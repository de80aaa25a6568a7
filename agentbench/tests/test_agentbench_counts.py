"""The yardstick's counts against hand counts, two shapes per kernel."""
import pytest

from agentbench.counts import decode_attention, flash_attention, model, peaks
from agentbench.counts import wkv6_chunk, wkv6_scan

OLMOE = {"num_layers": 16, "d_model": 2048, "num_heads": 16, "num_kv_heads": 16,
         "head_dim": 128, "d_ff": 1024, "vocab_size": 50304, "activation": "swiglu",
         "num_experts": 64, "experts_per_token": 8, "attn_free": False}
RWKV = {"num_layers": 32, "d_model": 4096, "num_heads": 64, "num_kv_heads": 64,
        "head_dim": 64, "d_ff": 14336, "vocab_size": 65536, "activation": "relu_sq",
        "attn_free": True}


@pytest.mark.parametrize("S", [1, 860])
def test_flash_attention(S):
    shapes = flash_attention.calls({"kind": "prefill", "S": S}, OLMOE)
    assert len(shapes) == 16
    ops, nbytes = flash_attention.work(shapes[0])
    # pairs S(S+1)/2 x 16 heads x 4 x 128
    assert ops == 4 * 128 * 16 * S * (S + 1) // 2
    # q, o: S x 2048 bf16 each; k, v: S x 2048 bf16 each
    assert nbytes == 4 * S * 2048 * 2
    assert flash_attention.calls({"kind": "decode", "rows": 2, "lengths": [3, 0]}, OLMOE) == []
    assert flash_attention.calls({"kind": "prefill", "S": S}, RWKV) == []


@pytest.mark.parametrize("lengths", [[1000, 0, 7], [4096] * 64])
def test_decode_attention(lengths):
    shapes = decode_attention.calls({"kind": "decode", "rows": len(lengths),
                                     "lengths": lengths}, OLMOE)
    assert len(shapes) == 16
    ops, nbytes = decode_attention.work(shapes[0])
    tokens = sum(lengths)
    assert ops == 4 * 16 * 128 * tokens
    # q and o of every row, k and v of each valid entry (16 heads x 128), lengths
    assert nbytes == 2 * 2 * len(lengths) * 2048 + 2 * 2 * tokens * 2048 + 4 * len(lengths)


@pytest.mark.parametrize("S", [2, 1000])
def test_wkv6_chunk(S):
    shapes = wkv6_chunk.calls({"kind": "prefill", "S": S}, RWKV)
    assert len(shapes) == 32
    ops, nbytes = wkv6_chunk.work(shapes[0])
    chunks = 64 * S / 64
    per_chunk = 2 * 64 * (64 * 64 + 16 * 16 * 16 + 64 * 64)
    assert ops == pytest.approx(per_chunk * chunks)
    # r, k, v, o bf16; logw f32; u f32; state in and out f32
    assert nbytes == 4 * 2 * S * 4096 + 4 * S * 4096 + 4 * 4096 + 2 * 4 * 64 * 64 * 64
    assert wkv6_chunk.calls({"kind": "prefill", "S": 1}, RWKV) == []


@pytest.mark.parametrize("rows", [1, 32])
def test_wkv6_scan(rows):
    shapes = wkv6_scan.calls({"kind": "decode", "rows": rows, "lengths": [5] * rows}, RWKV)
    assert len(shapes) == 32
    ops, nbytes = wkv6_scan.work(shapes[0])
    assert ops == 5 * rows * 64 * 64 * 64
    assert nbytes == (4 * 2 * rows * 4096 + 4 * rows * 4096 + 4 * 4096
                      + 2 * 4 * rows * 64 * 64 * 64)
    assert wkv6_scan.PEAK == "f32"


def test_model_flops_olmoe():
    d, f, L, V = 2048, 1024, 16, 50304
    per_token = 2 * (2 * d * d + 2 * d * d + d * 64 + 8 * 3 * d * f)
    # a prefill of 100 tokens: every token through the layers, the LM head once
    got = model.flops({"kind": "prefill", "S": 100}, OLMOE)
    assert got == 100 * L * per_token + 2 * d * V + 4 * 128 * 16 * L * 5050
    # a decode of two active rows over 10 and 20 entries and an idle one
    got = model.flops({"kind": "decode", "rows": 3, "lengths": [10, 0, 20]}, OLMOE)
    assert got == 2 * L * per_token + 2 * 2 * d * V + 4 * 128 * 16 * L * 30


def test_model_flops_rwkv():
    d, f, L, V = 4096, 14336, 32, 65536
    weights = 5 * d * d + d * 160 + 160 * d + d * 64 + 64 * d + 2 * d * f + d * d
    got = model.flops({"kind": "decode", "rows": 4, "lengths": [3, 3, 0, 0]}, RWKV)
    assert got == 2 * 2 * L * weights + 2 * 2 * d * V + 4 * 64 * 64 * 64 * L * 2


def test_bound():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 1, flops=peaks.F32_FLOPS) == pytest.approx(1.0)


def test_kv_live_gb():
    from agentbench.metrics import reader

    read = reader("kv_live_gb")
    calls = [{"kind": "decode", "rows": 3, "lengths": [1000, 0, 7]},
             {"kind": "decode", "rows": 3, "lengths": [1001, 0, 8]},
             {"kind": "prefill", "S": 860}]
    record = {"model": OLMOE, "dtype_bytes": 2, "calls": calls}
    # K and V: 16 layers x 16 heads x 128 x 2 bytes each, 131072 B a token
    assert read(record) == pytest.approx(131072 * (1007 + 1009) / 2 / 1e9)
    assert read(dict(record, model=RWKV)) is None
    assert read(dict(record, calls=calls[2:])) is None
