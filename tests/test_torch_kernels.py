"""The port's attention kernels against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; that is held
against the JAX Pallas kernels run in interpret mode (as the JAX package's
own tests run them) and against the jnp oracles and model-layer functions.
The CUDA kernels themselves are held against the plain versions by the
``gpu``-marked tests at the end, which skip where there is no card; the
WKV6 kernels' CPU parity with the JAX package is in ``test_torch_rwkv.py``
and ``test_torch_wkv6_chunk.py``.
Tolerances follow ``tests/test_kernels.py``: 2e-5 in f32, 2e-2 in bf16.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.decode_attention import (decode_attention_op,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import (flash_attention_op,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rwkv6_scan import kernel_for, wkv6_op, wkv6_scan_ref
from repro_torch.kernels.tile_plan import tile_plan
from repro_torch.models import layers as TL
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the card's attention outputs, row by row (the D values of one head): the
# largest error against the plain version in f32 over the row's RMS, as
# chip_smoke.py's ROW_REL_TOL; long rows' outputs are small beside TOL
ROW_REL_TOL = 0.05


def _assert_rows_close(out, truth):
    err = (out.float() - truth).abs().amax(-1)
    rms = truth.square().mean(-1).sqrt()
    assert bool((err[rms == 0] == 0).all()), "a zero row came out nonzero"
    worst = float((err[rms > 0] / rms[rms > 0]).max()) if bool((rms > 0).any()) else 0.0
    assert worst <= ROW_REL_TOL, f"row error {worst} of the row's RMS"


class _Ref:
    """The JAX package's kernels and layers.  Imported inside the tests that
    use them, so that the card's tests below run where JAX is absent."""

    def __init__(self):
        self.jnp = pytest.importorskip("jax.numpy")
        flash = importlib.import_module("repro.kernels.flash_attention")
        decode = importlib.import_module("repro.kernels.decode_attention")
        self.flash_op, self.flash_ref = flash.flash_attention_op, flash.flash_attention_ref
        self.flash_kernel = importlib.import_module(
            "repro.kernels.flash_attention.kernel").flash_attention
        self.decode_op, self.decode_ref = decode.decode_attention_op, decode.decode_attention_ref
        self.layers = importlib.import_module("repro.models.layers")

    def inputs(self, seed, *shapes, dtype="float32"):
        """numpy arrays (rounded to ``dtype``) as (jnp, torch) twins."""
        rng = np.random.default_rng(seed)
        jdtype = {"float32": self.jnp.float32, "bfloat16": self.jnp.bfloat16}[dtype]
        out = []
        for s in shapes:
            a = (rng.standard_normal(s) * 0.5).astype(np.float32)
            out.append((self.jnp.asarray(a, jdtype),
                        torch.from_numpy(a).to(TORCH[dtype])))
        return out

    def close(self, ours, ref, tol):
        np.testing.assert_allclose(
            np.asarray(ours.float()),
            np.asarray(self.jnp.asarray(ref, self.jnp.float32)),
            atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def R():
    return _Ref()


def _torch_inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32))
            for s in shapes]


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,KV,S,D", [
    (1, 2, 2, 128, 64),   # MHA
    (2, 4, 2, 256, 64),   # GQA group 2
    (1, 8, 1, 128, 128),  # MQA, wide head
    (1, 2, 2, 192, 64),   # the block-divisible ragged case of the JAX sweep
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_pallas_kernel(R, B, H, KV, S, D, dtype):
    (jq, tq), (jk, tk), (jv, tv) = R.inputs(0, (B, S, H, D), (B, S, KV, D),
                                           (B, S, KV, D), dtype=dtype)
    ref = R.flash_op(jq, jk, jv, block_q=64, block_kv=64)
    R.close(flash_attention_op(tq, tk, tv), ref, TOL[dtype])


@pytest.mark.parametrize("window", [64, 128])
def test_flash_window_matches_pallas_kernel(R, window):
    B, H, KV, S, D = 1, 4, 2, 256, 64
    (jq, tq), (jk, tk), (jv, tv) = R.inputs(1, (B, S, H, D), (B, S, KV, D),
                                           (B, S, KV, D))
    ref = R.flash_op(jq, jk, jv, window=window, block_q=64, block_kv=64)
    R.close(flash_attention_op(tq, tk, tv, window=window), ref, TOL["float32"])


@pytest.mark.parametrize("S", [1, 77, 192])
def test_flash_ragged_lengths_match_oracle_and_model_layer(R, S):
    """The Pallas kernel needs block-divisible S; the port takes any S."""
    B, H, KV, D = 2, 4, 2, 32
    (jq, tq), (jk, tk), (jv, tv) = R.inputs(2, (B, S, H, D), (B, S, KV, D),
                                           (B, S, KV, D))
    ours = flash_attention_op(tq, tk, tv)
    oracle = R.flash_ref(jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                           jv.transpose(0, 2, 1, 3)).transpose(0, 2, 1, 3)
    R.close(ours, oracle, TOL["float32"])
    R.close(ours, R.layers.causal_flash_attention(jq, jk, jv, q_chunk=64),
           TOL["float32"])
    R.close(TL.causal_flash_attention(tq, tk, tv), oracle, TOL["float32"])


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 4, 7, 8, 16])
def test_flash_head_dims_and_groups(R, D, G):
    B, KV, S, window = 1, 2, 19, 0
    H = KV * G
    (jq, tq), (jk, tk), (jv, tv) = R.inputs(3, (B, S, H, D), (B, S, KV, D),
                                           (B, S, KV, D))
    oracle = R.flash_ref(jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                           jv.transpose(0, 2, 1, 3),
                           window=window).transpose(0, 2, 1, 3)
    R.close(flash_attention_op(tq, tk, tv), oracle, TOL["float32"])


def test_flash_ref_layout_matches_jax_ref(R):
    B, H, KV, S, D = 1, 4, 1, 33, 16
    (jq, tq), (jk, tk), (jv, tv) = R.inputs(4, (B, H, S, D), (B, KV, S, D),
                                           (B, KV, S, D))
    R.close(flash_attention_ref(tq, tk, tv, window=8),
           R.flash_ref(jq, jk, jv, window=8), TOL["float32"])


# the encoders' non-causal mode: queries over a key set of their own length
@pytest.mark.parametrize("Sq,Sk", [(1, 1), (77, 77), (64, 200), (200, 64)])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noncausal_matches_bidirectional_attention(R, Sq, Sk, G, D, dtype):
    B, KV = 2, 2
    H = KV * G
    (jq, tq), (jk, tk), (jv, tv) = R.inputs(10, (B, Sq, H, D), (B, Sk, KV, D),
                                           (B, Sk, KV, D), dtype=dtype)
    ref = R.layers.bidirectional_attention(jq, jk, jv)
    ours = flash_attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                               tv.transpose(1, 2), causal=False).transpose(1, 2)
    assert ours.dtype == TORCH[dtype] and tuple(ours.shape) == (B, Sq, H, D)
    R.close(ours, ref, TOL[dtype])
    R.close(TL.bidirectional_attention(tq, tk, tv), ref, TOL[dtype])
    R.close(flash_attention_op(tq, tk, tv, causal=False), ref, TOL[dtype])


@pytest.mark.parametrize("S", [1, 77, 256])
def test_causal_head_dim_32_matches_pallas_kernel(R, S):
    """Head dim 32 (the MiniLM reranker's) in the causal mode, against the
    Pallas kernel in interpret mode."""
    B, H, KV, D = 1, 4, 2, 32
    (jq, tq), (jk, tk), (jv, tv) = R.inputs(11, (B, H, S, D), (B, KV, S, D),
                                           (B, KV, S, D))
    ref = R.flash_kernel(jq, jk, jv, interpret=True)
    R.close(flash_attention_ref(tq, tk, tv), ref, TOL["float32"])
    R.close(flash_attention_op(tq.transpose(1, 2), tk.transpose(1, 2),
                               tv.transpose(1, 2)).transpose(1, 2),
            ref, TOL["float32"])


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,KV,D,Smax,clen", [
    (2, 8, 2, 64, 256, 200),
    (1, 16, 16, 128, 512, 512),  # MHA full cache
    (4, 4, 4, 64, 128, 1),       # single valid entry
    (2, 32, 2, 64, 256, 130),    # glm4-style extreme GQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_pallas_kernel(R, B, H, KV, D, Smax, clen, dtype):
    (jq, tq), (jk, tk), (jv, tv) = R.inputs(
        5, (B, H, D), (B, KV, Smax, D), (B, KV, Smax, D), dtype=dtype)
    ref = R.decode_op(jq, jk, jv, R.jnp.asarray(clen), block_s=64)
    R.close(decode_attention_op(tq, tk, tv, clen), ref, TOL[dtype])


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 4, 7, 8, 16])
def test_decode_per_row_lengths_match_model_layer(R, D, G):
    B, KV, Smax = 3, 2, 24
    H = KV * G
    lengths = np.array([1, 13, 24], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = R.inputs(
        6, (B, H, D), (B, KV, Smax, D), (B, KV, Smax, D))
    ours = decode_attention_op(tq, tk, tv, torch.from_numpy(lengths))
    R.close(ours, R.layers.decode_attention(jq, jk, jv, R.jnp.asarray(lengths)),
           TOL["float32"])
    R.close(TL.decode_attention(tq, tk, tv, torch.from_numpy(lengths)),
           R.layers.decode_attention(jq, jk, jv, R.jnp.asarray(lengths)),
           TOL["float32"])


def test_decode_per_row_lengths_match_scalar_oracle(R):
    B, H, KV, D, Smax = 3, 8, 2, 64, 40
    lengths = [1, 23, 40]
    (jq, tq), (jk, tk), (jv, tv) = R.inputs(
        9, (B, H, D), (B, KV, Smax, D), (B, KV, Smax, D))
    ours = decode_attention_op(tq, tk, tv, torch.tensor(lengths))
    for b, n in enumerate(lengths):
        ref = R.decode_ref(jq[b:b + 1].reshape(1, KV, H // KV, D),
                             jk[b:b + 1], jv[b:b + 1], n).reshape(1, H, D)
        R.close(ours[b:b + 1], ref, TOL["float32"])


def test_decode_length_zero_row_is_zeros():
    """The port's contract (the JAX kernel guards l == 0 the same way; the
    jnp layer instead averages the whole masked cache)."""
    tq, tk, tv = _torch_inputs(7, (3, 8, 64), (3, 2, 16, 64), (3, 2, 16, 64))
    lengths = torch.tensor([0, 5, 0])
    out = decode_attention_op(tq, tk, tv, lengths)
    assert torch.isfinite(out).all()
    assert float(out[0].abs().max()) == 0.0 and float(out[2].abs().max()) == 0.0
    ref = decode_attention_ref(tq.reshape(3, 2, 4, 64), tk, tv, lengths)
    torch.testing.assert_close(out, ref.reshape(3, 8, 64))
    assert float(out[1].abs().max()) > 0.0


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    common.reset_launch_counts()
    tq, tk, tv = _torch_inputs(8, (1, 9, 4, 64), (1, 9, 2, 64), (1, 9, 2, 64))
    flash_attention_op(tq, tk, tv)
    flash_attention_op(tq[:, :3], tk, tv, causal=False)
    decode_attention_op(tq[:, 0], tk.transpose(1, 2), tv.transpose(1, 2), 3)
    assert common.launch_counts == {"flash_attention": 0,
                                    "decode_attention": 0, "wkv6_scan": 0,
                                    "wkv6_chunk": 0, "flash_attention_bwd": 0,
                                    "wkv6_bwd": 0}


def test_wrappers_reject_mismatched_shapes():
    q = torch.zeros(1, 8, 4, 64)
    with pytest.raises(ValueError):
        flash_attention_op(q, torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64))
    with pytest.raises(ValueError):
        flash_attention_op(q, torch.zeros(1, 7, 2, 64), torch.zeros(1, 7, 2, 64))
    with pytest.raises(ValueError):
        decode_attention_op(q[:, 0], torch.zeros(1, 2, 16, 32),
                            torch.zeros(1, 2, 16, 32), 4)


def test_noncausal_routing_and_refusals():
    """On the CPU, ``causal=False`` takes the plain version (any Sk, any
    head dim); the wrapper refuses a window without causality and a causal
    call over keys of another length.  What the kernel takes beyond that
    (f32/bf16, a head dim of HEAD_DIMS) it checks before a CUDA launch."""
    q, k, v = _torch_inputs(12, (1, 5, 4, 48), (1, 9, 2, 48), (1, 9, 2, 48))
    common.reset_launch_counts()
    out = flash_attention_op(q, k, v, causal=False)
    ref = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=False).transpose(1, 2)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert common.launch_counts["flash_attention"] == 0
    with pytest.raises(ValueError, match="window"):
        flash_attention_op(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="causal"):
        flash_attention_op(q, k, v)
    with pytest.raises(ValueError, match="window"):
        flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=False, window=4)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    with pytest.raises(ValueError, match="no keys"):
        flash_attention_op(q, k[:, :0], v[:, :0], causal=False)
    assert flash_ops.HEAD_DIMS == (32, 64, 128, 256)
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_ops.check_kernel_operands(q, k, v)
    with pytest.raises(ValueError, match="dtype"):
        flash_ops.check_kernel_operands(q.double(), k.double(), v.double())
    for D in flash_ops.HEAD_DIMS:
        t = torch.zeros(1, 5, 4, D)
        flash_ops.check_kernel_operands(t, t[:, :, :2], t[:, :, :2])


def test_library_paths_are_keyed_by_source_hash():
    path = common.library_path("flash_attention")
    assert path.parent == common.BUILD_DIR
    assert path.name.startswith("flash_attention-") and path.suffix == ".so"
    assert common.library_path("decode_attention") != path


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    common.reset_launch_counts()

    def rnd(*shape, dtype):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.5).to(dtype)

    n_flash = n_decode = 0
    for name, dtype in TORCH.items():
        tol = TOL[name]
        for B, S, H, KV, D, window in [(1, 1, 32, 8, 128, 0), (2, 77, 32, 8, 128, 0),
                                       (1, 192, 16, 4, 64, 64), (1, 300, 28, 4, 128, 0),
                                       (1, 130, 16, 16, 256, 0), (1, 100, 32, 2, 128, 0),
                                       (1, 1000, 32, 8, 128, 256)] + [
                # ragged tails around the 64-row tiles, every head dim, the
                # group sizes from MHA to 16, with and without a window
                (1, S, 2 * G, 2, D, window) for S in (1, 63, 65, 256)
                for D in (64, 128, 256) for G in (1, 7, 16) for window in (0, 64)]:
            q = rnd(B, S, H, D, dtype=dtype)
            k = rnd(B, S, KV, D, dtype=dtype)
            v = rnd(B, S, KV, D, dtype=dtype)
            out = flash_attention_op(q, k, v, window=window)
            torch.cuda.synchronize()
            ref = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), window=window)
            torch.testing.assert_close(out.float(), ref.transpose(1, 2).float(),
                                       atol=tol, rtol=tol)
            truth = flash_attention_ref(q.transpose(1, 2).float(), k.transpose(1, 2).float(),
                                        v.transpose(1, 2).float(), window=window)
            _assert_rows_close(out, truth.transpose(1, 2))
            n_flash += 1
        for B, H, KV, D, Smax, lens in [(8, 32, 8, 128, 1024, [0, 1, 77, 1000, 1024, 5, 300, 2]),
                                        (3, 28, 4, 128, 300, [299, 5, 0]),
                                        (2, 16, 1, 256, 200, [150, 199]),
                                        (2, 32, 2, 64, 256, [130, 256]),
                                        # one sequence, long and empty
                                        (1, 32, 8, 128, 4096, [4000]),
                                        (1, 32, 8, 128, 4096, [0]),
                                        # Smax not a multiple of the split
                                        (4, 32, 8, 128, 1000, [999, 1000, 3, 0])]:
            q = rnd(B, H, D, dtype=dtype)
            kc = rnd(B, KV, Smax, D, dtype=dtype)
            vc = rnd(B, KV, Smax, D, dtype=dtype)
            lengths = torch.tensor(lens, device=dev, dtype=torch.int32)
            out = decode_attention_op(q, kc, vc, lengths)
            torch.cuda.synchronize()
            ref = decode_attention_ref(q.reshape(B, KV, H // KV, D), kc, vc, lengths)
            torch.testing.assert_close(out.float(), ref.reshape(B, H, D).float(),
                                       atol=tol, rtol=tol)
            truth = decode_attention_ref(q.reshape(B, KV, H // KV, D).float(), kc.float(),
                                         vc.float(), lengths)
            _assert_rows_close(out, truth.reshape(B, H, D))
            n_decode += 1
    # a batch-1 view of one slot of a layered cache, as the engine's
    # prefix-hit suffix steps pass it
    for name, dtype in TORCH.items():
        q = rnd(1, 32, 128, dtype=dtype)
        cache = rnd(2, 2, 4, 8, 2048, 128, dtype=dtype)  # (k/v, L, slots, ...)
        kc, vc = cache[0, 1, 2:3], cache[1, 1, 2:3]
        lengths = torch.tensor([1100], device=dev, dtype=torch.int32)
        out = decode_attention_op(q, kc, vc, lengths)
        torch.cuda.synchronize()
        ref = decode_attention_ref(q.reshape(1, 8, 4, 128), kc, vc, lengths)
        torch.testing.assert_close(out.float(), ref.reshape(1, 32, 128).float(),
                                   atol=TOL[name], rtol=TOL[name])
        truth = decode_attention_ref(q.reshape(1, 8, 4, 128).float(), kc.float(),
                                     vc.float(), lengths)
        _assert_rows_close(out, truth.reshape(1, 32, 128))
        n_decode += 1
    # f32 queries over a bf16 cache: the engine's cache with f32 weights
    q = rnd(2, 32, 128, dtype=torch.float32)
    kc = rnd(2, 8, 300, 128, dtype=torch.bfloat16)
    vc = rnd(2, 8, 300, 128, dtype=torch.bfloat16)
    lengths = torch.tensor([299, 7], device=dev, dtype=torch.int32)
    out = decode_attention_op(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    ref = decode_attention_ref(q.reshape(2, 8, 4, 128), kc, vc, lengths)
    torch.testing.assert_close(out, ref.reshape(2, 32, 128),
                               atol=TOL["float32"], rtol=TOL["float32"])
    n_decode += 1
    assert common.launch_counts == {"flash_attention": n_flash,
                                    "decode_attention": n_decode,
                                    "wkv6_scan": 0, "wkv6_chunk": 0,
                                    "flash_attention_bwd": 0, "wkv6_bwd": 0}


@pytest.mark.gpu
def test_cuda_flash_noncausal_and_head_dim_32_match_plain_version():
    """The encoders' modes of the flash kernel on the card: non-causal with
    Sq != Sk (ragged ends around the 64- and 128-row tiles, every head dim,
    G of 1 to 16) and head dim 32 in both modes, against the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    common.reset_launch_counts()

    def rnd(*shape, dtype):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.5).to(dtype)

    cases = [(1, 512, 512, 12, 12, 64, False), (1, 286, 286, 12, 12, 32, False),
             (8, 137, 137, 12, 12, 32, False), (1, 77, 1601, 32, 8, 128, False),
             (1, 1, 512, 12, 12, 64, False), (1, 1000, 1000, 12, 12, 32, True),
             (2, 300, 300, 4, 2, 32, True)]
    cases += [(1, Sq, Sk, 2 * G, 2, D, False) for Sq, Sk in ((1, 1), (65, 63), (130, 257))
              for D in (32, 64, 128, 256) for G in (1, 7, 16)]
    n = 0
    for name, dtype in TORCH.items():
        tol = TOL[name]
        for B, Sq, Sk, H, KV, D, causal in cases:
            q = rnd(B, Sq, H, D, dtype=dtype)
            k = rnd(B, Sk, KV, D, dtype=dtype)
            v = rnd(B, Sk, KV, D, dtype=dtype)
            out = flash_attention_op(q, k, v, causal=causal)
            torch.cuda.synchronize()
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            ref = flash_attention_ref(qt, kt, vt, causal=causal)
            torch.testing.assert_close(out.float(), ref.transpose(1, 2).float(),
                                       atol=tol, rtol=tol)
            truth = flash_attention_ref(qt.float(), kt.float(), vt.float(),
                                        causal=causal)
            _assert_rows_close(out, truth.transpose(1, 2))
            n += 1
    assert common.launch_counts["flash_attention"] == n


@pytest.mark.gpu
def test_cuda_flash_launch_plan_matches_tile_plan():
    """The tiles the kernel reports it launches (``flash_attention_plan``)
    against the host's Hopper tile plan, with the card's SM count, over
    every head dim, both dtypes and grids on each side of the warpgroup
    choice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel reports its plan there")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in ("bfloat16", "float32"):
        for D in flash_ops.HEAD_DIMS:
            for B, H, S in ((1, 32, 1000), (1, 12, 286), (8, 12, 137),
                            (1, 32, 256), (1, 33, 512), (1, 1, 1),
                            (4, 64, 4096)):
                want = tile_plan(B, H, S, D, sms, dtype=dtype)
                got = flash_ops.flash_attention_plan(B, H, S, D, TORCH[dtype])
                assert got == want.kernel_numbers(), (dtype, D, B, H, S)


@pytest.mark.gpu
def test_cuda_wkv6_matches_plain_version():
    """The WKV6 kernels against their plain version, each call on the
    kernel ``wkv6_op`` routes it to (bf16 prompts at D=64 on the chunked
    kernel, the rest on the scan): ragged S, a carried state, strided
    (B, S, H, D) inputs, an update in place, strong and slow decays.  Beside the
    kernel tolerances, each output row and each state row is held to
    ROW_REL_TOL against the plain version run in f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    common.reset_launch_counts()

    def rnd(*shape, scale=0.5):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    n = {"wkv6_scan": 0, "wkv6_chunk": 0}
    for name, dtype in TORCH.items():
        tol = TOL[name]
        for B, H, S, D, mean in [
                (1, 64, 1, 64, -1.0), (1, 64, 77, 64, -1.0), (8, 64, 1, 64, -1.0),
                (2, 8, 130, 32, -1.0), (1, 4, 200, 128, -1.0), (1, 64, 1000, 64, -1.0),
                # the chunked kernel's edges: one pair, whole and partial
                # chunks, a batch, the longest prompt; strong decays (logw
                # ~-7) and slow ones (~-0.02, where every sub-chunk block
                # of a chunk weighs in the output)
                (1, 64, 2, 64, -1.0), (1, 64, 64, 64, -1.0), (2, 64, 130, 64, -1.0),
                (1, 64, 2048, 64, -1.0), (1, 64, 1000, 64, 2.0), (1, 64, 1000, 64, -4.0)]:
            # (B, S, H, D) projections seen as (B, H, S, D), as the model has them
            r, k, v = (rnd(B, S, H, D).to(dtype).transpose(1, 2) for _ in range(3))
            logw = (-torch.exp(rnd(B, S, H, D) + mean)).transpose(1, 2)
            u = rnd(H, D, scale=0.2)
            s0 = rnd(B, H, D, D, scale=0.1)
            out, s1 = wkv6_op(r, k, v, logw, u, s0)
            torch.cuda.synchronize()
            ref, sref = wkv6_scan_ref(r, k, v, logw, u, s0)
            truth, _ = wkv6_scan_ref(r.float(), k.float(), v.float(), logw, u, s0)
            assert out.dtype == dtype and s1.dtype == torch.float32
            torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
            torch.testing.assert_close(s1, sref, atol=tol, rtol=tol)
            _assert_rows_close(out, truth)
            _assert_rows_close(s1, sref)
            n[kernel_for(dtype, S, D)] += 1
            if S > 1:  # two calls over the halves, the second in place
                h = S // 2
                a, mid = wkv6_op(r[:, :, :h], k[:, :, :h], v[:, :, :h],
                                 logw[:, :, :h], u, s0)
                b, end = wkv6_op(r[:, :, h:], k[:, :, h:], v[:, :, h:],
                                 logw[:, :, h:], u, mid, out_state=mid)
                torch.cuda.synchronize()
                assert end.data_ptr() == mid.data_ptr()
                torch.testing.assert_close(torch.cat([a, b], 2).float(),
                                           ref.float(), atol=tol, rtol=tol)
                torch.testing.assert_close(end, sref, atol=tol, rtol=tol)
                _assert_rows_close(torch.cat([a, b], 2), truth)
                _assert_rows_close(end, sref)
                n[kernel_for(dtype, h, D)] += 1
                n[kernel_for(dtype, S - h, D)] += 1
    assert n["wkv6_chunk"] > 0
    assert {name: common.launch_counts[name] for name in n} == n
