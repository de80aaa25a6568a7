"""The split-K decode kernel's arithmetic and its host-side split planner.

On the card, bf16 decode attention runs as a split kernel, each block
covering ``chunk`` cache positions of one (sequence, kv head) and writing a
partial (m, l, O), and a merge kernel that combines a row's partials by
log-sum-exp.  ``decode_attention_split_ref`` repeats those steps in f32;
here it is held against the plain version and against the JAX package's
Pallas decode kernel in interpret mode, at 2e-5 as in
``tests/test_kernels.py``.  The CUDA kernels themselves are held against
the plain version by the ``gpu``-marked tests of ``test_torch_kernels.py``.
"""
import importlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 2e-5
H100_SMS = 132  # the card the planner is sized for


def _inputs(seed, B, KV, G, D, Smax):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.5).astype(np.float32)
            for s in ((B, KV, G, D), (B, KV, Smax, D), (B, KV, Smax, D))]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(scope="module")
def pallas():
    jnp = pytest.importorskip("jax.numpy")
    mod = importlib.import_module("repro.kernels.decode_attention")
    return jnp, mod.decode_attention_op, mod.decode_attention_ref


# ---------------------------------------------------------------------------
# the plain split-and-merge against the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 7, 64, "smax"])
@pytest.mark.parametrize("B,KV,G,D,Smax,lengths", [
    # length 0, shorter than one split, equal to Smax, in between
    (5, 2, 4, 64, 128, [0, 3, 128, 65, 64]),
    # Smax not a multiple of the split (1000 % 64, 1000 % 7)
    (4, 1, 7, 32, 1000, [999, 1000, 3, 0]),
    (2, 2, 16, 128, 100, [100, 1]),
    (1, 8, 1, 256, 77, [50]),
])
def test_split_ref_matches_plain_version(chunk, B, KV, G, D, Smax, lengths):
    chunk = Smax if chunk == "smax" else chunk
    q, k, v = _torch(*_inputs(0, B, KV, G, D, Smax))
    lens = torch.tensor(lengths)
    ours = decode_attention_split_ref(q, k, v, lens, chunk)
    torch.testing.assert_close(ours, decode_attention_ref(q, k, v, lens),
                               atol=TOL, rtol=TOL)
    zero = [i for i, n in enumerate(lengths) if n == 0]
    assert all(float(ours[i].abs().max()) == 0.0 for i in zero)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_split_ref_takes_scalar_lengths_and_clamps(chunk):
    q, k, v = _torch(*_inputs(1, 2, 2, 4, 64, 70))
    for n in (0, 5, 70, 99):
        torch.testing.assert_close(decode_attention_split_ref(q, k, v, n, chunk),
                                   decode_attention_ref(q, k, v, min(n, 70)),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("chunk", [64, 448, 4096])
def test_split_ref_at_the_engine_plans(chunk):
    """The chunks plan_splits gives the engine (B=1 and B=8 over 4096)."""
    B, KV, G, D, Smax = 2, 2, 4, 64, 4096
    q, k, v = _torch(*_inputs(2, B, KV, G, D, Smax))
    lens = torch.tensor([1100, 4095])
    torch.testing.assert_close(decode_attention_split_ref(q, k, v, lens, chunk),
                               decode_attention_ref(q, k, v, lens),
                               atol=TOL, rtol=TOL)


def test_split_ref_keeps_q_dtype():
    q, k, v = _torch(*_inputs(3, 1, 2, 4, 64, 64))
    out = decode_attention_split_ref(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                     33, 7)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


# ---------------------------------------------------------------------------
# ... and against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 7, 64, "smax"])
@pytest.mark.parametrize("B,H,KV,D,Smax,clen", [
    (2, 8, 2, 64, 256, 200),
    (1, 16, 16, 128, 512, 512),  # length equal to Smax
    (4, 4, 4, 64, 128, 1),       # shorter than one split
    (2, 32, 2, 64, 256, 130),    # G = 16
])
def test_split_ref_matches_pallas_kernel(pallas, chunk, B, H, KV, D, Smax, clen):
    jnp, decode_op, _ = pallas
    chunk = Smax if chunk == "smax" else chunk
    G = H // KV
    q, k, v = _inputs(5, B, KV, G, D, Smax)
    ref = decode_op(jnp.asarray(q.reshape(B, H, D)), jnp.asarray(k),
                    jnp.asarray(v), jnp.asarray(clen), block_s=64)
    tq, tk, tv = _torch(q, k, v)
    ours = decode_attention_split_ref(tq, tk, tv, clen, chunk).reshape(B, H, D)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref, np.float32),
                               atol=TOL, rtol=TOL)


def test_split_ref_per_row_lengths_match_pallas_oracle(pallas):
    """Per-row lengths (the Pallas kernel takes one): each row against the
    JAX oracle at its own length, with Smax = 1000 not a multiple of 64."""
    jnp, _, oracle = pallas
    B, KV, G, D, Smax = 4, 2, 4, 64, 1000
    lengths = [999, 1000, 3, 37]
    q, k, v = _inputs(6, B, KV, G, D, Smax)
    tq, tk, tv = _torch(q, k, v)
    ours = decode_attention_split_ref(tq, tk, tv, torch.tensor(lengths), 64)
    for b, n in enumerate(lengths):
        ref = oracle(jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
                     jnp.asarray(v[b:b + 1]), n)
        np.testing.assert_allclose(ours[b:b + 1].numpy(),
                                   np.asarray(ref, np.float32), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# the host-side split planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_heads", [8, 64, 128])
@pytest.mark.parametrize("smax", [0, 1, 63, 64, 100, 1000, 2048, 4096, 32768])
def test_split_plan_fills_the_card(batch_heads, smax):
    chunk, splits = decode_ops.plan_splits(batch_heads, smax, H100_SMS)
    assert isinstance(chunk, int) and isinstance(splits, int)
    assert chunk >= decode_ops.SPLIT_TILE and chunk % decode_ops.SPLIT_TILE == 0
    assert splits >= 1 and chunk * splits >= smax
    if smax > 0:  # no split starts past Smax
        assert (splits - 1) * chunk < smax
    # at least two blocks per SM where Smax allows
    most = batch_heads * max(1, -(-smax // decode_ops.SPLIT_TILE))
    assert batch_heads * splits >= min(2 * H100_SMS, most)


def test_split_plan_at_the_engine_shapes():
    """B=1 (the prefix-hit suffix steps) and B=8 over an 8-head cache of
    4096 positions: both give the card several blocks per SM."""
    for B in (1, 8):
        chunk, splits = decode_ops.plan_splits(B * 8, 4096, H100_SMS)
        assert B * 8 * splits >= 2 * H100_SMS


def test_split_plan_reads_no_tensor(monkeypatch):
    """The plan depends on two host integers only: no tensor is read back
    (a device read would sync the host with the card every layer)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the planner read a tensor")

    for name in ("item", "tolist", "cpu", "numpy", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    assert decode_ops.plan_splits(64, 4096, H100_SMS) == (448, 10)


# ---------------------------------------------------------------------------
# the wrappers' ctypes signatures against the C entry points
# ---------------------------------------------------------------------------


def _c_params(kernel: str, symbol: str):
    src = (common.CSRC_DIR / f"{kernel}.cu").read_text()
    body = re.search(rf"int {symbol}\((.*?)\)\s*{{", src, re.S).group(1)
    return [p.strip() for p in body.split(",")]


@pytest.mark.parametrize("ops,kernel,symbol", [
    (flash_ops, "flash_attention", "flash_attention_fwd"),
    (decode_ops, "decode_attention", "decode_attention_fwd"),
])
def test_argtypes_match_the_c_entry_point(ops, kernel, symbol):
    """ctypes passes what ``_ARGTYPES`` says whatever the C side expects, so
    a mismatch would only show on the card: check it here."""
    params = _c_params(kernel, symbol)
    assert len(params) == len(ops._ARGTYPES)
    for param, argtype in zip(params, ops._ARGTYPES):
        ctype = param.rsplit(" ", 1)[0].replace("const ", "")
        expected = {"void*": decode_ops.ctypes.c_void_p, "int": decode_ops.ctypes.c_int,
                    "long long": decode_ops.ctypes.c_longlong}[ctype]
        assert argtype is expected, param
