"""The chunked WKV6 kernel's arithmetic, on the CPU, against the JAX package.

``csrc/wkv6_chunk.cu`` runs only on the card; its factorisation is
``wkv6_chunk_ref`` (chunks of 64 tokens, sub-chunks of 16, diagonal
sub-chunks by masked pairwise exponentials, the blocks below them through
the boundary ``B_i``), in plain f32 torch.  These tests hold that
factorisation to the token-by-token recurrence (the port's
``wkv6_scan_ref`` and the JAX package's) and to the JAX Pallas kernel in
interpret mode, on inputs made with numpy from a seed.  The card's kernel
is held to the plain version by the ``gpu``-marked test in
``tests/test_torch_kernels.py`` and by ``chip_smoke.py``.  Tolerances:

* 2e-5 in f32: the chunked and token-by-token forms sum the same terms in
  another order over at most a few hundred tokens;
* 2e-2 in bf16: both sides compute in f32 from the same bf16 inputs and
  round the output to bf16 once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan import wkv6_op as jax_wkv6_op
from repro.kernels.rwkv6_scan import wkv6_scan_ref as jax_wkv6_scan_ref
from repro_torch.kernels import common
from repro_torch.kernels.rwkv6_scan import (kernel_for, wkv6_chunk_ref,
                                            wkv6_op, wkv6_scan_ref)
from repro_torch.kernels.rwkv6_scan.ref import CHUNK, LOG2E
from torch_threads import one_thread  # noqa: F401  (autouse)

F32_TOL = 2e-5
BF16_TOL = 2e-2
H, D = 2, 64  # the kernel's head dim


def _inputs(seed, B, S, *, dtype=np.float32, decay_mean=-1.0, state_scale=0.3):
    """numpy r/k/v, logw = -exp(N(decay_mean, 0.5)) <= 0, u and a state."""
    rng = np.random.default_rng(seed)
    shape = (B, H, S, D)
    r, k, v = ((rng.standard_normal(shape) * 0.5).astype(dtype) for _ in range(3))
    logw = -np.exp(rng.standard_normal(shape) * 0.5 + decay_mean).astype(np.float32)
    u = (rng.standard_normal((H, D)) * 0.2).astype(np.float32)
    s0 = (rng.standard_normal((B, H, D, D)) * state_scale).astype(np.float32)
    return r, k, v, logw, u, s0


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_scan(r, k, v, logw, u, s0):
    B, _, S, _ = r.shape
    out, s1 = jax_wkv6_scan_ref(*(jnp.asarray(a).reshape(B * H, S, D)
                                  for a in (r, k, v, logw)),
                                jnp.asarray(u), jnp.asarray(s0).reshape(B * H, D, D),
                                num_heads=H)
    return np.asarray(out).reshape(B, H, S, D), np.asarray(s1).reshape(B, H, D, D)


def _close(ours, ref, tol):
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("S,decay_mean", [(2, -1.0), (16, -1.0), (17, -1.0), (64, -1.0),
                                          (65, -1.0), (77, -1.0), (130, -1.0), (130, -4.0)])
def test_chunk_ref_matches_the_recurrence(S, decay_mean):
    """Ragged S: a partial sub-chunk (17, 77), a partial chunk (65, 77,
    130) and a single pair (2); the padded tail leaves the state exact.
    Slow decays (logw ~ -0.02) give every sub-chunk block of a chunk its
    weight in the output."""
    arrays = _inputs(S, 1, S, decay_mean=decay_mean)
    out, s1 = wkv6_chunk_ref(*_torch(*arrays))
    ref, sref = wkv6_scan_ref(*_torch(*arrays))
    _close(out, ref, F32_TOL)
    _close(s1, sref, F32_TOL)
    jout, js1 = _jax_scan(*arrays)
    _close(out, jout, F32_TOL)
    _close(s1, js1, F32_TOL)


@pytest.mark.parametrize("B,S,chunk", [(1, 64, 64), (2, 128, 64), (1, 16, 16)])
def test_chunk_ref_matches_pallas_kernel(B, S, chunk):
    """The TPU kernel's chunked form in interpret mode (S a multiple of its
    chunk, which it needs)."""
    arrays = _inputs(7 + S, B, S)
    out, s1 = wkv6_chunk_ref(*_torch(*arrays))
    pallas, s_pallas = jax_wkv6_op(*(jnp.asarray(a) for a in arrays), chunk=chunk)
    _close(out, pallas, F32_TOL)
    _close(s1, s_pallas, F32_TOL)


@pytest.mark.parametrize("S,split", [(130, 77), (200, 100)])
def test_chunk_ref_state_carry_split(S, split):
    """Two calls over [0, split) and [split, S), at a split that is no
    multiple of 64, equal one call over the whole and the recurrence."""
    r, k, v, logw, u, s0 = _torch(*_inputs(3, 1, S))
    full, s_full = wkv6_chunk_ref(r, k, v, logw, u, s0)
    a, mid = wkv6_chunk_ref(r[:, :, :split], k[:, :, :split], v[:, :, :split],
                            logw[:, :, :split], u, s0)
    b, end = wkv6_chunk_ref(r[:, :, split:], k[:, :, split:], v[:, :, split:],
                            logw[:, :, split:], u, mid)
    _close(torch.cat([a, b], dim=2), full, F32_TOL)
    _close(end, s_full, F32_TOL)
    ref, sref = wkv6_scan_ref(r, k, v, logw, u, s0)
    _close(torch.cat([a, b], dim=2), ref, F32_TOL)
    _close(end, sref, F32_TOL)


def test_chunk_ref_strong_decays_stay_finite():
    """logw near -7 per token (published RWKV6 weights decay this hard):
    the chunked form stays finite and matches the recurrence, where the
    1/decay form's exp(-cum) over one chunk overflows f32."""
    r, k, v, logw, u, s0 = _torch(*_inputs(5, 1, 150, decay_mean=2.0))
    assert float(logw.mean()) < -6.0
    assert not bool(torch.isfinite(torch.exp(-torch.cumsum(logw[:, :, :CHUNK], 2))).all())
    out, s1 = wkv6_chunk_ref(r, k, v, logw, u, s0)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(s1).all())
    ref, sref = wkv6_scan_ref(r, k, v, logw, u, s0)
    _close(out, ref, F32_TOL)
    _close(s1, sref, F32_TOL)


def test_chunk_prefix_sums_never_increase():
    """Every exponent of the chunked form is a later prefix sum of logw
    minus an earlier one, so it is <= 0 if the prefix sum does not
    increase, in f32, tiny and zero decays included.  The kernel sums a
    chunk's channel in two runs of 32 tokens and adds the first run's total
    to the second run: that total is the first run's last sum, so the join
    keeps the order too."""
    rng = np.random.default_rng(11)
    logw = -np.exp(rng.standard_normal((4, CHUNK, D)) * 4.0 - 3.0).astype(np.float32)
    logw[0, ::3] = 0.0
    logw[1] = -np.float32(1e-30)
    runs = (torch.from_numpy(logw) * LOG2E).view(4, 2, CHUNK // 2, D).cumsum(2)
    cum = torch.cat([runs[:, 0], runs[:, 0, -1:] + runs[:, 1]], dim=1)
    assert bool((cum[:, 1:] <= cum[:, :-1]).all())


def test_chunk_ref_bf16_inputs_match_the_recurrence():
    r, k, v, logw, u, s0 = _torch(*_inputs(9, 1, 77))
    r, k, v = (x.to(torch.bfloat16) for x in (r, k, v))
    out, s1 = wkv6_chunk_ref(r, k, v, logw, u, s0)
    ref, sref = wkv6_scan_ref(r, k, v, logw, u, s0)
    assert out.dtype == torch.bfloat16 and s1.dtype == torch.float32
    _close(out.float(), ref.float(), BF16_TOL)
    _close(s1, sref, F32_TOL)


@pytest.mark.parametrize("dtype,S,D_,kernel", [
    (torch.bfloat16, 1000, 64, "wkv6_chunk"),
    (torch.bfloat16, 2, 64, "wkv6_chunk"),
    (torch.bfloat16, 1, 64, "wkv6_scan"),     # decode
    (torch.float32, 1000, 64, "wkv6_scan"),   # f32 keeps f32 products
    (torch.bfloat16, 1000, 32, "wkv6_scan"),
    (torch.bfloat16, 1000, 128, "wkv6_scan"),
])
def test_routing_rule(dtype, S, D_, kernel):
    assert kernel_for(dtype, S, D_) == kernel


def test_cpu_bf16_prefill_runs_the_plain_version_and_counts_no_launch():
    r, k, v, logw, u, s0 = _torch(*_inputs(4, 1, 77))
    r, k, v = (x.to(torch.bfloat16) for x in (r, k, v))
    common.reset_launch_counts()
    out, s1 = wkv6_op(r, k, v, logw, u, s0)
    assert common.launch_counts["wkv6_chunk"] == 0
    assert common.launch_counts["wkv6_scan"] == 0
    ref, sref = wkv6_scan_ref(r, k, v, logw, u, s0)
    assert torch.equal(out, ref) and torch.equal(s1, sref)
