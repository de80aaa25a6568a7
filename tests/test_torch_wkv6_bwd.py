"""The WKV6 backward: ``wkv6_bwd_ref`` (the plain version of
``csrc/wkv6_bwd.cu``), ``wkv6_bwd_chunk_ref`` (the kernel's chunked
arithmetic), ``WKV6Fn`` and the wrapper's routing of a call that needs a
gradient.

The plain backward runs the kernel's two passes token by token.  It is
held to torch autograd of the plain forward ``wkv6_scan_ref`` in f64 (to
1e-6 of each gradient's scale, its largest magnitude) and in f32 (2e-5:
the two sum the same products in another order), at S of 1, 37 and 128,
with strong decays and a nonzero carried state; and in f32 to ``jax.vjp``
of the reference's ``wkv6_chunked``, the function the reference trains
through (S a multiple of its chunk of 64, or one chunk).  The chunked form
is held to autograd in f64 at small chunks (8 tokens in sub-chunks of 4,
so that many chunks and a ragged last one run at small S) and at the
kernel's 64 and 16, to ``jax.vjp`` in f32, its walks to the token-by-token
states, and its f32 dlogw to the f64 truth at strong decays.  ``WKV6Fn``
passes ``gradcheck`` on the CPU in f64, where it runs the plain versions.
Inputs and cotangents are numpy draws from a seed.  The ``gpu``-marked
tests hold the kernel to the plain version on the card and skip here.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv import wkv6_chunked as jax_wkv6_chunked
from repro_torch.kernels import common
from repro_torch.kernels.rwkv6_scan import (WKV6Fn, wkv6_bwd_chunk_ref, wkv6_bwd_op,
                                            wkv6_bwd_ref, wkv6_op, wkv6_scan_ref)
from repro_torch.kernels.rwkv6_scan import ops as wkv6_ops
from repro_torch.kernels.rwkv6_scan.ref import wkv6_bwd_chunk_states

NAMES = ("dr", "dk", "dv", "dlogw", "du", "dstate")
TOL = {torch.float64: 1e-6, torch.float32: 2e-5}


def _inputs(B, H, S, D, seed, decay_mean=2.0):
    """r, k, v, logw, u, state and a cotangent as f64 numpy arrays; logw =
    -exp(N(decay_mean, 0.5)), strong by default (about -7 a token)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, D)) * 0.5 for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, H, S, D)) * 0.5 + decay_mean)
    u = rng.standard_normal((H, D)) * 0.3
    state = rng.standard_normal((B, H, D, D)) * 0.2
    dout = rng.standard_normal((B, H, S, D))
    return r, k, v, logw, u, state, dout


def _autograd(tensors, dout):
    """Gradients of ``wkv6_scan_ref``'s output by torch autograd; logw's is
    zero where S = 1 (only the final state, not differentiated, uses it)."""
    leaves = [t.clone().requires_grad_(True) for t in tensors]
    out, _ = wkv6_scan_ref(*leaves)
    grads = torch.autograd.grad(out, leaves, dout, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]


def _close(ours, ref, tol, what):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, what
    scale = float(np.abs(ref).max())
    err = float(np.abs(ours - ref).max())
    assert err <= tol * max(scale, 1e-30), f"{what}: error {err} over scale {scale}"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("S", [1, 37, 128])
def test_plain_backward_matches_autograd(S, dtype):
    arrays = _inputs(2, 3, S, 16, seed=S)
    tensors = [torch.from_numpy(a).to(dtype) for a in arrays]
    ref = _autograd(tensors[:6], tensors[6])
    ours = wkv6_bwd_ref(*tensors)
    for name, g, want in zip(NAMES, ours, ref):
        assert g.dtype == dtype, name
        _close(g, want, TOL[dtype], name)
    if S > 1:
        assert float(ours[3].abs().max()) > 0  # dlogw is held, not vacuous


@pytest.mark.parametrize("S,decay_mean", [(64, 2.0), (128, -1.0), (128, -4.0), (24, 2.0)])
def test_plain_backward_matches_jax_vjp_of_wkv6_chunked(S, decay_mean):
    """f32, against the reference's chunked form (mild, strong and slow
    decays); its state gradient too, from a nonzero carried state.  Within
    1e-4 of scale: the chunked form takes each decay as a difference of two
    prefix sums of logw, which at strong decays (prefix sums near -450 in
    one chunk) carry about 3e-5 of relative rounding in f32."""
    arrays = [a.astype(np.float32) for a in _inputs(2, 2, S, 64, 10 + S, decay_mean)]
    r, k, v, logw, u, state, dout = arrays

    def f(r, k, v, logw, u, state):
        return jax_wkv6_chunked(r, k, v, logw, u, state)[0]

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrays[:6]))
    ref = vjp(jnp.asarray(dout))
    ours = wkv6_bwd_ref(*(torch.from_numpy(a) for a in arrays))
    for name, g, want in zip(NAMES, ours, ref):
        _close(g, np.asarray(want), 1e-4, name)


@pytest.mark.parametrize("decay_mean", [2.0, -1.0, -4.0])
@pytest.mark.parametrize("S", [1, 37, 64, 130, 200])
def test_chunked_backward_matches_autograd(S, decay_mean):
    """f64, chunks of 8 in sub-chunks of 4 (S = 37: four whole chunks and
    five padded tokens), at strong, mild and slow decays."""
    tensors = [torch.from_numpy(a) for a in _inputs(2, 3, S, 16, S, decay_mean)]
    ref = _autograd(tensors[:6], tensors[6])
    ours = wkv6_bwd_chunk_ref(*tensors, chunk=8, sub=4)
    for name, g, want in zip(NAMES, ours, ref):
        assert g.dtype == torch.float64, name
        _close(g, want, TOL[torch.float64], name)


@pytest.mark.parametrize("S", [37, 130])
def test_chunked_backward_matches_autograd_at_the_kernels_chunks(S):
    """f64 at the kernel's chunks of 64 in sub-chunks of 16, D = 64."""
    tensors = [torch.from_numpy(a) for a in _inputs(1, 2, S, 64, S, -1.0)]
    ref = _autograd(tensors[:6], tensors[6])
    for name, g, want in zip(NAMES, wkv6_bwd_chunk_ref(*tensors), ref):
        _close(g, want, TOL[torch.float64], name)


@pytest.mark.parametrize("S", [64, 128])
def test_chunked_backward_matches_jax_vjp_of_wkv6_chunked(S):
    """f32, against the reference's chunked form at strong decays, to 1e-4
    of scale (the reference's own rounding, as in the plain version's
    test)."""
    arrays = [a.astype(np.float32) for a in _inputs(2, 2, S, 64, 20 + S, 2.0)]

    def f(r, k, v, logw, u, state):
        return jax_wkv6_chunked(r, k, v, logw, u, state)[0]

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrays[:6]))
    ref = vjp(jnp.asarray(arrays[6]))
    ours = wkv6_bwd_chunk_ref(*(torch.from_numpy(a) for a in arrays))
    for name, g, want in zip(NAMES, ours, ref):
        _close(g, np.asarray(want), 1e-4, name)


def test_chunk_walks_match_the_token_states():
    """Phases 1 and 2: S_n is the state after the token before chunk n,
    dS_n the gradient at chunk n's last token, the last chunk's zero (S =
    37 in chunks of 8: the padded tokens change neither)."""
    S, chunk = 37, 8
    r, k, v, logw, u, state, dout = (torch.from_numpy(a)
                                     for a in _inputs(2, 3, S, 16, 5, -1.0))
    states, dstates, dstate = wkv6_bwd_chunk_states(r, k, v, logw, state, dout, chunk=chunk,
                                                    sub=4)
    n = -(-S // chunk)
    assert states.shape == dstates.shape == (2, 3, n, 16, 16)
    s, before = state.clone(), []
    for t in range(S):
        before.append(s)
        s = s * torch.exp(logw[:, :, t, :, None]) + k[:, :, t, :, None] * v[:, :, t, None, :]
    ds, after = torch.zeros_like(state), [None] * S
    for t in reversed(range(S)):
        after[t] = ds
        ds = ds * torch.exp(logw[:, :, t, :, None]) + r[:, :, t, :, None] * dout[:, :, t, None, :]
    for i in range(n):
        _close(states[:, :, i], before[i * chunk], 1e-12, f"S_{i}")
        _close(dstates[:, :, i], after[min((i + 1) * chunk, S) - 1], 1e-12, f"dS_{i}")
    _close(dstate, ds, 1e-12, "dstate")
    assert float(dstates[:, :, -1].abs().max()) == 0.0


@pytest.fixture
def one_thread():
    """Torch's intra-op pool cut to one thread for one test.  The plain
    backward's token loops issue thousands of small operations, and while
    the suite's other workers hold every core, each operation's hand-off
    to the pool costs more than its work: S = 512 took about a minute on
    the default pool and under a second on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_chunked_dlogw_is_resolved_at_strong_decays(one_thread):
    """At strong decays (logw ~ -7 a token) dlogw is ~1e-3 of r . dr~: the
    plain version's running sum of r . dr~ - k . dk~ carries its rounding
    into dlogw, and the chunked form, which sums no growing terms, is at
    least 10x closer to the f64 truth in norm on the same f32 inputs."""
    arrays = [a.astype(np.float32) for a in _inputs(1, 4, 512, 64, 3, 2.0)]
    f32 = [torch.from_numpy(a) for a in arrays]
    truth = wkv6_bwd_ref(*(x.double() for x in f32))[3]

    def err(dlogw):
        return float((dlogw.double() - truth).norm() / truth.norm())

    running, direct = err(wkv6_bwd_ref(*f32)[3]), err(wkv6_bwd_chunk_ref(*f32)[3])
    assert direct * 10 <= running, (direct, running)


@pytest.mark.parametrize("B,H,S,D", [(1, 2, 1, 4), (2, 1, 5, 4), (1, 2, 9, 8)])
def test_wkv6_fn_gradcheck(B, H, S, D):
    arrays = _inputs(B, H, S, D, seed=S, decay_mean=-1.0)
    leaves = tuple(torch.from_numpy(a).requires_grad_(True) for a in arrays[:6])
    assert torch.autograd.gradcheck(lambda *x: WKV6Fn.apply(*x)[0], leaves)


def test_wkv6_fn_final_state_is_not_differentiable():
    arrays = _inputs(1, 2, 5, 8, seed=0)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:6]]
    out, s1 = WKV6Fn.apply(*leaves)
    assert out.requires_grad and not s1.requires_grad
    ref_out, ref_s1 = wkv6_scan_ref(*[x.detach() for x in leaves])
    torch.testing.assert_close(out.detach(), ref_out, rtol=0, atol=0)
    torch.testing.assert_close(s1, ref_s1, rtol=0, atol=0)
    # the state's gradient is skipped where it is not wanted
    dr, dk, dv, dlogw, du, ds = wkv6_bwd_op(
        *[x.detach() for x in leaves], torch.from_numpy(arrays[6]), need_dstate=False)
    assert ds is None and du.shape == leaves[4].shape


def test_cpu_op_with_a_gradient_stays_the_plain_autograd_op():
    """On the CPU ``wkv6_op`` is autograd of ``wkv6_scan_ref`` (no
    ``WKV6Fn``), launches nothing, and agrees with the plain backward."""
    common.reset_launch_counts()
    arrays = _inputs(1, 2, 20, 8, seed=3)
    tensors = [torch.from_numpy(a).float() for a in arrays]
    leaves = [t.clone().requires_grad_(True) for t in tensors[:6]]
    out, _ = wkv6_op(*leaves)
    assert type(out.grad_fn).__name__ != "WKV6FnBackward"
    out.backward(tensors[6])
    for name, leaf, want in zip(NAMES, leaves, wkv6_bwd_ref(*tensors)):
        _close(leaf.grad, want, 2e-5, name)
    assert all(n == 0 for n in common.launch_counts.values())


def test_backward_operands_refused_off_the_cpu():
    """A call off the CPU that needs a gradient must be bf16 at D = 64 with
    no ``out_state`` (checked on the meta device, which needs no card), and
    a bf16 D = 64 one goes on to ``WKV6Fn`` and its device check."""
    def meta(*shape, dtype=torch.float32, grad=False):
        return torch.empty(*shape, device="meta", dtype=dtype, requires_grad=grad)

    def call(D, dtype, out_state=None):
        r = meta(1, 2, 3, D, dtype=dtype, grad=True)
        return wkv6_op(r, meta(1, 2, 3, D, dtype=dtype), meta(1, 2, 3, D, dtype=dtype),
                       meta(1, 2, 3, D), meta(2, D), meta(1, 2, D, D), out_state=out_state)

    with pytest.raises(RuntimeError, match="wkv6_op: .* takes bf16"):
        call(64, torch.float32)
    with pytest.raises(RuntimeError, match="wkv6_op: .* head_dim 64, got 128"):
        call(128, torch.bfloat16)
    with pytest.raises(RuntimeError, match="wkv6_op: out_state"):
        call(64, torch.bfloat16, out_state=meta(1, 2, 64, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        call(64, torch.bfloat16)
    assert wkv6_ops.check_backward_operands(meta(1, 1, 1, 64, dtype=torch.bfloat16)) is None


def test_bwd_op_checks_the_cotangent_shape():
    arrays = _inputs(1, 2, 5, 8, seed=1)
    tensors = [torch.from_numpy(a).float() for a in arrays]
    with pytest.raises(ValueError, match="dout"):
        wkv6_bwd_op(*tensors[:6], tensors[6][:, :, :4])


def test_bwd_argtypes_match_the_c_entry_point():
    """ctypes passes what ``_BWD_ARGTYPES`` says whatever the C side
    expects, so a mismatch would only show on the card: check it here."""
    src = (common.CSRC_DIR / "wkv6_bwd.cu").read_text()
    body = re.search(r"int wkv6_bwd\((.*?)\)\s*{", src, re.S).group(1)
    params = [p.strip() for p in body.split(",")]
    assert len(params) == len(wkv6_ops._BWD_ARGTYPES)
    ctypes = wkv6_ops.ctypes
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long*": ctypes.POINTER(ctypes.c_longlong)}
    for param, argtype in zip(params, wkv6_ops._BWD_ARGTYPES):
        assert argtype is kinds[param.rsplit(" ", 1)[0].replace("const ", "")], param


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

BF16_TOL = 2e-2
ROW_REL_TOL = 0.05
GPU_CASES = [(1, 2, 1, -1.0), (2, 3, 37, 2.0), (1, 4, 100, -4.0), (2, 2, 300, -1.0)]


@pytest.mark.gpu
def test_cuda_wkv6_backward_matches_plain_version():
    """The kernel's six gradients against the plain backward in f64 on the
    same bf16 inputs (transposed (B, S, H, D) views, as the model passes
    them), within BF16_TOL of each value and, row by row, ROW_REL_TOL of
    the row's RMS, dlogw's rows at strong decays (mean 2.0) too, where it
    is ~1e-3 of the terms the plain version's running sum subtracts; dlogw
    also as a whole, its error's norm within ROW_REL_TOL of its norm; two
    calls give the same bits; one launch count per call; and the same
    gradients through autograd, after one forward launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    common.reset_launch_counts()
    for B, H, S, decay_mean in GPU_CASES:
        r, k, v, logw, u, state, dout = (torch.from_numpy(a).float().to(dev)
                                         for a in _inputs(B, H, S, 64, S, decay_mean))
        r, k, v, dout = (x.transpose(1, 2).contiguous().transpose(1, 2).bfloat16()
                         for x in (r, k, v, dout))
        logw = logw.transpose(1, 2).contiguous().transpose(1, 2)
        grads = wkv6_bwd_op(r, k, v, logw, u, state, dout)
        again = wkv6_bwd_op(r, k, v, logw, u, state, dout)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(grads, again))
        f64 = [x.double() for x in (r, k, v, logw, u, state, dout)]
        truth = wkv6_bwd_ref(*f64)
        for name, g, want in zip(NAMES, grads, truth):
            torch.testing.assert_close(g.double(), want, atol=BF16_TOL, rtol=BF16_TOL,
                                       msg=name)
            if name == "dlogw":
                # at S = 1 dlogw is all zero (the final state's gradient is)
                err_norm, norm = float((g.double() - want).norm()), float(want.norm())
                assert err_norm <= ROW_REL_TOL * norm, (name, err_norm, norm)
            err = (g.double() - want).abs().amax(-1)
            rms = want.square().mean(-1).sqrt()
            assert bool((err <= ROW_REL_TOL * rms + 1e-6).all()), name
        leaves = [x.clone().requires_grad_(True) for x in (r, k, v, logw, u, state)]
        out, _ = wkv6_op(*leaves)
        out.backward(dout)
        for leaf, g in zip(leaves, grads):
            assert torch.equal(leaf.grad, g)
    n = len(GPU_CASES)
    assert common.launch_counts["wkv6_bwd"] == 3 * n
    assert common.launch_counts["wkv6_chunk"] + common.launch_counts["wkv6_scan"] == n


@pytest.mark.gpu
def test_cuda_op_refuses_a_gradient_it_cannot_take():
    """A CUDA call that requires grad at f32 or at D != 64 raises; nothing
    goes to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    common.reset_launch_counts()
    for D, dtype, match in ((64, torch.float32, "bf16"), (32, torch.bfloat16, "head_dim"),
                            (128, torch.bfloat16, "head_dim")):
        r = torch.randn(1, 2, 3, D, device=dev, dtype=dtype, requires_grad=True)
        with pytest.raises(RuntimeError, match=f"wkv6_op: .*{match}"):
            wkv6_op(r, r.detach(), r.detach(), -torch.rand(1, 2, 3, D, device=dev),
                    torch.zeros(2, D, device=dev), torch.zeros(1, 2, D, D, device=dev))
    assert all(n == 0 for n in common.launch_counts.values())
