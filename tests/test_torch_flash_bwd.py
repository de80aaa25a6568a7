"""The backward of the port's flash attention against the JAX package.

The reference has no backward kernel: its training differentiates the jnp
attention of its model layers.  So the plain backward
(``flash_attention_bwd_ref``, the explicit formula with P recomputed from
the log-sum-exp) is held against ``jax.vjp`` of the reference's
``causal_flash_attention`` (with ``q_chunk`` below S, so its chunking is
exercised) and ``bidirectional_attention``, and against ``torch.autograd``
of the plain forward; inputs and cotangents are numpy draws from a seed,
in f32, at head dims 32 to 256, and the bound is 1e-5 of each gradient's
scale (its largest magnitude).  ``FlashAttentionFn`` (the autograd plumbing around the
kernels) passes ``gradcheck`` on the CPU in f64, where it runs the plain
forward-with-LSE and backward.  The ``gpu``-marked tests hold the CUDA
kernels against the plain versions and skip where there is no card; the
JAX package is imported inside the tests that use it, so that those run
where JAX is absent.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_lse_ref,
                                                     flash_attention_ref)
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-5
# (B, Sq, Sk, H, KV, D, window, causal): G of 1, 4 and 8, D of 32, 64, 128
# and 256 (gemma-7b's, causal, windowed and non-causal), ragged lengths, a
# sliding window, non-causal at Sq != Sk
CASES = [
    (2, 37, 37, 4, 4, 32, 0, True),
    (1, 40, 40, 8, 2, 64, 0, True),
    (1, 33, 33, 8, 1, 128, 0, True),
    (2, 45, 45, 4, 1, 64, 8, True),
    (1, 50, 50, 8, 1, 32, 13, True),
    (2, 19, 41, 4, 4, 64, 0, False),
    (1, 29, 13, 8, 2, 128, 0, False),
    (1, 23, 31, 8, 1, 32, 0, False),
    (1, 35, 35, 4, 4, 256, 0, True),
    (2, 30, 30, 4, 2, 256, 9, True),
    (1, 21, 37, 2, 2, 256, 0, False),
]
IDS = [f"{'causal' if c[7] else 'full'}-w{c[6]}-S{c[1]}x{c[2]}-G{c[3] // c[4]}-D{c[5]}"
       for c in CASES]
Q_CHUNK = 16


def _inputs(seed, B, Sq, Sk, H, KV, D):
    """q, k, v and the output's cotangent, (B, S, heads, D) f32 numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    return q, k, v, do


def _plain_bwd(q, k, v, do, window, causal):
    """The plain backward in the port's (B, S, heads, D) layout, from the
    plain forward's output and log-sum-exp."""
    qt, kt, vt, dot = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, do))
    out, lse = flash_attention_fwd_lse_ref(qt, kt, vt, window=window,
                                           causal=causal)
    grads = flash_attention_bwd_ref(qt, kt, vt, out, dot, lse, window=window,
                                    causal=causal)
    return [g.transpose(1, 2).numpy() for g in grads]


def _close(ours, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    err = float(np.abs(np.asarray(ours, np.float32) - ref).max())
    assert err <= tol * scale, f"error {err} over scale {scale}"


@pytest.fixture(scope="module")
def jref():
    """(jax, jax.numpy, the reference's model layers)."""
    jax = pytest.importorskip("jax")
    return jax, jax.numpy, importlib.import_module("repro.models.layers")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case, jref):
    jax, jnp, jax_layers = jref
    B, Sq, Sk, H, KV, D, window, causal = case
    q, k, v, do = _inputs(1, B, Sq, Sk, H, KV, D)
    if causal:
        def attn(q, k, v):
            return jax_layers.causal_flash_attention(q, k, v, window=window,
                                                     q_chunk=Q_CHUNK)
    else:
        attn = jax_layers.bidirectional_attention
    @jax.jit
    def fwd_bwd(q, k, v, do):
        out, vjp = jax.vjp(attn, q, k, v)
        return out, vjp(do)

    out, ref = fwd_bwd(*(jnp.asarray(a) for a in (q, k, v, do)))
    ours = _plain_bwd(q, k, v, do, window, causal)
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        assert a.shape == b.shape, name
        _close(a, b)
    # the forward the backward starts from is the reference's too
    mine = flash_attention_ref(*(torch.from_numpy(a).transpose(1, 2)
                                 for a in (q, k, v)), window=window,
                               causal=causal).transpose(1, 2)
    _close(mine.numpy(), out)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_torch_autograd(case):
    B, Sq, Sk, H, KV, D, window, causal = case
    q, k, v, do = _inputs(2, B, Sq, Sk, H, KV, D)
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2).requires_grad_(True)
                  for a in (q, k, v))
    out = flash_attention_ref(qt, kt, vt, window=window, causal=causal)
    out.backward(torch.from_numpy(do).transpose(1, 2))
    ours = _plain_bwd(q, k, v, do, window, causal)
    for a, t in zip(ours, (qt, kt, vt)):
        _close(a, t.grad.transpose(1, 2).numpy())


@pytest.mark.parametrize("case", CASES[:3] + CASES[5:6], ids=IDS[:3] + IDS[5:6])
def test_fwd_lse_is_the_forward_and_its_logsumexp(case):
    B, Sq, Sk, H, KV, D, window, causal = case
    q, k, v, _ = _inputs(3, B, Sq, Sk, H, KV, D)
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    out, lse = flash_attention_fwd_lse_ref(qt, kt, vt, window=window,
                                           causal=causal)
    ref = flash_attention_ref(qt, kt, vt, window=window, causal=causal)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    G = H // KV
    scores = torch.einsum("bkgqd,bksd->bkgqs", qt.reshape(B, KV, G, Sq, D),
                          kt) / np.sqrt(D)
    if causal:
        pos = torch.arange(Sq)
        mask = pos[None, :] <= pos[:, None]
        if window > 0:
            mask &= pos[None, :] > pos[:, None] - window
        scores = scores.masked_fill(~mask, -torch.inf)
    want = torch.logsumexp(scores, -1).reshape(B, H, Sq)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,window,causal", [
    (1, 6, 6, 4, 2, 8, 0, True),
    (2, 7, 7, 2, 1, 8, 3, True),
    (1, 5, 9, 4, 1, 8, 0, False),
])
def test_flash_attention_fn_gradcheck(B, Sq, Sk, H, KV, D, window, causal):
    """The Function's plumbing in f64: saved tensors, the (B, S, H, D) <->
    (B, H, S, D) layouts and the GQA sum over a KV head's query heads."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(B, Sq, H, D, generator=gen, dtype=torch.float64)
    k = torch.randn(B, Sk, KV, D, generator=gen, dtype=torch.float64)
    v = torch.randn(B, Sk, KV, D, generator=gen, dtype=torch.float64)
    inputs = tuple(t.requires_grad_(True) for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_ops.FlashAttentionFn.apply(q, k, v, window, causal),
        inputs)


def test_op_takes_the_function_only_when_a_gradient_is_needed():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(4, 1, 9, 9, 4, 2, 16))
    common.reset_launch_counts()
    plain = flash_ops.flash_attention_op(q, k, v)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_(True)
    out = flash_ops.flash_attention_op(qg, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    torch.testing.assert_close(out, plain, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        assert flash_ops.flash_attention_op(qg, k, v).grad_fn is None
    out.sum().backward()
    assert qg.grad.shape == q.shape
    assert all(n == 0 for n in common.launch_counts.values())


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_backward_takes_bf16_and_f32_at_every_head_dim(dtype):
    """On the meta device (the card's checks, no card): a call that needs a
    gradient is taken in bf16 and in f32 at D = 256 as at the other head
    dims of ``HEAD_DIMS``, and refused by name in f16 or at a head dim
    outside ``HEAD_DIMS``; the backward's meta call plans and counts as the
    card's would."""
    assert flash_ops.BWD_HEAD_DIMS == (32, 64, 128, 256)
    for D in flash_ops.BWD_HEAD_DIMS:
        assert flash_ops.check_backward_operands(_meta(1, 8, 2, D, dtype=dtype)) is None
    with pytest.raises(RuntimeError, match="flash_attention_bwd: the backward kernels "
                       "take bf16 and f32, got torch.float16"):
        flash_ops.check_backward_operands(_meta(1, 8, 2, 256, dtype=torch.float16))
    with pytest.raises(RuntimeError, match=r"head_dim 96 not in \(32, 64, 128, 256\)"):
        flash_ops.check_backward_operands(_meta(1, 8, 2, 96, dtype=dtype))
    seen = []
    common.meta_counters.append(lambda name, shape: seen.append((name, shape)))
    try:
        q = _meta(2, 40, 4, 256, dtype=dtype).requires_grad_(True)
        k, v = _meta(2, 40, 4, 256, dtype=dtype), _meta(2, 40, 4, 256, dtype=dtype)
        out = flash_ops.flash_attention_op(q, k, v)
        dq, dk, dv = flash_ops.flash_attention_bwd_op(
            q.detach(), k, v, out.detach(), _meta(2, 40, 4, 256, dtype=dtype),
            _meta(2, 4, 40))
    finally:
        common.meta_counters.pop()
    assert out.dtype == dtype and dq.shape == q.shape and dk.shape == k.shape
    assert [name for name, _ in seen] == ["flash_attention", "flash_attention_bwd"]
    assert seen[0][1]["lse"] is True and seen[0][1]["dtype"] == str(dtype)
    want = (flash_ops.bwd_work_bytes_f32(2, 4, 40) if dtype == torch.float32 else
            flash_ops.bwd_work_bytes(flash_ops.plan_bwd_units(
                2, 4, 1, 40, 40, 0, True, 132, slots=1), 2, 4, 4, 40, 256))
    assert seen[1][1]["scratch"] == want


def test_f32_forward_with_lse_counts_one_call():
    """``flash_attention_fwd_lse`` on f32 meta tensors (the f32 training
    forward) takes the card's checks and counts one flash call with its
    LSE: the output in q's layout and dtype, the (B, H, Sq) f32 rows."""
    seen = []
    common.meta_counters.append(lambda name, shape: seen.append((name, shape)))
    common.reset_launch_counts()
    try:
        out, lse = flash_ops.flash_attention_fwd_lse(
            _meta(2, 33, 8, 128), _meta(2, 33, 2, 128), _meta(2, 33, 2, 128), window=16)
    finally:
        common.meta_counters.pop()
    assert out.shape == (2, 33, 8, 128) and out.dtype == torch.float32
    assert lse.shape == (2, 8, 33) and lse.dtype == torch.float32
    assert seen == [("flash_attention", {"B": 2, "Sq": 33, "Sk": 33, "H": 8, "KV": 2,
                                         "D": 128, "window": 16, "causal": True,
                                         "dtype": "torch.float32", "lse": True})]
    assert all(n == 0 for n in common.launch_counts.values())


def test_wrappers_without_a_backward_refuse_a_gradient_off_the_cpu():
    """``decode_attention_op`` refuses, by the wrapper's name, a call off
    the CPU whose input requires grad, and ``wkv6_op`` one its backward
    kernel cannot take (here f32 at D = 32; checked on the meta device,
    which needs no card); under no_grad the meta device (the dry-run's)
    takes the card's checks, returns empty outputs and launches nothing; on
    the CPU they stay plain autograd ops."""
    from repro_torch.kernels.decode_attention import decode_attention_op
    from repro_torch.kernels.rwkv6_scan import wkv6_op

    def meta(*shape):
        return torch.empty(*shape, device="meta", requires_grad=True)

    with pytest.raises(RuntimeError, match="decode_attention_op"):
        decode_attention_op(meta(2, 4, 64), meta(2, 2, 8, 64), meta(2, 2, 8, 64), 3)
    wkv = (meta(1, 2, 3, 32), meta(1, 2, 3, 32), meta(1, 2, 3, 32),
           meta(1, 2, 3, 32), meta(2, 32), meta(1, 2, 32, 32))
    with pytest.raises(RuntimeError, match="wkv6_op"):
        wkv6_op(*wkv)
    common.reset_launch_counts()
    with torch.no_grad():
        out, state = wkv6_op(*wkv)
    assert out.device.type == "meta" and tuple(out.shape) == (1, 2, 3, 32)
    assert tuple(state.shape) == (1, 2, 32, 32)
    assert all(n == 0 for n in common.launch_counts.values())
    # on the CPU the plain decode version passes a gradient
    q = torch.randn(2, 4, 16, requires_grad=True)
    out = decode_attention_op(q, torch.randn(2, 2, 8, 16), torch.randn(2, 2, 8, 16), 5)
    out.sum().backward()
    assert q.grad is not None and bool(q.grad.abs().sum() > 0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

GPU_CASES = [
    (2, 300, 300, 16, 2, 128, 0, True),    # qwen2.5-3b's heads, G = 8
    (1, 1000, 1000, 32, 8, 128, 0, True),  # ragged S
    (1, 700, 700, 25, 5, 64, 256, True),   # hymba's heads under a window
    (2, 137, 137, 12, 12, 64, 0, False),   # e5-base-v2
    (2, 137, 137, 12, 12, 32, 0, False),   # reranker-minilm
    (1, 77, 301, 32, 8, 128, 0, False),    # cross-attention, Sq != Sk
    (1, 1, 1, 4, 2, 64, 0, True),
    (1, 300, 300, 16, 16, 256, 0, True),   # gemma-7b's heads: one-worker wgmma
    (1, 200, 200, 4, 2, 256, 64, True),    # D = 256 under a window
]
# the f32 kernels: (case, dtype)
GPU_CASES = [(c, torch.bfloat16) for c in GPU_CASES] + [
    ((1, 300, 300, 16, 2, 128, 0, True), torch.float32),
    ((1, 200, 200, 16, 16, 256, 32, True), torch.float32),
    ((2, 77, 130, 12, 12, 64, 0, False), torch.float32),
    ((1, 90, 90, 4, 4, 32, 0, True), torch.float32),
]
ROW_REL_TOL = 0.05
BF16_TOL = 2e-2
F32_TOL = 2e-5


def _rows_close(out, truth, rows=None):
    """Each row held (``rows``, a mask over the leading dims; all by
    default) within ROW_REL_TOL of its RMS, a zero row exactly zero."""
    err = (out.float() - truth).abs().amax(-1)
    rms = truth.square().mean(-1).sqrt()
    if rows is not None:
        rows = rows.expand_as(err)
        err, rms = err[rows], rms[rows]
    assert bool((err[rms == 0] == 0).all())
    if bool((rms > 0).any()):
        assert float((err[rms > 0] / rms[rms > 0]).max()) <= ROW_REL_TOL


@pytest.mark.gpu
def test_cuda_flash_backward_matches_plain_version():
    """The backward kernel's dq, dk, dv and the forward's lse against the
    plain versions in f32 on the same bf16 (or f32) inputs, within
    BF16_TOL (F32_TOL) and, row by row, ROW_REL_TOL of the row's RMS; one
    backward launch per call; and the same through autograd
    (``FlashAttentionFn``).  The dq of
    a query that sees one key (a causal call's first) is zero
    analytically, and so is the dk of a key that only such queries see,
    which both sides reach only up to rounding: those rows are held by
    BF16_TOL alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    common.reset_launch_counts()
    for (B, Sq, Sk, H, KV, D, window, causal), dtype in GPU_CASES:
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL

        def rnd(*shape):
            return (torch.randn(*shape, generator=gen, device=dev) * 0.5).to(dtype)
        q, k, v, do = rnd(B, Sq, H, D), rnd(B, Sk, KV, D), rnd(B, Sk, KV, D), rnd(B, Sq, H, D)
        out, lse = flash_ops.flash_attention_fwd_lse(q, k, v, window=window, causal=causal)
        grads = flash_ops.flash_attention_bwd_op(q, k, v, out, do, lse,
                                                 window=window, causal=causal)
        torch.cuda.synchronize()
        t = [x.transpose(1, 2).float() for x in (q, k, v, out, do)]
        _, lse_ref = flash_attention_fwd_lse_ref(*t[:3], window=window, causal=causal)
        torch.testing.assert_close(lse, lse_ref, atol=tol, rtol=tol)
        truth = flash_attention_bwd_ref(*t, lse, window=window, causal=causal)
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=dev)
        if causal:
            pos = torch.arange(Sq, device=dev)
            mask = pos[None, :] <= pos[:, None]
            if window > 0:
                mask &= pos[None, :] > pos[:, None] - window
        multi_q = mask.sum(1) > 1
        multi_k = (mask & multi_q[:, None]).any(0)
        held = (multi_q[None, :, None], multi_k[None, :, None], None)
        for g, ref, rows in zip(grads, truth, held):
            ref = ref.transpose(1, 2)
            torch.testing.assert_close(g.float(), ref, atol=tol, rtol=tol)
            _rows_close(g, ref, rows)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        flash_ops.flash_attention_op(*leaves, window=window, causal=causal).backward(do)
        for leaf, g in zip(leaves, grads):
            assert torch.equal(leaf.grad, g)
    n = len(GPU_CASES)
    assert common.launch_counts["flash_attention_bwd"] == 2 * n
    assert common.launch_counts["flash_attention"] == 2 * n


@pytest.mark.gpu
def test_cuda_wrappers_without_a_backward_raise_on_a_gradient():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.decode_attention import decode_attention_op
    from repro_torch.kernels.rwkv6_scan import wkv6_op

    dev = torch.device("cuda")
    q = torch.randn(2, 4, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    kc = torch.randn(2, 2, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="decode_attention_op"):
        decode_attention_op(q, kc, kc, 3)
    # f32: the WKV6 backward kernel takes bf16 only
    r = torch.randn(1, 2, 3, 64, device=dev, requires_grad=True)
    logw = -torch.rand(1, 2, 3, 64, device=dev)
    with pytest.raises(RuntimeError, match="wkv6_op"):
        wkv6_op(r, r.detach(), r.detach(), logw, torch.zeros(2, 64, device=dev),
                torch.zeros(1, 2, 64, 64, device=dev))
    # f16: the flash backward kernels take bf16 and f32
    with pytest.raises(RuntimeError, match="bf16 and f32"):
        flash_ops.flash_attention_op(q.half()[:, None].expand(2, 4, 4, 64),
                                     kc.half().transpose(1, 2)[:, :4],
                                     kc.half().transpose(1, 2)[:, :4])
