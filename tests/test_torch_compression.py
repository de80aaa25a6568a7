"""The port's int8 gradient compression with error feedback
(``repro_torch.distributed.compression``) against the JAX package's: bit
for bit on the same arrays, through 20 steps of error feedback, the
reference's own properties run on the port, and a compressed train step
against the reference's ``value_and_grad`` -> ``compress_tree`` ->
``apply_updates``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.distributed import compression as ref
from repro.models import build_model as jax_build_model
from repro.training import optimizer as jax_opt
from repro.training.data import DataConfig, SyntheticCorpus
from repro_torch.bridge import load_reference_params
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.distributed import compression as port
from repro_torch.launch.train import main as train_main
from repro_torch.models import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import make_train_step

SHAPES = [(1,), (255,), (256,), (1000,), (64, 64)]
DTYPES = ["float32", "bfloat16"]
# a reduced qwen2.5-3b width at which every layer's weight is a whole
# number of compression blocks
WIDE = 1024


@pytest.fixture(autouse=True)
def one_thread():
    """Torch's intra-op pool cut to one thread: these small models' steps
    issue thousands of tiny operations, and while the suite's other
    workers hold every core each one's hand-off to the pool costs more
    than its work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _inputs(shape, dtype, seed, zero_block=False):
    """The same values as a jnp array and a torch tensor of ``dtype``
    (heavy-tailed, so that blocks' scales differ); with ``zero_block``
    the first block is all zeros."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.exponential(1.0, shape) * 3).astype(np.float32)
    if zero_block:
        x.reshape(-1)[:port.BLOCK] = 0
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(getattr(torch, dtype))
    return j, t


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _equal(ours, theirs):
    assert ours.shape == tuple(theirs.shape)
    a, b = _np(ours), _np(theirs)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES + ["zero_block"])
def test_quantize_and_compress_are_bit_equal_to_the_reference(shape, dtype):
    zero = shape == "zero_block"
    shape = (1000,) if zero else shape
    jx, tx = _inputs(shape, dtype, 0, zero_block=zero)
    q, s = ref.quantize_int8(jx)
    tq, ts = port.quantize_int8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _equal(tq, q)
    _equal(ts, s)
    if zero:
        assert float(ts[0]) == 1.0 and not tq[0].any()
    _equal(port.dequantize_int8(tq, ts, shape), ref.dequantize_int8(q, s, shape))
    je, te = _inputs(shape, "float32", 1)
    je, te = je * 0.01, te * 0.01
    sent, err = ref.compress_tree({"w": jx}, {"w": je})
    tsent, terr = port.compress_tree({"w": tx}, {"w": te})
    assert tsent["w"].dtype == tx.dtype and terr["w"].dtype == torch.float32
    _equal(tsent["w"], sent["w"])
    _equal(terr["w"], err["w"])


def test_error_feedback_is_bit_equal_to_the_reference_for_20_steps():
    names = ("w", "b")
    shapes = {"w": (64, 64), "b": (300,)}
    err = ref.init_error({n: jnp.zeros(shapes[n]) for n in names})
    terr = port.init_error({n: torch.zeros(shapes[n]) for n in names})
    for n in names:
        assert terr[n].dtype == torch.float32 and not terr[n].any()
    for i in range(20):
        grads = {n: _inputs(shapes[n], "bfloat16", 10 * i + k)
                 for k, n in enumerate(names)}
        sent, err = ref.compress_tree({n: g[0] for n, g in grads.items()}, err)
        tsent, terr = port.compress_tree({n: g[1] for n, g in grads.items()}, terr)
        for n in names:
            _equal(tsent[n], sent[n])
            _equal(terr[n], err[n])


def test_int8_quantization_bounded_error():
    """The reference's ``test_int8_quantization_bounded_error`` on the port."""
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 3.0
    q, s = port.quantize_int8(x)
    deq = port.dequantize_int8(q, s, x.shape)
    err = (deq - x).abs().max()
    assert float(err) <= float(x.abs().max()) / 127.0 + 1e-6


def test_error_feedback_preserves_signal():
    """The reference's ``test_error_feedback_preserves_signal`` on the port."""
    err = port.init_error({"w": torch.zeros(64, 64)})
    total_sent = torch.zeros(64, 64)
    total_true = torch.zeros(64, 64)
    for i in range(20):
        g = {"w": torch.randn(64, 64, generator=torch.Generator().manual_seed(i + 2)) * 0.1}
        total_true += g["w"]
        sent, err = port.compress_tree(g, err)
        total_sent += sent["w"]
    resid = float((total_sent + err["w"] - total_true).abs().max())
    assert resid < 1e-3


def test_launcher_loss_decreases_with_compression():
    """The reference's ``test_loss_decreases_with_compression`` arguments."""
    losses = train_main(["--device", "cpu", "--arch", "qwen2.5-3b", "--steps", "20",
                         "--batch", "8", "--seq", "32", "--lr", "2e-3",
                         "--compress"])
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5])


def _close(ours, theirs, tol, what):
    theirs = np.asarray(theirs, np.float32)
    ours = np.asarray(ours, np.float32)
    scale = float(np.abs(theirs).max())
    err = float(np.abs(ours - theirs).max())
    assert err <= tol * scale, f"{what}: error {err} over scale {scale}"


def test_compressed_train_step_matches_the_reference():
    """Two steps of ``make_train_step(compress=True)`` on weights bridged
    from the reference's init against its ``value_and_grad`` ->
    ``compress_tree`` -> ``apply_updates``, to the tolerances of
    ``test_train_step_matches_reference_train_step``: each loss within
    1e-4 of its scale, and each weight's update within 1% of its RMS.

    The reference compresses each leaf of its layer-stacked tree and the
    port each layer's weight, so their blocks of BLOCK values coincide
    only where every layer's weight is a whole number of blocks, as at
    qwen2.5-3b's full width.  The reduced config here is cut to a width
    (1024; KV projections of 256) where that holds too."""
    arch = "qwen2.5-3b"
    bundle = jax_build_model(jax_reduced_config(jax_get_config(arch), d_model=WIDE))
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          bundle.init(jax.random.key(0)))
    cfg = reduced_config(get_config(arch), d_model=WIDE)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    assert all(p.numel() % port.BLOCK == 0 for p in model.parameters())
    load_reference_params(model, jax.tree.map(np.asarray, params))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}

    jcfg = jax_opt.AdamWConfig(lr=1e-3, warmup_steps=2)
    grad_fn = jax.jit(jax.value_and_grad(bundle.loss_fn))
    # as the reference's launcher runs them: the update jitted, the
    # compression eager (jitted, XLA's fused quotients can differ from the
    # eager ones in their last bit)
    update_fn = jax.jit(lambda p, g, s: jax_opt.apply_updates(p, g, s, jcfg))
    err = ref.init_error(params)
    jstate = jax_opt.init_state(params)
    step_fn = make_train_step(model, opt.AdamWConfig(lr=1e-3, warmup_steps=2),
                              compress=True)
    state = opt.init_state(dict(model.named_parameters()))
    data = SyntheticCorpus(DataConfig(cfg.vocab_size, 24, 4))
    for step in range(2):
        batch = data.batch_at(step)
        loss, grads = grad_fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
        grads, err = ref.compress_tree(grads, err)
        params, jstate = update_fn(params, grads, jstate)
        state, metrics = step_fn(state, batch)
        _close(metrics["loss"], loss, 1e-4, "loss")
        assert int(metrics["step"]) == int(jstate.step) == step + 1
    shell = build_model(cfg, device="cpu", dtype=torch.float32)
    load_reference_params(shell, jax.tree.map(np.asarray, params))
    want = dict(shell.named_parameters())
    for name, p in model.named_parameters():
        moved = (want[name] - start[name]).square().mean().sqrt()
        diff = (p.detach() - want[name]).square().mean().sqrt()
        assert float(moved) > 0 and float(diff) <= 1e-2 * float(moved), name
