"""The port's training (loss, gradients, AdamW, train step, launcher)
against the JAX package.

Weights come from ``build_model(cfg).init(jax.random.key(0))`` cast to f32
and cross through ``repro_torch.bridge``; batches come from the
reference's ``SyntheticCorpus``.  The loss and every gradient are held to
``jax.value_and_grad(bundle.loss_fn)`` within 1e-4 of each one's scale
(its largest magnitude): in f32 both sides sum the same products in
another order.  The reference's gradient tree is loaded into a shell
``DenseLM`` by the bridge, so gradients are compared by the model's own
names.  AdamW is held to the reference's ``apply_updates`` within 1e-6 of
each tensor's scale in f32 (one bf16 ulp for bf16 weights, which both
sides round from f32 values that may differ in the last bit).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.models.layers import cross_entropy_from_logits as jax_cross_entropy
from repro.training import optimizer as jax_opt
from repro.training.data import DataConfig, SyntheticCorpus
from repro.training.train_loop import make_train_step as jax_make_train_step
from repro_torch.bridge import load_reference_params
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.launch.train import main as train_main
from repro_torch.models import build_model
from repro_torch.models.layers import cross_entropy_from_logits
from repro_torch.models.transformer import make_microbatched_loss
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import make_train_step
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4
ARCHS = ["qwen2.5-3b", "llama-3.2-1b", "granite-moe-3b-a800m"]


def _pair(arch):
    """The reference bundle and its f32 params, and the port's f32 model
    on the CPU with those params."""
    jcfg = jax_reduced_config(jax_get_config(arch))
    bundle = jax_build_model(jcfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          bundle.init(jax.random.key(0)))
    cfg = reduced_config(get_config(arch))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return cfg, bundle, params, model


def _batch(cfg, batch=4, seq=24, step=0):
    return SyntheticCorpus(DataConfig(cfg.vocab_size, seq, batch)).batch_at(step)


def _close(ours, ref, tol=TOL, what=""):
    ref = np.asarray(ref, np.float32)
    ours = np.asarray(ours, np.float32)
    assert ours.shape == ref.shape, what
    scale = float(np.abs(ref).max())
    err = float(np.abs(ours - ref).max())
    assert err <= tol * scale, f"{what}: error {err} over scale {scale}"


def _grads_by_name(model, cfg, tree):
    """A reference gradient tree as {name: tensor} of the port's model,
    through a shell model loaded by the bridge."""
    shell = build_model(cfg, device="cpu", dtype=torch.float32)
    load_reference_params(shell, jax.tree.map(np.asarray, tree))
    return {name: p.detach() for name, p in shell.named_parameters()}


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    ref = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    ours = cross_entropy_from_logits(torch.from_numpy(logits),
                                     torch.from_numpy(labels))
    assert ours.dtype == torch.float32 and ours.ndim == 0
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    # bf16 logits are taken in f32, as the reference's
    ref = jax_cross_entropy(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels))
    ours = cross_entropy_from_logits(torch.from_numpy(logits).bfloat16(),
                                     torch.from_numpy(labels))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_value_and_grad(arch):
    cfg, bundle, params, model = _pair(arch)
    batch = _batch(cfg)
    loss, grads = jax.jit(jax.value_and_grad(bundle.loss_fn))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model.requires_grad_(True)
    ours = model.forward_loss(torch.from_numpy(batch["tokens"]),
                              torch.from_numpy(batch["labels"]))
    ours.backward()
    _close(ours.detach(), loss, what="loss")
    ref = _grads_by_name(model, cfg, grads)
    for name, p in model.named_parameters():
        _close(p.grad, ref[name], what=name)
        assert float(ref[name].abs().max()) > 0, name


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("mu", [2, 4])
def test_microbatched_gradients_equal_the_whole_batch(arch, mu):
    cfg = reduced_config(get_config(arch))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, batch=8).items()}
    runs = []
    for n in (1, mu):
        model.zero_grad(set_to_none=True)
        loss = make_microbatched_loss(model.forward_loss, n)(batch)
        runs.append((loss, {k: p.grad.clone() for k, p in model.named_parameters()}))
    (whole, g1), (split, g2) = runs
    assert not split.requires_grad
    _close(split, whole, 1e-6, "loss")
    for name in g1:
        _close(g2[name], g1[name], 1e-5, name)
    with pytest.raises(ValueError, match="microbatches"):
        make_microbatched_loss(model.forward_loss, 3)(batch)


def _opt_tree(seed, shapes, grad_scale):
    rng = np.random.default_rng(seed)
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    grads = {n: (rng.standard_normal(s) * grad_scale).astype(np.float32)
             for n, s in shapes.items()}
    m = {n: (rng.standard_normal(s) * 0.01).astype(np.float32) for n, s in shapes.items()}
    v = {n: np.abs(rng.standard_normal(s) * 1e-4).astype(np.float32)
         for n, s in shapes.items()}
    return params, grads, m, v


# (case, start step, gradient scale, config): a warm-up step from zero
# moments, a clipped step (global norm far above grad_clip) and a step past
# the warm-up from nonzero moments
OPT_CASES = [("warmup", 0, 0.01, jax_opt.AdamWConfig(lr=1e-3, warmup_steps=10)),
             ("clipped", 3, 5.0, jax_opt.AdamWConfig(lr=1e-3, warmup_steps=10)),
             ("steady", 20, 0.05, jax_opt.AdamWConfig())]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,step,grad_scale,jcfg", OPT_CASES,
                         ids=[c[0] for c in OPT_CASES])
def test_adamw_step_matches_apply_updates(case, step, grad_scale, jcfg, dtype):
    shapes = {"w": (17, 9), "b": (9,), "e": (5, 3, 4)}
    params, grads, m, v = _opt_tree(7, shapes, grad_scale)
    if step == 0:
        m = {n: np.zeros_like(a) for n, a in m.items()}
        v = {n: np.zeros_like(a) for n, a in v.items()}
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jparams = {n: jnp.asarray(a, jdt) for n, a in params.items()}
    jstate = jax_opt.AdamWState(step=jnp.asarray(step, jnp.int32),
                                m={n: jnp.asarray(a) for n, a in m.items()},
                                v={n: jnp.asarray(a) for n, a in v.items()})
    new_p, new_s = jax_opt.apply_updates(
        jparams, {n: jnp.asarray(a, jdt) for n, a in grads.items()}, jstate, jcfg)

    tparams = {n: torch.from_numpy(a).to(tdt) for n, a in params.items()}
    state = opt.AdamWState(step=torch.tensor(step, dtype=torch.int32),
                           m={n: torch.from_numpy(a.copy()) for n, a in m.items()},
                           v={n: torch.from_numpy(a.copy()) for n, a in v.items()})
    cfg = opt.AdamWConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    tgrads = {n: torch.from_numpy(a).to(tdt) for n, a in grads.items()}
    gnorm = float(opt.global_norm(tgrads.values()))
    np.testing.assert_allclose(gnorm, float(jax_opt.global_norm(
        {n: jnp.asarray(a, jdt) for n, a in grads.items()})), rtol=1e-6)
    assert (gnorm > jcfg.grad_clip) == (case == "clipped")
    new_state = opt.apply_updates(tparams, tgrads, state, cfg)

    assert int(new_state.step) == int(new_s.step) == step + 1
    ptol = 1e-6 if dtype == "float32" else 2 ** -7
    for n in shapes:
        assert tparams[n].dtype == tdt
        _close(tparams[n].float(), jnp.asarray(new_p[n], jnp.float32), ptol, n)
        _close(new_state.m[n], new_s.m[n], 1e-6, f"m.{n}")
        _close(new_state.v[n], new_s.v[n], 1e-6, f"v.{n}")
        assert new_state.m[n].dtype == torch.float32


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-3b-a800m"])
def test_train_step_matches_reference_train_step(arch):
    """Two steps of the port's train step (two microbatches) against the
    reference's ``make_train_step`` over its whole batch: each step's loss
    within TOL of its scale, the step count, and every weight's update.
    AdamW's first steps move an element by about lr times the sign of its
    gradient, so an element whose gradient is within rounding of zero (a
    few of the qkv biases') may move either way on either side: each
    weight's update is held in RMS, within 1% of the reference's."""
    cfg, bundle, params, model = _pair(arch)
    start = {name: p.detach().clone() for name, p in model.named_parameters()}
    jcfg = jax_opt.AdamWConfig(lr=1e-3, warmup_steps=2)
    jstep = jax.jit(jax_make_train_step(bundle, jcfg))
    jstate = jax_opt.init_state(params)
    train_step = make_train_step(model, opt.AdamWConfig(lr=1e-3, warmup_steps=2),
                                 num_microbatches=2)
    state = opt.init_state(dict(model.named_parameters()))
    assert all(p.requires_grad for p in model.parameters())
    for step in range(2):
        batch = _batch(cfg, step=step)
        params, jstate, jmetrics = jstep(
            params, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, metrics = train_step(state, batch)
        _close(metrics["loss"], jmetrics["loss"], what="loss")
        assert int(metrics["step"]) == int(jmetrics["step"]) == step + 1
    ref = _grads_by_name(model, cfg, params)
    for name, p in model.named_parameters():
        moved = (ref[name] - start[name]).square().mean().sqrt()
        err = (p.detach() - ref[name]).square().mean().sqrt()
        assert float(moved) > 0 and float(err) <= 1e-2 * float(moved), name


def test_data_pipeline_is_the_reference_copy():
    ours = REPO / "src" / "repro_torch" / "training" / "data.py"
    ref = REPO / "src" / "repro" / "training" / "data.py"
    assert ours.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-3b-a800m", "rwkv6-7b"])
def test_launcher_loss_decreases(arch):
    """The reference's ``test_loss_decreases`` arguments, on the CPU."""
    losses = train_main(["--device", "cpu", "--arch", arch, "--steps", "20",
                         "--batch", "8", "--seq", "32", "--lr", "2e-3"])
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < 0.75 * np.mean(losses[:5]), (
        f"{arch}: loss did not decrease: {losses[:3]} ... {losses[-3:]}")
