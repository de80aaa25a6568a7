"""The port's training of the encoders, rwkv6-7b, hymba, the VLM and the
enc-dec against the JAX package.

Each family's config is cut to a few layers and narrow widths, and the
port and the reference agree on it field by field: the encoders at the
head dims they run at full size (e5-base-v2 64, reranker-minilm 32),
hymba at three layers, a full-attention singleton and a window run of
two (W = 8, the heads of ``test_torch_hymba.py``), the VLM at two
groups of two self layers and a cross layer, seamless-m4t-large-v2 at two
encoder and two decoder layers, rwkv6-7b at ``reduced_config``'s two
layers of four heads of 16.  Weights come from
``build_model(cfg).init(jax.random.key(0))`` cast to f32 and cross
through ``repro_torch.bridge``; the VLM's gates are set to seeded nonzero
values on both sides (the reference's zero gates would leave every cross
weight but the gates without a gradient).  Batches are the reference's
``SyntheticCorpus`` with seeded standard normal image embeddings or audio
frames.  The loss and every gradient are held to
``jax.value_and_grad(bundle.loss_fn)`` within 1e-4 of each one's scale
(its largest magnitude), as ``test_torch_training.py`` holds the
decoders': in f32 both sides sum the same products in another order.
hymba runs at S = 24 over its window of 8, which the loss may pass (it
writes no ring).  rwkv6-7b runs at S = 24 and at S = 128, two of the
reference's chunks of 64 (its ``wkv6_chunked`` takes no other length past
one chunk): the port's CPU loss is autograd of the token-by-token
recurrence, the reference's JAX's of the chunked form.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.training import optimizer as jax_opt
from repro.training.data import DataConfig, SyntheticCorpus
from repro.training.train_loop import make_train_step as jax_make_train_step
from repro_torch.bridge import load_reference_params
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.launch.train import main as train_main
from repro_torch.models import build_model
from repro_torch.models.transformer import make_microbatched_loss
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import make_train_step
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-4
# arch -> (reduced_config arguments, fields replaced after it)
CONFIGS = {
    "e5-base-v2": (dict(d_model=256), {}),
    "reranker-minilm": (dict(d_model=128), {}),
    "hymba-1.5b": ({}, dict(num_layers=3, full_attn_layers=(0,), d_model=80,
                            num_heads=5, num_kv_heads=1, head_dim=16)),
    "llama-3.2-vision-11b": (dict(layers=4), {}),
    "seamless-m4t-large-v2": ({}, {}),
}
RWKV = ("rwkv6-7b", ({}, {}))
ARCHS = list(CONFIGS)
SEQ = 24
# (arch, seq) of the loss-and-gradient test, ids as the arch alone where
# the length is SEQ
LOSS_CASES = [pytest.param(arch, SEQ, id=arch) for arch in ARCHS + ["rwkv6-7b"]]
LOSS_CASES.append(pytest.param("rwkv6-7b", 128, id="rwkv6-7b-two-chunks"))


def _configs(arch):
    reduce, changes = dict([RWKV], **CONFIGS)[arch]
    cfg = dataclasses.replace(reduced_config(get_config(arch), **reduce), **changes)
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(arch), **reduce),
                               **changes)
    assert cfg.to_dict() == jcfg.to_dict()
    return cfg, jcfg


def _gates(params, groups):
    """The VLM's params with every gate and gate_mlp set to a seeded
    nonzero value, |g| in [0.4, 1.2], either sign, one per group."""
    rng = np.random.default_rng(7)
    mag = rng.uniform(0.4, 1.2, size=(2, groups)).astype(np.float32)
    values = mag * rng.choice(np.array([-1.0, 1.0], np.float32), size=(2, groups))
    cross = dict(params["cross_layers"], gate=jnp.asarray(values[0]),
                 gate_mlp=jnp.asarray(values[1]))
    return dict(params, cross_layers=cross)


def _pair(arch):
    """The reference bundle and its f32 params, and the port's f32 model
    on the CPU with those params."""
    cfg, jcfg = _configs(arch)
    bundle = jax_build_model(jcfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          bundle.init(jax.random.key(0)))
    if cfg.family == "vlm":
        params = _gates(params, cfg.num_layers // cfg.cross_attn_every)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return cfg, bundle, params, model


def _batch(cfg, batch=4, seq=SEQ, step=0):
    """The corpus's tokens and labels, with the family's stub input drawn
    from a seed, row by row different (f32 numpy)."""
    out = SyntheticCorpus(DataConfig(cfg.vocab_size, seq, batch)).batch_at(step)
    rng = np.random.default_rng(100 + step)
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.vision_d_model), dtype=np.float32)
    elif cfg.family == "audio":
        out["audio_frames"] = rng.standard_normal(
            (batch, cfg.num_audio_frames, cfg.d_model), dtype=np.float32)
    return out


def _close(ours, ref, tol=TOL, what=""):
    ref = np.asarray(ref, np.float32)
    ours = np.asarray(ours, np.float32)
    assert ours.shape == ref.shape, what
    scale = float(np.abs(ref).max())
    err = float(np.abs(ours - ref).max())
    assert err <= tol * scale, f"{what}: error {err} over scale {scale}"


def _by_name(cfg, tree):
    """A reference tree (gradients or weights) as {name: tensor} of the
    port's model, through a shell model loaded by the bridge."""
    shell = build_model(cfg, device="cpu", dtype=torch.float32)
    load_reference_params(shell, jax.tree.map(np.asarray, tree))
    return {name: p.detach() for name, p in shell.named_parameters()}


@pytest.mark.parametrize("arch,seq", LOSS_CASES)
def test_loss_and_gradients_match_value_and_grad(arch, seq):
    cfg, bundle, params, model = _pair(arch)
    if cfg.family == "hybrid":
        assert seq > cfg.sliding_window
    batch = _batch(cfg, seq=seq)
    loss, grads = jax.jit(jax.value_and_grad(bundle.loss_fn))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model.requires_grad_(True)
    ours = model.forward_loss(**{k: torch.from_numpy(v) for k, v in batch.items()})
    ours.backward()
    assert ours.dtype == torch.float32 and ours.ndim == 0
    _close(ours.detach(), loss, what="loss")
    ref = _by_name(cfg, grads)
    assert set(ref) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        _close(p.grad, ref[name], what=name)
        assert float(ref[name].abs().max()) > 0, name


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "seamless-m4t-large-v2"])
def test_microbatched_loss_splits_the_stub_inputs_with_their_rows(arch):
    """Two microbatches give the whole batch's loss and gradients: each
    row's image embeddings or audio frames go with its tokens.  Rows paired
    with another row's input would change the loss."""
    cfg, _ = _configs(arch)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    if cfg.family == "vlm":
        with torch.no_grad():
            for cross in model.cross_layers:
                cross.gate.fill_(0.8)
                cross.gate_mlp.fill_(-0.6)
    model.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    runs = []
    for n in (1, 2):
        model.zero_grad(set_to_none=True)
        loss = make_microbatched_loss(model.forward_loss, n)(batch)
        runs.append((loss, {k: p.grad.clone() for k, p in model.named_parameters()}))
    (whole, g1), (split, g2) = runs
    _close(split, whole, 1e-6, "loss")
    for name in g1:
        _close(g2[name], g1[name], 1e-5, name)
    swapped = dict(batch)
    name = next(k for k in batch if k not in ("tokens", "labels"))
    swapped[name] = batch[name].roll(1, dims=0)
    with torch.no_grad():
        other = model.forward_loss(**swapped)
    assert abs(float(other) - float(whole)) > 1e-4 * abs(float(whole))


def test_hymba_train_step_matches_reference_train_step():
    """Two steps of the port's train step (two microbatches) against the
    reference's ``make_train_step`` over the whole batch, past the window:
    each step's loss, the step count and every weight's update, held in
    RMS within 1% of the reference's, as ``test_torch_training.py`` holds
    the decoders'."""
    cfg, bundle, params, model = _pair("hymba-1.5b")
    start = {name: p.detach().clone() for name, p in model.named_parameters()}
    jstep = jax.jit(jax_make_train_step(bundle, jax_opt.AdamWConfig(lr=1e-3,
                                                                    warmup_steps=2)))
    jstate = jax_opt.init_state(params)
    train_step = make_train_step(model, opt.AdamWConfig(lr=1e-3, warmup_steps=2),
                                 num_microbatches=2)
    state = opt.init_state(dict(model.named_parameters()))
    for step in range(2):
        batch = _batch(cfg, step=step)
        params, jstate, jmetrics = jstep(
            params, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, metrics = train_step(state, batch)
        _close(metrics["loss"], jmetrics["loss"], what="loss")
        assert int(metrics["step"]) == int(jmetrics["step"]) == step + 1
    ref = _by_name(cfg, params)
    for name, p in model.named_parameters():
        moved = (ref[name] - start[name]).square().mean().sqrt()
        err = (p.detach() - ref[name]).square().mean().sqrt()
        assert float(moved) > 0 and float(err) <= 1e-2 * float(moved), name


def test_train_step_takes_float_inputs_in_the_weights_dtype():
    """f32 numpy frames reach a bf16 enc-dec as bf16, and every weight,
    the encoder's too, gets a finite gradient."""
    cfg, _ = _configs("seamless-m4t-large-v2")
    model = build_model(cfg, device="cpu", dtype=torch.bfloat16)
    model.init_params(torch.Generator().manual_seed(0))
    assert model.extra_inputs(3) == {
        "audio_frames": ((3, cfg.num_audio_frames, cfg.d_model), torch.bfloat16)}
    train_step = make_train_step(model, opt.AdamWConfig(lr=1e-3, warmup_steps=2))
    state, metrics = train_step(opt.init_state(dict(model.named_parameters())),
                                _batch(cfg))
    assert np.isfinite(float(metrics["loss"])) and int(metrics["step"]) == 1
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.bfloat16, name
        assert bool(torch.isfinite(p.grad).all()) and float(p.grad.abs().max()) > 0, name


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_loss_decreases(arch):
    """The reference's ``test_loss_decreases`` arguments, on the CPU, with
    zeros for the stub inputs as the reference's launcher feeds them."""
    losses = train_main(["--device", "cpu", "--arch", arch, "--steps", "20",
                         "--batch", "8", "--seq", "32", "--lr", "2e-3"])
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < 0.75 * np.mean(losses[:5]), (
        f"{arch}: loss did not decrease: {losses[:3]} ... {losses[-3:]}")
