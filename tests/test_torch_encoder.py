"""The port's encoder (e5-base-v2, the MiniLM reranker) against the JAX
package's ``make_encoder`` on the same weights.

Weights come from ``make_encoder(cfg).init(jax.random.key(0))`` and cross
through ``repro_torch.bridge`` as numpy arrays; tokens are drawn with
numpy.  In f32 both compute the same function, so the pooled embeddings
are held to 1e-4 relative to their scale (as ``test_torch_model.py`` holds
the decoders' logits).  The attention kernel's own parity (the non-causal
mode and head dim 32) is in ``test_torch_kernels.py``.
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
from repro.models.transformer import encoder_layer as jax_encoder_layer
from repro_torch.bridge import load_reference_params
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.models import build_model
from repro_torch.models.transformer import EncoderLayer, EncoderLM
from repro_torch.serving.engine import ServingEngine
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-4
ENCODERS = ["e5-base-v2", "reranker-minilm"]


def _configs(arch, reduce=None, **changes):
    """The port's and the reference's config of ``arch``, equal field by
    field: cut by ``reduced_config(**reduce)`` where ``reduce`` is given,
    else at the published widths, with ``changes`` applied."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if reduce is not None:
        cfg, jcfg = reduced_config(cfg, **reduce), jax_reduced_config(jcfg, **reduce)
    cfg = dataclasses.replace(cfg, **changes)
    jcfg = dataclasses.replace(jcfg, **changes)
    assert cfg.to_dict() == jcfg.to_dict()
    return cfg, jcfg


def _pair(cfg, jcfg, dtype=jnp.float32, torch_dtype=torch.float32):
    bundle = jax_build_model(jcfg)
    params = jax.tree.map(lambda a: a.astype(dtype), bundle.init(jax.random.key(0)))
    model = build_model(cfg, device="cpu", dtype=torch_dtype)
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return bundle, params, model


def _close_rel(ours, ref, tol=TOL):
    ours = np.asarray(ours, np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max() / np.abs(ref).max()
    assert err <= tol, f"max error {err} of the reference's scale"


def _prefill_matches(cfg, jcfg, B, S, seed=0):
    bundle, params, model = _pair(cfg, jcfg)
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    jemb, jrest = bundle.prefill(params, {"tokens": jnp.asarray(tokens)})
    temb, trest = model.prefill(torch.from_numpy(tokens))
    assert jrest is None and trest is None
    assert tuple(temb.shape) == (B, cfg.d_model) and temb.dtype == torch.float32
    _close_rel(temb, jemb)


# ---------------------------------------------------------------------------
# the layer and the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ENCODERS)
@pytest.mark.parametrize("d_model", [64, 128])  # head dim 16 and 32
def test_encoder_layer_matches_reference(arch, d_model):
    cfg, jcfg = _configs(arch, {"d_model": d_model})
    assert cfg.head_dim == d_model // 4
    _, params, model = _pair(cfg, jcfg)
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    x = (np.random.default_rng(1).standard_normal((2, 37, d_model)) * 0.5
         ).astype(np.float32)
    ref = jax_encoder_layer(lp, jnp.asarray(x), jcfg)
    layer = model.layers[0]
    assert isinstance(layer, EncoderLayer)
    ours = layer(torch.from_numpy(x), cfg)
    _close_rel(ours, ref)
    # the plain attention computes the same function on the CPU
    _close_rel(layer(torch.from_numpy(x), cfg, plain=True), ref)


@pytest.mark.parametrize("arch", ENCODERS)
@pytest.mark.parametrize("d_model", [64, 128])  # head dim 16 and 32
def test_reduced_encoder_prefill_matches_reference(arch, d_model):
    cfg, jcfg = _configs(arch, {"d_model": d_model})
    _prefill_matches(cfg, jcfg, B=3, S=29)


def test_reranker_minilm_full_size_prefill_matches_reference():
    """Published widths and depth: 6 layers, d 384, 12 heads of 32."""
    cfg, jcfg = _configs("reranker-minilm")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim) == (6, 384, 12, 32)
    _prefill_matches(cfg, jcfg, B=1, S=64)


def test_e5_base_v2_full_size_prefill_matches_reference():
    """Published widths and depth: 12 layers, d 768, 12 heads of 64, d_ff
    3072, vocab 30522 (~9 s on a CPU)."""
    cfg, jcfg = _configs("e5-base-v2")
    assert (cfg.num_layers, cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
        12, 768, 64, 3072, 30522)
    _prefill_matches(cfg, jcfg, B=1, S=64)


@pytest.mark.parametrize("arch", ENCODERS)
def test_bf16_pooling_matches_reference_mean(arch):
    """The mean over S of a bf16 model is taken in f32 and rounded once,
    as ``jnp.mean`` does on a bf16 input."""
    cfg, jcfg = _configs(arch, {"d_model": 128})
    bundle, params, model = _pair(cfg, jcfg, jnp.bfloat16, torch.bfloat16)
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    jemb, _ = bundle.prefill(params, {"tokens": jnp.asarray(tokens)})
    temb, _ = model.prefill(torch.from_numpy(tokens))
    assert temb.dtype == torch.bfloat16 and jemb.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(temb.float()),
                               np.asarray(jemb.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    # the pooling step alone: a bf16 (B, S, d) tensor
    x = (np.random.default_rng(4).standard_normal((2, 300, 64)) * 3).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    np.testing.assert_array_equal(
        np.asarray(tx.float().mean(dim=1).to(torch.bfloat16).float()),
        np.asarray(jnp.mean(jx, axis=1).astype(jnp.float32)))


# ---------------------------------------------------------------------------
# construction, the bridge and the entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ENCODERS)
def test_build_model_gives_an_encoder(arch):
    cfg = reduced_config(get_config(arch))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    assert isinstance(model, EncoderLM)
    assert len(model.layers) == cfg.num_layers
    assert {n for n, _ in model.named_children()} == {"layers"}
    assert not hasattr(model, "lm_head") or model.lm_head is None
    model.init_params(torch.Generator().manual_seed(0))
    assert float(model.final_norm.abs().max()) == 0.0
    assert abs(float(model.embed.std()) - 1.0) < 0.05
    w_up = model.layers[0].mlp["w_up"]
    assert "w_gate" not in model.layers[0].mlp  # GELU with no gate
    assert abs(float(w_up.std()) * np.sqrt(w_up.shape[0]) - 1.0) < 0.1


def test_bridge_rejects_a_mismatched_tree():
    cfg, jcfg = _configs("reranker-minilm", {"d_model": 64})
    bundle = jax_build_model(jcfg)
    params = jax.tree.map(np.asarray, bundle.init(jax.random.key(0)))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    extra = dict(params, lm_head=params["embed"])
    with pytest.raises(ValueError, match="keys"):
        load_reference_params(model, extra)
    deeper = build_model(dataclasses.replace(cfg, num_layers=3), device="cpu",
                         dtype=torch.float32)
    with pytest.raises(ValueError, match="layers"):
        load_reference_params(deeper, params)
    gated = dict(params, layers=dict(params["layers"],
                                     mlp=dict(params["layers"]["mlp"],
                                              w_gate=params["layers"]["mlp"]["w_up"])))
    with pytest.raises(ValueError, match="keys"):
        load_reference_params(model, gated)


def test_engine_refuses_an_encoder():
    model = build_model(reduced_config(get_config("e5-base-v2")), device="cpu",
                        dtype=torch.float32)
    with pytest.raises(ValueError, match="encoder"):
        ServingEngine(model, device="cpu")


@pytest.mark.parametrize("arch", ENCODERS)
def test_encoder_entry_points_without_a_device_raise_here(arch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no card")
    cfg = reduced_config(get_config(arch))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EncoderLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    EncoderLM(cfg, device="cpu")  # the explicit CPU is taken


@pytest.mark.parametrize("arch", ENCODERS)
def test_serve_model_encodes_each_request(arch, capsys):
    from repro_torch.launch import serve_model

    embeddings = serve_model.main(["--arch", arch, "--reduced", "--device", "cpu",
                                   "--requests", "3"])
    assert len(embeddings) == 3
    assert all(e.shape == (1, 64) and bool(torch.isfinite(e).all())
               for e in embeddings)
    out = capsys.readouterr().out
    assert "calls/s" in out and "tok/s" in out
