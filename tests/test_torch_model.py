"""The port's dense and MoE LM against the JAX bundle on the same weights.

Weights come from ``build_model(cfg).init(jax.random.key(0))`` and cross
through ``repro_torch.bridge`` as numpy arrays.  Logits are compared in f32
params with the bf16 KV cache (the reference upcasts every dot on the CPU,
so f32 params are where the two compute the same function) within 1e-4.
The MoE models (olmoe-1b-7b, granite-moe-3b-a800m) route every token as
the reference does, so their logits meet the same bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro_torch.bridge import load_reference_params
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.models import build_model
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 1e-4
MOE_ARCHS = ["olmoe-1b-7b", "granite-moe-3b-a800m"]
ARCHS = ["llama-3.2-1b", "qwen2.5-3b-agent", "qwen2.5-3b", "gemma-7b"] + MOE_ARCHS


def _pair(arch, jax_dtype=jnp.float32, torch_dtype=torch.float32):
    """The reference bundle and params and the port's model with those
    params.  f32 casts every leaf; bf16 keeps the reference's own dtypes
    (bf16, and f32 where a ``ParamDef`` names it, as the MoE router)."""
    jcfg = jax_reduced_config(jax_get_config(arch))
    bundle = jax_build_model(jcfg)
    params = bundle.init(jax.random.key(0))
    if jax_dtype != jnp.bfloat16:
        params = jax.tree.map(lambda a: a.astype(jax_dtype), params)
    cfg = reduced_config(get_config(arch))
    assert cfg.to_dict() == jcfg.to_dict()
    model = build_model(cfg, device="cpu", dtype=torch_dtype)
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return cfg, bundle, params, model


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_is_bit_exact_on_bf16_params(arch):
    _, _, params, model = _pair(arch, jnp.bfloat16, torch.bfloat16)
    ref = jax.tree.map(np.asarray, params)
    assert ref["embed"].dtype.name == "bfloat16"

    def bits(t):
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()

    def ref_bits(a):
        return a.view(np.int16 if a.itemsize == 2 else np.int32)

    np.testing.assert_array_equal(bits(model.embed), ref["embed"].view(np.int16))
    for i, layer in enumerate(model.layers):
        for group in ("attn", "mlp"):
            for key, leaf in ref["layers"][group].items():
                mine = getattr(layer, group)[key]
                assert mine.element_size() == leaf.itemsize, key
                np.testing.assert_array_equal(bits(mine), ref_bits(leaf[i]))
        np.testing.assert_array_equal(bits(layer.ln1),
                                      ref["layers"]["ln1"][i].view(np.int16))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    cfg, bundle, params, model = _pair(arch)
    rng = np.random.default_rng(0)
    B, S, Smax, steps = 2, 11, 24, 4
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)

    jl, (jk, jv) = bundle.prefill(params, {"tokens": jnp.asarray(tokens)})
    tl, (tk, tv) = model.prefill(torch.from_numpy(tokens))
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)

    # the bf16 decode cache holds the prompt; rows decode at ragged positions
    shape = (cfg.num_layers, B, cfg.num_kv_heads, Smax, cfg.head_dim)
    k0 = np.zeros(shape, np.float32)
    v0 = np.zeros(shape, np.float32)
    k0[:, :, :, :S] = np.asarray(jk)
    v0[:, :, :, :S] = np.asarray(jv)
    jcache = (jnp.asarray(k0, jnp.bfloat16), jnp.asarray(v0, jnp.bfloat16))
    tcache = (torch.from_numpy(k0).to(torch.bfloat16),
              torch.from_numpy(v0).to(torch.bfloat16))
    for step in range(steps):
        tok = rng.integers(0, cfg.vocab_size, size=B).astype(np.int32)
        pos = np.array([S + step, S - 3 + 2 * step], np.int32)
        jl, jcache = bundle.decode_step(params, jcache, jnp.asarray(tok),
                                        jnp.asarray(pos))
        tl, tcache = model.decode_step(tcache, torch.from_numpy(tok),
                                       torch.from_numpy(pos))
        _close(tl, jl)
    for t, j in zip(tcache, jcache):
        _close(t.float(), np.asarray(j.astype(jnp.float32)), 2e-2)


def test_decode_with_scalar_position_matches_reference():
    cfg, bundle, params, model = _pair("llama-3.2-1b")
    rng = np.random.default_rng(1)
    B, Smax = 3, 16
    jcache = bundle.init_cache(B, Smax)
    tcache = model.init_cache(B, Smax)
    for pos in range(5):
        tok = rng.integers(0, cfg.vocab_size, size=B).astype(np.int32)
        jl, jcache = bundle.decode_step(params, jcache, jnp.asarray(tok),
                                        jnp.asarray(pos, jnp.int32))
        tl, tcache = model.decode_step(tcache, torch.from_numpy(tok), pos)
        _close(tl, jl)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_with_scalar_position_matches_reference(arch):
    cfg, bundle, params, model = _pair(arch)
    rng = np.random.default_rng(1)
    B, Smax = 3, 16
    jcache = bundle.init_cache(B, Smax)
    tcache = model.init_cache(B, Smax)
    for pos in range(5):
        tok = rng.integers(0, cfg.vocab_size, size=B).astype(np.int32)
        jl, jcache = bundle.decode_step(params, jcache, jnp.asarray(tok),
                                        jnp.asarray(pos, jnp.int32))
        tl, tcache = model.decode_step(tcache, torch.from_numpy(tok), pos)
        _close(tl, jl)


@pytest.mark.parametrize("arch", ["llama-3.2-1b", "qwen2.5-3b"] + MOE_ARCHS)
def test_prefill_with_lengths_matches_reference(arch):
    """The pad tokens are routed too, and an MoE layer's capacity comes
    from the padded S, as in the reference; the gathered row is the last
    valid token's."""
    cfg, bundle, params, model = _pair(arch)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, size=(3, 9)).astype(np.int32)
    lengths = np.array([9, 4, 1], np.int32)
    jl, _ = bundle.prefill(params, {"tokens": jnp.asarray(tokens),
                                    "lengths": jnp.asarray(lengths)})
    tl, _ = model.prefill(torch.from_numpy(tokens), torch.from_numpy(lengths))
    _close(tl, jl)
    if cfg.is_moe:  # a shorter S has another capacity
        return
    # the gathered row is the last valid token's: a shorter prompt alone
    # gives the same logits
    solo, _ = model.prefill(torch.from_numpy(tokens[1:2, :4]))
    _close(tl[1:2], solo)


def test_init_params_follows_reference_rules():
    cfg = reduced_config(get_config("llama-3.1-8b"))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    assert float(model.final_norm.abs().max()) == 0.0
    assert float(model.layers[0].ln1.abs().max()) == 0.0
    assert abs(float(model.embed.std()) - 1.0) < 0.05
    wq = model.layers[0].attn["wq"]
    assert abs(float(wq.std()) * np.sqrt(wq.shape[0]) - 1.0) < 0.1
    head = model.lm_head
    assert abs(float(head.std()) * np.sqrt(head.shape[0]) - 1.0) < 0.1
    again = build_model(cfg, device="cpu", dtype=torch.float32)
    again.init_params(torch.Generator().manual_seed(0))
    assert torch.equal(again.layers[1].mlp["w_down"], model.layers[1].mlp["w_down"])


def test_registry_serves_every_llm_of_the_paper_workflows():
    """Every LLM the reference's two deployed workflows call is in the
    port's registry, field for field as the reference defines it."""
    from repro.configs.registry import REGISTRY as JAX_REGISTRY
    from repro.workflows.beam_search import BEAM_SEARCH
    from repro.workflows.rag_reranker import RAG_RERANKER
    from repro_torch.configs.registry import REGISTRY

    names = {c.name for wf in (RAG_RERANKER, BEAM_SEARCH) for c in wf.llms.values()}
    assert {"e5-base-v2", "reranker-minilm"} <= names
    for name in sorted(names):
        assert REGISTRY[name].to_dict() == JAX_REGISTRY[name].to_dict(), name
        model = build_model(reduced_config(REGISTRY[name]), device="cpu",
                            dtype=torch.float32)
        assert hasattr(model, "prefill"), name


def test_registry_entries_equal_the_reference():
    """Every config the port registers, the MoE decoders included, is the
    reference's field for field."""
    from repro.configs.registry import REGISTRY as JAX_REGISTRY
    from repro_torch.configs.registry import ASSIGNED, REGISTRY

    assert set(MOE_ARCHS) <= set(ASSIGNED)
    for name, cfg in REGISTRY.items():
        assert cfg.to_dict() == JAX_REGISTRY[name].to_dict(), name


@pytest.mark.parametrize("arch,cls", [("llama-3.2-vision-11b", "VisionLM"),
                                      ("seamless-m4t-large-v2", "EncDecLM")])
def test_zoo_builds_the_cross_attention_decoders(arch, cls):
    """The VLM and the enc-dec families build (no zoo family is left to a
    later slice), and the port's ASSIGNED holds the reference's names."""
    from repro.configs.registry import ASSIGNED as JAX_ASSIGNED
    from repro_torch.configs.registry import ASSIGNED

    assert set(ASSIGNED) == set(JAX_ASSIGNED)
    model = build_model(reduced_config(get_config(arch)), device="cpu",
                        dtype=torch.float32)
    assert type(model).__name__ == cls
    assert hasattr(model, "prefill") and hasattr(model, "decode_step")
