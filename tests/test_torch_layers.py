"""Each ported layer function against its JAX counterpart in
``repro.models.layers``, on the same numpy inputs (f32, tolerance 2e-5
unless stated)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.models import layers as JL
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.models import layers as TL
from torch_threads import one_thread  # noqa: F401  (autouse)

TOL = 2e-5


def _close(ours, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_rms_norm(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = (rng.standard_normal(64) * 0.1).astype(np.float32)
    _close(TL.rms_norm(_t(x), _t(scale), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))


def test_rms_norm_bf16_rounds_like_reference(rng):
    x = rng.standard_normal((3, 64)).astype(np.float32)
    scale = (rng.standard_normal(64) * 0.1).astype(np.float32)
    ours = TL.rms_norm(_t(x).bfloat16(), _t(scale).bfloat16())
    ref = JL.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale, jnp.bfloat16))
    assert ours.dtype == torch.bfloat16
    _close(ours.float(), ref.astype(jnp.float32), 2e-2)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_prefill_positions(rng, theta):
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(7)
    _close(TL.apply_rope(_t(x), _t(pos), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_rope_per_row_decode_positions(rng):
    x = rng.standard_normal((3, 1, 4, 32)).astype(np.float32)
    pos = np.array([[0], [17], [1000]], np.int32)  # (B, 1)
    _close(TL.apply_rope(_t(x), _t(pos), 1e6),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-4)


def test_matmul_f32_and_mixed(rng):
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    _close(TL.matmul(_t(x), _t(w)), JL.matmul(jnp.asarray(x), jnp.asarray(w)), 1e-4)
    ours = TL.matmul(_t(x), _t(w).bfloat16())
    ref = JL.matmul(jnp.asarray(x), jnp.asarray(w, jnp.bfloat16))
    assert ours.dtype == torch.float32
    _close(ours, ref, 1e-4)


@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_mlp_block(rng, activation):
    d, f = 32, 64
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    _close(TL.mlp_block({k: _t(v) for k, v in p.items()}, _t(x), activation),
           JL.mlp_block({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), activation), 1e-4)


def test_gelu_is_the_tanh_approximation(rng):
    x = rng.standard_normal(100).astype(np.float32) * 3
    _close(TL.activate(_t(x), "geglu"), JL.activate(jnp.asarray(x), "geglu"), 1e-5)


def _attn_params(cfg, rng, bias):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    shapes = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wo": (qd, d)}
    if bias:
        shapes.update(bq=(qd,), bk=(kvd,), bv=(kvd,))
    return {k: (rng.standard_normal(s) * 0.2).astype(np.float32)
            for k, s in shapes.items()}


def _cfgs(arch):
    return reduced_config(get_config(arch)), jax_reduced_config(jax_get_config(arch))


def test_attention_qkv_with_bias(rng):
    cfg, jcfg = _cfgs("qwen2.5-3b")
    assert cfg.qkv_bias
    p = _attn_params(cfg, rng, bias=True)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    pos = np.arange(6)
    ours = TL.attention_qkv({k: _t(v) for k, v in p.items()}, _t(x), _t(pos), cfg)
    ref = JL.attention_qkv({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), jnp.asarray(pos), jcfg)
    for o, r in zip(ours, ref):
        _close(o, r, 1e-4)


def test_attention_block_prefill(rng):
    cfg, jcfg = _cfgs("qwen2.5-3b-agent")
    p = _attn_params(cfg, rng, bias=False)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    out, (k, v) = TL.attention_block_prefill(
        {k: _t(v) for k, v in p.items()}, _t(x), cfg)
    jout, (jk, jv) = JL.attention_block_prefill(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    _close(out, jout, 1e-4)
    _close(k, jk, 1e-4)
    _close(v, jv, 1e-4)


def test_attention_block_decode_per_row_positions(rng):
    cfg, jcfg = _cfgs("llama-3.2-1b")
    p = _attn_params(cfg, rng, bias=False)
    B, Smax = 3, 12
    shape = (B, cfg.num_kv_heads, Smax, cfg.head_dim)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    pos = np.array([0, 5, 11], np.int32)
    out, (k2, v2) = TL.attention_block_decode(
        {k: _t(v) for k, v in p.items()}, _t(x), (_t(kc.copy()), _t(vc.copy())),
        _t(pos), cfg)
    jout, (jk2, jv2) = JL.attention_block_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        (jnp.asarray(kc), jnp.asarray(vc)), jnp.asarray(pos), jcfg)
    _close(out, jout, 1e-4)
    _close(k2, jk2, 1e-4)
    _close(v2, jv2, 1e-4)


def test_attention_block_decode_idle_row_writes_nothing(rng):
    cfg, _ = _cfgs("llama-3.2-1b")
    p = {k: _t(v) for k, v in _attn_params(cfg, rng, bias=False).items()}
    shape = (2, cfg.num_kv_heads, 8, cfg.head_dim)
    kc = _t(rng.standard_normal(shape).astype(np.float32))
    vc = _t(rng.standard_normal(shape).astype(np.float32))
    k0, v0 = kc.clone(), vc.clone()
    x = _t(rng.standard_normal((2, cfg.d_model)).astype(np.float32))
    out, _ = TL.attention_block_decode(p, x, (kc, vc), torch.tensor([-1, 3]), cfg)
    assert torch.equal(kc[0], k0[0]) and torch.equal(vc[0], v0[0])
    assert not torch.equal(kc[1, :, 3], k0[1, :, 3])
    # an idle row attends over nothing: its attention output is zero
    assert float(out[0].abs().max()) == 0.0


@pytest.mark.parametrize("per_row", [False, True])
def test_write_kv(rng, per_row):
    cache = rng.standard_normal((3, 2, 10, 8)).astype(np.float32)
    new = rng.standard_normal((3, 2, 1, 8)).astype(np.float32)
    idx = np.array([0, 4, 9], np.int32) if per_row else np.int32(6)
    ours = TL.write_kv(_t(cache.copy()), _t(new), _t(idx))
    ref = JL.write_kv(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(idx))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_write_kv_casts_to_the_cache_dtype(rng):
    cache = torch.zeros((2, 1, 4, 8), dtype=torch.bfloat16)
    new = rng.standard_normal((2, 1, 1, 8)).astype(np.float32)
    TL.write_kv(cache, _t(new), 2)
    ref = JL.write_kv(jnp.zeros((2, 1, 4, 8), jnp.bfloat16), jnp.asarray(new), 2)
    np.testing.assert_array_equal(cache.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_lm_head_logits_masks_padded_vocab(rng):
    vocab = 250
    padded = 256
    x = rng.standard_normal((2, 16)).astype(np.float32)
    table = rng.standard_normal((padded, 16)).astype(np.float32)
    ours = TL.lm_head_logits(_t(x), _t(table), valid_vocab=vocab)
    ref = JL.lm_head_logits(jnp.asarray(x), jnp.asarray(table), valid_vocab=vocab)
    assert ours.dtype == torch.float32
    _close(ours, ref, 1e-4)
    assert float(ours[:, vocab:].max()) == float(np.float32(-1e30))


def test_embed_lookup(rng):
    table = rng.standard_normal((20, 8)).astype(np.float32)
    tokens = np.array([[3, 0, 19]], np.int32)
    np.testing.assert_array_equal(
        TL.embed_lookup(_t(table), _t(tokens).long()).numpy(),
        np.asarray(JL.embed_lookup(jnp.asarray(table), jnp.asarray(tokens))))
