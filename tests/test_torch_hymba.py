"""The port's hymba path (Mamba heads, layer, model, engine) against the JAX
package.

The config is reduced hymba-1.5b with five query heads over one KV head
(G = 5, as the full model has) and six layers laid out as two
full-attention singletons and two sliding-window runs of two, so that the
bridge maps every kind of the reference's layer groups: window W = 8,
ssm_state 4, head_dim 16.  Inputs are made with numpy from a seed and
handed to both sides.  Tolerances:

* 1e-4 in f32 where the port's chunked Mamba scan (log-depth doubling)
  meets the reference's ``associative_scan`` or the port's own
  token-by-token steps: they sum the same terms in another order, the
  chunked-vs-token tolerance of ``tests/test_torch_rwkv.py``;
* 2e-2 of the scale (max |ref|) in bf16.  Both sides round to bf16 at the
  same steps, but not always the same way: ``jax.nn.silu`` rounds inside
  (XLA expands the sigmoid), ``F.silu`` once, so an element may sit an ulp
  (2**-8 relative) apart, and through the f32 state that moves the
  outputs by up to ~1% of their scale over 256 tokens.  The port's bf16 is
  also held to be as accurate as the reference's: its RMS error against
  the reference run in f32 at most BF16_ERR_RATIO times the reference's
  bf16 one (the ratio ``chip_smoke.py`` holds the full model to);
* model logits 1e-4 in f32 weights, as ``tests/test_torch_model.py``, and
  engine logits 1e-3 of their scale, as ``tests/test_torch_engine.py``.

The reference's prefill takes S <= 128 or a multiple of 128, and keeps
its window ring in the wrong order once S > W and S % W != 0, so parity
with it uses S <= W or multiples of W; the port's ragged prefill is held
against its own token-by-token decode, and its ring against a longer
prefill.
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
from repro.models.hymba import hymba_layer_decode, hymba_layer_prefill
from repro.models.hymba import mamba_decode as jax_mamba_decode
from repro.models.hymba import mamba_prefill as jax_mamba_prefill
from repro.serving.engine import ServeRequest as JaxServeRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.bridge import load_reference_params
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.models import build_model
from repro_torch.models import hymba as hymba_module
from repro_torch.models.hymba import (HymbaLM, layer_groups, mamba_decode,
                                      mamba_prefill)
from repro_torch.serving.engine import ServeRequest, ServingEngine, _merge_slot
from torch_threads import one_thread  # noqa: F401  (autouse)

ARCH = "hymba-1.5b"
LAYOUT = dict(num_layers=6, full_attn_layers=(0, 3), d_model=80, num_heads=5,
              num_kv_heads=1, head_dim=16)
CHUNKED_TOL = 1e-4
BF16_TOL = 2e-2
MODEL_TOL = 1e-4
ENGINE_TOL = 1e-3
BF16_ERR_RATIO = 1.25

JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _configs():
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(ARCH)), **LAYOUT)
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), **LAYOUT)
    assert cfg.to_dict() == jcfg.to_dict()
    return cfg, jcfg


def _pair(dtype="float32"):
    """The reference bundle and params and the port's model with those
    params: f32 casts every leaf, bf16 keeps the reference's own dtypes
    (bf16, and f32 for ``a_log``)."""
    cfg, jcfg = _configs()
    bundle = jax_build_model(jcfg)
    params = bundle.init(jax.random.key(0))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = build_model(cfg, device="cpu", dtype=TORCH_DT[dtype])
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return cfg, bundle, params, model


@pytest.fixture(scope="module")
def hymba():
    cfg, bundle, params, model = _pair()
    return (cfg, bundle, params, model, jax.jit(bundle.prefill),
            jax.jit(bundle.decode_step))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


def _close(ours, ref, tol):
    np.testing.assert_allclose(_np(ours), _np(ref), atol=tol, rtol=tol)


def _close_to_scale(ours, ref, tol):
    err, scale = np.abs(_np(ours) - _np(ref)).max(), np.abs(_np(ref)).max()
    assert err <= tol * scale, f"max |diff| {err} > {tol} * {scale}"


def _rms(a, b):
    return float(np.sqrt(np.square(_np(a) - _np(b)).mean()))


def _both(a, dtype):
    """A numpy array as (jax, torch) in ``dtype``, the same rounded values."""
    j = jnp.asarray(a, JAX_DT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH_DT[dtype])


def _mamba_inputs(seed, cfg, B, S, dtype):
    rng = np.random.default_rng(seed)
    h, n = cfg.q_dim, cfg.ssm_state
    x = _both(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32), dtype)
    conv = _both(rng.standard_normal((B, h, 3)).astype(np.float32) * 0.5, dtype)
    ssm = (rng.standard_normal((B, h, n)) * 0.5).astype(np.float32)
    return x, conv, (jnp.asarray(ssm), torch.from_numpy(ssm))


def _mamba_params(model, params, dtype):
    """Layer 1's Mamba weights (the first of a sliding-window group) as
    (jax dict, torch ParameterDict)."""
    jp = jax.tree.map(lambda a: a[0], params["groups"][1]["mamba"])
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jp, model.layers[1].mamba


@pytest.fixture(scope="module")
def bf16_pair():
    return _pair("bfloat16")


def _pair_for(dtype, hymba, bf16_pair):
    return hymba[:4] if dtype == "float32" else bf16_pair


# ---------------------------------------------------------------------------
# the Mamba heads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 77, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_prefill_matches_reference(S, dtype, hymba, bf16_pair):
    cfg, _, params, model = _pair_for(dtype, hymba, bf16_pair)
    jp, tp = _mamba_params(model, params, dtype)
    (jx, tx), (jc, tc), (js, ts) = _mamba_inputs(S, cfg, 2, S, dtype)
    ref = jax_mamba_prefill(jp, jx, jc, js)
    ours = mamba_prefill(tp, tx, tc, ts)
    assert ours[0].dtype == TORCH_DT[dtype] and ours[2].dtype == torch.float32
    assert tuple(ours[1].shape) == (2, cfg.q_dim, 3)
    assert ours[1].dtype == TORCH_DT[dtype]
    if dtype == "float32":
        for mine, theirs in zip(ours, ref):  # out, conv state, ssm state
            _close(mine, theirs, CHUNKED_TOL)
        return
    for mine, theirs in zip(ours, ref):
        _close_to_scale(mine, theirs, BF16_TOL)
    # and no less accurate than the reference's bf16 against the f32 run
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), (jp, jx, jc))
    truth = jax_mamba_prefill(*f32, js)
    for i in (0, 2):  # out, ssm state
        assert _rms(ours[i], truth[i]) <= BF16_ERR_RATIO * _rms(ref[i], truth[i])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_reference(dtype, hymba, bf16_pair):
    cfg, _, params, model = _pair_for(dtype, hymba, bf16_pair)
    jp, tp = _mamba_params(model, params, dtype)
    (jx, tx), (jc, tc), (js, ts) = _mamba_inputs(3, cfg, 3, 1, dtype)
    for _ in range(3):
        ref = jax_mamba_decode(jp, jx[:, 0], jc, js)
        ours = mamba_decode(tp, tx[:, 0], tc, ts)
        for mine, theirs in zip(ours, ref):
            if dtype == "float32":
                _close(mine, theirs, 2e-5)
            else:
                _close_to_scale(mine, theirs, BF16_TOL)
        (_, jc, js), (_, tc, ts) = ref, ours


@pytest.mark.parametrize("S,block", [(77, None), (200, None), (300, None),
                                     (300, 256)])
def test_mamba_ragged_prefill_equals_token_steps(S, block, hymba, monkeypatch):
    """Any S, with a shorter last chunk (which the reference refuses past
    128), against S single-token steps of the port from a zero state; with
    ``block``, the scan's blocks are that many tokens, so the state also
    crosses from block to block."""
    if block is not None:
        monkeypatch.setattr(hymba_module, "SCAN_BLOCK", block)
    cfg, _, params, model = hymba[:4]
    _, tp = _mamba_params(model, params, "float32")
    (_, x), _, _ = _mamba_inputs(S, cfg, 2, S, "float32")
    conv0 = torch.zeros(2, cfg.q_dim, 3)
    ssm0 = torch.zeros(2, cfg.q_dim, cfg.ssm_state)
    out, conv, ssm = mamba_prefill(tp, x, conv0, ssm0)
    steps, c, s = [], conv0, ssm0
    for t in range(S):
        y, c, s = mamba_decode(tp, x[:, t], c, s)
        steps.append(y)
    _close(out, torch.stack(steps, dim=1), CHUNKED_TOL)
    _close(conv, c, CHUNKED_TOL)
    _close(ssm, s, CHUNKED_TOL)


def test_mamba_scan_stays_finite_under_strong_decay():
    """dt * A of -8 per token is -1024 in log over a 128-token chunk: a scan
    factored through exp(-cumsum) would overflow; the doubling scan only
    multiplies decays."""
    rng = np.random.default_rng(5)
    decay = torch.full((1, 128, 2, 3), float(np.exp(-8.0)))
    add = torch.from_numpy(rng.standard_normal((1, 128, 2, 3)).astype(np.float32))
    cum, s = hymba_module._scan_chunks(decay, add)
    ref, prev = [], torch.zeros(1, 2, 3)
    for t in range(128):
        prev = decay[:, t] * prev + add[:, t]
        ref.append(prev)
    assert torch.isfinite(s).all() and torch.isfinite(cum).all()
    _close(s, torch.stack(ref, dim=1), 1e-6)
    assert float(cum[:, -1].max()) == 0.0  # underflows to 0, never inf


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layer_idx", [0, 1], ids=["full", "window"])
def test_layer_prefill_and_decode_match_reference(layer_idx, hymba):
    cfg, _, params, model = hymba[:4]
    group = params["groups"][layer_idx]
    lp = group if layer_idx == 0 else jax.tree.map(lambda a: a[0], group)
    layer = model.layers[layer_idx]
    window = layer.window
    assert window == (0 if layer_idx == 0 else cfg.sliding_window)
    B, S, Smax = 2, 8, 24
    (jx, tx), (jc, tc), (js, ts) = _mamba_inputs(11, cfg, B, S, "float32")
    jy, (jk, jv), jc1, js1 = hymba_layer_prefill(lp, jx, cfg, window, jc, js)
    ty, (tk, tv), tc1, ts1 = layer.prefill(tx, cfg, False, tc, ts)
    _close(ty, jy, MODEL_TOL)
    _close(tk, jk, MODEL_TOL)
    _close(tc1, jc1, MODEL_TOL)
    _close(ts1, js1, MODEL_TOL)
    # an f32 cache holding the prompt (a ring of W entries in a window
    # layer, where S = W puts position p at p % W on both sides)
    length = Smax if window == 0 else window
    k0 = np.zeros((B, cfg.num_kv_heads, length, cfg.head_dim), np.float32)
    v0 = k0.copy()
    k0[:, :, :S], v0[:, :, :S] = np.asarray(jk), np.asarray(jv)
    jkv = (jnp.asarray(k0), jnp.asarray(v0))
    tkv = (torch.from_numpy(k0), torch.from_numpy(v0))
    rng = np.random.default_rng(12)
    for step in range(3):
        x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
        pos = np.array([S + step, S + 2 * step], np.int32)
        jy, jkv, jc1, js1 = hymba_layer_decode(lp, jnp.asarray(x), cfg, window,
                                               jkv, jnp.asarray(pos), jc1, js1)
        ty, tc1, ts1 = layer.decode(torch.from_numpy(x), tkv,
                                    torch.from_numpy(pos), cfg, False, tc1, ts1)
        _close(ty, jy, MODEL_TOL)
        _close(ts1, js1, MODEL_TOL)
    _close(tkv[0], jkv[0], MODEL_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _port_layout(cfg, groups):
    """The reference's per-group cache as the port's stacked leaves (numpy
    f32): full groups' KV stacked, window groups' KV concatenated, conv and
    ssm in layer order."""
    out = {k: [] for k in ("k_full", "v_full", "k_swa", "v_swa", "conv", "ssm")}
    for (kind, _), g in zip(layer_groups(cfg), groups):
        for name in ("k", "v", "conv", "ssm"):
            a = _np(g[name])
            out[f"{name}_{kind}" if name in ("k", "v") else name].append(
                a[None] if kind == "full" else a)
    return {k: np.concatenate(v) for k, v in out.items()}


def _jax_decode_cache(bundle, small, B, Smax, kv_dtype=jnp.bfloat16):
    """The reference's prefill cache padded into ``init_cache(B, Smax)``'s
    lengths: KV in ``kv_dtype`` (the engines' bf16 by default), conv and
    ssm in f32 (the port's states with f32 weights)."""
    def pad(big, s):
        widths = [(0, 0)] * s.ndim
        widths[-2] = (0, big.shape[-2] - s.shape[-2])
        return jnp.pad(s, widths).astype(kv_dtype)

    return tuple({"k": pad(gb["k"], gs["k"]), "v": pad(gb["v"], gs["v"]),
                  "conv": gs["conv"].astype(jnp.float32), "ssm": gs["ssm"]}
                 for gb, gs in zip(bundle.init_cache(B, Smax), small))


def _port_decode_cache(model, small, B, Smax, kv_dtype=torch.bfloat16):
    """The port's prefill cache written row by row through the engine's
    merge into ``init_cache(B, Smax)``, its KV in ``kv_dtype``."""
    cache = {k: v.to(kv_dtype) if k.startswith(("k_", "v_")) else v
             for k, v in model.init_cache(B, Smax).items()}
    for b in range(B):
        _merge_slot(cache, {k: v[:, b:b + 1] for k, v in small.items()}, b)
    return cache


@pytest.mark.parametrize("S", [5, 8, 16])
def test_prefill_and_decode_logits_match_reference(S, hymba):
    cfg, bundle, params, model, jprefill, jdecode = hymba
    assert isinstance(model, HymbaLM)
    rng = np.random.default_rng(S)
    B, Smax = 2, 32
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    jl, jsmall = jprefill(params, {"tokens": jnp.asarray(tokens)})
    tl, tsmall = model.prefill(torch.from_numpy(tokens))
    _close(tl, jl, MODEL_TOL)
    ref = _port_layout(cfg, jsmall)
    assert set(tsmall) == set(ref)
    for name, leaf in tsmall.items():
        assert tuple(leaf.shape) == ref[name].shape, name
        _close(leaf, ref[name], MODEL_TOL)
    jcache = _jax_decode_cache(bundle, jsmall, B, Smax)
    tcache = _port_decode_cache(model, tsmall, B, Smax)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, size=B).astype(np.int32)
        pos = np.array([S + step, S + step], np.int32)
        jl, jcache = jdecode(params, jcache, jnp.asarray(tok),
                             jnp.asarray(pos))
        tl, tcache = model.decode_step(tcache, torch.from_numpy(tok),
                                       torch.from_numpy(pos))
        _close(tl, jl, MODEL_TOL)
    ref = _port_layout(cfg, jcache)
    for name in ("ssm", "conv"):  # the states after the decode steps
        _close_to_scale(tcache[name], ref[name], MODEL_TOL)
    for name in ("k_full", "k_swa", "v_swa"):
        _close(tcache[name], ref[name], BF16_TOL)


def _next_token_error(prefill, decode, tokens, S, Smax):
    """max |logits of prefill(S) + one decode step - logits of
    prefill(S + 1)| over the batch, and their scale."""
    _, small = prefill(tokens[:, :S])
    ref, _ = prefill(tokens[:, :S + 1])
    got = decode(small, tokens[:, S], S, Smax)
    ref = _np(ref)
    return float(np.abs(_np(got) - ref).max()), float(np.abs(ref).max())


@pytest.mark.parametrize("S", [12, 21])
def test_ring_after_a_long_prefill_continues_the_sequence(S, hymba):
    """Past the window (S > W, S % W != 0) a prefill of S tokens and one
    decode step give the logits of a prefill of S + 1, with the caches in
    f32 so that only the ring's order can part them.  The port places
    position p at p % W and meets that; the reference's ring, whose last W
    rows sit at 0..W-1, misses it by over a tenth of the scale
    (ROADMAP.md C)."""
    cfg, bundle, params, model, jprefill, jdecode = hymba
    assert S > cfg.sliding_window and S % cfg.sliding_window
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, S + 1)).astype(np.int32)
    B, Smax = 2, 32

    def port_decode(small, tok, pos, Smax):
        cache = _port_decode_cache(model, small, B, Smax, torch.float32)
        return model.decode_step(cache, torch.from_numpy(tok), pos)[0]

    def jax_decode(small, tok, pos, Smax):
        cache = _jax_decode_cache(bundle, small, B, Smax, jnp.float32)
        return jdecode(params, cache, jnp.asarray(tok),
                       jnp.asarray(pos, jnp.int32))[0]

    err, scale = _next_token_error(lambda t: model.prefill(torch.from_numpy(t)),
                                   port_decode, tokens, S, Smax)
    assert err <= MODEL_TOL * scale, (err, scale)
    err, scale = _next_token_error(
        lambda t: jprefill(params, {"tokens": jnp.asarray(t)}), jax_decode,
        tokens, S, Smax)
    assert err > 0.1 * scale, (err, scale)


def test_bridge_is_bit_exact_on_bf16_params(bf16_pair):
    cfg, _, params, model = bf16_pair
    ref = jax.tree.map(np.asarray, params)

    def bits(t):
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()

    def ref_bits(a):
        return a.view(np.int16 if a.itemsize == 2 else np.int32)

    np.testing.assert_array_equal(bits(model.embed), ref_bits(ref["embed"]))
    np.testing.assert_array_equal(bits(model.lm_head), ref_bits(ref["lm_head"]))
    layer, first = 0, []
    for (kind, count), group in zip(layer_groups(cfg), ref["groups"]):
        first.append(layer)
        for j in range(count):
            mine = model.layers[layer]
            pick = (lambda a: a) if kind == "full" else (lambda a, j=j: a[j])
            for name in ("ln1", "fuse_na", "fuse_ns", "ln2"):
                np.testing.assert_array_equal(bits(getattr(mine, name)),
                                              ref_bits(pick(group[name])))
            for sub in ("attn", "mamba", "mlp"):
                for key, leaf in group[sub].items():
                    t = getattr(mine, sub)[key]
                    assert t.element_size() == leaf.itemsize, key
                    np.testing.assert_array_equal(bits(t), ref_bits(pick(leaf)))
            layer += 1
    assert layer == cfg.num_layers and first == [0, 1, 3, 4]
    assert model.layers[2].mamba["a_log"].dtype == torch.float32
    assert model.layers[2].mamba["w_in"].dtype == torch.bfloat16


def test_bridge_rejects_another_layout(hymba):
    _, _, params, _ = hymba[:4]
    cfg, _ = _configs()
    other = build_model(dataclasses.replace(cfg, full_attn_layers=(0, 2)),
                        device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="groups"):
        load_reference_params(other, jax.tree.map(np.asarray, params))


def test_init_params_follows_reference_rules():
    cfg, jcfg = _configs()
    model = build_model(cfg, device="cpu", dtype=torch.bfloat16)
    model.init_params(torch.Generator().manual_seed(0))
    ref = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.key(0)))
    m = model.layers[1].mamba
    assert m["a_log"].dtype == torch.float32
    np.testing.assert_array_equal(m["a_log"].numpy(),
                                  ref["groups"][1]["mamba"]["a_log"][0])
    assert torch.equal(m["d_skip"], torch.ones_like(m["d_skip"]))
    for zero in (m["dt_bias"], model.layers[1].fuse_na, model.layers[1].ln1,
                 model.final_norm):
        assert float(zero.float().abs().max()) == 0.0
    for key, scale in (("conv_w", 0.5), ("w_dt", 0.1)):
        assert abs(float(m[key].float().std()) / scale - 1.0) < 0.1, key
    w_in = m["w_in"].float()
    assert abs(float(w_in.std()) * np.sqrt(w_in.shape[0]) - 1.0) < 0.1
    assert [layer.window for layer in model.layers] == [0, 8, 8, 0, 8, 8]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _record_port(eng):
    log = []
    prefill, decode = eng.model.prefill, eng.model.decode_step

    def rec_prefill(tokens):
        out = prefill(tokens)
        log.append((out[0].numpy().copy(), None))
        return out

    def rec_decode(cache, tokens, pos):
        out = decode(cache, tokens, pos)
        log.append((out[0].numpy().copy(), np.asarray(pos).reshape(-1) >= 0))
        return out

    eng.model = _Calls(rec_prefill, rec_decode)
    return log


class _Calls:
    def __init__(self, prefill, decode_step):
        self.prefill, self.decode_step = prefill, decode_step


def _record_jax(eng):
    log = []
    prefill, decode = eng._prefill_one, eng._decode

    def rec_prefill(params, tokens):
        out = prefill(params, tokens)
        log.append(np.asarray(out[0]))
        return out

    def rec_decode(params, cache, tokens, pos):
        out = decode(params, cache, tokens, pos)
        log.append(np.asarray(out[0]))
        return out

    eng._prefill_one, eng._decode = rec_prefill, rec_decode
    return log


def _serve(eng, prompts, max_new, req_cls):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(i, p, max_new_tokens=max_new))
    return {r.req_id: r for r in eng.run_to_completion()}


def _prompts(cfg, seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lengths]


def test_engine_matches_reference_step_by_step(hymba):
    """Same prompts (S <= W or multiples of W), same weights: the same
    tokens and, step by step, the same logits of the active rows.  The
    reference's cache starts with bf16 conv states, which its merge rounds
    the f32 prefill's into; it is given f32 ones, as the port keeps the
    weights' dtype.  Neither engine has a prefix cache for hymba."""
    cfg, bundle, params, model = hymba[:4]
    prompts = _prompts(cfg, 0, [5, 16, 8, 24])
    jeng = JaxServingEngine(bundle, params, slots=2, max_len=48)
    jeng.cache = tuple(dict(g, conv=g["conv"].astype(jnp.float32))
                       for g in jeng.cache)
    assert jeng.prefix_cache is None
    jlog = _record_jax(jeng)
    ref = _serve(jeng, prompts, 6, JaxServeRequest)
    eng = ServingEngine(model, device="cpu", slots=2, max_len=48)
    log = _record_port(eng)
    ours = _serve(eng, prompts, 6, ServeRequest)
    assert len(log) == len(jlog)
    for (mine, active), theirs in zip(log, jlog):
        if active is not None:  # idle rows' logits are thrown away
            mine, theirs = mine[active], theirs[active]
        err, scale = np.abs(mine - theirs).max(), np.abs(theirs).max()
        assert err <= ENGINE_TOL * scale, (err, scale)
    assert {i: r.generated for i, r in ours.items()} == \
        {i: r.generated for i, r in ref.items()}
    assert eng.stats == jeng.stats
    assert eng.prefix_cache is None and eng.stats["cached_tokens"] == 0


def test_engine_batched_equals_solo(hymba):
    """Ragged prompts past the window: each request generates in a batch
    what it generates alone."""
    cfg, _, _, model = hymba[:4]
    prompts = _prompts(cfg, 1, [13, 3, 21])
    batched = _serve(ServingEngine(model, device="cpu", slots=3, max_len=40),
                     prompts, 6, ServeRequest)
    for i, p in enumerate(prompts):
        solo = _serve(ServingEngine(model, device="cpu", slots=1, max_len=40),
                      [p], 6, ServeRequest)[0]
        assert solo.generated == batched[i].generated, f"req {i} diverged"


def test_idle_slot_writes_no_kv_and_is_rewritten_at_admission(hymba):
    """An idle slot decodes at position -1: its KV stays put while its Mamba
    states drift; admission overwrites every leaf, and a request admitted
    there generates what it generates in a fresh engine."""
    cfg, _, _, model = hymba[:4]
    x, y, z = _prompts(cfg, 2, [12, 7, 9])
    eng = ServingEngine(model, device="cpu", slots=2, max_len=40)
    eng.submit(ServeRequest(0, x, max_new_tokens=10))
    eng.submit(ServeRequest(1, y, max_new_tokens=3))
    eng.step()
    slot_y = next(s for s, r in eng.active.items() if r.req_id == 1)
    eng.step()
    eng.step()  # y is done, its slot idle
    assert slot_y not in eng.active
    before = {k: v[:, slot_y].clone() for k, v in eng.cache.items()}
    eng.step()
    eng.step()
    for k in ("k_full", "v_full", "k_swa", "v_swa"):
        assert torch.equal(before[k], eng.cache[k][:, slot_y]), k
    assert not torch.equal(before["ssm"], eng.cache["ssm"][:, slot_y])
    eng.submit(ServeRequest(2, z, max_new_tokens=5))
    done = {r.req_id: r for r in eng.run_to_completion()}
    assert done[2].slot == slot_y
    solo = _serve(ServingEngine(model, device="cpu", slots=1, max_len=40),
                  [z], 5, ServeRequest)[0]
    assert done[2].generated == solo.generated


def test_serve_model_serves_hymba(capsys):
    from repro_torch.launch import serve_model

    done = serve_model.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--requests", "3", "--max-new", "4"])
    assert len(done) == 3 and all(len(r.generated) == 4 for r in done)
    assert "arch=hymba-1.5b (reduced, cpu) served 3 requests" in capsys.readouterr().out
