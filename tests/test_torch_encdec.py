"""The port's encoder-decoder (seamless-m4t-large-v2) against the JAX
package's ``make_encdec`` on the same weights.

The config is ``reduced_config(cfg, layers=4)``: four encoder and four
decoder layers of d 64, four heads of 16 (MHA, as the full model), 16
audio frames.  Weights come from ``make_encdec(cfg).init(jax.random.key(0))``
and cross through ``repro_torch.bridge``; tokens and audio frames are
drawn with numpy.  Tolerances: f32 logits, caches, encoder output and
layer outputs to 1e-4 of the reference's scale (max |ref|), where both
compute the same function; bf16 to 2e-2 of the scale, and the port's bf16
logits as close to the reference's f32 run as the reference's bf16 ones
(RMS, at most BF16_ERR_RATIO of the reference's).
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
from repro.models.encdec import _cross_apply_seq as jax_cross_apply_seq
from repro.models.layers import attention_block_prefill as jax_attention_prefill
from repro.models.layers import matmul as jax_matmul
from repro.models.layers import mlp_block as jax_mlp_block
from repro.models.layers import rms_norm as jax_rms_norm
from repro.models.transformer import encoder_layer as jax_encoder_layer
from repro_torch.bridge import load_reference_params
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.launch.serve_model import generate
from repro_torch.models import build_model
from repro_torch.models.encdec import EncDecLayer, EncDecLM
from repro_torch.models.transformer import EncoderLayer
from repro_torch.serving.engine import ServingEngine, _merge_slot
from torch_threads import one_thread  # noqa: F401  (autouse)

ARCH = "seamless-m4t-large-v2"
TOL = 1e-4
BF16_TOL = 2e-2
BF16_ERR_RATIO = 1.25
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _configs():
    cfg = reduced_config(get_config(ARCH), layers=4)
    jcfg = jax_reduced_config(jax_get_config(ARCH), layers=4)
    assert cfg.to_dict() == jcfg.to_dict()
    assert (cfg.encoder_layers, cfg.num_layers, cfg.num_kv_heads) == (4, 4, 4)
    return cfg, jcfg


def _pair(dtype="float32"):
    """The reference bundle and params and the port's model with those
    params: f32 casts every leaf, bf16 keeps the reference's own."""
    cfg, jcfg = _configs()
    bundle = jax_build_model(jcfg)
    params = bundle.init(jax.random.key(0))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    model = build_model(cfg, device="cpu", dtype=TORCH_DT[dtype])
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return cfg, bundle, params, model


@pytest.fixture(scope="module")
def encdec():
    cfg, bundle, params, model = _pair()
    return (cfg, bundle, params, model, jax.jit(bundle.prefill),
            jax.jit(bundle.decode_step))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close_to_scale(ours, ref, tol):
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err, scale = np.abs(ours - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"max |diff| {err} > {tol} * {scale}"


def _both(a, dtype):
    """A numpy array as (jax, torch) in ``dtype``, the same rounded values."""
    j = jnp.asarray(a, JAX_DT[dtype])
    return j, torch.from_numpy(np.array(_np(j))).to(TORCH_DT[dtype])


def _inputs(cfg, B, S, seed, dtype="float32"):
    """tokens (B, S) int32 and audio frames as (jax, torch) in ``dtype``."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    audio = rng.standard_normal((B, cfg.num_audio_frames, cfg.d_model))
    return (tokens,) + _both(audio.astype(np.float32), dtype)


def _cache(jcache):
    """The reference's {"self": (k, v), "cross": (ck, cv)} as the port's
    dict of stacked leaves."""
    (k, v), (ck, cv) = jcache["self"], jcache["cross"]
    return {"k": k, "v": v, "ck": ck, "cv": cv}


def _jax_decode_cache(bundle, small, B, Smax, dtype="bfloat16"):
    """The reference's prefill cache written into ``init_cache(B, Smax)``:
    the self KV's S positions padded, the cross leaves whole, in ``dtype``
    (the engines' bf16 by default)."""
    def put(big, s):
        widths = [(0, 0)] * s.ndim
        widths[-2] = (0, big.shape[-2] - s.shape[-2])
        return jnp.pad(s, widths).astype(JAX_DT[dtype])

    return jax.tree.map(put, bundle.init_cache(B, Smax), small)


def _port_decode_cache(model, small, B, Smax, dtype="bfloat16"):
    """The port's prefill cache written row by row through the engine's
    merge into ``init_cache(B, Smax)``, in ``dtype``."""
    cache = {k: v.to(TORCH_DT[dtype]) for k, v in model.init_cache(B, Smax).items()}
    for b in range(B):
        _merge_slot(cache, {k: v[:, b:b + 1] for k, v in small.items()}, b)
    return cache


def _jax_encode(params, audio, jcfg):
    """The reference's ``encode`` (a closure of ``make_encdec``): its encoder
    layers, then ``enc_norm``."""
    x = audio
    for i in range(jcfg.encoder_layers):
        x = jax_encoder_layer(jax.tree.map(lambda a: a[i], params["enc_layers"]),
                              x, jcfg)
    return jax_rms_norm(x, params["enc_norm"], jcfg.norm_eps)


def _jax_dec_layer(lp, x, enc_out, jcfg):
    """The reference's ``dec_layer_prefill`` (a closure of ``make_encdec``,
    ``repro/models/encdec.py``), line for line from its module-level
    parts: x and the cross k, v (B, F, KV, D)."""
    h, _ = jax_attention_prefill(lp["self_attn"],
                                 jax_rms_norm(x, lp["ln1"], jcfg.norm_eps), jcfg)
    x = x + h
    B, F = enc_out.shape[:2]
    ck = jax_matmul(enc_out, lp["wk_x"]).reshape(B, F, jcfg.num_kv_heads,
                                                 jcfg.head_dim)
    cv = jax_matmul(enc_out, lp["wv_x"]).reshape(B, F, jcfg.num_kv_heads,
                                                 jcfg.head_dim)
    x = jax_cross_apply_seq(lp, x, ck, cv, jcfg)
    x = x + jax_mlp_block(lp["mlp"], jax_rms_norm(x, lp["ln2"], jcfg.norm_eps),
                          jcfg.activation)
    return x, ck, cv


# ---------------------------------------------------------------------------
# the layers and the encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer_idx", [0, 3])
def test_decoder_layer_matches_reference(dtype, layer_idx):
    cfg, jcfg = _configs()
    _, _, params, model = _pair(dtype)
    lp = jax.tree.map(lambda a: a[layer_idx], params["dec_layers"])
    layer = model.dec_layers[layer_idx]
    assert isinstance(layer, EncDecLayer)
    rng = np.random.default_rng(layer_idx)
    jx, tx = _both(rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32), dtype)
    jenc, tenc = _both(rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32),
                       dtype)
    ref, jck, jcv = _jax_dec_layer(lp, jx, jenc, jcfg)
    tck, tcv = layer.cross_kv(tenc, cfg)
    tol = TOL if dtype == "float32" else BF16_TOL
    _close_to_scale(tck, jck, tol)
    _close_to_scale(tcv, jcv, tol)
    for plain in (False, True):  # the CPU runs the plain version either way
        ours, (k, v) = layer.prefill(tx, tck, tcv, cfg, plain)
        assert ours.dtype == TORCH_DT[dtype]
        assert tuple(k.shape) == (2, cfg.num_kv_heads, 9, cfg.head_dim)
        _close_to_scale(ours, ref, tol)


def test_encode_matches_reference(encdec):
    cfg, _, params, model, _, _ = encdec
    _, jaudio, taudio = _inputs(cfg, 3, 1, seed=2)
    assert all(isinstance(layer, EncoderLayer) for layer in model.enc_layers)
    ours = model.encode(taudio)
    assert tuple(ours.shape) == (3, cfg.num_audio_frames, cfg.d_model)
    _close_to_scale(ours, _jax_encode(params, jaudio, cfg), TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S", [(2, 11), (1, 1), (3, 20)])
def test_prefill_and_decode_logits_match_reference(B, S, encdec):
    cfg, bundle, params, model, jprefill, jdecode = encdec
    assert isinstance(model, EncDecLM)
    tokens, jaudio, taudio = _inputs(cfg, B, S, seed=S)
    jl, jsmall = jprefill(params, {"tokens": jnp.asarray(tokens),
                                   "audio_frames": jaudio})
    tl, tsmall = model.prefill(torch.from_numpy(tokens), taudio)
    assert tuple(tl.shape) == (B, cfg.vocab_size) and tl.dtype == torch.float32
    _close_to_scale(tl, jl, TOL)
    ref = _cache(jsmall)
    assert set(tsmall) == set(ref)
    for name, leaf in tsmall.items():
        assert leaf.is_contiguous(), name
        _close_to_scale(leaf, ref[name], TOL)
    Smax = S + 4
    jcache = _jax_decode_cache(bundle, jsmall, B, Smax)
    tcache = _port_decode_cache(model, tsmall, B, Smax)
    rng = np.random.default_rng(100 + S)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, size=B).astype(np.int32)
        jl, jcache = jdecode(params, jcache, jnp.asarray(tok),
                             jnp.asarray(S + step, jnp.int32))
        tl, tcache = model.decode_step(tcache, torch.from_numpy(tok), S + step)
        _close_to_scale(tl, jl, TOL)
    ref = _cache(jcache)
    for name in ("k", "v"):  # the steps' K/V, written in place
        _close_to_scale(tcache[name], ref[name], BF16_TOL)


def test_cross_kv_pins_the_encoder_output(encdec):
    """Each decoder layer's cached cross K/V is the encoder's output
    projected: equal to the reference's "cross" leaves, and to
    ``cross_kv(encode(audio))`` of the port."""
    cfg, _, params, model, jprefill, _ = encdec
    tokens, jaudio, taudio = _inputs(cfg, 2, 5, seed=8)
    _, jsmall = jprefill(params, {"tokens": jnp.asarray(tokens),
                                  "audio_frames": jaudio})
    _, tsmall = model.prefill(torch.from_numpy(tokens), taudio)
    enc_out = model.encode(taudio)
    (jck, jcv) = jsmall["cross"]
    assert tuple(tsmall["ck"].shape) == (cfg.num_layers, 2, cfg.num_kv_heads,
                                         cfg.num_audio_frames, cfg.head_dim)
    for i, layer in enumerate(model.dec_layers):
        ck, cv = layer.cross_kv(enc_out, cfg)
        assert torch.equal(ck.transpose(1, 2), tsmall["ck"][i])
        assert torch.equal(cv.transpose(1, 2), tsmall["cv"][i])
        _close_to_scale(tsmall["ck"][i], jck[i], TOL)
        _close_to_scale(tsmall["cv"][i], jcv[i], TOL)


def test_decode_with_per_row_positions_matches_reference(encdec):
    """Rows at their own positions, one of them rewriting its prompt's KV.
    The caches are f32 on both sides: in a bf16 cache an f32 K a few ulps
    apart may round to the next bf16 value, which moves later layers'
    logits by ~5e-4 of their scale."""
    cfg, bundle, params, model, _, jdecode = encdec
    tokens, jaudio, taudio = _inputs(cfg, 2, 6, seed=3)
    _, jsmall = bundle.prefill(params, {"tokens": jnp.asarray(tokens),
                                        "audio_frames": jaudio})
    _, tsmall = model.prefill(torch.from_numpy(tokens), taudio)
    jcache = _jax_decode_cache(bundle, jsmall, 2, 16, "float32")
    tcache = _port_decode_cache(model, tsmall, 2, 16, "float32")
    for step in range(3):
        tok = np.array([5 + step, 9 * step], np.int32)
        pos = np.array([6 + step, 3 + 2 * step], np.int32)
        jl, jcache = jdecode(params, jcache, jnp.asarray(tok), jnp.asarray(pos))
        tl, tcache = model.decode_step(tcache, torch.from_numpy(tok),
                                       torch.from_numpy(pos))
        _close_to_scale(tl, jl, TOL)


def test_cache_shapes_match_reference():
    cfg, jcfg = _configs()
    bundle = jax_build_model(jcfg)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    ref = _cache(bundle.cache_shape_fn(3, 24))
    cache = model.init_cache(3, 24)
    assert set(cache) == set(ref)
    for name, leaf in cache.items():
        assert tuple(leaf.shape) == ref[name].shape, name
        assert ref[name].dtype == jnp.bfloat16
        assert leaf.dtype == torch.bfloat16 and leaf.is_contiguous()


def test_generate_matches_the_reference_greedy_loop(encdec):
    """``serve_model.generate`` (one prefill, the cache copied into S +
    max_new positions, greedy steps at S + i) gives the reference's tokens
    from its own prefill -> decode loop."""
    cfg, bundle, params, model, jprefill, jdecode = encdec
    B, S, max_new = 3, 7, 5
    tokens, jaudio, taudio = _inputs(cfg, B, S, seed=21)
    ours, _ = generate(model, tokens, taudio, max_new)
    assert tuple(ours.shape) == (B, 1 + max_new)
    jl, small = jprefill(params, {"tokens": jnp.asarray(tokens),
                                  "audio_frames": jaudio})
    jcache = _jax_decode_cache(bundle, small, B, S + max_new)
    tok = jnp.argmax(jl, axis=-1)
    ref = [tok]
    for i in range(max_new):
        jl, jcache = jdecode(params, jcache, tok, jnp.asarray(S + i, jnp.int32))
        tok = jnp.argmax(jl, axis=-1)
        ref.append(tok)
    np.testing.assert_array_equal(ours.numpy(), np.stack(ref, axis=1))


def test_audio_changes_the_logits(encdec):
    """The cross-attention is live: other frames give other logits, in
    prefill and in decode."""
    cfg, _, _, model, _, _ = encdec
    tokens, _, taudio = _inputs(cfg, 2, 8, seed=30)
    _, _, taudio2 = _inputs(cfg, 2, 8, seed=31)
    t1, c1 = model.prefill(torch.from_numpy(tokens), taudio)
    t2, c2 = model.prefill(torch.from_numpy(tokens), taudio2)
    assert float((t1 - t2).abs().max()) > 1e-2 * float(t1.abs().max())
    caches = [_port_decode_cache(model, c, 2, 9) for c in (c1, c2)]
    tok = torch.tensor([3, 4])
    d1, _ = model.decode_step(caches[0], tok, 8)
    d2, _ = model.decode_step(caches[1], tok, 8)
    assert float((d1 - d2).abs().max()) > 1e-2 * float(d1.abs().max())


def test_bf16_logits_match_reference():
    """bf16 weights on both sides: prefill logits and caches and four decode
    steps' logits within 2e-2 of the scale, and the port's logits as close
    to the reference's f32 run as the reference's bf16 ones (RMS over all
    five logit rows of the four sequences)."""
    cfg, bundle, params, model = _pair("bfloat16")
    _, _, params32, _ = _pair("float32")
    B, S = 4, 10
    tokens, jaudio, taudio = _inputs(cfg, B, S, seed=40, dtype="bfloat16")
    jl, jsmall = bundle.prefill(params, {"tokens": jnp.asarray(tokens),
                                         "audio_frames": jaudio})
    fl, fsmall = bundle.prefill(params32, {"tokens": jnp.asarray(tokens),
                                           "audio_frames": jaudio.astype(jnp.float32)})
    tl, tsmall = model.prefill(torch.from_numpy(tokens), taudio)
    _close_to_scale(tl, jl, BF16_TOL)
    for name, leaf in tsmall.items():
        assert leaf.dtype == torch.bfloat16
        _close_to_scale(leaf, _cache(jsmall)[name], BF16_TOL)
    runs = {"port": [tl], "ref": [jl], "f32": [fl]}
    jcache = _jax_decode_cache(bundle, jsmall, B, S + 4)
    fcache = _jax_decode_cache(bundle, fsmall, B, S + 4)
    tcache = _port_decode_cache(model, tsmall, B, S + 4)
    rng = np.random.default_rng(40)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, size=B).astype(np.int32)
        pos = jnp.asarray(S + step, jnp.int32)
        jl, jcache = bundle.decode_step(params, jcache, jnp.asarray(tok), pos)
        fl, fcache = bundle.decode_step(params32, fcache, jnp.asarray(tok), pos)
        tl, tcache = model.decode_step(tcache, torch.from_numpy(tok), S + step)
        _close_to_scale(tl, jl, BF16_TOL)
        for name, out in zip(("port", "ref", "f32"), (tl, jl, fl)):
            runs[name].append(out)
    port, ref, truth = (np.stack([_np(a) for a in runs[k]])
                        for k in ("port", "ref", "f32"))
    rms = lambda a: float(np.sqrt(np.square(a - truth).mean()))  # noqa: E731
    assert rms(port) <= BF16_ERR_RATIO * rms(ref), (rms(port), rms(ref))


# ---------------------------------------------------------------------------
# construction, the bridge and the entry points
# ---------------------------------------------------------------------------


def test_bridge_is_bit_exact_on_bf16_params():
    cfg, _, params, model = _pair("bfloat16")
    ref = jax.tree.map(np.asarray, params)

    def bits(t):
        return t.view(torch.int16).numpy()

    def ref_bits(a):
        return np.asarray(a).view(np.int16)

    for name in ("embed", "enc_norm", "final_norm", "lm_head"):
        np.testing.assert_array_equal(bits(getattr(model, name)),
                                      ref_bits(ref[name]))
    for stack in ("enc_layers", "dec_layers"):
        tree = ref[stack]
        for i, layer in enumerate(getattr(model, stack)):
            for key, leaf in tree.items():
                if isinstance(leaf, dict):
                    for sub, a in leaf.items():
                        np.testing.assert_array_equal(
                            bits(getattr(layer, key)[sub]), ref_bits(a[i]))
                else:
                    np.testing.assert_array_equal(bits(getattr(layer, key)),
                                                  ref_bits(leaf[i]))
    assert set(ref["dec_layers"]) == {"ln1", "self_attn", "ln_x", "wq_x", "wk_x",
                                      "wv_x", "wo_x", "ln2", "mlp"}


def test_bridge_rejects_a_mismatched_tree():
    cfg, jcfg = _configs()
    params = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.key(0)))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    deeper = build_model(dataclasses.replace(cfg, encoder_layers=5), device="cpu",
                         dtype=torch.float32)
    with pytest.raises(ValueError, match="enc_layers"):
        load_reference_params(deeper, params)
    with pytest.raises(ValueError, match="keys"):
        load_reference_params(model, {k: v for k, v in params.items()
                                      if k != "enc_norm"})
    renamed = dict(params, dec_layers=dict(
        {k: v for k, v in params["dec_layers"].items() if k != "self_attn"},
        attn=params["dec_layers"]["self_attn"]))
    with pytest.raises(ValueError, match="keys"):
        load_reference_params(model, renamed)


def test_init_params_follows_reference_rules():
    cfg, _ = _configs()
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    assert float(model.enc_norm.abs().max()) == 0.0
    assert float(model.dec_layers[1].ln_x.abs().max()) == 0.0
    assert abs(float(model.embed.std()) - 1.0) < 0.05
    wk = model.dec_layers[0].wk_x
    assert abs(float(wk.std()) * np.sqrt(wk.shape[0]) - 1.0) < 0.1
    assert "w_gate" not in model.dec_layers[0].mlp  # GELU with no gate
    assert len(model.enc_layers) == cfg.encoder_layers
    assert len(model.dec_layers) == cfg.num_layers


def test_engine_refuses_the_enc_dec():
    model = build_model(reduced_config(get_config(ARCH)), device="cpu",
                        dtype=torch.float32)
    with pytest.raises(ValueError, match="image or audio"):
        ServingEngine(model, device="cpu")


def test_serve_model_generates_for_the_enc_dec(capsys):
    from repro_torch.launch import serve_model

    out = serve_model.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                            "--requests", "2", "--max-new", "3"])
    assert tuple(out.shape) == (2, 4)
    assert bool(((out >= 0) & (out < 256)).all())
    text = capsys.readouterr().out
    assert "arch=seamless-m4t-large-v2 (reduced, cpu) generated for 2 requests" in text


@pytest.mark.gpu
def test_cuda_prefill_and_decode_go_through_the_kernels():
    """On the card, at head dim 64 (MHA): one flash launch per encoder, self
    and cross attention of a prefill, one decode launch per self and cross
    attention of a step, and the kernels' logits within 1e-3 of the scale
    of the plain versions' (f32 weights)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import common

    cfg = dataclasses.replace(reduced_config(get_config(ARCH), layers=4, d_model=256),
                              num_audio_frames=77)
    assert cfg.head_dim == 64
    dev = torch.device("cuda")
    model = build_model(cfg, device=dev, dtype=torch.float32)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    tokens, _, audio = _inputs(cfg, 2, 37, seed=50)
    audio = audio.to(dev)
    runs = {}
    for plain in (True, False):
        model.plain_kernels = plain
        common.reset_launch_counts()
        logits, small = model.prefill(torch.from_numpy(tokens), audio)
        cache = _port_decode_cache(model, small, 2, 40)
        step, _ = model.decode_step(cache, torch.tensor([1, 2], device=dev), 37)
        torch.cuda.synchronize()
        runs[plain] = (logits, step, dict(common.launch_counts))
    assert runs[True][2]["flash_attention"] == runs[True][2]["decode_attention"] == 0
    assert runs[False][2]["flash_attention"] == cfg.encoder_layers + 2 * cfg.num_layers
    assert runs[False][2]["decode_attention"] == 2 * cfg.num_layers
    for i in (0, 1):
        _close_to_scale(runs[False][i].cpu(), runs[True][i].cpu(), 1e-3)
