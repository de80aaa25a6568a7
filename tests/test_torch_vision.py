"""The port's VLM (llama-3.2-vision-11b) against the JAX package's
``make_vlm`` on the same weights.

The config is ``reduced_config(cfg, layers=4)``: two groups of two self
layers, each followed by a cross layer (so the bridge maps the nested
(G, per) stacking), four query heads over one KV head, 16 image tokens of
width 32.  Weights come from ``make_vlm(cfg).init(jax.random.key(0))``
with every ``gate`` and ``gate_mlp`` set to a seeded nonzero value, a
different one per group (the reference inits them to zero, and a zero gate
would hide the cross-attention), and cross through
``repro_torch.bridge``; tokens and image embeddings are drawn with numpy.
Tolerances: f32 logits, caches and layer outputs to 1e-4 of the
reference's scale (max |ref|), where both compute the same function; bf16
to 2e-2 of the scale, where both round to bf16 at the same steps but the
reference also rounds the softmax weights before P V, and the port's bf16
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
from repro.models.vision import cross_kv as jax_cross_kv
from repro.models.vision import cross_layer_apply as jax_cross_layer_apply
from repro_torch.bridge import load_reference_params
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.launch.serve_model import generate
from repro_torch.models import build_model
from repro_torch.models.vision import CrossLayer, VisionLM
from repro_torch.serving.engine import ServingEngine, _merge_slot
from torch_threads import one_thread  # noqa: F401  (autouse)

ARCH = "llama-3.2-vision-11b"
TOL = 1e-4
BF16_TOL = 2e-2
BF16_ERR_RATIO = 1.25
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _configs():
    cfg = reduced_config(get_config(ARCH), layers=4)
    jcfg = jax_reduced_config(jax_get_config(ARCH), layers=4)
    assert cfg.to_dict() == jcfg.to_dict()
    assert (cfg.num_layers // cfg.cross_attn_every, cfg.cross_attn_every) == (2, 2)
    return cfg, jcfg


def gate_values(groups: int, seed: int = 7):
    """Seeded nonzero gates, one per group and sublayer: |g| in [0.4, 1.2],
    either sign."""
    rng = np.random.default_rng(seed)
    mag = rng.uniform(0.4, 1.2, size=(2, groups)).astype(np.float32)
    return mag * rng.choice(np.array([-1.0, 1.0], np.float32), size=(2, groups))


def _with_gates(params, values):
    cross = dict(params["cross_layers"], gate=jnp.asarray(values[0]),
                 gate_mlp=jnp.asarray(values[1]))
    return dict(params, cross_layers=cross)


def _pair(dtype="float32", gates=True):
    """The reference bundle and params and the port's model with those
    params: f32 casts every leaf, bf16 keeps the reference's own dtypes
    (bf16, and f32 for the gates)."""
    cfg, jcfg = _configs()
    bundle = jax_build_model(jcfg)
    params = bundle.init(jax.random.key(0))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    if gates:
        params = _with_gates(params, gate_values(cfg.num_layers // cfg.cross_attn_every))
    model = build_model(cfg, device="cpu", dtype=TORCH_DT[dtype])
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return cfg, bundle, params, model


@pytest.fixture(scope="module")
def vlm():
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


def _inputs(cfg, B, S, seed, dtype="float32"):
    """tokens (B, S) int32 and image embeddings as (jax, torch) of the same
    values in ``dtype``."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    img = rng.standard_normal((B, cfg.num_image_tokens, cfg.vision_d_model)
                              ).astype(np.float32)
    jimg = jnp.asarray(img, JAX_DT[dtype])
    timg = torch.from_numpy(np.array(_np(jimg))).to(TORCH_DT[dtype])
    return tokens, jimg, timg


def _flat(cfg, jcache):
    """The reference's cache {"self": (k, v) of (G, per, ...), "cross":
    (ck, cv) of (G, ...)} in the port's dict of stacked leaves."""
    (k, v), (ck, cv) = jcache["self"], jcache["cross"]
    flat = lambda a: a.reshape((cfg.num_layers,) + a.shape[2:])  # noqa: E731
    return {"k": flat(k), "v": flat(v), "ck": ck, "cv": cv}


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


# ---------------------------------------------------------------------------
# one cross layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [0, 1])
def test_cross_layer_matches_reference(dtype, group):
    cfg, jcfg = _configs()
    _, _, params, model = _pair(dtype)
    jp = jax.tree.map(lambda a: a[group], params["cross_layers"])
    layer = model.cross_layers[group]
    assert isinstance(layer, CrossLayer)
    assert layer.gate.dtype == torch.float32 and layer.gate.ndim == 0
    assert float(layer.gate) == float(jp["gate"]) != 0.0
    _, jimg, timg = _inputs(cfg, 2, 1, seed=group)
    x = np.random.default_rng(10 + group).standard_normal((2, 9, cfg.d_model))
    jx = jnp.asarray(x, JAX_DT[dtype])
    tx = torch.from_numpy(np.array(_np(jx))).to(TORCH_DT[dtype])
    jk, jv = jax_cross_kv(jp, jimg, jcfg)
    ref = jax_cross_layer_apply(jp, jx, jk, jv, jcfg)
    tk, tv = layer.kv(timg, cfg)
    tol = TOL if dtype == "float32" else BF16_TOL
    _close_to_scale(tk, jk, tol)
    for plain in (False, True):  # the CPU runs the plain version either way
        ours = layer.prefill(tx, tk, tv, cfg, plain)
        assert ours.dtype == TORCH_DT[dtype]
        _close_to_scale(ours, ref, tol)


def test_cross_layer_decode_equals_its_one_row_prefill():
    """Decode over the bf16 cross cache (all entries) is the prefill of one
    query row over the same, bf16-rounded, K/V."""
    cfg, _ = _configs()
    _, _, _, model = _pair()
    layer = model.cross_layers[1]
    _, _, timg = _inputs(cfg, 3, 1, seed=4)
    k, v = layer.kv(timg, cfg)
    k, v = k.to(torch.bfloat16).float(), v.to(torch.bfloat16).float()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, cfg.d_model)).astype(np.float32))
    ck = k.transpose(1, 2).contiguous().to(torch.bfloat16)
    cv = v.transpose(1, 2).contiguous().to(torch.bfloat16)
    lengths = torch.full((3,), cfg.num_image_tokens, dtype=torch.int32)
    ours = layer.decode(x, ck, cv, lengths, cfg, False)
    _close_to_scale(ours, layer.prefill(x[:, None], k, v, cfg, False)[:, 0], TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S", [(2, 11), (1, 1), (3, 20)])
def test_prefill_and_decode_logits_match_reference(B, S, vlm):
    cfg, bundle, params, model, jprefill, jdecode = vlm
    assert isinstance(model, VisionLM)
    tokens, jimg, timg = _inputs(cfg, B, S, seed=S)
    jl, jsmall = jprefill(params, {"tokens": jnp.asarray(tokens),
                                   "image_embeds": jimg})
    tl, tsmall = model.prefill(torch.from_numpy(tokens), timg)
    assert tuple(tl.shape) == (B, cfg.vocab_size) and tl.dtype == torch.float32
    _close_to_scale(tl, jl, TOL)
    # the prompt's KV and the image's K/V, layer for layer
    ref = _flat(cfg, jsmall)
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
    ref = _flat(cfg, jcache)
    for name in ("k", "v"):  # the steps' K/V, written in place
        _close_to_scale(tcache[name], ref[name], BF16_TOL)


def test_decode_with_per_row_positions_matches_reference(vlm):
    """Rows at their own positions, one of them rewriting its prompt's KV.
    The caches are f32 on both sides: in a bf16 cache an f32 K a few ulps
    apart may round to the next bf16 value, which moves later layers'
    logits by ~5e-4 of their scale."""
    cfg, bundle, params, model, _, jdecode = vlm
    tokens, jimg, timg = _inputs(cfg, 2, 6, seed=3)
    _, jsmall = bundle.prefill(params, {"tokens": jnp.asarray(tokens),
                                        "image_embeds": jimg})
    _, tsmall = model.prefill(torch.from_numpy(tokens), timg)
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
    """``init_cache`` against ``cache_shape_fn`` with the self leaves'
    (G, per) dims flattened."""
    cfg, jcfg = _configs()
    bundle = jax_build_model(jcfg)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    (k, v), (ck, cv) = (bundle.cache_shape_fn(3, 24)[n] for n in ("self", "cross"))
    ref = {"k": (cfg.num_layers,) + k.shape[2:], "v": (cfg.num_layers,) + v.shape[2:],
           "ck": ck.shape, "cv": cv.shape}
    assert k.shape[:2] == (cfg.num_layers // cfg.cross_attn_every, cfg.cross_attn_every)
    assert k.dtype == ck.dtype == jnp.bfloat16
    cache = model.init_cache(3, 24)
    assert set(cache) == set(ref)
    for name, leaf in cache.items():
        assert tuple(leaf.shape) == tuple(ref[name]), name
        assert leaf.dtype == torch.bfloat16 and leaf.is_contiguous()
    G = cfg.num_layers // cfg.cross_attn_every
    assert tuple(cache["ck"].shape) == (G, 3, cfg.num_kv_heads,
                                        cfg.num_image_tokens, cfg.head_dim)


def test_generate_matches_the_reference_greedy_loop(vlm):
    """``serve_model.generate`` (one prefill, the cache copied into S +
    max_new positions, greedy steps at S + i) gives the reference's tokens
    from its own prefill -> decode loop."""
    cfg, bundle, params, model, jprefill, jdecode = vlm
    B, S, max_new = 3, 7, 5
    tokens, jimg, timg = _inputs(cfg, B, S, seed=21)
    ours, times = generate(model, tokens, timg, max_new)
    assert tuple(ours.shape) == (B, 1 + max_new) and set(times) == {
        "prefill_s", "decode_s"}
    jl, small = jprefill(params, {"tokens": jnp.asarray(tokens),
                                  "image_embeds": jimg})
    jcache = _jax_decode_cache(bundle, small, B, S + max_new)
    tok = jnp.argmax(jl, axis=-1)
    ref = [tok]
    for i in range(max_new):
        jl, jcache = jdecode(params, jcache, tok, jnp.asarray(S + i, jnp.int32))
        tok = jnp.argmax(jl, axis=-1)
        ref.append(tok)
    np.testing.assert_array_equal(ours.numpy(), np.stack(ref, axis=1))


def test_gates_let_the_image_through(vlm):
    """With the seeded nonzero gates another image gives other logits, in
    prefill and in decode, on both sides; with the reference's zero gates
    the image changes nothing (so a zero-gate test could not see the
    cross-attention)."""
    cfg, _, params, model, jprefill, _ = vlm
    tokens, jimg, timg = _inputs(cfg, 2, 8, seed=30)
    _, jimg2, timg2 = _inputs(cfg, 2, 8, seed=31)
    j1, _ = jprefill(params, {"tokens": jnp.asarray(tokens), "image_embeds": jimg})
    j2, _ = jprefill(params, {"tokens": jnp.asarray(tokens), "image_embeds": jimg2})
    t1, c1 = model.prefill(torch.from_numpy(tokens), timg)
    t2, c2 = model.prefill(torch.from_numpy(tokens), timg2)
    scale = float(np.abs(_np(j1)).max())
    assert float(np.abs(_np(j1) - _np(j2)).max()) > 1e-2 * scale
    assert float((t1 - t2).abs().max()) > 1e-2 * scale
    _close_to_scale(t2, j2, TOL)
    caches = [_port_decode_cache(model, c, 2, 9) for c in (c1, c2)]
    tok = torch.tensor([3, 4])
    d1, _ = model.decode_step(caches[0], tok, 8)
    d2, _ = model.decode_step(caches[1], tok, 8)
    assert float((d1 - d2).abs().max()) > 1e-2 * float(d1.abs().max())

    _, _, _, shut = _pair(gates=False)
    assert all(float(c.gate) == float(c.gate_mlp) == 0.0 for c in shut.cross_layers)
    z1, _ = shut.prefill(torch.from_numpy(tokens), timg)
    z2, _ = shut.prefill(torch.from_numpy(tokens), timg2)
    assert torch.equal(z1, z2)


def test_bf16_logits_match_reference():
    """bf16 weights on both sides: prefill logits and caches and four decode
    steps' logits within 2e-2 of the scale, and the port's logits as close
    to the reference's f32 run as the reference's bf16 ones (RMS over all
    five logit rows of the four sequences, at most BF16_ERR_RATIO of the
    reference's: a single element of two bf16 pipelines parts by up to
    ~2% of the scale, the RMS is the steadier measure)."""
    cfg, bundle, params, model = _pair("bfloat16")
    _, _, params32, _ = _pair("float32")
    B, S = 4, 10
    tokens, jimg, timg = _inputs(cfg, B, S, seed=40, dtype="bfloat16")
    jl, jsmall = bundle.prefill(params, {"tokens": jnp.asarray(tokens),
                                         "image_embeds": jimg})
    fl, fsmall = bundle.prefill(params32, {"tokens": jnp.asarray(tokens),
                                           "image_embeds": jimg.astype(jnp.float32)})
    tl, tsmall = model.prefill(torch.from_numpy(tokens), timg)
    _close_to_scale(tl, jl, BF16_TOL)
    for name, leaf in tsmall.items():
        assert leaf.dtype == torch.bfloat16
        _close_to_scale(leaf, _flat(cfg, jsmall)[name], BF16_TOL)
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
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()

    def ref_bits(a):
        a = np.asarray(a)
        return a.view(np.int16 if a.itemsize == 2 else np.int32)

    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(bits(getattr(model, name)),
                                      ref_bits(ref[name]))
    per = cfg.cross_attn_every
    for i, layer in enumerate(model.self_layers):
        tree = ref["self_layers"]
        for name in ("ln1", "ln2"):
            np.testing.assert_array_equal(bits(getattr(layer, name)),
                                          ref_bits(tree[name][i // per][i % per]))
        for group in ("attn", "mlp"):
            for key, leaf in tree[group].items():
                np.testing.assert_array_equal(
                    bits(getattr(layer, group)[key]),
                    ref_bits(leaf[i // per][i % per]))
    for g, layer in enumerate(model.cross_layers):
        tree = ref["cross_layers"]
        for name in ("ln", "wq", "wk", "wv", "wo", "gate", "ln_mlp", "gate_mlp"):
            mine = getattr(layer, name)
            assert mine.element_size() == tree[name].itemsize, name
            np.testing.assert_array_equal(bits(mine), ref_bits(tree[name][g]))
        for key, leaf in tree["mlp"].items():
            np.testing.assert_array_equal(bits(layer.mlp[key]), ref_bits(leaf[g]))
    assert model.cross_layers[0].gate.dtype == torch.float32
    assert model.cross_layers[0].wq.dtype == torch.bfloat16


def test_bridge_rejects_a_mismatched_tree():
    cfg, jcfg = _configs()
    params = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.key(0)))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    # three groups of one self layer: the (G, per) stacking differs
    other = build_model(dataclasses.replace(cfg, num_layers=3, cross_attn_every=1),
                        device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="self_layers"):
        load_reference_params(other, params)
    gateless = dict(params, cross_layers={k: v for k, v in params["cross_layers"].items()
                                          if k != "gate"})
    with pytest.raises(ValueError, match="keys"):
        load_reference_params(model, gateless)
    with pytest.raises(ValueError, match="keys"):
        load_reference_params(model, dict(params, layers=params["self_layers"]))


def test_init_params_follows_reference_rules():
    """Zero norms and gates (f32 in a bf16 model), normal weights at
    1/sqrt(fan_in): the vision width for wk/wv."""
    cfg, _ = _configs()
    model = build_model(cfg, device="cpu", dtype=torch.bfloat16)
    model.init_params(torch.Generator().manual_seed(0))
    for cross in model.cross_layers:
        for gate in (cross.gate, cross.gate_mlp):
            assert gate.dtype == torch.float32 and gate.ndim == 0
            assert float(gate) == 0.0
        assert float(cross.ln.float().abs().max()) == 0.0
    wk = model.cross_layers[1].wk.float()
    assert wk.shape[0] == cfg.vision_d_model
    assert abs(float(wk.std()) * np.sqrt(wk.shape[0]) - 1.0) < 0.1
    assert abs(float(model.embed.float().std()) - 1.0) < 0.05
    assert len(model.self_layers) == cfg.num_layers
    assert len(model.cross_layers) == cfg.num_layers // cfg.cross_attn_every


def test_engine_refuses_the_vlm():
    model = build_model(reduced_config(get_config(ARCH)), device="cpu",
                        dtype=torch.float32)
    with pytest.raises(ValueError, match="image or audio"):
        ServingEngine(model, device="cpu")


def test_serve_model_generates_for_the_vlm(capsys):
    from repro_torch.launch import serve_model

    out = serve_model.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                            "--requests", "3", "--max-new", "4"])
    assert tuple(out.shape) == (3, 5)
    assert bool(((out >= 0) & (out < 256)).all())
    text = capsys.readouterr().out
    assert "arch=llama-3.2-vision-11b (reduced, cpu) generated for 3 requests" in text
    assert "prefill" in text and "decode step" in text


@pytest.mark.gpu
def test_cuda_prefill_and_decode_go_through_the_kernels():
    """On the card, at head dim 128 and a ragged image of 77 entries: one
    flash launch per self and cross layer of a prefill, one decode launch
    per self and cross layer of a step, and the kernels' logits within
    1e-3 of the scale of the plain versions' (f32 weights, nonzero gates)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import common

    cfg = dataclasses.replace(reduced_config(get_config(ARCH), layers=4, d_model=512),
                              num_image_tokens=77)
    assert cfg.head_dim == 128
    dev = torch.device("cuda")
    model = build_model(cfg, device=dev, dtype=torch.float32)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    gates = gate_values(len(model.cross_layers))
    with torch.no_grad():
        for cross, g, g_mlp in zip(model.cross_layers, *gates):
            cross.gate.fill_(float(g))
            cross.gate_mlp.fill_(float(g_mlp))
    tokens, _, img = _inputs(cfg, 2, 37, seed=50)
    img = img.to(dev)
    runs = {}
    for plain in (True, False):
        model.plain_kernels = plain
        common.reset_launch_counts()
        logits, small = model.prefill(torch.from_numpy(tokens), img)
        cache = _port_decode_cache(model, small, 2, 40)
        step, _ = model.decode_step(cache, torch.tensor([1, 2], device=dev), 37)
        torch.cuda.synchronize()
        runs[plain] = (logits, step, dict(common.launch_counts))
    layers = cfg.num_layers + len(model.cross_layers)
    assert runs[True][2]["flash_attention"] == runs[True][2]["decode_attention"] == 0
    assert runs[False][2]["flash_attention"] == layers
    assert runs[False][2]["decode_attention"] == layers
    for i in (0, 1):
        _close_to_scale(runs[False][i].cpu(), runs[True][i].cpu(), 1e-3)
