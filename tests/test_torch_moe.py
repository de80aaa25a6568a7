"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package.

Inputs and weights are made with numpy from a seed and handed to both
sides: ``repro.models.moe.moe_block`` and the port's ``moe_block``.  Beside
the output, the routing is compared exactly: the chosen experts of every
(row, token, k) and which choices the capacity keeps, from the port's
``route`` and ``expert_positions`` against the reference's own lines
(``moe.py:58-74``) evaluated in JAX.  Tolerances: 1e-4 in f32 (both sides
sum the same f32 products in another order); 2e-2 in bf16, of each value
and of the output's scale (its largest magnitude).  In bf16 both sides
round every product to bf16 from f32 accumulation, but the reference's
bf16 SiLU (x * sigmoid(x)) and torch's round apart in about 40% of the
elements, so an element of h can differ by an ulp (2**-8 relative), and
the down product sums f such differences into every output: an output
near 0 carries an error of the scale of its terms, not of itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.models.moe import capacity_per_row as jax_capacity_per_row
from repro.models.moe import moe_block as jax_moe_block
from repro_torch.bridge import load_reference_params
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.models.transformer import DenseLM
from torch_threads import one_thread  # noqa: F401  (autouse)

ARCHS = ["olmoe-1b-7b", "granite-moe-3b-a800m"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _layer(cfg, seed):
    """One layer's MoE weights as numpy f32, drawn as the reference's
    ``ParamDef`` draws them (normal / sqrt(fan_in))."""
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts

    def draw(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    return {"router": draw(d, E), "w_up": draw(E, d, f), "w_gate": draw(E, d, f),
            "w_down": draw(E, f, d)}


def _crowded(cfg, seed, shape):
    """Weights and an input where expert 0 is most tokens' first choice:
    every token carries one shared direction, along which router column 0
    is scaled up (its logit rises by ~8)."""
    rng = np.random.default_rng(seed)
    p = _layer(cfg, seed + 1)
    shared = rng.standard_normal(cfg.d_model).astype(np.float32)
    x = (rng.standard_normal(shape + (cfg.d_model,)) + shared).astype(np.float32)
    p["router"][:, 0] += 8.0 * shared / np.dot(shared, shared)
    return p, x


def _sides(p, x, dtype):
    """The same weights and input for both sides, the experts and x in
    ``dtype`` and the router in f32 (the cast from f32 rounds alike)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jdt)
          for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router" else tdt)
          for k, v in p.items()}
    return jp, jnp.asarray(x, jdt), tp, torch.from_numpy(x).to(tdt)


def _jax_routing(jp, jx, cfg):
    """The reference's experts and kept mask, by its own lines."""
    B, S, _ = jx.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    logits = jnp.einsum("bsd,de->bse", jx.astype(jnp.float32), jp["router"])
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    oh = jax.nn.one_hot(top_e, E, dtype=jnp.int32).reshape(B, S * K, E)
    pos = jnp.sum(oh * (jnp.cumsum(oh, axis=1) - 1), axis=-1)
    return np.asarray(top_e), np.asarray(pos < jax_capacity_per_row(S, cfg))


def _port_routing(tp, tx, cfg):
    _, top_e = moe.route(tp["router"], tx, cfg)
    pos = moe.expert_positions(top_e, cfg.num_experts)
    return top_e.numpy(), (pos < moe.capacity_per_row(tx.shape[1], cfg)).numpy()


def _check(cfg, p, x, dtype):
    """Output, chosen experts and kept mask of both sides; returns the
    share of choices dropped."""
    jp, jx, tp, tx = _sides(p, x, dtype)
    ref = np.asarray(jax_moe_block(jp, jx, cfg).astype(jnp.float32))
    with torch.no_grad():
        out = moe.moe_block(tp, tx, cfg).float().numpy()
    assert out.shape == ref.shape == x.shape
    assert np.isfinite(out).all()
    atol = TOL[dtype] * (np.abs(ref).max() if dtype == "bfloat16" else 1.0)
    np.testing.assert_allclose(out, ref, atol=atol, rtol=TOL[dtype])
    if x.ndim == 2:  # one decode token per row
        jx, tx = jx[:, None], tx[:, None]
    j_e, j_keep = _jax_routing(jp, jx, cfg)
    t_e, t_keep = _port_routing(tp, tx, cfg)
    np.testing.assert_array_equal(t_e, j_e)
    np.testing.assert_array_equal(t_keep, j_keep)
    return 1.0 - t_keep.mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, dtype):
    cfg = reduced_config(get_config(arch))
    assert cfg.to_dict() == jax_reduced_config(jax_get_config(arch)).to_dict()
    x = np.random.default_rng(1).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    _check(cfg, _layer(cfg, 0), x, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_drops_past_capacity_as_the_reference(arch, dtype):
    """Router column 0 scaled up: nearly every token picks expert 0 first,
    so over a quarter of the choices pass the capacity (10 per expert at
    S = 32), and which ones are kept follows the s-major, k-minor order of
    the exclusive cumsum."""
    cfg = reduced_config(get_config(arch))
    p, x = _crowded(cfg, 2, (2, 32))
    assert _check(cfg, p, x, dtype) >= 0.25


def test_moe_layer_at_granite_full_width_matches_reference():
    """One layer at granite-moe-3b-a800m's published widths: d 1536, 40
    experts of f 512, top 8, S = 32 (capacity 8 per expert)."""
    cfg = get_config("granite-moe-3b-a800m")
    assert (cfg.d_model, cfg.num_experts, cfg.d_ff, cfg.experts_per_token) == \
        (1536, 40, 512, 8)
    x = np.random.default_rng(4).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    _check(cfg, _layer(cfg, 5), x, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_form_matches_reference(arch, dtype):
    """A (B, d) input is one token per row: C = K, nothing is dropped."""
    cfg = reduced_config(get_config(arch))
    p, x = _crowded(cfg, 6, (5,))
    assert _check(cfg, p, x, dtype) == 0.0


@pytest.mark.parametrize("S", [1, 2, 7, 24, 1000, 2048])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_per_row_matches_reference(arch, S):
    assert moe.capacity_per_row(S, get_config(arch)) == \
        jax_capacity_per_row(S, jax_get_config(arch))


def test_dropped_choices_never_leak_a_non_finite_slot():
    """The reference weighs slot C, where dropped choices land, by 0, so
    an inf there would give NaN; the port masks that slot out."""
    cfg = reduced_config(get_config("olmoe-1b-7b"))
    p, x = _crowded(cfg, 2, (1, 32))
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    x = torch.from_numpy(x)
    top_g, top_e = moe.route(p["router"], x, cfg)
    pos = moe.expert_positions(top_e, cfg.num_experts)
    C = moe.capacity_per_row(32, cfg)
    assert bool((pos >= C).any())
    # a huge dropped token saturates slot C of its expert
    dropped = int(torch.nonzero((pos >= C)[0])[0]) // cfg.experts_per_token
    x[0, dropped] = 1e30
    out = moe.expert_ffn(p, x, top_g, top_e, pos, cfg)
    assert bool(torch.isfinite(out[0, :dropped]).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_is_a_dense_lm_with_routed_experts(arch):
    cfg = get_config(arch)
    model = build_model(reduced_config(cfg), device="cpu", dtype=torch.bfloat16)
    assert isinstance(model, DenseLM)
    mlp = model.layers[0].mlp
    assert set(mlp) == {"router", "w_up", "w_gate", "w_down"}
    assert mlp["router"].dtype == torch.float32
    assert mlp["w_up"].dtype == torch.bfloat16
    # the full config's shapes, without allocating them
    shapes = {k: s for k, (s, _) in moe.moe_shapes(cfg).items()}
    assert shapes == {"router": (cfg.d_model, cfg.num_experts),
                      "w_up": (cfg.num_experts, cfg.d_model, cfg.d_ff),
                      "w_gate": (cfg.num_experts, cfg.d_model, cfg.d_ff),
                      "w_down": (cfg.num_experts, cfg.d_ff, cfg.d_model)}


def test_moe_init_draws_with_the_reference_fan_in():
    """fan_in = shape[-2]: d for the router and the (E, d, f) experts, f
    for (E, f, d)."""
    cfg = reduced_config(get_config("olmoe-1b-7b"), d_model=128)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0))
    mlp = model.layers[0].mlp
    for key, fan_in in (("router", cfg.d_model), ("w_up", cfg.d_model),
                        ("w_gate", cfg.d_model), ("w_down", cfg.d_ff)):
        assert abs(float(mlp[key].std()) * np.sqrt(fan_in) - 1.0) < 0.1, key


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_is_bit_exact_on_bf16_params_with_an_f32_router(arch):
    cfg = reduced_config(get_config(arch))
    params = jax_build_model(jax_reduced_config(jax_get_config(arch))).init(
        jax.random.key(0))
    ref = jax.tree.map(np.asarray, params)
    mlp = ref["layers"]["mlp"]
    assert mlp["router"].dtype == np.float32
    assert mlp["w_up"].dtype.name == "bfloat16"
    model = build_model(cfg, device="cpu", dtype=torch.bfloat16)
    load_reference_params(model, ref)
    for i, layer in enumerate(model.layers):
        assert layer.mlp["router"].dtype == torch.float32
        np.testing.assert_array_equal(layer.mlp["router"].numpy(), mlp["router"][i])
        for key in ("w_up", "w_gate", "w_down"):
            np.testing.assert_array_equal(
                layer.mlp[key].view(torch.int16).numpy(), mlp[key][i].view(np.int16))


def test_capacity_makes_a_prefill_differ_from_its_decode_steps():
    """Capacity depends on S: a whole-prompt prefill may drop choices that
    the same tokens decoded one at a time (C = K) keep.  So a prefix hit's
    token-at-a-time suffix need not equal a cold prefill, in the reference
    as in the port; each side equals the other on both paths."""
    arch = "olmoe-1b-7b"
    bundle = jax_build_model(jax_reduced_config(jax_get_config(arch)))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), bundle.init(jax.random.key(0)))
    router = params["layers"]["mlp"]["router"]
    params["layers"]["mlp"]["router"] = router.at[:, :, 0].multiply(8.0)
    cfg = reduced_config(get_config(arch))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    load_reference_params(model, jax.tree.map(np.asarray, params))
    S = 24
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(1, S)).astype(np.int32)

    jl, _ = bundle.prefill(params, {"tokens": jnp.asarray(tokens)})
    tl, _ = model.prefill(torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)

    jcache = bundle.init_cache(1, 32)
    tcache = model.init_cache(1, 32)
    for pos in range(S):
        tok = tokens[:, pos]
        jd, jcache = bundle.decode_step(params, jcache, jnp.asarray(tok),
                                        jnp.asarray([pos], jnp.int32))
        td, tcache = model.decode_step(tcache, torch.from_numpy(tok), [pos])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-3, rtol=1e-3)
    scale = np.abs(np.asarray(jl)).max()
    assert np.abs(np.asarray(jd) - np.asarray(jl)).max() > 0.05 * scale


@pytest.mark.gpu
def test_router_stays_f32_under_tf32():
    """The router's product ignores a global TF32 setting on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1, 512, 2048, generator=gen, device="cuda")
    router = torch.randn(2048, 64, generator=gen, device="cuda") / 2048 ** 0.5
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    try:
        flags.allow_tf32 = False
        ieee = moe.router_probs(router, x)
        flags.allow_tf32 = True
        under_tf32 = moe.router_probs(router, x)
        assert flags.allow_tf32
    finally:
        flags.allow_tf32 = before
    assert torch.equal(ieee, under_tf32)


@pytest.mark.parametrize("lead", [(5,), (2, 7)], ids=["2d", "3d"])
def test_router_product_gradients_are_matmuls(lead):
    """``_ieee_f32_matmul`` (an autograd Function, so that its backward's
    products run without TF32 on the card too) gives torch.matmul's
    gradients on the CPU: dx = g router^T and, over every leading dim,
    drouter = x^T g; with only one input requiring grad, only that one."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(*lead, 16, generator=gen, dtype=torch.float64)
    router = torch.randn(16, 6, generator=gen, dtype=torch.float64)
    g = torch.randn(*lead, 6, generator=gen, dtype=torch.float64)
    ours = [t.clone().requires_grad_(True) for t in (x, router)]
    ref = [t.clone().requires_grad_(True) for t in (x, router)]
    out = moe._ieee_f32_matmul(*ours)
    assert type(out.grad_fn).__name__ == "_IeeeF32MatmulBackward"
    out.backward(g)
    torch.matmul(*ref).backward(g)
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(moe._ieee_f32_matmul,
                                    [t.clone().requires_grad_(True) for t in (x, router)])
    xg = x.clone().requires_grad_(True)
    moe._ieee_f32_matmul(xg, router).backward(g)
    torch.testing.assert_close(xg.grad, g @ router.T, rtol=1e-12, atol=1e-12)


@pytest.mark.gpu
def test_router_gradients_stay_f32_under_tf32():
    """The router product's backward ignores a global TF32 setting on the
    card: both gradients equal the ones taken with TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1, 512, 2048, generator=gen, device="cuda")
    router = torch.randn(2048, 64, generator=gen, device="cuda") / 2048 ** 0.5
    g = torch.randn(1, 512, 64, generator=gen, device="cuda")
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    grads = []
    try:
        for tf32 in (False, True):
            flags.allow_tf32 = tf32
            leaves = [t.clone().requires_grad_(True) for t in (x, router)]
            moe._ieee_f32_matmul(*leaves).backward(g)
            grads.append([t.grad for t in leaves])
    finally:
        flags.allow_tf32 = before
    for a, b in zip(*grads):
        assert torch.equal(a, b)
