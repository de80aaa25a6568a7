"""The port's rwkv6 path (WKV6 scan, model, engine) against the JAX package.

Inputs are made with numpy from a seed and handed to both sides.  On the
CPU ``wkv6_op`` runs its plain version (the token-by-token recurrence in
f32); the CUDA kernel is held against that plain version by the
``gpu``-marked test in ``tests/test_torch_kernels.py``.  Tolerances:

* 1e-4 in f32 where the chunked forms (the Pallas kernel in interpret
  mode, ``wkv6_chunked``) meet the token-by-token one: they sum the same
  terms in another order over up to 256 tokens, and 1e-4 is the tolerance
  ``tests/test_kernels.py`` holds them to;
* 2e-5 in f32 between two token-by-token recurrences (the port's plain
  version and ``wkv6_scan_ref``/``wkv6_step``), which differ only in the
  order of the D-term sums;
* 2e-2 in bf16: both sides compute in f32 from the same bf16 inputs and
  round the output to bf16 once, so they differ by at most an ulp (2**-8
  relative) where the f32 values straddle a rounding boundary;
* model logits 1e-4 in f32 weights, as ``tests/test_torch_model.py``, and
  engine logits 1e-3 of their scale, as ``tests/test_torch_engine.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.kernels.rwkv6_scan import wkv6_op as jax_wkv6_op
from repro.kernels.rwkv6_scan import wkv6_scan_ref as jax_wkv6_scan_ref
from repro.models import build_model as jax_build_model
from repro.models.rwkv import wkv6_chunked, wkv6_step
from repro.serving.engine import ServeRequest as JaxServeRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.bridge import load_reference_params
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.kernels import common
from repro_torch.kernels.rwkv6_scan import wkv6_op, wkv6_scan_ref
from repro_torch.models import build_model
from repro_torch.models.rwkv import RWKVLM
from repro_torch.serving.engine import ServeRequest, ServingEngine
from torch_threads import one_thread  # noqa: F401  (autouse)

ARCH = "rwkv6-7b"
CHUNKED_TOL = 1e-4
SCAN_TOL = 2e-5
BF16_TOL = 2e-2
MODEL_TOL = 1e-4
ENGINE_TOL = 1e-3

JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(ours, ref, tol):
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(jnp.asarray(ref, jnp.float32)),
                               atol=tol, rtol=tol)


def _scan_inputs(seed, B, H, S, D, dtype="float32", state_scale=0.0):
    """numpy r/k/v (rounded to ``dtype``), logw <= 0 (also rounded, as the
    JAX package's sweep feeds it), u and a state, as (jax, torch) pairs.
    The port takes logw, u and the state in f32."""
    rng = np.random.default_rng(seed)
    shape = (B, H, S, D)
    arrs = [(rng.standard_normal(shape) * 0.5).astype(np.float32)
            for _ in range(3)]
    arrs.append(-np.exp(rng.standard_normal(shape) * 0.5 - 1.0).astype(np.float32))
    jd = JAX_DT[dtype]
    out = []
    for a in arrs:
        j = jnp.asarray(a, jd)
        out.append((j, torch.from_numpy(np.array(j.astype(jnp.float32)))
                    .to(TORCH_DT[dtype])))
    out[3] = (out[3][0], out[3][1].float())  # logw
    u = (rng.standard_normal((H, D)) * 0.2).astype(np.float32)
    s0 = (rng.standard_normal((B, H, D, D)) * state_scale).astype(np.float32)
    out.append((jnp.asarray(u), torch.from_numpy(u)))
    out.append((jnp.asarray(s0), torch.from_numpy(s0)))
    return out


def _jax_scan_ref(r, k, v, logw, u, s0):
    B, H, S, D = r.shape
    out, s1 = jax_wkv6_scan_ref(*(a.reshape(B * H, S, D) for a in (r, k, v, logw)),
                                u, s0.reshape(B * H, D, D), num_heads=H)
    return out.reshape(B, H, S, D), s1.reshape(B, H, D, D)


# ---------------------------------------------------------------------------
# the WKV6 scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,S,D,chunk", [
    (1, 2, 64, 32, 32),
    (2, 3, 128, 64, 64),
    (1, 1, 256, 64, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_matches_pallas_kernel_and_oracles(B, H, S, D, chunk, dtype):
    (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu), (js, ts) = \
        _scan_inputs(0, B, H, S, D, dtype)
    out, s1 = wkv6_op(tr, tk, tv, tw, tu, ts)
    assert out.dtype == TORCH_DT[dtype] and s1.dtype == torch.float32
    tol = BF16_TOL if dtype == "bfloat16" else CHUNKED_TOL
    pallas, s_pallas = jax_wkv6_op(jr, jk, jv, jw, ju, js, chunk=chunk)
    _close(out.float(), pallas, tol)
    _close(s1, s_pallas, tol)
    oracle, s_oracle = _jax_scan_ref(jr, jk, jv, jw, ju, js)
    _close(out.float(), oracle, BF16_TOL if dtype == "bfloat16" else SCAN_TOL)
    _close(s1, s_oracle, SCAN_TOL)
    chunked, s_chunked = wkv6_chunked(jr, jk, jv, jw, ju, js)
    _close(out.float(), chunked, tol)
    _close(s1, s_chunked, CHUNKED_TOL)


@pytest.mark.parametrize("S", [1, 7, 77, 130])
def test_wkv6_ragged_lengths_match_scan_oracle(S):
    """wkv6_chunked refuses S % 64 != 0 past one chunk; the port takes any S."""
    (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu), (js, ts) = \
        _scan_inputs(1, 2, 3, S, 32, state_scale=0.3)
    out, s1 = wkv6_op(tr, tk, tv, tw, tu, ts)
    oracle, s_oracle = _jax_scan_ref(jr, jk, jv, jw, ju, js)
    _close(out, oracle, SCAN_TOL)
    _close(s1, s_oracle, SCAN_TOL)


@pytest.mark.parametrize("S,split", [(128, 64), (77, 30)])
def test_wkv6_state_carry_split(S, split):
    """Two calls over the halves, the second updating the carried state in
    place, equal one call over the whole (and the Pallas kernel's)."""
    (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu), (js, ts) = \
        _scan_inputs(2, 1, 2, S, 32)
    full, s_full = wkv6_op(tr, tk, tv, tw, tu, ts)
    a, mid = wkv6_op(tr[:, :, :split], tk[:, :, :split], tv[:, :, :split],
                     tw[:, :, :split], tu, ts)
    b, end = wkv6_op(tr[:, :, split:], tk[:, :, split:], tv[:, :, split:],
                     tw[:, :, split:], tu, mid, out_state=mid)
    assert end.data_ptr() == mid.data_ptr()
    torch.testing.assert_close(torch.cat([a, b], dim=2), full,
                               atol=SCAN_TOL, rtol=SCAN_TOL)
    torch.testing.assert_close(end, s_full, atol=SCAN_TOL, rtol=SCAN_TOL)
    if S % 64 == 0:
        pallas, s_pallas = jax_wkv6_op(jr, jk, jv, jw, ju, js, chunk=32)
        _close(full, pallas, CHUNKED_TOL)
        _close(end, s_pallas, CHUNKED_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_single_token_is_the_decode_step(dtype):
    (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu), (js, ts) = \
        _scan_inputs(3, 3, 4, 1, 32, dtype, state_scale=0.5)
    out, s1 = wkv6_op(tr, tk, tv, tw, tu, ts)
    ref, s_ref = wkv6_step(jr[:, :, 0], jk[:, :, 0], jv[:, :, 0], jw[:, :, 0],
                           ju, js)
    _close(out[:, :, 0].float(), ref,
           BF16_TOL if dtype == "bfloat16" else SCAN_TOL)
    _close(s1, s_ref, SCAN_TOL)


def test_wkv6_cpu_tensors_run_the_plain_version_and_count_no_launch():
    (_, tr), (_, tk), (_, tv), (_, tw), (_, tu), (_, ts) = \
        _scan_inputs(4, 1, 2, 9, 64, state_scale=0.1)
    common.reset_launch_counts()
    out, s1 = wkv6_op(tr, tk, tv, tw, tu, ts)
    assert common.launch_counts["wkv6_scan"] == 0
    ref, s_ref = wkv6_scan_ref(tr, tk, tv, tw, tu, ts)
    assert torch.equal(out, ref) and torch.equal(s1, s_ref)


def test_wkv6_wrapper_rejects_bad_shapes():
    r = torch.zeros(1, 2, 5, 32)
    u, s = torch.zeros(2, 32), torch.zeros(1, 2, 32, 32)
    with pytest.raises(ValueError):  # k of another length
        wkv6_op(r, torch.zeros(1, 2, 4, 32), r, r, u, s)
    with pytest.raises(ValueError):  # u of another width
        wkv6_op(r, r, r, r, torch.zeros(2, 16), s)
    with pytest.raises(ValueError):  # state of another batch
        wkv6_op(r, r, r, r, u, torch.zeros(2, 2, 32, 32))
    with pytest.raises(ValueError):  # no token
        wkv6_op(r[:, :, :0], r[:, :, :0], r[:, :, :0], r[:, :, :0], u, s)
    with pytest.raises(ValueError):  # out_state of another shape
        wkv6_op(r, r, r, r, u, s, out_state=torch.zeros(1, 2, 32, 16))
    with pytest.raises(ValueError):  # not (B, H, S, D)
        wkv6_op(r[0], r[0], r[0], r[0], u, s)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _perturbed(params, seed):
    """The init tree with every zeros/ones leaf (norms, token-shift mixes,
    the bonus u, the groupnorm affine) moved off its init value, so that a
    comparison sees each of them used."""
    rng = np.random.default_rng(seed)
    flat = ("ln1", "ln2", "final_norm")
    mixes = ("mu_x", "mu", "u", "gn_scale", "gn_bias", "mu_k", "mu_r")

    def move(path, a):
        name = str(getattr(path[-1], "key", ""))
        if name in flat + mixes:
            noise = rng.standard_normal(a.shape).astype(np.float32) * 0.3
            return (a.astype(jnp.float32) + noise).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(move, params)


def _pair(perturb=False, jax_dtype=jnp.float32, torch_dtype=torch.float32):
    jcfg = jax_reduced_config(jax_get_config(ARCH))
    bundle = jax_build_model(jcfg)
    params = bundle.init(jax.random.key(0))
    if jax_dtype is not None:
        params = jax.tree.map(lambda a: a.astype(jax_dtype), params)
    if perturb:
        params = _perturbed(params, 7)
    cfg = reduced_config(get_config(ARCH))
    assert cfg.to_dict() == jcfg.to_dict()
    model = build_model(cfg, device="cpu", dtype=torch_dtype)
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return cfg, bundle, params, model


@pytest.fixture(scope="module")
def rwkv():
    return _pair()


@pytest.mark.parametrize("S", [10, 64])
@pytest.mark.parametrize("perturb", [False, True], ids=["init", "perturbed"])
def test_prefill_and_decode_logits_match_reference(S, perturb):
    cfg, bundle, params, model = _pair(perturb)
    assert isinstance(model, RWKVLM)
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, S)).astype(np.int32)
    jl, jstate = bundle.prefill(params, {"tokens": jnp.asarray(tokens)})
    tl, tstate = model.prefill(torch.from_numpy(tokens))
    _close(tl, jl, MODEL_TOL)
    assert set(tstate) == {"wkv", "tm_x", "cm_x"}
    for name in tstate:
        assert tuple(tstate[name].shape) == tuple(jstate[name].shape)
        _close(tstate[name].float(), jstate[name], MODEL_TOL)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, size=2).astype(np.int32)
        jl, jstate = bundle.decode_step(params, jstate, jnp.asarray(tok),
                                        jnp.asarray(S + step, jnp.int32))
        tl, tstate = model.decode_step(tstate, torch.from_numpy(tok), S + step)
        _close(tl, jl, MODEL_TOL)
    _close(tstate["wkv"], jstate["wkv"], MODEL_TOL)


def test_bridge_keeps_w0_and_u_f32_in_a_bf16_model():
    _, _, params, model = _pair(jax_dtype=None, torch_dtype=torch.bfloat16)
    ref = jax.tree.map(np.asarray, params)
    layer = model.layers[1]
    for key in ("w0", "u"):
        assert layer.tm[key].dtype == torch.float32
        np.testing.assert_array_equal(layer.tm[key].numpy(),
                                      ref["layers"]["tm"][key][1])
    assert ref["layers"]["tm"]["wr"].dtype.name == "bfloat16"
    for group in ("tm", "cm"):
        for key, leaf in ref["layers"][group].items():
            if key in ("w0", "u"):
                continue
            np.testing.assert_array_equal(
                getattr(layer, group)[key].view(torch.int16).numpy(),
                leaf[1].view(np.int16))
    np.testing.assert_array_equal(model.lm_head.view(torch.int16).numpy(),
                                  ref["lm_head"].view(np.int16))


def test_init_params_follows_reference_rules():
    cfg = reduced_config(get_config(ARCH))
    model = build_model(cfg, device="cpu", dtype=torch.bfloat16)
    model.init_params(torch.Generator().manual_seed(0))
    ref = jax.tree.map(np.asarray, jax_build_model(
        jax_reduced_config(jax_get_config(ARCH))).init(jax.random.key(0)))
    tm, cm = model.layers[0].tm, model.layers[0].cm
    # the decay ramp, exactly the reference's, and f32
    assert tm["w0"].dtype == torch.float32 and tm["u"].dtype == torch.float32
    np.testing.assert_array_equal(tm["w0"].numpy(), ref["layers"]["tm"]["w0"][0])
    assert float(tm["w0"][0]) == -5.0 and float(tm["w0"][-1]) == -1.0
    assert torch.all(tm["w0"][1:] > tm["w0"][:-1])
    assert torch.equal(tm["gn_scale"], torch.ones_like(tm["gn_scale"]))
    for zero in (tm["mu_x"], tm["mu"], tm["u"], tm["gn_bias"], cm["mu_k"],
                 cm["mu_r"], model.layers[0].ln1, model.final_norm):
        assert float(zero.float().abs().max()) == 0.0
    for key in ("ddl_w1", "ddl_w2", "w_lora1", "w_lora2"):
        assert abs(float(tm[key].float().std()) / 1e-2 - 1.0) < 0.1, key
    wr = tm["wr"].float()
    assert abs(float(wr.std()) * np.sqrt(wr.shape[0]) - 1.0) < 0.1
    assert abs(float(model.embed.float().std()) - 1.0) < 0.05


@pytest.mark.parametrize("reduced", [False, True])
def test_param_count_matches_reference(reduced):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        cfg, jcfg = reduced_config(cfg), jax_reduced_config(jcfg)
    assert cfg.layer_param_count() == jcfg.layer_param_count()
    assert cfg.param_count() == jcfg.param_count()
    dense = get_config("llama-3.1-8b")
    assert dense.param_count() == jax_get_config("llama-3.1-8b").param_count()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _record_port(eng):
    """Log (logits, active rows) of every model call of ``eng``."""
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


def _assert_close_to_scale(ours, ref, tol):
    err = np.abs(ours - ref).max()
    scale = np.abs(ref).max()
    assert err <= tol * scale, f"max |diff| {err} > {tol} * {scale}"


def _serve(eng, prompts, max_new, req_cls):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(i, p, max_new_tokens=max_new))
    return {r.req_id: r for r in eng.run_to_completion()}


def _prompts(cfg, seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lengths]


@pytest.mark.parametrize("perturb", [False, True], ids=["init", "perturbed"])
def test_engine_matches_reference_step_by_step(perturb):
    """Same prompts, same weights: the same tokens and, step by step, the
    same logits of the active rows.  The reference's prefill needs S <= 64
    or a multiple of 64.  Its state starts with bf16 token-shift leaves,
    which its first decode step turns into the weights' dtype; it is given
    that dtype (f32) from the start, as the port's state has it."""
    cfg, bundle, params, model = _pair(perturb)
    prompts = _prompts(cfg, 0, [9, 64, 5, 128, 30])
    jeng = JaxServingEngine(bundle, params, slots=3, max_len=160)
    jeng.cache = jax.tree.map(lambda a: a.astype(jnp.float32), jeng.cache)
    assert jeng.prefix_cache is None
    jlog = _record_jax(jeng)
    ref = _serve(jeng, prompts, 6, JaxServeRequest)
    eng = ServingEngine(model, device="cpu", slots=3, max_len=160)
    log = _record_port(eng)
    ours = _serve(eng, prompts, 6, ServeRequest)
    assert len(log) == len(jlog)
    for (mine, active), theirs in zip(log, jlog):
        if active is not None:  # idle rows' logits are thrown away
            mine, theirs = mine[active], theirs[active]
        _assert_close_to_scale(mine, theirs, ENGINE_TOL)
    assert {i: r.generated for i, r in ours.items()} == \
        {i: r.generated for i, r in ref.items()}
    assert eng.stats == jeng.stats
    assert eng.prefix_cache is None and eng.stats["cached_tokens"] == 0
    assert all(r.cached_tokens == 0 for r in ours.values())


def test_engine_batched_equals_solo(rwkv):
    """The port's counterpart of test_substrates.py's batched == solo."""
    cfg, _, _, model = rwkv
    prompts = _prompts(cfg, 1, [10, 10, 10])
    batched = _serve(ServingEngine(model, device="cpu", slots=3, max_len=32),
                     prompts, 5, ServeRequest)
    for i, p in enumerate(prompts):
        solo = _serve(ServingEngine(model, device="cpu", slots=1, max_len=32),
                      [p], 5, ServeRequest)[0]
        assert solo.generated == batched[i].generated, f"req {i} diverged"


def test_idle_slot_state_is_rewritten_at_admission(rwkv):
    """Idle slots are decoded as in the reference, so their state drifts;
    admission overwrites every leaf of it, and a request admitted into such
    a slot generates what it generates in a fresh engine."""
    cfg, _, _, model = rwkv
    x, y, z = _prompts(cfg, 2, [12, 7, 9])
    eng = ServingEngine(model, device="cpu", slots=2, max_len=64)
    eng.submit(ServeRequest(0, x, max_new_tokens=10))
    eng.submit(ServeRequest(1, y, max_new_tokens=3))
    eng.step()
    slot_y = next(s for s, r in eng.active.items() if r.req_id == 1)
    eng.step()  # y is done, its slot idle
    assert slot_y not in eng.active
    before = {k: v[:, slot_y].clone() for k, v in eng.cache.items()}
    eng.step()
    eng.step()  # x decodes on; the idle slot is decoded too
    assert any(not torch.equal(before[k], eng.cache[k][:, slot_y])
               for k in before)
    log = _record_port(eng)
    eng.submit(ServeRequest(2, z, max_new_tokens=5))
    done = {r.req_id: r for r in eng.run_to_completion()}
    assert done[2].slot == slot_y

    fresh = ServingEngine(model, device="cpu", slots=1, max_len=64)
    fresh_log = _record_port(fresh)
    solo = _serve(fresh, [z], 5, ServeRequest)[0]
    assert done[2].generated == solo.generated
    # z's prefill, then its first decode step (row slot_y)
    np.testing.assert_array_equal(log[0][0], fresh_log[0][0])
    _assert_close_to_scale(log[1][0][slot_y], fresh_log[1][0][0], SCAN_TOL)
