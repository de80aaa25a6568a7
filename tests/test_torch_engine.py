"""The port's serving engine against the JAX engine, and its own contracts.

Both engines serve the same requests on the same (f32) weights with a bf16
KV cache.  The per-step logits of every active row are compared, not only
the greedy tokens: at reduced size with random weights greedy decoding
often collapses to one repeated token, which would hide a wrong cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.serving.engine import ServeRequest as JaxServeRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.bridge import load_reference_params
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.models import build_model
from repro_torch.serving.engine import ServeRequest, ServingEngine
from torch_threads import one_thread  # noqa: F401  (autouse)

# Both engines keep KV in bf16.  Where the f32 k/v of the two sides (equal
# to ~1e-7) straddle a bf16 rounding boundary, one cache element rounds one
# ulp apart (2**-8 relative), which moves later logits by up to ~1e-4 of
# their scale; so logits are compared against their scale, max|ref|.
TOL = 1e-3
# the warm path's suffix reads the bf16 cache where a cold prefill reads
# its unrounded k/v: equal within the bf16 tolerance, again against scale
BF16_TOL = 2e-2


@pytest.fixture(scope="module")
def qwen():
    return _pair("qwen2.5-3b")


def _pair(arch):
    bundle = jax_build_model(jax_reduced_config(jax_get_config(arch)))
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          bundle.init(jax.random.key(0)))
    cfg = reduced_config(get_config(arch))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return cfg, bundle, params, model


def _engine(model, **kw):
    return ServingEngine(model, device="cpu", **kw)


def _record_port(eng):
    """Log (kind, logits, active rows) of every model call of ``eng``."""
    log = []
    model = eng.model
    prefill, decode = model.prefill, model.decode_step

    def rec_prefill(tokens, lengths=None):
        out = prefill(tokens, lengths)
        log.append(("prefill", out[0].numpy().copy(), None))
        return out

    def rec_decode(cache, tokens, pos):
        out = decode(cache, tokens, pos)
        active = np.asarray(pos).reshape(-1) >= 0
        log.append(("decode", out[0].numpy().copy(), active))
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
        log.append(("prefill", np.asarray(out[0])))
        return out

    def rec_decode(params, cache, tokens, pos):
        out = decode(params, cache, tokens, pos)
        log.append(("decode", np.asarray(out[0])))
        return out

    eng._prefill_one, eng._decode = rec_prefill, rec_decode
    return log


def _assert_logs_match(port_log, jax_log, tol=TOL):
    assert [e[0] for e in port_log] == [e[0] for e in jax_log]
    for (kind, ours, active), (_, ref) in zip(port_log, jax_log):
        if active is not None:  # idle rows' logits are thrown away
            ours, ref = ours[active], ref[active]
        _assert_close_to_scale(ours, ref, tol)


def _assert_close_to_scale(ours, ref, tol):
    err = np.abs(ours - ref).max()
    scale = np.abs(ref).max()
    assert err <= tol * scale, f"max |diff| {err} > {tol} * {scale}"


def _serve(eng, prompts, max_new, req_cls):
    for i, p in enumerate(prompts):
        eng.submit(req_cls(i, p, max_new_tokens=max_new))
    return {r.req_id: r for r in eng.run_to_completion()}


MOE_ARCHS = ["olmoe-1b-7b", "granite-moe-3b-a800m"]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "llama-3.2-1b", "gemma-7b"]
                         + MOE_ARCHS)
def test_engine_matches_reference_step_by_step(arch):
    cfg, bundle, params, model = _pair(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(6, 20, size=5)]
    jeng = JaxServingEngine(bundle, params, slots=3, max_len=48)
    jlog = _record_jax(jeng)
    ref = _serve(jeng, prompts, 5, JaxServeRequest)
    eng = _engine(model, slots=3, max_len=48)
    log = _record_port(eng)
    ours = _serve(eng, prompts, 5, ServeRequest)
    _assert_logs_match(log, jlog)
    assert {i: r.generated for i, r in ours.items()} == \
        {i: r.generated for i, r in ref.items()}
    assert eng.stats == jeng.stats


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen2.5-3b-agent"] + MOE_ARCHS)
def test_engine_batched_equals_solo(arch):
    cfg, _, _, model = _pair(arch)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=10).astype(np.int32)
               for _ in range(3)]
    batched = _serve(_engine(model, slots=3, max_len=32), prompts, 5,
                     ServeRequest)
    for i, p in enumerate(prompts):
        solo = _serve(_engine(model, slots=1, max_len=32), [p], 5,
                      ServeRequest)[0]
        assert solo.generated == batched[i].generated, f"req {i} diverged"


def test_engine_identical_prompt_served_from_cache(qwen):
    cfg, _, _, model = qwen
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=24).astype(np.int32)
    eng = _engine(model, slots=2, max_len=64)
    first = _serve(eng, [prompt], 4, ServeRequest)[0]
    second = _serve(eng, [prompt], 4, ServeRequest)[0]
    assert second.cached_tokens == len(prompt) - 1
    assert eng.stats["cached_tokens"] == len(prompt) - 1
    assert second.generated == first.generated


def test_engine_prefix_reuse_warm_equals_cold(qwen):
    cfg, _, _, model = qwen
    rng = np.random.default_rng(5)
    base = rng.integers(0, cfg.vocab_size, size=20).astype(np.int32)
    ext = np.concatenate(
        [base, rng.integers(0, cfg.vocab_size, size=9).astype(np.int32)])

    warm_eng = _engine(model, slots=2, max_len=64)
    _serve(warm_eng, [base], 3, ServeRequest)
    log = _record_port(warm_eng)
    warm = _serve(warm_eng, [ext], 5, ServeRequest)[0]
    assert warm.cached_tokens >= len(base)

    cold_eng = _engine(model, slots=1, max_len=64, prefix_caching=False)
    cold_log = _record_port(cold_eng)
    cold = _serve(cold_eng, [ext], 5, ServeRequest)[0]
    assert cold.cached_tokens == 0
    assert warm.generated == cold.generated
    _assert_close_to_scale(log[len(ext) - warm.cached_tokens - 1][1],
                           cold_log[0][1], BF16_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_prefix_hit_matches_the_reference_step_by_step(arch):
    """A prompt that extends a finished one hits the prefix cache in both
    engines (the reference matches whole cached sequences), so both run
    its suffix token at a time over the copied KV.  Capacity depends on S,
    so that warm run need not equal a cold prefill of the same prompt; it
    equals the reference's warm run, call by call."""
    cfg, bundle, params, model = _pair(arch)
    rng = np.random.default_rng(5)
    base = rng.integers(0, cfg.vocab_size, size=20).astype(np.int32)
    ext = np.concatenate(
        [base, rng.integers(0, cfg.vocab_size, size=9).astype(np.int32)])

    jeng = JaxServingEngine(bundle, params, slots=2, max_len=64)
    jlog = _record_jax(jeng)
    ref = [_serve(jeng, [p], 4, JaxServeRequest)[0] for p in (base, ext)]
    eng = _engine(model, slots=2, max_len=64)
    log = _record_port(eng)
    ours = [_serve(eng, [p], 4, ServeRequest)[0] for p in (base, ext)]
    assert ref[1].cached_tokens == ours[1].cached_tokens == len(base)
    assert [r.generated for r in ours] == [r.generated for r in ref]
    # the same calls in the same order: ext's suffix is 9 batch-1 decodes
    _assert_logs_match(log, jlog)
    assert eng.stats == jeng.stats


def test_engine_slot_reuse_invalidates_stale_entries(qwen):
    cfg, _, _, model = qwen
    rng = np.random.default_rng(11)
    p1 = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    p2 = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    eng = _engine(model, slots=1, max_len=64)
    _serve(eng, [p1], 2, ServeRequest)
    _serve(eng, [p2], 2, ServeRequest)
    matched, slot = eng.prefix_cache.longest_prefix([int(t) for t in p1])
    assert slot is None and matched == 0


def test_idle_slot_kv_survives_other_slots_decoding(qwen):
    """The reference decodes idle slots at position 0 and so overwrites the
    first KV entry of a finished sequence its prefix cache still points at;
    the port leaves idle slots untouched, and a later prefix hit on such a
    slot generates what a cold run generates."""
    cfg, bundle, params, model = qwen
    rng = np.random.default_rng(7)
    a = rng.integers(0, cfg.vocab_size, size=20).astype(np.int32)
    b = rng.integers(0, cfg.vocab_size, size=12).astype(np.int32)
    c = np.concatenate([a, rng.integers(0, cfg.vocab_size, size=6)
                        .astype(np.int32)])

    z = rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)

    def run_a_then_b(eng, req_cls, first_k):
        # z and a finish in the same step; the slots come back in order,
        # so b reuses z's slot and a's slot stays idle
        slot_a = _serve(eng, [z, a], 4, req_cls)[1].slot
        before = first_k(eng, slot_a)
        eng.submit(req_cls(2, b, max_new_tokens=4))
        eng.step()
        eng.step()  # b decodes two steps while a's slot is idle
        assert eng.active and slot_a not in eng.active
        after = first_k(eng, slot_a)
        eng.run_to_completion()
        assert eng.prefix_cache.longest_prefix(c.tolist()) == (len(a), slot_a)
        return before, after

    jeng = JaxServingEngine(bundle, params, slots=3, max_len=64)
    before, after = run_a_then_b(
        jeng, JaxServeRequest,
        lambda e, s: np.asarray(e.cache[0][:, s, :, 0].astype(jnp.float32)))
    assert np.abs(after - before).max() > 0  # the reference's fault

    eng = _engine(model, slots=3, max_len=64)
    before, after = run_a_then_b(
        eng, ServeRequest, lambda e, s: e.cache[0][:, s, :, 0].float().clone())
    assert torch.equal(before, after)

    log = _record_port(eng)
    warm = _serve(eng, [c], 5, ServeRequest)[0]
    assert warm.cached_tokens == len(a)
    cold_eng = _engine(model, slots=1, max_len=64, prefix_caching=False)
    cold_log = _record_port(cold_eng)
    cold = _serve(cold_eng, [c], 5, ServeRequest)[0]
    assert warm.generated == cold.generated
    # first token: the suffix's last decode vs the cold prefill; then each
    # decode step's row of the warm request's slot vs the cold run's
    suffix = len(c) - len(a)
    assert len(log) - suffix + 1 == len(cold_log)
    _assert_close_to_scale(log[suffix - 1][1], cold_log[0][1], BF16_TOL)
    for ours, ref in zip(log[suffix:], cold_log[1:]):
        _assert_close_to_scale(ours[1][warm.slot], ref[1][0], BF16_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_never_returns_a_stale_slot(seed):
    """Random engine-like use of the trie: each slot holds one sequence,
    which a later insert either extends or replaces (after invalidating
    the slot, as the engine does).  Every hit names a slot whose sequence
    starts with the matched tokens, and a prefix of the sequence inserted
    last is always found."""
    from repro_torch.serving.prefix_cache import PrefixCache

    rng = np.random.default_rng(seed)
    pc = PrefixCache(max_entries=10_000)
    held = {}  # slot -> the sequence its KV holds
    base = [int(t) for t in rng.integers(0, 4, size=10)]
    for _ in range(300):
        slot = int(rng.integers(0, 4))
        if slot in held and rng.random() < 0.5:  # the slot's sequence grows
            seq = held[slot] + [int(t) for t in rng.integers(0, 4, size=3)]
        else:
            pc.invalidate_slot(slot)
            seq = base[:int(rng.integers(0, 10))] + \
                [int(t) for t in rng.integers(0, 4, size=int(rng.integers(1, 8)))]
        pc.insert(seq, slot)
        held[slot] = seq
        query = seq[:int(rng.integers(1, len(seq) + 1))] + [9]
        assert pc.longest_prefix(query) == (len(query) - 1, slot)
        probe = base[:int(rng.integers(0, 10))] + \
            [int(t) for t in rng.integers(0, 4, size=4)]
        matched, hit = pc.longest_prefix(probe)
        if hit is not None:
            assert held[hit][:matched] == probe[:matched]
    # no dead node is left behind, and ``entries`` counts the live ones
    nodes, stack = 0, list(pc.root.children.values())
    while stack:
        node = stack.pop()
        nodes += 1
        assert node.children or node.slot is not None
        stack.extend(node.children.values())
    assert nodes == pc.entries


def test_prefix_cache_finds_a_shared_system_prompt():
    from repro_torch.serving.prefix_cache import PrefixCache

    pc = PrefixCache()
    system = list(range(100, 140))
    pc.insert(system + [1, 2, 3], slot=0)
    pc.insert(system + [4, 5], slot=1)
    assert pc.longest_prefix(system + [7, 7]) == (len(system), 1)
    # the shared nodes named slot 1, the last inserted: invalidating it
    # loses that hit (never a stale one); slot 0's own tail still hits
    pc.invalidate_slot(1)
    assert pc.longest_prefix(system + [7, 7]) == (0, None)
    assert pc.longest_prefix(system + [1, 2, 9]) == (len(system) + 2, 0)


def test_engine_reuses_a_shared_prefix_across_different_suffixes(qwen):
    cfg, _, _, model = qwen
    rng = np.random.default_rng(13)
    system = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, size=5)
                               .astype(np.int32)]) for _ in range(3)]
    eng = _engine(model, slots=3, max_len=64)
    warm = _serve(eng, prompts, 4, ServeRequest)
    assert [warm[i].cached_tokens for i in range(3)] == [0, 16, 16]
    for i, p in enumerate(prompts):
        cold = _serve(_engine(model, slots=1, max_len=64, prefix_caching=False),
                      [p], 4, ServeRequest)[0]
        assert warm[i].generated == cold.generated


def test_engine_shared_prefix_hits_match_the_reference_step_by_step(qwen):
    """The port hits on a shared system prompt where the reference, which
    marks only whole cached sequences, serves every prompt cold.  So the
    reference's run holds each logit the warm run computes: the logits
    that pick each request's first token, then every decode step's active
    rows."""
    cfg, bundle, params, model = qwen
    rng = np.random.default_rng(13)
    system = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, size=5)
                               .astype(np.int32)]) for _ in range(3)]
    jeng = JaxServingEngine(bundle, params, slots=3, max_len=64)
    jlog = _record_jax(jeng)
    ref = _serve(jeng, prompts, 4, JaxServeRequest)
    assert jeng.stats["cached_tokens"] == 0
    eng = _engine(model, slots=3, max_len=64)
    log = _record_port(eng)
    warm = _serve(eng, prompts, 4, ServeRequest)
    assert [warm[i].cached_tokens for i in range(3)] == [0, 16, 16]
    # admission, in submit order: a cold prompt is one prefill call, a hit
    # one decode call per suffix token; the last call's logits pick the
    # first token
    calls = 0
    for i in range(3):
        req = warm[i]
        calls += (1 if req.cached_tokens == 0
                  else len(req.prompt) - req.cached_tokens)
        assert jlog[i][0] == "prefill"
        _assert_close_to_scale(log[calls - 1][1], jlog[i][1], BF16_TOL)
    _assert_logs_match(log[calls:], jlog[3:], BF16_TOL)
    assert {i: r.generated for i, r in warm.items()} == \
        {i: r.generated for i, r in ref.items()}


def test_prefix_cache_takes_prompts_deeper_than_the_recursion_limit():
    from repro_torch.serving.prefix_cache import PrefixCache

    pc = PrefixCache(max_entries=3000)
    long = list(range(2500))
    pc.insert(long, slot=0)
    pc.insert(list(range(5000, 5600)), slot=1)  # evicts 100 of the older chain
    assert pc.entries == 3000
    assert pc.longest_prefix(long) == (2400, 0)
    pc.insert(long[:2100], slot=2)
    pc.invalidate_slot(2)
    assert pc.longest_prefix(long[:2000]) == (0, None)
    assert pc.longest_prefix(list(range(5000, 5600))) == (600, 1)
