"""The "seq" KV layout of a sharded dense decoder (``sharding.kv_layout``),
the decode kernel's partial-output mode (its LSE) and the serving caches'
API (``serving/kv_cache.py``), against the reference and the unsharded
port.

* The layout rule: ``kv_layout`` gives what the reference's dry-run gives
  its decode cells, for every assigned dense and MoE config at both
  production meshes.
* The LSE: the plain version's log-sum-exp equals ``logsumexp`` of the
  scaled scores, the split-K arithmetic gives the same, and two halves of
  a cache merged by ``merge_partials`` (the arithmetic the ranks run)
  equal the whole call; the output equals the Pallas kernel's in
  interpret mode.
* Sharded serving on four gloo ranks (``tests/torch_sharded_worker.py``,
  spawned once for the module): reduced qwen2.5-3b (one KV head) with f32
  weights bridged from the reference, at (1, 4) and (2, 2), and reduced
  granite-moe-3b-a800m (one KV head, seeded weights) at (1, 4), each over
  a cache of 32 positions (blocks of 8 or 16 a rank), and qwen over 30
  positions at (1, 4), which do not split (every rank holds the whole
  cache, as the reference's ``fit_spec`` leaves it).  Prefill logits are
  held within 1e-5 of their scale and decode steps within 1e-4 (as
  ``test_torch_sharding.py``), with idle rows and steps that cross a
  block; the engine's tokens exactly, across a prefix hit of 20 tokens
  (ending in the third block at (1, 4), the second at (2, 2)) and idle
  slots; every rank computes the same bits.
* ``PagedKVCache`` and ``SlotKVCache`` against the reference's classes
  under the same calls.
* The dry-run counts qwen2.5-3b's decode_32k at ``gpu32x8`` over the
  "seq" cache.
* The lasting divergence: the VLM and the enc-dec keep "heads", where
  their KV heads divide the model ways, at the bytes a GPU that the
  reference's "seq" spec would hold.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ASSIGNED as JAX_ASSIGNED
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.serving import kv_cache as jax_kv_cache
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import ASSIGNED, get_config, reduced_config
from repro_torch.distributed import sharding
from repro_torch.kernels import common
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      decode_attention_split_ref)
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.serving.kv_cache import PagedKVCache, SlotKVCache

import torch_sharded_worker as worker
from test_torch_sharding import SERVE_TOL, TOL, WORLD, _close
from torch_threads import one_thread  # noqa: F401  (autouse)

DECODERS = sorted(n for n, c in ASSIGNED.items() if c.family in ("dense", "moe"))
PROD_MESHES = {"gpu32x8": {"data": 32, "model": 8},
               "gpu2x32x8": {"pod": 2, "data": 32, "model": 8}}
LSE_TOL = 1e-5


def _reference_rule(cfg, model_ways: int) -> str:
    """``repro/launch/dryrun.py``'s decode cell, with no override set:

        kv_layout = ("heads" if cfg.num_kv_heads % model_ways == 0
                     and not cfg.attn_free and not cfg.sliding_window
                     and os.environ.get("REPRO_KV_LAYOUT", "auto") != "seq"
                     else "seq")
    """
    return ("heads" if cfg.num_kv_heads % model_ways == 0
            and not cfg.attn_free and not cfg.sliding_window else "seq")


@pytest.mark.parametrize("mesh", list(PROD_MESHES))
@pytest.mark.parametrize("arch", DECODERS)
def test_kv_layout_is_the_reference_rule(arch, mesh):
    sizes = PROD_MESHES[mesh]
    ours = sharding.kv_layout(get_config(arch), sizes)
    assert ours == _reference_rule(JAX_ASSIGNED[arch], sizes["model"])
    assert (ours == "seq") == (arch in ("qwen2.5-3b", "qwen2-7b", "glm4-9b"))


@pytest.mark.parametrize("arch", DECODERS)
def test_unsharded_layout_is_heads(arch):
    cfg = get_config(arch)
    assert sharding.kv_layout(cfg, None) == "heads"
    assert sharding.kv_layout(cfg, {"data": 8, "model": 1}) == "heads"


# ---------------------------------------------------------------------------
# the decode kernel's LSE, in its plain versions
# ---------------------------------------------------------------------------


def _decode_inputs(seed, B, KV, G, D, Smax):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32))
            for s in ((B, KV, G, D), (B, KV, Smax, D), (B, KV, Smax, D))]


# a row of length 0, rows that end inside the first half, at its end,
# inside the second and at Smax
LENGTHS = [0, 1, 13, 32, 33, 50, 64]


def test_plain_lse_is_the_logsumexp_of_the_scaled_scores():
    B, KV, G, D, Smax = len(LENGTHS), 2, 3, 16, 64
    q, k, v = _decode_inputs(0, B, KV, G, D, Smax)
    out, lse = decode_attention_ref(q, k, v, torch.tensor(LENGTHS), return_lse=True)
    assert out.dtype == lse.dtype == torch.float32 and lse.shape == (B, KV, G)
    scores = torch.einsum("bkgd,bksd->bkgs", q.double(), k.double()) / np.sqrt(D)
    for b, n in enumerate(LENGTHS):
        if n == 0:
            assert torch.isneginf(lse[b]).all() and float(out[b].abs().max()) == 0.0
            continue
        want = torch.logsumexp(scores[b, :, :, :n], dim=-1)
        torch.testing.assert_close(lse[b].double(), want, atol=LSE_TOL, rtol=0)
    torch.testing.assert_close(out, decode_attention_ref(q, k, v, torch.tensor(LENGTHS)),
                               atol=0, rtol=0)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_split_ref_lse_matches_plain(chunk):
    """The kernel pair's arithmetic: (M + log2 L) ln 2 of the merged
    partials, in log2 units, against the plain LSE."""
    B, KV, G, D, Smax = len(LENGTHS), 2, 4, 32, 64
    q, k, v = _decode_inputs(1, B, KV, G, D, Smax)
    lens = torch.tensor(LENGTHS)
    out, lse = decode_attention_split_ref(q, k, v, lens, chunk, return_lse=True)
    ref_out, ref_lse = decode_attention_ref(q, k, v, lens, return_lse=True)
    torch.testing.assert_close(out, ref_out, atol=2e-5, rtol=2e-5)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse))
    finite = torch.isfinite(ref_lse)
    torch.testing.assert_close(lse[finite], ref_lse[finite], atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("Smax,half", [(64, 32), (63, 40)])
def test_two_halves_merge_to_the_whole_call(Smax, half):
    """A cache cut at ``half``: each part called at the lengths that fall
    in it (as a rank of the "seq" layout calls its block), merged by
    ``merge_partials``, equals the call over the whole cache, and the
    parts' LSEs combine to the whole's."""
    lengths = [min(n, Smax) for n in LENGTHS]
    B, KV, G, D = len(lengths), 1, 8, 16
    q, k, v = _decode_inputs(2, B, KV, G, D, Smax)
    lens = torch.tensor(lengths)
    whole, whole_lse = decode_attention_ref(q, k, v, lens, return_lse=True)
    first = decode_attention_ref(q, k[:, :, :half], v[:, :, :half],
                                 lens.clamp(0, half), return_lse=True)
    second = decode_attention_ref(q, k[:, :, half:], v[:, :, half:],
                                  (lens - half).clamp(0, Smax - half), return_lse=True)
    merged = sharding.merge_partials([first[0], second[0]], [first[1], second[1]])
    torch.testing.assert_close(merged, whole, atol=1e-6, rtol=1e-6)
    combined = torch.logaddexp(first[1], second[1])
    assert torch.equal(torch.isneginf(combined), torch.isneginf(whole_lse))
    finite = torch.isfinite(whole_lse)
    torch.testing.assert_close(combined[finite], whole_lse[finite], atol=LSE_TOL, rtol=0)
    assert float(merged[0].abs().max()) == 0.0  # length 0: zeros, no NaN
    assert torch.isfinite(merged).all()


def test_op_returns_the_lse_on_the_cpu():
    """``decode_attention_op(return_lse=True)`` in the model's (B, H, D)
    layout: the output in f32 whatever q's dtype, the LSE (B, H)."""
    B, KV, G, D, Smax = len(LENGTHS), 2, 4, 64, 64
    q, k, v = _decode_inputs(3, B, KV, G, D, Smax)
    lens = torch.tensor(LENGTHS)
    for dtype in (torch.float32, torch.bfloat16):
        qh = q.reshape(B, KV * G, D).to(dtype)
        out, lse = decode_ops.decode_attention_op(qh, k.to(dtype), v.to(dtype), lens,
                                                  return_lse=True)
        assert out.dtype == lse.dtype == torch.float32
        assert out.shape == (B, KV * G, D) and lse.shape == (B, KV * G)
        ref_out, ref_lse = decode_attention_ref(qh.reshape(B, KV, G, D), k.to(dtype),
                                                v.to(dtype), lens, return_lse=True)
        assert torch.equal(out, ref_out.reshape(B, KV * G, D))
        assert torch.equal(lse, ref_lse.reshape(B, KV * G))


def test_op_counts_an_lse_call_once_on_meta():
    """On the meta device the LSE mode takes the card's checks, returns the
    f32 output and LSE shapes, launches nothing and counts one call with
    the f32 output's bytes."""
    seen = []
    common.meta_counters.append(lambda name, shape: seen.append((name, shape)))
    before = dict(common.launch_counts)
    try:
        q = torch.empty(4, 16, 128, dtype=torch.bfloat16, device="meta")
        kc = torch.empty(4, 2, 512, 128, dtype=torch.bfloat16, device="meta")
        out, lse = decode_ops.decode_attention_op(q, kc, kc, 7, return_lse=True)
        plain = decode_ops.decode_attention_op(q, kc, kc, 7)
    finally:
        common.meta_counters.pop()
    assert out.dtype == lse.dtype == torch.float32
    assert out.shape == (4, 16, 128) and lse.shape == (4, 16)
    assert plain.dtype == torch.bfloat16
    assert [name for name, _ in seen] == ["decode_attention"] * 2
    assert seen[0][1]["lse"] and "lse" not in seen[1][1]
    assert common.launch_counts == before
    from repro_torch.analysis.op_stats import kernel_work

    (_, with_lse), (_, without) = (kernel_work(n, s) for n, s in seen)
    assert with_lse - without == 4 * 16 * (128 * 2 + 4)


@pytest.mark.parametrize("clen", [1, 100, 256])
def test_lse_mode_output_matches_the_pallas_kernel(clen):
    """The LSE mode's output against the JAX package's Pallas decode kernel
    in interpret mode, at 2e-5 as ``test_torch_decode_split.py``."""
    from repro.kernels.decode_attention import decode_attention_op as pallas_op

    B, H, KV, D, Smax = 2, 8, 2, 64, 256
    q, k, v = _decode_inputs(4, B, KV, H // KV, D, Smax)
    ref = pallas_op(jnp.asarray(q.numpy().reshape(B, H, D)), jnp.asarray(k.numpy()),
                    jnp.asarray(v.numpy()), jnp.asarray(clen), block_s=64)
    out, _ = decode_ops.decode_attention_op(q.reshape(B, H, D), k, v, clen,
                                            return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# sharded serving on four gloo ranks
# ---------------------------------------------------------------------------

MAX_LEN = 32
# (mesh, config, cache and engine positions): blocks of 8 at (1, 4), of 16
# at (2, 2); 30 positions do not split into 4
CASES = {"1x4-qwen": ((1, 4), "qwen", 32), "2x2-qwen": ((2, 2), "qwen", 32),
         "1x4-qwen-whole": ((1, 4), "qwen", 30), "1x4-granite": ((1, 4), "granite", 32)}
ARCHS = {"qwen": "qwen2.5-3b", "granite": "granite-moe-3b-a800m"}
PROMPT = 14
# each decode step's position per row: row 1 idle at the second step,
# rows crossing from the second block into the third at (1, 4)
DECODE_POS = [[14, 14], [15, -1], [16, 15], [17, 16]]
SHARED = 20  # the prefix hit's matched tokens


def _requests(rng, vocab):
    """Three requests over four slots (one idle throughout): a prompt of
    24 tokens, one that shares its first SHARED (a prefix hit ending in a
    block past the first), and a short one."""
    first = rng.integers(0, vocab, size=24).astype(np.int32)
    hit = np.concatenate([first[:SHARED], rng.integers(0, vocab, size=4)]).astype(np.int32)
    return [first, hit, rng.integers(0, vocab, size=5).astype(np.int32)]


@pytest.fixture(scope="module")
def configs():
    """{name: (the case without key, mesh and lengths, the reference's
    bundle and f32 params or None)}."""
    rng = np.random.default_rng(7)
    out = {}
    for name, arch in ARCHS.items():
        cfg = reduced_config(get_config(arch))
        assert cfg.num_kv_heads == 1
        case = {"cfg": cfg, "prompts": rng.integers(0, cfg.vocab_size, size=(2, PROMPT)),
                "decode": rng.integers(0, cfg.vocab_size, size=(len(DECODE_POS), 2)),
                "requests": _requests(rng, cfg.vocab_size)}
        bundle = params = None
        if name == "qwen":  # the reference's weights, and its prefill as the anchor
            bundle = jax_build_model(jax_reduced_config(jax_get_config(arch)))
            params = jax.tree.map(lambda a: a.astype(jnp.float32),
                                  bundle.init(jax.random.key(0)))
            case["params"] = jax.tree.map(np.asarray, params)
        else:
            case["seed"] = 5
        out[name] = (case, bundle, params)
    return out


def _case(configs, key):
    mesh, name, length = CASES[key]
    case = configs[name][0]
    return dict(case, key=key, mesh=mesh,
                serve={"cache_len": length, "max_len": length, "slots": 4,
                       "decode_pos": DECODE_POS})


@pytest.fixture(scope="module")
def runs(configs, tmp_path_factory):
    """Every case on its mesh (each rank's results) and unsharded (run here
    while the ranks run)."""
    cases = [_case(configs, key) for key in CASES]
    store = str(tmp_path_factory.mktemp("kv_seq") / "store")
    got, plain = worker.run_ranks(
        cases, store, WORLD,
        meanwhile=lambda: {case["key"]: worker.serve_case(case) for case in cases})
    return {case["key"]: ([r[case["key"]] for r in got], plain[case["key"]], case)
            for case in cases}


@pytest.mark.parametrize("key", list(CASES))
def test_seq_cache_is_every_kv_head_over_the_rank_block(runs, key):
    """Each rank's cache is (L, B, KV, positions / W, D) at block r of the
    positions, or whole where W does not divide them."""
    ranks, plain, case = runs[key]
    cfg, (_, ways) = case["cfg"], case["mesh"]
    length = case["serve"]["cache_len"]
    assert sharding.kv_layout(cfg, {"model": ways}) == "seq"
    assert plain["block"] is None
    whole = (cfg.num_layers, 2, cfg.num_kv_heads, length, cfg.head_dim)
    assert plain["cache_shapes"] == {"k": whole, "v": whole}
    for rank, r in enumerate(ranks):
        model_rank = rank % ways
        if length % ways:
            assert r["block"] is None and r["cache_shapes"]["k"] == whole
        else:
            chunk = length // ways
            assert r["block"] == (model_rank * chunk, chunk)
            assert r["cache_shapes"]["k"] == whole[:3] + (chunk,) + whole[4:]


@pytest.mark.parametrize("key", list(CASES))
def test_seq_prefill_and_decode_match_unsharded(runs, key):
    ranks, plain, _ = runs[key]
    for r in ranks:
        _close(r["serve_logits"][0], plain["serve_logits"][0], SERVE_TOL, "prefill")
        _close(r["serve_logits"][1:], plain["serve_logits"][1:], TOL, "decode")
        assert r["kernel_input_types"] == ["Tensor"]
        # every rank computes the same bits
        assert np.array_equal(r["serve_logits"], ranks[0]["serve_logits"])


@pytest.mark.parametrize("key", list(CASES))
def test_seq_engine_tokens_equal_unsharded(runs, key):
    """The engine's tokens exactly, the second request served from the
    first's cached prefix of SHARED tokens on every rank."""
    ranks, plain, case = runs[key]
    assert len(plain["tokens"]) == len(case["requests"])
    assert plain["cached_tokens"] == {0: 0, 1: SHARED, 2: 0}
    for r in ranks:
        assert r["tokens"] == plain["tokens"]
        assert r["cached_tokens"] == plain["cached_tokens"]


def test_prefix_hit_ends_past_the_first_block():
    """At (1, 4) over 32 positions the 20 matched tokens end in block 2,
    at (2, 2) in block 1: the copy and the suffix's steps cross ranks."""
    assert SHARED // (MAX_LEN // 4) == 2 and SHARED // (MAX_LEN // 2) == 1


def test_unsharded_logits_match_reference(configs, runs):
    """The chain's anchor: the unsharded port's prefill logits equal the
    reference's on the same weights and prompts."""
    case, bundle, params = configs["qwen"]
    ref, _ = jax.jit(bundle.prefill)(params, {"tokens": jnp.asarray(case["prompts"])})
    plain = runs["1x4-qwen"][1]
    _close(plain["serve_logits"][0], np.asarray(ref).reshape(
        plain["serve_logits"][0].shape), 1e-4, "qwen logits against the reference")


# ---------------------------------------------------------------------------
# the serving caches against the reference's classes
# ---------------------------------------------------------------------------


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def test_paged_cache_matches_reference():
    """The same calls on both classes (appends that start and end mid-page,
    a freed sequence's pages reused): the same free list, tables and
    lengths, equal pools and ``gather_seq`` contents, and ``MemoryError``
    when the pool runs dry."""
    L, pages, KV, ps, D = 2, 6, 2, 4, 8
    ours = PagedKVCache.create(L, pages, KV, ps, D, dtype=torch.float32, device="cpu")
    ref = jax_kv_cache.PagedKVCache.create(L, pages, KV, ps, D, dtype=jnp.float32)
    rng = np.random.default_rng(0)

    def both(method, *args):
        torch_args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
        jax_args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        getattr(ours, method)(*torch_args)
        getattr(ref, method)(*jax_args)

    def kv(T):
        k = rng.standard_normal((L, KV, T, D)).astype(np.float32)
        return k, k * 3

    both("alloc_seq", 0)
    both("alloc_seq", 1)
    both("append", 0, *kv(3))
    both("append", 1, *kv(6))
    both("append", 0, *kv(7))  # from mid-page across two pages
    both("free_seq", 1)
    both("alloc_seq", 2)
    both("append", 2, *kv(5))  # into the freed pages
    assert ours.free_pages == ref.free_pages
    assert ours.tables == ref.tables and ours.lengths == ref.lengths
    np.testing.assert_array_equal(_np(ours.k), _np(ref.k))
    np.testing.assert_array_equal(_np(ours.v), _np(ref.v))
    for seq in (0, 2):
        got, want = ours.gather_seq(seq), ref.gather_seq(seq)
        assert got[2] == want[2]
        np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
        np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    with pytest.raises(MemoryError):
        ref.append(2, *(jnp.asarray(a) for a in kv(2 * ps)))
    with pytest.raises(MemoryError):
        ours.append(2, *(torch.from_numpy(a) for a in kv(2 * ps)))


def test_slot_cache_matches_reference():
    """create, alloc, write_prefill (a long prompt, then a shorter one into
    the same slot, whose tail stays as it was), copy_prefix and free on
    both classes: the same free list and lengths, equal tensors."""
    L, slots, KV, S, D = 2, 3, 2, 16, 8
    ours = SlotKVCache.create(L, slots, KV, S, D, dtype=torch.float32, device="cpu")
    ref = jax_kv_cache.SlotKVCache.create(L, slots, KV, S, D, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    steps = []
    for _ in range(3):
        a, b = ours.alloc(), ref.alloc()
        assert a == b
        steps.append(a)
    for slot, n in ((steps[0], 12), (steps[1], 5), (steps[0], 7)):
        k = rng.standard_normal((L, KV, n, D)).astype(np.float32)
        ours.write_prefill(slot, torch.from_numpy(k), torch.from_numpy(-k), n)
        ref.write_prefill(slot, jnp.asarray(k), jnp.asarray(-k), n)
    ours.copy_prefix(steps[0], steps[2], 6)
    ref.copy_prefix(steps[0], steps[2], 6)
    ours.free(steps[1])
    ref.free(steps[1])
    assert ours.free_slots == ref.free_slots
    np.testing.assert_array_equal(ours.lengths, ref.lengths)
    np.testing.assert_array_equal(_np(ours.k), _np(ref.k))
    np.testing.assert_array_equal(_np(ours.v), _np(ref.v))


@pytest.mark.parametrize("rank", range(4))
def test_slot_cache_writes_the_rank_block(rank):
    """Under the "seq" layout (blocks of 4 of 16 positions) a slot cache
    holds, of everything a whole one holds, its block: after prompts of 13,
    9 and 3 tokens and a copied prefix of 10, the block of the whole
    cache's valid positions, and the rest of the block untouched."""
    L, slots, KV, S, D = 1, 3, 2, 16, 4
    seq = sharding.SeqShard(None, 4, rank, S // 4)
    whole = SlotKVCache.create(L, slots, KV, S, D, dtype=torch.float32, device="cpu")
    block = SlotKVCache.create(L, slots, KV, S // 4, D, dtype=torch.float32, device="cpu")
    block = dataclasses.replace(block, seq=seq)
    block.k.fill_(-7.0)
    rng = np.random.default_rng(rank)
    for slot, n in ((0, 13), (1, 9), (2, 3)):
        k = torch.from_numpy(rng.standard_normal((L, KV, n, D)).astype(np.float32))
        for c in (whole, block):
            c.write_prefill(slot, k, 2 * k, n)
    for c in (whole, block):
        c.copy_prefix(0, 2, 10)
    assert list(block.lengths) == list(whole.lengths) == [13, 9, 10]
    for slot, n in enumerate(block.lengths):
        held = min(max(int(n) - seq.start, 0), seq.chunk)
        want = whole.k[:, slot, :, seq.start:seq.start + held]
        assert torch.equal(block.k[:, slot, :, :held], want)
        assert torch.equal(block.v[:, slot, :, :held], 2 * want)
        assert (block.k[:, slot, :, held:] == -7.0).all()
    assert block.cache.seq == seq


def test_cache_classes_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlotKVCache.create(1, 1, 1, 4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache.create(1, 1, 1, 4, 4)


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------


def test_dryrun_counts_the_seq_cache(tmp_path):
    """qwen2.5-3b's decode_32k at ``gpu32x8``: the cache a GPU holds is both
    KV heads over 4096 of the 32768 positions of its 4 rows, 0.604 GB (the
    "heads" layout held one KV head over all of them, 2.416 GB); per layer
    one decode call over the block, the q gather and the partials'
    all-gather, beside the two Megatron all-reduces; plus the
    embedding's all-reduce and the logits' all-gather."""
    rec = dryrun.run_cell("qwen2.5-3b", "decode_32k", "gpu32x8", tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_config("qwen2.5-3b")
    L, rows = cfg.num_layers, rec["rows_per_gpu"]
    cache = 2 * L * rows * cfg.num_kv_heads * 4096 * cfg.head_dim * 2
    assert cache == 603979776
    kernels = rec["op_stats"]["kernels"]["decode_attention"]
    assert kernels["calls"] == L
    # each call reads its block of both KV heads' K and V
    assert kernels["bytes"] > cache > kernels["bytes"] - 2e6
    coll = rec["collectives"]
    assert coll["all-gather"]["count"] == 2 * L + 1
    assert coll["all-reduce"]["count"] == 2 * L + 1


@pytest.mark.parametrize("mesh", list(PROD_MESHES))
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "seamless-m4t-large-v2"])
def test_vlm_and_encdec_keep_heads_at_the_seq_bytes(arch, mesh):
    """A lasting divergence.  The reference lays the VLM's and the
    enc-dec's self caches' positions over ``model`` (their
    ``cache_spec_fn`` takes no layout), the enc-dec's frame cache too, and
    replicates the VLM's image cache.  Their KV heads divide the model ways
    (8 and 16 over 8), so ``kv_layout`` gives "heads", as the reference's
    dry-run rule does, and the port keeps each rank's KV heads over every
    position.  A GPU's cache in the port's decode_32k record is the bytes
    of the reference's shapes with ``model`` on the KV heads: the self
    cache's bytes under the reference's spec, seamless's frame cache's
    too, and the VLM's image cache a W-th of the reference's."""
    sizes, ways = PROD_MESHES[mesh], PROD_MESHES[mesh]["model"]
    cfg, jcfg = get_config(arch), JAX_ASSIGNED[arch]
    assert sharding.kv_layout(cfg, sizes) == "heads" == _reference_rule(jcfg, ways)
    shape = SHAPES_BY_NAME["decode_32k"]
    bundle = jax_build_model(jcfg)
    leaves = bundle.cache_shape_fn(shape.global_batch, shape.seq_len)
    ref_specs = bundle.cache_spec_fn()

    def gpu_bytes(leaf, spec):
        fitted = sharding.fit_spec(tuple(spec), leaf.shape, sizes)
        return math.prod(sharding.local_shape(leaf.shape, fitted, sizes)) * leaf.dtype.itemsize

    def heads_spec(spec):  # "model" on the KV heads, not on the positions
        entries = list(spec)
        entries[-3], entries[-2] = "model", None
        return tuple(entries)

    ref = {part: sum(gpu_bytes(leaf, spec) for leaf, spec in zip(leaves[part], ref_specs[part]))
           for part in ("self", "cross")}
    ours = {part: sum(gpu_bytes(leaf, heads_spec(spec))
                      for leaf, spec in zip(leaves[part], ref_specs[part]))
            for part in ("self", "cross")}
    assert ours["self"] == ref["self"]
    assert ours["cross"] * (ways if cfg.family == "vlm" else 1) == ref["cross"]
    rec = json.loads((dryrun.RESULTS_DIR / f"{arch}__decode_32k__{mesh}.json").read_text())
    assert rec["status"] == "ok"
    weights = sharding.per_gpu_bytes(build_model(cfg, device="meta"), sizes)["weights"]
    # the arguments: the local weights, the cache and the tokens' storage
    held = rec["memory"]["argument_bytes"] - weights - 4 * shape.global_batch
    assert held == ours["self"] + ours["cross"]
