"""hymba-1.5b's "seq" KV layout (``sharding.kv_layout``): a sharded
``HymbaLM`` holds every KV head over its block of the full layers'
positions and of the window rings' indices (``HymbaCache.blocks``), and
decodes its blocks through the decode kernel's LSE mode, merged over
``model``.

* Sharded serving on four gloo ranks (``tests/torch_sharded_worker.py``'s
  ``serve_case``, spawned once for the module): reduced hymba-1.5b (two
  layers, layer 0 full, W = 8, one KV head) with f32 weights bridged from
  the reference, at (1, 4) and (2, 2) over a cache of 32 positions (full
  blocks of 8 or 16, ring blocks of 2 or 4), over 30 positions at (1, 4)
  (the full layer's do not split, its ring's do) and at W = 6 (the ring's
  6 do not split, the full layer's do).  An 8-token prompt, then 18 steps
  to position 25: the full layer's steps cross every block past the first
  and the ring wraps twice; row 1 idles one step and lags after it.
  Prefill logits within 1e-5 of their scale and decode within 1e-4 (as
  ``test_torch_sharding.py``), every rank's logits bit-equal, each rank's
  leaves its blocks of the unsharded leaves (within one bf16 rounding of
  their scale), and the engine's tokens exactly (three requests of 20, 5
  and 11 tokens over four slots, one idle throughout).
* The unsharded anchor: the port's prefill logits against the reference's
  at S = W (the reference's ring is right for S <= W).
* Rank 0 of (1, 4) under torch's fake process group, on the meta device:
  the reduced config's blocks, and "heads" where the KV heads divide the
  ways (the KV projections then split over ``model``).
* Without ranks: a 64-entry ring cut into 8 blocks, each called at its
  part of every row's valid prefix (rows ending in different blocks,
  rows that wrapped), merged by ``merge_partials``, equals the whole
  ring's call, through the plain version and the split-K arithmetic; and
  the dry-run's ``long_500k`` and ``decode_32k`` hymba cells count the
  "seq" cache and 2L + 1 all-gathers a decode step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.distributed import sharding
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      decode_attention_split_ref)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.hymba import CONV_K, HymbaLM

import torch_sharded_worker as worker
from test_torch_sharding import SERVE_TOL, TOL, WORLD, _close
from torch_threads import one_thread  # noqa: F401  (autouse)

ARCH = "hymba-1.5b"
PROMPT = 8
# (mesh, cache and engine positions, window)
CASES = {"1x4": ((1, 4), 32, 8), "2x2": ((2, 2), 32, 8),
         "1x4-full-whole": ((1, 4), 30, 8), "1x4-ring-whole": ((1, 4), 32, 6)}
# each step's position per row: row 0 from PROMPT to 25, row 1 idle at the
# sixth step and one behind after it
STEPS = 18
DECODE_POS = [[PROMPT + i, PROMPT + i if i < 5 else (-1 if i == 5 else PROMPT + i - 1)]
              for i in range(STEPS)]
# one bf16 rounding of a cache entry, over the leaf's scale
CACHE_TOL = 2 ** -7


@pytest.fixture(scope="module")
def reference():
    """The reference's bundle and f32 params of reduced hymba-1.5b."""
    bundle = jax_build_model(jax_reduced_config(jax_get_config(ARCH)))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), bundle.init(jax.random.key(0)))
    return bundle, params


def _case(key, params, rng_seed=11):
    mesh, length, window = CASES[key]
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), sliding_window=window)
    rng = np.random.default_rng(rng_seed)
    return {"key": key, "mesh": mesh, "cfg": cfg,
            "params": jax.tree.map(np.asarray, params),
            "prompts": rng.integers(0, cfg.vocab_size, size=(2, PROMPT)),
            "decode": rng.integers(0, cfg.vocab_size, size=(STEPS, 2)),
            "requests": [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                         for n in (20, 5, 11)],
            "serve": {"cache_len": length, "max_len": length, "slots": 4,
                      "decode_pos": DECODE_POS}}


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    """Every case on its mesh (each rank's results) and unsharded (run here
    while the ranks run)."""
    cases = [_case(key, reference[1]) for key in CASES]
    store = str(tmp_path_factory.mktemp("hymba_seq") / "store")
    got, plain = worker.run_ranks(
        cases, store, WORLD,
        meanwhile=lambda: {case["key"]: worker.serve_case(case) for case in cases})
    return {case["key"]: ([r[case["key"]] for r in got], plain[case["key"]], case)
            for case in cases}


def test_reduced_config_takes_seq_at_both_meshes():
    """One KV head over 2 or 4 ways, and a window: "seq" at (1, 4) and
    (2, 2); the model takes it once sharded, "heads" unsharded."""
    cfg = reduced_config(get_config(ARCH))
    assert cfg.num_kv_heads == 1 and cfg.sliding_window == 8
    assert cfg.full_attn_layers == (0,) and cfg.num_layers == 2
    for ways in (2, 4):
        assert sharding.kv_layout(cfg, {"data": 4 // ways, "model": ways}) == "seq"
    assert HymbaLM(cfg, device="meta").kv_layout() == "heads"


@pytest.fixture
def fake_world():
    """A fake default process group of ``world`` ranks, this one rank 0."""
    def start(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("kv_heads", [1, 4])
def test_layout_follows_the_kv_projections(fake_world, kv_heads):
    """Rank 0 of (1, 4) on the meta device: one KV head (the reduced
    config) takes "seq", blocks of 8 of 32 positions and 2 of the ring's 8
    indices, and ``decode_step`` refuses a plain dict; 4 KV heads divide
    the ways, the KV projections split over ``model``, and the cache keeps
    "heads", one KV head over every position: the same bytes."""
    fake_world(4)
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), num_kv_heads=kv_heads)
    assert sharding.kv_layout(cfg, {"data": 1, "model": 4}) == "seq"
    model = sharding.shard_model(HymbaLM(cfg, device="meta"),
                                 make_mesh((1, 4), ("data", "model"), device_type="cpu"))
    cache = model.init_cache(2, 32)
    shapes = {name: tuple(leaf.shape) for name, leaf in cache.items()}
    if kv_heads == 1:
        assert model.kv_layout() == "seq"
        assert {k: (b.start, b.chunk) for k, b in cache.blocks.items()} == {
            "full": (0, 8), "swa": (0, 2)}
        assert shapes["k_full"] == (1, 2, 1, 8, cfg.head_dim)
        assert shapes["k_swa"] == (1, 2, 1, 2, cfg.head_dim)
        with pytest.raises(ValueError, match="HymbaCache"):
            model.decode_step(dict(cache), torch.zeros(2, dtype=torch.long), 0)
    else:
        assert model.kv_layout() == "heads"
        assert cache.blocks == {"full": None, "swa": None}
        assert shapes["k_full"] == (1, 2, 1, 32, cfg.head_dim)
        assert shapes["k_swa"] == (1, 2, 1, 8, cfg.head_dim)
    assert shapes["conv"] == (2, 2, cfg.q_dim // 4, CONV_K - 1)


@pytest.mark.parametrize("key", list(CASES))
def test_seq_cache_is_every_kv_head_over_the_rank_blocks(runs, key):
    """Each rank's KV leaves are every KV head at block r of the full
    layers' positions and of the ring's indices, or whole where the ways
    do not divide them; its Mamba states its h / W channels; and its
    leaves hold what the unsharded leaves hold there, after the last
    step."""
    ranks, plain, case = runs[key]
    cfg, (_, ways), length = case["cfg"], case["mesh"], case["serve"]["cache_len"]
    positions = {"full": length, "swa": min(cfg.sliding_window, length)}
    assert plain["blocks"] == {"full": None, "swa": None}
    for rank, r in enumerate(ranks):
        model_rank = rank % ways
        for name, shape in plain["cache_shapes"].items():
            got, kind = r["cache_shapes"][name], name.partition("_")[2]
            if not kind:  # conv, ssm: the rank's channels
                assert got == shape[:2] + (shape[2] // ways,) + shape[3:], (rank, name)
                continue
            assert shape[2] == cfg.num_kv_heads and shape[3] == positions[kind]
            if positions[kind] % ways:
                assert r["blocks"][kind] is None and got == shape, (rank, name)
                start, chunk = 0, positions[kind]
            else:
                chunk = positions[kind] // ways
                start = model_rank * chunk
                assert r["blocks"][kind] == (start, chunk), (rank, name)
                assert got == shape[:3] + (chunk,) + shape[4:], (rank, name)
            _close(r["leaves"][name], plain["leaves"][name][:, :, :, start:start + chunk],
                   CACHE_TOL, f"rank {rank} {name}")


def test_cases_cover_every_block_and_wrap_the_ring_twice():
    """The full layer's steps reach every block past the prompt's at
    (1, 4) and (2, 2); the ring's last position is past 3 W."""
    last = max(max(p) for p in DECODE_POS)
    for (_, ways), length, window in CASES.values():
        chunk = length // ways
        assert last // chunk == ways - 1 and PROMPT // chunk < ways - 1
        assert last >= 3 * window
    assert any(p[1] < 0 for p in DECODE_POS)


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
    """The engine's tokens exactly: a request past the ring and past the
    first full block, a short one, and a slot idle throughout; hymba gets
    no prefix cache."""
    ranks, plain, case = runs[key]
    assert len(plain["tokens"]) == len(case["requests"])
    assert set(plain["cached_tokens"].values()) == {0}
    for r in ranks:
        assert r["tokens"] == plain["tokens"]


def test_unsharded_logits_match_reference(reference, runs):
    """The chain's anchor: the unsharded port's prefill logits equal the
    reference's on the same weights and prompts of W tokens."""
    bundle, params = reference
    ranks, plain, case = runs["1x4"]
    ref, _ = jax.jit(bundle.prefill)(params, {"tokens": jnp.asarray(case["prompts"])})
    _close(plain["serve_logits"][0], np.asarray(ref).reshape(plain["serve_logits"][0].shape),
           1e-4, "hymba logits against the reference")


# ---------------------------------------------------------------------------
# the ring's blocks merged, without ranks
# ---------------------------------------------------------------------------

RING, BLOCKS = 64, 8
# valid prefixes min(pos + 1, RING): an idle row, rows whose end falls in
# blocks 0, 1, 3, 4 and 7, and two that wrapped (pos past the ring)
RING_POS = [-1, 0, 12, 30, 39, 63, 64, 200]


@pytest.mark.parametrize("kind", ["plain", "split"])
def test_ring_blocks_merge_to_the_whole_ring(kind):
    """Each block called at ``clamp(min(pos + 1, R) - start, 0, chunk)``
    (as ``attention_block_decode_seq`` calls a rank's block), with its LSE,
    merged by ``merge_partials``, equals the call over the whole ring at
    G = 5, KV = 5 (hymba's groups); an idle row gives zeros."""
    B, KV, G, D = len(RING_POS), 5, 5, 16
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32))
               for s in ((B, KV, G, D), (B, KV, RING, D), (B, KV, RING, D)))
    pos = torch.tensor(RING_POS)
    valid = torch.where(pos >= 0, (pos + 1).clamp(max=RING), 0)

    def call(kc, vc, n):
        if kind == "plain":
            return decode_attention_ref(q, kc, vc, n, return_lse=True)
        return decode_attention_split_ref(q, kc, vc, n, 3, return_lse=True)

    chunk = RING // BLOCKS
    parts = [call(k[:, :, s:s + chunk], v[:, :, s:s + chunk], (valid - s).clamp(0, chunk))
             for s in range(0, RING, chunk)]
    # the rows end in different blocks
    assert len({int((n - 1) // chunk) for n in valid if n > 0}) >= 5
    merged = sharding.merge_partials([o for o, _ in parts], [lse for _, lse in parts])
    whole, whole_lse = call(k, v, valid)
    torch.testing.assert_close(merged, whole, atol=1e-6, rtol=1e-6)
    assert float(merged[0].abs().max()) == 0.0 and torch.isfinite(merged).all()
    combined = torch.logsumexp(torch.stack([lse for _, lse in parts]), dim=0)
    finite = torch.isfinite(whole_lse)
    assert torch.equal(finite, torch.isfinite(combined))
    torch.testing.assert_close(combined[finite], whole_lse[finite], atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,cache_bytes", [("long_500k", 256409600),
                                               ("decode_32k", 81920000)])
def test_dryrun_counts_the_seq_cache(tmp_path, shape, cache_bytes):
    """hymba-1.5b at ``gpu32x8``: a GPU's cache is all 5 KV heads over
    S / 8 positions of its 3 full layers and 128 of the 1024 ring indices
    of its 29 window layers, k and v in bf16 (the "heads" layout held 1 KV
    head over all of them, 410,255,360 and 131,072,000 B); the arguments
    are the local weights, that cache, the Mamba states of the rank's 200
    channels and the tokens' storage; per layer one decode call over the blocks,
    the q gather and the partials' all-gather, beside the four all-reduces
    (attention, Mamba ``w_xdbc`` and ``w_out``, MLP), plus the embedding's
    all-reduce and the logits' all-gather."""
    rec = dryrun.run_cell(ARCH, shape, "gpu32x8", tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_config(ARCH)
    L, rows = cfg.num_layers, rec["rows_per_gpu"]
    S, batch = dryrun.SHAPES_BY_NAME[shape].seq_len, dryrun.SHAPES_BY_NAME[shape].global_batch
    n_full = len(cfg.full_attn_layers)
    per_position = rows * cfg.num_kv_heads * cfg.head_dim * 2 * 2  # k and v, bf16
    cache = per_position * (n_full * S // 8 + (L - n_full) * cfg.sliding_window // 8)
    assert cache == cache_bytes
    weights = sharding.per_gpu_bytes(HymbaLM(cfg, device="meta"),
                                     {"data": 32, "model": 8})["weights"]
    channels = cfg.q_dim // 8
    states = L * rows * channels * ((CONV_K - 1) * 2 + cfg.ssm_state * 4)
    # the tokens: the rank's rows, a view of the global batch's int32s
    assert rec["memory"]["argument_bytes"] == weights + cache + states + 4 * batch
    kernels = rec["op_stats"]["kernels"]["decode_attention"]
    assert kernels["calls"] == L
    # each call reads its blocks of every KV head's K and V
    assert kernels["bytes"] > cache > kernels["bytes"] - 4e6
    coll = rec["collectives"]
    assert coll["all-gather"]["count"] == 2 * L + 1
    assert coll["all-reduce"]["count"] == 4 * L + 1
