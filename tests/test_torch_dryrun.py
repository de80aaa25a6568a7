"""The port's dry-run (``launch/dryrun.py``, ``launch/reanalyze.py``) and its
counter (``analysis/op_stats.py``) on the meta device: no card, no memory.

A reduced dense config (qwen2.5-3b's at 2 layers and width 64, with 4
query heads over 2 KV heads of 64, a head dim every kernel takes) gives
exact FLOP identities for a train step and a prefill, the kernels' calls,
and its prefill and decode against the reference's compiled HLO
(``repro.analysis.hlo_stats``).  qwen2.5-3b at full width (cut to 2
layers) at both production meshes under torch's fake process group gives
the argument bytes and the all-reduce count a layer and microbatch; and
gemma-7b's train step (head dim 256) counts its backward calls as the card
launches them.  Four gloo ranks check that the ``pod`` axis is data
parallelism: (2, 1, 2) bit-equal to (1, 2, 2).  Then the CLI and
``reanalyze``.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils.flop_counter import FlopCounterMode

import torch_sharded_worker as worker
from repro_torch.analysis.op_stats import (OpCounter, attention_pairs,
                                           train_launches)
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.distributed import sharding
from repro_torch.kernels import common
from repro_torch.launch import dryrun, reanalyze
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.transformer import DenseLM
from repro_torch.training.optimizer import init_state
from repro_torch.training.train_loop import make_train_step
from torch_threads import one_thread  # noqa: F401  (autouse)

CFG = dataclasses.replace(reduced_config(get_config("qwen2.5-3b")), num_heads=4,
                          num_kv_heads=2, head_dim=64)
B, S = 4, 24
MESHES = ["gpu32x8", "gpu2x32x8"]


def _meta(*shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _count(step):
    """op_stats (with "memory") of ``step()`` under an ``OpCounter``."""
    with OpCounter() as counter:
        step()
    return counter.stats()


def _weights(model):
    """(the layers' matrices but w_down, the layers' w_down, the LM head's
    table) in elements."""
    mats = {n: p.numel() for n, p in model.named_parameters()
            if p.ndim == 2 and n.startswith("layers.")}
    down = sum(n for k, n in mats.items() if k.endswith("w_down"))
    head = (model.embed if model.lm_head is None else model.lm_head).numel()
    return sum(mats.values()) - down, down, head


def _train_count(mb):
    model = DenseLM(CFG, device="meta")
    step = make_train_step(model, num_microbatches=mb)
    state = init_state(dict(model.named_parameters()))
    batch = {"tokens": _meta(B, S), "labels": _meta(B, S)}
    with FlopCounterMode(display=False) as flops, OpCounter() as counter:
        step(state, batch)
    return model, counter.stats(), flops.get_total_flops()


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_flop_identities(mb):
    """Per token, each layer matrix is multiplied 8 times a step (the
    forward, the checkpoint's recompute and the backward's two products),
    except w_down, which the recompute skips: non-reentrant checkpointing
    stops once the saved tensors the backward needs are rebuilt, and the
    layer's last product feeds none; the LM head (outside the checkpoint)
    6 times.  The flash kernels: the forward's 4·D per unmasked pair and
    head twice (forward, recompute), the backward's 14·D once."""
    model, stats, torch_flops = _train_count(mb)
    rest, down, head = _weights(model)
    T = B * S
    assert stats["flops"] == 8 * rest * T + 6 * down * T + 6 * head * T
    assert stats["flops"] == torch_flops  # FlopCounterMode's own total
    L, H, D = CFG.num_layers, CFG.num_heads, CFG.head_dim
    pairs = attention_pairs(S, S, True)
    kernels = stats["kernels"]
    assert kernels["flash_attention"]["flops"] == 2 * L * 4 * D * pairs * H * B
    assert kernels["flash_attention_bwd"]["flops"] == L * 14 * D * pairs * H * B
    assert {k: v["calls"] for k, v in kernels.items()} == train_launches(CFG, mb)


def test_prefill_flop_identity():
    """A prefill multiplies each layer matrix once per token (2 FLOPs) and
    the LM head for the last token of each row; the flash forward 4·D per
    unmasked pair and head, once a layer."""
    model = DenseLM(CFG, device="meta")
    rest, down, head = _weights(model)
    stats = _count(lambda: model.prefill(_meta(B, S)))
    assert stats["flops"] == 2 * (rest + down) * B * S + 2 * head * B
    L, H, D = CFG.num_layers, CFG.num_heads, CFG.head_dim
    assert stats["kernels"] == {"flash_attention": {
        "calls": L, "flops": L * 4 * D * attention_pairs(S, S, True) * H * B,
        "bytes": L * 2 * (2 * B * S * H * D + 2 * B * S * CFG.num_kv_heads * D)}}
    assert not stats["collectives"]


def test_meta_calls_leave_the_launch_counts_alone():
    common.reset_launch_counts()
    _, stats, _ = _train_count(2)
    model = DenseLM(CFG, device="meta")
    cache = model.init_cache(B, 32)
    with torch.no_grad(), OpCounter() as counter:
        model.decode_step(cache, _meta(B), 31)
    assert stats["kernels"] and counter.stats()["kernels"]["decode_attention"]["calls"] == 2
    assert all(n == 0 for n in common.launch_counts.values())
    assert not common.meta_counters  # each counter leaves the hook list


def _reference_counts(kind):
    """The reference's prefill or decode step of CFG lowered and compiled
    on the host, counted by ``hlo_stats``."""
    import jax
    import jax.numpy as jnp

    from repro.analysis.hlo_stats import analyze_compiled
    from repro.configs.registry import get_config as jax_get_config
    from repro.configs.registry import reduced_config as jax_reduced_config
    from repro.models import build_model as jax_build_model

    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config("qwen2.5-3b")),
                               num_heads=4, num_kv_heads=2, head_dim=64)
    bundle = jax_build_model(jcfg)
    params = bundle.shapes()
    if kind == "prefill":
        batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
        compiled = jax.jit(bundle.prefill).lower(params, batch).compile()
    else:
        compiled = jax.jit(bundle.decode_step).lower(
            params, bundle.cache_shape_fn(B, 32),
            jax.ShapeDtypeStruct((B,), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32)).compile()
    return analyze_compiled(compiled)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_prefill_and_decode_flops_against_the_reference(kind):
    """The reference's compiled prefill and decode (its attention is the
    jnp form, one query chunk at S <= 1024, and its decode attends over
    the whole cache) against the port's aten products plus its kernels.
    The products agree exactly once the attention is set apart: the
    reference's chunk computes every (query, key) pair, masked ones too,
    4·D·S² a layer and head where the port's flash kernel does the S(S+1)/2
    unmasked ones; at decode both read all 32 cache positions (the port's
    lengths are not known on the meta device).  So the totals differ by
    the masked half only: within 8% of the reference's at S = 24 (6.8%)."""
    ref = _reference_counts(kind)
    model = DenseLM(CFG, device="meta")
    L, H, D = CFG.num_layers, CFG.num_heads, CFG.head_dim
    with torch.no_grad():
        if kind == "prefill":
            stats = _count(lambda: model.prefill(_meta(B, S)))
            attention = L * 4 * D * S * S * H * B
        else:
            cache = model.init_cache(B, 32)
            stats = _count(lambda: model.decode_step(cache, _meta(B), 31))
            attention = L * 4 * D * 32 * H * B
    assert ref.flops == pytest.approx(stats["flops"] + attention, rel=1e-9)
    assert stats["total_flops"] == pytest.approx(ref.flops, rel=0.08)
    if kind == "decode":
        assert stats["total_flops"] == pytest.approx(ref.flops, rel=1e-9)


# ---------------------------------------------------------------------------
# the production meshes under the fake process group
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_world():
    def start(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


QWEN2 = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=2)
TRAIN = InputShape("train_4k", 4096, 256, "train")


def _production_count(fake_world, mesh_name, mb):
    multi_pod = dryrun.MESHES[mesh_name]
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    return mesh, dryrun.count_step(QWEN2, TRAIN, mesh, num_microbatches=mb)


@pytest.mark.parametrize("mesh_name", MESHES)
def test_argument_bytes_are_the_local_weights_and_moments(fake_world, mesh_name):
    """qwen2.5-3b (full width, 2 layers) at a production mesh: the step's
    arguments are this GPU's weight shards and its ZeRO-1 moments (over
    ``pod`` x ``data``), AdamW's int32 step and the global batch of int32
    tokens and labels that every rank is handed."""
    mesh, counted = _production_count(fake_world, mesh_name, 1)
    local = sharding.per_gpu_bytes(DenseLM(QWEN2, device="meta"), mesh)
    batch = 2 * 4 * TRAIN.global_batch * TRAIN.seq_len
    assert counted["memory"]["argument_bytes"] == local["weights"] + local["moments"] + 4 + batch
    assert counted["rows"] == TRAIN.global_batch // (32 if mesh_name == "gpu32x8" else 64)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("mb", [1, 2])
def test_all_reduce_count_per_layer_and_microbatch(fake_world, mesh_name, mb):
    """All-reduces of a train step.  Per layer and microbatch: the forward's
    two row-parallel sums (wo, w_down), the recompute's one (wo; it stops
    before w_down, as it stops before its product), and the backward's two
    column-parallel input gradients (q/k/v and the MLP).  Per microbatch:
    the vocab-sharded embedding's sum and the LM head's input gradient.
    Per step: one over ``pod`` x ``data`` for every weight's gradient, one
    more over ``model`` for each KV projection replicated there (qwen's two
    KV heads over 8 ways: wk, wv, bk, bv), the clip's norm and the loss's
    mean.  One all-gather per microbatch (the logits' vocabulary) and one
    per weight with a ZeRO-1 dim (its update)."""
    mesh, counted = _production_count(fake_world, mesh_name, mb)
    coll = counted["op_stats"]["collectives"]
    model = DenseLM(QWEN2, device="meta")
    names = [n for n, _ in model.named_parameters()]
    replicated = [n for n in names if n.endswith(sharding.KV_PROJECTIONS)]
    L = QWEN2.num_layers
    assert len(replicated) == 4 * L
    assert coll["all-reduce"]["count"] == mb * (5 * L + 2) + len(names) + len(replicated) + 2
    specs = sharding.fit_param_specs(model, mesh)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    dp = 32 if mesh_name == "gpu32x8" else 64
    zeroed = sum(sharding._zero_dim(specs[n], shapes[n], dp) is not None for n in names)
    assert coll["all-gather"]["count"] == mb + zeroed


@pytest.mark.parametrize("mesh_name", MESHES)
def test_gemma_train_is_refused_as_on_the_card(tmp_path, mesh_name):
    """gemma-7b's train cell runs as the card now runs it: the flash
    backward takes its head dim of 256 (the persistent ``wgmma`` kernel,
    one worker a block), so the cell is ``ok`` and counts one backward
    call per layer and microbatch, ``train_launches``' count, beside two
    forwards.  qwen2-7b's 28 heads
    over 8 model ways (3.5 a rank), whose 4 KV heads lay the decode cache's
    positions over ``model`` (the "seq" layout), count: per layer one
    decode launch, the two Megatron all-reduces, the gather of q's columns
    and the all-gather of the ranks' partial outputs, plus the embedding's
    all-reduce and the logits' all-gather."""
    rec = dryrun.run_cell("gemma-7b", "train_4k", mesh_name, tmp_path)
    assert rec["status"] == "ok", rec.get("reason") or rec.get("error")
    want = train_launches(get_config("gemma-7b"), rec["microbatches"])
    kernels = rec["op_stats"]["kernels"]
    assert kernels["flash_attention_bwd"]["calls"] == want["flash_attention_bwd"] > 0
    assert kernels["flash_attention"]["calls"] == want["flash_attention"]
    rec = dryrun.run_cell("qwen2-7b", "decode_32k", mesh_name, tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    L = get_config("qwen2-7b").num_layers
    coll = rec["op_stats"]["collectives"]
    assert coll["all-gather"]["count"] == 2 * L + 1
    assert coll["all-reduce"]["count"] == 2 * L + 1
    assert "reduce-scatter" not in coll
    assert rec["op_stats"]["kernels"]["decode_attention"]["calls"] == L


def test_collective_breakdown_tells_the_q_gather(tmp_path, capsys):
    """``reanalyze --collectives``: qwen2-7b's decode_32k at ``gpu32x8`` by
    c10d op and shape, the rows' bytes summing to the record's.  The
    query columns' gather is one ``_allgather_base_`` a layer of the 8
    ranks' 448 columns of each of the 4 rows (the logits' vocabulary
    gather is a list ``allgather_``)."""
    rec = dryrun.run_cell("qwen2-7b", "decode_32k", "gpu32x8", tmp_path)
    cell = "qwen2-7b__decode_32k__gpu32x8"
    assert reanalyze.main(["--out", str(tmp_path), "--collectives", cell]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert sum(r["bytes"] for r in rows) == rec["collectives"]["total_bytes"]
    assert abs(sum(r["share"] for r in rows) - 1) < 1e-9
    (gather,) = [r for r in rows if r["op"] == "_allgather_base_"]
    assert gather["count"] == get_config("qwen2-7b").num_layers
    assert gather["out"] == [8 * 4, 1, 448] and gather["dtype"] == "bfloat16"


def test_rwkv_decode_counts_on_local_heads(tmp_path):
    """rwkv6-7b's decode_32k at ``gpu32x8`` (256 GPUs, model ways 8): 128
    rows over 32 data ranks, 4 a GPU, each holding its 8 of the 64 WKV
    heads.  Its arguments are this GPU's weight shards, the state (the
    WKV state of its heads in f32, the token shifts at the whole width in
    bf16) and the 128 int32 tokens every rank is handed (its rows are a
    view of them); one scan launch a layer; per layer the two
    row-parallel sums (the time mix's ``wo``, the channel mix's ``wv``),
    plus the embedding's sum and the logits' all-gather."""
    rec = dryrun.run_cell("rwkv6-7b", "decode_32k", "gpu32x8", tmp_path)
    assert rec["status"] == "ok" and rec["rows_per_gpu"] == 4
    cfg = get_config("rwkv6-7b")
    L, D, d, rows = cfg.num_layers, cfg.head_dim, cfg.d_model, 4
    model = build_model(cfg, device="meta")
    weights = sharding.per_gpu_bytes(model, {"data": 32, "model": 8})["weights"]
    state = L * rows * (cfg.num_heads // 8) * D * D * 4 + 2 * L * rows * d * 2
    assert rec["memory"]["argument_bytes"] == weights + state + 4 * 128
    kernels = rec["op_stats"]["kernels"]
    assert {k: v["calls"] for k, v in kernels.items()} == {"wkv6_scan": L}
    coll = rec["collectives"]
    assert coll["all-reduce"]["count"] == 2 * L + 1
    assert coll["all-gather"]["count"] == 1


def test_rows_that_do_not_divide_split_as_fit_spec(fake_world):
    """At (2, 32, 8): 128 rows split 64 ways; 32 rows do not, so ``data``
    is dropped and the pod halves them; 1 row runs on every rank."""
    fake_world(512)
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    assert sharding.data_shard(mesh).ways == 64
    rows = torch.arange(128)
    assert torch.equal(sharding.data_rows(rows, mesh), rows[:2])
    assert torch.equal(sharding.data_rows(rows[:32], mesh), rows[:16])
    assert torch.equal(sharding.data_rows(rows[:1], mesh), rows[:1])


# ---------------------------------------------------------------------------
# the pod axis on four gloo ranks
# ---------------------------------------------------------------------------

POD_CASES = {"pod": (2, 1, 2), "data": (1, 2, 2)}
WORLD = 4


@pytest.fixture(scope="module")
def pod_runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    cfg = dataclasses.replace(reduced_config(get_config("qwen2.5-3b")),
                              num_heads=8, num_kv_heads=2, head_dim=8)
    tokens = rng.integers(0, cfg.vocab_size, size=(4, 12))
    common_case = {
        "cfg": cfg, "seed": 3,
        "batch": {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)},
        "prompts": rng.integers(0, cfg.vocab_size, size=(2, 9)),
        "decode": rng.integers(0, cfg.vocab_size, size=(4, 2)),
        "requests": [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                     for n in (5, 9, 12)]}
    cases = [dict(common_case, key=k, mesh=m) for k, m in POD_CASES.items()]
    store = str(tmp_path_factory.mktemp("pod") / "store")
    return worker.run_ranks(cases, store, WORLD)[0]


def _equal(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}/{k}")
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), what


@pytest.mark.parametrize("part", [("loss", "grads"), ("losses", "weights", "m", "v"),
                                  ("serve_logits",), ("tokens",)],
                         ids=["gradients", "train", "serve", "engine"])
def test_pod_axis_is_bit_equal_to_data(pod_runs, part):
    """Each rank of (pod 2, data 1, model 2) computes exactly what the same
    rank of (pod 1, data 2, model 2) does: the pod axis is data parallelism
    (rows, gradient average and ZeRO-1 slices over pod x data)."""
    for rank, r in enumerate(pod_runs):
        for key in part:
            _equal(r["pod"][key], r["data"][key], f"rank {rank} {key}")
    # ZeRO-1 over the two data-parallel ranks halves some moments
    numel = pod_runs[0]["pod"]["numel"]
    assert any(m * 2 == w for w, m in numel.values())


# ---------------------------------------------------------------------------
# the CLI and reanalyze
# ---------------------------------------------------------------------------


def test_cli_writes_a_record_and_reanalyze_reproduces_it(tmp_path, capsys):
    assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                        "--single-pod", "--out", str(tmp_path), "--force"]) == 0
    path = tmp_path / "qwen2.5-3b__decode_32k__gpu32x8.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["num_devices"] == 256
    assert rec["kind"] == "decode" and rec["rows_per_gpu"] == 4
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["output_bytes"]
    assert rec["op_stats"]["kernels"]["decode_attention"]["calls"] == 36
    assert set(rec["collectives"]) == {"all-reduce", "all-gather", "total_bytes"}
    assert "gpu32x8: ok" in capsys.readouterr().out
    # a second call reads the record back; reanalyze re-derives it exactly
    assert dryrun.run_cell("qwen2.5-3b", "decode_32k", "gpu32x8", tmp_path) == rec
    assert reanalyze.main(["--out", str(tmp_path)]) == 0
    assert json.loads(path.read_text()) == rec
    # and from a trace alone, without the record's memory
    trace = (tmp_path / "trace" / "qwen2.5-3b__decode_32k__gpu32x8.json.gz")
    again = reanalyze.reanalyze_cell(path, trace)
    assert again["op_stats"] == rec["op_stats"]
    assert math.isfinite(again["op_stats"]["total_flops"])
