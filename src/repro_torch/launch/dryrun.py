"""Multi-pod dry-run of the port, the counterpart of ``repro.launch.dryrun``.

For every (architecture x input shape x production mesh) cell, build the
model on the meta device, shard it at the mesh under torch's fake process
group (one process plays rank 0 of 256 or 512 GPUs), run the cell's real
step -- ``make_train_step`` for train shapes, ``prefill`` for prefill
shapes, ``init_cache`` and one ``decode_step`` for decode shapes -- under
``analysis.op_stats.OpCounter``, and record, per GPU:

  * the FLOPs (aten products and the hand-written kernels' work),
  * the memory bytes the ops move,
  * each collective's count and bytes,
  * argument, output, temp and peak memory.

Nothing is computed and no GPU is needed: the tool runs on the CPU by
design, as the reference's runs on fake host devices, and raises if a
tensor of the step lands on a real device.  The meshes are
``launch/mesh.py``'s: ``gpu32x8`` is (32, 8) over (data, model), 256 GPUs
in 32 NVLink hosts of 8; ``gpu2x32x8`` is (2, 32, 8) over (pod, data,
model), 512.

A dense decoder's and hymba's prefill and decode caches take the layout
of ``sharding.kv_layout``: where the KV heads do not divide into the
model ways (and, for hymba's window, at every model ways), every KV head
over a block of the positions (of hymba's rings, a block of the ring
indices), decoded with the q gather and an all-gather of the ranks'
partial outputs.

Statuses: ``skipped`` (the reference's skip list: ``shapes_for``),
``refused`` (``sharding.check_shardable`` or a kernel's operand checks
refuse it, as the card would; the record carries their message), ``ok``
and ``error`` (anything else).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR] [--force]
Results land in DIR (``experiments/dryrun_torch/`` at the repo root by
default) as ``<arch>__<shape>__<mesh>.json``, each with its op trace in
``trace/<arch>__<shape>__<mesh>.json.gz`` (``launch/reanalyze.py``
re-derives ``op_stats`` from it).  A cell whose JSON exists is read back
unless ``--force`` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import math
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.analysis.op_stats import OpCounter
from repro_torch.configs.base import (ArchConfig, InputShape, SHAPES_BY_NAME,
                                      shapes_for)
from repro_torch.configs.registry import ASSIGNED, get_config
from repro_torch.distributed.sharding import (DATA_AXES, axis_sizes,
                                              check_shardable, data_rows,
                                              shard_model)
from repro_torch.kernels.common import REPO_ROOT, Refused
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.hymba import HymbaLM
from repro_torch.models.transformer import DenseLM
from repro_torch.models.zoo import build_model
from repro_torch.training.optimizer import init_state
from repro_torch.training.train_loop import make_train_step

RESULTS_DIR = REPO_ROOT / "experiments" / "dryrun_torch"
MESHES = {"gpu32x8": False, "gpu2x32x8": True}  # name -> multi_pod


def pick_microbatches(cfg: ArchConfig, shape: InputShape, sizes: Dict[str, int]) -> int:
    """The reference's rule: split the global batch so that a data shard
    runs at most 2 sequences a microbatch (1 for the archs with an SSM
    state), over the ``pod`` x ``data`` ways."""
    data_ways = math.prod(sizes.get(a, 1) for a in DATA_AXES)
    per_shard = max(shape.global_batch // data_ways, 1)
    per_mb = 1 if cfg.ssm_state else 2
    mb = max(per_shard // per_mb, 1)
    while shape.global_batch % mb:
        mb -= 1
    return mb


@contextlib.contextmanager
def fake_world(world: int):
    """torch's fake process group of ``world`` ranks, this process rank 0:
    collectives run and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta(*shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _local(t):
    return getattr(t, "_local_tensor", t)


def count_step(cfg: ArchConfig, shape: InputShape, mesh,
               num_microbatches: Optional[int] = None) -> dict:
    """Build ``cfg`` on the meta device, shard it at ``mesh`` and count one
    step of ``shape`` (``num_microbatches`` for a train step defaults to
    ``pick_microbatches``).  Returns {"op_stats", "memory", "trace",
    "microbatches", "rows"}; raises what ``check_shardable`` or the
    kernels' checks raise."""
    check_shardable(cfg, mesh)
    model = shard_model(build_model(cfg, device="meta"), mesh)
    sizes = axis_sizes(mesh)
    params = dict(model.named_parameters())
    B, S = shape.global_batch, shape.seq_len
    # the VLM's image embeddings or the enc-dec's audio frames, B rows
    extra = {name: _meta(*dims, dtype=dtype) for name, (dims, dtype)
             in getattr(model, "extra_inputs", lambda b: {})(B).items()}
    mb = None
    if shape.kind == "train":
        mb = num_microbatches or pick_microbatches(cfg, shape, sizes)
        step = make_train_step(model, num_microbatches=mb)
        state = init_state(params)
        batch = {"tokens": _meta(B, S), "labels": _meta(B, S), **extra}
        args = [*params.values(), state.step, *state.m.values(),
                *state.v.values(), *batch.values()]
        rows = data_rows(batch["tokens"], mesh).shape[0]

        def run():
            return step(state, batch)
    elif shape.kind == "prefill":
        tokens = data_rows(_meta(B, S), mesh)
        inputs = {name: data_rows(t, mesh) for name, t in extra.items()}
        args, rows = [*params.values(), tokens, *inputs.values()], tokens.shape[0]
        # a dense decoder's or hymba's output cache of the prompt's S
        # positions in the layout of its decode cache (``kv_layout``: under
        # "seq" each rank keeps its block of them, and of hymba's rings)
        cache_len = {"max_len": S} if isinstance(model, (DenseLM, HymbaLM)) else {}

        def run():
            return model.prefill(tokens, **inputs, **cache_len)
    else:
        tokens = data_rows(_meta(B), mesh)
        rows = tokens.shape[0]
        cache = model.init_cache(rows, S)
        leaves = cache.values() if isinstance(cache, dict) else cache
        args = [*params.values(), *leaves, tokens]

        def run():
            # the last position of a full cache (under the "seq" layout,
            # every rank attends over its whole block)
            return model.decode_step(cache, tokens, S - 1)
    with OpCounter([_local(t) for t in args]) as counter:
        result = run()
        stats = counter.stats()
    del result
    memory = stats.pop("memory")
    return {"op_stats": stats, "memory": memory, "trace": counter.trace(),
            "microbatches": mb, "rows": rows}


def collectives(stats: dict) -> dict:
    """A record's ``collectives``: ``op_stats``' count and bytes by kind,
    and their ``total_bytes``, as the reference's record keeps them."""
    return dict(stats["collectives"], total_bytes=stats["total_collective_bytes"])


def run_cell(arch: str, shape_name: str, mesh_name: str,
             out_dir: Path = RESULTS_DIR, force: bool = False) -> dict:
    """One cell's record, written to ``out_dir`` (read back from there
    unless ``force``)."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    multi_pod = MESHES[mesh_name]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cell = f"{arch}__{shape_name}__{mesh_name}"
    out_path = out_dir / f"{cell}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    base = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "mesh": mesh_name}
    if shape not in shapes_for(cfg):
        result = dict(base, status="skipped",
                      reason="long_500k requires sub-quadratic attention "
                             "(the reference's skip list)")
        out_path.write_text(json.dumps(result, indent=2))
        return result
    t0 = time.perf_counter()
    world = 512 if multi_pod else 256
    try:
        with fake_world(world):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            try:
                check_shardable(cfg, mesh)
            except (NotImplementedError, ValueError) as exc:
                result = dict(base, num_devices=world, status="refused",
                              reason=f"{type(exc).__name__}: {exc}")
            else:
                counted = count_step(cfg, shape, mesh)
                trace_dir = out_dir / "trace"
                trace_dir.mkdir(exist_ok=True)
                (trace_dir / f"{cell}.json.gz").write_bytes(
                    gzip.compress(json.dumps(counted["trace"]).encode()))
                stats = counted["op_stats"]
                result = dict(base, num_devices=world, status="ok",
                              count_s=round(time.perf_counter() - t0, 2),
                              microbatches=counted["microbatches"],
                              rows_per_gpu=counted["rows"],
                              memory=counted["memory"],
                              collectives=collectives(stats),
                              op_stats=stats)
    except Refused as exc:
        result = dict(base, num_devices=world, status="refused",
                      reason=f"Refused: {exc}")
    except Exception as exc:  # recorded, as the reference records its failures
        result = dict(base, num_devices=world, status="error",
                      error=f"{type(exc).__name__}: {exc}",
                      traceback=traceback.format_exc()[-3000:])
    out_path.write_text(json.dumps(result, indent=2))
    return result


def cells(all_cells: bool, arch: Optional[str], shape: Optional[str]):
    if all_cells:
        return [(name, sh.name) for name, cfg in ASSIGNED.items()
                for sh in shapes_for(cfg)]
    if not (arch and shape):
        raise SystemExit("give --arch and --shape, or --all")
    return [(arch, shape)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the two-pod mesh only")
    ap.add_argument("--single-pod", action="store_true",
                    help="the one-pod mesh only")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", type=Path, default=RESULTS_DIR)
    args = ap.parse_args(argv)
    meshes = []
    if args.single_pod or not args.multi_pod:
        meshes.append("gpu32x8")
    if args.multi_pod or not args.single_pod:
        meshes.append("gpu2x32x8")
    for arch, shape in cells(args.all, args.arch, args.shape):
        for mesh_name in meshes:
            r = run_cell(arch, shape, mesh_name, args.out, force=args.force)
            status = r["status"]
            if status == "ok":
                st, mem = r["op_stats"], r["memory"]
                extra = (f"count={r['count_s']}s flops={st['total_flops']:.3e} "
                         f"bytes={st['total_bytes']:.3e} "
                         f"coll={r['collectives']['total_bytes']:.3e}B "
                         f"peak={mem['peak_bytes'] / 2**30:.2f}GiB")
            else:
                extra = r.get("reason", r.get("error", ""))[:160]
            print(f"[{time.strftime('%H:%M:%S')}] {arch} {shape} {mesh_name}: "
                  f"{status} {extra}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
