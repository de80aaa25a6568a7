#!/usr/bin/env python3
"""Serve a model sharded over several cards of one host and hold it to
the same model served unsharded on one card.

    python3 shard_probe.py [--ways 4] [--arch hymba-1.5b]

Needs ``--ways`` CUDA cards, the CUDA toolkit's ``nvcc`` and this
checkout's ``src/repro_torch``; builds the attention kernels into
``build/`` first.  One process per card joins an NCCL group over
``tcp://localhost`` and a (1, ways) mesh over (data, model).  In f32,
then in bf16, ``--arch`` (hymba-1.5b by default, whose window, and 5 KV
heads over 4 ways, take the "seq" cache layout: every KV head over a
block of the full layers' positions and of the window rings' indices; a
dense decoder such as qwen2.5-3b, whose 2 KV heads do not divide into 4
ways, takes it too, over a block of the positions) is built at
full width and depth with weights drawn from ``chip_smoke.SEED`` on
every card alike (``chip_smoke.seeded_model``); rank 0 first serves
``chip_smoke.SHARD_REQUESTS`` requests of its engine phase,
``chip_smoke.SHARD_NEW`` tokens each, unsharded
(``chip_smoke._engine_serve``) and prefills the first request's prompt,
then every rank shards the model (``shard_model``) and does the same.
Rank 0 prints one JSON line per dtype: whether the sharded tokens equal
the unsharded ones (and where each request's first differ), whether the
ranks agree, the prefill logits' largest error over their scale (and,
after an f32 run, the unsharded run's against the f32 one's), each
rank's kernel launches, wall seconds and decode step ms, and each rank's
attention call (its KV heads, query heads with padding, and the query
heads it owns, from ``sharding.attention_share``) and its cache layout
(the model's ``kv_layout``: the KV heads and positions of its engine's
cache, and of hymba's rings their indices); then a line with the
seconds and ``ok``, and the card's ``nvidia-smi`` line.  It exits
non-zero unless every rank launched the flash and decode kernels as
often as the unsharded run, the ranks agree, and the f32 run's tokens
equal the unsharded run's.  (In bf16 each rank's partial products are
rounded to bf16 before they are summed over ``model``, where the
unsharded product rounds once, so greedy tokens may part at a near tie;
that run is reported, not held.)
"""
from __future__ import annotations

import argparse
import json
import socket
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "hymba-1.5b"  # the default --arch
# f32 first: its tokens are held; bf16's are reported (see above)
DTYPES = ("float32", "bfloat16")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _first_differences(tokens: dict, other: dict) -> dict:
    """Per request, the first new token at which two runs differ (None
    where all are equal)."""
    return {r: next((i for i, (a, b) in enumerate(zip(tokens[r], other[r])) if a != b),
                    None) for r in tokens}


def rank_main(rank: int, ways: int, port: int, arch: str, queue) -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import attention_share, shard_model
    from repro_torch.kernels import common
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=ways, rank=rank, device_id=dev)
    try:
        mesh = make_mesh((1, ways), ("data", "model"))
        cfg = get_config(arch)
        runs = []
        for dtype in DTYPES:
            model = cs.seeded_model(torch, np, cfg, dev, build_model,
                                    getattr(torch, dtype))
            serve, _ = cs._engine_serve(torch, np, model, dev, common)
            prompt = cs.rwkv_prompts(np, cfg)[0]
            plain = None
            if rank == 0:
                logits = model.prefill(torch.as_tensor(prompt[None]))[0].float()
                plain = serve(), logits
            dist.barrier()
            shard_model(model, mesh)
            attn = model.layers[0].attn
            share = attention_share(attn["wq"], attn["wk"], cfg)
            logits = model.prefill(torch.as_tensor(prompt[None]))[0].float()
            tokens, wall, launches, steps, step_ms = serve()
            # the engine's KV cache for one slot (none in a recurrent state)
            cache = model.init_cache(1, 4096)
            leaf = cache.get("k_full") if isinstance(cache, dict) else cache[0]
            ring = cache.get("k_swa") if isinstance(cache, dict) else None
            run = {"dtype": dtype, "tokens": tokens, "wall_s": wall,
                   "launches": launches, "decode_steps": steps, "step_ms": step_ms,
                   "call": {"kv_heads": share.kv_heads,
                            "query_heads": share.kv_heads * share.group,
                            "own_query_heads": cfg.num_heads / ways,
                            "runs": [n for _, n in share.runs] or None,
                            # a dense decoder's or hymba's; the other
                            # families keep "heads"
                            "kv_layout": (model.kv_layout() if hasattr(model, "kv_layout")
                                          else "heads"),
                            "cache_kv_heads": None if leaf is None else leaf.shape[2],
                            "cache_positions": None if leaf is None else leaf.shape[3],
                            "ring_indices": None if ring is None else ring.shape[3]}}
            del cache, leaf, ring
            if plain is not None:
                (tokens_p, wall_p, launches_p, steps_p, step_ms_p), logits_p = plain
                run["plain"] = {"tokens": tokens_p, "wall_s": wall_p,
                                "launches": launches_p, "decode_steps": steps_p,
                                "step_ms": step_ms_p}
                run["prefill_logits_rel_err"] = float(
                    (logits - logits_p).abs().max() / logits_p.abs().max())
                if runs:  # bf16's unsharded run against f32's: its own noise
                    run["plain_vs_f32_rel_err"] = float(
                        (logits_p - f32_logits).abs().max() / f32_logits.abs().max())
                f32_logits = logits_p
            runs.append(run)
            del model
            torch.cuda.empty_cache()
        queue.put((rank, runs))
    except Exception as exc:  # reported to the parent, which fails the run
        import traceback

        queue.put((rank, traceback.format_exc()))
        raise SystemExit(1) from exc
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ways", type=int, default=4, help="the cards to use")
    ap.add_argument("--arch", default=ARCH, help="the model to serve")
    args = ap.parse_args(argv)
    import multiprocessing

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import common

    # built once here, before the ranks load them
    common.build(("flash_attention", "decode_attention"))
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=rank_main, args=(r, args.ways, port, args.arch, queue))
             for r in range(args.ways)]
    for p in procs:
        p.start()
    got = {}
    try:
        # every rank's result, or the first rank's traceback (the others
        # may then wait in a collective, and are stopped)
        while len(got) < len(procs):
            rank, value = queue.get(timeout=600)
            got[rank] = value
            if isinstance(value, str):
                break
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    bad = {r: v for r, v in got.items() if isinstance(v, str)}
    if bad:
        for r, tb in sorted(bad.items()):
            print(f"rank {r}:\n{tb}", file=sys.stderr)
        return 1
    kernels = ("flash_attention", "decode_attention")
    results = []
    for i, dtype in enumerate(DTYPES):
        zero = got[0][i]
        plain = zero["plain"]
        result = {
            "probe": "shard", "arch": args.arch, "mesh": [1, args.ways],
            "dtype": dtype, "requests": len(plain["tokens"]),
            "new_tokens": cs.SHARD_NEW,
            "tokens_equal": all(got[r][i]["tokens"] == plain["tokens"] for r in got),
            "first_differing_token": _first_differences(zero["tokens"], plain["tokens"]),
            "ranks_agree": all(got[r][i]["tokens"] == zero["tokens"] for r in got),
            "prefill_logits_rel_err": zero["prefill_logits_rel_err"],
            "plain_vs_f32_rel_err": zero.get("plain_vs_f32_rel_err"),
            "wall_s": plain["wall_s"], "step_ms": plain["step_ms"],
            "decode_steps": plain["decode_steps"],
            "launches": {k: plain["launches"][k] for k in kernels},
            "ranks": [{"rank": r, "wall_s": got[r][i]["wall_s"],
                       "step_ms": got[r][i]["step_ms"],
                       "launches": {k: got[r][i]["launches"][k] for k in kernels},
                       **got[r][i]["call"]} for r in sorted(got)]}
        result["launches_equal"] = all(
            got[r][i]["launches"][k] == plain["launches"][k] > 0
            for r in got for k in kernels)
        results.append(result)
        print(json.dumps(result), flush=True)
    ok = all(r["launches_equal"] and r["ranks_agree"] for r in results) and all(
        r["tokens_equal"] for r in results if r["dtype"] == "float32")
    print(json.dumps({"probe": "shard", "seconds": time.perf_counter() - t0, "ok": ok}))
    print(cs.nvidia_smi_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
