#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one card and check it end to end.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit's ``nvcc`` and this checkout's
``src/repro_torch``.  It drives six serving paths, llama-3.1-8b through
the two attention kernels, rwkv6-7b through the two WKV6 kernels (the chunked
tensor-core kernel for bf16 prefill, the scan for decode and f32), the MoE
decoders olmoe-1b-7b and granite-moe-3b-a800m through the attention
kernels and the routed experts of ``models/moe.py``, hymba-1.5b through the
attention kernels' sliding-window mode and ring decode beside its Mamba
heads, the cross-attention decoders llama-3.2-vision-11b and
seamless-m4t-large-v2 through both attention kernels over their image and
audio caches, and rag_reranker's two encoders through the flash kernel's
non-causal mode, then trains every family (qwen2.5-3b, the encoders,
hymba-1.5b, seamless-m4t-large-v2, the VLM, gemma-7b at head dim 256 and
olmoe-1b-7b through the flash forward and its backward kernel, rwkv6-7b
through the chunked WKV6 forward and the WKV6 backward kernel), and
prints one JSON object per phase:

1. ``device``: the card's name and ``nvidia-smi`` name/power limit;
2. ``build``: the six kernels compiled from ``src/repro_torch/csrc`` for
   sm_90a, in parallel, with nvcc's register/spill report (the flash
   backward's D = 256 and f32 entries must not spill); then one
   ``sass`` line per kernel library with its HGMMA, HMMA and FFMA
   instructions per entry (``cuobjdump -sass``), which fails the run if a
   bf16 attention entry, the chunked WKV6 entry or a dQ or dK/dV entry of
   the attention backward has no tensor-core instruction;
3. ``kernel_checks``: the attention kernels against their plain PyTorch
   versions on the card at the llama path's shapes, then the encoders'
   non-causal and head-dim-32 shapes (an f32 case also through the
   forward with its LSE, the training forward; within TOL, and each
   output row within ROW_REL_TOL of its RMS; the decode kernel also in
   its LSE mode over the two halves of each cache, merged as the ranks
   of a "seq" cache merge, against the whole call, the LSE within
   LSE_TOL), with times (CUDA
   events, and device time through a CUDA graph), the bound of each call
   and one PyTorch library call as a yardstick, timed the same two ways;
4. ``model_check``: full-width llama-3.1-8b (seeded random weights, in
   f32 and in bf16), a 1000-token prefill and 8 decode steps through the
   kernels and through the plain versions, with their largest logit
   difference;
5. ``engine``: the serving engine at full width and depth serving 16
   requests (8 share a 1024-token prefix), with the kernels' launch counts
   during that run (one flash launch per layer and whole-prompt prefill,
   one decode launch per layer and model decode call) and a
   ``torch.profiler`` window of three batched decode steps;
6. with the llama model freed, ``kernel_checks`` of the WKV6 kernels at
   the rwkv path's shapes, each call on the kernel ``wkv6_op`` routes it
   to (no single PyTorch call computes WKV6), each output and state row
   held to ROW_REL_TOL as well as TOL, with strong and slow decays; then
   ``model_check`` and ``engine`` for rwkv6-7b: 16 requests of 256-2048
   prompt tokens, no prefix reuse (a recurrent state has no prefix to
   copy), every prefill through the chunked kernel (one launch per layer
   and request) and every decode step through the scan (one per layer and
   step);
7. with rwkv6-7b freed, ``kernel_checks`` of the attention kernels at
   the MoE decoders' heads (olmoe: H = KV = 16, D = 128; granite-moe:
   H = 24, KV = 8, D = 64), then ``model_check`` for olmoe-1b-7b at full
   width and depth with its routing replayed (each run takes the experts
   the f32 plain run chose; the free runs' routing agreement is printed),
   its ``engine`` run (the llama traffic, exact launch counts), and
   ``model_check`` and a short ``engine`` run (8 requests of 16 tokens)
   for granite-moe-3b-a800m;
8. with the MoE models freed, ``kernel_checks`` of the attention kernels at
   hymba-1.5b's heads (H = 25, KV = 5, D = 64: flash at window 1024 over
   S = 2048 and S = 1500, at window 0, and in f32; decode over a
   1024-entry ring and a 4096-entry cache, and the ring's 8 blocks of 128
   indices, as 8 model ways hold it under the "seq" layout, each called in
   the LSE mode at its part of every row's valid prefix and merged
   against the whole call), then ``model_check`` for
   hymba-1.5b at full width and depth over a 1500-token prompt (past the
   window and not a multiple of it, so the decode steps write into a
   wrapped ring) and its ``engine`` run: the rwkv traffic, no prefix reuse,
   exactly 32 flash launches per prefill and 32 decode launches per model
   decode call;
9. with hymba freed, ``kernel_checks`` of the attention kernels at the
   cross-attention decoders' shapes (the VLM's cross prefill over 1601
   image entries and decode over them; seamless-m4t's encoder over 1024
   frames, causal self-attention and cross-attention over the frames at
   H = KV = 16, D = 64, and decode over both its caches; one f32 cross
   case), then, one model at a time, ``model_check`` for
   llama-3.2-vision-11b (every cross-layer gate set to a seeded nonzero
   value, printed: the reference's zero gates would hide the
   cross-attention) and seamless-m4t-large-v2 at full width and depth, with
   seeded stub image or audio inputs, and ``generate``: 8 requests of 512
   prompt tokens through ``launch.serve_model.generate`` (one prefill, 64
   greedy decode steps of the batch), with prefill and decode step ms,
   tokens/s, peak memory, exact launch counts (flash 48 per VLM prefill, 72
   per seamless prefill; decode 48 per step on both) and a
   ``torch.profiler`` window of three decode steps;
10. with those freed, ``encoder_check`` for e5-base-v2 and
   reranker-minilm (full width and depth, seeded weights, f32 and bf16,
   a 512- and a 137-token prompt; the pooled embeddings through the
   kernel and through the plain version), then ``encode``: rag_reranker's
   encoder traffic, 16 queries embedded by e5-base-v2 and 8 reranks each
   by reranker-minilm, one ``prefill`` per call, with per-model calls/s,
   tokens/s, mean and p99 ms per call, peak memory, the flash launch
   count (one per layer and call) and a ``torch.profiler`` breakdown of
   one query's calls;
11. with the encoders freed, ``kernel_checks`` of the attention backward
   (``flash_attention_bwd``: dq, dk, dv and the forward's lse against the
   plain versions in f32, within TOL and ROW_REL_TOL, at the train shape
   B=2, S=2048, H=16, KV=2, D=128, a ragged S=1000, hymba's window, the
   encoders' non-causal D=64 and D=32, the VLM's cross shape, seamless's
   encoder (1024 x 1024) and cross (512 over 1024) shapes at B=4, the
   train_4k length B=1, S=4096, gemma-7b's D=256 (B=2, S=2048, H=KV=16,
   a ragged S=1000, grouped heads H=16, KV=4 under a window of 512, and
   non-causal 512 over 1024), and the f32 kernels at D=128 and 256 over
   2 x 2048, D=64 under a window and seamless's cross shape, held to the
   f32 TOL; two calls must give bit-equal gradients;
   each with its dK/dV plan, graph ms, bound and SDPA's backward ms, and
   the forward's graph ms beside SDPA's forward and its bound), and
   of the WKV6 backward (``wkv6_bwd``: dr, dk, dv, dlogw, du and dstate
   against ``wkv6_bwd_ref`` in f64, within TOL and ROW_REL_TOL, dlogw
   also as a whole (its error's norm within ROW_REL_TOL of its norm), at
   rwkv6-7b's train shape B=2, S=2048, H=64, D=64, a ragged S=1000, the
   strong and slow decays, one partial chunk (S=37) and ``rwkv_grad``'s
   B=4; two calls bit-equal; graph ms, the bytes bound, the chunked
   products' and the f32 operations' times, and the two plain versions'
   row errors in f32);
   then for each of ``TRAIN_RUNS``, one model at a time: ``train_parity``,
   one train step at full width and 2 layers (the VLM: one group of 5
   self layers and a cross layer) through the kernels and through their
   plain versions, held against an f32 plain run (loss within TOL, each
   gradient's RMS error within BF16_ERR_RATIO of the plain bf16 run's, no
   gradient zero; qwen2.5-3b and gemma-7b also in f32 through the
   kernels, loss and each gradient within the f32 TOL of the f32 plain
   run; olmoe-1b-7b's runs replay the f32 plain step's experts, and each
   bf16 run's free routing agreement is printed); then ``train``, bf16
   seeded weights and AdamW on the
   reference's synthetic corpus, with seeded stub image or audio inputs
   and nonzero VLM gates (the steps of TRAIN_RUNS): qwen2.5-3b at full
   width and depth for 30 steps of 8 x 2048 tokens in 4 microbatches,
   e5-base-v2 and reranker-minilm (15 of 16 x 512), hymba-1.5b (10 of 2 x
   2048, past its window), seamless-m4t-large-v2 (15 of 8 x 512 over 1024
   frames a row, 2 microbatches), the VLM at full width and 2 of its 8
   groups (15 of 4 x 512 over 1601 image embeddings; the f32 moments of
   all 11.47 B weights would not fit) and rwkv6-7b at full width and 8 of
   its 32 layers (20 of qwen's 8 x 2048 in 4 microbatches), gemma-7b and
   olmoe-1b-7b at full width and 8 layers (30 of 4 x 2048 in 2
   microbatches), one
   ``train_step`` line per step (loss, ms, tokens/s, grad norm, model
   FLOPs share), peak memory, a ``torch.profiler`` window of one step
   (busy share, the backward kernel's ms); a run fails unless every loss
   is finite, the last 5 losses' mean is under 0.75x the first 5's, and
   every step launches exactly ``train_launches``: 2 forwards and 1
   backward per attention call (WKV6 call, for rwkv) and microbatch (qwen:
   288 and 144; rwkv: 64 and 32); then ``vlm_grad`` and ``rwkv_grad``: one
   loss and backward at full depth, the VLM's 48 layers over 4 x 512
   tokens (96 forwards and 48 backwards) and rwkv6-7b's 32 over 4 x 2048
   (64 and 32), with the loss, grad norm and peak memory;
12. ``train_resume``: checkpoint, resume and int8 compression of
   qwen2.5-3b's training at full width and PARITY_LAYERS layers (4 x 2048
   tokens, one microbatch): run U takes 8 steps and saves a checkpoint
   (``training.checkpoint``, about 5.6 GB) after 4 into a temporary
   directory under ``build/``, U2 repeats U, R (a model drawn from another
   seed) restores it and takes steps 4-7, C takes 8 steps with
   ``compress=True``; it fails unless the restored weights, moments and
   step, U2 and R (every loss, the final weights and moments) are
   bit-equal to U's, every step launches exactly ``train_launches``, C's
   losses are finite and ``compress_tree`` of the tied embedding's gradient
   is bit-equal on the card and on the CPU; with the checkpoint's bytes,
   save and restore seconds and GB/s, the compression's ms and peak memory;
13. ``shard``: the per-GPU bytes of every dense config's bf16 weights and
   f32 moments at model ways 1, 2, 4 and 8 on one 8-GPU host, from the
   placement tables (``distributed.sharding``) beside the cost model's
   ``min_fraction_units`` (printed, not checked); then, over
   ``launch.mesh.single_device_mesh()`` (the (1, 1) mesh of a one-rank
   NCCL process group, every weight a DTensor), each run unsharded and
   then sharded in place, one model on the card at a time: at full width
   and depth, llama-3.1-8b and olmoe-1b-7b serve the engine phase's first
   4 requests and rwkv6-7b the rwkv engine phase's, 16 new tokens each,
   through ``ServingEngine``, hymba-1.5b its engine phase's first 4 (the
   hybrid cache, no prefix reuse), and llama-3.2-vision-11b (gates seeded
   nonzero) and seamless-m4t-large-v2 ``generate`` 16 greedy steps from the
   generate phase's batch (8 prompts of 512 tokens over seeded stub
   inputs), each of which must give the same tokens and the same launch
   counts of every kernel (flash and decode; rwkv6-7b's wkv6_chunk and
   wkv6_scan) with only plain tensors reaching the kernel wrappers, its
   wall seconds and step ms printed beside the unsharded run's; then
   qwen2.5-3b at full width and 4 layers, rwkv6-7b at full width and 8
   of its 32 layers (4 x 2048 tokens) and hymba-1.5b at full width and its
   layers 0-3 (a full-attention layer and three window layers; 2 x 2048
   tokens, past the window) each take 3 train steps (one
   microbatch) unsharded and 3 sharded with ZeRO-1 moments from the same
   seed, which must be bit-equal in every loss, weight and moment, with
   exactly ``train_launches`` in every step; qwen2.5-3b's sharded run
   saves a checkpoint after its first step (gathered from the DTensors,
   written once at the unsharded shapes) and a sharded model from another
   seed restores it, each DTensor its own slice, and takes steps 1-2,
   which must be bit-equal to the uninterrupted run; the summary line sums each
   kernel's launches over the sharded runs (the ``kernels`` line's
   ``launches_shard``) and lists them by run;
14. ``dryrun``: the dry-run's counts (``launch.dryrun.count_step``, the
   meta device under a fake process group, in a process of its own
   started after the build) held to the card over the ``shard`` phase's
   (1, 1) mesh: qwen2.5-3b's train step of TRAIN_RUNS[0] (8 x 2048 tokens,
   4 microbatches) must call each kernel exactly as often as the card
   launches it in each of 3 measured steps (288 flash forwards, 144
   backwards) and count a peak within 10% of ``max_memory_allocated``;
   the counted FLOPs over the best step time as TFLOP/s and a share of
   989, beside the ``nvidia-smi`` line; llama-3.1-8b's prefill of 1000
   tokens, the same call equality; then the production cell qwen2.5-3b
   ``train_4k`` at ``gpu32x8`` (256 GPUs) counted: its per-GPU peak and
   collective bytes;
15. ``plan``: Scepsy's planner
   (``repro_torch.core.scepsy.deploy``) plans beam_search and rag_reranker
   at 0.4 req/s on one 8-GPU H100 host and on four, each plan printed with
   its allocations, predicted latency and throughput and its placement,
   which must validate, keep every TP group inside one NVLink domain and
   fit every model in the h100 class's HBM (itself within the card's
   memory); ``deploy_multi(online=True)`` of both on four hosts, its
   controller stepped over arrivals at the planned rate and then at 2.5x
   beam_search's (at least one feasible re-plan), and one traced
   ``ClusterDriver`` run of rag_reranker (every request completed, its
   spans counted); the host's Hopper tile plan of every flash shape the kernel
   checks ran against the plan the kernel library reports (``flash_attention_plan``)
   with the card's SM count; and the cost model's decode-step and prefill
   times (h100, tp=1) at the llama, rwkv, olmoe and hymba engine phases'
   batches, contexts and prompts beside those phases' measured times
   (printed, not checked);

then a ``wall`` line (the script's seconds so far, beside qwen2.5-3b's
``train`` tokens/s, so that a slow host shows as one), the ``kernels``
summary line, the card's ``nvidia-smi`` line and, last,
``{"ok": true, "device": ...}``.  Every phase line carries ``t_s``, the
script's seconds when it was printed.  Any failed check exits non-zero
before the last line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from typing import NamedTuple, Optional

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet: HBM bandwidth, dense bf16 tensor-core rate, f32 rate
# on the CUDA cores (the f32 kernels do not use the tensor cores)
BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
# the rate assumed for the chunked WKV6 kernel's exponentials (reported
# beside its bound, not part of it): 16 results per clock per SM on the SFU
# (CUDA's throughput table for compute capability 9.0), 132 SMs, 1.98 GHz
EXP2_PER_S = 16 * 132 * 1.98e9
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# beside TOL, each attention output row (the D values of one query head)
# and each WKV6 output and state row is held to a bound scaled to that row: its largest error against the
# plain version computed in f32 (no output rounding), over the row's RMS
# there.  Inputs of randn * 0.5 give |out| ~ 0.5 / sqrt(len), below TOL on
# long rows, so TOL alone would pass a kernel that dropped part of a long
# row.  A row whose reference is all zeros (length 0) must be exactly zero.
ROW_REL_TOL = 0.05
# the full-width model check: kernels vs plain versions in f32 weights,
# and in bf16 the kernel path's error over the plain path's, each
# against the f32 plain run (see model_check)
MODEL_REL_TOL_F32 = 1e-3
BF16_ERR_RATIO = 1.25

ARCH = "llama-3.1-8b"
RWKV_ARCH = "rwkv6-7b"
MOE_ARCHS = ("olmoe-1b-7b", "granite-moe-3b-a800m")
HYMBA_ARCH = "hymba-1.5b"
# past hymba's 1024-token window and not a multiple of it: prefill masks by
# the window and the decode steps write into a wrapped ring
HYMBA_PROMPT = 1500
CROSS_ARCHS = ("llama-3.2-vision-11b", "seamless-m4t-large-v2")
# generate: requests, prompt tokens and new tokens of the cross-attention
# decoders' batch
GENERATE = (8, 512, 64)
ENCODER_ARCHS = ("e5-base-v2", "reranker-minilm")
SEED = 0


class SmokeFailure(Exception):
    pass


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line with the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, target_ms: float = 60.0) -> float:
    """Mean time of ``fn`` on the card by CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = (time.perf_counter() - t0) * 1e3
    iters = int(min(200, max(3, target_ms / max(once, 1e-3))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, calls: int = 20) -> float:
    """Device time of ``fn`` per call, without the host's launch cost:
    ``calls`` calls captured in one CUDA graph, replayed and timed by CUDA
    events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * calls)


def row_rel_err(torch, out, truth, rows=None) -> float:
    """Largest over rows (the last dim) of max |out - truth| / rms(truth);
    a row whose truth is all zeros must be exactly zero.  ``rows``, a mask
    broadcast over the leading dims, picks the rows held (all by
    default)."""
    err = (out.float() - truth).abs().amax(-1)
    rms = truth.square().mean(-1).sqrt()
    rel = torch.where(rms > 0, err / rms.clamp_min(1e-30),
                      torch.where(err > 0, float("inf"), 0.0))
    if rows is not None:
        rel = rel[rows.expand_as(rel)]
    return float(rel.max()) if rel.numel() else 0.0


def bound(ops: float, nbytes: float, dtype: str):
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ptxas_summary(text: str):
    """Registers, static shared memory, stack and spill bytes of each kernel
    entry in nvcc -Xptxas -v.  The attention kernels take all their shared
    memory dynamically, which ptxas does not see: their static figure is 0;
    the WKV6 kernel's is static."""
    entries = []
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entries.append({"entry": line.split("'")[1], "smem_bytes": 0,
                            "stack_bytes": 0})
        elif "spill stores" in line and entries:
            entries[-1]["spill_store_bytes"] = int(line.split()[4])
        elif "Used" in line and "registers" in line and entries:
            used = line.split("Used")[1]
            entries[-1]["registers"] = int(used.split("registers")[0])
            for part in used.split(","):
                words = part.split()
                if part.strip().endswith(" smem"):
                    entries[-1]["smem_bytes"] = int(words[0])
                elif "stack size" in part:
                    entries[-1]["stack_bytes"] = int(words[0])
    return entries


SASS_OPS = ("HGMMA", "HMMA", "FFMA")
TENSOR_CORES = ("HGMMA", "HMMA")
# entries that must run on the tensor cores: (a name they contain, the
# instructions of which each such entry needs one): the bf16 attention
# kernels, the chunked WKV6 kernel and the attention backward's dQ and dK/dV
# kernels: one persistent wgmma kernel for both at D = 64, 128 and 256, and
# mma.sync at D = 32; and the WKV6 backward's two kernels, the chunks' walks
# and every chunk on its own
TENSOR_CORE_ENTRIES = {
    "flash_attention": (("flash_fwd_tc", TENSOR_CORES),),
    "decode_attention": (("decode_split", TENSOR_CORES),),
    "wkv6_chunk": (("wkv6_chunk_kernel", TENSOR_CORES),),
    "flash_attention_bwd": (("bwd_dq_dkdv_tcILi64E", ("HGMMA",)),
                            ("bwd_dq_dkdv_tcILi128E", ("HGMMA",)),
                            ("bwd_dq_dkdv_tcILi256E", ("HGMMA",)),
                            ("bwd_dq_mmaILi32E", ("HMMA",)),
                            ("bwd_dkdv_mmaILi32E", ("HMMA",))),
    "wkv6_bwd": (("wkv6_bwd_states", TENSOR_CORES), ("wkv6_bwd_chunk", TENSOR_CORES))}


# entries whose nvcc report must show no spill: the flash backward's
# D = 256 entries (the persistent wgmma kernel bwd_dq_dkdv_tcILi256E, its
# prep and merge) and f32 (CUDA-core) entries
NO_SPILL_ENTRIES = {"flash_attention_bwd": ("ILi256E", "3f32")}


def sass_counts(common, name: str) -> dict:
    """HGMMA, HMMA and FFMA instructions per (mangled) kernel entry of the
    built library of ``name``, from the toolkit's ``cuobjdump -sass``."""
    tool = Path(common.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return {"phase": "sass", "library": name,
                "error": "cuobjdump not found: SASS not inspected"}
    text = subprocess.run([str(tool), "-sass", str(common.library_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, entry = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            entry = line.split("Function :")[1].strip()
            counts[entry] = dict.fromkeys(SASS_OPS, 0)
        elif entry is not None:
            for op in SASS_OPS:
                if f" {op}." in line or f" {op} " in line:
                    counts[entry][op] += 1
    result = {"phase": "sass", "library": name, "entries": counts}
    markers = TENSOR_CORE_ENTRIES.get(name)
    if markers:
        ok, n = True, 0
        for marker, ops in markers:
            mine = [c for e, c in counts.items() if marker in e]
            n += len(mine)
            ok = ok and bool(mine) and all(any(c[op] > 0 for op in ops) for c in mine)
        result["tensor_core_entries"] = n
        result["ok"] = ok
    return result


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash(torch, F, ops_mod, dev, gen, B, S, H, KV, D, window, dtype,
                Sk=None, causal=True):
    """A flash call against its plain version: S query rows over Sk keys
    (Sk = S when not given), causal or not."""
    from repro_torch.kernels.flash_attention import flash_attention_ref

    dt = getattr(torch, dtype)
    Sk = S if Sk is None else Sk

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.5).to(dt)

    q, k, v = rnd(B, S, H, D), rnd(B, Sk, KV, D), rnd(B, Sk, KV, D)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def kernel():
        return ops_mod.flash_attention_op(q, k, v, window=window, causal=causal)

    def plain():
        return flash_attention_ref(qt, kt, vt, window=window, causal=causal)

    out = kernel()
    torch.cuda.synchronize()
    ref = plain().transpose(1, 2)
    truth = flash_attention_ref(qt.float(), kt.float(), vt.float(),
                                window=window, causal=causal).transpose(1, 2)
    err = (out.float() - ref.float()).abs()
    tol = TOL[dtype]
    ok_abs = bool((err <= tol + tol * ref.float().abs()).all()) and \
        bool(torch.isfinite(out).all())
    row_err = row_rel_err(torch, out, truth)
    del truth
    pos = torch.arange(S, device=dev)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    # the (query, key) pairs the call must weigh: all of them when
    # non-causal, those the causal (and window) mask keeps otherwise
    pairs = int(mask.sum()) if causal else S * Sk

    def library():
        if not causal:
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=False,
                                                  enable_gqa=True)
        if window > 0:
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    esize = q.element_size()
    # q read and o written over S rows, k and v read over Sk
    nbytes = esize * (2 * B * S * H * D + 2 * B * Sk * KV * D)
    flops = 4.0 * B * H * D * pairs
    b_ms, b_by = bound(flops, nbytes, dtype)
    kernel_graph_ms = graph_ms(torch, kernel)
    lse_check = {}
    if dtype == "float32":
        # the f32 training forward: the same output, and each row's
        # log-sum-exp against the plain version's
        from repro_torch.kernels.flash_attention.ref import flash_attention_fwd_lse_ref

        out_l, lse = ops_mod.flash_attention_fwd_lse(q, k, v, window=window,
                                                     causal=causal)
        _, lse_ref = flash_attention_fwd_lse_ref(qt, kt, vt, window=window,
                                                 causal=causal)
        lse_err = (lse - lse_ref).abs()
        lse_check = {"lse_max_abs_err": float(lse_err.max()),
                     "lse_out_equal": bool(torch.equal(out_l, out)),
                     "lse_ok": bool((lse_err <= tol + tol * lse_ref.abs()).all()),
                     "fwd_lse_graph_ms": graph_ms(torch, lambda: ops_mod.flash_attention_fwd_lse(
                         q, k, v, window=window, causal=causal))}
        ok_abs = ok_abs and lse_check["lse_ok"] and lse_check["lse_out_equal"]
    return {"kernel": "flash_attention", "dtype": dtype, **lse_check,
            "shape": {"B": B, "S": S, "Sk": Sk, "H": H, "KV": KV, "D": D,
                      "window": window, "causal": causal},
            "max_abs_err": float(err.max()), "tol": tol,
            "max_row_rel_err": row_err, "row_rel_tol": ROW_REL_TOL,
            "ok_abs": ok_abs, "ok_rows": row_err <= ROW_REL_TOL,
            "ok": ok_abs and row_err <= ROW_REL_TOL,
            "kernel_ms": cuda_ms(torch, kernel), "kernel_graph_ms": kernel_graph_ms,
            "tflops_graph": flops / kernel_graph_ms * 1e-9,
            "plain_ms": cuda_ms(torch, plain),
            "library_ms": cuda_ms(torch, library),
            "library_graph_ms": graph_ms(torch, library),
            "bound_ms": b_ms, "bound_by": b_by}


def check_decode(torch, F, ops_mod, dev, gen, H, KV, D, Smax, lens, dtype,
                 cache_dtype=None, blocks=None):
    """The decode kernel against its plain version at one shape, and its
    LSE mode (``check_decode_lse``) over the cache's halves and, with
    ``blocks``, over that many equal blocks of it."""
    from repro_torch.kernels.decode_attention import decode_attention_ref

    cache_dtype = cache_dtype or dtype
    B = len(lens)

    def rnd(*shape, dt):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.5).to(
            getattr(torch, dt))

    q = rnd(B, H, D, dt=dtype)
    kc, vc = rnd(B, KV, Smax, D, dt=cache_dtype), rnd(B, KV, Smax, D, dt=cache_dtype)
    lengths = torch.tensor(lens, device=dev, dtype=torch.int32)
    G = H // KV
    qg = q.reshape(B, KV, G, D)

    def kernel():
        return ops_mod.decode_attention_op(q, kc, vc, lengths)

    def plain():
        return decode_attention_ref(qg, kc, vc, lengths)

    out = kernel()
    torch.cuda.synchronize()
    ref = plain().reshape(B, H, D)
    truth = decode_attention_ref(qg.float(), kc.float(), vc.float(),
                                 lengths).reshape(B, H, D)
    err = (out.float() - ref.float()).abs()
    tol = TOL[dtype]
    ok_abs = bool((err <= tol + tol * ref.float().abs()).all()) and \
        bool(torch.isfinite(out).all())
    row_err = row_rel_err(torch, out, truth)
    valid = torch.arange(Smax, device=dev)[None, :] < lengths[:, None]
    attn_mask = valid[:, None, None, :]
    q4 = q[:, :, None, :]

    kl, vl = kc.to(q.dtype), vc.to(q.dtype)  # SDPA takes one dtype

    def library():
        return F.scaled_dot_product_attention(q4, kl, vl, attn_mask=attn_mask,
                                              enable_gqa=True)

    tokens = sum(min(max(n, 0), Smax) for n in lens)
    nbytes = (q.element_size() * 2 * B * H * D
              + kc.element_size() * 2 * tokens * KV * D + 4 * B)
    b_ms, b_by = bound(4.0 * H * D * tokens, nbytes, dtype)
    kernel_graph_ms = graph_ms(torch, kernel)
    lse = check_decode_lse(torch, ops_mod, q, kc, vc, lengths, out, ref, truth, tol,
                           splits=(2,) if blocks is None else (2, blocks))
    return {"kernel": "decode_attention", "dtype": dtype,
            "cache_dtype": cache_dtype,
            "shape": {"B": B, "H": H, "KV": KV, "D": D, "Smax": Smax, "lengths": lens},
            "max_abs_err": float(err.max()), "tol": tol,
            "max_row_rel_err": row_err, "row_rel_tol": ROW_REL_TOL,
            "ok_abs": ok_abs, "ok_rows": row_err <= ROW_REL_TOL,
            "ok": ok_abs and row_err <= ROW_REL_TOL and lse["ok"], "lse": lse,
            "kernel_ms": cuda_ms(torch, kernel), "kernel_graph_ms": kernel_graph_ms,
            "lse_graph_ms": lse.pop("graph_ms"),
            "gbytes_per_s_graph": nbytes / kernel_graph_ms * 1e-6,
            "plain_ms": cuda_ms(torch, plain),
            "library_ms": cuda_ms(torch, library),
            "library_graph_ms": graph_ms(torch, library),
            "bound_ms": b_ms, "bound_by": b_by}


# the LSE's tolerance, in natural-log units: the kernel and the plain
# version sum the same f32 exponentials in another order
LSE_TOL = 1e-4


def check_decode_lse(torch, ops_mod, q, kc, vc, lengths, out, ref, truth, tol,
                     splits=(2,)):
    """The decode kernel's partial-output mode, as the ranks of a "seq"
    cache call it: for each n of ``splits``, the kernel with its LSE over
    n equal blocks of the cache (the halves; 8 blocks of hymba's
    1024-entry ring, as 8 model ways hold its indices), each row at the
    part of its valid prefix that falls in each block, merged as the ranks
    merge (``sharding.merge_partials``, in block order).  Each merge is
    held to the whole call ``out`` and to the plain version ``ref`` (TOL,
    and ROW_REL_TOL against ``truth``), each block's LSE to the plain LSE
    within LSE_TOL (-inf exactly where a row has no position there), the
    whole call's LSE too, two calls bit-equal; and the graph ms of the
    whole call in the LSE mode beside the plain mode's, timed in turns
    (plain, LSE, LSE, plain), the mean of each mode's two; past the
    halves, the graph ms of one block's call (a rank's) and of the
    merge."""
    from repro_torch.distributed.sharding import merge_partials
    from repro_torch.kernels.decode_attention import decode_attention_ref

    B, H, D = q.shape
    KV, Smax = kc.shape[1], kc.shape[2]
    qg = q.reshape(B, KV, H // KV, D)
    cuts = {n: [Smax * i // n for i in range(n + 1)] for n in splits}
    parts = [(slice(0, Smax), lengths)]  # the whole cache
    for bounds in cuts.values():
        parts += [(slice(a, b), (lengths - a).clamp(0, b - a))
                  for a, b in zip(bounds[:-1], bounds[1:])]

    def call(s, n):
        return ops_mod.decode_attention_op(q, kc[:, :, s], vc[:, :, s], n,
                                           return_lse=True)

    got = [call(s, n) for s, n in parts]
    again = [call(s, n) for s, n in parts]
    torch.cuda.synchronize()
    bit_equal = all(torch.equal(a, b) for x, y in zip(got, again) for a, b in zip(x, y))
    lse_err, lse_inf_ok = 0.0, True
    for (s, n), (_, lse) in zip(parts, got):
        _, want = decode_attention_ref(qg, kc[:, :, s], vc[:, :, s], n, return_lse=True)
        want = want.reshape(B, H)
        lse_inf_ok &= bool(torch.equal(torch.isneginf(lse), torch.isneginf(want)))
        finite = torch.isfinite(want)
        if finite.any():
            lse_err = max(lse_err, float((lse[finite] - want[finite]).abs().max()))
    merges, at, ok = {}, 1, True
    for n, bounds in cuts.items():
        mine = got[at:at + n]
        at += n
        merged = merge_partials([o for o, _ in mine], [lse for _, lse in mine])
        errs = {name: (merged - other.float()).abs()
                for name, other in (("whole", out), ("plain", ref))}
        ok_abs = all(bool((e <= tol + tol * ref.float().abs()).all())
                     for e in errs.values())
        row_err = row_rel_err(torch, merged, truth)
        ok &= ok_abs and row_err <= ROW_REL_TOL and bool(torch.isfinite(merged).all())
        merges[n] = {"bounds": bounds,
                     "merged_vs_whole_max_abs_err": float(errs["whole"].max()),
                     "merged_vs_plain_max_abs_err": float(errs["plain"].max()),
                     "merged_max_row_rel_err": row_err}
        if n > 2:
            s, lens = parts[at - n]  # block 0's
            merges[n]["block_graph_ms"] = graph_ms(torch, lambda: call(s, lens))
            merges[n]["merge_graph_ms"] = graph_ms(torch, lambda: merge_partials(
                [o for o, _ in mine], [lse for _, lse in mine]))
    halves = merges.pop(2)
    return {"halves": [b - a for a, b in zip(halves["bounds"], halves["bounds"][1:])],
            "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
            "lse_neginf_where_empty": lse_inf_ok,
            **{k: v for k, v in halves.items() if k != "bounds"},
            "blocks": {str(n): m for n, m in merges.items()},
            "bit_equal": bit_equal,
            "ok": ok and lse_err <= LSE_TOL and lse_inf_ok and bit_equal,
            **lse_mode_ms(torch, ops_mod, q, kc, vc, lengths)}


def lse_mode_ms(torch, ops_mod, q, kc, vc, lengths) -> dict:
    """Graph ms of one decode call in the LSE mode and in the plain mode,
    timed in turns (plain, LSE, LSE, plain): each mode's mean, and the
    four turns."""
    def call(lse):
        return lambda: ops_mod.decode_attention_op(q, kc, vc, lengths,
                                                   return_lse=lse)

    turns = [graph_ms(torch, call(lse)) for lse in (False, True, True, False)]
    return {"graph_ms": (turns[1] + turns[2]) / 2,
            "plain_graph_ms_in_turns": (turns[0] + turns[3]) / 2,
            "graph_ms_turns": turns}


# logw = -exp(N(mean, 0.5)) per decay: the model's mild decays (~-0.4 per
# token), strong ones (~-7, as published RWKV6 weights have, where
# exp(-cum) over a chunk overflows f32) and slow ones (~-0.02, where tokens
# three sub-chunks apart still weigh ~0.4, so that every block of the
# chunked form shows in the output)
LOGW_MEAN = {"mild": -1.0, "strong": 2.0, "slow": -4.0}


def check_wkv6(torch, ops_mod, dev, gen, B, S, H, D, dtype, split=0,
               decay="mild"):
    """A WKV6 call against its plain version from a carried state, on
    (B, S, H, D) projections seen as (B, H, S, D), as the model passes them,
    through the kernel ``wkv6_op`` routes it to.  With ``split``, the
    kernel also runs as two calls over [0, split) and [split, S), the
    second updating the state in place, and both are held against the one
    plain call over the whole.  ``decay`` picks the decays (``LOGW_MEAN``).
    Beside TOL, each output row and each state row is held to ROW_REL_TOL
    against the plain version run on the same inputs in f32 (no output
    rounding)."""
    from repro_torch.analysis.op_stats import wkv6_chunk_work
    from repro_torch.kernels.rwkv6_scan import wkv6_scan_ref

    dt = getattr(torch, dtype)
    name = ops_mod.kernel_for(dt, S, D)

    def rnd(*shape, scale=0.5):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    r, k, v = (rnd(B, S, H, D).to(dt).transpose(1, 2) for _ in range(3))
    logw = (-torch.exp(rnd(B, S, H, D) + LOGW_MEAN[decay])).transpose(1, 2)
    u = rnd(H, D, scale=0.2)
    s0 = rnd(B, H, D, D, scale=0.1)

    def kernel():
        return ops_mod.wkv6_op(r, k, v, logw, u, s0)

    def plain():
        return wkv6_scan_ref(r, k, v, logw, u, s0)

    out, s1 = kernel()
    torch.cuda.synchronize()
    ref, sref = plain()
    truth, _ = wkv6_scan_ref(r.float(), k.float(), v.float(), logw, u, s0)
    if split:
        mid = s0.clone()
        a, _ = ops_mod.wkv6_op(r[:, :, :split], k[:, :, :split],
                               v[:, :, :split], logw[:, :, :split], u, mid,
                               out_state=mid)
        b, _ = ops_mod.wkv6_op(r[:, :, split:], k[:, :, split:],
                               v[:, :, split:], logw[:, :, split:], u, mid,
                               out_state=mid)
        torch.cuda.synchronize()
        out, s1 = torch.cat([a, b], dim=2), mid
    tol = TOL[dtype]
    err = (out.float() - ref.float()).abs()
    serr = (s1 - sref).abs()
    ok_abs = (bool((err <= tol + tol * ref.float().abs()).all())
              and bool((serr <= tol + tol * sref.abs()).all())
              and bool(torch.isfinite(out).all()) and bool(torch.isfinite(s1).all()))
    row_err = row_rel_err(torch, out, truth)
    state_row_err = row_rel_err(torch, s1, sref)
    # outputs that round to another bf16 value than the plain version's
    differs = float((out != ref).float().mean())
    del truth
    esize = r.element_size()
    # r, k, v read and o written in the model's dtype, logw read in f32,
    # u read, the state read and written in f32
    nbytes = (4 * esize * B * H * S * D + 4 * B * H * S * D + 4 * H * D
              + 2 * 4 * B * H * D * D)
    result = {"kernel": name, "dtype": dtype,
              "shape": {"B": B, "S": S, "H": H, "D": D, "split": split,
                        "decay": decay}}
    if name == "wkv6_chunk":
        flops, exps = wkv6_chunk_work(B, S, H, D)
        b_ms, b_by = bound(flops, nbytes, dtype)
        result.update({"exp2": exps, "exp2_ms_at_sfu_rate": exps / EXP2_PER_S * 1e3})
    else:
        # ~5 D^2 f32 operations per token and head on the CUDA cores (r S:
        # D^2 FMA; S * w + k^T v: D^2 products and FMA)
        b_ms, b_by = bound(5.0 * B * H * S * D * D, nbytes, "float32")
    ok_rows = row_err <= ROW_REL_TOL and state_row_err <= ROW_REL_TOL
    result.update({
        "max_abs_err": float(max(err.max(), serr.max())), "tol": tol,
        "max_row_rel_err": row_err, "max_state_row_rel_err": state_row_err,
        "differs_from_plain_share": differs,
        "row_rel_tol": ROW_REL_TOL, "ok_abs": ok_abs, "ok_rows": ok_rows,
        "ok": ok_abs and ok_rows, "kernel_ms": cuda_ms(torch, kernel),
        # where the host's launch cost exceeds the kernel's (S=1, S=77)
        # kernel_ms measures the host; this is the device alone
        "kernel_graph_ms": graph_ms(torch, kernel),
        "plain_ms": cuda_ms(torch, plain), "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by})
    return result


def check_wkv6_bwd(torch, ops_mod, dev, gen, B, S, H, D, decay="mild"):
    """The WKV6 backward kernel against its plain version: bf16 r, k, v
    and dO as (B, S, H, D) projections seen as (B, H, S, D), as the model
    passes them, f32 logw (``LOGW_MEAN[decay]``), u and a nonzero carried
    state; the kernel's dr, dk, dv, dlogw, du and dstate against
    ``wkv6_bwd_ref`` on the same inputs in f64, each held to TOL and, row by
    row, to ROW_REL_TOL of the row's RMS, and a second call bit-equal to the
    first (nothing atomic).  dlogw is also held as a whole: the norm of its
    error at most ROW_REL_TOL of its own norm (an all-zero dlogw reads 1,
    reported beside).  Beside the kernel's, the row errors and dlogw's norm
    error of the two plain versions in f32 are reported: ``wkv6_bwd_ref``,
    whose running sum leaves dlogw's rows at strong decays ~1 of their RMS
    off, and ``wkv6_bwd_chunk_ref``, the kernel's own arithmetic.  Times:
    the kernel by CUDA events and through a CUDA graph, and its plain
    version (a token loop); no single PyTorch call computes it.  The bound
    (``wkv6_bwd_work``) is the larger of the function's bytes and the
    chunked form's products at the bf16 tensor-core rate; the token-by-
    token form's f32 operations at the f32 rate are reported beside it."""
    from repro_torch.analysis.op_stats import wkv6_bwd_work
    from repro_torch.kernels.rwkv6_scan import wkv6_bwd_chunk_ref, wkv6_bwd_ref

    dt = torch.bfloat16

    def rnd(*shape, scale=0.5):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    r, k, v, do = (rnd(B, S, H, D).to(dt).transpose(1, 2) for _ in range(4))
    logw = (-torch.exp(rnd(B, S, H, D) + LOGW_MEAN[decay])).transpose(1, 2)
    u = rnd(H, D, scale=0.2)
    s0 = rnd(B, H, D, D, scale=0.1)

    def kernel():
        return ops_mod.wkv6_bwd_op(r, k, v, logw, u, s0, do)

    def plain():
        return wkv6_bwd_ref(r, k, v, logw, u, s0, do)

    grads = kernel()
    again = kernel()
    torch.cuda.synchronize()
    deterministic = all(torch.equal(a, b) for a, b in zip(grads, again))
    del again
    truth = wkv6_bwd_ref(*(x.double() for x in (r, k, v, logw, u, s0, do)))
    tol = TOL["bfloat16"]
    names = ("dr", "dk", "dv", "dlogw", "du", "dstate")

    def norm_err(g):
        return float((g.double() - truth[3]).norm() / truth[3].norm())

    errs, row_errs, ok_abs = {}, {}, True
    for name, g, ref in zip(names, grads, truth):
        err = (g.double() - ref).abs()
        ok_abs = (ok_abs and bool((err <= tol + tol * ref.abs()).all())
                  and bool(torch.isfinite(g).all()))
        errs[name] = float(err.max())
        row_errs[name] = row_rel_err(torch, g, ref)
    dlogw_norm = {"kernel": norm_err(grads[3]), "zero": norm_err(torch.zeros_like(grads[3]))}
    plain_rows = {}
    for tag, fn in (("plain", plain),
                    ("chunk_plain", lambda: wkv6_bwd_chunk_ref(r, k, v, logw, u, s0, do))):
        p = fn()
        plain_rows[tag] = {n: row_rel_err(torch, g, ref) for n, g, ref in zip(names, p, truth)}
        dlogw_norm[tag] = norm_err(p[3])
        del p
    del truth
    products, f32_ops, nbytes = wkv6_bwd_work(B, S, H, D)
    b_ms, b_by = bound(products, nbytes, "bfloat16")
    row_err = max(row_errs.values())
    result = {"kernel": "wkv6_bwd", "dtype": "bfloat16",
              "shape": {"B": B, "S": S, "H": H, "D": D, "decay": decay},
              "deterministic": deterministic,
              "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
              "tol": tol, "max_row_rel_err": row_err, "row_rel_err_by_grad": row_errs,
              "plain_row_rel_err_by_grad": plain_rows["plain"],
              "chunk_plain_row_rel_err_by_grad": plain_rows["chunk_plain"],
              "row_rel_tol": ROW_REL_TOL, "rows_held": sorted(row_errs),
              "dlogw_norm_rel_err": dlogw_norm, "ok_abs": ok_abs,
              "ok_rows": row_err <= ROW_REL_TOL,
              "ok_dlogw_norm": dlogw_norm["kernel"] <= ROW_REL_TOL < dlogw_norm["zero"],
              "kernel_ms": cuda_ms(torch, kernel),
              "kernel_graph_ms": graph_ms(torch, kernel),
              "plain_ms": cuda_ms(torch, plain, target_ms=1.0), "library_ms": None,
              "bound_ms": b_ms, "bound_by": b_by,
              "bound_ops_ms": products / PEAK_OPS["bfloat16"] * 1e3,
              "bound_bytes_ms": nbytes / BYTES_PER_S * 1e3,
              "bound_f32_ops_ms": f32_ops / PEAK_OPS["float32"] * 1e3}
    result["ok"] = (ok_abs and result["ok_rows"] and result["ok_dlogw_norm"]
                    and deterministic)
    return result


def sdpa_calls(torch, F, qt, kt, vt, do_t, window, causal):
    """SDPA on leaves that require grad, under the fused backends only
    (never its plain math), as two zero-argument calls: the forward, and
    the forward followed by its backward (``torch.autograd.grad``).  The
    backward alone is their difference: autograd runs a backward on its
    forward's stream, so a graph captures the two together.  Returns
    (forward, forward_backward, None), or (None, None, the error) where no
    fused backend takes the inputs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
    S = qt.shape[2]
    kwargs = {"is_causal": causal}
    if causal and window > 0:
        pos = torch.arange(S, device=qt.device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        kwargs = {"attn_mask": mask}
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION]

    def forward():
        with sdpa_kernel(backends):
            return F.scaled_dot_product_attention(*leaves, enable_gqa=True, **kwargs)

    def forward_backward():
        return torch.autograd.grad(forward(), leaves, do_t)

    try:
        forward_backward()
    except RuntimeError as exc:
        return None, None, f"{type(exc).__name__}: {str(exc)[:200]}"
    return forward, forward_backward, None


def check_flash_bwd(torch, F, ops_mod, dev, gen, B, S, H, KV, D, window, dtype,
                    Sk=None, causal=True):
    """The backward kernel against its plain version: the forward with LSE
    (kernel) on bf16 q, k, v, then dq, dk, dv from the backward kernel and
    from ``flash_attention_bwd_ref`` in f32 on the same q, k, v, output,
    dO and lse, held to TOL and, row by row, to ROW_REL_TOL, and a second
    call bit-equal to the first (no atomics on the data); the kernel's
    lse against the plain forward's logsumexp the same way.  The dq of a
    query that sees one key (a causal call's first) is zero analytically
    (P = 1, so dS = dP - D = 0), and so is the dk of a key that only such
    queries see, which both sides reach only up to rounding: those rows
    are held by TOL alone.  Times: the backward by CUDA events over
    back-to-back calls and through a CUDA graph, its plain version, SDPA's
    backward on the same inputs both ways (``sdpa_calls``: its forward
    and backward less its forward), the forward with and without the LSE
    (graph) beside SDPA's forward without grad (graph) and the forward's
    bound (4 D flops a kept pair; q, k, v read and the output written)."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_lse_ref)

    dt = getattr(torch, dtype)
    Sk = S if Sk is None else Sk

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.5).to(dt)

    q, k, v, do = rnd(B, S, H, D), rnd(B, Sk, KV, D), rnd(B, Sk, KV, D), rnd(B, S, H, D)
    out, lse = ops_mod.flash_attention_fwd_lse(q, k, v, window=window, causal=causal)

    def kernel():
        return ops_mod.flash_attention_bwd_op(q, k, v, out, do, lse, window=window,
                                              causal=causal)

    t = [x.transpose(1, 2) for x in (q, k, v, out, do)]

    def plain():
        return flash_attention_bwd_ref(*t, lse, window=window, causal=causal)

    grads = kernel()
    again = kernel()
    torch.cuda.synchronize()
    # no atomics on the data: two calls give the same bits
    deterministic = all(torch.equal(a, b) for a, b in zip(grads, again))
    del again
    truth = flash_attention_bwd_ref(*[x.float() for x in t], lse, window=window,
                                    causal=causal)
    tol = TOL[dtype]
    mask = torch.ones(S, Sk, dtype=torch.bool, device=dev)
    if causal:
        pos = torch.arange(S, device=dev)
        mask = pos[None, :] <= pos[:, None]
        if window > 0:
            mask &= pos[None, :] > pos[:, None] - window
    pairs = int(mask.sum())
    # the dq rows of queries that see more than one key, the dk rows of
    # keys that such a query sees: the rows held row by row
    multi_q = mask.sum(1) > 1
    multi_k = (mask & multi_q[:, None]).any(0)
    del mask
    errs, row_errs, ok_abs = [], [], True
    for g, ref, rows in zip(grads, truth, (multi_q[None, :, None],
                                           multi_k[None, :, None], None)):
        ref = ref.transpose(1, 2)
        err = (g.float() - ref).abs()
        ok_abs = ok_abs and bool((err <= tol + tol * ref.abs()).all()) \
            and bool(torch.isfinite(g).all())
        errs.append(float(err.max()))
        row_errs.append(row_rel_err(torch, g, ref, rows))
    del truth
    _, lse_ref = flash_attention_fwd_lse_ref(*[x.float() for x in t[:3]],
                                             window=window, causal=causal)
    lse_err = (lse - lse_ref).abs()
    lse_ok = bool((lse_err <= tol + tol * lse_ref.abs()).all())
    esize = q.element_size()
    # read q, k, v, o, dO and lse; write dq, dk and dv
    nbytes = (esize * (3 * B * S * H * D + 2 * B * Sk * KV * D) + 4 * B * H * S
              + esize * (B * S * H * D + 2 * B * Sk * KV * D))
    flops = 10.0 * B * H * D * pairs
    b_ms, b_by = bound(flops, nbytes, dtype)
    fwd_b_ms, fwd_b_by = bound(4.0 * B * H * D * pairs,
                               esize * (2 * B * S * H * D + 2 * B * Sk * KV * D), dtype)
    sdpa_fwd, sdpa_fwd_bwd, library_error = sdpa_calls(torch, F, *t[:3], t[4],
                                                       window, causal)
    kernel_graph_ms = graph_ms(torch, kernel)
    row_err = max(row_errs)

    def sdpa_inference():
        with torch.no_grad():
            return sdpa_fwd()

    # the bf16 kernels' dK/dV plan as the wrapper makes it; the f32 ones
    # walk whole tiles
    plan = ops_mod.plan_bwd_units(B, KV, H // KV, S, Sk, window, causal,
                                  torch.cuda.get_device_properties(dev).multi_processor_count,
                                  slots=ops_mod.bwd_slots_per_sm(D))
    result = {"kernel": "flash_attention_bwd", "dtype": dtype,
              "shape": {"B": B, "S": S, "Sk": Sk, "H": H, "KV": KV, "D": D,
                        "window": window, "causal": causal},
              "plan": None if dtype == "float32" else {
                  "cap": plan.cap, "units": len(plan.units) * B * KV,
                  "partial_tiles": plan.partials * B * KV,
                  "merged_tiles": len(plan.merges) * B * KV},
              "deterministic": deterministic,
              "max_abs_err": max(errs), "max_abs_err_dq_dk_dv": errs, "tol": tol,
              "max_row_rel_err": row_err, "row_rel_err_dq_dk_dv": row_errs,
              "row_rel_tol": ROW_REL_TOL,
              "lse_max_abs_err": float(lse_err.max()),
              "lse_max_row_rel_err": row_rel_err(torch, lse[..., None], lse_ref[..., None]),
              "ok_abs": ok_abs and lse_ok, "ok_rows": row_err <= ROW_REL_TOL,
              "kernel_ms": cuda_ms(torch, kernel), "kernel_graph_ms": kernel_graph_ms,
              "tflops_graph": flops / kernel_graph_ms * 1e-9,
              "plain_ms": cuda_ms(torch, plain),
              "fwd_graph_ms": graph_ms(torch, lambda: ops_mod.flash_attention_op(
                  q, k, v, window=window, causal=causal)),
              "fwd_lse_graph_ms": graph_ms(torch, lambda: ops_mod.flash_attention_fwd_lse(
                  q, k, v, window=window, causal=causal)),
              "library_fwd_graph_ms": graph_ms(torch, sdpa_inference) if sdpa_fwd else None,
              "fwd_bound_ms": fwd_b_ms, "fwd_bound_by": fwd_b_by,
              "library": "SDPA backward (flash, efficient or cuDNN backend)",
              "library_ms": (cuda_ms(torch, sdpa_fwd_bwd) - cuda_ms(torch, sdpa_fwd)
                             if sdpa_fwd else None),
              "library_graph_ms": (graph_ms(torch, sdpa_fwd_bwd) - graph_ms(torch, sdpa_fwd)
                                   if sdpa_fwd else None),
              "library_error": library_error,
              "bound_ms": b_ms, "bound_by": b_by}
    result["ok"] = result["ok_abs"] and result["ok_rows"] and deterministic
    return result


# the main path's shapes: llama-3.1-8b (H=32, KV=8, D=128) first, then one
# size each of the other head dims and group sizes the registry serves
FLASH_CASES = [
    (1, 1, 32, 8, 128, 0, "bfloat16"),
    (1, 77, 32, 8, 128, 0, "bfloat16"),
    (1, 1000, 32, 8, 128, 0, "bfloat16"),
    (1, 2048, 32, 8, 128, 0, "bfloat16"),
    (1, 2048, 32, 8, 128, 1024, "bfloat16"),
    (1, 1000, 32, 8, 64, 0, "bfloat16"),     # llama-3.2-1b: D=64, G=4
    (1, 1000, 16, 2, 128, 0, "bfloat16"),    # qwen2.5-3b: G=8
    (1, 1000, 16, 16, 256, 0, "bfloat16"),   # gemma-7b: D=256, G=1
    (1, 77, 32, 8, 128, 0, "float32"),
    (1, 256, 32, 8, 128, 0, "bfloat16"),    # the engine's shortest prompt
    # the encoders' modes, (..., Sk, causal): non-causal, head dim 32
    (1, 512, 12, 12, 64, 0, "bfloat16", 512, False),    # e5-base-v2
    (1, 286, 12, 12, 32, 0, "bfloat16", 286, False),    # reranker-minilm
    (8, 137, 12, 12, 32, 0, "bfloat16", 137, False),    # reranker, ragged
    (1, 77, 32, 8, 128, 0, "bfloat16", 1601, False),    # cross-attention
    (1, 1, 12, 12, 64, 0, "bfloat16", 512, False),      # one query row
    (1, 1000, 12, 12, 32, 0, "bfloat16", 1000, True),   # causal, D=32
    (1, 77, 12, 12, 32, 0, "float32", 77, False),
]
DECODE_LENS = [0, 1, 77, 1000, 2048, 3000, 4095, 4096]
DECODE_CASES = [
    (32, 8, 128, 4096, DECODE_LENS, "bfloat16"),
    (32, 8, 64, 4096, DECODE_LENS, "bfloat16"),   # llama-3.2-1b: D=64, G=4
    (16, 2, 128, 4096, DECODE_LENS, "bfloat16"),  # qwen2.5-3b: G=8
    (28, 4, 128, 4096, DECODE_LENS, "bfloat16"),  # qwen2-7b: G=7
    (32, 2, 128, 4096, DECODE_LENS, "bfloat16"),  # glm4-9b: G=16
    (16, 16, 256, 4096, DECODE_LENS, "bfloat16"),  # gemma-7b: D=256, G=1
    (32, 8, 128, 1024, [0, 5, 1024, 300], "float32"),
    # f32 weights over the bf16 cache, as in the f32 model check
    (32, 8, 128, 1024, [0, 5, 1024, 300], "float32", "bfloat16"),
    # the engine's prefix-hit suffix step: one sequence over its slot
    (32, 8, 128, 4096, [1100], "bfloat16"),
    (32, 8, 128, 4096, [0], "bfloat16"),
    # Smax not a multiple of the split
    (32, 8, 128, 1000, [999, 1000, 3, 0], "bfloat16"),
]
# the MoE decoders' heads, which no case above has: olmoe-1b-7b MHA (H = KV
# = 16, D = 128, G = 1) and granite-moe-3b-a800m (H = 24, KV = 8, D = 64,
# G = 3); a 1000-token prompt, and decode over the engine's 8 slots
MOE_FLASH_CASES = [(1, 1000, 16, 16, 128, 0, "bfloat16"),
                   (1, 1000, 24, 8, 64, 0, "bfloat16")]
MOE_DECODE_CASES = [(16, 16, 128, 4096, DECODE_LENS, "bfloat16"),
                    (24, 8, 64, 4096, DECODE_LENS, "bfloat16")]
# hymba-1.5b's heads (H = 25 over KV = 5, G = 5, D = 64): prefill at window
# 1024 over S > W (a multiple of W and not), its 3 full-attention layers at
# window 0, and f32; decode over the engine's 8 slots on a 1024-entry ring
# (lengths min(pos + 1, W)) and on a full 4096-entry cache
HYMBA_FLASH_CASES = [(1, 2048, 25, 5, 64, 1024, "bfloat16"),
                     (1, 1500, 25, 5, 64, 1024, "bfloat16"),
                     (1, 2048, 25, 5, 64, 0, "bfloat16"),
                     (1, 1500, 25, 5, 64, 1024, "float32")]
RING_LENS = [0, 1, 77, 1000, 1024, 1024, 1024, 1024]
# the ring as 8 model ways hold it under the "seq" layout, 8 blocks of 128
# indices: the valid prefixes min(pos + 1, W) of an idle row, rows at
# positions 100, 300, 450, 700 and 1023 (ends in blocks 0, 2, 3, 5, 7) and
# two that wrapped (positions 1500 and 3000)
RING_BLOCK_LENS = [0, 101, 301, 451, 701, 1024, 1024, 1024]
HYMBA_DECODE_CASES = [(25, 5, 64, 1024, RING_LENS, "bfloat16"),
                      (25, 5, 64, 4096, DECODE_LENS, "bfloat16"),
                      (25, 5, 64, 1024, RING_BLOCK_LENS, "bfloat16", None, 8)]
# the cross-attention decoders: llama-3.2-vision-11b's cross prefill of the
# generate batch over 1601 image entries (H = 32, KV = 8, D = 128), and in
# f32 at the model check's 1000 tokens; seamless-m4t-large-v2 (H = KV = 16,
# D = 64): its encoder over 1024 frames, causal self-attention and
# cross-attention over the frames; decode over the full image and frame
# caches (every row's length the cache's) and over a self cache; the
# generate phase's own shapes: the VLM's causal self-attention prefill of
# 8 x 512 tokens, and both models' self decode over its cache of 512 + 64
# positions at the lengths its steps reach (513..576)
GEN_LENS = [513, 514, 520, 533, 548, 563, 575, 576]
CROSS_FLASH_CASES = [(8, 512, 32, 8, 128, 0, "bfloat16", 1601, False),
                     (8, 512, 32, 8, 128, 0, "bfloat16"),
                     (8, 1024, 16, 16, 64, 0, "bfloat16", 1024, False),
                     (8, 512, 16, 16, 64, 0, "bfloat16"),
                     (8, 512, 16, 16, 64, 0, "bfloat16", 1024, False),
                     (1, 1000, 32, 8, 128, 0, "float32", 1601, False)]
CROSS_DECODE_CASES = [(32, 8, 128, 1601, [1601] * 8, "bfloat16"),
                      (16, 16, 64, 1024, [1024] * 8, "bfloat16"),
                      (16, 16, 64, 4096, DECODE_LENS, "bfloat16"),
                      (32, 8, 128, 576, GEN_LENS, "bfloat16"),
                      (16, 16, 64, 576, GEN_LENS, "bfloat16")]
# rwkv6-7b: H=64, D=64; prompts of the engine phase are 256-2048 tokens,
# decode runs S=1 over its 8 slots.  bf16 prompts (S >= 2) go to the
# chunked kernel, decode and f32 to the scan.
WKV6_CASES = [(B, S, 64, 64, "bfloat16", split, "mild")
              for B, S, split in ((1, 2, 0), (1, 77, 0), (1, 256, 0),
                                  (1, 1000, 0), (1, 2048, 0), (1, 1000, 500))]
WKV6_CASES += [(1, 1000, 64, 64, "bfloat16", 0, decay) for decay in ("strong", "slow")]
WKV6_CASES += [(B, 1, 64, 64, "bfloat16", 0, "mild") for B in (1, 8)]
WKV6_CASES += [(B, S, 64, 64, "float32", split, "mild")
               for B, S, split in ((1, 1, 0), (1, 77, 0), (1, 1000, 0),
                                   (1, 2048, 0), (8, 1, 0), (1, 1000, 500))]
# the backward kernel at the train phase's shape (qwen2.5-3b: H=16, KV=2,
# D=128, B=2 per microbatch, S=2048), a ragged S, and the other families'
# train shapes: hymba's window, the encoders' non-causal attention at D=64
# and D=32, the VLM's cross-attention (512 over 1601), seamless-m4t's
# encoder (1024 x 1024 frames, H = KV = 16, D = 64) and its cross-attention
# (512 over the 1024 frames), at its microbatch of 4 rows; the reference's
# train_4k length (B=1, S=4096), the longest walk the dK/dV planner splits;
# gemma-7b's microbatch (H = KV = 16, D = 256, one worker a block of the
# wgmma kernel), a ragged S, and at D = 256 grouped heads under a window
# and non-causal cross-attention (512 over 1024); then the f32 kernels at
# the f32 parity steps' shapes (qwen's D = 128 and gemma's D = 256 over
# 2 x 2048), a window at D = 64 and seamless's cross shape
FLASH_BWD_CASES = [(2, 2048, 16, 2, 128, 0, "bfloat16"),
                   (1, 1000, 32, 8, 128, 0, "bfloat16"),
                   (1, 2048, 25, 5, 64, 1024, "bfloat16"),
                   (8, 512, 12, 12, 64, 0, "bfloat16", 512, False),
                   (8, 512, 12, 12, 32, 0, "bfloat16", 512, False),
                   (8, 512, 32, 8, 128, 0, "bfloat16", 1601, False),
                   (4, 1024, 16, 16, 64, 0, "bfloat16", 1024, False),
                   (4, 512, 16, 16, 64, 0, "bfloat16", 1024, False),
                   (1, 4096, 16, 2, 128, 0, "bfloat16"),
                   (2, 2048, 16, 16, 256, 0, "bfloat16"),
                   (1, 1000, 16, 16, 256, 0, "bfloat16"),
                   (1, 1000, 16, 4, 256, 512, "bfloat16"),
                   (2, 512, 16, 16, 256, 0, "bfloat16", 1024, False),
                   (2, 2048, 16, 2, 128, 0, "float32"),
                   (2, 2048, 16, 16, 256, 0, "float32"),
                   (1, 1000, 25, 5, 64, 256, "float32"),
                   (4, 512, 16, 16, 64, 0, "float32", 1024, False)]
# the WKV6 backward at rwkv6-7b's train shape (H = 64, D = 64; B = 2 per
# microbatch, S = 2048), a ragged S, the strong and slow decays of
# WKV6_CASES, a single partial chunk and rwkv_grad's shape (B = 4):
# (B, S, H, D, decay)
WKV6_BWD_CASES = [(2, 2048, 64, 64, "mild"), (1, 1000, 64, 64, "mild"),
                  (1, 1000, 64, 64, "strong"), (1, 1000, 64, 64, "slow"),
                  (1, 37, 64, 64, "mild"), (4, 2048, 64, 64, "mild")]
# the row of each kernel in the summary line: its index among the kernel's
# checks (flash: S=1000; decode: the engine's 8 slots; wkv6_chunk: B=1,
# S=1000; wkv6_scan: the engine's decode step, B=8 at S=1, bf16; the
# backward kernels: their train shapes)
SUMMARY_SHAPE = {"flash_attention": 2, "decode_attention": 0, "wkv6_chunk": 3,
                 "wkv6_scan": 1, "flash_attention_bwd": 0, "wkv6_bwd": 0}
SOURCES = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:90"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:74"),
    "wkv6_scan": ("src/repro_torch/csrc/wkv6_scan.cu",
                  "src/repro/kernels/rwkv6_scan/kernel.py:77"),
    "wkv6_chunk": ("src/repro_torch/csrc/wkv6_chunk.cu",
                   "src/repro/kernels/rwkv6_scan/kernel.py:77"),
    # the TPU kernel flash_attention (kernel.py:90) has no backward: the
    # reference's training differentiates its jnp causal_flash_attention
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/models/layers.py:308"),
    # nor wkv6_scan (kernel.py:77): the reference's training differentiates
    # its jnp wkv6_chunked
    "wkv6_bwd": ("src/repro_torch/csrc/wkv6_bwd.cu",
                 "src/repro/models/rwkv.py:49"),
}


# ---------------------------------------------------------------------------
# phase 4 and 5: the model and the engine at full width
# ---------------------------------------------------------------------------


def _logits_run(torch, model, prompt, steps, extra=()):
    """Logits (1 + steps, 1, vocab) of a prefill of the S-token prompt (with
    ``extra``, the stub image or audio input of a cross-attention decoder)
    and the decode steps after it.  The prefill's cache goes into a decode
    cache of S + steps rounded up to 512 positions through the engine's
    ``_merge_slot`` (for llama's 1000 tokens, 1024 positions; a
    cross-attention cache's image or frame leaves are written whole)."""
    from repro_torch.serving.engine import _merge_slot

    S = prompt.shape[1]
    logits, small = model.prefill(prompt, *extra)
    cache = model.init_cache(1, -(-(S + len(steps)) // 512) * 512)
    _merge_slot(cache, small, 0)
    del small
    out = [logits]
    for i, tok in enumerate(steps):
        logits, cache = model.decode_step(cache, tok, [S + i])
        out.append(logits)
    return torch.stack(out).float()


def _rel(torch, a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _rms(torch, a, b) -> float:
    return float((a - b).square().mean().sqrt())


def routed_run(moe, run, replay=None):
    """``run()`` with ``moe.route`` wrapped; returns its result and the
    experts (B, S, K) of every route call, in call order.  With ``replay``
    (another run's list), each call takes the experts recorded there in
    place of its own top K, with its own router probabilities gathered at
    them and renormalised over the K; the capacity positions follow from
    those experts as always."""
    route = moe.route
    calls = []

    def wrapped(router, x, cfg):
        if replay is None:
            top_g, top_e = route(router, x, cfg)
        else:
            top_e = replay[len(calls)]
            top_g = moe.router_probs(router, x).gather(-1, top_e)
            top_g = top_g / top_g.sum(dim=-1, keepdim=True)
        calls.append(top_e)
        return top_g, top_e

    moe.route = wrapped
    try:
        out = run()
    finally:
        moe.route = route
    if replay is not None and len(calls) != len(replay):
        raise SmokeFailure(f"routing replay: {len(calls)} route calls, "
                           f"{len(replay)} recorded")
    return out, calls


def routing_agreement(a, b) -> float:
    """Share of (layer call, token, k) choices equal in two runs."""
    same = sum(int((x == y).sum()) for x, y in zip(a, b))
    return same / sum(x.numel() for x in a)


def moe_stats(torch, moe, cfg, calls, router, x_shape, dev):
    """The share of choices the capacity drops in the prefill calls of a
    recorded run, and whether the router's product is the same with TF32
    allowed (it must be: ``moe.router_probs`` turns TF32 off for it)."""
    prefill = [e for e in calls if e.shape[1] > 1]
    dropped = sum(int((moe.expert_positions(e, cfg.num_experts)
                       >= moe.capacity_per_row(e.shape[1], cfg)).sum())
                  for e in prefill)
    x = torch.randn(x_shape, generator=torch.Generator(device=dev).manual_seed(SEED),
                    device=dev)
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    try:
        flags.allow_tf32 = False
        ieee = moe.router_probs(router, x)
        flags.allow_tf32 = True
        under_tf32 = moe.router_probs(router, x)
    finally:
        flags.allow_tf32 = before
    return {"dropped_share_prefill": dropped / sum(e.numel() for e in prefill),
            "router_f32_under_tf32": bool(torch.equal(ieee, under_tf32))}


def vlm_gates(np, groups: int):
    """Seeded nonzero (gate, gate_mlp) of each cross layer, a different
    value per group: |g| in [0.4, 1.2], either sign."""
    rng = np.random.default_rng(SEED + 5)
    mag = rng.uniform(0.4, 1.2, size=(2, groups))
    return (mag * rng.choice([-1.0, 1.0], size=(2, groups))).tolist()


def set_gates(torch, model, gates) -> None:
    """Write ``vlm_gates``' values into the VLM's cross layers."""
    with torch.no_grad():
        for cross, g, g_mlp in zip(model.cross_layers, *gates):
            cross.gate.fill_(g)
            cross.gate_mlp.fill_(g_mlp)


def model_check(torch, np, cfg, dev, build_model, prompt_tokens=1000):
    """Full-width prefill of ``prompt_tokens`` + 8 decode steps through the
    kernels and through the plain versions (``model.plain_kernels = True``),
    in f32 and in bf16 weights drawn from one seed.

    In f32 the two differ only by the kernels' arithmetic, and that
    difference is held to MODEL_REL_TOL_F32: on llama-3.1-8b the sound
    kernels read 2.2e-5 of the logit scale there, an attention that
    rounded P or V to bf16 inside would read ~1e-2.  In bf16, two 32-layer pipelines whose
    roundings part at one element end up as far apart as bf16 noise
    (2.4e-2 of the scale, above a 2e-2 bound), so there each bf16 path is
    held against the f32 plain run: the kernel path's error may exceed the
    plain bf16 path's by at most BF16_ERR_RATIO.

    An MoE model's routing is discontinuous: a last-bit difference can
    swap the K-th and (K+1)-th expert, so free runs would measure routing
    flips, not the kernels.  There the f32 plain run's experts are
    recorded and replayed in the other three runs (``routed_run``), which
    are held as above; the free runs' routing agreement is printed.
    A cross-attention decoder prefills with a seeded stub input (the VLM's
    image embeddings, the enc-dec's audio frames), the same in every run;
    the VLM's gates, zero under the reference's init (which would leave
    its cross layers out of the logits), are set to ``vlm_gates`` in all
    four runs.

    Returns the result and the bf16 model, for the engine phase."""
    from repro_torch.launch.serve_model import stub_inputs
    from repro_torch.models import moe

    rng = np.random.default_rng(SEED)
    prompt = rng.integers(0, cfg.vocab_size, size=(1, prompt_tokens))
    steps = rng.integers(0, cfg.vocab_size, size=(8, 1))
    extra, gates = (), None
    if cfg.family in ("vlm", "audio"):
        extra = (torch.from_numpy(stub_inputs(cfg, 1, rng)).to(dev),)
    if cfg.family == "vlm":
        gates = vlm_gates(np, cfg.num_layers // cfg.cross_attn_every)
    runs, free, stats = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev, dtype=getattr(torch, dtype))
        model.init_params(torch.Generator(device=dev).manual_seed(SEED))
        if gates is not None:
            set_gates(torch, model, gates)
        torch.cuda.synchronize()
        weights_s = time.perf_counter() - t0
        for plain in (True, False):  # the f32 plain run first: the reference
            model.plain_kernels = plain

            def run(model=model):
                return _logits_run(torch, model, prompt, steps, extra)

            if not cfg.is_moe:
                runs[dtype, plain] = run()
                continue
            runs[dtype, plain], free[dtype, plain] = routed_run(moe, run)
            if (dtype, plain) != ("float32", True):
                runs[dtype, plain], _ = routed_run(
                    moe, run, replay=free["float32", True])
        model.plain_kernels = False
        if cfg.is_moe and dtype == "float32":
            stats = moe_stats(torch, moe, cfg, free["float32", True],
                              model.layers[0].mlp["router"], (1, 1000, cfg.d_model),
                              dev)
        if dtype == "float32":
            # ``run`` holds the model too: the f32 VLM (46 GB) and the bf16
            # one (23 GB) would not fit side by side with their work
            del model, run
            gc.collect()
            torch.cuda.empty_cache()
    ref = runs["float32", True]
    finite = all(bool(torch.isfinite(r).all()) for r in runs.values())
    shape_ok = all(tuple(r.shape) == (9, 1, cfg.vocab_size)
                   for r in runs.values())
    f32_rel = _rel(torch, runs["float32", False], ref)
    bf16_rel = _rel(torch, runs["bfloat16", False], runs["bfloat16", True])
    kernel_err = _rel(torch, runs["bfloat16", False], ref)
    plain_err = _rel(torch, runs["bfloat16", True], ref)
    same_argmax = int((runs["bfloat16", False].argmax(-1)
                       == runs["bfloat16", True].argmax(-1)).sum())
    result = {"phase": "model_check", "arch": cfg.name,
              "prompt_tokens": prompt_tokens,
              "decode_steps": 8, "max_rel_logit_diff_f32": f32_rel,
              "tol_f32": MODEL_REL_TOL_F32, "max_rel_logit_diff_bf16": bf16_rel,
              "bf16_kernel_vs_f32_plain": kernel_err,
              "bf16_plain_vs_f32_plain": plain_err,
              "bf16_err_ratio": kernel_err / plain_err,
              "bf16_err_ratio_tol": BF16_ERR_RATIO,
              # the same ratio over the root mean square of all 9 x vocab
              # logits, less at the mercy of one element (reported only)
              "bf16_rms_err_ratio": (_rms(torch, runs["bfloat16", False], ref)
                                     / _rms(torch, runs["bfloat16", True], ref)),
              "bf16_same_argmax_steps": same_argmax, "finite": finite,
              "shape_ok": shape_ok, "bf16_weights_s": weights_s}
    result["ok"] = (finite and shape_ok and f32_rel <= MODEL_REL_TOL_F32
                    and kernel_err <= BF16_ERR_RATIO * plain_err)
    if cfg.is_moe:
        result.update({
            "layers": cfg.num_layers, "experts": cfg.num_experts,
            "top_k": cfg.experts_per_token, "routing": "replayed from f32 plain",
            # the free runs: kernels against plain versions in each dtype,
            # and bf16 plain against f32 plain (reported only)
            "routing_agreement_f32": routing_agreement(
                free["float32", False], free["float32", True]),
            "routing_agreement_bf16": routing_agreement(
                free["bfloat16", False], free["bfloat16", True]),
            "routing_agreement_bf16_vs_f32": routing_agreement(
                free["bfloat16", True], free["float32", True]),
            **stats})
        result["ok"] = result["ok"] and stats["router_f32_under_tf32"]
    if extra:
        result["stub_input_shape"] = list(extra[0].shape)
        result["params"] = sum(p.numel() for p in model.parameters())
    if gates is not None:
        result["gates"] = {"gate": gates[0], "gate_mlp": gates[1]}
    return result, model


def llama_prompts(np, cfg):
    """8 requests sharing a 1024-token prefix, 8 of 256-2048 own tokens."""
    rng = np.random.default_rng(SEED + 1)
    shared = rng.integers(0, cfg.vocab_size, size=1024)
    reqs = []
    for i in range(8):
        suffix = rng.integers(0, cfg.vocab_size, size=int(rng.integers(32, 129)))
        reqs.append(np.concatenate([shared, suffix]).astype(np.int32))
        reqs.append(rng.integers(0, cfg.vocab_size,
                                 size=int(rng.integers(256, 2049))).astype(np.int32))
    return reqs


def rwkv_prompts(np, cfg):
    """16 requests of 256-2048 own tokens."""
    rng = np.random.default_rng(SEED + 2)
    return [rng.integers(0, cfg.vocab_size,
                         size=int(rng.integers(256, 2049))).astype(np.int32)
            for _ in range(16)]


def engine_run(torch, np, model, common, reqs, kernels, cached, max_new=64):
    """Serve ``reqs`` at full width, ``max_new`` tokens each; ``ok`` needs
    every request served, a launch of each of ``kernels`` in this run, and
    cached prompt tokens (``cached``) or none.  On a KV cache (the
    attention kernels) it needs exactly one flash launch per layer and
    whole-prompt prefill and one decode launch per layer and model decode
    call (batched steps and a prefix hit's suffix steps alike).  After the
    run, three batched decode steps (8 slots at position 1000) are
    profiled (``device_breakdown``).

    Returns the result and the run's steps for the cost model's
    predictions (the ``plan`` phase): each batched decode step's batch and
    mean context, and each whole-prompt prefill's tokens and seconds (a
    prefix hit's suffix runs as batch-1 decode steps, not as a prefill)."""
    from repro_torch.serving.engine import ServeRequest, ServingEngine

    cfg = model.cfg
    engine = ServingEngine(model, device=model.device, slots=8, max_len=4096)
    decode_s, decode_shapes, prefills = [], [], []
    decode_calls = 0
    decode_step = engine._decode_step
    prefill, model_decode = model.prefill, model.decode_step

    def timed_decode_step():
        active = sorted(engine.active)
        if active:
            decode_shapes.append(
                (len(active), float(np.mean(engine.lengths[active]))))
        t = time.perf_counter()
        out = decode_step()  # ends in a host copy of the sampled tokens
        decode_s.append(time.perf_counter() - t)
        return out

    def timed_prefill(prompt):
        t = time.perf_counter()
        out = prefill(prompt)
        torch.cuda.synchronize()
        prefills.append((int(prompt.shape[-1]), time.perf_counter() - t))
        return out

    def counted_decode(cache, tokens, pos):
        nonlocal decode_calls
        decode_calls += 1
        return model_decode(cache, tokens, pos)

    engine._decode_step = timed_decode_step
    model.prefill, model.decode_step = timed_prefill, counted_decode
    for i, prompt in enumerate(reqs):
        engine.submit(ServeRequest(i, prompt, max_new_tokens=max_new))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del model.prefill, model.decode_step  # the class's methods again
    launches = dict(common.launch_counts)
    generated = sum(len(r.generated) for r in done)
    tokens_ok = all(len(r.generated) == max_new and r.done and
                    all(0 <= t < cfg.vocab_size for t in r.generated)
                    for r in done)
    result = {
        "phase": "engine", "arch": cfg.name, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "slots": 8, "max_len": 4096,
        "requests": len(reqs), "requests_done": len(done),
        "prompt_tokens": int(sum(len(p) for p in reqs)),
        "prefill_tokens": engine.stats["prefill_tokens"],
        "cached_tokens": engine.stats["cached_tokens"],
        "generated_tokens": generated, "wall_s": wall,
        "tokens_per_s": generated / wall,
        "decode_steps": engine.stats["decode_steps"],
        "decode_step_ms": 1e3 * sum(decode_s) / max(len(decode_s), 1),
        "prefills": len(prefills),
        "prefill_ms": 1e3 * sum(s for _, s in prefills) / max(len(prefills), 1),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "model_decode_calls": decode_calls,
        # the least time a decode step takes on this card: every weight
        # read once at the HBM rate (an MoE step reads all E experts)
        "weights_read_ms": 1e3 * sum(p.numel() * p.element_size()
                                     for p in model.parameters()) / BYTES_PER_S,
        "launches": launches,
    }
    result["ok"] = (len(done) == len(reqs) and tokens_ok
                    and (engine.stats["cached_tokens"] > 0) == cached
                    and all(launches[name] > 0 for name in kernels))
    if "flash_attention" in kernels:
        expected = {"flash_attention": cfg.num_layers * len(prefills),
                    "decode_attention": cfg.num_layers * decode_calls}
        result["launches_expected"] = expected
        result["ok"] = result["ok"] and all(launches[name] == n
                                            for name, n in expected.items())
    del engine
    cache = model.init_cache(8, 1024)
    tokens = torch.zeros(8, dtype=torch.long, device=model.device)
    pos = torch.full((8,), 1000, dtype=torch.long, device=model.device)
    model.decode_step(cache, tokens, pos)  # warm-up
    result["profile_decode_steps"] = device_breakdown(
        torch, [lambda: model.decode_step(cache, tokens, pos)] * 3)
    del cache
    return result, {"decode": decode_shapes, "prefill": prefills}


def generate_run(torch, np, model, common):
    """GENERATE's batch through ``launch.serve_model.generate``: one
    prefill of 8 prompts of 512 tokens over seeded stub inputs, then 64
    greedy decode steps of the batch.  ``ok`` needs every row's tokens in
    the vocabulary and exactly the launches of the path: one flash launch
    per attention of the prefill (the VLM's self and cross layers; the
    enc-dec's encoder, self and cross layers) and one decode launch per
    attention of each step (self and cross), nothing else.  After the run,
    three decode steps of the batch at position 1000 are profiled
    (``device_breakdown``)."""
    from repro_torch.launch.serve_model import generate, stub_inputs

    cfg = model.cfg
    requests, prompt, max_new = GENERATE
    rng = np.random.default_rng(SEED + 6)
    tokens = rng.integers(0, cfg.vocab_size, size=(requests, prompt))
    inputs = torch.from_numpy(stub_inputs(cfg, requests, rng)).to(model.device)
    generate(model, tokens, inputs, 1)  # warm-up, not counted
    if cfg.family == "vlm":
        groups = cfg.num_layers // cfg.cross_attn_every
        flash, decode = cfg.num_layers + groups, cfg.num_layers + groups
    else:
        flash = cfg.encoder_layers + 2 * cfg.num_layers
        decode = 2 * cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launch_counts()
    out, times = generate(model, tokens, inputs, max_new)
    launches = dict(common.launch_counts)
    expected = {name: 0 for name in launches}
    expected.update(flash_attention=flash, decode_attention=decode * max_new)
    wall = times["prefill_s"] + times["decode_s"]
    result = {
        "phase": "generate", "arch": cfg.name, "layers": cfg.num_layers,
        "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
        "requests": requests, "prompt_tokens": prompt, "decode_steps": max_new,
        "stub_input_shape": list(inputs.shape),
        "requests_done": int(out.shape[0]),
        "generated_tokens": int(out.numel()),
        "prefill_ms": 1e3 * times["prefill_s"],
        "decode_step_ms": 1e3 * times["decode_s"] / max_new,
        "tokens_per_s": out.numel() / wall,
        "decode_tokens_per_s": requests * max_new / times["decode_s"],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "weights_read_ms": 1e3 * sum(p.numel() * p.element_size()
                                     for p in model.parameters()) / BYTES_PER_S,
        "launches": launches, "launches_expected": expected,
        "launches_per_prefill": {"flash_attention": flash},
        "launches_per_step": {"decode_attention": decode},
    }
    result["ok"] = (tuple(out.shape) == (requests, 1 + max_new)
                    and bool(((out >= 0) & (out < cfg.vocab_size)).all())
                    and launches == expected)
    cache = model.init_cache(requests, 1024)
    step = torch.zeros(requests, dtype=torch.long, device=model.device)
    pos = torch.full((requests,), 1000, dtype=torch.long, device=model.device)
    model.decode_step(cache, step, pos)  # warm-up
    result["profile_decode_steps"] = device_breakdown(
        torch, [lambda: model.decode_step(cache, step, pos)] * 3)
    del cache
    return result


# ---------------------------------------------------------------------------
# phase 10: rag_reranker's encoders
# ---------------------------------------------------------------------------


def encoder_check(torch, np, cfg, dev, build_model):
    """Full-width and full-depth pooled embeddings of a 512- and a
    137-token prompt (one ``prefill`` each) through the kernel and through
    the plain version (``plain_kernels``), in f32 and in bf16 weights
    drawn from one seed: held to MODEL_REL_TOL_F32 in f32, and in bf16 by
    BF16_ERR_RATIO against the f32 plain run, as ``model_check`` holds the
    decoders' logits.  Returns the result and the bf16 model."""
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(0, cfg.vocab_size, size=(1, n)) for n in (512, 137)]
    runs = {}
    for dtype in ("float32", "bfloat16"):
        model = build_model(cfg, device=dev, dtype=getattr(torch, dtype))
        model.init_params(torch.Generator(device=dev).manual_seed(SEED))
        for plain in (False, True):
            model.plain_kernels = plain
            runs[dtype, plain] = torch.cat(
                [model.prefill(p)[0] for p in prompts]).float()
        model.plain_kernels = False
        if dtype == "float32":
            del model
            torch.cuda.empty_cache()
    ref = runs["float32", True]
    finite = all(bool(torch.isfinite(r).all()) for r in runs.values())
    shape_ok = all(tuple(r.shape) == (2, cfg.d_model) for r in runs.values())
    f32_rel = _rel(torch, runs["float32", False], ref)
    kernel_err = _rel(torch, runs["bfloat16", False], ref)
    plain_err = _rel(torch, runs["bfloat16", True], ref)
    result = {"phase": "encoder_check", "arch": cfg.name,
              "layers": cfg.num_layers, "d_model": cfg.d_model,
              "heads": cfg.num_heads, "head_dim": cfg.head_dim,
              "prompt_tokens": [512, 137],
              "max_rel_emb_diff_f32": f32_rel, "tol_f32": MODEL_REL_TOL_F32,
              "max_rel_emb_diff_bf16": _rel(torch, runs["bfloat16", False],
                                            runs["bfloat16", True]),
              "bf16_kernel_vs_f32_plain": kernel_err,
              "bf16_plain_vs_f32_plain": plain_err,
              "bf16_err_ratio": kernel_err / plain_err,
              "bf16_err_ratio_tol": BF16_ERR_RATIO,
              # the same ratio over the RMS of all 2 x d_model values
              # (reported only)
              "bf16_rms_err_ratio": (_rms(torch, runs["bfloat16", False], ref)
                                     / _rms(torch, runs["bfloat16", True], ref)),
              "finite": finite, "shape_ok": shape_ok}
    result["ok"] = (finite and shape_ok and f32_rel <= MODEL_REL_TOL_F32
                    and kernel_err <= BF16_ERR_RATIO * plain_err)
    return result, model


RERANK_K = 8
MAX_POSITIONS = 512  # the published encoders' max_position_embeddings


def rag_encoder_calls(np, vocab):
    """rag_reranker's encoder calls for 16 queries, drawn as
    ``rag_reranker_program`` draws them: a query of 16 + Exp(mean 30)
    tokens embedded by e5-base-v2, then RERANK_K reranks of the query and a
    document of 120 + Exp(mean 120) tokens by reranker-minilm; lengths are
    capped at MAX_POSITIONS.  Returns (arch, tokens (1, S)) in call order."""
    rng = np.random.default_rng(SEED + 4)
    calls = []
    for _ in range(16):
        query = 16 + int(rng.exponential(30.0))
        lengths = [("e5-base-v2", query)]
        lengths += [("reranker-minilm", query + 120 + int(rng.exponential(120.0)))
                    for _ in range(RERANK_K)]
        for arch, n in lengths:
            n = min(n, MAX_POSITIONS)
            calls.append((arch, rng.integers(0, vocab, size=(1, n)).astype(np.int32)))
    return calls


def device_breakdown(torch, calls):
    """Device time by kernel over ``calls`` (zero-argument functions), from
    ``torch.profiler``: the attention kernels, the matrix products (cuBLAS
    and CUTLASS kernels) and the rest, beside the host's wall time of the
    window.  Only the card's activity is traced (the host's ops are not
    recorded, which took a train step of hymba's ~30 s to trace and sort).
    Measurement only: a profiler that fails is reported, not fatal."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for fn in calls:
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        groups = {"flash_attention": 0.0, "flash_attention_bwd": 0.0,
                  "decode_attention": 0.0, "wkv6": 0.0, "wkv6_bwd": 0.0,
                  "matmul": 0.0, "other": 0.0}
        kernels = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            name = e.key.lower()
            if "flash_fwd" in name:
                group = "flash_attention"
            elif any(w in name for w in ("bwd_prep", "bwd_dq", "bwd_dkdv", "bwd_merge")):
                group = "flash_attention_bwd"
            elif any(w in name for w in ("decode_split", "decode_merge",
                                         "decode_fwd")):
                group = "decode_attention"
            elif "wkv6_bwd" in name:
                group = "wkv6_bwd"
            elif "wkv6" in name:
                group = "wkv6"
            elif any(w in name for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
                group = "matmul"
            else:
                group = "other"
            groups[group] += us / 1e3
            kernels.append((us / 1e3, e.count, e.key[:80]))
        kernels.sort(reverse=True)
        device_ms = sum(groups.values())
        return {"calls": len(calls), "wall_ms": wall_ms, "device_ms": device_ms,
                "device_busy_share": device_ms / wall_ms if wall_ms else None,
                "device_ms_by_group": groups,
                "top_kernels": [{"ms": ms, "count": n, "name": k}
                                for ms, n, k in kernels[:6]]}
    except Exception as exc:  # noqa: BLE001 - a measurement, not a check
        return {"error": f"{type(exc).__name__}: {exc}"}


def encode_run(torch, np, models, common):
    """rag_reranker's encoder traffic (``rag_encoder_calls``), one
    ``prefill`` per call: the reference's encoder takes an unmasked (B, S)
    batch, so calls of different lengths cannot share one without changing
    the result.  Each call is timed on the host clock to its
    synchronisation.  ``ok`` needs a finite (1, d_model) embedding from
    every call and exactly one flash launch per layer and call."""
    calls = rag_encoder_calls(np, min(m.cfg.vocab_size for m in models.values()))
    for arch, model in models.items():  # warm-up, not counted
        model.prefill(next(t for a, t in calls if a == arch))
    torch.cuda.synchronize()
    per = {arch: {"ms": [], "tokens": 0, "peak": 0} for arch in models}
    finite = shape_ok = True
    common.reset_launch_counts()
    t0 = time.perf_counter()
    for arch, tokens in calls:
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        emb, _ = models[arch].prefill(tokens)
        torch.cuda.synchronize()
        per[arch]["ms"].append((time.perf_counter() - t) * 1e3)
        per[arch]["tokens"] += tokens.shape[1]
        per[arch]["peak"] = max(per[arch]["peak"], torch.cuda.max_memory_allocated())
        finite = finite and bool(torch.isfinite(emb).all())
        shape_ok = shape_ok and tuple(emb.shape) == (1, models[arch].cfg.d_model)
    wall = time.perf_counter() - t0
    launches = dict(common.launch_counts)
    expected = sum(models[arch].cfg.num_layers for arch, _ in calls)
    report = {}
    for arch, p in per.items():
        busy_s = sum(p["ms"]) / 1e3
        lengths = [t.shape[1] for a, t in calls if a == arch]
        report[arch] = {
            "calls": len(p["ms"]), "tokens": p["tokens"],
            "tokens_per_call": {"min": min(lengths), "mean": float(np.mean(lengths)),
                                "max": max(lengths)},
            "calls_per_s": len(p["ms"]) / busy_s, "tokens_per_s": p["tokens"] / busy_s,
            "mean_ms": float(np.mean(p["ms"])),
            "p99_ms": float(np.percentile(p["ms"], 99)),
            "max_memory_allocated_bytes": p["peak"]}
    # where one query's time goes: its embedding and its reranks, profiled
    # after the counted run
    first = calls[:1 + RERANK_K]
    profiled = {arch: device_breakdown(torch, [
        (lambda m=models[a], t=t: m.prefill(t)) for a, t in first if a == arch])
        for arch in models}
    result = {"phase": "encode", "workflow": "rag_reranker", "queries": 16,
              "reranks_per_query": RERANK_K, "calls": len(calls), "wall_s": wall,
              "models": report, "launches": launches,
              "launches_expected": {"flash_attention": expected},
              "finite": finite, "shape_ok": shape_ok, "profile_first_query": profiled}
    result["ok"] = (finite and shape_ok and launches["flash_attention"] == expected
                    and all(n == 0 for k, n in launches.items()
                            if k != "flash_attention"))
    return result


# ---------------------------------------------------------------------------
# phase 11: training every family
# ---------------------------------------------------------------------------


TRAIN_LR, TRAIN_WARMUP = 1e-3, 10


class TrainSpec(NamedTuple):
    """One training run: SyntheticCorpus batches of ``batch`` x ``seq``
    tokens in ``microbatches``, ``steps`` AdamW steps at peak rate ``lr``
    (after TRAIN_WARMUP steps of warm-up), at full width; the depth cut to
    ``layers`` where given.  With ``f32_kernels``, ``train_parity`` also
    runs its step in f32 through the kernels."""
    arch: str
    batch: int
    seq: int
    microbatches: int
    steps: int
    layers: Optional[int] = None
    lr: float = TRAIN_LR
    f32_kernels: bool = False


# qwen2.5-3b first (8 x 2048 in 4 microbatches of 2), then the other
# families: the encoders at rag_reranker's rerank length cap, hymba past its
# 1024 window, seamless-m4t over 1024 stub frames a row, the VLM at 2 of its
# 8 groups (AdamW's f32 moments of all 11.47 B weights would take 91.8 GB),
# at AdamW's default peak rate: at 1e-3 its loss climbed back from step 7;
# rwkv6-7b at qwen's batches and 8 of its 32 layers (2.30 B weights: the
# f32 moments of all 7.58 B, with bf16 weights and gradients, take 91 GB)
#
# Steps are cut to what the loss bar needs, with margin, to keep the
# script's time (a run at the longer counts on NVIDIA H100 80GB HBM3,
# 700.00 W: the last 5 steps' mean over the first 5's at 15 steps e5
# 0.193, reranker 0.075, seamless 0.530 and the VLM 0.586, at 10 hymba
# 0.638, at 20 rwkv 0.698; qwen2.5-3b needs its 30: 0.718 at 25)
#
# gemma-7b (head dim 256: the backward's wgmma kernel, one worker a block)
# at full width and 8 of its 28 layers, 3.00 B weights: bf16 weights and
# gradients and f32 moments of all 8.54 B would take 102 GB; olmoe-1b-7b at
# full width and 8 of its 16 layers, 3.56 B (6.92 B at full depth: 83 GB),
# routed through every expert; each at 4 x 2048 tokens in 2 microbatches.
# qwen2.5-3b and gemma-7b also check a step in f32 through the kernels
# (``train_parity``)
TRAIN_RUNS = [TrainSpec("qwen2.5-3b", 8, 2048, 4, 30, f32_kernels=True),
              TrainSpec("e5-base-v2", 16, 512, 1, 15),
              TrainSpec("reranker-minilm", 16, 512, 1, 15),
              TrainSpec("hymba-1.5b", 2, 2048, 1, 10),
              TrainSpec("seamless-m4t-large-v2", 8, 512, 2, 15),
              TrainSpec("llama-3.2-vision-11b", 4, 512, 1, 15, layers=10, lr=3e-4),
              TrainSpec(RWKV_ARCH, 8, 2048, 4, 20, layers=8),
              TrainSpec("gemma-7b", 4, 2048, 2, 30, layers=8, f32_kernels=True),
              TrainSpec(MOE_ARCHS[0], 4, 2048, 2, 30, layers=8)]
# the gradients at full depth, one forward_loss and backward each, no
# update: (phase, rows, seq) by arch; the VLM's 48 layers over 4 x 512
# tokens, rwkv6-7b's 32 over 4 x 2048
FULL_GRADS = {CROSS_ARCHS[0]: ("vlm_grad", 4, 512), RWKV_ARCH: ("rwkv_grad", 4, 2048)}
# the reference's bar for a falling loss (tests/test_training.py)
TRAIN_LOSS_RATIO = 0.75
PARITY_LAYERS = 2
PARITY_ROWS = 2


def parity_config(cfg):
    """``cfg`` at full width and PARITY_LAYERS layers (the VLM: one group,
    its self layers and a cross layer; the enc-dec: PARITY_LAYERS encoder
    and decoder layers)."""
    if cfg.family == "vlm":
        return dataclasses.replace(cfg, num_layers=cfg.cross_attn_every)
    if cfg.family == "audio":
        return dataclasses.replace(cfg, num_layers=PARITY_LAYERS,
                                   encoder_layers=PARITY_LAYERS)
    return dataclasses.replace(cfg, num_layers=PARITY_LAYERS)


def seeded_model(torch, np, cfg, dev, build_model, dtype, seed=SEED):
    """``cfg`` with weights drawn from ``seed`` in ``dtype``; a VLM's gates
    set to ``vlm_gates`` (zero gates would leave every cross weight but the
    gates without a gradient)."""
    model = build_model(cfg, device=dev, dtype=dtype)
    model.init_params(torch.Generator(device=dev).manual_seed(seed))
    if cfg.family == "vlm":
        set_gates(torch, model, vlm_gates(np, len(model.cross_layers)))
    return model


def stub_batch(torch, model, rows: int, dev, seed: int) -> dict:
    """The model's ``extra_inputs`` for ``rows`` rows (the VLM's image
    embeddings, the enc-dec's audio frames), standard normal f32 drawn on
    the card from ``seed``; the train step takes them in the weights'
    dtype."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {name: torch.randn(shape, generator=gen, device=dev)
            for name, (shape, _) in getattr(model, "extra_inputs",
                                            lambda b: {})(rows).items()}


def train_run(torch, np, spec: TrainSpec, cfg, dev, build_model, common):
    """``cfg`` (full width, depth cut by the spec where it says so), bf16
    weights from the seed, trained for ``spec.steps`` steps on
    ``SyntheticCorpus`` batches through ``make_train_step``, with one
    seeded stub input for the whole run where the family takes one.  Each
    step's launch counts are set to 0 just before it and read just after.
    ``ok`` needs every loss finite, the mean of the last 5 below
    TRAIN_LOSS_RATIO of the first 5's, and, in every step, exactly the
    launches of ``train_launches``.  An extra step is profiled
    (``device_breakdown``)."""
    from repro_torch.analysis.op_stats import train_flops, train_launches
    from repro_torch.training.data import DataConfig, SyntheticCorpus
    from repro_torch.training.optimizer import (AdamWConfig, global_norm,
                                                init_state)
    from repro_torch.training.train_loop import make_train_step

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = seeded_model(torch, np, cfg, dev, build_model, torch.bfloat16)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    step_fn = make_train_step(model, AdamWConfig(lr=spec.lr, warmup_steps=TRAIN_WARMUP),
                              num_microbatches=spec.microbatches)
    state = init_state(params)
    stub = stub_batch(torch, model, spec.batch, dev, SEED + 11)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    data = SyntheticCorpus(DataConfig(cfg.vocab_size, spec.seq, spec.batch, seed=SEED))
    per_step = train_launches(cfg, spec.microbatches)
    expected = {name: per_step.get(name, 0) for name in common.KERNELS}
    bwd_kernel = next(name for name in per_step if name.endswith("_bwd"))
    tokens = spec.batch * spec.seq
    flops = train_flops(model, spec.batch, spec.seq)
    steps, launches_ok, totals = [], True, Counter()
    for step in range(spec.steps):
        batch = {**data.batch_at(step), **stub}
        torch.cuda.synchronize()
        common.reset_launch_counts()
        t = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = dict(common.launch_counts)
        totals.update(launches)
        launches_ok = launches_ok and launches == expected
        row = {"phase": "train_step", "arch": cfg.name, "step": int(metrics["step"]),
               "loss": loss, "ms": seconds * 1e3, "tokens_per_s": tokens / seconds,
               "grad_norm": float(global_norm(p.grad for p in params.values())),
               "model_flops_share": flops / seconds / PEAK_OPS["bfloat16"],
               "launches": {k: n for k, n in launches.items() if n}}
        emit(row)
        steps.append(row)
    peak = torch.cuda.max_memory_allocated()
    profile = device_breakdown(torch, [lambda: step_fn(
        state, {**data.batch_at(spec.steps), **stub})])
    losses = [r["loss"] for r in steps]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    ms = [r["ms"] for r in steps[1:]]  # the first step pays the allocator's warm-up
    step_s = float(np.mean(ms)) / 1e3
    result = {
        "phase": "train", "arch": cfg.name, "family": cfg.family,
        "layers": cfg.num_layers, "d_model": cfg.d_model, "heads": cfg.num_heads,
        "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "vocab": cfg.vocab_size, "params": n_params,
        "seq": spec.seq, "batch": spec.batch, "microbatches": spec.microbatches,
        "stub_inputs": {k: list(v.shape) for k, v in stub.items()},
        "steps": spec.steps, "lr": spec.lr, "warmup_steps": TRAIN_WARMUP,
        "setup_s": setup_s, "first5_mean_loss": first, "last5_mean_loss": last,
        "loss_ratio": last / first, "loss_ratio_bar": TRAIN_LOSS_RATIO,
        "step_ms_mean": float(np.mean(ms)), "step_ms_min": float(np.min(ms)),
        "tokens_per_s": tokens / step_s, "model_flops_per_step": flops,
        "model_flops_share": flops / step_s / PEAK_OPS["bfloat16"],
        "max_memory_allocated_bytes": peak,
        "launches_per_step_expected": {k: n for k, n in expected.items() if n},
        "launches": dict(totals), "profile_one_step": profile,
        "device_busy_share": profile.get("device_busy_share"),
        "bwd_kernel": bwd_kernel,
        "bwd_group_ms": profile.get("device_ms_by_group", {}).get(bwd_kernel),
        "finite": all(np.isfinite(losses))}
    if cfg.family == "vlm":
        result["groups"] = len(model.cross_layers)
    if cfg.family == "audio":
        result["encoder_layers"] = cfg.encoder_layers
    result["ok"] = (result["finite"] and last < TRAIN_LOSS_RATIO * first
                    and launches_ok)
    del model, params, state, step_fn
    return result


def train_parity(torch, np, spec: TrainSpec, cfg, dev, build_model, common):
    """One train step (one microbatch of PARITY_ROWS x ``spec.seq`` tokens,
    with a seeded stub input where the family takes one) of ``cfg`` at full
    width and the depth of ``parity_config``, from weights drawn from one
    seed: in f32 with the plain versions of the kernels (the reference
    run), in bf16 with the plain versions and in bf16 through the kernels;
    with ``spec.f32_kernels``, in f32 through the kernels too.
    The kernels' loss must be within bf16 TOL of the plain bf16 loss's
    scale, no gradient of the f32 run may be zero, and each gradient's RMS
    error against the f32 run at most BF16_ERR_RATIO times the plain bf16
    run's, as ``model_check`` holds logits; a 0-dim gradient (the VLM's
    gates), one number, for which that ratio of two single errors is
    noise, is held as the loss is: within TOL of the plain bf16 run's.
    The f32 kernel run differs from the f32 plain run only by the kernels'
    order of f32 sums: its loss, and each gradient's RMS error over the
    gradient's RMS, within the f32 TOL.  The kernel runs launch exactly
    ``train_launches``, the plain runs nothing.

    An MoE model routes discontinuously (``model_check``): the f32 plain
    run's experts, recorded over its step (the forward and the checkpoint's
    recompute, in call order), are replayed in every other run's step, and
    each bf16 run's free forward is held to them by routing agreement
    (printed)."""
    from repro_torch.analysis.op_stats import train_launches
    from repro_torch.models import moe
    from repro_torch.training.data import DataConfig, SyntheticCorpus
    from repro_torch.training.optimizer import AdamWConfig, init_state
    from repro_torch.training.train_loop import make_train_step

    small = parity_config(cfg)
    batch = SyntheticCorpus(DataConfig(cfg.vocab_size, spec.seq, PARITY_ROWS,
                                       seed=SEED + 7)).batch_at(0)
    kinds = [("float32", True), ("bfloat16", True), ("bfloat16", False)]
    if spec.f32_kernels:
        kinds.append(("float32", False))
    runs, routes, agreement = {}, None, {}
    for dtype, plain in kinds:
        model = seeded_model(torch, np, small, dev, build_model, getattr(torch, dtype))
        model.plain_kernels = plain
        step_fn = make_train_step(model, AdamWConfig(lr=spec.lr, warmup_steps=TRAIN_WARMUP))
        state = init_state(dict(model.named_parameters()))
        inputs = {**batch, **stub_batch(torch, model, PARITY_ROWS, dev, SEED + 9)}
        if cfg.is_moe and routes is not None and dtype == "bfloat16":
            with torch.no_grad():
                _, free = routed_run(moe, lambda: model.forward_loss(
                    **{k: torch.as_tensor(v, device=dev) for k, v in batch.items()}))
            agreement[f"{dtype}_{'plain' if plain else 'kernel'}"] = \
                routing_agreement(free, routes)
        torch.cuda.synchronize()
        common.reset_launch_counts()
        if cfg.is_moe:
            (_, metrics), calls = routed_run(moe, lambda: step_fn(state, inputs),
                                             replay=routes)
            routes = calls if routes is None else routes
        else:
            _, metrics = step_fn(state, inputs)
        loss = float(metrics["loss"])
        launches = {k: n for k, n in common.launch_counts.items() if n}
        grads = {n: p.grad.float() for n, p in model.named_parameters()}
        runs[dtype, plain] = (loss, grads, launches)
        del model, step_fn, state, inputs
        gc.collect()
        torch.cuda.empty_cache()
    ref_loss, ref, _ = runs["float32", True]
    plain_loss, plain_g, plain_launches = runs["bfloat16", True]
    kern_loss, kern_g, kern_launches = runs["bfloat16", False]
    tol = TOL["bfloat16"]
    ratios, scalars, zero = {}, {}, []
    for name, g in ref.items():
        if not bool(g.abs().max() > 0):
            zero.append(name)
        if g.ndim == 0:
            # one number (the VLM's gates): the ratio of two single errors
            # is noise, so it is held as the loss is, kernels against plain
            k, p = float(kern_g[name]), float(plain_g[name])
            scalars[name] = {"f32_plain": float(g), "bf16_plain": p, "bf16_kernel": k,
                             "ok": abs(k - p) <= tol * abs(p)}
            continue
        p_err = _rms(torch, plain_g[name], g)
        k_err = _rms(torch, kern_g[name], g)
        ratios[name] = k_err / p_err if p_err > 0 else (0.0 if k_err == 0 else float("inf"))
    worst = sorted(ratios.items(), key=lambda kv: -kv[1])
    want = train_launches(small)
    result = {"phase": "train_parity", "arch": cfg.name, "layers": small.num_layers,
              "d_model": cfg.d_model, "tokens": PARITY_ROWS * spec.seq,
              "loss_f32_plain": ref_loss, "loss_bf16_plain": plain_loss,
              "loss_bf16_kernel": kern_loss,
              "loss_rel_diff": abs(kern_loss - plain_loss) / abs(plain_loss),
              "loss_tol": tol, "grads": len(ratios), "zero_grads_f32": zero,
              "grad_rms_err_ratio_max": worst[0][1],
              "grad_rms_err_ratio_worst5": dict(worst[:5]),
              "grad_rms_err_ratio_tol": BF16_ERR_RATIO, "scalar_grads": scalars,
              "launches_kernel_run": kern_launches, "launches_kernel_expected": want,
              "launches_plain_run": plain_launches}
    ok = (abs(kern_loss - plain_loss) <= tol * abs(plain_loss)
          and all(np.isfinite([ref_loss, plain_loss, kern_loss]))
          and worst[0][1] <= BF16_ERR_RATIO and not zero
          and all(v["ok"] for v in scalars.values())
          and kern_launches == want and not plain_launches)
    if spec.f32_kernels:
        f32_loss, f32_g, f32_launches = runs["float32", False]
        rel = {name: _rms(torch, f32_g[name], g) / float(g.square().mean().sqrt())
               for name, g in ref.items() if bool(g.abs().max() > 0)}
        worst32 = sorted(rel.items(), key=lambda kv: -kv[1])
        loss32 = abs(f32_loss - ref_loss) / abs(ref_loss)
        result.update({"loss_f32_kernel": f32_loss, "f32_kernel_loss_rel_diff": loss32,
                       "f32_kernel_grad_rel_rms_err_max": worst32[0][1],
                       "f32_kernel_grad_rel_rms_err_worst5": dict(worst32[:5]),
                       "f32_tol": TOL["float32"],
                       "launches_f32_kernel_run": f32_launches})
        ok = (ok and bool(np.isfinite(f32_loss)) and loss32 <= TOL["float32"]
              and worst32[0][1] <= TOL["float32"] and f32_launches == want)
    if cfg.is_moe:
        result.update({"routing": "replayed from the f32 plain step",
                       "route_calls": len(routes),
                       "routing_agreement_free_vs_f32": agreement})
    if cfg.family == "audio":
        result["encoder_layers"] = small.encoder_layers
    result["ok"] = ok
    return result


def grad_run(torch, np, cfg, dev, build_model, common):
    """``cfg`` at full width and depth: one ``forward_loss`` and backward
    of FULL_GRADS' rows x seq tokens (over seeded image embeddings for the
    VLM), bf16 weights and gradients, no optimiser state.  ``ok`` needs a
    finite loss and gradient norm and exactly ``train_launches``."""
    from repro_torch.analysis.op_stats import train_launches
    from repro_torch.training.data import DataConfig, SyntheticCorpus
    from repro_torch.training.optimizer import global_norm

    phase, rows, seq = FULL_GRADS[cfg.name]
    torch.cuda.reset_peak_memory_stats()
    model = seeded_model(torch, np, cfg, dev, build_model, torch.bfloat16)
    model.requires_grad_(True)
    batch = SyntheticCorpus(DataConfig(cfg.vocab_size, seq, rows,
                                       seed=SEED)).batch_at(0)
    stub = stub_batch(torch, model, rows, dev, SEED + 11)
    torch.cuda.synchronize()
    common.reset_launch_counts()
    t = time.perf_counter()
    loss = model.forward_loss(**batch, **stub)
    loss.backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = {k: n for k, n in common.launch_counts.items() if n}
    want = train_launches(cfg)
    gnorm = float(global_norm(p.grad for p in model.parameters()))
    result = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
              "params": sum(p.numel() for p in model.parameters()),
              "tokens": rows * seq, "loss": float(loss.detach()), "grad_norm": gnorm,
              "ms": seconds * 1e3,
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "launches": launches, "launches_expected": want}
    if cfg.family == "vlm":
        result["groups"] = len(model.cross_layers)
    result["ok"] = (bool(np.isfinite(result["loss"])) and bool(np.isfinite(gnorm))
                    and launches == want)
    del model, loss
    return result


def train_phase(torch, np, F, flash_ops, wkv6_ops, dev, gen, build_model, common,
                get_config):
    """The backward kernels' checks, then for each of TRAIN_RUNS the step
    parity check and the training run, then the full-depth gradients of
    FULL_GRADS; returns the checks and the train results by arch."""
    bwd = [check_flash_bwd(torch, F, flash_ops, dev, gen, *c) for c in FLASH_BWD_CASES]
    emit({"phase": "kernel_checks", "checks": bwd})
    bad = [c for c in bwd if not c["ok"]]
    if bad:
        raise SmokeFailure(f"{len(bad)} flash backward check(s) out of tolerance")
    wkv = [check_wkv6_bwd(torch, wkv6_ops, dev, gen, *c) for c in WKV6_BWD_CASES]
    emit({"phase": "kernel_checks", "checks": wkv})
    bad = [c for c in wkv if not c["ok"]]
    if bad:
        raise SmokeFailure(f"{len(bad)} wkv6 backward check(s) out of tolerance")
    bwd += wkv
    results = {}
    for spec in TRAIN_RUNS:
        cfg = get_config(spec.arch)
        result = train_parity(torch, np, spec, cfg, dev, build_model, common)
        emit(result)
        if not result["ok"]:
            raise SmokeFailure(f"{spec.arch} train step parity (kernels vs plain) failed")
        if spec.layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=spec.layers)
        result = train_run(torch, np, spec, cfg, dev, build_model, common)
        emit(result)
        if not result["ok"]:
            raise SmokeFailure(f"{spec.arch} training run failed")
        results[spec.arch] = result
        gc.collect()
        torch.cuda.empty_cache()
    for arch in FULL_GRADS:
        result = grad_run(torch, np, get_config(arch), dev, build_model, common)
        emit(result)
        if not result["ok"]:
            raise SmokeFailure(f"full-depth {arch} gradient failed")
        gc.collect()
        torch.cuda.empty_cache()
    return bwd, results


# ---------------------------------------------------------------------------
# phase 12: checkpoint, resume and compression
# ---------------------------------------------------------------------------

# train_resume: qwen2.5-3b at full width and PARITY_LAYERS layers, 4 x 2048
# tokens in one microbatch, 8 steps with a checkpoint after RESUME_AT of them
RESUME = TrainSpec("qwen2.5-3b", 4, 2048, 1, 8, layers=PARITY_LAYERS)
RESUME_AT = 4


def _state_copy(torch, model, state) -> dict:
    """A copy on the card of every weight, moment and the step, by the
    checkpoint's keys."""
    out = {f"param/{n}": p.detach().clone() for n, p in model.named_parameters()}
    out.update({f"m/{n}": t.clone() for n, t in state.m.items()})
    out.update({f"v/{n}": t.clone() for n, t in state.v.items()})
    out["step"] = state.step.clone()
    return out


def _unequal(torch, a: dict, b: dict) -> list:
    """The keys of two ``_state_copy``s (or of one and a live state) whose
    tensors differ in dtype, shape or any bit."""
    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or not torch.equal(a[k], b[k]))


def resume_phase(torch, np, cfg, dev, build_model, common):
    """Checkpoint, resume and compression on the card (``RESUME``): bf16
    weights from SEED, ``SyntheticCorpus`` batches by step, AdamW through
    ``make_train_step``.  Run U takes RESUME.steps steps and saves a
    checkpoint (``training.checkpoint``) after RESUME_AT of them into a
    directory under ``build/`` that is removed at the end; U2 repeats U; R,
    a model drawn from another seed, restores that checkpoint and takes the
    remaining steps; C takes U's steps with ``compress=True``.  ``ok``
    needs the restored weights, moments and step bit-equal to U's at the
    save, U2 and R bit-equal to U in every loss and in the final weights
    and moments, every step's launches exactly ``train_launches``, C's
    losses finite, and ``compress_tree`` of the largest gradient (the tied
    embedding's) with a seeded error bit-equal on the card and on the
    CPU."""
    from repro_torch.analysis.op_stats import train_launches
    import shutil
    import tempfile

    from repro_torch.distributed.compression import compress_tree
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import DataConfig, SyntheticCorpus
    from repro_torch.training.optimizer import AdamWConfig, init_state
    from repro_torch.training.train_loop import make_train_step

    spec = RESUME
    data = SyntheticCorpus(DataConfig(cfg.vocab_size, spec.seq, spec.batch, seed=SEED))
    per_step = train_launches(cfg, spec.microbatches)
    expected = {name: per_step.get(name, 0) for name in common.KERNELS}
    launches_ok, totals = [], Counter()

    def steps(model, state, step_fn, start, stop, at=None):
        """Steps start..stop-1; with ``at``, calls ``at(state)`` after step
        RESUME_AT - 1."""
        losses = []
        for step in range(start, stop):
            torch.cuda.synchronize()
            common.reset_launch_counts()
            state, metrics = step_fn(state, data.batch_at(step))
            losses.append(float(metrics["loss"]))
            launches_ok.append(dict(common.launch_counts) == expected)
            totals.update(common.launch_counts)
            if at is not None and step + 1 == RESUME_AT:
                at(state)
        return state, losses

    def fresh(seed, compress=False):
        model = build_model(cfg, device=dev, dtype=torch.bfloat16)
        model.init_params(torch.Generator(device=dev).manual_seed(seed))
        step_fn = make_train_step(model, AdamWConfig(lr=spec.lr, warmup_steps=TRAIN_WARMUP),
                                  compress=compress)
        return model, init_state(dict(model.named_parameters())), step_fn

    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train_resume_", dir=build_dir)
    torch.cuda.reset_peak_memory_stats()
    io = {}
    try:
        model_u, state, step_fn = fresh(SEED)
        n_params = sum(p.numel() for p in model_u.parameters())

        def save(state):
            torch.cuda.synchronize()
            t = time.perf_counter()
            path = ckpt.save_checkpoint(ckpt_dir, RESUME_AT, model_u, state,
                                        extra={"arch": cfg.name})
            io["save_s"] = time.perf_counter() - t
            io["bytes"] = sum(f.stat().st_size for f in Path(path).iterdir())
            io["at_save"] = _state_copy(torch, model_u, state)

        state_u, losses_u = steps(model_u, state, step_fn, 0, spec.steps, at=save)
        final_u = _state_copy(torch, model_u, state_u)
        embed_grad = model_u.embed.grad.detach().clone()
        compress_shape = list(embed_grad.shape)
        del step_fn, state, state_u
        model_u = None

        model, state, step_fn = fresh(SEED)
        state, losses_u2 = steps(model, state, step_fn, 0, spec.steps)
        u2_diff = _unequal(torch, final_u, _state_copy(torch, model, state))
        del model, state, step_fn

        model, state, step_fn = fresh(SEED + 1)
        before = _unequal(torch, io["at_save"], _state_copy(torch, model, state))
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, at_step, extra = ckpt.restore_checkpoint(ckpt_dir, model, state)
        torch.cuda.synchronize()
        io["restore_s"] = time.perf_counter() - t
        restored_diff = _unequal(torch, io.pop("at_save"), _state_copy(torch, model, state))
        state, losses_r = steps(model, state, step_fn, at_step, spec.steps)
        r_diff = _unequal(torch, final_u, _state_copy(torch, model, state))
        del model, state, step_fn, final_u
        gc.collect()
        torch.cuda.empty_cache()

        model, state, step_fn = fresh(SEED, compress=True)
        state, losses_c = steps(model, state, step_fn, 0, spec.steps)
        del model, state, step_fn
        gc.collect()
        torch.cuda.empty_cache()
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # compress_tree of the embedding's gradient on the card and on the CPU,
    # with an f32 error of 1% of the gradient's RMS drawn from a seed
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    rms = embed_grad.float().square().mean().sqrt()
    error = torch.randn(embed_grad.shape, generator=gen, device=dev) * (0.01 * rms)
    grads, errors = {"embed": embed_grad}, {"embed": error}
    compress_tree(grads, errors)  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    sent, new_error = compress_tree(grads, errors)
    end.record()
    torch.cuda.synchronize()
    compress_ms = start.elapsed_time(end)
    t = time.perf_counter()
    sent_cpu, error_cpu = compress_tree({"embed": embed_grad.cpu()}, {"embed": error.cpu()})
    compress_cpu_s = time.perf_counter() - t
    compress_equal = (torch.equal(sent["embed"].cpu(), sent_cpu["embed"])
                      and torch.equal(new_error["embed"].cpu(), error_cpu["embed"]))
    del sent, new_error, sent_cpu, error_cpu, error, embed_grad, grads, errors

    result = {
        "phase": "train_resume", "arch": cfg.name, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "params": n_params, "batch": spec.batch,
        "seq": spec.seq, "microbatches": spec.microbatches, "steps": spec.steps,
        "checkpoint_at": RESUME_AT, "restored_step": at_step, "extra": extra,
        "checkpoint_bytes": io["bytes"], "save_s": io["save_s"],
        "save_gb_per_s": io["bytes"] / io["save_s"] / 1e9,
        "restore_s": io["restore_s"],
        "restore_gb_per_s": io["bytes"] / io["restore_s"] / 1e9,
        "fresh_model_differs_before_restore": bool(before),
        "restored_unequal": restored_diff, "uninterrupted_again_unequal": u2_diff,
        "resumed_unequal": r_diff,
        "losses_uninterrupted": losses_u, "losses_uninterrupted_again": losses_u2,
        "losses_resumed": losses_r, "losses_compressed": losses_c,
        "launches_per_step_expected": {k: n for k, n in expected.items() if n},
        "steps_with_expected_launches": f"{sum(launches_ok)}/{len(launches_ok)}",
        "launches": {k: n for k, n in totals.items() if n},
        "compress_shape": compress_shape,
        "compress_ms": compress_ms, "compress_cpu_s": compress_cpu_s,
        "compress_card_equals_cpu": compress_equal,
        "max_memory_allocated_bytes": peak}
    result["ok"] = (bool(before) and not restored_diff and not u2_diff and not r_diff
                    and at_step == RESUME_AT and losses_u2 == losses_u
                    and losses_r == losses_u[RESUME_AT:] and all(launches_ok)
                    and bool(np.isfinite(losses_c).all()) and compress_equal)
    return result


# ---------------------------------------------------------------------------
# phase 13: the dense decoders sharded over a (1, 1) NCCL mesh
# ---------------------------------------------------------------------------

# llama-3.1-8b and olmoe-1b-7b serve the engine phase's first 4 requests
# (the third takes the first's 1024-token prefix from the cache), rwkv6-7b
# the rwkv engine phase's first 4, 16 new tokens each (8 requests, three
# prefix hits whose suffixes decode token by token, took llama 77 s
# unsharded and sharded on a slow host, the whole script 1150 s of its
# 1200); the VLM and seamless-m4t generate 16 steps from GENERATE's batch;
# qwen2.5-3b trains 3 steps at full width and 4 of its 36 layers (0.62 B
# weights: its sharded run checkpoints, 7.4 GB of f32 weights and moments;
# 18 layers until the checkpoint came, whose 20 GB would take ~50 s to
# write and read), rwkv6-7b 3
# steps of 4 x 2048 tokens at 8 of its 32 layers (23 GB a run); hymba-1.5b
# serves the hymba engine phase's first 4 requests and trains 3 steps of
# 2 x 2048 tokens at its layers 0-3 (layer 0 attends over the whole
# prefix, 1-3 over the 1024-token window)
SHARD_REQUESTS, SHARD_NEW = 4, 16
SHARD_SERVE = (ARCH, MOE_ARCHS[0], RWKV_ARCH, HYMBA_ARCH, *CROSS_ARCHS)
SHARD_TRAINS = (TrainSpec("qwen2.5-3b", 4, 2048, 1, 3, layers=4),
                TrainSpec(RWKV_ARCH, 4, 2048, 1, 3, layers=8),
                TrainSpec(HYMBA_ARCH, 2, 2048, 1, 3, layers=4))
SHARD_WAYS = (1, 2, 4, 8)
# the sharded train run that checkpoints (after SHARD_CKPT_AT steps) and is
# resumed from the file by a sharded model from another seed
SHARD_CKPT, SHARD_CKPT_AT = "qwen2.5-3b", 1


def shard_bytes(get_config):
    """Per-GPU bytes of each dense config's bf16 weights and f32 AdamW
    moments (ZeRO-1) at model ways SHARD_WAYS on one 8-GPU host (data ways
    8 / model ways), from the placement tables of a meta-device model,
    beside the cost model's ``min_fraction_units`` on that host.  Printed,
    not checked."""
    import torch

    from repro_torch import hw
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.distributed.sharding import check_shardable, per_gpu_bytes
    from repro_torch.models.transformer import DenseLM
    from repro_torch.serving.costmodel import min_fraction_units

    rows = []
    for arch in sorted(n for n, c in REGISTRY.items() if c.family == "dense"):
        cfg = get_config(arch)
        model = DenseLM(cfg, device="meta", dtype=torch.bfloat16)
        row = {"arch": arch, "min_fraction_units": min_fraction_units(
            cfg, hw.H100_HOST_8), "fractions_per_chip": hw.H100_HOST_8.fractions_per_chip}
        for ways in SHARD_WAYS:
            sizes = {"data": 8 // ways, "model": ways}
            try:
                check_shardable(cfg, sizes)
                runs = True
            except ValueError:
                runs = False
            b = per_gpu_bytes(model, sizes)
            row[f"model_{ways}"] = {"weights_gb": b["weights"] / 1e9,
                                    "moments_gb": b["moments"] / 1e9,
                                    "shard_model_runs": runs}
        rows.append(row)
    return rows


def _recording_kernels(seen):
    """Wrap the kernel wrappers that the models call (the attention ones in
    ``models.layers``, the WKV6 one in ``models.rwkv``) so that the types
    of their tensor arguments land in ``seen``; returns the undo."""
    from repro_torch.models import layers, rwkv

    targets = [(layers, "flash_attention_op"), (layers, "decode_attention_op"),
               (rwkv, "wkv6_op")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def wrap(fn):
        def call(*args, **kwargs):
            seen.update(type(a).__name__ for a in args if hasattr(a, "dtype"))
            return fn(*args, **kwargs)
        return call

    for mod, name, fn in saved:
        setattr(mod, name, wrap(fn))
    return lambda: [setattr(mod, name, fn) for mod, name, fn in saved]


def _engine_serve(torch, np, model, dev, common):
    """A call that serves SHARD_REQUESTS requests of ``model``'s engine
    phase (the llama traffic for a dense or MoE decoder, the rwkv traffic
    for rwkv6-7b and hymba-1.5b), SHARD_NEW tokens each, through
    ``ServingEngine``, the launch counts set to 0 just before; returns
    (tokens by request, wall s, launches, decode steps, ms a decode step
    of the wall)."""
    from repro_torch.serving.engine import ServeRequest, ServingEngine

    prompts = (rwkv_prompts if model.cfg.family in ("ssm", "hybrid")
               else llama_prompts)
    reqs = prompts(np, model.cfg)[:SHARD_REQUESTS]

    def serve():
        engine = ServingEngine(model, device=dev, slots=8, max_len=4096)
        for i, prompt in enumerate(reqs):
            engine.submit(ServeRequest(i, prompt, max_new_tokens=SHARD_NEW))
        torch.cuda.synchronize()
        common.reset_launch_counts()
        t = time.perf_counter()
        done = engine.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        steps = engine.stats["decode_steps"]
        return ({r.req_id: list(r.generated) for r in done}, wall,
                dict(common.launch_counts), steps, 1e3 * wall / steps)

    return serve, len(reqs)


def _generate_serve(torch, np, model, common):
    """A call that runs GENERATE's batch (8 prompts of 512 tokens over
    seeded stub inputs) through ``generate`` for SHARD_NEW greedy steps,
    the launch counts set to 0 just before; returns (tokens by row, wall
    s, launches, decode steps, ms a decode step)."""
    from repro_torch.launch.serve_model import generate, stub_inputs

    cfg = model.cfg
    requests, prompt, _ = GENERATE
    rng = np.random.default_rng(SEED + 6)
    tokens = rng.integers(0, cfg.vocab_size, size=(requests, prompt))
    inputs = torch.from_numpy(stub_inputs(cfg, requests, rng)).to(model.device)

    def serve():
        torch.cuda.synchronize()
        common.reset_launch_counts()
        out, times = generate(model, tokens, inputs, SHARD_NEW)
        return (dict(enumerate(out.tolist())), times["prefill_s"] + times["decode_s"],
                dict(common.launch_counts), SHARD_NEW,
                1e3 * times["decode_s"] / SHARD_NEW)

    return serve, requests


def shard_serve(torch, np, cfg, dev, build_model, common, mesh):
    """``cfg`` at full width and depth (bf16 weights from SEED, a VLM's
    gates seeded nonzero) serves unsharded, then sharded in place over
    ``mesh``: the engine (``_engine_serve``) or, for the VLM and the
    enc-dec, ``generate`` (``_generate_serve``).  ``ok`` needs every weight
    a DTensor, the same tokens, the same launch counts of every kernel
    (each of the path's launched), and only plain tensors handed to the
    kernel wrappers.  The wall seconds and step ms of both runs are
    printed, not checked."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import shard_model

    model = seeded_model(torch, np, cfg, dev, build_model, torch.bfloat16)
    if cfg.family in ("vlm", "audio"):
        serve, requests = _generate_serve(torch, np, model, common)
    else:
        serve, requests = _engine_serve(torch, np, model, dev, common)
    names = (("wkv6_chunk", "wkv6_scan") if cfg.family == "ssm"
             else ("flash_attention", "decode_attention"))
    tokens, wall, launches, steps, step_ms = serve()
    shard_model(model, mesh)
    dtensors = all(isinstance(p, DTensor) for p in model.parameters())
    seen = set()
    undo = _recording_kernels(seen)
    try:
        tokens_s, wall_s, launches_s, steps_s, step_ms_s = serve()
    finally:
        undo()
    result = {
        "run": "serve", "arch": cfg.name, "layers": cfg.num_layers,
        "requests": requests, "new_tokens": SHARD_NEW,
        "every_weight_a_dtensor": dtensors, "kernel_input_types": sorted(seen),
        "tokens_equal": tokens_s == tokens, "requests_done": len(tokens_s),
        "decode_steps": steps_s, "wall_s": wall, "wall_s_sharded": wall_s,
        "step_ms": step_ms, "step_ms_sharded": step_ms_s,
        "launches": launches, "launches_sharded": launches_s}
    result["ok"] = (dtensors and result["tokens_equal"] and len(tokens) == requests
                    and seen == {"Tensor"} and steps == steps_s
                    and launches == launches_s
                    and all(launches.get(n, 0) > 0 for n in names))
    del model
    return result


def shard_train(torch, np, spec: TrainSpec, dev, build_model, common, get_config,
                mesh):
    """``spec`` (an entry of SHARD_TRAINS): its arch at full width and
    ``spec.layers`` layers, bf16 weights from SEED, SyntheticCorpus
    batches, ``spec.steps`` AdamW steps unsharded (U), then as many from
    the same seed sharded over ``mesh`` with ZeRO-1 moments (S).  ``ok``
    needs S's losses, weights, moments and step bit-equal to U's, and
    exactly ``train_launches`` in every step of both.

    For SHARD_CKPT's arch, S saves a checkpoint (``training.checkpoint``,
    gathered from the DTensors) after SHARD_CKPT_AT steps into a directory
    under ``build/`` that is removed at the end, and R, a sharded model
    drawn from another seed, restores it (each DTensor its own slice) and
    takes the remaining steps: ``ok`` also needs the file written once at
    the unsharded shapes (``writers`` 1, one shard) and R bit-equal to S
    in every loss after the save and in the final weights, moments and
    step."""
    import shutil
    import tempfile

    from repro_torch.analysis.op_stats import train_launches
    from repro_torch.distributed.sharding import local, shard_model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import DataConfig, SyntheticCorpus
    from repro_torch.training.optimizer import AdamWConfig, init_state
    from repro_torch.training.train_loop import make_train_step

    cfg = dataclasses.replace(get_config(spec.arch), num_layers=spec.layers)
    data = SyntheticCorpus(DataConfig(cfg.vocab_size, spec.seq, spec.batch, seed=SEED))
    per_step = train_launches(cfg, spec.microbatches)
    expected = {name: per_step.get(name, 0) for name in common.KERNELS}
    ckpt_dir = None
    if spec.arch == SHARD_CKPT:
        (ROOT / "build").mkdir(exist_ok=True)
        ckpt_dir = tempfile.mkdtemp(prefix="shard_ckpt_", dir=ROOT / "build")
    io = {}

    def run(sharded, seed=SEED, restore=False):
        model = seeded_model(torch, np, cfg, dev, build_model, torch.bfloat16, seed)
        # each weight's unsharded shape: hymba's ``w_in`` is sharded as its
        # (d, 2, h) view, which the comparison reads back as (d, 2h)
        shapes = {n: p.shape for n, p in model.named_parameters()}
        if sharded:
            shard_model(model, mesh)
        step_fn = make_train_step(model, AdamWConfig(lr=spec.lr, warmup_steps=TRAIN_WARMUP),
                                  num_microbatches=spec.microbatches)
        state = init_state(dict(model.named_parameters()))
        start = 0
        if restore:
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, start, _ = ckpt.restore_checkpoint(ckpt_dir, model, state)
            torch.cuda.synchronize()
            io["restore_s"] = time.perf_counter() - t
        losses, ms, launches_ok, totals = [], [], True, Counter()
        for step in range(start, spec.steps):
            torch.cuda.synchronize()
            common.reset_launch_counts()
            t = time.perf_counter()
            state, metrics = step_fn(state, data.batch_at(step))
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            launches_ok = launches_ok and dict(common.launch_counts) == expected
            totals.update(common.launch_counts)
            if sharded and not restore and ckpt_dir and step + 1 == SHARD_CKPT_AT:
                torch.cuda.synchronize()
                t = time.perf_counter()
                path = Path(ckpt.save_checkpoint(ckpt_dir, step + 1, model, state))
                io["save_s"] = time.perf_counter() - t
                io["files"] = sorted(f.name for f in path.iterdir())
                io["bytes"] = sum(f.stat().st_size for f in path.iterdir())
                manifest = json.loads((path / "manifest.json").read_text())
                io["writers"] = manifest["writers"]
                io["shapes_unsharded"] = all(
                    manifest["leaves"][f"param/{n}"]["shape"] == list(shp)
                    for n, shp in shapes.items())
        tensors = {f"param/{n}": local(p).detach().reshape(shapes[n])
                   for n, p in model.named_parameters()}
        tensors.update({f"m/{n}": local(t).reshape(shapes[n]) for n, t in state.m.items()})
        tensors.update({f"v/{n}": local(t).reshape(shapes[n]) for n, t in state.v.items()})
        tensors["step"] = state.step
        return losses, ms, launches_ok, totals, tensors

    try:
        losses_u, ms_u, ok_u, totals_u, tensors = run(False)
        final_u = {k: t.clone() for k, t in tensors.items()}
        del tensors
        gc.collect()
        torch.cuda.empty_cache()
        losses_s, ms_s, ok_s, totals_s, tensors = run(True)
        unequal = _unequal(torch, final_u, tensors)
        del final_u
        if ckpt_dir:
            final_s = {k: t.clone() for k, t in tensors.items()}
            del tensors
            gc.collect()
            torch.cuda.empty_cache()
            losses_r, _, ok_r, totals_r, tensors = run(True, seed=SEED + 1, restore=True)
            io["unequal_restored"] = _unequal(torch, final_s, tensors)[:8]
            io["losses_restored"] = losses_r
            io["ok"] = (losses_r == losses_s[SHARD_CKPT_AT:] and not io["unequal_restored"]
                        and ok_r and io["writers"] == 1 and io["files"] == [
                            "manifest.json", "shard_0.npz"] and io["shapes_unsharded"])
            io["gb_per_s_save"] = io["bytes"] / io["save_s"] / 1e9
            io["gb_per_s_restore"] = io["bytes"] / io["restore_s"] / 1e9
            totals_s.update(totals_r)
            del final_s
        del tensors
    finally:
        if ckpt_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    result = {
        "run": "train", "arch": cfg.name, "layers": cfg.num_layers,
        "batch": spec.batch, "seq": spec.seq, "microbatches": spec.microbatches,
        "steps": spec.steps, "losses": losses_u, "losses_sharded": losses_s,
        "step_ms": ms_u, "step_ms_sharded": ms_s, "unequal": unequal[:8],
        "unequal_count": len(unequal),
        "launches_per_step_expected": {k: n for k, n in expected.items() if n},
        "launches": {k: n for k, n in totals_u.items() if n},
        "launches_sharded": {k: n for k, n in totals_s.items() if n}}
    if ckpt_dir:
        result["checkpoint"] = {"at_step": SHARD_CKPT_AT, **io}
    result["ok"] = (losses_s == losses_u and not unequal and ok_u and ok_s
                    and bool(np.isfinite(losses_u).all())
                    and (not ckpt_dir or io["ok"]))
    return result


def shard_phase(torch, np, dev, build_model, common, get_config, mesh):
    """The ``shard`` phase: the per-GPU bytes table, then over ``mesh``,
    ``single_device_mesh()`` (a one-rank NCCL process group), a
    ``shard_serve`` of each of SHARD_SERVE and a ``shard_train`` of each of
    SHARD_TRAINS, one model on the card at a time; one line per run, then
    the phase's seconds (the runs, not the table) and its sharded runs'
    launches by kernel, summed over the runs, which it returns."""
    emit({"phase": "shard", "run": "bytes", "host_gpus": 8,
          "per_gpu": shard_bytes(get_config)})
    t0 = time.perf_counter()
    results = []

    def record(result):
        results.append(result)
        emit({"phase": "shard", "mesh": list(mesh.shape), **result})
        gc.collect()
        torch.cuda.empty_cache()

    try:
        for arch in SHARD_SERVE:
            record(shard_serve(torch, np, get_config(arch), dev, build_model,
                               common, mesh))
        for spec in SHARD_TRAINS:
            record(shard_train(torch, np, spec, dev, build_model, common,
                               get_config, mesh))
    finally:
        gc.collect()
        torch.cuda.empty_cache()
    for r in results:
        if not r["ok"]:
            raise SmokeFailure(f"shard: the sharded {r['run']} run of {r['arch']} "
                               "differs from the unsharded one")
    # each kernel's launches in every sharded run, summed
    launches = sum((Counter(r["launches_sharded"]) for r in results), Counter())
    summary = {"seconds": time.perf_counter() - t0, "launches": dict(launches),
               "launches_by_run": [{"run": r["run"], "arch": r["arch"],
                                    **r["launches_sharded"]} for r in results]}
    emit({"phase": "shard", "run": "summary", **summary})
    return summary


# ---------------------------------------------------------------------------
# phase 14: the dry-run's counts held to the card
# ---------------------------------------------------------------------------

DRYRUN_PREFILL = 1000  # llama-3.1-8b's prompt tokens in the dryrun phase
DRYRUN_PEAK_TOL = 0.10  # the counted peak against max_memory_allocated
DRYRUN_STEPS = 3  # measured train steps, after one warm-up step
DRYRUN_CELL = ("qwen2.5-3b", "train_4k", "gpu32x8")
DRYRUN_COUNTS = ROOT / "build" / "dryrun" / "chip_counts.json"
DRYRUN_WAIT_S = 600  # the most the phase waits for the counting process

# the processes the script starts, stopped at its end (``main``)
CHILDREN = []


def dryrun_counts():
    """The dry-run's counts (``launch.dryrun.count_step`` on the meta
    device) of the phase's two steps on the (1, 1) mesh of a one-rank fake
    process group, qwen2.5-3b's train step at TRAIN_RUNS[0]'s shape and
    llama-3.1-8b's prefill of one DRYRUN_PREFILL-token prompt, then
    DRYRUN_CELL's record (``launch.dryrun.run_cell``, 256 fake ranks),
    written to DRYRUN_COUNTS.  It runs in a process of its own on the host
    (``start_dryrun_counts``), beside the card's phases: it computes
    nothing on the card, and a fake process group cannot share the
    process with the card's NCCL group."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import AXES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    spec = TRAIN_RUNS[0]
    out = {}
    with dryrun.fake_world(1):
        mesh = make_mesh((1, 1), AXES, device_type="cpu")
        for run, cfg, shape, mb in (
                ("train", get_config(spec.arch),
                 InputShape("chip_train", spec.seq, spec.batch, "train"),
                 spec.microbatches),
                ("prefill", get_config(ARCH),
                 InputShape("chip_prefill", DRYRUN_PREFILL, 1, "prefill"), None)):
            t0 = time.perf_counter()
            out[run] = dryrun.count_step(cfg, shape, mesh, num_microbatches=mb)
            out[run]["count_s"] = time.perf_counter() - t0
            del out[run]["trace"]
    out["cell"] = dryrun.run_cell(*DRYRUN_CELL, out_dir=DRYRUN_COUNTS.parent, force=True)
    DRYRUN_COUNTS.write_text(json.dumps(out))


def start_dryrun_counts():
    """``dryrun_counts`` in a spawned process (no CUDA state inherited),
    started now and joined by the ``dryrun`` phase."""
    import multiprocessing

    DRYRUN_COUNTS.parent.mkdir(parents=True, exist_ok=True)
    DRYRUN_COUNTS.unlink(missing_ok=True)
    proc = multiprocessing.get_context("spawn").Process(target=dryrun_counts)
    proc.start()
    CHILDREN.append(proc)
    return proc


def dryrun_card(torch, np, dev, build_model, common, get_config, mesh):
    """The same two steps on the card, sharded over ``mesh``: qwen2.5-3b
    from SEED, one warm-up step on SyntheticCorpus, then DRYRUN_STEPS steps
    with the peak memory reset before the first (the previous step's
    gradients dropped first, as the step itself drops them) and the launch
    counts set to 0 before each step and read after it; then llama-3.1-8b's
    prefill of a seeded prompt, its counts read the same way."""
    from repro_torch.distributed.sharding import shard_model
    from repro_torch.training.data import DataConfig, SyntheticCorpus
    from repro_torch.training.optimizer import AdamWConfig, init_state
    from repro_torch.training.train_loop import make_train_step

    spec = TRAIN_RUNS[0]
    cfg = get_config(spec.arch)
    model = shard_model(seeded_model(torch, np, cfg, dev, build_model, torch.bfloat16), mesh)
    params = dict(model.named_parameters())
    step_fn = make_train_step(model, AdamWConfig(lr=spec.lr, warmup_steps=TRAIN_WARMUP),
                              num_microbatches=spec.microbatches)
    state = init_state(params)
    data = SyntheticCorpus(DataConfig(cfg.vocab_size, spec.seq, spec.batch, seed=SEED))
    state, _ = step_fn(state, data.batch_at(0))
    for p in params.values():
        p.grad = None
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, launches, losses = [], [], []
    for step in range(1, DRYRUN_STEPS + 1):
        batch = data.batch_at(step)
        torch.cuda.synchronize()
        common.reset_launch_counts()
        t = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        launches.append({k: n for k, n in common.launch_counts.items() if n})
    train = {"step_ms": ms, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
             "launches": launches, "losses": losses}
    del model, params, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config(ARCH)
    model = shard_model(seeded_model(torch, np, cfg, dev, build_model, torch.bfloat16), mesh)
    prompt = np.random.default_rng(SEED).integers(0, cfg.vocab_size, size=(1, DRYRUN_PREFILL))
    torch.cuda.synchronize()
    common.reset_launch_counts()
    logits, _ = model.prefill(prompt)
    torch.cuda.synchronize()
    prefill = {"launches": {k: n for k, n in common.launch_counts.items() if n},
               "finite": bool(torch.isfinite(logits).all())}
    del model, logits
    gc.collect()
    torch.cuda.empty_cache()
    return train, prefill


def dryrun_phase(torch, np, dev, build_model, common, get_config, counting, mesh):
    """The ``dryrun`` phase: the dry-run's counts held to the card.  The
    qwen2.5-3b train step counted on the meta device must call each kernel
    exactly as often as the card launches it in every measured step (288
    flash forwards and 144 backwards, ``train_launches``), and its counted
    peak must lie within DRYRUN_PEAK_TOL of ``max_memory_allocated``; the
    counted FLOPs over the measured step time are printed as TFLOP/s and as
    a share of 989.  llama-3.1-8b's prefill: the same call equality.  Then
    one production cell (DRYRUN_CELL, 256 GPUs under a fake process group)
    counted on the meta device: its per-GPU peak and collective bytes.  The
    counts come from ``counting`` (``start_dryrun_counts``); the card runs
    over ``mesh``.  Returns the card runs' launches."""
    from repro_torch.analysis.op_stats import train_launches

    t0 = time.perf_counter()
    counting.join(DRYRUN_WAIT_S)
    if counting.exitcode != 0 or not DRYRUN_COUNTS.exists():
        raise SmokeFailure(f"dryrun: the counting process ended with "
                           f"{counting.exitcode}")
    counted = json.loads(DRYRUN_COUNTS.read_text())
    cell = counted["cell"]
    waited_s = time.perf_counter() - t0
    card, card_prefill = dryrun_card(torch, np, dev, build_model, common,
                                     get_config, mesh)
    smi = nvidia_smi_line()
    spec = TRAIN_RUNS[0]
    stats, mem = counted["train"]["op_stats"], counted["train"]["memory"]
    calls = {k: v["calls"] for k, v in stats["kernels"].items()}
    want = train_launches(get_config(spec.arch), spec.microbatches)
    peak = card["max_memory_allocated_bytes"]
    best_s = min(card["step_ms"]) / 1e3
    train = {
        "phase": "dryrun", "run": "train", "arch": spec.arch, "mesh": [1, 1],
        "batch": spec.batch, "seq": spec.seq, "microbatches": spec.microbatches,
        "count_s": counted["train"]["count_s"], "counted_calls": calls,
        "card_launches": card["launches"], "train_launches": want,
        "counted_memory": mem, "counted_peak_bytes": mem["peak_bytes"],
        "max_memory_allocated_bytes": peak,
        "peak_rel_err": (mem["peak_bytes"] - peak) / peak, "peak_tol": DRYRUN_PEAK_TOL,
        "counted_flops": stats["total_flops"], "counted_aten_flops": stats["flops"],
        "counted_kernel_flops": stats["kernel_flops"], "counted_bytes": stats["total_bytes"],
        "counted_collectives": stats["collectives"],
        "step_ms": card["step_ms"], "losses": card["losses"], "waited_s": waited_s,
        "tflops_per_s": stats["total_flops"] / best_s * 1e-12,
        "share_of_989": stats["total_flops"] / best_s / PEAK_OPS["bfloat16"],
        "nvidia_smi": smi}
    train["ok"] = (all(launches == calls for launches in card["launches"])
                   and calls == want and abs(train["peak_rel_err"]) <= DRYRUN_PEAK_TOL
                   and bool(np.isfinite(card["losses"]).all()))
    emit(train)
    p_calls = {k: v["calls"] for k, v in counted["prefill"]["op_stats"]["kernels"].items()}
    prefill = {"phase": "dryrun", "run": "prefill", "arch": ARCH, "mesh": [1, 1],
               "tokens": DRYRUN_PREFILL, "count_s": counted["prefill"]["count_s"],
               "counted_calls": p_calls, "card_launches": card_prefill["launches"],
               "counted_memory": counted["prefill"]["memory"],
               "counted_flops": counted["prefill"]["op_stats"]["total_flops"],
               "finite": card_prefill["finite"]}
    prefill["ok"] = p_calls == card_prefill["launches"] and card_prefill["finite"]
    emit(prefill)
    row = {"phase": "dryrun", "run": "cell", "arch": cell["arch"], "shape": cell["shape"],
           "mesh": cell["mesh"], "status": cell["status"]}
    if cell["status"] == "ok":
        row.update({"num_devices": cell["num_devices"], "count_s": cell["count_s"],
                    "microbatches": cell["microbatches"],
                    "per_gpu_peak_gb": cell["memory"]["peak_bytes"] / 1e9,
                    "per_gpu_collective_gb": cell["collectives"]["total_bytes"] / 1e9,
                    "collectives": cell["collectives"],
                    "per_gpu_tflop": cell["op_stats"]["total_flops"] / 1e12,
                    "per_gpu_gb_moved": cell["op_stats"]["total_bytes"] / 1e9,
                    "memory": cell["memory"]})
    else:
        row["error"] = cell.get("error", cell.get("reason"))
    emit(row)
    for r in (train, prefill):
        if not r["ok"]:
            raise SmokeFailure(f"dryrun: the counted {r['run']} of {r['arch']} "
                               "differs from the card")
    if cell["status"] != "ok":
        raise SmokeFailure(f"dryrun: the {'/'.join(DRYRUN_CELL)} cell is {cell['status']}")
    return {"flash_attention": card["launches"][0].get("flash_attention", 0)
            + card_prefill["launches"].get("flash_attention", 0),
            "flash_attention_bwd": card["launches"][0].get("flash_attention_bwd", 0)}


# ---------------------------------------------------------------------------
# phase 15: the planner on H100 hosts
# ---------------------------------------------------------------------------

PLAN_RATE = 0.4  # req/s, the launcher's default target
PLAN_TRACE_REQUESTS = 30  # as repro_torch.launch.serve traces


def plan_deploys(torch):
    """Scepsy's ``deploy`` for beam_search and rag_reranker on one 8-GPU
    H100 host and on four, each plan held to: a placement that validates,
    every TP group inside one NVLink domain, every model (weights and one
    2048-token sequence's KV) within the h100 class's HBM at its tp and
    fraction, and that HBM within the card's own memory."""
    from repro_torch import hw
    from repro_torch.core.placement import PlacementError
    from repro_torch.core.scepsy import deploy
    from repro_torch.serving import costmodel as cm
    from repro_torch.workflows.beam_search import BEAM_SEARCH
    from repro_torch.workflows.rag_reranker import RAG_RERANKER

    card_bytes = torch.cuda.get_device_properties(0).total_memory
    results = []
    for wf in (BEAM_SEARCH, RAG_RERANKER):
        for spec in (hw.H100_HOST_8, hw.H100_CLUSTER_32):
            t0 = time.perf_counter()
            dep = deploy(wf, spec, PLAN_RATE,
                         n_trace_requests=PLAN_TRACE_REQUESTS, seed=SEED)
            plan_s = time.perf_counter() - t0
            try:
                dep.placement.validate()
                validates = True
            except PlacementError:
                validates = False
            table = spec.chip_table()
            in_domain = all(len({table[c][1] for c in inst.chips}) == 1
                            for inst in dep.placement.instances)
            fits = all(cm.max_batch_size(wf.llms[m], 2048, tp=a.tp,
                                         fraction=a.fraction, chip=hw.H100) >= 1
                       for m, a in dep.schedule.allocations.items())
            pred = dep.schedule.prediction
            result = {
                "phase": "plan", "workflow": wf.name, "gpus": spec.num_chips,
                "hosts": spec.total_hosts, "nvlink_domain": spec.hb_domain_size,
                "chip_class": hw.DEFAULT_CHIP_CLASS.name, "rate": PLAN_RATE,
                "plan_s": plan_s,
                "allocations": {m: {"replicas": a.replicas, "tp": a.tp,
                                    "fraction": a.fraction}
                                for m, a in dep.schedule.allocations.items()},
                "predicted_latency_s": pred.latency,
                "predicted_max_throughput": pred.max_throughput,
                "feasible": pred.feasible,
                "placement": [{"llm": i.llm, "replica": i.replica, "tp": i.tp,
                               "chips": i.chips, "units": i.units_per_chip,
                               "host": i.host, "domain": i.domain}
                              for i in dep.placement.instances],
                "validates": validates, "tp_in_one_domain": in_domain,
                "fits_hbm": fits, "class_hbm_bytes": hw.H100.hbm_bytes,
                "card_bytes": card_bytes,
            }
            result["ok"] = (validates and in_domain and fits
                            and hw.H100.hbm_bytes <= card_bytes)
            results.append(result)
    return results


PLAN_ONLINE_REQUESTS = 40  # the traced ClusterDriver run's requests


def plan_online():
    """``deploy_multi(online=True)`` of beam_search and rag_reranker at
    PLAN_RATE each on ``H100_CLUSTER_32``; its controller stepped after
    arrivals at the planned rate, then at 2.5x beam_search's (its re-plans
    counted); then one ``ClusterDriver`` run of rag_reranker on its share
    with a ``Tracer`` installed (the spans counted)."""
    import math

    from repro_torch import hw
    from repro_torch.core.scepsy import deploy_multi
    from repro_torch.obs import Tracer, install_tracer
    from repro_torch.serving.deploy import routers_from_allocations
    from repro_torch.serving.simulator import EventLoop
    from repro_torch.workflows.beam_search import BEAM_SEARCH
    from repro_torch.workflows.rag_reranker import RAG_RERANKER
    from repro_torch.workflows.runtime import ClusterDriver

    t0 = time.perf_counter()
    lams = {wf.name: PLAN_RATE for wf in (BEAM_SEARCH, RAG_RERANKER)}
    dep = deploy_multi([BEAM_SEARCH, RAG_RERANKER], hw.H100_CLUSTER_32, lams,
                       online=True, n_trace_requests=10, max_profile_groups=8,
                       seed=SEED)
    ctrl = dep.controller
    plan_s = time.perf_counter() - t0
    t, actions = 0.0, []
    for factor, n in ((1.0, 100), (2.5, 400)):
        for _ in range(n):
            ctrl.monitor.record_arrival(BEAM_SEARCH.name, t)
            t += 1.0 / (PLAN_RATE * factor)
        act = ctrl.step()
        actions.append(None if act is None else
                       {"rung": act.rung, "reason": act.reason, "feasible": act.feasible,
                        "lam_targets": act.lam_targets})
    replans = [h.rung for h in ctrl.history]

    loop = EventLoop()
    allocs = dep.schedule.per_workflow[RAG_RERANKER.name].allocations
    drv = ClusterDriver(RAG_RERANKER, routers_from_allocations(RAG_RERANKER, allocs, loop), loop)
    tracer = Tracer(sample_per_workflow=16, seed=SEED)
    install_tracer(tracer, drivers=[drv])
    drv.schedule_open_loop(PLAN_RATE, PLAN_ONLINE_REQUESTS, seed=SEED, arrival_seed=SEED + 100)
    loop.run(math.inf)
    export = tracer.export()
    traces = export["traces"]
    spans = {"traces": len(traces), "phases": sum(len(tr["phases"]) for tr in traces),
             "calls": sum(len(tr["calls"]) for tr in traces)}
    result = {"phase": "plan", "online": True, "workflows": sorted(lams),
              "gpus": hw.H100_CLUSTER_32.num_chips, "plan_s": plan_s,
              "actions": actions, "replans": len(replans), "rungs": replans,
              "lam_targets": ctrl.lam_targets,
              "traced_requests": PLAN_ONLINE_REQUESTS, "completed": drv.n_completed,
              "spans": spans, "exposition_lines": len(export["exposition"].splitlines())}
    result["ok"] = (bool(replans) and all(a is None or a["feasible"] for a in actions)
                    and drv.n_completed == PLAN_ONLINE_REQUESTS and spans["calls"] > 0)
    return result


def plan_tiles(torch, flash_ops, checks):
    """The host's Hopper tile plan of every flash shape the kernel checks
    ran, against the plan the kernel library reports for it on this card
    (``flash_attention_plan``)."""
    from repro_torch.kernels.tile_plan import tile_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for c in checks:
        if c["kernel"] != "flash_attention":
            continue
        B, S, H, D = (c["shape"][k] for k in ("B", "S", "H", "D"))
        want = tile_plan(B, H, S, D, sms, dtype=c["dtype"])
        got = flash_ops.flash_attention_plan(B, H, S, D, getattr(torch, c["dtype"]))
        rows.append({"shape": c["shape"], "dtype": c["dtype"],
                     "kernel": list(got), "plan": list(want.kernel_numbers()),
                     "blocks": want.blocks, "waves": want.waves,
                     "ok": tuple(got) == want.kernel_numbers()})
    return {"phase": "plan", "tile_plans": rows, "sms": sms,
            "ok": bool(rows) and all(r["ok"] for r in rows)}


def plan_predictions(engine_results, steps):
    """The cost model's decode-step and prefill times (h100 class, tp=1) at
    the engine phases' own batches, contexts and prompt lengths, beside the
    times those phases measured.  Printed, not checked: the engine's steps
    are host-bound, and these are the data the class's calibration starts
    from.  The cost model prices an MoE prefill by its active parameters
    (K of E experts per token); the dispatch the port keeps from the
    reference computes E x (C + 1) expert slots per batch row, and an MoE
    row gives that count over the S x K choices, averaged over the run's
    prefills."""
    from repro_torch import hw
    from repro_torch.configs.registry import get_config
    from repro_torch.models.moe import capacity_per_row
    from repro_torch.serving import costmodel as cm

    rows = []
    for result in engine_results:
        cfg = get_config(result["arch"])
        run = steps[cfg.name]
        decode = [cm.decode_step_cost(cfg, b, int(ctx), tp=1, chip=hw.H100)
                  for b, ctx in run["decode"]]
        prefill = [cm.prefill_cost(cfg, n, tp=1, chip=hw.H100)
                   for n, _ in run["prefill"]]
        rows.append({
            "arch": cfg.name, "decode_steps": len(decode),
            "mean_batch": sum(b for b, _ in run["decode"]) / len(decode),
            "mean_context": sum(c for _, c in run["decode"]) / len(decode),
            "decode_step_ms_predicted": 1e3 * sum(c.total for c in decode) / len(decode),
            "decode_step_ms_measured": result["decode_step_ms"],
            "decode_bottleneck": Counter(c.bottleneck
                                        for c in decode).most_common(1)[0][0],
            "prefills": len(prefill),
            "mean_prompt_tokens": sum(n for n, _ in run["prefill"]) / len(prefill),
            "prefill_ms_predicted": 1e3 * sum(c.total for c in prefill) / len(prefill),
            "prefill_ms_measured": result["prefill_ms"],
        })
        if cfg.is_moe:
            E, K = cfg.num_experts, cfg.experts_per_token
            rows[-1]["prefill_dispatch_slots_per_choice"] = sum(
                E * (capacity_per_row(n, cfg) + 1) / (n * K)
                for n, _ in run["prefill"]) / len(prefill)
    return {"phase": "plan", "predicted_vs_measured": rows, "chip_class": "h100",
            "tp": 1}


def plan_phase(torch, flash_ops, checks, engine_results, steps):
    for result in plan_deploys(torch):
        emit(result)
        if not result["ok"]:
            raise SmokeFailure(f"plan of {result['workflow']} on "
                               f"{result['gpus']} GPUs failed its checks")
    result = plan_online()
    emit(result)
    if not result["ok"]:
        raise SmokeFailure("the online deploy or the traced run failed its checks")
    result = plan_tiles(torch, flash_ops, checks)
    emit(result)
    if not result["ok"]:
        raise SmokeFailure("a flash tile plan differs from the kernel's")
    emit(plan_predictions(engine_results, steps))


def run():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device is available")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SmokeFailure("src/repro_torch is not beside this script")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import common
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv6_ops
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    reports = common.build(common.KERNELS)
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "kernels": {name: {"seconds": r["seconds"],
                             "ptxas": ptxas_summary(r["ptxas"])}
                      for name, r in reports.items()},
          "cached": sorted(set(common.KERNELS) - set(reports))})
    spills = [(name, e["entry"]) for name, r in reports.items()
              for e in ptxas_summary(r["ptxas"])
              if any(m in e["entry"] for m in NO_SPILL_ENTRIES.get(name, ()))
              and e.get("spill_store_bytes", 0) > 0]
    if spills:
        raise SmokeFailure(f"kernel entries that must not spill do: {spills}")
    counting = start_dryrun_counts()
    for name in common.KERNELS:
        result = sass_counts(common, name)
        emit(result)
        if result.get("ok") is False:
            raise SmokeFailure(f"{name}: a bf16 entry has no tensor-core "
                               "instruction in its SASS")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        checks = [check_flash(torch, F, flash_ops, dev, gen, *c) for c in FLASH_CASES]
        checks += [check_decode(torch, F, decode_ops, dev, gen, *c)
                   for c in DECODE_CASES]
    emit({"phase": "kernel_checks", "checks": checks})
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise SmokeFailure(f"{len(bad)} kernel check(s) out of tolerance")

    cfg = get_config(ARCH)
    result, model = model_check(torch, np, cfg, dev, build_model)
    emit(result)
    if not result["ok"]:
        raise SmokeFailure("full-width model check failed")
    torch.cuda.empty_cache()

    engines, steps, predicted = {}, {}, []
    result, steps[cfg.name] = engine_run(
        torch, np, model, common, llama_prompts(np, cfg),
        ("flash_attention", "decode_attention"), cached=True)
    emit(result)
    if not result["ok"]:
        raise SmokeFailure("engine run failed")
    engines["flash_attention"] = engines["decode_attention"] = result
    predicted.append(result)

    # the rwkv6-7b path, on a card free of the llama model
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        wkv = [check_wkv6(torch, wkv6_ops, dev, gen, *c) for c in WKV6_CASES]
    emit({"phase": "kernel_checks", "checks": wkv})
    bad = [c for c in wkv if not c["ok"]]
    if bad:
        raise SmokeFailure(f"{len(bad)} wkv6 kernel check(s) out of tolerance")
    checks += wkv

    cfg = get_config(RWKV_ARCH)
    result, model = model_check(torch, np, cfg, dev, build_model)
    emit(result)
    if not result["ok"]:
        raise SmokeFailure("full-width rwkv6-7b model check failed")
    torch.cuda.empty_cache()

    result, steps[cfg.name] = engine_run(
        torch, np, model, common, rwkv_prompts(np, cfg),
        ("wkv6_chunk", "wkv6_scan"), cached=False)
    # one launch per layer: of the chunked kernel in every prefill (every
    # prompt is bf16 and longer than one token), of the scan in every
    # decode step
    expected = {"wkv6_chunk": cfg.num_layers * result["requests"],
                "wkv6_scan": cfg.num_layers * result["decode_steps"]}
    result["launches_expected"] = expected
    result["ok"] = result["ok"] and all(result["launches"][name] == n
                                        for name, n in expected.items())
    emit(result)
    if not result["ok"]:
        raise SmokeFailure("rwkv6-7b engine run failed")
    engines["wkv6_chunk"] = engines["wkv6_scan"] = result
    predicted.append(result)

    # the MoE decoders, on a card free of rwkv6-7b: the attention kernels
    # at their heads, then each model checked and served, one at a time
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        moe_checks = [check_flash(torch, F, flash_ops, dev, gen, *c)
                      for c in MOE_FLASH_CASES]
        moe_checks += [check_decode(torch, F, decode_ops, dev, gen, *c)
                       for c in MOE_DECODE_CASES]
    emit({"phase": "kernel_checks", "checks": moe_checks})
    bad = [c for c in moe_checks if not c["ok"]]
    if bad:
        raise SmokeFailure(f"{len(bad)} MoE-shape kernel check(s) out of tolerance")
    checks += moe_checks
    moe_launches = {}
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        result, model = model_check(torch, np, cfg, dev, build_model)
        emit(result)
        if not result["ok"]:
            raise SmokeFailure(f"full-width {arch} model check failed")
        torch.cuda.empty_cache()
        # olmoe serves the llama traffic; granite-moe, twice as deep, half
        # of it with 16 new tokens each, to keep the script's time
        reqs, max_new = llama_prompts(np, cfg), 64
        if arch != MOE_ARCHS[0]:
            reqs, max_new = reqs[:8], 16
        result, steps[cfg.name] = engine_run(
            torch, np, model, common, reqs,
            ("flash_attention", "decode_attention"), cached=True, max_new=max_new)
        emit(result)
        if not result["ok"]:
            raise SmokeFailure(f"{arch} engine run failed")
        moe_launches[arch] = {k: result["launches"][k]
                              for k in ("flash_attention", "decode_attention")}
        if arch == MOE_ARCHS[0]:
            predicted.append(result)
        del model
        gc.collect()
        torch.cuda.empty_cache()

    # hymba-1.5b, on a card free of the MoE decoders: the attention kernels
    # at its heads, window and ring, the model over a prompt past the
    # window, and its engine (full-layer KV, window rings and Mamba states
    # in one cache, no prefix reuse)
    with torch.no_grad():
        hymba_checks = [check_flash(torch, F, flash_ops, dev, gen, *c)
                        for c in HYMBA_FLASH_CASES]
        hymba_checks += [check_decode(torch, F, decode_ops, dev, gen, *c)
                         for c in HYMBA_DECODE_CASES]
    emit({"phase": "kernel_checks", "checks": hymba_checks})
    bad = [c for c in hymba_checks if not c["ok"]]
    if bad:
        raise SmokeFailure(f"{len(bad)} hymba-shape kernel check(s) out of tolerance")
    checks += hymba_checks
    cfg = get_config(HYMBA_ARCH)
    result, model = model_check(torch, np, cfg, dev, build_model,
                                prompt_tokens=HYMBA_PROMPT)
    emit(result)
    if not result["ok"]:
        raise SmokeFailure(f"full-width {HYMBA_ARCH} model check failed")
    torch.cuda.empty_cache()
    result, steps[cfg.name] = engine_run(
        torch, np, model, common, rwkv_prompts(np, cfg),
        ("flash_attention", "decode_attention"), cached=False)
    emit(result)
    if not result["ok"]:
        raise SmokeFailure(f"{HYMBA_ARCH} engine run failed")
    hymba_launches = {k: result["launches"][k]
                      for k in ("flash_attention", "decode_attention")}
    predicted.append(result)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # the cross-attention decoders, on a card free of hymba: the attention
    # kernels at their shapes, then each model checked and generating, one
    # at a time
    with torch.no_grad():
        cross_checks = [check_flash(torch, F, flash_ops, dev, gen, *c)
                        for c in CROSS_FLASH_CASES]
        cross_checks += [check_decode(torch, F, decode_ops, dev, gen, *c)
                         for c in CROSS_DECODE_CASES]
    emit({"phase": "kernel_checks", "checks": cross_checks})
    bad = [c for c in cross_checks if not c["ok"]]
    if bad:
        raise SmokeFailure(f"{len(bad)} cross-attention kernel check(s) out "
                           "of tolerance")
    checks += cross_checks
    cross_launches = {}
    for arch in CROSS_ARCHS:
        cfg = get_config(arch)
        result, model = model_check(torch, np, cfg, dev, build_model)
        emit(result)
        if not result["ok"]:
            raise SmokeFailure(f"full-width {arch} model check failed")
        torch.cuda.empty_cache()
        result = generate_run(torch, np, model, common)
        emit(result)
        if not result["ok"]:
            raise SmokeFailure(f"{arch} generate run failed")
        cross_launches[cfg.family] = result["launches"]
        del model
        gc.collect()
        torch.cuda.empty_cache()

    # rag_reranker's encoders, on a card free of hymba
    encoders = {}
    for arch in ENCODER_ARCHS:
        result, encoders[arch] = encoder_check(torch, np, get_config(arch), dev,
                                               build_model)
        emit(result)
        if not result["ok"]:
            raise SmokeFailure(f"full-size {arch} encoder check failed")
    torch.cuda.empty_cache()
    result = encode_run(torch, np, encoders, common)
    emit(result)
    if not result["ok"]:
        raise SmokeFailure("rag_reranker encode run failed")
    encode_launches = result["launches"]["flash_attention"]

    del encoders
    gc.collect()
    torch.cuda.empty_cache()

    # training, on a card free of the encoders: the backward kernel's
    # checks, then each family's step parity and training run, one model at
    # a time, qwen2.5-3b first
    bwd_checks, trained = train_phase(torch, np, F, flash_ops, wkv6_ops, dev, gen,
                                      build_model, common, get_config)
    checks += bwd_checks
    train = trained[TRAIN_RUNS[0].arch]
    engines["flash_attention_bwd"] = train
    engines["wkv6_bwd"] = rwkv_train = trained[RWKV_ARCH]

    # checkpoint, resume and int8 compression of qwen2.5-3b's training, on
    # a card free of the training runs
    resume = resume_phase(torch, np, dataclasses.replace(
        get_config(RESUME.arch), num_layers=RESUME.layers), dev, build_model, common)
    emit(resume)
    if not resume["ok"]:
        raise SmokeFailure("train_resume: a restored or resumed run is not "
                           "bit-equal to the uninterrupted one, or compression failed")

    # the sharded families over a (1, 1) NCCL mesh, on a card free of the
    # resume runs; then, over the same mesh on a card free of the shard
    # runs, the dry-run's counts against the card (one NCCL group a process:
    # torch's meshes do not survive its destruction and a new one)
    import torch.distributed as dist

    from repro_torch.launch.mesh import single_device_mesh

    mesh = single_device_mesh()
    try:
        shard = shard_phase(torch, np, dev, build_model, common, get_config, mesh)
        dryrun_launches = dryrun_phase(torch, np, dev, build_model, common,
                                       get_config, counting, mesh)
    finally:
        dist.destroy_process_group()

    plan_phase(torch, flash_ops, checks, predicted, steps)

    summary = []
    for name in common.KERNELS:
        source, replaces = SOURCES[name]
        mine = [c for c in checks if c["kernel"] == name]
        row = mine[SUMMARY_SHAPE[name]]
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": engines[name]["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "max_row_rel_err": max((c["max_row_rel_err"] for c in mine
                                    if "max_row_rel_err" in c), default=None),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "graph_ms": row["kernel_graph_ms"],
            "library_graph_ms": row.get("library_graph_ms"),
            # the decode kernel's LSE mode beside its plain mode, in turns
            **({"lse_graph_ms": row["lse_graph_ms"],
                "lse_plain_graph_ms": row["lse"]["plain_graph_ms_in_turns"]}
               if "lse_graph_ms" in row else {}),
            "shape": row["shape"], "dtype": row["dtype"]})
    # the attention kernels' launches on the MoE, hymba, cross-attention
    # and encoder paths (their rows' ``launches`` stay the llama engine's)
    for row in summary:
        if row["name"] in ("flash_attention", "decode_attention"):
            row["launches_moe"] = {arch: n[row["name"]]
                                   for arch, n in moe_launches.items()}
            row["launches_hymba"] = hymba_launches[row["name"]]
            row["launches_vlm"] = cross_launches["vlm"][row["name"]]
            row["launches_encdec"] = cross_launches["audio"][row["name"]]
    flash_row = next(r for r in summary if r["name"] == "flash_attention")
    flash_row["launches_encode"] = encode_launches
    flash_row["launches_train"] = train["launches"]["flash_attention"]
    bwd_row = next(r for r in summary if r["name"] == "flash_attention_bwd")
    bwd_row["launches_per_step"] = train["launches_per_step_expected"]["flash_attention_bwd"]
    # the train_resume phase's four runs (U, U2, R, C)
    for row in (flash_row, bwd_row):
        row["launches_resume"] = resume["launches"][row["name"]]
    # the other attention families' training runs, per arch
    for row, name in ((flash_row, "flash_attention"), (bwd_row, "flash_attention_bwd")):
        row["launches_train_families"] = {arch: r["launches"][name]
                                          for arch, r in trained.items()
                                          if arch != TRAIN_RUNS[0].arch
                                          and r["launches"].get(name)}
    # the shard phase's sharded runs, summed (llama-3.1-8b, olmoe-1b-7b,
    # rwkv6-7b and hymba-1.5b served, the VLM and seamless generated,
    # qwen2.5-3b, rwkv6-7b and hymba-1.5b trained)
    for row in summary:
        if row["name"] in shard["launches"]:
            row["launches_shard"] = shard["launches"][row["name"]]
    # the dryrun phase's card runs (one measured train step, the prefill)
    for row in summary:
        if row["name"] in dryrun_launches:
            row["launches_dryrun"] = dryrun_launches[row["name"]]
    # rwkv6-7b's training run (the wkv6_bwd row's ``launches``)
    chunk_row = next(r for r in summary if r["name"] == "wkv6_chunk")
    chunk_row["launches_train"] = rwkv_train["launches"]["wkv6_chunk"]
    wkv_bwd_row = next(r for r in summary if r["name"] == "wkv6_bwd")
    wkv_bwd_row["launches_per_step"] = rwkv_train["launches_per_step_expected"]["wkv6_bwd"]
    emit({"phase": "wall", "seconds": time.perf_counter() - T0,
          "limit_s": 1200, "qwen_train_tokens_per_s": train["tokens_per_s"]})
    emit({"kernels": summary})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def main() -> int:
    try:
        run()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    finally:
        for proc in CHILDREN:
            if proc.is_alive():
                proc.terminate()
            proc.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
