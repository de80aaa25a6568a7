"""Metrics, one file each: ``agentbench/metrics/<name>.py`` holds
``read(record) -> float | None`` for the metric ``name`` of
``BENCHMARK.json``.  A reader that finds nothing to read returns None, and
the harness leaves the metric out of the result line.

The record of a run (``harness.Run.record``):

    window   {"seconds", "tokens", "ttft_s": [...], "tpot_s": [...]}
    setup_s  process start to the window's start
    engine_stats  the engine's own counters over the window (prefill and
             cached prompt tokens, decode steps)
    model    the configuration's sizes; slots: the engine's slots;
             dtype_bytes: bytes of an element in the served dtype
    steps    per engine step: {"s": host seconds, "model_s": seconds in
             the model's calls, "in_profile"} (traced runs)
    calls    per model call: {"kind", "S", "rows", "lengths", "ms",
             "in_profile"} (traced runs; ``counts`` says what they hold)
    profile  the profiled stretch of a traced run: {"window_s", "busy_s",
             "kernels": {name: device seconds}, "launches": {kernel: n}}
"""
from __future__ import annotations

import importlib.util
import math
import sys
from pathlib import Path
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent


def reader(name: str) -> Callable:
    """The ``read`` function of metric ``name``, from its file."""
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"agentbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


MIN_SAMPLES = 20


def percentile(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile, linear between the closest ranks (numpy's
    default), or None with fewer than ``MIN_SAMPLES`` values.  A window
    holds some 90 to 250 calls: p90 has ten beyond it from 100."""
    if len(values) < MIN_SAMPLES:
        return None
    v = sorted(values)
    at = (len(v) - 1) * q / 100
    lo = math.floor(at)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (at - lo)


def outside_profile(items: list) -> list:
    """Host times are read where the profiler is off."""
    return [x for x in items if not x.get("in_profile")]


def roofline(record: dict, kernel: str) -> Optional[float]:
    """Percent: the sum over the profiled calls of the kernel's bound over
    the profiler's device time of its entries.  None where the kernel did
    not run there; an error where the counted calls differ from the
    program's launch counter (the count would be wrong)."""
    from agentbench.counts import kernel as counting
    from agentbench.counts.peaks import BF16_FLOPS, F32_FLOPS, bound_s

    prof = record.get("profile")
    if not prof:
        return None
    mod = counting(kernel)
    flops = F32_FLOPS if getattr(mod, "PEAK", "bf16") == "f32" else BF16_FLOPS
    shapes = [s for c in record["calls"] if c.get("in_profile")
              for s in mod.calls(c, record["model"])]
    seconds = sum(t for name, t in prof["kernels"].items()
                  if any(n in name for n in mod.NAMES))
    if not shapes or seconds <= 0:
        return None
    launched = prof["launches"].get(kernel)
    if launched is not None and launched != len(shapes):
        print(f"roofline {kernel}: {len(shapes)} calls counted, {launched} "
              "launched", file=sys.stderr)
        raise ValueError(f"{kernel}: counted calls differ from launches")
    bound = sum(bound_s(*mod.work(s), flops=flops) for s in shapes)
    return 100.0 * bound / seconds
