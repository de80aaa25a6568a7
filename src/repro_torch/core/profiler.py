"""Per-LLM profiling (paper §4 step 3).

Replays all traced requests of a given LLM — across all workflow-level
requests, *maintaining inter-request dependencies within each trace* — at
swept arrival rates and tensor-parallel degrees, through the discrete-
event engine simulator.  Produces the throughput-latency profiles the
Aggregate LLM Pipeline is synthesized from.

Replica counts are NOT swept (paper: replicas don't change latency;
throughput scales linearly).  Fractional shares are NOT swept either: a
fraction ``f`` scales the engine's service rate, which maps a profile
exactly as  L(rate; f) = (1/f) · L(rate/f; 1)  and  T(f) = f · T(1).

On heterogeneous clusters each LLM is profiled once per
``(chip_class, tp)``: the replay engine's roofline costs (and, on a GPU
class, the flash kernel's tile plan) depend on the class, so a
profile on v5p-class chips is a different curve from the same model on
v4i-class chips.  ``LLMProfile.by_class`` holds the per-class curves;
``by_tp`` stays the default-class view so every uniform-cluster caller
is untouched.  (chip_class, tp) sweeps are memoized process-wide —
re-profiling the same architecture on the same class and trace shape is
a cache hit.
"""
from __future__ import annotations

import math
import random
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import hw
from repro_torch.configs.base import ArchConfig
from repro_torch.core.trace import TraceStore
from repro_torch.kernels.tile_plan import TilePlan, tile_plan
from repro_torch.serving import costmodel as cm
from repro_torch.serving.simulator import EngineRequest, EngineSim, EventLoop

DEP_EPS = 1e-9
RATE_GRID = (0.10, 0.30, 0.50, 0.65, 0.80, 0.90, 0.95)


@dataclass
class ReplayCall:
    prompt_tokens: int
    output_tokens: int
    preds: List[int]  # indices within the group that must finish first
    parent: Optional[int]  # index used for prefix-cache affinity


@dataclass
class ReplayGroup:
    """The calls one workflow-level request issued to one LLM."""

    calls: List[ReplayCall]


def extract_groups(store: TraceStore, llm: str) -> List[ReplayGroup]:
    groups: List[ReplayGroup] = []
    for tr in store.traces:
        calls = sorted(tr.calls_for(llm), key=lambda c: c.t_start)
        if not calls:
            continue
        rcs: List[ReplayCall] = []
        for i, c in enumerate(calls):
            preds = [j for j in range(i)
                     if calls[j].t_end <= c.t_start + DEP_EPS]
            # direct predecessors only: drop preds dominated by later preds
            direct = [j for j in preds
                      if not any(calls[j].t_end < calls[k].t_start + DEP_EPS
                                 for k in preds if k != j)]
            parent = max(direct, key=lambda j: calls[j].t_end) if direct else None
            rcs.append(ReplayCall(c.prompt_tokens, c.output_tokens,
                                  direct, parent))
        groups.append(ReplayGroup(rcs))
    return groups


def _run_replay(cfg: ArchConfig, groups: Sequence[ReplayGroup], *,
                tp: int, group_rate: float, seed: int = 0,
                prefix_caching: bool = True,
                avg_context: int = 1024,
                chip: Optional[hw.ChipClass] = None) -> List[EngineRequest]:
    """Replay groups at Poisson ``group_rate`` through one engine replica."""
    loop = EventLoop()
    engine = EngineSim(cfg, loop, tp=tp, fraction=1.0,
                       prefix_caching=prefix_caching, avg_context=avg_context,
                       chip=chip)
    rng = random.Random(seed)
    completed: List[EngineRequest] = []
    next_id = [0]

    def submit_group(g: ReplayGroup, arrival: float):
        remaining = {i: len(c.preds) for i, c in enumerate(g.calls)}
        dependents: Dict[int, List[int]] = {i: [] for i in range(len(g.calls))}
        ids: Dict[int, int] = {}
        for i, c in enumerate(g.calls):
            for j in c.preds:
                dependents[j].append(i)

        def launch(i: int, t: float):
            c = g.calls[i]
            next_id[0] += 1
            rid = next_id[0]
            ids[i] = rid

            def on_done(req: EngineRequest, i=i):
                completed.append(req)
                for k in dependents[i]:
                    remaining[k] -= 1
                    if remaining[k] == 0:
                        launch(k, loop.now)

            req = EngineRequest(
                req_id=rid, prompt_tokens=c.prompt_tokens,
                output_tokens=max(c.output_tokens, 1), arrival=t,
                on_complete=on_done,
                parent_id=ids.get(c.parent) if c.parent is not None else None)
            engine.submit(req)

        for i, c in enumerate(g.calls):
            if not c.preds:
                loop.schedule(arrival, lambda i=i: launch(i, loop.now))

    t = 0.0
    for g in groups:
        loop.schedule(t, lambda g=g, t=t: submit_group(g, t))
        if group_rate == math.inf:
            continue
        t += rng.expovariate(group_rate)
    loop.run()
    return completed


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    idx = min(int(q * len(s)), len(s) - 1)
    return s[idx]


@dataclass
class TPProfile:
    tp: int
    rates: List[float]  # call arrival rates (calls/s)
    latency: Dict[str, List[float]]  # percentile -> latencies
    max_throughput: float  # calls/s
    chip_class: str = ""  # chip class the sweep ran on ("" = default)
    block_plan: Optional[TilePlan] = None  # the flash kernel's tiles (GPU)

    def lookup(self, rate: float, percentile: str = "mean") -> float:
        if rate >= self.max_throughput:
            return math.inf
        xs, ys = self.rates, self.latency[percentile]
        if rate <= xs[0]:
            return ys[0]
        i = bisect_left(xs, rate)
        if i >= len(xs):
            # extrapolate toward saturation with an M/M/1-style blowup
            base = ys[-1]
            return base * (self.max_throughput - xs[-1]) / max(
                self.max_throughput - rate, 1e-9)
        x0, x1 = xs[i - 1], xs[i]
        y0, y1 = ys[i - 1], ys[i]
        w = (rate - x0) / max(x1 - x0, 1e-12)
        return y0 + w * (y1 - y0)


@dataclass
class LLMProfile:
    llm: str
    arch: str
    calls_per_group: float
    by_tp: Dict[int, TPProfile]
    # chip-class name -> tp -> profile; ``by_tp`` aliases the default
    # class's entry, so uniform-cluster callers never look in here
    by_class: Dict[str, Dict[int, TPProfile]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.by_class:
            self.by_class = {hw.DEFAULT_CHIP_CLASS.name: self.by_tp}

    def classes(self) -> List[str]:
        return sorted(self.by_class)

    def tps(self, chip_class: Optional[str] = None) -> List[int]:
        return sorted(self._table(chip_class))

    def _table(self, chip_class: Optional[str]) -> Dict[int, TPProfile]:
        if chip_class is None:
            return self.by_tp
        try:
            return self.by_class[chip_class]
        except KeyError:
            raise KeyError(
                f"{self.llm}: no profile for chip class {chip_class!r} "
                f"(profiled: {self.classes()})") from None

    def latency(self, rate: float, tp: int, *, fraction: float = 1.0,
                percentile: str = "mean",
                chip_class: Optional[str] = None) -> float:
        prof = self._table(chip_class)[tp]
        if fraction <= 0:
            return math.inf
        return prof.lookup(rate / fraction, percentile) / fraction

    def max_throughput(self, tp: int, *, fraction: float = 1.0,
                       chip_class: Optional[str] = None) -> float:
        return self._table(chip_class)[tp].max_throughput * fraction


# Per-(arch, chip_class, tp) sweep memo.  Keyed by the replayed trace
# shape as well (group/call counts + context), so two workflows with
# different traces never share an entry, but re-profiling the same
# architecture on another host group of the same class is a hit.
_sweep_cache: Dict[tuple, TPProfile] = {}
_sweep_stats = {"hits": 0, "misses": 0}


def profile_cache_stats() -> Tuple[int, int]:
    """(hits, misses) of the per-(chip_class, tp) sweep memo."""
    return _sweep_stats["hits"], _sweep_stats["misses"]


def clear_profile_cache() -> None:
    _sweep_cache.clear()
    _sweep_stats["hits"] = _sweep_stats["misses"] = 0


def _sweep_tp(cfg: ArchConfig, groups: Sequence[ReplayGroup],
              calls_per_group: float, *, tp: int, chip: hw.ChipClass,
              avg_context: int, prefix_caching: bool, seed: int,
              trace_key: tuple) -> TPProfile:
    key = (cfg.name, chip.name, tp, prefix_caching, seed) + trace_key
    hit = _sweep_cache.get(key)
    if hit is not None:
        _sweep_stats["hits"] += 1
        return hit
    _sweep_stats["misses"] += 1

    # --- capacity run: all groups at t=0 ---
    done = _run_replay(cfg, groups, tp=tp, group_rate=math.inf,
                       prefix_caching=prefix_caching,
                       avg_context=avg_context, seed=seed, chip=chip)
    makespan = max(r.t_done for r in done)
    t_max = len(done) / max(makespan, 1e-9)

    # --- latency sweep at fractions of capacity ---
    rates, lat = [], {"mean": [], "p50": [], "p90": [], "p99": []}
    for fr in RATE_GRID:
        call_rate = fr * t_max
        group_rate = call_rate / calls_per_group
        done = _run_replay(cfg, groups, tp=tp, group_rate=group_rate,
                           prefix_caching=prefix_caching,
                           avg_context=avg_context, seed=seed + 1,
                           chip=chip)
        ls = [r.latency for r in done]
        rates.append(call_rate)
        lat["mean"].append(sum(ls) / len(ls))
        lat["p50"].append(_percentile(ls, 0.50))
        lat["p90"].append(_percentile(ls, 0.90))
        lat["p99"].append(_percentile(ls, 0.99))
    # the flash kernel's tiles for a prefill of the traced context on this
    # (chip_class, tp) point: one request per prefill, as the port's engine
    # runs it, over one TP shard's heads.  None on a TPU class (the kernel
    # is Hopper's) and for an attention-free model (no flash attention).
    plan = None
    if chip.sms and not cfg.attn_free:
        plan = tile_plan(1, max(cfg.num_heads // tp, 1), max(avg_context, 1),
                         cfg.head_dim or 128, chip.sms)
    prof = TPProfile(tp=tp, rates=rates, latency=lat, max_throughput=t_max,
                     chip_class=chip.name, block_plan=plan)
    _sweep_cache[key] = prof
    return prof


def profile_llm(cfg: ArchConfig, store: TraceStore, llm: str, *,
                tp_degrees: Sequence[int] = (1, 2, 4),
                max_groups: int = 120, prefix_caching: bool = True,
                seed: int = 0,
                chip_classes: Sequence[hw.ChipClass] = ()) -> LLMProfile:
    """Profile one LLM per (chip_class, tp).

    ``chip_classes`` defaults to the default (h100) class only — the
    uniform-cluster path.  A (class, tp) point is skipped when the model
    does not fit the class's HBM at that TP degree; a class where no TP
    degree fits is omitted from ``by_class`` entirely (the scheduler
    then never binds this LLM to that class).
    """
    groups = extract_groups(store, llm)[:max_groups]
    if not groups:
        raise ValueError(f"no traced calls for LLM {llm!r}")
    n_calls = sum(len(g.calls) for g in groups)
    calls_per_group = n_calls / len(groups)
    prompts = [c.prompt_tokens for g in groups for c in g.calls]
    outs = [c.output_tokens for g in groups for c in g.calls]
    avg_context = int(sum(prompts) / len(prompts) + sum(outs) / len(outs))
    trace_key = (llm, len(groups), n_calls, avg_context, max_groups)

    classes = tuple(chip_classes) or (hw.DEFAULT_CHIP_CLASS,)
    by_class: Dict[str, Dict[int, TPProfile]] = {}
    for chip in classes:
        table: Dict[int, TPProfile] = {}
        for tp in tp_degrees:
            # legacy behavior on the default class: always sweep (the
            # engine clamps to batch 1); other classes skip infeasible
            # points so the scheduler never binds a model to a class it
            # cannot load on
            if (chip.name != hw.DEFAULT_CHIP_CLASS.name
                    and not cm.fits_on_class(cfg, chip, max_tp=tp,
                                             avg_context=avg_context)):
                continue
            table[tp] = _sweep_tp(cfg, groups, calls_per_group, tp=tp,
                                  chip=chip, avg_context=avg_context,
                                  prefix_caching=prefix_caching, seed=seed,
                                  trace_key=trace_key)
        if table:
            by_class[chip.name] = table
    if not by_class:
        raise ValueError(
            f"{llm}: model fits no profiled chip class "
            f"({[c.name for c in classes]}) at TP degrees {tuple(tp_degrees)}")
    by_tp = by_class.get(hw.DEFAULT_CHIP_CLASS.name)
    if by_tp is None:  # default class absent: alias the first profiled one
        first = next(c.name for c in classes if c.name in by_class)
        by_tp = by_class[first]
    return LLMProfile(llm=llm, arch=cfg.name,
                      calls_per_group=calls_per_group, by_tp=by_tp,
                      by_class=by_class)
