"""Scepsy GPU scheduler (paper §5).

Searches over (fractional chip share, TP degree, replica count) per LLM
for the allocation that minimizes workflow latency subject to sustaining a
target arrival rate, using the Aggregate LLM Pipeline as the predictor.

Pruning (paper's three strategies + one exploited symmetry):
  (i)   latency-ratio ordering: LLMs are enumerated in descending latency
        share and unit assignments are non-increasing along that order
        (an LLM may still drop to its memory lower bound);
  (ii)  contiguous allocation: fractions pack contiguously onto chips, so
        only unit *counts* matter (allocation symmetry);
  (iii) TP degree capped by the high-bandwidth ICI domain size;
  (iv)  separability: eq. (1) is a sum and eq. (2) a min over per-LLM
        terms, so for a fixed unit split the best (TP, replicas) choice
        decomposes per LLM — no cross-product over parallelism configs.

Fleet scheduling (:func:`schedule_multi`, post-paper): N workflows share
one cluster under partitioned / pooled / auto allocation modes with
egalitarian, weighted or proportional welfare; the partitioned split
search can close the loop with the placement layer
(``SchedulerConfig.placement_aware``): every candidate split is probed
through :func:`repro_torch.core.placement.fleet_feasibility` — unplaceable
splits are rejected outright and placeable ones pay a
``fragmentation_weight``-scaled penalty, so the winning split is one
that actually deploys on the real host/ICI-domain topology (ROADMAP
"Placement-aware partitioned splits").

Inputs: :class:`AggregateLLMPipeline` predictors + a
:class:`repro_torch.hw.ClusterSpec` + arrival-rate targets; outputs:
:class:`ScheduleResult` / :class:`MultiScheduleResult` allocation plans
consumed by :mod:`repro_torch.core.placement` and :mod:`repro_torch.core.scepsy`.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import hw
from repro_torch.configs.base import ArchConfig
from repro_torch.core import placement as _pl
from repro_torch.core.pipeline import (AggregateLLMPipeline,
                                 Allocation,
                                 Prediction,
                                 merge_pipelines)
from repro_torch.serving import costmodel as cm

WELFARE_OBJECTIVES = ("egalitarian", "weighted", "proportional")


@dataclass
class SchedulerConfig:
    percentile: str = "mean"
    max_tp: Optional[int] = None  # default: hb domain size
    units_grid: int = 10  # candidate unit values per LLM per level
    max_assignments: int = 200_000  # hard cap on enumerated unit splits
    allow_fractional: bool = True  # ablation: co-location via GPU fractions
    allow_parallelism: bool = True  # ablation: TP > 1
    memoize: bool = True  # cache best_option_for(m, units) across splits
    # multi-workflow welfare: egalitarian (min utility), weighted
    # (weight-normalized mean utility), proportional (Nash: Σ w·log u)
    welfare: str = "egalitarian"
    welfare_weights: Optional[Dict[str, float]] = None  # default: all 1.0
    # pooled routing-table shape: "uniform" spreads every workflow over
    # all tenant replicas; "partition" hands each workflow a load-
    # proportional block (better KV-affinity, and re-balanceable on
    # drift without re-placement)
    routing_policy: str = "uniform"
    # share each workflow's best_option_for table across the split
    # search's sub-schedules (neighbouring chip counts re-use it)
    warm_start: bool = True
    # close the scheduler<->placement loop: probe every candidate
    # partitioned split through placement.fleet_feasibility — reject
    # splits that cannot be placed on the real topology, and break
    # welfare ties toward less fragmented packings
    placement_aware: bool = False
    # soft penalty: split score = welfare - weight * fragmentation
    # (fragmentation in [0, 1] = stranded fraction of free units); keep
    # small so it only breaks near-ties, never trades real welfare away
    fragmentation_weight: float = 0.05


@dataclass
class ScheduleResult:
    allocations: Dict[str, Allocation]
    prediction: Prediction
    units: Dict[str, int]
    evaluated: int
    search_time_s: float
    feasible: bool


@dataclass
class _Option:
    alloc: Allocation
    units: int


def _parallelism_options(cfg: ArchConfig, units: int, spec: hw.ClusterSpec,
                         lo_units: int, max_tp: int,
                         allow_fractional: bool = True) -> List[_Option]:
    """Feasible (tp, replicas, fraction) configs for a unit budget."""
    F = spec.fractions_per_chip
    opts: List[_Option] = []
    # sub-chip / fractional replicas: tp=1, d replicas of u_r < F units
    # each (a replica never spans chips unless tensor-parallel).
    seen = set()
    if allow_fractional:
        for d in range(1, units + 1):
            u_r = min(units // d, F - 1)
            if u_r < lo_units:
                break
            if (d, u_r) in seen:
                continue
            seen.add((d, u_r))
            opts.append(_Option(Allocation(replicas=d, tp=1, fraction=u_r / F),
                                units=d * u_r))
    # whole-chip replicas (TP needs whole chips inside one hb domain)
    if units >= F:
        chips = units // F
        for tp in (t for t in (1, 2, 4, 8, 16) if t <= min(max_tp, chips)):
            if chips % tp:
                continue
            d = chips // tp
            if tp * F < lo_units:  # replica can't even hold the model
                continue
            opts.append(_Option(Allocation(replicas=d, tp=tp, fraction=1.0),
                                units=chips * F))
    return opts


def _prof_table(prof, cname: Optional[str]) -> Dict:
    """The TP table of ``prof`` on chip class ``cname`` (None = default).

    Works for both :class:`~repro_torch.core.profiler.LLMProfile` (per-class
    tables in ``by_class``) and
    :class:`~repro_torch.core.pipeline.MergedLLMProfile` (one table, valid on
    the intersection of member classes).
    """
    if cname is None:
        return prof.by_tp
    by_class = getattr(prof, "by_class", None)
    if by_class is not None:
        return by_class.get(cname) or {}
    return prof.by_tp if cname in prof.classes() else {}


def _candidate_units(lo: int, hi: int, grid: int, chip_units: int) -> List[int]:
    if hi <= lo:
        return [lo]
    step = max(1, (hi - lo) // grid)
    vals = set(range(hi, lo - 1, -step))
    vals.add(lo)
    # whole-chip-aligned values matter: TP/replica options exist only at
    # multiples of F, which a coarse grid can step over entirely
    c = (lo + chip_units - 1) // chip_units * chip_units
    while c <= hi:
        vals.add(c)
        c += chip_units
    return sorted(vals, reverse=True)


def schedule(pipeline: AggregateLLMPipeline, spec: hw.ClusterSpec,
             lam_target: float,
             config: SchedulerConfig = SchedulerConfig(), *,
             option_cache: Optional[Dict] = None,
             warm_seed: Optional[Dict[str, int]] = None) -> ScheduleResult:
    """Search the allocation space for one pipeline.

    ``warm_seed`` (a unit assignment, e.g. the schedule chosen for a
    neighbouring chip count in the fleet split search) is evaluated
    first; together with the admissible unloaded-latency floor bound it
    turns the enumeration into branch-and-bound with an immediate
    incumbent, without changing the optimal latency found.

    Heterogeneous clusters (more than one chip class in the spec) are
    routed to the class-aware search, which additionally assigns each
    LLM to a chip class and draws units from per-class budgets.  A
    uniform non-default-class cluster runs this search with that class's
    cost constants and profile curves; the default class reproduces the
    legacy behavior exactly.
    """
    if not spec.is_uniform:
        return _schedule_hetero(pipeline, spec, lam_target, config,
                                option_cache=option_cache)
    t0 = time.perf_counter()
    max_tp = config.max_tp or spec.hb_domain_size
    if not config.allow_parallelism:
        max_tp = 1
    F = spec.fractions_per_chip
    U = spec.total_units

    cls_names = spec.classes()
    chip = hw.chip_class(cls_names[0]) if cls_names else hw.DEFAULT_CHIP_CLASS
    # None on the default class => allocations and profile lookups are
    # byte-identical to the pre-ChipClass scheduler
    cname = None if chip.name == hw.DEFAULT_CHIP_CLASS.name else chip.name

    ratios = pipeline.latency_ratios(config.percentile)
    order = sorted(ratios, key=lambda m: -ratios[m])
    lo = {m: cm.min_fraction_units(pipeline.stages[m].cfg, spec, chip=chip)
          for m in order}
    if sum(lo.values()) > U:
        raise ValueError(
            f"cluster too small: need {sum(lo.values())} units, have {U}")

    # pre-compute per-LLM option tables for every candidate unit count
    tails = {m: sum(lo[x] for x in order[order.index(m) + 1:]) for m in order}

    evaluated = 0
    best: Optional[Tuple[float, Dict[str, Allocation], Prediction,
                         Dict[str, int]]] = None
    best_infeasible: Optional[Tuple[float, Dict[str, Allocation], Prediction,
                                    Dict[str, int]]] = None

    # best_option_for depends only on (m, units) — not on the rest of the
    # assignment being scored, nor on the cluster's chip count — so its
    # result is shared across every enumerated unit split (and the slack
    # post-pass).  On large clusters this collapses the search's hot path
    # from O(splits × options) to O(distinct (m, units) × options) option
    # scans.  Callers scheduling the same pipeline on several sub-cluster
    # sizes (the fleet split search) pass ``option_cache`` to warm-start
    # each search from its neighbours' tables.
    if option_cache is None:
        option_cache = {}

    def best_option_for(m: str, units: int) -> Optional[Tuple[Allocation, float, float]]:
        """(alloc, latency_contrib, llm_tput) minimizing latency s.t. tput."""
        if config.memoize:
            key = (m, units)
            if key not in option_cache:
                option_cache[key] = _best_option_uncached(m, units)
            return option_cache[key]
        return _best_option_uncached(m, units)

    def _best_option_uncached(m: str, units: int) -> Optional[Tuple[Allocation, float, float]]:
        st = pipeline.stages[m]
        opts = _parallelism_options(st.cfg, units, spec, lo[m], max_tp,
                                    config.allow_fractional)
        if not opts:
            return None
        table = _prof_table(st.profile, cname)
        lam_m = lam_target * st.n
        best_feas: Optional[Tuple[float, Allocation, float]] = None
        best_tput: Optional[Tuple[float, Allocation, float]] = None
        for o in opts:
            a = o.alloc
            if a.tp not in table:
                continue  # unprofiled TP degree
            if cname is not None:
                a = dataclasses.replace(a, chip_class=cname)
            tput = a.replicas * st.profile.max_throughput(
                a.tp, fraction=a.fraction, chip_class=cname)
            lmt = st.profile.latency(lam_m / a.replicas, a.tp,
                                     fraction=a.fraction,
                                     percentile=config.percentile,
                                     chip_class=cname)
            contrib = lmt * st.n / max(st.p, 1.0)
            if tput >= lam_m and math.isfinite(contrib):
                if best_feas is None or contrib < best_feas[0]:
                    best_feas = (contrib, a, tput)
            if best_tput is None or tput > best_tput[0]:
                best_tput = (tput, a, tput)
        if best_feas:
            return best_feas[1], best_feas[0], best_feas[2]
        if best_tput:
            a = best_tput[1]
            return a, math.inf, best_tput[2]
        return None

    def evaluate(units: Dict[str, int]):
        nonlocal evaluated, best, best_infeasible
        evaluated += 1
        allocs: Dict[str, Allocation] = {}
        total_lat = 0.0
        min_tput = math.inf
        for m in order:
            r = best_option_for(m, units[m])
            if r is None:
                return
            a, contrib, tput = r
            allocs[m] = a
            total_lat += contrib
            min_tput = min(min_tput, tput / pipeline.stages[m].n)
        pred = pipeline.predict(allocs, lam_target, config.percentile)
        key_units = dict(units)
        if pred.feasible:
            if best is None or pred.latency < best[0]:
                best = (pred.latency, allocs, pred, key_units)
        else:
            score = -pred.max_throughput
            if best_infeasible is None or score < best_infeasible[0]:
                best_infeasible = (score, allocs, pred, key_units)

    # admissible latency floor per stage (unloaded latency at the best
    # profiled TP, whole chips): no allocation can serve below it, so
    # partial-assignment sums bound every completion of a branch.  The
    # 0.9 margin guards against mild non-monotonicity in simulated
    # profiles; it only weakens (never invalidates) the bound.
    floor = {}
    for m in order:
        st = pipeline.stages[m]
        f = min(st.profile.latency(0.0, tp, percentile=config.percentile,
                                   chip_class=cname)
                for tp in _prof_table(st.profile, cname))
        floor[m] = 0.9 * f * st.n / max(st.p, 1.0)
    tail_floor = {len(order): 0.0}
    for i in range(len(order) - 1, -1, -1):
        tail_floor[i] = tail_floor[i + 1] + floor[order[i]]

    def recurse(i: int, remaining: int, prev_units: int,
                units: Dict[str, int], partial: float):
        if evaluated >= config.max_assignments:
            return
        if i == len(order):
            if remaining >= 0:
                evaluate(units)
            return
        m = order[i]
        # ratio-ordered prune (i), softened by the memory lower bound: an
        # LLM may exceed a higher-ratio LLM's share when its parameters
        # simply need more chips (e.g. 8B verifier vs 1B generator)
        cap = max(prev_units, 2 * lo[m])
        hi = min(remaining - tails[m], cap)
        if hi < lo[m]:
            return
        for u in _candidate_units(lo[m], hi, config.units_grid, F):
            r = best_option_for(m, u)
            if r is None:
                continue  # no option fits this budget: branch is dead
            new_partial = partial + r[1]
            # branch-and-bound: prune completions that provably cannot
            # beat the feasible incumbent (seeded by warm_seed)
            if (best is not None
                    and new_partial + tail_floor[i + 1] >= best[0]):
                continue
            units[m] = u
            recurse(i + 1, remaining - u, u, units, new_partial)
        units.pop(m, None)

    if warm_seed is not None:
        seed = {m: warm_seed.get(m, 0) for m in order}
        if (all(seed[m] >= lo[m] for m in order)
                and sum(seed.values()) <= U):
            evaluate(seed)
    recurse(0, U, U, {}, 0.0)

    def used_units(allocs: Dict[str, Allocation]) -> int:
        total = 0
        for a in allocs.values():
            if a.tp > 1 or a.fraction >= 1.0:
                total += a.replicas * a.tp * F
            else:
                total += a.replicas * int(round(a.fraction * F))
        return total

    def improve_with_slack(allocs: Dict[str, Allocation],
                           units: Dict[str, int]):
        """Greedy post-pass: hand leftover units to whichever LLM's
        re-optimized option lowers predicted latency most."""
        nonlocal evaluated
        allocs = dict(allocs)
        units = dict(units)
        best_pred = pipeline.predict(allocs, lam_target, config.percentile)
        for _ in range(8):
            leftover = U - used_units(allocs)
            if leftover <= 0:
                break
            improved = False
            for m in order:
                r = best_option_for(m, units[m] + leftover)
                if r is None:
                    continue
                cand = dict(allocs)
                cand[m] = r[0]
                pred = pipeline.predict(cand, lam_target, config.percentile)
                evaluated += 1
                if pred.feasible and pred.latency < best_pred.latency - 1e-12:
                    allocs, best_pred = cand, pred
                    units[m] = units[m] + leftover
                    improved = True
                    break
            if not improved:
                break
        return allocs, best_pred, units

    elapsed = time.perf_counter() - t0
    if best is not None:
        lat, allocs, pred, units = best
        allocs, pred, units = improve_with_slack(allocs, units)
        elapsed = time.perf_counter() - t0
        return ScheduleResult(allocs, pred, units, evaluated, elapsed, True)
    if best_infeasible is not None:
        _, allocs, pred, units = best_infeasible
        return ScheduleResult(allocs, pred, units, evaluated, elapsed, False)
    raise RuntimeError("scheduler found no viable allocation")


def _schedule_hetero(pipeline: AggregateLLMPipeline, spec: hw.ClusterSpec,
                     lam_target: float,
                     config: SchedulerConfig = SchedulerConfig(), *,
                     option_cache: Optional[Dict] = None) -> ScheduleResult:
    """Class-aware allocation search for heterogeneous clusters.

    Extends the paper's search with one more decision per LLM: which
    chip class its replicas live on.  Units are drawn from per-class
    budgets (``spec.units_of_class``); an LLM is only assignable to
    classes it was profiled on AND whose HBM fits it
    (:func:`profile_llm` already drops unfittable classes), and every
    chosen :class:`Allocation` carries its ``chip_class`` so placement
    binds the instances to compatible host groups.  Latency and
    throughput come from the per-``(chip_class, tp)`` profile curves, so
    a 9B on big-HBM chips and the same 9B on mid-tier chips are scored
    as the different machines they are.
    """
    t0 = time.perf_counter()
    max_tp = config.max_tp or spec.hb_domain_size
    if not config.allow_parallelism:
        max_tp = 1
    F = spec.fractions_per_chip
    budgets = {c: spec.units_of_class(c) for c in spec.classes()}

    ratios = pipeline.latency_ratios(config.percentile)
    order = sorted(ratios, key=lambda m: -ratios[m])

    # feasible classes + per-class memory floors per LLM
    lo: Dict[str, Dict[str, int]] = {}
    for m in order:
        st = pipeline.stages[m]
        prof_classes = set(st.profile.classes())
        lo[m] = {}
        for c in spec.classes():
            if c not in prof_classes or not _prof_table(st.profile, c):
                continue
            u = cm.min_fraction_units(st.cfg, spec, chip=hw.chip_class(c))
            if u <= budgets[c]:
                lo[m][c] = u
        if not lo[m]:
            raise ValueError(
                f"{m}: no chip class on this cluster both fits the model "
                f"and has a profile (cluster classes: {spec.classes()})")
    lo_min = {m: min(lo[m].values()) for m in order}
    if sum(lo_min.values()) > spec.total_units:
        raise ValueError(
            f"cluster too small: need {sum(lo_min.values())} units, "
            f"have {spec.total_units}")

    if option_cache is None:
        option_cache = {}
    evaluated = 0
    best: Optional[Tuple[float, Dict[str, Allocation], Prediction,
                         Dict[str, int]]] = None
    best_infeasible: Optional[Tuple[float, Dict[str, Allocation], Prediction,
                                    Dict[str, int]]] = None

    def best_option_for(m: str, units: int, c: str
                        ) -> Optional[Tuple[Allocation, float, float]]:
        if not config.memoize:
            return _best_option_uncached(m, units, c)
        key = (m, units, c)
        if key not in option_cache:
            option_cache[key] = _best_option_uncached(m, units, c)
        return option_cache[key]

    def _best_option_uncached(m: str, units: int, c: str
                              ) -> Optional[Tuple[Allocation, float, float]]:
        if c not in lo[m]:
            return None
        st = pipeline.stages[m]
        table = _prof_table(st.profile, c)
        opts = _parallelism_options(st.cfg, units, spec, lo[m][c], max_tp,
                                    config.allow_fractional)
        lam_m = lam_target * st.n
        best_feas: Optional[Tuple[float, Allocation, float]] = None
        best_tput: Optional[Tuple[float, Allocation, float]] = None
        for o in opts:
            a = o.alloc
            if a.tp not in table:
                continue
            a = dataclasses.replace(a, chip_class=c)
            tput = a.replicas * st.profile.max_throughput(
                a.tp, fraction=a.fraction, chip_class=c)
            lmt = st.profile.latency(lam_m / a.replicas, a.tp,
                                     fraction=a.fraction,
                                     percentile=config.percentile,
                                     chip_class=c)
            contrib = lmt * st.n / max(st.p, 1.0)
            if tput >= lam_m and math.isfinite(contrib):
                if best_feas is None or contrib < best_feas[0]:
                    best_feas = (contrib, a, tput)
            if best_tput is None or tput > best_tput[0]:
                best_tput = (tput, a, tput)
        if best_feas:
            return best_feas[1], best_feas[0], best_feas[2]
        if best_tput:
            return best_tput[1], math.inf, best_tput[2]
        return None

    def evaluate(units: Dict[str, int], picks: Dict[str, str]) -> None:
        nonlocal evaluated, best, best_infeasible
        evaluated += 1
        allocs: Dict[str, Allocation] = {}
        for m in order:
            r = best_option_for(m, units[m], picks[m])
            if r is None:
                return
            allocs[m] = r[0]
        pred = pipeline.predict(allocs, lam_target, config.percentile)
        key_units = dict(units)
        if pred.feasible:
            if best is None or pred.latency < best[0]:
                best = (pred.latency, allocs, pred, key_units)
        else:
            score = -pred.max_throughput
            if best_infeasible is None or score < best_infeasible[0]:
                best_infeasible = (score, allocs, pred, key_units)

    # admissible unloaded-latency floor: min over (class, tp) points
    floor = {}
    for m in order:
        st = pipeline.stages[m]
        vals = [st.profile.latency(0.0, tp, percentile=config.percentile,
                                   chip_class=c)
                for c in lo[m] for tp in _prof_table(st.profile, c)]
        floor[m] = 0.9 * min(vals) * st.n / max(st.p, 1.0)
    tail_floor = {len(order): 0.0}
    for i in range(len(order) - 1, -1, -1):
        tail_floor[i] = tail_floor[i + 1] + floor[order[i]]

    def recurse(i: int, remaining: Dict[str, int], units: Dict[str, int],
                picks: Dict[str, str], partial: float) -> None:
        if evaluated >= config.max_assignments:
            return
        if i == len(order):
            evaluate(units, picks)
            return
        m = order[i]
        # roomiest feasible class first: a good incumbent early makes
        # the floor bound prune the rest
        for c in sorted(lo[m], key=lambda c: -remaining[c]):
            if remaining[c] < lo[m][c]:
                continue
            for u in _candidate_units(lo[m][c], remaining[c],
                                      config.units_grid, F):
                r = best_option_for(m, u, c)
                if r is None:
                    continue
                new_partial = partial + r[1]
                if (best is not None
                        and new_partial + tail_floor[i + 1] >= best[0]):
                    continue
                units[m], picks[m] = u, c
                remaining[c] -= u
                recurse(i + 1, remaining, units, picks, new_partial)
                remaining[c] += u
        units.pop(m, None)
        picks.pop(m, None)

    recurse(0, dict(budgets), {}, {}, 0.0)

    def used_units_in(allocs: Dict[str, Allocation], c: str) -> int:
        total = 0
        for a in allocs.values():
            if a.chip_class != c:
                continue
            if a.tp > 1 or a.fraction >= 1.0:
                total += a.replicas * a.tp * F
            else:
                total += a.replicas * int(round(a.fraction * F))
        return total

    def improve_with_slack(allocs: Dict[str, Allocation],
                           units: Dict[str, int]):
        nonlocal evaluated
        allocs, units = dict(allocs), dict(units)
        best_pred = pipeline.predict(allocs, lam_target, config.percentile)
        for _ in range(8):
            improved = False
            for c in budgets:
                leftover = budgets[c] - used_units_in(allocs, c)
                if leftover <= 0:
                    continue
                for m in order:
                    if allocs[m].chip_class != c:
                        continue
                    r = best_option_for(m, units[m] + leftover, c)
                    if r is None:
                        continue
                    cand = dict(allocs)
                    cand[m] = r[0]
                    pred = pipeline.predict(cand, lam_target,
                                            config.percentile)
                    evaluated += 1
                    if (pred.feasible
                            and pred.latency < best_pred.latency - 1e-12):
                        allocs, best_pred = cand, pred
                        units[m] = units[m] + leftover
                        improved = True
                        break
                if improved:
                    break
            if not improved:
                break
        return allocs, best_pred, units

    elapsed = time.perf_counter() - t0
    if best is not None:
        _, allocs, pred, units = best
        allocs, pred, units = improve_with_slack(allocs, units)
        elapsed = time.perf_counter() - t0
        return ScheduleResult(allocs, pred, units, evaluated, elapsed, True)
    if best_infeasible is not None:
        _, allocs, pred, units = best_infeasible
        return ScheduleResult(allocs, pred, units, evaluated, elapsed, False)
    raise RuntimeError("scheduler found no viable class-aware allocation")


# ---------------------------------------------------------------------------
# Multi-workflow scheduling (welfare objectives, paper §5 end)
# ---------------------------------------------------------------------------


@dataclass
class PooledScheduleResult:
    """Shared multi-tenant allocation: LLMs are tenants, workflows hold
    routing weights into the pooled replica set."""

    merged: ScheduleResult  # merged-pipeline schedule over the whole cluster
    allocations: Dict[str, Allocation]  # canonical llm id -> shared alloc
    cfgs: Dict[str, ArchConfig]  # canonical llm id -> architecture
    members: Dict[str, List[Tuple[str, str]]]  # id -> [(workflow, local llm)]
    routing: Dict[str, Dict[str, Dict[int, float]]]  # wf -> llm -> rep -> w
    predictions: Dict[str, Prediction]  # per-workflow attribution
    chip_share: Dict[str, float]  # traffic-weighted chip-equivalents
    lam_total: float


@dataclass
class FleetWarmState:
    """Carry-over state for incremental fleet re-planning.

    Everything the split search builds — the (workflow, chips) schedule
    cache, per-workflow ``best_option_for`` tables, the winning split and
    unit assignments — survives across :func:`schedule_multi` calls when
    threaded through ``warm_state``.  :meth:`sync` keeps it sound: a
    workflow whose pipeline object or arrival-rate target changed has its
    cached schedules and option tables dropped (both bake in the lam),
    while its last unit split is kept purely as a branch-and-bound
    incumbent seed, which can never change the optimum found.  A changed
    cluster spec drops everything.
    """

    sched_cache: Dict[Tuple[str, int], Optional[ScheduleResult]] = \
        field(default_factory=dict)
    option_tables: Dict[str, Dict] = field(default_factory=dict)
    lams: Dict[str, float] = field(default_factory=dict)
    pipelines: Dict[str, AggregateLLMPipeline] = field(default_factory=dict)
    last_split: Dict[str, int] = field(default_factory=dict)
    last_units: Dict[str, Dict[str, int]] = field(default_factory=dict)
    merged_units: Optional[Dict[str, int]] = None
    spec: Optional[hw.ClusterSpec] = None

    def invalidate(self, workflow: str) -> None:
        for key in [k for k in self.sched_cache if k[0] == workflow]:
            del self.sched_cache[key]
        self.option_tables.pop(workflow, None)

    def clear(self) -> None:
        self.sched_cache.clear()
        self.option_tables.clear()
        self.last_split = {}
        self.last_units = {}
        self.merged_units = None

    def sync(self, pipelines: Dict[str, AggregateLLMPipeline],
             lam_targets: Dict[str, float],
             spec: hw.ClusterSpec) -> List[str]:
        """Invalidate state made stale by drift; returns the changed
        workflow names."""
        if self.spec is not None and self.spec != spec:
            self.clear()
            self.pipelines.clear()
            self.lams.clear()
        self.spec = spec
        changed = []
        for n, pipe in pipelines.items():
            if n in self.pipelines and (self.pipelines[n] is not pipe
                                        or self.lams.get(n)
                                        != lam_targets[n]):
                self.invalidate(n)
                changed.append(n)
            self.pipelines[n] = pipe
            self.lams[n] = lam_targets[n]
        for n in [x for x in self.pipelines if x not in pipelines]:
            self.invalidate(n)
            del self.pipelines[n]
            self.lams.pop(n, None)
        return changed


@dataclass
class MultiScheduleResult:
    per_workflow: Dict[str, ScheduleResult]
    chip_split: Dict[str, int]  # empty when alloc_mode == "pooled"
    welfare: float
    search_time_s: float
    utilities: Dict[str, float] = field(default_factory=dict)
    evaluated_splits: int = 0
    schedule_calls: int = 0
    search_mode: str = "enumerate"
    alloc_mode: str = "partitioned"  # "partitioned" | "pooled"
    pooled: Optional[PooledScheduleResult] = None
    welfare_by_mode: Dict[str, float] = field(default_factory=dict)
    warm_state: Optional[FleetWarmState] = None
    # placement feedback (None unless config.placement_aware): did the
    # winning plan pass the placement probe, at what fragmentation, and
    # how many candidate splits the probe rejected as unplaceable
    placement_ok: Optional[bool] = None
    fragmentation: Optional[float] = None
    placement_rejected_splits: int = 0
    # True when a requested pooled plan existed but its shared replica
    # set failed the placement probe, so the result degraded to a
    # partitioned plan (distinct from "no shared LLMs")
    pooled_unplaceable: bool = False


def _welfare_fn(config: SchedulerConfig, names: Sequence[str]):
    """Welfare objective over per-workflow utilities in [0, 1]."""
    if config.welfare not in WELFARE_OBJECTIVES:
        raise ValueError(f"unknown welfare objective {config.welfare!r}; "
                         f"known: {WELFARE_OBJECTIVES}")
    wts = {n: (config.welfare_weights or {}).get(n, 1.0) for n in names}
    total_w = sum(wts.values()) or 1.0
    if config.welfare == "egalitarian":
        return lambda utils: min(utils.values())
    if config.welfare == "weighted":
        return lambda utils: sum(wts[n] * u for n, u in utils.items()) / total_w
    return lambda utils: sum(wts[n] * math.log(max(u, 1e-9))
                             for n, u in utils.items())


def schedule_multi(pipelines: Dict[str, AggregateLLMPipeline],
                   spec: hw.ClusterSpec, lam_targets: Dict[str, float],
                   config: SchedulerConfig = SchedulerConfig(),
                   split_step: int = 1, *,
                   search: str = "auto",
                   max_enumerated_splits: int = 4096,
                   mode: str = "partitioned",
                   warm_state: Optional[FleetWarmState] = None
                   ) -> MultiScheduleResult:
    """Allocate the cluster between N >= 2 workflows.

    Utility of a workflow = L_ref / L (reference = its latency given the
    whole cluster), so utilities are comparable across workflows; welfare
    combines them per ``config.welfare`` (egalitarian min by default).

    ``mode`` selects the allocation data model:
      * ``"partitioned"`` — every workflow owns a disjoint chip slice
        (the paper's evaluated split search): small composition spaces
        are enumerated exhaustively, larger fleets fall back to greedy
        water-filling with local-exchange refinement, and
        per-(workflow, chips) schedules are cached across candidates
        with option tables warm-started across neighbouring chip counts;
      * ``"pooled"`` — LLMs are tenants: the workflows' pipelines are
        merged (rate-weighted shares keyed by canonical model identity),
        the merged pipeline is scheduled over the *whole* cluster, and
        per-workflow latency/throughput is attributed back out of the
        shared allocation.  Degrades to the exact partitioned result
        when workflows share no LLM configs;
      * ``"auto"`` — both, keeping whichever yields higher welfare
        (ties prefer partitioned).

    ``warm_state`` (a :class:`FleetWarmState`, e.g. the one returned on a
    previous result's ``warm_state`` field) makes the call an
    *incremental re-plan*: schedules and option tables of workflows whose
    pipeline and target are unchanged are reused verbatim, drifted
    workflows are re-searched from their previous unit split as a
    branch-and-bound incumbent, and the pooled merged search is seeded
    from the previous merged units.  The state is invalidated
    conservatively (see :meth:`FleetWarmState.sync`), so warm results are
    identical to a cold search over the same inputs.

    With ``config.placement_aware`` the partitioned split search closes
    the loop with :mod:`repro_torch.core.placement`: every candidate split's
    per-workflow allocations are probed through
    :func:`~repro_torch.core.placement.fleet_feasibility` (the exact packing a
    deploy would run, without materializing a manifest) — unplaceable
    splits are filtered out, and placeable ones are scored
    ``welfare - fragmentation_weight * fragmentation``.  The pooled
    search probes its shared replica set over the whole cluster the same
    way.  The winner's ``placement_ok`` / ``fragmentation`` /
    ``placement_rejected_splits`` fields report what the probe saw; if
    NO split is placeable the placement-blind winner is returned with
    ``placement_ok=False``.  ``mode="pooled"`` with an unplaceable
    shared replica set degrades to the partitioned result flagged
    ``pooled_unplaceable=True``; ``mode="auto"`` prefers a placeable
    pooled plan over an unplaceable partitioned fallback.
    """
    t0 = time.perf_counter()
    names = list(pipelines)
    if len(names) < 2:
        raise ValueError("schedule_multi needs >= 2 workflows")
    if search not in ("auto", "enumerate", "greedy"):
        raise ValueError(f"unknown search mode {search!r}")
    if mode not in ("partitioned", "pooled", "auto"):
        raise ValueError(f"unknown allocation mode {mode!r}")
    missing = [n for n in names if n not in lam_targets]
    if missing:
        raise ValueError(f"no arrival-rate target for workflows {missing}")
    G = spec.num_chips
    welfare_of = _welfare_fn(config, names)

    chips_avail = [hw.chip_class(c) for c in spec.classes()] or \
        [hw.DEFAULT_CHIP_CLASS]
    lo_chips = {
        n: _min_chips_for_units(
            sum(min(cm.min_fraction_units(pipelines[n].stages[m].cfg, spec,
                                          chip=ch) for ch in chips_avail)
                for m in pipelines[n].stages), spec)
        for n in names
    }
    if sum(lo_chips.values()) > G:
        raise ValueError(
            f"cluster too small for {len(names)} workflows: need "
            f">= {sum(lo_chips.values())} chips, have {G}")

    # reference schedules (whole cluster each) double as cache seeds
    stats = {"schedule_calls": 0, "evaluated_splits": 0}
    # incremental re-plan: the schedule cache and per-workflow option
    # tables live in the (possibly caller-provided) FleetWarmState, so
    # they carry across re-plans; sync() drops whatever drift made stale
    ws = warm_state if warm_state is not None else FleetWarmState()
    ws.sync(pipelines, lam_targets, spec)
    sched_cache = ws.sched_cache
    # per-workflow best_option_for tables shared across every sub-cluster
    # size the split search visits (ROADMAP "warm-start each sub-schedule
    # from the neighbouring chip count's result"): the table depends only
    # on (stage, units), never on the cluster's chip count
    warm: Dict[str, Dict] = {n: ws.option_tables.setdefault(n, {})
                             for n in names}

    def sched(n: str, chips: int,
              offset: int = 0) -> Optional[ScheduleResult]:
        if chips < lo_chips[n]:
            return None
        # a k-chip slice of a uniform cluster is the same spec at any
        # offset, so the cache key (and slice) only carries the offset
        # on heterogeneous specs — uniform search behavior is unchanged
        key = (n, chips, offset) if spec.host_groups else (n, chips)
        if key not in sched_cache:
            stats["schedule_calls"] += 1
            cache = warm[n] if (config.warm_start and config.memoize) \
                else None
            seed = None
            if config.warm_start:
                # seed from the nearest chip count already scheduled:
                # its unit split is an immediate feasible incumbent for
                # the branch-and-bound at this size
                near = [(abs(k[1] - chips), k)
                        for k, r in sched_cache.items()
                        if k[0] == n
                        and (len(k) == 2 or k[2] == offset)
                        and r is not None and r.feasible]
                if near:
                    seed = sched_cache[min(near)[1]].units
                elif n in ws.last_units:
                    # drifted workflow on a warm re-plan: its cached
                    # schedules were invalidated, but the previous
                    # plan's unit split is still a valid incumbent
                    seed = ws.last_units[n]
            try:
                sched_cache[key] = schedule(
                    pipelines[n], _subcluster(spec, chips, offset),
                    lam_targets[n], config, option_cache=cache,
                    warm_seed=seed)
            except (ValueError, RuntimeError):
                sched_cache[key] = None
        return sched_cache[key]

    refs = {}
    for n in names:
        r = sched(n, G)
        refs[n] = (r.prediction.latency
                   if r is not None and r.feasible else math.inf)

    def utility_of(n: str, pred: Optional[Prediction]) -> float:
        if (pred is None or not pred.feasible
                or not math.isfinite(pred.latency) or pred.latency <= 0):
            return 0.0
        if refs[n] <= 0:
            return 0.0
        return min(refs[n] / pred.latency, 1.0)

    def utility(n: str, r: Optional[ScheduleResult]) -> float:
        return utility_of(n, r.prediction if r is not None else None)

    def partitioned_search() -> MultiScheduleResult:
        def score(split: Dict[str, int]):
            """(welfare, utils, per-workflow results) or None if any
            schedule call failed outright for this split."""
            stats["evaluated_splits"] += 1
            per: Dict[str, ScheduleResult] = {}
            # heterogeneous clusters: slices at cumulative offsets (in
            # canonical name order) are disjoint, so class-bound plans
            # of different workflows can never claim the same chips
            off = 0
            for n in names:
                r = sched(n, split[n], off if spec.host_groups else 0)
                if r is None:
                    return None
                per[n] = r
                off += split[n]
            utils = {n: utility(n, per[n]) for n in names}
            return welfare_of(utils), utils, per

        # best entries: (score_key, welfare, utils, per, split, frag);
        # score_key folds in the fragmentation penalty when the search
        # is placement-aware.  best_blind ignores the placement probe —
        # it is the fallback when NO candidate split is placeable, so a
        # pathological cluster still yields a plan (placement_ok=False)
        best: Optional[Tuple] = None
        best_blind: Optional[Tuple] = None
        rejected = {"n": 0}

        def consider(split: Dict[str, int]) -> None:
            nonlocal best, best_blind
            s = score(split)
            if s is None:
                return
            welfare, utils, per = s
            if config.placement_aware and (best_blind is None
                                           or welfare > best_blind[1]):
                best_blind = (welfare, welfare, utils, per, dict(split), None)
            frag = None
            key = welfare
            if config.placement_aware:
                # fragmentation >= 0 means key <= welfare: a split whose
                # raw welfare cannot beat the incumbent key can never
                # win, so skip its (full greedy packing) probe
                if best is not None and welfare <= best[0]:
                    return
                probe = _pl.fleet_feasibility(
                    {n: per[n].allocations for n in names}, spec)
                if not probe.ok:
                    rejected["n"] += 1
                    return
                frag = probe.fragmentation
                key = welfare - config.fragmentation_weight * frag
            if best is None or key > best[0]:
                best = (key, welfare, utils, per, dict(split), frag)

        # the previous plan's split is the incumbent: evaluated first so
        # greedy refinement and cache-driven re-plans start from it
        prev = ws.last_split
        if (prev and set(prev) == set(names) and sum(prev.values()) <= G
                and all(prev[n] >= lo_chips[n] for n in names)):
            consider(dict(prev))
        splits = (None if search == "greedy"
                  else _enumerate_splits(names, lo_chips, G, split_step,
                                         max_enumerated_splits))
        if splits is None and search == "enumerate":
            raise ValueError(
                f"enumeration bound {max_enumerated_splits} exceeded; use "
                "search='auto'/'greedy' or raise max_enumerated_splits")
        smode = "enumerate" if splits is not None else "greedy"
        if splits is not None:
            for split in splits:
                consider(split)
        else:
            for split in _greedy_splits(names, lo_chips, G, split_step,
                                        lam_targets, refs, sched, utility,
                                        welfare_of):
                consider(split)
        placement_ok: Optional[bool] = None
        if best is None and best_blind is not None and config.placement_aware:
            # every scoreable split failed the probe: fall back to the
            # placement-blind winner so the caller still gets a plan,
            # flagged unplaceable
            best = best_blind
            placement_ok = False
        elif best is not None and config.placement_aware:
            placement_ok = True
        if best is None:
            raise RuntimeError("no feasible multi-workflow split")
        _, welfare, utils, per_wf, split, frag = best
        ws.last_split = dict(split)
        ws.last_units = {n: dict(per_wf[n].units) for n in names}
        return MultiScheduleResult(per_wf, split, welfare,
                                   time.perf_counter() - t0,
                                   utilities=utils,
                                   evaluated_splits=stats["evaluated_splits"],
                                   schedule_calls=stats["schedule_calls"],
                                   search_mode=smode,
                                   alloc_mode="partitioned",
                                   warm_state=ws,
                                   placement_ok=placement_ok,
                                   fragmentation=frag,
                                   placement_rejected_splits=rejected["n"])

    # set by pooled_search when a pooled plan existed but its shared
    # replica set failed the placement probe (vs. "no shared LLMs")
    pooled_degraded = {"unplaceable": False}

    def pooled_search() -> Optional[MultiScheduleResult]:
        merged = merge_pipelines(pipelines, lam_targets)
        if not merged.shared_llms():
            return None  # degenerate: pooling cannot differ from a split
        try:
            # the previous merged unit split seeds branch-and-bound: a
            # pooled re-plan is ONE warm-started schedule() call
            res = schedule(merged, spec, merged.lam_total, config,
                           warm_seed=ws.merged_units)
        except (ValueError, RuntimeError):
            return None
        stats["schedule_calls"] += 1
        ws.merged_units = dict(res.units)
        pooled_ok: Optional[bool] = None
        pooled_frag: Optional[float] = None
        if config.placement_aware:
            # the shared replica set is placed once over the whole
            # cluster; probe it the same way the split search probes
            # per-split slices
            probe = _pl.feasibility(res.allocations, spec)
            if not probe.ok:
                # unplaceable pool: partitioned path decides, but the
                # degradation is flagged on the returned result
                pooled_degraded["unplaceable"] = True
                return None
            pooled_ok, pooled_frag = True, probe.fragmentation
        preds = merged.attribute(res.allocations, config.percentile)
        utils = {n: utility_of(n, preds[n]) for n in names}
        welfare = welfare_of(utils)
        routing = merged.routing_weights(res.allocations,
                                         policy=config.routing_policy)
        # traffic-weighted chip attribution (diagnostic: the pool has no
        # per-workflow chip ownership); Allocation.chip_units is already
        # in chips (replicas x tp x fraction)
        chip_share: Dict[str, float] = {n: 0.0 for n in names}
        for cid, mem in merged.tenants.items():
            total = sum(t.call_rate for t in mem) or 1.0
            for t in mem:
                chip_share[t.workflow] += (t.call_rate / total
                                           * res.allocations[cid].chip_units)
        per_wf: Dict[str, ScheduleResult] = {}
        for n in names:
            members = merged.members_of(n)
            per_wf[n] = ScheduleResult(
                allocations={t.llm: res.allocations[cid]
                             for cid, ts in members.items() for t in ts},
                prediction=preds[n],
                units={t.llm: res.units[cid]
                       for cid, ts in members.items() for t in ts},
                evaluated=res.evaluated,
                search_time_s=res.search_time_s,
                feasible=preds[n].feasible)
        pooled = PooledScheduleResult(
            merged=res,
            allocations=dict(res.allocations),
            cfgs={cid: merged.stages[cid].cfg for cid in merged.tenants},
            members={cid: [(t.workflow, t.llm) for t in mem]
                     for cid, mem in merged.tenants.items()},
            routing=routing, predictions=preds, chip_share=chip_share,
            lam_total=merged.lam_total)
        return MultiScheduleResult(
            per_wf, {}, welfare, time.perf_counter() - t0,
            utilities=utils,
            evaluated_splits=stats["evaluated_splits"],
            schedule_calls=stats["schedule_calls"],
            search_mode="pooled", alloc_mode="pooled", pooled=pooled,
            warm_state=ws, placement_ok=pooled_ok,
            fragmentation=pooled_frag)

    if mode == "partitioned":
        return partitioned_search()
    if mode == "pooled":
        pooled = pooled_search()
        if pooled is None:
            # no shared LLMs (exact partitioned parity) OR an
            # unplaceable shared replica set — the latter is flagged so
            # explicit pooled-mode callers can tell the difference
            part = partitioned_search()
            part.pooled_unplaceable = pooled_degraded["unplaceable"]
            return part
        return pooled
    # auto: evaluate both, keep the better welfare (ties -> partitioned).
    # A placement-aware partitioned result flagged placement_ok=False is
    # the blind fallback — it cannot deploy, so a placeable pooled plan
    # beats it regardless of welfare.
    part = partitioned_search()
    pooled = pooled_search()
    by_mode = {"partitioned": part.welfare}
    if pooled is not None:
        by_mode["pooled"] = pooled.welfare
    part_unplaceable = config.placement_aware and part.placement_ok is False
    winner = (pooled if pooled is not None
              and (pooled.welfare > part.welfare or part_unplaceable)
              else part)
    winner.pooled_unplaceable = (winner is part
                                 and pooled_degraded["unplaceable"])
    winner.welfare_by_mode = by_mode
    winner.search_time_s = time.perf_counter() - t0
    return winner


def _min_chips_for_units(units_needed: int, spec: hw.ClusterSpec) -> int:
    """Smallest chip count providing ``units_needed`` fraction units.

    :func:`_subcluster` models partial-host remainders explicitly (as
    ``tail_chips``), so no rounding to host multiples is needed — every
    chip a workflow is granted is usable.
    """
    return max(math.ceil(units_needed / spec.fractions_per_chip), 1)


def _enumerate_splits(names: Sequence[str], lo: Dict[str, int], G: int,
                      step: int, cap: int) -> Optional[List[Dict[str, int]]]:
    """All N-way chip compositions (step granularity, remainder to the
    last workflow), or None if there are more than ``cap``."""
    out: List[Dict[str, int]] = []
    tails = {n: sum(lo[m] for m in names[i + 1:])
             for i, n in enumerate(names)}

    def rec(i: int, remaining: int, cur: Dict[str, int]) -> bool:
        n = names[i]
        if i == len(names) - 1:
            if remaining >= lo[n]:
                if len(out) >= cap:
                    return False
                out.append({**cur, n: remaining})
            return True
        for c in range(lo[n], remaining - tails[n] + 1, step):
            cur[n] = c
            if not rec(i + 1, remaining - c, cur):
                return False
        cur.pop(n, None)
        return True

    if not rec(0, G, {}):
        return None
    return out


def _greedy_splits(names: Sequence[str], lo: Dict[str, int], G: int,
                   step: int, lam_targets: Dict[str, float],
                   refs: Dict[str, float], sched, utility, welfare_fn):
    """Candidate splits from greedy water-filling + local exchange.

    Yields complete splits (the caller keeps the best-scoring one):
      1. a proportional seed — lower bounds plus the leftover split by
         demand weight lam_n * L_ref,n (offered work per workflow);
      2. water-filling — chips granted ``step`` at a time to whichever
         workflow raises welfare most (ties: largest own utility gain,
         then heaviest demand);
      3. local exchange — chip moves between workflow pairs kept while
         they strictly improve welfare.
    """
    weight = {}
    for n in names:
        ref = refs[n] if math.isfinite(refs[n]) and refs[n] > 0 else 1.0
        weight[n] = max(lam_targets[n], 1e-9) * ref
    total_w = sum(weight.values()) or 1.0

    split = dict(lo)
    pool = G - sum(split.values())
    # 1) proportional seed, floored to step multiples so water-filling
    # keeps granularity
    for n in names:
        give = int(pool * weight[n] / total_w) // step * step
        split[n] += give
    pool = G - sum(split.values())

    # 2) water-filling on welfare
    while pool > 0:
        g = min(step, pool)
        cur_util = {n: utility(n, sched(n, split[n])) for n in names}
        best_n, best_key = None, None
        for n in names:
            new_u = utility(n, sched(n, split[n] + g))
            new_welfare = welfare_fn({**cur_util, n: new_u})
            key = (new_welfare, new_u - cur_util[n], weight[n])
            if best_key is None or key > best_key:
                best_n, best_key = n, key
        split[best_n] += g
        pool -= g
    yield dict(split)

    # 3) local-exchange refinement
    def welfare_of(sp: Dict[str, int]) -> float:
        us = {}
        for n in names:
            r = sched(n, sp[n])
            if r is None:
                return -math.inf
            us[n] = utility(n, r)
        return welfare_fn(us)

    cur = welfare_of(split)
    max_rounds = 2 * len(names) * len(names)
    for _ in range(max_rounds):
        improved = False
        for i in names:
            for j in names:
                if i == j or split[i] - step < lo[i]:
                    continue
                cand = dict(split)
                cand[i] -= step
                cand[j] += step
                w = welfare_of(cand)
                if w > cur + 1e-12:
                    split, cur = cand, w
                    yield dict(split)
                    improved = True
        if not improved:
            break


def _subcluster(spec: hw.ClusterSpec, chips: int,
                offset: int = 0) -> hw.ClusterSpec:
    """A contiguous sub-cluster of ``chips`` chips (contiguity prune ii).

    Partial-host remainders are modeled explicitly as ``tail_chips``
    rather than truncated, so a 9-chip slice of a 4-chip/host cluster
    really provides 9 chips — no chips are silently dropped from the
    split search's pool.

    On a heterogeneous spec the slice walks the host groups in order
    starting ``offset`` chips in, taking whole (or partial, via a
    reduced-host-count group) prefixes so each sliced chip keeps its
    chip class.  Offsets make the split search's per-workflow slices
    DISJOINT: on a mixed cluster a scarce class is granted to exactly
    one workflow's slice instead of every slice claiming it.  Uniform
    specs ignore ``offset`` — every k-chip slice is the same cluster.
    """
    import dataclasses as dc

    if spec.host_groups:
        left, skip = chips, offset
        taken = []
        for g in spec.groups():
            if left <= 0:
                break
            used = min(skip, g.num_chips)
            skip -= used
            avail = g.num_chips - used
            if avail <= 0:
                continue
            want = min(left, avail)
            left -= want
            # a mid-host start leaves a partial host at the slice head
            head = min(want, -used % g.chips_per_host)
            if head:
                taken.append(dc.replace(g, num_hosts=1,
                                        chips_per_host=head))
                want -= head
            take_hosts, rem = divmod(want, g.chips_per_host)
            if take_hosts:
                taken.append(dc.replace(g, num_hosts=take_hosts))
            if rem:
                taken.append(dc.replace(g, num_hosts=1, chips_per_host=rem))
        return dc.replace(spec, num_hosts=0, tail_chips=0,
                          host_groups=tuple(taken))

    full_hosts, tail = divmod(chips, spec.chips_per_host)
    if full_hosts >= 1:
        return dc.replace(spec, num_hosts=full_hosts, tail_chips=tail)
    # fewer chips than one host: a single smaller host
    return dc.replace(spec, num_hosts=1, chips_per_host=chips, tail_chips=0)
