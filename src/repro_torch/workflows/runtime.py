"""Framework-agnostic workflow runtime.

A workflow is *any* Python generator: it yields groups of LLM calls (or
tool calls) and receives their results — Scepsy never inspects the
program, mirroring the paper's "unrestricted programming model" property.
Two executors drive the same programs:

  * :func:`trace_workflow` — the tracing deployment (paper §4 step 1):
    each workflow-level request runs against an *unloaded* engine (nominal
    cost-model durations, no queueing), and the TracingProxy captures the
    LLM-level telemetry;
  * :class:`ClusterDriver` — the full discrete-event cluster execution
    used by the end-to-end benchmarks: Poisson arrivals, routing,
    continuous batching, prefix caching.
"""
from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Generator, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core.trace import LLMCall, TracingProxy, TraceStore
from repro_torch.serving import costmodel as cm
from repro_torch.serving.radix import Segment
from repro_torch.serving.simulator import (EngineRequest, EventLoop, Router,
                                     output_segment)


@dataclass
class Call:
    llm: str
    prompt_tokens: int
    output_tokens: int
    parent: Optional[int] = None  # handle of a prior call (prefix sharing)


@dataclass
class Tool:
    seconds: float = 0.005  # non-LLM step; negligible per the paper


@dataclass
class CallResult:
    handle: int
    t_start: float
    t_end: float


WorkflowProgram = Callable[[random.Random], Generator]


class _GroupJoin:
    """Fan-in for one yielded call group: collects each call's result
    and resumes the workflow generator when the last one lands.  One
    small object per group (plus a two-arg partial per call) instead of
    one full closure per call — the driver's hot-path allocation."""

    __slots__ = ("driver", "gen", "rec", "results", "pending")

    def __init__(self, driver: "ClusterDriver", gen: Generator,
                 rec: "RequestRecord", n: int):
        self.driver = driver
        self.gen = gen
        self.rec = rec
        self.results: List[Optional[CallResult]] = [None] * n
        self.pending = n

    def done(self, i: int, llm: str, req: "EngineRequest") -> None:
        d = self.driver
        self.results[i] = CallResult(req.req_id, req.t_start_service,
                                     req.t_done)
        if d.telemetry is not None:
            d.telemetry.record_call(d.wf.name, llm, req)
        if d.tracer is not None:
            d.tracer.on_call_done(d.wf.name, self.rec.request_id, llm, req)
        self.pending -= 1
        if self.pending == 0:
            d._advance(self.gen, self.rec, self.results)


@dataclass
class Workflow:
    name: str
    program: WorkflowProgram
    llms: Dict[str, ArchConfig]  # logical name -> architecture
    # service tier (repro_torch.qos.slo.SLOClass); None = unclassified, which
    # every layer treats as best-effort with no admission control
    slo: Optional[object] = None


def with_slo(wf: Workflow, slo) -> Workflow:
    """The same workflow under a service tier (program shared, not copied)."""
    return Workflow(wf.name, wf.program, dict(wf.llms), slo=slo)


# ---------------------------------------------------------------------------
# Tracing executor (unloaded deployment, nominal durations)
# ---------------------------------------------------------------------------


def nominal_call_seconds(cfg: ArchConfig, prompt: int, out: int,
                         cached: int = 0) -> float:
    pf = cm.prefill_cost(cfg, prompt, cached_tokens=cached).total
    dc = cm.decode_step_cost(cfg, 1, prompt + out // 2).total
    return pf + out * dc


def trace_workflow(wf: Workflow, n_requests: int, *, seed: int = 0,
                   cache_aware: bool = True) -> TraceStore:
    proxy = TracingProxy(wf.name)
    handle_counter = [0]
    for rid in range(n_requests):
        rng = random.Random((seed << 20) + rid)
        gen = wf.program(rng)
        proxy.begin_request(rid, 0.0)
        t = 0.0
        handles: Dict[int, CallResult] = {}
        totals: Dict[int, int] = {}  # handle -> prompt+output tokens
        try:
            group = next(gen)
            while True:
                if isinstance(group, Tool):
                    t += group.seconds
                    group = gen.send([])
                    continue
                calls: Sequence[Call] = group
                results = []
                t_end_group = t
                for c in calls:
                    cfg = wf.llms[c.llm]
                    cached = 0
                    if cache_aware and c.parent is not None and c.parent in handles:
                        # exact: the child re-sends its parent's full
                        # sequence (prompt + output) as its prefix
                        cached = max(min(totals[c.parent],
                                         c.prompt_tokens - 1), 0)
                    dur = nominal_call_seconds(cfg, c.prompt_tokens,
                                               c.output_tokens, cached)
                    handle_counter[0] += 1
                    h = handle_counter[0]
                    res = CallResult(h, t, t + dur)
                    handles[h] = res
                    totals[h] = c.prompt_tokens + c.output_tokens
                    results.append(res)
                    proxy.record(LLMCall(
                        workflow_request=rid, llm=c.llm, t_start=t,
                        t_end=t + dur, prompt_tokens=c.prompt_tokens,
                        output_tokens=c.output_tokens,
                        cached_prefix_tokens=cached))
                    t_end_group = max(t_end_group, t + dur)
                t = t_end_group
                group = gen.send(results)
        except StopIteration:
            pass
        proxy.end_request(rid, t)
    return proxy.store


# ---------------------------------------------------------------------------
# Cluster executor (end-to-end benchmark driver)
# ---------------------------------------------------------------------------


def _truncate_seq(seq: Sequence[Segment], n: int) -> Tuple[Segment, ...]:
    """Leading ``n`` tokens of a segment sequence (last span partial)."""
    out: List[Segment] = []
    left = n
    for seg_id, length in seq:
        if left <= 0:
            break
        take = min(length, left)
        out.append((seg_id, take))
        left -= take
    return tuple(out)


@dataclass
class RequestRecord:
    request_id: int
    arrival: float
    done: float = -1.0
    # request-level QoS bookkeeping (populated when the driver has a
    # WorkflowQoS context):
    slo_class: str = ""
    deadline: float = math.inf  # absolute; inf = best-effort
    rejected: bool = False  # shed at the front door, never dispatched
    degraded: bool = False  # admitted, but demoted to best-effort
    # admitted via JIT model substitution: calls to substitutable stages
    # route to the substitute tier's replicas; SLO class/deadline kept
    substituted: bool = False
    issued_s: float = 0.0  # expected work already dispatched (WorkModel)
    # True when an installed Tracer holds this request in its trace
    # reservoir: unsampled requests skip the per-group/per-tool hooks
    obs_sampled: bool = False

    @property
    def latency(self) -> float:
        return self.done - self.arrival

    @property
    def slo_met(self) -> bool:
        """Completed within its latency target (best-effort is always
        met; rejected or unfinished requests never are)."""
        return self.done >= 0 and not self.rejected \
            and self.done <= self.deadline


class ArrivalSource:
    """Generator-driven lazy arrival stream: exactly ONE pending loop
    event (the next arrival) at any time, so a million-request ramp
    costs O(1) heap space instead of O(N) pre-materialized events.

    The underlying generator yields ``(t, rid)`` pairs drawn from the
    *same* RNG in the *same* order as the legacy eager schedulers, so
    lazy and eager runs see identical arrival processes (gated by an
    equivalence test).  ``scheduled`` counts arrivals fired so far.
    """

    def __init__(self, driver: "ClusterDriver", gen, seed: int):
        self._driver = driver
        self._gen = gen
        self._seed = seed
        self.scheduled = 0
        self.exhausted = False
        self._arm()

    def _arm(self) -> None:
        try:
            t, rid = next(self._gen)
        except StopIteration:
            self.exhausted = True
            return
        self._driver.loop.schedule(t, self._fire, rid)

    def _fire(self, rid: int) -> None:
        self.scheduled += 1
        self._arm()  # keep the stream primed before running the program
        self._driver._start(rid, self._seed)


class ClusterDriver:
    """Drives workflow requests through routed engine replicas.

    ``routers`` is keyed by whatever serving tier the deployment exposes:
    workflow-local stage names in a partitioned deployment, or shared
    tenant ids in a pooled one — in the latter case ``route_map``
    translates each call's workflow-local LLM name to its tenant, so the
    same workflow program runs unchanged against pooled replicas.

    ``telemetry`` (optional, duck-typed — e.g. a
    :class:`repro_torch.core.drift.DriftMonitor`) receives ``record_arrival``,
    ``record_call`` and ``record_request_done`` callbacks, the live
    signal the online drift detector runs on; ``record_shed`` is called
    (when the sink defines it) for front-door rejections/degradations.

    ``qos`` (a :class:`repro_torch.qos.slo.WorkflowQoS`) turns on request-
    level QoS: each arrival passes admission control (when the context
    carries a controller), every engine request is tagged with
    :class:`repro_torch.qos.slo.RequestQoS` metadata — deadline, class weight
    and the work model's remaining-work estimate — which the engines'
    queue disciplines order by.

    ``sink`` (a :class:`repro_torch.core.telemetry.StatsSink`, duck-typed)
    switches the driver to aggregate-only accounting: ``records`` stays
    empty and every completion feeds the sink's counters/sketches
    instead, so memory is O(in-flight) regardless of run length.  The
    default (no sink) keeps the exact per-request record list.
    """

    # handles are unique process-wide: drivers can share pooled engine
    # replicas, and engine-side prefix/parent registries key on them
    _uid = itertools.count(1)

    def __init__(self, wf: Workflow, routers: Dict[str, Router],
                 loop: EventLoop,
                 route_map: Optional[Dict[str, str]] = None,
                 telemetry=None, qos=None, sink=None,
                 substitute_map: Optional[Dict[str, str]] = None):
        self.wf = wf
        self.routers = routers
        self.loop = loop
        self.route_map = route_map or {}
        # JIT substitution routes: workflow-local llm name -> router key
        # of the substitute tier's replicas (used only for requests the
        # admission controller decided to substitute)
        self.substitute_map = substitute_map or {}
        self.telemetry = telemetry
        self.qos = qos
        self.sink = sink
        # observability hook (repro_torch.obs.spans.Tracer); None = untraced
        # fast path — every site below guards on it
        self.tracer = None
        self.records: List[RequestRecord] = []
        self.n_started = 0
        self.n_completed = 0
        # call handle -> full segment sequence (prompt + output) of the
        # call, kept while its workflow request is in flight so children
        # can extend it; pruned at request completion
        self._seqs: Dict[int, Tuple[Segment, ...]] = {}
        self._rec_handles: Dict[int, List[int]] = {}
        # distinct router objects, for sticky-state pruning on completion
        # (baseline systems may pass duck-typed routers without forget)
        self._router_objs = [r for r in
                             {id(r): r for r in routers.values()}.values()
                             if hasattr(r, "forget")]

    def set_routers(self, routers: Dict[str, Router],
                    route_map: Optional[Dict[str, str]] = None) -> None:
        """Swap the serving tier live (replan adoption mid-run): future
        calls route through the new views, and the sticky-prune list is
        recomputed so ``Router.forget`` keeps reaching the routers that
        are actually accumulating sticky state."""
        self.routers = routers
        if route_map is not None:
            self.route_map = route_map
        self._router_objs = [r for r in
                             {id(r): r for r in routers.values()}.values()
                             if hasattr(r, "forget")]

    def router_for(self, llm: str, rec: Optional["RequestRecord"] = None
                   ) -> Router:
        """The router serving a workflow-local LLM name (tenancy-aware).

        When ``rec`` was admitted via substitution, stages with a
        substitute route go to the substitute tier's replicas instead.
        """
        if rec is not None and rec.substituted \
                and llm in self.substitute_map:
            return self.routers[self.substitute_map[llm]]
        return self.routers[self.route_map.get(llm, llm)]

    def schedule_open_loop(self, arrival_rate: float, n_requests: int, *,
                           seed: int = 0, start: float = 0.0,
                           rid_start: int = 0,
                           arrival_seed: Optional[int] = None,
                           eager: bool = False):
        """Constant-rate Poisson arrivals, lazily generated by default
        (one pending event; see :class:`ArrivalSource`).  ``eager=True``
        pre-schedules every arrival (legacy behavior, O(N) pending) and
        returns the count; otherwise returns the source.  The arrival
        process draws from ``arrival_seed`` (default: ``seed``); request
        programs always seed from ``seed``.
        """
        aseed = seed if arrival_seed is None else arrival_seed
        if eager:
            rng = random.Random(aseed)
            t = start
            for rid in range(rid_start, rid_start + n_requests):
                self.loop.schedule(t, self._start, rid, seed)
                t += rng.expovariate(arrival_rate)
            return n_requests

        def gen():
            rng = random.Random(aseed)
            t = start
            for rid in range(rid_start, rid_start + n_requests):
                yield t, rid
                t += rng.expovariate(arrival_rate)

        return ArrivalSource(self, gen(), seed)

    def run_open_loop(self, arrival_rate: float, n_requests: int, *,
                      seed: int = 0, until: float = math.inf,
                      eager: bool = False) -> List[RequestRecord]:
        self.schedule_open_loop(arrival_rate, n_requests, seed=seed,
                                eager=eager)
        self.loop.run(until)
        return [r for r in self.records if r.done >= 0]

    def schedule_arrivals(self, segments: Sequence[tuple], *,
                          seed: int = 0, start: float = 0.0,
                          rid_start: int = 0, eager: bool = False):
        """Schedule piecewise-constant Poisson arrivals.

        ``segments`` is a sequence of ``(rate, duration_s)`` pairs — the
        arrival-rate *ramp* used to reproduce rate drift without
        hardware.  Request ids continue from ``rid_start``.  Lazy by
        default: returns an :class:`ArrivalSource` whose ``scheduled``
        counter is live; ``eager=True`` pre-schedules everything and
        returns the request count (legacy behavior).
        """
        if eager:
            rng = random.Random(seed)
            rid = rid_start
            t_seg = start
            for rate, duration in segments:
                t_end = t_seg + duration
                t = t_seg
                while rate > 0:
                    t += rng.expovariate(rate)
                    if t >= t_end:
                        break
                    self.loop.schedule(t, self._start, rid, seed)
                    rid += 1
                t_seg = t_end
            return rid - rid_start

        def gen():
            rng = random.Random(seed)
            rid = rid_start
            t_seg = start
            for rate, duration in segments:
                t_end = t_seg + duration
                t = t_seg
                while rate > 0:
                    t += rng.expovariate(rate)
                    if t >= t_end:
                        break
                    yield t, rid
                    rid += 1
                t_seg = t_end

        return ArrivalSource(self, gen(), seed)

    def run_ramped(self, segments: Sequence[tuple], *, seed: int = 0,
                   until: float = math.inf) -> List[RequestRecord]:
        """Open-loop run under an arrival-rate ramp (see
        :meth:`schedule_arrivals`)."""
        self.schedule_arrivals(segments, seed=seed)
        self.loop.run(until)
        return [r for r in self.records if r.done >= 0]

    def start_request(self, rid: int, seed: int = 0) -> None:
        """Begin one workflow-level request now (external arrival
        control — e.g. several drivers interleaved on one loop)."""
        self._start(rid, seed)

    def _start(self, rid: int, seed: int) -> None:
        rec = RequestRecord(rid, self.loop.now)
        self.n_started += 1
        if self.sink is None:
            self.records.append(rec)
        else:
            self.sink.observe_arrival(self.wf.name, self.loop.now)
        if self.telemetry is not None:
            self.telemetry.record_arrival(self.wf.name, self.loop.now)
        if self.tracer is not None:
            rec.obs_sampled = self.tracer.on_request_start(
                self.wf.name, rid, self.loop.now)
        if self.qos is not None:
            slo = self.qos.slo
            rec.slo_class = slo.name
            rec.deadline = self.loop.now + slo.deadline_s
            if self.qos.admission is not None:
                decision = self.qos.admission.admit(
                    self.wf.name, self.loop.now)
                if self.tracer is not None:
                    self.tracer.on_request_admission(
                        self.wf.name, rid, decision, self.loop.now)
                if decision == "reject":
                    rec.rejected = True
                    if self.sink is not None:
                        self.sink.observe_reject(self.wf.name)
                    if self.telemetry is not None and \
                            hasattr(self.telemetry, "record_shed"):
                        self.telemetry.record_shed(
                            self.wf.name, slo.name, "reject", self.loop.now)
                    return
                if decision == "substitute":
                    # rerouted to the substitute tier; class and
                    # deadline are KEPT (substitution never upgrades)
                    rec.substituted = True
                    if self.sink is not None and \
                            hasattr(self.sink, "observe_substitute"):
                        self.sink.observe_substitute(self.wf.name)
                    if self.telemetry is not None and \
                            hasattr(self.telemetry, "record_shed"):
                        self.telemetry.record_shed(
                            self.wf.name, slo.name, "substitute",
                            self.loop.now)
                if decision == "degrade":
                    rec.degraded = True
                    rec.deadline = math.inf
                    if self.sink is not None:
                        self.sink.observe_degrade(self.wf.name)
                    if self.telemetry is not None and \
                            hasattr(self.telemetry, "record_shed"):
                        self.telemetry.record_shed(
                            self.wf.name, slo.name, "degrade", self.loop.now)
        rng = random.Random((seed << 20) + rid)
        gen = self.wf.program(rng)
        self._advance(gen, rec, None)

    def _advance(self, gen: Generator, rec: RequestRecord, send_val) -> None:
        try:
            group = next(gen) if send_val is None else gen.send(send_val)
        except StopIteration:
            rec.done = self.loop.now
            self.n_completed += 1
            for h in self._rec_handles.pop(rec.request_id, []):
                self._seqs.pop(h, None)
            for router in self._router_objs:
                router.forget(rec.request_id)
            if self.sink is not None:
                self.sink.observe(self.wf.name, rec)
            if self.telemetry is not None:
                self.telemetry.record_request_done(self.wf.name, rec)
            if self.tracer is not None:
                self.tracer.on_request_done(self.wf.name, rec)
            return
        if isinstance(group, Tool):
            if rec.obs_sampled and self.tracer is not None:
                self.tracer.on_tool(self.wf.name, rec.request_id,
                                    self.loop.now, group.seconds)
            self.loop.schedule(self.loop.now + group.seconds,
                               self._advance, gen, rec, [])
            return
        calls: Sequence[Call] = group
        join = _GroupJoin(self, gen, rec, len(calls))
        tr = self.tracer
        sampled = (rec.obs_sampled and tr is not None
                   and tr.on_group_start(self.wf.name, rec.request_id,
                                         self.loop.now, len(calls)))
        for i, c in enumerate(calls):
            h = next(ClusterDriver._uid)
            out_tokens = max(c.output_tokens, 1)
            prefix, truth = self._prefix_for(h, c)
            self._seqs[h] = prefix + (output_segment(h, out_tokens),)
            self._rec_handles.setdefault(rec.request_id, []).append(h)
            if sampled:
                tr.on_call_submit(self.wf.name, rec.request_id, h, c.llm,
                                  self.loop.now)
            req = EngineRequest(
                req_id=h, prompt_tokens=c.prompt_tokens,
                output_tokens=out_tokens, arrival=self.loop.now,
                on_complete=partial(join.done, i, c.llm),
                parent_id=c.parent,
                workflow_request=rec.request_id,
                prefix=prefix, true_prefix=truth,
                qos=self._request_qos(rec, c.llm))
            self.router_for(c.llm, rec).submit(req)

    def _prefix_for(self, h: int, c: Call
                    ) -> Tuple[Tuple[Segment, ...], int]:
        """The call's prompt as a segment sequence, plus the ground-truth
        shared-prefix tokens (vs its parent) for the exactness gate.

        A child's prompt is modeled as its parent's full sequence
        (prompt + generated output) followed by a fresh delta segment;
        when the child's prompt is *shorter* than the parent's sequence
        (beam-search style truncation) it is the truncated parent
        sequence instead.  Parentless prompts are one fresh segment.
        """
        p = c.parent
        if p is None or p not in self._seqs:
            return ((("s", h), max(c.prompt_tokens, 1)),), 0
        parent_seq = self._seqs[p]
        ptotal = sum(length for _, length in parent_seq)
        if c.prompt_tokens > ptotal:
            prefix = parent_seq + ((("d", h), c.prompt_tokens - ptotal),)
        else:
            prefix = _truncate_seq(parent_seq, max(c.prompt_tokens, 1))
        truth = max(min(ptotal, c.prompt_tokens - 1), 0)
        return prefix, truth

    def _request_qos(self, rec: RequestRecord, llm: str):
        """Tag one engine request with this workflow request's urgency
        state: deadline, class weight, and the work model's estimate of
        the work still ahead once this call finishes."""
        if self.qos is None:
            return None
        from repro_torch.qos.slo import RequestQoS

        work = self.qos.work
        rec.issued_s += work.per_call_s.get(llm, 0.0)
        slo = self.qos.slo
        return RequestQoS(
            tenant=self.wf.name, slo=slo.name, weight=slo.weight,
            deadline=rec.deadline,
            remaining_s=work.remaining_after(rec.issued_s),
            degraded=rec.degraded)


# ---------------------------------------------------------------------------
# Drift injection (reproducible share-shifting request mixes)
# ---------------------------------------------------------------------------


def drift_workflow(wf: Workflow, *,
                   output_scale: Optional[Dict[str, float]] = None,
                   call_repeat: Optional[Dict[str, int]] = None,
                   name: Optional[str] = None) -> Workflow:
    """A share-shifted variant of ``wf`` for drift experiments.

    ``output_scale`` multiplies the output length of calls to the named
    LLMs (shifting that LLM's aggregate execution-time share and token
    distribution); ``call_repeat`` issues each call to the named LLMs
    ``k`` times in parallel (shifting n_m).  Extra repeated calls are
    invisible to the wrapped program — it receives exactly the results
    it asked for — so any workflow program can be drifted unmodified.
    """
    scales = dict(output_scale or {})
    repeats = dict(call_repeat or {})

    def program(rng: random.Random) -> Generator:
        gen = wf.program(rng)
        try:
            group = next(gen)
        except StopIteration:
            return
        while True:
            if isinstance(group, Tool):
                sent = yield group
            else:
                out_calls: List[Call] = []
                keep: List[int] = []
                for c in group:
                    out = max(int(round(
                        c.output_tokens * scales.get(c.llm, 1.0))), 1)
                    keep.append(len(out_calls))
                    out_calls.append(Call(c.llm, c.prompt_tokens, out,
                                          parent=c.parent))
                    for _ in range(max(repeats.get(c.llm, 1), 1) - 1):
                        out_calls.append(Call(c.llm, c.prompt_tokens, out))
                results = yield out_calls
                sent = ([results[i] for i in keep]
                        if results else results)
            try:
                group = gen.send(sent)
            except StopIteration:
                return

    return Workflow(name or f"{wf.name}", program, dict(wf.llms),
                    slo=wf.slo)
