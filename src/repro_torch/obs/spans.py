"""Span records + the Tracer hook threaded through the serving stack.

Span model (one sampled workflow request):

* the **request span** runs from arrival to completion;
* its **phase spans** tile it exactly: at any moment the driver is
  either waiting on one yielded call group (``group`` phase, closed
  when the last call lands) or on a tool timer (``tool`` phase), so
  the phase durations sum to the end-to-end latency — an invariant the
  property tests (and ``bench_obs``'s critical-path gate) check;
* each **call span** inside a group records queued time (router submit
  to engine admission), service time (admission to completion), exact
  prefill seconds (accumulated per admitted chunk from the engine's
  cost model), and point events (preemption, substitution).

Sampling: per-workflow reservoir (algorithm R) over *arrivals*, so a
10^6-request run holds at most ``sample_per_workflow`` request traces
per workflow — O(sample) memory — while every request still feeds the
O(1) aggregate accounting (per-(workflow, LLM) execution shares,
latency sketches, metric counters).  The reservoir draws from its own
RNG, never the simulation's, so installing a tracer cannot perturb a
seeded run (``bench_obs`` gates bit-identical completion traces).

Every hook site in the driver / engine / router / admission / replan
layers is guarded by ``if tracer is None`` on a plain attribute that
defaults to ``None`` — the disabled path allocates nothing and runs no
observability code at all.
"""
from __future__ import annotations

import random
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

from repro_torch.core.telemetry import GKQuantile
from repro_torch.obs.metrics import MetricsRegistry

# phase / event kinds
GROUP = "group"
TOOL = "tool"
QUEUED = "queued"
SERVICE = "service"
PREFILL = "prefill"
DECODE = "decode"
PREEMPTED = "preempted"
SUBSTITUTED = "substituted"
MIGRATED = "migrated"

_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

# engine-iteration hooks are stride-sampled (1-in-ITER_STRIDE events
# take the full accounting path); must be a power of two
ITER_STRIDE = 8
_ITER_MASK = ITER_STRIDE - 1


class _ReqTrace:
    """One sampled workflow request: phases tile [arrival, done]."""

    __slots__ = ("workflow", "rid", "arrival", "done", "outcome",
                 "slo_class", "phases", "calls", "events", "_open",
                 "_open_calls", "live_handles")

    def __init__(self, workflow: str, rid: int, arrival: float):
        self.workflow = workflow
        self.rid = rid
        self.arrival = arrival
        self.done = -1.0
        self.outcome = ""
        self.slo_class = ""
        self.phases: List[dict] = []
        self.calls: List[dict] = []
        self.events: List[dict] = []
        self._open: Optional[dict] = None  # phase awaiting its end time
        self._open_calls: List[int] = []  # call indices of the open group
        self.live_handles: set = set()

    def close_phase(self, t: float) -> None:
        ph = self._open
        if ph is None:
            return
        ph["t1"] = t
        if ph["kind"] == GROUP and self._open_calls:
            crit = max(self._open_calls,
                       key=lambda i: self.calls[i]["done"])
            ph["critical_llm"] = self.calls[crit]["llm"]
        self.phases.append(ph)
        self._open = None
        self._open_calls = []

    def as_dict(self) -> dict:
        return {"workflow": self.workflow, "rid": self.rid,
                "arrival": self.arrival, "done": self.done,
                "outcome": self.outcome, "slo_class": self.slo_class,
                "phases": list(self.phases), "calls": list(self.calls),
                "events": list(self.events)}


class _EngineStats:
    """Per-engine aggregate counters (hot path: plain field adds)."""

    __slots__ = ("engine", "label", "iterations", "batch_sum",
                 "queue_sum", "queue_max", "batch_hist")

    def __init__(self, engine, label: str):
        self.engine = engine
        self.label = label
        self.iterations = 0
        self.batch_sum = 0
        self.queue_sum = 0
        self.queue_max = 0
        self.batch_hist: Dict[int, int] = {}


class Tracer:
    """The hook object installed on driver/engine/router/admission/
    replan components (see :func:`install_tracer`).

    ``sample_per_workflow`` bounds retained request traces per workflow
    (reservoir over arrivals); ``enabled=False`` builds a tracer that
    :func:`install_tracer` refuses to wire — the stack stays on its
    ``tracer is None`` fast path.
    """

    def __init__(self, *, sample_per_workflow: int = 64, seed: int = 0,
                 enabled: bool = True,
                 metrics: Optional[MetricsRegistry] = None):
        self.enabled = enabled
        self.k = max(int(sample_per_workflow), 1)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._rng = random.Random(seed)
        # reservoir state
        self._seen: Dict[str, int] = {}  # workflow -> arrivals observed
        self._slots: Dict[str, List[Tuple[str, int]]] = {}
        self._traces: Dict[Tuple[str, int], _ReqTrace] = {}
        # sampled in-flight engine calls: handle -> [trace, call dict]
        self._live_calls: Dict[int, list] = {}
        self._lat: Dict[str, GKQuantile] = {}
        self._lat_sum: Dict[str, float] = {}
        self._lat_n: Dict[str, int] = {}
        # engine aggregates, keyed id(engine)
        self._eng: Dict[int, _EngineStats] = {}
        self._eng_labels: set = set()
        # hot-path accumulators: per-event hooks touch ONLY these plain
        # dicts; :meth:`collect` materializes them into the metric
        # families (a labels() lookup per event is measurable at 10^5+
        # events/s of simulated traffic — deferring it keeps enabled-
        # tracer overhead low)
        self._call_acc: Dict[Tuple[str, str], list] = {}  # n, busy, queued
        self.iter_mask = _ITER_MASK  # read by EngineSim's hook guard
        self._route_counts: Dict[str, int] = {}
        self._adm_counts: Dict[Tuple[str, str], int] = {}
        self._req_counts: Dict[Tuple[str, str], int] = {}
        self._shed_counts: Dict[Tuple[str, str], int] = {}
        # pre-bound metric families
        m = self.metrics
        self._m_requests = m.counter(
            "scepsy_requests_total",
            "workflow requests by outcome", ("workflow", "outcome"))
        self._m_calls = m.counter(
            "scepsy_calls_total", "LLM calls completed",
            ("workflow", "llm"))
        self._m_busy = m.counter(
            "scepsy_call_busy_seconds_total",
            "engine service seconds by call", ("workflow", "llm"))
        self._m_queued = m.counter(
            "scepsy_call_queued_seconds_total",
            "queueing seconds before admission", ("workflow", "llm"))
        self._m_admission = m.counter(
            "scepsy_admission_total",
            "front-door admission decisions", ("workflow", "decision"))
        self._m_shed = m.counter(
            "scepsy_shed_total", "rejected/degraded/substituted arrivals",
            ("workflow", "kind"))
        self._m_preempt = m.counter(
            "scepsy_preemptions_total", "QoS preemptions", ("engine",))
        self._m_replan = m.counter(
            "scepsy_replan_total", "replan actions by rung", ("rung",))
        self._m_route = m.counter(
            "scepsy_routing_total", "router target-selection tier",
            ("tier",))
        self._m_batch = m.histogram(
            "scepsy_engine_batch_occupancy",
            "running batch size at each engine iteration", (),
            buckets=_BATCH_BUCKETS)
        self._m_queue_depth = m.gauge(
            "scepsy_engine_queue_depth",
            "waiting requests at last iteration", ("engine",))
        self._m_kv_util = m.gauge(
            "scepsy_engine_kv_utilization",
            "radix-cache resident tokens / KV budget", ("engine",))
        self._m_batch_mean = m.gauge(
            "scepsy_engine_batch_mean",
            "mean running batch size over all iterations", ("engine",))
        self._m_iters = m.gauge(
            "scepsy_engine_iterations_total",
            "engine scheduling iterations", ("engine",))
        self._batch_child = self._m_batch.labels()

    # ------------------------------------------------------------------
    # driver hooks
    # ------------------------------------------------------------------

    def on_request_start(self, workflow: str, rid: int, t: float) -> bool:
        """Returns True when the request enters the trace reservoir; the
        driver stamps the flag on the request record so unsampled
        requests skip the per-group / per-tool hooks entirely."""
        n = self._seen.get(workflow, 0) + 1
        self._seen[workflow] = n
        slots = self._slots.setdefault(workflow, [])
        key = (workflow, rid)
        if len(slots) < self.k:
            slots.append(key)
            self._traces[key] = _ReqTrace(workflow, rid, t)
            return True
        j = self._rng.randrange(n)
        if j < self.k:
            self._evict(slots[j])
            slots[j] = key
            self._traces[key] = _ReqTrace(workflow, rid, t)
            return True
        return False

    def _evict(self, key: Tuple[str, int]) -> None:
        tr = self._traces.pop(key, None)
        if tr is not None:
            for h in tr.live_handles:
                self._live_calls.pop(h, None)

    def on_request_admission(self, workflow: str, rid: int,
                             decision: str, t: float) -> None:
        if decision != "admit":
            k = (workflow, decision)
            self._shed_counts[k] = self._shed_counts.get(k, 0) + 1
            if decision == "reject":
                k = (workflow, "rejected")
                self._req_counts[k] = self._req_counts.get(k, 0) + 1
        tr = self._traces.get((workflow, rid))
        if tr is None:
            return
        if decision == "reject":
            tr.outcome = "rejected"
            tr.done = t
        elif decision != "admit":
            tr.events.append({"type": SUBSTITUTED if decision ==
                              "substitute" else decision, "t": t})

    def on_group_start(self, workflow: str, rid: int, t: float,
                       n_calls: int) -> bool:
        """Returns True when this request is sampled (the driver then
        reports per-call submissions)."""
        tr = self._traces.get((workflow, rid))
        if tr is None:
            return False
        tr.close_phase(t)
        tr._open = {"kind": GROUP, "t0": t, "t1": -1.0, "n_calls": n_calls,
                    "critical_llm": ""}
        return True

    def on_call_submit(self, workflow: str, rid: int, handle: int,
                       llm: str, t: float) -> None:
        tr = self._traces.get((workflow, rid))
        if tr is None:
            return
        call = {"llm": llm, "handle": handle, "submit": t, "start": -1.0,
                "done": -1.0, "queued_s": 0.0, "service_s": 0.0,
                "prefill_s": 0.0, "preemptions": 0}
        tr.calls.append(call)
        tr._open_calls.append(len(tr.calls) - 1)
        tr.live_handles.add(handle)
        self._live_calls[handle] = [tr, call]

    def on_call_done(self, workflow: str, rid: int, llm: str, req) -> None:
        busy = req.t_done - req.t_start_service
        if busy < 0.0:
            busy = 0.0
        queued = req.t_start_service - req.arrival
        if queued < 0.0:
            queued = 0.0
        try:
            acc = self._call_acc[(workflow, llm)]
        except KeyError:
            acc = self._call_acc[(workflow, llm)] = [0, 0.0, 0.0]
        acc[0] += 1
        acc[1] += busy
        acc[2] += queued
        rec = self._live_calls.pop(req.req_id, None)
        if rec is None:
            return
        tr, call = rec
        tr.live_handles.discard(req.req_id)
        call["start"] = req.t_start_service
        call["done"] = req.t_done
        call["queued_s"] = queued
        call["service_s"] = busy
        call["preemptions"] = req.preemptions

    def on_tool(self, workflow: str, rid: int, t: float,
                seconds: float) -> None:
        tr = self._traces.get((workflow, rid))
        if tr is None:
            return
        tr.close_phase(t)
        tr._open = {"kind": TOOL, "t0": t, "t1": -1.0}

    def on_request_done(self, workflow: str, rec) -> None:
        rid = rec.request_id
        outcome = ("degraded" if getattr(rec, "degraded", False)
                   else "substituted" if getattr(rec, "substituted", False)
                   else "completed")
        k = (workflow, outcome)
        self._req_counts[k] = self._req_counts.get(k, 0) + 1
        lat = rec.done - rec.arrival
        sk = self._lat.get(workflow)
        if sk is None:
            sk = self._lat[workflow] = GKQuantile(0.005)
            self._lat_sum[workflow] = 0.0
            self._lat_n[workflow] = 0
        sk.add(lat)
        self._lat_sum[workflow] += lat
        self._lat_n[workflow] += 1
        tr = self._traces.get((workflow, rid))
        if tr is not None:
            tr.close_phase(rec.done)
            tr.done = rec.done
            tr.outcome = outcome
            tr.slo_class = getattr(rec, "slo_class", "")

    # ------------------------------------------------------------------
    # engine hooks
    # ------------------------------------------------------------------

    def _register_engine(self, engine) -> _EngineStats:
        label = getattr(engine, "name", "engine") or "engine"
        k = 1
        while label in self._eng_labels:
            k += 1
            label = f"{getattr(engine, 'name', 'engine')}#{k}"
        self._eng_labels.add(label)
        st = _EngineStats(engine, label)
        self._eng[id(engine)] = st
        return st

    def on_engine_iteration(self, engine, t0: float, duration: float,
                            batch: int, waiting: int) -> None:
        # stride-sampled at the CALL SITE: the engine invokes this for
        # one in ITER_STRIDE scheduling iterations (it reads the
        # tracer's ``iter_mask``), so each received event counts for
        # ITER_STRIDE iterations — collect() scales the derived totals;
        # occupancy / queue statistics are systematic samples of the
        # iteration stream.
        st = self._eng.get(id(engine))
        if st is None:
            st = self._register_engine(engine)
        st.iterations += 1
        st.batch_sum += batch
        st.queue_sum += waiting
        if waiting > st.queue_max:
            st.queue_max = waiting
        h = st.batch_hist
        h[batch] = h.get(batch, 0) + 1

    def on_engine_admit(self, req, t0: float, new_tokens: int,
                        prefill_s: float) -> None:
        rec = self._live_calls.get(req.req_id)
        if rec is None:
            return
        call = rec[1]
        call["prefill_s"] += prefill_s
        if call["start"] < 0:
            call["start"] = t0

    def on_engine_preempt(self, engine, victim, t0: float) -> None:
        st = self._eng.get(id(engine))
        if st is None:
            st = self._register_engine(engine)
        self._m_preempt.labels(st.label).inc()
        rec = self._live_calls.get(victim.req_id)
        if rec is not None:
            rec[0].events.append({"type": PREEMPTED, "t": t0,
                                  "handle": victim.req_id,
                                  "engine": st.label})

    # ------------------------------------------------------------------
    # router / control-plane hooks
    # ------------------------------------------------------------------

    def on_route(self, tier: str) -> None:
        rc = self._route_counts
        rc[tier] = rc.get(tier, 0) + 1

    def on_admission_decision(self, workflow: str, decision: str,
                              t: float) -> None:
        k = (workflow, decision)
        self._adm_counts[k] = self._adm_counts.get(k, 0) + 1

    def on_replan(self, action) -> None:
        self._m_replan.labels(str(getattr(action, "rung", 0))).inc()

    # ------------------------------------------------------------------
    # readers
    # ------------------------------------------------------------------

    def collect(self) -> None:
        """Materialize the hot-path accumulators into the metric
        families and refresh pull-style gauges (queue depth, KV
        utilization, batch occupancy) from the registered engines.
        Call before reading ``metrics`` mid-run; :meth:`export` calls
        it for you.  Idempotent — accumulators are monotone and the
        children are overwritten, not incremented."""
        for (w, llm), acc in self._call_acc.items():
            self._m_calls.labels(w, llm).set(acc[0])
            self._m_busy.labels(w, llm).set(acc[1])
            self._m_queued.labels(w, llm).set(acc[2])
        for (w, outcome), n in self._req_counts.items():
            self._m_requests.labels(w, outcome).set(n)
        for (w, kind), n in self._shed_counts.items():
            self._m_shed.labels(w, kind).set(n)
        for (w, decision), n in self._adm_counts.items():
            self._m_admission.labels(w, decision).set(n)
        for tier, n in self._route_counts.items():
            self._m_route.labels(tier).set(n)
        ch = self._batch_child
        counts = [0] * (len(ch.bounds) + 1)
        total, sm = 0, 0.0
        for st in self._eng.values():
            for b, n in st.batch_hist.items():
                counts[bisect_left(ch.bounds, b)] += n * ITER_STRIDE
                total += n * ITER_STRIDE
                sm += b * n * ITER_STRIDE
        ch.counts, ch.count, ch.sum = counts, total, sm
        for st in self._eng.values():
            eng = st.engine
            self._m_iters.labels(st.label).set(st.iterations * ITER_STRIDE)
            if st.iterations:
                self._m_batch_mean.labels(st.label).set(
                    st.batch_sum / st.iterations)
            self._m_queue_depth.labels(st.label).set(
                len(getattr(eng, "waiting", ())))
            radix = getattr(eng, "radix", None)
            cap = getattr(eng, "kv_capacity_tokens", 0)
            if radix is not None and cap:
                self._m_kv_util.labels(st.label).set(radix.tokens / cap)

    def traces(self, workflow: Optional[str] = None,
               finished_only: bool = True) -> List[dict]:
        """Sampled request traces (reservoir members), arrival-ordered."""
        out = []
        for tr in self._traces.values():
            if workflow is not None and tr.workflow != workflow:
                continue
            if finished_only and tr.done < 0:
                continue
            out.append(tr.as_dict())
        out.sort(key=lambda d: (d["workflow"], d["arrival"], d["rid"]))
        return out

    def observed_shares(self) -> Dict[str, Dict[str, float]]:
        """Per-(workflow, LLM) execution-time shares: each LLM's total
        engine-busy seconds over the workflow's total, accumulated from
        EVERY completed call (not just sampled ones).  Busy-seconds
        weighting is exactly how :func:`repro_torch.obs.accuracy.
        expected_shares` weights a pipeline's stages (calls x service
        latency), so observed and expected compare like for like.
        :class:`repro_torch.core.drift.DriftMonitor` uses a mean of
        per-request shares instead — close at steady state, which is
        what :meth:`DriftMonitor.corroborate`'s tolerance absorbs."""
        out: Dict[str, Dict[str, float]] = {}
        for (wf, llm), acc in self._call_acc.items():
            out.setdefault(wf, {})[llm] = acc[1]
        for wf, row in out.items():
            total = sum(row.values())
            if total > 0:
                out[wf] = {llm: b / total for llm, b in row.items()}
        return out

    def request_latency(self, workflow: str) -> dict:
        n = self._lat_n.get(workflow, 0)
        if not n:
            return {"count": 0}
        sk = self._lat[workflow]
        return {"count": n, "mean": self._lat_sum[workflow] / n,
                "p50": sk.query(0.50), "p99": sk.query(0.99)}

    def sampled_counts(self) -> Dict[str, dict]:
        return {wf: {"seen": n, "sampled": len(self._slots.get(wf, []))}
                for wf, n in sorted(self._seen.items())}

    def export(self) -> dict:
        """JSON-safe dump: sampled traces + metrics snapshot + text
        exposition (what ``tools/scepsy_report.py`` renders)."""
        self.collect()
        return {
            "traces": self.traces(finished_only=False),
            "sampling": {"per_workflow": self.k,
                         "counts": self.sampled_counts()},
            "shares": self.observed_shares(),
            "latency": {wf: self.request_latency(wf)
                        for wf in sorted(self._lat_n)},
            "metrics": self.metrics.snapshot(),
            "exposition": self.metrics.expose(),
        }

    def to_chrome_trace(self) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON: one pid per workflow,
        one tid per sampled request; phases and calls are complete
        ("ph": "X") events, preemptions instant ("ph": "i") events.
        Load the dict (written as JSON) in https://ui.perfetto.dev."""
        return chrome_trace(self.traces(finished_only=False))


def chrome_trace(traces: List[dict]) -> dict:
    """Convert trace dicts (:meth:`Tracer.traces` / an export dump's
    ``traces`` list) into Chrome trace_event JSON — also reachable
    offline via ``tools/scepsy_report.py --perfetto``."""
    events: List[dict] = []
    pids: Dict[str, int] = {}
    us = 1e6
    for tr in traces:
        pid = pids.setdefault(tr["workflow"], len(pids) + 1)
        tid = tr["rid"] + 1
        if not pids.get(("named", pid)):
            events.append({"name": "process_name", "ph": "M",
                           "pid": pid, "tid": 0,
                           "args": {"name": tr["workflow"]}})
            pids[("named", pid)] = 1
        end = tr["done"] if tr["done"] >= 0 else tr["arrival"]
        events.append({
            "name": f"request {tr['rid']}", "cat": "request",
            "ph": "X", "pid": pid, "tid": tid,
            "ts": tr["arrival"] * us,
            "dur": max(end - tr["arrival"], 0.0) * us,
            "args": {"outcome": tr["outcome"],
                     "slo_class": tr["slo_class"]}})
        for ph in tr["phases"]:
            name = ph["kind"]
            if ph["kind"] == GROUP and ph.get("critical_llm"):
                name = f"group[{ph['critical_llm']}]"
            events.append({
                "name": name, "cat": "phase", "ph": "X",
                "pid": pid, "tid": tid, "ts": ph["t0"] * us,
                "dur": max(ph["t1"] - ph["t0"], 0.0) * us,
                "args": {k: v for k, v in ph.items()
                         if k not in ("t0", "t1")}})
        for call in tr["calls"]:
            if call["done"] < 0:
                continue
            events.append({
                "name": f"call {call['llm']}", "cat": "call",
                "ph": "X", "pid": pid, "tid": tid,
                "ts": call["submit"] * us,
                "dur": max(call["done"] - call["submit"], 0.0) * us,
                "args": {"queued_s": call["queued_s"],
                         "service_s": call["service_s"],
                         "prefill_s": call["prefill_s"],
                         "preemptions": call["preemptions"]}})
        for ev in tr["events"]:
            events.append({"name": ev["type"], "cat": "event",
                           "ph": "i", "s": "t", "pid": pid,
                           "tid": tid, "ts": ev["t"] * us})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def install_tracer(tracer: Optional[Tracer], *, drivers=(), routers=(),
                   admission=None, replan=None) -> Optional[Tracer]:
    """Wire one tracer through a deployed stack.

    ``drivers`` are ClusterDrivers (their router dicts — including
    pooled tenant views — and every reachable engine replica are walked
    automatically); extra ``routers`` cover replicas no driver routes
    to.  ``admission`` is an AdmissionController, ``replan`` a
    ReplanController.  A ``None`` or disabled tracer installs nothing:
    every component keeps its ``tracer is None`` fast path, so the run
    is indistinguishable from an un-instrumented one.
    """
    if tracer is None or not tracer.enabled:
        return tracer
    router_objs = {}
    for drv in drivers:
        drv.tracer = tracer
        for r in getattr(drv, "routers", {}).values():
            router_objs[id(r)] = r
    for r in routers:
        router_objs[id(r)] = r
    for r in router_objs.values():
        if hasattr(r, "submit"):
            r.tracer = tracer
        for eng in getattr(r, "replicas", ()):
            eng.tracer = tracer
            # eager registration: engines with few iterations would
            # otherwise be invisible to stride-sampled hooks
            if id(eng) not in tracer._eng:
                tracer._register_engine(eng)
    if admission is not None:
        admission.tracer = tracer
    if replan is not None:
        replan.tracer = tracer
    return tracer
