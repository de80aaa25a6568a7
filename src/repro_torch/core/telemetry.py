"""O(1)-memory telemetry for million-request runs.

Three pieces (see ``docs/scale.md``):

* :class:`GKQuantile` — a Greenwald–Khanna streaming quantile sketch:
  ``query(q)`` returns a value whose rank in the stream is within
  ``eps * n`` of ``q * n``, holding O((1/eps) log(eps n)) tuples
  instead of the stream.  The hard rank-error bound (unlike p²'s
  heuristic estimate) is what the hypothesis property test checks.
* :class:`StatsSink` — the driver-facing aggregate: per-workflow
  counters, an in-flight gauge with a high-water mark, latency
  sketches, and a bounded ring of recent samples.  It replaces the
  unbounded ``ClusterDriver.records`` list when a driver is built with
  ``sink=``; exact-record mode stays the default for tests/benches.
* :class:`BatchedTelemetry` — wraps a telemetry consumer (e.g. a
  :class:`repro_torch.core.drift.DriftMonitor`) and replays buffered events
  once per flush interval of *simulated* time rather than per call.
  Events are replayed in arrival order and every ``poll`` flushes
  first, so poll-time results are identical to unbatched ingestion.
"""
from __future__ import annotations

import math
from bisect import insort
from collections import deque
from typing import Deque, Dict, List, Tuple


class GKQuantile:
    """Greenwald–Khanna ε-approximate streaming quantiles.

    Invariant: for every tracked tuple ``(v, g, Δ)``, the rank of ``v``
    lies in ``[rmin, rmin + Δ]`` where ``rmin`` is the running sum of
    ``g``; compression merges neighbours while ``g_i + g_{i+1} + Δ_{i+1}
    <= 2 ε n``, which caps both memory and the answer's rank error at
    ``ε n``.
    """

    def __init__(self, eps: float = 0.005):
        if not 0 < eps < 0.5:
            raise ValueError(f"eps must be in (0, 0.5), got {eps}")
        self.eps = eps
        self.n = 0
        # sorted by value; each entry is (v, g, delta)
        self._entries: List[Tuple[float, int, int]] = []
        self._compress_every = max(int(1.0 / (2.0 * eps)), 1)
        self._since_compress = 0

    def add(self, v: float) -> None:
        self.n += 1
        entries = self._entries
        if not entries:
            entries.append((v, 1, 0))
            return
        # min/max observations must be exact (delta = 0 at the ends)
        if v < entries[0][0]:
            entries.insert(0, (v, 1, 0))
        elif v >= entries[-1][0]:
            entries.append((v, 1, 0))
        else:
            delta = max(int(2 * self.eps * self.n) - 1, 0)
            insort(entries, (v, 1, delta))
        self._since_compress += 1
        if self._since_compress >= self._compress_every:
            self._since_compress = 0
            self._compress()

    def _compress(self) -> None:
        entries = self._entries
        if len(entries) < 3:
            return
        cap = int(2 * self.eps * self.n)
        out = [entries[0]]
        for v, g, d in entries[1:-1]:
            pv, pg, pd = out[-1]
            # merge the previous tuple into this one when safe (never
            # the first entry: the stream minimum stays exact)
            if len(out) > 1 and pg + g + d <= cap:
                out[-1] = (v, pg + g, d)
            else:
                out.append((v, g, d))
        out.append(entries[-1])
        self._entries = out

    def query(self, q: float) -> float:
        """A value whose stream rank is within ``eps*n`` of ``q*n``."""
        if not self._entries:
            return math.nan
        q = min(max(q, 0.0), 1.0)
        target = q * self.n
        margin = self.eps * self.n
        cum = 0
        prev_v = self._entries[0][0]
        for v, g, d in self._entries:
            if cum + g + d > target + margin:
                return prev_v
            cum += g
            prev_v = v
        return self._entries[-1][0]

    def __len__(self) -> int:
        """Tuples held (the memory footprint), not stream length."""
        return len(self._entries)


class _WorkflowStats:
    __slots__ = ("arrived", "completed", "rejected", "degraded", "slo_met",
                 "inflight", "peak_inflight", "lat_sum", "lat_min",
                 "lat_max", "sketch", "recent")

    def __init__(self, eps: float, ring: int):
        self.arrived = 0
        self.completed = 0
        self.rejected = 0
        self.degraded = 0
        self.slo_met = 0
        self.inflight = 0
        self.peak_inflight = 0
        self.lat_sum = 0.0
        self.lat_min = math.inf
        self.lat_max = 0.0
        self.sketch = GKQuantile(eps)
        self.recent: Deque[Tuple[float, float]] = deque(maxlen=ring)


class StatsSink:
    """Aggregate request telemetry with O(in-flight) memory.

    The driver calls ``observe_arrival`` / ``observe_reject`` /
    ``observe_degrade`` / ``observe`` (completion); readers use
    ``latency_quantile``, ``peak_inflight`` and ``summary()``.
    """

    def __init__(self, *, eps: float = 0.005, ring: int = 1024):
        self.eps = eps
        self.ring = ring
        self.stats: Dict[str, _WorkflowStats] = {}
        self.inflight = 0
        self.peak_inflight = 0

    def _wf(self, name: str) -> _WorkflowStats:
        s = self.stats.get(name)
        if s is None:
            s = self.stats[name] = _WorkflowStats(self.eps, self.ring)
        return s

    def observe_arrival(self, name: str, t: float) -> None:
        s = self._wf(name)
        s.arrived += 1
        s.inflight += 1
        if s.inflight > s.peak_inflight:
            s.peak_inflight = s.inflight
        self.inflight += 1
        if self.inflight > self.peak_inflight:
            self.peak_inflight = self.inflight

    def observe_reject(self, name: str) -> None:
        s = self._wf(name)
        s.rejected += 1
        s.inflight -= 1
        self.inflight -= 1

    def observe_degrade(self, name: str) -> None:
        self._wf(name).degraded += 1

    def observe(self, name: str, rec) -> None:
        """A completed workflow request (rec: RequestRecord-like)."""
        s = self._wf(name)
        s.completed += 1
        s.inflight -= 1
        self.inflight -= 1
        if getattr(rec, "slo_met", True):
            s.slo_met += 1
        lat = rec.done - rec.arrival
        s.lat_sum += lat
        if lat < s.lat_min:
            s.lat_min = lat
        if lat > s.lat_max:
            s.lat_max = lat
        s.sketch.add(lat)
        s.recent.append((rec.done, lat))

    # -- readers -----------------------------------------------------------

    def latency_quantile(self, name: str, q: float) -> float:
        s = self.stats.get(name)
        return s.sketch.query(q) if s else math.nan

    def summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name, s in self.stats.items():
            out[name] = {
                "arrived": s.arrived,
                "completed": s.completed,
                "rejected": s.rejected,
                "degraded": s.degraded,
                "slo_met": s.slo_met,
                "peak_inflight": s.peak_inflight,
                "latency_mean": (s.lat_sum / s.completed
                                 if s.completed else math.nan),
                "latency_min": s.lat_min if s.completed else math.nan,
                "latency_max": s.lat_max if s.completed else math.nan,
                "latency_p50": (s.sketch.query(0.50)
                                if s.completed else math.nan),
                "latency_p99": (s.sketch.query(0.99)
                                if s.completed else math.nan),
            }
        return out


class BatchedTelemetry:
    """Buffer driver telemetry and replay it into ``monitor`` once per
    ``flush_s`` of simulated time (``loop.now``), in arrival order.

    The driver's per-call overhead drops to one list append; because
    :meth:`poll` flushes first, anything the monitor computes at poll
    time (drift detection, rate estimates) sees exactly the events an
    unbatched monitor would have seen.
    """

    def __init__(self, monitor, loop, *, flush_s: float = 1.0):
        self.monitor = monitor
        self.loop = loop
        self.flush_s = flush_s
        self._buf: List[Tuple[str, tuple]] = []
        self._next_flush = flush_s
        self.flushes = 0

    # -- telemetry protocol (duck-typed, same as DriftMonitor) -------------

    def record_arrival(self, name: str, t: float) -> None:
        self._record("record_arrival", (name, t))

    def record_call(self, name: str, llm: str, req) -> None:
        self._record("record_call", (name, llm, req))

    def record_request_done(self, name: str, rec) -> None:
        self._record("record_request_done", (name, rec))

    def record_shed(self, name: str, slo: str, action: str, t: float) -> None:
        if hasattr(self.monitor, "record_shed"):
            self._record("record_shed", (name, slo, action, t))

    def _record(self, kind: str, args: tuple) -> None:
        self._buf.append((kind, args))
        if self.loop.now >= self._next_flush:
            self.flush()

    def flush(self) -> None:
        if self._buf:
            mon = self.monitor
            for kind, args in self._buf:
                getattr(mon, kind)(*args)
            self._buf.clear()
            self.flushes += 1
        self._next_flush = self.loop.now + self.flush_s

    # -- pass-through ------------------------------------------------------

    def poll(self, *args, **kwargs):
        self.flush()
        return self.monitor.poll(*args, **kwargs)

    def __getattr__(self, item):
        return getattr(self.monitor, item)
