"""Discrete-event loop for the cluster simulator — million-event scale.

Two interchangeable engines behind one API (``EventLoop(kind=...)``):

``calendar`` (default)
    A calendar queue (Brown 1988): a wheel of time buckets of width
    ``w`` covering one revolution ``[day, day + nbuckets)`` of bucket
    numbers (``bucket_no = floor(t / w)``), plus a binary-heap
    *overflow* for events beyond the revolution horizon.  Scheduling an
    event inside the horizon is an O(1) list append; popping sorts one
    bucket at a time (amortized O(1) per event for stable event
    densities).  As the wheel advances into new bucket numbers, due
    overflow events are drained into the wheel, so far-future events
    (e.g. a drain horizon or a calibration callback hours ahead) never
    slow the hot path.  The wheel *resizes itself*: the width tracks an
    EWMA of observed inter-event gaps and the bucket count tracks the
    pending-event population, with an O(n) rebuild whenever either is
    off by ~4x — n is the *pending* count, which lazy arrival sources
    keep O(in-flight), so rebuilds are cheap and rare.

``heap``
    The legacy binary heap (`heapq` over ``(t, seq, fn, args)``), kept
    for parity tests and as the measured baseline in
    ``benchmarks/bench_scale.py``.

Both engines pop events in exactly ``(t, seq)`` order, where ``seq`` is
the global schedule counter — so same-timestamp events run in FIFO
schedule order and the two engines produce *identical* execution traces
(gated by ``tests/test_event_core.py``).

Events are closure-free: ``schedule(t, fn, *args)`` stores the callable
and its argument tuple directly (one small tuple per event, no lambda
allocation); plain ``schedule(t, fn)`` still accepts any thunk, so
legacy call sites keep working.
"""
from __future__ import annotations

import heapq
import math
from typing import Callable, List, Optional, Tuple

_Event = Tuple[float, int, Callable, tuple]

# wheel sizing defaults (see docs/scale.md for the model behind them)
_MIN_BUCKETS = 256
_MAX_BUCKETS = 1 << 16
_TARGET_PER_BUCKET = 2.0  # aim for ~2 pending events per bucket
_RESIZE_FACTOR = 4.0      # rebuild when width/count are off by >= 4x
_RESIZE_CHECK = 4096      # pops between resize checks
_GAP_ALPHA = 0.01         # EWMA weight for the inter-event gap estimate


class EventLoop:
    """Simulation clock + pending-event queue.

    ``schedule(t, fn, *args)`` enqueues ``fn(*args)`` at simulated time
    ``max(t, now)``; ``run(until)`` pops events in ``(t, seq)`` order.
    ``kind`` selects the engine: ``"calendar"`` (default) or ``"heap"``
    (the legacy binary heap, kept for parity tests / baselines).

    Counters: ``events_processed`` (total pops), ``pending`` (events
    queued now), ``peak_pending`` (high-water mark — the memory gate in
    ``bench_scale`` asserts this stays O(in-flight), not O(total)).
    """

    def __init__(self, kind: str = "calendar", *,
                 bucket_width: Optional[float] = None,
                 nbuckets: int = _MIN_BUCKETS):
        if kind not in ("calendar", "heap"):
            raise ValueError(f"unknown EventLoop kind {kind!r}")
        self.kind = kind
        self.now = 0.0
        self._seq = 0
        self.events_processed = 0
        self.pending = 0
        self.peak_pending = 0
        # heap engine state
        self._heap: List[_Event] = []
        # calendar engine state
        self._width = bucket_width if bucket_width else 1e-3
        self._width_fixed = bucket_width is not None
        self._nbuckets = max(int(nbuckets), 1)
        self._buckets: List[List[_Event]] = [[] for _ in range(self._nbuckets)]
        self._day = 0               # bucket_no currently being consumed
        self._active: List[_Event] = []  # current bucket, heapified
        self._overflow: List[_Event] = []  # beyond-horizon events
        self._wheel_count = 0       # events in buckets + active
        self._gap_est: Optional[float] = None
        self._last_t = 0.0
        self._since_check = 0

    # -- public API --------------------------------------------------------

    def schedule(self, t: float, fn: Callable, *args) -> None:
        """Enqueue ``fn(*args)`` at time ``max(t, now)``."""
        t = t if t > self.now else self.now
        seq = self._seq
        self._seq = seq + 1
        self.pending += 1
        if self.pending > self.peak_pending:
            self.peak_pending = self.pending
        ev = (t, seq, fn, args)
        if self.kind == "heap":
            heapq.heappush(self._heap, ev)
            return
        b_no = int(t / self._width)
        if b_no < self._day:          # float-boundary guard
            b_no = self._day
        if b_no == self._day:
            heapq.heappush(self._active, ev)
            self._wheel_count += 1
        elif b_no < self._day + self._nbuckets:
            self._buckets[b_no % self._nbuckets].append(ev)
            self._wheel_count += 1
        else:
            heapq.heappush(self._overflow, ev)

    def run(self, until: float = math.inf) -> None:
        """Execute pending events with ``t <= until`` in (t, seq) order."""
        if self.kind == "heap":
            heap = self._heap
            while heap and heap[0][0] <= until:
                t, _, fn, args = heapq.heappop(heap)
                self.pending -= 1
                self.events_processed += 1
                self.now = t
                fn(*args)
            return
        while True:
            ev = self._peek()
            if ev is None or ev[0] > until:
                return
            heapq.heappop(self._active)
            self._wheel_count -= 1
            self.pending -= 1
            self.events_processed += 1
            t, _, fn, args = ev
            # update the gap estimate driving adaptive bucket width
            gap = t - self._last_t
            if gap > 0.0:
                g = self._gap_est
                self._gap_est = gap if g is None else g + _GAP_ALPHA * (gap - g)
            self._last_t = t
            self._since_check += 1
            if self._since_check >= _RESIZE_CHECK:
                self._since_check = 0
                self._maybe_resize()
            self.now = t
            fn(*args)

    def empty(self) -> bool:
        return self.pending == 0

    def peek_time(self) -> Optional[float]:
        """Timestamp of the next pending event, or None when empty."""
        if self.kind == "heap":
            return self._heap[0][0] if self._heap else None
        ev = self._peek()
        return ev[0] if ev is not None else None

    # -- calendar internals ------------------------------------------------

    def _peek(self) -> Optional[_Event]:
        """Earliest pending event (left in place), or None."""
        while True:
            if self._active:
                return self._active[0]
            if self._wheel_count == 0:
                if not self._overflow:
                    return None
                # wheel empty: jump straight to the next overflow event
                self._day = int(self._overflow[0][0] / self._width)
            else:
                self._day += 1
            self._admit_overflow()
            slot = self._buckets[self._day % self._nbuckets]
            if slot:
                self._buckets[self._day % self._nbuckets] = []
                heapq.heapify(slot)
                self._active = slot

    def _admit_overflow(self) -> None:
        """Move overflow events that now fall inside the wheel horizon
        into their buckets (they stay heap-ordered until consumed)."""
        horizon_t = (self._day + self._nbuckets) * self._width
        ovf = self._overflow
        while ovf and ovf[0][0] < horizon_t:
            ev = heapq.heappop(ovf)
            b_no = int(ev[0] / self._width)
            if b_no < self._day:
                b_no = self._day
            if b_no == self._day and self._active:
                heapq.heappush(self._active, ev)
            else:
                self._buckets[b_no % self._nbuckets].append(ev)
            self._wheel_count += 1

    def _maybe_resize(self) -> None:
        """Rebuild the wheel when the width has drifted >= 4x from the
        observed inter-event gap or the bucket count is badly sized for
        the pending population.  O(pending), amortized over
        ``_RESIZE_CHECK`` pops."""
        target_w = self._width
        if not self._width_fixed and self._gap_est is not None:
            target_w = max(self._gap_est * _TARGET_PER_BUCKET, 1e-12)
        target_n = min(max(_MIN_BUCKETS, 1 << max(self.pending, 1).bit_length()),
                       _MAX_BUCKETS)
        width_off = (max(target_w, self._width) / max(min(target_w, self._width), 1e-300)
                     >= _RESIZE_FACTOR)
        count_off = (max(target_n, self._nbuckets)
                     >= _RESIZE_FACTOR * min(target_n, self._nbuckets))
        if not (width_off or count_off):
            return
        events: List[_Event] = list(self._active) + list(self._overflow)
        for slot in self._buckets:
            events.extend(slot)
        self._width = target_w
        self._nbuckets = target_n
        self._buckets = [[] for _ in range(self._nbuckets)]
        self._active = []
        self._overflow = []
        self._wheel_count = 0
        self._day = int(self.now / self._width)
        for t, seq, fn, args in events:
            b_no = int(t / self._width)
            if b_no < self._day:
                b_no = self._day
            if b_no < self._day + self._nbuckets:
                self._buckets[b_no % self._nbuckets].append((t, seq, fn, args))
                self._wheel_count += 1
            else:
                heapq.heappush(self._overflow, (t, seq, fn, args))
        # re-enter the current bucket so _peek resumes correctly
        slot = self._buckets[self._day % self._nbuckets]
        if slot:
            self._buckets[self._day % self._nbuckets] = []
            heapq.heapify(slot)
            self._active = slot
