"""Discrete-event simulation of LLM serving engines on a (fractional) TPU
cluster.

The container is CPU-only, so Scepsy's per-LLM profiling (paper §4 step 3)
replays traced requests through this simulator instead of a live vLLM
deployment; per-iteration costs come from the analytical roofline cost
model (`repro_torch.serving.costmodel`) — the same model the §Roofline report
uses, so predictions and the roofline are consistent.

Fidelity notes (what is modeled):
  * continuous batching at iteration granularity with chunked prefill
    (Sarathi-style): each engine iteration admits waiting prefills up to a
    token budget and decodes the running batch; decode advances in quanta
    of ``decode_quantum`` tokens between scheduling points;
  * KV-capacity admission control (max concurrent sequences from HBM
    budget), queueing, and per-request latency accounting;
  * prefix caching: requests carry their prompt's *segment sequence*
    (``EngineRequest.prefix``, see :mod:`repro_torch.serving.radix`) and each
    replica tracks resident KV in a token-budgeted radix cache — the
    cached-prefix discount is the *measured* shared-prefix length, and
    evicted KV stops producing hits.  Requests without segments fall
    back to the legacy parent-id heuristic (85% of the prompt), bounded
    by the same KV budget via an LRU over completed requests;
  * QoS preemption (opt-in): at an iteration boundary, a waiting request
    of a strictly higher SLO weight may preempt a running lower-weight
    decode when the batch is full; the victim requeues with its decoded
    progress retained and its KV re-registered in the radix cache (so it
    is "retained" exactly while the budget keeps it resident);
  * fractional chip shares scale compute/bandwidth linearly (static
    MPS-like partitioning); TP scales per the cost model incl. collectives;
  * model swapping (for the Aegaeon-like baseline) pays the weight reload.
"""
from __future__ import annotations

import heapq
import math
from collections import OrderedDict
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Hashable, List, Optional, Set, Tuple

from repro_torch import hw
from repro_torch.configs.base import ArchConfig
from repro_torch.serving import costmodel as cm
from repro_torch.serving.eventloop import EventLoop
from repro_torch.serving.radix import RadixCache, Segment

__all__ = ["EventLoop", "EngineRequest", "EngineSim", "Router",
           "ReplicaSpec", "build_llm_service", "output_segment"]


def output_segment(req_id: int, tokens: int) -> Segment:
    """The synthetic segment id for a request's generated output — the
    driver and the engine must agree on it so a child call's prompt
    segments match what the engine registered at the parent's finish."""
    return (("o", req_id), tokens)


@dataclass
class EngineRequest:
    req_id: int
    prompt_tokens: int
    output_tokens: int
    arrival: float
    on_complete: Optional[Callable[["EngineRequest"], None]] = None
    parent_id: Optional[int] = None  # legacy prefix-caching heuristic
    workflow_request: Optional[int] = None
    qos: Optional[object] = None  # repro_torch.qos.slo.RequestQoS, duck-typed
    # token-accurate prefix model: the prompt as (segment id, length)
    # pairs (None = legacy heuristic path)
    prefix: Optional[Tuple[Segment, ...]] = None
    # driver-computed ground-truth shared-prefix tokens (bench gate)
    true_prefix: int = 0
    # filled by the engine:
    cached_prefix: int = 0
    t_start_service: float = -1.0
    t_first_token: float = -1.0
    t_done: float = -1.0
    remaining: int = 0
    progress: int = 0       # tokens already decoded (kept across preemption)
    preemptions: int = 0
    pinned_seq: Optional[Tuple[Segment, ...]] = None

    @property
    def latency(self) -> float:
        return self.t_done - self.arrival


def _qos_weight(req) -> float:
    """Effective preemption weight: best-effort (no QoS, degraded, or no
    deadline) sits at the BEST_EFFORT weight."""
    q = getattr(req, "qos", None)
    if q is None or q.degraded or not math.isfinite(q.deadline):
        return 0.5
    return q.weight


def _can_preempt(req) -> bool:
    """Only deadline-carrying, non-degraded requests may preempt."""
    q = getattr(req, "qos", None)
    return (q is not None and not q.degraded
            and math.isfinite(q.deadline))


class EngineSim:
    """One serving-engine replica (one LLM, one TP group, one fraction).

    ``policy`` (a :class:`repro_torch.qos.policy.QueueDiscipline`, duck-typed)
    reorders admission out of the waiting queue: it is asked which
    waiting request to admit next and charged the admitted request's
    token cost.  ``policy=None`` is the built-in FIFO fast path.

    ``preemption=True`` additionally lets the head-of-queue request (per
    the discipline) preempt a strictly-lower-weight running decode when
    the batch is full; every event is logged in ``preempt_log`` as
    ``(preemptor_weight, victim_weight, time)``.
    """

    def __init__(self, cfg: ArchConfig, loop: EventLoop, *, tp: int = 1,
                 fraction: float = 1.0, name: str = "",
                 prefix_caching: bool = True, avg_context: int = 1024,
                 prefill_chunk: int = 2048, decode_quantum: int = 8,
                 max_batch_override: Optional[int] = None,
                 policy: Optional[object] = None,
                 preemption: bool = False,
                 kv_capacity_override: Optional[int] = None,
                 keep_done: bool = True,
                 chip: Optional[hw.ChipClass] = None):
        self.cfg = cfg
        self.policy = policy
        self.loop = loop
        self.tp = tp
        self.fraction = fraction
        self.chip = chip or hw.DEFAULT_CHIP_CLASS
        self.name = name or cfg.name
        self.prefix_caching = prefix_caching
        self.preemption = preemption
        self.prefill_chunk = prefill_chunk
        self.decode_quantum = decode_quantum
        mb = cm.max_batch_size(cfg, avg_context, tp=tp, fraction=fraction,
                               chip=self.chip)
        self.max_batch = max_batch_override or max(min(mb, 256), 1)
        # modeled KV residency budget in tokens: the replica's HBM share
        # minus weights, divided by per-token KV bytes
        if kv_capacity_override is not None:
            self.kv_capacity_tokens = int(kv_capacity_override)
        else:
            budget = (tp * fraction * self.chip.hbm_bytes * 0.9
                      - cm.model_bytes(cfg))
            per_tok = max(cm.kv_bytes_per_seq(cfg, 1), 1.0)
            self.kv_capacity_tokens = max(int(budget / per_tok), 1)
        self.radix = RadixCache(self.kv_capacity_tokens)
        self.waiting: List[EngineRequest] = []
        self.running: List[EngineRequest] = []
        # completed requests: ``keep_done=False`` keeps only the counter
        # (million-request runs must not retain one object per request)
        self.keep_done = keep_done
        self.done: List[EngineRequest] = []
        self.n_done = 0
        # incremental queue-load (see ``load``); listeners are notified
        # once per state-changing event so routers can index replicas
        # without O(queue) scans
        self._load = 0
        self._load_notified = 0
        self._load_listeners: List[Callable[[int], None]] = []
        self.busy = False
        self.busy_time = 0.0
        self.prefill_tokens = 0  # prompt tokens actually computed
        self.cached_tokens = 0   # prompt tokens served from cached KV
        self.preempt_log: List[Tuple[float, float, float]] = []
        # legacy parent-id prefix path: completed request ids with live
        # KV, LRU-bounded by the same token budget (token cost = prompt
        # + output per entry)
        self._served: "OrderedDict[int, int]" = OrderedDict()
        self._served_tokens = 0
        self.current_model: Optional[str] = cfg.name  # for swap modeling
        self.swap_overhead_pending = 0.0
        self.failed = False
        # observability hook (repro_torch.obs.spans.Tracer); None = untraced
        self.tracer = None
        self._obs_tick = 0  # iteration counter for stride-sampled hooks

    # -- queue introspection (router) --
    @property
    def load(self) -> int:
        """Outstanding token work, maintained incrementally (O(1)):
        waiting requests count ``remaining + prompt``, running requests
        count ``remaining`` (see :meth:`recompute_load`)."""
        return self._load

    def recompute_load(self) -> int:
        """O(queue) recomputation of :attr:`load` (test invariant)."""
        return (sum(r.remaining + r.prompt_tokens for r in self.waiting)
                + sum(r.remaining for r in self.running))

    def add_load_listener(self, cb: Callable[[int], None]) -> None:
        self._load_listeners.append(cb)

    def _notify_load(self) -> None:
        if self._load_listeners and self._load != self._load_notified:
            self._load_notified = self._load
            for cb in self._load_listeners:
                cb(self._load)

    def has_parent(self, parent_id: Optional[int]) -> bool:
        if parent_id is None or parent_id not in self._served:
            return False
        self._served.move_to_end(parent_id)  # LRU touch
        return True

    def prefix_lookup(self, req: EngineRequest) -> int:
        """Live cached-prefix tokens this replica would grant ``req``
        (router probe; does not touch LRU state)."""
        if self.failed or not self.prefix_caching:
            return 0
        if req.prefix is not None:
            return min(self.radix.match(req.prefix, touch=False),
                       max(req.prompt_tokens - 1, 0))
        if req.parent_id is not None and req.parent_id in self._served:
            return min(int(req.prompt_tokens * 0.85),
                       req.prompt_tokens - 1)
        return 0

    # -- submission --
    def submit(self, req: EngineRequest) -> None:
        # estimate the discount now (queue disciplines cost by it); the
        # engine re-measures against live KV at admission
        req.cached_prefix = self._measure_prefix(req) \
            if self.prefix_caching else 0
        req.remaining = req.output_tokens - req.progress
        self.waiting.append(req)
        self._load += req.remaining + req.prompt_tokens
        self._notify_load()
        if not self.busy:
            self.busy = True
            self.loop.schedule(self.loop.now, self._iterate)

    def request_swap(self, seconds: float) -> None:
        self.swap_overhead_pending += seconds

    def fail(self, resubmit: Optional[Callable[[EngineRequest], None]] = None
             ) -> List[EngineRequest]:
        """Chip/host failure: drop this replica; in-flight work is lost
        (KV gone) and re-dispatched via ``resubmit`` (router failover)."""
        self.failed = True
        orphans = self.waiting + self.running
        self.waiting, self.running = [], []
        self._load = 0
        self._notify_load()
        self._served.clear()
        self._served_tokens = 0
        self.radix.clear()
        for r in orphans:
            r.cached_prefix = 0  # KV lost; full prefill elsewhere
            r.progress = 0
            r.remaining = r.output_tokens
            r.pinned_seq = None
            if resubmit is not None:
                resubmit(r)
        return orphans

    # -- prefix bookkeeping --
    def _eff_seq(self, req: EngineRequest) -> Optional[Tuple[Segment, ...]]:
        """The request's resident-KV sequence: prompt segments plus any
        decoded progress retained across a preemption."""
        if req.prefix is None:
            return None
        if req.progress > 0:
            return req.prefix + (output_segment(req.req_id, req.progress),)
        return req.prefix

    def _measure_prefix(self, req: EngineRequest) -> int:
        eff_prompt = req.prompt_tokens + req.progress
        seq = self._eff_seq(req)
        if seq is not None:
            return min(self.radix.match(seq, touch=False), eff_prompt - 1)
        if self.has_parent(req.parent_id):
            return min(int(req.prompt_tokens * 0.85), req.prompt_tokens - 1)
        return 0

    def _on_admitted(self, req: EngineRequest) -> None:
        seq = self._eff_seq(req)
        if seq is not None and self.prefix_caching:
            self.radix.insert(seq)
            self.radix.pin(seq)
            req.pinned_seq = seq

    def _on_finished(self, req: EngineRequest) -> None:
        if req.pinned_seq is not None:
            self.radix.unpin(req.pinned_seq)
            req.pinned_seq = None
        if req.prefix is not None and self.prefix_caching:
            self.radix.insert(
                req.prefix + (output_segment(req.req_id, req.output_tokens),))
        # legacy LRU registry, bounded by the same modeled KV budget
        self._served[req.req_id] = req.prompt_tokens + req.output_tokens
        self._served_tokens += self._served[req.req_id]
        while self._served_tokens > self.kv_capacity_tokens \
                and len(self._served) > 1:
            _, cost = self._served.popitem(last=False)
            self._served_tokens -= cost

    def _preempt_one(self, t0: float) -> bool:
        """Let the discipline's head-of-queue request bump the weakest
        strictly-lower-weight running request out of a full batch."""
        idx = self.policy.select(self.waiting, t0) if self.policy else 0
        cand = self.waiting[idx]
        if not _can_preempt(cand):
            return False
        cw = _qos_weight(cand)
        victims = [r for r in self.running if _qos_weight(r) < cw]
        if not victims:
            return False
        victim = min(victims, key=lambda r: (_qos_weight(r), -r.arrival))
        self.running.remove(victim)
        victim.preemptions += 1
        victim.progress = victim.output_tokens - victim.remaining
        if victim.pinned_seq is not None:
            self.radix.unpin(victim.pinned_seq)
            victim.pinned_seq = None
        seq = self._eff_seq(victim)
        if seq is not None and self.prefix_caching:
            # decoded-so-far KV stays resident while the budget allows —
            # re-admission re-measures, so "retained vs dropped" is
            # decided by eviction pressure, not a flag
            self.radix.insert(seq)
        victim.cached_prefix = self._measure_prefix(victim) \
            if self.prefix_caching else 0
        self.waiting.append(victim)
        self._load += victim.prompt_tokens  # waiting counts the prompt again
        self.preempt_log.append((cw, _qos_weight(victim), t0))
        if self.tracer is not None:
            self.tracer.on_engine_preempt(self, victim, t0)
        return True

    # -- engine loop --
    def _iterate(self) -> None:
        if self.failed or (not self.waiting and not self.running):
            self.busy = False
            return
        t0 = self.loop.now
        duration = 0.0
        if self.swap_overhead_pending > 0:
            duration += self.swap_overhead_pending
            self.swap_overhead_pending = 0.0

        # 0) QoS preemption: a high-weight arrival stuck behind a full
        #    batch bumps one weaker decode per iteration
        if (self.preemption and self.waiting
                and len(self.running) >= self.max_batch):
            self._preempt_one(t0)

        # 1) admit prefills within chunk budget and batch capacity; the
        #    queue discipline picks which waiting request goes next
        budget = self.prefill_chunk
        admitted: List[EngineRequest] = []
        while (self.waiting and len(self.running) + len(admitted) < self.max_batch
               and budget > 0):
            idx = self.policy.select(self.waiting, t0) if self.policy else 0
            req = self.waiting[idx]
            # re-measure against live KV (submit-time value is a queue-
            # ordering estimate; residency may have changed since)
            if self.prefix_caching:
                req.cached_prefix = self._measure_prefix(req)
            eff_prompt = req.prompt_tokens + req.progress
            new_tokens = eff_prompt - req.cached_prefix
            if new_tokens > budget and admitted:
                break
            self.waiting.pop(idx)
            self._load -= req.prompt_tokens  # running counts remaining only
            if self.policy:
                self.policy.on_admit(req, new_tokens + req.remaining)
            admitted.append(req)
            self._on_admitted(req)
            budget -= new_tokens
            self.prefill_tokens += new_tokens
            self.cached_tokens += req.cached_prefix
            cost = cm.prefill_cost(self.cfg, eff_prompt, tp=self.tp,
                                   fraction=self.fraction,
                                   cached_tokens=req.cached_prefix,
                                   chip=self.chip)
            duration += cost.total
            req.t_start_service = t0
            if self.tracer is not None:
                self.tracer.on_engine_admit(req, t0, new_tokens, cost.total)

        # 2) decode quantum for the (new) running batch
        batch = self.running + admitted
        self.running = batch  # committed now so fail() can re-dispatch
        if batch:
            q = min(self.decode_quantum, min(r.remaining for r in batch))
            q = max(q, 1)
            ctx = sum(r.prompt_tokens + (r.output_tokens - r.remaining)
                      for r in batch) / len(batch)
            step = cm.decode_step_cost(self.cfg, len(batch), int(ctx),
                                       tp=self.tp, fraction=self.fraction,
                                       chip=self.chip)
            duration += q * step.total
            for r in batch:
                r.remaining -= q
                if r.t_first_token < 0:
                    r.t_first_token = t0 + duration
            self._load -= q * len(batch)

        t1 = t0 + max(duration, 1e-6)
        self.busy_time += t1 - t0
        self._notify_load()
        tr = self.tracer
        if tr is not None:
            # stride-sampled (tracer.iter_mask is 2^k - 1): the hook and
            # its argument evaluation run for one iteration in 2^k
            n = self._obs_tick + 1
            self._obs_tick = n
            if not (n & tr.iter_mask):
                tr.on_engine_iteration(self, t0, t1 - t0, len(batch),
                                       len(self.waiting))
        self.loop.schedule(t1, self._finish_batch, batch, t1)

    def _finish_batch(self, batch: List[EngineRequest], t1: float) -> None:
        if self.failed:  # iteration died with the chip; work was
            return       # already re-dispatched by fail()
        still: List[EngineRequest] = []
        for r in batch:
            if r.remaining <= 0:
                r.t_done = t1
                self._load -= r.remaining
                self.n_done += 1
                if self.keep_done:
                    self.done.append(r)
                self._on_finished(r)
                if r.on_complete:
                    r.on_complete(r)
            else:
                still.append(r)
        self.running = still
        self._notify_load()
        self._iterate()


class _ReplicaIndex:
    """Incremental routing index over one replica list, shared by the
    base :class:`Router` and all of its tenant views.

    Two structures, both updated by callbacks (never rebuilt per call):

    * ``owners`` — head-segment id → indices of replicas whose radix
      cache holds KV for that segment.  Fed by the caches' head-listener
      hooks (:attr:`RadixCache.head_listeners`): a replica owns a head
      exactly while ``(seg, 0)`` is a root child, which is exactly when
      ``match()`` can return > 0 for a prompt starting with that
      segment — so probing only owners is *equivalent* to scanning all
      replicas (non-owners would report 0).
    * a lazy least-loaded min-heap of ``(load, idx)`` entries, pushed by
      the engines' load listeners on every load change.  Entries are
      validated on pop: an entry is fresh iff its recorded load equals
      the engine's current load — every live engine always has one
      fresh entry (each change pushes one), so after discarding stale
      heads the top is the true ``(min load, min idx)``, matching the
      legacy ``min()`` scan's lowest-index tie-break.

    The heap orders by *raw* load, so it serves unweighted routers only
    (weighted tenant views fall back to the O(R) scan — R is small in
    pooled deployments and effective load is per-view).
    """

    def __init__(self, replicas: List["EngineSim"]):
        self.replicas = replicas
        self.owners: Dict[Hashable, Set[int]] = {}
        self._heap: List[Tuple[float, int]] = []
        self._max_heap = max(64, 16 * len(replicas))
        for i, eng in enumerate(replicas):
            radix = getattr(eng, "radix", None)
            if radix is not None:
                radix.head_listeners.append(partial(self._head_event, i))
                for seg, _start in radix.root.children:
                    self.owners.setdefault(seg, set()).add(i)
            if hasattr(eng, "add_load_listener"):
                eng.add_load_listener(partial(self._load_event, i))
            self._heap.append((eng.load, i))
        heapq.heapify(self._heap)

    # radix head callback: op is "add" | "del" | "reset"
    def _head_event(self, idx: int, op: str, seg: Hashable) -> None:
        if op == "add":
            self.owners.setdefault(seg, set()).add(idx)
        elif op == "del":
            s = self.owners.get(seg)
            if s is not None:
                s.discard(idx)
                if not s:
                    del self.owners[seg]
        else:  # reset (cache cleared / replica failed)
            dead = [k for k, s in self.owners.items() if idx in s]
            for k in dead:
                s = self.owners[k]
                s.discard(idx)
                if not s:
                    del self.owners[k]

    def _load_event(self, idx: int, load: float) -> None:
        heapq.heappush(self._heap, (load, idx))
        if len(self._heap) > self._max_heap:
            self._compact()

    def _compact(self) -> None:
        self._heap = [(r.load, i) for i, r in enumerate(self.replicas)
                      if not getattr(r, "failed", False)]
        heapq.heapify(self._heap)

    def least_loaded(self) -> Optional[int]:
        """Live replica with minimal load (ties → lowest index)."""
        for _attempt in range(2):
            heap = self._heap
            while heap:
                load, idx = heap[0]
                eng = self.replicas[idx]
                if getattr(eng, "failed", False) or eng.load != load:
                    heapq.heappop(heap)  # stale
                    continue
                return idx
            self._compact()  # all entries consumed: rebuild once
        return None


class Router:
    """Prefix-affinity + least-loaded routing across one LLM's replicas.

    Target selection, in order:

    1. **longest live prefix** — the replica whose radix cache (or
       legacy parent registry) holds the longest cached prefix of the
       request's prompt;
    2. **sticky** (pooled tenant views, i.e. ``weights`` set) — the
       replica this workflow instance last used, while it is alive and
       positively weighted, so one instance's calls keep landing where
       its KV lives even before the first parent completes;
    3. **weighted least-loaded** — effective load is load/weight and
       zero-weight replicas are never chosen.

    Several routers may *share* one replica list (one per tenant
    workflow — see :meth:`view`); queue state then reflects
    cross-workflow contention automatically.

    ``indexed=True`` (default) serves the common case — unweighted
    router, segment-carrying request — from a :class:`_ReplicaIndex` in
    O(owners + log R) instead of O(R) scans per call, with selection
    semantics identical to the scan (gated by a parity test);
    ``indexed=False`` keeps the legacy full-scan path.
    """

    def __init__(self, replicas: List[EngineSim], *, affinity: bool = True,
                 weights: Optional[Dict[int, float]] = None,
                 indexed: bool = True,
                 index: Optional[_ReplicaIndex] = None,
                 legacy_load: bool = False):
        assert replicas
        self.replicas = replicas
        self.affinity = affinity
        self.weights = weights
        self.indexed = indexed
        # measurement/parity knob: re-sum each candidate's queues per
        # call (the seed's O(queue) hot path) instead of reading the
        # incrementally-maintained load; bench_scale's legacy baseline
        self.legacy_load = legacy_load
        self._sticky: Dict[int, int] = {}  # workflow instance -> replica
        if index is None and indexed:
            index = _ReplicaIndex(replicas)
        self._index = index
        # observability hook (repro_torch.obs.spans.Tracer); None = untraced
        self.tracer = None

    def view(self, weights: Dict[int, float]) -> "Router":
        """A per-tenant view over the same physical replicas (shares the
        base router's index rather than re-registering listeners)."""
        r = Router(self.replicas, affinity=self.affinity, weights=weights,
                   indexed=self.indexed, index=self._index,
                   legacy_load=self.legacy_load)
        r.tracer = self.tracer
        return r

    def _weight(self, idx: int) -> float:
        if self.weights is None:
            return 1.0
        return self.weights.get(idx, 0.0)

    def forget(self, workflow_request: int) -> None:
        """Drop sticky state for a completed workflow instance (the
        driver calls this from its done path so ``_sticky`` stays
        bounded by in-flight instances)."""
        self._sticky.pop(workflow_request, None)

    def submit(self, req: EngineRequest) -> None:
        if self.indexed and self.weights is None:
            self._submit_indexed(req)
        else:
            self._submit_scan(req)

    def _submit_indexed(self, req: EngineRequest) -> None:
        """Index-served fast path (unweighted router): probe prefix
        owners only, then the load heap.  Sticky (tier 2) never fires
        here — it is only consulted when ``weights`` is set."""
        idx = self._index
        replicas = self.replicas
        choice = None
        if self.affinity:
            if req.prefix is not None:
                head = None
                for seg_id, length in req.prefix:
                    if length > 0:
                        head = seg_id
                        break
                owners = idx.owners.get(head)
                cands = sorted(owners) if owners else ()
            else:
                # legacy parent-id heuristic carries no segment id to
                # index on; rare (drivers always attach segments)
                cands = range(len(replicas))
            best_len = 0
            for i in cands:
                r = replicas[i]
                if getattr(r, "failed", False):
                    continue
                pl = r.prefix_lookup(req)
                if pl > best_len:
                    best_len, choice = pl, i
        tier = "prefix"
        if choice is None:
            tier = "least_loaded"
            choice = idx.least_loaded()
            if choice is None:
                raise RuntimeError("no live replicas")
        if self.tracer is not None:
            self.tracer.on_route(tier)
        replicas[choice].submit(req)

    def _submit_scan(self, req: EngineRequest) -> None:
        live = [(i, r) for i, r in enumerate(self.replicas)
                if not getattr(r, "failed", False) and self._weight(i) > 0]
        if not live:
            raise RuntimeError("no live replicas")
        choice = None
        tier = "prefix"
        if self.affinity:
            best_len = 0
            for i, r in live:
                pl = r.prefix_lookup(req)
                if pl > best_len:
                    best_len, choice = pl, (i, r)
        if choice is None and self.weights is not None \
                and req.workflow_request is not None:
            idx = self._sticky.get(req.workflow_request)
            if idx is not None:
                for i, r in live:
                    if i == idx:
                        choice = (i, r)
                        tier = "sticky"
                        break
        if choice is None:
            tier = "least_loaded"
            if self.legacy_load:
                choice = min(live, key=lambda ir: ir[1].recompute_load()
                             / self._weight(ir[0]))
            else:
                choice = min(live,
                             key=lambda ir: ir[1].load / self._weight(ir[0]))
        idx, target = choice
        if self.weights is not None and req.workflow_request is not None:
            self._sticky[req.workflow_request] = idx
        if self.tracer is not None:
            self.tracer.on_route(tier)
        target.submit(req)

    def fail_replica(self, idx: int) -> None:
        """Kill one replica and re-dispatch its in-flight requests."""
        self.replicas[idx].fail(resubmit=self.submit)


@dataclass
class ReplicaSpec:
    """One deployed replica of an LLM (scheduler output, simulator input)."""

    llm: str
    cfg: ArchConfig
    tp: int = 1
    fraction: float = 1.0  # per-chip share (1.0 = whole chip(s))


def build_llm_service(specs: List[ReplicaSpec], loop: EventLoop, *,
                      prefix_caching: bool = True,
                      avg_context: int = 1024,
                      preemption: bool = False) -> Router:
    engines = [EngineSim(s.cfg, loop, tp=s.tp, fraction=s.fraction,
                         name=f"{s.llm}/{i}", prefix_caching=prefix_caching,
                         avg_context=avg_context, preemption=preemption)
               for i, s in enumerate(specs)]
    return Router(engines)
