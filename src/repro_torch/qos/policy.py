"""Pluggable queue disciplines for :class:`repro_torch.serving.simulator.EngineSim`.

The engine's iteration loop asks its discipline which waiting request to
admit next (``select``) and charges the admitted request's service cost
back (``on_admit``); the default FIFO discipline reproduces the seed
engine's arrival-order behavior exactly.

``priority`` orders by workflow-aware urgency: deadline slack minus the
aggregate-pipeline estimate of the workflow request's remaining work
(:meth:`repro_torch.qos.slo.RequestQoS.slack`), so a request one LLM call from
finishing its workflow jumps a fresh fan-out burst.  Best-effort
requests (no deadline) always queue behind deadline classes, ordered by
class weight then arrival.

``wfq`` is deficit-round-robin over tenants (workflow names): each
backlogged tenant's deficit counter grows by ``quantum x weight`` per
round and a tenant may admit requests while its deficit covers their
token cost, which gives every pooled tenant its routing-weight share of
the replica's served tokens and makes the discipline starvation-free
under overload (any positive-weight tenant's deficit grows without
bound until its head request is served).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional


def request_cost(req) -> float:
    """Service cost of one engine request in tokens (prefill work the
    engine actually runs plus decode work)."""
    return float(req.prompt_tokens - req.cached_prefix + req.output_tokens)


def _tenant(req) -> str:
    q = getattr(req, "qos", None)
    return q.tenant if q is not None else ""


class QueueDiscipline:
    """Interface: pick the next waiting request, get charged for it."""

    name = "fifo"

    def select(self, waiting: List, now: float) -> int:
        """Index into ``waiting`` of the request to admit next."""
        raise NotImplementedError

    def on_admit(self, req, cost: float) -> None:
        """Called once the selected request is actually admitted."""


class FifoDiscipline(QueueDiscipline):
    """Arrival order — the seed engine's behavior."""

    name = "fifo"

    def select(self, waiting: List, now: float) -> int:
        return 0

    def on_admit(self, req, cost: float) -> None:
        pass


class PriorityDiscipline(QueueDiscipline):
    """Class-weight tiers, workflow-aware urgency within a tier.

    Deadline classes are served strictly by descending class weight (a
    gold burst can never be starved by a bronze one); within a tier,
    salvageable requests (deadline slack minus estimated remaining work
    still non-negative) go most-urgent-first, so a workflow request one
    call from completion jumps a same-tier fan-out burst.  Requests
    whose tier SLO is already lost (negative slack) are demoted behind
    their tier's salvageable ones — pure least-slack-first under deep
    overload is the classic EDF pathology of serving the most hopeless
    request first, which destroys goodput for everyone.  Best-effort
    requests (no deadline, or degraded by admission control) always
    queue last.

    Requests without QoS metadata sort as best-effort at unit weight in
    arrival order, so a priority engine fed unclassified traffic behaves
    exactly like FIFO.
    """

    name = "priority"

    @staticmethod
    def _key(req, now: float):
        q = getattr(req, "qos", None)
        if q is None:
            return (1, -1.0, 0.0, 0.0, req.arrival)
        if not math.isfinite(q.deadline) or q.degraded:
            return (1, -q.weight, 0.0, 0.0, req.arrival)
        slack = q.slack(now)
        if slack < 0:  # tier SLO already lost: its salvageable go first
            return (0, -q.weight, 1.0, req.arrival, req.arrival)
        return (0, -q.weight, 0.0, slack, req.arrival)

    def select(self, waiting: List, now: float) -> int:
        return min(range(len(waiting)),
                   key=lambda i: self._key(waiting[i], now))

    def on_admit(self, req, cost: float) -> None:
        pass


class DRRDiscipline(QueueDiscipline):
    """Deficit round robin over tenants (weighted fair queueing).

    ``weights`` maps tenant -> share weight on *this* replica (e.g. the
    workflow's routing weight into it); unknown tenants get weight 1.
    Weights are floored at ``min_weight`` so a mis-routed zero-weight
    tenant degrades to a tiny share instead of starving.  Within a
    tenant, requests are served in arrival order (the waiting list is
    arrival-ordered).
    """

    name = "wfq"

    def __init__(self, weights: Optional[Dict[str, float]] = None, *,
                 quantum: float = 512.0, min_weight: float = 1e-3):
        self.weights = dict(weights or {})
        self.quantum = quantum
        self.min_weight = min_weight
        self.deficit: Dict[str, float] = {}
        self.order: List[str] = []  # round-robin rotation
        self._cursor = 0
        self._in_turn: Optional[str] = None  # tenant currently being served

    def _weight(self, tenant: str) -> float:
        return max(self.weights.get(tenant, 1.0), self.min_weight)

    def _heads(self, waiting: List) -> Dict[str, int]:
        heads: Dict[str, int] = {}
        for i, r in enumerate(waiting):
            t = _tenant(r)
            if t not in heads:
                heads[t] = i
        return heads

    def select(self, waiting: List, now: float) -> int:
        heads = self._heads(waiting)
        for t in heads:
            if t not in self.deficit:
                self.deficit[t] = 0.0
                self.order.append(t)
        # resume the tenant mid-turn if it still has backlog
        spins = 0
        max_cost = max(request_cost(waiting[i]) for i in heads.values())
        # each full rotation adds >= quantum*min_weight to some backlogged
        # tenant, so this many rotations always suffice to cover max_cost
        max_spins = len(self.order) * (
            int(max_cost / (self.quantum * self.min_weight)) + 2)
        while True:
            if self._in_turn is None:
                t = self.order[self._cursor % len(self.order)]
                if t not in heads:
                    # idle tenant: deficit resets (classic DRR), turn skipped
                    self.deficit[t] = 0.0
                    self._cursor += 1
                    spins += 1
                    if spins > max_spins:  # defensive; cannot happen
                        return next(iter(heads.values()))
                    continue
                self.deficit[t] += self.quantum * self._weight(t)
                self._in_turn = t
            t = self._in_turn
            if t in heads and self.deficit[t] >= request_cost(waiting[heads[t]]):
                return heads[t]
            # turn over: head too expensive (or queue drained mid-turn)
            self._in_turn = None
            self._cursor += 1
            spins += 1
            if spins > max_spins:  # defensive; cannot happen
                return next(iter(heads.values()))

    def on_admit(self, req, cost: float) -> None:
        t = _tenant(req)
        if t in self.deficit:
            self.deficit[t] -= cost


DISCIPLINES = ("fifo", "priority", "wfq")


def make_policy(kind: str, *, weights: Optional[Dict[str, float]] = None,
                quantum: float = 512.0) -> Optional[QueueDiscipline]:
    """One fresh discipline instance (engines must not share DRR state).

    ``kind="fifo"`` returns None — the engine's built-in arrival-order
    fast path — so the seed simulator behavior stays bit-identical.
    """
    if kind == "fifo":
        return None
    if kind == "priority":
        return PriorityDiscipline()
    if kind == "wfq":
        return DRRDiscipline(weights, quantum=quantum)
    raise ValueError(f"unknown queue discipline {kind!r}; known: {DISCIPLINES}")
