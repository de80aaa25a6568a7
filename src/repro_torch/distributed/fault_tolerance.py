"""Fault tolerance + elastic scaling controller (1000+-node design).

On a real multi-pod deployment this wraps the training/serving launcher:

  * heartbeat monitor — every worker (host) reports liveness; a missed
    ``grace`` window marks it failed;
  * straggler detection — per-step durations; a worker slower than
    ``straggler_factor`` x median for ``patience`` consecutive steps is
    treated like a failure (preemptive re-mesh beats waiting);
  * elastic re-mesh — on failure, drop the affected `data` slice(s) and
    rebuild the mesh with the largest power-of-two data axis that the
    survivors support; training resumes from the last checkpoint (the
    data pipeline is seekable by step, so no sample is lost or repeated);
  * serving side: the router already fails over (failed replica removed
    from the replica list); placement re-runs on the survivor cluster.

The container has one host, so the unit tests drive this with a simulated
clock — the controller is pure logic over (worker, timestamp) streams.
"""
from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple


@dataclass
class WorkerState:
    last_heartbeat: float = 0.0
    step_durations: List[float] = field(default_factory=list)
    slow_streak: int = 0
    alive: bool = True


@dataclass
class MeshPlan:
    """What the launcher should rebuild after an elasticity event."""

    data_ways: int
    model_ways: int
    dropped_workers: Tuple[int, ...]
    restart_from_checkpoint: bool


class FaultToleranceController:
    def __init__(self, num_workers: int, *, grace: float = 30.0,
                 straggler_factor: float = 2.0, patience: int = 3,
                 model_ways: int = 16):
        self.workers: Dict[int, WorkerState] = {
            i: WorkerState() for i in range(num_workers)}
        self.grace = grace
        self.straggler_factor = straggler_factor
        self.patience = patience
        self.model_ways = model_ways

    # --- telemetry ingestion ---
    def heartbeat(self, worker: int, t: float) -> None:
        self.workers[worker].last_heartbeat = t

    def report_step(self, worker: int, duration: float) -> None:
        w = self.workers[worker]
        w.step_durations.append(duration)
        if len(w.step_durations) > 50:
            w.step_durations.pop(0)

    # --- failure / straggler detection ---
    def check(self, now: float) -> Optional[MeshPlan]:
        alive = [i for i, w in self.workers.items() if w.alive]
        failed: Set[int] = set()
        for i in alive:
            w = self.workers[i]
            if now - w.last_heartbeat > self.grace:
                failed.add(i)
        medians = [w.step_durations[-1] for i, w in self.workers.items()
                   if w.alive and w.step_durations and i not in failed]
        if medians:
            med = statistics.median(medians)
            for i in alive:
                w = self.workers[i]
                if not w.step_durations or i in failed:
                    continue
                if w.step_durations[-1] > self.straggler_factor * med:
                    w.slow_streak += 1
                    if w.slow_streak >= self.patience:
                        failed.add(i)  # persistent straggler == failure
                else:
                    w.slow_streak = 0
        if not failed:
            return None
        for i in failed:
            self.workers[i].alive = False
        return self.remesh_plan(tuple(sorted(failed)))

    def remesh_plan(self, dropped: Tuple[int, ...]) -> MeshPlan:
        survivors = sum(1 for w in self.workers.values() if w.alive)
        # keep the model axis (TP needs its full ICI ring); shrink data
        data_ways = max(1, 2 ** int(math.log2(
            max(survivors * 0 + survivors, 1))))
        # survivors hosts each drive (chips_per_host) chips; data axis is
        # the largest power of two <= survivors
        data_ways = 2 ** int(math.log2(survivors)) if survivors else 1
        return MeshPlan(data_ways=data_ways, model_ways=self.model_ways,
                        dropped_workers=dropped,
                        restart_from_checkpoint=True)

    def alive_workers(self) -> List[int]:
        return [i for i, w in self.workers.items() if w.alive]


def backup_dispatch(latencies: Dict[int, float], deadline: float
                    ) -> List[int]:
    """Serving-side straggler mitigation: replicas whose in-flight request
    age exceeds the deadline get a backup dispatch elsewhere (first
    completion wins).  Returns replica ids needing a backup."""
    return [r for r, age in latencies.items() if age > deadline]
