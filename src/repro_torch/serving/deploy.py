"""Bridge: Scepsy scheduler output -> simulated serving deployment.

Two shapes: per-workflow private replicas (partitioned fleet, one Router
per workflow-local LLM name), and pooled tenants (one shared replica set
per canonical model, each workflow holding a weighted routing view into
it).

Every builder accepts a queue ``discipline`` (``fifo`` | ``priority`` |
``wfq``, see :mod:`repro_torch.qos.policy`): each engine replica gets its own
discipline instance, and in pooled ``wfq`` mode the per-replica tenant
weights are derived from the fleet's routing tables so deficit-round-
robin hands each workflow its routing-weight share of the replica.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch import hw
from repro_torch.configs.base import ArchConfig
from repro_torch.core.pipeline import Allocation
from repro_torch.qos.policy import make_policy
from repro_torch.serving.simulator import EngineSim, EventLoop, Router
from repro_torch.workflows.runtime import Workflow


def _alloc_chip(alloc: Allocation):
    """The hw.ChipClass an allocation is bound to (None = default)."""
    cc = getattr(alloc, "chip_class", None)
    return hw.chip_class(cc) if cc else None


def routers_from_allocations(wf: Workflow, allocations: Dict[str, Allocation],
                             loop: EventLoop, *, prefix_caching: bool = True,
                             avg_context: int = 1024,
                             discipline: str = "fifo",
                             preemption: bool = False) -> Dict[str, Router]:
    routers: Dict[str, Router] = {}
    for llm, alloc in allocations.items():
        cfg = wf.llms[llm]
        engines = [
            EngineSim(cfg, loop, tp=alloc.tp, fraction=alloc.fraction,
                      name=f"{llm}/{r}", prefix_caching=prefix_caching,
                      avg_context=avg_context,
                      policy=make_policy(discipline),
                      preemption=preemption, chip=_alloc_chip(alloc))
            for r in range(alloc.replicas)
        ]
        routers[llm] = Router(engines)
    return routers


def fleet_routers_from_placement(
        wfs: Dict[str, "Workflow"], placement,
        loop: EventLoop, *, prefix_caching: bool = True,
        avg_context: int = 1024,
        discipline: str = "fifo",
        preemption: bool = False) -> Dict[str, Dict[str, Router]]:
    """Per-workflow routers over a co-placed partitioned fleet.

    ``placement`` is a global ``workflow/llm``-keyed
    :class:`~repro_torch.core.placement.Placement` (from
    :func:`~repro_torch.core.placement.place_fleet` or a fleet deployment's
    ``fleet_placement``): one :class:`EngineSim` is built per placed
    instance with the instance's own TP degree and chip fraction, so
    the simulated replica set is exactly what the placement says is on
    the cluster.  Returned dict is keyed workflow -> local llm name ->
    Router, directly usable as a ClusterDriver's ``routers``.
    """
    F = placement.spec.fractions_per_chip
    table = placement.spec.chip_table()
    groups: Dict[Tuple[str, str], List[EngineSim]] = {}
    for inst in placement.instances:
        wf_name, _, llm = inst.llm.partition("/")
        cfg = wfs[wf_name].llms[llm]
        # each replica runs at the class of the chip it actually landed
        # on — for class-bound instances that is the binding; for
        # unbound instances on a heterogeneous cluster it is whatever
        # the packer picked (the class-blind penalty is real)
        cc = getattr(inst, "chip_class", None)
        if cc is None and inst.chips and inst.chips[0] < len(table):
            cc = table[inst.chips[0]][2]
        groups.setdefault((wf_name, llm), []).append(
            EngineSim(cfg, loop, tp=inst.tp,
                      fraction=inst.units_per_chip / F,
                      name=f"{inst.llm}-r{inst.replica}",
                      prefix_caching=prefix_caching,
                      avg_context=avg_context,
                      policy=make_policy(discipline),
                      preemption=preemption,
                      chip=hw.chip_class(cc) if cc else None))
    out: Dict[str, Dict[str, Router]] = {}
    for (wf_name, llm), engines in groups.items():
        out.setdefault(wf_name, {})[llm] = Router(engines)
    return out


def wfq_replica_weights(members: Dict[str, List[Tuple[str, str]]],
                        routing: Dict[str, Dict[str, Dict[int, float]]]
                        ) -> Dict[str, Dict[int, Dict[str, float]]]:
    """Per-replica tenant weights from the fleet's routing tables:
    canonical id -> replica index -> {workflow: weight}.  A workflow
    pointing several local stages at one tenant contributes the sum of
    those stages' weights on each replica."""
    out: Dict[str, Dict[int, Dict[str, float]]] = {}
    for cid, mem in members.items():
        per_replica: Dict[int, Dict[str, float]] = {}
        for workflow, llm in mem:
            for r, w in routing.get(workflow, {}).get(llm, {}).items():
                if w <= 0:
                    continue
                row = per_replica.setdefault(r, {})
                row[workflow] = row.get(workflow, 0.0) + w
        out[cid] = per_replica
    return out


def tenant_routers(allocations: Dict[str, Allocation],
                   cfgs: Dict[str, ArchConfig], loop: EventLoop, *,
                   prefix_caching: bool = True,
                   avg_context: int = 1024,
                   discipline: str = "fifo",
                   preemption: bool = False,
                   members: Optional[Dict[str, List[Tuple[str, str]]]] = None,
                   routing: Optional[Dict[str, Dict[str, Dict[int, float]]]] = None
                   ) -> Dict[str, Router]:
    """One shared Router per tenant (canonical model id).

    In ``wfq`` mode, pass the pooled schedule's ``members`` and
    ``routing`` so each replica's deficit-round-robin weights match the
    workflows' routing-weight shares of that replica.
    """
    wfq_weights: Dict[str, Dict[int, Dict[str, float]]] = {}
    if discipline == "wfq" and members is not None and routing is not None:
        wfq_weights = wfq_replica_weights(members, routing)
    routers: Dict[str, Router] = {}
    for cid, alloc in allocations.items():
        engines = [
            EngineSim(cfgs[cid], loop, tp=alloc.tp, fraction=alloc.fraction,
                      name=f"{cid}/{r}", prefix_caching=prefix_caching,
                      avg_context=avg_context,
                      policy=make_policy(
                          discipline,
                          weights=wfq_weights.get(cid, {}).get(r)),
                      preemption=preemption, chip=_alloc_chip(alloc))
            for r in range(alloc.replicas)
        ]
        routers[cid] = Router(engines)
    return routers


def pooled_fleet_routers(
        tenants: Dict[str, Router],
        members: Dict[str, List[Tuple[str, str]]],
        routing: Dict[str, Dict[str, Dict[int, float]]],
) -> Dict[str, Dict[str, Router]]:
    """Per-workflow router dicts over *shared* tenant replicas.

    ``members`` maps canonical id -> [(workflow, local llm name)];
    ``routing`` is each workflow's routing table (local llm -> replica
    index -> weight).  The returned dict is keyed workflow -> local llm
    name -> weighted Router view, directly usable as a ClusterDriver's
    ``routers``.
    """
    out: Dict[str, Dict[str, Router]] = {}
    for cid, mem in members.items():
        base = tenants[cid]
        for workflow, llm in mem:
            weights = routing.get(workflow, {}).get(llm)
            view = base.view(weights) if weights is not None else base
            out.setdefault(workflow, {})[llm] = view
    return out


def rebalance_pooled_drivers(drivers, tenants: Dict[str, Router],
                             members: Dict[str, List[Tuple[str, str]]],
                             routing: Dict[str, Dict[str, Dict[int, float]]]
                             ) -> None:
    """Apply a rung-1 routing rebalance to *live* drivers.

    Swaps each driver's router dict for fresh weighted views over the
    SAME engine replicas — queues, KV caches and in-flight requests are
    untouched, which is exactly what "no re-placement" means.  Safe to
    call from a scheduled event mid-simulation.
    """
    per_wf = pooled_fleet_routers(tenants, members, routing)
    for name, drv in drivers.items():
        if name in per_wf:
            # set_routers (not a bare attribute write) so the driver's
            # sticky-prune bookkeeping follows the new views: sessions
            # that end after the rebalance must still forget() their
            # sticky entries on the routers now recording them
            drv.set_routers(per_wf[name])
