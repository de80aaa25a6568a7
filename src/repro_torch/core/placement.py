"""Topology-aware fractional placement (paper §6; ROADMAP
"Placement-aware partitioned splits").

Maps the scheduler's allocation (replicas × TP × fraction per LLM) onto a
concrete cluster — hosts, high-bandwidth ICI domains (the NVLink-domain
analogue), chips, fraction units — with the paper's hierarchical
placement heuristic ("place the best allocation onto the GPU cluster,
minimizing fragmentation, while respecting network topology
constraints"):

  1. most-constrained shapes first: TP instances before non-TP; within
     each class, larger first;
  2. fill before spill: candidate hb domains on hosts that already run
     something beat domains on untouched hosts, so a fleet concentrates
     onto few hosts and whole hosts stay free for future large shapes;
  3. best-fit into domain-sized bins: among eligible domains the one
     whose free-chip count most tightly fits the instance wins (ties:
     least remaining capacity, then lowest domain id for determinism);
  4. sub-chip fractions pack onto already-occupied chips first (best
     fit), never onto chips owned by another workflow;
  5. the result is emitted as deployment manifests (the k8s-file
     analogue) consumed by ``repro_torch.launch.serve``; fraction limits are
     enforced by the engine's slot scheduler (the MPS analogue).

Inputs are ``{llm: Allocation}`` maps from :mod:`repro_torch.core.scheduler`
plus a :class:`repro_torch.hw.ClusterSpec`; outputs are :class:`Placement`
objects (and :class:`MigrationDiff` edits between them).

Three entry points share one packing core:

* :func:`place` — one allocation map (a single workflow, or a pooled
  fleet's shared tenant replica set) over the whole cluster;
* :func:`place_fleet` — true co-placement of a partitioned fleet: every
  workflow's replicas packed in ONE pass over the real topology (tail
  chips included), chip ownership kept exclusive per workflow, instances
  keyed ``<workflow>/<llm>`` so :func:`migration_diff` works fleet-wide.
  This replaces the old contiguous-slice model (:func:`fleet_offsets` +
  :func:`merge_fleet`, kept for comparison) which padded every
  TP-carrying slice to an hb-domain boundary;
* :func:`feasibility` / :func:`fleet_feasibility` — the cheap probe the
  split search calls per candidate split: same packing, but no manifest
  is materialized; returns ``(ok, fragmentation_cost)``.

Failures raise a structured :class:`PlacementError` carrying the shape
that failed, the per-domain free contiguous capacity at the time of
failure, and a remediation hint.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch import hw
from repro_torch.core.pipeline import Allocation


class PlacementError(RuntimeError):
    """A shape could not be placed (or a placement failed validation).

    Structured diagnostics (all optional — validation errors carry only
    a message):

    * ``shape`` — the instance that failed: ``{"llm", "replica", "tp",
      "units_per_chip"}``;
    * ``domain_capacity`` — per-hb-domain free capacity at failure time:
      ``{domain: {"host", "free_chips", "free_units",
      "largest_chip_free_units"}}`` (``free_chips`` counts fully-free
      chips — the contiguous capacity a TP group needs);
    * ``hint`` — what would make the shape placeable.
    """

    def __init__(self, message: str, *, shape: Optional[dict] = None,
                 domain_capacity: Optional[Dict[int, dict]] = None,
                 hint: Optional[str] = None):
        self.shape = shape
        self.domain_capacity = domain_capacity
        self.hint = hint
        parts = [message]
        if shape is not None:
            parts.append(f"shape: {shape}")
        if domain_capacity is not None:
            cap = ", ".join(
                f"d{d}(host {c['host']}): {c['free_chips']} free chips"
                f"/{c['free_units']}u"
                for d, c in sorted(domain_capacity.items()))
            parts.append(f"free contiguous capacity: {cap}")
        if hint is not None:
            parts.append(f"hint: {hint}")
        super().__init__("; ".join(parts))


@dataclass
class Chip:
    host: int
    domain: int  # global hb-domain id
    index: int  # global chip id
    free_units: int
    owner: Optional[str] = None  # workflow owning this chip (fleet packs)
    chip_class: str = ""  # hw.ChipClass name (heterogeneous clusters)

    def used(self, total: int) -> int:
        return total - self.free_units


@dataclass
class PlacedInstance:
    llm: str
    replica: int
    tp: int
    chips: List[int]  # global chip ids
    units_per_chip: int
    host: int
    domain: int
    # the Allocation's requested chip class; None = any (uniform cluster)
    chip_class: Optional[str] = None


@dataclass
class Placement:
    spec: hw.ClusterSpec
    instances: List[PlacedInstance] = field(default_factory=list)

    def chips_of(self, llm: str) -> List[int]:
        return sorted({c for i in self.instances if i.llm == llm
                       for c in i.chips})

    def validate(self) -> None:
        F = self.spec.fractions_per_chip
        table = self.spec.chip_table()
        used: Dict[int, int] = {}
        for inst in self.instances:
            if inst.tp > self.spec.hb_domain_size:
                raise PlacementError(
                    f"{inst.llm}: TP {inst.tp} exceeds hb domain "
                    f"{self.spec.hb_domain_size}")
            domains, classes = set(), set()
            for c in inst.chips:
                used[c] = used.get(c, 0) + inst.units_per_chip
                if c < len(table):
                    domains.add(table[c][1])
                    classes.add(table[c][2])
                else:  # chip id beyond spec (externally built placement)
                    domains.add(c // self.spec.hb_domain_size)
            if inst.tp > 1 and len(domains) != 1:
                raise PlacementError(
                    f"{inst.llm}: TP instance spans domains {domains}")
            if len(classes) > 1:
                raise PlacementError(
                    f"{inst.llm}: instance spans chip classes {classes}")
            if inst.chip_class is not None and classes and \
                    classes != {inst.chip_class}:
                raise PlacementError(
                    f"{inst.llm}: bound to class {inst.chip_class!r} but "
                    f"placed on {classes}")
        for c, u in used.items():
            if u > F:
                raise PlacementError(f"chip {c} oversubscribed: {u}/{F}")

    def fragmentation(self, scope: str = "cluster") -> float:
        """Fraction of free units stranded on partially-used chips.

        ``scope="cluster"`` (default) counts every chip in ``spec`` —
        the right metric for placements that own the whole cluster
        (:func:`place`, :func:`place_fleet`, the probe): untouched
        fully-free chips are usable capacity, not fragmentation.
        ``scope="touched"`` restricts to chips this placement's
        instances actually use — the right metric for the per-workflow
        views :func:`split_fleet` returns, whose ``spec`` is still the
        full cluster (chips owned by *other* workflows would otherwise
        dilute the number).
        """
        if scope not in ("cluster", "touched"):
            raise ValueError(f"unknown fragmentation scope {scope!r}")
        F = self.spec.fractions_per_chip
        used: Dict[int, int] = ({} if scope == "touched"
                                else {c: 0 for c in range(self.spec.num_chips)})
        for inst in self.instances:
            for c in inst.chips:
                used[c] = used.get(c, 0) + inst.units_per_chip
        stranded = sum(F - u for u in used.values() if 0 < u < F)
        total_free = sum(F - u for u in used.values())
        return stranded / total_free if total_free else 0.0

    def to_deployment(self, routing: Optional[dict] = None) -> dict:
        """k8s-style deployment manifest (consumed by repro_torch.launch.serve).

        ``routing`` (from :func:`tenant_routing`) annotates a pooled
        multi-tenant placement with each workflow's routing table.
        """
        doc = {
            "apiVersion": "repro/v1",
            "kind": "WorkflowServingDeployment",
            "cluster": {
                "hosts": self.spec.num_hosts,
                "chips_per_host": self.spec.chips_per_host,
                "tail_chips": self.spec.tail_chips,
                "hb_domain_size": self.spec.hb_domain_size,
                "fractions_per_chip": self.spec.fractions_per_chip,
            },
            "instances": [
                {
                    "name": f"{i.llm}-r{i.replica}",
                    "llm": i.llm,
                    "tensor_parallel": i.tp,
                    "chips": i.chips,
                    "chip_fraction": i.units_per_chip
                    / self.spec.fractions_per_chip,
                    "host": i.host,
                    "hb_domain": i.domain,
                    **({"chip_class": i.chip_class}
                       if i.chip_class is not None else {}),
                }
                for i in self.instances
            ],
        }
        if self.spec.host_groups:
            doc["cluster"]["host_groups"] = [
                {"num_hosts": g.num_hosts,
                 "chips_per_host": g.chips_per_host,
                 "chip_class": g.chip_class}
                for g in self.spec.host_groups
            ]
        if routing is not None:
            doc["routing"] = routing
        return doc


@dataclass
class _Cluster:
    """Mutable packing state; the per-domain free counters and busy-host
    set are maintained incrementally by :meth:`claim` so the greedy
    placement loop never rescans the whole cluster per instance."""

    spec: hw.ClusterSpec
    chips: List[Chip]
    domain_map: Dict[int, List[Chip]]
    dom_free_chips: Dict[int, int]  # fully-free chips per domain
    dom_free_units: Dict[int, int]  # total free units per domain
    busy_hosts: set

    @classmethod
    def fresh(cls, spec: hw.ClusterSpec) -> "_Cluster":
        chips = []
        domain_map: Dict[int, List[Chip]] = {}
        # chip_table() materializes hosts, hb domains and chip classes for
        # every chip — including tail chips and heterogeneous host groups;
        # domains never span hosts, host groups or the tail boundary, so a
        # TP group can never be packed across either
        for i, (host, domain, cname) in enumerate(spec.chip_table()):
            chip = Chip(host, domain, i, spec.fractions_per_chip,
                        chip_class=cname)
            chips.append(chip)
            domain_map.setdefault(domain, []).append(chip)
        return cls(spec, chips, domain_map,
                   {d: len(cs) for d, cs in domain_map.items()},
                   {d: len(cs) * spec.fractions_per_chip
                    for d, cs in domain_map.items()},
                   set())

    def claim(self, chip: Chip, units: int, owner: Optional[str]) -> None:
        if chip.free_units == self.spec.fractions_per_chip:
            self.dom_free_chips[chip.domain] -= 1
        chip.free_units -= units
        chip.owner = owner
        self.dom_free_units[chip.domain] -= units
        self.busy_hosts.add(chip.host)

    def fragmentation(self) -> float:
        F = self.spec.fractions_per_chip
        stranded = sum(c.free_units for c in self.chips
                       if 0 < c.free_units < F)
        total_free = sum(c.free_units for c in self.chips)
        return stranded / total_free if total_free else 0.0

    def domain_capacity(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        for dom, chips in self.domain_map.items():
            out[dom] = {
                "host": chips[0].host,
                "free_chips": self.dom_free_chips[dom],
                "free_units": self.dom_free_units[dom],
                "largest_chip_free_units": max(c.free_units for c in chips),
            }
        return out


@dataclass
class FeasibilityResult:
    """Outcome of the placement probe (:func:`fleet_feasibility`).

    Iterable as ``(ok, fragmentation)`` so the split search can unpack
    it directly.  ``fragmentation`` is the stranded-free-unit fraction
    of the probed packing (0 = every touched chip exactly tiled);
    ``failed_shape`` names the first unplaceable instance when ``ok`` is
    False (fragmentation is then reported for the partial packing).
    """

    ok: bool
    fragmentation: float
    failed_shape: Optional[dict] = None

    def __bool__(self) -> bool:
        return self.ok

    def __iter__(self):
        yield self.ok
        yield self.fragmentation


def _instances_from_alloc(allocations: Dict[str, Allocation],
                          spec: hw.ClusterSpec, owner: Optional[str] = None):
    """Expand allocations into placeable (owner, llm, replica, tp, units,
    chip_class) instance descriptors; ``owner`` prefixes the instance key
    for fleet packs.  ``chip_class`` is the Allocation's binding (None =
    any chip)."""
    F = spec.fractions_per_chip
    key = (lambda m: f"{owner}/{m}") if owner is not None else (lambda m: m)
    out = []
    for llm, a in allocations.items():
        cc = getattr(a, "chip_class", None)
        for r in range(a.replicas):
            if a.tp > 1 or a.fraction >= 1.0:
                out.append((owner, key(llm), r, a.tp, F, cc))  # whole chips
            else:
                units = max(int(round(a.fraction * F)), 1)
                out.append((owner, key(llm), r, 1, units, cc))
    return out


def _pack(groups: Dict[Optional[str], Dict[str, Allocation]],
          spec: hw.ClusterSpec, *, record: bool
          ) -> Tuple[Optional[List[PlacedInstance]], Optional[dict], _Cluster]:
    """Shared packing core: hierarchical most-constrained-first greedy.

    ``groups`` maps owner (workflow name, or None for a single
    workflow / pooled tenant set) to its allocation map.  Chips are
    owned exclusively: a sub-chip fraction only co-locates with replicas
    of the same owner, which is what keeps a partitioned fleet's chip
    sets disjoint.  With ``record=False`` no :class:`PlacedInstance`
    objects are built — the probe path.

    Returns ``(instances_or_None, failed_shape, cluster)``; on failure
    ``instances`` is None and ``failed_shape`` describes the first
    unplaceable instance.
    """
    cluster = _Cluster.fresh(spec)
    F = spec.fractions_per_chip
    insts: list = []
    for owner, allocations in groups.items():
        insts.extend(_instances_from_alloc(allocations, spec, owner))
    # most-constrained-first across ALL owners: class-bound before
    # class-free (a bound shape has fewer candidate domains), TP desc,
    # then whole-chip, then fraction desc; owner/llm tail keys make the
    # order total
    insts.sort(key=lambda t: (-(t[5] is not None), -(t[3] > 1), -t[3],
                              -t[4], t[1], t[2]))

    placed: Optional[List[PlacedInstance]] = [] if record else None
    for owner, llm, replica, tp, units, cc in insts:
        if tp >= 1 and units == F:
            chips = _place_whole(cluster, tp, cc)
        else:
            chips = _place_fraction(cluster, units, owner, cc)
        if chips is None:
            return None, {"llm": llm, "replica": replica, "tp": tp,
                          "units_per_chip": units, "chip_class": cc}, cluster
        per_chip = units if (tp == 1 and units < F) else F
        for c in chips:
            cluster.claim(c, per_chip, owner)
        if record:
            placed.append(PlacedInstance(
                llm=llm, replica=replica, tp=tp,
                chips=[c.index for c in chips], units_per_chip=per_chip,
                host=chips[0].host, domain=chips[0].domain,
                chip_class=cc))
    return placed, None, cluster


def _fail(failed: dict, cluster: _Cluster) -> PlacementError:
    shape = failed
    tp, units = shape["tp"], shape["units_per_chip"]
    F = cluster.spec.fractions_per_chip
    if tp > 1 or units == F:
        hint = (f"needs {tp} fully-free chip(s) inside one hb domain "
                f"(domain size {cluster.spec.hb_domain_size}); free a "
                "domain, lower TP, or grant this workflow more chips")
    else:
        hint = (f"needs {units}/{F} free units on one chip owned by the "
                "same workflow; sub-chip replicas never span chips — "
                "use smaller fractions or more chips")
    if shape.get("chip_class"):
        hint += (f"; instance is bound to chip class "
                 f"{shape['chip_class']!r} — only hosts of that class "
                 "are candidates")
    return PlacementError("cannot place instance", shape=shape,
                          domain_capacity=cluster.domain_capacity(),
                          hint=hint)


def place(allocations: Dict[str, Allocation],
          spec: hw.ClusterSpec) -> Placement:
    """Place one allocation map (single workflow or pooled tenant set)
    over the whole cluster; raises :class:`PlacementError` on failure."""
    placed, failed, cluster = _pack({None: allocations}, spec, record=True)
    if placed is None:
        raise _fail(failed, cluster)
    placement = Placement(spec, placed)
    placement.validate()
    return placement


def place_fleet(allocs_by_workflow: Dict[str, Dict[str, Allocation]],
                spec: hw.ClusterSpec) -> Placement:
    """Co-place a partitioned fleet in ONE pass over the real topology.

    Every workflow's replicas compete for the same hosts/domains under
    the hierarchical heuristic (largest TP shapes first, fleet-wide);
    chip ownership stays exclusive per workflow, but slices are neither
    contiguous nor hb-domain-aligned — tail chips and odd-sized
    leftovers are all usable.  Instances are keyed ``<workflow>/<llm>``,
    matching what :func:`migration_diff` and the replan ladder expect.
    """
    placed, failed, cluster = _pack(dict(allocs_by_workflow), spec,
                                    record=True)
    if placed is None:
        raise _fail(failed, cluster)
    placement = Placement(spec, placed)
    placement.validate()
    return placement


def fleet_feasibility(allocs_by_workflow: Dict[str, Dict[str, Allocation]],
                      spec: hw.ClusterSpec) -> FeasibilityResult:
    """The split search's placement probe: ``(ok, fragmentation_cost)``.

    Runs the exact packing :func:`place_fleet` would run — so ``ok``
    really means the split deploys — but materializes no instances or
    manifest.  Cost is O(instances × domains) for whole-chip/TP shapes
    (per-domain free counters are maintained incrementally) plus a
    partial-chip scan per sub-chip fraction."""
    placed, failed, cluster = _pack(dict(allocs_by_workflow), spec,
                                    record=False)
    return FeasibilityResult(ok=failed is None,
                             fragmentation=cluster.fragmentation(),
                             failed_shape=failed)


def feasibility(allocations: Dict[str, Allocation],
                spec: hw.ClusterSpec) -> FeasibilityResult:
    """Single-group probe (one workflow, or a pooled tenant set)."""
    return fleet_feasibility({None: allocations}, spec)  # type: ignore[dict-item]


def _place_whole(cluster: _Cluster, tp: int,
                 chip_class: Optional[str] = None) -> Optional[List[Chip]]:
    """Place a tp-chip instance inside one hb domain (fully-free chips).

    Candidate domains are ranked fill-before-spill (hosts already in use
    first), then best-fit (tightest free-chip count), then least
    remaining capacity, then domain id.  Runs off the cluster's
    incrementally-maintained per-domain counters: O(domains) per call
    plus one scan of the winning domain.  ``chip_class`` restricts
    candidates to domains of that class (a domain never spans classes,
    so the first chip's class speaks for the domain)."""
    F = cluster.spec.fractions_per_chip
    best = None
    for dom, chips in cluster.domain_map.items():
        if chip_class is not None and chips[0].chip_class != chip_class:
            continue
        n_free = cluster.dom_free_chips[dom]
        if n_free < tp:
            continue
        spill = 0 if chips[0].host in cluster.busy_hosts else 1
        key = (spill, n_free - tp, cluster.dom_free_units[dom], dom)
        if best is None or key < best:
            best = key
    if best is None:
        return None
    free = [c for c in cluster.domain_map[best[3]] if c.free_units == F]
    return free[:tp]


def _place_fraction(cluster: _Cluster, units: int,
                    owner: Optional[str] = None,
                    chip_class: Optional[str] = None
                    ) -> Optional[List[Chip]]:
    """Best-fit a sub-chip fraction; prefer already-occupied chips of
    the same owner (exclusive chip ownership keeps partitioned fleets'
    chip sets disjoint).  ``chip_class`` restricts candidates to chips
    of that class."""
    F = cluster.spec.fractions_per_chip
    partial = [c for c in cluster.chips
               if 0 < c.free_units < F and c.free_units >= units
               and c.owner == owner
               and (chip_class is None or c.chip_class == chip_class)]
    if partial:
        partial.sort(key=lambda c: (c.free_units, c.index))  # tightest fit
        return [partial[0]]
    # open a fresh chip: fill-before-spill, then least-capacity domain
    best = None
    for dom, chips in cluster.domain_map.items():
        if chip_class is not None and chips[0].chip_class != chip_class:
            continue
        if cluster.dom_free_chips[dom] == 0:
            continue
        spill = 0 if chips[0].host in cluster.busy_hosts else 1
        key = (spill, cluster.dom_free_units[dom], dom)
        if best is None or key < best:
            best = key
    if best is None:
        return None
    return [next(c for c in cluster.domain_map[best[2]]
                 if c.free_units == F)]


def fleet_offsets(placements: Dict[str, Placement], order,
                  spec: hw.ClusterSpec) -> Dict[str, int]:
    """Disjoint physical slice starts for per-workflow slice-local
    placements — the LEGACY contiguous-slice fleet model.

    Superseded by :func:`place_fleet` (true co-placement, no alignment
    padding); kept as the placement-blind baseline the placement
    benchmark compares against.  A slice start is hb-domain-aligned only
    when the slice contains TP groups (a TP instance must not cross a
    domain boundary after translation); TP=1 slices can start anywhere.
    Raises :class:`PlacementError` when the slices do not fit the
    cluster.
    """
    dom = spec.hb_domain_size
    offsets: Dict[str, int] = {}
    cursor = 0
    for name in order:
        insts = placements[name].instances
        used = 1 + max((c for inst in insts for c in inst.chips), default=0)
        if any(inst.tp > 1 for inst in insts):
            cursor = (cursor + dom - 1) // dom * dom
        offsets[name] = cursor
        cursor += used
    if cursor > spec.num_chips:
        raise PlacementError(
            f"fleet needs {cursor} chips for disjoint contiguous slices, "
            f"cluster has {spec.num_chips}",
            hint="contiguous slices waste chips on hb-domain alignment; "
                 "co-place with place_fleet instead")
    return offsets


def merge_fleet(placements: Dict[str, Placement], offsets: Dict[str, int],
                spec: hw.ClusterSpec) -> Placement:
    """One global :class:`Placement` for a partitioned fleet (legacy
    contiguous-slice model; see :func:`place_fleet`).

    Slice-local instances are translated by their workflow's offset and
    renamed ``<workflow>/<llm>`` so instance keys — and therefore
    :func:`migration_diff` — are unambiguous fleet-wide.
    """
    import dataclasses as dc

    out = Placement(spec)
    for name, pl in placements.items():
        off = offsets[name]
        for inst in pl.instances:
            chips = [c + off for c in inst.chips]
            out.instances.append(dc.replace(
                inst, llm=f"{name}/{inst.llm}", chips=chips,
                host=chips[0] // spec.chips_per_host,
                domain=chips[0] // spec.hb_domain_size))
    return out


def split_fleet(placement: Placement
                ) -> Dict[str, Placement]:
    """Per-workflow views of a co-placed fleet (inverse of the
    ``<workflow>/<llm>`` keying).  Chip ids stay GLOBAL — a view is the
    workflow's slice of the real cluster, not a renumbered sub-cluster —
    and each view's ``spec`` is still the full cluster, so per-workflow
    fragmentation must be read with ``fragmentation(scope="touched")``
    (the cluster-scope default would count other workflows' chips as
    free capacity).
    """
    import dataclasses as dc

    out: Dict[str, Placement] = {}
    for inst in placement.instances:
        wf, _, llm = inst.llm.partition("/")
        out.setdefault(wf, Placement(placement.spec)).instances.append(
            dc.replace(inst, llm=llm))
    return out


def tenant_routing(placement: Placement,
                   members: Dict[str, List[Tuple[str, str]]],
                   weights: Dict[str, Dict[str, Dict[int, float]]]
                   ) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Routing tables into a pooled placement, keyed by instance name.

    A pooled fleet gets ONE physical placement (the tenants' shared
    replica sets); instead of a private chip offset, every workflow
    receives a table ``local llm name -> {placed instance -> weight}``.
    ``members`` maps canonical model id -> [(workflow, local name)] and
    ``weights`` is the scheduler's replica-indexed routing
    (:meth:`MergedPipeline.routing_weights`); weights per (workflow,
    llm) sum to 1.
    """
    by_tenant: Dict[str, List[PlacedInstance]] = {}
    for inst in placement.instances:
        by_tenant.setdefault(inst.llm, []).append(inst)
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for cid, mem in members.items():
        insts = sorted(by_tenant.get(cid, []), key=lambda i: i.replica)
        for workflow, llm in mem:
            w = weights.get(workflow, {}).get(llm, {})
            table = {f"{i.llm}-r{i.replica}": w.get(i.replica, 0.0)
                     for i in insts}
            total = sum(table.values())
            if total > 0:
                table = {k: v / total for k, v in table.items()}
            out.setdefault(workflow, {})[llm] = table
    return out


@dataclass
class MigrationDiff:
    """What a re-placement actually changes, instance by instance.

    A full re-plan hands the operator this diff — chips to move, replicas
    to add or drop — rather than a from-scratch manifest, so a rung-3
    drift reaction is an *edit* to the running deployment.  An instance
    is keyed ``llm-r<replica>``; ``chip_loads`` counts the (instance,
    chip) assignments present in the new placement but not the old one —
    i.e. weight-loading events the migration must pay for.
    """

    added: List[str] = field(default_factory=list)
    dropped: List[str] = field(default_factory=list)
    moved: List[str] = field(default_factory=list)
    unchanged: List[str] = field(default_factory=list)
    chip_loads: int = 0

    @property
    def chips_moved(self) -> int:
        return self.chip_loads

    def summary(self) -> dict:
        return {
            "replicas_added": len(self.added),
            "replicas_dropped": len(self.dropped),
            "replicas_moved": len(self.moved),
            "replicas_unchanged": len(self.unchanged),
            "chips_moved": self.chip_loads,
        }


def migration_diff(old: Placement, new: Placement) -> MigrationDiff:
    """Instance-level diff between two placements of the same cluster."""
    def keyed(p: Placement) -> Dict[str, PlacedInstance]:
        return {f"{i.llm}-r{i.replica}": i for i in p.instances}

    a, b = keyed(old), keyed(new)
    diff = MigrationDiff()
    for name in sorted(set(a) | set(b)):
        if name not in a:
            diff.added.append(name)
            diff.chip_loads += len(b[name].chips)
        elif name not in b:
            diff.dropped.append(name)
        else:
            oi, ni = a[name], b[name]
            fresh = set(ni.chips) - set(oi.chips)
            if fresh or oi.units_per_chip != ni.units_per_chip \
                    or oi.tp != ni.tp:
                diff.moved.append(name)
                diff.chip_loads += len(fresh) if oi.tp == ni.tp else \
                    len(ni.chips)
            else:
                diff.unchanged.append(name)
    return diff


def save_deployment(placement: Placement, path: str,
                    routing: Optional[dict] = None) -> None:
    with open(path, "w") as f:
        json.dump(placement.to_deployment(routing), f, indent=2)
