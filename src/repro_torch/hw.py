"""Hardware model — chip classes and cluster topology (the port's copy of
``repro.hw``).

Single source of truth for the analytical cost model (serving
simulator / profiler), the roofline analysis, and the scheduler's
memory feasibility checks.

A :class:`ChipClass` bundles one accelerator generation's roofline
constants (peak flops, HBM bytes/bandwidth, interconnect bandwidth)
with the empirical efficiency knobs the cost model applies on top.
The TPU classes ``V5E``, ``V5P`` and ``V4I`` are the reference's, value
for value, so that a TPU plan can be held against the reference.  The
port adds ``H100`` (NVIDIA H100 SXM5 80GB, from its data sheet) and makes
it ``DEFAULT_CHIP_CLASS``: the module-level aliases below read the
default class's fields, so here they are the H100's (the reference's
read the v5e-class part's).  ``H100_HOST_8`` and ``H100_CLUSTER_32`` are
hosts of 8 GPUs joined by one NVLink domain.

Heterogeneous clusters are expressed by giving :class:`ClusterSpec` a
tuple of :class:`HostGroup`s — contiguous runs of identical hosts, each
bound to one chip class.  ``chip_table()`` flattens the groups into
per-chip ``(host, domain, class)`` rows; high-bandwidth domains are
numbered per host, so a domain can never span two hosts, two groups, or
the tail boundary (TP groups therefore never span chip classes by
construction).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class ChipClass:
    """One accelerator generation's constants for the cost model.

    The first block is the raw roofline (peaks — used as-is by the
    roofline analysis); the second block is the empirical efficiency
    knobs the *cost model* multiplies in (sustained fractions, latency
    floors, the weight-loading path for model swaps).
    """

    name: str
    peak_flops_bf16: float  # FLOP/s per chip
    hbm_bw: float  # bytes/s per chip
    hbm_bytes: int  # HBM capacity per chip
    ici_link_bw: float = 50e9  # bytes/s per ICI link
    ici_links_per_chip: int = 4  # torus degree
    dci_bw: float = 25e9  # bytes/s per chip cross-pod
    vmem_bytes: int = 16 * 2**20  # on-core scratch (Pallas tile budget)
    sms: int = 0  # streaming multiprocessors of a GPU class; 0 on a TPU

    # empirical efficiency knobs for the *cost model* (not the roofline)
    mxu_efficiency: float = 0.6  # sustained matmul fraction of peak
    hbm_efficiency: float = 0.8  # sustained HBM stream fraction
    collective_latency: float = 5e-6  # per-collective latency floor (s)
    host_to_hbm_bw: float = 30e9  # weight-loading path (model swap cost)


# The v5e-class default: exactly the constants the uniform-cluster code
# has always used.  V5P is the bigger-HBM class (a 9B-at-TP=1 home);
# V4I is the small-memory inference part that cannot hold a 9B at all.
V5E = ChipClass(
    name="v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    hbm_bytes=16 * 1024**3,
)
V5P = ChipClass(
    name="v5p",
    peak_flops_bf16=459e12,
    hbm_bw=2765e9,
    hbm_bytes=95 * 1024**3,
    ici_link_bw=90e9,
    ici_links_per_chip=6,  # 3D torus
    vmem_bytes=32 * 2**20,
    mxu_efficiency=0.55,  # bigger MXUs sustain a slightly lower fraction
    host_to_hbm_bw=60e9,
)
V4I = ChipClass(
    name="v4i",
    peak_flops_bf16=138e12,
    hbm_bw=614e9,
    hbm_bytes=8 * 1024**3,
    ici_link_bw=25e9,
    ici_links_per_chip=2,
    hbm_efficiency=0.75,
)

# NVIDIA H100 SXM5 80GB, each value from NVIDIA's H100 data sheet or the
# document named beside it.  ``ici_link_bw`` is the per-direction NVLink 4
# bandwidth of one GPU through the host's NVSwitch:
# ``costmodel.tp_collective_time`` divides its ring all-reduce by this
# field, and on an NVSwitch host each GPU of the ring sends at that rate.  The efficiency knobs (mxu_efficiency,
# hbm_efficiency, collective_latency) keep the class defaults and are
# uncalibrated: they wait for a device-bound engine step to be measured.
H100 = ChipClass(
    name="h100",
    peak_flops_bf16=989e12,  # data sheet: dense bf16 tensor-core rate
    hbm_bw=3.35e12,  # data sheet: HBM3 bandwidth
    hbm_bytes=80 * 10**9,  # data sheet: 80 GB HBM3
    ici_link_bw=450e9,  # data sheet: NVLink 4, 900 GB/s = 450 GB/s each way
    ici_links_per_chip=18,  # Hopper white paper: 18 NVLink 4 links per GPU
    dci_bw=50e9,  # DGX H100 data sheet: one 400 Gb/s NIC per GPU
    # CUDA guide, compute capability 9.0: 227 KiB of opt-in shared memory
    # per block, the budget csrc/flash_attention.cu plans its tiles from
    vmem_bytes=232448,
    host_to_hbm_bw=64e9,  # data sheet: PCIe Gen5, 128 GB/s = 64 GB/s each way
    sms=132,  # data sheet: 132 SMs on the SXM5 part
)

DEFAULT_CHIP_CLASS = H100

CHIP_CLASSES: Dict[str, ChipClass] = {c.name: c
                                      for c in (V5E, V5P, V4I, H100)}


def register_chip_class(cls: ChipClass) -> ChipClass:
    """Register a (possibly synthetic) chip class for name lookup.

    Benchmarks use this for the class-blind baseline: one averaged
    "blend" class standing in for a mixed cluster.
    """
    CHIP_CLASSES[cls.name] = cls
    return cls


def chip_class(name: str) -> ChipClass:
    try:
        return CHIP_CLASSES[name]
    except KeyError:
        raise KeyError(
            f"unknown chip class {name!r}; known: {sorted(CHIP_CLASSES)}"
        ) from None


def blend_classes(parts: List[Tuple[ChipClass, int]], name: str = "blend") -> ChipClass:
    """Chip-count-weighted average of several classes (class-blind view)."""
    total = sum(n for _, n in parts)
    if total <= 0:
        raise ValueError("blend_classes needs at least one chip")

    def avg(attr: str) -> float:
        return sum(getattr(c, attr) * n for c, n in parts) / total

    return ChipClass(
        name=name,
        peak_flops_bf16=avg("peak_flops_bf16"),
        hbm_bw=avg("hbm_bw"),
        hbm_bytes=int(avg("hbm_bytes")),
        ici_link_bw=avg("ici_link_bw"),
        ici_links_per_chip=max(1, round(avg("ici_links_per_chip"))),
        dci_bw=avg("dci_bw"),
        vmem_bytes=int(avg("vmem_bytes")),
        mxu_efficiency=avg("mxu_efficiency"),
        hbm_efficiency=avg("hbm_efficiency"),
        collective_latency=avg("collective_latency"),
        host_to_hbm_bw=avg("host_to_hbm_bw"),
    )


# Module-level aliases of the default class's fields (here the H100's;
# the reference's read its v5e-class default).
PEAK_FLOPS_BF16 = DEFAULT_CHIP_CLASS.peak_flops_bf16  # FLOP/s per chip
HBM_BW = DEFAULT_CHIP_CLASS.hbm_bw  # bytes/s per chip
HBM_BYTES = DEFAULT_CHIP_CLASS.hbm_bytes  # bytes per chip
ICI_LINK_BW = DEFAULT_CHIP_CLASS.ici_link_bw  # bytes/s per link
ICI_LINKS_PER_CHIP = DEFAULT_CHIP_CLASS.ici_links_per_chip
DCI_BW = DEFAULT_CHIP_CLASS.dci_bw  # bytes/s per chip cross-host

MXU_EFFICIENCY = DEFAULT_CHIP_CLASS.mxu_efficiency  # sustained matmul fraction
HBM_EFFICIENCY = DEFAULT_CHIP_CLASS.hbm_efficiency  # sustained HBM fraction
COLLECTIVE_LATENCY = DEFAULT_CHIP_CLASS.collective_latency  # per-collective (s)
HOST_TO_HBM_BW = DEFAULT_CHIP_CLASS.host_to_hbm_bw  # weight-loading path


@dataclass(frozen=True)
class HostGroup:
    """A contiguous run of identical hosts bound to one chip class.

    ``num_hosts`` may be a partial tail: a group with ``chips_per_host``
    smaller than its neighbours models a partially-populated host
    explicitly, so packing can never stretch an hb domain (and hence a
    TP group) across the tail boundary.
    """

    num_hosts: int
    chips_per_host: int
    chip_class: str = DEFAULT_CHIP_CLASS.name

    @property
    def num_chips(self) -> int:
        return self.num_hosts * self.chips_per_host

    def cls(self) -> ChipClass:
        return chip_class(self.chip_class)


@dataclass(frozen=True)
class ClusterSpec:
    """Serving-cluster topology (paper's placement problem, TPU terms).

    A *host* groups ``chips_per_host`` chips; ``hb_domain_size`` chips
    share a high-bandwidth ICI domain (the NVLink-domain analogue) — TP
    groups must stay inside one domain.  Each chip is divisible into
    ``fractions_per_chip`` units (enforced by the engine's slot
    scheduler + static HBM budgeting; the MPS analogue).

    Uniform clusters use the scalar fields; ``host_groups`` (when
    non-empty) overrides them with an explicit heterogeneous layout.
    ``tail_chips`` models a partially-populated final host; internally
    it is materialised as an explicit partial :class:`HostGroup`, so
    domains (and hence TP groups) cannot span the tail boundary —
    that is enforced structurally by ``chip_table()``, not by a
    docstring promise.
    """

    num_hosts: int = 4
    chips_per_host: int = 4
    hb_domain_size: int = 2  # paper cluster: NVLink pairs
    fractions_per_chip: int = 10
    tail_chips: int = 0  # chips on one extra, partially-filled host
    host_groups: Tuple[HostGroup, ...] = field(default=())

    def __post_init__(self) -> None:
        if self.host_groups and self.tail_chips:
            raise ValueError(
                "host_groups and tail_chips are mutually exclusive: "
                "model the tail as an explicit partial HostGroup"
            )

    def groups(self) -> Tuple[HostGroup, ...]:
        """The host groups, with scalar fields (and tail) materialised."""
        if self.host_groups:
            return self.host_groups
        groups: Tuple[HostGroup, ...] = ()
        if self.num_hosts:
            groups += (HostGroup(self.num_hosts, self.chips_per_host),)
        if self.tail_chips:
            groups += (HostGroup(1, self.tail_chips),)
        return groups

    @property
    def num_chips(self) -> int:
        return sum(g.num_chips for g in self.groups())

    @property
    def total_hosts(self) -> int:
        return sum(g.num_hosts for g in self.groups())

    @property
    def total_units(self) -> int:
        return self.num_chips * self.fractions_per_chip

    def domains_per_host(self) -> int:
        return self.chips_per_host // self.hb_domain_size

    # -- chip classes ----------------------------------------------------

    def classes(self) -> Tuple[str, ...]:
        """Distinct chip-class names, in group order."""
        seen: List[str] = []
        for g in self.groups():
            if g.chip_class not in seen:
                seen.append(g.chip_class)
        return tuple(seen)

    @property
    def is_uniform(self) -> bool:
        return len(self.classes()) <= 1

    def chips_of_class(self, name: str) -> int:
        return sum(g.num_chips for g in self.groups() if g.chip_class == name)

    def units_of_class(self, name: str) -> int:
        return self.chips_of_class(name) * self.fractions_per_chip

    def chip_table(self) -> Tuple[Tuple[int, int, str], ...]:
        """Per-chip ``(host, domain, chip_class)`` rows.

        Domains are numbered per host — the domain counter advances by
        ``ceil(chips_in_host / hb_domain_size)`` after each host — so a
        domain never spans two hosts, two groups, or the tail boundary.
        For uniform specs whose ``chips_per_host`` is a multiple of
        ``hb_domain_size`` this reproduces the legacy global
        ``chip_index // hb_domain_size`` numbering exactly.
        """
        hb = self.hb_domain_size
        rows: List[Tuple[int, int, str]] = []
        host = 0
        next_domain = 0
        for g in self.groups():
            for _ in range(g.num_hosts):
                for j in range(g.chips_per_host):
                    rows.append((host, next_domain + j // hb, g.chip_class))
                next_domain += -(-g.chips_per_host // hb)  # ceil div
                host += 1
        return tuple(rows)


def hetero_cluster(
    groups: Tuple[HostGroup, ...],
    *,
    hb_domain_size: int = 2,
    fractions_per_chip: int = 10,
) -> ClusterSpec:
    """A heterogeneous cluster from explicit host groups.

    The scalar ``num_hosts``/``chips_per_host`` fields are zeroed so the
    layout comes from ``host_groups`` alone.
    """
    return ClusterSpec(
        num_hosts=0,
        chips_per_host=max((g.chips_per_host for g in groups), default=0),
        hb_domain_size=hb_domain_size,
        fractions_per_chip=fractions_per_chip,
        host_groups=tuple(groups),
    )


# paper-equivalent cluster sizes used across benchmarks (16 chips =
# 4 hosts x 4) plus TPU-pod-scale variants for scale tests.
PAPER_CLUSTER_4 = ClusterSpec(num_hosts=1, chips_per_host=4)
PAPER_CLUSTER_8 = ClusterSpec(num_hosts=2, chips_per_host=4)
PAPER_CLUSTER_16 = ClusterSpec(num_hosts=4, chips_per_host=4)
POD_CLUSTER_256 = ClusterSpec(num_hosts=32, chips_per_host=8,
                              hb_domain_size=8)
# H100 hosts: 8 GPUs each, all 8 in one NVLink (NVSwitch) domain, so a
# TP group may take up to the whole host
H100_HOST_8 = ClusterSpec(num_hosts=1, chips_per_host=8, hb_domain_size=8)
H100_CLUSTER_32 = ClusterSpec(num_hosts=4, chips_per_host=8,
                              hb_domain_size=8)
