"""The Aggregate LLM Pipeline (paper §4 steps 4–5).

Synthesizes workflow statistics (n_m, p_m) and per-LLM throughput-latency
profiles into a pipeline of unique LLM stages, then predicts workflow-
level latency and throughput for a candidate GPU allocation:

    L_w(λ_w) = Σ_m L_m(λ_w · n_m / d_m ; TP_m, f_m) · n_m / p_m     (eq. 1)
    T_w      = min_m  d_m · T_m(TP_m, f_m) / n_m                    (eq. 2)

Prediction is profile lookups + arithmetic — negligible cost, which is
what lets the GPU scheduler explore large allocation spaces (§5).

Aggregate pipelines also compose *across* workflows: rate-weighted
aggregate shares over a shared LLM are still aggregate shares, so N
workflows' pipelines fuse into one tenant-tagged pipeline
(:func:`merge_pipelines`) whose stages are keyed by canonical model
identity rather than workflow-local stage names.  The merged pipeline
drives the pooled multi-tenant scheduling path, and per-workflow
latency/throughput is attributed back out of the shared allocation
(:meth:`MergedPipeline.attribute`).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.aggregate import WorkflowStats
from repro_torch.core.profiler import LLMProfile


def canonical_llm_id(cfg: ArchConfig) -> str:
    """Pooling identity of an LLM: the architecture name.

    Workflow-local stage names ("map", "debater") are routing labels;
    two stages are servable by the same replicas iff they load the same
    weights, which ``ArchConfig.name`` identifies.
    """
    return cfg.name


@dataclass(frozen=True)
class Allocation:
    """Scheduler decision for one LLM.

    ``chip_class`` binds the replicas to one chip class on a
    heterogeneous cluster (``None`` = any / the uniform default class);
    placement refuses to put a class-bound instance on another class's
    chips.
    """

    replicas: int = 1
    tp: int = 1
    fraction: float = 1.0  # per-replica chip share (tp chips x fraction)
    chip_class: Optional[str] = None

    @property
    def chip_units(self) -> float:
        return self.replicas * self.tp * self.fraction


@dataclass
class PipelineStage:
    llm: str
    cfg: ArchConfig
    n: float  # invocations per workflow request
    p: float  # request-level parallelism
    profile: LLMProfile
    mean_share: float


@dataclass
class Prediction:
    latency: float  # workflow-level latency at λ_w (s)
    max_throughput: float  # workflow requests/s
    feasible: bool  # max_throughput >= λ_w and finite latency
    bottleneck_llm: str
    latency_dominant_llm: str
    per_llm_latency: Dict[str, float] = field(default_factory=dict)


class AggregateLLMPipeline:
    def __init__(self, workflow: str, stages: List[PipelineStage]):
        self.workflow = workflow
        self.stages = {s.llm: s for s in stages}

    @classmethod
    def synthesize(cls, stats: WorkflowStats,
                   profiles: Dict[str, LLMProfile],
                   cfgs: Dict[str, ArchConfig]) -> "AggregateLLMPipeline":
        stages = []
        for m, st in stats.per_llm.items():
            if st.n <= 0:
                continue
            stages.append(PipelineStage(
                llm=m, cfg=cfgs[m], n=st.n, p=st.p, profile=profiles[m],
                mean_share=st.mean_share))
        return cls(stats.workflow, stages)

    # ------------------------------------------------------------------
    # Predictions
    # ------------------------------------------------------------------

    def predict(self, alloc: Dict[str, Allocation], lam_w: float,
                percentile: str = "mean") -> Prediction:
        total_latency = 0.0
        per_llm: Dict[str, float] = {}
        t_w = math.inf
        bottleneck = ""
        dominant = ""
        dom_lat = -1.0
        for m, st in self.stages.items():
            a = alloc[m]
            per_replica_rate = lam_w * st.n / max(a.replicas, 1)
            lm = st.profile.latency(per_replica_rate, a.tp,
                                    fraction=a.fraction,
                                    percentile=percentile,
                                    chip_class=a.chip_class)
            contrib = lm * st.n / max(st.p, 1.0)
            per_llm[m] = contrib
            total_latency += contrib
            tm = (a.replicas * st.profile.max_throughput(
                      a.tp, fraction=a.fraction, chip_class=a.chip_class)
                  / st.n)
            if tm < t_w:
                t_w, bottleneck = tm, m
            if contrib > dom_lat:
                dom_lat, dominant = contrib, m
        feasible = t_w >= lam_w and math.isfinite(total_latency)
        return Prediction(latency=total_latency, max_throughput=t_w,
                          feasible=feasible, bottleneck_llm=bottleneck,
                          latency_dominant_llm=dominant,
                          per_llm_latency=per_llm)

    def latency_ratios(self, percentile: str = "mean") -> Dict[str, float]:
        """Low-load latency contribution shares (scheduler's pruning order)."""
        shares = {}
        for m, st in self.stages.items():
            tp0 = st.profile.tps()[0]
            rate = 0.05 * st.profile.max_throughput(tp0)
            lm = st.profile.latency(rate, tp0, percentile=percentile)
            shares[m] = lm * st.n / max(st.p, 1.0)
        total = sum(shares.values()) or 1.0
        return {m: v / total for m, v in shares.items()}

    def llms(self) -> List[str]:
        return list(self.stages)


# ---------------------------------------------------------------------------
# Cross-workflow pipeline merging (pooled multi-tenant allocation)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TenantMember:
    """One workflow's view of a shared LLM tenant."""

    workflow: str
    llm: str  # workflow-local stage name
    n: float
    p: float
    profile: LLMProfile
    lam: float  # workflow arrival-rate target (requests/s)

    @property
    def call_rate(self) -> float:
        """Offered call rate this member contributes to the tenant."""
        return self.lam * self.n


class MergedLLMProfile:
    """Rate-weighted mixture of per-workflow profiles of one model.

    Each member workflow profiled the same architecture on its own token
    distribution, so the mixture's capacity is the weighted *harmonic*
    mean of member capacities (a member call consumes 1/T_w replica-
    seconds on average), and latency maps across members at equal
    *utilization*: a replica at mixed load ρ serves member w's calls as
    if that member alone ran it at rate ρ·T_w.  With a single member
    both formulas reduce exactly to the member profile.
    """

    def __init__(self, llm: str, members: List[TenantMember]):
        if not members:
            raise ValueError("merged profile needs >= 1 member")
        self.llm = llm
        self.members = sorted(members, key=lambda m: (m.workflow, m.llm))
        total = sum(m.call_rate for m in self.members)
        if total <= 0:
            # no offered load: weight members equally
            self.phi = [1.0 / len(self.members)] * len(self.members)
        else:
            self.phi = [m.call_rate / total for m in self.members]
        common = set(self.members[0].profile.by_tp)
        for m in self.members[1:]:
            common &= set(m.profile.by_tp)
        if not common:
            raise ValueError(
                f"{llm}: member profiles share no TP degree")
        self.by_tp = {tp: tp for tp in sorted(common)}

    def tps(self, chip_class: Optional[str] = None) -> List[int]:
        return sorted(self.by_tp)

    def classes(self) -> List[str]:
        """Chip classes every member profiled (intersection)."""
        common = set(self.members[0].profile.classes())
        for m in self.members[1:]:
            common &= set(m.profile.classes())
        return sorted(common)

    def max_throughput(self, tp: int, *, fraction: float = 1.0,
                       chip_class: Optional[str] = None) -> float:
        inv = 0.0
        for phi, m in zip(self.phi, self.members):
            t = m.profile.max_throughput(tp, chip_class=chip_class)
            if t <= 0:
                return 0.0
            inv += phi / t
        return fraction / inv if inv > 0 else math.inf

    def member_latency(self, idx: int, rate: float, tp: int, *,
                       fraction: float = 1.0,
                       percentile: str = "mean",
                       chip_class: Optional[str] = None) -> float:
        """Latency of member ``idx``'s calls on a shared replica serving
        the whole mix at per-replica call rate ``rate``."""
        if fraction <= 0:
            return math.inf
        t_mix = self.max_throughput(tp, chip_class=chip_class)
        if not math.isfinite(t_mix) or t_mix <= 0:
            return math.inf
        rho = (rate / fraction) / t_mix
        m = self.members[idx]
        equiv = rho * m.profile.max_throughput(tp, chip_class=chip_class)
        return m.profile.latency(equiv * fraction, tp, fraction=fraction,
                                 percentile=percentile,
                                 chip_class=chip_class)

    def latency(self, rate: float, tp: int, *, fraction: float = 1.0,
                percentile: str = "mean",
                chip_class: Optional[str] = None) -> float:
        return sum(phi * self.member_latency(i, rate, tp, fraction=fraction,
                                             percentile=percentile,
                                             chip_class=chip_class)
                   for i, phi in enumerate(self.phi))


class MergedPipeline(AggregateLLMPipeline):
    """N workflows' pipelines fused into one tenant-tagged pipeline.

    Stages are keyed by canonical model identity; the stage-level
    (n, p) are rate-weighted so that, driven at the fleet arrival rate
    ``lam_total``, every stage sees exactly the sum of its members'
    offered call rates.  ``attribute`` maps a shared allocation back to
    per-workflow predictions.
    """

    def __init__(self, stages: List[PipelineStage],
                 tenants: Dict[str, List[TenantMember]],
                 lam_targets: Dict[str, float]):
        super().__init__("pooled", stages)
        self.tenants = tenants
        self.lam_targets = dict(lam_targets)
        self.lam_total = sum(lam_targets.values())

    def workflows(self) -> List[str]:
        return sorted(self.lam_targets)

    def shared_llms(self) -> Dict[str, List[TenantMember]]:
        """Tenants referenced by more than one workflow."""
        return {m: mem for m, mem in self.tenants.items()
                if len({t.workflow for t in mem}) > 1}

    def members_of(self, workflow: str) -> Dict[str, List[TenantMember]]:
        """Canonical id -> this workflow's member entries (a workflow may
        point several of its stages at the same model)."""
        out: Dict[str, List[TenantMember]] = {}
        for cid, mem in self.tenants.items():
            for t in mem:
                if t.workflow == workflow:
                    out.setdefault(cid, []).append(t)
        return out

    # -- per-workflow attribution ------------------------------------

    def attribute(self, alloc: Dict[str, Allocation],
                  percentile: str = "mean") -> Dict[str, Prediction]:
        """Per-workflow predicted latency/throughput under a shared
        allocation.

        Latency: each member's calls run on replicas loaded by the whole
        mix (utilization-mapped member latency), summed over the
        workflow's stages per eq. (1).  Throughput: the largest factor κ
        by which this workflow alone could scale before some tenant it
        uses saturates — spare tenant capacity is attributed to whoever
        asks for it, not split a priori.
        """
        out: Dict[str, Prediction] = {}
        # per-tenant utilization under the current mix
        rho: Dict[str, float] = {}
        rate: Dict[str, float] = {}
        for cid, mem in self.tenants.items():
            a = alloc[cid]
            prof: MergedLLMProfile = self.stages[cid].profile
            r = sum(t.call_rate for t in mem) / max(a.replicas, 1)
            rate[cid] = r
            cap = prof.max_throughput(a.tp, fraction=a.fraction,
                                      chip_class=a.chip_class)
            rho[cid] = math.inf if cap <= 0 else r / cap
        for w in self.workflows():
            lam_w = self.lam_targets[w]
            members = self.members_of(w)
            total_lat, per_llm = 0.0, {}
            dominant, dom_lat = "", -1.0
            t_w, bottleneck = math.inf, ""
            for cid, ts in members.items():
                a = alloc[cid]
                prof = self.stages[cid].profile
                for t in ts:
                    idx = prof.members.index(t)
                    lm = prof.member_latency(idx, rate[cid], a.tp,
                                             fraction=a.fraction,
                                             percentile=percentile,
                                             chip_class=a.chip_class)
                    contrib = lm * t.n / max(t.p, 1.0)
                    per_llm[t.llm] = contrib
                    total_lat += contrib
                    if contrib > dom_lat:
                        dom_lat, dominant = contrib, t.llm
                    # scaling headroom: κ = 1 + spare / own share of load
                    own = t.call_rate / max(a.replicas, 1)
                    cap = prof.max_throughput(a.tp, fraction=a.fraction,
                                              chip_class=a.chip_class)
                    spare = cap - rate[cid]
                    if own <= 0:
                        cap_w = math.inf
                    else:
                        cap_w = lam_w * (1.0 + spare / own)
                    if cap_w < t_w:
                        t_w, bottleneck = cap_w, t.llm
            feasible = (t_w >= lam_w and math.isfinite(total_lat)
                        and all(rho[cid] <= 1.0 + 1e-9 for cid in members))
            out[w] = Prediction(latency=total_lat, max_throughput=t_w,
                                feasible=feasible, bottleneck_llm=bottleneck,
                                latency_dominant_llm=dominant,
                                per_llm_latency=per_llm)
        return out

    # -- substitution feedback ---------------------------------------

    def with_substitution(self, rates: Dict[str, float]) -> "MergedPipeline":
        """Re-merge with observed just-in-time substitution rates.

        ``rates`` maps a canonical model id to the observed fraction of
        its calls the admission layer rerouted to the model's
        ``ArchConfig.substitute``.  Each affected tenant member's call
        volume is split: ``(1 - r)`` stays on the original tenant and
        ``r`` moves to the substitute tenant (labelled ``<stage>~sub``),
        so share attribution, pooled re-planning and routing-weight
        rebalances all see the real serving mix rather than the planned
        one.  Substitution only targets models already served in the
        fleet; rates for tenants whose substitute has no replicas (no
        stage in this pipeline) are ignored, mirroring the admission
        controller, which never substitutes toward a model with no
        routable replicas.
        """
        tenants: Dict[str, List[TenantMember]] = {
            cid: list(mem) for cid, mem in self.tenants.items()}
        cfgs = {cid: self.stages[cid].cfg for cid in self.stages}
        shares = {cid: self.stages[cid].mean_share for cid in self.stages}
        for cid in sorted(rates):
            r = min(max(rates[cid], 0.0), 1.0)
            if r <= 0 or cid not in self.tenants:
                continue
            sub = cfgs[cid].substitute
            if not sub or sub not in self.stages:
                continue
            sub_prof = self.stages[sub].profile
            moved: List[TenantMember] = []
            kept: List[TenantMember] = []
            for t in self.tenants[cid]:
                kept.append(dataclasses.replace(t, n=t.n * (1.0 - r)))
                moved.append(TenantMember(
                    workflow=t.workflow, llm=t.llm + "~sub",
                    n=t.n * r, p=t.p, profile=sub_prof, lam=t.lam))
            tenants[cid] = kept
            tenants[sub] = tenants.get(sub, []) + moved
        stages: List[PipelineStage] = []
        out_tenants: Dict[str, List[TenantMember]] = {}
        for cid in sorted(tenants):
            mem = sorted([t for t in tenants[cid] if t.n > 0],
                         key=lambda t: (t.workflow, t.llm))
            if not mem:
                continue
            prof = MergedLLMProfile(cid, mem)
            total_rate = sum(t.call_rate for t in mem)
            n_eff = (total_rate / self.lam_total if self.lam_total > 0
                     else sum(t.n for t in mem))
            np_eff = sum((t.lam / self.lam_total if self.lam_total > 0
                          else 1.0 / len(mem))
                         * t.n / max(t.p, 1.0) for t in mem)
            p_eff = n_eff / np_eff if np_eff > 0 else 1.0
            stages.append(PipelineStage(
                llm=cid, cfg=cfgs[cid], n=n_eff, p=p_eff, profile=prof,
                mean_share=shares[cid]))
            out_tenants[cid] = mem
        return MergedPipeline(stages, out_tenants, self.lam_targets)

    def routing_weights(self, alloc: Dict[str, Allocation], *,
                        policy: str = "uniform"
                        ) -> Dict[str, Dict[str, Dict[int, float]]]:
        """workflow -> local llm name -> replica index -> weight.

        Weights per (workflow, llm) sum to 1.  This is the routing table
        deploy_multi hands each workflow instead of a private chip
        offset.

        ``policy="uniform"``: pooled replicas of a tenant are identical,
        so every workflow spreads its calls evenly over all of them.

        ``policy="partition"``: each member owns a contiguous,
        load-proportional *block* of the replica set (member i with
        call-rate share φ_i covers the interval [Σ_{j<i} φ_j·d,
        Σ_{j<=i} φ_j·d) of the d replicas; a replica straddling a block
        boundary is shared pro rata).  Concentrating a workflow on few
        replicas improves KV/prefix affinity and isolates tenants — and
        because the blocks are a pure function of the current rate mix,
        re-deriving them IS the rung-1 drift reaction: re-balance with
        no re-placement.
        """
        if policy not in ("uniform", "partition"):
            raise ValueError(f"unknown routing policy {policy!r}")
        out: Dict[str, Dict[str, Dict[int, float]]] = {}
        for cid, mem in self.tenants.items():
            d = max(alloc[cid].replicas, 1)
            if policy == "uniform":
                for t in mem:
                    out.setdefault(t.workflow, {})[t.llm] = {
                        r: 1.0 / d for r in range(d)}
                continue
            prof: MergedLLMProfile = self.stages[cid].profile
            cursor = 0.0
            for phi, t in zip(prof.phi, prof.members):
                span = phi * d
                lo, hi = cursor, cursor + span
                cursor = hi
                w: Dict[int, float] = {}
                for r in range(d):
                    overlap = min(hi, r + 1) - max(lo, r)
                    if overlap > 1e-12:
                        w[r] = overlap / max(span, 1e-12)
                if not w:  # zero-rate member: park it on its block start
                    w = {min(int(lo), d - 1): 1.0}
                out.setdefault(t.workflow, {})[t.llm] = w
        return out


def merge_pipelines(pipelines: Dict[str, AggregateLLMPipeline],
                    lam_targets: Dict[str, float]) -> MergedPipeline:
    """Fuse N workflows' aggregate pipelines into one tenant-tagged
    pipeline, rate-weighting the shares of LLMs that appear in several
    workflows (keyed by canonical model identity).

    The result is order-invariant in ``pipelines``: tenants are keyed by
    canonical id and members sorted by (workflow, stage name).
    """
    missing = [w for w in pipelines if w not in lam_targets]
    if missing:
        raise ValueError(f"no arrival-rate target for workflows {missing}")
    tenants: Dict[str, List[TenantMember]] = {}
    cfgs: Dict[str, ArchConfig] = {}
    shares: Dict[str, float] = {}
    for w in sorted(pipelines):
        pipe = pipelines[w]
        for llm, st in pipe.stages.items():
            cid = canonical_llm_id(st.cfg)
            tenants.setdefault(cid, []).append(TenantMember(
                workflow=w, llm=llm, n=st.n, p=st.p, profile=st.profile,
                lam=lam_targets[w]))
            cfgs[cid] = st.cfg
            shares[cid] = shares.get(cid, 0.0) + st.mean_share * lam_targets[w]
    lam_total = sum(lam_targets[w] for w in pipelines)
    stages: List[PipelineStage] = []
    for cid in sorted(tenants):
        mem = sorted(tenants[cid], key=lambda t: (t.workflow, t.llm))
        tenants[cid] = mem
        prof = MergedLLMProfile(cid, mem)
        total_rate = sum(t.call_rate for t in mem)
        # n such that lam_total * n == the tenant's total offered call
        # rate; p such that n/p matches the rate-weighted mean latency
        # multiplier of the members (predict()'s contribution weight)
        n_eff = total_rate / lam_total if lam_total > 0 else \
            sum(t.n for t in mem)
        np_eff = sum((t.lam / lam_total if lam_total > 0 else 1.0 / len(mem))
                     * t.n / max(t.p, 1.0) for t in mem)
        p_eff = n_eff / np_eff if np_eff > 0 else 1.0
        stages.append(PipelineStage(
            llm=cid, cfg=cfgs[cid], n=n_eff, p=p_eff, profile=prof,
            mean_share=shares[cid] / (lam_total or 1.0)))
    return MergedPipeline(stages, tenants, lam_targets)
