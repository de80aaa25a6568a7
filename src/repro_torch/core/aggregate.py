"""Statistical workflow aggregation (paper §4 step 2).

For every LLM *m* in a trace set, extract:
  * ``n_m`` — average number of invocations per workflow request;
  * ``p_m`` — average request-level parallelism: busy time divided by the
    union (sweep-line merged) time of m's call intervals within a request;
  * relative execution-time shares — the stability observation (§2.4,
    Fig. 3) that motivates the whole system.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.trace import LLMCall, TraceStore


def merged_busy_time(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length of the union of intervals (sweep-line)."""
    if not intervals:
        return 0.0
    out = 0.0
    cur_s, cur_e = None, None
    for s, e in sorted(intervals):
        if cur_s is None:
            cur_s, cur_e = s, e
        elif s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            out += cur_e - cur_s
            cur_s, cur_e = s, e
    out += cur_e - cur_s
    return out


def request_parallelism(calls: Sequence[LLMCall]) -> float:
    """Average number of concurrently-running calls (busy / union)."""
    busy = sum(c.duration for c in calls)
    union = merged_busy_time([(c.t_start, c.t_end) for c in calls])
    if union <= 0:
        return 1.0
    return max(busy / union, 1.0)


@dataclass
class LLMStats:
    llm: str
    n: float  # avg invocations per workflow request
    p: float  # avg request-level parallelism
    mean_prompt_tokens: float
    mean_output_tokens: float
    mean_share: float  # fraction of per-request total LLM time
    share_cov: float  # coefficient of variation of the share (stability)
    abs_cov: float  # coefficient of variation of absolute time


@dataclass
class WorkflowStats:
    workflow: str
    num_traces: int
    per_llm: Dict[str, LLMStats]
    mean_latency: float
    latency_cov: float

    def latency_ratio_order(self) -> List[str]:
        """LLMs ordered by descending latency contribution (scheduler prune)."""
        return sorted(self.per_llm,
                      key=lambda m: -self.per_llm[m].mean_share)


def _cov(xs: List[float]) -> float:
    if len(xs) < 2:
        return 0.0
    mu = sum(xs) / len(xs)
    if mu == 0:
        return 0.0
    var = sum((x - mu) ** 2 for x in xs) / (len(xs) - 1)
    return math.sqrt(var) / mu


def aggregate(store: TraceStore) -> WorkflowStats:
    llms = store.llms()
    per_llm: Dict[str, LLMStats] = {}
    latencies = [t.latency for t in store.traces]
    ntr = len(store.traces)

    for m in llms:
        counts, paras, shares, abs_times = [], [], [], []
        prompts, outs = [], []
        for tr in store.traces:
            calls = tr.calls_for(m)
            counts.append(len(calls))
            if calls:
                paras.append(request_parallelism(calls))
                total_m = sum(c.duration for c in calls)
                total_all = sum(c.duration for c in tr.calls)
                abs_times.append(total_m)
                if total_all > 0:
                    shares.append(total_m / total_all)
                prompts.extend(c.prompt_tokens for c in calls)
                outs.extend(c.output_tokens for c in calls)
        per_llm[m] = LLMStats(
            llm=m,
            n=sum(counts) / max(ntr, 1),
            p=sum(paras) / max(len(paras), 1) if paras else 1.0,
            mean_prompt_tokens=sum(prompts) / max(len(prompts), 1),
            mean_output_tokens=sum(outs) / max(len(outs), 1),
            mean_share=sum(shares) / max(len(shares), 1) if shares else 0.0,
            share_cov=_cov(shares),
            abs_cov=_cov(abs_times),
        )
    return WorkflowStats(
        workflow=store.workflow,
        num_traces=ntr,
        per_llm=per_llm,
        mean_latency=sum(latencies) / max(ntr, 1),
        latency_cov=_cov(latencies),
    )
