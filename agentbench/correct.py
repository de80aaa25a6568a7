"""Whether the timed path served the right tokens.

After the window, a sample drawn from the seed of the calls finished in it
(the longest among them, then others until ``min_tokens`` served tokens)
is scored by the plain reference: one pass over each prompt and the
tokens served after it, on weights drawn again from the seed.  A served
token's gap is how far its reference logit lies below the reference's
best at that position.  A cell compares the widest gap or the mean gap
(``limits/<cell>.json`` names it).  Greedy
decoding puts the program's best first, so the gap is its rounding's
reach into the reference's ranking, and a wrong token reads as the
spread of the logits.

The control (``control.py``) puts the reference, in fp8, in the
program's place: at each position the token the fp8 pass ranks first,
and its gap in the f32 pass.
"""
from __future__ import annotations

import importlib
import random
from typing import Dict, List

import torch


def sample(calls: list, seed: int, min_tokens: int, max_calls: int) -> list:
    """The longest finished call (prompt and served tokens), then others in
    the seed's order until ``min_tokens`` served tokens or ``max_calls``."""
    if not calls:
        return []
    calls = sorted(calls, key=lambda c: c.req_id)
    longest = max(calls, key=lambda c: (len(c.prompt) + len(c.served), -c.req_id))
    rest = [c for c in calls if c is not longest]
    random.Random(seed).shuffle(rest)
    out, served = [longest], len(longest.served)
    for c in rest:
        if served >= min_tokens or len(out) >= max_calls:
            break
        out.append(c)
        served += len(c.served)
    return out


def sequences(calls: list, device) -> list:
    """(prompt and served tokens but the last, prompt length) per call."""
    return [(torch.as_tensor(list(c.prompt) + list(c.served[:-1]), dtype=torch.long,
                             device=device), len(c.prompt)) for c in calls]


def gaps(ref_logits: torch.Tensor, picked: torch.Tensor) -> torch.Tensor:
    """Per position, the best reference logit less the picked token's."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, picked[:, None])[:, 0]


def reference(config: dict):
    return importlib.import_module(f"agentbench.reference.{config['reference']}")


def score(calls: list, config: dict, weights: Dict[str, torch.Tensor], device,
          control: bool = False) -> Dict[str, float]:
    """The numbers of ``summary`` over the served tokens of ``calls`` in
    the f32 reference, and with ``control`` the same of the fp8 pass's
    first choices over the same positions, and per call (in the sample's
    order) its tokens, and the sum and the widest of its gaps on either
    side."""
    from agentbench.reference.common import no_tf32

    if not calls:
        return {"logit_gap": None, "mean_gap": None, "miss_share": None,
                "tokens_compared": 0.0, "calls_compared": 0.0}
    no_tf32()
    ref = reference(config)
    m = config["model"]
    seqs = sequences(calls, device)
    f32 = ref.logits(weights, m, seqs, "f32")
    served = [torch.as_tensor(list(c.served), dtype=torch.long, device=device) for c in calls]
    program = [gaps(l, s) for l, s in zip(f32, served)]
    out = {"tokens_compared": float(sum(len(s) for s in served)),
           "calls_compared": float(len(calls)), **summary(torch.cat(program))}
    if control:
        low = ref.logits(weights, m, seqs, "fp8")
        picked = [gaps(l, c.argmax(-1)) for l, c in zip(f32, low)]
        out.update({"control_" + k: v for k, v in summary(torch.cat(picked)).items()})
        out["per_call"] = [[len(g), float(g.sum()), float(g.max()), float(c.sum()),
                            float(c.max())] for g, c in zip(program, picked)]
    return out


def summary(g: torch.Tensor) -> Dict[str, float]:
    """The numbers a cell may compare: the widest gap, the mean gap, and
    the share of served tokens that are not the reference's first choice
    (a gap above the reference's own f32 rounding of 1e-3)."""
    return {"logit_gap": float(g.max()), "mean_gap": float(g.mean()),
            "miss_share": float((g > 1e-3).float().mean())}
