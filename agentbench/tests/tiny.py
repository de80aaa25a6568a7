"""Tiny cells for the CPU tests: the cells' own files with every size cut,
so that a run on the CPU takes seconds.  The program runs its kernels'
plain versions there."""
import copy
import time

from agentbench import cells, harness
from agentbench.traffic import load_mix

SIZES = {
    "olmoe-1b-7b.mapreduce": (
        {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "head_dim": 16,
         "d_ff": 32, "vocab_size": 512, "num_experts": 8, "experts_per_token": 2},
        {"slots": 4, "max_len": 512},
        {"chunk_tokens": 24, "chunk_extra": {"exp": 6}, "doc_tokens": {"lognormal": [4.2, 0.4]},
         "map_out": {"base": 32, "exp": 4}, "partial_tokens": 8, "reduce_extra": 4,
         "root_out": {"base": 32, "exp": 4}}, 2),
    "rwkv6-7b.agent": (
        {"num_layers": 2, "d_model": 128, "num_heads": 2, "num_kv_heads": 2, "head_dim": 64,
         "d_ff": 256, "vocab_size": 512},
        {"slots": 4, "max_len": 4096},
        {"context_tokens": {"base": 8, "lognormal": [2.0, 0.3]}, "action_out": {"base": 4, "exp": 4},
         "observation_tokens": {"base": 3, "exp": 10}, "summarize_over": 12,
         "summary_out": {"base": 3, "exp": 3}, "answer_out": {"base": 4, "exp": 4}}, 4),
}


TINY_LIMITS = {"mean_gap": 0.03, "logit_gap": 1.0}


def files(cell: str):
    """(config, mix, limits) of ``cell`` with the tiny sizes."""
    bench = cells.benchmark()
    entry = cells.cell(cell, bench)
    model, deployment, params, clients = SIZES[cell]
    config = copy.deepcopy(cells.config(entry["config"]))
    config["model"].update(model)
    config["deployment"].update(deployment)
    mix = load_mix(entry["traffic"])
    mix["params"].update(params)
    mix.update(clients=clients, warmup_steps=6)
    # the cell's number, at a limit for tiny models: their rounding reads
    # up to ~0.007 (mean gap) and ~0.5 (widest), a planted fault 0.06 to 6
    (number,) = cells.limits(cell)["numbers"]
    limits = {"numbers": {number: TINY_LIMITS[number]}, "min_tokens": 60, "max_calls": 30}
    return config, mix, limits


def run(cell: str, seed: int, seconds: float = 3.0, trace: bool = False, **kw) -> dict:
    config, mix, limits = files(cell)
    limits = kw.pop("limits", limits)
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                            config=config, mix=mix, limits=limits, **kw)
