"""Traffic: closed-loop clients that run agentic workflow programs.

A mix is a data file ``agentbench/traffic/<mix>.json``:

    {"program": "<file in this folder>", "clients": 8, "pool": 512,
     "shape_seed": 0, "warmup_steps": 60, "params": {...}}

``program`` names a module here whose ``program(params, rng, tokens)`` is a
generator.  It yields a list of ``Send`` (one group of LLM calls, sent
together) and receives, for each, the tokens served; or a ``Tool`` (a wait
of that many seconds).  Every size a program draws comes from ``rng``;
every token id from ``tokens(n)``.

``clients`` workflows are in flight at once; when one ends its client
starts the next.  The sizes of workflow i are drawn from
``random.Random(shape_seed * 1_000_003 + i)``, and the clients start them
in the order i = 0, 1, 2, ... (after ``pool`` it wraps around): every seed
runs the same sizes in the same order, and the run's seed draws their
token ids (and the model's weights).  In a closed loop the order of the
sizes changes the work of a window: runs that shuffled them by the seed
spread 13% in tokens/s, where runs of one seed spread 0.3%.  ``params`` holds every number a program uses: a number, or a
distribution ``{"base": b, "exp": mean}`` (b plus an exponential draw),
``{"base": b, "lognormal": [mu, sigma]}``, each rounded down.
"""
from __future__ import annotations

import importlib
import json
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np

HERE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Send:
    """One LLM call: its prompt's token ids and the tokens it asks for."""

    prompt: np.ndarray
    max_new_tokens: int


@dataclass(frozen=True)
class Tool:
    """A non-LLM step that takes ``seconds``."""

    seconds: float


def draw(spec, rng: random.Random) -> float:
    """A number, or a draw of the distribution ``spec`` (module docstring)."""
    if isinstance(spec, (int, float)):
        return spec
    value = float(spec.get("base", 0))
    if "exp" in spec:
        value += rng.expovariate(1.0 / spec["exp"])
    if "lognormal" in spec:
        mu, sigma = spec["lognormal"]
        value += rng.lognormvariate(mu, sigma)
    return value


def idraw(spec, rng: random.Random) -> int:
    return int(draw(spec, rng))


def load_mix(name: str) -> dict:
    path = HERE / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def program_of(mix: dict) -> Callable:
    return importlib.import_module(f"agentbench.traffic.{mix['program']}").program


class Workflows:
    """The pool's workflows in order, each a fresh generator whose token
    ids the seed draws."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.program = program_of(mix)
        self.vocab = vocab
        self.seed = seed
        self.next = 0

    def start(self):
        """The next workflow's generator (the pool wraps around)."""
        i = self.next % self.mix["pool"]
        self.next += 1
        rng = random.Random(self.mix["shape_seed"] * 1_000_003 + i)
        ids = np.random.default_rng([self.seed % (1 << 63), i])

        def tokens(n: int) -> np.ndarray:
            return ids.integers(0, self.vocab, size=int(n), dtype=np.int64)

        return self.program(self.mix["params"], rng, tokens)
