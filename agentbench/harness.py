"""One run of one cell: build the model and the engine, drive closed-loop
clients through ``ServingEngine.submit`` and ``ServingEngine.step`` for
exactly the window's seconds, read the metrics, and check the served
tokens against the plain reference.

Set-up builds the configuration's model in bf16 with weights drawn on the
device from the seed (``weights.py``), one ``ServingEngine`` with the
configuration's deployment, and runs the cell's own traffic for a fixed
number of engine steps (the mix's ``warmup_steps``): every kernel library
is loaded (built under ``build/`` on a checkout's first run) and the
allocator holds its working set before the window opens.  The clients go
on from there into the window.

A traced run (``--trace 1``) also wraps the model's ``prefill`` and
``decode_step`` (CUDA events around each call, which ends in a
synchronisation), times each engine step, and runs ``torch.profiler`` over
a few seconds in the middle of the window.  Its spans are this file's
own, around the calls into each layer.
"""
from __future__ import annotations

import bisect
import contextlib
import gc
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from agentbench import cells, correct
from agentbench.metrics import reader
from agentbench.traffic import Send, Tool, Workflows, load_mix
from agentbench.weights import load_into, make

clock = time.perf_counter

# the profiled stretch of a traced run: from this share of the window,
# for this share of it, at most PROFILE_S seconds
PROFILE_AT, PROFILE_SHARE, PROFILE_S = 0.4, 0.3, 4.0
SPAN = "ab."  # the harness's own spans in a trace


@dataclass
class Call:
    """One LLM call: the engine's request and its times."""

    req: object
    client: "Client"
    send_t: float
    first_t: Optional[float] = None
    done_t: Optional[float] = None
    seen: int = 0  # served tokens counted so far

    @property
    def req_id(self) -> int:
        return self.req.req_id

    @property
    def prompt(self) -> np.ndarray:
        return self.req.prompt

    @property
    def served(self) -> List[int]:
        return self.req.generated


class Client:
    """One workflow in flight: its generator, the group of calls it waits
    for, or the time its tool step ends."""

    def __init__(self, gen):
        self.gen = gen
        self.group: List[Call] = []
        self.due: Optional[float] = None


class Timer:
    """A model call's ms: CUDA events on the card (the call ends in a
    synchronisation), the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if not self.cuda:
            return clock()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def stop(self, start) -> float:
        if not self.cuda:
            return 1e3 * (clock() - start)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)


def span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(SPAN + name)


class Run:
    """The clients, the engine, and what a run records."""

    def __init__(self, engine, workflows: Workflows, clients: int, trace: bool,
                 device: torch.device, stagger_steps: int):
        from repro_torch.serving.engine import ServeRequest

        self.ServeRequest = ServeRequest
        self.engine = engine
        self.workflows = workflows
        self.trace = trace
        self.device = device
        self.next_id = 0
        self.inflight: Dict[int, Call] = {}
        self.finished: List[Call] = []
        self.sent: List[Call] = []
        self.steps = 0
        self.counting = False
        self.tokens = 0
        self.model_s = 0.0
        self.profiling = False
        self.record = {"steps": [], "calls": [], "profile": None}
        # client i starts its first workflow at engine step i * stagger /
        # clients, so that the clients' workflows do not move in step
        self.clients: List[Client] = []
        self.starts = [i * stagger_steps // clients for i in range(clients)]
        self.start_due()

    def start_due(self) -> None:
        while (len(self.clients) < len(self.starts)
               and self.starts[len(self.clients)] <= self.steps):
            client = Client(self.workflows.start())
            self.clients.append(client)
            self.advance(client, None)

    # -- clients --
    def submit(self, client: Client, send: Send) -> Call:
        req = self.ServeRequest(self.next_id, send.prompt, max_new_tokens=send.max_new_tokens)
        self.next_id += 1
        call = Call(req, client, clock())
        self.engine.submit(req)
        self.inflight[req.req_id] = call
        self.sent.append(call)
        return call

    def advance(self, client: Client, value) -> None:
        """Hand ``value`` to the client's workflow and act on what it
        yields next; a workflow that ends is followed by the next."""
        while True:
            try:
                item = client.gen.send(value)
            except StopIteration:
                client.gen, value = self.workflows.start(), None
                continue
            if isinstance(item, Tool):
                client.due = clock() + item.seconds
            else:
                client.group = [self.submit(client, s) for s in item]
            return

    # -- the loop --
    def tick(self) -> None:
        """Release the clients whose tool step ended, then one engine step,
        or a wait for the next tool step where the engine has no work."""
        self.start_due()
        now = clock()
        for c in self.clients:
            if c.due is not None and c.due <= now:
                c.due = None
                self.advance(c, None)
        eng = self.engine
        if not eng.waiting and not eng.active:
            dues = [c.due for c in self.clients if c.due is not None]
            if len(self.clients) < len(self.starts):
                # nothing to step: the next client starts now
                self.starts[len(self.clients)] = self.steps
                return
            if not dues:
                raise RuntimeError("every client waits on a call the engine does not hold")
            with span("client.wait", self.profiling):
                time.sleep(min(max(min(dues) - clock(), 0.0), 0.05))
            return
        self.model_s = 0.0
        t = clock()
        with span("engine.step", self.profiling):
            completed = eng.step()
        now = clock()
        self.steps += 1
        if self.trace:
            self.record["steps"].append({"s": now - t, "model_s": self.model_s,
                                         "in_profile": self.profiling})
        for call in list(self.inflight.values()):
            n = len(call.req.generated)
            if self.counting:
                self.tokens += n - call.seen
            call.seen = n
            if call.first_t is None and n > 0:
                call.first_t = now
        for req in completed:
            call = self.inflight.pop(req.req_id)
            call.done_t = now
            self.finished.append(call)
            group = call.client.group
            if all(c.done_t is not None for c in group):
                call.client.group = []
                self.advance(call.client, [list(c.req.generated) for c in group])

    # -- the traced run's wrappers and profiler --
    def wrap_model(self, model) -> None:
        """Time the model's prefill and decode_step (instance attributes
        that shadow the class's methods); each call ends in a
        synchronisation, so its time holds its device work."""
        timer = Timer(self.device)
        prefill, decode_step = model.prefill, model.decode_step
        slots = self.engine.slots

        def timed(kind, fn, *args, **extra):
            t = clock()
            with span("model." + kind, self.profiling):
                start = timer.start()
                out = fn(*args)
                ms = timer.stop(start)
            self.model_s += clock() - t
            self.record["calls"].append({"kind": kind, "ms": ms,
                                         "in_profile": self.profiling, **extra})
            return out

        def timed_prefill(tokens, *args):
            return timed("prefill", prefill, tokens, *args, S=int(tokens.shape[-1]))

        def timed_decode(cache, tokens, pos):
            lengths = [int(p) + 1 if int(p) >= 0 else 0
                       for p in np.asarray(pos).reshape(-1)]
            kind = "suffix" if len(lengths) == 1 and slots > 1 else "decode"
            return timed(kind, decode_step, cache, tokens, pos, rows=len(lengths),
                         lengths=lengths)

        model.prefill, model.decode_step = timed_prefill, timed_decode

    def start_profile(self) -> None:
        from repro_torch.kernels import common
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.launch0 = dict(common.launch_counts)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.prof_t0 = clock()
        self.profiling = True

    def stop_profile(self) -> None:
        from repro_torch.kernels import common

        torch.cuda.synchronize()
        window_s = clock() - self.prof_t0
        self.prof.__exit__(None, None, None)
        self.profiling = False
        launches = {k: common.launch_counts[k] - self.launch0.get(k, 0)
                    for k in common.launch_counts}
        self.record["profile"] = reduce_profile(self.prof, window_s, launches)
        del self.prof

    def run_steps(self, steps: int) -> None:
        while self.steps < steps:
            self.tick()

    def run_window(self, seconds: float) -> tuple:
        self.counting = True
        t0 = clock()
        prof_at = t0 + PROFILE_AT * seconds
        prof_s = min(PROFILE_S, PROFILE_SHARE * seconds)
        end = t0 + seconds
        profiled = False
        while clock() < end:
            if self.trace and self.device.type == "cuda":
                now = clock()
                if not profiled and not self.profiling and now >= prof_at:
                    self.start_profile()
                elif self.profiling and now >= self.prof_t0 + prof_s:
                    self.stop_profile()
                    profiled = True
            self.tick()
        if self.profiling:
            self.stop_profile()
        self.counting = False
        return t0, clock()


HOST_SPANS = {"engine.step": "engine self", "model.prefill": "model prefill",
              "model.decode": "model decode", "model.suffix": "model suffix decode",
              "client.wait": "client/tool wait"}


def _events(prof):
    """(start ns, end ns, name, on the device) of every traced event, read
    from the profiler's raw results (building its Python event tree takes
    far longer)."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        yield start, start + e.duration_ns(), e.name(), e.device_type() == DeviceType.CUDA


def reduce_profile(prof, window_s: float, launches: dict) -> dict:
    """The profiled stretch: device time by kernel, the union of the device
    intervals, and the idle gaps between them by the harness span the host
    was in (the innermost one; "client" outside every span)."""
    dev, spans = [], []
    for s, e, name, on_device in _events(prof):
        if name.startswith(SPAN):
            if not on_device:
                spans.append((s, e, name[len(SPAN):]))
        elif on_device:
            dev.append((s, e, name))
    kernels: Dict[str, float] = {}
    for s, e, name in dev:
        kernels[name] = kernels.get(name, 0.0) + (e - s) * 1e-9
    merged = []
    for s, e, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-9
    idle: Dict[str, float] = {}
    spans.sort()
    starts = [sp[0] for sp in spans]
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        # the innermost span holding the gap's middle: the latest started
        # of those that have not ended by then
        inside = [sp for sp in spans[:bisect.bisect_right(starts, mid)] if sp[1] >= mid]
        who = HOST_SPANS.get(inside[-1][2], inside[-1][2]) if inside else "client"
        idle[who] = idle.get(who, 0.0) + (b - a) * 1e-9
    if busy > window_s:
        # the profiler starts after a synchronisation and stops after one:
        # device intervals that outlast the stretch mean a wrong trace or
        # a wrong window, and no idle share can be read from them
        print(f"profile: device busy {busy} s in a stretch of {window_s} s",
              file=sys.stderr)
        raise ValueError("device intervals outlast the profiled stretch")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": window_s, "busy_s": busy, "kernels": kernels,
            "launches": launches,
            "device_ops": [[n[:120], t] for n, t in top],
            "idle_gaps": sorted(([n, t] for n, t in idle.items()), key=lambda x: -x[1])[:10]}


def served_ok(call: Call, vocab: int, max_len: int) -> bool:
    """Every served token a real id, and as many as asked for, or fewer
    only where the slot's positions ran out."""
    n = len(call.served)
    full = n == call.req.max_new_tokens or len(call.prompt) + n >= max_len - 1
    return full and all(0 <= t < vocab for t in call.served)


def free_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float, *,
             device: str = "cuda", bench: Optional[dict] = None,
             config: Optional[dict] = None, mix: Optional[dict] = None,
             limits: Optional[dict] = None, patch: Optional[Callable] = None,
             control: bool = False) -> dict:
    """One run of cell ``name``; returns the result line's object.  The
    keyword arguments other than ``device`` stand in for the files that
    ``BENCHMARK.json`` names (the tests run tiny cells on the CPU);
    ``patch(model, engine)``, where given, runs before the warm-up.  With
    ``control`` the result also holds every reading of the comparison and
    the control's on the same sample (``control.py``; the benchmark's runs
    never take it)."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.zoo import build_model
    from repro_torch.serving.engine import ServingEngine

    bench = bench or cells.benchmark()
    cell = cells.cell(name, bench)
    config = config or cells.config(cell["config"])
    mix = mix or load_mix(cell["traffic"])
    limits = limits or cells.limits(name)
    dev = torch.device(device)
    m, dep = config["model"], config["deployment"]
    ref = correct.reference(config)
    leaves = ref.leaves(m)

    stages = {"imports": clock() - t_start}
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
        stages["CUDA context"] = clock() - t_start - sum(stages.values())
    model = build_model(ArchConfig(**m), device=dev, dtype=getattr(torch, dep["dtype"]))
    load_into(model, make(leaves, seed, dev))
    free_memory()
    stages["model and weights"] = clock() - t_start - sum(stages.values())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(model, device=dev, slots=dep["slots"], max_len=dep["max_len"],
                           prefix_caching=dep["prefix_caching"])
    if patch is not None:
        patch(model, engine)
    run = Run(engine, Workflows(mix, seed, m["vocab_size"]), mix["clients"], trace, dev,
              stagger_steps=mix["warmup_steps"] // 2)
    stages["engine"] = clock() - t_start - sum(stages.values())
    run.run_steps(mix["warmup_steps"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    stages["warm-up steps"] = clock() - t_start - sum(stages.values())
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()),
          file=sys.stderr)
    if trace:
        run.wrap_model(model)
    setup_s = clock() - t_start
    stats0 = dict(engine.stats)
    t0, t1 = run.run_window(seconds)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    in_window = lambda t: t is not None and t0 <= t <= t1  # noqa: E731
    finished = [c for c in run.finished if in_window(c.done_t)]
    record = dict(run.record, model=m, slots=dep["slots"], setup_s=setup_s,
                  dtype_bytes=torch.finfo(getattr(torch, dep["dtype"])).bits // 8,
                  engine_stats={k: v - stats0[k] for k, v in engine.stats.items()}, window={
        "seconds": t1 - t0, "tokens": run.tokens,
        "ttft_s": [c.first_t - c.send_t for c in run.sent if in_window(c.first_t)],
        "tpot_s": [(c.done_t - c.first_t) / (len(c.served) - 1)
                   for c in finished if len(c.served) > 1]})
    attempted = sum(1 for c in run.sent if in_window(c.send_t))
    failed = sum(1 for c in finished if not served_ok(c, m["vocab_size"], dep["max_len"]))
    units = {e["name"]: e["unit"] for e in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    for metric in cells.metric_names(bench, name, trace):
        value = reader(metric)(record)
        if value is not None:
            metrics[metric] = {"value": value, "unit": units[metric]}

    sample = correct.sample(finished, seed, limits["min_tokens"], limits["max_calls"])
    # the program's state goes before the reference runs
    del run, engine, model
    free_memory()
    scores = correct.score(sample, config, make(leaves, seed, dev), dev, control=control)
    free_memory()
    # every number the cell's limits name, each at most its limit
    checks = {k: {"value": scores[k], "limit": v} for k, v in limits["numbers"].items()}
    checks["tokens_compared"] = {"value": scores["tokens_compared"],
                                 "limit": limits["min_tokens"]}
    checks["failed_calls"] = {"value": failed, "limit": 0}
    ok = (bool(sample) and failed == 0
          and scores["tokens_compared"] >= limits["min_tokens"]
          and all(scores[k] is not None and scores[k] <= v
                  for k, v in limits["numbers"].items()))
    result = {"correct": ok, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info(dev, peak, record["profile"])}
    if control:
        result["control"] = scores
    if record["profile"]:
        result["breakdown"] = {k: record["profile"][k] for k in ("device_ops", "idle_gaps")}
    result["checks"] = checks
    return result


def device_info(dev: torch.device, peak: int, profile: Optional[dict]) -> dict:
    if dev.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": peak}
    if profile:
        info["busy_s"] = profile["busy_s"]
        info["window_s"] = profile["window_s"]
    return info
