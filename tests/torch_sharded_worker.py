"""The ranks of the sharded runs of ``tests/test_torch_sharding.py``,
``tests/test_torch_sharding_families.py``, ``tests/test_torch_sharding_heads.py``,
``tests/test_torch_dryrun.py`` and ``tests/test_torch_checkpoint_sharded.py``:
processes of one gloo group on the CPU that run a sharded model of any
family ``shard_model`` takes on every case and return numpy results.  It
imports no JAX: the parent bridges the reference's weights and hands them
over as numpy arrays.

Each case is a dict: ``key``, ``mesh`` ((data, model), or (pod, data,
model)), ``cfg``, ``params`` (the reference's tree with numpy leaves) or
``seed`` (the port's seeded weights), ``batch`` (tokens and labels, and
the VLM's ``image_embeds`` or the enc-dec's ``audio_frames``), ``prompts``
(B, S) and ``decode`` (steps, B) tokens, ``prompt_inputs`` (the prompts'
image or audio input, where the family takes one) and ``requests`` (the
engine's prompts; the VLM and the enc-dec ``generate`` from the prompts
instead, and an encoder has no decode).  With ``slice_backward`` the
query columns' gather keeps only this rank's slice of its gradient (a
mutation that a head split must fail).  ``run_case`` computes the same
results for an unsharded model when it is given no mesh.  A weight comes
back at its unsharded shape (a paired-halves weight's (d, 2, h) view as
its (d, 2h)).  A case with ``ckpt`` runs ``checkpoint_case`` instead:
train steps that save a checkpoint, a resume from it and a restore of
another run's; a case with ``serve`` runs ``serve_case``: the serving
half alone, at the case's own cache and engine lengths.
"""
from __future__ import annotations

import numpy as np
import torch

OPT = dict(lr=1e-3, warmup_steps=2)
STEPS = 3
MICROBATCHES = 2
CACHE_LEN = 32
MAX_NEW = 6


def _full(t, shape=None) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    t = t.detach().float()
    return (t if shape is None else t.reshape(shape)).numpy().copy()


def _slice_only(ctx, grad):
    """The gather's backward as a plain slice: this rank's own columns of
    its gradient, with no other rank's part."""
    import torch.distributed as dist

    rank = dist.get_group_rank(ctx.group, dist.get_rank())
    return grad.chunk(ctx.ways, dim=-1)[rank].contiguous(), None, None


def _model(case, mesh):
    from repro_torch.bridge import load_reference_params
    from repro_torch.distributed.sharding import shard_model
    from repro_torch.models import build_model

    model = build_model(case["cfg"], device="cpu", dtype=torch.float32)
    if "params" in case:
        load_reference_params(model, case["params"])
    else:
        model.init_params(torch.Generator().manual_seed(case["seed"]))
    return model if mesh is None else shard_model(model, mesh)


def start_weights(case) -> dict:
    """The case's weights by the port's names, before any step."""
    return {n: _full(p) for n, p in _model(case, None).named_parameters()}


def run_case(case, mesh=None) -> dict:
    """Loss and gradients, STEPS train steps, prefill and decode logits and
    the engine's tokens of one case, on ``mesh`` or unsharded."""
    from repro_torch.distributed.sharding import (data_mean, data_rows,
                                                  reduce_gradients)
    from repro_torch.serving.engine import (ServeRequest, ServingEngine,
                                            _merge_slot)
    from repro_torch.training.optimizer import AdamWConfig, init_state
    from repro_torch.training.train_loop import make_train_step

    from repro_torch.distributed import sharding

    if case.get("slice_backward"):
        saved = sharding._GatherHeads.backward
        sharding._GatherHeads.backward = staticmethod(_slice_only)
        try:
            return run_case(dict(case, slice_backward=False), mesh)
        finally:
            sharding._GatherHeads.backward = saved
    out = {}
    batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
    shapes = {n: tuple(p.shape) for n, p in _model(case, None).named_parameters()}

    # one loss and backward, each data rank on its own rows
    model = _model(case, mesh)
    model.requires_grad_(True)
    rows = batch if mesh is None else {k: data_rows(v, mesh) for k, v in batch.items()}
    loss = model.forward_loss(**rows)
    loss.backward()
    if mesh is not None:
        reduce_gradients(model.parameters())
        loss = data_mean(loss, mesh)
    out["loss"] = float(loss.detach())
    out["grads"] = {n: _full(p.grad, shapes[n]) for n, p in model.named_parameters()}

    # STEPS train steps in MICROBATCHES microbatches
    model = _model(case, mesh)
    params = dict(model.named_parameters())
    step = make_train_step(model, AdamWConfig(**OPT), num_microbatches=MICROBATCHES)
    state = init_state(params)
    out["losses"] = []
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        out["losses"].append(float(metrics["loss"]))
    out["weights"] = {n: _full(p, shapes[n]) for n, p in params.items()}
    out["m"] = {n: _full(t, shapes[n]) for n, t in state.m.items()}
    out["v"] = {n: _full(t, shapes[n]) for n, t in state.v.items()}
    out["numel"] = {n: (p.to_local().numel() if mesh is not None else p.numel(),
                        state.m[n].to_local().numel() if mesh is not None
                        else state.m[n].numel()) for n, p in params.items()}

    # a prefill of the prompts, then decode steps over a longer cache
    model = _model(case, mesh)
    prompts = torch.as_tensor(case["prompts"])
    extra = {n: torch.as_tensor(a) for n, a in case.get("prompt_inputs", {}).items()}
    routes = _recording_routes() if model.cfg.is_moe else None
    try:
        logits, small = model.prefill(prompts, **extra)
        if model.cfg.family == "encoder":  # the pooled embedding; no cache
            out["serve_logits"] = logits.float().numpy()
            return out
        cache = model.init_cache(prompts.shape[0], CACHE_LEN)
        for b in range(prompts.shape[0]):
            _merge_slot(cache, _rows(small, b), b)
        seq = [logits]
        for i, tokens in enumerate(case["decode"]):
            logits, cache = model.decode_step(cache, tokens, prompts.shape[1] + i)
            seq.append(logits)
    finally:
        if routes is not None:
            out["routes"] = routes()
    out["serve_logits"] = torch.stack(seq).float().numpy()
    out["cache_heads"] = cache[0].shape[2] if isinstance(cache, tuple) else None
    out["cache_shapes"] = {name: tuple(leaf.shape) for name, leaf in _leaves(cache)}

    if model.cfg.family in ("vlm", "audio"):
        from repro_torch.launch.serve_model import generate

        (inputs,) = extra.values()
        generated, _ = generate(model, prompts, inputs, MAX_NEW)
        out["tokens"] = {b: row.tolist() for b, row in enumerate(generated)}
        return out
    engine = ServingEngine(model, device="cpu", slots=len(case["requests"]),
                           max_len=CACHE_LEN)
    for i, prompt in enumerate(case["requests"]):
        engine.submit(ServeRequest(i, prompt, max_new_tokens=MAX_NEW))
    out["tokens"] = {r.req_id: list(r.generated) for r in engine.run_to_completion()}
    return out


def serve_case(case, mesh=None) -> dict:
    """A prefill of the prompts, decode steps over a cache of
    ``serve["cache_len"]`` positions (``decode_pos``: each step's position
    per row, negative for an idle row), the cache's shapes and its block
    of positions, and the engine's tokens and cached prefix lengths over
    ``serve["slots"]`` slots of ``serve["max_len"]`` positions, on
    ``mesh`` or unsharded.  Of a hymba cache also its blocks of the full
    layers' positions and of the rings' indices (``HymbaCache.blocks``),
    and of every cache its leaves after the last step."""
    from repro_torch.serving.engine import ServeRequest, ServingEngine, _merge_slot

    serve = case["serve"]
    model = _model(case, mesh)
    prompts = torch.as_tensor(case["prompts"])
    logits, small = model.prefill(prompts)
    cache = model.init_cache(prompts.shape[0], serve["cache_len"])
    for b in range(prompts.shape[0]):
        _merge_slot(cache, _rows(small, b), b)
    seq = [logits]
    for tokens, pos in zip(case["decode"], serve["decode_pos"]):
        logits, cache = model.decode_step(cache, tokens, pos)
        seq.append(logits)
    def span(block):
        return None if block is None else (block.start, block.chunk)

    out = {"serve_logits": torch.stack(seq).float().numpy(),
           "cache_shapes": {name: tuple(leaf.shape) for name, leaf in _leaves(cache)},
           "block": span(getattr(cache, "seq", None)),
           "blocks": {kind: span(b) for kind, b in getattr(cache, "blocks", {}).items()},
           "leaves": {name: leaf.float().numpy().copy() for name, leaf in _leaves(cache)}}
    engine = ServingEngine(model, device="cpu", slots=serve["slots"],
                           max_len=serve["max_len"])
    for i, prompt in enumerate(case["requests"]):
        engine.submit(ServeRequest(i, prompt, max_new_tokens=MAX_NEW))
    done = engine.run_to_completion()
    out["tokens"] = {r.req_id: list(r.generated) for r in done}
    out["cached_tokens"] = {r.req_id: r.cached_tokens for r in done}
    return out


CKPT_AT = 2  # the step after which a checkpoint case saves


def _state(model, state, shapes) -> dict:
    """Every weight and moment at its unsharded shape, and the step, by the
    checkpoint's keys, as numpy."""
    out = {f"param/{n}": _full(p, shapes[n]) for n, p in model.named_parameters()}
    out.update({f"m/{n}": _full(t, shapes[n]) for n, t in state.m.items()})
    out.update({f"v/{n}": _full(t, shapes[n]) for n, t in state.v.items()})
    out["step"] = state.step.numpy().copy()
    return out


def checkpoint_case(case, mesh=None) -> dict:
    """The checkpoint round trips of one case, on ``mesh`` or unsharded
    (``case["ckpt"]``: ``save``, the directory this run saves to, and
    ``restore``, the other kind's checkpoint directory, each optional).

    ``run``: the model from ``seed``, CKPT_AT + STEPS train steps with a
    checkpoint into ``save`` after CKPT_AT of them: its losses and final
    state.
    ``resumed``: a model from ``seed + 1`` restores ``save`` and takes the
    remaining steps.  With ``restore``, ``crossed``: a model from ``seed +
    1`` restores that directory (its state right after the restore, then
    its remaining steps)."""
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import AdamWConfig, init_state
    from repro_torch.training.train_loop import make_train_step

    batch = case["batch"]
    shapes = {n: tuple(p.shape) for n, p in _model(case, None).named_parameters()}

    def steps(seed, save=None, restore=None):
        model = _model(dict(case, seed=seed), mesh)
        step_fn = make_train_step(model, AdamWConfig(**OPT))
        state = init_state(dict(model.named_parameters()))
        start, out = 0, {}
        if restore is not None:
            state, start, _ = ckpt.restore_checkpoint(restore, model, state)
            out["restored"] = _state(model, state, shapes)
        out["losses"] = []
        for step in range(start, STEPS + CKPT_AT):
            state, metrics = step_fn(state, batch)
            out["losses"].append(float(metrics["loss"]))
            if save is not None and step + 1 == CKPT_AT:
                ckpt.save_checkpoint(save, CKPT_AT, model, state, extra={"key": case["key"]})
        out["final"] = _state(model, state, shapes)
        return out

    paths, out = case["ckpt"], {}
    if paths.get("save"):
        out["run"] = steps(case["seed"], save=paths["save"])
        out["resumed"] = steps(case["seed"] + 1, restore=paths["save"])
    if paths.get("restore"):
        out["crossed"] = steps(case["seed"] + 1, restore=paths["restore"])
    return out


def _leaves(cache):
    """(name, leaf) of a cache: a (k, v) pair or a dict."""
    return cache.items() if isinstance(cache, dict) else zip("kv", cache)


def _rows(small, b):
    """Row ``b`` of a prefill cache, as ``_merge_slot`` takes it."""
    if isinstance(small, dict):
        return {name: leaf[:, b:b + 1] for name, leaf in small.items()}
    return tuple(t[:, b:b + 1] for t in small)


def _recording_routes():
    """Wrap ``models.moe.route`` so that every call's f32 router logits
    (B, S, E), chosen experts (B, S, K) and kept choices (B, S, K) are
    recorded; returns the undo, which returns the records as numpy."""
    from repro_torch.models import moe

    route, calls = moe.route, []

    def recording(router, x, cfg):
        top_g, top_e = route(router, x, cfg)
        B, S, K = top_e.shape
        keep = moe.expert_positions(top_e, cfg.num_experts) < moe.capacity_per_row(S, cfg)
        calls.append({"logits": (x.float() @ router.float()).detach().numpy(),
                      "experts": top_e.numpy(), "kept": keep.reshape(B, S, K).numpy()})
        return top_g, top_e

    moe.route = recording

    def undo():
        moe.route = route
        return calls

    return undo


def _recording(fn, seen):
    def wrapper(*args, **kwargs):
        seen.update(type(a).__name__ for a in args if isinstance(a, torch.Tensor))
        return fn(*args, **kwargs)
    return wrapper


def rank_main(rank: int, world: int, store_path: str, cases, queue) -> None:
    """One rank: a gloo group over a ``FileStore``, then every case on its
    own mesh; puts (rank, {key: results}) or (rank, the error) on
    ``queue``."""
    import traceback

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers, rwkv

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        # every tensor handed to a kernel wrapper, by type
        seen = set()
        layers.flash_attention_op = _recording(layers.flash_attention_op, seen)
        layers.decode_attention_op = _recording(layers.decode_attention_op, seen)
        rwkv.wkv6_op = _recording(rwkv.wkv6_op, seen)
        results = {}
        for case in cases:
            axes = ("pod", "data", "model")[-len(case["mesh"]):]
            mesh = make_mesh(case["mesh"], axes, device_type="cpu")
            if "ckpt" in case:
                results[case["key"]] = checkpoint_case(case, mesh)
                continue
            if "serve" in case:
                results[case["key"]] = serve_case(case, mesh)
                results[case["key"]]["kernel_input_types"] = sorted(seen)
                continue
            results[case["key"]] = run_case(case, mesh)
            results[case["key"]]["kernel_input_types"] = sorted(seen)
        dist.destroy_process_group()
        queue.put((rank, results))
    except Exception:  # reported to the parent, which fails the tests
        queue.put((rank, traceback.format_exc()))


def run_ranks(cases, store: str, world: int, meanwhile=lambda: None,
              timeout: float = 240):
    """Every case on ``world`` spawned ranks (``rank_main``, a gloo group
    over a ``FileStore`` at ``store``), while this process runs
    ``meanwhile()``.  Returns ([each rank's {key: results}], what
    ``meanwhile`` returned); raises with every failed rank's traceback."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(rank, world, store, cases, queue))
             for rank in range(world)]
    for p in procs:
        p.start()
    try:
        here = meanwhile()
        got = dict(queue.get(timeout=timeout) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    bad = {rank: r for rank, r in got.items() if isinstance(r, str)}
    if bad:
        raise RuntimeError("\n".join(f"rank {rank}:\n{tb}" for rank, tb in bad.items()))
    return [got[r] for r in range(world)], here
