"""Operation counts of a step on the meta device, the port's counterpart of
``repro.analysis.hlo_stats``.

The reference counts a compiled step's optimized HLO.  The port has no
HLO: it runs the step on the meta device, where every tensor is a shape
and nothing is computed, under ``OpCounter``, a dispatch mode that sees
every operation torch runs.  It counts, per device:

* **FLOPs of aten ops**, by the formulas of torch's ``FlopCounterMode``
  (``torch.utils.flop_counter.flop_registry``: 2·M·N·K per product, the
  batch folded into M; elementwise ops count none, as in ``hlo_stats``);
* **memory bytes**: each aten op's operands plus its results, the
  convention ``hlo_stats`` takes for every top-level instruction.  Views
  and allocations (``empty``) count nothing; collectives count under
  their own heading;
* **collectives**: count and bytes of each c10d kind (all-reduce,
  all-gather, reduce-scatter, ...); bytes are the result's, the
  ring-traffic proxy of ``hlo_stats`` (an all-reduce's tensor, an
  all-gather's gathered whole);
* **the hand-written kernels' calls, FLOPs and bytes**, which their
  wrappers report from their meta branches (``kernels.common.
  count_meta_call``) by the conventions of the port's kernel table
  (``kernel_work``): the flash forward 4·D per unmasked (query, key) pair
  and head, its backward the 14·D it executes, decode 4·D per cached
  position and head, the WKV6 kernels by ``wkv6_chunk_work`` and
  ``wkv6_bwd_work``; bytes with each input read once and each output
  written once;
* **argument, output, temp and peak bytes**: the storages alive at the
  start (the arguments handed to the counter), those the step made that
  are alive at its end (outputs), and the most the step held at once
  besides its arguments, tracked storage by storage as ops make them and
  Python frees them (peak = arguments + that most; temp = peak less
  arguments and outputs).

Every counted op goes into a trace of (op, argument shapes and dtypes,
count) records that ``analyze`` turns back into the same counts without
a model (``launch/reanalyze.py``).  The work formulas of the kernels and
of a train step (``attention_pairs``, ``train_flops``, ``train_launches``,
``wkv6_chunk_work``, ``wkv6_bwd_work``) live here too; ``chip_smoke.py``
takes them from here.
"""
from __future__ import annotations

import json
import weakref
from typing import Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import common

# c10d ops by the kind ``hlo_stats`` names them
# (another c10d op counts under its own name)
COLLECTIVES = {"allreduce_": "all-reduce", "allgather_": "all-gather",
               "_allgather_base_": "all-gather",
               "reduce_scatter_": "reduce-scatter",
               "_reduce_scatter_base_": "reduce-scatter"}
# allocations: they make a storage and move no byte
NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided"}


# ---------------------------------------------------------------------------
# The kernels' work and a train step's (the port's kernel-table conventions)
# ---------------------------------------------------------------------------


def attention_pairs(sq: int, sk: int, causal: bool, window: int = 0) -> int:
    """Unmasked (query, key) pairs of one row and head: causal S(S+1)/2,
    a window of W over S, or non-causal Sq x Sk."""
    if not causal:
        return sq * sk
    if 0 < window < sq:
        return window * (window + 1) // 2 + (sq - window) * window
    return sq * (sq + 1) // 2


def wkv6_chunk_work(B, S, H, D):
    """Tensor-core operations and exponentials of the chunked WKV6 form for
    this call's tokens (the last chunk's padding not counted), per
    ``csrc/wkv6_chunk.cu``: per (b, h) and chunk of C tokens, the
    inter-chunk (C x D x D) product, the 6 off-diagonal (16 x 16 x D)
    sub-chunk products, A v over the 10 sub-chunk blocks at or below the
    diagonal, and the (D x C x D) state update, each once (the kernel
    takes three bf16 products for each, its operands split into two or
    three bf16 parts, which are not counted); the exponentials are those of the decayed operands and the
    diagonal sub-chunks' pairs, once per head (the two column blocks of a
    head share them)."""
    C, SUB = 64, 16
    chunks = B * H * S / C
    ops = 2.0 * D * (C * D + 6 * SUB * SUB + 10 * SUB * SUB + C * D) * chunks
    exps = D * (2 * C + (C - SUB) + 6 * SUB + 4 * SUB * (SUB - 1) // 2)
    return ops, exps * chunks


def wkv6_bwd_work(B, S, H, D):
    """Operations and bytes of the WKV6 backward for this call's tokens
    (the last chunk's padding not counted): (the chunked form's products,
    the token-by-token form's f32 operations, the function's bytes).

    The products, per ``csrc/wkv6_bwd.cu``, per (b, h) and chunk of C
    tokens, each once and before its bf16 parts: the two walks' (D x C x
    D) state updates, the three inter-chunk (C x D x D) products (dO S0^T,
    v dSe^T, k decayed by dSe), and over the 10 sub-chunk blocks at or
    below the diagonal dA, A and A^T dO, over the 6 below it dr's dA kq
    and dk's dA^T rE (16 x 16 x D each).  The token-by-token form takes 12
    D^2 f32 operations per token and head (the state rebuilt, 3; dr~, 2;
    dS carried, 3; dk~ and dv, 2 each).  Bytes: r, k, v, dO (bf16), logw,
    u and the state read, dr, dk, dv (bf16), dlogw, du and the state's
    gradient written, each once; the kernel's scratch of chunk states is
    its own cost, not the function's."""
    C, SUB = 64, 16
    chunks = B * H * S / C
    blocks = SUB * SUB * D
    products = 2.0 * (5 * C * D * D + 3 * 10 * blocks + 2 * 6 * blocks) * chunks
    f32_ops = 12.0 * B * H * S * D * D
    nbytes = B * H * S * D * (4 * 2 + 4 + 3 * 2 + 4) + 2 * 4 * (B * H * D * D + H * D)
    return products, f32_ops, nbytes


def _itemsize(dtype: str) -> int:
    return getattr(torch, dtype.rsplit(".", 1)[-1]).itemsize


def kernel_work(name: str, shape: dict) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call of kernel ``name`` at ``shape``, the
    dict its wrapper reports (``common.count_meta_call``)."""
    s = shape
    if name in ("flash_attention", "flash_attention_bwd"):
        B, Sq, Sk, H, KV, D = (s[k] for k in ("B", "Sq", "Sk", "H", "KV", "D"))
        e = _itemsize(s["dtype"])
        pairs = attention_pairs(Sq, Sk, s["causal"], s["window"])
        if name == "flash_attention":
            # q read and o written over Sq rows, k and v read over Sk
            nbytes = e * (2 * B * Sq * H * D + 2 * B * Sk * KV * D)
            if s.get("lse"):
                nbytes += 4 * B * H * Sq
            return 4.0 * D * pairs * H * B, nbytes
        # read q, k, v, o, dO and lse; write dq, dk and dv
        nbytes = (e * (3 * B * Sq * H * D + 2 * B * Sk * KV * D) + 4 * B * H * Sq
                  + e * (B * Sq * H * D + 2 * B * Sk * KV * D))
        return 14.0 * D * pairs * H * B, nbytes
    if name == "decode_attention":
        B, H, KV, D, Smax = (s[k] for k in ("B", "H", "KV", "D", "Smax"))
        # the lengths are not known on the meta device: every row its cache
        tokens = B * Smax
        e = _itemsize(s["dtype"])
        nbytes = (e * B * H * D + _itemsize(s["cache_dtype"]) * 2 * tokens * KV * D
                  + 4 * B)
        # the output in q's type, or in f32 beside the f32 LSE
        nbytes += (4 * B * H * (D + 1)) if s.get("lse") else e * B * H * D
        return 4.0 * H * D * tokens, nbytes
    B, H, S, D = (s[k] for k in ("B", "H", "S", "D"))
    if name == "wkv6_bwd":
        products, _, nbytes = wkv6_bwd_work(B, S, H, D)
        return products, nbytes
    # r, k, v read and o written in the model's dtype, logw read in f32,
    # u read, the state read and written in f32
    nbytes = (4 * _itemsize(s["dtype"]) * B * H * S * D + 4 * B * H * S * D
              + 4 * H * D + 2 * 4 * B * H * D * D)
    if name == "wkv6_chunk":
        return wkv6_chunk_work(B, S, H, D)[0], nbytes
    # the scan: ~5 D^2 f32 operations per token and head
    return 5.0 * B * H * S * D * D, nbytes


def train_launches(cfg, microbatches: int = 1) -> dict:
    """Kernel launches of one loss and backward over ``microbatches``
    microbatches, by kernel, nothing else: per layer and microbatch, the
    forward kernel twice (the forward and the checkpoint's recompute) and
    the backward once; rwkv6-7b's WKV6 kernels (the chunked forward: bf16
    prompts of 2048 tokens), every other family's flash kernels, once per
    attention call: one per layer, plus the VLM's cross layers, plus
    seamless's encoder and cross-attention."""
    if cfg.family == "ssm":
        return {"wkv6_chunk": 2 * cfg.num_layers * microbatches,
                "wkv6_bwd": cfg.num_layers * microbatches}
    calls = cfg.num_layers
    if cfg.family == "vlm":
        calls += cfg.num_layers // cfg.cross_attn_every
    elif cfg.family == "audio":
        calls = cfg.encoder_layers + 2 * cfg.num_layers
    return {"flash_attention": 2 * calls * microbatches,
            "flash_attention_bwd": calls * microbatches}


def train_flops(model, batch: int, seq: int) -> float:
    """Model FLOPs of one train step of ``batch`` rows of ``seq`` tokens
    (the recompute not counted): 6 per weight and token it multiplies (the
    enc-dec's encoder and its cross K/V projections over the frames, the
    VLM's cross K/V projections over the image embeddings, every other
    weight over the tokens; an embedding table that is not also the LM head
    is a lookup and counts none), and 3 x 4 D per unmasked (query, key)
    pair and head of every attention call (forward, and a backward of twice
    its products), by ``attention_pairs``; rwkv6-7b has no pairs, and its
    WKV6 3 x 4 D^2 per token, head and layer (the forward's r S and state
    update, a backward of twice that)."""
    cfg = model.cfg
    ctx = {"vlm": cfg.num_image_tokens, "audio": cfg.num_audio_frames}.get(cfg.family, 0)
    lookup = cfg.family == "encoder" or getattr(model, "lm_head", None) is not None
    weights = 0.0
    for name, p in model.named_parameters():
        if name == "embed" and lookup:
            continue
        leaf = name.rsplit(".", 1)[-1]
        over_ctx = (name.startswith("enc_layers.") or leaf in ("wk_x", "wv_x")
                    or (name.startswith("cross_layers.") and leaf in ("wk", "wv")))
        weights += p.numel() * (ctx if over_ctx else seq)
    causal = attention_pairs(seq, seq, True)
    L = cfg.num_layers
    if cfg.family == "encoder":
        pairs = L * attention_pairs(seq, seq, False)
    elif cfg.family == "hybrid":
        full = sum(i < L for i in cfg.full_attn_layers)
        pairs = full * causal + (L - full) * attention_pairs(seq, seq, True,
                                                             cfg.sliding_window)
    elif cfg.family == "vlm":
        pairs = L * causal + (L // cfg.cross_attn_every) * attention_pairs(seq, ctx, False)
    elif cfg.family == "audio":
        pairs = (cfg.encoder_layers * attention_pairs(ctx, ctx, False)
                 + L * (causal + attention_pairs(seq, ctx, False)))
    elif cfg.family == "ssm":
        return (6.0 * weights * batch
                + 12.0 * cfg.head_dim ** 2 * cfg.num_heads * L * batch * seq)
    else:
        pairs = L * causal
    return 6.0 * weights * batch + 12.0 * cfg.head_dim * cfg.num_heads * batch * pairs


# ---------------------------------------------------------------------------
# The trace: ops with their arguments as shapes
# ---------------------------------------------------------------------------


def _local(t: torch.Tensor) -> torch.Tensor:
    """The tensor whose storage holds ``t``'s data on this rank: a DTensor's
    local shard."""
    return getattr(t, "_local_tensor", t)


def _encode(x):
    """A JSON-safe stand-in of an op argument: a tensor as its (local)
    shape and dtype, containers item by item, other objects by name."""
    if isinstance(x, torch.Tensor):
        t = _local(x)
        return {"t": list(t.shape), "d": str(t.dtype).rsplit(".", 1)[-1]}
    if isinstance(x, (list, tuple)):
        return [_encode(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _encode(v) for k, v in x.items()}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.dtype):
        return str(x)
    return {"obj": type(x).__name__}


def _shapes(x):
    """``_encode``'s output with each tensor as a ``torch.Size``, which
    ``flop_registry``'s formulas take in place of the tensor."""
    if isinstance(x, dict):
        if "t" in x and "d" in x:
            return torch.Size(x["t"])
        return {k: _shapes(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_shapes(v) for v in x]
    return x


def _tensor_bytes(x) -> int:
    """Bytes of every tensor in an encoded value."""
    if isinstance(x, dict):
        if "t" in x and "d" in x:
            n = 1
            for d in x["t"]:
                n *= d
            return n * _itemsize(x["d"])
        return sum(_tensor_bytes(v) for v in x.values())
    if isinstance(x, list):
        return sum(_tensor_bytes(v) for v in x)
    return 0


def _packet(op: str):
    """The ``OpOverloadPacket`` of an op's name (``aten.mm.default``)."""
    ns, name = op.split(".")[:2]
    return getattr(getattr(torch.ops, ns), name)


def op_work(record: dict) -> dict:
    """The counts of one trace record (one op at one signature, once):
    {"flops", "bytes"} for an aten op, {"collective", "bytes"} for a c10d
    one, {"kernel", "flops", "bytes"} for a kernel call."""
    if "kernel" in record:
        flops, nbytes = kernel_work(record["kernel"], record["shape"])
        return {"kernel": record["kernel"], "flops": flops, "bytes": nbytes}
    op = record["op"]
    ns, name = op.split(".")[:2]
    if ns == "c10d":
        kind = COLLECTIVES.get(name, name)
        out = record["out"]
        return {"collective": kind,
                "bytes": _tensor_bytes(out[0] if isinstance(out, list) else out)}
    flops = 0.0
    if ns == "aten":
        packet = _packet(op)
        if packet in flop_registry:
            flops = float(flop_registry[packet](
                *_shapes(record["args"]), **_shapes(record["kwargs"]),
                out_val=_shapes(record["out"])))
    nbytes = 0
    if not record.get("view") and name not in NO_BYTES:
        nbytes = (_tensor_bytes(record["args"]) + _tensor_bytes(record["kwargs"])
                  + _tensor_bytes(record["out"]))
    return {"flops": flops, "bytes": nbytes}


def analyze(trace: Iterable[dict]) -> dict:
    """``op_stats`` of a trace: aten FLOPs and bytes (and the FLOPs by op),
    the collectives by kind, the kernels by name, and their totals."""
    flops = nbytes = 0.0
    by_op: Dict[str, float] = {}
    coll: Dict[str, dict] = {}
    kernels: Dict[str, dict] = {}
    for rec in trace:
        n = rec["count"]
        w = op_work(rec)
        if "kernel" in w:
            k = kernels.setdefault(w["kernel"], {"calls": 0, "flops": 0.0,
                                                 "bytes": 0.0})
            k["calls"] += n
            k["flops"] += n * w["flops"]
            k["bytes"] += n * w["bytes"]
        elif "collective" in w:
            c = coll.setdefault(w["collective"], {"count": 0, "bytes": 0})
            c["count"] += n
            c["bytes"] += n * w["bytes"]
        else:
            flops += n * w["flops"]
            nbytes += n * w["bytes"]
            if w["flops"]:
                by_op[rec["op"]] = by_op.get(rec["op"], 0.0) + n * w["flops"]
    kernel_flops = sum(k["flops"] for k in kernels.values())
    kernel_bytes = sum(k["bytes"] for k in kernels.values())
    return {"flops": flops, "bytes": nbytes, "flops_by_op": by_op,
            "kernels": kernels, "kernel_flops": kernel_flops,
            "kernel_bytes": kernel_bytes,
            "total_flops": flops + kernel_flops,
            "total_bytes": nbytes + kernel_bytes,
            "collectives": coll,
            "total_collective_bytes": sum(c["bytes"] for c in coll.values())}


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------


class OpCounter(TorchDispatchMode):
    """Counts what runs under it (see the module's docstring).

        with OpCounter(arguments=tensors) as counter:
            step(...)
        counter.stats()     # op_stats with "memory"
        counter.trace()     # the records ``analyze`` reads

    ``arguments`` are the tensors alive at the start that the step reads
    (weights, optimizer state, batch); their storages are the argument
    bytes.  It counts the meta device: an op that makes a tensor of more
    than one element on another device raises (a host scalar, which
    ``torch.tensor`` builds before it moves it, and an empty tensor, which
    ``torch.utils.checkpoint`` builds on the host for its bookkeeping, are
    let through)."""

    def __init__(self, arguments: Iterable[torch.Tensor] = ()):
        super().__init__()
        self._records: Dict[str, dict] = {}
        self._args: Dict[int, int] = {}
        for t in arguments:
            st = _local(t).untyped_storage()
            self._args[id(st)] = st.nbytes()
        self._live: Dict[int, int] = {}
        self._live_bytes = 0
        self._peak = 0

    # -- the trace --

    def _add(self, record: dict) -> None:
        key = json.dumps(record, sort_keys=True)
        if key in self._records:
            self._records[key]["count"] += 1
        else:
            self._records[key] = dict(record, count=1)

    def _on_kernel(self, name: str, shape: dict) -> None:
        self._add({"kernel": name, "shape": shape})

    def trace(self) -> List[dict]:
        return list(self._records.values())

    # -- storages --

    def _track(self, t: torch.Tensor) -> None:
        st = _local(t).untyped_storage()
        key = id(st)
        if key in self._live or key in self._args:
            return
        nbytes = st.nbytes()
        self._live[key] = nbytes
        self._live_bytes += nbytes
        self._peak = max(self._peak, self._live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def memory(self) -> dict:
        args = sum(self._args.values())
        out = self._live_bytes
        return {"argument_bytes": args, "output_bytes": out,
                "temp_bytes": max(self._peak - out, 0),
                "peak_bytes": args + self._peak}

    def stats(self) -> dict:
        return dict(analyze(self.trace()), memory=self.memory())

    # -- the mode --

    def __enter__(self):
        common.meta_counters.append(self._on_kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        common.meta_counters.remove(self._on_kernel)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        record = {"op": str(func), "args": _encode(list(args)),
                  "kwargs": _encode(kwargs), "out": _encode(out)}
        if func.is_view:
            record["view"] = True
        self._add(record)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                if _local(t).numel() > 1 and _local(t).device.type != "meta":
                    raise RuntimeError(f"{func} made a tensor on "
                                       f"{_local(t).device}, not meta")
                self._track(t)
        return out

