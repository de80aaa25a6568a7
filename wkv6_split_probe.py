"""How many bf16 parts the chunked WKV6 kernels' operands need, on one H100.

``csrc/wkv6_chunk.cu`` and ``csrc/wkv6_bwd.cu`` take each tensor-core
operand as bf16 parts (hi, lo = x - hi, and where it is needed a third,
lo2 = x - hi - lo).  This script holds one rwkv6-7b train step at full
width and 2 layers (chip_smoke's ``train_parity`` step: 2 x 2048 seeded
tokens, the loss and backward, no update) to an f32 run of the plain
model, with the WKV6 forward or backward swapped for each variant named
on the command line, and prints the worst ratio of a gradient's RMS error
against the f32 run to the plain bf16 run's (the ratio ``chip_smoke.py``
bars at 1.25), and the gradients' global norm beside the plain bf16 and
f32 runs'.  Where a variant swaps the forward, the backward is the
kernel of ``csrc/wkv6_bwd.cu``, and the other way round.  Variants:

* ``kernel``: ``wkv6_chunk.cu`` as it is;
* ``scan``: ``wkv6_scan.cu``, the token-by-token kernel;
* ``chunk_ref``: ``wkv6_chunk_ref``, the chunked form in f32;
* ``parts:IAVS``: the chunked form with the operands of its four products
  read as I, A, V and S bf16 parts each (a digit 2 or 3): the inter-chunk
  term (r decayed, S0), the sub-diagonal A (r and k decayed), A v (A) and
  the state update (k decayed); the diagonal blocks of A in f32;
* ``bwd_ref``: the backward as ``wkv6_bwd_chunk_ref``, in f32;
* ``bwd:IPQA``: the same with the operands of its products read as bf16
  parts (a digit 2 or 3 each, products of order below the last part's
  left out, a bf16 input taken whole): I, S0 and dSe and k decayed in the
  inter-chunk terms; P, r and k decayed in the walks of phases 1 and 2;
  Q, dA and r and k decayed in dr's and dk's products off the diagonal;
  A, k and r decayed in A's blocks off the diagonal and A in A^T dO.

With ``--layers N --rows R`` the step runs N layers over R rows and, with
``--norms``, prints only the gradients' global norms (no f32 run: at all
32 layers its weights and gradients would not fit).

Run on a card:  python3 wkv6_split_probe.py kernel scan parts:2222 parts:2232
                python3 wkv6_split_probe.py bwd_ref bwd:2222 bwd:3333
                python3 wkv6_split_probe.py --layers 32 --rows 4 --norms kernel
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

LOG2E = 1.4426950408889634


def split(torch, x, n: int):
    """x (f32) as n bf16 parts, each the rounding of what the others leave."""
    parts, rest = [], x.float()
    for _ in range(n):
        p = rest.to(torch.bfloat16).float()
        parts.append(p)
        rest = rest - p
    return parts


def product(torch, a, b, na: int, nb: int, order: int):
    """a @ b from na- and nb-part operands, less the products of order
    ``order`` and above (as the kernel's hi*hi + hi*lo + lo*hi at 2)."""
    pa, pb = split(torch, a, na), split(torch, b, nb)
    return sum(pa[i] @ pb[j] for i in range(na) for j in range(nb) if i + j < order)


def bwd_parts(torch, spec: str):
    """The ``mm`` of ``wkv6_bwd_chunk_ref`` for ``bwd:IPQA`` (see above)."""
    i, p, q, a = (int(c) for c in spec)
    shapes = {"inter_r": (1, i, i), "inter_k": (1, i, i), "inter_v": (i, i, i),
              "state": (p, 1, p), "dstate": (p, 1, p), "dA": (1, 1, 1),
              "dr_intra": (q, q, q), "dk_intra": (q, q, q), "A": (a, a, a),
              "dv_intra": (a, 1, a)}
    return lambda name, x, y: product(torch, x, y, *shapes[name])


def chunk_parts(torch, F, r, k, v, logw, u, state, parts, chunk=64, sub=16):
    """The WKV6 recurrence in ``csrc/wkv6_chunk.cu``'s chunked form (as
    ``wkv6_chunk_ref``), each product's operands read as ``parts``."""
    n_inter, n_a, n_av, n_state = parts
    B, H, S, D = r.shape
    nc = -(-S // chunk)
    pad = (0, 0, 0, nc * chunk - S)
    r32, k32, v32 = (F.pad(x.float(), pad) for x in (r, k, v))
    lw2 = F.pad(logw.float(), pad) * LOG2E
    s = state.float().clone()
    bonus = (r32 * u.float()[None, :, None, :] * k32).sum(-1, keepdim=True)
    idx = torch.arange(sub, device=r.device)
    below = (idx[:, None] > idx[None, :])[:, :, None]
    outs = []
    for c0 in range(0, nc * chunk, chunk):
        rc, kc, vc = (x[:, :, c0:c0 + chunk] for x in (r32, k32, v32))
        cum = torch.cumsum(lw2[:, :, c0:c0 + chunk], dim=2)
        excl = F.pad(cum[:, :, :-1], (0, 0, 1, 0))
        last = cum[:, :, -1:]
        o = product(torch, rc * torch.exp2(excl), s, n_inter, n_inter, n_inter)
        A = rc.new_zeros(B, H, chunk, chunk)
        for i in range(0, chunk, sub):
            ti = slice(i, i + sub)
            diff = excl[:, :, ti, None, :] - cum[:, :, None, ti, :]
            dec = torch.exp2(torch.where(below, diff, float("-inf")))
            A[:, :, ti, ti] = torch.einsum("bhtc,bhsc,bhtsc->bhts",
                                           rc[:, :, ti], kc[:, :, ti], dec)
            if i:
                bnd = cum[:, :, i - 1:i]
                rq = rc[:, :, ti] * torch.exp2(excl[:, :, ti] - bnd)
                kq = kc[:, :, :i] * torch.exp2(bnd - cum[:, :, :i])
                A[:, :, ti, :i] = product(torch, rq, kq.transpose(-1, -2), n_a, n_a, n_a)
        outs.append(o + product(torch, A, vc, n_av, n_av, n_av) + bonus[:, :, c0:c0 + chunk] * vc)
        kdec = kc * torch.exp2(last - cum)
        s = (s * torch.exp2(last).transpose(-1, -2)
             + product(torch, kdec.transpose(-1, -2), vc, n_state, n_state, n_state))
    return torch.cat(outs, dim=2)[:, :, :S].to(r.dtype), s


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--norms", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import common
    from repro_torch.kernels.rwkv6_scan import ops
    from repro_torch.kernels.rwkv6_scan.ref import wkv6_bwd_chunk_ref, wkv6_chunk_ref
    from repro_torch.models import build_model
    from repro_torch.training.data import DataConfig, SyntheticCorpus

    if not torch.cuda.is_available():
        print("wkv6_split_probe: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    common.build(["wkv6_scan", "wkv6_chunk", "wkv6_bwd"])
    dev = torch.device("cuda", 0)
    cfg = cs.parity_config(get_config("rwkv6-7b"))
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    spec = next(s for s in cs.TRAIN_RUNS if s.arch == "rwkv6-7b")
    batch = SyntheticCorpus(DataConfig(cfg.vocab_size, spec.seq, args.rows or cs.PARITY_ROWS,
                                       seed=cs.SEED + 7)).batch_at(0)
    tokens, labels = (torch.from_numpy(batch[k]).to(dev) for k in ("tokens", "labels"))
    launch, kernel_for = ops._launch_forward, ops.kernel_for
    backward = ops.wkv6_bwd_op

    def forward(name):
        """The forward of variant ``name``, in ``_launch_forward``'s form."""
        if name == "kernel":
            return launch
        if name == "scan":
            def scan(*args):
                ops.kernel_for = lambda *a: ops.NAME
                try:
                    return launch(*args)
                finally:
                    ops.kernel_for = kernel_for
            return scan
        if name == "chunk_ref":
            fn = wkv6_chunk_ref
        else:
            fn = functools.partial(chunk_parts, torch, F,
                                   parts=tuple(int(c) for c in name.split(":")[1]))
        return lambda r, k, v, logw, u, state, out_state: fn(r, k, v, logw, u, state)

    def swapped_backward(name):
        """``wkv6_bwd_op`` as variant ``name`` computes it."""
        mm = {} if name == "bwd_ref" else {"mm": bwd_parts(torch, name.split(":")[1])}

        def run(r, k, v, logw, u, state, dout, *, need_dstate=True):
            dr, dk, dv, dlogw, du, ds = wkv6_bwd_chunk_ref(r, k, v, logw, u, state, dout, **mm)
            return dr, dk, dv, dlogw, du, ds if need_dstate else None
        return run

    def grads(dtype, name=None):
        model = cs.seeded_model(torch, np, cfg, dev, build_model, dtype)
        model.plain_kernels = name is None
        model.requires_grad_(True)
        is_bwd = bool(name) and name.startswith("bwd")
        ops._launch_forward = forward(name) if name and not is_bwd else launch
        ops.wkv6_bwd_op = swapped_backward(name) if is_bwd else backward
        try:
            model.forward_loss(tokens, labels).backward()
        finally:
            ops._launch_forward, ops.wkv6_bwd_op = launch, backward
        out = {n: p.grad.float() for n, p in model.named_parameters()}
        del model
        torch.cuda.empty_cache()
        return out

    def rms(a, b):
        return float((a.double() - b.double()).square().mean().sqrt())

    def norm(g):
        return float(sum(x.double().square().sum() for x in g.values()).sqrt())

    if args.norms:
        print(json.dumps({"layers": cfg.num_layers,
                          "grad_norm_bf16_plain": norm(grads(torch.bfloat16))}), flush=True)
        for name in args.variants:
            print(json.dumps({"forward": name, "grad_norm": norm(grads(torch.bfloat16, name))}),
                  flush=True)
        return 0
    ref, plain = grads(torch.float32), grads(torch.bfloat16)
    print(json.dumps({"grad_norm_f32_plain": norm(ref), "grad_norm_bf16_plain": norm(plain)}),
          flush=True)
    for name in args.variants:
        g = grads(torch.bfloat16, name)
        ratios = sorted(((rms(g[n], ref[n]) / rms(plain[n], ref[n]), n) for n in ref),
                        reverse=True)
        print(json.dumps({"forward": name, "grad_rms_err_ratio_max": ratios[0][0],
                          "worst3": {n: x for x, n in ratios[:3]}, "grad_norm": norm(g)}),
              flush=True)
        del g
    return 0


if __name__ == "__main__":
    sys.exit(main())
