#!/usr/bin/env python3
"""Time the attention and WKV6 kernels of this checkout and another on one card.

    git archive <rev> | tar -x -C build/parent   # the other checkout
    python3 kernel_ab.py --other build/parent

``--other`` is the root of another checkout of this repository, unpacked
inside this one under ``build/`` (git-ignored).  The script runs four
worker processes in turns, other, this, this, other, so that drift of the
card over the run falls on both alike.  A worker builds its checkout's
kernels into that checkout's ``build/`` and prints one JSON line: the
device time per call through a CUDA graph (``chip_smoke.graph_ms``) of
``flash_attention_op`` and ``decode_attention_op`` at the llama-3.1-8b
shapes of ``chip_smoke.py``, and of PyTorch's
``scaled_dot_product_attention`` on the same inputs; then of ``wkv6_op``
at rwkv6-7b's prefill shapes (bf16, B=1, H=64, D=64, the model's mild
decays), on whichever kernel that checkout routes them to; then of
``flash_attention_bwd_op`` at each shape and dtype of
``chip_smoke.FLASH_BWD_CASES`` (the first is the train shape; the other
checkout must take every dtype and head dim there) beside SDPA's backward
on the same inputs,
timed as ``chip_smoke.sdpa_calls`` does (its forward and backward less its
forward); last of ``wkv6_bwd_op`` at each shape of
``chip_smoke.WKV6_BWD_CASES`` (the first is rwkv6-7b's train shape), on
inputs made as ``chip_smoke.check_wkv6_bwd`` makes them.  The card's
name and power limit (``nvidia-smi``) print first.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H, KV, D = 32, 8, 128
FLASH_S = (256, 1000, 2048)
DECODE_ROWS = {"b8_mixed": (4096, [0, 1, 77, 1000, 2048, 3000, 4095, 4096]),
               "b1_suffix": (4096, [1100])}
WKV6_H, WKV6_D = 64, 64
WKV6_S = (256, 1000, 2048)


def worker(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))  # that checkout's kernels
    import torch
    import torch.nn.functional as F
    # this checkout's device timing and backward shapes
    from chip_smoke import FLASH_BWD_CASES, LOGW_MEAN, WKV6_BWD_CASES, graph_ms, sdpa_calls

    from repro_torch.kernels.decode_attention import decode_attention_op
    from repro_torch.kernels.flash_attention import flash_attention_op
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv6_scan import wkv6_bwd_op, wkv6_op

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device is available")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.5).to(torch.bfloat16)

    out = {"root": str(root.relative_to(ROOT)),
           "device": torch.cuda.get_device_name(0)}
    with torch.no_grad():
        for S in FLASH_S:
            q, k, v = rnd(1, S, H, D), rnd(1, S, KV, D), rnd(1, S, KV, D)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            out[f"flash_S{S}"] = graph_ms(torch, lambda: flash_attention_op(q, k, v))
            out[f"sdpa_flash_S{S}"] = graph_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        for name, (smax, lens) in DECODE_ROWS.items():
            B = len(lens)
            q, kc, vc = rnd(B, H, D), rnd(B, KV, smax, D), rnd(B, KV, smax, D)
            lengths = torch.tensor(lens, device=dev, dtype=torch.int32)
            mask = (torch.arange(smax, device=dev)[None, :] < lengths[:, None])
            out[f"decode_{name}"] = graph_ms(
                torch, lambda: decode_attention_op(q, kc, vc, lengths))
            out[f"sdpa_decode_{name}"] = graph_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask[:, None, None, :], enable_gqa=True))
        for S in WKV6_S:
            r, k, v = (rnd(1, S, WKV6_H, WKV6_D).transpose(1, 2) for _ in range(3))
            logw = (-torch.exp(torch.randn(1, S, WKV6_H, WKV6_D, generator=gen, device=dev)
                               * 0.5 - 1.0)).transpose(1, 2)
            u = torch.randn(WKV6_H, WKV6_D, generator=gen, device=dev) * 0.2
            s0 = torch.randn(1, WKV6_H, WKV6_D, WKV6_D, generator=gen, device=dev) * 0.1
            out[f"wkv6_S{S}"] = graph_ms(torch, lambda: wkv6_op(r, k, v, logw, u, s0))
    for B, S, Hb, KVb, Db, window, dtype, *rest in FLASH_BWD_CASES:
        Sk, causal = rest if rest else (S, True)
        q, k, v, do = (x.to(getattr(torch, dtype)) for x in (
            rnd(B, S, Hb, Db), rnd(B, Sk, KVb, Db), rnd(B, Sk, KVb, Db), rnd(B, S, Hb, Db)))
        o, lse = flash_ops.flash_attention_fwd_lse(q, k, v, window=window, causal=causal)
        tag = (f"bwd_B{B}_S{S}x{Sk}_H{Hb}_KV{KVb}_D{Db}_w{window}{'' if causal else '_full'}"
               f"{'' if dtype == 'bfloat16' else '_' + dtype}")
        out[tag] = graph_ms(torch, lambda: flash_ops.flash_attention_bwd_op(
            q, k, v, o, do, lse, window=window, causal=causal))
        fwd, fwd_bwd, _ = sdpa_calls(torch, F, *(x.transpose(1, 2) for x in (q, k, v, do)),
                                     window, causal)
        out[f"sdpa_{tag}"] = (graph_ms(torch, fwd_bwd) - graph_ms(torch, fwd)) if fwd else None
        del q, k, v, do, o, lse
    for B, S, Hw, Dw, decay in WKV6_BWD_CASES:
        r, k, v, do = (rnd(B, S, Hw, Dw).transpose(1, 2) for _ in range(4))
        logw = (-torch.exp(torch.randn(B, S, Hw, Dw, generator=gen, device=dev) * 0.5
                           + LOGW_MEAN[decay])).transpose(1, 2)
        u = torch.randn(Hw, Dw, generator=gen, device=dev) * 0.2
        s0 = torch.randn(B, Hw, Dw, Dw, generator=gen, device=dev) * 0.1
        out[f"wkv6_bwd_B{B}_S{S}_{decay}"] = graph_ms(
            torch, lambda: wkv6_bwd_op(r, k, v, logw, u, s0, do))
        del r, k, v, do, logw, s0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="root of the other checkout, under this one's build/")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve())), flush=True)
        return 0
    other = args.other.resolve() if args.other else ROOT
    if not other.is_relative_to(ROOT / "build") or not (other / "src").is_dir():
        ap.error("--other must be a checkout unpacked under this one's build/")
    from chip_smoke import nvidia_smi_line
    print(nvidia_smi_line(), flush=True)
    env = dict(os.environ, PYTHONPATH="")  # each worker its own src/
    for tag, root in (("other", other), ("this", ROOT), ("this", ROOT),
                      ("other", other)):
        res = subprocess.run([sys.executable, str(ROOT / "kernel_ab.py"),
                              "--worker", str(root)], env=env, check=True,
                             stdout=subprocess.PIPE, text=True, cwd=str(root))
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"which": tag, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
