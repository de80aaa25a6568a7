"""Train a model with seeded random weights on the reference's synthetic
token stream: AdamW over the loss of any family (the dense and MoE
decoders, the encoders, rwkv6-7b, hymba, the VLM and the enc-dec).  The
counterpart of the reference's
``launch/train.py``, with its flags and defaults but no checkpoints or
gradient compression (``--ckpt-dir``, ``--ckpt-every``, ``--resume``,
``--compress``), which the port does not have yet.  As the reference's,
it feeds zeros for a model's stub inputs (the VLM's image embeddings, the
enc-dec's audio frames; ``extra_inputs``), and the CLI always trains a
reduced config (``--reduced`` is on by default and cannot be turned off);
full-width runs go through ``training.train_loop.make_train_step``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --steps 30
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch hymba-1.5b
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch rwkv6-7b

Runs on the card unless ``--device cpu`` is given.  The weights are bf16
and the moments f32, as in the reference.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.training.data import DataConfig, SyntheticCorpus
from repro_torch.training.optimizer import AdamWConfig, init_state
from repro_torch.training.train_loop import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = build_model(cfg, device=device, dtype=torch.bfloat16)
    model.init_params(torch.Generator(device=device).manual_seed(args.seed))
    train_step = make_train_step(model, AdamWConfig(lr=args.lr, warmup_steps=10))
    opt_state = init_state(dict(model.named_parameters()))
    data = SyntheticCorpus(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                      seed=args.seed))

    extra = getattr(model, "extra_inputs", lambda batch: {})(args.batch)
    losses = []
    for step in range(args.steps):
        batch = data.batch_at(step)
        for name, (shape, dtype) in extra.items():
            batch[name] = torch.zeros(shape, dtype=dtype, device=device)
        t0 = time.time()
        opt_state, metrics = train_step(opt_state, batch)
        losses.append(float(metrics["loss"]))
        print(f"step {step}: loss={losses[-1]:.4f} "
              f"({time.time()-t0:.2f}s)", flush=True)
    if len(losses) >= 10:
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'DECREASED' if last < first else 'no decrease'})")
    return losses


if __name__ == "__main__":
    main()
