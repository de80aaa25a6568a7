"""Serve a model with seeded random weights through the port's engine --
continuous batching, slot KV cache with prefix reuse (or rwkv's recurrent
state, or hymba's cache of full-layer KV, window rings and Mamba states),
greedy decode.  The counterpart of ``examples/serve_model.py``.
The MoE decoders (olmoe-1b-7b, granite-moe-3b-a800m) serve through the
dense decoders' ``DenseLM`` and engine.  An encoder (e5-base-v2, reranker-minilm) has no engine: each request is
one ``prefill`` call that returns its pooled embedding.

    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch llama-3.1-8b
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch rwkv6-7b
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch olmoe-1b-7b
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch granite-moe-3b-a800m
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch hymba-1.5b
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch e5-base-v2
    PYTHONPATH=src python -m repro_torch.launch.serve_model --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch rwkv6-7b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch olmoe-1b-7b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch hymba-1.5b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch reranker-minilm --reduced --device cpu

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving.engine import ServeRequest, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="2 layers, d_model 64 (the CPU test size)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    model = build_model(cfg, device=device, dtype=dtype)
    model.init_params(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)
    if cfg.family == "encoder":
        return encode(model, cfg, args, rng, device)
    engine = ServingEngine(model, device=device, slots=args.slots, max_len=128)

    t0 = time.perf_counter()
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(8, 24))).astype(np.int32)
        engine.submit(ServeRequest(i, prompt, max_new_tokens=args.max_new))
    done = engine.run_to_completion()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.generated) for r in done)
    size = "reduced" if args.reduced else "full"
    print(f"arch={cfg.name} ({size}, {device}) served {len(done)} requests, "
          f"{total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens / dt:.1f} tok/s, "
          f"{engine.stats['decode_steps']} engine iterations)")
    for r in done[:3]:
        print(f"  req {r.req_id}: prompt[{len(r.prompt)}] -> "
              f"{r.generated[:8]}...")
    return done


def encode(model, cfg, args, rng, device):
    """One ``prefill`` per request (the reference's encoder takes an
    unmasked batch, so prompts of different lengths do not share one)."""
    embeddings, tokens = [], 0
    t0 = time.perf_counter()
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=(1, int(rng.integers(8, 24)))).astype(np.int32)
        emb, _ = model.prefill(prompt)
        embeddings.append(emb)
        tokens += prompt.shape[1]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    size = "reduced" if args.reduced else "full"
    print(f"arch={cfg.name} ({size}, {device}) encoded {len(embeddings)} "
          f"requests, {tokens} tokens in {dt:.2f}s "
          f"({len(embeddings) / dt:.1f} calls/s, {tokens / dt:.1f} tok/s); "
          f"embedding dim {embeddings[0].shape[-1]}")
    return embeddings


if __name__ == "__main__":
    main()
