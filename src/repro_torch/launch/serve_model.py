"""Serve a model with seeded random weights through the port's engine --
continuous batching, slot KV cache with prefix reuse (or rwkv's recurrent
state, or hymba's cache of full-layer KV, window rings and Mamba states),
greedy decode.  The counterpart of ``examples/serve_model.py``.
The MoE decoders (olmoe-1b-7b, granite-moe-3b-a800m) serve through the
dense decoders' ``DenseLM`` and engine.  An encoder (e5-base-v2, reranker-minilm) has no engine: each request is
one ``prefill`` call that returns its pooled embedding.  The cross-attention
decoders (llama-3.2-vision-11b, seamless-m4t-large-v2) prefill with a stub
image or audio input, which the engine does not take: ``generate`` runs one
batch of equal-length prompts through one prefill and greedy decode steps.

    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch llama-3.1-8b
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch rwkv6-7b
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch olmoe-1b-7b
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch granite-moe-3b-a800m
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch hymba-1.5b
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch e5-base-v2
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch llama-3.2-vision-11b
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch seamless-m4t-large-v2
    PYTHONPATH=src python -m repro_torch.launch.serve_model --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch rwkv6-7b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch olmoe-1b-7b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch hymba-1.5b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch reranker-minilm --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch llama-3.2-vision-11b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_model --arch seamless-m4t-large-v2 --reduced --device cpu

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
from repro_torch.serving.engine import (ServeRequest, ServingEngine,
                                       _merge_slot)


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
    if cfg.family in ("vlm", "audio"):
        return generate_batch(model, cfg, args, rng, device)
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


def stub_inputs(cfg, batch: int, rng) -> np.ndarray:
    """Seeded stand-ins for the frontend the reference stubs out, standard
    normal in f32: the VLM's ``image_embeds`` (B, num_image_tokens,
    vision_d_model) or the enc-dec's ``audio_frames`` (B,
    num_audio_frames, d_model)."""
    if cfg.family == "vlm":
        shape = (batch, cfg.num_image_tokens, cfg.vision_d_model)
    elif cfg.family == "audio":
        shape = (batch, cfg.num_audio_frames, cfg.d_model)
    else:
        raise ValueError(f"{cfg.name} takes no image or audio input")
    return rng.standard_normal(shape, dtype=np.float32)


@torch.no_grad()
def generate(model, tokens, inputs, max_new: int):
    """The reference's prefill -> decode contract for a VLM or enc-dec:
    one ``prefill`` of the (B, S) prompts over their stub ``inputs``, the
    prompt's cache put row by row into one of S + max_new positions by the
    engine's ``_merge_slot`` (the cross leaves whole), then ``max_new`` greedy ``decode_step`` s of all rows
    at positions S + i.

    Returns the greedy tokens (B, 1 + max_new), the prefill's and each
    step's, on the host, and the seconds of the prefill (to its
    synchronisation) and of the decode (the cache copy and the steps, to
    the tokens' copy to the host)."""
    device = model.device
    B, S = tokens.shape
    t0 = time.perf_counter()
    logits, small = model.prefill(tokens, inputs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    cache = model.init_cache(B, S + max_new)
    for b in range(B):
        _merge_slot(cache, {name: leaf[:, b:b + 1]
                            for name, leaf in small.items()}, b)
    del small
    out = [torch.argmax(logits, dim=-1)]
    for i in range(max_new):
        logits, cache = model.decode_step(cache, out[-1], S + i)
        out.append(torch.argmax(logits, dim=-1))
    generated = torch.stack(out, dim=1).cpu()
    t2 = time.perf_counter()
    return generated, {"prefill_s": t1 - t0, "decode_s": t2 - t1}


def generate_batch(model, cfg, args, rng, device):
    """``--requests`` prompts of one seeded length, each with its seeded
    stub input, through ``generate`` (the reference's prefill takes an
    unmasked (B, S) batch, so the prompts share one length)."""
    S = int(rng.integers(8, 24))
    tokens = rng.integers(0, cfg.vocab_size, size=(args.requests, S))
    generated, times = generate(model, tokens,
                                stub_inputs(cfg, args.requests, rng),
                                args.max_new)
    size = "reduced" if args.reduced else "full"
    print(f"arch={cfg.name} ({size}, {device}) generated for "
          f"{args.requests} requests of {S} prompt tokens, "
          f"{generated.numel()} tokens; prefill "
          f"{1e3 * times['prefill_s']:.1f} ms, decode step "
          f"{1e3 * times['decode_s'] / max(args.max_new, 1):.1f} ms")
    return generated


if __name__ == "__main__":
    main()
