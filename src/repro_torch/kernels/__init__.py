"""Hand-written Hopper kernels of the serving path.

flash_attention  — causal/sliding-window GQA prefill attention
decode_attention — GQA decode over a KV cache with per-sequence lengths
rwkv6_scan       — the WKV6 recurrence of rwkv6-7b (kernel ``wkv6_scan``)
tile_plan        — the flash kernel's launch plan, computed on the host

Each package: ops.py (the wrapper: checks, launch, launch count; the
plain version for CPU tensors) and ref.py (the plain PyTorch version).
The CUDA sources are in ``repro_torch/csrc``.
"""
