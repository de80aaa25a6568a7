"""PyTorch/CUDA port of the repro serving path for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
of it.  See ``README.md`` ("PyTorch / H100 port") for how to run it.
"""
