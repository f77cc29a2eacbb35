"""PyTorch / CUDA port of the TConstFormer serving stack.

The JAX package ``repro`` is the reference; this package imports none of
it (and never imports ``jax``).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on a CUDA tensor every attention goes
through a hand-written Hopper kernel (``repro_torch/csrc``), on a CPU
tensor through the kernel's plain PyTorch version.
"""
