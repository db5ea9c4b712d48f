"""PyTorch + CUDA port of photoverse_tpu for one NVIDIA Hopper GPU.

The layout mirrors `photoverse_tpu/` (core, ops, models, engine, convert)
so each module's counterpart sits at the same path. Public functions keep
the JAX package's layouts (NHWC images and latents, (B, S, H, d) attention
tensors) so the two packages can be compared like for like.

Hand-written Hopper kernels live in `csrc/` and are built with nvcc at first
use (`ops/_build.py`). A wrapper runs its plain PyTorch version only for a
CPU tensor; for a CUDA tensor it launches the kernel or raises.
"""
