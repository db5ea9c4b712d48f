"""Kernels (ops/flash_sdpa.py -> csrc/flash_fwd_wgmma.cu at head dim 64,
SDXL's self-attention): the flash forward's share of its roofline over
the traced window, in %."""

from benchmark.harness import roofline


def read(ctx):
    return roofline(ctx, "flash_fwd_d64")
