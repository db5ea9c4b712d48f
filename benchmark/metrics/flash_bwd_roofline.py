"""Kernels (ops/flash_sdpa.py -> csrc/flash_bwd.cu): the flash backward's
share of its roofline over the traced window, in %."""

from benchmark.harness import roofline


def read(ctx):
    return roofline(ctx, "flash_bwd")
