"""Kernels (ops/fused_block.py -> csrc/fused_cross_ff.cu): the fused
block tail's share of its roofline over the traced window, in %."""

from benchmark.harness import roofline


def read(ctx):
    return roofline(ctx, "fused_cross_ff")
