"""Kernels (ops/dual_cross_attn.py -> csrc/dual_cross_attn.cu, the unfused
blocks' dual-context cross-attention): its share of its roofline over the
traced window, in %."""

from benchmark.harness import roofline


def read(ctx):
    return roofline(ctx, "dual_cross_attn")
