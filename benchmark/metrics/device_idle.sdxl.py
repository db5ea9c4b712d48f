"""Device (the H100) under SDXL serving: the share of the traced window in
which no kernel, copy or memset ran on the card, from the union of the
profiler's device activity intervals, in %."""

from benchmark.harness import device_idle


def read(ctx):
    return device_idle(ctx)
