"""Model step on SDXL (engine/inference.py:run_inference on an SDXL
bundle): the model FLOPs the window's images need
(benchmark/flops_sdxl.py) over the window and the H100's dense bf16 peak,
in %."""

from benchmark.harness import mfu


def read(ctx):
    return mfu(ctx)
