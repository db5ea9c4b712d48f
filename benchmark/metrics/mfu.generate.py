"""Model step (engine/inference.py:run_inference, or
engine/training.py:TrainStep for training): the model FLOPs the window's
work needs (benchmark/flops.py) over the window and the H100's dense bf16
peak, in %."""

from benchmark.harness import mfu


def read(ctx):
    return mfu(ctx)
