"""Model step (engine/inference.py:denoise): host milliseconds of one
`unet_step` span, the enqueue of one solver step (the UNet's evaluation
and the solver's update; nothing in it waits for the device), the mean
over the traced run. The profiler is on in that run and adds its own cost
to every launch (CUPTI's callbacks), so this reads above the host's
untraced pace, and a change that removes launches also removes some of
that cost: it reads here as a larger gain than the untraced step shows."""

from benchmark import program_spans


def read(ctx):
    steps = program_spans.spans(ctx, "unet_step")
    return 1e3 * sum(s["end"] - s["start"] for s in steps) / len(steps) if steps else None
