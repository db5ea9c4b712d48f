"""Model step on SDXL (engine/inference.py:denoise): host milliseconds of
one `unet_step` span, the enqueue of one solver step of the 70-block UNet
(nothing in it waits for the device), the mean over the traced run; set
beside the device's time a step takes, it says whether the host can keep
the card fed. The profiler's callbacks add to every launch, so this reads
above the untraced pace."""

from benchmark import program_spans


def read(ctx):
    steps = program_spans.spans(ctx, "unet_step")
    return 1e3 * sum(s["end"] - s["start"] for s in steps) / len(steps) if steps else None
