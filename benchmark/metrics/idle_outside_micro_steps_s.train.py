"""Device (the H100) in training: seconds per optimizer step in which the
card was idle while the training loop was outside every `micro_step`
span (the losses to the host, the loader, the host batch, the draws),
from the window's start to the last micro-step's end."""

from benchmark import program_spans
from benchmark.trace import gaps


def read(ctx):
    spans = program_spans.spans(ctx, "micro_step")
    if not spans:
        return None
    micro = program_spans.merged([(s["start"], s["end"]) for s in spans])
    idle = gaps(ctx.trace.activity, ctx.t0, micro[-1][1])
    outside = sum(b - a for a, b in idle) - program_spans.overlap(idle, micro)
    return outside / (len(spans) / ctx.run.config["recipe"]["accumulation"])
