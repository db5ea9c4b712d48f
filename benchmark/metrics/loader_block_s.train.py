"""Data (data/dataset.py:BatchLoader): seconds the training loop blocked
on the loader's queue (`loader_wait` spans, epoch restarts included) per
optimizer step (`micro_step` spans over the recipe's accumulation)."""

from benchmark import program_spans


def read(ctx):
    micro, waits = program_spans.spans(ctx, "micro_step"), program_spans.spans(ctx, "loader_wait")
    if not micro or not waits:
        return None
    steps = len(micro) / ctx.run.config["recipe"]["accumulation"]
    return sum(s["end"] - s["start"] for s in waits) / steps
