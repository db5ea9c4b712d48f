"""Serving layer (cli/serve.py's worker thread): the share of the window
in which the worker was inside a `dispatch` span (a batch's assembly,
noise, upload and the enqueue of its whole generation), the union of
those spans over the window, in %."""

from benchmark import program_spans
from benchmark.trace import union_length


def read(ctx):
    spans = program_spans.spans(ctx, "dispatch")
    if not spans:
        return None
    return 100.0 * union_length([(s["start"], s["end"]) for s in spans], ctx.t0, ctx.t1) / (ctx.t1 - ctx.t0)
