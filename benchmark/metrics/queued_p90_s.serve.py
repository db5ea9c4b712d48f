"""Serving layer (cli/serve.py's batcher): seconds a request spent in the
queue, from the program's `queued` span (the deque append to the worker
taking it into a group), over the window's delivered requests (those whose
`request` span closed); the 90th percentile."""

from benchmark import program_spans
from benchmark.harness import percentile


def read(ctx):
    requests, queued = program_spans.spans(ctx, "request"), program_spans.spans(ctx, "queued")
    if requests is None:
        return None
    done = {s["attrs"].get("request") for s in requests}
    waits = [s["end"] - s["start"] for s in queued if s["attrs"].get("request") in done]
    return percentile(waits, 0.9) if waits else None
