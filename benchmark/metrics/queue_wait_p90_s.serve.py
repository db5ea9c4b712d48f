"""Serving layer (cli/serve.py's batcher): seconds a served request waited
before its batch was dispatched, the benchmark's clock around submit()
less the service's own latency_s (dispatch to fetch-complete); the
window's 90th percentile."""

from benchmark.harness import percentile


def read(ctx):
    waits = [r.t_done - r.t_submit - r.service_s for r in ctx.reqs if r.ok]
    return percentile(waits, 0.9) if waits else None
