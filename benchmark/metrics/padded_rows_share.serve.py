"""Serving layer (cli/serve.py:_dispatch_group's power-of-two buckets):
padded rows as a share of all rows the device ran in the window, from
the service's counters read before and after it."""


def read(ctx):
    rows, pad = ctx.stats.get("rows", 0), ctx.stats.get("padded_rows", 0)
    return 100.0 * pad / (rows + pad) if rows + pad else None
