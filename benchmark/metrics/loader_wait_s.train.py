"""Data (data/dataset.py:BatchLoader): seconds the training loop waited
for the loader per optimizer step, the benchmark's clock around
next(loader), the window's mean."""


def read(ctx):
    waits = getattr(ctx, "loader_waits", None)
    return sum(waits) / len(waits) if waits else None
