"""The program's own spans over a traced run's window, for the per-layer
readers in benchmark/metrics/.

The port's recorder (photoverse_tpu_torch/utils/trace.py) records while a
torch profiler runs, so the traced window's `Profile` (benchmark/trace.py)
turns it on and off: its spans lie on the host clock that the device trace
is tied to. The first reader of a run takes the records and keeps them on
the run's context; the other readers read the same. Without a device trace,
or with a program that has no recorder, there is nothing to read and the
readers return None."""

from __future__ import annotations

from typing import List, Optional, Tuple

__all__ = ["program", "spans", "merged", "overlap"]


def program(ctx) -> Optional[dict]:
    """The recorder's records of the window ({"spans", "counters", ...}),
    or None."""
    if getattr(ctx, "trace", None) is None:
        return None
    if not hasattr(ctx, "program"):
        try:
            from photoverse_tpu_torch.utils import trace as recorder
        except ImportError:  # a program without the recorder
            recorder = None
        ctx.program = recorder.take() if recorder is not None else None
    return ctx.program


def spans(ctx, name: str) -> Optional[List[dict]]:
    """The window's spans named `name`, or None where the run has no
    records."""
    got = program(ctx)
    if got is None:
        return None
    return [s for s in got["spans"] if s["name"] == name]


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [a, b) intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(xs: List[Tuple[float, float]], ys: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two lists of disjoint [a, b)
    intervals, each sorted."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total
