"""Bursty open-loop serving traffic: on and off phases of fixed lengths,
requests only in the on phases, sent whether or not earlier ones have
returned (open_loop.py's sender). The window starts with an on phase.

Workload keys read: `rate` (requests/s inside an on phase), `on_s` and
`off_s` (the phases' lengths), `requests` (see serving.py). An on phase
of length L (the last one cut at the window's close) holds n = round(rate
x L) requests; its gaps are the exponential distribution's quantiles at
(i + 0.5) / n scaled to L, in an order shuffled by the seed and the
phase's index, as open_loop.offsets makes a window's. The mean rate is
rate x on_s / (on_s + off_s).
"""

from __future__ import annotations

import numpy as np

from benchmark import serving
from benchmark.traffic.open_loop import go

__all__ = ["offsets", "prepare", "go", "run"]


def offsets(rate: float, on_s: float, off_s: float, seconds: float, seed: int) -> list:
    """Due times (s from the window's start) of every request of the
    window."""
    out = []
    phase, start = 0, 0.0
    while start < seconds:
        length = min(on_s, seconds - start)
        n = int(round(rate * length))
        if n:
            gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n)
            gaps *= length / gaps.sum()
            np.random.default_rng([seed % (1 << 63), 13, phase]).shuffle(gaps)
            out += [start + float(x) for x in np.concatenate([[0.0], np.cumsum(gaps)[:-1]])]
        phase, start = phase + 1, start + on_s + off_s
    return out


def prepare(cell):
    run, wl = cell.run, cell.run.workload
    due = offsets(float(wl["rate"]), float(wl["on_s"]), float(wl["off_s"]), run.seconds, run.seed)
    return [(off, cell.make_request(i)) for i, off in enumerate(due)]


def run(run_):
    return serving.run_cell(run_, __import__(__name__, fromlist=["go"]))
