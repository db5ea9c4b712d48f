"""Open-loop serving traffic: requests due on a schedule, sent whether or
not earlier ones have returned (independent users). A request's latency
runs from its due time to its images delivered, so a stall of the
sender counts against every request it delays.

Workload keys read: `rate` (requests/s): the window's n = round(rate x
seconds) gaps are the exponential distribution's quantiles at
(i + 0.5) / n, scaled to the window's length, in an order shuffled by the
seed, so every seed offers the same gaps in another order (Poisson
arrivals without the seed's luck in their count); `requests` (see
serving.py).
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from benchmark import serving

__all__ = ["offsets", "prepare", "go", "run"]


def offsets(rate: float, seconds: float, seed: int) -> list:
    """Due times (s from the window's start) of every request of the
    window."""
    n = int(round(rate * seconds))
    if not n:
        return []
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n)
    gaps *= seconds / gaps.sum()
    np.random.default_rng([seed % (1 << 63), 11]).shuffle(gaps)
    return [float(x) for x in np.concatenate([[0.0], np.cumsum(gaps)[:-1]])]


def prepare(cell):
    run = cell.run
    due = offsets(float(run.workload["rate"]), run.seconds, run.seed)
    return [(off, cell.make_request(i)) for i, off in enumerate(due)]


def go(cell, plan, t0: float):
    threads = []
    for off, req in plan:
        req.due = t0 + off
        wait = req.due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        th = threading.Thread(target=cell.submit, args=(req,), daemon=True)
        th.start()
        threads.append(th)
    deadline = t0 + cell.run.seconds + 60.0
    for th in threads:
        th.join(max(0.0, deadline - time.perf_counter()))
    reqs = [r for _, r in plan]
    for r in reqs:
        if r.t_done is None:
            r.error = "no answer within 60 s of the window's close"
            r.t_done = math.inf
    return reqs


def run(run_):
    return serving.run_cell(run_, __import__(__name__, fromlist=["go"]))
