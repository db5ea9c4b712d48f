"""Closed-loop serving traffic: `clients` callers, each sending its next
request when its last one returns (callers that wait for a reply). A
request's latency runs from its sending to its images delivered.

Workload keys read: `clients`, `requests` (see serving.py).
"""

from __future__ import annotations

import threading
import time

from benchmark import serving

__all__ = ["prepare", "go", "run"]

STRIDE = 1 << 20  # request index = client * STRIDE + its count


def prepare(cell):
    return int(cell.run.workload["clients"])


def go(cell, clients: int, t0: float):
    end = t0 + cell.run.seconds
    done = [[] for _ in range(clients)]

    def client(c):
        j = 0
        while time.perf_counter() < end:
            req = cell.make_request(c * STRIDE + j)
            req.due = time.perf_counter()
            cell.submit(req)
            done[c].append(req)
            j += 1

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(cell.run.seconds + 120.0)
    return [r for per in done for r in per]


def run(run_):
    return serving.run_cell(run_, __import__(__name__, fromlist=["go"]))
