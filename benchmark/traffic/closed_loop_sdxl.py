"""Closed-loop serving traffic on an SDXL configuration: closed_loop.py's
`clients` callers, each sending its next request when its last one
returns, into the SDXL service (serving_sdxl.py: its bundle, requests with
time ids, its reference check and FLOP count).

Workload keys read: `clients`, `requests` (see serving.py).
"""

from __future__ import annotations

from benchmark import serving_sdxl
from benchmark.traffic.closed_loop import go, prepare

__all__ = ["prepare", "go", "run"]


def run(run_):
    return serving_sdxl.run_cell(run_, __import__(__name__, fromlist=["go"]))
