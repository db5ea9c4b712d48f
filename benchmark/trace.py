"""The device trace of a traced run: torch.profiler over the measured
window (device activity only, so the host's pace is barely touched),
written by the profiler's own chrome-trace writer and reduced here to
device-activity intervals, kernel launches with their grids, the device's
busy time (the union of its activity intervals) and its idle gaps.

The host clock and the trace's clock are tied by one marker kernel
(`torch.cuda._sleep`, the `spin_kernel`) launched at a known host time
right after the profiler starts: the launch's runtime event carries the
trace's time of that call."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["DeviceTrace", "Profile", "union_length", "gaps"]

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"


def union_length(intervals: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of [a, b) intervals, clipped to [lo, hi)."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


class DeviceTrace:
    """Device activity on the host's clock (seconds, time.perf_counter)."""

    def __init__(self, events: List[dict], anchor_host: Optional[float]):
        self.kernels: List[dict] = []  # name, start, end, grid
        self.activity: List[Tuple[float, float]] = []
        runtime = {}
        marker_corr = None
        raw = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat == "cuda_runtime":
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    runtime[corr] = e["ts"]
            elif cat in GPU_CATS:
                raw.append(e)
                if cat == "kernel" and marker_corr is None and MARKER in e.get("name", ""):
                    marker_corr = e.get("args", {}).get("correlation")
        # microseconds of the trace -> seconds of the host clock
        self.offset = None
        if anchor_host is not None and marker_corr in runtime:
            self.offset = anchor_host - runtime[marker_corr] * 1e-6
        off = self.offset if self.offset is not None else 0.0
        for e in raw:
            a = e["ts"] * 1e-6 + off
            b = a + e.get("dur", 0) * 1e-6
            self.activity.append((a, b))
            if e.get("cat") == "kernel" and MARKER not in e.get("name", ""):
                self.kernels.append({"name": e["name"], "start": a, "end": b,
                                     "grid": e.get("args", {}).get("grid")})
        self.activity.sort()
        self.kernels.sort(key=lambda k: k["start"])

    def busy(self, lo: float, hi: float) -> float:
        return union_length(self.activity, lo, hi)

    def in_window(self, lo: float, hi: float) -> List[dict]:
        return [k for k in self.kernels if k["start"] >= lo and k["end"] <= hi]

    def top_ops(self, lo: float, hi: float, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for k in self.in_window(lo, hi):
            by[k["name"]] = by.get(k["name"], 0.0) + (k["end"] - k["start"])
        return [[name[:200], s] for name, s in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, lo: float, hi: float, label, n: int = 10) -> List[list]:
        """The n longest idle stretches, each named by `label(t)`, what
        the host was doing when it began."""
        g = sorted(gaps(self.activity, lo, hi), key=lambda ab: ab[0] - ab[1])[:n]
        return [[label(a), b - a] for a, b in g]


class Profile:
    """torch.profiler around the measured window (CUDA activity only);
    `stop()` returns the DeviceTrace. The chrome trace goes to a file in
    TMPDIR, is read back and deleted."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = device
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.anchor = None

    def start(self) -> float:
        torch = self.torch
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.anchor = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)
        return self.anchor

    def stop(self) -> DeviceTrace:
        import tempfile

        self.torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        return DeviceTrace(events, self.anchor)
