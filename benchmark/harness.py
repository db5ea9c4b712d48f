"""What every cell shares: finding the benchmark's files by name, the
run's context, spans on the host clock, the per-layer readers, the
result line and the import guard.

Files found by name (no table in code lists them):
  benchmark/configs/<config>.json     a configuration
  benchmark/workloads/<cell>.json     a cell: its configuration, traffic
                                      kind and every traffic parameter
  benchmark/traffic/<kind>.py         the code of a traffic kind
  benchmark/metrics/<metric>.py       a per-layer metric's reader
  benchmark/kernels/*.json            a kernel's launch-name patterns and
                                      the module that counts a launch's work
"""

from __future__ import annotations

import glob
import importlib
import importlib.util
import json
import math
import os
import re
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "photoverse_tpu")

__all__ = ["BENCH_DIR", "ROOT", "load_json", "benchmark_spec", "workload", "config", "traffic", "Spans",
           "Run", "readers", "kernel_files", "forbidden_modules", "percentile", "prorated", "emit"]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(name: str, bench_dir: str = BENCH_DIR) -> dict:
    wl = load_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    wl["name"] = name
    return wl


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    cfg = load_json(os.path.join(bench_dir, "configs", f"{name}.json"))
    cfg["name"] = name
    return cfg


def traffic(kind: str):
    """The module of traffic kind `kind`: benchmark/traffic/<kind>.py."""
    return importlib.import_module(f"benchmark.traffic.{kind}")


def _load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def readers(names: List[str], bench_dir: str = BENCH_DIR) -> Dict[str, Callable]:
    """{metric: read(ctx)} from benchmark/metrics/<metric>.py."""
    out = {}
    for n in names:
        mod = _load_file(os.path.join(bench_dir, "metrics", f"{n}.py"), f"benchmark_metric_{n.replace('.', '_')}")
        out[n] = mod.read
    return out


def kernel_files(kernel: str, bench_dir: str = BENCH_DIR) -> List[dict]:
    """Every benchmark/kernels/*.json whose `kernel` is `kernel`, each with
    its compiled `pattern` and its `work(launch, match, cfg) -> (ops,
    bytes)` from benchmark/kernels/<work>.py."""
    out = []
    for path in sorted(glob.glob(os.path.join(bench_dir, "kernels", "*.json"))):
        spec = load_json(path)
        if spec["kernel"] != kernel:
            continue
        mod = _load_file(os.path.join(bench_dir, "kernels", f"{spec['work']}.py"),
                         f"benchmark_kernel_{spec['work'].replace('.', '_')}")
        for pat in spec["patterns"]:
            out.append({"pattern": re.compile(pat), "work": mod.work})
    return out


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load:
    JAX and its libraries, and the JAX package (compared whole)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def percentile(values: List[float], q: float) -> float:
    """The q-quantile (0..1) by linear interpolation; inf counts as the
    largest value."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = q * (len(v) - 1)
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    if v[hi] == math.inf:
        return math.inf if pos > lo or v[lo] == math.inf else v[lo]
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def prorated(intervals: List[tuple], lo: float, hi: float) -> float:
    """Units of work done inside [lo, hi): each (start, end, units) counts
    its units times the share of its interval that lies inside."""
    total = 0.0
    for a, b, units in intervals:
        if b <= a:
            total += units if lo <= b < hi else 0.0
            continue
        total += units * max(0.0, min(b, hi) - max(a, lo)) / (b - a)
    return total


class Spans:
    """The benchmark's own spans around its calls into the program:
    (name, start, end) on the host clock, kept in memory."""

    def __init__(self):
        self.items: List[tuple] = []
        self.lock = threading.Lock()

    def span(self, name: str):
        spans = self

        class _S:
            def __enter__(self):
                self.t = time.perf_counter()
                return self

            def __exit__(self, *exc):
                with spans.lock:
                    spans.items.append((name, self.t, time.perf_counter()))
                return False

        return _S()

    def label(self, t: float) -> str:
        """The latest-started span in progress at host time t."""
        best = None
        for name, a, b in self.items:
            if a <= t < b and (best is None or a > best[1]):
                best = (name, a)
        return best[0] if best else "no benchmark call in progress"


class Run:
    """One run of one cell: the arguments, the files, the clock."""

    def __init__(self, args, spec: dict, wl: dict, cfg: dict, t_start: float, device,
                 bench_dir: str = BENCH_DIR):
        self.args = args
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(int(args.trace))
        self.spec = spec
        self.workload = wl
        self.config = cfg
        self.t_start = t_start
        self.device = device
        self.bench_dir = bench_dir
        self.spans = Spans()
        entry = next(w for w in spec["workloads"] if w["name"] == wl["name"])
        self.chips = entry["chips"]
        self.end_to_end = [m for m in spec["end_to_end"] if wl["name"] in m.get("workloads", [wl["name"]])]
        self.per_layer = [m for m in spec["per_layer"] if wl["name"] in m.get("workloads", [wl["name"]])]


def device_info(run: Run, trace=None, window=None) -> dict:
    import torch

    info = {"platform": "gpu" if run.device.type == "cuda" else "cpu", "kind": "cpu", "count": run.chips,
            "memory_peak_bytes": 0}
    if run.device.type == "cuda":
        info["kind"] = torch.cuda.get_device_name(run.device)
        info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(run.device))
    if trace is not None and window is not None:
        lo, hi = window
        info["busy_s"] = trace.busy(lo, hi)
        info["window_s"] = hi - lo
    return info


def metric_values(run: Run, ctx) -> Dict[str, dict]:
    """The metrics of the line: the end-to-end ones from `ctx.e2e` with
    --trace 0, the per-layer readers' with --trace 1 (a reader that finds
    nothing returns None and its metric is left out)."""
    out = {}
    if not run.trace:
        for m in run.end_to_end:
            if m["name"] in ctx.e2e:
                out[m["name"]] = {"value": ctx.e2e[m["name"]], "unit": m["unit"]}
        return out
    fns = readers([m["name"] for m in run.per_layer], run.bench_dir)
    for m in run.per_layer:
        v = fns[m["name"]](ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result line, `checks` last, as the last line
    of standard output."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} ({c.get('rule', '<=')})", file=sys.stderr)
    result = dict(result)
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)



def roofline(ctx, kernel: str) -> Optional[float]:
    """A kernel's share of its roofline over the traced window, in %: the
    sum of the frozen bound (benchmark/bounds.py) over its launches, by
    the work each launch's file counts, divided by the sum of their device
    time. None when the window holds no launch of it."""
    from benchmark import bounds

    if ctx.trace is None:
        return None
    files = kernel_files(kernel, ctx.run.bench_dir)
    bound_s = time_s = 0.0
    for k in ctx.trace.in_window(ctx.t0, ctx.t1):
        for f in files:
            m = f["pattern"].search(k["name"])
            if m:
                ops, nbytes = f["work"](k, m, ctx.run.config)
                bound_s += max(ops / bounds.PEAK_FLOPS, nbytes / bounds.PEAK_BYTES)
                time_s += k["end"] - k["start"]
                break
    return 100.0 * bound_s / time_s if time_s > 0 else None


def mfu(ctx) -> Optional[float]:
    """Model FLOPs done in the window (benchmark/flops.py) over the window
    and the card's bf16 peak, in %."""
    from benchmark import flops

    if ctx.work_flops <= 0:
        return None
    return 100.0 * ctx.work_flops / ((ctx.t1 - ctx.t0) * flops.PEAK_FLOPS)


def device_idle(ctx) -> Optional[float]:
    """100 x (1 - the union of device activity over the traced window)."""
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy(ctx.t0, ctx.t1) / (ctx.t1 - ctx.t0))
