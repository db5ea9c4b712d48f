"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (benchmark/workloads/<cell>.json) names its configuration
(benchmark/configs/) and its traffic kind (the code in
benchmark/traffic/); BENCHMARK.json names its metrics, whose per-layer
readers are in benchmark/metrics/. Set-up builds the program's models from
the seed on the card, warms up the cell's own shapes and counts as
`setup_s`; the window then runs for --seconds; afterwards the program's
output is checked against the plain reference in benchmark/reference/.

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and the compared
numbers beside their limits under `checks`); the same numbers end
standard error. Without a CUDA card, with fewer cards than the cell asks
for, or with JAX or the JAX package loaded once the window has closed, the
run prints no result and exits with 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the script's own folder would shadow modules named like the benchmark's
# (trace, models, ...): the benchmark is imported as the package `benchmark`
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
CACHE = os.path.join(ROOT, ".bench_cache")


def _fixed_caches() -> None:
    """Kernel and extension caches at fixed paths inside the checkout, so
    only the first run of a checkout builds."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, t_start: float = T_START) -> int:
    """`device` None: the card, refused without one. Tests pass a CPU
    device and tiny files through `benchmark.harness` instead."""
    args = parse(argv)
    _fixed_caches()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    spec = harness.benchmark_spec(ROOT)
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    wl = harness.workload(args.workload)
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        print(f"{args.workload}: its file and BENCHMARK.json disagree on config or traffic", file=sys.stderr)
        return 2
    cfg = harness.config(wl["config"])

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"{args.workload} needs {entry['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    run = harness.Run(args, spec, wl, cfg, t_start, device)
    result, checks = harness.traffic(wl["kind"]).run(run)
    hits = harness.forbidden_modules()
    if hits:
        print(f"forbidden modules loaded in this process: {hits}", file=sys.stderr)
        return 2
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
