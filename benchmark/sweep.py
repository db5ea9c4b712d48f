"""Find the knee of an open-loop serving cell once: its mix offered at
rising rates to one service in one process, each rate for a window of its
own. A rate holds when the backlog does not grow over its window: every
request is served, the least-squares rise of latency (due to delivered)
against due time over the window is at most a quarter of the window's
median latency, and the 90th percentile stays under the latency limit.
Above capacity the queue, and with it the latency, grows by about
(offered - served rate) / served rate seconds every second, so a rise of a
quarter of the median reads any excess of a few percent over a 30 s
window. The knee is the highest rate that holds; the cell runs at
0.8 x the knee.

    python3 benchmark/sweep.py --workload serve-poisson-g6 --seed <n> --rates 2.0 2.4 ... [--window 30] [--out DIR]
    python3 benchmark/sweep.py --workload serve-poisson-g6 --apply DIR/sweep.json

The first form runs on the card and writes DIR/sweep.json and the table as
DIR/sweep.md; the second writes 0.8 x the knee into the cell's file.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SHARE = 0.8
RISE = 0.25


def sustained(row: dict, limit_s: float) -> bool:
    return row["failed"] == 0 and row["rise_s"] <= RISE * row["latency_p50_s"] and row["latency_p90_s"] <= limit_s


def rise(reqs, window: float) -> float:
    """The least-squares slope of latency against due time, times the
    window: how far the latency climbed from the window's start to its
    close (inf when a request failed)."""
    import numpy as np

    if not all(r.ok for r in reqs):
        return math.inf
    if len(reqs) < 2:
        return 0.0
    t = np.array([r.due for r in reqs])
    y = np.array([r.t_done - r.due for r in reqs])
    return float(np.polyfit(t - t[0], y, 1)[0] * window)


def sweep(args) -> dict:
    import torch

    from benchmark import harness, serving
    from benchmark.traffic import open_loop

    spec = harness.benchmark_spec(ROOT)
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ns = argparse.Namespace(workload=args.workload, seed=args.seed, seconds=args.window, trace=0)
    run = harness.Run(ns, spec, wl, cfg, time.perf_counter(), dev)
    cell = serving.ServeCell(run)
    cell.warm_up()
    rows = []
    for k, rate in enumerate(args.rates):
        run.workload = dict(wl, rate=rate)
        run.seed = args.seed + k
        plan = open_loop.prepare(cell)
        torch.cuda.synchronize()
        s0 = cell.stats()
        t0 = time.perf_counter()
        reqs = open_loop.go(cell, plan, t0)
        s1 = cell.stats()
        lat = serving.latencies(reqs, "due")
        done = [r for r in reqs if r.ok]
        # served over the arrivals' window and the drain after it
        end = max((r.t_done for r in done), default=t0)
        row = {
            "offered_per_s": len(reqs) / args.window,
            "served_per_s": len(done) / max(end - t0, 1e-9),
            "latency_p50_s": harness.percentile(lat, 0.5),
            "latency_p90_s": harness.percentile(lat, 0.9),
            "rise_s": rise(reqs, args.window),
            "rows_per_batch": (s1["rows"] - s0["rows"]) / max(1, s1["batches"] - s0["batches"]),
            "failed": len(reqs) - len(done),
        }
        row["rate"] = rate
        row["sustained"] = sustained(row, args.limit)
        rows.append(row)
        print(json.dumps(row), flush=True)
    held = [r["rate"] for r in rows if r["sustained"]]
    knee = max(held) if held else None
    return {"workload": args.workload, "seed": args.seed, "window_s": args.window, "latency_limit_s": args.limit,
            "rows": rows, "knee": knee, "cell_rate": round(SHARE * knee, 3) if knee else None,
            "device": torch.cuda.get_device_name(dev)}


def table(res: dict) -> str:
    lines = [f"Knee sweep of `{res['workload']}` ({res['device']}; window {res['window_s']} s a rate; "
             f"p90 limit {res['latency_limit_s']} s): knee {res['knee']} requests/s, cell rate {res['cell_rate']}.",
             "", "| offered /s | served /s (with the drain) | p50 s | p90 s | latency rise s | rows/batch | failed "
             "| holds |", "|---|---|---|---|---|---|---|---|"]
    for r in res["rows"]:
        lines.append(f"| {r['rate']} | {r['served_per_s']:.3f} | {r['latency_p50_s']:.3f} | "
                     f"{r['latency_p90_s']:.3f} | {r['rise_s']:.3f} | {r['rows_per_batch']:.2f} | {r['failed']} | "
                     f"{'yes' if r['sustained'] else 'no'} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rates", type=float, nargs="+")
    p.add_argument("--window", type=float, default=30.0)
    p.add_argument("--limit", type=float, default=10.0, help="p90 latency limit, s")
    p.add_argument("--out", default=None)
    p.add_argument("--apply", default=None, help="a sweep.json whose cell rate goes into the cell's file")
    args = p.parse_args(argv)
    if args.apply:
        with open(args.apply) as f:
            res = json.load(f)
        path = os.path.join(HERE, "workloads", f"{args.workload}.json")
        with open(path) as f:
            wl = json.load(f)
        wl["rate"] = res["cell_rate"]
        with open(path, "w") as f:
            json.dump(wl, f, indent=2)
            f.write("\n")
        print(f"{path}: rate {res['cell_rate']}")
        return 0
    res = sweep(args)
    md = table(res)
    print(md)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "sweep.json"), "w") as f:
            json.dump(res, f, indent=1)
        with open(os.path.join(args.out, "sweep.md"), "w") as f:
            f.write(md)
    return 0


if __name__ == "__main__":
    sys.exit(main())
