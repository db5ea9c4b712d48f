"""The control of a cell's correctness check: the plain reference put in the
program's place and computed one precision step below the configuration's
(bf16 -> operands rounded through fp8 e4m3; for training also the
diffusion loss's mean over half the rows), judged against the float32
reference by the same comparison and the cell's own limits as a run judges
the program. A sound limit passes the program's runs and fails this:
`correct` is false.

    python3 benchmark/control.py --workload <cell> --seeds <n> <n> <n> [--numerics fp8 half_batch]

Prints one JSON line per seed: `correct` and the compared numbers beside
their limits; on the card only (it runs the reference at the cell's own
sizes).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def serve_control(run, numerics: str = "fp8") -> dict:
    """The `numerics` reference in the program's place on the cell's first
    `sample` requests of the seed, judged against the f32 reference by the
    cell's own limits: {correct, checks, reference_s}."""
    from benchmark import serving
    from benchmark.models import DTYPES, program_models
    from benchmark.weights import make_weights, named_params

    cfg, wl = run.config, run.workload
    meta = program_models(cfg, "meta")
    weights = make_weights(named_params(meta), run.seed, run.device, DTYPES[cfg["precision"]])
    cell = serving.ServeCell.__new__(serving.ServeCell)
    cell.run, cell.req_cfg = run, wl["requests"]
    cell.key = (cell.req_cfg["steps"], float(cell.req_cfg["guidance"]), cell.req_cfg["scheduler"])
    reqs = [cell.make_request(i) for i in range(wl["correct"]["sample"])]
    t = time.perf_counter()
    ref = serving.reference_images(weights, cfg, reqs, run.device, "f32")
    t_ref = time.perf_counter() - t
    low = serving.reference_images(weights, cfg, reqs, run.device, numerics)
    checks = serving.judge(wl["correct"]["limits"], low, ref)
    return {"correct": serving.passed(checks), "checks": checks, "reference_s": t_ref}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--numerics", nargs="+", default=["fp8"],
                   help="fp8, and for a training cell also half_batch")
    args = p.parse_args(argv)
    import torch

    from benchmark import harness

    spec = harness.benchmark_spec(ROOT)
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        ns = argparse.Namespace(workload=args.workload, seed=seed, seconds=0, trace=0)
        run = harness.Run(ns, spec, wl, cfg, time.perf_counter(), dev)
        if wl["kind"] == "train_steps":
            from benchmark import training

            res = training.control(run, args.numerics)
        else:
            res = {n: serve_control(run, n) for n in args.numerics}
        print(json.dumps({"workload": args.workload, "seed": seed, **res}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
