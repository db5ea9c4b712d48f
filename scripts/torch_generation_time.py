"""Seconds per image of the port's 512px generation on one H100, from the
tree in the current directory.

    python3 scripts/torch_generation_time.py [--runs N] [--profile] [--diff]

SD-1.5-width models with random numpy-seeded weights, bf16, flash + fused
blocks, batch 2, DPM-Solver++ 50 steps, guidance 1 (chip_smoke.py's
pipeline configuration, whose request and noise helpers it reuses). It
imports `photoverse_tpu_torch` and `chip_smoke` from the current
directory, so the same script times two checkouts in one call on one card
(run it from each tree's root, in turns). `--profile` adds a 10-step run
under torch.profiler: device-busy time, wall time and the largest kernels.
`--diff` reads the pixel difference to the run on the kernels' plain
versions, at guidance 1 (50 steps) and 6 (10 steps).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())


def log(msg):
    print(msg, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--diff", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
    from photoverse_tpu_torch.engine.inference import run_inference
    from photoverse_tpu_torch.models.assembly import build_models, init_params
    from photoverse_tpu_torch.ops import _build

    log(f"tree {os.getcwd()}")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    models = init_params(build_models(
        dtype=torch.bfloat16, use_flash_attention=True, fast_attention_scores=True,
        fast_norms=True, fused_blocks=True, device="cuda"), seed=0)
    B = 2
    example = cs._example(B, seed=1)
    noise = np.concatenate([np.random.RandomState(100 + r).randn(1, 64, 64, 4) for r in range(B)]).astype(np.float32)
    uncond = cs._empty_prompt(B)

    def run(n_steps, guidance=1.0):
        solver = DPMSolverMultistep.create(models.schedule, n_steps)
        kw = dict(guidance_scale=guidance, token_index=0, latent_size=64, initial_noise=noise)
        if guidance != 1.0:
            kw["uncond_input_ids"] = uncond
        torch.cuda.synchronize()
        t = time.perf_counter()
        imgs = run_inference(models, solver, example, **kw)
        torch.cuda.synchronize()
        return imgs, time.perf_counter() - t

    run(2)
    run(2, 6.0)
    secs = [run(50)[1] for _ in range(args.runs)]
    log(f"50 steps, guidance 1, batch {B}: s/image {' '.join(f'{s / B:.4f}' for s in secs)} "
        f"(min {min(secs) / B:.4f}); ms per step from the 50- and a 10-step run: "
        f"{(min(secs) - min(run(10)[1] for _ in range(2))) / 40 * 1e3:.2f}")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = run(10)
        # device-side events only: an operator's row repeats its kernels' time
        evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        attr = "self_device_time_total" if hasattr(evs[0], "self_device_time_total") else "self_cuda_time_total"
        busy = sum(getattr(e, attr) for e in evs) / 1e3
        log(f"profile, 10 steps: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
            f"({100 * busy / (wall * 1e3):.1f}% of wall)")
        for e in sorted(evs, key=lambda e: -getattr(e, attr))[:12]:
            log(f"  {getattr(e, attr) / 1e3:9.2f} ms {e.count:6d} x {e.key[:90]}")

    if args.diff:
        with cs.plain_kernels():
            ref1, ref6 = run(50, 1.0)[0], run(10, 6.0)[0]
        d1 = (run(50, 1.0)[0] - ref1).abs().max().item()
        d6 = (run(10, 6.0)[0] - ref6).abs().max().item()
        log(f"max abs pixel diff to the plain run, guidance 1 (limit {cs.G1_ATOL}) {d1:.6g}, "
            f"guidance 6 (limit {cs.CFG_ATOL}) {d6:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
