"""Where a served request's time goes on one H100, from the tree in the
current directory.

    python3 scripts/torch_serve_time.py [--steps N] [--runs N]

SD-1.5-width models with random numpy-seeded weights and the serving flags
(bf16, flash, bf16 scores and norms, fused blocks; chip_smoke.py's models
and request helpers). Prints, each over `--runs` repeats of a host clock
around work that ends in torch.cuda.synchronize():
  - one request's `run_inference` (DPM-Solver++, `--steps` steps) at
    guidance 1 and 6 and at 1, 2 and 4 rows, i.e. UNet batches 1 to 8: what
    a bucket of the dynamic-batching server costs;
  - its parts at one row and guidance 6: conditioning, the denoise loop
    (and the host's time to enqueue it, which equals the whole when the
    host sets the pace), the VAE decode;
  - the same request from a thread started for it: cuDNN keeps its
    execution plans per thread, so a fresh thread builds them again, which
    is why the server warms up on its worker thread.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.getcwd())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from photoverse_tpu_torch.core.schedulers import make_solver
    from photoverse_tpu_torch.engine import inference as inf
    from photoverse_tpu_torch.ops import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    models = cs.serving_models()
    solver = make_solver(models.schedule, "dpm", args.steps)
    kw = dict(token_index=0, latent_size=64)

    def timed(label, fn):
        secs = []
        for _ in range(args.runs + 1):  # the first run warms up and is dropped
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        print(f"{label}: {' '.join(f'{s:.4f}' for s in secs[1:])} s", flush=True)

    def request(rows, guidance):
        example = cs._example(rows, seed=1)
        noise = np.random.RandomState(0).randn(rows, 64, 64, 4).astype(np.float32)
        extra = dict(uncond_input_ids=cs._empty_prompt(rows)) if guidance != 1.0 else {}
        return lambda: inf.run_inference(models, solver, example, guidance_scale=guidance,
                                         initial_noise=noise, **extra, **kw)

    for rows, guidance in ((1, 1.0), (2, 1.0), (1, 6.0), (2, 6.0), (4, 6.0)):
        timed(f"run_inference, {args.steps} steps, {rows} row(s), guidance {guidance:g} "
              f"(UNet batch {rows * (2 if guidance != 1.0 else 1)})", request(rows, guidance))

    dev = models.device
    example = cs._example(1, seed=1)
    with torch.inference_mode():
        px = torch.as_tensor(example["pixel_values_clip"], device=dev).to(models.dtype)
        ids = torch.as_tensor(example["text_input_ids"], device=dev).long()
        pidx = torch.as_tensor(example["concept_placeholder_idx"], device=dev).long()
        empty = torch.as_tensor(cs._empty_prompt(1), device=dev).long()

        def condition():
            concept, id_ctx = inf.encode_condition(models, px, 0)
            text_ctx, _ = models.text_encoder(ids, concept, pidx.reshape(1))
            _, uncond_id = inf.encode_condition(models, torch.zeros_like(px), 0)
            uncond_text, _ = models.text_encoder(empty)
            return text_ctx, id_ctx, uncond_text, uncond_id

        timed("  conditioning (the request and the empty prompt), 1 row", condition)
        ctx = condition()
        lat = torch.randn(1, 64, 64, 4, device=dev)
        timed(f"  denoise, {args.steps} steps, guidance 6, 1 row", lambda: inf.denoise(models, solver, lat, *ctx, 6.0))
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inf.denoise(models, solver, lat, *ctx, 6.0)
        host = time.perf_counter() - t
        torch.cuda.synchronize()
        print(f"  denoise: the host enqueues it in {host:.4f} s, the device is done after "
              f"{time.perf_counter() - t:.4f} s", flush=True)
        timed("  VAE decode, 1 row", lambda: models.vae.decode(out / models.scaling_factor))

    def in_fresh_thread():
        th = threading.Thread(target=request(1, 6.0))
        th.start()
        th.join()

    timed(f"run_inference, {args.steps} steps, 1 row, guidance 6, each from a thread started for it",
          in_fresh_thread)
    return 0


if __name__ == "__main__":
    sys.exit(main())
