"""Smoke run of the PyTorch/H100 port (photoverse_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each one fails the run on error):
  1. device: a CUDA card is required; prints its name and power limit.
  2. build:  compiles photoverse_tpu_torch/csrc/*.cu with nvcc (sm_90a).
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card at the shapes the main path gives it, with CUDA-event times.
  4. pipeline: SD-1.5-width models with random weights from a numpy seed,
     512px identity-conditioned generation (DPM-Solver++ 50 steps,
     guidance 1, two requests with their own noise seeds), then a guidance-6
     run; launch counters, image checks and the deviation from the same run
     with every kernel swapped for its plain version.
The last stdout line is {"ok": true, "device": {...}}; the line before it
is the per-kernel JSON summary.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

# flash: kernel output is bf16 (p is rounded to TF32 inside). With 0.3*randn
# inputs the softmax is near uniform and |out| is only 0.015-0.03, so the
# limit is relative to the largest |out|: 2^-6 of it is 2-4 bf16 ulps there.
# Dropping the last 32 or 64 keys moves it by 9-26% of max|out| (PERF.md).
FLASH_RTOL = 2**-6
# fused block tail: f32 inside with TF32 product operands, output rounded
# to bf16 once; unit-scale activations give |out| < 8, where a bf16 ulp is
# <= 2^-5, so 1/32 is one ulp (the rounding itself is at most half of it)
FUSED_ATOL = 1 / 32
# pipeline: max abs pixel difference (in [-1, 1]) between the kernel run and
# the same run with each kernel swapped for its plain version. Guidance 1:
# the JAX package's envelope for flash/fused on vs off on random weights
# was 0.027. Guidance 6 multiplies each step's eps difference by up to 11,
# and the random-weight bf16 pipeline reads 0.080-0.084 there when the
# kernels are sound (f32 summation order alone moves it that far); planted
# faults read 1.8-2.0 for a dropped identity context or head in the fused
# tail and 0.1007 for 64 dropped flash keys (PERF.md, PR 1 findings).
G1_ATOL = 0.05
CFG_ATOL = 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
              "the port's smoke run needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from photoverse_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so, out = _build.build_library()
    _build.load_library()
    log(f"build: {so} in {time.perf_counter() - t0:.1f}s")
    for line in out.splitlines():  # per kernel: name, registers, spills
        if any(w in line for w in ("Compiling entry", "registers", "spill")):
            log(f"  {line.strip()}")


def _time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _fused_inputs(gen, B, S, C, H, St, K, F, dev):
    import torch

    d = C // H
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*s, scale=1.0, dtype=bf):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(dtype)

    bundle = {
        "ln2g": 1 + rn(C, scale=0.1, dtype=f32), "ln2b": rn(C, scale=0.1, dtype=f32),
        "wq": rn(H, C, d, scale=C**-0.5), "wout": rn(H, d, C, scale=C**-0.5),
        "bout": rn(C, scale=0.1, dtype=f32),
        "ln3g": 1 + rn(C, scale=0.1, dtype=f32), "ln3b": rn(C, scale=0.1, dtype=f32),
        "wpa": rn(C, F, scale=C**-0.5), "wpg": rn(C, F, scale=C**-0.5),
        "bpa": rn(F, scale=0.1, dtype=f32), "bpg": rn(F, scale=0.1, dtype=f32),
        "wo": rn(F, C, scale=F**-0.5), "bo": rn(C, scale=0.1, dtype=f32),
        "ctx": (rn(B, H, St, d), rn(B, H, St, d), rn(B, H, K, d), rn(B, H, K, d)),
    }
    return rn(B, S, C), bundle


def phase_kernels(source_tpu: dict):
    """Every kernel against its plain version at the main path's shapes."""
    import torch

    from photoverse_tpu_torch.ops import flash_sdpa as fs
    from photoverse_tpu_torch.ops import fused_block as fb

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []

    def record(name, route, source, replaces, err, tol, ms, plain_ms, shape):
        ok = bool(np.isfinite(err) and err <= tol)
        log(f"kernel {name} {shape}: max_abs_err {err:.6g} (tol {tol:.6g}) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms {'OK' if ok else 'FAIL'}")
        rows.append(dict(name=name, route=route, source=source, replaces=replaces,
                         shape=shape, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, ok=ok))
        torch.cuda.synchronize()

    flash_cases = [  # (B, Sq, Skv, H, d): the UNet's 64^2 and 32^2 levels, then Skv > Sq
        (2, 4096, 4096, 8, 40), (2, 1024, 1024, 8, 80), (2, 1024, 4096, 8, 40),
    ]
    for B, Sq, Skv, H, d in flash_cases:
        q = (0.3 * torch.randn(B, Sq, H, d, generator=gen, device=dev)).bfloat16()
        k = (0.3 * torch.randn(B, Skv, H, d, generator=gen, device=dev)).bfloat16()
        v = (0.3 * torch.randn(B, Skv, H, d, generator=gen, device=dev)).bfloat16()
        got = fs.flash_sdpa(q, k, v)
        want = fs.flash_sdpa_plain(q.float(), k.float(), v.float())
        err = (got.float() - want).abs().max().item()
        tol = FLASH_RTOL * want.abs().max().item()
        ms = _time_ms(lambda: fs.flash_sdpa(q, k, v), 20)
        plain_ms = _time_ms(lambda: fs.flash_sdpa_plain(q, k, v), 5)
        record("flash_sdpa", "cuda", "photoverse_tpu_torch/csrc/flash_fwd.cu",
               source_tpu["flash_sdpa"], err, tol, ms, plain_ms, [B, Sq, Skv, H, d])

    B, S, H, d = 2, 4096, 1, 512  # the VAE decoder's mid-block attention
    q, k, v = ((0.3 * torch.randn(B, S, H, d, generator=gen, device=dev)).bfloat16() for _ in range(3))
    got = fs.flash_sdpa_stream(q, k, v)
    want = fs.flash_sdpa_plain(q.float(), k.float(), v.float())
    err = (got.float() - want).abs().max().item()
    tol = FLASH_RTOL * want.abs().max().item()
    ms = _time_ms(lambda: fs.flash_sdpa_stream(q, k, v), 10)
    plain_ms = _time_ms(lambda: fs.flash_sdpa_plain(q, k, v), 5)
    record("flash_sdpa_stream", "cuda", "photoverse_tpu_torch/csrc/flash_fwd.cu",
           source_tpu["flash_sdpa_stream"], err, tol, ms, plain_ms, [B, S, S, H, d])

    for K in (1, 5):  # token_index=0 gives K=1; the training path K=5
        B, S, C, H, St, F = 2, 4096, 320, 8, 77, 1280
        h, bundle = _fused_inputs(gen, B, S, C, H, St, K, F, dev)
        got = fb.fused_cross_ff(h, bundle, H)
        want = fb.reference_cross_ff(h.float(), bundle, H)
        err = (got.float() - want).abs().max().item()
        ms = _time_ms(lambda: fb.fused_cross_ff(h, bundle, H), 10)
        plain_ms = _time_ms(lambda: fb.reference_cross_ff(h, bundle, H), 5)
        record("fused_cross_ff", "cuda", "photoverse_tpu_torch/csrc/fused_cross_ff.cu",
               source_tpu["fused_cross_ff"], err, FUSED_ATOL, ms, plain_ms, [B, S, C, H, St, K, F])
    return rows


def _example(B: int, seed: int):
    """A request batch made from a numpy seed: CLIP-normalised-scale pixels,
    random prompt ids (EOT = the highest id at the end) and the placeholder
    at position 5."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 49406, (B, 77))
    ids[:, 0], ids[:, -1] = 49406, 49407
    return {
        "pixel_values_clip": rng.randn(B, 224, 224, 3).astype(np.float32),
        "text_input_ids": ids.astype(np.int64),
        "concept_placeholder_idx": np.full((B,), 5, np.int64),
    }


def _empty_prompt(B: int) -> np.ndarray:
    ids = np.full((B, 77), 49407, np.int64)  # <bos> then <eos> padding
    ids[:, 0] = 49406
    return ids


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel of the main path for its plain PyTorch version at
    the call sites (the comparison run; the wrappers themselves never fall
    back)."""
    from photoverse_tpu_torch.models import unet, vae
    from photoverse_tpu_torch.ops import flash_sdpa as fs
    from photoverse_tpu_torch.ops import fused_block as fb

    with mock.patch.object(unet, "flash_sdpa", fs.flash_sdpa_plain), \
            mock.patch.object(unet, "fused_cross_ff", fb.reference_cross_ff), \
            mock.patch.object(vae, "flash_sdpa_stream", fs.flash_sdpa_plain):
        yield


def phase_pipeline():
    """The port's main path at SD-1.5 width: kernels, then plain versions."""
    import torch

    from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
    from photoverse_tpu_torch.engine.inference import run_inference
    from photoverse_tpu_torch.models.assembly import build_models, init_params
    from photoverse_tpu_torch.ops import _build

    t0 = time.perf_counter()
    models = init_params(build_models(
        dtype=torch.bfloat16, use_flash_attention=True, fast_attention_scores=True,
        fast_norms=True, fused_blocks=True, device="cuda"), seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in models.parameters())
    log(f"pipeline: SD-1.5-width models ({n_params} params, bf16) built in {time.perf_counter() - t0:.1f}s")

    B, steps, cfg_steps = 2, 50, 10
    example = _example(B, seed=1)
    # two requests, each with the noise of its own seed
    noise = np.concatenate([np.random.RandomState(100 + r).randn(1, 64, 64, 4) for r in range(B)]).astype(np.float32)
    uncond = _empty_prompt(B)

    def run(n_steps, guidance):
        solver = DPMSolverMultistep.create(models.schedule, n_steps)
        kw = dict(guidance_scale=guidance, token_index=0, latent_size=64, initial_noise=noise)
        if guidance != 1.0:
            kw["uncond_input_ids"] = uncond
        torch.cuda.synchronize()
        t = time.perf_counter()
        imgs = run_inference(models, solver, example, **kw)
        torch.cuda.synchronize()
        return imgs, time.perf_counter() - t

    # warm-up: cuDNN/cuBLAS algorithm selection, the allocator
    for ctx in (contextlib.nullcontext, plain_kernels):
        with ctx():
            run(2, 1.0)
            run(2, 6.0)

    results = {}
    ok = True
    for name, guidance, n_steps, atol in (("g1", 1.0, steps, G1_ATOL), ("cfg", 6.0, cfg_steps, CFG_ATOL)):
        _build.reset_launch_counts()
        imgs, secs = run(n_steps, guidance)
        counts = dict(_build.launch_counts)
        _build.reset_launch_counts()
        with plain_kernels():
            ref, plain_secs = run(n_steps, guidance)
        plain_counts = dict(_build.launch_counts)
        evals = n_steps
        want = {"flash_sdpa": 10 * evals, "fused_cross_ff": 5 * evals, "flash_sdpa_stream": 1}
        diff = (imgs - ref).abs().max().item()
        finite = bool(torch.isfinite(imgs).all())
        in_range = bool(imgs.min() >= -1 and imgs.max() <= 1)
        shape_ok = tuple(imgs.shape) == (B, 512, 512, 3)
        good = finite and in_range and shape_ok and counts == want and not plain_counts and diff <= atol
        ok &= good
        log(f"pipeline {name}: guidance {guidance}, {n_steps} steps, batch {B}, 512px: "
            f"shape {tuple(imgs.shape)} finite {finite} in [-1,1] {in_range} "
            f"mean {imgs.float().mean().item():.5f} std {imgs.float().std().item():.5f}")
        log(f"  launches {counts} (want {want}); plain run launches {plain_counts or 0}")
        log(f"  max abs pixel diff vs the run on plain versions {diff:.6g} (tol {atol}) "
            f"{'OK' if good else 'FAIL'}")
        log(f"  s/image: kernels {secs / B:.4f} (run {secs:.3f}s), plain versions {plain_secs / B:.4f} "
            f"(run {plain_secs:.3f}s)")
        results[name] = dict(counts=counts, diff=diff, s_per_image=secs / B,
                             plain_s_per_image=plain_secs / B, ok=good)
    log(f"pipeline: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return results, ok


# file:line of each TPU kernel's pallas_call in the JAX package
TPU_KERNELS = {
    "flash_sdpa": "photoverse_tpu/ops/flash_sdpa.py:154",
    "flash_sdpa_stream": "photoverse_tpu/ops/flash_sdpa.py:462",
    "fused_cross_ff": "photoverse_tpu/ops/fused_block.py:231",
}


def main() -> int:
    phase_device()
    import torch

    phase_build()
    rows = phase_kernels(TPU_KERNELS)
    results, pipe_ok = phase_pipeline()
    launches = results["g1"]["counts"]  # the 50-step main-path run
    ok = all(r["ok"] for r in rows) and pipe_ok and all(launches.get(n, 0) > 0 for n in TPU_KERNELS)
    summary = {"kernels": []}
    for name in TPU_KERNELS:
        mine = [r for r in rows if r["name"] == name]
        first = mine[0]  # the main-path shape
        summary["kernels"].append({
            "name": name, "route": first["route"], "source": first["source"],
            "replaces": first["replaces"], "launches": launches.get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
        })
    if not ok:
        log("chip_smoke: a phase failed")
        return 1
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
