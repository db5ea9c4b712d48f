"""Smoke run of the PyTorch/H100 port (photoverse_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each one fails the run on error):
  1. device: a CUDA card is required; prints its name and power limit.
  2. build:  compiles photoverse_tpu_torch/csrc/*.cu with nvcc (sm_90a).
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card at the shapes the main paths give it, the server's largest
     batch included (and at ragged lengths for the flash forwards and the
     flash backward; kernel 1 also at SDXL's two d=64 levels, one launch
     a call), with CUDA-event times
     beside the bound from ops/bounds.py and one PyTorch library call on the
     same inputs; planted faults show that each kernel's limit catches them.
  4. pipeline: SD-1.5-width models with random weights from a numpy seed,
     512px identity-conditioned generation (DPM-Solver++ 50 steps,
     guidance 1, two requests with their own noise seeds), then a guidance-6
     run; launch counters, image checks and the deviation from the same run
     with every kernel swapped for its plain version.
  5. samplers: the same models through `run_inference` once per sampler
     name (10 steps, guidance 1, batch 1, noise and ancestral noise passed
     in), kernels against the same run on the plain versions, with the
     launch counts that follow each solver's number of UNet evaluations;
     then one run with an identity mask (the fused tail must not launch)
     and one from a noised image (the VAE encoder takes the stream kernel).
  6. serve: a dynamic-batching PhotoVerseService on those models (the
     --fast flags, --max_batch 4), entered at submit() with numpy examples
     and a tokenizer made from a small synthetic vocabulary: concurrent
     requests coalesce and equal their solo runs on a sequential service
     within a limit that a planted fault (a row served with another row's
     noise, or with one step of it) exceeds, for dpm and for euler_a; three
     rows pad to bucket 4, equal their solo runs and equal the same batch
     on the plain versions; different step counts do not coalesce; a burst of 12 mixed requests
     from 4 threads is served whole and drained; a full queue is refused.
     An exception in a service thread fails the run.
  7. train: the canonical recipe's train step at SD-1.5 width (bf16 with f32
     trainable masters, flash, LoRA 128/1/0.1, lr 1e-5, a random ArcFace,
     512px uint8 batches of 4, gradient accumulation 2 with the face branch
     on each window's last micro-step: 2 rows, 10 inner steps, guidance 2,
     face_weight_scale 2), 4 micro-steps = 2 optimizer updates; finite
     losses, moved trainables, untouched frozen weights, exact launch counts
     per micro-step, bit-identical repeat gradients, the same micro-step
     on the plain versions (plain autograd) against limits that planted
     faults exceed, and every training-kernel call of that micro-step
     against its plain version on the call's own inputs; the recipe's face
     micro-step (batch 8, 4 face rows) without and with remat,
     bit-identical, and with a planted unrestored dropout generator, which
     must differ.
  8. train-cli: first the user's files: an SD-1.5-layout directory written
     from random numpy-seeded weights (scripts/torch_make_random_checkpoint.py),
     32 identities as 512px JPEGs, and a synthetic archive laid out as the
     published CelebAMask-HQ zip (100 identities: 1024px photos, 512px label
     PNGs, a skipped label among them); cli.prepare_celebhqmasks extracts,
     fuses and splits it, the fused masks must equal a numpy fusion of the
     same files and the split must be 90/10 with every image beside its own
     mask. Then cli/train.py, the user's entry point, with --recipe canonical
     on the prepared train split (--img_subfolder images --mask_subfolder
     masks): batch 16 as micro-batches of
     8 x 2, remat, the random ArcFace with the fused face window, uint8
     transfer, async checkpoints in both formats every 2 steps, a sample
     grid. SIGTERM once the first stepped checkpoint is on disk (a native
     checkpoint at the next optimizer step, then return), resume from it for
     three steps (the state load_progress returns equal to the state at
     SIGTERM bit for bit), exact launches per micro-step under remat; it
     prints s per optimizer step, peak memory, checkpoint write times, the
     masked loader's rate and a profiled step's device-busy share. The model
     directory and the files are written once, for this phase and the
     next ones (phases 9-11 train and generate on the unmasked identities).
  9. identity: on the same directory, (b) cli/generate.py with
     --int8_conditioning --fast in process (512px, batch 2, 10 steps;
     launches exact, torch._int_mm's included; the concept embedding and
     the identity context against the same call on the bf16 route), (a) on
     the models it loaded, int8 against bf16 at batch 64 (cosines of CLIP-L
     and of ViT-L/14's last and collected layers, one layer's _int_mm
     accumulators against the CPU's int32 product, conditioning times in
     turns at batch 64 and 1, an {"int8_route": ...} line), (c) the native
     tokenizer built on this host against the Python one and a
     --native_tokenizer service serving one request, (d) cli/train.py
     --recipe canonical --face_loss facenet for 2 steps (launches per
     micro-step as ArcFace's), (e) cli/eval_face_similarity.py --json on
     (b)'s images with random FaceNet, ArcFace and MTCNN files, on the card
     against --cpu, and MTCNN's boxes on the card against the CPU's.
 10. parallel: on the same directory, `python -m torch.distributed.run
     --nproc_per_node 2` (a child process with a time limit; the two ranks
     share the card, so the backend rule picks gloo) runs, in each rank,
     cli.generate --fast under --sharding data, tensor and spatial (512px,
     batch 2, 10 steps) and then cli.serve --sharding tensor. Each mode's
     PNGs against the one-process run of the same CLI at the served-vs-solo
     limits, exact launches per rank (data: kernels 1, 4, 6 as one process;
     tensor / spatial: kernel 1 only, 10 per UNet evaluation), s/image per
     mode beside one process, a planted fault per mode that must read above
     the limit; the service answers two requests over HTTP as a one-process
     service does, and SIGTERM at rank 0 stops every rank with exit 0. The
     kernel phase holds kernel 1 at the shapes a rank gives it there.
 11. parallel-train: on the same directory, two ranks of
     `torch.distributed.run` run cli.train --recipe canonical (batch 8 as
     4 x 2, 2 optimizer steps) under --shard_optimizer_state,
     --tensor_parallel 2 and --fsdp (SIGTERM at one rank after step 1, then
     resumed to step 2 from its checkpoint), the models loaded once a rank:
     launches per rank and micro-step exactly one process's (kernels 2 and 3
     on each rank's 4 heads under TP), the first diffusion micro-step's
     gradient gathered against one process's on the same weights, batch and
     draws, planted faults (summed data gradients, no f operator, unwritten
     ZeRO-1 slices, stale FSDP shards) beyond their limits, the resumed
     state equal to the state at SIGTERM bit for bit; s per optimizer step,
     peak memory and collectives per micro-step per mode. The kernel phase
     holds kernels 2 and 3 at a TP rank's share of the recipe's shapes.
 12. soak: scripts/torch_train_soak.py as child processes on the same model
     directory and prepared split: cli.train --recipe canonical to step 4,
     a checkpoint and a sample grid every 2 steps, SIGTERM once step 2 is
     logged, then a fresh process resumed from the newest native
     checkpoint. Its record must say ok: the resume neither skips nor
     repeats a step, the losses are finite and both phases logged the
     in-train face_similarity.
The last stdout line is {"ok": true, "device": {...}}; the line before it
is the per-kernel JSON summary (`launches` from the 50-step generation or
the training micro-steps, `serve_launches` from the serve phase's first
coalesced batch).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np

# flash: kernel output is bf16 (p, and in the backward ds, are rounded to
# bf16 inside for the products that take them). With 0.3*randn inputs the softmax is near
# uniform and |out| is only 0.015-0.03, so the limit is relative to the
# largest |out|: 2^-6 of it is 2-4 bf16 ulps there. Dropping the last 32 or
# 64 keys moves it by 9-26% of max|out| (PERF.md).
FLASH_RTOL = 2**-6
# the lse output of the training forwards: an error e in lse scales the
# backward's recomputed p by exp(-e), so it is held absolutely, below a
# bf16 half-ulp in relative terms (the kernel computes it in f32)
LSE_ATOL = 2**-10
# fused block tail: f32 inside with bf16-pair product operands, output
# rounded to bf16 once; unit-scale activations give |out| < 8, where a bf16
# ulp is <= 2^-5, so 1/32 is one ulp (the rounding itself is at most half)
FUSED_ATOL = 1 / 32
# GroupNorm over channels-last activations: f32 moments and affine, one
# rounding to bf16, as its plain version; weights 1 +- 0.1 keep |out| < 8,
# where a bf16 ulp is <= 2^-5, so 1/32 is one ulp
GN_ATOL = 1 / 32
# dual-context cross-attention: the probabilities and the output are each
# rounded to bf16 once (relative error <= 2^-8), so the output is within
# 2^-8 (max |v| + max |v_ip| + max |out|) of the f32 plain version
DUAL_RTOL = 2**-8
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
# train phase, the face micro-step with the kernels against the same
# micro-step on the plain versions (same weights, batch and draws): the
# largest relative loss difference and, per trainable group, the relative
# L2 distance of the gradients. Sound kernels read 1.3e-4 and at most
# 0.0069 (text_adapter); planted faults read 0.020-0.032 for dk/dv of 64
# keys or dq dropped in the flash backward, 0.23-0.35 for the lse rolled by
# one row, 0.40-0.58 for a detached flash output (the runs are
# deterministic; PERF.md, PR 2). These sums over whole groups dilute one
# layer's share, so beside them every call of the training kernels in the
# run (kernels 2, 3 and 5) is held against its plain version on that
# call's own inputs at the kernel rows' limits: sound calls read at most
# 0.24 of their limit, the planted faults 64-3697 times it.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_RTOL = 0.015
# serve phase: a request served in a coalesced batch against the same
# request alone on a sequential service, in uint8 steps (of 255). The noise
# is the same by construction; what differs is the batch size, for which
# cuDNN and cuBLAS pick other algorithms and tile counts, and at guidance 6
# the random-weight bf16 pipeline amplifies that rounding as it amplifies
# the kernels' (CFG_ATOL above is 13 uint8 steps for the same reason). A
# coalesced pair reads at most 8 steps from its solo runs under dpm, 11-12
# under euler_a (25 steps, guidance 6) and 11 in a padded batch of 4, with a
# mean absolute difference of 0.91-1.31 steps; a row served with another
# row's noise reads 255 and 58-68, a row that takes another row's step noise
# at one step of 25 reads 103 and 13.5 (step 2) or 19 and 2.4 (step 12)
# (PERF.md, the serving slice's findings). Both measures are held.
SERVE_SAME_U8 = 16
SERVE_SAME_MEAN_U8 = 2.0
# serve phase: a padded batch of the server on the kernels against the same
# batch with every kernel swapped for its plain version, in uint8 steps:
# CFG_ATOL of [-1, 1] is 12.75 steps, and packing each side to uint8 can
# add one
SERVE_PLAIN_U8 = 14
# seconds a request thread of the serve phase may take before the run fails
SERVE_TIMEOUT_S = 300
# identity phase: W8A8 int8 conditioning against the same bf16 encoders, as
# the cosine of the flattened outputs; the JAX package's bar
# (tests/test_quant.py)
INT8_COS = 0.99
# identity phase: the eval CLI's scores on the card against --cpu (both f32
# without TF32), and MTCNN boxes on the card against the CPU in pixels
EVAL_SCORE_ATOL = 1e-3
MTCNN_BOX_ATOL = 0.5
# random MTCNN weights: the face logit's bias of R- and O-Net, and the
# P-Net biases tried in turn until a box of both the input photo and a
# generated image survives the default thresholds (0.6, 0.7, 0.7); the
# lower the P-Net bias, the fewer of its windows pass and the faster the
# cascade's host work (PERF.md)
MTCNN_FACE_BIAS = (3.0, 3.0)
MTCNN_PNET_BIASES = (0.2, 0.5, 1.0, 2.0)


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
    name = ""
    for line in out.splitlines():  # per kernel: name with template arguments, spills, registers
        if "Compiling entry" in line:
            name = line.split("'")[1] if "'" in line else line
            name = name[max(name.find("kernel") - 16, 0):][:60]  # its name and template arguments
        elif "spill" in line:
            log(f"  {name}: {line.strip()}")
        elif "Used" in line and "registers" in line:
            log(f"  {name}: {line.split(':', 1)[-1].strip()}")


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


def _device_ms(fn, iters: int):
    """Device time of one call: the sum of its kernels' time in a
    torch.profiler trace. The host enqueues a call through a Python wrapper
    in 30-90 us, so for a shorter kernel the CUDA-event time of a run of
    launches reads the host's pace and this reads the card's. A trace now
    and then comes back without device events: it is taken again, and after
    three empty ones the answer is None (not measured), never another
    clock's reading under this name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        attr = "self_device_time_total" if evs and hasattr(evs[0], "self_device_time_total") else "self_cuda_time_total"
        total = sum(getattr(e, attr) for e in evs)
        if total > 0:
            return total / 1e3 / iters
    return None


def _fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def _fused_inputs(gen, B, S, C, H, St, K, F, dev):
    import torch

    d = C // H
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*s, scale=1.0, dtype=bf):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(dtype)

    bundle = {
        "ln2g": 1 + rn(C, scale=0.1, dtype=f32), "ln2b": rn(C, scale=0.1, dtype=f32),
        "wq": rn(C, C, scale=C**-0.5), "wout": rn(C, C, scale=C**-0.5),
        "bout": rn(C, scale=0.1, dtype=f32),
        "ln3g": 1 + rn(C, scale=0.1, dtype=f32), "ln3b": rn(C, scale=0.1, dtype=f32),
        "wpa": rn(F, C, scale=C**-0.5), "wpg": rn(F, C, scale=C**-0.5),
        "bpa": rn(F, scale=0.1, dtype=f32), "bpg": rn(F, scale=0.1, dtype=f32),
        "wo": rn(C, F, scale=F**-0.5), "bo": rn(C, scale=0.1, dtype=f32),
        "ctx": (rn(B, H, St, d), rn(B, H, St, d), rn(B, H, K, d), rn(B, H, K, d)),
    }
    return rn(B, S, C), bundle


def _sdpa_backend(q, k, v) -> str:
    """The backend one scaled_dot_product_attention call picks for these
    (B, H, S, d) inputs, by name where this PyTorch tells."""
    import torch

    choice = getattr(torch, "_fused_sdp_choice", None)
    if choice is None:
        return "unknown"
    names = {0: "math", 1: "flash", 2: "efficient", 3: "cudnn"}
    code = int(choice(q, k, v))
    return names.get(code, f"backend {code}")


def phase_kernels(source_tpu: dict):
    """Every kernel against its plain version at the main path's shapes,
    timed beside its bound and one library call on the same inputs."""
    import torch
    import torch.nn.functional as nnf

    from photoverse_tpu_torch.ops import bounds
    from photoverse_tpu_torch.ops import dual_cross_attn as dca
    from photoverse_tpu_torch.ops import flash_sdpa as fs
    from photoverse_tpu_torch.ops import fused_block as fb
    from photoverse_tpu_torch.ops import group_norm as gn
    from photoverse_tpu_torch.utils import trace

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    wgmma_src = "photoverse_tpu_torch/csrc/flash_fwd_wgmma.cu"
    stream_src = "photoverse_tpu_torch/csrc/flash_fwd_stream.cu"

    def record(name, route, source, replaces, err, tol, fn, iters, plain_ms, shape, work, library=None,
               ok=None):
        """Times `fn` (the kernel's wrapper on this row's inputs) and the
        library call, each by CUDA events over a run of launches (`ms`,
        `library_ms`) and by the profiler's device time (`device_ms`,
        `library_device_ms`), and adds the row."""
        ok = bool(np.isfinite(err) and err <= tol) if ok is None else ok
        ms, dev_ms = _time_ms(fn, iters), _device_ms(fn, iters)
        lib_ms = lib_dev = None
        if library is not None:
            lib_ms, lib_dev = _time_ms(library, iters), _device_ms(library, iters)
        bound = bounds.bound_ms(*work)
        lib = "none" if library is None else f"{lib_ms:.4f} ms (device {_fmt_ms(lib_dev)})"
        log(f"kernel {name} {shape}: max_abs_err {err:.6g} (tol {tol:.6g}) "
            f"kernel {ms:.4f} ms (device {_fmt_ms(dev_ms)}), bound {bound:.4f} ms (by {bounds.bound_by(*work)}), "
            f"plain {plain_ms:.4f} ms, library call {lib} {'OK' if ok else 'FAIL'}")
        rows.append(dict(name=name, route=route, source=source, replaces=replaces,
                         shape=shape, max_abs_err=err, tol=tol, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=bounds.bound_by(*work), library_ms=lib_ms,
                         library_device_ms=lib_dev, ok=ok))
        torch.cuda.synchronize()

    def sdpa(q, k, v, label=None):
        """One scaled_dot_product_attention call on the same bf16 inputs in
        (B, H, S, d) layout; timed here, used nowhere in the port."""
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if label:
            log(f"  scaled_dot_product_attention for {label} takes the {_sdpa_backend(qt, kt, vt)} backend")
        return lambda: nnf.scaled_dot_product_attention(qt, kt, vt)

    def check(ok, what):
        log(f"  {what} {'OK' if ok else 'FAIL'}")
        if not ok:
            rows.append(dict(name=what, ok=False))

    def fault(caught, what):
        log(f"  planted fault, {what}: {'caught' if caught else 'NOT CAUGHT'}")
        faults_caught.append(caught)

    faults_caught = []

    flash_cases = [  # (B, Sq, Skv, H, d): the UNet's 64^2 and 32^2 levels, then Skv > Sq
        (2, 4096, 4096, 8, 40), (2, 1024, 1024, 8, 80), (2, 1024, 4096, 8, 40),
        # the server's bucket 4 at guidance 6 (UNet batch 8); batch 1 (the
        # samplers phase) follows the ragged cases below
        (8, 4096, 4096, 8, 40), (8, 1024, 1024, 8, 80),
        # one rank's share under --sharding at 2 ranks (the parallel phase):
        # tensor, 4 local heads; spatial, the local query rows against the
        # gathered keys
        (2, 4096, 4096, 4, 40), (2, 1024, 1024, 4, 80), (2, 2048, 4096, 8, 40), (2, 512, 1024, 8, 80),
        # SDXL's 128^2 and 64^2 levels at UNet batch 8 (sdxl-serve-saturated-g5)
        (8, 4096, 4096, 10, 64), (8, 1024, 1024, 20, 64),
    ]
    for B, Sq, Skv, H, d in flash_cases:
        q = (0.3 * torch.randn(B, Sq, H, d, generator=gen, device=dev)).bfloat16()
        k = (0.3 * torch.randn(B, Skv, H, d, generator=gen, device=dev)).bfloat16()
        v = (0.3 * torch.randn(B, Skv, H, d, generator=gen, device=dev)).bfloat16()
        with trace.counting("launch.") as launched:
            got = fs.flash_sdpa(q, k, v)
        check(launched == {"flash_sdpa": 1}, f"flash_sdpa {[B, Sq, Skv, H, d]} launches {launched}")
        want = fs.flash_sdpa_plain(q.float(), k.float(), v.float())
        err = (got.float() - want).abs().max().item()
        tol = FLASH_RTOL * want.abs().max().item()
        plain_ms = _time_ms(lambda: fs.flash_sdpa_plain(q, k, v), 5)
        record("flash_sdpa", "cuda", wgmma_src, source_tpu["flash_sdpa"], err, tol,
               lambda: fs.flash_sdpa(q, k, v), 20, plain_ms,
               [B, Sq, Skv, H, d], bounds.flash_fwd(B, Sq, Skv, H, d), sdpa(q, k, v))
        if B == 2 and Sq == Skv and d == 40:
            dropped = fs.flash_sdpa(q, k[:, :-64], v[:, :-64])
            e = (dropped.float() - want).abs().max().item()
            fault(e > tol, f"flash_sdpa last 64 keys dropped: err {e:.6g} (tol {tol:.6g})")
    # lengths that are no multiple of the 64/128-row and 64-key tiles, keys
    # shorter than one tile, batch 1 and 4: the TMA boxes' zero fill and the
    # masks of the last tile; then the two levels at batch 1, as the
    # samplers phase runs them
    for B, Sq, Skv, H, d in ((1, 1000, 4000, 8, 40), (4, 333, 77, 8, 80), (2, 4000, 1000, 8, 40),
                             (1, 77, 77, 8, 80), (1, 4096, 4096, 8, 40), (1, 1024, 1024, 8, 80)):
        q = (0.3 * torch.randn(B, Sq, H, d, generator=gen, device=dev)).bfloat16()
        k = (0.3 * torch.randn(B, Skv, H, d, generator=gen, device=dev)).bfloat16()
        v = (0.3 * torch.randn(B, Skv, H, d, generator=gen, device=dev)).bfloat16()
        want = fs.flash_sdpa_plain(q.float(), k.float(), v.float())
        tol = FLASH_RTOL * want.abs().max().item()
        got = fs.flash_sdpa(q, k, v)
        err = (got.float() - want).abs().max().item()
        same = torch.equal(got, fs.flash_sdpa(q, k, v))
        check(err <= tol and same, f"flash_sdpa ragged {[B, Sq, Skv, H, d]}: max_abs_err {err:.6g} "
              f"(tol {tol:.6g}), repeat bit-identical {same}")

    # the VAE's mid-block attention: decode of two requests (the pipeline
    # phase), of the server's bucket 4, of one request (the samplers phase),
    # and the train-CLI phase's encode of its micro-batch of 8
    S, H, d = 4096, 1, 512
    for B in (2, 4, 1, 8):
        q, k, v = ((0.3 * torch.randn(B, S, H, d, generator=gen, device=dev)).bfloat16() for _ in range(3))
        got = fs.flash_sdpa_stream(q, k, v)
        want = fs.flash_sdpa_plain(q.float(), k.float(), v.float())
        err = (got.float() - want).abs().max().item()
        tol = FLASH_RTOL * want.abs().max().item()
        plain_ms = _time_ms(lambda: fs.flash_sdpa_plain(q, k, v), 5)
        record("flash_sdpa_stream", "cuda", stream_src, source_tpu["flash_sdpa_stream"], err, tol,
               lambda: fs.flash_sdpa_stream(q, k, v), 10, plain_ms, [B, S, S, H, d],
               bounds.flash_fwd(B, S, S, H, d), sdpa(q, k, v, label="d=512" if B == 2 else None))
        if B == 2:
            dropped = fs.flash_sdpa_stream(q, k[:, :-32], v[:, :-32])
            e = (dropped.float() - want).abs().max().item()
            fault(e > tol, f"flash_sdpa_stream last 32 keys dropped: err {e:.6g} (tol {tol:.6g})")
    # keys longer than queries, a last tile shorter than a 64-row box, fewer
    # rows than one block
    for B, Sq, Skv, H, d in ((1, 1000, 4000, 1, 512), (1, 77, 77, 1, 512)):
        q = (0.3 * torch.randn(B, Sq, H, d, generator=gen, device=dev)).bfloat16()
        k = (0.3 * torch.randn(B, Skv, H, d, generator=gen, device=dev)).bfloat16()
        v = (0.3 * torch.randn(B, Skv, H, d, generator=gen, device=dev)).bfloat16()
        want, want_lse = fs.flash_fwd_lse_plain(q.float(), k.float(), v.float())
        tol = FLASH_RTOL * want.abs().max().item()
        got = fs.flash_sdpa_stream(q, k, v)
        err = (got.float() - want).abs().max().item()
        got2, lse = fs.flash_fwd_lse(q, k, v)
        lse_err = (lse - want_lse).abs().max().item()
        same = torch.equal(got, got2) and torch.equal(got, fs.flash_sdpa_stream(q, k, v))
        check(err <= tol and lse_err <= LSE_ATOL and same,
              f"flash_sdpa_stream ragged {[B, Sq, Skv, H, d]}: max_abs_err {err:.6g} (tol {tol:.6g}), lse err "
              f"{lse_err:.3g} (tol {LSE_ATOL:.3g}), lse variant and repeat bit-identical {same}")

    # token_index=0 gives K=1, the training path K=5; batch 8 is the
    # server's bucket 4 at guidance 6
    for B, K in ((2, 1), (2, 5), (8, 1)):
        S, C, H, St, F = 4096, 320, 8, 77, 1280
        h, bundle = _fused_inputs(gen, B, S, C, H, St, K, F, dev)
        got = fb.fused_cross_ff(h, bundle, H)
        want = fb.reference_cross_ff(h.float(), bundle, H)
        err = (got.float() - want).abs().max().item()
        plain_ms = _time_ms(lambda: fb.reference_cross_ff(h, bundle, H), 5)
        record("fused_cross_ff", "cuda", "photoverse_tpu_torch/csrc/fused_cross_ff.cu",
               source_tpu["fused_cross_ff"], err, FUSED_ATOL, lambda: fb.fused_cross_ff(h, bundle, H), 10,
               plain_ms, [B, S, C, H, St, K, F],
               bounds.fused_cross_ff(B, S, C, H, St, K, F))  # no single library call computes it
        if (B, K) == (2, 1):
            kT, vT, kI, vI = bundle["ctx"]
            no_id = dict(bundle, ctx=(kT, vT, kI, torch.zeros_like(vI)))
            e = (fb.fused_cross_ff(h, no_id, H).float() - want).abs().max().item()
            fault(e > FUSED_ATOL, f"fused_cross_ff identity context dropped: err {e:.6g} (tol {FUSED_ATOL:.6g})")
            one_head = vT.clone()
            one_head[:, 3] = 0
            e = (fb.fused_cross_ff(h, dict(bundle, ctx=(kT, one_head, kI, vI)), H).float()
                 - want).abs().max().item()
            fault(e > FUSED_ATOL, f"fused_cross_ff one head's text values dropped: err {e:.6g} "
                  f"(tol {FUSED_ATOL:.6g})")

    # GroupNorm over channels-last activations, 32 groups: the UNet's first
    # level at batch 16 (a ResNet block's norm2 with its time embedding and
    # SiLU), its widest concatenation at 8^2, the VAE decoder's last level at
    # batch 8 and 1. Library: the add, F.group_norm and F.silu on the same
    # values in NCHW, as the unfused layers ran them
    for N, C, HW, add, silu in ((16, 320, 64, True, True), (16, 2560, 8, True, True), (8, 128, 512, False, True),
                                (1, 128, 512, False, True)):
        x = (1.5 + 2 * torch.randn(N, HW, HW, C, generator=gen, device=dev)).bfloat16().permute(0, 3, 1, 2)
        w = (1 + 0.1 * torch.randn(C, generator=gen, device=dev)).bfloat16()
        b = (0.1 * torch.randn(C, generator=gen, device=dev)).bfloat16()
        t = torch.randn(N, C, generator=gen, device=dev).bfloat16() if add else None
        got = gn.group_norm_nhwc(x, w, b, 32, 1e-5, t, silu)
        want = gn.group_norm_nhwc_plain(x, w, b, 32, 1e-5, t, silu)
        err = (got.float() - want.float()).abs().max().item()
        plain_ms = _time_ms(lambda: gn.group_norm_nhwc_plain(x, w, b, 32, 1e-5, t, silu), 5)
        xn, t4 = x.contiguous(), None if t is None else t[:, :, None, None]

        def library(xn=xn, t4=t4, w=w, b=b, silu=silu):
            y = nnf.group_norm(xn if t4 is None else xn + t4, 32, w, b, 1e-5)
            return nnf.silu(y) if silu else y

        record("group_norm_nhwc", "cuda", "photoverse_tpu_torch/csrc/group_norm_nhwc.cu",
               source_tpu["group_norm_nhwc"], err, GN_ATOL, lambda: gn.group_norm_nhwc(x, w, b, 32, 1e-5, t, silu),
               20, plain_ms, [N, C, HW, HW], bounds.group_norm(N, HW * HW, C, add), library)
        same = torch.equal(got, gn.group_norm_nhwc(x, w, b, 32, 1e-5, t, silu))
        check(same and got.is_contiguous(memory_format=torch.channels_last),
              f"group_norm_nhwc {[N, C, HW, HW]}: channels-last output, repeat bit-identical {same}")
        if add:
            e = (gn.group_norm_nhwc(x, w, b, 32, 1e-5, None, silu).float() - want.float()).abs().max().item()
            fault(e > GN_ATOL, f"group_norm_nhwc {[N, C, HW, HW]} time embedding dropped: err {e:.6g} "
                  f"(tol {GN_ATOL:.6g})")
        del x, got, want, xn

    # the unfused blocks' dual-context cross-attention, 77 text rows and the
    # serving path's one identity row, unit-scale inputs: SDXL's two levels
    # at UNet batch 8, SD-1.5's 32^2, 16^2 and 8^2 levels at batch 16 and its
    # 64^2 level at the recipe's batch 8 (training's no-grad face prefix).
    # Against the plain version in f32 (`plain_ms`) at DUAL_RTOL, beside the
    # einsum route's own error; the "library call" is the einsum route on the
    # bf16 inputs, what the UNet ran before the kernel
    for B, S, H, d in ((8, 4096, 10, 64), (8, 1024, 20, 64), (16, 1024, 8, 80), (16, 256, 8, 160), (16, 64, 8, 160),
                       (8, 4096, 8, 40)):
        St, K = 77, 1
        ts = tuple(torch.randn(B, n, H, d, generator=gen, device=dev).bfloat16() for n in (S, St, St, K, K))
        f32 = tuple(t.float() for t in ts)
        with trace.counting("launch.") as launched:
            got = dca.dual_cross_attention(*ts)
        want = dca.dual_cross_attention_plain(*f32)
        err = (got.float() - want).abs().max().item()
        tol = DUAL_RTOL * sum(t.abs().max().item() for t in (f32[2], f32[4], want))
        route_err = (dca.dual_cross_attention_plain(*ts).float() - want).abs().max().item()
        log(f"  dual_cross_attn {[B, S, H, d, St, K]}: the einsum route's max_abs_err {route_err:.6g}")
        plain_ms = _time_ms(lambda: dca.dual_cross_attention_plain(*f32), 5)
        record("dual_cross_attn", "cuda", "photoverse_tpu_torch/csrc/dual_cross_attn.cu",
               source_tpu["dual_cross_attn"], err, tol, lambda: dca.dual_cross_attention(*ts), 20, plain_ms,
               [B, S, H, d, St, K], bounds.flash_fwd(B, S, St + K, H, d), lambda: dca.dual_cross_attention_plain(*ts))
        same = torch.equal(got, dca.dual_cross_attention(*ts))
        check(launched == {"dual_cross_attn": 1} and same,
              f"dual_cross_attn {[B, S, H, d, St, K]}: launches {launched}, repeat bit-identical {same}")
        if (S, H) == (4096, 10):
            e = (dca.dual_cross_attention(*ts[:4], torch.zeros_like(ts[4])).float() - want).abs().max().item()
            fault(e > tol, f"dual_cross_attn identity values dropped: err {e:.6g} (tol {tol:.6g})")
            e = (dca.dual_cross_attention(ts[0], ts[1][:, :76], ts[2][:, :76], *ts[3:]).float()
                 - want).abs().max().item()
            fault(e > tol, f"dual_cross_attn last text row dropped: err {e:.6g} (tol {tol:.6g})")
        del ts, f32, got, want

    # the training kernels on unit-scale inputs: out, dq, dk and dv held at
    # FLASH_RTOL of their own max |.|, lse at LSE_ATOL
    def rel_err(got, want):
        """(worst error, its limit, all within) over the outputs; a (B, H, S)
        f32 output is the lse."""
        errs = []
        for g, w in zip(got, want):
            lim = LSE_ATOL if g.dim() == 3 else FLASH_RTOL * w.float().abs().max().item()
            errs.append(((g.float() - w.float()).abs().max().item(), lim))
        log(f"  outputs (err / limit): {', '.join(f'{e:.4g} / {t:.4g}' for e, t in errs)}")
        worst = max(errs, key=lambda e: e[0] / e[1])
        return worst[0], worst[1], all(e <= t for e, t in errs)

    def planted(name, what, got, want):
        err, tol, within = rel_err(got, want)
        fault(not within, f"{name} {what}: err {err:.6g} (tol {tol:.6g})")

    # the train phase's shapes: its UNet grad evals run batch 4 (4 rows, or
    # the face branch's 2 rows doubled by guidance), its face decode 2 rows;
    # then the canonical recipe's (the train-CLI phase): micro-batch 8, and
    # the face branch's 4 rows doubled by guidance, its decode 4 rows; then
    # one tensor-parallel rank's share of the recipe's micro-batch 8 at
    # --tensor_parallel 2: 4 local heads (the parallel-train phase)
    lse_cases = [  # (kernel, B, S, H, d): the UNet's two levels, the VAE
        ("flash_sdpa_fwd_lse", 4, 4096, 8, 40), ("flash_sdpa_fwd_lse", 4, 1024, 8, 80),
        ("flash_stream_fwd_lse", 2, 4096, 1, 512),
        ("flash_sdpa_fwd_lse", 8, 4096, 8, 40), ("flash_sdpa_fwd_lse", 8, 1024, 8, 80),
        ("flash_stream_fwd_lse", 4, 4096, 1, 512),
        ("flash_sdpa_fwd_lse", 8, 4096, 4, 40), ("flash_sdpa_fwd_lse", 8, 1024, 4, 80),
    ]
    for name, B, S, H, d in lse_cases:
        q, k, v = (torch.randn(B, S, H, d, generator=gen, device=dev).bfloat16() for _ in range(3))
        got = fs.flash_fwd_lse(q, k, v)
        want = fs.flash_fwd_lse_plain(q.float(), k.float(), v.float())
        err, tol, within = rel_err(got, want)
        plain_ms = _time_ms(lambda: fs.flash_fwd_lse_plain(q, k, v), 5)
        record(name, "cuda", stream_src if d == 512 else wgmma_src, source_tpu[name],
               err, tol, lambda: fs.flash_fwd_lse(q, k, v), 10, plain_ms, [B, S, S, H, d],
               bounds.flash_fwd(B, S, S, H, d, with_lse=True), sdpa(q, k, v), ok=within)
        if name == "flash_sdpa_fwd_lse" and d == 40 and B == 4:
            planted(name, "lse off by one row", (got[0], got[1].roll(1, dims=-1)), want)
        if name == "flash_stream_fwd_lse" and B == 2:
            planted(name, "last 64 keys dropped",
                    fs.flash_fwd_lse(q, k[:, :-64], v[:, :-64]), want)

    # the train phase's batch 4, then the recipe's micro-batch 8, then its
    # tensor-parallel rank's 4 local heads
    for B, S, H, d in ((4, 4096, 8, 40), (4, 1024, 8, 80), (8, 4096, 8, 40), (8, 1024, 8, 80),
                       (8, 4096, 4, 40), (8, 1024, 4, 80)):
        q, k, v = (torch.randn(B, S, H, d, generator=gen, device=dev).bfloat16() for _ in range(3))
        out, lse = fs.flash_fwd_lse_plain(q, k, v)
        g = torch.randn(B, S, H, d, generator=gen, device=dev).bfloat16()
        got = fs.flash_bwd(q, k, v, out, lse, g)
        want = fs.flash_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse, g.float())
        err, tol, within = rel_err(got, want)
        plain_ms = _time_ms(lambda: fs.flash_bwd_plain(q, k, v, out, lse, g), 3)
        # library yardstick: autograd through one scaled_dot_product_attention call's output
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        lib_out = nnf.scaled_dot_product_attention(qt, kt, vt)
        gt = g.transpose(1, 2).contiguous()
        record("flash_bwd", "cuda", "photoverse_tpu_torch/csrc/flash_bwd.cu", source_tpu["flash_bwd"],
               err, tol, lambda: fs.flash_bwd(q, k, v, out, lse, g), 10, plain_ms, [B, S, S, H, d],
               bounds.flash_bwd(B, S, H, d),
               lambda: torch.autograd.grad(lib_out, (qt, kt, vt), gt, retain_graph=True), ok=within)
        del lib_out
        if d == 40 and B == 4:
            dq, dk, dv = got
            dk, dv = dk.clone(), dv.clone()
            dk[:, -64:] = 0
            dv[:, -64:] = 0
            planted("flash_bwd", "dk/dv of the last 64 keys dropped", (dq, dk, dv), want)
            dq = got[0].clone()
            dq[:, -64:] = 0
            planted("flash_bwd", "dq of the last query block zeroed", (dq, got[1], got[2]), want)
    # lengths that are no multiple of the 64-row tiles or of a block's rows
    for B, S, H, d in ((1, 1000, 8, 40), (4, 333, 8, 80), (1, 77, 8, 80)):
        q, k, v = (torch.randn(B, S, H, d, generator=gen, device=dev).bfloat16() for _ in range(3))
        out, lse = fs.flash_fwd_lse_plain(q, k, v)
        g = torch.randn(B, S, H, d, generator=gen, device=dev).bfloat16()
        got = fs.flash_bwd(q, k, v, out, lse, g)
        want = fs.flash_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse, g.float())
        err, tol, within = rel_err(got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, fs.flash_bwd(q, k, v, out, lse, g)))
        check(within and same, f"flash_bwd ragged {[B, S, H, d]}: worst err {err:.6g} (tol {tol:.6g}), "
              f"repeat bit-identical {same}")
    if not all(faults_caught):
        rows.append(dict(name="planted faults", ok=False))
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
    from photoverse_tpu_torch.models import layers, unet, vae
    from photoverse_tpu_torch.ops import dual_cross_attn as dca
    from photoverse_tpu_torch.ops import flash_sdpa as fs
    from photoverse_tpu_torch.ops import fused_block as fb
    from photoverse_tpu_torch.ops import group_norm as gn

    with mock.patch.object(layers, "group_norm_nhwc", gn.group_norm_nhwc_plain), \
            mock.patch.object(unet, "flash_sdpa", fs.flash_sdpa_plain), \
            mock.patch.object(unet, "flash_sdpa_diff", fs.flash_sdpa_plain), \
            mock.patch.object(unet, "fused_cross_ff", fb.reference_cross_ff), \
            mock.patch.object(unet, "dual_cross_attention", dca.dual_cross_attention_plain), \
            mock.patch.object(vae, "flash_sdpa_stream", fs.flash_sdpa_plain), \
            mock.patch.object(vae, "flash_sdpa_stream_diff", fs.flash_sdpa_plain):
        yield


def serving_models():
    """SD-1.5-width models with random weights from a numpy seed, built with
    the serving flags (bf16, flash, bf16 scores and norms, fused blocks)."""
    import torch

    from photoverse_tpu_torch.models.assembly import build_models, init_params

    t0 = time.perf_counter()
    models = init_params(build_models(
        dtype=torch.bfloat16, use_flash_attention=True, fast_attention_scores=True,
        fast_norms=True, fused_blocks=True), seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in models.parameters())
    log(f"pipeline: SD-1.5-width models ({n_params} params, bf16) built in {time.perf_counter() - t0:.1f}s")
    return models


def phase_pipeline(models):
    """The port's main path at SD-1.5 width: kernels, then plain versions."""
    import torch

    from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
    from photoverse_tpu_torch.engine.inference import run_inference
    from photoverse_tpu_torch.utils import trace

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
        launches0 = trace.counts("launch.")
        imgs, secs = run(n_steps, guidance)
        counts = trace.since(launches0, "launch.")
        launches0 = trace.counts("launch.")
        with plain_kernels():
            ref, plain_secs = run(n_steps, guidance)
        plain_counts = trace.since(launches0, "launch.")
        evals = n_steps
        want = _serving_counts(evals)
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


# GroupNorms of the SD-1.5 UNet, VAE decoder and VAE encoder (two per
# ResNet block, one per attention block, the output norm): the calls of
# group_norm_nhwc in their no-grad forwards
UNET_NORMS, DECODER_NORMS, ENCODER_NORMS = 61, 30, 22


def _serving_counts(evals: int, fused: bool = True, stream: int = 1) -> dict:
    """Launches of one generation at SD-1.5 width, 512px: per UNet
    evaluation 10 flash self-attention layers (the 64^2 and 32^2 levels),
    5 fused block tails (C=320), the other 11 blocks' dual-context
    cross-attention and its GroupNorms, and the VAE's mid-block attention
    and GroupNorms (`stream` 2: an encode too). `fused` False: an identity
    mask, which keeps every block's unfused tail and the cross-attention's
    einsums."""
    want = {"flash_sdpa": 10 * evals, "flash_sdpa_stream": stream,
            "group_norm_nhwc": UNET_NORMS * evals + DECODER_NORMS + ENCODER_NORMS * (stream - 1)}
    if fused:
        want["fused_cross_ff"] = 5 * evals
        want["dual_cross_attn"] = 11 * evals
    return want


def phase_samplers(models):
    """Every sampler name through run_inference, kernels against plain."""
    import torch

    from photoverse_tpu_torch.core.schedulers import SCHEDULER_NAMES, make_solver
    from photoverse_tpu_torch.engine.inference import run_inference
    from photoverse_tpu_torch.utils import trace

    steps = 10
    example = _example(1, seed=2)
    rng = np.random.RandomState(200)
    noise = rng.randn(1, 64, 64, 4).astype(np.float32)
    ok = True

    def both(label, solver, want, **kw):
        """One run on the kernels (launches counted), one on the plain
        versions; the phase's checks on the pair."""
        nonlocal ok
        kw = dict(guidance_scale=1.0, token_index=0, latent_size=64, initial_noise=noise, **kw)
        if solver.is_ancestral:
            kw["ancestral_noise"] = np.random.RandomState(201).randn(
                solver.num_steps, 1, 64, 64, 4).astype(np.float32)
        launches0 = trace.counts("launch.")
        torch.cuda.synchronize()
        t = time.perf_counter()
        imgs = run_inference(models, solver, example, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = trace.since(launches0, "launch.")
        launches0 = trace.counts("launch.")
        with plain_kernels():
            ref = run_inference(models, solver, example, **kw)
        plain_counts = trace.since(launches0, "launch.")
        diff = (imgs - ref).abs().max().item()
        sound = (bool(torch.isfinite(imgs).all()) and tuple(imgs.shape) == (1, 512, 512, 3)
                 and bool(imgs.min() >= -1 and imgs.max() <= 1))
        good = sound and counts == want and not plain_counts and diff <= G1_ATOL
        ok &= good
        log(f"samplers {label}: {solver.num_steps} UNet evaluations, {secs:.3f}s, launches {counts}"
            f"{'' if counts == want else f' (want {want})'}, max abs pixel diff vs plain {diff:.6g} "
            f"(tol {G1_ATOL}) {'OK' if good else 'FAIL'}")
        return imgs

    for name in SCHEDULER_NAMES:
        solver = make_solver(models.schedule, name, steps)
        both(name, solver, _serving_counts(solver.num_steps))

    # an identity mask over the right half: every block takes the masked
    # route, so the fused tail launches nothing and flash still does
    solver = make_solver(models.schedule, "dpm", steps)
    mask = np.zeros((1, 512, 512), np.float32)
    mask[:, :, 256:] = 1.0
    free = run_inference(models, solver, example, guidance_scale=1.0, latent_size=64, initial_noise=noise)
    masked = both("dpm with ip_mask", solver, _serving_counts(steps, fused=False), ip_mask=mask)
    moved = (masked - free).abs().max().item()
    log(f"  the mask moves the image by {moved:.6g} {'OK' if moved > G1_ATOL else 'FAIL'}")
    ok &= moved > G1_ATOL

    # from a noised image: the VAE encoder's mid-block attention is a second
    # launch of the stream kernel
    px = np.clip(rng.randn(1, 512, 512, 3) * 0.5, -1, 1).astype(np.float32)
    vae_noise = rng.randn(1, 64, 64, 4).astype(np.float32)
    example = dict(example, pixel_values=px)
    noised = both("dpm from_noised_image", solver, _serving_counts(steps, stream=2),
                  from_noised_image=True, vae_noise=vae_noise)
    moved = (noised - free).abs().max().item()
    log(f"  the image start moves the image by {moved:.6g} {'OK' if moved > G1_ATOL else 'FAIL'}")
    ok &= moved > G1_ATOL
    return ok


def phase_serve(models):
    """The dynamic-batching service at SD-1.5 width, entered at submit()."""
    import torch

    from photoverse_tpu_torch.cli import serve
    from photoverse_tpu_torch.data.prompts import prepare_prompt
    from photoverse_tpu_torch.utils import trace
    from scripts.torch_make_random_checkpoint import synthetic_tokenizer

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        tokenizer = synthetic_tokenizer(tmp)
    flags = ["--model_path", "unused", "--fast", "--resolution", "512"]
    bat = serve.PhotoVerseService(serve.build_parser().parse_args(
        flags + ["--dynamic_batching", "--max_batch", "4", "--batch_wait_ms", "500"]), models=(tokenizer, models))
    seq = serve.PhotoVerseService(serve.build_parser().parse_args(flags), models=(tokenizer, models))
    ok = True

    def check(good, what):
        nonlocal ok
        ok &= bool(good)
        log(f"serve: {what} {'OK' if good else 'FAIL'}")

    def example(n, seed):
        """What _prepare makes of a request, without Pillow: the prompt
        through the tokenizer, a CLIP-scale photo from the seed."""
        p = prepare_prompt(tokenizer, "a photo of a {}", num_of_samples=n)
        photo = np.random.RandomState(1000 + seed).randn(1, 224, 224, 3).astype(np.float32)
        return {
            "pixel_values": np.zeros((n, 512, 512, 3), np.float32),
            "pixel_values_clip": np.repeat(photo, n, axis=0),
            "text_input_ids": p["text_input_ids"].astype(np.int32),
            "concept_placeholder_idx": p["concept_placeholder_idx"].reshape(n).astype(np.int32),
            "negative_text_input_ids": np.asarray(tokenizer([""] * n), np.int32),
        }

    def fire(service, requests):
        """Submit (n, seed, key) requests from one thread each; the results
        in order, an exception in place of a failed one."""
        out = [None] * len(requests)

        def one(i, n, seed, key):
            try:
                out[i] = service.submit(example(n, seed), n, seed, key)
            except BaseException as e:  # noqa: BLE001 - reported by the caller
                out[i] = e

        threads = [threading.Thread(target=one, args=(i, *r), daemon=True) for i, r in enumerate(requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SERVE_TIMEOUT_S)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("serve: a request did not return in time")
        return out

    def u8diff(a, b):
        """(largest, mean) absolute difference of two uint8 images."""
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        return int(d.max()), round(float(d.mean()), 4)

    def same_image(d):
        return d[0] <= SERVE_SAME_U8 and d[1] <= SERVE_SAME_MEAN_U8

    same_tol = f"tol {SERVE_SAME_U8}, {SERVE_SAME_MEAN_U8}"

    ids = example(1, 0)["text_input_ids"][0]
    check(ids[0] == tokenizer.bos_token_id and ids[6] == tokenizer.eos_token_id
          and example(1, 0)["concept_placeholder_idx"][0] == 5, f"tokenizer: 'a photo of a *' -> {ids[:8].tolist()}")

    t0 = time.perf_counter()
    bat.warmup(steps=2)
    seq.warmup(steps=2)
    log(f"serve: warm-up of buckets 1, 2, 4 and the sequential service in {time.perf_counter() - t0:.1f}s")

    serve_counts = {}
    for scheduler in ("dpm", "euler_a"):  # (a) and (b)
        key = (25, 6.0, scheduler)
        launches0 = trace.counts("launch.")
        pair = fire(bat, [(1, 3, key), (1, 7, key)])
        counts = trace.since(launches0, "launch.")
        if scheduler == "dpm":
            serve_counts = counts
        failed = [r for r in pair if isinstance(r, BaseException)]
        if failed:
            check(False, f"{scheduler}: coalesced requests failed: {failed[0]!r}")
            continue
        solo = [seq.submit(example(1, s), 1, s, key) for s in (3, 7)]
        same = [u8diff(p["images"], q["images"]) for p, q in zip(pair, solo)]
        apart = u8diff(pair[0]["images"], pair[1]["images"])
        want = _serving_counts(25)
        check([p["batch_rows"] for p in pair] == [2, 2] and counts == want
              and all(map(same_image, same)) and not same_image(apart)
              and pair[0]["images"].shape == (1, 512, 512, 3),
              f"{scheduler}, 25 steps, guidance 6: seeds 3 and 7 coalesced (batch_rows "
              f"{[p['batch_rows'] for p in pair]}), launches {counts} (want {want}); coalesced vs solo, "
              f"(largest, mean) of 255: {same} ({same_tol}), seed 3 vs seed 7 {apart}; latency "
              f"{pair[0]['latency_s']:.3f}s coalesced, {solo[0]['latency_s']:.3f}s solo")

        def planted(what, held=True, **patches):
            """Serve the pair again with the service patched; the fault is
            caught when row 1 no longer passes for its solo run. A fault
            that is not `held` is read and logged only."""
            nonlocal ok
            with contextlib.ExitStack() as stack:
                for name, fn in patches.items():
                    stack.enter_context(mock.patch.object(bat, name, fn))
                bad = fire(bat, [(1, 3, key), (1, 7, key)])
            wrong = (-1, -1.0) if isinstance(bad[1], BaseException) else u8diff(bad[1]["images"], solo[1]["images"])
            caught = wrong[0] >= 0 and not same_image(wrong)
            ok &= caught or not held
            log(f"  planted fault, {what}: {wrong} of 255 from its solo run ({same_tol}): "
                f"{'caught' if caught else 'NOT CAUGHT' if held else 'not caught (below what this comparison sees)'}")

        real = bat._make_noise
        planted("row 1 served with row 0's noise", _make_noise=lambda seed, n: real(3, n))
        if scheduler == "euler_a":
            # milder ones: row 1 takes row 0's step noise at one step only.
            # At step 22 little noise is left to add and the fault reads what
            # another batch size's rounding reads: it is read and logged,
            # not held (the CPU tests hold a late step in f32, at 2 / 255)
            real_rows = bat._make_row_noise
            for at in (2, 12, 22):
                def one_step_wrong(seed, n, solver, at=at):
                    z = real_rows(seed, n, solver).clone()
                    if seed == 7:
                        z[at] = real_rows(3, n, solver)[at]
                    return z

                planted(f"row 1 takes row 0's step noise at step {at} of 25 only", held=at < 22,
                        _make_row_noise=one_step_wrong)

    # (c) three rows pad to bucket 4: UNet batch 8, the largest shapes the
    # server gives the kernels. Each row against its solo run, and the whole
    # batch against the same batch on the kernels' plain versions.
    key = (10, 6.0, "dpm")
    before = bat.health()["stats"]
    launches0 = trace.counts("launch.")
    trio = fire(bat, [(1, s, key) for s in (1, 2, 3)])
    counts = trace.since(launches0, "launch.")
    after = bat.health()["stats"]
    good = (not any(isinstance(r, BaseException) for r in trio) and [r["batch_rows"] for r in trio] == [3, 3, 3]
            and after["padded_rows"] - before["padded_rows"] == 1 and after["batches"] - before["batches"] == 1
            and counts == _serving_counts(10))
    check(good, f"three requests ran as one batch of bucket 4: padded_rows +{after['padded_rows'] - before['padded_rows']}, "
          f"batches +{after['batches'] - before['batches']}, launches {counts}")
    if good:
        solo = [seq.submit(example(1, s), 1, s, key) for s in (1, 2, 3)]
        same = [u8diff(r["images"], q["images"]) for r, q in zip(trio, solo)]
        launches0 = trace.counts("launch.")
        with plain_kernels():
            plain = fire(bat, [(1, s, key) for s in (1, 2, 3)])
        plain_counts = trace.since(launches0, "launch.")
        failed = [r for r in plain if isinstance(r, BaseException)]
        vs_plain = [(-1, -1.0)] if failed else [u8diff(r["images"], q["images"]) for r, q in zip(trio, plain)]
        check(all(map(same_image, same)) and not failed and not plain_counts
              and [r["batch_rows"] for r in plain] == [3, 3, 3]
              and all(0 <= d[0] <= SERVE_PLAIN_U8 for d in vs_plain),
              f"bucket 4, 10 steps, guidance 6, (largest, mean) of 255: rows vs their solo runs {same} "
              f"({same_tol}); kernels vs the same batch on plain versions {vs_plain} (tol {SERVE_PLAIN_U8}), "
              f"plain run launches {plain_counts or 0}")

    # (d) different step counts do not coalesce
    two = fire(bat, [(1, 5, (10, 6.0, "dpm")), (1, 5, (12, 6.0, "dpm"))])
    check(not any(isinstance(r, BaseException) for r in two) and [r["batch_rows"] for r in two] == [1, 1],
          "requests of 10 and 12 steps ran apart")

    # (e) a burst of 12 mixed requests from 4 threads
    before = bat.health()["stats"]
    N = 12
    reqs = [(1 + (i % 2), 100 + i, (25 if i % 3 else 20, 6.0, "dpm")) for i in range(N)]
    done, lock = [], threading.Lock()

    def client(w):
        for i in range(w, N, 4):
            n, seed, key = reqs[i]
            try:
                r = bat.submit(example(n, seed), n, seed, key)
            except BaseException as e:  # noqa: BLE001 - reported below
                r = e
            with lock:
                done.append(r)

    # the worker's host time per batch (enqueueing a whole trajectory), to
    # set beside the latency: where they are equal the host sets the pace
    enqueue, real_run = [], bat._run

    def timed_run(*a):
        t = time.perf_counter()
        out = real_run(*a)
        enqueue.append(time.perf_counter() - t)
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(w,), daemon=True) for w in range(4)]
    with mock.patch.object(bat, "_run", timed_run):
        for t in clients:
            t.start()
        for t in clients:
            t.join(SERVE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    drained = bat.drain(timeout_s=60)
    after = bat.health()["stats"]
    errors = [r for r in done if isinstance(r, BaseException)]
    served = [r for r in done if not isinstance(r, BaseException)]
    images = sum(len(r["images"]) for r in served)
    rows = after["rows"] - before["rows"]
    batches = after["batches"] - before["batches"]
    check(len(done) == N and not errors and images == sum(r[0] for r in reqs) and rows == images and drained
          and after["rejected"] == before["rejected"],
          f"burst of {N} requests ({images} images, steps 20 and 25, guidance 6) from 4 threads: "
          f"{len(errors)} errors, stats.rows +{rows}, drained {drained}")
    if served:
        lat = sorted(r["latency_s"] for r in served)
        log(f"serve burst: {wall:.3f}s wall, {len(served) / wall:.4f} requests/s, {images / wall:.4f} images/s, "
            f"latency_s p50 {lat[len(lat) // 2]:.3f} p95 {lat[min(len(lat) - 1, int(0.95 * len(lat)))]:.3f} "
            f"max {lat[-1]:.3f}, {batches} batches, mean rows per batch {rows / max(batches, 1):.3f}, "
            f"padded rows +{after['padded_rows'] - before['padded_rows']}; the worker's host time to enqueue "
            f"a batch: mean {np.mean(enqueue):.3f}s, sum {np.sum(enqueue):.3f}s of the wall")

    # device-busy share of serving, from a shorter burst under the profiler
    # (device events only; the profiler slows the host, so the share is a
    # lower bound of the unprofiled one)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fire(bat, [(1, 200 + i, (10, 6.0, "dpm")) for i in range(4)])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    attr = "self_device_time_total" if evs and hasattr(evs[0], "self_device_time_total") else "self_cuda_time_total"
    busy = sum(getattr(e, attr) for e in evs) / 1e6
    log("serve: device busy " + (f"{busy:.3f}s of {prof_wall:.3f}s wall ({busy / prof_wall:.1%}) over four "
        "coalesced 10-step requests under the profiler" if busy > 0 else "not measured (no device events)"))

    # (f) a full queue is refused
    bat.args.max_queue = 0
    try:
        bat.submit(example(1, 9), 1, 9, (10, 6.0, "dpm"))
        refused = False
    except serve.ServiceOverloaded:
        refused = True
    finally:
        bat.args.max_queue = 64
    check(refused and bat.health()["stats"]["rejected"] == after["rejected"] + 1,
          "max_queue 0 raises ServiceOverloaded")

    errs = bat.thread_errors + seq.thread_errors
    check(not errs, f"no exception in a service thread ({len(errs)}{': ' + repr(errs[0]) if errs else ''})")
    log(f"serve: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return serve_counts, ok


def _train_batch(B: int, n_face: int, seed: int):
    """A numpy-seeded uint8 training batch at 512px (the uint8 transfer
    path), its first n_face rows as the face sub-batch with the prompt
    "a photo of *" shape (placeholder at 4) and the empty negative prompt."""
    rng = np.random.RandomState(seed)
    ex = _example(B, seed)
    batch = {
        "pixel_values": rng.randint(0, 256, (B, 512, 512, 3)).astype(np.uint8),
        "pixel_values_clip": rng.randint(0, 256, (B, 224, 224, 3)).astype(np.uint8),
        "text_input_ids": ex["text_input_ids"],
        "concept_placeholder_idx": ex["concept_placeholder_idx"],
    }
    if n_face:
        face_ids = _empty_prompt(n_face)
        face_ids[:, 1:6] = rng.randint(1, 49406, (n_face, 5))
        batch.update(
            face_pixel_values=batch["pixel_values"][:n_face],
            face_pixel_values_clip=batch["pixel_values_clip"][:n_face],
            face_text_input_ids=face_ids,
            face_concept_placeholder_idx=np.full((n_face,), 4, np.int64),
            face_uncond_input_ids=_empty_prompt(n_face),
        )
    return batch


def _flash_layers(cfg, latent: int) -> int:
    """UNet self-attention layers at S >= flash_min_seq: per level with
    attention, layers_per_block down and layers_per_block + 1 up."""
    n = len(cfg.block_out_channels)
    return sum(2 * cfg.layers_per_block + 1 for i in range(n - 1)
               if (latent >> i) ** 2 >= cfg.flash_min_seq)


def _train_counts(n_flash: int, face_steps: int, face: bool, remat: bool) -> dict:
    """Launches of one micro-step of the train step at 512px. Under grad each
    flash layer launches its lse forward (kernel 2) and, but for the first
    layer, whose inputs depend on no trainable weight, its backward (kernel
    3); the VAE encodes without grad (kernel 4). The face micro-step adds a
    second VAE encode, the inner generation's no-grad steps (kernel 1), one
    more UNet evaluation under grad and the decode under grad (kernel 5).
    Remat recomputes every block that holds a flash layer in the backward,
    so each lse forward runs twice; the backward kernels do not. The
    channels-last GroupNorm runs in the no-grad encodes and the no-grad
    steps only, and so does the dual-context cross-attention kernel, in all
    16 blocks."""
    r = 2 if remat else 1
    if not face:
        return {"flash_sdpa_stream": 1, "flash_sdpa_fwd_lse": r * n_flash, "flash_bwd": n_flash - 1,
                "group_norm_nhwc": ENCODER_NORMS}
    return {"flash_sdpa_stream": 2, "flash_sdpa": n_flash * (face_steps - 1), "flash_sdpa_fwd_lse": 2 * r * n_flash,
            "flash_bwd": 2 * (n_flash - 1), "flash_stream_fwd_lse": r,
            "group_norm_nhwc": 2 * ENCODER_NORMS + UNET_NORMS * (face_steps - 1),
            "dual_cross_attn": 16 * (face_steps - 1)}


def phase_train():
    """The canonical train step at SD-1.5 width, kernels against plain."""
    import torch

    from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
    from photoverse_tpu_torch.engine import training as tr
    from photoverse_tpu_torch.models.arcface import ArcFaceResNet18, init_arcface
    from photoverse_tpu_torch.models.assembly import build_models, init_params
    from photoverse_tpu_torch.models import unet as unet_mod
    from photoverse_tpu_torch.models.face_loss import FaceLoss, make_face_loss_fn
    from photoverse_tpu_torch.models.unet import UNetConfig
    from photoverse_tpu_torch.models.vae import VAEConfig
    from photoverse_tpu_torch.ops import flash_sdpa as fs
    from photoverse_tpu_torch.utils import trace

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # bit-identical repeats need deterministic cuDNN algorithms
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    unet_cfg = UNetConfig(use_flash_attention=True, lora_rank=128, lora_alpha=1.0, lora_dropout=0.1)
    models = init_params(build_models(
        dtype=torch.bfloat16, unet_config=unet_cfg, vae_config=VAEConfig(use_flash_attention=True)),
        seed=0)
    face_net = init_arcface(ArcFaceResNet18(), seed=0).requires_grad_(False)
    cfg = tr.TrainConfig(learning_rate=1e-5, lr_scheduler="constant", gradient_accumulation_steps=2,
                         face_loss_timesteps=10, face_loss_guidance=2.0)
    trainable, frozen, opt = tr.init_train_state(models, cfg)
    solver = DPMSolverMultistep.create(models.schedule, cfg.face_loss_timesteps)
    accum = cfg.gradient_accumulation_steps
    face_step = tr.make_train_step(models, cfg, opt, make_face_loss_fn(FaceLoss(face_net)), solver,
                                   face_weight_scale=float(accum))
    plain_step = tr.make_train_step(models, cfg, opt)  # a window's other micro-steps
    torch.cuda.synchronize()
    log(f"train: SD-1.5-width models, bf16 with {sum(p.numel() for p in trainable.values())} f32 "
        f"trainable / {sum(p.numel() for p in frozen.values())} frozen params, built in "
        f"{time.perf_counter() - t0:.1f}s")

    B, n_face, latent = 4, 2, 64
    L = len(models.unet.cross_attentions())
    n_flash = _flash_layers(models.unet.config, latent)
    main_counts = _train_counts(n_flash, cfg.face_loss_timesteps, face=False, remat=False)
    face_counts = _train_counts(n_flash, cfg.face_loss_timesteps, face=True, remat=False)

    def draws(seed, face):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return tr.make_draws(g, B, latent, L, face_rows=n_face if face else 0)

    before_t = {k: v.detach().clone() for k, v in trainable.items()}
    before_f = {k: v.detach().clone() for k, v in frozen.items()}
    ok = True
    totals: dict = {}
    window_secs = []
    for micro in range(4):
        face = (micro + 1) % accum == 0
        batch = _train_batch(B, n_face if face else 0, seed=20 + micro)
        d = draws(100 + micro, face)
        launches0 = trace.counts("launch.")
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = (face_step if face else plain_step)(batch, d)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = trace.since(launches0, "launch.")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        want = face_counts if face else main_counts
        m = {k: float(v) for k, v in metrics.items()}
        good = (counts == want and all(np.isfinite(v) for v in m.values())
                and (m["loss_face"] != 0.0) == face)
        ok &= good
        window_secs.append(secs)
        log(f"train micro-step {micro} ({'face' if face else 'diffusion'}): {secs:.3f}s "
            f"{' '.join(f'{k} {v:.6g}' for k, v in m.items())} {'OK' if good else 'FAIL'}")
        log(f"  launches {counts} (want {want})")
    moved = sum(not torch.equal(before_t[k], v) for k, v in trainable.items())
    frozen_same = all(torch.equal(before_f[k], v) for k, v in frozen.items())
    good = opt.updates == 2 and moved == len(trainable) and frozen_same
    ok &= good
    log(f"train: {opt.updates} optimizer updates; {moved} of {len(trainable)} trainable tensors moved; "
        f"frozen bit-identical {frozen_same} {'OK' if good else 'FAIL'}")
    log(f"train: s per optimizer step (window of {accum} micro-steps, the second window) "
        f"{sum(window_secs[2:]):.4f}")
    del before_t, before_f

    # the face micro-step again, twice with the kernels, once on plain versions
    batch = _train_batch(B, n_face, seed=21)

    @contextlib.contextmanager
    def kernel_calls(store: list):
        """Record each call of the lse forward (kernels 2 and 5) and the
        flash backward (kernel 3) wrappers, with its inputs and outputs."""
        def recorder(kind, fn):
            def call(*args):
                outs = fn(*args)
                store.append((kind, tuple(a.detach() for a in args), tuple(o.detach() for o in outs)))
                return outs
            return call

        with mock.patch.object(fs, "flash_fwd_lse", recorder("fwd", fs.flash_fwd_lse)), \
                mock.patch.object(fs, "flash_bwd", recorder("bwd", fs.flash_bwd)):
            yield

    def call_errs(store):
        """Per recorded call, (worst error over its limit, where): each
        output against its plain version on the call's own inputs, out /
        dq / dk / dv by max |error| over FLASH_RTOL * max |want|, lse by
        max |error| over LSE_ATOL."""
        errs = []
        for i, (kind, args, outs) in enumerate(store):
            f32 = [a.float() for a in args]
            want = fs.flash_fwd_lse_plain(*f32) if kind == "fwd" else fs.flash_bwd_plain(*f32)
            for n, (o, w) in zip(("out", "lse") if kind == "fwd" else ("dq", "dk", "dv"), zip(outs, want)):
                lim = LSE_ATOL if n == "lse" else FLASH_RTOL * w.float().abs().max().item()
                errs.append(((o.float() - w.float()).abs().max().item() / lim,
                             f"call {i} {kind} (d={args[0].shape[-1]}) {n}"))
        return errs

    def grads(seed=101):
        store = []
        with kernel_calls(store):
            m, g = face_step.compute_grads(batch, draws(seed, True))
        return {k: float(v) for k, v in m.items()}, g, store

    m1, g1, s1 = grads()
    m2, g2, s2 = grads()
    same = (m1 == m2 and all(torch.equal(g1[k], g2[k]) for k in g1) and len(s1) == len(s2)
            and all(torch.equal(a, b) for c1, c2 in zip(s1, s2) for a, b in zip(c1[2], c2[2])))
    ok &= same
    log(f"train: repeat gradients bit-identical {same} (parameters, and the outputs of "
        f"{len(s1)} training-kernel calls) {'OK' if same else 'FAIL'}")
    del g2, s2
    e1 = call_errs(s1)
    # how far the flash backward's delta = rowsum(g out) taken from the bf16
    # out (as the JAX kernel takes it) moves dq/dk/dv from the exact
    # gradient: the plain formula with the f32 out against it (no limit)
    drift = []
    for kind, args, _ in s1:
        if kind == "bwd":
            q, k, v, out, lse, g = (a.float() for a in args)
            exact = fs.flash_bwd_plain(q, k, v, fs.flash_fwd_lse_plain(q, k, v)[0], lse, g)
            rounded = fs.flash_bwd_plain(q, k, v, out, lse, g)
            drift.append(max(((r - e).abs().max() / e.abs().max()).item() for r, e in zip(rounded, exact)))
    log(f"  delta from the bf16 out vs from the f32 out, plain formula, worst err/max over dq/dk/dv: "
        f"median {float(np.median(drift)):.6g} max {max(drift):.6g} over {len(drift)} backward calls")
    del s1

    launches0 = trace.counts("launch.")
    with plain_kernels():
        mp, gp, _ = grads()
    plain_launches = trace.since(launches0, "launch.")

    groups = ("text_adapter", "image_adapter", "unet")

    def compare(m, g, errs, label):
        """Run (m, g) against the plain run: losses and per-group gradients;
        and each training-kernel call against its plain version on its own
        inputs (errs)."""
        loss_err = max(abs(m[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in m)
        grad_err = {}
        for grp in groups:
            keys = [k for k in g if k.startswith(grp + ".")]
            num = torch.sqrt(sum((g[k].float() - gp[k].float()).square().sum() for k in keys))
            den = torch.sqrt(sum(gp[k].float().square().sum() for k in keys))
            grad_err[grp] = (num / den).item()
        worst = max(errs, default=(float("inf"), "no call"))
        within = (len(errs) == len(e1) and loss_err <= TRAIN_LOSS_RTOL
                  and max(grad_err.values()) <= TRAIN_GRAD_RTOL and worst[0] <= 1)
        log(f"  {label}: max rel loss diff {loss_err:.6g} (tol {TRAIN_LOSS_RTOL}); rel grad L2 diff "
            f"{' '.join(f'{k} {v:.6g}' for k, v in grad_err.items())} (tol {TRAIN_GRAD_RTOL}); "
            f"{len(errs)} kernel outputs (want {len(e1)}), worst error over its limit {worst[0]:.6g} "
            f"at {worst[1]} (tol 1)")
        return within

    good = compare(m1, g1, e1, "kernels vs plain versions") and not plain_launches
    ok &= good
    log(f"train: kernel run vs plain run (plain launches {plain_launches or 0}) {'OK' if good else 'FAIL'}")

    # planted faults at the kernels' call sites, each against the plain run
    real_bwd = fs.flash_bwd

    def bwd_keys_dropped(*a):
        dq, dk, dv = real_bwd(*a)
        dk, dv = dk.clone(), dv.clone()
        dk[:, -64:] = 0
        dv[:, -64:] = 0
        return dq, dk, dv

    def bwd_no_dq(*a):
        dq, dk, dv = real_bwd(*a)
        return torch.zeros_like(dq), dk, dv

    real_fwd_lse = fs.flash_fwd_lse

    def lse_rolled(q, k, v):  # kernels 2 and 5: each row's lse taken from its neighbour
        out, lse = real_fwd_lse(q, k, v)
        return out, lse.roll(1, dims=-1)

    def detached(q, k, v):  # the fault the autograd Functions repaired
        with torch.no_grad():
            return fs.flash_sdpa(q, k, v)

    faults = {
        "flash_bwd drops dk/dv of the last 64 keys": mock.patch.object(fs, "flash_bwd", bwd_keys_dropped),
        "flash_bwd drops dq": mock.patch.object(fs, "flash_bwd", bwd_no_dq),
        "flash_fwd_lse's lse off by one row": mock.patch.object(fs, "flash_fwd_lse", lse_rolled),
        "flash output detached (no gradient)": mock.patch.object(unet_mod, "flash_sdpa_diff", detached),
    }
    for label, patch in faults.items():
        with patch:
            mf, gf, sf = grads()
        caught = not compare(mf, gf, call_errs(sf), f"planted fault, {label}")
        ok &= caught
        log(f"  {'caught' if caught else 'NOT CAUGHT'}")
        del gf, sf
    del gp

    del g1

    # remat (the recipe's --remat) at the recipe's micro-step: batch 8 with 4
    # face rows (inner UNet batch 8), without remat and then with each UNet
    # resnet / transformer block and the decoder's blocks recomputed in the
    # backward, on the same draws. The recompute replays the LoRA dropout
    # masks from the explicit generator, so the gradients are the no-remat
    # ones bit for bit; with the generator not restored (planted) they are not
    from photoverse_tpu_torch.models import layers

    B8, n_face8 = 8, 4
    batch8 = _train_batch(B8, n_face8, seed=23)

    def grads8():
        g = torch.Generator(device="cuda").manual_seed(103)
        m, gr = face_step.compute_grads(batch8, tr.make_draws(g, B8, latent, L, face_rows=n_face8))
        return {k: float(v) for k, v in m.items()}, gr

    def set_remat(on):
        models.unet.config = dataclasses.replace(models.unet.config, remat=on)
        models.vae.config = dataclasses.replace(models.vae.config, remat=on)

    phase_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m0, g0 = grads8()
    peak0 = torch.cuda.max_memory_allocated() / 2**30
    set_remat(True)
    try:
        torch.cuda.reset_peak_memory_stats()
        launches0 = trace.counts("launch.")
        mr, gr = grads8()
        remat_counts = trace.since(launches0, "launch.")
        remat_peak = torch.cuda.max_memory_allocated() / 2**30
        phase_peak = max(phase_peak, peak0)
        want = _train_counts(n_flash, cfg.face_loss_timesteps, face=True, remat=True)
        differ = [k for k in g0 if not torch.equal(g0[k], gr[k])]
        good = mr == m0 and not differ and remat_counts == want
        ok &= good
        log(f"train: remat vs no remat, the recipe's face micro-step (batch {B8}, {n_face8} face rows): losses "
            f"equal {mr == m0}, {len(g0) - len(differ)} of {len(g0)} gradients bit-identical"
            f"{'' if not differ else f' (largest difference {max((g0[k] - gr[k]).abs().max().item() for k in differ):.3g})'}"
            f"; launches {remat_counts} (want {want}); peak {peak0:.2f} GiB without remat, {remat_peak:.2f} GiB "
            f"with {'OK' if good else 'FAIL'}")
        del gr
        with mock.patch.object(layers, "replaying", lambda fn, gen: fn):
            mf, gf = grads8()
        differ = [k for k in g0 if not torch.equal(g0[k], gf[k])]
        caught = bool(differ)
        ok &= caught
        log(f"  planted fault, the dropout generator not restored for the recompute: {len(differ)} of {len(g0)} "
            f"gradients differ {'caught' if caught else 'NOT CAUGHT'}")
        del gf
    finally:
        set_remat(False)
    del g0, batch8

    # s per optimizer step: a window (diffusion + face micro-step) of
    # compute_grads, kernels and plain versions in turns
    def window(ctx):
        with ctx():
            torch.cuda.synchronize()
            t = time.perf_counter()
            plain_step.compute_grads(_train_batch(B, 0, seed=22), draws(102, False))
            face_step.compute_grads(batch, draws(101, True))
            torch.cuda.synchronize()
            return time.perf_counter() - t

    order = (plain_kernels, contextlib.nullcontext, contextlib.nullcontext, plain_kernels) * 2
    secs = [window(c) for c in order]
    kern = [t for t, c in zip(secs, order) if c is contextlib.nullcontext]
    plain = [t for t, c in zip(secs, order) if c is plain_kernels]
    log(f"train: s per optimizer step, gradients only (plain, kernels, kernels, plain) x 2: "
        f"{' '.join(f'{t:.4f}' for t in secs)}; kernels {np.mean(kern):.4f} plain {np.mean(plain):.4f}")
    log(f"train: peak device memory {max(phase_peak, torch.cuda.max_memory_allocated() / 2**30):.2f} GiB")
    return totals, ok


def write_user_files(tmp: str):
    """What a user brings, written once for the train-CLI and later phases:
    an SD-1.5-layout model directory of random numpy-seeded bf16 weights
    with the synthetic tokenizer, 32 identities as 512px JPEGs, and a
    synthetic archive laid out as the published CelebAMask-HQ (100
    identities, 1024px photos, 512px label masks), all from
    scripts/torch_make_random_checkpoint.py. Returns (model directory, data root,
    tokenizer, the archive's save_path)."""
    from PIL import Image

    from scripts.torch_make_random_checkpoint import (ARCHIVE_IMAGES, face_photo, make_checkpoint,
                                                      write_celebahq_archive)

    t0 = time.perf_counter()
    root = os.path.join(tmp, "sd15")
    gib, tokenizer = make_checkpoint(root, "sd15", seed=0)
    log(f"user files: SD-1.5-layout model directory ({gib:.2f} GiB of bf16 .bin, random weights from a numpy "
        f"seed, the synthetic tokenizer) written in {time.perf_counter() - t0:.1f}s")
    # the identities as JPEGs on disk, decoded and resized by the loader
    data = os.path.join(tmp, "data")
    n_ids = 32
    os.makedirs(os.path.join(data, "images"))
    rng = np.random.RandomState(60)
    for i in range(n_ids):
        Image.fromarray(face_photo(rng, 512)).save(os.path.join(data, "images", f"{i}.jpg"), quality=95)
    log(f"user files: {n_ids} identities written as 512px JPEGs")
    t0 = time.perf_counter()
    celeba = os.path.join(tmp, "celeba")
    zip_path = write_celebahq_archive(celeba)
    log(f"user files: CelebAMask-HQ-layout archive ({ARCHIVE_IMAGES} identities, "
        f"{os.path.getsize(zip_path) / 2**20:.1f} MiB) written in {time.perf_counter() - t0:.1f}s")
    return root, data, tokenizer, celeba


def phase_prepare(celeba: str):
    """cli.prepare_celebhqmasks on the archive: the fused masks against a
    numpy fusion of the same label files, the 90/10 split with every image
    beside its own mask. Returns (the train split, ok)."""
    from PIL import Image

    from photoverse_tpu_torch.cli import prepare_celebhqmasks
    from photoverse_tpu_torch.data.celebahq import MASKS_LABEL_LIST_CELEBAHQ
    from scripts.torch_make_random_checkpoint import ARCHIVE_IMAGES

    ok = True

    def check(good, what):
        nonlocal ok
        ok &= bool(good)
        log(f"prepare: {what} {'OK' if good else 'FAIL'}")

    t0 = time.perf_counter()
    prepare_celebhqmasks.main(["--save_path", celeba, "--num_of_samples", str(ARCHIVE_IMAGES)])
    log(f"prepare: cli.prepare_celebhqmasks (extract, fuse, split) took {time.perf_counter() - t0:.1f}s")
    src = os.path.join(celeba, "CelebAMask-HQ")
    anno = os.path.join(src, "CelebAMask-HQ-mask-anno")
    # the published fusion: label index + 1, later labels win, four labels skipped
    skipped = {"ear_r", "neck", "neck_r", "cloth"}
    wrong, values = [], set()
    for k in range(ARCHIVE_IMAGES):
        want = np.zeros((512, 512), np.uint8)
        for idx, label in enumerate(MASKS_LABEL_LIST_CELEBAHQ):
            f = os.path.join(anno, str(k // 2000), f"{k:05d}_{label}.png")
            if label not in skipped and os.path.exists(f):
                want[np.asarray(Image.open(f).convert("L")) != 0] = idx + 1
        got = np.asarray(Image.open(os.path.join(src, "masks", f"{k}.png")))
        values |= set(np.unique(got).tolist())
        if not np.array_equal(got, want):
            wrong.append(k)
    check(not wrong, f"{ARCHIVE_IMAGES} fused masks equal a numpy fusion of the same label PNGs (values "
          f"{sorted(values)}; the cloth label is skipped)" + (f"; wrong: {wrong[:5]}" if wrong else ""))

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    parts = {}
    for part in ("train", "test"):
        imgs = sorted(os.listdir(os.path.join(celeba, part, "images")))
        masks = sorted(os.listdir(os.path.join(celeba, part, "masks")))
        stems = [n.split(".")[0] for n in imgs]
        own = stems == [n.split(".")[0] for n in masks] and all(
            read(os.path.join(celeba, part, "images", f"{s}.jpg")) == read(os.path.join(src, "CelebA-HQ-img",
                                                                                        f"{s}.jpg"))
            and read(os.path.join(celeba, part, "masks", f"{s}.png")) == read(os.path.join(src, "masks", f"{s}.png"))
            for s in stems)
        parts[part] = (len(imgs), own, set(stems))
    check(parts["train"][0] == 90 and parts["test"][0] == 10 and all(p[1] for p in parts.values())
          and parts["train"][2] | parts["test"][2] == {str(k) for k in range(ARCHIVE_IMAGES)},
          f"split {parts['train'][0]}/{parts['test'][0]} covering all {ARCHIVE_IMAGES} identities, each image and "
          f"mask byte-equal to its source under the same index")
    return os.path.join(celeba, "train"), ok


def phase_train_cli(smi: str, root: str, data: str, tokenizer):
    """cli/train.py, the user's entry point, at SD-1.5 width with the
    canonical recipe on the prepared, masked split `data` (images/ and
    masks/); SIGTERM at the first stepped checkpoint, then resume."""
    import signal

    import torch

    from photoverse_tpu_torch.ckpt import checkpoint as ck
    from photoverse_tpu_torch.cli import train as cli
    from photoverse_tpu_torch.data.dataset import BatchLoader, CustomDatasetWithMasks
    from photoverse_tpu_torch.engine import training as tr
    from photoverse_tpu_torch.models import assembly
    from photoverse_tpu_torch.models.unet import UNetConfig
    from photoverse_tpu_torch.utils import trace

    ok = True

    def check(good, what):
        nonlocal ok
        ok &= bool(good)
        log(f"train-cli: {what} {'OK' if good else 'FAIL'}")

    torch.cuda.empty_cache()
    # the canonical recipe's flash layers and inner steps at 512px
    n_flash = _flash_layers(UNetConfig(), 64)
    face_steps = tr.TrainConfig.face_loss_timesteps
    with tempfile.TemporaryDirectory() as tmp:
        out1, out2 = os.path.join(tmp, "run1"), os.path.join(tmp, "run2")
        base = ["--recipe", "canonical", "--pretrained_model_name_or_path", root, "--data_root_path", data,
                "--img_subfolder", "images", "--mask_subfolder", "masks", "--allow_random_face_model",
                "--checkpoint_save_steps", "2", "--checkpoint_format", "both", "--seed", "0", "--report_to", "none",
                "--samples_save_steps", "2"]

        # every TrainStep call (a micro-step) with its launches
        per_step = []
        real_call = tr.TrainStep.__call__

        def counted(self, batch, draws):
            launches0 = trace.counts("launch.")
            out = real_call(self, batch, draws)
            per_step.append(("face" if "face_pixel_values" in batch else "diffusion", trace.since(launches0, "launch.")))
            return out

        # each checkpoint write's time, in the writer's thread
        writes = []

        def timed(fn):
            def run(*a, **kw):
                t = time.perf_counter()
                path = fn(*a, **kw)
                writes.append((os.path.basename(path), time.perf_counter() - t, os.path.getsize(path)))
                return path
            return run

        stepped = os.path.join(out1, "photoverse_000002.msgpack")
        watching = threading.Event()
        sent = []

        def watch():  # SIGTERM once the first stepped checkpoint is on disk
            while watching.is_set():
                if os.path.exists(stepped):
                    sent.append(time.perf_counter())
                    os.kill(os.getpid(), signal.SIGTERM)
                    return
                time.sleep(0.02)

        torch.cuda.reset_peak_memory_stats()
        watching.set()
        watcher = threading.Thread(target=watch, daemon=True)
        t0 = time.perf_counter()
        with mock.patch.object(tr.TrainStep, "__call__", counted), \
                mock.patch.object(ck, "save_progress", timed(ck.save_progress)), \
                mock.patch.object(ck, "save_progress_pt", timed(ck.save_progress_pt)):
            watcher.start()
            try:
                models, opt, s1 = cli.main(base + ["--output_dir", out1, "--max_train_steps", "8",
                                                   "--profile_steps", "1,2"])
            finally:
                watching.clear()
        run1_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        saved = {k: v for k, v in ck.host_save_snapshot(models).items() if k in ck.partition_params(models)[0]}
        saved_opt = ck.optax_state(opt)
        accum, updates = opt.accum, opt.updates
        del models, opt
        torch.cuda.empty_cache()
        ckpt1 = os.path.join(out1, f"photoverse_{s1:06d}.msgpack")
        with open(os.path.join(out1, "metrics.jsonl")) as f:
            rows1 = [json.loads(line) for line in f]
        steps1 = [r for r in rows1 if "loss_mle" in r]
        check(bool(sent) and 2 < s1 < 8 and updates == s1 and accum == 2 and os.path.exists(ckpt1)
              and os.path.exists(ckpt1.replace(".msgpack", ".pt"))
              and [r["step"] for r in steps1] == list(range(1, s1 + 1)),
              f"run 1 ({run1_s:.1f}s with the load): micro-batch 8 x {accum} accumulation steps; SIGTERM sent when "
              f"photoverse_000002.msgpack appeared, checkpoint at the next boundary {os.path.basename(ckpt1)} "
              f"(+ .pt), returned at step {s1} of 8")
        sim = [r for r in rows1 if "face_similarity" in r]
        check(len(sim) == 1 and os.path.exists(os.path.join(out1, "00002.jpg")),
              f"sample grid at step 2 with face_similarity {sim[0]['face_similarity'] if sim else None}")

        # resume from the SIGTERM checkpoint, on top of the step-2 .pt loaded
        # through load_models(photoverse_path=...)
        pt2 = os.path.join(out1, "photoverse_000002.pt")
        loaded = {}
        real_load = ck.load_progress

        real_load_models = assembly.load_models

        def load_models(*a, **kw):
            tok, m, lora = real_load_models(*a, **kw)
            loaded["from_pt"] = {f"{name}.{k}": (v.dtype, v.detach().float().cpu().numpy())
                                 for name in ("image_adapter", "text_adapter")
                                 for k, v in getattr(m, name).state_dict().items()}
            return tok, m, lora

        def load(path, m, o):
            trainable = ck.partition_params(m)[0]
            step = real_load(path, m, o)
            loaded.update(step=step, opt=ck.optax_state(o),
                          snap={k: v for k, v in ck.host_save_snapshot(m).items() if k in trainable})
            return step

        # three steps: the first after a load warms cuDNN and the allocator up
        n_run1, last = len(per_step), s1 + 3
        with mock.patch.object(tr.TrainStep, "__call__", counted), mock.patch.object(ck, "load_progress", load), \
                mock.patch.object(assembly, "load_models", load_models):
            models, opt, s2 = cli.main(base + ["--output_dir", out2, "--max_train_steps", str(last), "--resume_from",
                                               ckpt1, "--pretrained_photoverse_path", pt2])
        pt = torch.load(pt2, map_location="cpu", weights_only=True)
        # load_models stores each weight in its parameter's dtype
        pt_diff = [(float(np.abs(loaded["from_pt"][f"{m}.{k}"][1]
                                 - v.to(loaded["from_pt"][f"{m}.{k}"][0]).float().numpy()).max()), m, k)
                   for m in ("image_adapter", "text_adapter") for k, v in pt[m].items()]
        check(max(pt_diff)[0] == 0 and len(loaded["from_pt"]) == len(pt_diff),
              f"photoverse_000002.pt through load_models(photoverse_path=...): {len(pt_diff)} adapter tensors "
              f"equal the file's in their parameters' dtypes (largest difference {max(pt_diff)}), lora r "
              f"{pt.get('lora_config', {}).get('r')}")
        same_t = set(loaded["snap"]) == set(saved) and all(np.array_equal(loaded["snap"][k], v)
                                                           for k, v in saved.items())
        flat_a, flat_b = [], []

        def flatten(t, out, where=""):
            if isinstance(t, dict):
                for k in sorted(t):
                    flatten(t[k], out, f"{where}/{k}")
            else:
                out.append((where, t))

        flatten(saved_opt, flat_a)
        flatten(loaded["opt"], flat_b)
        same_o = ([w for w, _ in flat_a] == [w for w, _ in flat_b]
                  and all(a.dtype == b.dtype and np.array_equal(a, b) for (_, a), (_, b) in zip(flat_a, flat_b)))
        with open(os.path.join(out2, "metrics.jsonl")) as f:
            steps2 = [r for r in map(json.loads, f) if "loss_mle" in r]
        check(loaded["step"] == s1 and same_t and same_o and s2 == last
              and [r["step"] for r in steps2] == list(range(s1 + 1, last + 1)),
              f"resume: load_progress gave step {loaded['step']}; {len(saved)} trainables bit-identical {same_t}; "
              f"optimizer state ({len(flat_a)} arrays: AdamW moments and counts, accumulation) bit-identical "
              f"{same_o}; steps {[r['step'] for r in steps2]} (want {list(range(s1 + 1, last + 1))})")
        finite = all(np.isfinite(r[k]) for r in steps1 + steps2 for k in r)
        check(finite, "every logged loss and time is finite")
        for r in steps1 + steps2:
            log(f"  step {r['step']}: {r['step_time_s']:.4f} s per optimizer step, {r['imgs_per_sec']:.4f} images/s, "
                f"loss_mle {r['loss_mle']:.6g} loss_face {r['loss_face']:.6g}")
        # not the first step of a run (warm-up) nor the profiled step 2
        steady = [r["step_time_s"] for r in steps1[2:] + steps2[1:]]
        log(f"train-cli: s per optimizer step (batch 16 = 8 x 2; steps {[r['step'] for r in steps1[2:] + steps2[1:]]}: "
            f"not a run's first, not the profiled one) {' '.join(f'{t:.4f}' for t in steady)}; median "
            f"{float(np.median(steady)):.4f} s, {16 / float(np.median(steady)):.4f} images/s ({smi})")
        log(f"train-cli: peak device memory over run 1 (load, remat, micro-batch 8, face rows "
            f"{cli.face_rows(0.25, 8, 2, True)}) {peak:.2f} GiB, against 39.65-42.61 GiB at batch 4 without remat "
            f"(PERF.md)")

        want_counts = {kind: _train_counts(n_flash, face_steps, kind == "face", remat=True)
                       for kind in ("face", "diffusion")}
        wrong = [(i, kind, c) for i, (kind, c) in enumerate(per_step) if c != want_counts[kind]]
        kinds = [k for k, _ in per_step]
        check(not wrong and kinds == ["diffusion", "face"] * (len(kinds) // 2) and len(kinds) == 2 * last,
              f"{len(per_step)} micro-steps ({n_run1} in run 1), launches per micro-step with remat: diffusion "
              f"{want_counts['diffusion']}, face {want_counts['face']}"
              + (f"; first wrong: {wrong[0]}" if wrong else ""))

        for name, secs, size in writes:
            log(f"train-cli: async write of {name} ({size / 2**20:.1f} MiB) took {secs:.4f}s in the writer thread")
        t = time.perf_counter()
        snap = ck.host_save_snapshot(models)
        state = ck.optax_state(opt)
        snap_s = time.perf_counter() - t
        lora = {"r": 128, "lora_alpha": 1.0, "lora_dropout": 0.1, "bias": "none",
                "target_modules": ["attn2.to_k", "attn2.to_v", "attn2.to_q"]}
        sync_dir = os.path.join(tmp, "sync")
        t = time.perf_counter()
        p1 = ck.save_progress(sync_dir, snap, step=s2, lora_config=lora, opt_state=state)
        native_s = time.perf_counter() - t
        t = time.perf_counter()
        p2 = ck.save_progress_pt(sync_dir, snap, step=s2, lora_config=lora)
        pt_s = time.perf_counter() - t
        log(f"train-cli: sync checkpoint: host snapshot {snap_s:.4f}s, native {native_s:.4f}s "
            f"({os.path.getsize(p1) / 2**20:.1f} MiB), .pt {pt_s:.4f}s ({os.path.getsize(p2) / 2**20:.1f} MiB)")
        del models, opt, snap, state
        torch.cuda.empty_cache()

        # the loader alone, as the CLI builds it (micro-batch 8, 4 workers)
        ds = CustomDatasetWithMasks(data, tokenizer, mask_subfolder="masks", size=512, use_random_templates=True,
                                    seed=0, uint8_pixels=True)
        loader = BatchLoader(ds, 8, shuffle=True, seed=0, num_workers=4)
        t = time.perf_counter()
        n = sum(1 for _ in range(2) for _ in loader)
        rate = n / (time.perf_counter() - t)
        log(f"train-cli: loader {rate:.3f} batches of 8 a second (Pillow decode and resize of 1024px photos, the "
            f"mask crop, 4 worker threads); "
            f"the train step consumes {2 / float(np.median(steady)):.3f} a second")

        with open(os.path.join(out1, "profile", "summary.json")) as f:
            prof = json.load(f)
        busy = prof["device_busy_s"]
        check(bool(busy) and 0 < busy <= prof["wall_s"] and prof["top_device_ops"],
              f"--profile_steps 1,2 (optimizer step 2): {prof['wall_s']:.4f}s wall, device busy "
              + (f"{busy:.4f}s ({busy / prof['wall_s']:.1%})" if busy else "not measured (no device events)"))
        for name, ms, count in prof["top_device_ops"]:
            log(f"  {ms:10.3f} ms  {count:6d}x  {name[:110]}")
    return ok


def _write_mtcnn(d: str, seed: int, face_bias) -> str:
    """Random facenet_pytorch-layout P-, R- and O-Net weights from a numpy
    seed as pnet.pt / rnet.pt / onet.pt: weights N(0, 0.1), biases
    N(0, 0.01), PReLU slopes 0.25, each net's face-logit bias from
    `face_bias` and its box regression head scaled by 0.02 (boxes stay on
    the image)."""
    import torch

    from photoverse_tpu_torch.utils import mtcnn

    rng = np.random.RandomState(seed)
    os.makedirs(d)
    heads = {"pnet": "conv4_", "rnet": "dense5_", "onet": "dense6_"}
    for (name, cls), bias in zip((("pnet", mtcnn.PNet), ("rnet", mtcnn.RNet), ("onet", mtcnn.ONet)), face_bias):
        sd = {}
        for k, v in cls().state_dict().items():
            if k.startswith("prelu"):
                a = np.full(v.shape, 0.25)
            else:
                a = rng.randn(*v.shape) * (0.1 if k.endswith("weight") else 0.01)
            if k.startswith(heads[name] + "2"):
                a = a * 0.02
            sd[k] = torch.from_numpy(a.astype(np.float32))
        sd[heads[name] + "1.bias"] = torch.tensor([0.0, bias])
        torch.save(sd, os.path.join(d, f"{name}.pt"))
    return d


def _cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def phase_identity(smi: str, root: str, data: str):
    """The identity-model slice at SD-1.5 width: (b) cli.generate with
    --int8_conditioning, (a) int8 conditioning at batch 64 on the models it
    loaded, (c) the native tokenizer and a service built with it, (d)
    cli.train with the FaceNet face loss, (e) the face-similarity eval CLI
    on the card against --cpu."""
    import io

    import torch
    from PIL import Image
    from torch import nn

    from photoverse_tpu_torch.cli import eval_face_similarity as ev
    from photoverse_tpu_torch.cli import generate as gen
    from photoverse_tpu_torch.cli import serve
    from photoverse_tpu_torch.cli import train as cli
    from photoverse_tpu_torch.data.native_tokenizer import NativeCLIPTokenizer
    from photoverse_tpu_torch.data.tokenizer import CLIPTokenizer
    from photoverse_tpu_torch.engine import inference as inf
    from photoverse_tpu_torch.engine import training as tr
    from photoverse_tpu_torch.models.arcface import ArcFaceResNet18, init_arcface
    from photoverse_tpu_torch.models.facenet import InceptionResnetV1, init_facenet
    from photoverse_tpu_torch.models.unet import UNetConfig
    from photoverse_tpu_torch.ops import quant
    from photoverse_tpu_torch.utils import trace
    from photoverse_tpu_torch.utils.mtcnn import MTCNN

    ok = True

    def check(good, what):
        nonlocal ok
        ok &= bool(good)
        log(f"identity: {what} {'OK' if good else 'FAIL'}")

    def bf16_route():
        """The same modules with every Int8Linear computing as nn.Linear."""
        return mock.patch.object(quant.Int8Linear, "forward", nn.Linear.forward)

    photo = os.path.join(data, "images", "0.jpg")
    per_layer = 6  # q, k, v, out, fc1, fc2
    with tempfile.TemporaryDirectory() as tmp:
        # (b) cli.generate --int8_conditioning --fast, in process
        seen = {}
        real_run = inf.run_inference

        def spy(models, solver, example, *a, **kw):
            seen.update(models=models, example=example)
            launches0 = trace.counts("launch.")
            imgs = real_run(models, solver, example, *a, **kw)
            torch.cuda.synchronize()
            seen.update(counts=trace.since(launches0, "launch."), imgs=imgs)
            return imgs

        results = os.path.join(tmp, "generated")
        t0 = time.perf_counter()
        with mock.patch.object(inf, "run_inference", spy):
            gen.main(["--model_path", root, "--checkpoint_path", "", "--input_image_path", photo,
                      "--results_dir", results, "--num_timesteps", "10", "--resolution", "512",
                      "--num_of_samples", "2", "--seed", "0", "--int8_conditioning", "--fast"])
        gen_s = time.perf_counter() - t0
        models, example, counts, imgs = seen["models"], seen["example"], seen["counts"], seen["imgs"]
        t, v = models.text_encoder.config, models.vision_encoder.config
        want = dict(_serving_counts(10), int8_matmul=per_layer * (t.num_layers + v.num_layers))
        files = sorted(os.listdir(results))
        check(t.int8_dense and v.int8_dense and files == ["generated_image0.png", "generated_image1.png"]
              and tuple(imgs.shape) == (2, 512, 512, 3) and bool(torch.isfinite(imgs).all()) and counts == want,
              f"(b) cli.generate --int8_conditioning --fast, 512px, batch 2, 10 steps ({gen_s:.1f}s with the load): "
              f"{files}, finite {bool(torch.isfinite(imgs).all())}, launches {counts} (want {want})")
        px = torch.as_tensor(example["pixel_values_clip"], device="cuda").to(models.dtype)
        with torch.no_grad():
            c8, i8 = inf.encode_condition(models, px, 0)
            with bf16_route():
                cb, ib = inf.encode_condition(models, px, 0)
        cc, ci = _cos(c8, cb), _cos(i8, ib)
        check(cc >= INT8_COS and ci >= INT8_COS,
              f"(b) the CLI's conditioning against the same call without int8: concept embedding cos {cc:.6f}, "
              f"identity context cos {ci:.6f} (bar {INT8_COS})")

        # (a) int8 conditioning at full width: CLIP-L text (77 tokens) and
        # ViT-L/14 (257 tokens) at batch 64, on the models the CLI loaded
        B, layers = 64, models.image_encoder_layers_idx
        ex = _example(B, seed=70)
        px = torch.as_tensor(ex["pixel_values_clip"], device="cuda").to(models.dtype)
        ids = torch.as_tensor(ex["text_input_ids"], device="cuda")
        pidx = torch.as_tensor(ex["concept_placeholder_idx"], device="cuda")
        fc1_in = []
        hook = models.text_encoder.encoder.layers[0].mlp.fc1.register_forward_hook(
            lambda m, inp, out: fc1_in.append(inp[0]))
        with torch.no_grad():
            launches0 = trace.counts("launch.")
            v8 = models.vision_encoder(px, collect_layers=layers)
            t8 = models.text_encoder(ids)[0]
            torch.cuda.synchronize()
            int8_launches = trace.since(launches0, "launch.").get("int8_matmul", 0)
            hook.remove()
            with bf16_route():
                vb = models.vision_encoder(px, collect_layers=layers)
                tb = models.text_encoder(ids)[0]
        cos = {"vision last": _cos(v8[0], vb[0]), "text last": _cos(t8, tb)}
        cos.update({f"vision layer {i}": _cos(a, b) for i, a, b in zip(layers, v8[1], vb[1])})
        check(min(cos.values()) >= INT8_COS and int8_launches == per_layer * (t.num_layers + v.num_layers),
              f"(a) batch {B}, int8 against bf16: cos {', '.join(f'{k} {c:.6f}' for k, c in cos.items())} (bar "
              f"{INT8_COS}); Int8Linear launches {int8_launches}")
        fc1 = models.text_encoder.encoder.layers[0].mlp.fc1
        x_q, _ = quant.quantize_activation(fc1_in[0])
        w_q, _ = quant.quantize_weight(fc1.weight)
        x_q = x_q.reshape(-1, x_q.shape[-1])
        acc = quant.int8_product(x_q, w_q).cpu()
        plain = quant.int8_product(x_q.cpu(), w_q.cpu())
        check(torch.equal(acc, plain),
              f"(a) text layer 0 fc1 input {tuple(fc1_in[0].shape)} x {tuple(fc1.weight.shape)}: torch._int_mm's "
              f"int32 accumulators equal the plain CPU int32 product exactly (max |acc| {int(plain.abs().max())})")
        del fc1_in, v8, vb, t8, tb

        def cond(b):
            def call():
                concept, id_ctx = inf.encode_condition(models, px[:b], None)
                return models.text_encoder(ids[:b], concept, pidx[:b])[0], id_ctx
            return call

        timing = {}
        with torch.no_grad():
            for b, iters in ((B, 5), (1, 20)):
                route = {"bf16": bf16_route, "int8": contextlib.nullcontext}
                order = ["bf16", "int8", "int8", "bf16"] * 2
                took = []
                for name in order:
                    with route[name]():
                        took.append(_time_ms(cond(b), iters))
                timing[b] = {}
                for k in route:
                    med = float(np.median([m for n, m in zip(order, took) if n == k]))
                    timing[b][k] = (med, b / (med / 1e3))
                log(f"identity: (a) conditioning at batch {b} (vision encoder, adapters, text encoder with the "
                    f"concept), ms per call in turns: " + ", ".join(f"{n} {m:.4f}" for n, m in zip(order, took))
                    + f"; median bf16 {timing[b]['bf16'][0]:.4f} ms ({timing[b]['bf16'][1]:.2f} identities/s), "
                    f"int8 {timing[b]['int8'][0]:.4f} ms ({timing[b]['int8'][1]:.2f} identities/s) ({smi})")
        # one product at the ViT-L/14 fc1 shape at batch 64: torch._int_mm
        # against the bf16 matmul of the same operands
        xs = torch.randn(B * 257, v.hidden_size, device="cuda", dtype=torch.bfloat16)
        ws = torch.randn(v.intermediate_size, v.hidden_size, device="cuda", dtype=torch.bfloat16)
        xq, wq = quant.quantize_activation(xs)[0], quant.quantize_weight(ws)[0]
        mm_ms = {"int_mm": _time_ms(lambda: quant.int8_product(xq, wq), 20),
                 "int8_matmul": _time_ms(lambda: quant.int8_matmul(xs, ws, None, torch.bfloat16), 20),
                 "bf16": _time_ms(lambda: xs @ ws.t(), 20)}
        ops = 2 * B * 257 * v.hidden_size * v.intermediate_size
        log(json.dumps({"int8_route": {
            "name": "int8_matmul", "route": "torch._int_mm", "source": "photoverse_tpu_torch/ops/quant.py",
            "replaces": "photoverse_tpu/ops/quant.py:44 (jax.lax.dot_general int8 x int8 -> int32, not Pallas)",
            "launches": int8_launches, "shape": [B * 257, v.hidden_size, v.intermediate_size],
            "int_mm_ms": mm_ms["int_mm"], "int8_matmul_ms": mm_ms["int8_matmul"], "bf16_matmul_ms": mm_ms["bf16"],
            "bound_ms": ops / 1979e12 * 1e3,
            "conditioning_ms": {str(b): {k: x[0] for k, x in tm.items()} for b, tm in timing.items()},
            "identities_per_s": {str(b): {k: x[1] for k, x in tm.items()} for b, tm in timing.items()},
            "card": smi}}))
        del xs, ws, xq, wq

        # (c) the native tokenizer, built on this host, and a service with it
        t0 = time.perf_counter()
        native = NativeCLIPTokenizer.from_pretrained(root)
        build_s = time.perf_counter() - t0
        py = CLIPTokenizer.from_pretrained(root)
        prompts = ["a photo of a *", "the photo of the *", "  THE   Photo of  * ", "photo, of. the! *?",
                   "café photo of *", "", "a " * 50]
        same = all(np.array_equal(native(p), py(p)) for p in prompts) and np.array_equal(native(prompts), py(prompts))
        check(same, f"(c) NativeCLIPTokenizer (built in {build_s:.2f}s) ids equal data/tokenizer.py's on "
                    f"{len(prompts)} prompts, one non-ASCII, one truncated")
        args = serve.build_parser().parse_args(["--model_path", root, "--fast", "--resolution", "512",
                                                "--native_tokenizer", "--int8_conditioning"])
        svc = serve.PhotoVerseService(args, models=(py, models))
        body = {"image_path": photo, "prompt": "a photo of a {}", "num_samples": 1, "steps": 10,
                "guidance_scale": 1.0, "seed": 5}
        req, n, seed, key = svc._prepare(body)
        launches0 = trace.counts("launch.")
        res = svc.submit(req, n, seed, key)
        served = trace.since(launches0, "launch.")
        want = dict(_serving_counts(10), int8_matmul=per_layer * (t.num_layers + v.num_layers))
        check(isinstance(svc.tokenizer, NativeCLIPTokenizer) and res["images"].shape == (1, 512, 512, 3)
              and res["images"].dtype == np.uint8 and np.array_equal(req["text_input_ids"][0], py("a photo of a *")[0])
              and served == want,
              f"(c) PhotoVerseService --native_tokenizer --int8_conditioning served one request in "
              f"{res['latency_s']:.3f}s, launches {served}")
        del svc, models, seen, px, ids, pidx, c8, i8, cb, ib
        torch.cuda.empty_cache()

        # (d) cli.train, the canonical recipe with the FaceNet face loss
        n_flash = _flash_layers(UNetConfig(), 64)
        per_step = []
        real_call = tr.TrainStep.__call__

        def counted(self, batch, draws):
            launches0 = trace.counts("launch.")
            out = real_call(self, batch, draws)
            per_step.append(("face" if "face_pixel_values" in batch else "diffusion", trace.since(launches0, "launch.")))
            return out

        out = os.path.join(tmp, "facenet_run")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(tr.TrainStep, "__call__", counted):
            fmodels, _, step = cli.main(["--recipe", "canonical", "--pretrained_model_name_or_path", root,
                                         "--data_root_path", data, "--output_dir", out, "--face_loss", "facenet",
                                         "--allow_random_face_model", "--max_train_steps", "2",
                                         "--checkpoint_save_steps", "1000", "--checkpoint_format", "pt",
                                         "--samples_save_steps", "2", "--seed", "0", "--report_to", "none"])
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        del fmodels
        torch.cuda.empty_cache()
        with open(os.path.join(out, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        steps = [r for r in rows if "loss_mle" in r]
        sim = [r for r in rows if "face_similarity" in r]
        want_counts = {kind: _train_counts(n_flash, tr.TrainConfig.face_loss_timesteps, kind == "face", remat=True)
                       for kind in ("face", "diffusion")}
        wrong = [(i, kind, c) for i, (kind, c) in enumerate(per_step) if c != want_counts[kind]]
        check(step == 2 and [r["step"] for r in steps] == [1, 2]
              and all(np.isfinite(r[k]) for r in steps for k in r) and len(sim) == 1
              and [k for k, _ in per_step] == ["diffusion", "face"] * 2 and not wrong,
              f"(d) cli.train --recipe canonical --face_loss facenet ({train_s:.1f}s with the load): batch 16 = 8 x 2, "
              f"remat; losses {[(r['loss_mle'], r['loss_face']) for r in steps]}, face_similarity "
              f"{sim[0]['face_similarity'] if sim else None}; launches per micro-step as the ArcFace recipe's "
              f"(diffusion {want_counts['diffusion']}, face {want_counts['face']})"
              + (f"; first wrong: {wrong[0]}" if wrong else ""))
        log(f"identity: (d) s per optimizer step {[round(r['step_time_s'], 4) for r in steps]} (the first warms "
            f"up), peak device memory {peak:.2f} GiB ({smi})")

        # (e) the face-similarity eval CLI over (b)'s images, on the card and
        # with --cpu, with random FaceNet and ArcFace files and random MTCNN
        # weights
        weights = {"facenet": os.path.join(tmp, "facenet.pt"), "arcface": os.path.join(tmp, "arcface.pt")}
        torch.save(init_facenet(InceptionResnetV1(device="cpu"), seed=1).state_dict(), weights["facenet"])
        torch.save(init_arcface(ArcFaceResNet18(device="cpu"), seed=1).state_dict(), weights["arcface"])
        first = np.asarray(Image.open(os.path.join(results, files[0])))
        face = np.asarray(Image.open(photo).convert("RGB"))
        for p_bias in MTCNN_PNET_BIASES:
            biases = (p_bias, *MTCNN_FACE_BIAS)
            mt = _write_mtcnn(os.path.join(tmp, f"mtcnn_{p_bias}"), 80, biases)
            cpu_det = MTCNN.from_torch_weights(mt, device="cpu")
            t0 = time.perf_counter()
            found = [cpu_det.detect(x)[0] for x in (face, first)]
            log(f"identity: (e) random MTCNN, face-logit biases {biases}: boxes on the input photo and on "
                f"{files[0]} {[None if f is None else len(f) for f in found]} ({time.perf_counter() - t0:.2f}s "
                f"on the CPU)")
            if all(f is not None for f in found):
                break

        def run_eval(model, cpu):
            argv = ["--input_image", photo, "--results_dir", results, "--model", model, "--model_weights",
                    weights[model], "--mtcnn_weights", mt, "--json"] + (["--cpu"] if cpu else [])
            buf, err = io.StringIO(), io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
                ev.main(argv)
            secs = time.perf_counter() - t
            if err.getvalue().strip():
                log(f"  stderr: {err.getvalue().strip()}")
            return json.loads(buf.getvalue().strip().splitlines()[-1]), secs

        for model in ("facenet", "arcface"):
            card, card_s = run_eval(model, cpu=False)
            host, host_s = run_eval(model, cpu=True)
            diff = max(abs(card["scores"][k] - host["scores"][k]) for k in host["scores"])
            check(list(card["scores"]) == list(host["scores"]) == files and diff <= EVAL_SCORE_ATOL
                  and any(s != 0.0 for s in host["scores"].values()),
                  f"(e) eval --model {model} --json: card {card['scores']} mean {card['mean']:.6f}, --cpu mean "
                  f"{host['mean']:.6f}, largest difference {diff:.3g} (tol {EVAL_SCORE_ATOL}); s per image card "
                  f"{card_s / (1 + len(files)):.3f}, cpu {host_s / (1 + len(files)):.3f} (with the load) ({smi})")
        t0 = time.perf_counter()
        bc, _ = MTCNN.from_torch_weights(mt, device="cuda").detect(first)
        card_s = time.perf_counter() - t0
        bh, _ = cpu_det.detect(first)
        same_n = bc is not None and bh is not None and len(bc) == len(bh)
        box_diff = float(np.abs(bc - bh).max()) if same_n else float("inf")
        check(same_n and box_diff <= MTCNN_BOX_ATOL,
              f"(e) MTCNN detect on {files[0]} at thresholds {cpu_det.thresholds}, face-logit biases {biases}: "
              f"card {None if bc is None else len(bc)} boxes ({card_s:.2f}s with the load), cpu "
              f"{None if bh is None else len(bh)}, largest box difference {box_diff:.3g} px (tol {MTCNN_BOX_ATOL})")
    return ok


# parallel phase: the generate CLI under --sharding on two ranks of one card
# against its one-process run, in uint8 steps, held at the serve phase's
# served-vs-solo limits (SERVE_SAME_U8, SERVE_SAME_MEAN_U8): two ranks sum
# their partial products and moments in another order, which in bf16 acts
# as another batch size's algorithms do
PARALLEL_MODES = ("data", "tensor", "spatial")
# the faults planted per mode in another run on the same ranks; each must
# read above the limit. The images cannot hold the spatial K/V gather (on
# random weights self-attention on half of the keys reads max 8, mean 0.86
# on an H100; PERF.md): the sharded flash wrapper is held on one layer's
# real inputs instead (`_hold_wrapper`)
PARALLEL_FAULTS = {
    "data": ("rank 1 takes rank 0's noise rows",),
    "tensor": ("the first feed-forward output layer skips its all_reduce",),
    "spatial": ("conv_in's halo rows zeroed",),
}
# seconds the two ranks may take for the three generations and the service
PARALLEL_TIMEOUT_S = 540


def _u8(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path), np.int32)


def _u8_diff(a, b):
    """(largest, mean) absolute difference of two uint8 image lists."""
    d = [np.abs(x - y) for x, y in zip(a, b)]
    return max(int(x.max()) for x in d), float(np.mean([x.mean() for x in d]))


def _plant(fault: str, models, spatial):
    """Plant one parallel-phase fault on this rank's models; returns the
    function that removes it (the data fault lives in the draws)."""
    import copy
    import types

    import torch

    from photoverse_tpu_torch.models.unet import _FeedForward
    from photoverse_tpu_torch.parallel.tp import RowParallelLinear

    if fault.endswith("skips its all_reduce"):
        layer = next(m for m in models.unet.modules() if isinstance(m, _FeedForward)).net[2]
        assert isinstance(layer, RowParallelLinear)
        comm = layer.comm
        layer.comm = types.SimpleNamespace(all_reduce=lambda t: t, size=comm.size)
        return lambda: setattr(layer, "comm", comm)
    if fault.startswith("conv_in"):
        conv = models.unet.conv_in
        zero = copy.copy(spatial)
        zero.halos = lambda x: (torch.zeros_like(x[:, :, :1]),) * 2
        conv.spatial = zero
        return lambda: setattr(conv, "spatial", spatial)
    return lambda: None


def _hold_wrapper(comm, q, k, v) -> dict:
    """sharded_flash(comm, "spatial") on this rank's rows of one real
    self-attention layer (q, k, v as the layer gave them to the wrapper),
    the outputs gathered, against the plain version on the whole sequence
    (f32) at the flash limit; and the planted fault, the kernel on the
    local K/V only (no gather), against the same."""
    import torch

    from photoverse_tpu_torch.ops.flash_sdpa import flash_sdpa, flash_sdpa_plain
    from photoverse_tpu_torch.parallel.flash import sharded_flash

    with torch.no_grad():
        whole = [comm.all_gather(t, 1) for t in (q, k, v)]
        want = flash_sdpa_plain(*(t.float() for t in whole))
        got = comm.all_gather(sharded_flash(comm, "spatial")(q, k, v), 1)
        local = comm.all_gather(flash_sdpa(q, k, v), 1)
        kernel = flash_sdpa(*whole)

    def err(t):
        return (t.float() - want).abs().max().item()

    return dict(local=list(q.shape), whole=list(whole[1].shape), err=err(got), fault_err=err(local),
                whole_kernel_err=err(kernel), tol=FLASH_RTOL * want.abs().max().item())


def _rank_generate(job: dict) -> dict:
    """cli.generate's main on this rank, its run_inference_sharded watched:
    the launches of the first run, the time of it and of a second run, and
    each planted fault's run (rank 0 writes those images)."""
    import torch

    from photoverse_tpu_torch.cli import generate as gen
    from photoverse_tpu_torch.engine import inference as inf
    from photoverse_tpu_torch.utils import trace
    from photoverse_tpu_torch.utils.image import denormalize, to_pil

    real = inf.run_inference_sharded
    rec = {}

    def spy(models, solver, example, generator, mesh, spatial=None, **kw):
        B = len(example["text_input_ids"])

        def fresh():
            return torch.Generator(device=generator.device).manual_seed(generator.initial_seed())

        cfg, captured = models.unet.config, []
        if job.get("wrapper"):  # the first flash self-attention's inputs

            def capture(q, k, v):
                if not captured:
                    captured.append((q, k, v))
                return cfg.flash_fn(q, k, v)

            models.unet.set_config(dataclasses.replace(cfg, flash_fn=capture))
        seconds = []
        for i in range(2):  # the first run warms this rank up
            torch.cuda.synchronize()
            launches0 = trace.counts("launch.")
            t0 = time.perf_counter()
            images = real(models, solver, example, fresh(), mesh, spatial, **kw)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if i == 0:
                rec["counts"] = trace.since(launches0, "launch.")
                models.unet.set_config(cfg)
        if captured:
            rec["wrapper"] = _hold_wrapper(mesh.model_comm, *captured.pop())
        rec.update(seconds=seconds, images=B, backend=mesh.backend, mesh=[mesh.dp, mesh.mp])
        for j, fault in enumerate(job["faults"]):
            draws = None
            if fault.startswith("rank 1 takes"):
                draws = inf.draw_noise(models, solver, fresh(), B, kw["latent_size"], kw["from_noised_image"])
                per = B // mesh.dp
                draws["initial_noise"][per:2 * per] = draws["initial_noise"][:per]
            undo = _plant(fault, models, spatial)
            try:
                bad = real(models, solver, example, fresh(), mesh, spatial, draws=draws, **kw)
            finally:
                undo()
            if mesh.rank == 0:
                d = os.path.join(job["out"], f"fault{j}")
                os.makedirs(d, exist_ok=True)
                for idx, img in enumerate(bad.float().cpu().numpy()):
                    to_pil(denormalize(img)).save(os.path.join(d, f"{idx}.png"))
        return images

    t0 = time.perf_counter()
    with mock.patch.object(inf, "run_inference_sharded", spy):
        gen.main(job["argv"])
    rec["main_seconds"] = time.perf_counter() - t0
    return rec


@contextlib.contextmanager
def _models_loaded_once(cache: dict):
    """assembly.load_models memoised by its arguments for the jobs of one
    rank: the first call with an argument set loads from the directory,
    every call returns a deep copy (the CLIs cut and train what they get),
    so a rank reads and converts the weights once per set."""
    import copy

    from photoverse_tpu_torch.models import assembly

    real = assembly.load_models

    def load(*a, **kw):
        key = repr((a, sorted(kw.items())))
        if key not in cache:
            cache[key] = real(*a, **kw)
        tok, models, lora = cache[key]
        return tok, copy.deepcopy(models), lora

    with mock.patch.object(assembly, "load_models", load):
        yield cache


def parallel_rank(jobs_path: str) -> int:
    """One rank of the parallel phase (started by torch.distributed.run):
    each job of the file in turn, cli.generate under --sharding in each
    mode, then cli.serve; what each generation saw goes to rank{r}.json."""
    import torch
    import torch.distributed as dist

    from photoverse_tpu_torch.cli import serve
    from photoverse_tpu_torch.parallel import mesh as pm

    torch.backends.cuda.matmul.allow_tf32 = False  # as the one-process run (phase_device)
    torch.backends.cudnn.allow_tf32 = False
    with open(jobs_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    with open(os.path.join(spec["dir"], f"rank{rank}.pid"), "w") as f:
        f.write(str(os.getpid()))
    results = {}
    # the jobs share this process's group (the CLIs' close_mesh waits for the
    # end): re-opening it from the launcher's store would meet the keys the
    # last group left there
    with mock.patch.object(pm, "close_mesh", lambda mesh: None), _models_loaded_once({}):
        for job in spec["jobs"]:
            if job["cli"] == "generate":
                results[job["mode"]] = _rank_generate(job)
            else:
                serve.main(job["argv"])
                results["serve"] = "returned"
            with open(os.path.join(spec["dir"], f"rank{rank}.json"), "w") as f:
                json.dump(results, f)
    dist.destroy_process_group()
    return 0


def phase_parallel(smi: str, root: str, data: str):
    """cli.generate --sharding data|tensor|spatial and cli.serve --sharding
    tensor on two ranks that share the card (`python -m
    torch.distributed.run --nproc_per_node 2`, gloo), against the
    one-process runs."""
    import base64
    import io
    import signal
    import urllib.request

    import torch
    from PIL import Image

    from photoverse_tpu_torch.cli import generate as gen
    from photoverse_tpu_torch.cli import serve
    from photoverse_tpu_torch.data.tokenizer import CLIPTokenizer
    from photoverse_tpu_torch.engine import inference as inf
    from photoverse_tpu_torch.utils import trace

    ok = True

    def check(good, what):
        nonlocal ok
        ok &= bool(good)
        log(f"parallel: {what} {'OK' if good else 'FAIL'}")

    def within(diff):
        return diff[0] <= SERVE_SAME_U8 and diff[1] <= SERVE_SAME_MEAN_U8

    photo = os.path.join(data, "images", "0.jpg")
    flags = ["--model_path", root, "--checkpoint_path", "", "--input_image_path", photo, "--num_timesteps", "10",
             "--resolution", "512", "--num_of_samples", "2", "--seed", "0", "--fast"]
    serve_flags = ["--model_path", root, "--fast", "--resolution", "512", "--port", "0"]
    with open(photo, "rb") as f:
        body = {"image_b64": base64.b64encode(f.read()).decode(), "prompt": "a photo of a {}", "steps": 10,
                "guidance_scale": 1.0}
    bodies = [dict(body, num_samples=2, seed=3), dict(body, seed=4, scheduler="euler_a")]
    with tempfile.TemporaryDirectory() as tmp:
        # the one-process runs, in this process
        seen = {}
        real = inf.run_inference

        def spy(models, *a, **kw):
            torch.cuda.synchronize()
            launches0 = trace.counts("launch.")
            t0 = time.perf_counter()
            imgs = real(models, *a, **kw)
            torch.cuda.synchronize()
            seen.update(counts=trace.since(launches0, "launch."), seconds=time.perf_counter() - t0, models=models)
            return imgs

        t0 = time.perf_counter()
        with mock.patch.object(inf, "run_inference", spy):
            gen.main(flags + ["--results_dir", os.path.join(tmp, "one")])
        one = [_u8(os.path.join(tmp, "one", f"generated_image{i}.png")) for i in range(2)]
        check(seen["counts"] == _serving_counts(10),
              f"one process: cli.generate --fast, 512px, batch 2, 10 steps: launches {seen['counts']}, "
              f"{seen['seconds'] / 2:.4f} s/image, {time.perf_counter() - t0:.1f}s with the load ({smi})")
        # the one-process service, on the models the CLI loaded with the
        # same flags
        svc = serve.PhotoVerseService(serve.build_parser().parse_args(serve_flags),
                                      models=(CLIPTokenizer.from_pretrained(root), seen.pop("models")))
        solo = [svc.generate(b) for b in bodies]
        del svc
        torch.cuda.empty_cache()

        # the ranks: the three generations, then the service
        jobs = [dict(cli="generate", mode=m, faults=PARALLEL_FAULTS[m], out=os.path.join(tmp, m),
                     wrapper=m == "spatial", argv=flags + ["--results_dir", os.path.join(tmp, m), "--sharding", m])
                for m in PARALLEL_MODES]
        jobs.append(dict(cli="serve", argv=serve_flags + ["--sharding", "tensor"]))
        jobs_path = os.path.join(tmp, "jobs.json")
        with open(jobs_path, "w") as f:
            json.dump({"dir": tmp, "jobs": jobs}, f)
        log_path = os.path.join(tmp, "ranks.log")
        here = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        with open(log_path, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                 os.path.abspath(__file__), "--parallel-rank", jobs_path],
                cwd=here, stdout=out, stderr=subprocess.STDOUT, start_new_session=True,
                env=dict(os.environ, OMP_NUM_THREADS="4"))  # the host's 8 cores over two ranks
        deadline = time.monotonic() + PARALLEL_TIMEOUT_S
        served, port = [], None
        try:
            while port is None and proc.poll() is None and time.monotonic() < deadline:
                with open(log_path) as f:
                    found = re.findall(r"listening on http://127\.0\.0\.1:(\d+)", f.read())
                port = found[0] if found else None
                time.sleep(0.5)
            if port is not None:
                for b in bodies:
                    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=json.dumps(b).encode(),
                                                 headers={"Content-Type": "application/json"})
                    served.append(json.loads(urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S).read()))
                with open(os.path.join(tmp, "rank0.pid")) as f:
                    os.kill(int(f.read()), signal.SIGTERM)  # rank 0 drains and stops rank 1
            proc.wait(timeout=max(deadline - time.monotonic(), 1))
        except Exception as e:  # noqa: BLE001 - reported, then the phase fails
            check(False, f"the ranks' run: {e!r}")
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        wall = time.perf_counter() - t0
        with open(log_path) as f:
            ranks_log = f.read()
        pids = []
        for r in range(2):
            with contextlib.suppress(OSError, ValueError), open(os.path.join(tmp, f"rank{r}.pid")) as f:
                pids.append(int(f.read()))
        alive = [p for p in pids if os.path.exists(f"/proc/{p}")]
        check(proc.returncode == 0 and len(pids) == 2 and not alive,
              f"torch.distributed.run --nproc_per_node 2: exit {proc.returncode} after {wall:.1f}s, ranks "
              f"{pids} running after it: {alive}")
        if proc.returncode != 0:
            log(ranks_log[-6000:])
        backend = re.findall(r"\[parallel\] backend .*", ranks_log)
        log(f"parallel: {backend[0] if backend else 'no backend line'}")
        check(any("backend gloo" in b for b in backend), "two ranks on one card chose gloo")
        ranks = []
        for r in range(2):
            with contextlib.suppress(OSError, ValueError), open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        if len(ranks) != 2 or any(set(rk) != {*PARALLEL_MODES, "serve"} for rk in ranks):
            check(False, f"every rank ran every job: {[sorted(rk) for rk in ranks]}")
            return ok
        log("parallel: two ranks share one H100's SMs and gloo moves every collective through the host, so "
            "these times are the cost of the collectives, not a multi-GPU speed-up")
        for m in PARALLEL_MODES:
            got = [_u8(os.path.join(tmp, m, f"generated_image{i}.png")) for i in range(2)]
            diff = _u8_diff(got, one)
            # no fused tails under tensor and spatial: the cross-attention kernel in all 16 blocks
            want = {"data": _serving_counts(10), "spatial": {"flash_sdpa": 100, "dual_cross_attn": 160},  # split norms: no kernel
                    "tensor": {"flash_sdpa": 100, "dual_cross_attn": 160,
                               "group_norm_nhwc": UNET_NORMS * 10 + DECODER_NORMS}}[m]
            counts = [rk[m]["counts"] for rk in ranks]
            secs = [rk[m]["seconds"] for rk in ranks]
            check(within(diff) and all(c == want for c in counts),
                  f"--sharding {m} (mesh {ranks[0][m]['mesh']}): images against one process max {diff[0]} mean "
                  f"{diff[1]:.4f} of 255 (limits {SERVE_SAME_U8}, {SERVE_SAME_MEAN_U8}); launches per rank "
                  f"{counts} (want {want}); s/image first / second run per rank "
                  f"{[[round(s / 2, 4) for s in x] for x in secs]} against {seen['seconds'] / 2:.4f} in one "
                  f"process; the CLI's main {[round(rk[m]['main_seconds'], 1) for rk in ranks]} s per rank "
                  f"({smi})")
            for j, fault in enumerate(PARALLEL_FAULTS[m]):
                bad = [_u8(os.path.join(tmp, m, f"fault{j}", f"{i}.png")) for i in range(2)]
                fd = _u8_diff(bad, one)
                check(not within(fd), f"planted fault under --sharding {m}, {fault}: max {fd[0]} mean "
                                      f"{fd[1]:.4f} of 255, {'above' if not within(fd) else 'NOT above'} the limit")
            if m == "spatial":
                w = [rk[m]["wrapper"] for rk in ranks]
                check(all(x["err"] <= x["tol"] < x["fault_err"] for x in w),
                      f"sharded_flash(spatial) on each rank's rows of the first self-attention layer, local "
                      f"{w[0]['local']} against K/V {w[0]['whole']}, gathered, against the plain version on the "
                      f"whole sequence: max |err| {[x['err'] for x in w]} (the kernel on the whole sequence "
                      f"{[x['whole_kernel_err'] for x in w]}), limit {[x['tol'] for x in w]}; planted fault, the "
                      f"local K/V only: {[x['fault_err'] for x in w]}, above the limit")

        def pixels(resp):
            return [np.asarray(Image.open(io.BytesIO(base64.b64decode(b))), np.int32) for b in resp["images_b64"]]

        for b, got, want in zip(bodies, served, solo):
            diff = _u8_diff(pixels(got), pixels(want))
            check(within(diff) and len(got["images_b64"]) == len(want["images_b64"]),
                  f"cli.serve --sharding tensor over HTTP, {b.get('scheduler', 'dpm')} x{b.get('num_samples', 1)} "
                  f"seed {b['seed']}: against a one-process service max {diff[0]} mean {diff[1]:.4f} of 255; "
                  f"latency {got['latency_s']} s (one process {want['latency_s']} s)")
        check(len(served) == len(bodies) and "[serve] rank 1: stopped by rank 0" in ranks_log
              and "[serve] drained; exiting" in ranks_log,
              f"cli.serve --sharding tensor: {len(served)} of {len(bodies)} requests answered; SIGTERM at rank 0 "
              f"drained it and stopped rank 1")
    return ok


# the parallel-train phase: cli.train --recipe canonical on two ranks that
# share the card, under each multi-GPU training flag (the batch cut to 8 as
# micro-batches of 4 x 2 accumulation steps, 2 optimizer steps; --fsdp is
# stopped by SIGTERM at one rank after step 1 and resumed to step 2)
PARALLEL_TRAIN_MODES = ("zero1", "tp", "fsdp")
PARALLEL_TRAIN_FLAGS = {
    "zero1": ["--shard_optimizer_state", "--max_microbatch_per_chip", "2"],
    "tp": ["--tensor_parallel", "2", "--max_microbatch_per_chip", "4", "--samples_save_steps", "2"],
    "fsdp": ["--fsdp", "--max_microbatch_per_chip", "2"],
}
# the planted fault of each mode's gradient check (run on the first
# diffusion micro-step's inputs, before the counted step), and the two that
# show after an update
PARALLEL_TRAIN_GRAD_FAULTS = {
    "zero1": ("the data group's gradients summed, not averaged",),
    "tp": ("the column-parallel inputs without the backward sum (no f operator)",),
    "fsdp": (),
}
# the sharded run's gradient of the first diffusion micro-step (gathered
# whole, the data group's mean) against one process's on the same weights,
# batch and draws, in bf16: the relative L2 distance per trainable group,
# held at the train phase's kernels-against-plain limit (the ranks' bf16
# products sum over other groupings of rows and heads)
PARALLEL_GRAD_RTOL = TRAIN_GRAD_RTOL
# seconds the two ranks may take for the three runs and the resume
PARALLEL_TRAIN_TIMEOUT_S = 600


def _whole_grads(layout, grads, summed: bool = False):
    """A rank's micro-step gradients made whole on every rank: the data
    group's mean (or, planted, its sum), the shards gathered."""
    acc = {k: g.detach().clone() for k, g in grads.items()}
    layout.reduce_grads(acc)
    if summed:
        for g in acc.values():
            g.mul_(layout.mesh.dp)
    return {k: layout.gather(k, v) for k, v in acc.items()}


def _group_rel(got: dict, want: dict) -> dict:
    """Relative L2 distance per trainable group (text_adapter,
    image_adapter, unet)."""
    import torch

    out = {}
    for group in sorted({k.split(".", 1)[0] for k in want}):
        keys = [k for k in want if k.startswith(group + ".")]
        num = torch.sqrt(sum((got[k].float() - want[k].float()).square().sum() for k in keys))
        den = torch.sqrt(sum(want[k].float().square().sum() for k in keys))
        out[group] = float(num / den)
    return out


def _rank_train(job: dict, loaded: dict, memo: dict) -> dict:
    """cli.train's main on this rank with its micro-steps watched: the
    launches of each, the first diffusion micro-step's gradient made whole
    (and, on its inputs before the counted call, each planted fault's), and
    on rank 0 one process's gradient on the same weights (the models as
    loaded: `loaded` holds the one bundle every run loads), batch and
    draws."""
    import copy

    import torch

    from photoverse_tpu_torch.ckpt import checkpoint as ck
    from photoverse_tpu_torch.cli import train as cli
    from photoverse_tpu_torch.engine import training as tr
    from photoverse_tpu_torch.models import layers, unet
    from photoverse_tpu_torch.utils import trace
    from photoverse_tpu_torch.parallel import fsdp, mesh as pm, training as ptr

    rec = {"counts": [], "collectives": []}
    first = {}
    moved = {"n": 0}
    real_call = tr.TrainStep.__call__
    calls = collections.Counter()
    real_reduce, real_gather = pm.Comm.all_reduce, pm.Comm.all_gather

    def counted(fn, kind):
        def run(self, t, *a):
            calls[kind] += 1
            calls[kind + "_bytes"] += t.numel() * t.element_size()
            return fn(self, t, *a)
        return run

    def fresh(d):
        """The draws with a new dropout generator in the state the CLI's began in."""
        out = {k: (torch.Generator(device=v.device).manual_seed(v.initial_seed()) if isinstance(v, torch.Generator)
                   else fresh(v) if isinstance(v, dict) else v) for k, v in d.items()}
        return out

    def call(self, batch, draws):
        layout = self.layout
        if "face_pixel_values" not in batch and not first.get("batch") and not job.get("resume_of"):
            # the first diffusion micro-step's inputs, kept for the checks after the run
            first.update(step=self, batch=batch, draws=fresh(draws), cfg=self.cfg)
        torch.cuda.synchronize()
        launches0 = trace.counts("launch.")
        calls.clear()
        out = real_call(self, batch, draws)
        torch.cuda.synchronize()
        rec["counts"].append(("face" if "face_pixel_values" in batch else "diffusion", trace.since(launches0, "launch.")))
        rec["collectives"].append(dict(calls))
        moved["n"] += 1
        if job.get("sigterm_at") == moved["n"] and layout.mesh.rank == 1:
            signal.raise_signal(signal.SIGTERM)  # one rank only: the CLI stops every rank at this step
        return out

    resumed = {}
    real_shard = ptr.shard_training

    def shard(models, optimizer, mesh, **kw):
        new = real_shard(models, optimizer, mesh, **kw)
        if job.get("resume_of"):  # the resumed state, re-cut, gathered whole
            resumed.update(snap=ck.host_save_snapshot(models, new.layout), opt=ck.optax_state(new))
        else:  # this rank's trainables before any step (set up, before the CLI's first timed step)
            first["initial"] = {k: p.detach().clone() for k, p in new.params.items()}
        return new

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(tr.TrainStep, "__call__", call), mock.patch.object(ptr, "shard_training", shard), \
            mock.patch.object(pm.Comm, "all_reduce", counted(real_reduce, "all_reduce")), \
            mock.patch.object(pm.Comm, "all_gather", counted(real_gather, "all_gather")):
        models, opt, step = cli.main(job["argv"])
    rec.update(main_seconds=time.perf_counter() - t0, step=step,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    layout = opt.layout
    mesh = layout.mesh
    if job["mode"] == "fsdp":  # the state at SIGTERM, as the checkpoint holds it
        memo["fsdp"] = dict(snap=ck.host_save_snapshot(models, layout), opt=ck.optax_state(opt))
    if job.get("resume_of") and mesh.rank == 0:
        def flat(t, where=""):
            if isinstance(t, dict):
                for k in sorted(t):
                    yield from flat(t[k], f"{where}/{k}")
            else:
                yield where, np.asarray(t)

        a, b = dict(flat(memo.pop(job["resume_of"]))), dict(flat(resumed))
        rec["resume_arrays"] = len(a)
        rec["resume_same"] = set(a) == set(b) and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                                                      for k in a)
    if job["mode"] == "zero1":
        # ZeRO-1 keeps the masters whole and equal on every data rank; a rank
        # that writes no other rank's updated slice leaves them apart
        def spread():
            flat = torch.cat([p.detach().reshape(-1) for p in opt.params.values()])
            every = mesh.data_comm.all_gather(flat[None], 0)
            return float((every - flat[None]).abs().max())

        rec["zero1_spread"] = spread()

        def no_write(self, params, slices):  # the planted fault: gathered, never written
            self.mesh.data_comm.all_gather(torch.cat([t.reshape(-1) for t in slices.values()]), 0)

        with mock.patch.object(ptr.TrainLayout, "gather_slices", no_write):
            g = {k: torch.randn_like(p) * 1e-3 for k, p in opt.params.items()}
            for _ in range(opt.accum):
                opt.step(g)
        rec["zero1_fault_spread"] = spread()
    if job["mode"] == "fsdp" and "batch" in first:
        # the forward on the shards as they are, twice, and on their values
        # from before the update (the planted stale shard)
        step_fn = tr.TrainStep(models, first["cfg"], opt)
        old = {id(p): first["initial"][k] for k, p in opt.params.items()}
        real_g = fsdp.gather_shard

        def loss(stale=False):
            patch = mock.patch.object(fsdp, "gather_shard", lambda t, comm, dim: real_g(
                old.get(id(t), t), comm, dim)) if stale else contextlib.nullcontext()
            with patch, torch.no_grad():
                return float(step_fn.loss_fn(first["batch"], fresh(first["draws"]))[0])

        rec["fsdp_loss"] = [loss(), loss(), loss(stale=True)]
    if "batch" in first:
        # the first diffusion micro-step again, after the run and outside its
        # timing: the trainables put back to their values before any step,
        # the gradient made whole, and each planted fault's on the same inputs
        step_first = first["step"]
        with torch.no_grad():
            for k, p in opt.params.items():
                p.copy_(first["initial"][k])
        batch = first["batch"]
        _, g = step_first.compute_grads(batch, fresh(first["draws"]))
        first["sound"] = _whole_grads(layout, g)
        first["faults"] = {}
        for fault in job["grad_faults"]:
            with contextlib.ExitStack() as stack:
                if "no f operator" in fault:
                    for m in (unet, layers):
                        stack.enter_context(mock.patch.object(m, "copy_to_model", lambda x, comm: x))
                _, g = step_first.compute_grads(batch, fresh(first["draws"]))
            first["faults"][fault] = _whole_grads(layout, g, summed="summed" in fault)
        del g
        first["batch"] = {k: mesh.data_comm.all_gather(v, 0) for k, v in batch.items()}
    if mesh.rank == 0 and "sound" in first:
        # one process on the same weights (the models as loaded), batch and draws
        (_, pristine, _), = loaded.values()
        one = copy.deepcopy(pristine)
        tr.init_train_state(one, first["cfg"])
        _, g1 = tr.TrainStep(one, first["cfg"]).compute_grads(first["batch"], fresh(first["draws"]))
        rec["grad_rel"] = _group_rel(first["sound"], g1)
        rec["fault_rel"] = {f: _group_rel(g, g1) for f, g in first["faults"].items()}
        rec["rows"] = int(first["batch"]["pixel_values"].shape[0])
        del one, g1
    del models, opt
    torch.cuda.empty_cache()
    return rec


def parallel_train_rank(jobs_path: str) -> int:
    """One rank of the parallel-train phase (started by
    torch.distributed.run): cli.train in each mode, the models loaded from
    the directory once (later runs take a copy of the loaded bundle)."""
    import torch
    import torch.distributed as dist

    from photoverse_tpu_torch.parallel import mesh as pm

    torch.backends.cuda.matmul.allow_tf32 = False  # as the one-process run (phase_device)
    torch.backends.cudnn.allow_tf32 = False
    with open(jobs_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    results, memo, loaded = {}, {}, {}
    with mock.patch.object(pm, "close_mesh", lambda mesh: None), _models_loaded_once(loaded):
        for job in spec["jobs"]:
            results[job["name"]] = _rank_train(job, loaded, memo)
            with open(os.path.join(spec["dir"], f"train_rank{rank}.json"), "w") as f:
                json.dump(results, f)
    dist.destroy_process_group()
    return 0


def phase_parallel_train(smi: str, root: str, data: str):
    """cli.train --recipe canonical on two ranks that share the card under
    --shard_optimizer_state, --tensor_parallel 2 and --fsdp (stopped by
    SIGTERM after step 1, resumed to step 2): launches per rank and
    micro-step, the gradient against one process's, the planted faults, the
    resume against the saved state bit for bit."""
    from photoverse_tpu_torch.models.unet import UNetConfig

    ok = True

    def check(good, what):
        nonlocal ok
        ok &= bool(good)
        log(f"parallel-train: {what} {'OK' if good else 'FAIL'}")

    n_flash = _flash_layers(UNetConfig(), 64)
    face_steps = 10
    want = {kind: _train_counts(n_flash, face_steps, kind == "face", remat=True) for kind in ("face", "diffusion")}
    with tempfile.TemporaryDirectory() as tmp:
        base = ["--recipe", "canonical", "--pretrained_model_name_or_path", root, "--data_root_path", data,
                "--allow_random_face_model", "--seed", "0", "--report_to", "none", "--train_batch_size", "8",
                "--max_train_steps", "2", "--checkpoint_save_steps", "1000", "--samples_save_steps", "1000",
                "--dataloader_num_workers", "2"]
        out = {m: os.path.join(tmp, m) for m in (*PARALLEL_TRAIN_MODES, "fsdp_resumed")}
        jobs = [dict(name=m, mode=m, grad_faults=PARALLEL_TRAIN_GRAD_FAULTS[m],
                     sigterm_at=2 if m == "fsdp" else None,
                     argv=base + PARALLEL_TRAIN_FLAGS[m] + ["--output_dir", out[m]]) for m in PARALLEL_TRAIN_MODES]
        jobs.append(dict(name="fsdp_resumed", mode="fsdp_resumed", grad_faults=(), resume_of="fsdp",
                         argv=base + PARALLEL_TRAIN_FLAGS["fsdp"] + [
                             "--output_dir", out["fsdp_resumed"],
                             "--resume_from", os.path.join(out["fsdp"], "photoverse_000001.msgpack")]))
        jobs_path = os.path.join(tmp, "train_jobs.json")
        with open(jobs_path, "w") as f:
            json.dump({"dir": tmp, "jobs": jobs}, f)
        log_path = os.path.join(tmp, "train_ranks.log")
        here = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        with open(log_path, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                 os.path.abspath(__file__), "--parallel-train-rank", jobs_path],
                cwd=here, stdout=f, stderr=subprocess.STDOUT, start_new_session=True,
                env=dict(os.environ, OMP_NUM_THREADS="4"))
        try:
            proc.wait(timeout=PARALLEL_TRAIN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            check(False, f"the ranks ended within {PARALLEL_TRAIN_TIMEOUT_S}s")
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        wall = time.perf_counter() - t0
        with open(log_path) as f:
            ranks_log = f.read()
        check(proc.returncode == 0, f"torch.distributed.run --nproc_per_node 2: exit {proc.returncode} after "
                                    f"{wall:.1f}s")
        if proc.returncode != 0:
            log(ranks_log[-8000:])
        ranks = []
        for r in range(2):
            with contextlib.suppress(OSError, ValueError), open(os.path.join(tmp, f"train_rank{r}.json")) as f:
                ranks.append(json.load(f))
        names = [j["name"] for j in jobs]
        if len(ranks) != 2 or any(sorted(rk) != sorted(names) for rk in ranks):
            check(False, f"every rank ran every run: {[sorted(rk) for rk in ranks]}")
            return ok
        for line in re.findall(r"\[parallel\] (?:backend|training) .*", ranks_log)[:5]:
            log(f"parallel-train: {line}")
        for name in names:
            r0, r1 = ranks[0][name], ranks[1][name]
            steps = []
            with contextlib.suppress(OSError), open(os.path.join(out[name], "metrics.jsonl")) as f:
                steps = [r for r in map(json.loads, f) if "loss_mle" in r]
            want_steps = [1] if name == "fsdp" else [2] if name == "fsdp_resumed" else [1, 2]
            finite = all(np.isfinite(r[k]) for r in steps for k in ("loss_mle", "loss_face", "step_time_s"))
            wrong = [(i, kind, c) for rk in (r0, r1) for i, (kind, c) in enumerate(rk["counts"]) if c != want[kind]]
            kinds = [k for k, _ in r0["counts"]]
            check([r["step"] for r in steps] == want_steps and finite and not wrong
                  and kinds == ["diffusion", "face"] * len(want_steps),
                  f"--{name}: steps {[r['step'] for r in steps]}, s per optimizer step "
                  f"{[round(r['step_time_s'], 4) for r in steps]}, loss_mle "
                  f"{[round(r['loss_mle'], 6) for r in steps]}, the CLI's main {r0['main_seconds']:.1f} / "
                  f"{r1['main_seconds']:.1f} s, peak {r0['peak_gib']:.2f} / {r1['peak_gib']:.2f} GiB per rank "
                  f"({smi}); {len(kinds)} micro-steps per rank, launches per micro-step each rank: diffusion "
                  f"{want['diffusion']}, face {want['face']}" + (f"; first wrong {wrong[0]}" if wrong else ""))
            log(f"parallel-train: --{name} collectives per micro-step (rank 0): "
                + "; ".join(f"{kind} {c.get('all_reduce', 0)} all_reduce {c.get('all_reduce_bytes', 0) / 2**20:.1f} "
                            f"MiB, {c.get('all_gather', 0)} all_gather {c.get('all_gather_bytes', 0) / 2**20:.1f} MiB"
                            for (kind, _), c in zip(r0["counts"], r0["collectives"])))
            if "grad_rel" in r0:
                rel = r0["grad_rel"]
                check(max(rel.values()) <= PARALLEL_GRAD_RTOL,
                      f"--{name}: the first diffusion micro-step's gradient (rows {r0['rows']}, gathered whole) "
                      f"against one process on the same weights, batch and draws, relative L2 per group "
                      f"{ {k: round(v, 6) for k, v in rel.items()} } (limit {PARALLEL_GRAD_RTOL})")
                for fault, frel in r0["fault_rel"].items():
                    check(max(frel.values()) > PARALLEL_GRAD_RTOL,
                          f"--{name}: planted fault, {fault}: {({k: round(v, 6) for k, v in frel.items()})}, "
                          f"above the limit")
        z = [ranks[r]["zero1"] for r in range(2)]
        check(all(x["zero1_spread"] == 0.0 < x["zero1_fault_spread"] for x in z),
              f"--shard_optimizer_state: the f32 masters after the run equal on both data ranks (max |diff| "
              f"{[x['zero1_spread'] for x in z]}); planted fault, a rank that writes no other rank's updated slice: "
              f"{[x['zero1_fault_spread'] for x in z]}, apart")
        fl = [ranks[r]["fsdp"]["fsdp_loss"] for r in range(2)]
        check(all(abs(c - a) > abs(b - a) for a, b, c in fl),
              f"--fsdp after step 1: the diffusion loss on the shards as they are, twice {[x[:2] for x in fl]}; "
              f"planted fault, the shards' values from before the update: {[x[2] for x in fl]}, further from the "
              f"first than the repeat")
        res = ranks[0]["fsdp_resumed"]
        check(res.get("resume_same") and res.get("resume_arrays", 0) > 100,
              f"--fsdp resumed from photoverse_000001.msgpack on fresh runs of the CLI: the state re-cut to the "
              f"ranks and gathered again ({res.get('resume_arrays')} arrays: trainables, AdamW moments and counts, "
              f"the accumulation window) equals the state at SIGTERM bit for bit")
        log("parallel-train: two ranks share one H100 and gloo moves every collective through the host: these "
            "times are the collectives' cost, not a multi-GPU speed-up")
    return ok


SOAK_TIMEOUT_S = 480


def phase_soak(smi: str, root: str, masked: str):
    """scripts/torch_train_soak.py, the user's soak, as a child process on
    the model directory and the prepared split: cli.train --recipe canonical
    to step 4 with a checkpoint and a sample grid every 2 steps, SIGTERM once
    step 2 is logged, a fresh process resumed from phase A's newest native
    checkpoint. The record must say ok, with a resume that neither skips nor
    repeats a step, finite losses and face_similarity rows in both phases."""
    ok = True

    def check(good, what):
        nonlocal ok
        ok &= bool(good)
        log(f"soak: {what} {'OK' if good else 'FAIL'}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "record.json")
        cmd = [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                                            "torch_train_soak.py"),
               "--sd", root, "--ds", masked, "--out", tmp, "--record", path,
               "--steps", "4", "--kill_at", "2", "--boundary", "2", "--phase_timeout", str(SOAK_TIMEOUT_S // 2)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=SOAK_TIMEOUT_S)
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        wall = time.perf_counter() - t0
        for name in ("runA/phaseA.log", "runB/phaseB.log"):
            log_path = os.path.join(tmp, name)
            if rc != 0 and os.path.exists(log_path):
                with open(log_path) as f:
                    log(f"soak: the end of {name}:\n" + "".join(f.readlines()[-30:]))
        rec = {}
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
    resume, trace, loss = rec.get("resume", {}), rec.get("face_similarity_trace", {}), rec.get("loss_trace", {})
    check(rc == 0 and rec.get("ok") is True,
          f"scripts/torch_train_soak.py --steps 4 --kill_at 2 --boundary 2 exit {rc} in {wall:.1f}s, record ok "
          f"{rec.get('ok')}; masked data {rec.get('recipe', {}).get('masked_data')}")
    check(resume.get("resume_exact") and resume.get("no_gap_no_repeat") and loss.get("all_finite"),
          f"SIGTERM at step {resume.get('killed_at_step')}, phase A's checkpoint at step "
          f"{resume.get('checkpoint_step')}, phase B from step {resume.get('phaseB_first_step')}: no gap, no "
          f"repeat {resume.get('no_gap_no_repeat')}; losses finite {loss.get('all_finite')}")
    check(trace.get("count_phaseA", 0) > 0 and trace.get("count_phaseB", 0) > 0,
          f"face_similarity rows by phase {trace.get('count_phaseA')} / {trace.get('count_phaseB')}: "
          + ", ".join(f"step {r['step']} {r['face_similarity']:.6g}" for r in trace.get("rows", [])))
    st = rec.get("step_time", {})
    log(f"soak: phase A {rec.get('phaseA', {}).get('wall_s', float('nan')):.1f}s "
        f"({rec.get('phaseA', {}).get('steps_logged')} steps), phase B "
        f"{rec.get('phaseB', {}).get('wall_s', float('nan')):.1f}s ({rec.get('phaseB', {}).get('steps_logged')} "
        f"steps), each with its load; steady s per optimizer step A {st.get('phaseA_median')} B "
        f"{st.get('phaseB_median')} ({smi})")
    return ok


# what each kernel replaces: the file:line of its TPU kernel's pallas_call
# in the JAX package, or none
TPU_KERNELS = {
    "flash_sdpa": "photoverse_tpu/ops/flash_sdpa.py:154",
    "flash_sdpa_stream": "photoverse_tpu/ops/flash_sdpa.py:462",
    "fused_cross_ff": "photoverse_tpu/ops/fused_block.py:231",
    "flash_sdpa_fwd_lse": "photoverse_tpu/ops/flash_sdpa.py:206",
    "flash_bwd": "photoverse_tpu/ops/flash_sdpa.py:345",
    "flash_stream_fwd_lse": "photoverse_tpu/ops/flash_sdpa.py:500",
    "group_norm_nhwc": "none (the JAX package leaves GroupNorm to XLA)",
    "dual_cross_attn": "none (the JAX package leaves the cross-attention's einsums to XLA)",
}
SERVING_KERNELS = ("flash_sdpa", "flash_sdpa_stream", "fused_cross_ff", "group_norm_nhwc", "dual_cross_attn")


def main() -> int:
    t_start = time.perf_counter()
    marks = [("start", t_start)]

    def mark(name):  # each phase's wall time, for the log's last lines
        marks.append((name, time.perf_counter()))

    smi = phase_device()
    import torch

    phase_build()
    rows = phase_kernels(TPU_KERNELS)
    mark("device, build, kernels")
    models = serving_models()
    results, pipe_ok = phase_pipeline(models)
    mark("pipeline")
    samplers_ok = phase_samplers(models)
    mark("samplers")
    serve_launches, serve_ok = phase_serve(models)
    mark("serve")
    del models
    train_launches, train_ok = phase_train()
    mark("train")
    with tempfile.TemporaryDirectory() as tmp:
        root, data, tokenizer, celeba = write_user_files(tmp)
        masked, prepare_ok = phase_prepare(celeba)
        cli_ok = phase_train_cli(smi, root, masked, tokenizer) and prepare_ok
        mark("user files, prepare, train-cli")
        identity_ok = phase_identity(smi, root, data)
        mark("identity")
        torch.cuda.empty_cache()  # the ranks of the next phase share this card
        parallel_ok = phase_parallel(smi, root, data)
        mark("parallel")
        torch.cuda.empty_cache()
        parallel_train_ok = phase_parallel_train(smi, root, data)
        mark("parallel-train")
        torch.cuda.empty_cache()  # the soak's training processes share this card
        soak_ok = phase_soak(smi, root, masked)
        mark("soak")
    log("phase seconds: " + ", ".join(f"{name} {b - a:.1f}" for (_, a), (name, b) in zip(marks, marks[1:]))
        + f"; total {time.perf_counter() - t_start:.1f}")
    # each kernel's launches from the run of the path it lies on: the
    # 50-step generation, or the four training micro-steps; the serving
    # kernels also from the server's first coalesced batch
    launches = {n: results["g1"]["counts"].get(n, 0) if n in SERVING_KERNELS else train_launches.get(n, 0)
                for n in TPU_KERNELS}
    ok = (all(r["ok"] for r in rows) and pipe_ok and samplers_ok and serve_ok and train_ok and cli_ok and identity_ok
          and parallel_ok and parallel_train_ok and soak_ok
          and all(v > 0 for v in launches.values())
          and all(serve_launches.get(n, 0) > 0 for n in SERVING_KERNELS))
    summary = {"kernels": []}
    for name in TPU_KERNELS:
        mine = [r for r in rows if r["name"] == name and "ms" in r]
        first = mine[0]  # the main-path shape
        summary["kernels"].append({
            "name": name, "route": first["route"], "source": first["source"],
            "replaces": first["replaces"], "launches": launches[name],
            "serve_launches": serve_launches.get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "device_ms": first["device_ms"], "library_device_ms": first["library_device_ms"],
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
    if sys.argv[1:2] == ["--parallel-rank"]:  # a rank of the parallel phase
        sys.exit(parallel_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--parallel-train-rank"]:  # a rank of the parallel-train phase
        sys.exit(parallel_train_rank(sys.argv[2]))
    sys.exit(main())
