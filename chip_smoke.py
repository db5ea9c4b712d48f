"""Smoke run of the PyTorch/H100 port (photoverse_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each one fails the run on error):
  1. device: a CUDA card is required; prints its name and power limit.
  2. build:  compiles photoverse_tpu_torch/csrc/*.cu with nvcc (sm_90a).
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card at the shapes the main paths give it (and at ragged lengths
     for the flash forwards and the flash backward), with CUDA-event times
     beside the bound from ops/bounds.py and one PyTorch library call on the
     same inputs; planted faults show that each kernel's limit catches them.
  4. pipeline: SD-1.5-width models with random weights from a numpy seed,
     512px identity-conditioned generation (DPM-Solver++ 50 steps,
     guidance 1, two requests with their own noise seeds), then a guidance-6
     run; launch counters, image checks and the deviation from the same run
     with every kernel swapped for its plain version.
  5. train: the canonical recipe's train step at SD-1.5 width (bf16 with f32
     trainable masters, flash, LoRA 128/1/0.1, lr 1e-5, a random ArcFace,
     512px uint8 batches of 4, gradient accumulation 2 with the face branch
     on each window's last micro-step: 2 rows, 10 inner steps, guidance 2,
     face_weight_scale 2), 4 micro-steps = 2 optimizer updates; finite
     losses, moved trainables, untouched frozen weights, exact launch counts
     per micro-step, bit-identical repeat gradients, the same micro-step
     on the plain versions (plain autograd) against limits that planted
     faults exceed, and every training-kernel call of that micro-step
     against its plain version on the call's own inputs.
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
    from photoverse_tpu_torch.ops import flash_sdpa as fs
    from photoverse_tpu_torch.ops import fused_block as fb

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
    ]
    for B, Sq, Skv, H, d in flash_cases:
        q = (0.3 * torch.randn(B, Sq, H, d, generator=gen, device=dev)).bfloat16()
        k = (0.3 * torch.randn(B, Skv, H, d, generator=gen, device=dev)).bfloat16()
        v = (0.3 * torch.randn(B, Skv, H, d, generator=gen, device=dev)).bfloat16()
        got = fs.flash_sdpa(q, k, v)
        want = fs.flash_sdpa_plain(q.float(), k.float(), v.float())
        err = (got.float() - want).abs().max().item()
        tol = FLASH_RTOL * want.abs().max().item()
        plain_ms = _time_ms(lambda: fs.flash_sdpa_plain(q, k, v), 5)
        record("flash_sdpa", "cuda", wgmma_src, source_tpu["flash_sdpa"], err, tol,
               lambda: fs.flash_sdpa(q, k, v), 20, plain_ms,
               [B, Sq, Skv, H, d], bounds.flash_fwd(B, Sq, Skv, H, d), sdpa(q, k, v))
        if Sq == Skv and d == 40:
            dropped = fs.flash_sdpa(q, k[:, :-64], v[:, :-64])
            e = (dropped.float() - want).abs().max().item()
            fault(e > tol, f"flash_sdpa last 64 keys dropped: err {e:.6g} (tol {tol:.6g})")
    # lengths that are no multiple of the 64/128-row and 64-key tiles, keys
    # shorter than one tile, batch 1 and 4: the TMA boxes' zero fill and the
    # masks of the last tile
    for B, Sq, Skv, H, d in ((1, 1000, 4000, 8, 40), (4, 333, 77, 8, 80), (2, 4000, 1000, 8, 40),
                             (1, 77, 77, 8, 80)):
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

    B, S, H, d = 2, 4096, 1, 512  # the VAE decoder's mid-block attention
    q, k, v = ((0.3 * torch.randn(B, S, H, d, generator=gen, device=dev)).bfloat16() for _ in range(3))
    got = fs.flash_sdpa_stream(q, k, v)
    want = fs.flash_sdpa_plain(q.float(), k.float(), v.float())
    err = (got.float() - want).abs().max().item()
    tol = FLASH_RTOL * want.abs().max().item()
    plain_ms = _time_ms(lambda: fs.flash_sdpa_plain(q, k, v), 5)
    record("flash_sdpa_stream", "cuda", stream_src, source_tpu["flash_sdpa_stream"], err, tol,
           lambda: fs.flash_sdpa_stream(q, k, v), 10, plain_ms, [B, S, S, H, d],
           bounds.flash_fwd(B, S, S, H, d), sdpa(q, k, v, label="d=512"))
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

    for K in (1, 5):  # token_index=0 gives K=1; the training path K=5
        B, S, C, H, St, F = 2, 4096, 320, 8, 77, 1280
        h, bundle = _fused_inputs(gen, B, S, C, H, St, K, F, dev)
        got = fb.fused_cross_ff(h, bundle, H)
        want = fb.reference_cross_ff(h.float(), bundle, H)
        err = (got.float() - want).abs().max().item()
        plain_ms = _time_ms(lambda: fb.reference_cross_ff(h, bundle, H), 5)
        record("fused_cross_ff", "cuda", "photoverse_tpu_torch/csrc/fused_cross_ff.cu",
               source_tpu["fused_cross_ff"], err, FUSED_ATOL, lambda: fb.fused_cross_ff(h, bundle, H), 10,
               plain_ms, [B, S, C, H, St, K, F],
               bounds.fused_cross_ff(B, S, C, H, St, K, F))  # no single library call computes it
        if K == 1:
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
    # the face branch's 2 rows doubled by guidance), its face decode 2 rows
    lse_cases = [  # (kernel, B, S, H, d): the UNet's two levels, the VAE
        ("flash_sdpa_fwd_lse", 4, 4096, 8, 40), ("flash_sdpa_fwd_lse", 4, 1024, 8, 80),
        ("flash_stream_fwd_lse", 2, 4096, 1, 512),
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
        if name == "flash_sdpa_fwd_lse" and d == 40:
            planted(name, "lse off by one row", (got[0], got[1].roll(1, dims=-1)), want)
        if name == "flash_stream_fwd_lse":
            planted(name, "last 64 keys dropped",
                    fs.flash_fwd_lse(q, k[:, :-64], v[:, :-64]), want)

    for B, S, H, d in ((4, 4096, 8, 40), (4, 1024, 8, 80)):
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
        if d == 40:
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
    from photoverse_tpu_torch.models import unet, vae
    from photoverse_tpu_torch.ops import flash_sdpa as fs
    from photoverse_tpu_torch.ops import fused_block as fb

    with mock.patch.object(unet, "flash_sdpa", fs.flash_sdpa_plain), \
            mock.patch.object(unet, "flash_sdpa_diff", fs.flash_sdpa_plain), \
            mock.patch.object(unet, "fused_cross_ff", fb.reference_cross_ff), \
            mock.patch.object(vae, "flash_sdpa_stream", fs.flash_sdpa_plain), \
            mock.patch.object(vae, "flash_sdpa_stream_diff", fs.flash_sdpa_plain):
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
        fast_norms=True, fused_blocks=True), seed=0)
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
    from photoverse_tpu_torch.ops import _build
    from photoverse_tpu_torch.ops import flash_sdpa as fs

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
    # the first flash layer's inputs depend on no trainable weight, so
    # autograd runs no backward there
    main_counts = {"flash_sdpa_stream": 1, "flash_sdpa_fwd_lse": n_flash, "flash_bwd": n_flash - 1}
    face_counts = {  # + the face encode, the no-grad prefix, the grad step, the decode
        "flash_sdpa_stream": 2, "flash_sdpa": n_flash * (cfg.face_loss_timesteps - 1),
        "flash_sdpa_fwd_lse": 2 * n_flash, "flash_bwd": 2 * (n_flash - 1), "flash_stream_fwd_lse": 1,
    }

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
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = (face_step if face else plain_step)(batch, d)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        counts = dict(_build.launch_counts)
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

    _build.reset_launch_counts()
    with plain_kernels():
        mp, gp, _ = grads()
    plain_launches = dict(_build.launch_counts)

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
    del g1, gp

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
    log(f"train: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return totals, ok


# file:line of each TPU kernel's pallas_call in the JAX package
TPU_KERNELS = {
    "flash_sdpa": "photoverse_tpu/ops/flash_sdpa.py:154",
    "flash_sdpa_stream": "photoverse_tpu/ops/flash_sdpa.py:462",
    "fused_cross_ff": "photoverse_tpu/ops/fused_block.py:231",
    "flash_sdpa_fwd_lse": "photoverse_tpu/ops/flash_sdpa.py:206",
    "flash_bwd": "photoverse_tpu/ops/flash_sdpa.py:345",
    "flash_stream_fwd_lse": "photoverse_tpu/ops/flash_sdpa.py:500",
}
SERVING_KERNELS = ("flash_sdpa", "flash_sdpa_stream", "fused_cross_ff")


def main() -> int:
    phase_device()
    import torch

    phase_build()
    rows = phase_kernels(TPU_KERNELS)
    results, pipe_ok = phase_pipeline()
    train_launches, train_ok = phase_train()
    # each kernel's launches from the run of the path it lies on: the
    # 50-step generation, or the four training micro-steps
    launches = {n: results["g1"]["counts"].get(n, 0) if n in SERVING_KERNELS else train_launches.get(n, 0)
                for n in TPU_KERNELS}
    ok = all(r["ok"] for r in rows) and pipe_ok and train_ok and all(v > 0 for v in launches.values())
    summary = {"kernels": []}
    for name in TPU_KERNELS:
        mine = [r for r in rows if r["name"] == name and "ms" in r]
        first = mine[0]  # the main-path shape
        summary["kernels"].append({
            "name": name, "route": first["route"], "source": first["source"],
            "replaces": first["replaces"], "launches": launches[name],
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
    sys.exit(main())
