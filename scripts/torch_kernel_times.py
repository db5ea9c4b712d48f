"""Times and checks the port's wgmma kernels on one H100.

    python3 scripts/torch_kernel_times.py [flash] [bwd] [stream] [fused] [dual_cross] [--quick] [--earlier DIR]

For `flash_sdpa` (head dims 40, 64 and 80): error, CUDA-event, device and host
time at small, ragged and main-path shapes, beside one
`scaled_dot_product_attention` call on the same inputs. `bwd`: the same
for `flash_bwd` (errors of dq, dk, dv over their limits, the library time
by autograd through such a call). `stream`: the same for
`flash_sdpa_stream` and the d=512 `flash_fwd_lse`. For `fused_cross_ff`:
the same at K = 1 and 5. For `dual_cross_attention`: its error and the
einsum route's against the plain version in f32, and the time of the
kernel, of the einsum route (the plain version on the same bf16 inputs, what
the UNet ran before the kernel) and of the plain version in f32, at the
UNets' shapes. `--earlier DIR` also times these kernels of
another checkout of this repository (an earlier commit unpacked with
`git archive`) at the main-path shapes, on the same card in the same run,
twice: before and after this tree's families. Each family runs in a
child process with a time limit, so a kernel that hangs ends the child and
not the run. Prints the card's name and power limit first; `--quick` checks
each shape once and times nothing.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tree under test: the current directory for the `earlier` child, else this file's
sys.path.insert(0, os.getcwd() if "earlier" in sys.argv[1:3] else ROOT)

# this tree's chip_smoke.py for its limits and timers (it imports torch lazily)
_spec = importlib.util.spec_from_file_location("chip_smoke_here", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

FLASH_RTOL, LSE_ATOL, FUSED_ATOL, DUAL_RTOL = cs.FLASH_RTOL, cs.LSE_ATOL, cs.FUSED_ATOL, cs.DUAL_RTOL
time_ms = cs._time_ms


def device_ms(fn, iters):
    return cs._fmt_ms(cs._device_ms(fn, iters))


def device_split(fn, iters, names):
    """Device ms per call of the kernels whose name holds one of `names`,
    and of everything else, from one profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    parts = dict.fromkeys((*names, "other"), 0.0)
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        parts[next((n for n in names if n in e.key), "other")] += t / 1e3 / iters
    return " ".join(f"{k} {v:.4f}" for k, v in parts.items())


def log(msg):
    print(msg, flush=True)


def host_us(fn, iters=200):
    """Host time of one call (enqueue only), microseconds."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / iters * 1e6


def child_flash(quick: bool):
    import torch
    import torch.nn.functional as F

    from photoverse_tpu_torch.ops import bounds
    from photoverse_tpu_torch.ops import flash_sdpa as fs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    small = [(1, 100, 100, 2, 40), (2, 64, 200, 3, 80), (1, 1000, 4000, 2, 40), (4, 300, 77, 2, 80),
             (1, 100, 100, 2, 64)]
    # SD-1.5's head dims at scale 0.3, SDXL's d=64 at UNet batch 8 at scale 0.3, then unit scale
    main = [(2, 4096, 4096, 8, 40), (2, 1024, 1024, 8, 80), (2, 1024, 4096, 8, 40),
            (8, 4096, 4096, 10, 64), (8, 1024, 1024, 20, 64),
            (4, 4096, 4096, 8, 40), (4, 1024, 1024, 8, 80)]
    for B, Sq, Skv, H, d in small + main:
        scale = 0.3 if (B, Sq, Skv, H, d) not in main[5:] else 1.0
        q = (scale * torch.randn(B, Sq, H, d, generator=gen, device=dev)).bfloat16()
        k = (scale * torch.randn(B, Skv, H, d, generator=gen, device=dev)).bfloat16()
        v = (scale * torch.randn(B, Skv, H, d, generator=gen, device=dev)).bfloat16()
        want, want_lse = fs.flash_fwd_lse_plain(q.float(), k.float(), v.float())
        tol = FLASH_RTOL * want.abs().max().item()
        is_main = (B, Sq, Skv, H, d) in main
        ops, byts = bounds.flash_fwd(B, Sq, Skv, H, d)
        log(f"flash {(B, Sq, Skv, H, d)} scale {scale}: tol {tol:.4g}, bound "
            f"{bounds.bound_ms(ops, byts):.4f} ms")
        if is_main and not quick:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            log(f"  scaled_dot_product_attention: "
                f"{time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20):.4f} ms, device "
                f"{device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)} ms")
        got = fs.flash_sdpa(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        line = f"  err {err:.4g} ({err / tol:.3f} of tol)"
        if Sq == Skv:
            out2, lse = fs.flash_fwd_lse(q, k, v)
            lerr = (lse - want_lse).abs().max().item()
            same = torch.equal(out2, got)
            line += f" lse err {lerr:.3g} ({lerr / LSE_ATOL:.3f} of tol) out same {same}"
        again = fs.flash_sdpa(q, k, v)
        line += f" repeat identical {torch.equal(again, got)}"
        if is_main and not quick:
            line += (f" {time_ms(lambda: fs.flash_sdpa(q, k, v), 20):.4f} ms, device "
                     f"{device_ms(lambda: fs.flash_sdpa(q, k, v), 20)} ms")
        log(line + ("" if err <= tol else " FAIL"))
        if is_main and not quick:
            log(f"  host time per call: {host_us(lambda: fs.flash_sdpa(q, k, v)):.1f} us "
                f"(three cached tensor maps)")


def child_fused(quick: bool):
    import torch

    from photoverse_tpu_torch.ops import bounds
    from photoverse_tpu_torch.ops import fused_block as fb

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*s, scale=1.0, dtype=bf):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(dtype)

    C, H, F = 320, 8, 1280
    d = C // H
    cases = [(1, 64, 77, 1), (2, 100, 77, 5), (1, 200, 7, 1), (2, 4096, 77, 1), (2, 4096, 77, 5), (4, 4096, 77, 1)]
    for B, S, St, K in cases:
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
        h = rn(B, S, C)
        want = fb.reference_cross_ff(h.float(), bundle, H)
        ops, byts = bounds.fused_cross_ff(B, S, C, H, St, K, F)
        log(f"fused {(B, S, St, K)}: bound {bounds.bound_ms(ops, byts):.4f} ms")
        got = fb.fused_cross_ff(h, bundle, H)
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        err = diff.max().item()
        line = (f"  err {err:.4g} ({err / FUSED_ATOL:.3f} of tol) mean err "
                f"{diff.mean().item():.3g} finite {bool(torch.isfinite(got).all())} repeat identical "
                f"{torch.equal(fb.fused_cross_ff(h, bundle, H), got)}")
        if S >= 4096 and not quick:
            line += (f" {time_ms(lambda: fb.fused_cross_ff(h, bundle, H), 20):.4f} ms, device "
                     f"{device_ms(lambda: fb.fused_cross_ff(h, bundle, H), 20)} ms")
            line += f" host {host_us(lambda: fb.fused_cross_ff(h, bundle, H)):.1f} us"
        log(line + ("" if err <= FUSED_ATOL else " FAIL"))
        if S >= 4096 and not quick:
            log(f"  plain version: {time_ms(lambda: fb.reference_cross_ff(h, bundle, H), 5):.4f} ms")


def child_dual_cross(quick: bool):
    import torch

    from photoverse_tpu_torch.ops import bounds
    from photoverse_tpu_torch.ops import dual_cross_attn as dca

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # SDXL's two levels at UNet batch 8, SD-1.5's 32^2, 16^2 and 8^2 levels at
    # batch 16, its 64^2 level at the recipe's batch 8; 77 text rows and the
    # serving path's one identity row; then ragged contexts and rows
    main = [(8, 4096, 10, 64, 77, 1), (8, 1024, 20, 64, 77, 1), (16, 1024, 8, 80, 77, 1),
            (16, 256, 8, 160, 77, 1), (16, 64, 8, 160, 77, 1), (8, 4096, 8, 40, 77, 1)]
    small = [(2, 300, 3, 64, 33, 5), (1, 100, 2, 160, 80, 8), (2, 17, 4, 40, 1, 1)]
    for B, S, H, d, St, K in main + small:
        ts = tuple(torch.randn(B, n, H, d, generator=gen, device=dev).bfloat16() for n in (S, St, St, K, K))
        f32 = tuple(t.float() for t in ts)
        want = dca.dual_cross_attention_plain(*f32)
        got = dca.dual_cross_attention(*ts)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        route_err = (dca.dual_cross_attention_plain(*ts).float() - want).abs().max().item()
        tol = DUAL_RTOL * sum(t.abs().max().item() for t in (f32[2], f32[4], want))
        bound = bounds.bound_ms(*bounds.flash_fwd(B, S, St + K, H, d))
        line = (f"dual_cross {(B, S, H, d, St, K)}: bound {bound:.4f} ms (by "
                f"{bounds.bound_by(*bounds.flash_fwd(B, S, St + K, H, d))}); err {err:.4g} (tol {tol:.4g}), einsum "
                f"route's {route_err:.4g}; repeat identical {torch.equal(dca.dual_cross_attention(*ts), got)}")
        log(line + ("" if err <= tol else " FAIL"))
        if (B, S, H, d, St, K) in main and not quick:
            for label, fn in (("kernel", lambda: dca.dual_cross_attention(*ts)),
                              ("einsum route", lambda: dca.dual_cross_attention_plain(*ts))):
                dms = cs._device_ms(fn, 20)
                share = "" if dms is None else f", {100 * bound / dms:.1f}% of the bound"
                log(f"  {label}: {time_ms(fn, 20):.4f} ms, device {cs._fmt_ms(dms)} ms{share}, host "
                    f"{host_us(fn, 100):.1f} us")
            log(f"  plain version in f32: {time_ms(lambda: dca.dual_cross_attention_plain(*f32), 5):.4f} ms")


def _bwd_case(gen, B, S, H, d, dev):
    import torch

    from photoverse_tpu_torch.ops import flash_sdpa as fs

    q, k, v, g = (torch.randn(B, S, H, d, generator=gen, device=dev).bfloat16() for _ in range(4))
    out, lse = fs.flash_fwd_lse_plain(q, k, v)
    return q, k, v, out, lse, g


def _library_bwd(q, k, v, g):
    """Autograd through one scaled_dot_product_attention call's output."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    gt = g.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)


BWD_MAIN = [(4, 4096, 8, 40), (4, 1024, 8, 80)]
STREAM_MAIN = (2, 4096, 4096, 1, 512)


def child_bwd(quick: bool):
    import torch

    from photoverse_tpu_torch.ops import bounds
    from photoverse_tpu_torch.ops import flash_sdpa as fs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    small = [(1, 100, 2, 40), (2, 256, 3, 80), (1, 64, 1, 40), (1, 1000, 8, 40), (4, 333, 8, 80),
             (1, 77, 8, 80)]
    for B, S, H, d in small + BWD_MAIN:
        args = _bwd_case(gen, B, S, H, d, dev)
        want = fs.flash_bwd_plain(*(a.float() for a in args))
        log(f"bwd {(B, S, H, d)}: bound {bounds.bound_ms(*bounds.flash_bwd(B, S, H, d)):.4f} ms")
        got = fs.flash_bwd(*args)
        torch.cuda.synchronize()
        ratios = [((a.float() - w).abs().max() / (FLASH_RTOL * w.abs().max())).item() for a, w in zip(got, want)]
        same = all(torch.equal(a, b) for a, b in zip(got, fs.flash_bwd(*args)))
        line = (f"  err over limit dq {ratios[0]:.3f} dk {ratios[1]:.3f} dv {ratios[2]:.3f} "
                f"repeat identical {same}")
        if (B, S, H, d) in BWD_MAIN and not quick:
            line += (f" {time_ms(lambda: fs.flash_bwd(*args), 10):.4f} ms, device "
                     f"{device_ms(lambda: fs.flash_bwd(*args), 10)} ms (with delta's torch ops), host "
                     f"{host_us(lambda: fs.flash_bwd(*args), 50):.1f} us")
            lib = _library_bwd(args[0], args[1], args[2], args[5])
            line += f"; library {time_ms(lib, 10):.4f} ms, device {device_ms(lib, 10)} ms"
            line += ("; device ms by kernel: "
                     + device_split(lambda: fs.flash_bwd(*args), 10, ("bwd_dq", "bwd_dkv")))
        log(line + ("" if max(ratios) <= 1 and same else " FAIL"))


def child_stream(quick: bool):
    import torch
    import torch.nn.functional as F

    from photoverse_tpu_torch.ops import bounds
    from photoverse_tpu_torch.ops import flash_sdpa as fs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(1, 300, 77, 1, 512), (1, 64, 64, 2, 512), (1, 1000, 4000, 1, 512), (1, 77, 77, 1, 512),
             STREAM_MAIN]
    for B, Sq, Skv, H, d in cases:
        for scale in (0.3, 1.0):
            q = (scale * torch.randn(B, Sq, H, d, generator=gen, device=dev)).bfloat16()
            k = (scale * torch.randn(B, Skv, H, d, generator=gen, device=dev)).bfloat16()
            v = (scale * torch.randn(B, Skv, H, d, generator=gen, device=dev)).bfloat16()
            want, want_lse = fs.flash_fwd_lse_plain(q.float(), k.float(), v.float())
            tol = FLASH_RTOL * want.abs().max().item()
            log(f"stream {(B, Sq, Skv, H, d)} scale {scale}: tol {tol:.4g}, bound "
                f"{bounds.bound_ms(*bounds.flash_fwd(B, Sq, Skv, H, d)):.4f} ms")
            got = fs.flash_sdpa_stream(q, k, v)
            out2, lse = fs.flash_fwd_lse(q, k, v)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            lerr = (lse - want_lse).abs().max().item()
            same = torch.equal(out2, got) and torch.equal(got, fs.flash_sdpa_stream(q, k, v))
            line = (f"  err {err:.4g} ({err / tol:.3f} of tol) lse err {lerr:.3g} ({lerr / LSE_ATOL:.3f} of "
                    f"tol) lse variant and repeat identical {same}")
            main = (B, Sq, Skv, H, d) == STREAM_MAIN
            if main and not quick:
                line += (f" {time_ms(lambda: fs.flash_sdpa_stream(q, k, v), 10):.4f} ms, device "
                         f"{device_ms(lambda: fs.flash_sdpa_stream(q, k, v), 10)} ms; with lse "
                         f"{time_ms(lambda: fs.flash_fwd_lse(q, k, v), 10):.4f} ms, device "
                         f"{device_ms(lambda: fs.flash_fwd_lse(q, k, v), 10)} ms")
                qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                lib = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
                line += f"; library {time_ms(lib, 10):.4f} ms, device {device_ms(lib, 10)} ms"
            log(line + ("" if err <= tol and lerr <= LSE_ATOL and same else " FAIL"))


def child_earlier(quick: bool):
    """The kernels of the checkout in the current directory (its own
    chip_smoke.py builds the fused tail's inputs in its own layout),
    CUDA-event, device and host time at the main-path shapes."""
    import torch

    import chip_smoke as theirs  # the other checkout's
    from photoverse_tpu_torch.ops import flash_sdpa as fs
    from photoverse_tpu_torch.ops import fused_block as fb

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    log(f"earlier tree {os.getcwd()}")
    for B, S, H, d in BWD_MAIN:
        args = _bwd_case(gen, B, S, H, d, dev)
        log(f"  flash_bwd {(B, S, H, d)}: {time_ms(lambda: fs.flash_bwd(*args), 10):.4f} ms, device "
            f"{device_ms(lambda: fs.flash_bwd(*args), 10)} ms (with delta's torch ops), host "
            f"{host_us(lambda: fs.flash_bwd(*args), 50):.1f} us")
    B, S, _, H, d = STREAM_MAIN
    q, k, v = ((0.3 * torch.randn(B, S, H, d, generator=gen, device=dev)).bfloat16() for _ in range(3))
    log(f"  flash_sdpa_stream {STREAM_MAIN}: {time_ms(lambda: fs.flash_sdpa_stream(q, k, v), 10):.4f} ms, device "
        f"{device_ms(lambda: fs.flash_sdpa_stream(q, k, v), 10)} ms; with lse "
        f"{time_ms(lambda: fs.flash_fwd_lse(q, k, v), 10):.4f} ms, device "
        f"{device_ms(lambda: fs.flash_fwd_lse(q, k, v), 10)} ms")
    for B, S, H, d in ((2, 4096, 8, 40), (2, 1024, 8, 80), (4, 4096, 8, 40), (4, 1024, 8, 80)):
        q, k, v = ((0.3 * torch.randn(B, S, H, d, generator=gen, device=dev)).bfloat16() for _ in range(3))
        log(f"  flash_sdpa {(B, S, S, H, d)}: {time_ms(lambda: fs.flash_sdpa(q, k, v), 20):.4f} ms, device "
            f"{device_ms(lambda: fs.flash_sdpa(q, k, v), 20)} ms, host "
            f"{host_us(lambda: fs.flash_sdpa(q, k, v)):.1f} us")
    for K in (1, 5):
        h, bundle = theirs._fused_inputs(gen, 2, 4096, 320, 8, 77, K, 1280, dev)
        log(f"  fused_cross_ff (2, 4096, 77, {K}): {time_ms(lambda: fb.fused_cross_ff(h, bundle, 8), 20):.4f} ms, "
            f"device {device_ms(lambda: fb.fused_cross_ff(h, bundle, 8), 20)} ms, host "
            f"{host_us(lambda: fb.fused_cross_ff(h, bundle, 8)):.1f} us")


def main():
    args = sys.argv[1:]
    quick = "--quick" in args
    if "--child" in args:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        {"flash": child_flash, "bwd": child_bwd, "stream": child_stream, "fused": child_fused,
         "dual_cross": child_dual_cross, "earlier": child_earlier}[
            args[args.index("--child") + 1]](quick)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    from photoverse_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _, out = _build.build_library()
    log(f"build {time.perf_counter() - t0:.1f}s")
    name, keep = "", False
    for line in out.splitlines():  # per kernel: template arguments, spills, registers; warnings
        if "Compiling entry" in line:
            keep = "Z" in line
            name = line[max(line.find("flash"), line.find("fused"), line.find("dual")):][:48]
        elif keep and ("registers" in line or "spill" in line):
            log(f"  {name}: {line.strip()}")
        elif "error" in line or "arning" in line:
            log(f"  {line.strip()}")
    rc = 0
    names = ("flash", "bwd", "stream", "fused", "dual_cross")
    families = [(a, None) for a in args if a in names] or [(a, None) for a in names]
    if "--earlier" in args:  # the other checkout first and last: the card's pace can move within a call
        other = ("earlier", args[args.index("--earlier") + 1])
        families = [other] + families + [other]
    for fam, cwd in families:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", fam] + (["--quick"] if quick else [])
        try:
            rc |= subprocess.run(cmd, timeout=240, cwd=cwd).returncode
        except subprocess.TimeoutExpired:
            log(f"{fam}: child timed out (a kernel hung?)")
            rc |= 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
