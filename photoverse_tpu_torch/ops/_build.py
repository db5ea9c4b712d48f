"""Build-on-first-use for the hand-written CUDA kernels in `csrc/`.

Each `csrc/*.cu` file compiles with its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so the build takes
seconds). The library lands in `photoverse_tpu_torch/_build/`, which git
ignores; it is rebuilt when any source is newer. A missing nvcc or a
failed compile raises `KernelBuildError`: there is no fallback.

Every C entry point returns `cudaGetLastError()` after its launch;
`check()` turns a non-zero code into an exception. The wrappers count
each launch in `utils.trace` as `launch.<kernel>`, so a run can show
which kernels it went through.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

__all__ = [
    "KernelBuildError",
    "KernelLaunchError",
    "build_library",
    "load_library",
    "check",
    "BUILD_DIR",
    "CSRC_DIR",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libphotoverse_kernels.so"
# searched after $CUDA_HOME/bin and $PATH
NVCC_FALLBACKS = ("/usr/local/cuda/bin/nvcc",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
# C signatures of the entry points in csrc/ (all return cudaError_t as int)
SIGNATURES = {
    # q, k, v, out, lse or null, B, Sq, Skv, H, D, strides (b, s, h) of q, k,
    # v, stream: head dims 40 and 80, then 512
    "pv_flash_fwd_wgmma": [P] * 5 + [I] * 5 + [L] * 9 + [P],
    "pv_flash_fwd_stream": [P] * 5 + [I] * 5 + [L] * 9 + [P],
    # q, k, v, g, lse, delta, dq, dk, dv, B, S, H, D, strides (b, s, h) of
    # q, k, v, g, stream
    "pv_flash_bwd": [P] * 9 + [I] * 4 + [L] * 12 + [P],
    # h, out, kT, vT, kI, vI, ln2g, ln2b, wq, wout, bout, ln3g, ln3b,
    # wpa, wpg, bpa, bpg, wo, bo, B, S, C, H, St, K, F, stream
    "pv_fused_cross_ff": [P] * 19 + [I] * 7 + [P],
    # x, add or null, weight, bias, out, work, N, HW, C, G, chunks, eps,
    # x_bf16, w_bf16, silu, stream
    "pv_group_norm_nhwc": [P] * 6 + [I] * 5 + [F] + [I] * 3 + [P],
    # q, k, v, k_ip, v_ip, out, B, S, H, D, St, K, strides (b, s, h) of q,
    # k, v, k_ip, v_ip, stream
    "pv_dual_cross_attn": [P] * 6 + [I] * 6 + [L] * 15 + [P],
}
# const char* pv_error_string(int code)
ERROR_STRING = "pv_error_string"


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def _find_nvcc() -> str | None:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.extend(NVCC_FALLBACKS)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def build_library(build_dir: str = BUILD_DIR) -> tuple[str, str]:
    """Compile csrc/*.cu into build_dir if stale; returns (.so path,
    compiler output). Raises KernelBuildError with nvcc's output."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    if not sources:
        raise KernelBuildError(f"no CUDA sources under {CSRC_DIR}")
    so = os.path.join(build_dir, LIB_NAME)
    newest = max(os.path.getmtime(p) for p in sources + headers)
    if os.path.exists(so) and os.path.getmtime(so) >= newest:
        return so, ""
    nvcc = _find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
            f"{', '.join(NVCC_FALLBACKS)}); the CUDA kernels need the CUDA "
            "toolkit to build"
        )
    os.makedirs(build_dir, exist_ok=True)
    # unique names + rename: concurrent builders never load a partial file
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(build_dir, os.path.basename(src) + f".{tag}.o") for src in sources]
    tmp = f"{so}.{tag}"
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src] for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    try:
        for c, p, log in zip(cmds, procs, logs):
            if p.returncode != 0:
                raise KernelBuildError(f"nvcc failed ({' '.join(c)}):\n{log}")
        link = [nvcc, "-shared", "-o", tmp, *objs]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise KernelBuildError(f"nvcc failed ({' '.join(link)}):\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
    finally:
        for f in objs + [tmp]:
            if os.path.exists(f):
                os.unlink(f)
    return so, "".join(logs)


_lib = None
_lib_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with argtypes set."""
    global _lib
    with _lib_lock:
        if _lib is None:
            so, _ = build_library()
            lib = ctypes.CDLL(so)
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            getattr(lib, ERROR_STRING).argtypes = [I]
            getattr(lib, ERROR_STRING).restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = getattr(load_library(), ERROR_STRING)(code).decode()
        raise KernelLaunchError(f"{name}: CUDA error {code} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
