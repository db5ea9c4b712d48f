"""Build-on-first-use of the repository's native C++ sources (`native/`)
with g++, into the port's own `photoverse_tpu_torch/_build/` (git-ignored),
never into `native/build/`. A failed build raises NativeBuildError with the
compiler's output; nothing falls back."""

from __future__ import annotations

import os
import subprocess
from typing import Sequence

__all__ = ["NativeBuildError", "build_native_lib", "NATIVE_DIR", "BUILD_DIR"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build")


class NativeBuildError(RuntimeError):
    pass


def build_native_lib(src_name: str, so_name: str, extra_flags: Sequence[str] = ()) -> str:
    """Compile native/<src_name> to _build/<so_name> unless the library is
    newer than its source; returns the library's path."""
    src = os.path.join(NATIVE_DIR, src_name)
    so = os.path.join(BUILD_DIR, so_name)
    if not os.path.exists(src):
        raise NativeBuildError(f"native source {src} not found")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a process-unique name renamed into place: concurrent builds never
    # load a half-written library
    tmp_so = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC", "-std=c++17",
           src, "-o", tmp_so, *extra_flags, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp_so, so)
    except (subprocess.CalledProcessError, OSError) as e:
        if os.path.exists(tmp_so):
            os.unlink(tmp_so)
        raise NativeBuildError(f"native build of {src_name} failed: {getattr(e, 'stderr', None) or e}") from e
    return so
