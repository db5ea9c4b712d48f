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


def build_native_lib(src_name: str, so_name: str, extra_flags: Sequence[str] = (),
                     compile_flags: Sequence[str] = ()) -> str:
    """Compile native/<src_name> to _build/<so_name> unless the library is
    newer than its source and was built with the same flags; returns the
    library's path. `compile_flags` reach the compiler only, never the
    link: gcc links crtfastmath.o into a library linked with -ffast-math,
    which turns on flush-to-zero and denormals-are-zero for every process
    that loads it."""
    src = os.path.join(NATIVE_DIR, src_name)
    so = os.path.join(BUILD_DIR, so_name)
    if not os.path.exists(src):
        raise NativeBuildError(f"native source {src} not found")
    base = ["g++", "-O3", "-march=native", "-funroll-loops", "-fPIC", "-std=c++17"]
    stamp = " ".join([*base, *compile_flags, "|", *extra_flags])
    if (os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src)
            and _read(so + ".flags") == stamp):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # process-unique names renamed into place: concurrent builds never
    # load a half-written library
    tmp_o, tmp_so = f"{so}.{os.getpid()}.o", f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run([*base, *compile_flags, "-c", src, "-o", tmp_o], check=True, capture_output=True, text=True)
        subprocess.run([*base, "-shared", tmp_o, "-o", tmp_so, *extra_flags, "-lpthread"], check=True,
                       capture_output=True, text=True)
        os.replace(tmp_so, so)
        with open(so + ".flags", "w") as f:
            f.write(stamp)
    except (subprocess.CalledProcessError, OSError) as e:
        if os.path.exists(tmp_so):
            os.unlink(tmp_so)
        raise NativeBuildError(f"native build of {src_name} failed: {getattr(e, 'stderr', None) or e}") from e
    finally:
        if os.path.exists(tmp_o):
            os.unlink(tmp_o)
    return so


def _read(path: str):
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None
