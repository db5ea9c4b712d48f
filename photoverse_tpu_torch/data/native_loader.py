"""ctypes binding of the C++ batch loader (native/dataloader.cc), built with
g++ on first use and linked against libjpeg and libpng
(data/_native_build.py). The port's own copy of
photoverse_tpu/data/native_loader.py:
  load_batch(paths, size, clip_size) -> (pixel_values, pixel_values_clip)
  load_batch_masked(paths, mask_paths, size, clip_size)
  preprocess_rgb(array, size, mode)
float32 NHWC outputs ([-1, 1] and CLIP-normalized). A machine that cannot
build it raises NativeLoaderUnavailable; the caller decides, nothing falls
back here.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Tuple

import numpy as np

from photoverse_tpu_torch.data._native_build import NativeBuildError, build_native_lib

__all__ = ["NativeLoaderUnavailable", "get_loader", "NativeLoader"]

_lock = threading.Lock()
_cached = None
_F32P = ctypes.POINTER(ctypes.c_float)


class NativeLoaderUnavailable(RuntimeError):
    pass


def _build() -> str:
    try:
        # -ffast-math: the resize convolutions have no NaN / inf semantics;
        # compiled with it, not linked with it (the process keeps IEEE
        # subnormals)
        return build_native_lib("dataloader.cc", "libpvdataloader.so", extra_flags=["-ljpeg", "-lpng"],
                                compile_flags=["-ffast-math"])
    except NativeBuildError as e:
        raise NativeLoaderUnavailable(str(e)) from e


def _paths(paths: List[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


class NativeLoader:
    def __init__(self, num_threads: int = 0):
        lib = ctypes.CDLL(_build())
        lib.pv_load_batch.restype = ctypes.c_int
        lib.pv_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, _F32P, _F32P]
        lib.pv_load_batch_masked.restype = ctypes.c_int
        lib.pv_load_batch_masked.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
                                             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                             _F32P, _F32P]
        lib.pv_preprocess_rgb.restype = None
        lib.pv_preprocess_rgb.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int, _F32P]
        self._lib = lib
        self.requested_threads = num_threads
        self.num_threads = num_threads or (os.cpu_count() or 4)

    def _outputs(self, n: int, size: int, clip_size: int):
        return np.empty((n, size, size, 3), np.float32), np.empty((n, clip_size, clip_size, 3), np.float32)

    def load_batch(self, paths: List[str], size: int = 512, clip_size: int = 224) -> Tuple[np.ndarray, np.ndarray]:
        n = len(paths)
        pv, pc = self._outputs(n, size, clip_size)
        ok = self._lib.pv_load_batch(_paths(paths), n, size, clip_size, min(self.num_threads, n),
                                     pv.ctypes.data_as(_F32P), pc.ctypes.data_as(_F32P))
        if ok != n:
            raise IOError(f"native loader decoded {ok}/{n} images")
        return pv, pc

    def load_batch_masked(self, paths: List[str], mask_paths: List[str], size: int = 512,
                          clip_size: int = 224) -> Tuple[np.ndarray, np.ndarray]:
        """pixel_values from the image, pixel_values_clip from its
        background-zeroed face crop (CustomDatasetWithMasks)."""
        n = len(paths)
        if len(mask_paths) != n:
            raise ValueError(f"{n} images but {len(mask_paths)} masks")
        pv, pc = self._outputs(n, size, clip_size)
        ok = self._lib.pv_load_batch_masked(_paths(paths), _paths(mask_paths), n, size, clip_size,
                                            min(self.num_threads, n),
                                            pv.ctypes.data_as(_F32P), pc.ctypes.data_as(_F32P))
        if ok != n:
            raise IOError(f"native loader decoded {ok}/{n} image/mask pairs")
        return pv, pc

    def preprocess_rgb(self, image: np.ndarray, size: int, mode: str = "vae") -> np.ndarray:
        """(H, W, 3) uint8 -> (size, size, 3) float32; mode "vae" ([-1, 1])
        or "clip" (CLIP mean / std)."""
        img = np.ascontiguousarray(image, np.uint8)
        h, w = img.shape[:2]
        out = np.empty((size, size, 3), np.float32)
        self._lib.pv_preprocess_rgb(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, size,
                                    0 if mode == "vae" else 1, out.ctypes.data_as(_F32P))
        return out


def get_loader(num_threads: int = 0) -> NativeLoader:
    """One loader per thread count, built once."""
    global _cached
    with _lock:
        if _cached is None or _cached.requested_threads != num_threads:
            _cached = NativeLoader(num_threads)
        return _cached
