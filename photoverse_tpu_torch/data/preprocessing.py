"""Host-side image preprocessing for the VAE and CLIP inputs (the port's own
copy of the inference part of photoverse_tpu/data/preprocessing.py).

Outputs are NHWC float32 numpy. Pillow does the decoding and resizing and is
imported inside the functions that need it, never when this module is
imported: a machine without Pillow can still import the package and serve
already-prepared arrays.
"""

from __future__ import annotations

import numpy as np

__all__ = ["CLIP_MEAN", "CLIP_STD", "preprocess_image", "clip_preprocess"]

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def _resize_shortest(img, size: int, interpolation: str):
    from PIL import Image

    interp = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR,
              "bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS}[interpolation]
    # the long edge truncates (int(size * long / short)), as torchvision's
    # Resize and transformers' image processor do; rounding would shift the
    # centre crop by a pixel on many aspect ratios
    w, h = img.size
    if w < h:
        nw, nh = size, max(int(h * size / w), size)
    else:
        nw, nh = max(int(w * size / h), size), size
    return img.resize((nw, nh), interp)


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return arr[top : top + size, left : left + size]


def preprocess_image(raw_image, size: int = 512, interpolation: str = "bicubic") -> np.ndarray:
    """PIL image -> (size, size, 3) float32 in [-1, 1] (the VAE's input)."""
    if raw_image.mode != "RGB":
        raw_image = raw_image.convert("RGB")
    img = _resize_shortest(raw_image, size, interpolation)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    arr = _center_crop(arr, size)
    return arr * 2.0 - 1.0


def clip_preprocess(image, size: int = 224) -> np.ndarray:
    """PIL image or (H, W, 3) uint8 array -> (size, size, 3) CLIP-normalized."""
    if isinstance(image, np.ndarray):
        from PIL import Image

        image = Image.fromarray(image.astype(np.uint8))
    if image.mode != "RGB":
        image = image.convert("RGB")
    img = _resize_shortest(image, size, "bicubic")
    arr = np.asarray(img, dtype=np.float32) / 255.0
    arr = _center_crop(arr, size)
    return (arr - CLIP_MEAN) / CLIP_STD
