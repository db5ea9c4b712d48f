"""Image utilities on NHWC numpy arrays: denormalization, uint8 packing and
PIL conversion (the port's own copy of what the CLIs use from
photoverse_tpu/utils/image.py). Pillow is imported inside `to_pil` only.
"""

from __future__ import annotations

import numpy as np

__all__ = ["denormalize", "to_uint8", "to_pil"]


def denormalize(img: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 1]."""
    return np.clip(np.asarray(img) / 2.0 + 0.5, 0.0, 1.0)


def to_uint8(img: np.ndarray) -> np.ndarray:
    """(..., 3) float in [0, 1] -> uint8, round(x * 255)."""
    return (np.asarray(img) * 255.0).round().astype(np.uint8)


def to_pil(img: np.ndarray):
    """(H, W, 3) float in [0, 1] -> PIL image."""
    from PIL import Image

    return Image.fromarray(to_uint8(img))
