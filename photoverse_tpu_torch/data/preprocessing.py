"""Host-side image preprocessing for the VAE and CLIP inputs (the port's own
copy of photoverse_tpu/data/preprocessing.py): float crops, uint8 crops
whose normalization happens on the device (`--uint8_transfer`), and the
masked-face crop of CustomDatasetWithMasks.

Outputs are NHWC numpy. Pillow does the decoding and resizing and is
imported inside the functions that need it, never when this module is
imported: a machine without Pillow can still import the package and serve
already-prepared arrays.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "CLIP_MEAN",
    "CLIP_STD",
    "preprocess_image",
    "preprocess_image_u8",
    "clip_preprocess",
    "clip_preprocess_u8",
    "crop_to_mask_and_scale",
    "apply_mask_and_crop",
]

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


def preprocess_image_u8(raw_image, size: int = 512, interpolation: str = "bicubic") -> np.ndarray:
    """PIL image -> (size, size, 3) uint8, the VAE crop before
    normalization. Exact: Pillow's RGB resize emits uint8, and
    preprocess_image normalizes that same array."""
    if raw_image.mode != "RGB":
        raw_image = raw_image.convert("RGB")
    img = _resize_shortest(raw_image, size, interpolation)
    return _center_crop(np.asarray(img, dtype=np.uint8), size)


def _rgb(image):
    if isinstance(image, np.ndarray):
        from PIL import Image

        image = Image.fromarray(image.astype(np.uint8))
    return image.convert("RGB") if image.mode != "RGB" else image


def clip_preprocess_u8(image, size: int = 224) -> np.ndarray:
    """PIL image or (H, W, 3) uint8 array -> (size, size, 3) uint8 CLIP
    crop (the mean/std normalization is left to the device)."""
    img = _resize_shortest(_rgb(image), size, "bicubic")
    return _center_crop(np.asarray(img, dtype=np.uint8), size)


def clip_preprocess(image, size: int = 224) -> np.ndarray:
    """PIL image or (H, W, 3) uint8 array -> (size, size, 3) CLIP-normalized."""
    img = _resize_shortest(_rgb(image), size, "bicubic")
    arr = np.asarray(img, dtype=np.float32) / 255.0
    arr = _center_crop(arr, size)
    return (arr - CLIP_MEAN) / CLIP_STD


def crop_to_mask_and_scale(image: np.ndarray, mask: np.ndarray, scale: float = 0.15) -> np.ndarray:
    """Crop `image` to the mask's bounding box grown by `scale` of its size
    on each side and squared (clamped to the image); an empty mask raises."""
    m = np.where(mask > 0, 255, 0).astype(np.uint8)
    rows = np.any(m, axis=1)
    cols = np.any(m, axis=0)
    if not rows.any():
        raise ValueError("crop_to_mask_and_scale: mask is empty (all zeros), no face region to "
                         "crop; check the mask files")
    ymin, ymax = np.where(rows)[0][[0, -1]]
    xmin, xmax = np.where(cols)[0][[0, -1]]
    height = ymax - ymin
    width = xmax - xmin
    ymin = max(0, int(ymin - height * scale))
    ymax = min(m.shape[0], int(ymax + height * scale))
    xmin = max(0, int(xmin - width * scale))
    xmax = min(m.shape[1], int(xmax + width * scale))
    crop_w = xmax - xmin
    crop_h = ymax - ymin
    if crop_w > crop_h:
        crop_h = crop_w
        ymax = min(m.shape[0], ymax + crop_h // 2)
        ymin = max(0, ymin - crop_h // 2)
    elif crop_h > crop_w:
        crop_w = crop_h
        xmax = min(m.shape[1], xmax + crop_w // 2)
        xmin = max(0, xmin - crop_w // 2)
    return image[ymin:ymax, xmin:xmax]


def apply_mask_and_crop(raw_image, raw_mask) -> np.ndarray:
    """The masked-face CLIP input: the image resized to the mask's size,
    its background zeroed, cropped by crop_to_mask_and_scale."""
    if raw_image.mode != "RGB":
        raw_image = raw_image.convert("RGB")
    if raw_mask.mode != "L":
        raw_mask = raw_mask.convert("L")
    reshaped = np.asarray(raw_image.resize(raw_mask.size))
    mask_np = np.asarray(raw_mask)
    clip_image = np.zeros_like(reshaped)
    sel = mask_np != 0
    clip_image[sel] = reshaped[sel]
    return crop_to_mask_and_scale(clip_image, mask_np)
