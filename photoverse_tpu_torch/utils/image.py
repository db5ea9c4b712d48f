"""Image utilities on NHWC numpy arrays: denormalization, uint8 packing,
PIL conversion and captioned sample grids (the port's own copy of
photoverse_tpu/utils/image.py). Pillow is imported inside the functions
that need it.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from photoverse_tpu_torch.data.preprocessing import CLIP_MEAN, CLIP_STD

__all__ = ["denormalize", "denormalize_clip", "to_uint8", "to_pil", "save_images_grid",
           "rebuild_gallery_grid", "GALLERY_PROMPTS"]


def denormalize(img: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 1]."""
    return np.clip(np.asarray(img) / 2.0 + 0.5, 0.0, 1.0)


def denormalize_clip(img: np.ndarray) -> np.ndarray:
    """CLIP-normalized -> [0, 1]."""
    return np.clip(np.asarray(img) * CLIP_STD + CLIP_MEAN, 0.0, 1.0)


def to_uint8(img: np.ndarray) -> np.ndarray:
    """(..., 3) float in [0, 1] -> uint8, round(x * 255)."""
    return (np.asarray(img) * 255.0).round().astype(np.uint8)


def to_pil(img: np.ndarray):
    """(H, W, 3) float in [0, 1] -> PIL image."""
    from PIL import Image

    return Image.fromarray(to_uint8(img))


def save_images_grid(grid_data: Sequence[Tuple[str, List]], output_path: str, header_height: int = 50) -> None:
    """Rows of PIL images, each under a caption strip; a caption with "{}"
    shows it as "S*"."""
    from PIL import Image, ImageDraw

    rows = []
    max_w = 0
    for caption, images in grid_data:
        if not images:
            continue
        h = max(im.height for im in images)
        w = sum(im.width for im in images)
        row = Image.new("RGB", (w, h + header_height), "white")
        text = caption.format("S*") if "{}" in caption else caption
        ImageDraw.Draw(row).text((10, header_height // 3), text, fill="black")
        x = 0
        for im in images:
            row.paste(im, (x, header_height))
            x += im.width
        rows.append(row)
        max_w = max(max_w, w)
    if not rows:
        return
    grid = Image.new("RGB", (max_w, sum(r.height for r in rows)), "white")
    y = 0
    for r in rows:
        grid.paste(r, (0, y))
        y += r.height
    grid.save(output_path)


# the README gallery: {base_dir}/{i}/{file_stem}{i}.png for i in
# 1..num_columns, one row per (caption, file stem)
GALLERY_PROMPTS = [
    ("Input Image", "input_image"),
    ("A photo of S*", "photo"),
    ("S* in Ghibli anime style", "ghibli"),
    ("S* wears a red hat", "red_hat"),
    ("S* on the beach", "beach"),
    ("Manga drawing of S*", "manga"),
    ("S* as a Funko Pop figure", "funko_pop"),
    ("S* stained glass window", "stained_glass"),
    ("Watercolor painting of S*", "watercolor"),
]


def rebuild_gallery_grid(base_dir: str, output_path: str,
                         prompts: Sequence[Tuple[str, str]] = GALLERY_PROMPTS, num_columns: int = 5) -> None:
    from PIL import Image

    grid_data = [(caption, [Image.open(os.path.join(base_dir, str(i), f"{stem}{i}.png"))
                            for i in range(1, num_columns + 1)])
                 for caption, stem in prompts]
    save_images_grid(grid_data, output_path)
