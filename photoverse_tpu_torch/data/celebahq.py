"""CelebAMask-HQ preparation (the port's own copy of
photoverse_tpu/data/celebahq.py): extract the archive, fuse the per-label
mask PNGs into one indexed mask per image (skipping ear_r/neck/neck_r/cloth),
then split 90/10 into train/test trees. Every step is idempotent behind its
force flag.

The archive is not downloaded: `download_celebhq_masks` extracts a
`CelebaHQMask.zip` the user placed in `save_path` and raises when there is
none (the JAX package fetches it with gdown when that is installed). Pillow
is imported inside the functions that decode or encode images.
"""

from __future__ import annotations

import os
import shutil
import zipfile
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "NUM_OF_IMAGES_IN_CELEBAHQ",
    "MASKS_LABEL_LIST_CELEBAHQ",
    "create_celebahq_masks",
    "download_celebhq_masks",
    "split_celebhqmasks_train_test",
    "create_test_train_from_known_list",
]

NUM_OF_IMAGES_IN_CELEBAHQ = 30000
MASKS_LABEL_LIST_CELEBAHQ = [
    "skin", "nose", "eye_g", "l_eye", "r_eye", "l_brow", "r_brow", "l_ear",
    "r_ear", "mouth", "u_lip", "l_lip", "hair", "hat", "ear_r", "neck_l",
    "neck", "cloth",
]
_SKIP_LABELS = {"ear_r", "neck", "neck_r", "cloth"}


def _make_folder(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def create_celebahq_masks(
    masks_path: str,
    save_path: str,
    force_create: bool = False,
    num_of_images: int = NUM_OF_IMAGES_IN_CELEBAHQ,
) -> None:
    """Fuse per-label mask PNGs (the published layout: image k's label at
    `{k // 2000}/{k:05d}_{label}.png`) into a single 512x512 indexed mask
    per image, `{k}.png` in `save_path`: the pixel value is the label's
    index + 1, later labels overwrite earlier ones."""
    from PIL import Image

    _make_folder(save_path)
    if not force_create and len(os.listdir(save_path)) >= num_of_images:
        print("CelebaHQ masks already created, skipping creation")
        return
    for k in range(num_of_images):
        base = np.zeros((512, 512), dtype=np.uint8)
        for idx, label in enumerate(MASKS_LABEL_LIST_CELEBAHQ):
            if label in _SKIP_LABELS:
                continue
            fname = os.path.join(masks_path, str(k // 2000), f"{k:05d}_{label}.png")
            if os.path.exists(fname):
                with Image.open(fname) as im:
                    base[np.asarray(im.convert("L")) != 0] = idx + 1
        Image.fromarray(base).save(os.path.join(save_path, f"{k}.png"))
        if (k + 1) % 1000 == 0:
            print(f"fused {k + 1}/{num_of_images} masks")


def download_celebhq_masks(
    gdrive_file_id: str,
    save_path: str,
    force_download: bool = False,
    force_extract: bool = False,
) -> Optional[str]:
    """Extract `save_path/CelebaHQMask.zip` and return the archive's one
    top-level folder (None when it has several). Nothing is fetched: a
    missing zip raises the JAX package's RuntimeError (its text when gdown
    is not installed), and so does `force_download`; the error's cause
    names the published file by `gdrive_file_id`."""
    _make_folder(save_path)
    zip_file = os.path.join(save_path, "CelebaHQMask.zip")
    if not os.path.exists(zip_file) or force_download:
        raise RuntimeError(
            f"gdown unavailable and {zip_file} missing — place the "
            "CelebAMask-HQ zip there manually"
        ) from FileNotFoundError(f"{zip_file}: the CelebAMask-HQ archive, Google Drive file id {gdrive_file_id}")
    print("CelebaHQ masks already downloaded, skipping download")

    with zipfile.ZipFile(zip_file, "r") as zf:
        folders = {n.split("/")[0] for n in zf.namelist() if "/" in n}
        src = folders.pop() if len(folders) == 1 else None
        if src and os.path.exists(os.path.join(save_path, src)) and not force_extract:
            print("CelebaHQ masks already extracted, skipping extraction")
            return os.path.join(save_path, src)
        zf.extractall(save_path)
    return os.path.join(save_path, src) if src else None


def _split_folders(dest: str) -> None:
    for part in ("train", "test"):
        for sub in ("images", "masks"):
            _make_folder(os.path.join(dest, part, sub))


def split_celebhqmasks_train_test(
    src_img_folder: str,
    src_masks_folder: str,
    dest_folder: str,
    train_ratio: float = 0.9,
    force_split: bool = False,
    seed: Optional[int] = None,
) -> Tuple[str, str]:
    """Copy (image, mask) pairs, in numeric order and shuffled by
    RandomState(seed), into {dest}/train|test/{images,masks}: the first
    int(train_ratio * n) pairs train, the rest test."""
    _split_folders(dest_folder)
    key = lambda x: int(x.split(".")[0])  # noqa: E731
    imgs = sorted(os.listdir(src_img_folder), key=key)
    masks = sorted(os.listdir(src_masks_folder), key=key)
    n = min(len(imgs), len(masks))
    pairs = list(zip(imgs[:n], masks[:n]))
    np.random.RandomState(seed).shuffle(pairs)

    existing = len(os.listdir(os.path.join(dest_folder, "train", "images"))) + len(
        os.listdir(os.path.join(dest_folder, "test", "images"))
    )
    if existing >= len(pairs) and not force_split:
        print("CelebaHQ images already split, skipping split")
        return os.path.join(dest_folder, "train"), os.path.join(dest_folder, "test")
    shutil.rmtree(os.path.join(dest_folder, "train"))
    shutil.rmtree(os.path.join(dest_folder, "test"))
    _split_folders(dest_folder)

    n_train = int(train_ratio * len(pairs))
    for i, (img, mask) in enumerate(pairs):
        part = "train" if i < n_train else "test"
        shutil.copy(os.path.join(src_img_folder, img), os.path.join(dest_folder, part, "images", img))
        shutil.copy(os.path.join(src_masks_folder, mask), os.path.join(dest_folder, part, "masks", mask))
    return os.path.join(dest_folder, "train"), os.path.join(dest_folder, "test")


def create_test_train_from_known_list(
    train_list_file: str,
    test_list_file: str,
    src_folder: str,
    dest_folder: str,
    force_copy: bool = False,
) -> Tuple[str, str]:
    """Copy the images each list file names (one per line) into
    {dest}/train|test/images."""
    _split_folders(dest_folder)
    for list_file, part in ((train_list_file, "train"), (test_list_file, "test")):
        with open(list_file) as f:
            names: List[str] = f.read().splitlines()
        for img in names:
            dst = os.path.join(dest_folder, part, "images", img)
            if not os.path.exists(dst) or force_copy:
                shutil.copy(os.path.join(src_folder, img), dst)
    return os.path.join(dest_folder, "train"), os.path.join(dest_folder, "test")
