"""Datasets and the batch loader for training (the port's own copy of
photoverse_tpu/data/dataset.py): NHWC numpy batches with the keys
  pixel_values (B, size, size, 3) in [-1, 1] (uint8 with uint8_pixels),
  pixel_values_clip (B, clip_size, clip_size, 3) CLIP-normalized (uint8),
  text_input_ids (B, L) int32, concept_placeholder_idx (B, 1) int32,
  text (list of str).

`BatchLoader` shuffles with one seed, assembles batches on worker threads
(each with its own RandomState for the random templates), and yields them
in order through a bounded reorder buffer. With native=True the decode and
resize run in the C++ loader (data/native_loader.py). Pillow is imported
inside the functions that decode, never when this module is imported.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List

import numpy as np

from photoverse_tpu_torch.data.preprocessing import (
    apply_mask_and_crop,
    clip_preprocess,
    clip_preprocess_u8,
    preprocess_image,
    preprocess_image_u8,
)
from photoverse_tpu_torch.data.prompts import IMAGENET_TEMPLATES_SMALL, prepare_prompt
from photoverse_tpu_torch.utils import trace

__all__ = ["CustomDataset", "CustomDatasetWithMasks", "collate_fn", "BatchLoader"]


def _is_image(f: str) -> bool:
    return f.lower().endswith((".jpg", ".jpeg", ".png"))


def _numeric_sort(paths: List[str]) -> List[str]:
    """Numeric stems in numeric order, then the other stems in lexical
    order."""

    def key(x):
        stem = os.path.basename(x).split(".")[0]
        try:
            return (0, int(stem), "")
        except ValueError:
            return (1, 0, stem)

    return sorted(paths, key=key)


def _open_rgb(path: str):
    from PIL import Image

    raw = Image.open(path)
    return raw.convert("RGB") if raw.mode != "RGB" else raw


class CustomDataset:
    """One image per identity under `data_root/img_subfolder`."""

    def __init__(self, data_root: str, tokenizer, img_subfolder: str = "images", size: int = 512,
                 interpolation: str = "bicubic", placeholder_token: str = "*",
                 template: str = "a photo of {}", use_random_templates: bool = False, seed: int = 0,
                 clip_size: int = 224, uint8_pixels: bool = False):
        self.tokenizer = tokenizer
        self.size = size
        self.clip_size = clip_size
        self.interpolation = interpolation
        # uint8 crops, normalized on the device (engine.training.normalize_pixel_batch)
        self.uint8_pixels = uint8_pixels
        self.placeholder_token = placeholder_token
        self.template = template
        self.use_random_templates = use_random_templates
        self.rng = np.random.RandomState(seed)
        img_dir = os.path.join(data_root, img_subfolder)
        self.image_paths = _numeric_sort([os.path.join(img_dir, f) for f in os.listdir(img_dir) if _is_image(f)])

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, idx: int) -> Dict:
        return self.example(idx)

    def example(self, idx: int, rng: np.random.RandomState = None) -> Dict:
        """Item `idx`, its random template drawn from `rng` (a worker's own
        RandomState; self.rng when None)."""
        template = self.template
        if self.use_random_templates:
            template = (rng or self.rng).choice(IMAGENET_TEMPLATES_SMALL)
        example = prepare_prompt(self.tokenizer, template, self.placeholder_token)
        return self._prepare_image(example, idx)

    def _pixels(self, example: Dict, raw, clip_source) -> Dict:
        if self.uint8_pixels:
            example["pixel_values"] = preprocess_image_u8(raw, self.size, self.interpolation)
            example["pixel_values_clip"] = clip_preprocess_u8(clip_source, self.clip_size)
        else:
            example["pixel_values"] = preprocess_image(raw, self.size, self.interpolation)
            example["pixel_values_clip"] = clip_preprocess(clip_source, self.clip_size)
        return example

    def _prepare_image(self, example: Dict, idx: int) -> Dict:
        raw = _open_rgb(self.image_paths[idx])
        return self._pixels(example, raw, raw)


class CustomDatasetWithMasks(CustomDataset):
    """The CLIP input is the face alone: the image with its background
    zeroed by the mask, cropped around the mask (apply_mask_and_crop)."""

    def __init__(self, data_root: str, tokenizer, mask_subfolder: str = "masks", **kw):
        super().__init__(data_root, tokenizer, **kw)
        mask_dir = os.path.join(data_root, mask_subfolder)
        self.masks_paths = _numeric_sort([os.path.join(mask_dir, f) for f in os.listdir(mask_dir) if _is_image(f)])

    def _prepare_image(self, example: Dict, idx: int) -> Dict:
        from PIL import Image

        raw = _open_rgb(self.image_paths[idx])
        face_crop = apply_mask_and_crop(raw, Image.open(self.masks_paths[idx]))
        return self._pixels(example, raw, face_crop)


def _stack_pixels(arrs: List[np.ndarray]) -> np.ndarray:
    """uint8 stays uint8; anything else becomes float32."""
    out = np.stack(arrs)
    return out if out.dtype == np.uint8 else out.astype(np.float32)


def _stack_ids(rows: List, key: str) -> np.ndarray:
    return np.concatenate([np.asarray(r[key]).reshape(1, -1) for r in rows]).astype(np.int32)


def collate_fn(batch: List[Dict]) -> Dict:
    """Stack per-example dicts into a batch."""
    return {
        "pixel_values": _stack_pixels([e["pixel_values"] for e in batch]),
        "pixel_values_clip": _stack_pixels([e["pixel_values_clip"] for e in batch]),
        "text_input_ids": _stack_ids(batch, "text_input_ids"),
        "concept_placeholder_idx": _stack_ids(batch, "concept_placeholder_idx"),
        "text": [e["text"] for e in batch],
    }


class BatchLoader:
    """Shuffling, prefetching batch iterator (the last partial batch is
    dropped).

    `batch_size` is the global batch; `host_slice` (a slice of each global
    batch) and `host_id` keep the JAX package's multi-host interface: in
    one process they are None and 0 and change nothing. Every epoch draws
    its order and its workers' template seeds from the loader's RandomState
    (`seed`), so two loaders with the same seed give the same batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 2, native: bool = False,
                 host_slice: slice = None, host_id: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.host_slice = host_slice
        self.host_id = host_id
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.native = native
        self._native_loader = None
        if native:
            from photoverse_tpu_torch.data.native_loader import get_loader

            self._native_loader = get_loader(num_threads=self.num_workers)

    def _native_batch(self, idxs, rng: np.random.RandomState) -> Dict:
        ds = self.dataset
        paths = [ds.image_paths[int(i)] for i in idxs]
        if isinstance(ds, CustomDatasetWithMasks):
            masks = [ds.masks_paths[int(i)] for i in idxs]
            pv, pc = self._native_loader.load_batch_masked(paths, masks, size=ds.size, clip_size=ds.clip_size)
        else:
            pv, pc = self._native_loader.load_batch(paths, size=ds.size, clip_size=ds.clip_size)
        prompts = []
        for _ in idxs:
            template = ds.template
            if ds.use_random_templates:
                template = rng.choice(IMAGENET_TEMPLATES_SMALL)
            prompts.append(prepare_prompt(ds.tokenizer, template, ds.placeholder_token))
        return {
            "pixel_values": pv,
            "pixel_values_clip": pc,
            "text_input_ids": _stack_ids(prompts, "text_input_ids"),
            "concept_placeholder_idx": _stack_ids(prompts, "concept_placeholder_idx"),
            "text": [p["text"] for p in prompts],
        }

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[Dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        n_batches = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        # per-(host, worker) template streams from the epoch's RandomState;
        # the golden-ratio mix keeps the seeds in RandomState's 2**32 range
        worker_seeds = (
            self.rng.randint(0, 2**31 - 1, size=self.num_workers).astype(np.uint64)
            + np.uint64(self.host_id) * np.uint64(0x9E3779B1)
        ) % np.uint64(2**32)
        # workers stay within `window` batches of the consumer, so the
        # reorder buffer is bounded; every wait checks `stop`, so closing
        # the generator early releases every worker
        window = self.prefetch + self.num_workers
        cursor = {"nxt": 0}
        cv = threading.Condition()

        def put_stop_aware(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer(worker_id: int):
            wrng = np.random.RandomState(worker_seeds[worker_id])
            try:
                for b in range(worker_id, n_batches, self.num_workers):
                    with cv:
                        while b >= cursor["nxt"] + window and not stop.is_set():
                            cv.wait(timeout=0.1)
                    if stop.is_set():
                        return
                    idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                    if self.host_slice is not None:
                        idxs = idxs[self.host_slice]
                    if self._native_loader is not None:
                        batch = self._native_batch(idxs, wrng)
                    else:
                        batch = collate_fn([self.dataset.example(int(i), wrng) for i in idxs])
                    if not put_stop_aware((b, batch)):
                        return
            except BaseException as e:  # raised in the consumer, never lost
                put_stop_aware((-1, e))

        threads = [threading.Thread(target=producer, args=(w,), daemon=True) for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            pending: Dict[int, Dict] = {}
            nxt = 0
            received = 0
            while received < n_batches:
                with trace.span("loader_wait", epoch_start=received == 0):
                    b, batch = q.get()
                if b < 0:
                    raise batch
                pending[b] = batch
                received += 1
                while nxt in pending:
                    yield pending.pop(nxt)
                    nxt += 1
                    with cv:
                        cursor["nxt"] = nxt
                        cv.notify_all()
        finally:
            stop.set()
            with cv:
                cv.notify_all()
