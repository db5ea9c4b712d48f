"""Plain reference of the training feed (numpy and Pillow only; nothing of
the program under test): what each row of a host batch has to hold, built
again from the files the benchmark wrote.

A row of `pixel_values` is identified by its uint8 crop: the photo's
decode, the shortest side bicubic-resized to the training size (the long
side truncated) and the centre crop. That photo's row must then hold
  - `pixel_values_clip`: the photo resized to its mask's size, the
    background zeroed where the mask is 0, cropped to the mask's bounding
    box grown by 15% of its size on each side and squared (clamped to the
    image), then the CLIP crop (shortest side bicubic to 224, centre crop);
  - `text_input_ids`: BOS, one of the textual-inversion templates with the
    placeholder `*`, EOS, EOS padding, a symbol the vocabulary lacks read
    as EOS; `concept_placeholder_idx` 1 + the index of `*` among the
    prompt's space-separated words (PhotoVerse's rule: the token position
    of `*` wherever each word is one token).
Face rows repeat distinct rows of their batch, with the prompt
"a photo of *" and the empty negative prompt.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Dict, List, Optional

import numpy as np

__all__ = ["TEMPLATES", "Feed"]

# the textual-inversion templates (imagenet_templates_small) that
# PhotoVerse's training draws its prompts from
TEMPLATES = [
    "a photo of a {}", "a rendering of a {}", "a cropped photo of the {}", "the photo of a {}",
    "a photo of a clean {}", "a photo of a dirty {}", "a dark photo of the {}", "a photo of my {}",
    "a photo of the cool {}", "a close-up photo of a {}", "a bright photo of the {}", "a cropped photo of a {}",
    "a photo of the {}", "a good photo of the {}", "a photo of one {}", "a close-up photo of the {}",
    "a rendition of the {}", "a photo of the clean {}", "a rendition of a {}", "a photo of a nice {}",
    "a good photo of a {}", "a photo of the nice {}", "a photo of the small {}", "a photo of the weird {}",
    "a photo of the large {}", "a photo of a cool {}", "a photo of a small {}",
]
UNK = "<unk>"
GROW = 0.15


def _key(arr: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _shortest_side_crop(img, size: int) -> np.ndarray:
    from PIL import Image

    w, h = img.size
    nw, nh = (size, max(int(h * size / w), size)) if w < h else (max(int(w * size / h), size), size)
    arr = np.asarray(img.resize((nw, nh), Image.BICUBIC), np.uint8)
    top, left = (arr.shape[0] - size) // 2, (arr.shape[1] - size) // 2
    return np.ascontiguousarray(arr[top:top + size, left:left + size])


def masked_crop(photo, mask) -> np.ndarray:
    """The photo at the mask's size, zeroed outside the mask, cropped to the
    mask's box grown by GROW on each side and squared."""
    img = np.asarray(photo.resize(mask.size))
    m = np.asarray(mask) != 0
    out = np.where(m[..., None], img, 0).astype(img.dtype)
    ys, xs = np.nonzero(m)
    y0, y1, x0, x1 = ys.min(), ys.max(), xs.min(), xs.max()
    h, w = y1 - y0, x1 - x0
    y0, y1 = max(0, int(y0 - h * GROW)), min(m.shape[0], int(y1 + h * GROW))
    x0, x1 = max(0, int(x0 - w * GROW)), min(m.shape[1], int(x1 + w * GROW))
    cw, ch = x1 - x0, y1 - y0
    if cw > ch:
        y1, y0 = min(m.shape[0], y1 + cw // 2), max(0, y0 - cw // 2)
    elif ch > cw:
        x1, x0 = min(m.shape[1], x1 + ch // 2), max(0, x0 - ch // 2)
    return out[y0:y1, x0:x1]


def _words(text: str) -> List[str]:
    """The prompt's words as the synthetic vocabulary spells them: letters
    and `*` are words, any other symbol is unknown."""
    return [w if re.fullmatch(r"[a-z]+|\*", w) else UNK for w in re.findall(r"[a-z]+|[^\sa-z]", text.lower())]


def _prompts(templates: List[str]) -> Dict[tuple, int]:
    """{the prompt's words: its placeholder index} of each template."""
    return {tuple(_words(t.format("*"))): 1 + t.format("*").split(" ").index("*") for t in templates}


class Feed:
    """The reference's own build of every photo of the written set, and the
    judge of host batches against it."""

    def __init__(self, root: str, size: int, clip_size: int):
        from PIL import Image

        with open(os.path.join(root, "tokenizer", "vocab.json")) as f:
            vocab = json.load(f)
        self.decoder = {v: k for k, v in vocab.items()}
        self.bos, self.eos = vocab["<|startoftext|>"], vocab["<|endoftext|>"]
        self.rows: Dict[str, tuple] = {}
        for name in os.listdir(os.path.join(root, "images")):
            photo = Image.open(os.path.join(root, "images", name)).convert("RGB")
            mask = Image.open(os.path.join(root, "masks", os.path.splitext(name)[0] + ".png")).convert("L")
            clip = _shortest_side_crop(Image.fromarray(masked_crop(photo, mask)), clip_size)
            self.rows[_key(_shortest_side_crop(photo, size))] = (name, clip)
        self.prompts = _prompts(TEMPLATES)

    def _prompt(self, ids, pidx, allowed: Dict[tuple, int]) -> bool:
        """The ids read one of the `allowed` prompts {words: placeholder
        index}, and `pidx` (None: not checked) is its placeholder index."""
        ids = [int(i) for i in ids]
        if ids[0] != self.bos:
            return False
        end = max(i for i, t in enumerate(ids) if t != self.eos)
        if end + 1 >= len(ids):  # no EOS after the prompt
            return False
        words, word = [], ""
        for t in ids[1:end + 1]:
            if t == self.eos:
                words.append(UNK)
                continue
            tok = self.decoder[t]
            if tok.endswith("</w>"):
                words.append(word + tok[:-4])
                word = ""
            else:
                word += tok
        words = tuple(words)
        if word or words not in allowed:
            return False
        return pidx is None or int(pidx) == allowed[words]

    def row_ok(self, batch: Dict, i: int) -> Optional[str]:
        """The photo's name when row i of `batch` is the reference's build of
        it, else None."""
        hit = self.rows.get(_key(batch["pixel_values"][i]))
        if hit is None or not np.array_equal(batch["pixel_values_clip"][i], hit[1]):
            return None
        ok = self._prompt(batch["text_input_ids"][i], np.asarray(batch["concept_placeholder_idx"]).reshape(-1)[i],
                          self.prompts)
        return hit[0] if ok else None

    def rows_matched(self, batches: List[Dict]) -> float:
        """Share of the batches' rows (face rows included) that hold what the
        reference builds, in batches whose rows are all different photos."""
        hit = total = 0
        face_prompt = _prompts(["a photo of {}"])
        for b in batches:
            names = [self.row_ok(b, i) for i in range(len(b["pixel_values"]))]
            distinct = len(set(names)) == len(names)
            total += len(names)
            hit += sum(n is not None for n in names) if distinct else 0
            if "face_pixel_values" not in b:
                continue
            keys = [_key(r) for r in b["pixel_values"]]
            picked = []
            for j, row in enumerate(b["face_pixel_values"]):
                total += 1
                src = keys.index(_key(row)) if _key(row) in keys else None
                ok = (src is not None and src not in picked
                      and np.array_equal(b["face_pixel_values_clip"][j], b["pixel_values_clip"][src])
                      and self._prompt(b["face_text_input_ids"][j], b["face_concept_placeholder_idx"][j],
                                       face_prompt)
                      and self._prompt(b["face_uncond_input_ids"][j], None, {(): 0}))
                picked.append(src)
                hit += bool(ok and distinct)
        return hit / total if total else 0.0
