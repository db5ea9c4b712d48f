"""Prompt preparation: the training templates, template formatting,
tokenization, placeholder index and the face-loss sub-batch pick (the
port's own copy of photoverse_tpu/data/prompts.py). Pure numpy.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = [
    "IMAGENET_TEMPLATES_SMALL",
    "EVAL_PROMPTS",
    "prepare_prompt",
    "find_placeholder_index",
    "random_batch_slicing",
]

# the 27 training templates (--use_random_prompts)
IMAGENET_TEMPLATES_SMALL = [
    "a photo of a {}",
    "a rendering of a {}",
    "a cropped photo of the {}",
    "the photo of a {}",
    "a photo of a clean {}",
    "a photo of a dirty {}",
    "a dark photo of the {}",
    "a photo of my {}",
    "a photo of the cool {}",
    "a close-up photo of a {}",
    "a bright photo of the {}",
    "a cropped photo of a {}",
    "a photo of the {}",
    "a good photo of the {}",
    "a photo of one {}",
    "a close-up photo of the {}",
    "a rendition of the {}",
    "a photo of the clean {}",
    "a rendition of a {}",
    "a photo of a nice {}",
    "a good photo of a {}",
    "a photo of the nice {}",
    "a photo of the small {}",
    "a photo of the weird {}",
    "a photo of the large {}",
    "a photo of a cool {}",
    "a photo of a small {}",
]

# the 7 fixed prompts of the in-training sample grids
# (--save_samples_with_various_prompts)
EVAL_PROMPTS = [
    "{} in Ghibli anime style",
    "{} in Disney & Pixar style",
    "{} wears a red hat",
    "{} on the beach",
    "Manga drawing of {}",
    "{} Funko Pop",
    "{} latte art",
]


def find_placeholder_index(text: str, placeholder_token: str = "*") -> int:
    """Word index of the placeholder + 1 (the BOS offset); 0 if absent."""
    for idx, word in enumerate(text.strip().split(" ")):
        if word == placeholder_token:
            return idx + 1
    return 0


def prepare_prompt(
    tokenizer,
    template: str = "a photo of a {}",
    placeholder_token: str = "*",
    negative_prompt: Optional[str] = None,
    num_of_samples: Optional[int] = None,
) -> Dict:
    """Tokenized prompt batch: keys text / text_input_ids (n, L) /
    concept_placeholder_idx (n, 1) / negative_text_input_ids (n, L) or None,
    n = num_of_samples or 1."""
    text = template.format(placeholder_token)
    kw = dict(padding="max_length", truncation=True, max_length=tokenizer.model_max_length)
    input_ids = np.asarray(tokenizer(text, **kw), dtype=np.int32)
    negative_input_ids = None
    if negative_prompt:
        negative_input_ids = np.asarray(tokenizer(negative_prompt, **kw), dtype=np.int32)
    idx = np.asarray([[find_placeholder_index(text, placeholder_token)]], dtype=np.int32)
    out_text = text
    if num_of_samples:
        out_text = [text] * num_of_samples
        input_ids = np.repeat(input_ids, num_of_samples, axis=0)
        idx = np.repeat(idx, num_of_samples, axis=0)
        if negative_input_ids is not None:
            negative_input_ids = np.repeat(negative_input_ids, num_of_samples, axis=0)
    return {
        "text": out_text,
        "text_input_ids": input_ids,
        "concept_placeholder_idx": idx,
        "negative_text_input_ids": negative_input_ids,
    }


def random_batch_slicing(example: Dict, batch_size: int, num_of_samples: int,
                         rng: np.random.RandomState) -> Dict:
    """The face-loss sub-batch: `num_of_samples` rows picked by
    rng.permutation(batch_size); arrays and lists are sliced, other values
    kept."""
    if batch_size < num_of_samples:
        raise ValueError(f"a batch of {batch_size} has no {num_of_samples} rows to pick")
    indices = rng.permutation(batch_size)[:num_of_samples]
    out = {}
    for key, value in example.items():
        if isinstance(value, np.ndarray) or hasattr(value, "shape"):
            out[key] = value[indices]
        elif isinstance(value, list):
            out[key] = [value[i] for i in indices]
        else:
            out[key] = value
    return out
