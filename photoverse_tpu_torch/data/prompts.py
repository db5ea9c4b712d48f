"""Prompt preparation: template formatting, tokenization, placeholder index
(the port's own copy of the host code in photoverse_tpu/data/prompts.py that
the generate and serve CLIs call). Pure numpy.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["prepare_prompt", "find_placeholder_index"]


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
