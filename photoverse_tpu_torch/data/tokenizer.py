"""Self-contained CLIP BPE tokenizer (the port's own copy of
photoverse_tpu/data/tokenizer.py, which it may not import).

Loads `vocab.json` + `merges.txt` from a local Stable Diffusion checkpoint
directory and implements the byte-level BPE of OpenAI CLIP (lowercase,
whitespace collapse, GPT-2 byte encoder, word-final `</w>` marker), without
transformers at run time.

  tokenizer(text, padding="max_length", truncation=True, max_length=77)
  -> numpy int32 ids (BOS + tokens + EOS, padded with the EOS id as SD's
  tokenizer pads), plus `model_max_length`.
"""

from __future__ import annotations

import functools
import gzip
import json
import os
import re
from typing import List, Sequence, Union

import numpy as np

__all__ = ["CLIPTokenizer"]


@functools.lru_cache()
def _bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


# CLIP's regex uses unicode \p{L}/\p{N}; stdlib `re` lacks those, so match
# letters/digits via str.isalpha/isdigit-compatible classes (ASCII prompts
# tokenize identically). '_' is NOT \p{L}/\p{N},
# so it belongs to the punctuation run ([^\s\p{L}\p{N}]+) — but Python's \w
# includes it, hence the explicit |_ alternative.
_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE | re.UNICODE,
)


def _basic_clean(text: str) -> str:
    # no html.unescape: transformers' CLIPTokenizer only unescapes on its
    # ftfy branch; without ftfy it cleans whitespace and lowercases only,
    # so '&amp;' tokenizes as its literal characters
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    def __init__(
        self,
        vocab: dict,
        merges: List[str],
        model_max_length: int = 77,
        bos_token: str = "<|startoftext|>",
        eos_token: str = "<|endoftext|>",
    ):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        # only a leading version header is dropped — transformers keeps every
        # other line, including merges whose first symbol is '#'
        if merges and merges[0].startswith("#version"):
            merges = merges[1:]
        merges = [tuple(m.split()) for m in merges if m]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {bos_token: bos_token, eos_token: eos_token}
        self.model_max_length = model_max_length
        self.bos_token_id = vocab[bos_token]
        self.eos_token_id = vocab[eos_token]
        self.pad_token_id = self.eos_token_id  # SD pads with EOS

    # ------------------------------------------------------------------
    @classmethod
    def from_pretrained(cls, path: str, subfolder: str = "tokenizer") -> "CLIPTokenizer":
        d = os.path.join(path, subfolder)
        if not os.path.isdir(d):
            d = path
        with open(os.path.join(d, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges_path = os.path.join(d, "merges.txt")
        if os.path.exists(merges_path):
            with open(merges_path, encoding="utf-8") as f:
                raw = f.read()
        else:
            with gzip.open(os.path.join(d, "merges.txt.gz"), "rt", encoding="utf-8") as f:
                raw = f.read()
        # transformers: drop exactly the first line (version header) and cap
        # the merge count (tokenization_clip.py merges slice)
        merges = raw.strip().split("\n")[1 : 49152 - 256 - 2 + 1]
        max_len = 77
        cfg_path = os.path.join(d, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
            max_len = int(cfg.get("model_max_length", 77))
        return cls(vocab, merges, model_max_length=max_len)

    # ------------------------------------------------------------------
    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for tok in _PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            # unknown symbols map to the unk token (= endoftext), like
            # transformers' CLIPTokenizer
            ids.extend(
                self.encoder.get(t, self.eos_token_id)
                for t in self.bpe(tok).split(" ")
            )
        return ids

    def __call__(
        self,
        text: Union[str, Sequence[str]],
        padding: str = "max_length",
        truncation: bool = True,
        max_length: int = None,
        **_: object,
    ) -> "np.ndarray":
        """Returns (B, max_length) int32 ids: BOS + tokens + EOS, EOS-padded."""
        if isinstance(text, str):
            text = [text]
        L = max_length or self.model_max_length
        rows = []
        for t in text:
            ids = self.encode_text(t)
            if truncation:
                ids = ids[: L - 2]
            elif len(ids) > L - 2:
                # clipping here would silently drop the EOS token (CLIP
                # pooling locates it); refuse loudly like transformers warns
                raise ValueError(
                    f"input of {len(ids)} tokens exceeds max_length={L} "
                    "with truncation=False"
                )
            row = [self.bos_token_id] + ids + [self.eos_token_id]
            row = row + [self.pad_token_id] * (L - len(row))
            rows.append(row[:L])
        return np.asarray(rows, dtype=np.int32)

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.decoder[int(i)] for i in ids]
        text = "".join(toks).replace("</w>", " ")
        data = bytearray(self.byte_decoder.get(ch, ord(" ")) for ch in text)
        return data.decode("utf-8", errors="replace").strip()
