"""ctypes binding of the C++ CLIP BPE tokenizer (native/tokenizer.cc), built
with g++ on first use into the port's `_build/` (data/_native_build.py).
The port's own copy of photoverse_tpu/data/native_tokenizer.py.

The encode contract of data/tokenizer.py's CLIPTokenizer: __call__ ->
(B, max_len) int32, BOS + ids + EOS, EOS padding. ASCII text (including
'&' and text that looks like an HTML entity: neither path unescapes) runs
in C++; a non-ASCII text goes through the Python tokenizer, one text at a
time, because the C++ scanner only approximates Unicode lowercasing and
letter classes, and that is what keeps the ids exact.

Unlike the JAX package's server, nothing falls back: a machine that cannot
build the library raises NativeBuildError.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Sequence, Union

import numpy as np

from photoverse_tpu_torch.data._native_build import build_native_lib
from photoverse_tpu_torch.data.tokenizer import CLIPTokenizer

__all__ = ["NativeCLIPTokenizer"]

_lock = threading.Lock()
_lib = None


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_native_lib("tokenizer.cc", "libpvtokenizer.so"))
            lib.pvtok_create.restype = ctypes.c_void_p
            lib.pvtok_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            lib.pvtok_destroy.restype = None
            lib.pvtok_destroy.argtypes = [ctypes.c_void_p]
            lib.pvtok_encode_batch.restype = None
            lib.pvtok_encode_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ]
            _lib = lib
    return _lib


class NativeCLIPTokenizer:
    """CLIPTokenizer with the encode path in C++. It holds the Python
    tokenizer too, for decode, non-ASCII text and truncation=False, so
    `model_max_length` and the special ids are the same."""

    def __init__(self, vocab_path: str, merges_path: str, py_tok: CLIPTokenizer):
        self._lib = _get_lib()
        self._handle = self._lib.pvtok_create(vocab_path.encode(), merges_path.encode())
        if not self._handle:
            raise ValueError(f"the native tokenizer could not read {vocab_path!r} / {merges_path!r}")
        self._py = py_tok
        self.model_max_length = py_tok.model_max_length
        self.bos_token_id = py_tok.bos_token_id
        self.eos_token_id = py_tok.eos_token_id
        self.pad_token_id = py_tok.pad_token_id

    @classmethod
    def from_pretrained(cls, path: str, subfolder: str = "tokenizer") -> "NativeCLIPTokenizer":
        d = os.path.join(path, subfolder)
        if not os.path.isdir(d):
            d = path
        merges = os.path.join(d, "merges.txt")
        if not os.path.exists(merges):
            raise ValueError(f"the native tokenizer needs an uncompressed merges.txt in {d}")
        return cls(os.path.join(d, "vocab.json"), merges, CLIPTokenizer.from_pretrained(path, subfolder))

    def __call__(self, text: Union[str, Sequence[str]], padding: str = "max_length", truncation: bool = True,
                 max_length: int = None, **_: object) -> np.ndarray:
        if isinstance(text, str):
            text = [text]
        L = max_length or self.model_max_length
        if not truncation:
            # the C++ encoder always truncates; the Python tokenizer raises
            # on an over-long text, and its ids are the answer either way
            return self._py(text, truncation=False, max_length=L)
        out = np.empty((len(text), L), np.int32)
        native_idx = [i for i, t in enumerate(text) if t.isascii()]
        if native_idx:
            arr = (ctypes.c_char_p * len(native_idx))(*[text[i].encode("utf-8") for i in native_idx])
            buf = np.empty((len(native_idx), L), np.int32)
            self._lib.pvtok_encode_batch(self._handle, arr, len(native_idx),
                                         buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), L)
            out[native_idx] = buf
        for i, t in enumerate(text):
            if not t.isascii():
                out[i] = self._py([t], max_length=L)[0]
        return out

    def decode(self, ids) -> str:
        return self._py.decode(ids)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.pvtok_destroy(self._handle)
