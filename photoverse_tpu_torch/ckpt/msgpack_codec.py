"""MessagePack reader and writer for the native `.msgpack` checkpoint, in
plain Python and numpy (no msgpack or flax package needed).

It covers the subset that flax's `serialization.msgpack_serialize` emits
for a checkpoint payload: maps with str keys, ints, floats, bools, None,
str, bytes, lists, and numpy arrays as flax's ext type 1 (an inner
MessagePack array `(shape, dtype name, C-order buffer)`; ext type 3 is the
same for a numpy scalar). Arrays above 2**30 bytes are split into
flax's chunked-array map, as flax does. Anything else (another ext type,
a non-str map key, bfloat16 or object dtypes) is refused with an error.
The writer picks the smallest encoding for every value, as msgpack-python
does with `use_bin_type=True`, and writes map keys in sorted order, as
flax's tree copy leaves them, so its bytes equal flax's for the same tree.
`dump` streams them to a file, each array's buffer straight from its
memory (a checkpoint at SD-1.5 width is over a GiB).
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Callable, List

import numpy as np

__all__ = ["packb", "dump", "unpackb", "MsgpackError"]

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_BYTES = 2**30
_CHUNKED = "__msgpack_chunked_array__"
Write = Callable[[Any], Any]  # takes bytes or a buffer


class MsgpackError(ValueError):
    pass


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _int(write: Write, n: int) -> None:
    if 0 <= n < 128:
        write(struct.pack("B", n))
    elif -32 <= n < 0:
        write(struct.pack("b", n))
    elif 0 <= n < 2**8:
        write(b"\xcc" + struct.pack("B", n))
    elif 0 <= n < 2**16:
        write(b"\xcd" + struct.pack(">H", n))
    elif 0 <= n < 2**32:
        write(b"\xce" + struct.pack(">I", n))
    elif 0 <= n < 2**64:
        write(b"\xcf" + struct.pack(">Q", n))
    elif -(2**7) <= n:
        write(b"\xd0" + struct.pack(">b", n))
    elif -(2**15) <= n:
        write(b"\xd1" + struct.pack(">h", n))
    elif -(2**31) <= n:
        write(b"\xd2" + struct.pack(">i", n))
    elif -(2**63) <= n:
        write(b"\xd3" + struct.pack(">q", n))
    else:
        raise MsgpackError(f"integer {n} does not fit in 64 bits")


def _header(write: Write, n: int, fix: int, fix_limit: int, codes) -> None:
    """A length header: the fix form below fix_limit, else 8/16/32-bit."""
    if n < fix_limit:
        write(struct.pack("B", fix | n))
    elif codes[0] is not None and n < 2**8:
        write(struct.pack(">BB", codes[0], n))
    elif n < 2**16:
        write(struct.pack(">BH", codes[1], n))
    elif n < 2**32:
        write(struct.pack(">BI", codes[2], n))
    else:
        raise MsgpackError(f"length {n} is too large for MessagePack")


def _str(write: Write, s: str) -> None:
    b = s.encode("utf-8")
    _header(write, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
    write(b)


def _bin_header(write: Write, n: int) -> None:
    if n < 2**8:
        write(struct.pack(">BB", 0xC4, n))
    elif n < 2**16:
        write(struct.pack(">BH", 0xC5, n))
    elif n < 2**32:
        write(struct.pack(">BI", 0xC6, n))
    else:
        raise MsgpackError(f"bytes of length {n} are too large for MessagePack")


def _ext_header(write: Write, code: int, n: int) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        write(struct.pack(">Bb", fixed[n], code))
    elif n < 2**8:
        write(struct.pack(">BBb", 0xC7, n, code))
    elif n < 2**16:
        write(struct.pack(">BHb", 0xC8, n, code))
    elif n < 2**32:
        write(struct.pack(">BIb", 0xC9, n, code))
    else:
        raise MsgpackError(f"ext payload of {n} bytes is too large for MessagePack")


def _array(write: Write, a: np.ndarray, code: int) -> None:
    """Ext `code` around the inner array (shape, dtype name, C-order
    buffer); the buffer goes to `write` as a view, not a copy."""
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise MsgpackError(f"arrays of dtype {a.dtype} cannot be written")
    if not a.flags.c_contiguous:  # (np.ascontiguousarray would make a 0-d array 1-d)
        a = np.ascontiguousarray(a)
    head: List[bytes] = []
    _header(head.append, 3, 0x90, 16, (None, 0xDC, 0xDD))
    _header(head.append, len(a.shape), 0x90, 16, (None, 0xDC, 0xDD))
    for d in a.shape:
        _int(head.append, int(d))
    _str(head.append, a.dtype.name)
    _bin_header(head.append, a.nbytes)
    head_bytes = b"".join(head)
    _ext_header(write, code, len(head_bytes) + a.nbytes)
    write(head_bytes)
    write(memoryview(a.reshape(-1).view(np.uint8)))


def _chunked(a: np.ndarray) -> dict:
    per = max(1, MAX_CHUNK_BYTES // a.dtype.itemsize)
    flat = a.reshape(-1)
    chunks = [flat[i:i + per] for i in range(0, flat.size, per)]
    return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(a.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(write: Write, x: Any) -> None:
    if x is None:
        write(b"\xc0")
    elif x is True:
        write(b"\xc3")
    elif x is False:
        write(b"\xc2")
    elif type(x) is int:
        _int(write, x)
    elif type(x) is float:
        write(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        _str(write, x)
    elif type(x) is bytes:
        _bin_header(write, len(x))
        write(x)
    elif type(x) is dict:
        _header(write, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        if any(type(k) is not str for k in x):
            raise MsgpackError(f"map keys {[k for k in x if type(k) is not str]!r} are not str")
        for k, v in sorted(x.items()):
            _str(write, k)
            if isinstance(v, np.ndarray) and v.nbytes > MAX_CHUNK_BYTES:
                v = _chunked(v)
            _pack(write, v)
    elif type(x) is list:
        _header(write, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(write, v)
    elif isinstance(x, np.ndarray):
        _array(write, x, EXT_NDARRAY)
    elif isinstance(x, np.generic):
        _array(write, np.asarray(x), EXT_NPSCALAR)
    else:
        raise MsgpackError(f"cannot write a value of type {type(x).__name__}")


def _top(tree: Any) -> Any:
    return _chunked(tree) if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_BYTES else tree


def packb(tree: Any) -> bytes:
    """MessagePack bytes of `tree` (see the module docstring)."""
    out: List[bytes] = []
    _pack(out.append, _top(tree))
    return b"".join(out)


def dump(tree: Any, f: BinaryIO) -> None:
    """Write packb(tree) to the binary file `f` piece by piece, array
    buffers straight from their memory."""
    _pack(f.write, _top(tree))


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, raw_str: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw_str = raw_str

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise MsgpackError("truncated MessagePack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw_str else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _array_from(data)
        if code == EXT_NPSCALAR:
            return _array_from(data)[()]
        raise MsgpackError(f"unknown MessagePack ext type {code}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, str):
                raise MsgpackError(f"map key {k!r} is not a str")
            out[k] = self.value()
        return out

    def value(self):
        b = self.unpack("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            v = self.unpack(ints[b])
            return float(v) if b in (0xCA, 0xCB) else v
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lens:
            n = self.unpack(lens[b])
            if b in (0xC4, 0xC5, 0xC6):
                return bytes(self.take(n))
            if b in (0xD9, 0xDA, 0xDB):
                return self.str_(n)
            if b in (0xDC, 0xDD):
                return [self.value() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self.map_(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise MsgpackError(f"unknown MessagePack type byte 0x{b:02x}")


def _array_from(data: bytes) -> np.ndarray:
    r = _Reader(data, raw_str=True)
    tpl = r.value()
    if not (isinstance(tpl, list) and len(tpl) == 3 and isinstance(tpl[0], list)
            and isinstance(tpl[2], bytes)):
        raise MsgpackError("malformed ndarray payload")
    shape, name, buf = tpl
    name = name.decode() if isinstance(name, bytes) else name
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise MsgpackError(f"arrays of dtype {name!r} are not supported") from None
    if dtype.hasobject:
        raise MsgpackError(f"arrays of dtype {name!r} are not supported")
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def _unchunk(x):
    if isinstance(x, dict):
        if x.get(_CHUNKED) is True:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in x.items()}
    return x


def unpackb(data: bytes) -> Any:
    """The tree `data` encodes; chunked arrays are joined back."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} bytes after the MessagePack value")
    return _unchunk(out)
