"""Spans and counters of the program, on the host clock
(`time.perf_counter`, the clock a device trace is tied to by a marker
kernel; see `cli/train.py --profile_steps` and `benchmark/trace.py`).

    from photoverse_tpu_torch.utils import trace

    with trace.span("unet_step"):       # nests under the thread's open span
        ...
    q = trace.span("queued", request=7)  # without `with`: may end on another thread
    ...
    q.end()
    trace.count("launch.flash_sdpa")

A span times the host's work between two points, the enqueue of device
work or an explicit wait; it never synchronises the device. Recording is
on between `enable()` and `take()`, and also while a torch profiler runs
(torch's own `_is_profiler_enabled` flag), so that any profile of the
program, such as a traced run of benchmark/run.py, holds its spans. Off,
`span()` tests those two flags and returns one shared no-op object,
allocating and locking nothing. On, a span records its name, start and
end, the native id of the thread that opened it, its parent (the
innermost span the same thread had open when it started, entered with
`with`) and the attributes passed in. Records stay in memory until
`take()`, which ends the recording and returns them with the counters'
growth since `enable()`.

Counters are always on (a locked Counter increment, cheaper than a recorded
span): the kernel wrappers count each launch as `launch.<kernel>`, and the
UNet's cross-attention counts each call on the card that kept the einsums
as `route.cross_attn_einsum` (beside `launch.dual_cross_attn`, the share of
those calls that took the kernel).
`since()` and `counting()` give their growth.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from torch.autograd import profiler as _profiler

__all__ = ["span", "enable", "take", "count", "counts", "since", "counting",
           "union_length", "device_intervals", "DEVICE_CATS"]

_on = False
_records: List[dict] = []
_ids = itertools.count(1)
_local = threading.local()
_counts: collections.Counter = collections.Counter()
_counts_lock = threading.Lock()
_base: Dict[str, int] = {}
_threads: Dict[int, int] = {}  # native thread id: threading.get_ident(), of each thread that opened a span


class _Off:
    """The span of a recorder that is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self, **attrs):
        pass


_OFF = _Off()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        _threads[threading.get_native_id()] = threading.get_ident()
        return _local.stack


class _Span:
    __slots__ = ("id", "name", "attrs", "parent", "thread", "t0")

    def __init__(self, name: str, attrs: dict):
        stack = _stack()
        self.id = next(_ids)
        self.name = name
        self.attrs = attrs
        self.parent = stack[-1].id if stack else None
        self.thread = threading.get_native_id()
        self.t0 = time.perf_counter()

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        self.end()
        return False

    def end(self, **attrs):
        """Close the span (any thread); `attrs` join those it started with."""
        t1 = time.perf_counter()
        if attrs:
            self.attrs = {**self.attrs, **attrs}
        _records.append({"id": self.id, "name": self.name, "start": self.t0, "end": t1, "thread": self.thread,
                         "parent": self.parent, "attrs": self.attrs})


def span(name: str, **attrs):
    """A span entered with `with`, whose children are the thread's spans
    opened inside it; or, used without `with`, closed by its `end()` on
    whichever thread, and nobody's parent."""
    return _Span(name, attrs) if _on or _profiler._is_profiler_enabled else _OFF


def enable() -> None:
    """Start recording: earlier records are dropped, the counters' growth
    is counted from here."""
    global _on, _records, _base
    _records = []
    _base = counts()
    _on = True


def take() -> dict:
    """End the recording; {"spans": the records in the order they closed,
    "counters": each counter's growth since enable() (since the start,
    where only a profiler turned recording on), "threads": [native
    id, threading.get_ident()] of every thread that opened a span (a
    profiler names a thread by the latter)}."""
    global _on, _records
    _on = False
    spans, _records = _records, []
    return {"spans": spans, "counters": since(_base), "threads": [[n, i] for n, i in list(_threads.items())]}


def count(name: str, n: int = 1) -> None:
    with _counts_lock:
        _counts[name] += n


def counts(prefix: str = "") -> Dict[str, int]:
    """The counters whose names start with `prefix`, the prefix cut off."""
    with _counts_lock:
        return {k[len(prefix):]: v for k, v in _counts.items() if k.startswith(prefix)}


def since(before: Dict[str, int], prefix: str = "") -> Dict[str, int]:
    """Each counter's growth since `before`, a `counts(prefix)` taken
    earlier (counters that did not move left out)."""
    return {k: v - before.get(k, 0) for k, v in counts(prefix).items() if v != before.get(k, 0)}


@contextlib.contextmanager
def counting(prefix: str = "") -> Iterator[Dict[str, int]]:
    """Yields a dict that, once the block ends, holds `since()` over the
    block."""
    out: Dict[str, int] = {}
    before = counts(prefix)
    try:
        yield out
    finally:
        out.update(since(before, prefix))


# ---------------------------------------------------------------------------
# device activity of a profiler's chrome trace

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_intervals(events: Iterable[dict]) -> List[Tuple[float, float]]:
    """(start, end) in seconds of the trace's clock of every kernel, copy
    and memset in a chrome trace's events (not the annotations that mirror
    host ranges on the device's timeline)."""
    return [(e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def union_length(intervals: Iterable[Tuple[float, float]], lo: Optional[float] = None,
                 hi: Optional[float] = None) -> float:
    """Length of the union of [a, b) intervals, clipped to [lo, hi): the
    device's busy time, where overlapping work counts once."""
    lo = float("-inf") if lo is None else lo
    hi = float("inf") if hi is None else hi
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total
