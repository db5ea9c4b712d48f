"""The program's spans in a traced run: the port's recorder records while a
torch profiler runs, the first reader takes its records for the run, and
the five per-layer readers of the spans read what hand-made records and a
hand-made device trace hold, or None where the program has no recorder or
the run no trace."""

from __future__ import annotations

import sys
import types

import pytest

from benchmark import harness, program_spans
from benchmark.trace import DeviceTrace

OFF = 100.0 - 0.005  # host seconds = trace microseconds * 1e-6 + OFF
SPAN_READERS = ["queued_p90_s.serve", "dispatch_busy_share.serve", "unet_step_enqueue_ms.generate",
                "loader_block_s.train", "idle_outside_micro_steps_s.train"]


def _us(host_s: float) -> float:
    return (host_s - OFF) * 1e6


def _events(work):
    """A chrome trace: the marker launched at host time 100.0 s, then for
    each (device start s, device end s) a kernel."""
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5000.0, "dur": 0.2,
           "args": {"correlation": 1}},
          {"ph": "X", "cat": "kernel", "name": "spin_kernel(long)", "ts": 5000.5, "dur": 0.5,
           "args": {"correlation": 1}}]
    for i, (a, b) in enumerate(work, start=2):
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": _us(a), "dur": (b - a) * 1e6,
                   "args": {"correlation": i, "grid": [1, 1, 1]}})
    return ev


def _span(i, name, thread, a, b, parent=None, **attrs):
    return {"id": i, "name": name, "start": a, "end": b, "thread": thread, "parent": parent, "attrs": attrs}


SERVE_SPANS = [
    _span(1, "request", 11, 100.000, 100.040, request=0),
    _span(2, "queued", 11, 100.001, 100.003, 1, request=0),
    _span(3, "request", 12, 100.002, 100.045, request=1),
    _span(4, "queued", 12, 100.002, 100.006, 3, request=1),
    _span(5, "queued", 12, 100.030, 100.049, request=2),  # not delivered in the window
    _span(6, "dispatch", 22, 100.004, 100.020, batch=0, requests=[0, 1]),
    _span(7, "unet_step", 22, 100.006, 100.008, 6),
    _span(8, "unet_step", 22, 100.009, 100.011, 6),
    _span(9, "decode", 22, 100.012, 100.016, 6),
    _span(10, "dispatch", 22, 100.025, 100.030, batch=1, requests=[2]),
    _span(11, "device_wait", 33, 100.017, 100.031, batch=0),
]
SERVE_WORK = [(100.007, 100.009), (100.010, 100.0115), (100.013, 100.016), (100.030, 100.031)]
TRAIN_SPANS = [
    _span(1, "micro_step", 11, 100.000, 100.010, kind="diffusion"),
    _span(2, "loader_wait", 11, 100.010, 100.0115, epoch_start=True),
    _span(3, "micro_step", 11, 100.012, 100.020, kind="face"),
]
TRAIN_WORK = [(100.001, 100.009), (100.013, 100.019)]


def _ctx(work, spans, t1, cfg_name="sd15-photoverse-serve"):
    run = types.SimpleNamespace(config=harness.config(cfg_name), bench_dir=harness.BENCH_DIR)
    ctx = types.SimpleNamespace(run=run, trace=DeviceTrace(_events(work), anchor_host=100.0), t0=100.0, t1=t1)
    if spans is not None:
        ctx.program = {"spans": spans, "counters": {}}
    return ctx


def _read(ctx):
    fns = harness.readers(SPAN_READERS)
    return {n: fns[n](ctx) for n in SPAN_READERS}


def test_serving_and_generation_readers():
    got = _read(_ctx(SERVE_WORK, SERVE_SPANS, 100.050))
    assert got["queued_p90_s.serve"] == pytest.approx(0.002 + 0.9 * 0.002)
    assert got["dispatch_busy_share.serve"] == pytest.approx(100 * 0.021 / 0.050)
    assert got["unet_step_enqueue_ms.generate"] == pytest.approx(2.0)
    assert got["loader_block_s.train"] is None and got["idle_outside_micro_steps_s.train"] is None


def test_training_readers():
    got = _read(_ctx(TRAIN_WORK, TRAIN_SPANS, 100.015, "sd15-photoverse-train"))  # accumulation 2: one step
    assert got["loader_block_s.train"] == pytest.approx(0.0015)
    # idle from the window's start to the last micro-step's end, outside both: 100.010-100.012
    assert got["idle_outside_micro_steps_s.train"] == pytest.approx(0.002)
    assert got["unet_step_enqueue_ms.generate"] is None and got["queued_p90_s.serve"] is None


def test_the_readers_take_what_the_recorder_held_under_the_profiler():
    torch = pytest.importorskip("torch")
    from photoverse_tpu_torch.utils import trace as recorder

    recorder.take()
    with recorder.span("unet_step"):
        pass  # no profiler: not recorded
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            with recorder.span("unet_step"):
                pass
    ctx = _ctx(SERVE_WORK, None, 100.050)
    got = _read(ctx)
    assert len(program_spans.spans(ctx, "unet_step")) == 3  # taken once, kept for the run's readers
    assert got["unet_step_enqueue_ms.generate"] > 0.0 and got["queued_p90_s.serve"] is None
    assert recorder.take()["spans"] == []


def test_without_the_recorder_or_the_trace_the_readers_find_nothing(monkeypatch):
    utils = sys.modules.get("photoverse_tpu_torch.utils")
    if utils is not None:
        monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "photoverse_tpu_torch.utils.trace", None)  # the import fails
    ctx = _ctx(SERVE_WORK, None, 100.050)
    assert all(v is None for v in _read(ctx).values())
    assert ctx.program is None
    ctx = _ctx(SERVE_WORK, SERVE_SPANS, 100.050)
    ctx.trace = None
    assert all(v is None for v in _read(ctx).values())
