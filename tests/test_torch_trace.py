"""The port's span and counter recorder (photoverse_tpu_torch/utils/trace.py)
and the spans of the layers it instruments, on the CPU at the tiny size:
off it records nothing and costs one flag test; on, spans nest per thread
and carry their ids; run_inference, the dynamic-batching service, the train
step and the loader record the spans the benchmark's readers read, and the
recorder changes no output."""

import threading
import time

import numpy as np
import pytest
import torch

from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
from photoverse_tpu_torch.data.dataset import BatchLoader
from photoverse_tpu_torch.engine import training as ttr
from photoverse_tpu_torch.engine.inference import run_inference
from photoverse_tpu_torch.utils import trace
from tests.tiny_models import LATENT, SEQ, tiny_batch, tiny_bundle
from tests.torch_tiny import port_models
from tests.torch_threads import worker_threads  # noqa: F401

STEPS = 3


@pytest.fixture
def recorder():
    """The recorder on for the test; always off afterwards."""
    trace.enable()
    try:
        yield trace
    finally:
        trace.take()


@pytest.fixture(scope="module")
def models():
    modules, params = tiny_bundle(lora_rank=2)
    return port_models(modules, params)


def _names(spans):
    return [s["name"] for s in spans]


def _example(n, seed=0):
    b = tiny_batch(B=n, seed=seed)
    b["negative_text_input_ids"] = np.zeros((n, SEQ), np.int32)
    return b


def test_off_records_nothing_and_costs_a_flag_test():
    trace.take()  # off, whatever ran before
    assert trace.span("a") is trace.span("b", request=1) is trace.span("c")
    with trace.span("a") as s:
        s.end(extra=1)
    n = 20000
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(n):
            with trace.span("unet_step"):
                pass
        best = min(best, (time.perf_counter() - t) / n)
    print(f"span() with the recorder off: {best * 1e9:.0f} ns a call (best of 5 x {n})")
    assert best < 10e-6
    assert trace.take()["spans"] == []


def test_a_running_profiler_turns_recording_on():
    trace.take()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("denoise"):
            with trace.span("unet_step"):
                pass
    with trace.span("unet_step"):  # the profiler has stopped
        pass
    got = trace.take()
    by = {s["name"]: s for s in got["spans"]}
    assert _names(got["spans"]) == ["unet_step", "denoise"]
    assert by["unet_step"]["parent"] == by["denoise"]["id"]
    assert trace.span("a") is trace.span("b")


def test_nesting_parents_threads_and_ids(recorder):
    main = threading.get_native_id()
    with trace.span("request", request=7) as outer:
        queued = trace.span("queued", request=7)
        with trace.span("dispatch", batch=1, rows=2):
            with trace.span("unet_step"):
                pass
        seen = {}

        def worker():
            seen["tid"] = threading.get_native_id()
            queued.end(taken=True)
            with trace.span("device_wait", batch=1):
                pass

        th = threading.Thread(target=worker)
        th.start()
        th.join(30)
        assert not th.is_alive()
    trace.count("launch.fused_cross_ff", 3)
    got = trace.take()
    by = {s["name"]: s for s in got["spans"]}
    assert set(by) == {"request", "queued", "dispatch", "unet_step", "device_wait"}
    assert by["request"]["parent"] is None and by["request"]["id"] == outer.id
    assert by["queued"]["parent"] == by["dispatch"]["parent"] == by["request"]["id"]
    assert by["unet_step"]["parent"] == by["dispatch"]["id"]
    assert by["device_wait"]["parent"] is None  # another thread's stack
    assert by["queued"]["thread"] == by["request"]["thread"] == main  # where it started
    assert by["device_wait"]["thread"] == seen["tid"] != main
    assert by["queued"]["attrs"] == {"request": 7, "taken": True}
    assert by["dispatch"]["attrs"] == {"batch": 1, "rows": 2}
    for s in got["spans"]:
        assert s["start"] <= s["end"]
    assert by["request"]["start"] <= by["dispatch"]["start"] <= by["dispatch"]["end"] <= by["request"]["end"]
    assert got["counters"] == {"launch.fused_cross_ff": 3}
    assert [main, threading.get_ident()] in got["threads"] and seen["tid"] in [n for n, _ in got["threads"]]
    assert trace.take()["spans"] == []  # take() ended the recording


def test_counters_are_always_on_and_count_per_block():
    with trace.counting("launch.") as launches:
        trace.count("launch.flash_sdpa")
        trace.count("launch.flash_sdpa", 2)
        trace.count("not_a_launch")
    assert launches == {"flash_sdpa": 3}
    before = trace.counts("launch.")
    trace.count("launch.fused_cross_ff")
    assert trace.since(before, "launch.") == {"fused_cross_ff": 1}


def test_union_length_counts_overlap_once():
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.union_length([(0, 2), (1, 3)], 1.5, 2.5) == 1.0
    ev = [{"ph": "X", "cat": "kernel", "ts": 0.0, "dur": 2e6}, {"ph": "X", "cat": "gpu_memcpy", "ts": 1e6, "dur": 2e6},
          {"ph": "X", "cat": "cuda_runtime", "ts": 0.0, "dur": 9e6}, {"ph": "X", "cat": "gpu_user_annotation",
                                                                      "ts": 0.0, "dur": 9e6}]
    assert trace.union_length(trace.device_intervals(ev)) == pytest.approx(3.0)


@pytest.mark.parametrize("guidance", [1.0, 6.0])
def test_run_inference_spans_and_equal_images(models, guidance):
    def run():
        solver = DPMSolverMultistep.create(models.schedule, STEPS)
        noise = np.random.RandomState(5).randn(2, LATENT, LATENT, 4).astype(np.float32)
        return run_inference(models, solver, _example(2), guidance_scale=guidance, latent_size=LATENT,
                             initial_noise=noise)

    off = run()
    trace.enable()
    try:
        on = run()
    finally:
        got = trace.take()
    assert torch.equal(on, off)
    names = _names(got["spans"])
    assert names.count("conditioning") == names.count("denoise") == names.count("decode") == 1
    assert names.count("unet_step") == STEPS
    by = {s["id"]: s for s in got["spans"]}
    for s in got["spans"]:
        if s["name"] == "unet_step":
            assert by[s["parent"]]["name"] == "denoise"
    order = [n for n in names if n != "unet_step"]
    assert order == ["conditioning", "denoise", "decode"]  # closed in this order


def test_dynamic_batching_ties_batches_to_their_requests(models, recorder):
    import argparse

    from photoverse_tpu_torch.cli.serve import PhotoVerseService

    args = argparse.Namespace(
        sharding="none", model_path="", resolution=32, cpu=True, dynamic_batching=True, max_batch=2,
        batch_wait_ms=5000, max_queue=8, default_steps=STEPS, native_tokenizer=False, fast=False,
        int8_conditioning=False, bf16_params=False, extra_num_tokens=4, encoder_layers_idx=[1, 2, 3, 4])
    svc = PhotoVerseService(args, models=(None, models))
    key = (2, 6.0, "dpm")
    out = {}

    def fire(seed):
        out[seed] = svc.submit(_example(1, seed), 1, seed, key)

    threads = [threading.Thread(target=fire, args=(s,)) for s in (3, 4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not any(th.is_alive() for th in threads) and svc.drain(30)
    assert out[3]["batch_rows"] == out[4]["batch_rows"] == 2
    got = trace.take()
    spans = got["spans"]
    requests = {s["attrs"]["request"]: s for s in spans if s["name"] == "request"}
    queued = [s for s in spans if s["name"] == "queued"]
    assert len(requests) == 2 and sorted(s["attrs"]["request"] for s in queued) == sorted(requests)
    for q in queued:  # the queue wait lies inside its request, begun on the request's thread
        r = requests[q["attrs"]["request"]]
        assert q["parent"] == r["id"] and q["thread"] == r["thread"]
        assert r["start"] <= q["start"] <= q["end"] <= r["end"]
    batch = {s["name"]: s for s in spans if "batch" in s["attrs"]}
    assert set(batch) == {"coalesce", "dispatch", "inflight_wait", "device_wait", "deliver"}
    for s in batch.values():
        assert sorted(s["attrs"]["requests"]) == sorted(requests)
        assert (s["attrs"]["rows"], s["attrs"]["bucket"]) == (2, 2)
    by = {s["id"]: s for s in spans}
    assert _names(s for s in spans if s["parent"] == batch["dispatch"]["id"]) == ["conditioning", "denoise", "decode"]
    assert batch["coalesce"]["thread"] == batch["dispatch"]["thread"] != batch["device_wait"]["thread"]
    assert all(by[s["parent"]]["name"] == "denoise" for s in spans if s["name"] == "unet_step")


def test_sequential_service_records_request_dispatch_and_device_wait(models, recorder):
    import argparse

    from photoverse_tpu_torch.cli.serve import PhotoVerseService

    args = argparse.Namespace(
        sharding="none", model_path="", resolution=32, cpu=True, dynamic_batching=False, max_batch=2,
        batch_wait_ms=25, max_queue=8, default_steps=STEPS, native_tokenizer=False, fast=False,
        int8_conditioning=False, bf16_params=False, extra_num_tokens=4, encoder_layers_idx=[1, 2, 3, 4])
    svc = PhotoVerseService(args, models=(None, models))
    svc.submit(_example(1), 1, 3, (2, 1.0, "dpm"))
    spans = trace.take()["spans"]
    by = {s["name"]: s for s in spans}
    assert {"request", "dispatch", "device_wait", "conditioning", "denoise", "decode"} <= set(by)
    assert by["dispatch"]["parent"] == by["device_wait"]["parent"] == by["request"]["id"]
    assert by["conditioning"]["parent"] == by["dispatch"]["id"]


def test_sdxl_request_records_both_text_encoder_spans(recorder):
    # a tiny SDXL bundle (tests/sdxl_tiny.py) behind the sequential service,
    # its flash route on: one `text_encoder` span per encoder inside
    # `conditioning`, each with its encoder and rows. The d=64 launches'
    # `launch.flash_sdpa` count needs the card (tests/test_torch_cuda.py:
    # test_sdxl_request_counts_its_d64_flash_launches); the CPU's plain
    # path launches nothing and counts nothing
    import argparse

    from photoverse_tpu_torch.cli.serve import PhotoVerseService
    from tests import sdxl_tiny

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        sdxl, _ = sdxl_tiny.bundle(use_flash_attention=True, flash_min_seq=16)
        args = argparse.Namespace(
            sharding="none", model_path="", resolution=sdxl_tiny.RES, cpu=True, dynamic_batching=False,
            max_batch=2, batch_wait_ms=25, max_queue=8, default_steps=2, native_tokenizer=False, fast=False,
            int8_conditioning=False, bf16_params=False, extra_num_tokens=0, encoder_layers_idx=[])
        svc = PhotoVerseService(args, models=(None, sdxl))
        with trace.counting("launch.") as launches:
            svc.submit(sdxl_tiny.example(2), 2, 3, (2, 5.0, "dpm"))
    finally:
        torch.set_num_threads(n)
    spans = trace.take()["spans"]
    by = {s["id"]: s for s in spans}
    enc = [s for s in spans if s["name"] == "text_encoder"]
    assert [s["attrs"] for s in enc] == [{"encoder": 1, "rows": 2}, {"encoder": 2, "rows": 2}]
    assert all(by[s["parent"]]["name"] == "conditioning" for s in enc)
    assert enc[0]["end"] <= enc[1]["start"] and launches == {}


@pytest.mark.parametrize("face", [False, True])
def test_train_step_spans(face):
    from photoverse_tpu_torch.models.arcface import ArcFaceConfig, ArcFaceResNet18
    from photoverse_tpu_torch.models.face_loss import FaceLoss, make_face_loss_fn

    models = port_models(*tiny_bundle(lora_rank=2))
    cfg = ttr.TrainConfig(max_train_steps=5, lr_warmup_steps=0, learning_rate=1e-3, face_loss_timesteps=2,
                          gradient_accumulation_steps=2)
    _, _, optimizer = ttr.init_train_state(models, cfg)
    kw = {}
    if face:
        arc = ArcFaceResNet18(ArcFaceConfig(input_size=32), device="cpu").requires_grad_(False)
        kw = dict(face_loss_fn=make_face_loss_fn(FaceLoss(arc)), face_solver=DPMSolverMultistep.create(models.schedule, 2))
    step = ttr.make_train_step(models, cfg, optimizer, **kw)
    batch = tiny_batch(B=2, seed=8)
    if face:
        batch.update(face_pixel_values=batch["pixel_values"][:1], face_pixel_values_clip=batch["pixel_values_clip"][:1],
                     face_text_input_ids=batch["text_input_ids"][:1],
                     face_concept_placeholder_idx=batch["concept_placeholder_idx"][:1],
                     face_uncond_input_ids=np.zeros((1, SEQ), np.int32))
    trace.enable()
    try:
        draws = ttr.make_draws(torch.Generator().manual_seed(0), 2, LATENT, len(models.unet.cross_attentions()),
                               face_rows=1 if face else 0)
        metrics = step(batch, draws)
    finally:
        got = trace.take()
    assert np.isfinite(float(metrics["loss"]))
    spans = got["spans"]
    by = {s["id"]: s for s in spans}
    micro = [s for s in spans if s["name"] == "micro_step"]
    assert len(micro) == 1 and micro[0]["attrs"] == {"kind": "face" if face else "diffusion"}
    children = _names(s for s in spans if s["parent"] == micro[0]["id"])
    assert children == ["forward"] + (["face_loss"] if face else []) + ["backward", "optimizer"]
    assert [s["name"] for s in spans if s["name"] == "sync"] == ["sync"] * (2 if face else 1)
    if face:
        floss = next(s for s in spans if s["name"] == "face_loss")
        assert _names(s for s in spans if s["parent"] == floss["id"]) == ["denoise", "decode", "face_embed"]
        steps = [s for s in spans if s["name"] == "unet_step"]
        assert len(steps) == 2 and all(by[by[s["parent"]]["parent"]]["name"] == "face_loss" for s in steps)


class _Rows:
    """A dataset of n tiny examples."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def example(self, i, rng):
        return {"pixel_values": np.full((2, 2, 3), i, np.uint8), "pixel_values_clip": np.zeros((2, 2, 3), np.uint8),
                "text_input_ids": np.arange(4), "concept_placeholder_idx": np.array([1]), "text": str(i)}


def test_loader_records_one_wait_per_batch(recorder):
    loader = BatchLoader(_Rows(10), 2, shuffle=True, seed=0, num_workers=2)
    batches = [b for _ in range(2) for b in loader]
    spans = trace.take()["spans"]
    waits = [s for s in spans if s["name"] == "loader_wait"]
    assert len(batches) == len(waits) == 10
    assert [s["attrs"]["epoch_start"] for s in waits] == ([True] + [False] * 4) * 2
    assert len({s["thread"] for s in waits}) == 1 and waits[0]["thread"] == threading.get_native_id()
