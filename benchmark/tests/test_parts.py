"""The benchmark's parts on their own: traffic that repeats per seed, the
FLOP count against torch's own counter over the reference, the trace
reduction and the per-layer readers on a hand-made trace."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from benchmark import flops, harness, serving
from benchmark.reference import nets
from benchmark.tests.tiny import SERVE_WL, make_run, tiny_train_config
from benchmark.trace import DeviceTrace, gaps, union_length
from benchmark.traffic import open_loop


def test_arrivals_repeat_per_seed_and_keep_their_gaps():
    a, b = open_loop.offsets(2.0, 51.0, 2147483901), open_loop.offsets(2.0, 51.0, 2147483901)
    c = open_loop.offsets(2.0, 51.0, 2147483999)
    assert a == b and a != c
    assert len(a) == len(c) == 102  # the same offered load on every seed
    assert sorted(np.diff(a + [51.0]).round(9)) == pytest.approx(sorted(np.diff(c + [51.0]).round(9)), abs=1e-6)
    assert all(0 <= x < 51.0 for x in a) and open_loop.offsets(0.01, 10.0, 1) == []


def test_requests_repeat_per_seed():
    cell = serving.ServeCell.__new__(serving.ServeCell)
    cell.run = make_run(SERVE_WL)
    cell.req_cfg = SERVE_WL["requests"]
    cell.key = (3, 6.0, "dpm")
    r1, r2, r3 = cell.make_request(5), cell.make_request(5), cell.make_request(6)
    for k in r1.example:
        np.testing.assert_array_equal(r1.example[k], r2.example[k])
    assert r1.seed == r2.seed != r3.seed
    ids, p = r1.example["text_input_ids"][0], int(r1.example["concept_placeholder_idx"][0])
    assert 2 <= p <= 10 and ids[0] == 126 and ids[-1] == 127 and ids[p] < 126


def _count(fn):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_flops_agree_with_torchs_counter_over_the_reference():
    cfg = tiny_train_config()
    from benchmark.models import program_models, ref_cfg
    from benchmark.weights import make_weights, named_params

    w = make_weights(named_params(program_models(cfg, "meta", train=True)), 1, "cpu", torch.float32)
    from photoverse_tpu_torch.models.arcface import ArcFaceConfig, ArcFaceResNet18

    f = cfg["face_model"]
    face = ArcFaceResNet18(ArcFaceConfig(layers=tuple(f["layers"]), channels=tuple(f["channels"]),
                                         embedding_dim=f["embedding_dim"], input_size=f["input_size"]), device="meta")
    w.update(make_weights(named_params(face, "arcface."), 2, "cpu", torch.float32))
    W, N, rc = nets.Weights(w, "cpu"), nets.Numerics(), ref_cfg(cfg)
    size, st, K = 16, 77, 5
    x = torch.randn(2, size, size, 4)
    text, idc = torch.randn(2, st, 32), torch.randn(2, K, 32)
    t = torch.tensor([10, 500])
    with torch.no_grad():
        assert _count(lambda: nets.unet(W, N, rc["unet"], x, t, text, idc)) == 2 * flops.unet_forward(cfg, size, st, K)
        assert _count(lambda: nets.vae_decode(W, N, rc["vae"], x)) == 2 * flops.vae_decode(cfg, size)
        px = torch.rand(2, 32, 32, 3)
        assert _count(lambda: nets.vae_encode_moments(W, N, rc["vae"], px)) == 2 * flops.vae_encode(cfg, 32)
        ids = torch.randint(0, 120, (2, 77))
        assert _count(lambda: nets.text_encoder(W, N, rc["text"], ids)) == 2 * flops.text_encoder(cfg)
        clip = torch.randn(2, 28, 28, 3)
        assert _count(lambda: nets.vision_encoder(W, N, rc["vision"], clip)) == 2 * flops.vision_encoder(cfg)
        feats = nets.vision_encoder(W, N, rc["vision"], clip)
        assert _count(lambda: nets.adapter(W, N, "text_adapter", feats, [0, 1])) == 2 * flops.adapter(cfg, 2)
        g = torch.rand(2, 32, 32, 1)
        assert _count(lambda: nets.arcface(W, N, rc["arcface"], g)) == 2 * flops.arcface(cfg)


def test_generation_and_step_counts_are_positive_and_ordered():
    cfg = harness.config("sd15-photoverse-serve")
    g1, g6 = flops.generation(cfg, 25, 1.0), flops.generation(cfg, 25, 6.0)
    assert 0 < g1 < g6 < 2.2 * g1
    assert 1.5e13 < g1 < 3e13  # about 0.7 TFLOP a UNet evaluation at 64 x 64 latents
    t = flops.train_step(harness.config("sd15-photoverse-train"))
    assert t > 16 * 3 * flops.unet_forward(cfg, 64, 77, 5, lora_branch=False)


def _trace():
    """A hand-made chrome trace: the marker launched at host time 100.0 s
    (trace time 5,000 us), two fused-tail launches, one flash backward
    pair, a copy."""
    ev = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5000.0, "dur": 3.0,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "spin_kernel(long)", "ts": 5010.0, "dur": 1.0,
         "args": {"correlation": 1, "grid": [1, 1, 1]}},
        {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::fused_cross_ff_kernel(Maps, Args)",
         "ts": 6000.0, "dur": 1000.0, "args": {"correlation": 2, "grid": [64, 16, 1]}},
        {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::fused_cross_ff_kernel(Maps, Args)",
         "ts": 8000.0, "dur": 1000.0, "args": {"correlation": 3, "grid": [64, 16, 1]}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 8500.0, "dur": 1000.0, "args": {}},
        {"ph": "X", "cat": "kernel", "name": "void flash_bwd_dq_kernel<40, 3>(CUtensorMap)", "ts": 10000.0,
         "dur": 2000.0, "args": {"correlation": 4, "grid": [32, 64, 1]}},
        {"ph": "X", "cat": "kernel", "name": "void flash_bwd_dkv_kernel<40, 2, true>(CUtensorMap)", "ts": 12000.0,
         "dur": 1000.0, "args": {"correlation": 5, "grid": [32, 64, 1]}},
    ]
    return DeviceTrace(ev, anchor_host=100.0)


def test_trace_intervals():
    assert union_length([(0, 2), (1, 3), (5, 6)], 0, 10) == 4
    assert union_length([(0, 2), (1, 3)], 1.5, 2.5) == 1.0
    assert gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]


def test_readers_on_a_hand_made_trace():
    tr = _trace()
    assert tr.offset == pytest.approx(100.0 - 0.005)
    lo, hi = 100.0, 100.01  # 10 ms from the marker's launch
    # busy: marker 1 us, 1 ms, 1.5 ms (kernel + overlapping copy), 3 ms
    assert tr.busy(lo, hi) == pytest.approx(0.000001 + 0.001 + 0.0015 + 0.003, rel=1e-6)
    cfg = harness.config("sd15-photoverse-serve")
    run = types.SimpleNamespace(config=cfg, bench_dir=harness.BENCH_DIR)
    ctx = types.SimpleNamespace(run=run, trace=tr, t0=lo, t1=hi, work_flops=989e12 * 0.001)
    from benchmark import bounds

    want = 2 * bounds.bound_ms(*bounds.fused_cross_ff(16, 4096, 320, 8, 77, 1, 1280)) / 1e3 / 0.002
    assert harness.roofline(ctx, "fused_cross_ff") == pytest.approx(100 * want)
    ctx.run = types.SimpleNamespace(config=harness.config("sd15-photoverse-train"), bench_dir=harness.BENCH_DIR)
    want = bounds.bound_ms(*bounds.flash_bwd(8, 4096, 8, 40)) / 1e3 / 0.003
    assert harness.roofline(ctx, "flash_bwd") == pytest.approx(100 * want)
    assert harness.device_idle(ctx) == pytest.approx(100 * (1 - 0.005501 / 0.01), rel=1e-6)
    assert harness.mfu(ctx) == pytest.approx(10.0)
    top = tr.top_ops(lo, hi)
    assert top[0][0].startswith("(anonymous namespace)::fused_cross_ff") and top[0][1] == pytest.approx(0.002)
    spans = harness.Spans()
    spans.items = [("step", 99.0, 100.0095), ("next(loader)", 100.0070, 100.0080)]
    idle = tr.idle_gaps(lo, hi, spans.label)
    assert idle[0] == ["step", pytest.approx(0.001, abs=1e-9)] or idle[0][0] in ("step", "next(loader)")
    assert harness.roofline(types.SimpleNamespace(run=ctx.run, trace=None, t0=lo, t1=hi), "flash_bwd") is None


def test_percentiles_count_failures_as_missing():
    assert harness.percentile([1.0, 2.0, 3.0], 0.5) == 2.0
    assert harness.percentile([1.0, 2.0, float("inf")], 0.9) == float("inf")
    assert harness.prorated([(0.0, 2.0, 1.0), (1.0, 3.0, 2.0)], 1.0, 2.0) == pytest.approx(0.5 + 1.0)


def test_the_synthetic_vocabulary_spells_each_template_word_as_one_token(tmp_path):
    """As in CLIP's vocabulary, so the placeholder index (a word index)
    points at the placeholder's token."""
    from benchmark import training
    from benchmark.reference import data_ref
    from photoverse_tpu_torch.data.tokenizer import CLIPTokenizer

    training.write_tokenizer(str(tmp_path), 77)
    tok = CLIPTokenizer.from_pretrained(str(tmp_path))
    star = tok.encoder["*</w>"]
    for t in data_ref.TEMPLATES:
        ids = list(tok(t.format("*"))[0])
        if "-" not in t:
            assert ids.index(star) == 1 + t.format("*").split(" ").index("*"), t


def test_the_sweep_reads_a_growing_backlog():
    from benchmark import sweep

    def reqs(slope):
        out = []
        for i in range(90):
            r = serving.Request(i, 0, 1, None, None)
            r.due = 100.0 + i / 3.0
            r.t_done = r.due + 2.0 + slope * (r.due - 100.0) + (0.3 if i % 2 else -0.3)
            r.images = np.zeros(1)
            out.append(r)
        return out

    flat, growing = reqs(0.0), reqs(0.1)
    assert abs(sweep.rise(flat, 30.0)) < 0.05 and sweep.rise(growing, 30.0) == pytest.approx(3.0, abs=0.05)
    row = {"failed": 0, "rise_s": sweep.rise(flat, 30.0), "latency_p50_s": 2.0, "latency_p90_s": 2.3}
    assert sweep.sustained(row, 10.0)
    assert not sweep.sustained(dict(row, rise_s=sweep.rise(growing, 30.0)), 10.0)
    assert not sweep.sustained(dict(row, failed=1), 10.0)
    growing[5].images, growing[5].error = None, "rejected"
    assert sweep.rise(growing, 30.0) == float("inf")
