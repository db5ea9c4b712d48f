"""Whole runs at a tiny size on the CPU (the harness's look for a card
skipped, the program in f32 on its plain paths): the result line, the
checks passing on the sound program, and `correct` coming out false when
the timed path is broken underneath or the reference one step below the
configuration's precision takes the program's place."""

from __future__ import annotations

import contextlib
import io
import json

import torch

from benchmark import harness, training
from benchmark.tests.tiny import SERVE_WL, TRAIN_WL, make_run, tiny_train_config

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _serve(wl=SERVE_WL, **kw):
    run = make_run(wl, **kw)
    return harness.traffic(run.workload["kind"]).run(run)


def _train(**kw):
    run = make_run(TRAIN_WL, cfg=tiny_train_config(), seconds=1.5, **kw)
    run.end_to_end = [{"name": "setup_s", "unit": "s"}, {"name": "train_images_per_s", "unit": "images/s"}]
    return training.run_cell(run)


def test_a_sound_serving_run_and_its_line():
    result, checks = _serve()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        harness.emit(result, checks)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == KEYS
    assert line["correct"] is True and line["attempted"] == 8 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "latency_p50_s", "latency_p90_s", "images_per_s"}
    assert line["checks"]["image_gap_max"]["value"] <= 1.0


def test_a_sound_single_user_run():
    wl = dict(SERVE_WL, kind="closed_loop", clients=1,
              server=dict(SERVE_WL["server"], dynamic_batching=False, warm_batches=[1]),
              requests=dict(SERVE_WL["requests"], guidance=1.0))
    result, checks = _serve(wl, seconds=1.0)
    assert result["correct"] and result["attempted"] >= 1


def test_a_sound_training_run():
    result, checks = _train()
    assert result["correct"], checks
    assert checks["loss_gap"]["value"] < 1e-5 and checks["data_rows_matched"]["value"] == 1.0


def test_serving_faults_are_caught(monkeypatch):
    from photoverse_tpu_torch.core import schedulers
    from photoverse_tpu_torch.cli import serve

    # a step that returns its state unchanged
    with monkeypatch.context() as m:
        m.setattr(schedulers.DPMSolverMultistep, "advance", lambda self, step, carry, eps: carry)
        assert not _serve()[0]["correct"]
    # an answer altered where it is produced
    call = serve._Pipeline.__call__

    def altered(self, example, noise, ancestral_noise):
        out = call(self, example, noise, ancestral_noise)
        with torch.inference_mode():
            out[:, :4] = 255 - out[:, :4]
        return out

    with monkeypatch.context() as m:
        m.setattr(serve._Pipeline, "__call__", altered)
        assert not _serve()[0]["correct"]

    # half of the batch left out: the second half of a batch gets the first half's images
    def half(self, example, noise, ancestral_noise):
        out = call(self, example, noise, ancestral_noise)
        n = out.shape[0] // 2
        if n:
            with torch.inference_mode():
                out[n:2 * n] = out[:n]
        return out

    with monkeypatch.context() as m:
        m.setattr(serve._Pipeline, "__call__", half)
        assert not _serve(dict(SERVE_WL, correct=dict(SERVE_WL["correct"], sample=8)))[0]["correct"]


def test_training_faults_are_caught(monkeypatch):
    from photoverse_tpu_torch.engine import training as eng

    # a step that returns its state unchanged
    with monkeypatch.context() as m:
        m.setattr(eng.Optimizer, "step", lambda self, grads: True)
        assert not _train()[0]["correct"]
    # half of the batch left out, the mean taken over the rest
    loss_fn = eng.TrainStep.loss_fn

    def half(self, batch, draws):
        b = {k: v[: len(v) // 2] if k in ("pixel_values", "pixel_values_clip", "text_input_ids",
                                          "concept_placeholder_idx") else v for k, v in batch.items()}
        d = dict(draws)
        for k in ("vae_noise", "noise", "timesteps"):
            d[k] = draws[k][: len(draws[k]) // 2]
        return loss_fn(self, b, d)

    with monkeypatch.context() as m:
        m.setattr(eng.TrainStep, "loss_fn", half)
        assert not _train()[0]["correct"]
    # an answer altered where it is produced: one leaf's gradient
    grads_fn = eng.TrainStep.compute_grads

    def altered(self, batch, draws):
        metrics, grads = grads_fn(self, batch, draws)
        k = sorted(grads)[0]
        grads[k] = grads[k] * 1.5
        return metrics, grads

    with monkeypatch.context() as m:
        m.setattr(eng.TrainStep, "compute_grads", altered)
        assert not _train()[0]["correct"]


def test_feed_faults_are_caught(monkeypatch):
    """A wrong mask or CLIP crop in the feed, which both sides would take
    alike, fails the data check."""
    from photoverse_tpu_torch.data import dataset

    prepare = dataset.CustomDatasetWithMasks._prepare_image

    def unmasked(self, example, idx):
        out = prepare(self, example, idx)
        out["pixel_values_clip"] = 255 - out["pixel_values_clip"]
        return out

    with monkeypatch.context() as m:
        m.setattr(dataset.CustomDatasetWithMasks, "_prepare_image", unmasked)
        result, checks = _train()
        assert not result["correct"] and checks["data_rows_matched"]["value"] == 0.0


def test_the_controls_fail_the_tiny_limits():
    """The reference in fp8 (and, for training, with half the batch in the
    loss) in the program's place, judged by the cell's own comparison and
    limits, comes out not correct."""
    from benchmark.control import serve_control

    res = serve_control(make_run(SERVE_WL), "fp8")
    assert res["correct"] is False and set(res["checks"]) == {"image_gap_mean", "image_gap_max"}
    res = training.control(make_run(TRAIN_WL, cfg=tiny_train_config()), ["fp8", "half_batch"])
    for numerics in ("fp8", "half_batch"):
        assert res[numerics]["correct"] is False, res[numerics]
        assert set(res[numerics]["checks"]) == set(TRAIN_WL["correct"]["limits"])
