"""The port's train soak (scripts/torch_train_soak.py): its reading of
metrics.jsonl and the record's analysis on synthetic files (a partial last
line, face_similarity rows without losses, a gap, a repeat), the training
command it runs, and one whole --tiny rehearsal on the CPU (a tiny model
directory, a synthetic CelebAMask-HQ archive prepared by the port's CLI,
phase A killed at step 2, phase B resumed to step 4; marked slow).
"""

import json
import types

import numpy as np
import pytest

from scripts import torch_train_soak as soak
from tests.torch_threads import worker_threads  # noqa: F401


def _write(path, rows, tail=""):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write(tail)


def _step(step, t=2.0, loss=0.5, face=0.1):
    return {"step": step, "time": 1e9 + step, "loss_mle": loss, "loss_face": face, "step_time_s": t,
            "imgs_per_sec": 16 / t}


def test_read_metrics_keeps_face_rows_and_skips_a_partial_line(tmp_path):
    path = tmp_path / "metrics.jsonl"
    _write(path, [_step(1), _step(2), {"step": 2, "time": 1e9, "face_similarity": 0.25}, _step(3)],
           tail='{"step": 4, "loss_m')
    steps, faces = soak.read_metrics(path)
    assert [r["step"] for r in steps] == [1, 2, 3]
    assert faces == [{"step": 2, "face_similarity": 0.25}]
    assert soak.read_metrics(tmp_path / "none.jsonl") == ([], [])


def test_analysis_of_a_clean_resume():
    a = [_step(s, t=2.0 + 0.01 * s, loss=1.0 - 0.001 * s) for s in range(1, 302)]
    b = [_step(s, t=3.0, loss=0.6) for s in range(302, 501)]
    faces_a = [{"step": s, "face_similarity": 0.1 + 0.001 * s} for s in (100, 200, 300)]
    faces_b = [{"step": s, "face_similarity": 0.1 + 0.001 * s} for s in (400, 500)]
    rec = soak.analyse(a, b, faces_a, faces_b, killed_at=300, micro_batch=8, accum=2, bench_ref=2.5)
    assert rec["resume"] == {"killed_at_step": 300, "checkpoint_step": 301, "phaseB_first_step": 302,
                             "resume_exact": True, "no_gap_no_repeat": True}
    assert rec["total_steps"] == 500
    st = [r["step_time_s"] for r in a[1:] + b[1:]]
    assert rec["sec_per_optimizer_step"] == pytest.approx(np.median(st))
    assert rec["imgs_per_sec"] == pytest.approx(16 / np.median(st))
    assert rec["step_time"]["phaseA_median"] == pytest.approx(np.median([r["step_time_s"] for r in a[1:]]))
    assert rec["step_time"]["phaseB_median"] == 3.0 and rec["step_time"]["steady_steps"] == 498
    assert rec["loss_trace"]["all_finite"] and rec["loss_trace"]["decreasing_ish"]
    assert rec["loss_trace"]["face_loss_active"]
    trace = rec["face_similarity_trace"]
    assert (trace["count"], trace["count_phaseA"], trace["count_phaseB"]) == (5, 3, 2)
    assert [r["phase"] for r in trace["rows"]] == ["A", "A", "A", "B", "B"]
    assert trace["first"] == pytest.approx(0.2) and trace["last"] == pytest.approx(0.6)
    assert trace["slope_per_step"] == pytest.approx(0.001) and trace["residual_std"] == pytest.approx(0, abs=1e-9)
    over = rec["overhead_accounting"]
    assert over["bench_sec_per_step"] == 2.5 and not over["within_10pct"]


@pytest.mark.parametrize("fault", ["gap", "repeat", "nan"])
def test_analysis_catches_a_gap_a_repeat_and_a_nan(fault):
    a = [_step(s) for s in range(1, 4)]
    b = [_step(s) for s in range(4, 7)]
    if fault == "gap":  # phase B resumed one step late
        b = [_step(s) for s in range(5, 8)]
    elif fault == "repeat":  # phase B resumed from an older checkpoint
        b = [_step(s) for s in range(3, 7)]
    else:
        b[1]["loss_face"] = float("nan")
    rec = soak.analyse(a, b, [], [], killed_at=2, micro_batch=8, accum=2)
    if fault == "nan":
        assert not rec["loss_trace"]["all_finite"] and rec["resume"]["no_gap_no_repeat"]
    else:
        assert not rec["resume"]["resume_exact"] and not rec["resume"]["no_gap_no_repeat"]
    assert "overhead_accounting" not in rec
    assert rec["face_similarity_trace"]["count"] == 0 and rec["face_similarity_trace"]["slope_per_step"] is None


def test_training_command_is_the_reference_recipe(tmp_path):
    ds = tmp_path / "train"
    (ds / "images").mkdir(parents=True)
    args = types.SimpleNamespace(sd="sd", ds=ds, micro_batch=8, steps=500, boundary=100, tiny=False)
    cmd = soak.train_cmd(args, "out")
    flags = " ".join(cmd[1:])
    for want in ("-m photoverse_tpu_torch.cli.train --recipe canonical", "--resolution 512", "--train_batch_size 16",
                 "--max_microbatch_per_chip 8", "--lora_rank 128 --lora_alpha 1 --lora_dropout 0.1",
                 "--face_loss arcface --allow_random_face_model", "--learning_rate 1e-5",
                 "--lr_scheduler constant --lr_warmup_steps 500", "--use_random_prompts", "--mixed_precision bf16"):
        assert want in flags, want
    assert "--mask_subfolder" not in cmd and "--cpu" not in cmd and "--resume_from" not in cmd
    (ds / "masks").mkdir()
    args.tiny = True
    cmd = soak.train_cmd(args, "out", resume_from="ck.msgpack")
    assert " ".join(cmd).endswith("--img_subfolder images --mask_subfolder masks --cpu --resume_from ck.msgpack")
    assert "--resolution 32" in " ".join(cmd)


# 25 s alone on 8 cores, but its two CLI processes take every core: beside
# the suite's other workers it took 239 s, so it is not in the fast tier
@pytest.mark.slow
def test_tiny_soak_rehearsal(tmp_path):
    record = tmp_path / "record.json"
    # no --out: the fixtures and the runs' checkpoints (over 1 GB) go to a
    # temporary directory that the script removes
    rc = soak.main(["--tiny", "--steps", "4", "--kill_at", "2", "--boundary", "2", "--micro_batch", "2",
                    "--record", str(record)])
    rec = json.loads(record.read_text())
    assert rc == 0 and rec["ok"], rec
    assert rec["recipe"]["masked_data"] and rec["device"] == "cpu (--tiny)"
    assert rec["phaseA"]["killed_at_step"] == 2 and rec["phaseA"]["rc"] == 0 and rec["phaseB"]["rc"] == 0
    assert rec["resume"]["resume_exact"] and rec["resume"]["no_gap_no_repeat"] and rec["total_steps"] == 4
    trace = rec["face_similarity_trace"]
    assert trace["count_phaseA"] >= 1 and trace["count_phaseB"] >= 1
    assert all(np.isfinite(r["face_similarity"]) for r in trace["rows"])
    assert rec["sample_grids"] and rec["final_checkpoint"] == "photoverse.msgpack"
