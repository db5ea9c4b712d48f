#!/usr/bin/env python
"""Sustained training soak of the PyTorch port: the reference recipe through
`photoverse_tpu_torch.cli.train` for hundreds of optimizer steps, killed and
resumed. Counterpart of scripts/run_train_soak.py.

The recipe is scripts/prepare_dataset_and_train.sh's: `--recipe canonical`
with batch 16 (micro-batches of 8 x 2), LoRA 128/1/0.1, the ArcFace face
loss (random weights, `--allow_random_face_model`), lr 1e-5 (constant after
500 warm-up steps), random prompts, bf16, on CelebAMask-HQ prepared by
`cli.prepare_celebhqmasks` (`--img_subfolder images --mask_subfolder masks`
whenever the dataset has a masks/ folder). Random weights and synthetic
data: the run shows that the training loop holds, not model quality.

  phase A: train towards --steps with a sample grid and a checkpoint every
           --boundary steps; SIGTERM once metrics.jsonl reaches --kill_at,
           after which the CLI checkpoints at the next optimizer step and
           exits 0;
  phase B: a fresh process resumes with --resume_from from phase A's newest
           native checkpoint and finishes.

Without --sd/--ds it builds its own fixtures under --out: a model directory
and a synthetic archive laid out as the published CelebAMask-HQ (100
identities), both from scripts/torch_make_random_checkpoint.py (SD-1.5
width, or tiny with --tiny); the archive goes through
`cli.prepare_celebhqmasks` and the soak trains on its train split.

The record (--record, TRAIN_SOAK_torch.json at the repository's root by
default) keeps the JAX soak's fields (recipe, phaseA, phaseB,
sec_per_optimizer_step, imgs_per_sec, loss_trace, resume,
overhead_accounting with --bench_ref, ok) and adds step_time (each phase's
steady-state median and the spread), face_similarity_trace (every in-train
{step, face_similarity} row of both phases, with a least-squares slope; on
random weights it shows the trace exists, not that identity improves) and
device (the card's name and power limit).

    python3 scripts/torch_train_soak.py --steps 500 --kill_at 300
    python3 scripts/torch_train_soak.py --tiny --steps 4 --kill_at 2 --boundary 2 \\
        --micro_batch 2 --record "$TMPDIR"/soak.json      # CPU rehearsal

The orchestrator never touches the card: the model writer and both training
runs are child processes.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KILL_AT = 300  # SIGTERM once metrics.jsonl reaches this optimizer step
POLL_S = 1.0  # how often phase A's metrics file is read
ACCUM = 2  # micro-batches per optimizer step (batch 16 = 8 x 2)
LORA_RANK = 128  # scripts/prepare_dataset_and_train.sh


def note(msg):
    print(f"# {msg}", flush=True)


def build_fixtures(root: pathlib.Path, tiny: bool):
    """The model directory and the prepared, masked train split under
    `root` (each made once)."""
    sd = root / "sd"
    if not (sd / "unet").exists():
        scale = "tiny" if tiny else "sd15"
        note(f"writing a random {scale} model directory")
        shutil.rmtree(sd, ignore_errors=True)
        subprocess.run([sys.executable, os.path.join(REPO, "scripts", "torch_make_random_checkpoint.py"),
                        "--out", str(sd), "--scale", scale] + (["--cpu"] if tiny else []), check=True, cwd=REPO)
    celeba = root / "celeba"
    if not (celeba / "train" / "masks").exists():
        from photoverse_tpu_torch.cli import prepare_celebhqmasks
        from scripts.torch_make_random_checkpoint import ARCHIVE_IMAGES, write_celebahq_archive

        note(f"writing a synthetic CelebAMask-HQ archive ({ARCHIVE_IMAGES} identities) and preparing it")
        write_celebahq_archive(str(celeba), image_size=64 if tiny else 1024)

        prepare_celebhqmasks.main(["--save_path", str(celeba), "--num_of_samples", str(ARCHIVE_IMAGES)])
    return sd, celeba / "train"


def resolution(tiny: bool) -> int:
    return 32 if tiny else 512


def train_cmd(args, out_dir, resume_from=None):
    cmd = [
        sys.executable, "-m", "photoverse_tpu_torch.cli.train", "--recipe", "canonical",
        "--pretrained_model_name_or_path", str(args.sd),
        "--data_root_path", str(args.ds),
        "--output_dir", str(out_dir),
        "--resolution", str(resolution(args.tiny)),
        "--train_batch_size", str(args.micro_batch * ACCUM),
        "--max_microbatch_per_chip", str(args.micro_batch),
        "--max_train_steps", str(args.steps),
        "--checkpoint_save_steps", str(args.boundary),
        "--samples_save_steps", str(args.boundary),
        "--num_of_samples_to_save", "4",
        # scripts/prepare_dataset_and_train.sh
        "--use_lora", "--lora_rank", str(LORA_RANK), "--lora_alpha", "1", "--lora_dropout", "0.1",
        "--face_loss", "arcface", "--allow_random_face_model",
        "--learning_rate", "1e-5", "--lr_scheduler", "constant", "--lr_warmup_steps", "500",
        "--use_random_prompts", "--mixed_precision", "bf16",
        "--seed", "0", "--report_to", "none",
    ]
    if (pathlib.Path(args.ds) / "masks").is_dir():
        cmd += ["--img_subfolder", "images", "--mask_subfolder", "masks"]
    if args.tiny:
        cmd += ["--cpu"]
    if resume_from:
        cmd += ["--resume_from", str(resume_from)]
    return cmd


def read_metrics(path):
    """(optimizer-step rows, face_similarity rows) of a metrics.jsonl. A
    step row has loss_mle; a sample step also writes a {step,
    face_similarity} row without losses. A line that does not parse (the
    tail of a write cut by the kill) is skipped."""
    steps, faces = [], []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "loss_mle" in row:
                    steps.append(row)
                if "face_similarity" in row:
                    faces.append({"step": row["step"], "face_similarity": row["face_similarity"]})
    return steps, faces


def run_phase_a(args, out_dir):
    """Train until the metrics reach --kill_at, then SIGTERM; returns
    (step rows, face rows, rc, the step at which SIGTERM was sent)."""
    metrics = out_dir / "metrics.jsonl"
    with open(out_dir / "phaseA.log", "w") as log:
        proc = subprocess.Popen(train_cmd(args, out_dir), cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        killed_at = None
        deadline = time.time() + args.phase_timeout
        while proc.poll() is None and time.time() < deadline:
            rows, _ = read_metrics(metrics)
            if rows and rows[-1]["step"] >= args.kill_at and killed_at is None:
                killed_at = rows[-1]["step"]
                note(f"phase A reached step {killed_at} -> SIGTERM")
                proc.send_signal(signal.SIGTERM)
            time.sleep(POLL_S)
        rc = proc.poll()
        if rc is None:
            note("phase A timeout — killing hard")
            proc.kill()
            proc.wait()
            rc = -9
    rows, faces = read_metrics(metrics)
    return rows, faces, rc, killed_at


def newest_checkpoint(out_dir):
    cks = sorted(pathlib.Path(out_dir).glob("photoverse*.msgpack"), key=lambda p: p.stat().st_mtime)
    return cks[-1] if cks else None


def face_similarity_trace(faces_a, faces_b) -> dict:
    """Every in-train face_similarity row of both phases, with the
    least-squares line through (step, value) and the residuals' spread."""
    rows = [dict(r, phase="A") for r in faces_a] + [dict(r, phase="B") for r in faces_b]
    trace = {"rows": rows, "count": len(rows), "count_phaseA": len(faces_a), "count_phaseB": len(faces_b),
             "first": rows[0]["face_similarity"] if rows else None,
             "last": rows[-1]["face_similarity"] if rows else None,
             "slope_per_step": None, "residual_std": None}
    if len(rows) >= 2:
        x = np.asarray([r["step"] for r in rows], np.float64)
        y = np.asarray([r["face_similarity"] for r in rows], np.float64)
        slope, intercept = np.polyfit(x, y, 1)
        trace["slope_per_step"] = float(slope)
        trace["residual_std"] = float(np.std(y - (slope * x + intercept)))
    return trace


def analyse(rows_a, rows_b, faces_a, faces_b, killed_at, micro_batch, accum, bench_ref=None) -> dict:
    """The record's analysis of both phases' step and face rows."""
    all_rows = rows_a + rows_b
    losses = [r["loss_mle"] for r in all_rows]
    face_losses = [r.get("loss_face", 0.0) for r in all_rows]
    steps_a = [r["step"] for r in rows_a]
    steps_b = [r["step"] for r in rows_b]
    # steady state: each phase without its first (warm-up) step
    st_a = [r["step_time_s"] for r in rows_a[1:]]
    st_b = [r["step_time_s"] for r in rows_b[1:]]
    st = st_a + st_b
    med_t = float(np.median(st)) if st else None
    w = max(1, min(30, len(losses) // 3))
    first_mean = float(np.mean(losses[:w])) if losses else None
    last_mean = float(np.mean(losses[-w:])) if losses else None
    continuity = bool(steps_a and steps_b and steps_b[0] == steps_a[-1] + 1)
    merged = steps_a + steps_b
    no_gap_no_repeat = bool(merged) and merged == list(range(merged[0], merged[0] + len(merged)))
    out = {
        "steps_per_sec": 1.0 / med_t if med_t else None,
        "sec_per_optimizer_step": med_t,
        "imgs_per_sec": micro_batch * accum / med_t if med_t else None,
        "step_time": {
            "phaseA_median": float(np.median(st_a)) if st_a else None,
            "phaseB_median": float(np.median(st_b)) if st_b else None,
            "p10": float(np.percentile(st, 10)) if st else None,
            "p90": float(np.percentile(st, 90)) if st else None,
            "min": min(st) if st else None,
            "max": max(st) if st else None,
            "steady_steps": len(st),
        },
        "loss_trace": {
            "all_finite": bool(losses) and bool(np.all(np.isfinite(losses + face_losses))),
            "first_window_mean": first_mean,
            "last_window_mean": last_mean,
            "decreasing_ish": bool(losses) and bool(last_mean <= first_mean * 1.05),
            "face_loss_active": bool(np.any(np.asarray(face_losses) != 0.0)),
        },
        "resume": {
            "killed_at_step": killed_at,
            "checkpoint_step": steps_a[-1] if steps_a else None,
            "phaseB_first_step": steps_b[0] if steps_b else None,
            "resume_exact": continuity,
            "no_gap_no_repeat": no_gap_no_repeat,
        },
        "face_similarity_trace": face_similarity_trace(faces_a, faces_b),
        "total_steps": len(all_rows),
    }
    if bench_ref and med_t:
        # the soak's steady s/step against an isolated train-step time:
        # the difference is the loop's own cost (loading, metrics, boundaries)
        out["overhead_accounting"] = {
            "bench_sec_per_step": bench_ref,
            "soak_sec_per_step": med_t,
            "overhead_pct": 100.0 * (med_t / bench_ref - 1.0),
            "within_10pct": bool(med_t <= bench_ref * 1.10),
        }
    return out


def device_line(tiny: bool) -> str:
    """The card's `nvidia-smi --query-gpu=name,power.limit` line."""
    if tiny:
        return "cpu (--tiny)"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e!r})"
    return out.strip().splitlines()[0]


def _write(record, path):
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    print(json.dumps({"ok": record.get("ok")}))
    note(f"wrote {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="Working directory (fixtures and both runs); a temporary one, removed at the end, "
                         "when not given")
    ap.add_argument("--record", default=os.path.join(REPO, "TRAIN_SOAK_torch.json"))
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--micro_batch", type=int, default=8)
    ap.add_argument("--kill_at", type=int, default=KILL_AT)
    ap.add_argument("--boundary", type=int, default=100, help="Checkpoint and sample-grid step interval")
    ap.add_argument("--bench_ref", type=float, default=None,
                    help="An isolated s per optimizer step of the same recipe; records the overhead against it")
    ap.add_argument("--phase_timeout", type=int, default=3600)
    ap.add_argument("--tiny", action="store_true",
                    help="CPU rehearsal: a tiny model directory, small images, --cpu")
    ap.add_argument("--sd", default=None, help="An existing model directory (with --ds: no fixtures are built)")
    ap.add_argument("--ds", default=None, help="An existing dataset directory (images/, optionally masks/)")
    args = ap.parse_args(argv)

    root = pathlib.Path(args.out or tempfile.mkdtemp(prefix="torch_soak_"))
    try:
        root.mkdir(parents=True, exist_ok=True)
        return _soak(args, root)
    finally:
        if args.out is None:
            shutil.rmtree(root, ignore_errors=True)


def _soak(args, root: pathlib.Path) -> int:
    if args.sd and args.ds:
        args.sd, args.ds = pathlib.Path(args.sd), pathlib.Path(args.ds)
    else:
        args.sd, args.ds = build_fixtures(root, args.tiny)
    run_a, run_b = root / "runA", root / "runB"
    run_a.mkdir(exist_ok=True)
    run_b.mkdir(exist_ok=True)

    record = {
        "recipe": {
            "effective_batch": args.micro_batch * ACCUM,
            "micro_batch": args.micro_batch,
            "grad_accum": ACCUM,
            "lora_rank": LORA_RANK,
            "face_loss": "arcface (random weights)",
            "resolution": resolution(args.tiny),
            "target_steps": args.steps,
            "kill_at_step": args.kill_at,
            "boundary": args.boundary,
            "mixed_precision": "bf16",
            "fuse_face_accum": True,
            "masked_data": (args.ds / "masks").is_dir(),
            "command": " ".join(train_cmd(args, "<out>")[1:]),
        },
        "device": device_line(args.tiny),
    }

    t0 = time.time()
    rows_a, faces_a, rc_a, killed_at = run_phase_a(args, run_a)
    ck = newest_checkpoint(run_a)
    record["phaseA"] = {
        "rc": rc_a,
        "killed_at_step": killed_at,
        "steps_logged": len(rows_a),
        "last_step": rows_a[-1]["step"] if rows_a else None,
        "wall_s": time.time() - t0,
        "checkpoint": ck.name if ck else None,
    }
    if not rows_a or ck is None:
        record["ok"] = False
        _write(record, args.record)
        return 1

    t1 = time.time()
    try:
        with open(run_b / "phaseB.log", "w") as log:
            rc_b = subprocess.call(train_cmd(args, run_b, resume_from=ck), cwd=REPO, stdout=log,
                                   stderr=subprocess.STDOUT, timeout=args.phase_timeout)
    except subprocess.TimeoutExpired:
        note("phase B timeout — recording ok=false")
        record["phaseB"] = {"rc": "timeout", "wall_s": time.time() - t1}
        record["ok"] = False
        _write(record, args.record)
        return 1
    rows_b, faces_b = read_metrics(run_b / "metrics.jsonl")
    record["phaseB"] = {
        "rc": rc_b,
        "steps_logged": len(rows_b),
        "first_step": rows_b[0]["step"] if rows_b else None,
        "last_step": rows_b[-1]["step"] if rows_b else None,
        "wall_s": time.time() - t1,
    }

    record.update(analyse(rows_a, rows_b, faces_a, faces_b, killed_at, args.micro_batch, ACCUM, args.bench_ref))
    sample_grids = sorted(run_a.glob("0*.jpg")) + sorted(run_b.glob("0*.jpg"))
    final_ck = newest_checkpoint(run_b)
    record["sample_grids"] = [f"{p.parent.name}/{p.name}" for p in sample_grids]
    record["final_checkpoint"] = final_ck.name if final_ck else None
    trace = record["face_similarity_trace"]
    record["ok"] = bool(
        rc_a == 0 and rc_b == 0
        and record["loss_trace"]["all_finite"]
        and record["resume"]["resume_exact"]
        and record["resume"]["no_gap_no_repeat"]
        and record["total_steps"] >= args.steps
        and sample_grids
        and final_ck is not None
        and trace["count_phaseA"] > 0 and trace["count_phaseB"] > 0
    )
    _write(record, args.record)
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
