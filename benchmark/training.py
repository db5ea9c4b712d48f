"""Training cells: the recipe's optimizer steps, driven through the same
per-micro-step calls as the train CLI's loop (`cli/train.py:_train`):
`BatchLoader` over `CustomDatasetWithMasks`, `host_batch` with the face
rows, `make_draws`, and `TrainStep` (the face step on each window's last
micro-step, the diffusion-only step otherwise), with checkpoints and
sample grids left out.

Set-up writes a masked CelebAMask-HQ-layout set from the seed under
TMPDIR (1024 px JPEG photos, 512 px masks) and a synthetic BPE
vocabulary, builds the models and ArcFace with the benchmark's weights,
and runs the recipe's first optimizer steps: they warm every shape and are
the steps the reference follows from the seed once the window has closed.
Their host batches are held to the reference's own build of the written
files (benchmark/reference/data_ref.py).
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import tempfile
import time
from typing import Dict, List

import numpy as np

from benchmark import harness
from benchmark.models import DTYPES, latent_size, program_models, ref_cfg
from benchmark.reference import data_ref
from benchmark.serving import Context, face_crop
from benchmark.weights import load_into, make_weights, named_params

__all__ = ["TrainCell", "run_cell", "control", "write_dataset", "write_tokenizer", "trainable_keys"]

CHECKED_STEPS = 3


def _face(rng: np.random.Generator, size: int, mask_size: int):
    """(photo (size, size, 3) uint8, face mask (mask_size, mask_size) uint8
    0/255): a face-like crop drawn at 1/8 scale and brought up bicubically."""
    from PIL import Image

    small = face_crop(rng, size // 8)
    photo = np.asarray(Image.fromarray(small).resize((size, size), Image.BICUBIC))
    yy, xx = np.mgrid[0:mask_size, 0:mask_size] / mask_size
    cy, cx = rng.uniform(0.42, 0.58), rng.uniform(0.42, 0.58)
    ry, rx = rng.uniform(0.25, 0.35), rng.uniform(0.18, 0.28)
    mask = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0).astype(np.uint8) * 255
    return photo, mask


def write_dataset(root: str, spec: Dict, seed: int) -> str:
    """`root/images/{k}.jpg` and `root/masks/{k}.png` for each identity."""
    from PIL import Image

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "masks"), exist_ok=True)
    rng = np.random.default_rng([seed % (1 << 63), 23])
    for k in range(spec["identities"]):
        photo, mask = _face(rng, spec["image_size"], spec["mask_size"])
        Image.fromarray(photo).save(os.path.join(root, "images", f"{k}.jpg"), quality=90)
        Image.fromarray(mask, mode="L").save(os.path.join(root, "masks", f"{k}.png"))
    return root


def _bpe(word: str, ranks: Dict[tuple, int]) -> List[str]:
    """CLIP's byte-pair encoding of one lower-case word."""
    parts = list(word[:-1]) + [word[-1] + "</w>"]
    while len(parts) > 1:
        pairs = [(ranks.get((a, b), math.inf), i) for i, (a, b) in enumerate(zip(parts, parts[1:]))]
        rank, _ = min(pairs)
        if rank == math.inf:
            break
        first, second = next((parts[i], parts[i + 1]) for r, i in pairs if r == rank)
        out, i = [], 0
        while i < len(parts):
            if i < len(parts) - 1 and (parts[i], parts[i + 1]) == (first, second):
                out.append(first + second)
                i += 2
            else:
                out.append(parts[i])
                i += 1
        parts = out
    return parts


def write_tokenizer(root: str, max_length: int) -> str:
    """A synthetic CLIP BPE vocabulary in `root/tokenizer`: letters and their
    word-final forms, every word of the prompt templates as one token (as
    CLIP's vocabulary holds them), the placeholder `*`, BOS, EOS last.
    Each word that the merges so far split gets merges that join its
    pieces left to right, until every word is one token."""
    vocab = {}
    for c in "abcdefghijklmnopqrstuvwxyz":
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    merges: List[tuple] = []
    words = sorted({w for t in data_ref.TEMPLATES for w in re.findall(r"[a-z]+", t)})
    while True:
        ranks = {m: i for i, m in enumerate(merges)}
        split = [(w, _bpe(w, ranks)) for w in words]
        split = [(w, p) for w, p in split if len(p) > 1]
        if not split:
            break
        for _, parts in split:
            head = parts[0]
            for part in parts[1:]:
                if (head, part) not in merges:
                    merges.append((head, part))
                head += part
                vocab.setdefault(head, len(vocab))
    vocab["*</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    d = os.path.join(root, "tokenizer")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"model_max_length": max_length}, f)
    return root


def trainable_keys(weights: Dict) -> List[str]:
    """The recipe's trainables by the reference's own rule: both adapters,
    the UNet's identity projections and LoRA factors."""
    leaves = ("to_k_ip", "to_v_ip", "lora_A", "lora_B")
    return sorted(k for k in weights if k.startswith(("text_adapter.", "image_adapter."))
                  or (k.startswith("unet.") and any(part in leaves for part in k.split("."))))


class TrainCell:
    """The recipe's training loop on the program (`program=True`), or its
    feed alone (the loader and host batches, for the control)."""

    def __init__(self, run, program: bool = True):
        import torch

        from photoverse_tpu_torch.cli.train import face_rows, host_batch
        from photoverse_tpu_torch.data.dataset import BatchLoader, CustomDatasetWithMasks
        from photoverse_tpu_torch.data.tokenizer import CLIPTokenizer

        self.run, self.torch = run, torch
        cfg, hp = run.config, run.config["recipe"]
        self.hp = hp
        dev = run.device
        self.host_batch = host_batch
        self.tmp = tempfile.mkdtemp(prefix="photoverse_bench_")
        with run.spans.span("write data"):
            write_dataset(self.tmp, cfg["dataset"], run.seed)
            write_tokenizer(self.tmp, cfg["text_encoder"]["max_position_embeddings"])
            self.tokenizer = CLIPTokenizer.from_pretrained(self.tmp)
        s32 = run.seed % (2 ** 32 - 2)
        self.dataset = CustomDatasetWithMasks(
            self.tmp, self.tokenizer, mask_subfolder="masks", img_subfolder="images", size=cfg["resolution"],
            use_random_templates=hp["use_random_prompts"], seed=s32,
            clip_size=cfg["vision_encoder"]["image_size"], uint8_pixels=hp["uint8_transfer"])
        self.loader = BatchLoader(self.dataset, hp["micro_batch"], shuffle=True, seed=s32,
                                  num_workers=hp["loader_workers"])
        self.face_rng = np.random.RandomState(s32 + 1)
        self.n_face = face_rows(hp["face_loss_sample_ratio"], hp["micro_batch"], hp["accumulation"], True)
        if self.n_face != hp["face_rows"]:
            raise ValueError(f"the recipe's face rows are {self.n_face}, the configuration says {hp['face_rows']}")
        self.it = None
        self.micro_n = 0
        self.latent = latent_size(cfg)
        self.generator = torch.Generator(device=dev).manual_seed(run.seed % (1 << 63))
        self.weights = self.face_weights = None
        if program:
            self._build_program()

    def _build_program(self):
        torch, run, cfg, hp = self.torch, self.run, self.run.config, self.hp
        from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
        from photoverse_tpu_torch.engine.training import TrainConfig, TrainStep, init_train_state
        from photoverse_tpu_torch.models.arcface import ArcFaceConfig, ArcFaceResNet18
        from photoverse_tpu_torch.models.face_loss import FaceLoss, make_face_loss_fn

        dev = run.device
        f = cfg["face_model"]
        with run.spans.span("build models"):
            self.models = program_models(cfg, dev, train=True, kernels=dev.type == "cuda")
            self.weights = make_weights(named_params(self.models), run.seed, dev, DTYPES[cfg["precision"]])
            load_into(self.models, self.weights)
            face_net = ArcFaceResNet18(ArcFaceConfig(layers=tuple(f["layers"]), channels=tuple(f["channels"]),
                                                     embedding_dim=f["embedding_dim"], input_size=f["input_size"]),
                                       device="meta").to_empty(device=dev)
            self.face_weights = make_weights(named_params(face_net, "arcface."), run.seed + 1, dev, torch.float32)
            load_into(face_net, self.face_weights, "arcface.")
        loss = FaceLoss(face_net.eval().requires_grad_(False))
        tcfg = TrainConfig(
            learning_rate=hp["learning_rate"], adam_beta1=hp["adam_beta1"], adam_beta2=hp["adam_beta2"],
            adam_weight_decay=hp["adam_weight_decay"], adam_epsilon=hp["adam_epsilon"],
            lr_scheduler=hp["lr_scheduler"], lr_warmup_steps=hp["lr_warmup_steps"],
            max_train_steps=hp["max_train_steps"], gradient_accumulation_steps=hp["accumulation"],
            max_grad_norm=hp["max_grad_norm"], concept_reg_weight=hp["concept_reg_weight"],
            visual_reg_weight=hp["visual_reg_weight"], face_loss_weight=hp["face_loss_weight"],
            face_loss_timesteps=hp["face_steps"], face_loss_guidance=hp["face_guidance"])
        self.trainable, _, self.optimizer = init_train_state(self.models, tcfg)
        solver = DPMSolverMultistep.create(self.models.schedule, hp["face_steps"])
        self.step_face = TrainStep(self.models, tcfg, self.optimizer, make_face_loss_fn(loss), solver,
                                   face_weight_scale=float(hp["accumulation"]))
        self.step_plain = TrainStep(self.models, tcfg, self.optimizer)
        self.n_cross = len(self.models.unet.cross_attentions())

    def next_batch(self):
        while True:
            if self.it is None:
                self.it = iter(self.loader)
            try:
                return next(self.it)
            except StopIteration:
                self.it = None

    def feed(self, final: bool):
        """(host batch, seconds waited for the loader) of one micro-step."""
        spans = self.run.spans
        t = time.perf_counter()
        with spans.span("next(loader)"):
            batch = self.next_batch()
        wait = time.perf_counter() - t
        with spans.span("host_batch"):
            hb = self.host_batch(batch, self.tokenizer, self.n_face if final else 0, self.face_rng)
        return hb, wait

    def optimizer_step(self):
        """One optimizer step, its micro-steps as the train CLI makes them;
        returns (reported losses, host batches, loader wait)."""
        from photoverse_tpu_torch.engine.training import make_draws

        spans, accum = self.run.spans, self.hp["accumulation"]
        metrics, hbs, wait = [], [], 0.0
        for j in range(accum):
            final = j == accum - 1
            hb, w = self.feed(final)
            wait += w
            with spans.span("make_draws"):
                draws = make_draws(self.generator, self.hp["micro_batch"], self.latent, self.n_cross,
                                   face_rows=self.n_face if final else 0,
                                   in_channels=self.run.config["unet"]["in_channels"])
            with spans.span("face micro-step" if final else "diffusion micro-step"):
                metrics.append((self.step_face if final else self.step_plain)(hb, draws))
            hbs.append(hb)
        with spans.span("loss to host"):
            losses = [float(m["loss"]) for m in metrics]
        return losses, hbs, wait

    def free_program(self):
        torch = self.torch
        for p in self.models.parameters():
            p.data = torch.empty(0, device=p.device, dtype=p.dtype)
        self.optimizer.adamw.state.clear()
        self.optimizer.acc.clear()
        self.trainable = {}
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
            torch.cuda.empty_cache()

    def close(self):
        shutil.rmtree(self.tmp, ignore_errors=True)


def _rel_gaps(prog: Dict, ref: Dict, keep=None) -> float:
    """The worst leaf's |norm(prog) - norm(ref)| over the larger of its
    reference norm and the median leaf's reference norm."""
    keys = [k for k in ref if keep is None or k in keep]
    pn = {k: float(prog[k].double().norm()) for k in keys}
    rn = {k: float(ref[k].double().norm()) for k in keys}
    med = statistics.median(rn.values())
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def compare(prog: Dict, ref: Dict, limits: Dict) -> Dict[str, dict]:
    """The worst micro-step's relative loss gap, the worst leaf's gap of the
    first step's gradient norms, and of the masters' change over the
    checked steps (leaves whose reference gradient is under 1e-3 of the
    median leaf's left out), each beside its limit."""
    med = statistics.median(float(g.double().norm()) for g in ref["grad1"].values())
    moving = {k for k, g in ref["grad1"].items() if float(g.double().norm()) >= 1e-3 * med}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    d_prog = {k: prog["end"][k] - prog["start"][k] for k in moving}
    d_ref = {k: ref["end"][k] - ref["start"][k] for k in moving}
    values = {"loss_gap": loss_gap, "grad_gap": _rel_gaps(prog["grad1"], ref["grad1"]),
              "update_gap": _rel_gaps(d_prog, d_ref)}
    # a number without a limit is read, not compared (loss_gap: neither the
    # control nor a fault reads three times the program's readings)
    print(f"[bench] readings: {values}", flush=True)
    return {k: {"value": v, "limit": limits[k], "rule": "<="} for k, v in values.items() if k in limits}


def follow(cell: TrainCell, weights: Dict, hbs: List[Dict], numerics: str = "f32", half_batch: bool = False):
    """The reference over the checked steps' host batches, from the run's
    seed."""
    import torch

    from benchmark.reference import train_ref

    run = cell.run
    rc = ref_cfg(run.config)
    gen = torch.Generator(device=run.device).manual_seed(run.seed % (1 << 63))
    return train_ref.train(weights, rc, cell.hp, trainable_keys(weights), hbs, gen, run.device, numerics,
                           half_batch)


def run_cell(run) -> tuple:
    import torch

    from benchmark import flops
    from benchmark.trace import Profile

    cell = TrainCell(run)
    hp = cell.hp
    try:
        with run.spans.span("checked steps"):
            start = {k: p.detach().clone() for k, p in cell.trainable.items()}
            losses, hbs = [], []
            grad1 = None
            for s in range(CHECKED_STEPS):
                l, h, _ = cell.optimizer_step()
                losses += l
                hbs += h
                if s == 0:  # AdamW's first moment after one step is (1 - beta1) x the gradient
                    st = cell.optimizer.adamw.state
                    grad1 = {k: st.get(cell.optimizer.adam_param(k), {}).get("exp_avg", torch.zeros_like(p))
                             / (1 - hp["adam_beta1"]) for k, p in cell.trainable.items()}
            prog = {"losses": losses, "grad1": {k: g.clone() for k, g in grad1.items()}, "start": start,
                    "end": {k: p.detach().clone() for k, p in cell.trainable.items()}}
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        prof = Profile(run.device) if run.trace else None
        t0 = prof.start() if prof else time.perf_counter()
        setup_s = t0 - run.t_start
        steps, waits = [], []
        while True:
            a = time.perf_counter()
            _, _, w = cell.optimizer_step()
            b = time.perf_counter()
            steps.append((a, b, 1.0))
            waits.append(w)
            if b >= t0 + run.seconds:
                break
        t1 = t0 + run.seconds
        trace = prof.stop() if prof else None
        per_step = hp["micro_batch"] * hp["accumulation"]
        done = harness.prorated(steps, t0, t1)
        e2e = {"setup_s": setup_s, "train_images_per_s": per_step * done / run.seconds}
        print(f"[bench] window: {len(steps)} optimizer steps, {done:.3f} inside; end to end: {e2e}", flush=True)
        ctx = Context(run=run, t0=t0, t1=t1, trace=trace, work_flops=done * flops.train_step(run.config),
                      loader_waits=waits, spans=run.spans)
        ctx.e2e = e2e
        device = harness.device_info(run, trace, (t0, t1))
        result = {"correct": False, "attempted": len(steps), "failed": 0,
                  "metrics": harness.metric_values(run, ctx), "device": device}
        if trace is not None:
            result["breakdown"] = {"device_ops": trace.top_ops(t0, t1),
                                   "idle_gaps": trace.idle_gaps(t0, t1, run.spans.label)}
        cell.free_program()
        with run.spans.span("check"):
            ref = follow(cell, {**cell.weights, **cell.face_weights}, hbs)
            checks = compare(prog, ref, run.workload["correct"]["limits"])
            feed = data_ref.Feed(cell.tmp, run.config["resolution"], run.config["vision_encoder"]["image_size"])
            checks["data_rows_matched"] = {"value": feed.rows_matched(hbs), "limit": 1.0, "rule": ">="}
        from benchmark.serving import passed

        result["correct"] = passed(checks)
        return result, checks
    finally:
        cell.close()


def control(run, numerics: List[str]) -> Dict[str, dict]:
    """For each of `numerics` ("fp8", or "half_batch": the diffusion loss's
    mean over half the rows), the reference so computed in the program's
    place over the checked steps' batches of the seed's feed, judged
    against the f32 reference by the cell's own comparison and limits:
    {numerics: {correct, checks}}, and `reference_s`."""
    import torch

    from benchmark.models import program_models as pm
    from benchmark.serving import passed

    cell = TrainCell(run, program=False)
    try:
        hbs = []
        for s in range(CHECKED_STEPS):
            for j in range(cell.hp["accumulation"]):
                hbs.append(cell.feed(j == cell.hp["accumulation"] - 1)[0])
        cfg, dev = run.config, run.device
        from photoverse_tpu_torch.models.arcface import ArcFaceConfig, ArcFaceResNet18

        f = cfg["face_model"]
        weights = make_weights(named_params(pm(cfg, "meta", train=True)), run.seed, dev, DTYPES[cfg["precision"]])
        face = ArcFaceResNet18(ArcFaceConfig(layers=tuple(f["layers"]), channels=tuple(f["channels"]),
                                             embedding_dim=f["embedding_dim"], input_size=f["input_size"]),
                               device="meta")
        weights.update(make_weights(named_params(face, "arcface."), run.seed + 1, dev, torch.float32))
        t = time.perf_counter()
        ref = follow(cell, weights, hbs)
        out = {"reference_s": time.perf_counter() - t}
        for n in numerics:
            low = follow(cell, weights, hbs, "f32" if n == "half_batch" else n, half_batch=n == "half_batch")
            checks = compare(low, ref, run.workload["correct"]["limits"])
            out[n] = {"correct": passed(checks), "checks": checks}
        return out
    finally:
        cell.close()
