"""Training CLI of the PyTorch port: the flags of photoverse_tpu/cli/train.py,
on one GPU or several ranks (or the CPU with --cpu).

Usage:
  python -m photoverse_tpu_torch.cli.train --recipe canonical \\
      --pretrained_model_name_or_path /path/to/sd15 --data_root_path data \\
      --face_model_weights arcface.pt --output_dir results
  python -m torch.distributed.run --nproc_per_node N -m photoverse_tpu_torch.cli.train ... \\
      [--tensor_parallel M] [--fsdp | --shard_optimizer_state]

Several ranks (parallel/training.py): the launcher's ranks form a
(N / M data) x (M model) mesh. Each data rank loads its rows of every
micro-batch (the loader's host_slice; its template stream keyed on the
data rank, so the model ranks of one data rank see the same batch) and its
face sub-batch from them, and makes the whole micro-batch's draws from the
one shared generator, keeping its rows; gradients are averaged over the
data ranks once per window; --tensor_parallel M shards the UNet's
attention and feed-forward over M ranks (flash through the sharded
wrapper: kernels 2 and 3 on each rank's heads); --fsdp keeps each rank's
shard of every large parameter (ZeRO-3), --shard_optimizer_state each
rank's slice of the AdamW state (ZeRO-1). Checkpoints gather on every rank
and rank 0 writes the files one process writes; metrics.jsonl, the sample
grids and the profile are rank 0's. SIGTERM: every rank stops at the same
optimizer step (the flag is combined over the ranks at each step). With
one rank --fsdp and --shard_optimizer_state change nothing, as in the JAX
CLI. Refused before any group opens: --tensor_parallel that does not
divide the ranks (a one-process run included: the JAX CLI shrinks its
device mesh, but a rank here is a process that must take part) and a
micro-batch that the data ranks do not divide.

The flow of the JAX CLI: the train batch split into
accumulation micro-steps when it exceeds --max_microbatch_per_chip, remat,
the face loss (ArcFace or FaceNet), the fused face-accumulation window (the face
branch on each window's last micro-step, wider and weighted, through a
second TrainStep that shares the Optimizer), uint8 pixel transfer, resume
from a native checkpoint (its random draws reseeded with seed + step and
the loader restarted at epoch 0, as the JAX CLI does), native / .pt
checkpoints (optionally on a background writer), a checkpoint at the next
optimizer-step boundary on SIGTERM or SIGINT, sample grids with the
in-train face_similarity metric, and a torch.profiler window.

Refused with a message, never ignored: --push_to_hub (needs the network)
and --mixed_precision fp16 (the JAX CLI refuses it too).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import signal
import time
from typing import Dict, Optional, Tuple

import numpy as np

from photoverse_tpu_torch.utils import trace

# --recipe presets, applied as argparse defaults (explicit flags still win):
# the JAX package's canonical recipe
RECIPE_PRESETS = {
    "canonical": dict(
        mixed_precision="bf16",
        flash_attention=True,
        remat=True,
        use_lora=True,
        lora_rank=128,
        lora_alpha=1.0,
        lora_dropout=0.1,
        learning_rate=1e-5,
        lr_scheduler="constant",
        lr_warmup_steps=500,
        train_batch_size=16,
        max_train_steps=40000,
        auto_grad_accum=True,
        face_loss="arcface",
        fuse_face_accum=True,
        async_checkpointing=True,
        use_random_prompts=True,
        uint8_transfer=True,
    ),
}

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PhotoVerse training (PyTorch port)")
    p.add_argument("--recipe", type=str, default=None, choices=sorted(RECIPE_PRESETS),
                   help="Apply a preset as flag defaults (explicit flags still override; preset "
                        "booleans are disabled with their --no-* forms)")
    p.add_argument("--pretrained_model_name_or_path", type=str, default="runwayml/stable-diffusion-v1-5",
                   help="Local diffusers-layout SD checkpoint directory")
    p.add_argument("--pretrained_photoverse_path", type=str, default=None)
    p.add_argument("--data_root_path", type=str, required=True)
    p.add_argument("--img_subfolder", type=str, default="images")
    p.add_argument("--mask_subfolder", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="results")
    p.add_argument("--logging_dir", type=str, default="logs")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--num_train_epochs", type=int, default=100)
    p.add_argument("--max_train_steps", type=int, default=5000)
    p.add_argument("--train_batch_size", type=int, default=4)
    p.add_argument("--dataloader_num_workers", type=int, default=4)
    p.add_argument("--checkpoint_save_steps", type=int, default=2000)
    p.add_argument("--samples_save_steps", type=int, default=500)
    p.add_argument("--mixed_precision", type=str, default=None, choices=["no", "fp16", "bf16"])
    p.add_argument("--report_to", type=str, default="tensorboard")
    p.add_argument("--local_rank", type=int, default=-1)
    p.add_argument("--extra_num_tokens", type=int, default=4)
    p.add_argument("--image_encoder_layers_idx", nargs="+", type=int, default=[4, 8, 12, 16])
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--auto_grad_accum", action=argparse.BooleanOptionalAction, default=False,
                   help="Split the train batch into accumulation micro-steps when it exceeds "
                        "--max_microbatch_per_chip")
    p.add_argument("--max_microbatch_per_chip", type=int, default=8)
    p.add_argument("--lr_scheduler", type=str, default="constant")
    p.add_argument("--denoise_timesteps", type=int, default=10)
    p.add_argument("--guidance_scale", type=float, default=2.0)
    p.add_argument("--num_of_samples_to_save", type=int, default=4)
    p.add_argument("--save_samples_with_various_prompts", action="store_true")
    p.add_argument("--use_random_prompts", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--push_to_hub", action="store_true", help="Not ported (needs the network); refused")
    p.add_argument("--hub_token", type=str, default=None)
    p.add_argument("--hub_model_id", type=str, default=None)
    p.add_argument("--face_loss", type=str, default=None, choices=["arcface", "facenet"])
    p.add_argument("--face_model_weights", type=str, default=None,
                   help="Pretrained ArcFace .pt weights (reference ResNetFace state dict)")
    p.add_argument("--allow_random_face_model", action="store_true",
                   help="Run --face_loss with random embedder weights (testing only)")
    p.add_argument("--face_loss_sample_ratio", type=float, default=0.25)
    p.add_argument("--fuse_face_accum", action=argparse.BooleanOptionalAction, default=False,
                   help="With gradient accumulation, run the face branch only on the last "
                        "micro-step of each window, on an accum-x wider sub-batch at accum-x weight")
    p.add_argument("--use_lora", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--lora_alpha", type=float, default=1)
    p.add_argument("--lora_dropout", type=float, default=0.1)
    p.add_argument("--lora_rank", type=int, default=8)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--cpu", action="store_true", help="Run on the CPU (the default is the GPU)")
    p.add_argument("--native_loader", action="store_true",
                   help="Decode and resize with the C++ batch loader (native/dataloader.cc)")
    p.add_argument("--uint8_transfer", action=argparse.BooleanOptionalAction, default=False,
                   help="Ship uint8 crops to the device and normalize there (not with --native_loader)")
    p.add_argument("--resume_from", type=str, default=None,
                   help="Native .msgpack checkpoint to resume from (weights, optimizer state, step)")
    p.add_argument("--checkpoint_format", type=str, default="native", choices=["native", "pt", "both"])
    p.add_argument("--async_checkpointing", action=argparse.BooleanOptionalAction, default=False,
                   help="Write checkpoints on a background thread")
    p.add_argument("--shard_optimizer_state", action="store_true",
                   help="ZeRO-1: each data rank holds and updates its slice of the AdamW state")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3: each data rank keeps its shard of every large parameter and its moments")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="Ranks per model replica (Megatron tensor parallelism of the UNet)")
    p.add_argument("--flash_attention", action=argparse.BooleanOptionalAction, default=False,
                   help="The hand-written flash attention kernels (on the GPU)")
    p.add_argument("--remat", action=argparse.BooleanOptionalAction, default=False,
                   help="Recompute the UNet's and the VAE decoder's block activations in the backward")
    p.add_argument("--profile_steps", type=str, default=None,
                   help="'start,stop' optimizer-step range traced by torch.profiler into {output_dir}/profile")
    return p


def parse_args(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.recipe:
        p.set_defaults(**RECIPE_PRESETS[args.recipe])
        args = p.parse_args(argv)
    env_local_rank = int(os.environ.get("LOCAL_RANK", -1))
    if env_local_rank != -1 and env_local_rank != args.local_rank:
        args.local_rank = env_local_rank
    return args


def check_args(args):
    if args.extra_num_tokens < 0:
        raise ValueError("extra_num_tokens should be greater than or equal to 0")
    if len(args.image_encoder_layers_idx) != args.extra_num_tokens:
        raise ValueError("The number of image encoder layers to use as tokens should be equal to extra_num_tokens")
    if 0 in args.image_encoder_layers_idx:
        raise ValueError("The image encoder extra tokens layers cant be the last layer since we always use the last layer")
    if getattr(args, "uint8_transfer", False) and args.native_loader:
        raise ValueError("--uint8_transfer is not supported with --native_loader (the C++ loader emits "
                         "normalized float32 batches); drop one of them (--recipe canonical users: pass "
                         "--no-uint8_transfer)")


def refuse_unported(args) -> None:
    """Exit on a flag whose code the port lacks, naming the flag."""
    if args.push_to_hub:
        raise SystemExit("--push_to_hub needs the network, which the PyTorch port does not use; "
                         "upload the checkpoints in output_dir yourself")
    if args.mixed_precision == "fp16":
        raise SystemExit("--mixed_precision fp16 is not supported (as in the JAX package); use bf16 or no")


def accumulation_plan(train_batch_size: int, gradient_accumulation_steps: int, auto_grad_accum: bool,
                      max_microbatch_per_chip: int, n_mesh: int = 1) -> Tuple[int, int]:
    """(accumulation steps, micro-batch). With auto_grad_accum and no
    manual accumulation, a batch whose per-device share exceeds
    max_microbatch_per_chip is split into the fewest equal micro-batches
    that fit; manual accumulation keeps micro-batch = the loader batch."""
    accum, micro_batch = gradient_accumulation_steps, train_batch_size
    if auto_grad_accum and accum == 1:
        per_chip = train_batch_size // n_mesh
        if per_chip > max_microbatch_per_chip:
            for cand in range(2, per_chip + 1):
                micro = train_batch_size // cand
                if (train_batch_size % cand == 0 and micro % n_mesh == 0
                        and micro // n_mesh <= max_microbatch_per_chip):
                    accum, micro_batch = cand, micro
                    break
    return accum, micro_batch


def mesh_plan(args, world: int) -> Tuple[int, int, int, int]:
    """(dp, mp, accumulation steps, micro-batch) for the launcher's
    `world` ranks, checked before any process group opens: --tensor_parallel
    must divide the ranks and the head count, and the data ranks the
    micro-batch (the JAX CLI's host_batch_slice)."""
    mp = args.tensor_parallel
    if mp < 1 or world % mp:
        raise SystemExit(f"--tensor_parallel {mp} must divide the device count {world} (the ranks the launcher "
                         f"started; launch them with python -m torch.distributed.run --nproc_per_node N)")
    dp = world // mp
    if mp > 1:
        from photoverse_tpu_torch.models.assembly import model_configs

        heads = model_configs(args.pretrained_model_name_or_path)[0].num_heads
        if heads % mp:
            raise SystemExit(f"tensor_parallel={mp} must divide num_heads={heads}")
    accum, micro_batch = accumulation_plan(args.train_batch_size, args.gradient_accumulation_steps,
                                           args.auto_grad_accum, args.max_microbatch_per_chip, n_mesh=dp)
    if micro_batch % dp:
        raise SystemExit(f"global batch {micro_batch} not divisible by process count {dp} (the data ranks: "
                         f"{world} ranks / --tensor_parallel {mp})")
    return dp, mp, accum, micro_batch


def face_rows(sample_ratio: float, micro_batch: int, accum: int, fuse_face: bool) -> int:
    """Rows of the face sub-batch: the sample ratio of the micro-batch (at
    least 1), the window's worth under the fused schedule, capped at the
    micro-batch."""
    n_face = max(int(sample_ratio * micro_batch), 1)
    if fuse_face:
        n_face = min(n_face * accum, micro_batch)
    return n_face


def host_batch(batch: Dict, tokenizer, n_face: int = 0, face_rng: Optional[np.random.RandomState] = None) -> Dict:
    """The loader batch as the train step takes it: text dropped, the
    placeholder index flattened, and with n_face > 0 the face sub-batch
    (rows picked by random_batch_slicing from face_rng, the prompt
    "a photo of *" and the empty negative prompt)."""
    from photoverse_tpu_torch.data.prompts import prepare_prompt, random_batch_slicing

    out = {k: v for k, v in batch.items() if k != "text"}
    out["concept_placeholder_idx"] = out["concept_placeholder_idx"].reshape(-1)
    if n_face:
        bs = batch["pixel_values"].shape[0]
        ex = prepare_prompt(tokenizer, "a photo of {}", "*", num_of_samples=bs)
        merged = dict(batch, text_input_ids=ex["text_input_ids"],
                      concept_placeholder_idx=ex["concept_placeholder_idx"])
        sliced = random_batch_slicing(merged, bs, n_face, face_rng)
        out["face_pixel_values"] = sliced["pixel_values"]
        out["face_pixel_values_clip"] = sliced["pixel_values_clip"]
        out["face_text_input_ids"] = sliced["text_input_ids"]
        out["face_concept_placeholder_idx"] = sliced["concept_placeholder_idx"].reshape(-1)
        out["face_uncond_input_ids"] = np.asarray(tokenizer([""] * n_face), np.int32)
    return out


def _promote_final_ckpt(args, step: int) -> None:
    """Copy the photoverse_{step:06}.* files just written to the unstepped
    final names (the run ended on a checkpoint boundary); the sidecar
    lands before the checkpoint, as save_progress orders them."""

    def promote(src, dst):
        if not os.path.exists(src):
            return
        tmp = dst + ".tmp"
        shutil.copyfile(src, tmp)
        os.replace(tmp, dst)

    stem = os.path.join(args.output_dir, f"photoverse_{step:06d}")
    final = os.path.join(args.output_dir, "photoverse")
    if args.checkpoint_format in ("native", "both"):
        promote(stem + ".msgpack.lora.json", final + ".msgpack.lora.json")
        promote(stem + ".msgpack", final + ".msgpack")
    if args.checkpoint_format in ("pt", "both"):
        promote(stem + ".pt", final + ".pt")


def _save_samples(args, models, tokenizer, solver, batch, step, writer, latent_size, face_metric=None):
    """A sample grid (input images, condition images, generations; with
    --save_samples_with_various_prompts one row per eval prompt) into
    output_dir/{step:05d}.jpg, and with the face loss the face_similarity
    of the inputs and the generations. The generation batch is the first
    min(batch, 16) rows; with --use_random_prompts the prompt is the fixed
    "a photo of {}". With sharded parameters every rank generates from its
    rows (the collectives need every rank); a rank without a `writer`
    writes nothing."""
    import torch

    from photoverse_tpu_torch.data.preprocessing import CLIP_MEAN, CLIP_STD
    from photoverse_tpu_torch.data.prompts import EVAL_PROMPTS, prepare_prompt
    from photoverse_tpu_torch.engine.inference import run_inference
    from photoverse_tpu_torch.utils.image import denormalize, denormalize_clip, save_images_grid, to_pil

    if batch["pixel_values"].dtype == np.uint8:
        batch = dict(batch)
        batch["pixel_values"] = batch["pixel_values"].astype(np.float32) / 127.5 - 1.0
        batch["pixel_values_clip"] = (batch["pixel_values_clip"].astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
    B = min(batch["pixel_values"].shape[0], 16)
    n = min(args.num_of_samples_to_save, B)
    text_ids = batch["text_input_ids"][:B]
    pidx = batch["concept_placeholder_idx"][:B]
    grid_prompt = batch["text"][0]
    if args.use_random_prompts:
        ex = prepare_prompt(tokenizer, "a photo of {}", "*", num_of_samples=B)
        text_ids, pidx, grid_prompt = ex["text_input_ids"], ex["concept_placeholder_idx"], ex["text"][0]
    example = {"pixel_values": batch["pixel_values"][:B], "pixel_values_clip": batch["pixel_values_clip"][:B],
               "text_input_ids": text_ids, "concept_placeholder_idx": np.asarray(pidx).reshape(-1)}
    uncond = np.asarray(tokenizer([""] * B), np.int32)
    dev = models.device

    def generate(ex, uncond_ids):
        g = torch.Generator(device=dev).manual_seed(step)
        with torch.no_grad():
            return run_inference(models, solver, ex, g, guidance_scale=args.guidance_scale, token_index=0,
                                 latent_size=latent_size, uncond_input_ids=uncond_ids)

    gen = generate(example, uncond)
    logs = {}
    if face_metric is not None:
        with torch.no_grad():
            logs["face_similarity"] = float(face_metric(torch.as_tensor(example["pixel_values"], device=dev), gen))
    rows = [(grid_prompt, gen)]
    if args.save_samples_with_various_prompts:
        for prompt in EVAL_PROMPTS:
            ex = prepare_prompt(tokenizer, prompt, "*", num_of_samples=n)
            ex_n = {"pixel_values": example["pixel_values"][:n], "pixel_values_clip": example["pixel_values_clip"][:n],
                    "text_input_ids": ex["text_input_ids"],
                    "concept_placeholder_idx": ex["concept_placeholder_idx"].reshape(-1)}
            rows.append((prompt, generate(ex_n, uncond[:n])))
    if writer is None:
        return
    grid_data = [
        ("Input Images", [to_pil(denormalize(im)) for im in batch["pixel_values"][:n]]),
        ("Condition Images", [to_pil(denormalize_clip(im)).resize((args.resolution, args.resolution))
                              for im in batch["pixel_values_clip"][:n]]),
    ] + [(label, [to_pil(denormalize(im)) for im in g.float().cpu().numpy()[:n]]) for label, g in rows]
    path = os.path.join(args.output_dir, f"{step:05d}.jpg")
    save_images_grid(grid_data, path)
    if logs:
        writer.log(logs, step)
    writer.log_image("Generated images vs input images", path, "Generated images vs input images", step)


class _Profiler:
    """torch.profiler over the optimizer steps [start, stop): the chrome
    trace, a table of the operations by device (or, on the CPU, host)
    time, summary.json (the window's wall time, the device's busy time
    and its largest operations) and spans.json (the spans and counters of
    utils/trace.py over the window, in seconds of time.perf_counter, with
    `anchor_host`, the host time at which the marker kernel `spin_kernel`
    was launched: its launch's time in the trace ties the two clocks) go
    to output_dir/profile."""

    def __init__(self, output_dir: str, on_card: bool):
        import torch
        import torch.profiler as tp

        acts = [tp.ProfilerActivity.CPU] + ([tp.ProfilerActivity.CUDA] if on_card else [])
        self.dir = os.path.join(output_dir, "profile")
        self.on_card = on_card
        self.prof = tp.profile(activities=acts)
        self.prof.start()
        self.anchor = None
        if on_card:
            torch.cuda.synchronize()
            self.anchor = time.perf_counter()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        trace.enable()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch

        if self.on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        program = trace.take()
        self.prof.stop()
        t = time.perf_counter()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, "trace.json")
        self.prof.export_chrome_trace(path)
        with open(os.path.join(self.dir, "spans.json"), "w") as f:
            json.dump({"anchor_host": self.anchor, "marker": "spin_kernel", **program}, f)
        # the table and the summary are read back from the exported trace:
        # the profiler's own event list (key_averages, events) is built in
        # Python and takes tens of seconds over one step's 26,000 launches
        with open(path) as f:
            events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
        kernels = [e for e in events if e.get("cat") in trace.DEVICE_CATS]
        busy = trace.union_length(trace.device_intervals(kernels))

        def by_name(evs) -> list:  # [name, total ms, count], largest first
            out: Dict[str, list] = {}
            for e in evs:
                entry = out.setdefault(e["name"], [e["name"], 0.0, 0])
                entry[1] += float(e["dur"]) / 1e3
                entry[2] += 1
            return sorted(out.values(), key=lambda r: -r[1])

        # the device's operations, or on the CPU the host's (with their children)
        ops = by_name(kernels) if kernels else by_name(e for e in events if e.get("cat") == "cpu_op")
        with open(os.path.join(self.dir, "ops.txt"), "w") as f:
            f.write(f"{'total ms':>12}  {'count':>7}  {'device' if kernels else 'host'} operation\n")
            f.writelines(f"{ms:12.3f}  {n:7d}  {name}\n" for name, ms, n in ops[:40])
        summary = {"wall_s": wall, "device_busy_s": busy if busy > 0 else None,
                   "top_device_ops": by_name(kernels)[:12], "summarised_s": time.perf_counter() - t}
        with open(os.path.join(self.dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(f"profile: {wall:.4f}s wall, device busy "
              + (f"{busy:.4f}s ({busy / wall:.1%})" if busy > 0 else "not measured (no device events)")
              + f"; trace written and summarised in {summary['summarised_s']:.2f}s", flush=True)


def main(argv=None, dataset=None):
    """Train. `dataset` replaces the dataset the flags describe (an object
    with __len__ and example(idx, rng), as CustomDataset). Returns
    (models, optimizer, optimizer steps done); on several ranks, this
    rank's shards."""
    args = parse_args(argv)
    check_args(args)
    refuse_unported(args)
    from photoverse_tpu_torch.parallel.mesh import close_mesh, open_mesh, world_from_env

    world = world_from_env()[1]
    dp, mp, accum, micro_batch = mesh_plan(args, world)
    if world == 1:
        if args.fsdp or args.shard_optimizer_state:
            print("--fsdp / --shard_optimizer_state with one data rank: the run is one process's", flush=True)
        return _train(args, dataset, None, accum, micro_batch)
    mesh = open_mesh(dp, mp, args.cpu)
    try:
        return _train(args, dataset, mesh, accum, micro_batch)
    finally:
        close_mesh(mesh)


def _train(args, dataset, mesh, accum: int, micro_batch: int):
    import torch

    from photoverse_tpu_torch.cli.generate import pick_device
    from photoverse_tpu_torch.ckpt.checkpoint import (
        AsyncCheckpointer,
        host_save_snapshot,
        load_progress,
        optax_state,
        save_progress,
        save_progress_pt,
    )
    from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
    from photoverse_tpu_torch.data.dataset import BatchLoader, CustomDataset, CustomDatasetWithMasks
    from photoverse_tpu_torch.engine.training import TrainConfig, TrainStep, init_train_state, make_draws
    from photoverse_tpu_torch.models.assembly import load_models
    from photoverse_tpu_torch.parallel.mesh import host_batch_slice, shard_batch
    from photoverse_tpu_torch.utils.metrics import MetricsWriter

    device = mesh.device if mesh is not None else pick_device(args.cpu)
    on_card = torch.device(device).type == "cuda"
    lead = mesh is None or mesh.rank == 0  # writes the files and the metrics
    dp = 1 if mesh is None else mesh.dp
    host_bs = micro_batch // dp
    seed = args.seed if args.seed is not None else 0
    dtype = torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32
    tokenizer, models, lora_config = load_models(
        args.pretrained_model_name_or_path, extra_num_tokens=args.extra_num_tokens,
        photoverse_path=args.pretrained_photoverse_path, use_lora=args.use_lora, lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha, lora_dropout=args.lora_dropout,
        image_encoder_layers_idx=tuple(args.image_encoder_layers_idx), dtype=dtype,
        use_flash_attention=args.flash_attention, remat=args.remat, seed=seed, device=device)
    latent_size = args.resolution // 2 ** (len(models.vae.config.block_out_channels) - 1)

    face_loss_fn = face_solver = face_metric = None
    if args.face_loss:
        from photoverse_tpu_torch.models.face_loss import load_face_loss, make_face_loss_fn

        if args.face_model_weights is None and not args.allow_random_face_model:
            raise ValueError(f"--face_loss {args.face_loss} requires --face_model_weights (pretrained embedder "
                             ".pt); a randomly-initialized embedder produces a meaningless identity signal. "
                             "Pass --allow_random_face_model to override for testing.")
        if args.face_model_weights is None and lead:
            print("WARNING: --face_loss with RANDOM embedder weights (--allow_random_face_model): the "
                  "identity loss is noise.")
        face_loss_obj = load_face_loss(args.face_loss, args.face_model_weights, device=device)
        face_loss_fn = make_face_loss_fn(face_loss_obj)
        face_solver = DPMSolverMultistep.create(models.schedule, TrainConfig.face_loss_timesteps)

        def face_metric(x, gen):
            return face_loss_obj(x, gen, maximize=False, normalize=False)

    if accum != args.gradient_accumulation_steps and lead:
        print(f"auto_grad_accum: micro-batch {micro_batch} x {accum} accumulation steps ({host_bs}/chip)")
    cfg = TrainConfig(
        learning_rate=args.learning_rate, adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2,
        adam_weight_decay=args.adam_weight_decay, adam_epsilon=args.adam_epsilon,
        lr_scheduler=args.lr_scheduler, lr_warmup_steps=args.lr_warmup_steps,
        max_train_steps=args.max_train_steps, gradient_accumulation_steps=accum,
        face_loss_guidance=args.guidance_scale)
    _, _, optimizer = init_train_state(models, cfg)
    start_step = 0
    if args.resume_from:
        # loaded whole, as one process loads it, then cut to this rank's share
        start_step = load_progress(args.resume_from, models, optimizer)
        if lead:
            print(f"resumed from {args.resume_from} at step {start_step}")
    layout = None
    if mesh is not None:
        from photoverse_tpu_torch.parallel.training import shard_training

        optimizer = shard_training(models, optimizer, mesh, fsdp=args.fsdp, zero1=args.shard_optimizer_state)
        layout = optimizer.layout
        if lead:
            place = layout.placements.values()
            print(f"[parallel] training on a {mesh.dp} x {mesh.mp} mesh: {sum(p.model is not None for p in place)} "
                  f"tensor-parallel leaves, {sum(p.data is not None for p in place)} FSDP shards, "
                  f"{sum(p.zero is not None for p in place)} ZeRO-1 slices", flush=True)

    if dataset is None:
        ds_kw = dict(tokenizer=tokenizer, size=args.resolution, use_random_templates=args.use_random_prompts,
                     seed=seed, img_subfolder=args.img_subfolder,
                     clip_size=models.vision_encoder.config.image_size, uint8_pixels=args.uint8_transfer)
        if args.mask_subfolder is None:
            dataset = CustomDataset(args.data_root_path, **ds_kw)
        else:
            dataset = CustomDatasetWithMasks(args.data_root_path, mask_subfolder=args.mask_subfolder, **ds_kw)
    # every data rank decodes only its rows of each micro-batch; the model
    # ranks of one data rank share its template stream (keyed on the data rank)
    loader = BatchLoader(dataset, micro_batch, shuffle=True, seed=seed, num_workers=args.dataloader_num_workers,
                         native=args.native_loader,
                         host_slice=None if mesh is None else host_batch_slice(micro_batch, mesh),
                         host_id=0 if mesh is None else mesh.data_rank)

    fuse_face = bool(args.fuse_face_accum and args.face_loss and accum > 1)
    step_fn = TrainStep(models, cfg, optimizer, face_loss_fn, face_solver,
                        face_weight_scale=float(accum) if fuse_face else 1.0)
    # the window's other micro-steps: the diffusion step alone, same optimizer
    step_noface = TrainStep(models, cfg, optimizer) if fuse_face else None
    n_cross = len(models.unet.cross_attentions())

    os.makedirs(args.output_dir, exist_ok=True)
    writer = MetricsWriter(args.output_dir, report_to=args.report_to, config=vars(args)) if lead else None
    num_update_steps_per_epoch = math.ceil(len(loader) / accum)
    num_epochs = math.ceil(args.max_train_steps / max(num_update_steps_per_epoch, 1))
    if lead:
        print(f"~~~~~ Running training ~~~~~\n  Num examples = {len(dataset)}\n  Num Epochs = {num_epochs}\n"
              f"  Batch size per step = {args.train_batch_size}\n"
              f"  Devices = {1 if mesh is None else mesh.world} ({device})\n"
              f"  Total optimization steps = {args.max_train_steps}", flush=True)

    ckpt_async = AsyncCheckpointer() if args.async_checkpointing and lead else None
    if args.checkpoint_format == "pt" and lead:
        print("WARNING: --checkpoint_format pt has no optimizer state / step counter; --resume_from needs the "
              "native format (a native checkpoint is still written on SIGTERM/SIGINT)")

    def timed(fn, how):
        def run(*a, **kw):
            t = time.perf_counter()
            path = fn(*a, **kw)
            print(f"checkpoint: wrote {os.path.basename(path)} in {time.perf_counter() - t:.4f}s ({how})", flush=True)
        return run

    def save_ckpt(step_, force_native=False, final=False):
        """Every rank gathers its shards; rank 0 writes."""
        t = time.perf_counter()
        snap = host_save_snapshot(models, layout)
        opt_save = optax_state(optimizer)
        if not lead:
            return
        print(f"checkpoint: host snapshot at step {step_} in {time.perf_counter() - t:.4f}s", flush=True)
        jobs = []
        if args.checkpoint_format in ("native", "both") or force_native:
            jobs.append((save_progress, dict(step=step_, lora_config=lora_config, opt_state=opt_save, final=final)))
        if args.checkpoint_format in ("pt", "both"):
            jobs.append((save_progress_pt, dict(step=step_, lora_config=lora_config, final=final)))
        for fn, kw in jobs:
            if ckpt_async is not None:
                ckpt_async.submit(timed(fn, "async"), args.output_dir, snap, **kw)
            else:
                timed(fn, "sync")(args.output_dir, snap, **kw)

    def finalize_io():
        try:
            if ckpt_async is not None:
                ckpt_async.close()
        finally:
            if writer is not None:
                writer.close()

    stop_requested = {"flag": False}

    def _on_term(signum, frame):
        stop_requested["flag"] = True

    def stopping() -> bool:
        """The stop flag of any rank (one all_reduce at every optimizer step,
        so that every rank stops at the same step)."""
        if mesh is None:
            return stop_requested["flag"]
        flag = torch.tensor([float(stop_requested["flag"])])
        return bool(mesh.world_comm.all_reduce(flag)[0] > 0)

    previous = {s: signal.signal(s, _on_term) for s in (signal.SIGTERM, signal.SIGINT)}
    face_rng = np.random.RandomState(seed + 1)
    # the JAX CLI's PRNGKey(seed + start_step): a resumed run reseeds its draws
    generator = torch.Generator(device=device).manual_seed(seed + start_step)
    global_step = start_step
    last_ckpt_step = -1
    micro_step = 0
    accum_time = 0.0
    profiler = None
    profile_range = tuple(int(x) for x in args.profile_steps.split(",")) if args.profile_steps else None
    eval_solver = DPMSolverMultistep.create(models.schedule, args.denoise_timesteps)
    # the face sub-batch comes from this data rank's rows, as the JAX CLI slices it per host
    n_face = face_rows(args.face_loss_sample_ratio, host_bs, accum, fuse_face) if args.face_loss else 0
    params_sharded = mesh is not None and (mesh.mp > 1 or (args.fsdp and mesh.dp > 1))
    try:
        for _epoch in range(num_epochs):
            for batch in loader:
                window_final = (micro_step + 1) % accum == 0
                face = bool(args.face_loss) and (not fuse_face or window_final)
                hb = host_batch(batch, tokenizer, n_face if face else 0, face_rng)
                if mesh is not None:
                    hb = shard_batch(hb, mesh)
                # the whole micro-batch's draws on every rank; the step keeps this rank's rows
                draws = make_draws(generator, micro_batch, latent_size, n_cross,
                                   face_rows=n_face * dp if face else 0, in_channels=models.unet.config.in_channels)
                if profile_range and global_step == profile_range[0] and profiler is None and lead:
                    profiler = _Profiler(args.output_dir, on_card)
                t_step = time.perf_counter()
                metrics = (step_noface if fuse_face and not window_final else step_fn)(hb, draws)
                micro_step += 1
                if micro_step % accum:
                    accum_time += time.perf_counter() - t_step
                    continue
                global_step += 1
                metrics = {k: float(v) for k, v in metrics.items()}  # waits for the window
                accum_time += time.perf_counter() - t_step
                step_s, accum_time = accum_time, 0.0
                if profiler is not None and global_step >= profile_range[1]:
                    profiler.stop()
                    profiler = None

                logs = {
                    "loss_mle": metrics["loss_mle"],
                    "loss_reg_concept_text": metrics["loss_reg_concept_text"],
                    "loss_reg_cross_attn_visual": metrics["loss_reg_cross_attn_visual"],
                    "lr": optimizer.lr(global_step),
                    "step_time_s": step_s,
                    "imgs_per_sec": micro_batch * accum / max(step_s, 1e-9),
                }
                if args.face_loss:
                    logs["loss_face"] = metrics["loss_face"]
                if writer is not None:
                    writer.log(logs, global_step)

                if stopping():
                    if lead:
                        print(f"termination requested — checkpointing at step {global_step}", flush=True)
                    save_ckpt(global_step, force_native=True)
                    finalize_io()
                    return models, optimizer, global_step

                if global_step % args.samples_save_steps == 0 and (lead or params_sharded):
                    _save_samples(args, models, tokenizer, eval_solver, batch, global_step, writer, latent_size,
                                  face_metric=face_metric)
                if global_step % args.checkpoint_save_steps == 0:
                    save_ckpt(global_step)
                    last_ckpt_step = global_step
                if global_step >= args.max_train_steps:
                    break
            if global_step >= args.max_train_steps:
                break

        if profiler is not None:
            profiler.stop()
        if last_ckpt_step == global_step and global_step > 0:
            # the boundary save holds this exact state: promote its files
            if lead:
                if ckpt_async is not None:
                    ckpt_async.wait()
                _promote_final_ckpt(args, global_step)
        else:
            # unstepped names, the step embedded: resuming continues here
            save_ckpt(global_step, final=True)
        finalize_io()
        return models, optimizer, global_step
    finally:
        for s, h in previous.items():
            signal.signal(s, h)


if __name__ == "__main__":
    main()
