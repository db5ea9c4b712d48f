"""Training engine: the PhotoVerse train step. Port of
photoverse_tpu/engine/training.py.

    loss = MSE(eps_pred, eps)
         + concept_reg_weight * mean |concept text embeddings|
         + visual_reg_weight  * mean ||v_ip||
         + face_loss_weight * face_weight_scale * face loss

  - Gradients reach only the trainable set (`ckpt.partition_params`): both
    adapters and the UNet's to_k_ip / to_v_ip / LoRA factors, kept as f32
    masters inside a bf16 model (`init_train_state`).
  - AdamW on the masters. Gradients are averaged over
    `gradient_accumulation_steps` micro-steps as optax.MultiSteps does
    (running mean), clipped per group (text_adapter / image_adapter / unet)
    at the window boundary with the JAX formula
    min(1, max_norm / max(||g||, 1e-12)), then applied; update j uses the
    learning rate lr(j), optax's counting.
  - The face loss: an inner DPM-Solver++ generation on the face sub-batch
    whose last step carries gradients in train mode, the VAE decode, and
    the ArcFace cosine loss. `face_weight_scale` serves the fused
    face-accumulation schedule (the branch runs on a window's last
    micro-step, on a wider sub-batch, at accum x weight); the reported
    `loss` keeps the unscaled face term.
  - Randomness arrives as one explicit `draws` dict (`make_draws`): the
    VAE sample noise, the diffusion noise, the timesteps, the fusion
    uniforms and the LoRA dropout generator, for the main branch and for
    the face branch under "face". Tests fill it with the values the JAX
    package draws from its key.
  - Several ranks (a parallel.training.TrainLayout on the optimizer):
    data-parallel semantics equal to one process. Every rank makes the
    draws of the whole micro-batch and keeps its rows
    (`TrainLayout.local_draws`; the dropout masks through a RowGenerator),
    each rank's loss is the mean over its equal share of rows, and the
    optimizer averages the accumulated gradient over the data group once
    per window before clipping (the clip norms are those of the whole
    gradient). Under tensor parallelism the identity-value norms of the
    visual regulariser are summed over the model group; the reported
    metrics are means over the data group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from photoverse_tpu_torch.ckpt.checkpoint import _host, partition_params
from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
from photoverse_tpu_torch.engine.inference import denoise, encode_condition

__all__ = [
    "TrainConfig",
    "make_lr_schedule",
    "clip_groups",
    "Optimizer",
    "make_optimizer",
    "normalize_pixel_batch",
    "make_draws",
    "TrainStep",
    "make_train_step",
    "init_train_state",
]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    lr_scheduler: str = "constant"  # constant | constant_with_warmup | linear | cosine
    lr_warmup_steps: int = 500
    max_train_steps: int = 5000
    gradient_accumulation_steps: int = 1
    max_grad_norm: float = 1.0
    concept_reg_weight: float = 0.01
    visual_reg_weight: float = 0.001
    face_loss_weight: float = 0.01
    face_loss_timesteps: int = 10
    face_loss_guidance: float = 2.0


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """lr(update count), as the JAX package's optax schedules give it:
    linear warmup from 0 over lr_warmup_steps, then constant, linear decay
    to 0 at max_train_steps, or cosine decay to 0 at max_train_steps."""
    base, warm, total = cfg.learning_rate, cfg.lr_warmup_steps, cfg.max_train_steps
    kind = cfg.lr_scheduler
    if kind not in ("constant", "constant_with_warmup", "linear", "cosine"):
        raise ValueError(f"unknown lr_scheduler {kind}")

    def lr(n: int) -> float:
        if kind == "constant":
            return base
        if n < warm:
            return base * n / warm
        if kind == "constant_with_warmup":
            return base
        if kind == "linear":
            return base * (1.0 - min(max((n - warm) / max(total - warm, 1), 0.0), 1.0))
        t = min(n - warm, total - warm)
        return base * 0.5 * (1.0 + math.cos(math.pi * t / (total - warm)))

    return lr


def clip_groups(grads: Dict[str, torch.Tensor], max_norm: float,
                global_sq: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """Global-norm clipping per model group (the key's first component):
    g * min(1, max_norm / max(||g||, 1e-12)). Unlike clip_grad_norm_, no
    1e-6 is added to the norm. `global_sq` maps {key: this rank's sum of
    squares} to {group: the whole gradient's sum of squares} when the
    leaves are shards of a multi-rank layout."""
    groups: Dict[str, list] = {}
    for key in grads:
        groups.setdefault(key.split(".", 1)[0], []).append(key)
    out = dict(grads)
    sq = {k: g.float().square().sum() for k, g in grads.items()}
    totals = global_sq(sq) if global_sq is not None else {
        name: sum(sq[k] for k in keys) for name, keys in groups.items()}
    for name, keys in groups.items():
        norm = torch.sqrt(totals[name])
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        for k in keys:
            out[k] = grads[k] * scale.to(grads[k].dtype)
    return out


class Optimizer:
    """AdamW (torch.optim.AdamW, optax's update) on the f32 masters, with
    optax.MultiSteps accumulation and per-group clipping of the averaged
    gradient at the window boundary.

    With a `layout` (parallel.training.TrainLayout) the parameters may be
    shards: the window's gradient is averaged over the data group first
    (`_reduce_grads`), the clip norms span every rank's shard, and under
    ZeRO-1 AdamW holds and updates only this rank's slice of a leaf (its
    `zero` dim), after which the updated slices are all-gathered into the
    whole masters (`_gather_slices`)."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], cfg: TrainConfig, layout=None):
        self.params = params
        self.cfg = cfg
        self.layout = layout
        self.lr = make_lr_schedule(cfg)
        self.accum = cfg.gradient_accumulation_steps
        self.max_grad_norm = cfg.max_grad_norm
        # ZeRO-1: AdamW's parameter is this rank's slice, a view of the master
        self.slices = {} if layout is None else layout.zero_slices(params)
        self.adamw = torch.optim.AdamW(
            [self.slices.get(k, p) for k, p in params.items()], lr=self.lr(0),
            betas=(cfg.adam_beta1, cfg.adam_beta2), eps=cfg.adam_epsilon, weight_decay=cfg.adam_weight_decay,
            foreach=False,
        )
        self.acc = {k: torch.zeros_like(p) for k, p in params.items()}
        self.mini_step = 0
        self.updates = 0

    def adam_param(self, key: str) -> torch.nn.Parameter:
        """The tensor AdamW updates for leaf `key` (its state's key)."""
        return self.slices.get(key, self.params[key])

    def _reduce_grads(self) -> None:
        if self.layout is not None:
            self.layout.reduce_grads(self.acc)

    def _gather_slices(self) -> None:
        if self.slices:
            self.layout.gather_slices(self.params, self.slices)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> bool:
        """Take one micro-step's gradients; returns True when this call
        completed a window and updated the parameters."""
        n = self.mini_step
        for k, g in grads.items():
            acc = self.acc[k]
            acc.add_((g.to(acc.dtype) - acc) / (n + 1))
        if n + 1 < self.accum:
            self.mini_step += 1
            return False
        self._reduce_grads()
        global_sq = None if self.layout is None else self.layout.global_sq
        for k, g in clip_groups(self.acc, self.max_grad_norm, global_sq).items():
            self.adam_param(k).grad = self.layout.zero_slice(k, g) if k in self.slices else g
        for group in self.adamw.param_groups:
            group["lr"] = self.lr(self.updates)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self._gather_slices()
        for acc in self.acc.values():
            acc.zero_()
        self.mini_step = 0
        self.updates += 1
        return True

    @torch.no_grad()
    def host_state(self):
        """(mu, nu, acc): AdamW's moments and the accumulator of every leaf,
        whole, as host f32 arrays; multi-rank, every rank takes part in the
        layout's gathers and rank 0 receives them (the others get None). The
        accumulator is then the data group's mean, as one process
        accumulates the whole batch's gradient."""
        layout, acc = self.layout, self.acc
        if layout is None:
            def to_host(key, t, zero=False):
                return _host(t)
        else:
            to_host = layout.host
            acc = {k: v.clone() for k, v in acc.items()}
            layout.reduce_grads(acc)
        mu, nu = {}, {}
        for k in self.params:
            ap = self.adam_param(k)
            st = self.adamw.state.get(ap, {})
            if st and int(st["step"]) != self.updates:
                raise RuntimeError(f"{k}: AdamW step {int(st['step'])} != {self.updates} updates")
            zero = k in self.slices
            mu[k] = to_host(k, st["exp_avg"] if st else torch.zeros_like(ap), zero)
            nu[k] = to_host(k, st["exp_avg_sq"] if st else torch.zeros_like(ap), zero)
        acc = {k: to_host(k, v) for k, v in acc.items()}
        if layout is not None and layout.mesh.rank != 0:
            return None
        return mu, nu, acc


def make_optimizer(cfg: TrainConfig, params: Dict[str, torch.nn.Parameter]) -> Optimizer:
    """The optimizer over `params`; its schedule is `Optimizer.lr`."""
    return Optimizer(params, cfg)


def normalize_pixel_batch(batch: Dict) -> Dict:
    """uint8 pixel batches normalized on the device: VAE keys to [-1, 1],
    CLIP keys through the CLIP mean/std. Float inputs pass unchanged."""
    out = dict(batch)
    for k in ("pixel_values", "face_pixel_values"):
        if k in out and out[k].dtype == torch.uint8:
            out[k] = out[k].float() / 127.5 - 1.0
    for k in ("pixel_values_clip", "face_pixel_values_clip"):
        if k in out and out[k].dtype == torch.uint8:
            x = out[k]
            mean = torch.tensor(CLIP_MEAN, device=x.device)
            std = torch.tensor(CLIP_STD, device=x.device)
            out[k] = (x.float() / 255.0 - mean) / std
    return out


def make_draws(generator: torch.Generator, batch_size: int, latent_size: int,
               num_cross_layers: int, face_rows: int = 0, in_channels: int = 4,
               num_train_timesteps: int = 1000) -> Dict:
    """One micro-step's random draws from `generator`, on its device:
    vae_noise, noise (B, h, h, in_channels), timesteps (B,), fusion_u (L,)
    and a `dropout` generator seeded from it; with face_rows > 0 the face
    branch's vae_noise, noise (n, h, h, in_channels), fusion_u (L,) and
    dropout generator under "face"."""
    dev = generator.device

    def branch(n, with_t):
        shape = (n, latent_size, latent_size, in_channels)
        d = {"vae_noise": torch.randn(shape, generator=generator, device=dev),
             "noise": torch.randn(shape, generator=generator, device=dev)}
        if with_t:
            d["timesteps"] = torch.randint(0, num_train_timesteps, (n,), generator=generator, device=dev)
        d["fusion_u"] = torch.rand(num_cross_layers, generator=generator, device=dev)
        seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=dev).item())
        d["dropout"] = torch.Generator(device=dev).manual_seed(seed)
        return d

    draws = branch(batch_size, True)
    if face_rows:
        draws["face"] = branch(face_rows, False)
    return draws


class TrainStep:
    """One micro-step: `loss_fn` (total, metrics), `compute_grads` (metrics,
    per-parameter gradients) and `__call__`, which hands the gradients to
    the optimizer. Batch keys (NHWC): pixel_values (B, H, W, 3),
    pixel_values_clip (B, 224, 224, 3), text_input_ids (B, 77),
    concept_placeholder_idx (B,), and with the face loss face_pixel_values,
    face_pixel_values_clip, face_text_input_ids,
    face_concept_placeholder_idx and face_uncond_input_ids for the face
    sub-batch; uint8 pixels are normalized on the device."""

    def __init__(self, models, cfg: TrainConfig, optimizer: Optional[Optimizer] = None,
                 face_loss_fn: Optional[Callable] = None,
                 face_solver: Optional[DPMSolverMultistep] = None,
                 face_weight_scale: float = 1.0):
        if face_loss_fn is not None and face_solver is None:
            raise ValueError("the face loss needs face_solver")
        # Int8Linear rounds its operands and round() has zero gradient: the
        # adapters' gradients through the text encoder would vanish while the
        # loss stays finite, so refuse instead of stalling silently
        if models.text_encoder.config.int8_dense or models.vision_encoder.config.int8_dense:
            raise ValueError("int8_conditioning/int8_dense is inference-only: the quantizer's round() has "
                             "zero gradient and would silently stall adapter training. Build the training "
                             "models without it.")
        self.models = models
        self.cfg = cfg
        self.optimizer = optimizer
        self.face_loss_fn = face_loss_fn
        self.face_solver = face_solver
        self.face_weight_scale = face_weight_scale
        # several ranks: the optimizer's parallel.training.TrainLayout
        self.layout = None if optimizer is None else optimizer.layout
        self.trainable, _ = partition_params(models)

    def _tensors(self, batch: Dict) -> Dict:
        dev = self.models.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        batch = normalize_pixel_batch(batch)
        for k in ("pixel_values_clip", "face_pixel_values_clip"):
            if k in batch:
                batch[k] = batch[k].to(self.models.dtype)
        for k in ("text_input_ids", "face_text_input_ids", "face_uncond_input_ids",
                  "concept_placeholder_idx", "face_concept_placeholder_idx"):
            if k in batch:
                batch[k] = batch[k].long()
        return batch

    def _text(self, ids, concept=None, pidx=None):
        return self.models.text_encoder(ids, concept, None if pidx is None else pidx.reshape(-1))[0]

    def loss_fn(self, batch: Dict, draws: Dict) -> Tuple[torch.Tensor, Dict]:
        """`batch` holds this rank's rows, `draws` the whole micro-batch's
        (the same on every rank)."""
        m, cfg, layout = self.models, self.cfg, self.layout
        batch = self._tensors(batch)
        if layout is not None:
            draws = layout.local_draws(draws, len(batch["pixel_values"]),
                                       len(batch["face_pixel_values"]) if "face" in draws else 0)
        with torch.no_grad():
            latents = m.vae.encode_sample(batch["pixel_values"], draws["vae_noise"]) * m.scaling_factor
        noise = draws["noise"].to(latents.dtype)
        t = draws["timesteps"]
        noisy = m.schedule.add_noise(latents, noise, t)
        concept, id_ctx = encode_condition(m, batch["pixel_values_clip"], token_index=None)
        text_ctx = self._text(batch["text_input_ids"], concept, batch["concept_placeholder_idx"])
        eps_pred, v_norms = m.unet(noisy, t, text_ctx, id_ctx, train=True,
                                   fusion_u=draws["fusion_u"], dropout_generator=draws["dropout"])
        diffusion = (eps_pred.float() - noise.float()).square().mean()
        concept_reg = concept.float().abs().mean()
        visual_reg = v_norms.float().mean()
        if layout is not None:  # the mean over every head: the model group's local means, averaged
            visual_reg = layout.model_mean(visual_reg)
        floss = torch.zeros((), device=latents.device)
        if self.face_loss_fn is not None:
            floss = self._face_loss(batch, draws["face"])
        base = diffusion + cfg.concept_reg_weight * concept_reg + cfg.visual_reg_weight * visual_reg
        total = base + cfg.face_loss_weight * self.face_weight_scale * floss
        metrics = {
            "loss": (base + cfg.face_loss_weight * floss).detach(),
            "loss_mle": diffusion.detach(),
            "loss_reg_concept_text": concept_reg.detach(),
            "loss_reg_cross_attn_visual": visual_reg.detach(),
            "loss_face": floss.detach(),
        }
        if layout is not None:
            metrics = layout.data_mean(metrics)
        return total, metrics

    def _face_loss(self, batch: Dict, fd: Dict) -> torch.Tensor:
        """In-training generation on the face sub-batch, the last solver
        step with gradients in train mode, then the identity loss."""
        m, cfg, solver = self.models, self.cfg, self.face_solver
        fpx = batch["face_pixel_values"]
        with torch.no_grad():
            lat = m.vae.encode_sample(fpx, fd["vae_noise"]) * m.scaling_factor
        latents = solver.add_noise(lat, fd["noise"].to(lat.dtype), 0) * solver.init_noise_sigma
        concept, id_ctx = encode_condition(m, batch["face_pixel_values_clip"], token_index=0)
        text_ctx = self._text(batch["face_text_input_ids"], concept, batch["face_concept_placeholder_idx"])
        uncond_text = uncond_id = None
        if cfg.face_loss_guidance != 1.0:
            _, uncond_id = encode_condition(m, torch.zeros_like(batch["face_pixel_values_clip"]), 0)
            uncond_text = self._text(batch["face_uncond_input_ids"])
        latents = denoise(m, solver, latents, text_ctx, id_ctx, uncond_text, uncond_id,
                          cfg.face_loss_guidance, num_grad_steps=1, train=True,
                          step_draws=[{"fusion_u": fd["fusion_u"], "dropout": fd["dropout"]}])
        gen = m.vae.decode(latents / m.scaling_factor).clamp(-1.0, 1.0)
        return self.face_loss_fn(fpx, gen)

    def compute_grads(self, batch: Dict, draws: Dict) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        """(metrics, {trainable name: gradient of the optimized loss})."""
        total, metrics = self.loss_fn(batch, draws)
        names = list(self.trainable)
        grads = torch.autograd.grad(total, [self.trainable[k] for k in names], allow_unused=True)
        return metrics, {k: torch.zeros_like(self.trainable[k]) if g is None else g
                         for k, g in zip(names, grads)}

    def __call__(self, batch: Dict, draws: Dict) -> Dict:
        metrics, grads = self.compute_grads(batch, draws)
        self.optimizer.step(grads)
        return metrics


def make_train_step(models, cfg: TrainConfig, optimizer: Optional[Optimizer] = None,
                    face_loss_fn: Optional[Callable] = None,
                    face_solver: Optional[DPMSolverMultistep] = None,
                    face_weight_scale: float = 1.0) -> TrainStep:
    return TrainStep(models, cfg, optimizer, face_loss_fn, face_solver, face_weight_scale)


def init_train_state(models, cfg: TrainConfig):
    """Trainable parameters become f32 masters that require grad (the
    frozen ones keep their dtype and require none); returns (trainable,
    frozen, optimizer). For several ranks, parallel.training.shard_training
    then cuts the models and this optimizer to each rank's share."""
    models.requires_grad_(False)
    trainable, frozen = partition_params(models)
    for p in trainable.values():
        p.data = p.data.float()
        p.requires_grad_(True)
    return trainable, frozen, make_optimizer(cfg, trainable)
