"""Plain PyTorch reference of the PhotoVerse training step and its AdamW
update (torch and numpy only; nothing of the program under test).

One micro-step's loss:
    MSE(eps_pred, eps) + 0.01 mean|concept tokens| + 0.001 mean||v_ip||
    (+ 0.01 x window weight x the face loss on the window's last micro-step)
  - the VAE's latent sample of the training crop (no grad), noised to a
    timestep by the DDPM forward process;
  - all five CLIP feature sets through both adapters, the concept tokens
    spliced into the prompt at its placeholder;
  - the UNet in train mode: LoRA dropout, the stochastic fusion of the text
    and identity streams from one uniform per cross-attention layer;
  - the face loss: the face rows generated by DPM-Solver++ from their noised
    latents at guidance g, all steps but the last without grad and in eval
    mode, the last with grad in train mode; the VAE decode; ArcFace
    embeddings of the grayscale 128 px crops of the real and the generated
    face; 1 - cos.
The window's gradients are averaged, clipped per model group to norm 1
(min(1, 1 / max(norm, 1e-12))) and applied by AdamW on f32 masters.

Random draws, in order from one generator per run, as one micro-step makes
them: VAE noise, noise, timesteps, fusion uniforms, a dropout seed; then for
the face rows VAE noise, noise, fusion uniforms, a dropout seed.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import nets

__all__ = ["draws", "micro_step", "train", "CLIP_MEAN", "CLIP_STD"]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
REC601 = (0.2989, 0.5870, 0.1140)


def draws(generator: torch.Generator, batch: int, latent: int, layers: int, face_rows: int,
          channels: int = 4, train_steps: int = 1000) -> Dict:
    dev = generator.device

    def branch(n, with_t):
        shape = (n, latent, latent, channels)
        d = {"vae_noise": torch.randn(shape, generator=generator, device=dev),
             "noise": torch.randn(shape, generator=generator, device=dev)}
        if with_t:
            d["timesteps"] = torch.randint(0, train_steps, (n,), generator=generator, device=dev)
        d["fusion_u"] = torch.rand(layers, generator=generator, device=dev)
        d["dropout_seed"] = int(torch.randint(0, 2 ** 62, (1,), generator=generator, device=dev).item())
        return d

    out = branch(batch, True)
    if face_rows:
        out["face"] = branch(face_rows, False)
    return out


def _pixels(u8, device):
    return torch.as_tensor(u8, device=device).float() / 127.5 - 1.0


def _clip(u8, device):
    x = torch.as_tensor(u8, device=device).float() / 255.0
    return (x - torch.tensor(CLIP_MEAN, device=device)) / torch.tensor(CLIP_STD, device=device)


def _alphas(steps: int = 1000):
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, steps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def _face_input(images, size: int):
    gray = torch.tensordot(images, torch.tensor(REC601, device=images.device), dims=([-1], [0]))[..., None]
    return F.interpolate(gray.permute(0, 3, 1, 2), size=(size, size), mode="bilinear", align_corners=False,
                         antialias=False).permute(0, 2, 3, 1)


def face_loss(W, N, rc, hp, batch, fd, device):
    """The face rows' generation (last step with grad, train mode), decode
    and ArcFace cosine loss."""
    sf = rc["vae"]["scaling_factor"]
    fpx = _pixels(batch["face_pixel_values"], device)
    with torch.no_grad():
        mean, logvar = nets.vae_encode_moments(W, N, rc["vae"], fpx)
        lat = (mean + torch.exp(0.5 * logvar) * fd["vae_noise"]) * sf
    solver = nets.DPMSolver2M(hp["face_steps"])
    x = solver.add_noise(lat, fd["noise"], 0)
    clip = _clip(batch["face_pixel_values_clip"], device)
    with torch.no_grad():
        feats = nets.vision_encoder(W, N, rc["vision"], clip)
        feats0 = nets.vision_encoder(W, N, rc["vision"], torch.zeros_like(clip))
    concept = nets.adapter(W, N, "text_adapter", feats, [0])
    idc = nets.adapter(W, N, "image_adapter", feats, [0])
    ids = torch.as_tensor(batch["face_text_input_ids"], device=device).long()
    pidx = torch.as_tensor(batch["face_concept_placeholder_idx"], device=device).long().reshape(-1)
    text = nets.text_encoder(W, N, rc["text"], ids, concept, pidx)
    g = hp["face_guidance"]
    if g != 1.0:
        idc0 = nets.adapter(W, N, "image_adapter", feats0, [0])
        uncond = torch.as_tensor(batch["face_uncond_input_ids"], device=device).long()
        with torch.no_grad():
            text0 = nets.text_encoder(W, N, rc["text"], uncond)
        text, idc = torch.cat([text0, text]), torch.cat([idc0, idc])
    B = x.shape[0]
    m_prev = None
    n = solver.num_steps
    for i, t in enumerate(solver.timesteps):
        grad = i == n - 1
        with torch.set_grad_enabled(grad):
            xin = torch.cat([x, x]) if g != 1.0 else x
            tt = torch.full((xin.shape[0],), int(t), device=device, dtype=torch.long)
            train = None
            if grad:
                gen = torch.Generator(device=device).manual_seed(fd["dropout_seed"])
                train = {"fusion_u": fd["fusion_u"], "drop": nets.DropoutMasks(gen, hp["lora_dropout"])}
            eps, _ = nets.unet(W, N, rc["unet"], xin, tt, text if grad else text.detach(),
                               idc if grad else idc.detach(), train=train, checkpoint_blocks=grad)
            if g != 1.0:
                eps = eps[:B] + g * (eps[B:] - eps[:B])
            x, m_prev = solver.step(i, x, eps, m_prev)
    gen_img = nets.vae_decode(W, N, rc["vae"], x / sf, checkpoint_blocks=True).clamp(-1.0, 1.0)
    size = rc["arcface"]["input_size"]
    e1 = nets.arcface(W, N, rc["arcface"], _face_input(fpx, size))
    e2 = nets.arcface(W, N, rc["arcface"], _face_input(gen_img, size))
    cos = (e1 * e2).sum(-1) / torch.clamp(e1.norm(dim=-1) * e2.norm(dim=-1), min=1e-8)
    return (1.0 - cos).mean()


def micro_step(W, N, rc, hp, batch: Dict, d: Dict, face: bool, device, half_batch: bool = False):
    """(total loss to differentiate, reported loss)."""
    sf = rc["vae"]["scaling_factor"]
    px = _pixels(batch["pixel_values"], device)
    with torch.no_grad():
        mean, logvar = nets.vae_encode_moments(W, N, rc["vae"], px)
        lat = (mean + torch.exp(0.5 * logvar) * d["vae_noise"]) * sf
        feats = nets.vision_encoder(W, N, rc["vision"], _clip(batch["pixel_values_clip"], device))
    abar = torch.as_tensor(_alphas(), device=device)
    t = d["timesteps"]
    a = abar.sqrt().float()[t].reshape(-1, 1, 1, 1)
    s = (1.0 - abar).sqrt().float()[t].reshape(-1, 1, 1, 1)
    noisy = a * lat + s * d["noise"]
    K = rc["tokens"]
    concept = nets.adapter(W, N, "text_adapter", feats, range(K))
    idc = nets.adapter(W, N, "image_adapter", feats, range(K))
    ids = torch.as_tensor(batch["text_input_ids"], device=device).long()
    pidx = torch.as_tensor(batch["concept_placeholder_idx"], device=device).long().reshape(-1)
    text = nets.text_encoder(W, N, rc["text"], ids, concept, pidx)
    gen = torch.Generator(device=device).manual_seed(d["dropout_seed"])
    train = {"fusion_u": d["fusion_u"], "drop": nets.DropoutMasks(gen, hp["lora_dropout"])}
    eps, vn = nets.unet(W, N, rc["unet"], noisy, t, text, idc, train=train, checkpoint_blocks=True)
    rows = slice(0, eps.shape[0] // 2) if half_batch else slice(None)
    diffusion = (eps[rows] - d["noise"][rows]).square().mean()
    base = diffusion + hp["concept_reg_weight"] * concept.abs().mean() + hp["visual_reg_weight"] * vn.mean()
    if not face:
        return base, float(base.detach())
    floss = face_loss(W, N, rc, hp, batch, d["face"], device)
    total = base + hp["face_loss_weight"] * hp["accumulation"] * floss
    return total, float((base + hp["face_loss_weight"] * floss).detach())


def _clip_groups(grads: Dict[str, torch.Tensor], max_norm: float) -> Dict[str, torch.Tensor]:
    groups: Dict[str, List[str]] = {}
    for k in grads:
        groups.setdefault(k.split(".", 1)[0], []).append(k)
    out = {}
    for keys in groups.values():
        norm = math.sqrt(sum(float(grads[k].double().square().sum()) for k in keys))
        scale = min(1.0, max_norm / max(norm, 1e-12))
        for k in keys:
            out[k] = grads[k] * scale
    return out


def train(weights: Dict[str, torch.Tensor], rc: Dict, hp: Dict, trainable: List[str], batches: List[Dict],
          generator: torch.Generator, device, numerics: str = "f32", half_batch: bool = False) -> Dict:
    """Follow the first len(batches) / accumulation optimizer steps.
    Returns {losses: [per micro-step], grad1: {leaf: the first step's
    clipped gradient}, start: {leaf: master}, end: {leaf: master}}."""
    N = nets.Numerics(numerics)
    W = nets.Weights(weights, device)
    params = {k: weights[k].to(device, torch.float32).clone().requires_grad_(True) for k in trainable}
    W.override = params
    start = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    acc = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2, lr, wd, eps = hp["adam_beta1"], hp["adam_beta2"], hp["learning_rate"], hp["adam_weight_decay"], \
        hp["adam_epsilon"]
    accum = hp["accumulation"]
    L = sum(1 for _ in _cross_layers(rc))
    losses, grad1 = [], None
    updates = 0
    with nets.strict_f32():
        for j, batch in enumerate(batches):
            face = (j + 1) % accum == 0
            latent = batch["pixel_values"].shape[1] // 2 ** (len(rc["vae"]["channels"]) - 1)
            d = draws(generator, len(batch["pixel_values"]), latent, L, hp["face_rows"] if face else 0)
            total, reported = micro_step(W, N, rc, hp, batch, d, face, device, half_batch)
            grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
            losses.append(reported)
            n = j % accum
            with torch.no_grad():
                for (k, p), gk in zip(params.items(), grads):
                    gk = torch.zeros_like(p) if gk is None else gk
                    acc[k] += (gk - acc[k]) / (n + 1)
                if n + 1 < accum:
                    continue
                clipped = _clip_groups(acc, hp["max_grad_norm"])
                if grad1 is None:
                    grad1 = {k: g.clone() for k, g in clipped.items()}
                updates += 1
                bc1, bc2 = 1 - b1 ** updates, 1 - b2 ** updates
                for k, p in params.items():
                    g = clipped[k]
                    p.mul_(1 - lr * wd)
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    p.addcdiv_(m[k], (v[k].sqrt() / math.sqrt(bc2)).add_(eps), value=-lr / bc1)
                    acc[k].zero_()
    return {"losses": losses, "grad1": grad1, "start": start, "end": {k: p.detach() for k, p in params.items()}}


def _cross_layers(rc: Dict):
    """One entry per cross-attention layer of the UNet."""
    ch, lpb = rc["unet"]["channels"], rc["unet"]["layers_per_block"]
    n = len(ch)
    for _ in range((n - 1) * lpb + 1 + (n - 1) * (lpb + 1)):
        yield None
