"""Inference engine: identity-conditioned generation with DPM-Solver++.
Port of photoverse_tpu/engine/inference.py (eval path).

  - Conditioning (CLIP-vision features of layers_idx + last, both adapters
    with token_index, the text encoder with the concept spliced in) runs
    once per call.
  - The context K/V of every cross-attention layer, and the fused
    block-tail bundles, are built once per call, outside the step loop.
  - guidance_scale == 1 evaluates only the conditional branch; above 1,
    [uncond; cond] runs as one batch, the unconditional identity coming
    from an all-zero image.
  - A Python loop over the solver steps takes the place of lax.scan.
  - `denoise(num_grad_steps=n)` runs all but the last n steps under
    torch.no_grad() with eval fusion and the cached context K/V; the last
    n steps carry gradients, recompute the context K/V (so gradients reach
    to_k_ip / to_v_ip / LoRA) and, with train=True, run the UNet in train
    mode on the caller's per-step draws (the face loss's inner generation).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch

from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
from photoverse_tpu_torch.models.assembly import PhotoVerseModels
from photoverse_tpu_torch.ops.fused_block import (
    attach_ctx,
    build_block_bundle,
    bundle_eligible,
    kernel_serves,
)

__all__ = [
    "encode_condition",
    "precompute_ctx_kv",
    "precompute_fused_bundles",
    "denoise",
    "run_inference",
]


def precompute_ctx_kv(models: PhotoVerseModels, text_ctx: torch.Tensor, id_ctx: torch.Tensor):
    """Per cross-attention layer (k, v, k_ip, v_ip), each (B, n, H, d)."""
    text_ctx = text_ctx.to(models.dtype)
    id_ctx = id_ctx.to(models.dtype)
    return tuple(blk.attn2.context_kv(text_ctx, id_ctx) for blk in models.unet.cross_attentions())


def precompute_fused_bundles(models: PhotoVerseModels, kv_cache):
    """Per-layer weight + context bundles for the fused block tail, None for
    the layers it does not serve: C > fused_block_max_channels and, for a
    model on the card, any sizes the CUDA kernel is not built for. Those
    layers keep the unfused tail."""
    cfg = models.unet.config
    out = []
    for blk, kv in zip(models.unet.cross_attentions(), kv_cache):
        c = blk.attn2.to_out[0].out_features
        served = bundle_eligible(c, cfg.num_heads, cfg.fused_block_max_channels)
        if served and kv[0].device.type == "cuda":
            served = kernel_serves(c, cfg.num_heads, kv[0].shape[1], kv[2].shape[1],
                                   blk.ff.net[2].in_features)
        if served:
            b = build_block_bundle(blk, cfg.num_heads, dtype=models.dtype)
            out.append(attach_ctx(b, kv, models.dtype))
        else:
            out.append(None)
    return tuple(out)


def encode_condition(
    models: PhotoVerseModels, pixel_values_clip: torch.Tensor, token_index: Optional[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CLIP-vision features -> (concept text embeddings, identity context).
    The features carry no gradient (the reference detaches them)."""
    with torch.no_grad():
        last, collected = models.vision_encoder(
            pixel_values_clip, collect_layers=models.image_encoder_layers_idx
        )
    feats = torch.stack([last, *collected], dim=0)  # (K, B, S, D)
    return (models.text_adapter(feats, token_index=token_index),
            models.image_adapter(feats, token_index=token_index))


def denoise(
    models: PhotoVerseModels,
    solver: DPMSolverMultistep,
    latents: torch.Tensor,  # (B, h, w, 4) f32
    text_ctx: torch.Tensor,
    id_ctx: torch.Tensor,
    uncond_text_ctx: Optional[torch.Tensor],
    uncond_id_ctx: Optional[torch.Tensor],
    guidance_scale: float,
    num_grad_steps: int = 0,
    train: bool = False,
    step_draws: Optional[Sequence[dict]] = None,
) -> torch.Tensor:
    """The full DPM-Solver++ trajectory; returns the final latents.

    With num_grad_steps = n > 0 the first N - n steps run under
    torch.no_grad() and the last n carry gradients (the reference's
    training-mode generation uses n = 1). train=True runs those n steps in
    train mode; `step_draws` then holds one dict per grad step with its
    `fusion_u` (L,) and its LoRA `dropout` generator."""
    use_cfg = guidance_scale != 1.0 and uncond_text_ctx is not None
    if train and num_grad_steps > 0 and (step_draws is None or len(step_draws) < num_grad_steps):
        raise ValueError("train=True grad steps need one step_draws entry per grad step")
    if use_cfg:
        text_ctx = torch.cat([uncond_text_ctx, text_ctx], dim=0)
        id_ctx = torch.cat([uncond_id_ctx, id_ctx], dim=0)
    # the prefix never carries gradients when grad steps follow it
    prefix_mode = torch.no_grad() if num_grad_steps > 0 else contextlib.nullcontext()
    with prefix_mode:
        kv_cache = precompute_ctx_kv(models, text_ctx, id_ctx)
    fused = None
    if models.unet.config.fused_blocks and num_grad_steps == 0:  # the UNet drops them under grad
        fused = precompute_fused_bundles(models, kv_cache)

    def eps_fn(lat, t, grad_step=None):
        x = torch.cat([lat, lat], dim=0) if use_cfg else lat
        t = t.expand(x.shape[0])
        if grad_step is None:
            eps, _ = models.unet(x, t, text_ctx, id_ctx, ctx_kv=kv_cache, fused_bundles=fused)
        else:  # recompute the context K/V so gradients reach their projections
            kw = {}
            if train:
                d = step_draws[grad_step]
                kw = dict(train=True, fusion_u=d["fusion_u"], dropout_generator=d.get("dropout"))
            eps, _ = models.unet(x, t, text_ctx, id_ctx, **kw)
        if use_cfg:
            eps_u, eps_c = eps.chunk(2, dim=0)
            eps = eps_u + guidance_scale * (eps_c - eps_u)
        return eps

    steps = solver.step_inputs(latents.device)
    n = solver.num_steps
    n_prefix = max(n - num_grad_steps, 0)
    carry = solver.init_carry(latents)
    with prefix_mode:
        for i in range(n_prefix):
            step = {k: v[i] for k, v in steps.items()}
            carry = solver.advance(step, carry, eps_fn(solver.latent(carry), step["t"]))
    for i in range(n_prefix, n):
        step = {k: v[i] for k, v in steps.items()}
        carry = solver.advance(step, carry, eps_fn(solver.latent(carry), step["t"], i - n_prefix))
    return solver.latent(carry)


@torch.inference_mode()
def run_inference(
    models: PhotoVerseModels,
    solver: DPMSolverMultistep,
    example: dict,
    generator: Optional[torch.Generator] = None,
    *,
    guidance_scale: float = 1.0,
    token_index: Optional[int] = 0,
    latent_size: int = 64,
    uncond_input_ids=None,
    initial_noise=None,
) -> torch.Tensor:
    """Generate images for a preprocessed example batch.

    example keys (NHWC, numpy or torch): pixel_values_clip (B, 224, 224, 3),
    text_input_ids (B, 77), concept_placeholder_idx (B,) or (B, 1), optional
    negative_text_input_ids. Returns images (B, H, W, 3) f32 in [-1, 1].

    `initial_noise` (B, latent, latent, in_channels) replaces the starting
    noise drawn from `generator`, so a caller can batch requests that each
    carry their own seed.
    """
    dev = models.device
    px_clip = torch.as_tensor(example["pixel_values_clip"], device=dev).to(models.dtype)
    ids = torch.as_tensor(example["text_input_ids"], device=dev).long()
    pidx = torch.as_tensor(example["concept_placeholder_idx"], device=dev).long()
    B = px_clip.shape[0]

    if initial_noise is not None:
        noise = torch.as_tensor(initial_noise, device=dev).float()
    else:
        shape = (B, latent_size, latent_size, models.unet.config.in_channels)
        noise = torch.randn(shape, generator=generator, device=dev)
    latents = noise * solver.init_noise_sigma

    concept, id_ctx = encode_condition(models, px_clip, token_index)
    text_ctx, _ = models.text_encoder(ids, concept, pidx.reshape(B))

    uncond_text_ctx = uncond_id_ctx = None
    if guidance_scale != 1.0:
        neg = example.get("negative_text_input_ids")
        if neg is None:
            neg = uncond_input_ids
        if neg is None:
            raise ValueError(
                "guidance_scale != 1 requires negative_text_input_ids or "
                "uncond_input_ids (tokenized empty prompt)"
            )
        _, uncond_id_ctx = encode_condition(models, torch.zeros_like(px_clip), token_index)
        uncond_text_ctx, _ = models.text_encoder(torch.as_tensor(neg, device=dev).long())

    latents = denoise(
        models, solver, latents, text_ctx, id_ctx, uncond_text_ctx, uncond_id_ctx, guidance_scale
    )
    images = models.vae.decode(latents / models.scaling_factor)
    return images.clamp(-1.0, 1.0)
