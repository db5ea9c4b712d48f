"""Inference engine: identity-conditioned generation with any sampler of
core/schedulers.py. Port of photoverse_tpu/engine/inference.py.

  - Conditioning (CLIP-vision features of layers_idx + last, both adapters
    with token_index, the text encoder with the concept spliced in) runs
    once per call.
  - The context K/V of every cross-attention layer, and the fused
    block-tail bundles, are built once per call, outside the step loop.
  - guidance_scale == 1 evaluates only the conditional branch; above 1,
    [uncond; cond] runs as one batch, the unconditional identity coming
    from an all-zero image.
  - A Python loop over the solver steps takes the place of lax.scan. It is
    written against the solver's carry (`init_carry`, `latent`,
    `replace_latent`, `advance`), so every sampler rides it, and it calls
    nothing that waits for the device: a whole trajectory is enqueued
    without a synchronisation, which the serving loop relies on.
  - Ancestral samplers add `noise_sigma[i] * z` after each update. z comes
    per batch row, from the row's own generator (or as an explicit tensor),
    so a row's trajectory does not depend on the batch it runs in.
  - `ip_mask` restricts where the identity acts (doubled under guidance);
    the fused tail is off then.
  - `denoise(num_grad_steps=n)` runs all but the last n steps under
    torch.no_grad() with eval fusion and the cached context K/V; the last
    n steps carry gradients, recompute the context K/V (so gradients reach
    to_k_ip / to_v_ip / LoRA) and, with train=True, run the UNet in train
    mode on the caller's per-step draws (the face loss's inner generation).
  - Multi-GPU (parallel/): `spatial` (a parallel.sp.Spatial, where the JAX
    package takes `latent_sharding`) splits the latent rows over the model
    group: every draw is made whole, as one process makes it, and cut to
    the rank's rows; conditioning runs whole on every rank; the decoded
    rows are gathered. The data split happens outside: `draw_noise` makes
    a batch's draws as run_inference would, and the caller passes each
    rank its rows.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
from photoverse_tpu_torch.models.assembly import PhotoVerseModels
from photoverse_tpu_torch.ops.fused_block import (
    attach_ctx,
    build_block_bundle,
    bundle_eligible,
    kernel_serves,
)
from photoverse_tpu_torch.utils import trace

__all__ = [
    "encode_condition",
    "precompute_ctx_kv",
    "precompute_fused_bundles",
    "row_seed",
    "make_row_generators",
    "draw_initial_noise",
    "draw_ancestral_noise",
    "draw_noise",
    "denoise",
    "run_inference",
    "run_inference_sharded",
]

_ROW_TAG = 0xA9CE  # marks the seeds of the per-row ancestral generators


def row_seed(seed: int, row: int) -> int:
    """The seed of row `row`'s ancestral-noise generator for a request
    seeded `seed`: ((seed xor 0xA9CE) * 2^20 + row) mod 2^63. Distinct for
    every (seed, row) with seed < 2^43 and row < 2^20."""
    return (((int(seed) ^ _ROW_TAG) << 20) + int(row)) % (1 << 63)


def make_row_generators(seed: int, n: int, device) -> list:
    """One generator per batch row of a request seeded `seed`, on `device`."""
    return [torch.Generator(device=device).manual_seed(row_seed(seed, r)) for r in range(n)]


def draw_initial_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal f32 of `shape`, drawn on the generator's device."""
    return torch.randn(tuple(shape), generator=generator, device=generator.device).to(device)


def draw_ancestral_noise(row_generators: Sequence[torch.Generator], num_steps: int,
                         row_shape, device) -> torch.Tensor:
    """(N, B, *row_shape) f32: row b's noise for all N steps is one draw of
    (N, *row_shape) from row_generators[b], step i reading its i-th slice.
    Steps whose noise_sigma is 0 consume their slice all the same, so the
    stream does not depend on the sampler's zero pattern."""
    rows = [draw_initial_noise(g, (num_steps, *row_shape), device) for g in row_generators]
    return torch.stack(rows, dim=1)


def draw_noise(models: PhotoVerseModels, solver, generator: torch.Generator, batch: int,
               latent_size: int, from_noised_image: bool = False) -> dict:
    """The draws run_inference makes from `generator` for a batch of
    `batch` rows when the caller passes none: {"initial_noise",
    "vae_noise" (from_noised_image only), "ancestral_noise" (ancestral
    solvers only)}, each whole, on the models' device. A data-parallel
    caller draws them once and hands each rank its rows, so a row's draws
    do not depend on the number of ranks."""
    dev = models.device
    shape = (batch, latent_size, latent_size, models.unet.config.in_channels)
    out = {"initial_noise": draw_initial_noise(generator, shape, dev)}
    if from_noised_image:
        out["vae_noise"] = draw_initial_noise(generator, shape, dev)
    if solver.is_ancestral:
        gens = make_row_generators(generator.initial_seed(), batch, generator.device)
        out["ancestral_noise"] = draw_ancestral_noise(gens, solver.num_steps, shape[1:], dev)
    return out


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
    ip_mask: Optional[torch.Tensor] = None,  # (B, Hm, Wm) identity mask
    ancestral_noise: Optional[torch.Tensor] = None,  # (N, B, h, w, 4)
    row_generators: Optional[Sequence[torch.Generator]] = None,  # B of them
    spatial=None,  # parallel.sp.Spatial: `latents` are this rank's rows
) -> torch.Tensor:
    """The full trajectory of `solver`; returns the final latents.

    With num_grad_steps = n > 0 the first N - n steps run under
    torch.no_grad() and the last n carry gradients (the reference's
    training-mode generation uses n = 1). train=True runs those n steps in
    train mode; `step_draws` then holds one dict per grad step with its
    `fusion_u` (L,) and its LoRA `dropout` generator.

    An ancestral solver needs its per-step noise: `ancestral_noise`
    (N, B, h, w, 4), or `row_generators`, one per batch row, from which
    `draw_ancestral_noise` draws it before the loop.

    With `spatial`, `latents` (and the latents returned) are this rank's
    block of rows; `ancestral_noise` is whole, or drawn whole from
    `row_generators`, and cut to the same rows."""
    with trace.span("denoise"):
        use_cfg = guidance_scale != 1.0 and uncond_text_ctx is not None
        if train and num_grad_steps > 0 and (step_draws is None or len(step_draws) < num_grad_steps):
            raise ValueError("train=True grad steps need one step_draws entry per grad step")
        n = solver.num_steps
        B = latents.shape[0]
        if solver.is_ancestral:
            if ancestral_noise is None:
                if row_generators is None or len(row_generators) != B:
                    raise ValueError(
                        "an ancestral solver (noise per step) needs ancestral_noise (N, B, h, w, C) "
                        "or one generator per batch row, so that a row's trajectory does not depend "
                        "on its batch (run_inference derives the generators from its own)"
                    )
                whole = list(latents.shape[1:])
                if spatial is not None:
                    whole[0] *= spatial.size
                ancestral_noise = draw_ancestral_noise(row_generators, n, whole, latents.device)
            if spatial is not None:
                ancestral_noise = spatial.rows(ancestral_noise, 2)
            if tuple(ancestral_noise.shape) != (n, *latents.shape):
                raise ValueError(f"ancestral_noise is {tuple(ancestral_noise.shape)}, want {(n, *latents.shape)}")
        if use_cfg:
            text_ctx = torch.cat([uncond_text_ctx, text_ctx], dim=0)
            id_ctx = torch.cat([uncond_id_ctx, id_ctx], dim=0)
            if ip_mask is not None:
                ip_mask = torch.cat([ip_mask, ip_mask], dim=0)
        # the prefix never carries gradients when grad steps follow it
        prefix_mode = torch.no_grad() if num_grad_steps > 0 else contextlib.nullcontext()
        with prefix_mode:
            kv_cache = precompute_ctx_kv(models, text_ctx, id_ctx)
        fused = None
        # the UNet drops the bundles under grad and with a mask
        if models.unet.config.fused_blocks and num_grad_steps == 0 and ip_mask is None:
            fused = precompute_fused_bundles(models, kv_cache)

        def eps_fn(lat, t, grad_step=None):
            x = torch.cat([lat, lat], dim=0) if use_cfg else lat
            t = t.expand(x.shape[0])
            if grad_step is None:
                eps, _ = models.unet(x, t, text_ctx, id_ctx, ctx_kv=kv_cache, fused_bundles=fused,
                                     ip_mask=ip_mask)
            else:  # recompute the context K/V so gradients reach their projections
                kw = {}
                if train:
                    d = step_draws[grad_step]
                    kw = dict(train=True, fusion_u=d["fusion_u"], dropout_generator=d.get("dropout"))
                eps, _ = models.unet(x, t, text_ctx, id_ctx, ip_mask=ip_mask, **kw)
            if use_cfg:
                eps_u, eps_c = eps.chunk(2, dim=0)
                eps = eps_u + guidance_scale * (eps_c - eps_u)
            return eps

        steps = solver.step_inputs(latents.device)

        def advance(i, carry, grad_step=None):
            with trace.span("unet_step"):
                step = {k: v[i] for k, v in steps.items()}
                carry = solver.advance(step, carry, eps_fn(solver.latent(carry), step["t"], grad_step))
                if solver.is_ancestral:
                    lat = solver.latent(carry)
                    lat = lat + step["noise_sigma"].to(lat.dtype) * ancestral_noise[i].to(lat.dtype)
                    carry = solver.replace_latent(carry, lat)
                return carry

        n_prefix = max(n - num_grad_steps, 0)
        carry = solver.init_carry(latents)
        with prefix_mode:
            for i in range(n_prefix):
                carry = advance(i, carry)
        for i in range(n_prefix, n):
            carry = advance(i, carry, i - n_prefix)
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
    from_noised_image: bool = False,
    uncond_input_ids=None,
    ip_mask=None,
    initial_noise=None,
    ancestral_noise=None,
    row_generators: Optional[Sequence[torch.Generator]] = None,
    vae_noise=None,
    spatial=None,
) -> torch.Tensor:
    """Generate images for a preprocessed example batch.

    example keys (NHWC, numpy or torch): pixel_values_clip (B, 224, 224, 3),
    text_input_ids (B, 77), concept_placeholder_idx (B,) or (B, 1), optional
    negative_text_input_ids, and with from_noised_image pixel_values
    (B, H, W, 3) in [-1, 1]. Returns images (B, H, W, 3) f32 in [-1, 1].

    Random draws, all from `generator` (when None, a generator seeded with
    one draw from torch's global CPU generator):
      1. the starting noise (B, latent, latent, in_channels), unless
         `initial_noise` replaces it, so a caller can batch requests that
         each carry their own seed;
      2. with from_noised_image, the noise of the VAE's latent sample,
         unless `vae_noise` replaces it. The clean latents are then noised
         to the solver's first step (`solver.add_noise(lat, noise, 0)`);
         init_noise_sigma applies only to the pure-noise start;
      3. for an ancestral solver, nothing from `generator` itself: row r
         draws from its own generator, seeded
         `row_seed(generator.initial_seed(), r)`, unless `row_generators` or
         `ancestral_noise` (N, B, latent, latent, in_channels) are given. A
         row's image is therefore a function of (seed, r) and not of its
         batch. A caller that coalesces requests (cli/serve.py) makes each
         request's noise with `make_row_generators(seed, n, device)`,
         which is the same derivation.

    `spatial` (parallel.sp.Spatial; the UNet and the VAE decoder split by
    parallel.sp.enable_spatial with it) runs the denoise loop and the
    decode on this rank's latent rows: the draws above are made whole and
    cut, and the returned images are gathered whole on every rank.
    """
    if spatial is not None and (models.unet.spatial is not spatial or models.vae.decoder.spatial is not spatial):
        raise ValueError("run_inference(spatial=...) needs the UNet and the VAE decoder split with the same "
                         "Spatial (parallel.sp.enable_spatial)")
    dev = models.device
    px_clip = torch.as_tensor(example["pixel_values_clip"], device=dev).to(models.dtype)
    ids = torch.as_tensor(example["text_input_ids"], device=dev).long()
    pidx = torch.as_tensor(example["concept_placeholder_idx"], device=dev).long()
    B = px_clip.shape[0]
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(torch.randint(0, 2**62, (1,)).item()))

    if initial_noise is not None:
        noise = torch.as_tensor(initial_noise, device=dev).float()
    else:
        shape = (B, latent_size, latent_size, models.unet.config.in_channels)
        noise = draw_initial_noise(generator, shape, dev)

    if from_noised_image:
        if vae_noise is None:
            vae_noise = draw_initial_noise(generator, noise.shape, dev)
        px = torch.as_tensor(example["pixel_values"], device=dev).to(models.dtype)
        lat = models.vae.encode_sample(px, torch.as_tensor(vae_noise, device=dev).float())
        latents = solver.add_noise(lat * models.scaling_factor, noise, 0)
    else:
        latents = noise * solver.init_noise_sigma

    if solver.is_ancestral and ancestral_noise is None and row_generators is None:
        row_generators = make_row_generators(generator.initial_seed(), B, generator.device)
    if ancestral_noise is not None:
        ancestral_noise = torch.as_tensor(ancestral_noise, device=dev).float()
    if spatial is not None:
        latents = spatial.rows(latents, 1)
    if ip_mask is not None:
        ip_mask = torch.as_tensor(ip_mask, device=dev).float()

    with trace.span("conditioning"):
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
        models, solver, latents, text_ctx, id_ctx, uncond_text_ctx, uncond_id_ctx, guidance_scale,
        ip_mask=ip_mask, ancestral_noise=ancestral_noise, row_generators=row_generators, spatial=spatial,
    )
    with trace.span("decode"):
        images = models.vae.decode(latents / models.scaling_factor)
        if spatial is not None:
            images = spatial.gather_rows(images, 1)
        return images.clamp(-1.0, 1.0)


_ROW_KEYS = ("pixel_values", "pixel_values_clip", "text_input_ids", "concept_placeholder_idx",
             "negative_text_input_ids")


def run_inference_sharded(
    models: PhotoVerseModels,
    solver: DPMSolverMultistep,
    example: dict,
    generator: torch.Generator,
    mesh,
    spatial=None,
    *,
    latent_size: int = 64,
    from_noised_image: bool = False,
    uncond_input_ids=None,
    ip_mask=None,
    draws: Optional[dict] = None,
    **kw,
) -> torch.Tensor:
    """run_inference over a parallel.mesh.Mesh, as the generate CLI runs it
    under --sharding. The batch is padded to a multiple of the data ranks
    by repeating its last row (its draws too), as the JAX CLI pads it; the
    draws are made whole, as one process makes them (`draw_noise`, unless
    `draws` holds them); each data rank runs its rows (split over its
    model group by `spatial` or by the tensor-parallel UNet); the images
    are gathered over the data ranks and the padding dropped. Returns the
    whole batch's images on every rank."""
    from photoverse_tpu_torch.parallel.mesh import data_rows, pad_rows, padded_rows

    B = len(example["text_input_ids"])
    if draws is None:
        draws = draw_noise(models, solver, generator, B, latent_size, from_noised_image)
    total = padded_rows(B, mesh.dp)
    rows = data_rows(total, mesh)

    def local(x, dim=0):
        if x is None:
            return None
        x = pad_rows(x, total, dim)
        return x[rows] if dim == 0 else x[:, rows]

    ex = {k: local(np.asarray(example[k])) for k in _ROW_KEYS if example.get(k) is not None}
    images = run_inference(
        models, solver, ex, generator, latent_size=latent_size, from_noised_image=from_noised_image,
        uncond_input_ids=local(None if uncond_input_ids is None else np.asarray(uncond_input_ids)),
        ip_mask=local(None if ip_mask is None else np.asarray(ip_mask)),
        initial_noise=local(draws["initial_noise"]), vae_noise=local(draws.get("vae_noise")),
        ancestral_noise=local(draws.get("ancestral_noise"), dim=1), spatial=spatial, **kw)
    return mesh.data_comm.all_gather(images, 0)[:B]
