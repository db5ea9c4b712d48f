"""Plain PyTorch reference of PhotoVerse on Stable Diffusion XL base 1.0:
the SDXL UNet with dual-context (text + identity) cross-attention and LoRA
on attn2's q/k/v, its "text_time" added conditioning, both text encoders
with the concept tokens spliced in and the second one's pooled
projection, and identity-conditioned generation with DPM-Solver++(2M)
under classifier-free guidance.

It imports torch and numpy only, and from the benchmark nothing but the
SD-1.5 reference (`nets`: the layers, attention, the CLIP vision encoder,
the adapters, the VAE decoder, the solver, `Weights`, `Numerics`,
`strict_f32`), and nothing of the program under test. It computes in
float32 (the caller turns TF32 off, as `nets.strict_f32` does) and rounds
the operands of every product through `Numerics`. Weights are read by the
diffusers / transformers key schema under the bundle's prefixes (`unet.`,
`text_encoder.`, `text_encoder_2.`, `text_adapter.`, `text_adapter_2.`,
`image_adapter.`, `vision_encoder.`, `vae.`).

The published model (stabilityai/stable-diffusion-xl-base-1.0, arXiv
2307.01952) is followed layer for layer: a UNet at 320/640/1280 with no
attention at the first level, 1, 2 and 10 transformer blocks at the other
two and 10 in the mid block, 5/10/20 heads of 64, linear proj_in and
proj_out, GEGLU feed-forwards; time ids and the pooled text embedding
through `add_embedding` into the time embedding; CLIP ViT-L/14's text
tower (quick_gelu) and OpenCLIP ViT-bigG/14's (1280 wide, 32 layers, 20
heads, exact gelu), both read at hidden_states[-2], concatenated to a
2048-wide context. Departures, all PhotoVerse's or the benchmark's:
  - attn2 of every block also attends to the identity tokens
    (`processor.to_k_ip.0` / `to_v_ip.0` from the image adapter, 2048
    wide) and adds that output to the text one (PhotoVerse's eval fusion);
    LoRA on attn2.to_q / to_k / to_v;
  - the concept tokens of a text adapter per encoder (768 and 1280 wide)
    take the placeholder's place in both encoders' token embeddings;
  - one id sequence serves both encoders, and each pools at its highest
    id (the EOS), as transformers does for CLIP's own tokenizer;
  - the unconditional branch of guidance takes zero prompt and pooled
    embeddings (SDXL's force_zeros_for_empty_prompt) and the identity of
    the zero image;
  - the sampler is DPM-Solver++(2M) on SDXL's own betas (SDXL ships Euler
    with the same schedule).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import nets
from benchmark.reference.nets import conv, gn, heads, lin, ln, lora_proj, merge, resnet

__all__ = ["unet", "added_embedding", "text_encoder", "conditioning", "generate", "time_ids"]

ACTS = {"quick_gelu": lambda h: h * torch.sigmoid(1.702 * h), "gelu": F.gelu}


# ---------------------------------------------------------------------------
# UNet


def _block(W, N, b: str, h, text, idc, nh: int, lora):
    """One BasicTransformerBlock: self-attention, dual cross-attention
    (text + identity, summed), GEGLU feed-forward, each with its residual."""
    a = ln(W, b + ".norm1", h)
    q, k, v = (heads(lin(W, N, f"{b}.attn1.to_{n}", a, False), nh) for n in "qkv")
    h = h + lin(W, N, b + ".attn1.to_out.0", merge(nets.attention(N, q, k, v)))
    a = ln(W, b + ".norm2", h)
    q = heads(lora_proj(W, N, b + ".attn2.to_q", a, lora), nh)
    k = heads(lora_proj(W, N, b + ".attn2.to_k", text, lora), nh)
    v = heads(lora_proj(W, N, b + ".attn2.to_v", text, lora), nh)
    k_ip = heads(lin(W, N, b + ".attn2.processor.to_k_ip.0", idc, False), nh)
    v_ip = heads(lin(W, N, b + ".attn2.processor.to_v_ip.0", idc, False), nh)
    fused = nets.attention(N, q, k, v) + nets.attention(N, q, k_ip, v_ip)
    h = h + lin(W, N, b + ".attn2.to_out.0", merge(fused))
    a = ln(W, b + ".norm3", h)
    val, gate = lin(W, N, b + ".ff.net.0.proj", a).chunk(2, dim=-1)
    return h + lin(W, N, b + ".ff.net.2", val * F.gelu(gate))


def _transformer(W, N, p: str, x, text, idc, cfg, nh: int, depth: int):
    """GN -> permute to (B, S, C) -> linear proj_in -> `depth` blocks ->
    linear proj_out -> permute back, + x."""
    B, C, Hh, Ww = x.shape
    h = gn(W, p + ".norm", x, cfg["groups"], 1e-6).permute(0, 2, 3, 1).reshape(B, Hh * Ww, C)
    h = lin(W, N, p + ".proj_in", h)
    for d in range(depth):
        h = _block(W, N, f"{p}.transformer_blocks.{d}", h, text, idc, nh, cfg.get("lora"))
    h = lin(W, N, p + ".proj_out", h)
    return h.reshape(B, Hh, Ww, C).permute(0, 3, 1, 2) + x


def added_embedding(W, N, cfg, pooled, tids):
    """add_embedding(concat(pooled (B, D), the sinusoidal embedding of
    each of the six time ids, cos first)) -> (B, 4 * channels[0])."""
    B = pooled.shape[0]
    t = nets.timestep_embedding(tids.reshape(-1), cfg["time_ids_dim"]).reshape(B, -1)
    a = torch.cat([pooled.float(), t], dim=-1)
    return lin(W, N, "unet.add_embedding.linear_2", F.silu(lin(W, N, "unet.add_embedding.linear_1", a)))


def unet(W, N, cfg, sample, t, text, idc, pooled, tids):
    """sample (B, h, w, 4) NHWC, t (B,), text (B, St, 2048), idc (B, K,
    2048), pooled (B, 1280), tids (B, 6) -> eps (B, h, w, 4). cfg:
    channels, layers_per_block, heads, depth and attention (one each a
    level; the mid block takes the last level's), groups, time_ids_dim,
    lora (rank, alpha) or None."""
    ch = cfg["channels"]
    n = len(ch)
    G = cfg["groups"]
    lpb = cfg["layers_per_block"]

    def res(p, x):
        return resnet(W, N, p, x, temb, G, 1e-5)

    temb = nets.timestep_embedding(t, ch[0])
    temb = lin(W, N, "unet.time_embedding.linear_2", F.silu(lin(W, N, "unet.time_embedding.linear_1", temb)))
    temb = temb + added_embedding(W, N, cfg, pooled, tids)
    x = conv(W, N, "unet.conv_in", sample.permute(0, 3, 1, 2).float(), padding=1)
    skips = [x]
    for i in range(n):
        p = f"unet.down_blocks.{i}"
        for j in range(lpb):
            x = res(f"{p}.resnets.{j}", x)
            if cfg["attention"][i]:
                x = _transformer(W, N, f"{p}.attentions.{j}", x, text, idc, cfg, cfg["heads"][i], cfg["depth"][i])
            skips.append(x)
        if i < n - 1:
            x = conv(W, N, f"{p}.downsamplers.0.conv", x, stride=2, padding=1)
            skips.append(x)
    x = res("unet.mid_block.resnets.0", x)
    x = _transformer(W, N, "unet.mid_block.attentions.0", x, text, idc, cfg, cfg["heads"][-1], cfg["depth"][-1])
    x = res("unet.mid_block.resnets.1", x)
    for i in range(n):
        p = f"unet.up_blocks.{i}"
        level = n - 1 - i
        for j in range(lpb + 1):
            x = res(f"{p}.resnets.{j}", torch.cat([x, skips.pop()], dim=1))
            if cfg["attention"][level]:
                x = _transformer(W, N, f"{p}.attentions.{j}", x, text, idc, cfg, cfg["heads"][level],
                                 cfg["depth"][level])
        if i < n - 1:
            x = conv(W, N, f"{p}.upsamplers.0.conv", F.interpolate(x, scale_factor=2.0, mode="nearest"),
                     padding=1)
    x = conv(W, N, "unet.conv_out", F.silu(gn(W, "unet.conv_norm_out", x, G, 1e-5)), padding=1)
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# text encoders


def _clip_layer(W, N, p: str, x, nh: int, act, mask):
    a = ln(W, p + ".layer_norm1", x)
    q, k, v = (heads(lin(W, N, f"{p}.self_attn.{n}_proj", a), nh) for n in "qkv")
    x = x + lin(W, N, p + ".self_attn.out_proj", merge(nets.attention(N, q, k, v, mask)))
    return x + lin(W, N, p + ".mlp.fc2", act(lin(W, N, p + ".mlp.fc1", ln(W, p + ".layer_norm2", x))))


def text_encoder(W, N, pre: str, cfg, ids, concept, pidx):
    """ids (B, S) with the concept tokens (B, K, D) spliced in at pidx ->
    (hidden_states[-2]: the input of the last layer, (B, S, D); the pooled
    output: final_layer_norm at each row's highest id, through
    text_projection when cfg['projection'])."""
    x = W(pre + ".embeddings.token_embedding.weight")[ids]
    if concept is not None:
        x = nets.inject(x, concept.float(), pidx)
    S = ids.shape[1]
    x = x + W(pre + ".embeddings.position_embedding.weight")[:S][None]
    mask = torch.full((S, S), float("-inf"), device=x.device).triu(1)
    act = ACTS[cfg["act"]]
    penultimate = x
    for i in range(cfg["layers"]):
        penultimate = x
        x = _clip_layer(W, N, f"{pre}.encoder.layers.{i}", x, cfg["heads"], act, mask)
    x = ln(W, pre + ".final_layer_norm", x)
    pooled = x[torch.arange(ids.shape[0], device=x.device), ids.argmax(dim=-1)]
    if cfg.get("projection"):
        pooled = lin(W, N, pre + ".text_projection", pooled, bias=False)
    return penultimate, pooled


def conditioning(W, N, rc, px, ids, pidx, zero_image: bool = False):
    """CLIP vision features -> (context (B, S, 2048), pooled (B, 1280),
    identity context (B, 1, 2048)); with `zero_image` the identity context
    of the all-zero image alone."""
    feats = nets.vision_encoder(W, N, rc["vision"], px)
    idc = nets.adapter(W, N, "image_adapter", feats, [0])
    if zero_image:
        return None, None, idc
    c1 = nets.adapter(W, N, "text_adapter", feats, [0])
    c2 = nets.adapter(W, N, "text_adapter_2", feats, [0])
    h1, _ = text_encoder(W, N, "text_encoder", rc["text"], ids, c1, pidx)
    h2, pooled = text_encoder(W, N, "text_encoder_2", rc["text_2"], ids, c2, pidx)
    return torch.cat([h1, h2], dim=-1), pooled, idc


def time_ids(rows: int, size: int) -> np.ndarray:
    """(rows, 6) f32: original size, crop top-left, target size of an
    uncropped square `size` image."""
    return np.tile(np.asarray([size, size, 0, 0, size, size], np.float32), (rows, 1))


def generate(W, N, rc: Dict, ex: Dict, noise, steps: int, guidance: float, device) -> np.ndarray:
    """Identity-conditioned SDXL generation from `ex` (pixel_values_clip,
    text_input_ids, concept_placeholder_idx, add_time_ids) and the starting
    noise (B, h, w, 4): conditioning, DPM-Solver++(2M) under guidance, VAE
    decode, uint8 images (B, H, W, 3)."""
    px = torch.as_tensor(ex["pixel_values_clip"], device=device).float()
    ids = torch.as_tensor(ex["text_input_ids"], device=device).long()
    pidx = torch.as_tensor(ex["concept_placeholder_idx"], device=device).long().reshape(-1)
    tids = torch.as_tensor(ex["add_time_ids"], device=device).float()
    text, pooled, idc = conditioning(W, N, rc, px, ids, pidx)
    cfg_on = guidance != 1.0
    if cfg_on:
        _, _, idc0 = conditioning(W, N, rc, torch.zeros_like(px), ids, pidx, zero_image=True)
        text = torch.cat([torch.zeros_like(text), text])
        pooled = torch.cat([torch.zeros_like(pooled), pooled])
        tids = torch.cat([tids, tids])
        idc = torch.cat([idc0, idc])
    solver = nets.DPMSolver2M(steps)
    x = noise.float()
    m_prev = None
    B = x.shape[0]
    for i, t in enumerate(solver.timesteps):
        xin = torch.cat([x, x]) if cfg_on else x
        tt = torch.full((xin.shape[0],), int(t), device=device, dtype=torch.long)
        eps = unet(W, N, rc["unet"], xin, tt, text, idc, pooled, tids)
        if cfg_on:
            eu, ec = eps[:B], eps[B:]
            eps = eu + guidance * (ec - eu)
        x, m_prev = solver.step(i, x, eps, m_prev)
    img = nets.vae_decode(W, N, rc["vae"], x / rc["vae"]["scaling_factor"]).clamp(-1.0, 1.0)
    return ((img / 2.0 + 0.5).clamp(0.0, 1.0) * 255.0).round().to(torch.uint8).cpu().numpy()
