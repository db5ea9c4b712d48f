"""Model FLOPs of an SDXL configuration's served images, by the rules of
benchmark/flops.py (2 per multiply-add; matrix products, convolutions and
the two attention products only; LoRA folded into its base projections;
each cross-attention layer's context K/V once a call):

  - the UNet: levels without attention, per-level transformer depth and
    heads (attention FLOPs do not depend on the head count), linear
    proj_in / proj_out, and add_embedding on the pooled text and the six
    time ids;
  - the conditioning: the CLIP vision encoder, the image adapter's and
    both text adapters' token-0 MLPs, both text encoders (the second one's
    pooled projection too); under guidance the zero image's vision encoder
    and image adapter (the unconditional prompt is zeros: no encoder runs);
  - the VAE decode of each image.
"""

from __future__ import annotations

from typing import Dict

from benchmark import flops
from benchmark.flops import attn, conv, linear

__all__ = ["unet_parts", "generation", "text_encoders"]


def _block(hw: int, c: int, cd: int, st: int, k: int) -> Dict[str, float]:
    """One transformer block (proj_in / proj_out are its Transformer2D's)."""
    main = 4 * linear(hw, c, c) + attn(hw, hw, c)  # self-attention
    main += 2 * linear(hw, c, c)  # attn2 q and out
    main += attn(hw, st, c) + attn(hw, k, c)
    main += linear(hw, c, 8 * c) + linear(hw, 4 * c, c)  # GEGLU
    return {"main": main, "context": 2 * linear(st, cd, c) + 2 * linear(k, cd, c)}


def unet_parts(cfg: Dict, size: int, st: int, k: int) -> Dict[str, float]:
    """One UNet evaluation of one image at latent `size`: main (everything
    but the context K/V) and context."""
    u = cfg["unet"]
    ch = u["block_out_channels"]
    n = len(ch)
    lpb = u["layers_per_block"]
    cd = u["cross_attention_dim"]
    depth = u["transformer_layers_per_block"]
    attends = ["CrossAttn" in t for t in u["down_block_types"]]
    temb = 4 * ch[0]
    parts = {"main": 0.0, "context": 0.0}

    def tr(hw, level, blocks):
        parts["main"] += 2 * linear(hw, ch[level], ch[level])  # proj_in, proj_out (linear)
        for _ in range(blocks):
            t = _block(hw, ch[level], cd, st, k)
            parts["main"] += t["main"]
            parts["context"] += t["context"]

    parts["main"] += linear(1, ch[0], temb) + linear(1, temb, temb)
    parts["main"] += linear(1, u["projection_class_embeddings_input_dim"], temb) + linear(1, temb, temb)
    hw = size * size
    parts["main"] += conv(hw, u["in_channels"], ch[0], 3)
    skips = [ch[0]]
    prev = ch[0]
    for i, c in enumerate(ch):
        for j in range(lpb):
            parts["main"] += flops._resnet(hw, prev if j == 0 else c, c, temb)
            if attends[i]:
                tr(hw, i, depth[i])
            skips.append(c)
        prev = c
        if i < n - 1:
            hw //= 4
            parts["main"] += conv(hw, c, c, 3)
            skips.append(c)
    parts["main"] += 2 * flops._resnet(hw, ch[-1], ch[-1], temb)
    tr(hw, n - 1, depth[-1])
    prev = ch[-1]
    for i in range(n):
        level = n - 1 - i
        c = ch[level]
        for j in range(lpb + 1):
            parts["main"] += flops._resnet(hw, prev + skips.pop(), c, temb)
            prev = c
            if attends[level]:
                tr(hw, level, depth[level])
        if i < n - 1:
            hw *= 4
            parts["main"] += conv(hw, c, c, 3)
    parts["main"] += conv(hw, ch[0], u["out_channels"], 3)
    return parts


def text_encoders(cfg: Dict) -> float:
    """Both text encoders on one prompt, with the second's projection."""
    f = 0.0
    for key in ("text_encoder", "text_encoder_2"):
        t = cfg[key]
        f += flops._clip(t["num_hidden_layers"], t["max_position_embeddings"], t["hidden_size"],
                         t["intermediate_size"])
    t = cfg["text_encoder_2"]
    return f + linear(1, t["hidden_size"], t["projection_dim"])


def _adapter(cfg: Dict, out: int) -> float:
    """One adapter's token-0 MLPs for one image (CLS and every patch)."""
    i = cfg["vision_encoder"]
    d, h = i["hidden_size"], cfg["photoverse"]["adapter_hidden_dim"]
    rows = (i["image_size"] // i["patch_size"]) ** 2 + 1
    return linear(rows, d, h) + linear(rows, h, h) + linear(rows, h, out)


def generation(cfg: Dict, steps: int, guidance: float, images: int = 1) -> float:
    """FLOPs of `images` served images."""
    size = cfg["resolution"] // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    st = cfg["text_encoder"]["max_position_embeddings"]
    p = unet_parts(cfg, size, st, 1)
    cd = cfg["unet"]["cross_attention_dim"]
    cond = (flops.vision_encoder(cfg) + _adapter(cfg, cd) + _adapter(cfg, cfg["text_encoder"]["hidden_size"])
            + _adapter(cfg, cfg["text_encoder_2"]["hidden_size"]) + text_encoders(cfg))
    rows = images * (2 if guidance != 1.0 else 1)
    if guidance != 1.0:
        cond += flops.vision_encoder(cfg) + _adapter(cfg, cd)
    return images * cond + rows * p["context"] + rows * steps * p["main"] + images * flops.vae_decode(cfg, size)
