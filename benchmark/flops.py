"""Model FLOPs the traffic needs, counted from the configuration's shapes
(2 per multiply-add; matrix products, convolutions and the two attention
products only, as torch.utils.flop_counter counts them). The count is the
benchmark's own, so work the program skips or repeats does not move it:

  - a generation: the conditioning (CLIP vision, the adapters' token-0
    MLPs, the text encoder with the concept spliced in; under guidance the
    zero image and the empty prompt too), the context K/V of each
    cross-attention layer once, every UNet evaluation (doubled under
    guidance) with LoRA folded into its base projections, the VAE decode;
  - a training step: the VAE encode, every forward pass, the UNet's and
    the text encoder's backward to their inputs, the trainables' weight
    gradients, the face branch's sampling, decode and ArcFace and their
    backward; never the remat recompute.
"""

from __future__ import annotations

from typing import Dict, Sequence

__all__ = ["conv", "linear", "attn", "unet_forward", "vae_decode", "vae_encode", "text_encoder",
           "vision_encoder", "adapter", "arcface", "generation", "train_step", "PEAK_FLOPS"]

PEAK_FLOPS = 989e12  # one H100 SXM, dense bf16 (NVIDIA's data sheet)


def linear(tokens: int, fin: int, fout: int) -> float:
    return 2.0 * tokens * fin * fout


def conv(hw_out: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * hw_out * cin * cout * k * k


def attn(sq: int, skv: int, width: int) -> float:
    """q k^T and p v over all heads of total width `width`."""
    return 4.0 * sq * skv * width


def _resnet(hw: int, cin: int, cout: int, temb: int) -> float:
    f = conv(hw, cin, cout, 3) + conv(hw, cout, cout, 3)
    if temb:
        f += linear(1, temb, cout)
    if cin != cout:
        f += conv(hw, cin, cout, 1)
    return f


def _transformer(hw: int, c: int, cd: int, st: int, k: int, lora: int, context: bool) -> Dict[str, float]:
    """{"main": ..., "context": ..., "lora": ...} of one transformer block
    per image: the context projections and the LoRA branches apart."""
    main = 2 * conv(hw, c, c, 1)  # proj_in, proj_out
    main += 4 * linear(hw, c, c) + attn(hw, hw, c)  # self-attention
    main += 2 * linear(hw, c, c)  # attn2 q and out
    main += attn(hw, st, c) + attn(hw, k, c)
    main += linear(hw, c, 8 * c) + linear(hw, 4 * c, c)  # GEGLU
    ctx = 2 * linear(st, cd, c) + 2 * linear(k, cd, c)
    lo = 0.0
    if lora:
        lo = linear(hw, c, lora) + linear(hw, lora, c) + 2 * (linear(st, cd, lora) + linear(st, lora, c))
    return {"main": main, "context": ctx if context else 0.0, "lora": lo}


def unet_parts(u: Dict, pv: Dict, size: int, st: int, k: int) -> Dict[str, float]:
    """One UNet evaluation of one image at latent `size`, in parts:
    main (everything but the below), context (the cross-attention K/V
    projections), lora (the LoRA branches), ip (to_k_ip / to_v_ip alone,
    a share of context)."""
    ch = u["block_out_channels"]
    lpb = u["layers_per_block"]
    cd = u["cross_attention_dim"]
    temb = 4 * ch[0]
    r = pv.get("lora_rank", 0)
    parts = {"main": 0.0, "context": 0.0, "lora": 0.0, "ip": 0.0}

    def tr(hw, c):
        t = _transformer(hw, c, cd, st, k, r, True)
        for key in ("main", "context", "lora"):
            parts[key] += t[key]
        parts["ip"] += 2 * linear(k, cd, c)

    n = len(ch)
    parts["main"] += linear(1, ch[0], temb) + linear(1, temb, temb)
    hw = size * size
    parts["main"] += conv(hw, u["in_channels"], ch[0], 3)
    res_hw = hw
    skips = [ch[0]]
    prev = ch[0]
    for i, c in enumerate(ch):
        for j in range(lpb):
            parts["main"] += _resnet(res_hw, prev if j == 0 else c, c, temb)
            if i < n - 1:
                tr(res_hw, c)
            skips.append(c)
        prev = c
        if i < n - 1:
            res_hw //= 4
            parts["main"] += conv(res_hw, c, c, 3)
            skips.append(c)
    parts["main"] += 2 * _resnet(res_hw, ch[-1], ch[-1], temb)
    tr(res_hw, ch[-1])
    rev = list(reversed(ch))
    prev = ch[-1]
    for i, c in enumerate(rev):
        for j in range(lpb + 1):
            parts["main"] += _resnet(res_hw, prev + skips.pop(), c, temb)
            prev = c
            if i > 0:
                tr(res_hw, c)
        if i < n - 1:
            res_hw *= 4
            parts["main"] += conv(res_hw, c, c, 3)
    parts["main"] += conv(res_hw, ch[0], u["out_channels"], 3)
    return parts


def unet_forward(cfg: Dict, size: int, st: int, k: int, lora_branch: bool = True) -> float:
    """One whole UNet forward of one image, as the plain reference runs it."""
    p = unet_parts(cfg["unet"], cfg["photoverse"], size, st, k)
    return p["main"] + p["context"] + (p["lora"] if lora_branch else 0.0)


def _vae_mid(hw: int, c: int) -> float:
    return 2 * _resnet(hw, c, c, 0) + 4 * linear(hw, c, c) + attn(hw, hw, c)


def vae_decode(cfg: Dict, size: int) -> float:
    """One image from a latent of `size` x `size`."""
    v = cfg["vae"]
    ch = list(reversed(v["block_out_channels"]))
    hw = size * size
    lat = v["latent_channels"]
    f = conv(hw, lat, lat, 1) + conv(hw, lat, ch[0], 3) + _vae_mid(hw, ch[0])
    prev = ch[0]
    for i, c in enumerate(ch):
        for j in range(v["layers_per_block"] + 1):
            f += _resnet(hw, prev if j == 0 else c, c, 0)
        prev = c
        if i < len(ch) - 1:
            hw *= 4
            f += conv(hw, c, c, 3)
    return f + conv(hw, ch[-1], v["out_channels"], 3)


def vae_encode(cfg: Dict, res: int) -> float:
    """The moments of one `res` x `res` image."""
    v = cfg["vae"]
    ch = v["block_out_channels"]
    hw = res * res
    lat = v["latent_channels"]
    f = conv(hw, v["in_channels"], ch[0], 3)
    prev = ch[0]
    for i, c in enumerate(ch):
        for j in range(v["layers_per_block"]):
            f += _resnet(hw, prev if j == 0 else c, c, 0)
        prev = c
        if i < len(ch) - 1:
            hw //= 4
            f += conv(hw, c, c, 3)
    f += _vae_mid(hw, ch[-1]) + conv(hw, ch[-1], 2 * lat, 3) + conv(hw, 2 * lat, 2 * lat, 1)
    return f


def _clip(layers: int, s: int, d: int, inter: int) -> float:
    return layers * (4 * linear(s, d, d) + attn(s, s, d) + linear(s, d, inter) + linear(s, inter, d))


def text_encoder(cfg: Dict) -> float:
    t = cfg["text_encoder"]
    return _clip(t["num_hidden_layers"], t["max_position_embeddings"], t["hidden_size"], t["intermediate_size"])


def vision_encoder(cfg: Dict) -> float:
    i = cfg["vision_encoder"]
    p = (i["image_size"] // i["patch_size"]) ** 2
    return (conv(p, 3, i["hidden_size"], i["patch_size"])
            + _clip(i["num_hidden_layers"], p + 1, i["hidden_size"], i["intermediate_size"]))


def adapter(cfg: Dict, tokens: int) -> float:
    """`tokens` of one adapter for one image: the CLS MLP and the patch
    MLP over every patch."""
    i = cfg["vision_encoder"]
    d, h, cd = i["hidden_size"], cfg["photoverse"]["adapter_hidden_dim"], cfg["unet"]["cross_attention_dim"]
    rows = (i["image_size"] // i["patch_size"]) ** 2 + 1
    return tokens * (linear(rows, d, h) + linear(rows, h, h) + linear(rows, h, cd))


def arcface(cfg: Dict) -> float:
    f = cfg["face_model"]
    s = f["input_size"]
    hw = s * s
    total = conv(hw, 1, 64, 3)
    hw //= 4  # max pool
    in_ch = 64
    for si, (planes, blocks) in enumerate(zip(f["channels"], f["layers"])):
        for bi in range(blocks):
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            out_hw = hw // (stride * stride)
            total += conv(hw, in_ch, in_ch, 3) + conv(out_hw, in_ch, planes, 3)
            if bi == 0 and (stride != 1 or in_ch != planes):
                total += conv(out_hw, in_ch, planes, 1)
            hw, in_ch = out_hw, planes
    return total + linear(1, in_ch * hw, f["embedding_dim"])


def _conditioning(cfg: Dict, rows: int, guidance: float, tokens: Sequence[int] = (1, 1)) -> float:
    """Conditioning of `rows` images: vision, text adapter and image
    adapter tokens, text encoder; under guidance the zero image's vision
    and image adapter, and the empty prompt's text encoder."""
    f = rows * (vision_encoder(cfg) + adapter(cfg, tokens[0]) + adapter(cfg, tokens[1]) + text_encoder(cfg))
    if guidance != 1.0:
        f += rows * (vision_encoder(cfg) + adapter(cfg, tokens[1]) + text_encoder(cfg))
    return f


def generation(cfg: Dict, steps: int, guidance: float, images: int = 1) -> float:
    """FLOPs of `images` served images of one configuration."""
    size = cfg["resolution"] // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    st = cfg["text_encoder"]["max_position_embeddings"]
    p = unet_parts(cfg["unet"], cfg["photoverse"], size, st, 1)
    rows = images * (2 if guidance != 1.0 else 1)
    return (_conditioning(cfg, images, guidance) + rows * p["context"] + rows * steps * p["main"]
            + images * vae_decode(cfg, size))


def train_step(cfg: Dict) -> float:
    """FLOPs of one optimizer step of the configuration's recipe."""
    r = cfg["recipe"]
    micro, accum, face_rows = r["micro_batch"], r["accumulation"], r["face_rows"]
    res = cfg["resolution"]
    size = res // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    st = cfg["text_encoder"]["max_position_embeddings"]
    K = cfg["photoverse"]["extra_num_tokens"] + 1
    te = text_encoder(cfg)

    # main branch: frozen encoders forward; adapters forward and backward
    # (weights and inner inputs); text encoder forward and backward to its
    # inputs; the UNet forward (train mode: LoRA branch, context each
    # call) and backward to its inputs, plus the trainables' weights
    p = unet_parts(cfg["unet"], cfg["photoverse"], size, st, K)
    unet_fwd = p["main"] + p["context"] + p["lora"]
    unet_train = 2 * unet_fwd + p["lora"] + p["ip"]
    main = micro * (vae_encode(cfg, res) + vision_encoder(cfg) + 3 * 2 * adapter(cfg, K) + 2 * te + unet_train)

    # face branch on the window's last micro-step: `face_rows` images,
    # guidance g (doubled UNet rows), `steps` sampler steps, the last with grad
    g = r["face_guidance"]
    rows = face_rows * (2 if g != 1.0 else 1)
    q = unet_parts(cfg["unet"], cfg["photoverse"], size, st, 1)
    face = face_rows * (vae_encode(cfg, res) + 2 * vision_encoder(cfg))
    face += face_rows * (3 * adapter(cfg, 1) * 3) + face_rows * (2 * te + te)
    face += rows * (q["context"] + (r["face_steps"] - 1) * q["main"])
    face += rows * (2 * (q["main"] + q["context"] + q["lora"]) + q["lora"] + q["ip"])
    face += face_rows * 2 * vae_decode(cfg, size)
    face += face_rows * (arcface(cfg) + 2 * arcface(cfg))
    return accum * main + face
