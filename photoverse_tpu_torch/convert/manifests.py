"""State-dict manifests (key -> shape) of the published checkpoints: the
port's own copy of photoverse_tpu/convert/manifests.py.

Every key name and tensor shape of the diffusers `runwayml/stable-diffusion-v1-5`
UNet and VAE and of the transformers CLIP ViT-L/14 text and vision towers,
written out from the published module layouts (no weight file needed):

  - UNet2DConditionModel, SD-1.5 config: block_out_channels (320,640,1280,
    1280), layers_per_block 2, cross_attention_dim 768, GEGLU ff,
    conv proj_in/out (use_linear_projection=False)  -> 859,520,964 params
  - AutoencoderKL, SD config: (128,256,512,512), layers_per_block 2,
    mid-block single-head attention                 ->  83,653,863 params
  - CLIPTextModel ViT-L/14: vocab 49408, width 768, 12 layers, ctx 77
                                                    -> 123,060,480 params
  - CLIPVisionModel ViT-L/14: width 1024, 24 layers, patch 14, image 224
                                                    -> 303,179,776 params

They check the port's parameter names at full width independently of the
port's own state dicts: a loader of convert/from_diffusers.py that
consumes every manifest key, and leaves no parameter of its module without
a source, has the real checkpoint's inventory.
"""

from __future__ import annotations

from typing import Dict, Tuple

Shape = Tuple[int, ...]
Manifest = Dict[str, Shape]


def _conv(m: Manifest, name: str, cout: int, cin: int, k: int = 3) -> None:
    m[name + ".weight"] = (cout, cin, k, k)
    m[name + ".bias"] = (cout,)


def _linear(m: Manifest, name: str, cout: int, cin: int, bias: bool = True) -> None:
    m[name + ".weight"] = (cout, cin)
    if bias:
        m[name + ".bias"] = (cout,)


def _norm(m: Manifest, name: str, c: int) -> None:
    m[name + ".weight"] = (c,)
    m[name + ".bias"] = (c,)


def _resnet(
    m: Manifest, p: str, cin: int, cout: int, temb: int = 0
) -> None:
    _norm(m, p + ".norm1", cin)
    _conv(m, p + ".conv1", cout, cin)
    if temb:
        _linear(m, p + ".time_emb_proj", cout, temb)
    _norm(m, p + ".norm2", cout)
    _conv(m, p + ".conv2", cout, cout)
    if cin != cout:
        _conv(m, p + ".conv_shortcut", cout, cin, k=1)


def _unet_tf_block(m: Manifest, p: str, c: int, cross: int = 768) -> None:
    """diffusers Transformer2DModel (depth 1, conv projections, GEGLU)."""
    _norm(m, p + ".norm", c)
    _conv(m, p + ".proj_in", c, c, k=1)
    b = p + ".transformer_blocks.0"
    _norm(m, b + ".norm1", c)
    _linear(m, b + ".attn1.to_q", c, c, bias=False)
    _linear(m, b + ".attn1.to_k", c, c, bias=False)
    _linear(m, b + ".attn1.to_v", c, c, bias=False)
    _linear(m, b + ".attn1.to_out.0", c, c)
    _norm(m, b + ".norm2", c)
    _linear(m, b + ".attn2.to_q", c, c, bias=False)
    _linear(m, b + ".attn2.to_k", c, cross, bias=False)
    _linear(m, b + ".attn2.to_v", c, cross, bias=False)
    _linear(m, b + ".attn2.to_out.0", c, c)
    _norm(m, b + ".norm3", c)
    _linear(m, b + ".ff.net.0.proj", 8 * c, c)  # GEGLU: 2 * (4c)
    _linear(m, b + ".ff.net.2", c, 4 * c)
    _conv(m, p + ".proj_out", c, c, k=1)


def sd15_unet_manifest(
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280),
    layers_per_block: int = 2,
    cross: int = 768,
    in_channels: int = 4,
    out_channels: int = 4,
) -> Manifest:
    """Plain (un-patched) diffusers UNet2DConditionModel state dict."""
    ch = block_out_channels
    n = len(ch)
    temb = 4 * ch[0]
    m: Manifest = {}
    _conv(m, "conv_in", ch[0], in_channels)
    _linear(m, "time_embedding.linear_1", temb, ch[0])
    _linear(m, "time_embedding.linear_2", temb, temb)

    # down path; blocks 0..n-2 are CrossAttnDownBlock2D, the last DownBlock2D
    skips = [ch[0]]
    cin = ch[0]
    for i, c in enumerate(ch):
        has_attn = i < n - 1
        for j in range(layers_per_block):
            _resnet(m, f"down_blocks.{i}.resnets.{j}", cin, c, temb)
            if has_attn:
                _unet_tf_block(m, f"down_blocks.{i}.attentions.{j}", c, cross)
            cin = c
            skips.append(c)
        if i < n - 1:
            _conv(m, f"down_blocks.{i}.downsamplers.0.conv", c, c)
            skips.append(c)

    # mid
    _resnet(m, "mid_block.resnets.0", ch[-1], ch[-1], temb)
    _unet_tf_block(m, "mid_block.attentions.0", ch[-1], cross)
    _resnet(m, "mid_block.resnets.1", ch[-1], ch[-1], temb)

    # up path; block 0 is UpBlock2D, blocks 1..n-1 CrossAttnUpBlock2D
    cin = ch[-1]
    for i, c in enumerate(reversed(ch)):
        has_attn = i > 0
        for j in range(layers_per_block + 1):
            skip = skips.pop()
            _resnet(m, f"up_blocks.{i}.resnets.{j}", cin + skip, c, temb)
            if has_attn:
                _unet_tf_block(m, f"up_blocks.{i}.attentions.{j}", c, cross)
            cin = c
        if i < n - 1:
            _conv(m, f"up_blocks.{i}.upsamplers.0.conv", c, c)

    _norm(m, "conv_norm_out", ch[0])
    _conv(m, "conv_out", out_channels, ch[0])
    return m


def _vae_attn(m: Manifest, p: str, c: int) -> None:
    _norm(m, p + ".group_norm", c)
    _linear(m, p + ".to_q", c, c)
    _linear(m, p + ".to_k", c, c)
    _linear(m, p + ".to_v", c, c)
    _linear(m, p + ".to_out.0", c, c)


def sd_vae_manifest(
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512),
    layers_per_block: int = 2,
    latent_channels: int = 4,
) -> Manifest:
    """diffusers AutoencoderKL (SD) state dict, modern to_q/to_k naming."""
    ch = block_out_channels
    n = len(ch)
    m: Manifest = {}
    # encoder
    _conv(m, "encoder.conv_in", ch[0], 3)
    cin = ch[0]
    for i, c in enumerate(ch):
        for j in range(layers_per_block):
            _resnet(m, f"encoder.down_blocks.{i}.resnets.{j}", cin, c)
            cin = c
        if i < n - 1:
            _conv(m, f"encoder.down_blocks.{i}.downsamplers.0.conv", c, c)
    _resnet(m, "encoder.mid_block.resnets.0", ch[-1], ch[-1])
    _vae_attn(m, "encoder.mid_block.attentions.0", ch[-1])
    _resnet(m, "encoder.mid_block.resnets.1", ch[-1], ch[-1])
    _norm(m, "encoder.conv_norm_out", ch[-1])
    _conv(m, "encoder.conv_out", 2 * latent_channels, ch[-1])
    # decoder
    _conv(m, "decoder.conv_in", ch[-1], latent_channels)
    _resnet(m, "decoder.mid_block.resnets.0", ch[-1], ch[-1])
    _vae_attn(m, "decoder.mid_block.attentions.0", ch[-1])
    _resnet(m, "decoder.mid_block.resnets.1", ch[-1], ch[-1])
    cin = ch[-1]
    for i, c in enumerate(reversed(ch)):
        for j in range(layers_per_block + 1):
            _resnet(m, f"decoder.up_blocks.{i}.resnets.{j}", cin, c)
            cin = c
        if i < n - 1:
            _conv(m, f"decoder.up_blocks.{i}.upsamplers.0.conv", c, c)
    _norm(m, "decoder.conv_norm_out", ch[0])
    _conv(m, "decoder.conv_out", 3, ch[0])
    _conv(m, "quant_conv", 2 * latent_channels, 2 * latent_channels, k=1)
    _conv(m, "post_quant_conv", latent_channels, latent_channels, k=1)
    return m


def _clip_layer(m: Manifest, p: str, width: int, mlp: int) -> None:
    _norm(m, p + ".layer_norm1", width)
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(m, p + f".self_attn.{proj}", width, width)
    _norm(m, p + ".layer_norm2", width)
    _linear(m, p + ".mlp.fc1", mlp, width)
    _linear(m, p + ".mlp.fc2", width, mlp)


def clip_text_manifest(
    vocab: int = 49408,
    width: int = 768,
    layers: int = 12,
    ctx: int = 77,
    mlp: int = 3072,
) -> Manifest:
    """transformers CLIPTextModel (ViT-L/14 text tower) state dict."""
    m: Manifest = {
        "text_model.embeddings.token_embedding.weight": (vocab, width),
        "text_model.embeddings.position_embedding.weight": (ctx, width),
    }
    for i in range(layers):
        _clip_layer(m, f"text_model.encoder.layers.{i}", width, mlp)
    _norm(m, "text_model.final_layer_norm", width)
    return m


def clip_vision_manifest(
    width: int = 1024,
    layers: int = 24,
    patch: int = 14,
    image: int = 224,
    mlp: int = 4096,
) -> Manifest:
    """transformers CLIPVisionModel (ViT-L/14 vision tower) state dict."""
    n_pos = (image // patch) ** 2 + 1
    m: Manifest = {
        "vision_model.embeddings.class_embedding": (width,),
        "vision_model.embeddings.patch_embedding.weight": (width, 3, patch, patch),
        "vision_model.embeddings.position_embedding.weight": (n_pos, width),
    }
    _norm(m, "vision_model.pre_layrnorm", width)  # [sic] transformers typo
    for i in range(layers):
        _clip_layer(m, f"vision_model.encoder.layers.{i}", width, mlp)
    _norm(m, "vision_model.post_layernorm", width)
    return m


def manifest_param_count(m: Manifest) -> int:
    total = 0
    for shape in m.values():
        k = 1
        for s in shape:
            k *= s
        total += k
    return total


# published parameter totals of the real checkpoints (sanity anchors)
SD15_UNET_PARAMS = 859_520_964
SD_VAE_PARAMS = 83_653_863
CLIP_TEXT_PARAMS = 123_060_480
CLIP_VISION_PARAMS = 303_179_776
