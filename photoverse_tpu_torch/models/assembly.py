"""Model assembly: the six-model bundle, its random initialisation and the
load path both CLIs share. Port of photoverse_tpu/models/assembly.py.

`PhotoVerseModels` is one nn.Module holding the CLIP text encoder, the
CLIP vision encoder, the UNet, the VAE, and the text and image adapters,
plus the DDPM schedule; its state dict is the counterpart of the JAX
package's PhotoVerseParams. `load_models` builds it from a local
diffusers-layout SD-1.5 directory (tokenizer/ text_encoder/ vae/ unet/
scheduler/ image_encoder/) and, optionally, a PhotoVerse checkpoint.

An SDXL bundle (`build_models(text_config_2=...)`, `sdxl_configs`) also
holds `text_encoder_2` (OpenCLIP ViT-bigG/14's text tower, with its pooled
projection) and `text_adapter_2`, the text adapter whose concept tokens go
into the second encoder; its image adapter writes the UNet's 2048-wide
context. An SD-1.5 bundle has neither (both attributes are None), so its
modules and state dict are those of the six-model bundle.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from photoverse_tpu_torch.core.schedulers import DDPMSchedule, make_sd15_schedule
from photoverse_tpu_torch.models.adapters import PhotoVerseAdapter
from photoverse_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextEncoder,
    CLIPVisionConfig,
    CLIPVisionEncoder,
)
from photoverse_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from photoverse_tpu_torch.models.vae import AutoencoderKL, VAEConfig

__all__ = ["PhotoVerseModels", "build_models", "init_params", "load_models", "cast_params", "model_configs",
           "sdxl_configs"]

MODEL_NAMES = ("text_encoder", "vision_encoder", "unet", "vae", "text_adapter", "image_adapter")
SDXL_MODEL_NAMES = ("text_encoder_2", "text_adapter_2")


class PhotoVerseModels(nn.Module):
    def __init__(self, text_encoder, vision_encoder, unet, vae, text_adapter, image_adapter,
                 schedule: DDPMSchedule, image_encoder_layers_idx: Tuple[int, ...],
                 text_encoder_2=None, text_adapter_2=None):
        super().__init__()
        self.text_encoder = text_encoder
        self.vision_encoder = vision_encoder
        self.unet = unet
        self.vae = vae
        self.text_adapter = text_adapter
        self.image_adapter = image_adapter
        self.schedule = schedule
        self.image_encoder_layers_idx = tuple(image_encoder_layers_idx)
        self.text_encoder_2 = text_encoder_2
        self.text_adapter_2 = text_adapter_2

    @property
    def sdxl(self) -> bool:
        """Whether this is an SDXL bundle (two text encoders, added
        conditioning)."""
        return self.text_encoder_2 is not None

    @property
    def model_names(self) -> Tuple[str, ...]:
        return MODEL_NAMES + (SDXL_MODEL_NAMES if self.sdxl else ())

    @property
    def num_tokens(self) -> int:
        return len(self.image_encoder_layers_idx) + 1

    @property
    def vae_scale(self) -> int:
        """Pixels per latent along a side."""
        return 2 ** (len(self.vae.config.block_out_channels) - 1)

    @property
    def scaling_factor(self) -> float:
        return self.vae.config.scaling_factor

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.conv_in.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device


def build_models(
    extra_num_tokens: int = 4,
    image_encoder_layers_idx: Tuple[int, ...] = (4, 8, 12, 16),
    dtype: torch.dtype = torch.float32,
    use_flash_attention: bool = False,
    fast_attention_scores: bool = False,
    fast_norms: bool = False,
    fused_blocks: bool = False,
    int8_conditioning: bool = False,
    unet_config: Optional[UNetConfig] = None,
    vae_config: Optional[VAEConfig] = None,
    text_config: Optional[CLIPTextConfig] = None,
    vision_config: Optional[CLIPVisionConfig] = None,
    text_config_2: Optional[CLIPTextConfig] = None,
    device="cuda",
) -> PhotoVerseModels:
    """Construct the models at SD-1.5 scale (or the given configs) on
    `device` (the card unless the caller asks for the CPU) in `dtype`, in
    eval mode. The flags build the default configs;
    a config passed in is used as it is, as in the JAX package (LoRA comes
    in through `unet_config`). `int8_conditioning` sets `int8_dense` on both
    CLIP configs: W8A8 int8 layers in the frozen encoders (ops/quant.py),
    inference-only. The UNet's and the VAE's convolution weights are
    channels_last, the layout their activations keep. `text_config_2`
    builds an SDXL bundle (see `sdxl_configs`): the second text encoder,
    its own text adapter, and the text adapters at their encoders' widths."""
    unet_cfg = unet_config or UNetConfig(
        use_flash_attention=use_flash_attention,
        fast_attention_scores=fast_attention_scores,
        fast_norms=fast_norms, fused_blocks=fused_blocks,
    )
    vae_cfg = vae_config or VAEConfig(use_flash_attention=use_flash_attention, fast_norms=fast_norms)
    text_cfg = text_config or CLIPTextConfig()
    vision_cfg = vision_config or CLIPVisionConfig()
    if int8_conditioning:
        text_cfg = dataclasses.replace(text_cfg, int8_dense=True)
        vision_cfg = dataclasses.replace(vision_cfg, int8_dense=True)
    if int8_conditioning and text_config_2 is not None:
        text_config_2 = dataclasses.replace(text_config_2, int8_dense=True)
    K = extra_num_tokens + 1
    cd = unet_cfg.cross_attention_dim
    with torch.device(device):
        adapter = lambda out: PhotoVerseAdapter(vision_cfg.hidden_size, out, K)  # noqa: E731
        sdxl = {}
        if text_config_2 is not None:
            if text_cfg.hidden_size + text_config_2.hidden_size != cd:
                raise ValueError(f"the two text encoders' widths {text_cfg.hidden_size} + "
                                 f"{text_config_2.hidden_size} must make the UNet's context {cd}")
            sdxl = dict(text_encoder_2=CLIPTextEncoder(text_config_2),
                        text_adapter_2=adapter(text_config_2.hidden_size))
        models = PhotoVerseModels(
            CLIPTextEncoder(text_cfg), CLIPVisionEncoder(vision_cfg),
            UNet2DCondition(unet_cfg), AutoencoderKL(vae_cfg),
            adapter(text_cfg.hidden_size if sdxl else cd), adapter(cd),
            make_sd15_schedule(), image_encoder_layers_idx, **sdxl,
        )
    models = models.to(dtype=dtype).eval().requires_grad_(False)
    for m in (models.unet, models.vae):
        m.to(memory_format=torch.channels_last)
    return models


def sdxl_configs(lora_rank: int = 0, lora_alpha: float = 1.0, use_flash_attention: bool = False,
                 fast_attention_scores: bool = False, fast_norms: bool = False) -> dict:
    """build_models' configuration arguments for Stable Diffusion XL base
    1.0 at its published widths (the unet/, vae/, text_encoder/ and
    text_encoder_2/ config.json files of stabilityai/stable-diffusion-xl-
    base-1.0): a three-level UNet at 320/640/1280 with no attention at the
    first level, 1, 2 and 10 transformer blocks a level (10 in the mid
    block), 5/10/20 heads of 64, linear projections, a 2048-wide context and
    "text_time" added conditioning; CLIP ViT-L/14's text tower and OpenCLIP
    ViT-bigG/14's (1280 wide, 32 layers, gelu, projection 1280), both read
    at their penultimate layer; the SD VAE with scaling factor 0.13025."""
    unet = UNetConfig(
        block_out_channels=(320, 640, 1280), layers_per_block=2, cross_attention_dim=2048, num_heads=20,
        norm_num_groups=32, lora_rank=lora_rank, lora_alpha=lora_alpha, level_heads=(5, 10, 20),
        transformer_layers_per_block=(1, 2, 10),
        attention_levels=(False, True, True), use_linear_projection=True, addition_embed_type="text_time",
        addition_time_embed_dim=256, addition_text_embed_dim=1280, use_flash_attention=use_flash_attention,
        fast_attention_scores=fast_attention_scores, fast_norms=fast_norms)
    vae = VAEConfig(scaling_factor=0.13025, use_flash_attention=use_flash_attention, fast_norms=fast_norms)
    text = CLIPTextConfig(hidden_act="quick_gelu", penultimate_output=True)
    text_2 = CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20, intermediate_size=5120,
                            hidden_act="gelu", penultimate_output=True, projection_dim=1280)
    return dict(unet_config=unet, vae_config=vae, text_config=text, text_config_2=text_2,
                vision_config=CLIPVisionConfig())


def _fill(name: str, module: nn.Module, shape, rng: np.random.Generator) -> np.ndarray:
    """The JAX package's `_numpy_fill` rules, keyed on torch names:
    zeros for biases and lora_B, ones for norm scales, N(0, 0.02) for
    embeddings, U(+-sqrt(6/fan_in)) for lora_A, and N(0, 1/fan_in)
    (LeCun normal) for every other weight."""
    leaf = name.rsplit(".", 1)[-1]
    owner = name.rsplit(".", 2)[-2] if name.count(".") else ""
    if leaf == "bias":
        return np.zeros(shape, np.float32)
    if isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
        return np.ones(shape, np.float32)
    if "lora_B" in name:
        return np.zeros(shape, np.float32)
    if "embedding" in leaf or "embedding" in owner:
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
    if "lora_A" in name:
        lim = np.sqrt(6.0 / shape[1])
        return rng.uniform(-lim, lim, shape).astype(np.float32)
    fan_in = int(np.prod(shape[1:]))  # torch (out, in[, kh, kw])
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(np.sqrt(1.0 / max(fan_in, 1)))


def init_params(models: PhotoVerseModels, seed: int = 0) -> PhotoVerseModels:
    """Fill every parameter from numpy (seed + model index), in place. Each
    model draws from its own generator in its parameters' order, so the
    models fill in threads of their own (numpy's fills release the GIL)
    and the values do not depend on it."""

    @torch.no_grad()
    def fill(i: int, name: str) -> None:
        rng = np.random.default_rng(seed + i)
        sub = getattr(models, name)
        owners = {n: m for n, m in sub.named_modules()}
        for pname, p in sub.named_parameters():
            mod = owners[pname.rsplit(".", 1)[0]] if "." in pname else sub
            p.copy_(torch.from_numpy(_fill(pname, mod, tuple(p.shape), rng)))

    from concurrent.futures import ThreadPoolExecutor

    names = models.model_names
    with ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(fill, i, name) for i, name in enumerate(names)]:
            f.result()
    return models


def _read_json(folder: str, name: str = "config.json") -> Optional[dict]:
    p = os.path.join(folder, name)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _configs_from_checkpoint(root: str, lora_rank, lora_alpha, lora_dropout):
    """Module configs from the diffusers / transformers config.json files
    where present, so a checkpoint at another scale loads correctly.
    `attention_head_dim` of an SD-1.5-style UNet config is the head count."""
    u = _read_json(os.path.join(root, "unet")) or {}
    v = _read_json(os.path.join(root, "vae")) or {}
    t = _read_json(os.path.join(root, "text_encoder")) or {}
    unet_cfg = UNetConfig(
        in_channels=u.get("in_channels", 4),
        out_channels=u.get("out_channels", 4),
        block_out_channels=tuple(u.get("block_out_channels", (320, 640, 1280, 1280))),
        layers_per_block=u.get("layers_per_block", 2),
        cross_attention_dim=u.get("cross_attention_dim", 768),
        num_heads=u["attention_head_dim"] if isinstance(u.get("attention_head_dim"), int) else 8,
        norm_num_groups=u.get("norm_num_groups", 32),
        lora_rank=lora_rank,
        lora_alpha=lora_alpha,
        lora_dropout=lora_dropout,
    )
    vae_cfg = VAEConfig(
        in_channels=v.get("in_channels", 3),
        out_channels=v.get("out_channels", 3),
        latent_channels=v.get("latent_channels", 4),
        block_out_channels=tuple(v.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=v.get("layers_per_block", 2),
        norm_num_groups=v.get("norm_num_groups", 32),
        scaling_factor=v.get("scaling_factor", 0.18215),
    )
    text_cfg = CLIPTextConfig(
        vocab_size=t.get("vocab_size", 49408),
        hidden_size=t.get("hidden_size", 768),
        num_layers=t.get("num_hidden_layers", 12),
        num_heads=t.get("num_attention_heads", 12),
        intermediate_size=t.get("intermediate_size", 3072),
        max_position_embeddings=t.get("max_position_embeddings", 77),
    )
    return unet_cfg, vae_cfg, text_cfg


def _vision_config_from(folder: str) -> CLIPVisionConfig:
    c = _read_json(folder) or {}
    if "vision_config" in c:
        c = c["vision_config"]
    return CLIPVisionConfig(
        hidden_size=c.get("hidden_size", 1024),
        num_layers=c.get("num_hidden_layers", 24),
        num_heads=c.get("num_attention_heads", 16),
        intermediate_size=c.get("intermediate_size", 4096),
        image_size=c.get("image_size", 224),
        patch_size=c.get("patch_size", 14),
    )


def model_configs(root: str) -> Tuple[UNetConfig, VAEConfig]:
    """The UNet and VAE configs of a diffusers-layout directory, read
    without loading any weight (what the CLIs validate a sharding mode
    against before they open the process group)."""
    unet_cfg, vae_cfg, _ = _configs_from_checkpoint(root, 0, 1.0, 0.0)
    return unet_cfg, vae_cfg


def _schedule_from(root: str) -> DDPMSchedule:
    c = _read_json(os.path.join(root, "scheduler"), "scheduler_config.json")
    if c is None:
        return make_sd15_schedule()
    return DDPMSchedule.create(
        num_train_timesteps=c.get("num_train_timesteps", 1000),
        beta_start=c.get("beta_start", 0.00085),
        beta_end=c.get("beta_end", 0.012),
        beta_schedule=c.get("beta_schedule", "scaled_linear"),
        prediction_type=c.get("prediction_type", "epsilon"),
        steps_offset=c.get("steps_offset", 1),
    )


def _find_weight_file(folder: str) -> str:
    for name in (
        "diffusion_pytorch_model.safetensors",
        "diffusion_pytorch_model.bin",
        "model.safetensors",
        "pytorch_model.bin",
    ):
        p = os.path.join(folder, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no weight file found under {folder}")


def load_models(
    pretrained_model_name_or_path: str,
    extra_num_tokens: int = 4,
    photoverse_path: Optional[str] = None,
    use_lora: bool = False,
    lora_rank: int = 8,
    lora_alpha: float = 1.0,
    lora_dropout: float = 0.0,
    image_encoder_path: Optional[str] = None,
    image_encoder_layers_idx: Tuple[int, ...] = (4, 8, 12, 16),
    dtype: torch.dtype = torch.float32,
    use_flash_attention: bool = False,
    fast_attention_scores: bool = False,
    fast_norms: bool = False,
    fused_blocks: bool = False,
    int8_conditioning: bool = False,
    remat: bool = False,
    seed: int = 0,
    device="cuda",
):
    """The full load path for local checkpoints.

    `pretrained_model_name_or_path` is a local diffusers-layout SD-1.5
    directory (tokenizer/ text_encoder/ vae/ unet/ subfolders);
    `image_encoder_path` a local CLIP ViT-L/14 (the `image_encoder`
    subfolder when absent). Every checkpoint is converted strictly
    (convert/from_diffusers.py); the identity projections a plain SD
    checkpoint lacks, the adapters and the LoRA factors come from
    `init_params(seed)` until `photoverse_path` (a PhotoVerse
    checkpoint, `.pt` or native `.msgpack`) overlays them. A checkpoint
    trained with LoRA re-injects LoRA from its saved config even when the
    caller passed no LoRA flags. `int8_conditioning` builds both CLIP
    encoders with W8A8 int8 layers (inference-only). `remat` recomputes the UNet's and the VAE
    decoder's block activations in the backward (training).
    The weights are stored in `dtype`, on `device` (the card unless the
    caller asks for the CPU). Returns (tokenizer, models, lora_config)."""
    from photoverse_tpu_torch.ckpt.checkpoint import load_photoverse_checkpoint, peek_lora_config
    from photoverse_tpu_torch.convert import from_diffusers as fd
    from photoverse_tpu_torch.data.tokenizer import CLIPTokenizer

    root = pretrained_model_name_or_path
    tokenizer = CLIPTokenizer.from_pretrained(root, subfolder="tokenizer")
    ie_path = image_encoder_path or os.path.join(root, "image_encoder")
    if photoverse_path is not None and not use_lora:
        # without this a LoRA checkpoint would lose both its LoRA deltas and
        # its trained base q/k/v (a rank-0 model has no slots for the former)
        saved_lora = peek_lora_config(photoverse_path)
        if saved_lora is not None:
            use_lora = True
            lora_rank = int(saved_lora.get("r", lora_rank))
            lora_alpha = float(saved_lora.get("lora_alpha", lora_alpha))
            lora_dropout = float(saved_lora.get("lora_dropout", lora_dropout))
    unet_cfg, vae_cfg, text_cfg = _configs_from_checkpoint(
        root, lora_rank if use_lora else 0, lora_alpha, lora_dropout)
    unet_cfg = dataclasses.replace(
        unet_cfg, use_flash_attention=use_flash_attention,
        fast_attention_scores=fast_attention_scores, fast_norms=fast_norms, fused_blocks=fused_blocks,
        remat=remat)
    # the VAE's 4096-token attention takes the streaming flash kernel under
    # the same flag; its GroupNorms follow fast_norms
    vae_cfg = dataclasses.replace(vae_cfg, use_flash_attention=use_flash_attention, fast_norms=fast_norms,
                                  remat=remat)
    models = build_models(
        extra_num_tokens=extra_num_tokens, image_encoder_layers_idx=image_encoder_layers_idx,
        dtype=dtype, int8_conditioning=int8_conditioning, unet_config=unet_cfg, vae_config=vae_cfg,
        text_config=text_cfg, vision_config=_vision_config_from(ie_path), device=device)
    models.schedule = _schedule_from(root)
    init_params(models, seed)

    fd.load_clip_text(models.text_encoder, fd.read_state_dict(_find_weight_file(os.path.join(root, "text_encoder"))))
    fd.load_vae(models.vae, fd.read_state_dict(_find_weight_file(os.path.join(root, "vae"))))
    fd.load_unet(models.unet, fd.read_state_dict(_find_weight_file(os.path.join(root, "unet"))))
    fd.load_clip_vision(models.vision_encoder, fd.read_state_dict(_find_weight_file(ie_path)))

    lora_config = (
        {
            "r": lora_rank,
            "lora_alpha": lora_alpha,
            "lora_dropout": lora_dropout,
            "bias": "none",
            "target_modules": ["attn2.to_k", "attn2.to_v", "attn2.to_q"],
        }
        if use_lora
        else None
    )
    if photoverse_path is not None:
        lora_config = load_photoverse_checkpoint(photoverse_path, models)
    return tokenizer, models, lora_config


def cast_params(models: PhotoVerseModels, dtype: torch.dtype = torch.bfloat16) -> PhotoVerseModels:
    """The `--bf16_params` serving knob. The port stores its weights in the
    compute dtype, so a bf16 model is unchanged; an f32 model has every
    floating weight rounded through `dtype` and keeps computing in f32,
    which is what the JAX package computes from bf16-stored weights."""
    from photoverse_tpu_torch.convert.from_diffusers import round_through

    return round_through(models, dtype)
