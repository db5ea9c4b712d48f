"""Model assembly: the six-model bundle and its random initialisation.
Port of photoverse_tpu/models/assembly.py (build_models, init_params).

`PhotoVerseModels` is one nn.Module holding the CLIP text encoder, the
CLIP vision encoder, the UNet, the VAE (decode half), and the text and
image adapters, plus the DDPM schedule; its state dict is the counterpart
of the JAX package's PhotoVerseParams. Loading a diffusers-layout
checkpoint directory is not part of this slice.
"""

from __future__ import annotations

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

__all__ = ["PhotoVerseModels", "build_models", "init_params"]

MODEL_NAMES = ("text_encoder", "vision_encoder", "unet", "vae", "text_adapter", "image_adapter")


class PhotoVerseModels(nn.Module):
    def __init__(self, text_encoder, vision_encoder, unet, vae, text_adapter, image_adapter,
                 schedule: DDPMSchedule, image_encoder_layers_idx: Tuple[int, ...]):
        super().__init__()
        self.text_encoder = text_encoder
        self.vision_encoder = vision_encoder
        self.unet = unet
        self.vae = vae
        self.text_adapter = text_adapter
        self.image_adapter = image_adapter
        self.schedule = schedule
        self.image_encoder_layers_idx = tuple(image_encoder_layers_idx)

    @property
    def num_tokens(self) -> int:
        return len(self.image_encoder_layers_idx) + 1

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
    unet_config: Optional[UNetConfig] = None,
    vae_config: Optional[VAEConfig] = None,
    text_config: Optional[CLIPTextConfig] = None,
    vision_config: Optional[CLIPVisionConfig] = None,
    device="cuda",
) -> PhotoVerseModels:
    """Construct the models at SD-1.5 scale (or the given configs) on
    `device` (the card unless the caller asks for the CPU) in `dtype`, in
    eval mode. The flags build the default configs;
    a config passed in is used as it is, as in the JAX package (LoRA comes
    in through `unet_config`)."""
    unet_cfg = unet_config or UNetConfig(
        use_flash_attention=use_flash_attention,
        fast_attention_scores=fast_attention_scores,
        fast_norms=fast_norms, fused_blocks=fused_blocks,
    )
    vae_cfg = vae_config or VAEConfig(use_flash_attention=use_flash_attention, fast_norms=fast_norms)
    text_cfg = text_config or CLIPTextConfig()
    vision_cfg = vision_config or CLIPVisionConfig()
    K = extra_num_tokens + 1
    with torch.device(device):
        adapter = lambda: PhotoVerseAdapter(  # noqa: E731
            vision_cfg.hidden_size, unet_cfg.cross_attention_dim, K
        )
        models = PhotoVerseModels(
            CLIPTextEncoder(text_cfg), CLIPVisionEncoder(vision_cfg),
            UNet2DCondition(unet_cfg), AutoencoderKL(vae_cfg),
            adapter(), adapter(),
            make_sd15_schedule(), image_encoder_layers_idx,
        )
    return models.to(dtype=dtype).eval().requires_grad_(False)


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


@torch.no_grad()
def init_params(models: PhotoVerseModels, seed: int = 0) -> PhotoVerseModels:
    """Fill every parameter from numpy (seed + model index), in place."""
    for i, name in enumerate(MODEL_NAMES):
        rng = np.random.default_rng(seed + i)
        sub = getattr(models, name)
        owners = {n: m for n, m in sub.named_modules()}
        for pname, p in sub.named_parameters():
            mod = owners[pname.rsplit(".", 1)[0]] if "." in pname else sub
            p.copy_(torch.from_numpy(_fill(pname, mod, tuple(p.shape), rng)))
    return models

