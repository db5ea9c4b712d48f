"""SD-1.5 VAE decode path: `post_quant_conv` and the `Decoder` with its
mid block. Port of photoverse_tpu/models/vae.py (the encoder comes with
`from_noised_image` in a later slice).

Module names follow the diffusers AutoencoderKL state dict
(`decoder.*`, `post_quant_conv`), which `convert_vae` reads. Public
tensors are NHWC; every GroupNorm uses eps 1e-6. With use_flash_attention
the mid block's single-head attention at S >= 1024 (S=4096, d=512 at
512px) takes the streaming flash kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F

from photoverse_tpu_torch.models.layers import Group, GroupNorm, ResnetBlock, Sampler
from photoverse_tpu_torch.ops.flash_sdpa import flash_sdpa_stream

__all__ = ["VAEConfig", "Decoder", "AutoencoderKL"]

GN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    use_flash_attention: bool = False
    fast_norms: bool = False


class AttnBlock(nn.Module):
    """Single-head full spatial self-attention (VAE mid block)."""

    FLASH_MIN_SEQ = 1024

    def __init__(self, ch: int, groups: int, norm_f32: bool, use_flash: bool):
        super().__init__()
        self.use_flash = use_flash
        self.group_norm = GroupNorm(groups, ch, GN_EPS, norm_f32)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        B, C, H, W = x.shape
        S = H * W
        h = self.group_norm(x).flatten(2).transpose(1, 2)  # (B, S, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        if self.use_flash and S >= self.FLASH_MIN_SEQ:
            ctx = flash_sdpa_stream(q[:, :, None], k[:, :, None], v[:, :, None])[:, :, 0]
        else:
            scores = torch.einsum("bqc,bkc->bqk", q.float(), k.float())
            probs = torch.softmax(scores * (C**-0.5), dim=-1).to(x.dtype)
            ctx = torch.einsum("bqk,bkc->bqc", probs.float(), v.float()).to(x.dtype)
        out = self.to_out[0](ctx)
        return x + out.transpose(1, 2).reshape(B, C, H, W)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = list(reversed(cfg.block_out_channels))  # (512, 512, 256, 128)
        G = cfg.norm_num_groups
        nf = not cfg.fast_norms

        def res(i, o):
            return ResnetBlock(i, o, None, G, GN_EPS, nf)

        self.conv_in = nn.Conv2d(cfg.latent_channels, ch[0], 3, padding=1)
        self.mid_block = Group()
        self.mid_block.resnets = nn.ModuleList([res(ch[0], ch[0]), res(ch[0], ch[0])])
        self.mid_block.attentions = nn.ModuleList([AttnBlock(ch[0], G, nf, cfg.use_flash_attention)])
        self.up_blocks = nn.ModuleList()
        prev = ch[0]
        for i, c in enumerate(ch):
            blk = Group()
            blk.resnets = nn.ModuleList(
                res(prev if j == 0 else c, c) for j in range(cfg.layers_per_block + 1)
            )
            if i < len(ch) - 1:
                blk.upsamplers = nn.ModuleList([Sampler(nn.Conv2d(c, c, 3, padding=1))])
            prev = c
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(G, ch[-1], GN_EPS, nf)
        self.conv_out = nn.Conv2d(ch[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, h, w, latent) NHWC -> pixels (B, H, W, 3) f32."""
        x = self.conv_in(z.permute(0, 3, 1, 2).to(self.conv_in.weight.dtype))
        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x)))
        for blk in self.up_blocks:
            for r in blk.resnets:
                x = r(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
        x = F.silu(self.conv_norm_out(x))
        # the last conv runs in f32, as in the reference
        out = F.conv2d(x.float(), self.conv_out.weight.float(), self.conv_out.bias.float(), padding=1)
        return out.permute(0, 2, 3, 1)


class AutoencoderKL(nn.Module):
    """Decode half of the SD VAE: decode(latents) = decoder(post_quant_conv)."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Unscaled latents (B, h, w, 4) NHWC -> pixels (B, H, W, 3)."""
        w = self.post_quant_conv
        z = F.conv2d(latents.permute(0, 3, 1, 2).float(), w.weight.float(), w.bias.float())
        return self.decoder(z.permute(0, 2, 3, 1))
