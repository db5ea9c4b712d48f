"""SD-1.5 VAE: the `Encoder` with `quant_conv` (`encode_moments`,
`encode_sample`) and `post_quant_conv` with the `Decoder` (`decode`). Port
of photoverse_tpu/models/vae.py.

Module names follow the diffusers AutoencoderKL state dict (`encoder.*`,
`quant_conv`, `decoder.*`, `post_quant_conv`), which `convert_vae` reads.
Public tensors are NHWC; every GroupNorm uses eps 1e-6. With
use_flash_attention the mid blocks' single-head attention at S >= 1024
(S=4096, d=512 at 512px) takes the streaming flash kernel: the no-grad
forward under torch.no_grad(), the differentiable one (lse forward,
chunked backward) when grad is enabled (the face loss backpropagates
through the decoder).

`remat` (the decoder only, as in the JAX package): when grad is enabled the
mid block, each resnet block and each upsampler keep only their inputs and
recompute their activations in the backward, so the mid block's stream
flash launches its lse forward a second time.

Under spatial parallelism (parallel/sp.py) the decoder's rows are split
over the model group: its 3x3 convolutions (the f32 conv_out too) and
GroupNorms exchange rows or moments, and the mid block's attention keeps
its query rows and gathers K and V, on the plain route (the stream kernel
has no sharded wrapper). The encoder always runs whole.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F

from photoverse_tpu_torch.models.layers import Conv2d, Group, GroupNorm, ResnetBlock, Sampler, remat
from photoverse_tpu_torch.ops.flash_sdpa import flash_sdpa_stream, flash_sdpa_stream_diff

__all__ = ["VAEConfig", "Encoder", "Decoder", "AutoencoderKL"]

GN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    use_flash_attention: bool = False
    fast_norms: bool = False
    remat: bool = False


class AttnBlock(nn.Module):
    """Single-head full spatial self-attention (VAE mid block)."""

    FLASH_MIN_SEQ = 1024
    spatial = None  # parallel.sp.Spatial

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
        if self.spatial is not None:
            if self.use_flash:
                raise ValueError("the VAE's stream kernel has no sharded wrapper: build the VAE with "
                                 "use_flash_attention off to split its rows")
            k, v = self.spatial.gather_rows(k, 1), self.spatial.gather_rows(v, 1)
        if self.use_flash and S >= self.FLASH_MIN_SEQ:
            fn = flash_sdpa_stream_diff if torch.is_grad_enabled() else flash_sdpa_stream
            ctx = fn(q[:, :, None], k[:, :, None], v[:, :, None])[:, :, 0]
        else:
            scores = torch.einsum("bqc,bkc->bqk", q.float(), k.float())
            probs = torch.softmax(scores * (C**-0.5), dim=-1).to(x.dtype)
            ctx = torch.einsum("bqk,bkc->bqc", probs.float(), v.float()).to(x.dtype)
        out = self.to_out[0](ctx)
        return x + out.transpose(1, 2).reshape(B, C, H, W)


def _mid_block(ch: int, cfg: VAEConfig) -> Group:
    G, nf = cfg.norm_num_groups, not cfg.fast_norms
    mid = Group()
    mid.resnets = nn.ModuleList([ResnetBlock(ch, ch, None, G, GN_EPS, nf) for _ in range(2)])
    mid.attentions = nn.ModuleList([AttnBlock(ch, G, nf, cfg.use_flash_attention)])
    return mid


def _run_mid(mid: Group, x: torch.Tensor) -> torch.Tensor:
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](x)))


def _conv_out_f32(conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
    """The last conv in f32, as in the reference; NCHW in, NHWC out."""
    return conv.forward_f32(x).permute(0, 2, 3, 1)


class Encoder(nn.Module):
    """pixels (B, H, W, 3) in [-1, 1] -> moments (B, H/f, W/f, 2 * latent) f32."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        G, nf = cfg.norm_num_groups, not cfg.fast_norms
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = ch[0]
        for i, c in enumerate(ch):
            blk = Group()
            blk.resnets = nn.ModuleList(
                ResnetBlock(prev if j == 0 else c, c, None, G, GN_EPS, nf)
                for j in range(cfg.layers_per_block)
            )
            if i < len(ch) - 1:
                blk.downsamplers = nn.ModuleList([Sampler(nn.Conv2d(c, c, 3, stride=2))])
            prev = c
            self.down_blocks.append(blk)
        self.mid_block = _mid_block(ch[-1], cfg)
        self.conv_norm_out = GroupNorm(G, ch[-1], GN_EPS, nf)
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(pixels.permute(0, 3, 1, 2).to(self.conv_in.weight.dtype))
        for blk in self.down_blocks:
            for r in blk.resnets:
                x = r(x)
            if hasattr(blk, "downsamplers"):
                # asymmetric (0, 1) pad, then the stride-2 conv, as the SD VAE
                x = blk.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        x = F.silu(self.conv_norm_out(_run_mid(self.mid_block, x)))
        return _conv_out_f32(self.conv_out, x)


class Decoder(nn.Module):
    spatial = None  # parallel.sp.Spatial: the split its layers were given

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = list(reversed(cfg.block_out_channels))  # (512, 512, 256, 128)
        G = cfg.norm_num_groups
        nf = not cfg.fast_norms

        def res(i, o):
            return ResnetBlock(i, o, None, G, GN_EPS, nf)

        self.conv_in = Conv2d(cfg.latent_channels, ch[0], 3, padding=1)
        self.mid_block = _mid_block(ch[0], cfg)
        self.up_blocks = nn.ModuleList()
        prev = ch[0]
        for i, c in enumerate(ch):
            blk = Group()
            blk.resnets = nn.ModuleList(
                res(prev if j == 0 else c, c) for j in range(cfg.layers_per_block + 1)
            )
            if i < len(ch) - 1:
                blk.upsamplers = nn.ModuleList([Sampler(Conv2d(c, c, 3, padding=1))])
            prev = c
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(G, ch[-1], GN_EPS, nf)
        self.conv_out = Conv2d(ch[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor, remat_blocks: bool = False) -> torch.Tensor:
        """z (B, h, w, latent) NHWC -> pixels (B, H, W, 3) f32; remat_blocks
        is the owning AutoencoderKL's config.remat."""
        run = remat if remat_blocks and torch.is_grad_enabled() else (lambda fn, *a: fn(*a))
        x = self.conv_in(z.permute(0, 3, 1, 2).to(self.conv_in.weight.dtype))
        x = run(lambda h: _run_mid(self.mid_block, h), x)
        for blk in self.up_blocks:
            for r in blk.resnets:
                x = run(r, x)
            if hasattr(blk, "upsamplers"):
                up = blk.upsamplers[0].conv
                x = run(lambda h, up=up: up(F.interpolate(h, scale_factor=2.0, mode="nearest")), x)
        return _conv_out_f32(self.conv_out, F.silu(self.conv_norm_out(x)))


def _conv1x1_f32(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv in f32 on an NHWC tensor."""
    out = F.conv2d(x.permute(0, 3, 1, 2).float(), conv.weight.float(), conv.bias.float())
    return out.permute(0, 2, 3, 1)


class AutoencoderKL(nn.Module):
    """The SD VAE: encode_moments / encode_sample (encoder + quant_conv) and
    decode (post_quant_conv + decoder)."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        # the decode half first: init_params fills parameters in this order
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)
        self.encoder = Encoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)

    def encode_moments(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixels (B, H, W, 3) in [-1, 1] -> (mean, logvar), each
        (B, h, w, latent) f32; logvar clipped to [-30, 20]."""
        moments = _conv1x1_f32(self.quant_conv, self.encoder(pixels))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode_sample(self, pixels: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """A sample of the latent distribution, mean + std * noise
        (unscaled latents); `noise` is standard normal shaped as the mean."""
        mean, logvar = self.encode_moments(pixels)
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Unscaled latents (B, h, w, 4) NHWC -> pixels (B, H, W, 3)."""
        return self.decoder(_conv1x1_f32(self.post_quant_conv, latents), self.config.remat)
