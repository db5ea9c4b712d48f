"""Layers shared by the UNet and the VAE: norms that can run in f32 inside a
bf16 model, the resnet block, the two linear forms of the cross-attention
projections, and the containers that give modules their diffusers key paths."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

__all__ = ["GroupNorm", "LayerNorm", "Linear", "LoraLinear", "ResnetBlock", "Group", "Sampler", "proj"]


class GroupNorm(nn.GroupNorm):
    """GroupNorm whose arithmetic runs in f32 when `f32` is set (the
    reference's default), or in the input dtype (its `fast_norms`)."""

    def __init__(self, groups: int, channels: int, eps: float, f32: bool = True):
        super().__init__(groups, channels, eps=eps)
        self.f32 = f32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.f32:
            return F.group_norm(
                x.float(), self.num_groups, self.weight.float(), self.bias.float(), self.eps
            ).to(x.dtype)
        return super().forward(x)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with the same f32 switch as GroupNorm."""

    def __init__(self, dim: int, eps: float = 1e-5, f32: bool = True):
        super().__init__(dim, eps=eps)
        self.f32 = f32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.f32:
            return F.layer_norm(
                x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps
            ).to(x.dtype)
        return super().forward(x)


class Linear(nn.Linear):
    def effective_weight(self) -> torch.Tensor:
        return self.weight


class LoraLinear(nn.Module):
    """Bias-free Linear plus a LoRA branch, eval mode (no dropout):
    y = x W^T + (alpha / r) * x A^T B^T. Parameter names follow peft
    (`base_layer`, `lora_A.default`, `lora_B.default`)."""

    def __init__(self, in_features: int, out_features: int, rank: int, alpha: float):
        super().__init__()
        self.scale = alpha / rank
        self.base_layer = nn.Linear(in_features, out_features, bias=False)
        self.lora_A = nn.ModuleDict({"default": nn.Linear(in_features, rank, bias=False)})
        self.lora_B = nn.ModuleDict({"default": nn.Linear(rank, out_features, bias=False)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.base_layer(x) + self.lora_B["default"](self.lora_A["default"](x)) * self.scale

    def effective_weight(self) -> torch.Tensor:
        """(out, in) weight with the LoRA delta folded in."""
        delta = self.lora_B["default"].weight @ self.lora_A["default"].weight
        return self.base_layer.weight + delta * self.scale


def proj(in_features: int, out_features: int, lora_rank: int = 0, lora_alpha: float = 1.0) -> nn.Module:
    """Bias-free projection, with a LoRA branch when lora_rank > 0."""
    if lora_rank > 0:
        return LoraLinear(in_features, out_features, lora_rank, lora_alpha)
    return Linear(in_features, out_features, bias=False)


class ResnetBlock(nn.Module):
    """GN -> SiLU -> conv -> (+ time embedding) -> GN -> SiLU -> conv, plus
    the (1x1-projected) input. The VAE's blocks have no time embedding."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: Optional[int], groups: int,
                 eps: float, norm_f32: bool):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, eps, norm_f32)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch) if temb_dim else None
        self.norm2 = GroupNorm(groups, out_ch, eps, norm_f32)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        sc = self.conv_shortcut(x) if self.conv_shortcut is not None else x
        return sc + h


class Group(nn.Module):
    """A module that only groups submodules (a diffusers block's
    `resnets` / `attentions` / `*samplers` key path)."""


class Sampler(nn.Module):
    """An up- or downsampler: holds its conv as `.conv`."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        self.conv = conv
