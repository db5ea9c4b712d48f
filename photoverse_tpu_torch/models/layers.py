"""Layers shared by the UNet and the VAE: norms that can run in f32 inside a
bf16 model, the resnet block, the two linear forms of the cross-attention
projections (with LoRA dropout in train mode), and the containers that give
modules their diffusers key paths.

Under spatial parallelism (parallel/sp.py) a `Spatial` split set on
`Conv2d.spatial` and `GroupNorm.spatial` makes the 3x3 convolutions take
their halo rows from the neighbouring ranks and the norms sum their
moments over the model group; unset (None), both are the plain layers.

Trainable weights may stay f32 masters inside a bf16 model: `Linear`
casts its weight to the activation's dtype in `forward`, as flax's
`dtype=` does, so the same module serves both."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

__all__ = [
    "Conv2d", "GroupNorm", "LayerNorm", "Linear", "LoraLinear", "ResnetBlock", "Group", "Sampler",
    "proj", "dropout", "remat", "replaying",
]


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose rows may be split over ranks (`spatial`)."""

    spatial = None  # parallel.sp.Spatial

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spatial is None:
            return super().forward(x)
        return self.spatial.conv2d(x, self.weight, self.bias, self.stride[0], self.padding[0])

    def forward_f32(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution with input, weight and bias in f32."""
        w, b = self.weight.float(), self.bias.float()
        if self.spatial is None:
            return F.conv2d(x.float(), w, b, self.stride, self.padding)
        return self.spatial.conv2d(x.float(), w, b, self.stride[0], self.padding[0])


class GroupNorm(nn.GroupNorm):
    """GroupNorm whose arithmetic runs in f32 when `f32` is set (the
    reference's default), or in the input dtype (its `fast_norms`; PyTorch's
    kernel still computes a bf16 input in f32 and rounds once). With
    `spatial` set, the moments span every rank's rows (Spatial.group_norm:
    the same f32 arithmetic, returned in the input dtype)."""

    spatial = None  # parallel.sp.Spatial

    def __init__(self, groups: int, channels: int, eps: float, f32: bool = True):
        super().__init__(groups, channels, eps=eps)
        self.f32 = f32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spatial is not None:
            return self.spatial.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)
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
    """nn.Linear computing in the input's dtype (an f32 master weight is
    cast to a bf16 activation's dtype)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)

    def effective_weight(self) -> torch.Tensor:
        return self.weight


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with its mask drawn from `generator`: each element
    is kept with probability 1 - p and scaled by 1 / (1 - p)."""
    if generator is None:
        raise ValueError("dropout in train mode needs an explicit torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def replaying(fn, generator: Optional[torch.Generator]):
    """`fn` made to draw the same random numbers from `generator` each time
    it runs: its first call draws as usual; a later call (the recompute in
    the backward) starts from the state the first one started from and
    leaves the generator as it found it. torch.utils.checkpoint restores
    only the default CPU and CUDA generators, not an explicit one."""
    if generator is None:
        return fn
    start = generator.get_state()
    calls = [0]

    def run(*args):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*args)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*args)
        finally:
            generator.set_state(now)

    return run


def remat(fn, *args, generator: Optional[torch.Generator] = None):
    """fn(*args) with its activations recomputed in the backward instead of
    kept (torch.utils.checkpoint, non-reentrant); the recompute draws the
    dropout masks of the first run from `generator`. Without grad it is a
    plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint

    return checkpoint(replaying(fn, generator), *args, use_reentrant=False)


class LoraLinear(nn.Module):
    """Bias-free Linear plus a LoRA branch:
    y = x W^T + (alpha / r) * drop(x) A^T B^T, where drop is dropout with
    rate `dropout` in train mode and the identity in eval mode. Parameter
    names follow peft (`base_layer`, `lora_A.default`, `lora_B.default`)."""

    def __init__(self, in_features: int, out_features: int, rank: int, alpha: float,
                 dropout: float = 0.0):
        super().__init__()
        self.scale = alpha / rank
        self.dropout = dropout
        self.base_layer = nn.Linear(in_features, out_features, bias=False)
        self.lora_A = nn.ModuleDict({"default": Linear(in_features, rank, bias=False)})
        self.lora_B = nn.ModuleDict({"default": Linear(rank, out_features, bias=False)})

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(x, self.dropout, generator) if train and self.dropout > 0 else x
        return self.base_layer(x) + self.lora_B["default"](self.lora_A["default"](h)) * self.scale

    def effective_weight(self) -> torch.Tensor:
        """(out, in) weight with the LoRA delta folded in (eval: no dropout)."""
        delta = self.lora_B["default"].weight @ self.lora_A["default"].weight
        return self.base_layer.weight + delta * self.scale


def proj(in_features: int, out_features: int, lora_rank: int = 0, lora_alpha: float = 1.0,
         lora_dropout: float = 0.0) -> nn.Module:
    """Bias-free projection, with a LoRA branch when lora_rank > 0. Both
    forms take (x, train=False, generator=None)."""
    if lora_rank > 0:
        return LoraLinear(in_features, out_features, lora_rank, lora_alpha, lora_dropout)
    return _PlainProj(in_features, out_features, bias=False)


class _PlainProj(Linear):
    """A projection without LoRA: train mode and the generator do nothing."""

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return super().forward(x)


class ResnetBlock(nn.Module):
    """GN -> SiLU -> conv -> (+ time embedding) -> GN -> SiLU -> conv, plus
    the (1x1-projected) input. The VAE's blocks have no time embedding."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: Optional[int], groups: int,
                 eps: float, norm_f32: bool):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, eps, norm_f32)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch) if temb_dim else None
        self.norm2 = GroupNorm(groups, out_ch, eps, norm_f32)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
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
