"""Layers shared by the UNet and the VAE: norms that can run in f32 inside a
bf16 model, the resnet block, the two linear forms of the cross-attention
projections (with LoRA dropout in train mode), and the containers that give
modules their diffusers key paths.

Under spatial parallelism (parallel/sp.py) a `Spatial` split set on
`Conv2d.spatial` and `GroupNorm.spatial` makes the 3x3 convolutions take
their halo rows from the neighbouring ranks and the norms sum their
moments over the model group; unset (None), both are the plain layers.

Without grad, a GroupNorm whose input is a CUDA tensor in channels_last
memory runs ops.group_norm.group_norm_nhwc (one kernel that reads the
layout as it lies, with the ResNet block's time-embedding add and the SiLU
after the norm fused in; `nhwc_route`), so the UNet's and the VAE's
no-grad forwards keep their activations channels-last from the first
convolution to the last. Every other input (NCHW, the CPU, grad enabled,
the spatial split) keeps torch's GroupNorm, the add and the SiLU as
separate operations.

Trainable weights may stay f32 masters inside a bf16 model: `Linear`
casts its weight to the activation's dtype in `forward`, as flax's
`dtype=` does, so the same module serves both.

Under tensor-parallel training a projection's `comm` (the model group)
is set: its input, and LoRA's lora_B input, go through
parallel.mesh.copy_to_model. Under data parallelism the dropout
generator may be a `RowGenerator`: the mask is drawn for the whole batch
and cut to this rank's rows, so a row's mask does not depend on the rank
it runs on."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from photoverse_tpu_torch.ops.group_norm import group_norm_nhwc
from photoverse_tpu_torch.parallel.mesh import copy_to_model

__all__ = [
    "Conv2d", "GroupNorm", "LayerNorm", "Linear", "LoraLinear", "ResnetBlock", "Group", "Sampler",
    "proj", "dropout", "remat", "replaying", "RowGenerator", "nhwc_route",
]


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose rows may be split over ranks (`spatial`)."""

    spatial = None  # parallel.sp.Spatial

    def forward(self, x: torch.Tensor, f32: bool = False) -> torch.Tensor:
        """The convolution; with `f32`, of input, weight and bias in f32."""
        if not f32 and self.spatial is None:
            return super().forward(x)
        w, b = self.weight, self.bias
        if f32:
            x, w, b = x.float(), w.float(), b.float()
        if self.spatial is None:
            return F.conv2d(x, w, b, self.stride, self.padding)
        return self.spatial.conv2d(x, w, b, self.stride[0], self.padding[0])


def nhwc_route(x: torch.Tensor) -> bool:
    """Whether a norm's input takes the channels-last kernel: a CUDA tensor
    in channels_last memory while grad is disabled (the kernel has no
    backward)."""
    return x.is_cuda and not torch.is_grad_enabled() and x.is_contiguous(memory_format=torch.channels_last)


class GroupNorm(nn.GroupNorm):
    """GroupNorm whose arithmetic runs in f32 when `f32` is set (the
    reference's default), or in the input dtype (its `fast_norms`; PyTorch's
    kernel still computes a bf16 input in f32 and rounds once). With
    `spatial` set, the moments span every rank's rows (Spatial.group_norm:
    the same f32 arithmetic, returned in the input dtype).

    forward(x, add=None, silu=False) is silu?(norm(x + add[:, :, None,
    None])); an input `nhwc_route` accepts runs all three as one kernel
    (ops.group_norm, the same f32 arithmetic for both `f32` settings, the
    SiLU before the one rounding)."""

    spatial = None  # parallel.sp.Spatial

    def __init__(self, groups: int, channels: int, eps: float, f32: bool = True):
        super().__init__(groups, channels, eps=eps)
        self.f32 = f32

    def forward(self, x: torch.Tensor, add: Optional[torch.Tensor] = None, silu: bool = False) -> torch.Tensor:
        if self.spatial is None and nhwc_route(x):
            return group_norm_nhwc(x, self.weight, self.bias, self.num_groups, self.eps, add, silu)
        if add is not None:
            x = x + add[:, :, None, None]
        if self.spatial is not None:
            y = self.spatial.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)
        elif self.f32:
            y = F.group_norm(
                x.float(), self.num_groups, self.weight.float(), self.bias.float(), self.eps
            ).to(x.dtype)
        else:
            y = super().forward(x)
        return F.silu(y) if silu else y


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


class RowGenerator:
    """A data rank's view of the generator of a whole batch: the batch has
    `total` rows and this rank holds rows [start, start + rows). A draw for
    an activation of k * rows rows (k stacked copies of the rank's rows, as
    [uncond; cond] under guidance) is made at k * total rows, as one
    process draws it, and cut to the rank's rows of each copy."""

    def __init__(self, generator: torch.Generator, total: int, start: int, rows: int):
        self.generator, self.total, self.start, self.rows = generator, total, start, rows

    def get_state(self):
        return self.generator.get_state()

    def set_state(self, state):
        self.generator.set_state(state)

    def rand(self, shape, device) -> torch.Tensor:
        k, rem = divmod(shape[0], self.rows)
        if rem:
            raise ValueError(f"an activation of {shape[0]} rows is not copies of this rank's {self.rows}")
        whole = torch.rand((k * self.total, *shape[1:]), generator=self.generator, device=device)
        own = torch.arange(self.start, self.start + self.rows, device=device)
        return whole[torch.cat([own + j * self.total for j in range(k)])]


def dropout(x: torch.Tensor, p: float, generator) -> torch.Tensor:
    """Inverted dropout with its mask drawn from `generator` (a
    torch.Generator or a RowGenerator): each element is kept with
    probability 1 - p and scaled by 1 / (1 - p)."""
    if generator is None:
        raise ValueError("dropout in train mode needs an explicit torch.Generator")
    if isinstance(generator, RowGenerator):
        u = generator.rand(x.shape, x.device)
    else:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    keep = u >= p
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
    names follow peft (`base_layer`, `lora_A.default`, `lora_B.default`).
    With `comm` set (a tensor-parallel shard: base_layer and lora_B hold
    this rank's output features, lora_A is whole) the inputs of base_layer
    and lora_B go through copy_to_model."""

    comm = None  # parallel.mesh.Comm of the model group

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
        h = copy_to_model(self.lora_A["default"](h), self.comm)
        return self.base_layer(copy_to_model(x, self.comm)) + self.lora_B["default"](h) * self.scale

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
    """A projection without LoRA: train mode and the generator do nothing;
    with `comm` set (a column-parallel shard) its input goes through
    copy_to_model."""

    comm = None  # parallel.mesh.Comm of the model group

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return super().forward(copy_to_model(x, self.comm))


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
        h = self.conv1(self.norm1(x, silu=True))
        t = self.time_emb_proj(F.silu(temb)) if self.time_emb_proj is not None else None
        h = self.conv2(self.norm2(h, add=t, silu=True))
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
