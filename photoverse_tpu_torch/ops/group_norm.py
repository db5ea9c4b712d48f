"""GroupNorm over channels-last activations, optionally with an add before
it and a SiLU after it: `group_norm_nhwc`, the no-grad forward of every
GroupNorm of the UNet and the VAE (models/layers.py routes a CUDA input in
channels_last memory here when grad is off).

    y = silu?(group_norm(x + add[:, :, None, None], groups, weight, bias, eps))

x is (N, C, H, W) in `torch.channels_last` memory, that is (N, H, W, C)
contiguous seen as NCHW; `add` is (N, C) in x's dtype and is added in that
dtype, as the unfused `h + temb[:, :, None, None]` rounds it, before the
moments. The moments and the affine are f32 and the result is rounded once
to x's dtype: the arithmetic of `layers.GroupNorm` with and without `f32`
(PyTorch's kernel computes a bf16 input in f32 too), with the SiLU taken
before the rounding rather than after it.

A CUDA tensor runs `csrc/group_norm_nhwc.cu` (bf16 or f32, weight and bias
bf16 or f32, C up to 4096 in bf16 and 2048 in f32) or raises; a CPU tensor runs `group_norm_nhwc_plain`. The
kernel has no backward, so it refuses inputs that require grad while grad
is enabled.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from photoverse_tpu_torch.ops import _build
from photoverse_tpu_torch.utils import trace

__all__ = ["group_norm_nhwc", "group_norm_nhwc_plain"]

# elements a block of the kernel takes at least (64 KB of bf16), and blocks
# per SM wanted when a batch is too small to give that many
CHUNK_ELEMS = 32768
BLOCKS_PER_SM = 2
_DTYPES = (torch.bfloat16, torch.float32)
_sms = {}


def group_norm_nhwc_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
                          add: Optional[torch.Tensor] = None, silu: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: the add in x's dtype, the norm and
    the SiLU in f32, one rounding to x's dtype."""
    if add is not None:
        x = x + add[:, :, None, None]
    y = F.group_norm(x.float(), groups, weight.float(), bias.float(), eps)
    return (F.silu(y) if silu else y).to(x.dtype)


def _chunks(N: int, HW: int, C: int, device: torch.device) -> int:
    """Pieces the kernel cuts each image's pixels into: CHUNK_ELEMS elements
    a block, or more blocks when the batch is small, at most one a pixel."""
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(math.ceil(HW * C / CHUNK_ELEMS), math.ceil(BLOCKS_PER_SM * _sms[device.index] / N))
    return min(want, HW)


def group_norm_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
                    add: Optional[torch.Tensor] = None, silu: bool = False) -> torch.Tensor:
    """GroupNorm of the channels-last x (N, C, H, W), with `add` (N, C)
    added first and SiLU after when asked; returns x's shape, dtype and
    memory format. The UNet calls it 61 times a step, so the checks are
    kept to what the kernel cannot survive."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad
                                    or (add is not None and add.requires_grad)):
        raise RuntimeError("group_norm_nhwc has no backward: call it under torch.no_grad() "
                           "(a grad-enabled forward keeps torch's GroupNorm)")
    dev = x.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return group_norm_nhwc_plain(x, weight, bias, groups, eps, add, silu)
        raise ValueError(f"group_norm_nhwc runs on CPU or CUDA tensors, got {dev}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"group_norm_nhwc reads (N, C, H, W) in channels_last memory, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    N, C, H, W = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm_nhwc: x is {x.dtype}, the CUDA kernel takes bf16 or f32")
    if groups <= 0 or C % groups:
        raise ValueError(f"group_norm_nhwc: {C} channels do not split into {groups} groups")
    for name, t, shape, dtypes in (("weight", weight, (C,), _DTYPES), ("bias", bias, (C,), (weight.dtype,)),
                                   ("add", add, (N, C), (x.dtype,))):
        if t is not None and (t.shape != shape or t.dtype not in dtypes or t.device != dev
                              or not t.is_contiguous()):
            raise ValueError(f"group_norm_nhwc: {name} must be a contiguous {shape} tensor of "
                             f"{' or '.join(map(str, dtypes))} on {dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    chunks = _chunks(N, H * W, C, dev)
    out = torch.empty_like(x)
    work = torch.empty(2 * groups * N * (chunks + 1), dtype=torch.float32, device=dev)
    code = _build.load_library().pv_group_norm_nhwc(
        x.data_ptr(), None if add is None else add.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        work.data_ptr(), N, H * W, C, groups, chunks, eps, x.dtype == torch.bfloat16, weight.dtype == torch.bfloat16,
        silu, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "pv_group_norm_nhwc")
    trace.count("launch.group_norm_nhwc")
    return out
