"""Spatial (sequence) parallelism for diffusion sampling. Port of
photoverse_tpu/parallel/sp.py.

The latent height is split over the model group: rank r holds rows
[r h / sp, (r + 1) h / sp) of every (B, C, h, w) activation of the UNet and
of the VAE decoder. What GSPMD derives from one sharding annotation in the
JAX package is written out here (`Spatial`):

  * a 3x3 convolution takes one halo row from each neighbour, zeros at the
    image edges (`conv2d`); the stride-2 downsampler needs only the row
    above, and the convolution after a nearest upsample halos the
    upsampled rows;
  * GroupNorm sums its per-shard moments over the group, in f32 and in two
    passes (mean, then the centred squares), and applies them in f32 as
    the unsharded norm does (`group_norm`);
  * self-attention keeps its local query rows and gathers K and V over the
    group: the row-major flatten makes a block of rows a contiguous block
    of the sequence (`gather_rows`); cross-attention stays local;
  * 1x1 convolutions, elementwise work and the samplers' updates are local.

`enable_spatial` installs one `Spatial` on every module of a tree that
takes it (layers.Conv2d, layers.GroupNorm, the attention layers, the
UNet's transformer blocks for the identity mask). Requirements
(`validate_sp`): sp divides the latent height at the deepest level of the
UNet (SD-1.5 at 512px: 64 rows through 3 downsamples, 8 at the bottom, so
sp in {2, 4, 8}); the flash kernel only through the sharded wrapper
(parallel/flash.py); the fused block tail off.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["Spatial", "enable_spatial", "validate_sp"]


class Spatial:
    """The latent height split over one model group (a parallel.mesh.Comm)."""

    def __init__(self, comm):
        self.comm = comm
        self.size = comm.size
        self.rank = comm.rank

    def rows(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of rows of a whole tensor along `dim`."""
        if t.shape[dim] % self.size:
            raise ValueError(f"{t.shape[dim]} rows do not split over {self.size} ranks")
        return t.chunk(self.size, dim=dim)[self.rank].contiguous()

    def gather_rows(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's block of rows along `dim`, in order."""
        return self.comm.all_gather(t, dim)

    def halos(self, x: torch.Tensor):
        """(row above, row below) of this rank's block of an NCHW tensor,
        each (B, C, 1, W): the neighbours' edge rows, zeros at the image's
        top and bottom. One all_gather of every rank's two edge rows."""
        edges = self.comm.all_gather(torch.stack([x[:, :, 0], x[:, :, -1]]), 0)
        zero = torch.zeros_like(x[:, :, :1])
        above = edges[2 * self.rank - 1][:, :, None] if self.rank > 0 else zero
        below = edges[2 * self.rank + 2][:, :, None] if self.rank < self.size - 1 else zero
        return above, below

    def conv2d(self, x, weight, bias, stride: int, padding: int) -> torch.Tensor:
        """A kxk convolution of this rank's rows, padding rows from the
        neighbours: 3x3 with padding 1 at stride 1 (above and below) or 2
        (above only: output row i reads input rows 2i-1..2i+1); 1x1 is
        local."""
        k = weight.shape[-2]
        if k == 1 and padding == 0:
            return F.conv2d(x, weight, bias, stride)
        if k != 3 or padding != 1 or stride not in (1, 2):
            raise ValueError(f"a height-sharded convolution takes 3x3 / padding 1 / stride 1 or 2, got "
                             f"{k}x{k} / {padding} / {stride}")
        above, below = self.halos(x)
        x = torch.cat([above, x, below] if stride == 1 else [above, x], dim=2)
        return F.conv2d(x, weight, bias, stride, padding=(0, 1))

    def group_norm(self, x, groups: int, weight, bias, eps: float) -> torch.Tensor:
        """GroupNorm over the whole height: f32 moments of this rank's rows
        summed over the group, mean first and then the centred squares,
        applied as F.group_norm applies them (y = x * a + b per channel,
        a = rstd * weight, b = bias - mean * a, in f32) and rounded once to
        x's dtype. F.group_norm keeps a bf16 input's arithmetic in f32 too,
        so this is the arithmetic of layers.GroupNorm with and without f32
        (fast_norms)."""
        B, C = x.shape[:2]
        xf = x.float().reshape(B, groups, -1)
        n = xf.shape[-1] * self.size
        mean = self.comm.all_reduce(xf.sum(dim=-1)) / n
        var = self.comm.all_reduce((xf - mean[..., None]).square().sum(dim=-1)) / n
        a = (torch.rsqrt(var + eps).repeat_interleave(C // groups, dim=1) * weight.float())
        b = bias.float() - mean.repeat_interleave(C // groups, dim=1) * a
        shape = (B, C) + (1,) * (x.dim() - 2)
        return (x.float() * a.reshape(shape) + b.reshape(shape)).to(x.dtype)


def enable_spatial(module, spatial: Optional[Spatial]):
    """Set `spatial` on every submodule of `module` that takes it (None
    turns the split off); returns `module`. The attention layers refuse a
    flash route without the sharded wrapper when they run."""
    for m in module.modules():
        if hasattr(type(m), "spatial"):
            m.spatial = spatial
    return module


def validate_sp(unet_config, latent_size: int, sp: int) -> None:
    """The sharded height must stay divisible through every down level
    (the stride-2 convolutions then see even blocks), and the kernels that
    cannot run sharded must be off, as in the JAX package."""
    if sp <= 1:
        return
    n_down = len(unet_config.block_out_channels) - 1
    min_h = latent_size // (2 ** n_down)
    if min_h % sp:
        raise ValueError(f"spatial axis {sp} must divide the deepest latent height {min_h} "
                         f"(latent {latent_size}, {n_down} downsamples)")
    if unet_config.use_flash_attention and unet_config.flash_fn is None:
        raise ValueError(
            "spatial parallelism needs the sharded flash wrapper "
            "(parallel.flash.enable_sharded_flash) or the plain attention path: "
            "the bare flash kernel sees one rank's tensors only"
        )
    if unet_config.fused_blocks:
        raise ValueError("spatial parallelism requires fused_blocks off (the fused block-tail kernel has no "
                         "sharded wrapper)")
