"""The flash kernel under tensor and spatial parallelism. Port of
photoverse_tpu/parallel/flash.py, which wraps the Pallas kernel in
`jax.shard_map`.

The kernel (ops/flash_sdpa.py:flash_sdpa, csrc/flash_fwd_wgmma.cu) sees one
rank's tensors. `sharded_flash(comm, mode)` gives it the mode's
decomposition over the model group `comm`:

  tensor  - q, k, v arrive with this rank's heads (the column-parallel
            projections of parallel/tp.py put them there): the kernel runs
            on the local heads, with no communication;
  spatial - q, k, v arrive with this rank's block of the sequence
            (parallel/sp.py): K and V are gathered over the group and the
            kernel attends the local Sq = S / sp query rows against all
            Skv = S keys (the no-grad forward takes Skv > Sq).

The wrapper is the no-grad forward only: under grad it raises. The
differentiable route (kernels 2 and 3 per rank) belongs to tensor-parallel
training, which the port does not have yet (ROADMAP.md, Queue 1).

`enable_sharded_flash` installs it as the UNet's `UNetConfig.flash_fn`,
the hook SelfAttention calls in place of the bare kernel. The VAE keeps its
plain attention (its stream kernel has no sharded wrapper), and the fused
block tail must be off, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from photoverse_tpu_torch.ops.flash_sdpa import flash_sdpa

__all__ = ["sharded_flash", "enable_sharded_flash"]

MODES = ("tensor", "spatial")


def sharded_flash(comm, mode: str):
    """fn(q, k, v) -> (B, Sq, H, d): the flash forward on this rank's share
    of a (B, S, H, d) attention; `mode` is "tensor" (local heads) or
    "spatial" (local query rows, K and V gathered over `comm`)."""
    if mode not in MODES:
        raise ValueError(f"unknown sharded-flash mode {mode!r} (expected one of {MODES})")

    def fn(q, k, v):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "the sharded flash wrapper is the no-grad forward; its differentiable route "
                "(tensor-parallel training) is not ported yet (ROADMAP.md, Queue 1: the training "
                "half of parallel/)")
        if mode == "spatial":
            k, v = comm.all_gather(k, 1), comm.all_gather(v, 1)
        return flash_sdpa(q, k, v)

    return fn


def enable_sharded_flash(models, comm, mode: str, flash_min_seq=None):
    """`models` with the UNet's flash self-attention routed through
    `sharded_flash(comm, mode)` (use_flash_attention on, flash_fn set);
    the weights are unchanged. Refused while fused_blocks is on."""
    unet = models.unet
    cfg = unet.config
    if cfg.fused_blocks:
        raise ValueError("fused_blocks has no sharded wrapper: build with it off under --sharding tensor|spatial")
    updates = dict(use_flash_attention=True, flash_fn=sharded_flash(comm, mode))
    if flash_min_seq is not None:
        updates["flash_min_seq"] = flash_min_seq
    unet.set_config(dataclasses.replace(cfg, **updates))
    return models
