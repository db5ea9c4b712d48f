"""Multi-GPU serving and training of the port over torch.distributed: the
counterpart of photoverse_tpu/parallel/.

  mesh.py     - the process group, the backend rule, the (data, model) mesh
                as subgroups, the collectives (staged through host memory
                under gloo) and their autograd forms for training (Megatron's
                f and g, the shard gather), the batch split, ZeRO-1's rule;
  tp.py       - Megatron tensor parallelism of the UNet's attention and
                feed-forward weights;
  sp.py       - spatial parallelism: the latent height split over the model
                group (halo convolutions, GroupNorm moments, gathered K/V);
  flash.py    - the flash kernels on each rank's share under tensor and
                spatial parallelism (training: tensor only);
  fsdp.py     - FSDP / ZeRO-3: the JAX package's shard rule, shards gathered
                for each forward;
  training.py - the training layout: each leaf's placement, the data-group
                gradient mean, the clip norms, ZeRO-1 slices, the gathers
                for a checkpoint (`shard_training`).

Modes, as in the JAX CLIs' --sharding: `data` splits the batch and runs
every kernel as one process does; `tensor` and `spatial` shard one model
replica over `--model_parallel` ranks (composing with data on a 2-D mesh),
with the fused block tail and the VAE's stream kernel off and the UNet's
flash kernel through the sharded wrapper (the JAX CLIs' configuration).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["MODES", "shard_models"]

MODES = ("data", "tensor", "spatial")


def shard_models(models, mesh, mode: str, flash: bool, flash_min_seq: Optional[int] = None):
    """Make this rank's `models` (loaded with flash, the stream kernel and
    the fused tail off under tensor / spatial) run `mode` on `mesh`:
    under tensor the UNet is cut to this rank's shard (the one place that
    cuts it), under spatial the UNet and the VAE decoder split their rows; with
    `flash` the UNet's flash kernel runs through the sharded wrapper.
    Returns the Spatial split to pass to run_inference (None otherwise)."""
    from photoverse_tpu_torch.parallel.flash import enable_sharded_flash
    from photoverse_tpu_torch.parallel.sp import Spatial, enable_spatial
    from photoverse_tpu_torch.parallel.tp import TPShard, shard_unet, validate_tp

    if mode not in MODES:
        raise ValueError(f"unknown sharding mode {mode!r} (expected one of {MODES})")
    if mode == "data":
        return None
    comm = mesh.model_comm
    if mode == "tensor":
        models.unet = shard_unet(models.unet, TPShard(mesh.model_rank, mesh.mp, comm))
    if flash:
        enable_sharded_flash(models, comm, mode, flash_min_seq)
    if mode == "tensor":
        validate_tp(models.unet.config, mesh.mp)
        return None
    if models.unet.config.fused_blocks:
        raise ValueError("spatial parallelism requires fused_blocks off (the fused block-tail kernel has no "
                         "sharded wrapper)")
    spatial = Spatial(comm)
    enable_spatial(models.unet, spatial)
    enable_spatial(models.vae.decoder, spatial)
    return spatial
