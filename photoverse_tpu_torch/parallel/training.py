"""Multi-rank training: which leaf is whose, and the collectives of the
sharded train step. The counterpart of the shardings photoverse_tpu/cli/train.py
hands its jitted step (TP, FSDP, ZeRO-1/3) and of the gathers before a
save.

`shard_training` takes one process's models and optimizer (built, and
resumed from a checkpoint, as one process builds them) and cuts them to
this rank's share of a (dp, mp) mesh:

  * tensor parallelism (mp > 1): the UNet becomes this rank's shard
    (parallel.shard_models; the f32 masters stay f32) with the flash
    kernels through the sharded wrapper: the lse forward and the backward
    kernel on the rank's heads;
  * FSDP (`fsdp`, dp > 1): every parameter of every model that
    parallel.fsdp.fsdp_dim splits keeps only its data shard and is
    gathered for each forward; AdamW then holds only shards (ZeRO-3);
  * ZeRO-1 (`zero1`, dp > 1, without FSDP): the parameters stay whole;
    AdamW holds and updates this rank's slice of each leaf
    (parallel.mesh.zero1_dim, or fsdp_dim beside a tensor-parallel dim, as
    the JAX CLI picks them) and the slices are all-gathered after each
    update.

The returned optimizer carries a `TrainLayout`: each leaf's `Placement`
(its tensor-parallel dim, its FSDP dim, its ZeRO-1 dim), the data-group
reduction of the gradients, the clip norms of the whole gradient, this
rank's rows of the draws, and the gathers of the whole trainables and
AdamW moments for a checkpoint (rank 0 receives them; the files are those
one process writes). Any world size resumes a checkpoint: the resumed
state is loaded whole and then cut again.

Collectives are Comm.all_reduce / all_gather / broadcast only (gloo, which
runs the ranks that share one card, has no reduce-scatter).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from photoverse_tpu_torch.parallel.fsdp import MIN_SHARD_SIZE, flax_order, fsdp_dim, shard_module
from photoverse_tpu_torch.parallel.mesh import Mesh, reduce_from_model, zero1_dim
from photoverse_tpu_torch.parallel.tp import tree_tp_dim

__all__ = ["Placement", "TrainLayout", "shard_training", "MODELS"]

# the models of a PhotoVerseModels bundle, in partition_params' order
MODELS = ("text_adapter", "image_adapter", "text_encoder", "vision_encoder", "vae", "unet")


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf's elements live: `model` is the dim split over the
    model group (tensor parallelism), `data` the dim split over the data
    group (FSDP: the parameter is a shard), `zero` the dim of the
    optimizer's slice (ZeRO-1: the parameter is whole)."""

    model: Optional[int] = None
    data: Optional[int] = None
    zero: Optional[int] = None


def _part(t: torch.Tensor, dim: Optional[int], size: int, rank: int) -> torch.Tensor:
    if dim is None or size == 1:
        return t
    return t.chunk(size, dim=dim)[rank]


class TrainLayout:
    """The placements of one rank's parameters on `mesh`, and the
    collectives of a training step over them."""

    def __init__(self, mesh: Mesh, placements: Dict[str, Placement]):
        self.mesh = mesh
        self.placements = placements

    # -- the step ----------------------------------------------------------

    def local_draws(self, draws: Dict, rows: int, face_rows: int) -> Dict:
        """This data rank's rows of the whole micro-batch's draws: the noise
        and timesteps cut, the fusion uniforms whole, the dropout generator
        a RowGenerator (the masks drawn for the whole batch)."""
        from photoverse_tpu_torch.models.layers import RowGenerator

        dp, r = self.mesh.dp, self.mesh.data_rank
        if dp == 1:
            return draws

        def cut(d, n):
            out = {}
            for k, v in d.items():
                if k in ("vae_noise", "noise", "timesteps"):
                    if v.shape[0] != n * dp:
                        raise ValueError(f"draws[{k!r}] has {v.shape[0]} rows, the micro-batch {n * dp}")
                    out[k] = v[r * n:(r + 1) * n]
                elif k == "dropout" and v is not None:
                    out[k] = RowGenerator(v, n * dp, r * n, n)
                else:
                    out[k] = v
            return out

        out = cut({k: v for k, v in draws.items() if k != "face"}, rows)
        if "face" in draws:
            out["face"] = cut(draws["face"], face_rows)
        return out

    def model_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of the model group's equal-sized local means."""
        mp = self.mesh.mp
        return x if mp == 1 else reduce_from_model(x, self.mesh.model_comm) / mp

    def data_mean(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each scalar averaged over the data group (one all_reduce)."""
        if self.mesh.dp == 1:
            return metrics
        keys = list(metrics)
        v = self.mesh.data_comm.all_reduce(torch.stack([metrics[k].float() for k in keys])) / self.mesh.dp
        return dict(zip(keys, v.unbind(0)))

    @torch.no_grad()
    def reduce_grads(self, acc: Dict[str, torch.Tensor]) -> None:
        """The data group's mean gradient, in place: the whole leaves summed
        in one flat all_reduce, the FSDP shards (summed already by their
        gather's backward) divided."""
        dp = self.mesh.dp
        if dp == 1:
            return
        whole = [k for k in acc if self.placements[k].data is None]
        if whole:
            flat = self.mesh.data_comm.all_reduce(torch.cat([acc[k].reshape(-1) for k in whole]))
            for k, piece in zip(whole, flat.split([acc[k].numel() for k in whole])):
                acc[k].copy_(piece.view_as(acc[k]))
        for g in acc.values():
            g.div_(dp)

    def global_sq(self, sq: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """{group: the whole gradient's sum of squares} from each leaf's
        local sum: shards over the data group summed over it, shards over
        the model group over that, whole leaves counted once (two small
        all_reduces)."""
        groups = sorted({k.split(".", 1)[0] for k in sq})
        dev = next(iter(sq.values())).device
        parts = torch.zeros(4, len(groups), device=dev)  # whole, data, model, both
        for k, v in sq.items():
            p = self.placements[k]
            parts[(p.data is not None) + 2 * (p.model is not None), groups.index(k.split(".", 1)[0])] += v
        m = self.mesh
        if m.dp > 1:
            parts[1::2] = m.data_comm.all_reduce(parts[1::2].contiguous())
        if m.mp > 1:
            parts[2:] = m.model_comm.all_reduce(parts[2:].contiguous())
        return dict(zip(groups, parts.sum(dim=0).unbind(0)))

    # -- ZeRO-1 ---------------------------------------------------------------

    def zero_slice(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO-1 slice of the whole leaf `t`."""
        return _part(t, self.placements[key].zero, self.mesh.dp, self.mesh.data_rank)

    def zero_slices(self, params: Dict[str, nn.Parameter]) -> Dict[str, nn.Parameter]:
        """{key: a Parameter viewing this rank's slice of the master} for
        every leaf with a ZeRO-1 dim: AdamW updates the master in place."""
        return {k: nn.Parameter(self.zero_slice(k, p.data), requires_grad=True)
                for k, p in params.items() if self.placements[k].zero is not None}

    @torch.no_grad()
    def gather_slices(self, params: Dict[str, nn.Parameter], slices: Dict[str, nn.Parameter]) -> None:
        """Every rank's updated slices into the whole masters (one flat
        all_gather)."""
        keys = list(slices)
        sizes = [slices[k].numel() for k in keys]
        flat = self.mesh.data_comm.all_gather(torch.cat([slices[k].reshape(-1) for k in keys]), 0)
        for r, part in enumerate(flat.chunk(self.mesh.dp)):
            if r == self.mesh.data_rank:
                continue
            for k, piece in zip(keys, part.split(sizes)):
                _part(params[k].data, self.placements[k].zero, self.mesh.dp, r).copy_(piece.view_as(slices[k]))

    # -- whole leaves for a checkpoint ---------------------------------------

    def gather(self, key: str, t: torch.Tensor, zero: bool = False) -> torch.Tensor:
        """The whole leaf from every rank's part `t` (its data shard or,
        with `zero`, its ZeRO-1 slice; its model shard); every rank takes
        part and receives it."""
        p, m = self.placements.get(key, Placement()), self.mesh
        dim = p.zero if zero else p.data
        if dim is not None and m.dp > 1:
            t = m.data_comm.all_gather(t.contiguous(), dim)
        if p.model is not None and m.mp > 1:
            t = m.model_comm.all_gather(t.contiguous(), p.model)
        return t

    def host(self, key: str, t: torch.Tensor, zero: bool = False) -> Optional[np.ndarray]:
        """The whole leaf `key` as a host f32 array on rank 0 (None
        elsewhere) from every rank's part `t`, as `gather` takes it."""
        whole = self.gather(key, t.detach(), zero)
        return whole.to("cpu", torch.float32, copy=True).numpy() if self.mesh.rank == 0 else None

    @torch.no_grad()
    def host_snapshot(self, models, keys: List[str]) -> Optional[Dict[str, np.ndarray]]:
        """ckpt.host_save_snapshot of a sharded bundle: the whole leaves on
        rank 0 (None elsewhere)."""
        params = {f"{name}.{k}": p for name in MODELS for k, p in getattr(models, name).named_parameters()}
        snap = {k: self.host(k, params[k]) for k in keys}
        return snap if self.mesh.rank == 0 else None


def _adamw_state(optimizer, key: str):
    st = optimizer.adamw.state.get(optimizer.adam_param(key), {})
    return {n: st[n].detach().clone() for n in ("exp_avg", "exp_avg_sq", "step")} if st else None


def shard_training(models, optimizer, mesh: Mesh, fsdp: bool = False, zero1: bool = False,
                   min_size: int = MIN_SHARD_SIZE):
    """Cut `models` (in place) and `optimizer` (a one-process Optimizer over
    them, possibly resumed) to this rank's share of `mesh`; returns the
    rank's Optimizer, whose `layout` the train step uses. Tensor
    parallelism follows mesh.mp, FSDP and ZeRO-1 the flags (they change
    nothing with one data rank)."""
    from photoverse_tpu_torch.ckpt.checkpoint import partition_params
    from photoverse_tpu_torch.engine.training import Optimizer
    from photoverse_tpu_torch.parallel import shard_models

    dp, mp = mesh.dp, mesh.mp
    fsdp, zero1 = fsdp and dp > 1, zero1 and dp > 1 and not (fsdp and dp > 1)
    old = optimizer
    masters = {k: p.detach() for k, p in old.params.items()}
    states = {k: _adamw_state(old, k) for k in masters}
    if mp > 1:
        shard_models(models, mesh, "tensor", flash=models.unet.config.use_flash_attention)
    trainable, _ = partition_params(models)
    for p in trainable.values():
        p.requires_grad_(True)

    placements: Dict[str, Placement] = {}
    for name in MODELS:
        for mod_name, module in getattr(models, name).named_modules():
            dims = {}
            for pname, p in module._parameters.items():
                if p is None:
                    continue
                key = ".".join(s for s in (name, mod_name, pname) if s)
                tp = tree_tp_dim(key, p.dim()) if mp > 1 else None
                data = (fsdp_dim(p.shape, dp, base=tp, min_size=min_size, order=flax_order(module, p.dim()))
                        if fsdp else None)
                z = None
                if zero1 and key in trainable:
                    z = (zero1_dim(p.shape, dp) if mp == 1 else
                         fsdp_dim(p.shape, dp, base=tp, order=flax_order(module, p.dim())))
                placements[key] = Placement(tp, data, z)
                if data is not None:
                    dims[pname] = data
            shard_module(module, mesh.data_comm, dims)

    trainable, _ = partition_params(models)
    layout = TrainLayout(mesh, placements)
    new = Optimizer(trainable, old.cfg, layout)

    def local(k, t):
        p = placements[k]
        t = _part(t, p.model, mp, mesh.model_rank)
        return _part(t, p.data, dp, mesh.data_rank)

    with torch.no_grad():
        for k, p in trainable.items():
            if tuple(local(k, masters[k]).shape) != tuple(p.shape):
                raise AssertionError(f"{k}: shard {tuple(p.shape)} is not the layout's cut of the master")
            # an FSDP shard accumulates the data group's summed gradients
            # (its gather's backward sums them): the mean saved, times dp
            new.acc[k].copy_(local(k, old.acc[k]) * (dp if placements[k].data is not None else 1))
            st = states[k]
            if st is not None:
                ap = new.adam_param(k)
                new.adamw.state[ap] = {
                    "step": st["step"],
                    "exp_avg": layout.zero_slice(k, local(k, st["exp_avg"])).clone(),
                    "exp_avg_sq": layout.zero_slice(k, local(k, st["exp_avg_sq"])).clone(),
                }
    new.mini_step, new.updates = old.mini_step, old.updates
    return new
