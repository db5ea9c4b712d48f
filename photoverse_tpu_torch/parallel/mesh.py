"""Process groups and the ("data", "model") mesh of the port's multi-GPU
serving and training. Port of photoverse_tpu/parallel/mesh.py and of
`make_mesh_2d` (photoverse_tpu/parallel/tp.py).

The JAX package builds one `jax.sharding.Mesh` and lets GSPMD derive every
collective. Here each rank is a process, launched by

    python -m torch.distributed.run --nproc_per_node N -m photoverse_tpu_torch.cli.generate ...

which sets RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and
MASTER_PORT. `open_mesh` opens the process group from them and builds the
mesh as explicit subgroups; the rank grid is (dp, mp) with the model axis
innermost (rank = data_rank * mp + model_rank), as in `make_mesh_2d`.

Backend rule (`choose_backend`, printed by `open_mesh`): nccl when every
local rank has a card of its own, gloo when ranks share a card or the run
is on the CPU (--cpu). `init_device_mesh("cuda", ...)` is not used: it
assumes NCCL, which refuses two ranks on one card.

Collectives are all_reduce (sum), all_gather and broadcast only: gloo has
no send/recv for CUDA tensors. Under gloo a CUDA tensor is staged through
pinned host memory explicitly (`Comm`): copied to the host, which waits for
the device, reduced or gathered there, and copied back. The time of that
staging is part of every sharded run's time. Under nccl a host tensor
(a seed, a request header) goes through the rank's card.

Training (the collectives GSPMD derives for the JAX package's sharded
step) adds three autograd Functions over a Comm: `reduce_from_model`
(Megatron's "g": the forward sums over the model group, the backward is
the identity), `copy_to_model` ("f": the forward is the identity, the
backward sums), and `gather_shard` (the forward all-gathers a shard along
a dim, the backward sums over the group and keeps this rank's slice: a
reduce-scatter made of all_reduce, which gloo has where reduce_scatter it
has not); and the data split of a batch (`host_batch_slice`,
`shard_batch`) and of the optimizer state (`zero1_dim`).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "Comm",
    "Mesh",
    "world_from_env",
    "choose_backend",
    "mesh_shape",
    "open_mesh",
    "close_mesh",
    "padded_rows",
    "pad_rows",
    "data_rows",
    "host_batch_slice",
    "shard_batch",
    "zero1_dim",
    "reduce_from_model",
    "copy_to_model",
    "gather_shard",
]

# the serving followers wait on the control group between requests, for as
# long as the server is idle
CONTROL_TIMEOUT = datetime.timedelta(days=365)


class Comm:
    """The collectives of one process group. `wire` is the device the
    backend moves tensors from: the host for gloo (a CUDA tensor is staged
    through pinned memory, the host waiting for the device first), the
    rank's card for nccl. A group of one rank returns its input."""

    def __init__(self, group, ranks: Tuple[int, ...], wire: torch.device):
        self.group = group
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank())
        self.wire = wire

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of `t` on the wire device (never `t` itself)."""
        if t.device == self.wire:
            return t.contiguous().clone()
        if self.wire.type == "cpu":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            torch.cuda.current_stream(t.device).synchronize()
            return h
        return t.to(self.wire)

    @staticmethod
    def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return h if h.device == like.device else h.to(like.device, non_blocking=like.is_cuda)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the group, on every rank (a new tensor)."""
        if self.size == 1:
            return t
        h = self._to_wire(t)
        dist.all_reduce(h, group=self.group)
        return self._back(h, t)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's `t` (all of one shape) concatenated along `dim` in
        group-rank order, on every rank. The parts land in one (size,
        *shape) block on the wire device (pinned when a CUDA tensor is
        staged for gloo), moved back in one copy."""
        if self.size == 1:
            return t
        h = self._to_wire(t)
        block = torch.empty((self.size, *h.shape), dtype=h.dtype, device=h.device,
                            pin_memory=h.device.type == "cpu" and t.is_cuda)
        dist.all_gather(list(block.unbind(0)), h, group=self.group)
        return torch.cat(self._back(block, t).unbind(0), dim=dim)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Group rank `src`'s `t` on every rank (a new tensor elsewhere than
        on the source, where it is `t`)."""
        if self.size == 1:
            return t
        h = self._to_wire(t)
        dist.broadcast(h, src=self.ranks[src], group=self.group)
        return t if self.rank == src else self._back(h, t)


@dataclasses.dataclass
class Mesh:
    """A (dp, mp) grid of ranks. `data_comm` joins the ranks of one
    model_rank (the batch is split over it), `model_comm` the ranks of one
    data_rank (one model replica, sharded), `world_comm` all of them, and
    `control_comm` all of them with a timeout that an idle server does not
    reach."""

    dp: int
    mp: int
    rank: int
    backend: str
    device: torch.device
    world_comm: Comm
    data_comm: Comm
    model_comm: Comm
    control_comm: Comm

    @property
    def world(self) -> int:
        return self.dp * self.mp

    @property
    def data_rank(self) -> int:
        return self.rank // self.mp

    @property
    def model_rank(self) -> int:
        return self.rank % self.mp


def world_from_env() -> Tuple[int, int, int, int]:
    """(rank, world size, local rank, local world size) as the launcher
    set them; (0, 1, 0, 1) for a plain `python -m ...` run."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    return (int(os.environ.get("RANK", "0")), world, int(os.environ.get("LOCAL_RANK", "0")),
            int(os.environ.get("LOCAL_WORLD_SIZE", str(world))))


def choose_backend(cpu: bool, device_count: int, local_world: int) -> Tuple[str, str]:
    """(backend, the reason, for the log): nccl when every local rank has a
    card of its own, else gloo."""
    if cpu:
        return "gloo", "--cpu"
    if device_count < 1:
        raise RuntimeError("no CUDA device found; pass --cpu to run the ranks on the CPU")
    if device_count >= local_world:
        return "nccl", f"{local_world} local ranks on {device_count} cards, one card each"
    return "gloo", f"{local_world} local ranks share {device_count} card(s); NCCL refuses two ranks on one card"


def mesh_shape(mode: str, world: int, model_parallel: int = 0) -> Tuple[int, int]:
    """(dp, mp) for a sharding mode at a world size, as the JAX CLIs choose
    it: data puts every rank on the batch; tensor and spatial put
    `model_parallel` ranks (all of them when 0) on one model replica and
    the rest on the batch."""
    if mode == "data":
        return world, 1
    if mode not in ("tensor", "spatial"):
        raise ValueError(f"unknown sharding mode {mode!r}")
    mp = model_parallel or world
    if mp < 1 or world % mp:
        raise ValueError(f"--model_parallel {mp} must divide the number of ranks {world}")
    return world // mp, mp


def open_mesh(dp: int, mp: int, cpu: bool, init_method: Optional[str] = None) -> Mesh:
    """Open the process group of this rank (from the launcher's
    environment, or `init_method`, e.g. a file:// store) and build the
    (dp, mp) mesh. On a card, this rank's device is LOCAL_RANK modulo the
    card count. A process whose group is open already (of the same size
    and backend) builds the mesh's subgroups in it. A rank that cannot
    open its group raises."""
    rank, world, local_rank, local_world = world_from_env()
    if dp * mp != world:
        raise ValueError(f"a {dp} x {mp} mesh needs {dp * mp} ranks, the launcher started {world}")
    count = 0 if cpu else torch.cuda.device_count()
    backend, why = choose_backend(cpu, count, local_world)
    if cpu:
        device = torch.device("cpu")
    else:
        torch.cuda.set_device(local_rank % count)
        device = torch.device("cuda", local_rank % count)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=world)
    elif (dist.get_world_size(), dist.get_backend()) != (world, backend):
        raise RuntimeError(f"this process's group is {dist.get_backend()} over {dist.get_world_size()} ranks, "
                           f"the mesh wants {backend} over {world}")
    wire = device if backend == "nccl" else torch.device("cpu")
    if rank == 0:
        print(f"[parallel] backend {backend} ({why}); mesh {dp} x {mp} (data x model) over {world} ranks",
              flush=True)
    # every rank creates every subgroup, in the same order
    data_comm = model_comm = None
    for m in range(mp):
        ranks = tuple(d * mp + m for d in range(dp))
        g = dist.new_group(list(ranks))
        if rank in ranks:
            data_comm = Comm(g, ranks, wire)
    for d in range(dp):
        ranks = tuple(d * mp + m for m in range(mp))
        g = dist.new_group(list(ranks))
        if rank in ranks:
            model_comm = Comm(g, ranks, wire)
    everyone = tuple(range(world))
    control = dist.new_group(list(everyone), timeout=CONTROL_TIMEOUT)
    return Mesh(dp=dp, mp=mp, rank=rank, backend=backend, device=device,
                world_comm=Comm(dist.group.WORLD, everyone, wire), data_comm=data_comm,
                model_comm=model_comm, control_comm=Comm(control, everyone, wire))


def close_mesh(mesh: Optional[Mesh]) -> None:
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()


def padded_rows(n: int, dp: int) -> int:
    """n rounded up to a multiple of dp."""
    return n + (-n) % dp


def pad_rows(x, total: int, dim: int = 0):
    """x (numpy or torch) with its last row along `dim` repeated up to
    `total` rows, as the JAX generate CLI pads a batch."""
    n = x.shape[dim]
    if n == total:
        return x
    if isinstance(x, torch.Tensor):
        last = x.narrow(dim, n - 1, 1)
        reps = [1] * x.dim()
        reps[dim] = total - n
        return torch.cat([x, last.repeat(*reps)], dim=dim)
    import numpy as np

    return np.concatenate([x, np.repeat(x.take([n - 1], axis=dim), total - n, axis=dim)], axis=dim)


def data_rows(total: int, mesh: Mesh) -> slice:
    """This rank's rows of a batch of `total` rows (a multiple of dp)."""
    if total % mesh.dp:
        raise ValueError(f"a batch of {total} rows does not split over {mesh.dp} data ranks")
    per = total // mesh.dp
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def host_batch_slice(global_batch_size: int, mesh: Mesh) -> slice:
    """This data rank's rows of a global batch (the loader's `host_slice`;
    the model ranks of one data rank get the same rows)."""
    if global_batch_size % mesh.dp:
        raise ValueError(f"global batch {global_batch_size} not divisible by process count {mesh.dp} "
                         f"(the data ranks)")
    per = global_batch_size // mesh.dp
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a batch (already cut by the loader's
    `host_batch_slice`; the global batch is never built) on its device."""
    return {k: torch.as_tensor(v).to(mesh.device) for k, v in batch.items()}


def zero1_dim(shape, n: int) -> Optional[int]:
    """The dim ZeRO-1 splits a leaf's optimizer state along over `n` data
    ranks: the leading one when it divides (`zero1_sharding` of the JAX
    package); None keeps the leaf whole on every rank."""
    if n > 1 and len(shape) >= 1 and shape[0] > 0 and shape[0] % n == 0:
        return 0
    return None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g), None


class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        whole = comm.all_reduce(g.contiguous())
        return whole.chunk(comm.size, dim=ctx.dim)[comm.rank].contiguous(), None, None


def _single(comm) -> bool:
    return comm is None or comm.size == 1


def reduce_from_model(x: torch.Tensor, comm) -> torch.Tensor:
    """The sum of `x` over the model group; its gradient passes through
    unchanged (each rank holds the whole output's gradient already). The
    row-parallel layers' partial products go through it."""
    if _single(comm):
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return comm.all_reduce(x)
    return _ReduceFromModel.apply(x, comm)


def copy_to_model(x: torch.Tensor, comm) -> torch.Tensor:
    """`x` (the same on every rank of the model group) as the input of a
    column-parallel layer: the gradient that comes back is the sum of the
    ranks' partial input gradients. Without it a replicated layer below
    sees one rank's share of its output gradient."""
    if _single(comm) or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, comm)


def gather_shard(x: torch.Tensor, comm, dim: int) -> torch.Tensor:
    """Every rank's shard of one tensor, concatenated along `dim` in
    group-rank order; the gradient of the whole is summed over the group and
    cut back to this rank's shard (a reduce-scatter)."""
    if _single(comm):
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return comm.all_gather(x, dim)
    return _GatherShard.apply(x, comm, dim)
