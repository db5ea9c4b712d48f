"""FSDP / ZeRO-3 parameter sharding over the data group. Port of
photoverse_tpu/parallel/fsdp.py.

The JAX package annotates each parameter with a sharding and GSPMD
inserts the all-gather where a weight is used and the reduce-scatter of
its gradient. Here both are written out:

  * `fsdp_dim` is the JAX package's `fsdp_spec` rule on a torch shape: the
    largest dim that divides by the data ranks is split (ties go to the
    dim the flax layout lists first), leaves under `MIN_SHARD_SIZE`
    elements stay whole, a dim is never split twice, and a tensor-parallel
    dim (`base`) is kept;
  * `shard_module` keeps only this rank's shard of each such parameter
    (the Parameter keeps its name, at the shard's shape). A forward
    pre-hook of the module that owns it puts the whole weight in the
    module's attribute for the forward (`parallel.mesh.gather_shard`: an
    all_gather, whose backward sums the gradient over the group and keeps
    this rank's slice) and a forward hook drops it afterwards. Under remat
    the recompute gathers again. The optimizer sees and updates the
    shards, so each rank's AdamW holds only its share (ZeRO-3).

Every rank must issue the same collectives in the same order, or gloo
waits forever: the hooks run in module call order, which is the same on
every rank because every rank runs the same model on equal shares.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from photoverse_tpu_torch.parallel.mesh import gather_shard

__all__ = ["MIN_SHARD_SIZE", "fsdp_dim", "flax_order", "shard_module"]

# leaves below this many elements stay whole: the all-gather of a small
# tensor costs more latency than the memory it frees
MIN_SHARD_SIZE = 2**16


def flax_order(module: nn.Module, ndim: int) -> Sequence[int]:
    """The torch dims of a parameter of `module` in the order the flax
    layout of the JAX package lists them: a Linear's (out, in) weight is a
    flax (in, out) kernel, a convolution's (out, in, kh, kw) weight a flax
    (kh, kw, in, out) kernel; embeddings, norms and biases match."""
    if isinstance(module, nn.Conv2d) and ndim == 4:
        return (2, 3, 1, 0)
    if isinstance(module, nn.Linear) and ndim == 2:
        return (1, 0)
    return tuple(range(ndim))


def fsdp_dim(shape, n: int, base: Optional[int] = None, min_size: int = MIN_SHARD_SIZE,
             order: Optional[Sequence[int]] = None) -> Optional[int]:
    """The torch dim FSDP splits over `n` data ranks, or None (the leaf
    stays whole): the largest dim divisible by n, other than `base` (the
    tensor-parallel dim), of a leaf of at least `min_size` elements; ties
    go to the dim that comes first in `order` (`flax_order`)."""
    shape = tuple(shape)
    if n <= 1 or not shape or math.prod(shape) < min_size:
        return None
    dims = tuple(order) if order is not None else tuple(range(len(shape)))
    for i in sorted(dims, key=lambda j: -shape[j]):  # stable: ties keep `dims`' order
        if i != base and shape[i] % n == 0 and shape[i] >= n:
            return i
    return None


def _gather(module: nn.Module, args):
    for name, dim in module._fsdp_dims.items():
        module.__dict__[name] = gather_shard(module._parameters[name], module._fsdp_comm, dim)


def _release(module: nn.Module, args, output):
    for name in module._fsdp_dims:
        module.__dict__.pop(name, None)


def shard_module(module: nn.Module, comm, dims: Dict[str, int]) -> None:
    """Keep this rank's shard of each directly owned parameter of `module`
    named in `dims` ({parameter name: dim}) and gather the whole ones for
    each forward. The parameter stays registered under its name (the
    optimizer, the checkpoint's gather and `named_parameters` see the
    shard); inside the forward the attribute is the gathered weight."""
    if not dims:
        return
    for name, dim in dims.items():
        p = module._parameters[name]
        shard = p.detach().chunk(comm.size, dim=dim)[comm.rank].clone()
        module._parameters[name] = nn.Parameter(shard, requires_grad=p.requires_grad)
    module._fsdp_dims = dict(dims)
    module._fsdp_comm = comm
    module.register_forward_pre_hook(_gather)
    module.register_forward_hook(_release, always_call=True)
