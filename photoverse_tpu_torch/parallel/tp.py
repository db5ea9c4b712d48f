"""Tensor parallelism for the dual-conditioned UNet (Megatron-style).
Port of photoverse_tpu/parallel/tp.py.

The JAX package annotates the UNet's weights and GSPMD derives the rest;
here the pieces it derives are explicit:

  * column-parallel (output features sharded): to_q, to_k, to_v, to_k_ip,
    to_v_ip of attn1 / attn2, the GEGLU up-projection `ff.net.0.proj`
    (weight and bias) and LoRA's lora_B. The head reshape then leaves each
    rank H / tp whole heads, so attention, the hoisted context K/V
    included, needs no communication;
  * row-parallel (input features sharded): to_out and `ff.net.2`. Each
    rank's partial product is summed over the model group (one all_reduce
    a layer, what GSPMD emits as one psum) and the bias added once
    (`RowParallelLinear`);
  * everything else replicated: convolutions, norms, the time embedding,
    lora_A, CLIP, the VAE and the adapters.

A torch `nn.Linear.weight` is (out, in), the transpose of a flax kernel,
so a column shard is dim 0 and a row shard dim 1 (`unet_tp_dim`). The
GEGLU up-projection holds the value half and the gate half of the 8C
outputs one after the other; rank r holds slice r of each half, so its
local output splits into its value and gate slices as the whole one does
(`shard_state_dict`). The JAX package needs `UNetConfig.tp_friendly_ffn`
for that under GSPMD; here the shard's layout carries it.

The weights reach a rank as the full state dict (from convert/from_jax.py
or convert/from_diffusers.py) cut to its shard: `shard_unet` builds the
UNet at the rank's shapes (`UNet2DCondition(config, tp=TPShard(...))`)
and loads `shard_state_dict` into it.

Training (Megatron's f and g, parallel/mesh.py): every column-parallel
projection takes its input through `copy_to_model`, so the input gradient
it returns is the sum of the ranks' partial products; LoRA's lora_B is a
column-parallel layer on the replicated lora_A output, so a LoRA
projection applies it to its base layer's input and to lora_B's input
(models/layers.py), and lora_A's gradient comes out whole on every rank.
The row-parallel sum is `reduce_from_model`. The trainables keep their
placement from `unet_tp_spec`: lora_B, to_k_ip and to_v_ip are shards,
lora_A and the adapters whole; `tree_tp_dim` says which of the
trainable dict's leaves (and so of the AdamW moments and the gradient
accumulator) are shards (`tree_tp_shardings` of the JAX package).

Requirements (`validate_tp`): tp divides the head count (8 for SD-1.5, so
tp in {2, 4, 8}); the flash kernel only through the sharded wrapper
(parallel/flash.py); the fused block tail off (it has no sharded wrapper).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
from torch import nn
import torch.nn.functional as F

from photoverse_tpu_torch.parallel.mesh import reduce_from_model

__all__ = [
    "TPShard",
    "RowParallelLinear",
    "unet_tp_dim",
    "tree_tp_dim",
    "shard_state_dict",
    "shard_unet",
    "validate_tp",
]

_COLUMN_PARENTS = frozenset({"to_q", "to_k", "to_v", "to_k_ip", "to_v_ip"})
_ROW_PARENTS = frozenset({"to_out"})
_ATTN_SCOPES = ("attn1", "attn2")
GEGLU_PROJ = "ff.net.0.proj"
FF_OUT = "ff.net.2"


@dataclasses.dataclass(frozen=True)
class TPShard:
    """Rank `rank` of a model group of `size` ranks, and the group's
    collectives (parallel.mesh.Comm)."""

    rank: int
    size: int
    comm: object


class RowParallelLinear(nn.Linear):
    """nn.Linear over this rank's slice of the input features: the partial
    product is summed over the model group, then the bias is added once.
    Keys and shapes are an nn.Linear's (weight (out, in / tp), bias (out,))."""

    def __init__(self, in_features: int, out_features: int, comm, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.comm = comm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = reduce_from_model(F.linear(x, self.weight.to(x.dtype)), self.comm)
        return y if self.bias is None else y + self.bias.to(x.dtype)


def unet_tp_dim(name: str, ndim: int) -> Optional[int]:
    """The torch dim of UNet parameter `name` that tensor parallelism
    shards, or None when it stays replicated (`unet_tp_spec` of the JAX
    package, with the Linear weight transposed)."""
    segs = name.split(".")
    if len(segs) < 2 or ndim == 0:
        return None
    leaf, owner = segs[-1], ".".join(segs[:-1])
    if owner.endswith(GEGLU_PROJ):
        return 0
    if owner.endswith(FF_OUT):
        return 1 if leaf == "weight" else None
    if not any(s in _ATTN_SCOPES for s in segs) or leaf != "weight" or ndim != 2:
        return None
    if "lora_B" in segs:
        return 0
    if "lora_A" in segs:
        return None
    # the projection's own name: skip peft's `base_layer` and ModuleList indices
    parent = next(s for s in reversed(segs[:-1]) if s != "base_layer" and not s.isdigit())
    if parent in _COLUMN_PARENTS:
        return 0
    if parent in _ROW_PARENTS:
        return 1
    return None


def tree_tp_dim(key: str, ndim: int) -> Optional[int]:
    """The dim that tensor parallelism shards of a leaf of a flat
    {"<model>.<parameter name>": tensor} dict (the trainables, the frozen
    weights, the AdamW moments, the gradient accumulator): the UNet's by
    `unet_tp_dim`, every other model's never (`tree_tp_shardings` of the
    JAX package)."""
    model, _, name = key.partition(".")
    return unet_tp_dim(name, ndim) if model == "unet" else None


def _chunk(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    if t.shape[dim] % size:
        raise ValueError(f"a dim of {t.shape[dim]} does not split over {size} ranks")
    return t.chunk(size, dim=dim)[rank]


def shard_state_dict(state: Mapping[str, torch.Tensor], rank: int, size: int) -> Dict[str, torch.Tensor]:
    """Rank `rank`'s shard of a full UNet state dict: each sharded tensor
    cut to its slice (`unet_tp_dim`), the GEGLU up-projection as
    [value slice r; gate slice r], the rest whole."""
    out = {}
    for name, t in state.items():
        dim = unet_tp_dim(name, t.dim())
        if dim is None or size == 1:
            out[name] = t
        elif name.rsplit(".", 1)[0].endswith(GEGLU_PROJ):
            value, gate = t.chunk(2, dim=0)
            out[name] = torch.cat([_chunk(value, 0, rank, size), _chunk(gate, 0, rank, size)]).contiguous()
        else:
            out[name] = _chunk(t, dim, rank, size).contiguous()
    return out


def shard_unet(unet, shard: TPShard):
    """A UNet at rank `shard.rank`'s shapes, on the device of `unet`,
    holding its shard of `unet`'s weights in their dtypes (a training run's
    f32 masters stay f32), with no parameter requiring grad."""
    from photoverse_tpu_torch.models.unet import UNet2DCondition

    with torch.device(unet.conv_in.weight.device):
        local = UNet2DCondition(unet.config, tp=shard)
    state = {k: t.detach() for k, t in unet.state_dict().items()}
    local.load_state_dict(shard_state_dict(state, shard.rank, shard.size), strict=True, assign=True)
    return local.eval().requires_grad_(False)


def validate_tp(unet_config, tp: int) -> None:
    """tp must divide the head count (head-sharded attention), and with it
    every sharded projection width; the kernels that cannot run sharded
    must be off, as in the JAX package."""
    if tp <= 1:
        return
    if unet_config.num_heads % tp:
        raise ValueError(f"tensor_parallel={tp} must divide num_heads={unet_config.num_heads}")
    if unet_config.use_flash_attention and unet_config.flash_fn is None:
        raise ValueError(
            "tensor parallelism needs the sharded flash wrapper "
            "(parallel.flash.enable_sharded_flash) or the plain attention path: "
            "the bare flash kernel sees one rank's tensors only"
        )
    if unet_config.fused_blocks:
        raise ValueError("tensor parallelism requires fused_blocks off (the fused block-tail kernel has no "
                         "sharded wrapper)")
