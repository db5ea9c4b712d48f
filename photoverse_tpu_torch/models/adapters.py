"""Dual-branch PhotoVerse adapters (port of photoverse_tpu/models/adapters.py).

Each of the K CLIP feature sets has two per-token MLPs
[Linear -> LayerNorm -> LeakyReLU] x2 -> Linear: `mapping_{k}` on the CLS
token and `mapping_patch_{k}` on each patch token, whose outputs are then
averaged over the patches (MLP first, then the mean):

    out_k = mapping_k(CLS_k) + mean_patch(mapping_patch_k(patches_k))

Module names follow the reference adapter's state dict
(`mapping_{i}.{0,1,3,4,6}`), which `convert_adapter` reads.

  embs: (K, B, S, clip_dim) stacked CLIP hidden states
  token_index=None -> (B, K, cross_dim); token_index=i -> (B, 1, cross_dim)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["PhotoVerseAdapter"]

# the MLPs' hidden width, whatever the CLIP width (as in the reference)
HIDDEN_DIM = 1024


def _mlp(in_dim: int, hidden_dim: int, out_dim: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Linear(in_dim, hidden_dim),
        nn.LayerNorm(hidden_dim, eps=1e-5),
        nn.LeakyReLU(0.01),
        nn.Linear(hidden_dim, hidden_dim),
        nn.LayerNorm(hidden_dim, eps=1e-5),
        nn.LeakyReLU(0.01),
        nn.Linear(hidden_dim, out_dim),
    )


class PhotoVerseAdapter(nn.Module):
    def __init__(self, clip_embedding_dim: int = 1024, cross_attention_dim: int = 768,
                 num_tokens: int = 5):
        super().__init__()
        self.num_tokens = num_tokens
        for i in range(num_tokens):
            for name in (f"mapping_{i}", f"mapping_patch_{i}"):
                self.add_module(name, _mlp(clip_embedding_dim, HIDDEN_DIM, cross_attention_dim))

    def forward(self, embs: torch.Tensor, token_index: Optional[int] = None) -> torch.Tensor:
        if embs.shape[0] != self.num_tokens:
            raise ValueError(f"expected {self.num_tokens} feature sets, got {embs.shape[0]}")
        # the inference path evaluates only token-MLP `token_index`
        idx = range(self.num_tokens) if token_index is None else [int(token_index)]
        # f32 master weights in a bf16 model: compute in the weights' dtype
        x = embs.to(self.mapping_0[0].weight.dtype)
        tokens = []
        for i in idx:
            cls_out = getattr(self, f"mapping_{i}")(x[i, :, 0])
            patch_out = getattr(self, f"mapping_patch_{i}")(x[i, :, 1:]).mean(dim=1)
            tokens.append(cls_out + patch_out)
        return torch.stack(tokens, dim=1).to(embs.dtype)
