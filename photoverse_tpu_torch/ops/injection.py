"""Concept-token splice into a token-embedding sequence (port of
photoverse_tpu/ops/injection.py).

For each batch row with placeholder index p and K concept tokens:
  out[j] = emb[j]            for j <  p
  out[j] = concept[j - p]    for p <= j < p + K
  out[j] = emb[j - K + 1]    for j >= p + K   (suffix shifted right by K-1,
                                               truncated at seq_len)
p = 0 puts the concept tokens first and starts the suffix from emb[1].
"""

from __future__ import annotations

import torch

__all__ = ["inject_concept_embeddings"]


def inject_concept_embeddings(
    inputs_embeds: torch.Tensor,  # (B, S, D)
    concept_embeds: torch.Tensor,  # (B, K, D)
    placeholder_idx: torch.Tensor,  # (B,) or (B, 1) int
) -> torch.Tensor:
    B, S, D = inputs_embeds.shape
    K = concept_embeds.shape[1]
    dev = inputs_embeds.device
    p = placeholder_idx.reshape(B, 1).to(device=dev, dtype=torch.long)
    j = torch.arange(S, device=dev)[None, :]

    src = torch.where(j >= p + K, j - (K - 1), j).clamp(0, S - 1)
    gathered = torch.gather(inputs_embeds, 1, src[:, :, None].expand(B, S, D))

    in_concept = (j >= p) & (j < p + K)
    cidx = (j - p).clamp(0, K - 1)
    concept = torch.gather(
        concept_embeds.to(inputs_embeds.dtype), 1, cidx[:, :, None].expand(B, S, D)
    )
    return torch.where(in_concept[:, :, None], concept, gathered)
