"""Dual-context cross-attention (port of photoverse_tpu/ops/attention.py).

These are plain tensor functions, as in the JAX package: the tiny contexts
(77 text + K identity tokens) and the short self-attention levels stay
einsum + softmax. Layouts are (B, S, H, D).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["sdpa", "dual_context_attention", "fuse_outputs", "identity_value_norm"]


def sdpa(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, H, D)
    v: torch.Tensor,  # (B, Sk, H, D)
    fast_scores: bool = False,
) -> torch.Tensor:
    """Scaled dot-product attention.

    fast_scores=False: scores and softmax in f32.
    fast_scores=True (bf16 inputs only): the (B, H, Sq, Sk) score and
    probability tensors are stored in bf16; exp and the row sums stay f32.
    """
    d = q.shape[-1]
    if fast_scores and q.dtype == torch.bfloat16:
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * torch.tensor(
            d**-0.5, dtype=torch.bfloat16, device=q.device
        )
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp((s - m).float()).to(torch.bfloat16)
        denom = p.float().sum(dim=-1, keepdim=True)
        p = p / denom.to(torch.bfloat16)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d**-0.5)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)


def fuse_outputs(
    text_out: torch.Tensor,
    id_out: torch.Tensor,
    *,
    train: bool,
    fusion_u: Optional[torch.Tensor] = None,  # scalar uniform in [0, 1)
    scale: float = 2.0,
    rule1: float = 1.0 / 3.0,
    rule2: float = 2.0 / 3.0,
) -> torch.Tensor:
    """PhotoVerse stochastic fusion (train) / sum (eval).

    train: u < rule1 -> scale*text ; u > rule2 -> scale*id ; else text+id,
    one branch per layer call, shared across the batch.
    """
    if not train:
        return text_out + id_out
    if fusion_u is None:
        raise ValueError("fusion_u required in train mode")
    u = torch.as_tensor(fusion_u, dtype=torch.float32, device=text_out.device)
    out = torch.where(u < rule1, scale * text_out, text_out + id_out)
    return torch.where(u > rule2, scale * id_out, out)


def identity_value_norm(v_id: torch.Tensor) -> torch.Tensor:
    """||v_id||_2 over the head dim, (B, K, H, D) -> (B, H, K) f32: the
    identity-value norm the visual regularizer reads."""
    return v_id.float().square().sum(dim=-1).sqrt().transpose(1, 2)


def dual_context_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k_text: torch.Tensor,  # (B, St, H, D)
    v_text: torch.Tensor,
    k_id: torch.Tensor,  # (B, K, H, D)
    v_id: torch.Tensor,
    *,
    train: bool = False,
    fusion_u: Optional[torch.Tensor] = None,
    scale: float = 2.0,
    rule1: float = 1.0 / 3.0,
    rule2: float = 2.0 / 3.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (fused (B, Sq, H, D), v_ip_norm (B, H, K)).

    v_ip_norm is `identity_value_norm(v_id)`.
    """
    text_out = sdpa(q, k_text, v_text)
    id_out = sdpa(q, k_id, v_id)
    v_ip_norm = identity_value_norm(v_id)
    fused = fuse_outputs(
        text_out, id_out, train=train, fusion_u=fusion_u, scale=scale,
        rule1=rule1, rule2=rule2,
    )
    return fused, v_ip_norm
