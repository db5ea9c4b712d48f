"""CLIP text + vision encoders (port of photoverse_tpu/models/clip.py).

Pre-LN transformer blocks with quick_gelu, as in OpenAI CLIP, or with the
exact gelu (`CLIPTextConfig.hidden_act`, OpenCLIP ViT-bigG/14's text
tower, SDXL's second encoder). Module names follow the transformers
CLIPTextModel / CLIPVisionModel state dicts (without the `text_model.` /
`vision_model.` prefix), which `convert_clip_text` / `convert_clip_vision`
read; CLIPTextModelWithProjection's `text_projection` sits beside them.

  - The text encoder splices the concept embeddings in at the placeholder
    (ops/injection.py), applies a causal mask and pools at the EOT token
    (the highest token id of each row). SDXL's encoders return the
    penultimate layer's output (`penultimate_output`: hidden_states[-2],
    before the final LayerNorm), and the second one projects its pooled
    output (`projection_dim`: `text_projection`, no bias).
  - The vision encoder returns its last hidden state plus the hidden
    states listed in `collect_layers`, in HF hidden_states indexing
    (0 = embedding output after pre-LN, i = output of encoder layer i).
  - `int8_dense` (inference-only) puts each layer's q/k/v/out projections
    and its MLP's fc1/fc2 on the W8A8 int8 product (ops/quant.py); the
    embeddings, the layer norms and everything outside the layers stay as
    they are, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from photoverse_tpu_torch.ops.injection import inject_concept_embeddings
from photoverse_tpu_torch.ops.quant import Int8Linear

__all__ = ["CLIPTextConfig", "CLIPVisionConfig", "CLIPTextEncoder", "CLIPVisionEncoder", "quick_gelu", "ACTIVATIONS"]


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    # W8A8 int8 projections and MLPs (ops/quant.py); inference-only
    int8_dense: bool = False
    hidden_act: str = "quick_gelu"  # or "gelu" (exact, erf)
    # the last hidden state after final_layer_norm (False) or the output of
    # the last layer but one, before it (True: SDXL's hidden_states[-2])
    penultimate_output: bool = False
    # > 0: the pooled output through text_projection (no bias), as
    # CLIPTextModelWithProjection's text_embeds
    projection_dim: int = 0


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 224
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    # see CLIPTextConfig.int8_dense
    int8_dense: bool = False

    @property
    def seq_len(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


class _SelfAttn(nn.Module):
    def __init__(self, dim: int, heads: int, linear=nn.Linear):
        super().__init__()
        self.heads = heads
        self.q_proj = linear(dim, dim)
        self.k_proj = linear(dim, dim)
        self.v_proj = linear(dim, dim)
        self.out_proj = linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        B, S, D = x.shape
        hd = D // self.heads
        q = self.q_proj(x).reshape(B, S, self.heads, hd)
        k = self.k_proj(x).reshape(B, S, self.heads, hd)
        v = self.v_proj(x).reshape(B, S, self.heads, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (hd**-0.5)
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(x.dtype)
        return self.out_proj(ctx.reshape(B, S, D))


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, linear=nn.Linear, act=quick_gelu):
        super().__init__()
        self.fc1 = linear(dim, hidden)
        self.fc2 = linear(hidden, dim)
        self.act = act

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class _CLIPLayer(nn.Module):
    """x += attn(ln1(x)); x += mlp(ln2(x))."""

    def __init__(self, dim: int, heads: int, hidden: int, eps: float, linear=nn.Linear, act=quick_gelu):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=eps)
        self.self_attn = _SelfAttn(dim, heads, linear)
        self.layer_norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = _MLP(dim, hidden, linear, act)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        linear = Int8Linear if c.int8_dense else nn.Linear
        act = ACTIVATIONS[getattr(c, "hidden_act", "quick_gelu")]
        self.layers = nn.ModuleList(
            _CLIPLayer(c.hidden_size, c.num_heads, c.intermediate_size, c.layer_norm_eps, linear, act)
            for _ in range(c.num_layers))


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class CLIPTextEncoder(nn.Module):
    """CLIP text transformer with concept-token injection.
    Returns (last_hidden_state, pooled_output), or under the config's
    `penultimate_output` / `projection_dim` (penultimate hidden state,
    projected pooled output)."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = c = config
        self.embeddings = _TextEmbeddings(c)
        self.encoder = _Encoder(c)
        self.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        if c.projection_dim:
            self.text_projection = nn.Linear(c.hidden_size, c.projection_dim, bias=False)

    def forward(
        self,
        input_ids: torch.Tensor,  # (B, S) int
        concept_embeds: Optional[torch.Tensor] = None,  # (B, K, D)
        placeholder_idx: Optional[torch.Tensor] = None,  # (B,)
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, S = input_ids.shape
        x = self.embeddings.token_embedding(input_ids)
        if concept_embeds is not None:
            if placeholder_idx is None:
                raise ValueError("placeholder_idx required with concept_embeds")
            x = inject_concept_embeddings(x, concept_embeds, placeholder_idx)
        x = x + self.embeddings.position_embedding(torch.arange(S, device=x.device))[None]
        causal = torch.full((S, S), torch.finfo(torch.float32).min, device=x.device).triu(1)
        penultimate = x
        for layer in self.encoder.layers:
            penultimate = x
            x = layer(x, causal)
        x = self.final_layer_norm(x)
        eot = input_ids.argmax(dim=-1)
        pooled = x[torch.arange(B, device=x.device), eot]
        if self.config.projection_dim:
            pooled = self.text_projection(pooled)
        return (penultimate if self.config.penultimate_output else x), pooled


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(
            cfg.num_channels, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size, bias=False
        )
        self.position_embedding = nn.Embedding(cfg.seq_len, cfg.hidden_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) NHWC -> [class token; patches] + positions, (B, seq_len, D)."""
        B = pixel_values.shape[0]
        w = self.patch_embedding.weight
        patches = self.patch_embedding(pixel_values.permute(0, 3, 1, 2).to(w.dtype))
        patches = patches.flatten(2).transpose(1, 2)  # (B, h*w, D)
        cls = self.class_embedding.to(patches.dtype).expand(B, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        return x + self.position_embedding(torch.arange(x.shape[1], device=x.device))[None]


class CLIPVisionEncoder(nn.Module):
    """CLIP ViT returning (last_hidden_state, hidden states of `collect_layers`)."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.config = c = config
        self.embeddings = _VisionEmbeddings(c)
        self.pre_layrnorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.encoder = _Encoder(c)
        # applies only to the pooled CLS output, which the pipeline does not
        # use; kept so the parameter set matches the real checkpoint
        self.post_layernorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(
        self, pixel_values: torch.Tensor, collect_layers: Tuple[int, ...] = ()
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """pixel_values (B, H, W, 3) NHWC."""
        c = self.config
        if pixel_values.shape[-1] != c.num_channels:
            raise ValueError(f"expected NHWC input with {c.num_channels} channels, got {tuple(pixel_values.shape)}")
        x = self.pre_layrnorm(self.embeddings(pixel_values))
        collected = {0: x} if 0 in collect_layers else {}
        for i, layer in enumerate(self.encoder.layers):
            x = layer(x)
            if i + 1 in collect_layers:
                collected[i + 1] = x
        return x, tuple(collected[i] for i in collect_layers)
