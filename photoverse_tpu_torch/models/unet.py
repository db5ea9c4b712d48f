"""SD-1.5 UNet with dual-context (text + identity) cross-attention, eval
and train modes. Port of photoverse_tpu/models/unet.py.

The same class builds the SDXL base UNet: per-level head counts
(`level_heads`) and transformer depth (`transformer_layers_per_block`; the
mid block takes the last level's), levels without attention (`attention_levels`),
linear proj_in / proj_out (`use_linear_projection`) and the "text_time"
added conditioning (`addition_embed_type`): the pooled text embedding and
the sinusoidal embeddings of six time ids through `add_embedding`, added to
the time embedding. The defaults build SD-1.5, module for module.

Module names follow the diffusers UNet2DConditionModel state dict with the
PhotoVerse processor's `attn2.processor.to_{k,v}_ip.0`, which
`convert_unet` reads. The public forward keeps the JAX package's NHWC
layout. Inside, the activations are NCHW tensors in channels_last memory:
the input's permute is a channels_last view, and with the convolutions'
weights channels_last too (models/assembly.py:build_models) every
convolution, residual add, skip concatenation and nearest upsampling keeps
that layout. Without grad the GroupNorms read it as it lies
(layers.GroupNorm), so nothing converts back between the first convolution
and the last; Transformer2D's permutes to and from (B, S, C) are views.

Kernel routes (the build flags of the serving configuration):
  - use_flash_attention: self-attention at S >= flash_min_seq goes through
    ops.flash_sdpa under torch.no_grad() and through the differentiable
    ops.flash_sdpa_diff when grad is enabled (the 64^2 and 32^2 levels of
    SD-1.5);
  - fused_blocks: a layer given a fused bundle runs its LN2 + dual-context
    cross-attention + LN3 + GEGLU tail through ops.fused_block; eval only,
    so the bundles are ignored in train mode or when grad is enabled;
  - with no flag: every other block's cross-attention takes
    ops.dual_cross_attn's kernel for a bf16 input on the card under
    torch.no_grad() in eval fusion without a mask, at the sizes the kernel
    serves (`DualCrossAttention`).

Train mode (`forward(..., train=True, fusion_u=..., dropout_generator=...)`):
stochastic fusion per cross-attention layer from the caller's uniforms
(`fusion_u`, one per layer in call order) and LoRA dropout drawn from the
caller's generator.

`remat`: when grad is enabled, each resnet block and each transformer
block (Transformer2D) keeps only its inputs, and its activations are
recomputed in the backward (the JAX package's nn.remat at the same
boundaries; layers.remat replays the dropout generator for the recompute,
so a recomputed flash layer launches its lse forward a second time).

`ip_mask` (B, Hm, Wm) in [0, 1] restricts where the identity tokens act:
each block resizes it to its own latent resolution and computes text
attention + 2 x identity attention x mask, with no stochastic fusion and
without the fused tail.

Multi-GPU (parallel/): `UNet2DCondition(config, tp=TPShard(...))` builds
one rank's shard of a tensor-parallel UNet (the column-parallel
projections at H / tp heads, to_out and the feed-forward's output as
parallel.tp.RowParallelLinear, the column-parallel projections'
inputs through parallel.mesh.copy_to_model so that training's input
gradients are summed over the group); its `v_ip_norms` then hold the
rank's heads only. A `parallel.sp.Spatial` set by `parallel.sp.enable_spatial`
splits the latent rows: the 3x3 convolutions and GroupNorms exchange rows
or moments, self-attention gathers K and V (or hands them to
`UNetConfig.flash_fn`), and the identity mask is resized whole and then
cut to the rank's rows. `UNetConfig.flash_fn`, when set, is called in
place of the bare flash kernel (parallel/flash.py's wrapper).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from photoverse_tpu_torch.models import layers
from photoverse_tpu_torch.models.layers import (
    Conv2d, GroupNorm, Group, LayerNorm, Linear, ResnetBlock, Sampler, proj,
)
from photoverse_tpu_torch.ops.attention import dual_context_attention, identity_value_norm, sdpa
from photoverse_tpu_torch.ops.dual_cross_attn import dual_cross_attention, takes_kernel
from photoverse_tpu_torch.ops.flash_sdpa import flash_sdpa, flash_sdpa_diff
from photoverse_tpu_torch.ops.fused_block import fused_cross_ff
from photoverse_tpu_torch.parallel.mesh import copy_to_model
from photoverse_tpu_torch.parallel.tp import RowParallelLinear, TPShard
from photoverse_tpu_torch.utils import trace

__all__ = ["UNetConfig", "UNet2DCondition", "timestep_embedding"]

# weight of the identity branch on the masked route (the JAX package's
# UNetConfig.fusion_scale default, which no entry point changes)
MASK_FUSION_SCALE = 2.0


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    num_heads: int = 8
    norm_num_groups: int = 32
    lora_rank: int = 0  # 0 disables LoRA
    lora_alpha: float = 1.0
    lora_dropout: float = 0.0  # on the LoRA branch's input, train mode only
    use_flash_attention: bool = False
    flash_min_seq: int = 1024
    # called as flash_fn(q, k, v) in place of the bare flash kernel (the
    # sharded wrapper of parallel/flash.py)
    flash_fn: Optional[Callable] = None
    fast_attention_scores: bool = False
    fast_norms: bool = False
    fused_blocks: bool = False
    fused_block_max_channels: int = 320
    remat: bool = False
    # SDXL's shape (None / the defaults: SD-1.5's): heads per level (else
    # num_heads everywhere), transformer blocks per attention at each level
    # (else 1; the mid block takes the last level's, as diffusers' does),
    # which levels have attention (else all but the last), linear
    # projections around the blocks, and "text_time" added conditioning
    # from a pooled text embedding of `addition_text_embed_dim` and six
    # time ids
    level_heads: Optional[Tuple[int, ...]] = None
    transformer_layers_per_block: Optional[Tuple[int, ...]] = None
    attention_levels: Optional[Tuple[bool, ...]] = None
    use_linear_projection: bool = False
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    addition_text_embed_dim: int = 1280

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def heads(self, level: int) -> int:
        return self.num_heads if self.level_heads is None else self.level_heads[level]

    def depth(self, level: int) -> int:
        return 1 if self.transformer_layers_per_block is None else self.transformer_layers_per_block[level]

    def attends(self, level: int) -> bool:
        n = len(self.block_out_channels)
        return level < n - 1 if self.attention_levels is None else self.attention_levels[level]

    @property
    def added_cond_dim(self) -> int:
        """add_embedding's input: the pooled text embedding and six time ids'
        sinusoidal embeddings (0 without added conditioning)."""
        if self.addition_embed_type is None:
            return 0
        if self.addition_embed_type != "text_time":
            raise ValueError(f"addition_embed_type {self.addition_embed_type!r} is not built (only text_time)")
        return self.addition_text_embed_dim + 6 * self.addition_time_embed_dim


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, cos first (flip_sin_to_cos=True, freq_shift=0)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


@functools.lru_cache(maxsize=None)
def _cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of a 1-D cubic resize as jax.image.resize
    computes it: the Keys kernel with a = -0.5 at half-pixel centres,
    stretched by n_in / n_out when that shrinks (so it low-pass filters
    before it samples), each output's weights normalised to sum 1.
    F.interpolate(mode="bicubic") is another function (a = -0.75, no
    stretch)."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(n_out) / f32(n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), w)
    w = np.where(x >= 2.0, f32(0.0), w).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def _downsample_ip_mask(ip_mask: Optional[torch.Tensor], B: int, Hh: int, Ww: int) -> Optional[torch.Tensor]:
    """(B, Hm, Wm) -> (B, Hh*Ww) f32, resized to a block's latent
    resolution by two separable cubic matrices (an axis of equal size is
    left alone)."""
    if ip_mask is None:
        return None
    m = ip_mask.float()
    if m.shape[0] != B:
        raise ValueError(f"ip_mask has {m.shape[0]} rows for a batch of {B}")
    if m.shape[1] != Hh:
        wh = torch.from_numpy(_cubic_resize_matrix(m.shape[1], Hh)).to(m.device)
        m = torch.einsum("bhw,hH->bHw", m, wh)
    if m.shape[2] != Ww:
        ww = torch.from_numpy(_cubic_resize_matrix(m.shape[2], Ww)).to(m.device)
        m = torch.einsum("bhw,wW->bhW", m, ww)
    return m.reshape(B, Hh * Ww)


def _out_proj(local: int, ch: int, tp: Optional[TPShard]) -> nn.Module:
    """to_out / the feed-forward's output: row-parallel under TP."""
    return nn.Linear(local, ch) if tp is None else RowParallelLinear(local, ch, tp.comm)


def _tp_size(tp: Optional[TPShard]) -> int:
    return 1 if tp is None else tp.size


def _tp_comm(tp: Optional[TPShard]):
    return None if tp is None else tp.comm


class SelfAttention(nn.Module):
    """attn1; long sequences take the flash kernels when enabled: the
    differentiable route when grad is enabled, the no-grad one otherwise,
    or `UNetConfig.flash_fn` when set. The length that decides is the whole
    sequence's, also when the rows are split (`spatial`)."""

    spatial = None  # parallel.sp.Spatial

    def __init__(self, ch: int, heads: int, cfg: UNetConfig, tp: Optional[TPShard] = None):
        super().__init__()
        n = _tp_size(tp)
        self.heads = heads // n
        self.cfg = cfg
        self.tp_comm = _tp_comm(tp)
        self.to_q = nn.Linear(ch, ch // n, bias=False)
        self.to_k = nn.Linear(ch, ch // n, bias=False)
        self.to_v = nn.Linear(ch, ch // n, bias=False)
        self.to_out = nn.ModuleList([_out_proj(ch // n, ch, tp)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        H = self.heads
        x = copy_to_model(x, self.tp_comm)
        q = self.to_q(x).reshape(B, S, H, -1)
        k = self.to_k(x).reshape(B, S, H, -1)
        v = self.to_v(x).reshape(B, S, H, -1)
        cfg, sp = self.cfg, self.spatial
        if cfg.use_flash_attention and S * (1 if sp is None else sp.size) >= cfg.flash_min_seq:
            if cfg.flash_fn is not None:
                out = cfg.flash_fn(q, k, v)
            elif sp is not None:
                raise ValueError("a height-split UNet takes the flash kernel only through the sharded wrapper "
                                 "(parallel.flash.enable_sharded_flash)")
            else:
                out = (flash_sdpa_diff if torch.is_grad_enabled() else flash_sdpa)(q, k, v)
        else:
            if sp is not None:
                k, v = sp.gather_rows(k, 1), sp.gather_rows(v, 1)
            out = sdpa(q, k, v, fast_scores=cfg.fast_attention_scores)
        return self.to_out[0](out.reshape(B, S, -1))


class _IPProcessor(nn.Module):
    def __init__(self, cross_dim: int, ch: int):
        super().__init__()
        self.to_k_ip = nn.ModuleList([Linear(cross_dim, ch, bias=False)])
        self.to_v_ip = nn.ModuleList([Linear(cross_dim, ch, bias=False)])


class DualCrossAttention(nn.Module):
    """attn2: text cross-attention + identity cross-attention; eval fusion
    (sum) or, in train mode, stochastic fusion from `fusion_u`; with
    `ip_mask` (B, S) text + MASK_FUSION_SCALE x identity x mask. Returns
    (out, v_ip_norm (B, H, K)). A no-grad eval call on the card without a
    mask takes `dual_cross_attention`'s kernel when it serves the sizes
    (`takes_kernel`); every other call runs the einsums, and on the card
    counts `route.cross_attn_einsum`."""

    def __init__(self, ch: int, heads: int, cfg: UNetConfig, tp: Optional[TPShard] = None):
        super().__init__()
        n = _tp_size(tp)
        self.heads = heads // n
        cd, r, a, p = cfg.cross_attention_dim, cfg.lora_rank, cfg.lora_alpha, cfg.lora_dropout
        self.to_q = proj(ch, ch // n, r, a, p)
        self.to_k = proj(cd, ch // n, r, a, p)
        self.to_v = proj(cd, ch // n, r, a, p)
        self.to_out = nn.ModuleList([_out_proj(ch // n, ch, tp)])
        self.processor = _IPProcessor(cd, ch // n)
        self.tp_comm = _tp_comm(tp)
        for m in (self.to_q, self.to_k, self.to_v):
            m.comm = self.tp_comm

    def context_kv(self, text_ctx: torch.Tensor, id_ctx: torch.Tensor, train: bool = False,
                   generator: Optional[torch.Generator] = None):
        """(k, v, k_ip, v_ip), each (B, n, H, d): constant over a denoise
        trajectory, so the engine computes it once per call."""
        B = text_ctx.shape[0]
        H = self.heads
        split = lambda t: t.reshape(B, -1, H, t.shape[-1] // H)  # noqa: E731
        p = self.processor
        id_ctx = copy_to_model(id_ctx, self.tp_comm)
        return (split(self.to_k(text_ctx, train, generator)),
                split(self.to_v(text_ctx, train, generator)),
                split(p.to_k_ip[0](id_ctx)), split(p.to_v_ip[0](id_ctx)))

    def forward(self, x, text_ctx, id_ctx, ctx_kv=None, train=False, fusion_u=None, generator=None,
                ip_mask=None):
        B, S, _ = x.shape
        q = self.to_q(x, train, generator).reshape(B, S, self.heads, -1)
        if ctx_kv is None:
            ctx_kv = self.context_kv(text_ctx, id_ctx, train, generator)
        k, v, k_ip, v_ip = (t.to(x.dtype) for t in ctx_kv)
        kernel = takes_kernel(q, k.shape[1], k_ip.shape[1], train=train, masked=ip_mask is not None)
        if q.is_cuda and not kernel:
            trace.count("route.cross_attn_einsum")
        if kernel:
            fused, v_ip_norm = dual_cross_attention(q, k, v, k_ip, v_ip), identity_value_norm(v_ip)
        elif ip_mask is not None:
            text_out, id_out = sdpa(q, k, v), sdpa(q, k_ip, v_ip)
            fused = text_out + MASK_FUSION_SCALE * (id_out * ip_mask.to(text_out.dtype)[:, :, None, None])
            v_ip_norm = identity_value_norm(v_ip)
        else:
            fused, v_ip_norm = dual_context_attention(q, k, v, k_ip, v_ip, train=train, fusion_u=fusion_u)
        return self.to_out[0](fused.reshape(B, S, -1)), v_ip_norm


class _GEGLUProj(nn.Module):
    """The GEGLU up-projection: outputs [value; gate]. Under TP a rank's
    weight is [value slice r; gate slice r] (parallel.tp.shard_state_dict),
    so the same split gives it its own value and gate slices."""

    def __init__(self, ch: int, out: int):
        super().__init__()
        self.proj = nn.Linear(ch, out)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class _FeedForward(nn.Module):
    def __init__(self, ch: int, tp: Optional[TPShard] = None):
        super().__init__()
        n = _tp_size(tp)
        # diffusers keys ff.net.0.proj / ff.net.2 (index 1 is a dropout)
        self.net = nn.ModuleList([_GEGLUProj(ch, 8 * ch // n), nn.Identity(),
                                  _out_proj(4 * ch // n, ch, tp)])
        self.tp_comm = _tp_comm(tp)

    def forward(self, x):
        return self.net[2](self.net[0](copy_to_model(x, self.tp_comm)))


class BasicTransformerBlock(nn.Module):
    def __init__(self, ch: int, cfg: UNetConfig, tp: Optional[TPShard] = None, heads: Optional[int] = None):
        super().__init__()
        nf = not cfg.fast_norms
        self.heads = heads = heads or cfg.num_heads
        self.norm1 = LayerNorm(ch, 1e-5, nf)
        self.attn1 = SelfAttention(ch, heads, cfg, tp)
        self.norm2 = LayerNorm(ch, 1e-5, nf)
        self.attn2 = DualCrossAttention(ch, heads, cfg, tp)
        self.norm3 = LayerNorm(ch, 1e-5, nf)
        self.ff = _FeedForward(ch, tp)

    def forward(self, h, text_ctx, id_ctx, ctx_kv=None, fused_bundle=None, ip_mask=None, **train_kw):
        h = h + self.attn1(self.norm1(h))
        if fused_bundle is not None and ip_mask is None:
            # the whole tail (LN2 + dual-cross + LN3 + GEGLU + residuals)
            h = fused_cross_ff(h.contiguous(), fused_bundle, self.heads)
            v_ip = fused_bundle["ctx"][3]  # (B, H, K, d)
            return h, v_ip.float().square().sum(dim=-1).sqrt()
        a2, v_ip_norm = self.attn2(self.norm2(h), text_ctx, id_ctx, ctx_kv, ip_mask=ip_mask, **train_kw)
        h = h + a2
        return h + self.ff(self.norm3(h)), v_ip_norm


class Transformer2D(nn.Module):
    """GN -> proj_in -> `depth` BasicTransformerBlocks -> proj_out (+
    residual). proj_in / proj_out are 1x1 convolutions before and after the
    permute to (B, S, C), or, with `use_linear_projection`, linear layers
    after and before it."""

    spatial = None  # parallel.sp.Spatial

    def __init__(self, ch: int, cfg: UNetConfig, tp: Optional[TPShard] = None, heads: Optional[int] = None,
                 depth: int = 1):
        super().__init__()
        self.linear = cfg.use_linear_projection
        proj = (lambda: nn.Linear(ch, ch)) if self.linear else (lambda: nn.Conv2d(ch, ch, 1))  # noqa: E731
        self.norm = GroupNorm(cfg.norm_num_groups, ch, 1e-6, not cfg.fast_norms)
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(ch, cfg, tp, heads) for _ in range(depth)])
        self.proj_out = proj()

    def _mask(self, ip_mask, B, Hh, Ww):
        """The identity mask at this block's resolution (B, Hh * Ww): under
        a row split resized whole, then cut to this rank's rows."""
        sp = self.spatial
        if sp is None or ip_mask is None:
            return _downsample_ip_mask(ip_mask, B, Hh, Ww)
        m = _downsample_ip_mask(ip_mask, B, Hh * sp.size, Ww).reshape(B, Hh * sp.size, Ww)
        return sp.rows(m, 1).reshape(B, Hh * Ww)

    def forward(self, x, text_ctx, id_ctx, ctx_kv=None, fused_bundles=None, ip_mask=None, fusion_u=None,
                **train_kw):
        """`ctx_kv`, `fused_bundles` and `fusion_u` hold one entry per
        transformer block (or are None); returns (out, [v_ip_norm of each
        block])."""
        B, C, Hh, Ww = x.shape
        if self.linear:
            h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(B, Hh * Ww, C))
        else:
            h = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(B, Hh * Ww, C)
        mask = self._mask(ip_mask, B, Hh, Ww)
        norms = []
        for i, blk in enumerate(self.transformer_blocks):
            kw = train_kw if fusion_u is None else dict(train_kw, fusion_u=fusion_u[i])
            h, vn = blk(h, text_ctx, id_ctx, None if ctx_kv is None else ctx_kv[i],
                        None if fused_bundles is None else fused_bundles[i], mask, **kw)
            norms.append(vn)
        if self.linear:
            return self.proj_out(h).reshape(B, Hh, Ww, C).permute(0, 3, 1, 2) + x, norms
        h = h.reshape(B, Hh, Ww, C).permute(0, 3, 1, 2)
        return self.proj_out(h) + x, norms


class UNet2DCondition(nn.Module):
    """forward(sample (B,H,W,4), timesteps (B,), text_ctx (B,St,cross),
    id_ctx (B,K,cross)) -> (eps (B,H,W,4) f32, v_ip_norms (B, L*H*K)),
    L the transformer blocks in call order and H each one's heads. A UNet
    with added conditioning also takes `added_cond` = (pooled text
    embedding (B, addition_text_embed_dim), time ids (B, 6)).

    train=True takes `fusion_u` (L,), one uniform in [0, 1) per
    cross-attention layer in call order (the JAX package draws them as
    uniform(fold_in(fusion_rng, i))), and, with lora_dropout > 0, the
    `dropout_generator` the LoRA masks are drawn from. `ip_mask` (B, Hm, Wm)
    takes every block down the masked route (no fused tail).

    `tp` builds rank tp.rank's shard of a tensor-parallel UNet (load it with
    parallel.tp.shard_state_dict or build it with parallel.tp.shard_unet)."""

    spatial = None  # parallel.sp.Spatial: the split its layers were given

    def __init__(self, config: UNetConfig = UNetConfig(), tp: Optional[TPShard] = None):
        super().__init__()
        n = len(config.block_out_channels)
        heads = {config.heads(i) for i in range(n)}
        if tp is not None and any(h % tp.size for h in heads):
            raise ValueError(f"tensor_parallel={tp.size} must divide every level's heads {sorted(heads)}")
        self.config = cfg = config
        ch = cfg.block_out_channels
        tdim = cfg.time_embed_dim
        G = cfg.norm_num_groups
        nf = not cfg.fast_norms

        def res(i, o):
            return ResnetBlock(i, o, tdim, G, 1e-5, nf)

        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = Group()
        self.time_embedding.linear_1 = nn.Linear(ch[0], tdim)
        self.time_embedding.linear_2 = nn.Linear(tdim, tdim)
        self.add_embedding = None
        if cfg.added_cond_dim:
            self.add_embedding = Group()
            self.add_embedding.linear_1 = nn.Linear(cfg.added_cond_dim, tdim)
            self.add_embedding.linear_2 = nn.Linear(tdim, tdim)

        def attn(level):
            return Transformer2D(ch[level], cfg, tp, cfg.heads(level), cfg.depth(level))

        self.down_blocks = nn.ModuleList()
        in_c = ch[0]
        for i, c in enumerate(ch):
            blk = Group()
            blk.resnets = nn.ModuleList()
            blk.attentions = nn.ModuleList() if cfg.attends(i) else None
            for j in range(cfg.layers_per_block):
                blk.resnets.append(res(in_c if j == 0 else c, c))
                if blk.attentions is not None:
                    blk.attentions.append(attn(i))
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Sampler(Conv2d(c, c, 3, stride=2, padding=1))])
            in_c = c
            self.down_blocks.append(blk)

        self.mid_block = Group()
        self.mid_block.resnets = nn.ModuleList([res(ch[-1], ch[-1]), res(ch[-1], ch[-1])])
        self.mid_block.attentions = nn.ModuleList([attn(n - 1)])

        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList()
        prev = ch[-1]
        for i, c in enumerate(rev):
            blk = Group()
            blk.resnets = nn.ModuleList()
            blk.attentions = nn.ModuleList() if cfg.attends(n - 1 - i) else None
            skip_last = rev[min(i + 1, n - 1)]
            for j in range(cfg.layers_per_block + 1):
                skip_c = skip_last if j == cfg.layers_per_block else c
                blk.resnets.append(res((prev if j == 0 else c) + skip_c, c))
                if blk.attentions is not None:
                    blk.attentions.append(attn(n - 1 - i))
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Sampler(Conv2d(c, c, 3, padding=1))])
            prev = c
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm(G, ch[0], 1e-5, nf)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def set_config(self, config: UNetConfig) -> None:
        """Replace the config of the UNet and of its attention layers
        (routes only: the shapes must not change)."""
        self.config = config
        for m in self.modules():
            if isinstance(m, SelfAttention):
                m.cfg = config

    def cross_attentions(self):
        """The DualCrossAttention-bearing blocks in call order."""
        out = [a for blk in self.down_blocks if blk.attentions is not None for a in blk.attentions]
        out.append(self.mid_block.attentions[0])
        out += [a for blk in self.up_blocks if blk.attentions is not None for a in blk.attentions]
        return [b for t in out for b in t.transformer_blocks]

    def forward(
        self,
        sample: torch.Tensor,
        timesteps: torch.Tensor,
        text_ctx: torch.Tensor,
        id_ctx: torch.Tensor,
        ctx_kv: Optional[Sequence] = None,  # per cross layer (k, v, k_ip, v_ip)
        fused_bundles: Optional[Sequence] = None,  # per cross layer bundle or None
        train: bool = False,
        fusion_u: Optional[torch.Tensor] = None,  # (L,) uniforms, train mode
        dropout_generator: Optional[torch.Generator] = None,
        ip_mask: Optional[torch.Tensor] = None,  # (B, Hm, Wm) identity mask in [0, 1]
        added_cond: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (B, pooled), (B, 6) time ids
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = self.conv_in.weight.dtype
        B = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(B)
        if train and fusion_u is None:
            raise ValueError("fusion_u is required when train=True")
        if train or torch.is_grad_enabled() or ip_mask is not None:
            fused_bundles = None  # the fused tail is eval-only (no backward) and has no mask
        layer = itertools.count()  # cross-attention layers in call order
        remat = self.config.remat and torch.is_grad_enabled()

        def cross(attn, x):
            ids = [next(layer) for _ in attn.transformer_blocks]
            kw = dict(train=True, fusion_u=[fusion_u[i] for i in ids], generator=dropout_generator) if train else {}
            kv = None if ctx_kv is None else [ctx_kv[i] for i in ids]
            fb = None if fused_bundles is None else [fused_bundles[i] for i in ids]
            if not remat:
                return attn(x, text_ctx, id_ctx, kv, fb, ip_mask, **kw)
            return layers.remat(lambda x_, t_, d_: attn(x_, t_, d_, kv, fb, ip_mask, **kw),
                                x, text_ctx, id_ctx, generator=dropout_generator if train else None)

        def res(block, x):
            return layers.remat(block, x, temb) if remat else block(x, temb)

        temb = timestep_embedding(timesteps, self.config.block_out_channels[0]).to(dtype)
        temb = self.time_embedding.linear_2(F.silu(self.time_embedding.linear_1(temb)))
        if self.add_embedding is not None:
            temb = temb + self._added_embedding(added_cond, B, dtype)
        text_ctx = text_ctx.to(dtype)
        id_ctx = id_ctx.to(dtype)

        norms = []
        x = self.conv_in(sample.permute(0, 3, 1, 2).to(dtype))
        skips = [x]
        for blk in self.down_blocks:
            for j, r in enumerate(blk.resnets):
                x = res(r, x)
                if blk.attentions is not None:
                    x, vn = cross(blk.attentions[j], x)
                    norms += vn
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0].conv(x)
                skips.append(x)

        x = res(self.mid_block.resnets[0], x)
        x, vn = cross(self.mid_block.attentions[0], x)
        norms += vn
        x = res(self.mid_block.resnets[1], x)

        for blk in self.up_blocks:
            for j, r in enumerate(blk.resnets):
                x = res(r, torch.cat([x, skips.pop()], dim=1))
                if blk.attentions is not None:
                    x, vn = cross(blk.attentions[j], x)
                    norms += vn
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))

        eps = self.conv_out(self.conv_norm_out(x, silu=True))
        v_ip_norms = torch.cat([v.reshape(B, -1) for v in norms], dim=1)
        return eps.float().permute(0, 2, 3, 1), v_ip_norms

    def _added_embedding(self, added_cond, B: int, dtype) -> torch.Tensor:
        """add_embedding(concat(pooled text, sinusoidal embeddings of the six
        time ids)), as diffusers' "text_time" computes it."""
        if added_cond is None:
            raise ValueError("this UNet takes added conditioning: added_cond=(pooled text (B, D), time ids (B, 6))")
        pooled, time_ids = added_cond
        if pooled.shape[0] != B or time_ids.shape[0] != B:
            raise ValueError(f"added conditioning of {pooled.shape[0]} / {time_ids.shape[0]} rows for a batch of {B}")
        t = timestep_embedding(time_ids.reshape(-1), self.config.addition_time_embed_dim).reshape(B, -1)
        a = torch.cat([pooled.float(), t], dim=-1).to(dtype)
        return self.add_embedding.linear_2(F.silu(self.add_embedding.linear_1(a)))
