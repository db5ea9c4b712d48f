"""SD-1.5 UNet with dual-context (text + identity) cross-attention, eval
and train modes. Port of photoverse_tpu/models/unet.py.

Module names follow the diffusers UNet2DConditionModel state dict with the
PhotoVerse processor's `attn2.processor.to_{k,v}_ip.0`, which
`convert_unet` reads. The public forward keeps the JAX package's NHWC
layout; convolutions run NCHW inside.

Kernel routes (the build flags of the serving configuration):
  - use_flash_attention: self-attention at S >= flash_min_seq goes through
    ops.flash_sdpa under torch.no_grad() and through the differentiable
    ops.flash_sdpa_diff when grad is enabled (the 64^2 and 32^2 levels of
    SD-1.5);
  - fused_blocks: a layer given a fused bundle runs its LN2 + dual-context
    cross-attention + LN3 + GEGLU tail through ops.fused_block; eval only,
    so the bundles are ignored in train mode or when grad is enabled.

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
parallel.tp.RowParallelLinear); its `v_ip_norms` then hold the rank's
heads only. A `parallel.sp.Spatial` set by `parallel.sp.enable_spatial`
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
from photoverse_tpu_torch.ops.attention import dual_context_attention, sdpa
from photoverse_tpu_torch.ops.flash_sdpa import flash_sdpa, flash_sdpa_diff
from photoverse_tpu_torch.ops.fused_block import fused_cross_ff
from photoverse_tpu_torch.parallel.tp import RowParallelLinear, TPShard

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

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


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
        self.to_q = nn.Linear(ch, ch // n, bias=False)
        self.to_k = nn.Linear(ch, ch // n, bias=False)
        self.to_v = nn.Linear(ch, ch // n, bias=False)
        self.to_out = nn.ModuleList([_out_proj(ch // n, ch, tp)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        H = self.heads
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
    (out, v_ip_norm (B, H, K))."""

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

    def context_kv(self, text_ctx: torch.Tensor, id_ctx: torch.Tensor, train: bool = False,
                   generator: Optional[torch.Generator] = None):
        """(k, v, k_ip, v_ip), each (B, n, H, d): constant over a denoise
        trajectory, so the engine computes it once per call."""
        B = text_ctx.shape[0]
        H = self.heads
        split = lambda t: t.reshape(B, -1, H, t.shape[-1] // H)  # noqa: E731
        p = self.processor
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
        if ip_mask is not None:
            text_out, id_out = sdpa(q, k, v), sdpa(q, k_ip, v_ip)
            fused = text_out + MASK_FUSION_SCALE * (id_out * ip_mask.to(text_out.dtype)[:, :, None, None])
            v_ip_norm = v_ip.float().square().sum(dim=-1).sqrt().transpose(1, 2)
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

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, ch: int, cfg: UNetConfig, tp: Optional[TPShard] = None):
        super().__init__()
        nf = not cfg.fast_norms
        self.heads = cfg.num_heads
        self.norm1 = LayerNorm(ch, 1e-5, nf)
        self.attn1 = SelfAttention(ch, cfg.num_heads, cfg, tp)
        self.norm2 = LayerNorm(ch, 1e-5, nf)
        self.attn2 = DualCrossAttention(ch, cfg.num_heads, cfg, tp)
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
    """GN -> proj_in -> BasicTransformerBlock -> proj_out (+ residual)."""

    spatial = None  # parallel.sp.Spatial

    def __init__(self, ch: int, cfg: UNetConfig, tp: Optional[TPShard] = None):
        super().__init__()
        self.norm = GroupNorm(cfg.norm_num_groups, ch, 1e-6, not cfg.fast_norms)
        self.proj_in = nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(ch, cfg, tp)])
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def _mask(self, ip_mask, B, Hh, Ww):
        """The identity mask at this block's resolution (B, Hh * Ww): under
        a row split resized whole, then cut to this rank's rows."""
        sp = self.spatial
        if sp is None or ip_mask is None:
            return _downsample_ip_mask(ip_mask, B, Hh, Ww)
        m = _downsample_ip_mask(ip_mask, B, Hh * sp.size, Ww).reshape(B, Hh * sp.size, Ww)
        return sp.rows(m, 1).reshape(B, Hh * Ww)

    def forward(self, x, text_ctx, id_ctx, ctx_kv=None, fused_bundle=None, ip_mask=None, **train_kw):
        B, C, Hh, Ww = x.shape
        h = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(B, Hh * Ww, C)
        h, vn = self.transformer_blocks[0](h, text_ctx, id_ctx, ctx_kv, fused_bundle,
                                           self._mask(ip_mask, B, Hh, Ww), **train_kw)
        h = h.reshape(B, Hh, Ww, C).permute(0, 3, 1, 2)
        return self.proj_out(h) + x, vn


class UNet2DCondition(nn.Module):
    """forward(sample (B,H,W,4), timesteps (B,), text_ctx (B,St,cross),
    id_ctx (B,K,cross)) -> (eps (B,H,W,4) f32, v_ip_norms (B, L*H*K)).

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
        if tp is not None and config.num_heads % tp.size:
            raise ValueError(f"tensor_parallel={tp.size} must divide num_heads={config.num_heads}")
        self.config = cfg = config
        ch = cfg.block_out_channels
        n = len(ch)
        tdim = cfg.time_embed_dim
        G = cfg.norm_num_groups
        nf = not cfg.fast_norms

        def res(i, o):
            return ResnetBlock(i, o, tdim, G, 1e-5, nf)

        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = Group()
        self.time_embedding.linear_1 = nn.Linear(ch[0], tdim)
        self.time_embedding.linear_2 = nn.Linear(tdim, tdim)

        self.down_blocks = nn.ModuleList()
        in_c = ch[0]
        for i, c in enumerate(ch):
            blk = Group()
            blk.resnets = nn.ModuleList()
            blk.attentions = nn.ModuleList() if i < n - 1 else None
            for j in range(cfg.layers_per_block):
                blk.resnets.append(res(in_c if j == 0 else c, c))
                if i < n - 1:
                    blk.attentions.append(Transformer2D(c, cfg, tp))
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Sampler(Conv2d(c, c, 3, stride=2, padding=1))])
            in_c = c
            self.down_blocks.append(blk)

        self.mid_block = Group()
        self.mid_block.resnets = nn.ModuleList([res(ch[-1], ch[-1]), res(ch[-1], ch[-1])])
        self.mid_block.attentions = nn.ModuleList([Transformer2D(ch[-1], cfg, tp)])

        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList()
        prev = ch[-1]
        for i, c in enumerate(rev):
            blk = Group()
            blk.resnets = nn.ModuleList()
            blk.attentions = nn.ModuleList() if i > 0 else None
            skip_last = rev[min(i + 1, n - 1)]
            for j in range(cfg.layers_per_block + 1):
                skip_c = skip_last if j == cfg.layers_per_block else c
                blk.resnets.append(res((prev if j == 0 else c) + skip_c, c))
                if i > 0:
                    blk.attentions.append(Transformer2D(c, cfg, tp))
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
        return [t.transformer_blocks[0] for t in out]

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
            i = next(layer)
            kw = dict(train=True, fusion_u=fusion_u[i], generator=dropout_generator) if train else {}
            kv = None if ctx_kv is None else ctx_kv[i]
            fb = None if fused_bundles is None else fused_bundles[i]
            if not remat:
                return attn(x, text_ctx, id_ctx, kv, fb, ip_mask, **kw)
            return layers.remat(lambda x_, t_, d_: attn(x_, t_, d_, kv, fb, ip_mask, **kw),
                                x, text_ctx, id_ctx, generator=dropout_generator if train else None)

        def res(block, x):
            return layers.remat(block, x, temb) if remat else block(x, temb)

        temb = timestep_embedding(timesteps, self.config.block_out_channels[0]).to(dtype)
        temb = self.time_embedding.linear_2(F.silu(self.time_embedding.linear_1(temb)))
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
                    norms.append(vn)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0].conv(x)
                skips.append(x)

        x = res(self.mid_block.resnets[0], x)
        x, vn = cross(self.mid_block.attentions[0], x)
        norms.append(vn)
        x = res(self.mid_block.resnets[1], x)

        for blk in self.up_blocks:
            for j, r in enumerate(blk.resnets):
                x = res(r, torch.cat([x, skips.pop()], dim=1))
                if blk.attentions is not None:
                    x, vn = cross(blk.attentions[j], x)
                    norms.append(vn)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))

        eps = self.conv_out(F.silu(self.conv_norm_out(x)))
        v_ip_norms = torch.stack(norms, dim=1).reshape(B, -1)
        return eps.float().permute(0, 2, 3, 1), v_ip_norms
