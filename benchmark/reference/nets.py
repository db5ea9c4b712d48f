"""Plain PyTorch reference of the PhotoVerse model family: the CLIP text
and vision encoders, the two adapters, the SD-1.5 UNet with dual-context
cross-attention and LoRA, the VAE, the ArcFace ResNet-18 and the
DPM-Solver++(2M) sampler.

It imports torch and numpy only, and nothing of the program under test.
Every function reads its weights from a `Weights` view of a flat
{key: tensor} dict in the diffusers / transformers key schema, computes in
float32 (the caller turns TF32 off) and rounds the operands of every
product through `Numerics`, which is where the lower-precision control
comes in. Tensors are NCHW inside; the public image tensors are NHWC.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "Weights", "Numerics", "strict_f32", "attention", "unet", "text_encoder", "vision_encoder",
    "adapter", "vae_decode", "vae_encode_moments", "arcface", "DPMSolver2M", "timestep_embedding",
    "inject", "DropoutMasks",
]


class Weights:
    """Read access to the benchmark's weights by key, as float32 on
    `device`; `override` holds tensors that take a key's place (the
    trainables the reference trains)."""

    def __init__(self, tensors: Dict[str, torch.Tensor], device):
        self.tensors = tensors
        self.device = torch.device(device)
        self.override: Dict[str, torch.Tensor] = {}

    def __call__(self, key: str) -> torch.Tensor:
        if key in self.override:
            return self.override[key]
        return self.tensors[key].to(self.device, torch.float32)

    def has(self, key: str) -> bool:
        return key in self.override or key in self.tensors


class Numerics:
    """How the operands of each product are rounded: "f32" keeps them;
    "fp8" rounds each through float8 e4m3 with one scale per tensor (its
    largest magnitude to 448), the control one step below bf16."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"unknown numerics {mode!r}")
        self.mode = mode

    def r(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.mode == "fp8":
            s = (x.detach().abs().amax() / 448.0).clamp(min=1e-30)
            x = x + ((x / s).to(torch.float8_e4m3fn).float() * s - x).detach()
        return x


@contextlib.contextmanager
def strict_f32():
    """float32 products without TF32, in matmuls and convolutions."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


# ---------------------------------------------------------------------------
# layers


def lin(W, N, p: str, x, bias: bool = True):
    y = torch.matmul(N.r(x), N.r(W(p + ".weight")).t())
    return y + W(p + ".bias") if bias else y


def conv(W, N, p: str, x, stride: int = 1, padding: int = 0, bias: bool = True):
    return F.conv2d(N.r(x), N.r(W(p + ".weight")), W(p + ".bias") if bias else None, stride, padding)


def gn(W, p: str, x, groups: int, eps: float):
    return F.group_norm(x, groups, W(p + ".weight"), W(p + ".bias"), eps)


def ln(W, p: str, x, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), W(p + ".weight"), W(p + ".bias"), eps)


def _attend(N, q, k, v, scale, mask):
    s = torch.matmul(N.r(q), N.r(k).transpose(-1, -2)) * scale
    if mask is not None:
        s = s + mask
    return torch.matmul(N.r(torch.softmax(s, dim=-1)), N.r(v))


def attention(N, q, k, v, mask=None, max_scores: int = 1 << 27):
    """softmax(q k^T / sqrt(d)) v over (B, H, S, d), in blocks of the
    flattened (B, H) so that a block's scores stay under `max_scores`
    elements; under grad each block is recomputed in the backward."""
    scale = q.shape[-1] ** -0.5
    B, H, Sq, d = q.shape
    q2, k2, v2 = (t.reshape(B * H, t.shape[2], d) for t in (q, k, v))
    step = max(1, max_scores // (Sq * k.shape[2]))
    outs = []
    for i in range(0, B * H, step):
        args = (q2[i:i + step], k2[i:i + step], v2[i:i + step])
        if torch.is_grad_enabled() and step < B * H:
            from torch.utils.checkpoint import checkpoint

            outs.append(checkpoint(_attend, N, *args, scale, mask, use_reentrant=False))
        else:
            outs.append(_attend(N, *args, scale, mask))
    return torch.cat(outs).reshape(B, H, Sq, d)


def heads(x, h: int):
    """(B, S, C) -> (B, h, S, C / h)."""
    B, S, C = x.shape
    return x.reshape(B, S, h, C // h).transpose(1, 2)


def merge(x):
    B, h, S, d = x.shape
    return x.transpose(1, 2).reshape(B, S, h * d)


class DropoutMasks:
    """LoRA dropout in train mode: the keep mask of each (layer,
    projection) drawn once from `generator` as u >= p, u = torch.rand of
    the input's shape, in the order of first use; a recompute reuses it."""

    def __init__(self, generator: torch.Generator, p: float):
        self.generator, self.p, self.masks = generator, p, {}

    def __call__(self, key, x):
        if key not in self.masks:
            u = torch.rand(x.shape, generator=self.generator, device=self.generator.device)
            self.masks[key] = (u >= self.p).to(x.device)
        return torch.where(self.masks[key], x / (1.0 - self.p), torch.zeros((), device=x.device))


def lora_proj(W, N, p: str, x, lora, drop=None, key=None):
    """A bias-free projection; with LoRA (rank, alpha) the branch
    (alpha / rank) * B(A(drop(x)))."""
    if not lora:
        return lin(W, N, p, x, bias=False)
    rank, alpha = lora
    h = x if drop is None else drop(key, x)
    branch = lin(W, N, p + ".lora_B.default", lin(W, N, p + ".lora_A.default", h, False), False)
    return lin(W, N, p + ".base_layer", x, bias=False) + branch * (alpha / rank)


# ---------------------------------------------------------------------------
# UNet


def timestep_embedding(t, dim: int):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    a = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1)


def resnet(W, N, p: str, x, temb, groups: int, eps: float):
    h = conv(W, N, p + ".conv1", F.silu(gn(W, p + ".norm1", x, groups, eps)), padding=1)
    if temb is not None:
        h = h + lin(W, N, p + ".time_emb_proj", F.silu(temb))[:, :, None, None]
    h = conv(W, N, p + ".conv2", F.silu(gn(W, p + ".norm2", h, groups, eps)), padding=1)
    sc = conv(W, N, p + ".conv_shortcut", x) if W.has(p + ".conv_shortcut.weight") else x
    return sc + h


def transformer(W, N, p: str, x, text, idc, cfg, layer: int, train):
    """GN -> proj_in -> [self-attn, dual cross-attn, GEGLU] -> proj_out, +x;
    returns it with the identity values' norms (B, H, K). `train` (None in
    eval): dict(fusion_u, drop)."""
    B, C, Hh, Ww = x.shape
    h = conv(W, N, p + ".proj_in", gn(W, p + ".norm", x, cfg["groups"], 1e-6))
    h = h.permute(0, 2, 3, 1).reshape(B, Hh * Ww, C)
    b = p + ".transformer_blocks.0"
    nh = cfg["heads"]
    a = ln(W, b + ".norm1", h)
    q, k, v = (heads(lin(W, N, f"{b}.attn1.to_{n}", a, False), nh) for n in "qkv")
    h = h + lin(W, N, b + ".attn1.to_out.0", merge(attention(N, q, k, v)))

    a = ln(W, b + ".norm2", h)
    lora = cfg.get("lora")
    drop = None if train is None else train["drop"]
    q = heads(lora_proj(W, N, b + ".attn2.to_q", a, lora, drop, (layer, "q")), nh)
    k = heads(lora_proj(W, N, b + ".attn2.to_k", text, lora, drop, (layer, "k")), nh)
    v = heads(lora_proj(W, N, b + ".attn2.to_v", text, lora, drop, (layer, "v")), nh)
    k_ip = heads(lin(W, N, b + ".attn2.processor.to_k_ip.0", idc, False), nh)
    v_ip = heads(lin(W, N, b + ".attn2.processor.to_v_ip.0", idc, False), nh)
    t_out, i_out = attention(N, q, k, v), attention(N, q, k_ip, v_ip)
    v_norm = v_ip.square().sum(-1).sqrt()  # (B, H, K)
    if train is None:
        fused = t_out + i_out
    else:
        u = float(train["fusion_u"][layer])
        fused = 2.0 * t_out if u < 1.0 / 3.0 else (2.0 * i_out if u > 2.0 / 3.0 else t_out + i_out)
    h = h + lin(W, N, b + ".attn2.to_out.0", merge(fused))

    a = ln(W, b + ".norm3", h)
    val, gate = lin(W, N, b + ".ff.net.0.proj", a).chunk(2, dim=-1)
    h = h + lin(W, N, b + ".ff.net.2", val * F.gelu(gate))
    h = h.reshape(B, Hh, Ww, C).permute(0, 3, 1, 2)
    return conv(W, N, p + ".proj_out", h) + x, v_norm


def unet(W, N, cfg, sample, t, text, idc, train=None, checkpoint_blocks: bool = False):
    """sample (B, h, w, 4) NHWC, t (B,), text (B, St, cd), idc (B, K, cd)
    -> (eps (B, h, w, 4), v_ip norms (B, L*H*K)). cfg: channels,
    layers_per_block, heads, groups, lora (rank, alpha) or None."""
    ch = cfg["channels"]
    n = len(ch)
    G = cfg["groups"]
    layer = iter(range(10 ** 6))
    norms: List[torch.Tensor] = []

    def run(fn, *a):
        if checkpoint_blocks and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            return checkpoint(fn, *a, use_reentrant=False)
        return fn(*a)

    def res(p, x):
        return run(lambda x_, te_: resnet(W, N, p, x_, te_, G, 1e-5), x, temb)

    def xattn(p, x):
        i = next(layer)
        out, v_norm = run(lambda x_, t_, d_: transformer(W, N, p, x_, t_, d_, cfg, i, train), x, text, idc)
        norms.append(v_norm)
        return out

    temb = timestep_embedding(t, ch[0])
    temb = lin(W, N, "unet.time_embedding.linear_2", F.silu(lin(W, N, "unet.time_embedding.linear_1", temb)))
    x = conv(W, N, "unet.conv_in", sample.permute(0, 3, 1, 2).float(), padding=1)
    skips = [x]
    for i in range(n):
        p = f"unet.down_blocks.{i}"
        for j in range(cfg["layers_per_block"]):
            x = res(f"{p}.resnets.{j}", x)
            if i < n - 1:
                x = xattn(f"{p}.attentions.{j}", x)
            skips.append(x)
        if i < n - 1:
            x = conv(W, N, f"{p}.downsamplers.0.conv", x, stride=2, padding=1)
            skips.append(x)
    x = res("unet.mid_block.resnets.0", x)
    x = xattn("unet.mid_block.attentions.0", x)
    x = res("unet.mid_block.resnets.1", x)
    for i in range(n):
        p = f"unet.up_blocks.{i}"
        for j in range(cfg["layers_per_block"] + 1):
            x = res(f"{p}.resnets.{j}", torch.cat([x, skips.pop()], dim=1))
            if i > 0:
                x = xattn(f"{p}.attentions.{j}", x)
        if i < n - 1:
            x = conv(W, N, f"{p}.upsamplers.0.conv", F.interpolate(x, scale_factor=2.0, mode="nearest"),
                     padding=1)
    x = conv(W, N, "unet.conv_out", F.silu(gn(W, "unet.conv_norm_out", x, G, 1e-5)), padding=1)
    B = sample.shape[0]
    return x.permute(0, 2, 3, 1), torch.stack(norms, dim=1).reshape(B, -1)


# ---------------------------------------------------------------------------
# CLIP


def _clip_layer(W, N, p: str, x, nh: int, eps: float, mask=None):
    a = ln(W, p + ".layer_norm1", x, eps)
    q, k, v = (heads(lin(W, N, f"{p}.self_attn.{n}_proj", a), nh) for n in "qkv")
    x = x + lin(W, N, p + ".self_attn.out_proj", merge(attention(N, q, k, v, mask)))
    h = lin(W, N, p + ".mlp.fc1", ln(W, p + ".layer_norm2", x, eps))
    return x + lin(W, N, p + ".mlp.fc2", h * torch.sigmoid(1.702 * h))


def inject(emb, concept, pidx):
    """Each row's K concept tokens in place of its placeholder at p; the
    tokens after it move right by K - 1 and the sequence keeps its length."""
    S = emb.shape[1]
    rows = []
    for b in range(emb.shape[0]):
        p = int(pidx[b])
        rows.append(torch.cat([emb[b, :p], concept[b], emb[b, p + 1:]])[:S])
    return torch.stack(rows)


def text_encoder(W, N, cfg, ids, concept=None, pidx=None):
    """ids (B, S) -> last hidden state (B, S, D), the concept tokens
    spliced in at each row's placeholder."""
    pre = "text_encoder"
    x = W(pre + ".embeddings.token_embedding.weight")[ids]
    if concept is not None:
        x = inject(x, concept.float(), pidx)
    S = ids.shape[1]
    x = x + W(pre + ".embeddings.position_embedding.weight")[:S][None]
    mask = torch.full((S, S), float("-inf"), device=x.device).triu(1)
    for i in range(cfg["layers"]):
        x = _clip_layer(W, N, f"{pre}.encoder.layers.{i}", x, cfg["heads"], 1e-5, mask)
    return ln(W, pre + ".final_layer_norm", x)


def vision_encoder(W, N, cfg, px):
    """px (B, 224, 224, 3) CLIP-normalised NHWC -> [last hidden state,
    then the hidden states of cfg['collect']] (B, 1 + P, D) each."""
    pre = "vision_encoder"
    B = px.shape[0]
    patches = F.conv2d(N.r(px.permute(0, 3, 1, 2).float()), N.r(W(pre + ".embeddings.patch_embedding.weight")),
                       stride=cfg["patch"]).flatten(2).transpose(1, 2)
    cls = W(pre + ".embeddings.class_embedding").expand(B, 1, -1)
    x = torch.cat([cls, patches], dim=1) + W(pre + ".embeddings.position_embedding.weight")[None]
    x = ln(W, pre + ".pre_layrnorm", x)
    states = {0: x}
    for i in range(cfg["layers"]):
        x = _clip_layer(W, N, f"{pre}.encoder.layers.{i}", x, cfg["heads"], 1e-5)
        states[i + 1] = x
    return [x] + [states[i] for i in cfg["collect"]]


def _mlp(W, N, p: str, x):
    x = F.leaky_relu(ln(W, p + ".1", lin(W, N, p + ".0", x)), 0.01)
    x = F.leaky_relu(ln(W, p + ".4", lin(W, N, p + ".3", x)), 0.01)
    return lin(W, N, p + ".6", x)


def adapter(W, N, p: str, feats: Sequence[torch.Tensor], tokens: Sequence[int]):
    """Token i: mapping_i(CLS of feature set i) + the patch mean of
    mapping_patch_i(patches of set i) -> (B, len(tokens), cd)."""
    out = [_mlp(W, N, f"{p}.mapping_{i}", feats[i][:, 0])
           + _mlp(W, N, f"{p}.mapping_patch_{i}", feats[i][:, 1:]).mean(dim=1) for i in tokens]
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# VAE


def _vae_attn(W, N, p: str, x, groups: int):
    B, C, H, Wd = x.shape
    h = gn(W, p + ".group_norm", x, groups, 1e-6).flatten(2).transpose(1, 2)
    q, k, v = (lin(W, N, f"{p}.to_{n}", h)[:, None] for n in "qkv")
    out = lin(W, N, p + ".to_out.0", attention(N, q, k, v)[:, 0])
    return x + out.transpose(1, 2).reshape(B, C, H, Wd)


def _vae_mid(W, N, p: str, x, G: int):
    x = resnet(W, N, p + ".resnets.0", x, None, G, 1e-6)
    x = _vae_attn(W, N, p + ".attentions.0", x, G)
    return resnet(W, N, p + ".resnets.1", x, None, G, 1e-6)


def vae_decode(W, N, cfg, z, checkpoint_blocks: bool = False):
    """Unscaled latents (B, h, w, 4) NHWC -> pixels (B, H, W, 3) NHWC."""
    G = cfg["groups"]
    ch = list(reversed(cfg["channels"]))

    def run(fn, x):
        if checkpoint_blocks and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            return checkpoint(fn, x, use_reentrant=False)
        return fn(x)

    x = conv(W, N, "vae.post_quant_conv", z.permute(0, 3, 1, 2).float())
    x = conv(W, N, "vae.decoder.conv_in", x, padding=1)
    x = run(lambda h: _vae_mid(W, N, "vae.decoder.mid_block", h, G), x)
    for i in range(len(ch)):
        p = f"vae.decoder.up_blocks.{i}"
        for j in range(cfg["layers_per_block"] + 1):
            x = run(lambda h, q=f"{p}.resnets.{j}": resnet(W, N, q, h, None, G, 1e-6), x)
        if i < len(ch) - 1:
            x = run(lambda h, q=p: conv(W, N, f"{q}.upsamplers.0.conv",
                                        F.interpolate(h, scale_factor=2.0, mode="nearest"), padding=1), x)
    x = conv(W, N, "vae.decoder.conv_out", F.silu(gn(W, "vae.decoder.conv_norm_out", x, G, 1e-6)), padding=1)
    return x.permute(0, 2, 3, 1)


def vae_encode_moments(W, N, cfg, px):
    """pixels (B, H, W, 3) in [-1, 1] -> (mean, logvar) (B, h, w, 4),
    logvar clipped to [-30, 20]."""
    G = cfg["groups"]
    ch = cfg["channels"]
    x = conv(W, N, "vae.encoder.conv_in", px.permute(0, 3, 1, 2).float(), padding=1)
    for i in range(len(ch)):
        p = f"vae.encoder.down_blocks.{i}"
        for j in range(cfg["layers_per_block"]):
            x = resnet(W, N, f"{p}.resnets.{j}", x, None, G, 1e-6)
        if i < len(ch) - 1:
            x = conv(W, N, f"{p}.downsamplers.0.conv", F.pad(x, (0, 1, 0, 1)), stride=2)
    x = _vae_mid(W, N, "vae.encoder.mid_block", x, G)
    x = conv(W, N, "vae.encoder.conv_out", F.silu(gn(W, "vae.encoder.conv_norm_out", x, G, 1e-6)), padding=1)
    m = conv(W, N, "vae.quant_conv", x).permute(0, 2, 3, 1)
    mean, logvar = m.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


# ---------------------------------------------------------------------------
# ArcFace ResNet-18 (IR blocks, eval batch norm, one PReLU per block)


def _bn(W, p: str, x):
    s = W(p + ".weight") * torch.rsqrt(W(p + ".running_var") + 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * s.reshape(shape) + (W(p + ".bias") - W(p + ".running_mean") * s).reshape(shape)


def _prelu(W, p: str, x):
    return F.prelu(x, W(p + ".weight"))


def arcface(W, N, cfg, x):
    """x (B, S, S, 1) grayscale in [-1, 1] -> (B, 512) embeddings."""
    pre = "arcface"
    h = F.conv2d(N.r(x.permute(0, 3, 1, 2)), N.r(W(pre + ".conv1.weight")), padding=1)
    h = F.max_pool2d(_prelu(W, pre + ".prelu", _bn(W, pre + ".bn1", h)), 2, 2)
    in_ch = 64
    for si, (planes, blocks) in enumerate(zip(cfg["channels"], cfg["layers"])):
        for bi in range(blocks):
            s = (1 if si == 0 else 2) if bi == 0 else 1
            p = f"{pre}.layer{si + 1}.{bi}"
            y = F.conv2d(N.r(_bn(W, p + ".bn0", h)), N.r(W(p + ".conv1.weight")), padding=1)
            y = _prelu(W, p + ".prelu", _bn(W, p + ".bn1", y))
            y = _bn(W, p + ".bn2", F.conv2d(N.r(y), N.r(W(p + ".conv2.weight")), stride=s, padding=1))
            if bi == 0 and (s != 1 or in_ch != planes):
                r = F.conv2d(N.r(h), N.r(W(p + ".downsample.0.weight")), stride=s)
                r = _bn(W, p + ".downsample.1", r)
            else:
                r = h
            h = _prelu(W, p + ".prelu", y + r)
            in_ch = planes
    h = _bn(W, pre + ".bn4", h).flatten(1)
    return _bn(W, pre + ".bn5", lin(W, N, pre + ".fc5", h))


# ---------------------------------------------------------------------------
# DPM-Solver++(2M)


class DPMSolver2M:
    """Multistep DPM-Solver++ of order 2 (midpoint) on the SD-1.5 DDPM
    schedule (scaled linear betas 0.00085 .. 0.012 over 1000 steps): integer
    timesteps linspace(0, 999, N + 1) rounded, descending, the last dropped;
    first order on the first step, on the last (whose sigma is 0, so it
    returns the x0-prediction) and, for N < 15, on the one before it."""

    def __init__(self, num_steps: int, train_steps: int = 1000):
        betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, train_steps, dtype=np.float64) ** 2
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        full = np.sqrt((1.0 - self.alphas_cumprod) / self.alphas_cumprod)
        self.timesteps = np.linspace(0, train_steps - 1, num_steps + 1).round()[::-1][:-1].astype(np.int64)
        self.sigmas = np.concatenate([full[self.timesteps], [0.0]])
        self.num_steps = num_steps

    @staticmethod
    def _vp(sig: float) -> Tuple[float, float]:
        a = 1.0 / math.sqrt(sig * sig + 1.0)
        return a, sig * a

    def add_noise(self, x0, noise, step: int = 0):
        """A clean sample noised to solver step `step`."""
        a, s = self._vp(float(self.sigmas[step]))
        return a * x0 + s * noise

    def step(self, i: int, x, eps, m_prev):
        """-> (x at step i + 1, the x0-prediction of step i)."""
        N = self.num_steps
        a0, s0 = self._vp(float(self.sigmas[i]))
        m = (x - s0 * eps) / a0
        sig_t = float(self.sigmas[i + 1])
        if sig_t == 0.0:
            return m, m
        at, st = self._vp(sig_t)
        h = math.log(at / st) - math.log(a0 / s0)
        em1 = math.expm1(-h)
        if i == 0 or (N < 15 and i == N - 2):
            return (st / s0) * x - at * em1 * m, m
        a1, s1 = self._vp(float(self.sigmas[i - 1]))
        r0 = (math.log(a0 / s0) - math.log(a1 / s1)) / h
        d1 = (m - m_prev) / r0
        return (st / s0) * x - at * em1 * m - 0.5 * at * em1 * d1, m
