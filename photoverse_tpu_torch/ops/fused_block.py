"""Fused transformer-block tail: LN2 + dual-context cross-attention + LN3 +
GEGLU feed-forward (+ both residuals) in one kernel. Port of
photoverse_tpu/ops/fused_block.py.

The region is the row-local tail of a TransformerBlock (everything after
the attn1 residual), eval mode only:

    h = h + to_out(dual_cross_attn(LN2(h), ctx))      # attn2, fusion = sum
    h = h + ff_out(geglu(ff_proj(LN3(h))))            # GEGLU ff

`build_block_bundle` stages one block's weights as nn.Linear holds them,
(out, in): wq and wout (C, C) over all heads (LoRA folded into q), wpa and
wpg (F, C), wo (C, F); that order is the K-major B operand of the kernel's
wgmma products, read in place by its TMA tensor maps. `attach_ctx` adds the
layer's hoisted context K/V as (B, H, n, d). `fused_cross_ff` runs the CUDA
kernel in `csrc/fused_cross_ff.cu` for a CUDA tensor and
`reference_cross_ff` (f32 math) for a CPU tensor.
"""

from __future__ import annotations

import torch

from photoverse_tpu_torch.ops import _build
from photoverse_tpu_torch.utils import trace

__all__ = [
    "fused_cross_ff",
    "reference_cross_ff",
    "build_block_bundle",
    "attach_ctx",
    "bundle_eligible",
    "kernel_serves",
    "check_kernel_shape",
]

LN_EPS = 1e-5
# What the CUDA kernel is built for: the UNet's C=320 blocks with 8 heads,
# up to 80 text and 8 identity tokens, F a multiple of 64.
KERNEL_CHANNELS, KERNEL_HEADS, KERNEL_MAX_TEXT, KERNEL_MAX_ID, KERNEL_F_MULTIPLE = 320, 8, 80, 8, 64
_F32_KEYS = ("ln2g", "ln2b", "bout", "ln3g", "ln3b", "bpa", "bpg", "bo")
_BF16_KEYS = ("wq", "wout", "wpa", "wpg", "wo")


def bundle_eligible(channels: int, num_heads: int, max_channels: int = 320) -> bool:
    """The fused path serves the C <= 320 blocks (the S=4096 level of the
    SD-1.5 UNet), as in the JAX package. On the card the CUDA kernel narrows
    this further: see `kernel_serves`."""
    return channels <= max_channels and channels % num_heads == 0


@torch.no_grad()
def build_block_bundle(block, num_heads: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Weight bundle from a port `BasicTransformerBlock` (eval: LoRA on
    to_q folded in, no dropout), every matrix (out, in) as the modules hold
    it. Built once per denoise call."""
    a2 = block.attn2
    ff_w = block.ff.net[0].proj.weight  # (8C, C): a's rows, then the gate's
    ff_b = block.ff.net[0].proj.bias
    F = ff_w.shape[0] // 2
    f32 = torch.float32

    def w(x):
        return x.to(dtype).contiguous()

    def vec(x):
        return x.to(f32).contiguous()

    return {
        "ln2g": vec(block.norm2.weight), "ln2b": vec(block.norm2.bias),
        "wq": w(a2.to_q.effective_weight()),
        "wout": w(a2.to_out[0].weight),
        "bout": vec(a2.to_out[0].bias),
        "ln3g": vec(block.norm3.weight), "ln3b": vec(block.norm3.bias),
        "wpa": w(ff_w[:F]), "wpg": w(ff_w[F:]),
        "bpa": vec(ff_b[:F]), "bpg": vec(ff_b[F:]),
        "wo": w(block.ff.net[2].weight), "bo": vec(block.ff.net[2].bias),
    }


def attach_ctx(bundle: dict, ctx_kv, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Add the layer's hoisted context K/V, (B, n, H, d) -> (B, H, n, d)."""
    out = dict(bundle)
    out["ctx"] = tuple(x.to(dtype).transpose(1, 2).contiguous() for x in ctx_kv)
    return out


def reference_cross_ff(h: torch.Tensor, bundle: dict, num_heads: int) -> torch.Tensor:
    """The fused region in f32 (the plain version of the kernel)."""
    B, S, C = h.shape
    d = C // num_heads
    kT, vT, kI, vI = (t.float() for t in bundle["ctx"])
    f = {k: bundle[k].float() for k in _F32_KEYS + _BF16_KEYS}
    x = h.float()

    def ln(x, g, b):
        mu = x.mean(-1, keepdim=True)
        xc = x - mu
        var = (xc * xc).mean(-1, keepdim=True)
        return xc * torch.rsqrt(var + LN_EPS) * g + b

    h2 = ln(x, f["ln2g"], f["ln2b"])
    q = (h2 @ f["wq"].t()).reshape(B, S, num_heads, d).transpose(1, 2) * (d**-0.5)
    ot = torch.einsum("bhst,bhtd->bhsd", torch.softmax(torch.einsum("bhsd,bhtd->bhst", q, kT), -1), vT)
    oi = torch.einsum("bhst,bhtd->bhsd", torch.softmax(torch.einsum("bhsd,bhtd->bhst", q, kI), -1), vI)
    x = x + (ot + oi).transpose(1, 2).reshape(B, S, C) @ f["wout"].t() + f["bout"]
    h3 = ln(x, f["ln3g"], f["ln3b"])
    a = h3 @ f["wpa"].t() + f["bpa"]
    g = h3 @ f["wpg"].t() + f["bpg"]
    ff = a * torch.nn.functional.gelu(g)
    x = x + ff @ f["wo"].t() + f["bo"]
    return x.to(h.dtype)


def kernel_serves(C: int, H: int, St: int, K: int, F: int) -> bool:
    """Whether the CUDA kernel is built for these sizes. The layer that
    routes blocks to the fused tail asks this for a model on the card; a
    block it does not serve keeps the unfused tail."""
    return ((C, H) == (KERNEL_CHANNELS, KERNEL_HEADS) and 0 < St <= KERNEL_MAX_TEXT
            and 0 < K <= KERNEL_MAX_ID and F > 0 and F % KERNEL_F_MULTIPLE == 0)


def check_kernel_shape(C: int, H: int, St: int, K: int, F: int) -> None:
    """Raise unless the CUDA kernel is built for these sizes."""
    if not kernel_serves(C, H, St, K, F):
        raise ValueError(
            f"the CUDA kernel is built for C={KERNEL_CHANNELS}, {KERNEL_HEADS} heads, at most "
            f"{KERNEL_MAX_TEXT} text and {KERNEL_MAX_ID} identity tokens and F a multiple of "
            f"{KERNEL_F_MULTIPLE}; got C={C}, H={H}, St={St}, K={K}, F={F}")


def fused_cross_ff(h: torch.Tensor, bundle: dict, num_heads: int) -> torch.Tensor:
    """Apply the fused block tail; returns the new (B, S, C) hidden states.
    Eval only: like the JAX kernel it has no backward, so it refuses inputs
    that require grad while grad is enabled."""
    if torch.is_grad_enabled():
        ts = [h, *bundle.get("ctx", ())] + [t for t in bundle.values() if isinstance(t, torch.Tensor)]
        if any(t.requires_grad for t in ts):
            raise RuntimeError(
                "fused_cross_ff has no backward: call it under torch.no_grad() "
                "(training keeps the unfused block tail)"
            )
    if h.device.type == "cpu":
        return reference_cross_ff(h, bundle, num_heads)
    if h.device.type != "cuda":
        raise ValueError(f"fused_cross_ff runs on CPU or CUDA tensors, got {h.device}")
    B, S, C = h.shape
    H = num_heads
    kT, vT, kI, vI = bundle["ctx"]
    St, K = kT.shape[2], kI.shape[2]
    F = bundle["wpa"].shape[0]
    if C % H:
        raise ValueError(f"channels {C} not divisible by {H} heads")
    d = C // H
    check_kernel_shape(C, H, St, K, F)
    want = {
        "h": (h, (B, S, C), torch.bfloat16),
        "kT": (kT, (B, H, St, d), torch.bfloat16), "vT": (vT, (B, H, St, d), torch.bfloat16),
        "kI": (kI, (B, H, K, d), torch.bfloat16), "vI": (vI, (B, H, K, d), torch.bfloat16),
        "wq": (bundle["wq"], (C, C), torch.bfloat16),
        "wout": (bundle["wout"], (C, C), torch.bfloat16),
        "wpa": (bundle["wpa"], (F, C), torch.bfloat16),
        "wpg": (bundle["wpg"], (F, C), torch.bfloat16),
        "wo": (bundle["wo"], (C, F), torch.bfloat16),
    }
    for k in ("ln2g", "ln2b", "bout", "ln3g", "ln3b", "bo"):
        want[k] = (bundle[k], (C,), torch.float32)
    for k in ("bpa", "bpg"):
        want[k] = (bundle[k], (F,), torch.float32)
    for name, (t, shape, dt) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_cross_ff: {name} has shape {tuple(t.shape)}, want {shape}")
        if t.dtype != dt:
            raise TypeError(f"fused_cross_ff: {name} is {t.dtype}, the CUDA kernel takes {dt}")
        if t.device != h.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_cross_ff: {name} must be contiguous and 16-byte aligned on {h.device}")
    out = torch.empty_like(h)
    lib = _build.load_library()
    code = lib.pv_fused_cross_ff(
        h.data_ptr(), out.data_ptr(),
        kT.data_ptr(), vT.data_ptr(), kI.data_ptr(), vI.data_ptr(),
        bundle["ln2g"].data_ptr(), bundle["ln2b"].data_ptr(),
        bundle["wq"].data_ptr(), bundle["wout"].data_ptr(), bundle["bout"].data_ptr(),
        bundle["ln3g"].data_ptr(), bundle["ln3b"].data_ptr(),
        bundle["wpa"].data_ptr(), bundle["wpg"].data_ptr(),
        bundle["bpa"].data_ptr(), bundle["bpg"].data_ptr(),
        bundle["wo"].data_ptr(), bundle["bo"].data_ptr(),
        B, S, C, H, St, K, F, _build.stream_ptr(h.device),
    )
    _build.check(code, "pv_fused_cross_ff")
    trace.count("launch.fused_cross_ff")
    return out
