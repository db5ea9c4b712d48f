"""Fused transformer-block tail: LN2 + dual-context cross-attention + LN3 +
GEGLU feed-forward (+ both residuals) in one kernel. Port of
photoverse_tpu/ops/fused_block.py.

The region is the row-local tail of a TransformerBlock (everything after
the attn1 residual), eval mode only:

    h = h + to_out(dual_cross_attn(LN2(h), ctx))      # attn2, fusion = sum
    h = h + ff_out(geglu(ff_proj(LN3(h))))            # GEGLU ff

`build_block_bundle` stages one block's weights per head ((H, C, d) q and
(H, d, C) out projections, LoRA folded into q), `attach_ctx` adds the
layer's hoisted context K/V as (B, H, n, d). `fused_cross_ff` runs the CUDA
kernel in `csrc/fused_cross_ff.cu` for a CUDA tensor and
`reference_cross_ff` (f32 math) for a CPU tensor.
"""

from __future__ import annotations

import torch

from photoverse_tpu_torch.ops import _build

__all__ = [
    "fused_cross_ff",
    "reference_cross_ff",
    "build_block_bundle",
    "attach_ctx",
    "bundle_eligible",
]

LN_EPS = 1e-5
_F32_KEYS = ("ln2g", "ln2b", "bout", "ln3g", "ln3b", "bpa", "bpg", "bo")
_BF16_KEYS = ("wq", "wout", "wpa", "wpg", "wo")


def bundle_eligible(channels: int, num_heads: int, max_channels: int = 320) -> bool:
    """The fused path serves the C <= 320 blocks (the S=4096 level of the
    SD-1.5 UNet), as in the JAX package."""
    return channels <= max_channels and channels % num_heads == 0


@torch.no_grad()
def build_block_bundle(block, num_heads: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Per-head weight bundle from a port `BasicTransformerBlock` (eval:
    LoRA on to_q folded in, no dropout). Pure reshapes, built once per
    denoise call."""
    a2 = block.attn2
    wq = a2.to_q.effective_weight().t()  # (C, C) as x @ wq
    C = wq.shape[0]
    H = num_heads
    d = C // H
    ff_k = block.ff.net[0].proj.weight.t()  # (C, 8C)
    ff_b = block.ff.net[0].proj.bias
    F = ff_k.shape[1] // 2
    f32 = torch.float32

    def w(x):
        return x.to(dtype).contiguous()

    def vec(x):
        return x.to(f32).contiguous()

    return {
        "ln2g": vec(block.norm2.weight), "ln2b": vec(block.norm2.bias),
        "wq": w(wq.reshape(C, H, d).permute(1, 0, 2)),
        "wout": w(a2.to_out[0].weight.t().reshape(H, d, C)),
        "bout": vec(a2.to_out[0].bias),
        "ln3g": vec(block.norm3.weight), "ln3b": vec(block.norm3.bias),
        "wpa": w(ff_k[:, :F]), "wpg": w(ff_k[:, F:]),
        "bpa": vec(ff_b[:F]), "bpg": vec(ff_b[F:]),
        "wo": w(block.ff.net[2].weight.t()), "bo": vec(block.ff.net[2].bias),
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
    q = torch.einsum("bsc,hcd->bhsd", h2, f["wq"]) * (d**-0.5)
    ot = torch.einsum("bhst,bhtd->bhsd", torch.softmax(torch.einsum("bhsd,bhtd->bhst", q, kT), -1), vT)
    oi = torch.einsum("bhst,bhtd->bhsd", torch.softmax(torch.einsum("bhsd,bhtd->bhst", q, kI), -1), vI)
    x = x + torch.einsum("bhsd,hdc->bsc", ot + oi, f["wout"]) + f["bout"]
    h3 = ln(x, f["ln3g"], f["ln3b"])
    a = h3 @ f["wpa"] + f["bpa"]
    g = h3 @ f["wpg"] + f["bpg"]
    ff = a * torch.nn.functional.gelu(g)
    x = x + ff @ f["wo"] + f["bo"]
    return x.to(h.dtype)


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
    F = bundle["wpa"].shape[1]
    d = C // H
    if C % H:
        raise ValueError(f"channels {C} not divisible by {H} heads")
    if C % 8 or d % 8 or F % 8:  # the kernel copies rows 8 bf16 (16 bytes) at a time
        raise ValueError(f"the CUDA kernel needs C, C/H and F divisible by 8, got {C}, {d}, {F}")
    want = {
        "h": (h, (B, S, C), torch.bfloat16),
        "kT": (kT, (B, H, St, d), torch.bfloat16), "vT": (vT, (B, H, St, d), torch.bfloat16),
        "kI": (kI, (B, H, K, d), torch.bfloat16), "vI": (vI, (B, H, K, d), torch.bfloat16),
        "wq": (bundle["wq"], (H, C, d), torch.bfloat16),
        "wout": (bundle["wout"], (H, d, C), torch.bfloat16),
        "wpa": (bundle["wpa"], (C, F), torch.bfloat16),
        "wpg": (bundle["wpg"], (C, F), torch.bfloat16),
        "wo": (bundle["wo"], (F, C), torch.bfloat16),
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
    _build.launch_counts["fused_cross_ff"] += 1
    return out
