"""The dual-context cross-attention of an unfused transformer block in one
kernel, for the no-grad eval forward: `dual_cross_attention`.

    out = softmax(q k^T / sqrt(d)) v + softmax(q k_ip^T / sqrt(d)) v_ip

q (B, S, H, d) is attn2's `to_q` output as it lies; k, v (B, St, H, d) and
k_ip, v_ip (B, K, H, d) are the layer's hoisted context K/V; out is (B, S,
H, d). The plain version is the eval arithmetic of
`attention.dual_context_attention`: f32 scores and softmax, the
probabilities rounded to q's dtype, each context's output rounded, then
their sum. The kernel (`csrc/dual_cross_attn.cu`) rounds the probabilities
alike but sums the two contexts in f32 and rounds once.

A CUDA tensor runs the kernel (bf16, head dims 40, 64, 80 and 160, 1-80
text and 1-8 identity rows: `kernel_serves`) or raises; a CPU tensor runs
the plain version. The kernel has no backward, so the wrapper refuses
inputs that require grad while grad is enabled. `takes_kernel` is
`models/unet.py:DualCrossAttention`'s route to it.
"""

from __future__ import annotations

import torch

from photoverse_tpu_torch.ops import _build
from photoverse_tpu_torch.ops.attention import dual_context_attention
from photoverse_tpu_torch.utils import trace

__all__ = ["dual_cross_attention", "dual_cross_attention_plain", "kernel_serves", "check_kernel_shape",
           "takes_kernel"]

# What the CUDA kernel is built for: every attending level of SD-1.5 (d 40,
# 80, 160) and SDXL (d 64), up to 80 text and 8 identity rows.
KERNEL_HEAD_DIMS, KERNEL_MAX_TEXT, KERNEL_MAX_ID = (40, 64, 80, 160), 80, 8


def kernel_serves(d: int, St: int, K: int) -> bool:
    """Whether the CUDA kernel is built for head dim d, St text and K
    identity context rows."""
    return d in KERNEL_HEAD_DIMS and 0 < St <= KERNEL_MAX_TEXT and 0 < K <= KERNEL_MAX_ID


def check_kernel_shape(d: int, St: int, K: int) -> None:
    """Raise unless the CUDA kernel is built for these sizes."""
    if not kernel_serves(d, St, K):
        raise ValueError(f"the CUDA kernel is built for head dims {KERNEL_HEAD_DIMS}, 1 to {KERNEL_MAX_TEXT} text "
                         f"and 1 to {KERNEL_MAX_ID} identity rows; got d={d}, St={St}, K={K}")


def takes_kernel(q, St: int, K: int, *, train: bool, masked: bool) -> bool:
    """The cross-attention's route: a bf16 CUDA q in an eval forward under
    no_grad, without an identity mask, at sizes the kernel serves. Every
    other call (the grad path, train-mode fusion, the mask, the CPU) keeps
    the einsums."""
    return (q.device.type == "cuda" and q.dtype == torch.bfloat16 and not train and not masked
            and not torch.is_grad_enabled() and kernel_serves(q.shape[-1], St, K))


def dual_cross_attention_plain(q, k, v, k_ip, v_ip) -> torch.Tensor:
    """The einsum route's eval output (the plain version of the kernel)."""
    return dual_context_attention(q, k, v, k_ip, v_ip)[0]


def dual_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_ip: torch.Tensor,
                         v_ip: torch.Tensor) -> torch.Tensor:
    """Both contexts' attention, summed: (B, S, H, d) in q's dtype. The UNet
    calls it once a block a step, so the checks are kept to what the kernel
    cannot survive."""
    ts = (q, k, v, k_ip, v_ip)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("dual_cross_attention has no backward: call it under torch.no_grad() "
                           "(a grad-enabled forward keeps the einsums)")
    dev = q.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return dual_cross_attention_plain(*ts)
        raise ValueError(f"dual_cross_attention runs on CPU or CUDA tensors, got {dev}")
    if q.dim() != 4:
        raise ValueError(f"dual_cross_attention: q must be (B, S, H, d), got {tuple(q.shape)}")
    B, S, H, d = q.shape
    St, K = k.shape[1], k_ip.shape[1]
    check_kernel_shape(d, St, K)
    strides = []  # (b, s, h) of each input, in elements
    for name, t, n in (("q", q, S), ("k", k, St), ("v", v, St), ("k_ip", k_ip, K), ("v_ip", v_ip, K)):
        if t.shape != (B, n, H, d):
            raise ValueError(f"dual_cross_attention: {name} has shape {tuple(t.shape)}, want {(B, n, H, d)}")
        if t.dtype != torch.bfloat16 or t.device != dev:
            raise TypeError(f"dual_cross_attention: {name} is {t.dtype} on {t.device}, the CUDA kernel takes "
                            f"bf16 on {dev}")
        st = t.stride()
        if st[3] != 1 or st[0] % 8 or st[1] % 8 or st[2] % 8 or t.data_ptr() % 16:
            raise ValueError(f"dual_cross_attention: {name} must have unit stride on d, strides {st} "
                             "in multiples of 8 and 16-byte aligned data")
        strides += st[:3]
    out = torch.empty(B, S, H, d, dtype=q.dtype, device=dev)
    code = _build.load_library().pv_dual_cross_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_ip.data_ptr(), v_ip.data_ptr(), out.data_ptr(),
        B, S, H, d, St, K, *strides, _build.stream_ptr(dev))
    _build.check(code, "pv_dual_cross_attn")
    trace.count("launch.dual_cross_attn")
    return out
