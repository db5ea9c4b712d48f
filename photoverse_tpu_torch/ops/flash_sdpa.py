"""Flash-attention forward: `flash_sdpa` (UNet self-attention, head dims 40
and 80) and `flash_sdpa_stream` (the VAE decoder's single-head d=512
attention). Port of the forward kernels in photoverse_tpu/ops/flash_sdpa.py.

Both run the CUDA kernel in `csrc/flash_fwd.cu` for a CUDA tensor and their
plain PyTorch version (`flash_sdpa_plain`, f32 einsum + softmax) for a CPU
tensor. Layout (B, S, H, d); K/V may be longer than Q.
"""

from __future__ import annotations

import torch

from photoverse_tpu_torch.ops import _build

__all__ = ["flash_sdpa", "flash_sdpa_stream", "flash_sdpa_plain", "KERNEL_HEAD_DIMS"]

# head dims the CUDA kernel is instantiated for (csrc/flash_fwd.cu)
KERNEL_HEAD_DIMS = (40, 80, 512)


def flash_sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T d^-0.5) v in f32; returns q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d**-0.5)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v.float())
    return out.to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, S, H, d) tensors")
    B, _, H, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must share a dtype")


def _launch(q, k, v) -> torch.Tensor:
    B, Sq, H, d = q.shape
    Skv = k.shape[1]
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CPU or CUDA tensors, got {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA flash kernel takes bf16, got {q.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernel is built for head dims {KERNEL_HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride on the head dim")
        # the kernel loads bf16 pairs as 32-bit words
        if t.data_ptr() % 4 or any(st % 2 for st in t.stride()[:3]):
            raise ValueError(f"{name} must be 4-byte aligned with even strides")
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    code = lib.pv_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, H, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        _build.stream_ptr(q.device),
    )
    _build.check(code, "pv_flash_fwd")
    return out


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Self-attention without an (S, S) tensor (UNet head dims 40 and 80);
    returns (B, Sq, H, d). The kernel keeps scores and softmax in f32 and
    takes the probabilities to TF32, not bf16, for the p v product, so
    unlike the TPU kernel it has no bf16-probability variant."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_sdpa_plain(q, k, v)
    out = _launch(q, k, v)
    _build.launch_counts["flash_sdpa"] += 1
    return out


def flash_sdpa_stream(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flash attention for large head dims (the VAE's d=512) on bf16
    inputs, the same kernel as flash_sdpa; returns (B, Sq, H, d)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_sdpa_plain(q, k, v)
    out = _launch(q, k, v)
    _build.launch_counts["flash_sdpa_stream"] += 1
    return out
