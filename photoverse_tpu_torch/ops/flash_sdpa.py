"""Flash attention: the no-grad forwards `flash_sdpa` (UNet self-attention,
head dims 40 and 80 of SD-1.5, 64 of SDXL) and `flash_sdpa_stream` (the VAE's single-head d=512
attention), and their differentiable counterparts `flash_sdpa_diff` and
`flash_sdpa_stream_diff`. Port of photoverse_tpu/ops/flash_sdpa.py.

Kernels (all in csrc/, launched for CUDA tensors; every product wgmma,
every tile fed by TMA):
  - flash_sdpa (head dims 40, 64 and 80): csrc/flash_fwd_wgmma.cu;
    flash_sdpa_stream (d=512): csrc/flash_fwd_stream.cu;
  - the forward of both autograd Functions: the same two kernels with
    their log-sum-exp output (`flash_fwd_lse`);
  - the backward of flash_sdpa_diff: csrc/flash_bwd.cu (`flash_bwd`).
The backward of flash_sdpa_stream_diff is `stream_bwd_chunked` in plain
torch on every device, as the JAX package's is plain XLA.

Each wrapper runs its plain PyTorch version (`flash_sdpa_plain`,
`flash_fwd_lse_plain`, `flash_bwd_plain`) for a CPU tensor. Layout
(B, S, H, d); the no-grad forwards take K/V longer than Q, the
differentiable ones need equal lengths. The no-grad forwards refuse inputs
that require grad while grad is enabled: their kernel output carries no
gradient.
"""

from __future__ import annotations

import torch

from photoverse_tpu_torch.ops import _build
from photoverse_tpu_torch.utils import trace

__all__ = [
    "flash_sdpa",
    "flash_sdpa_stream",
    "flash_sdpa_diff",
    "flash_sdpa_stream_diff",
    "flash_fwd_lse",
    "flash_bwd",
    "flash_sdpa_plain",
    "flash_fwd_lse_plain",
    "flash_bwd_plain",
    "stream_bwd_chunked",
    "KERNEL_HEAD_DIMS",
    "BWD_HEAD_DIMS",
]

# head dims the CUDA kernels are built for: csrc/flash_fwd_wgmma.cu (40, 64,
# 80) and csrc/flash_fwd_stream.cu (512); csrc/flash_bwd.cu
KERNEL_HEAD_DIMS = (40, 64, 80, 512)
BWD_HEAD_DIMS = (40, 80)


def flash_sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T d^-0.5) v in f32; returns q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d**-0.5)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v.float())
    return out.to(q.dtype)


def flash_fwd_lse_plain(q, k, v):
    """(out in q's dtype, lse (B, H, Sq) f32): f32 einsum + logsumexp."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d**-0.5)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]), v.float())
    return out.to(q.dtype), lse


def _delta(out, g):
    """rowsum(g * out) as (B, H, S) f32."""
    return (g.float() * out).sum(dim=-1, dtype=torch.float32).transpose(1, 2).contiguous()


def _check_equal_lengths(q, k, what):
    if q.shape[1] != k.shape[1]:
        raise ValueError(
            f"{what} requires equal q/k sequence lengths (got Sq={q.shape[1]}, "
            f"Skv={k.shape[1]}); the unequal-length forward (flash_sdpa) is inference-only"
        )


def flash_bwd_plain(q, k, v, out, lse, g):
    """(dq, dk, dv) of softmax(q k^T d^-0.5) v from the saved (out, lse), by
    the explicit formula: p = exp(s - lse), dv = p^T g, dp = g v^T,
    ds = p (dp - rowsum(g out)), dq = ds k d^-0.5, dk = ds^T q d^-0.5."""
    _check_equal_lengths(q, k, "flash backward")
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - _delta(out, g)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def stream_bwd_chunked(q, k, v, out, lse, g, chunk: int = 512):
    """Flash backward with the keys taken `chunk` at a time (port of
    `_stream_bwd_chunked`): each chunk's probabilities are rebuilt from
    (q, lse), so memory is O(B*H*S*chunk), never a full (S, S) tensor."""
    _check_equal_lengths(q, k, "flash backward")
    B, S, H, d = q.shape
    while S % chunk:
        chunk -= 1
    scale = d**-0.5
    qt, kt, vt, gt, ot = (x.transpose(1, 2).float() for x in (q, k, v, g, out))  # (B, H, S, d)
    delta = (gt * ot).sum(dim=-1, keepdim=True)
    lse_b = lse[..., None]
    dq = torch.zeros_like(qt)
    dks, dvs = [], []
    for j in range(0, S, chunk):
        kj, vj = kt[:, :, j:j + chunk], vt[:, :, j:j + chunk]
        p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qt, kj) * scale - lse_b)
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, gt))
        dp = torch.einsum("bhqd,bhkd->bhqk", gt, vj)
        ds = p * (dp - delta) * scale
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kj)
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qt))
    back = lambda x: x.transpose(1, 2)  # noqa: E731
    return (back(dq).to(q.dtype), back(torch.cat(dks, dim=2)).to(k.dtype),
            back(torch.cat(dvs, dim=2)).to(v.dtype))


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


def _refuse_grad(name, *ts):
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name} is the no-grad forward: its kernel output carries no gradient; "
            f"use {name}_diff, or call it under torch.no_grad()"
        )


def _check_tma_layout(name, t):
    """TMA's rules for a (B, S, H, d) bf16 tensor read in place: the data
    16-byte aligned and every stride but d's a multiple of 16 bytes."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have unit stride on the head dim")
    if (t.storage_offset() * t.element_size()) % 16 or any(st % 8 for st in t.stride()[:3]):
        raise ValueError(f"{name} must be 16-byte aligned with strides that are multiples of "
                         f"8 elements (got offset {t.storage_offset()}, strides {tuple(t.stride())})")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_kernel_inputs(dims, **ts):
    """The kernels read bf16 (B, S, H, d) tensors in place through TMA."""
    for name, t in ts.items():
        if t.device.type != "cuda":
            raise ValueError(f"flash attention runs on CPU or CUDA tensors, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA flash kernels take bf16, got {t.dtype} for {name}")
        if t.shape[-1] not in dims:
            raise ValueError(f"the CUDA flash kernel is built for head dims {dims}, got {t.shape[-1]}")
        _check_tma_layout(name, t)


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def _launch(q, k, v, with_lse: bool):
    B, Sq, H, d = q.shape
    _check_kernel_inputs(KERNEL_HEAD_DIMS, q=q, k=k, v=v)
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _build.load_library()
    name = "pv_flash_fwd_stream" if d == 512 else "pv_flash_fwd_wgmma"
    code = getattr(lib, name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, B, Sq, k.shape[1], H, d, *_strides(q, k, v),
        _build.stream_ptr(q.device))
    _build.check(code, name)
    return (out, lse) if with_lse else out


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Self-attention without an (S, S) tensor (UNet head dims 40, 64 and 80);
    returns (B, Sq, H, d). The kernel keeps scores and softmax in f32 and
    takes the probabilities to bf16 for the p v product."""
    _check(q, k, v)
    _refuse_grad("flash_sdpa", q, k, v)
    if q.device.type == "cpu":
        return flash_sdpa_plain(q, k, v)
    out = _launch(q, k, v, with_lse=False)
    trace.count("launch.flash_sdpa")
    return out


def flash_sdpa_stream(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flash attention for large head dims (the VAE's d=512) on bf16
    inputs, the same kernel as flash_sdpa; returns (B, Sq, H, d)."""
    _check(q, k, v)
    _refuse_grad("flash_sdpa_stream", q, k, v)
    if q.device.type == "cpu":
        return flash_sdpa_plain(q, k, v)
    out = _launch(q, k, v, with_lse=False)
    trace.count("launch.flash_sdpa_stream")
    return out


def flash_fwd_lse(q, k, v):
    """(out, lse (B, H, Sq) f32), the forward of the autograd Functions.
    A launch counts as flash_stream_fwd_lse for the VAE's d=512 and as
    flash_sdpa_fwd_lse for the UNet's head dims."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_lse_plain(q, k, v)
    out = _launch(q, k, v, with_lse=True)
    trace.count("launch.flash_stream_fwd_lse" if q.shape[-1] == 512 else "launch.flash_sdpa_fwd_lse")
    return out


def flash_bwd(q, k, v, out, lse, g):
    """(dq, dk, dv) from the forward's (out, lse) and the output gradient g,
    in the inputs' dtype. Kernels for head dims 40 and 80 (csrc/flash_bwd.cu:
    one for dq, one for dk and dv); delta = rowsum(g out) is computed here,
    in torch. The kernels round p and ds to bf16 for their products."""
    _check(q, k, v)
    _check_equal_lengths(q, k, "flash backward")
    if g.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} and out {tuple(out.shape)} must be shaped as q {tuple(q.shape)}")
    B, S, H, d = q.shape
    if lse.shape != (B, H, S):
        raise ValueError(f"lse has shape {tuple(lse.shape)}, want {(B, H, S)}")
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, g)
    g = g.contiguous()
    _check_kernel_inputs(BWD_HEAD_DIMS, q=q, k=k, v=v, g=g)
    lse = lse.float().contiguous()
    delta = _delta(out, g)
    dq, dk, dv = (torch.empty((B, S, H, d), dtype=q.dtype, device=q.device) for _ in range(3))
    code = _build.load_library().pv_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, d, *_strides(q, k, v, g),
        _build.stream_ptr(q.device),
    )
    _build.check(code, "pv_flash_bwd")
    trace.count("launch.flash_bwd")
    return dq, dk, dv


class _FlashSdpaDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_fwd_lse(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        return flash_bwd(*ctx.saved_tensors, g)


class _FlashStreamDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_fwd_lse(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        return stream_bwd_chunked(*ctx.saved_tensors, g)


def flash_sdpa_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable flash self-attention (UNet head dims 40 and 80): the
    lse forward, and the flash backward kernel; equal q/k lengths."""
    _check(q, k, v)
    _check_equal_lengths(q, k, "flash_sdpa_diff")
    return _FlashSdpaDiff.apply(q, k, v)


def flash_sdpa_stream_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable streaming flash attention (the VAE's d=512): the lse
    forward, and the chunked backward in plain torch (bounded memory: each
    chunk's probabilities are rebuilt from the saved lse)."""
    _check(q, k, v)
    _check_equal_lengths(q, k, "flash_sdpa_stream_diff")
    return _FlashStreamDiff.apply(q, k, v)
