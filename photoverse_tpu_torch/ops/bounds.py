"""The least time an H100 could take for one call of each hand-written
kernel: its operations and bytes from the call's shapes, and the larger of
the two quotients against the card's published peaks (NVIDIA's data sheet,
SXM part: 989 TFLOP/s dense bf16, 3.35 TB/s of device memory).

Bytes count each input read once and each output written once, whatever a
kernel reads again. Pure Python: no torch needed.
"""

from __future__ import annotations

__all__ = ["PEAK_FLOPS", "PEAK_BYTES", "bound_ms", "bound_by", "flash_fwd", "flash_bwd",
           "fused_cross_ff", "group_norm"]

PEAK_FLOPS = 989e12  # bf16 tensor cores, dense
PEAK_BYTES = 3.35e12
BF16, F32 = 2, 4


def bound_ms(ops: float, nbytes: float, peak_flops: float = PEAK_FLOPS,
             peak_bytes: float = PEAK_BYTES) -> float:
    return max(ops / peak_flops, nbytes / peak_bytes) * 1e3


def bound_by(ops: float, nbytes: float, peak_flops: float = PEAK_FLOPS,
             peak_bytes: float = PEAK_BYTES) -> str:
    return "operations" if ops / peak_flops >= nbytes / peak_bytes else "bytes"


def flash_fwd(B: int, Sq: int, Skv: int, H: int, d: int, with_lse: bool = False):
    """(operations, bytes) of softmax(q k^T) v on (B, S, H, d) bf16: the two
    products, 2 FLOPs a multiply-add; q, k, v in, out (and the f32 lse) out.
    Serves flash_sdpa (head dims 40, 64 and 80), flash_sdpa_stream and their
    lse forwards."""
    ops = 4 * B * H * Sq * Skv * d
    nbytes = BF16 * B * H * d * (2 * Sq + 2 * Skv) + (F32 * B * H * Sq if with_lse else 0)
    return ops, nbytes


def flash_bwd(B: int, S: int, H: int, d: int):
    """(operations, bytes) of dq, dk, dv from q, k, v, out, lse, g: five
    products (q k^T, g v^T, p^T g, ds k, ds^T q); five bf16 tensors and the
    f32 lse in, three bf16 tensors out."""
    ops = 10 * B * H * S * S * d
    nbytes = BF16 * 8 * B * S * H * d + F32 * B * H * S
    return ops, nbytes


def fused_cross_ff(B: int, S: int, C: int, H: int, St: int, K: int, F: int):
    """(operations, bytes) of the fused block tail: the q and out
    projections (2 C^2 a token), the GEGLU's three products (3 C F), the
    scores and weighted sums over St + K context tokens; hidden states in
    and out, the weights, the context K/V and the f32 vectors once."""
    ops = 2 * B * S * C * (2 * C + 3 * F) + 4 * B * S * C * (St + K)
    nbytes = (BF16 * (2 * B * S * C + 2 * C * C + 3 * C * F + 2 * B * C * (St + K))
              + F32 * (6 * C + 2 * F))
    return ops, nbytes


def group_norm(N: int, HW: int, C: int, add: bool = False, itemsize: int = BF16):
    """(operations, bytes) of group_norm_nhwc on (N, H W, C): no matrix
    product, so no operation counts against the tensor-core peak; x in and
    out once, the (N, C) add, the weight and the bias, all of x's type."""
    nbytes = itemsize * (2 * N * HW * C + (N * C if add else 0) + 2 * C)
    return 0, nbytes
