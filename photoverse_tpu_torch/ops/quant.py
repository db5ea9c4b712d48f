"""W8A8 dynamic int8 matmul for the frozen conditioning encoders. Port of
photoverse_tpu/ops/quant.py.

Both operands are quantized on every call: per-output-channel symmetric
weight scales (max |W| over the input dim), one per-tensor activation amax,
round half to even, clip at +-127, an int8 x int8 -> int32 product, then
acc * (a_scale * w_scale) + bias. `Int8Linear` is an nn.Linear with the
same parameter names, shapes and dtypes, so state dicts load unchanged.

Routes: on the CPU the product is the int32 matmul of the codes (the
plain version); on the card it is `torch._int_mm` on the 2-D view, the
counterpart of the JAX package's int8 `dot_general` (a library product in
both packages, not a Pallas kernel). A row count `_int_mm` refuses (16 or
fewer) is padded with zero rows; an input or output width that is not a
multiple of 8 raises. The product is never dequantized into a float
matmul.

Inference-only: `round` has zero gradient (engine/training.py refuses
models built with it).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from photoverse_tpu_torch.ops import _build

__all__ = ["quantize_weight", "quantize_activation", "int8_product", "int8_matmul", "Int8Linear"]

QMAX = 127.0
# torch._int_mm wants more than 16 rows and widths that are multiples of 8
_INT_MM_MIN_ROWS = 17


def _scale(amax: torch.Tensor) -> torch.Tensor:
    # divided by a tensor on the same device, never by a Python number: on
    # the card PyTorch turns division by a host scalar into multiplication
    # by its reciprocal, one rounding away from the JAX package's division
    return torch.clamp(amax, min=1e-8) / torch.full((), QMAX, device=amax.device)


def quantize_weight(weight: torch.Tensor):
    """(N, K) weight -> int8 codes (N, K) and f32 scales (N,)."""
    w = weight.float()
    scale = _scale(w.abs().amax(dim=1))
    return torch.clamp(torch.round(w / scale[:, None]), -QMAX, QMAX).to(torch.int8), scale


def quantize_activation(x: torch.Tensor):
    """(..., K) activations -> int8 codes and one f32 scale over the whole tensor."""
    xf = x.float()
    scale = _scale(xf.abs().amax())
    return torch.clamp(torch.round(xf / scale), -QMAX, QMAX).to(torch.int8), scale


def int8_product(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32, exact. A CPU tensor takes
    the plain int32 matmul; a CUDA tensor takes torch._int_mm."""
    if x_q.device.type == "cpu":
        return torch.matmul(x_q.int(), w_q.int().t())
    M, K = x_q.shape
    N = w_q.shape[0]
    if K % 8 or N % 8:
        raise ValueError(f"torch._int_mm needs widths that are multiples of 8, got K={K}, N={N}")
    a = x_q.contiguous()
    if M < _INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _INT_MM_MIN_ROWS - M))
    acc = torch._int_mm(a, w_q.contiguous().t())
    _build.launch_counts["int8_matmul"] += 1
    return acc[:M]


def int8_matmul(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                out_dtype: torch.dtype) -> torch.Tensor:
    """y = x @ weight.T (+ bias) with both operands dynamically quantized;
    weight is nn.Linear's (N, K)."""
    w_q, w_scale = quantize_weight(weight)
    x_q, a_scale = quantize_activation(x)
    acc = int8_product(x_q.reshape(-1, x.shape[-1]), w_q)
    y = acc.float() * (a_scale * w_scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).reshape(*x.shape[:-1], weight.shape[0])


class Int8Linear(nn.Linear):
    """nn.Linear drop-in whose product is W8A8 int8; the output keeps the
    input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul(x, self.weight, self.bias, x.dtype)
