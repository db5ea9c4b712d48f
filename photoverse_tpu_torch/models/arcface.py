"""ArcFace ResNet-18 face embedder, eval mode. Port of
photoverse_tpu/models/arcface.py.

IRBlock stages (2, 2, 2, 2) at 64/128/256/512 channels, without the
squeeze-excitation variant (the reference's configuration), on a grayscale
input_size x input_size image, a 512-d embedding. Used frozen, as the face
loss's network, so BatchNorm runs in eval mode with its running statistics
held as parameters. Each IRBlock applies ONE shared PReLU at both of its
activation sites, as the reference does.

Module names follow the reference ResNetFace state dict (`conv1`, `bn1`,
`prelu`, `layer{i}.{j}.{bn0,conv1,bn1,prelu,conv2,bn2,downsample.{0,1}}`,
`bn4`, `fc5`, `bn5`). The public forward is NHWC; convolutions run NCHW, so
fc5 reads the (C, H, W) flattening, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["ArcFaceConfig", "ArcFaceResNet18", "init_arcface"]


@dataclasses.dataclass(frozen=True)
class ArcFaceConfig:
    layers: Tuple[int, ...] = (2, 2, 2, 2)
    channels: Tuple[int, ...] = (64, 128, 256, 512)
    embedding_dim: int = 512
    input_size: int = 128


class BatchNormEval(nn.Module):
    """Eval-mode batch norm over dim 1: x * s + (bias - mean * s), with
    s = weight / sqrt(running_var + eps)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * inv.reshape(shape) + (self.bias - self.running_mean * inv).reshape(shape)


def _conv3(i: int, o: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(i, o, 3, stride=stride, padding=1, bias=False)


class IRBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int, has_downsample: bool):
        super().__init__()
        self.bn0 = BatchNormEval(in_ch)
        self.conv1 = _conv3(in_ch, in_ch)
        self.bn1 = BatchNormEval(in_ch)
        self.prelu = nn.PReLU()
        self.conv2 = _conv3(in_ch, out_ch, stride)
        self.bn2 = BatchNormEval(out_ch)
        self.downsample = (
            nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False), BatchNormEval(out_ch))
            if has_downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.prelu(self.bn1(self.conv1(self.bn0(x))))
        h = self.bn2(self.conv2(h))
        residual = x if self.downsample is None else self.downsample(x)
        return self.prelu(h + residual)


class ArcFaceResNet18(nn.Module):
    def __init__(self, config: ArcFaceConfig = ArcFaceConfig(), device="cuda"):
        super().__init__()
        self.config = cfg = config
        with torch.device(device):
            self._build(cfg)

    def _build(self, cfg: ArcFaceConfig) -> None:
        self.conv1 = _conv3(1, 64)
        self.bn1 = BatchNormEval(64)
        self.prelu = nn.PReLU()
        self.maxpool = nn.MaxPool2d(2, 2)
        in_ch = 64
        for si, (planes, blocks) in enumerate(zip(cfg.channels, cfg.layers)):
            stride = 1 if si == 0 else 2
            stage = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                stage.append(IRBlock(in_ch, planes, s, bi == 0 and (s != 1 or in_ch != planes)))
                in_ch = planes
            self.add_module(f"layer{si + 1}", nn.Sequential(*stage))
        self.bn4 = BatchNormEval(cfg.channels[-1])
        hw = cfg.input_size // 16
        self.fc5 = nn.Linear(cfg.channels[-1] * hw * hw, cfg.embedding_dim)
        self.bn5 = BatchNormEval(cfg.embedding_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, S, 1) grayscale in [-1, 1] -> (B, embedding_dim)."""
        h = self.maxpool(self.prelu(self.bn1(self.conv1(x.permute(0, 3, 1, 2)))))
        for si in range(len(self.config.layers)):
            h = getattr(self, f"layer{si + 1}")(h)
        h = self.bn4(h).flatten(1)
        return self.bn5(self.fc5(h))


@torch.no_grad()
def init_arcface(model: ArcFaceResNet18, seed: int = 0) -> ArcFaceResNet18:
    """Random weights from numpy, as flax's init gives them: LeCun normal
    convs and fc5, zero biases, BatchNorm scale 1 / shift 0 / mean 0 /
    var 1, PReLU slopes 0.25."""
    rng = np.random.default_rng(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(p.shape)
        if "prelu" in name:
            v = np.full(shape, 0.25, np.float32)
        elif leaf in ("weight", "running_var") and p.dim() == 1:
            v = np.ones(shape, np.float32)
        elif p.dim() == 1:  # biases, BN shifts and means
            v = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            v = rng.standard_normal(shape, dtype=np.float32) * np.float32(np.sqrt(1.0 / fan_in))
        p.copy_(torch.from_numpy(v))
    return model
