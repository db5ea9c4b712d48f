"""FaceNet InceptionResnetV1 (VGGFace2) face embedder, eval mode. Port of
photoverse_tpu/models/facenet.py.

Stem convs, 5x Block35 (scale 0.17), Mixed_6a, 10x Block17 (0.10),
Mixed_7a, 5x Block8 (0.20), a final Block8 at scale 1.0 without ReLU, a
global average pool, `last_linear` (no bias), `last_bn`, then L2
normalisation of the 512-d embedding. Every BatchNorm runs in eval mode
with eps 1e-3 (ArcFace's is 1e-5).

Module names follow facenet_pytorch's InceptionResnetV1 (`conv2d_1a.conv`,
`conv2d_1a.bn`, `repeat_1.{i}.branch1.{j}`, `mixed_6a`, `block8`,
`last_bn`, ...), so one of its state dicts loads strictly once its
`logits.*` and `*.num_batches_tracked` entries are dropped
(`models/face_loss.py:load_face_loss`). The public forward is NHWC, as the
JAX model's; the convolutions run NCHW.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from photoverse_tpu_torch.models.arcface import BatchNormEval

__all__ = ["InceptionResnetV1", "init_facenet"]

BN_EPS = 1e-3


class BasicConv2d(nn.Module):
    """conv (no bias) -> eval BatchNorm -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = BatchNormEval(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


def _seq(*convs: Tuple) -> nn.Sequential:
    return nn.Sequential(*(BasicConv2d(*c) for c in convs))


class Block35(nn.Module):
    def __init__(self, scale: float = 0.17):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(256, 32, 1)
        self.branch1 = _seq((256, 32, 1), (32, 32, 3, 1, 1))
        self.branch2 = _seq((256, 32, 1), (32, 32, 3, 1, 1), (32, 32, 3, 1, 1))
        self.conv2d = nn.Conv2d(96, 256, 1)

    def forward(self, x):
        up = self.conv2d(torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], 1))
        return torch.relu(x + self.scale * up)


class Block17(nn.Module):
    def __init__(self, scale: float = 0.10):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(896, 128, 1)
        self.branch1 = _seq((896, 128, 1), (128, 128, (1, 7), 1, (0, 3)), (128, 128, (7, 1), 1, (3, 0)))
        self.conv2d = nn.Conv2d(256, 896, 1)

    def forward(self, x):
        up = self.conv2d(torch.cat([self.branch0(x), self.branch1(x)], 1))
        return torch.relu(x + self.scale * up)


class Block8(nn.Module):
    def __init__(self, scale: float = 0.20, no_relu: bool = False):
        super().__init__()
        self.scale = scale
        self.no_relu = no_relu
        self.branch0 = BasicConv2d(1792, 192, 1)
        self.branch1 = _seq((1792, 192, 1), (192, 192, (1, 3), 1, (0, 1)), (192, 192, (3, 1), 1, (1, 0)))
        self.conv2d = nn.Conv2d(384, 1792, 1)

    def forward(self, x):
        out = x + self.scale * self.conv2d(torch.cat([self.branch0(x), self.branch1(x)], 1))
        return out if self.no_relu else torch.relu(out)


class Mixed6a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(256, 384, 3, 2)
        self.branch1 = _seq((256, 192, 1), (192, 192, 3, 1, 1), (192, 256, 3, 2))
        self.branch2 = nn.MaxPool2d(3, 2)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], 1)


class Mixed7a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = _seq((896, 256, 1), (256, 384, 3, 2))
        self.branch1 = _seq((896, 256, 1), (256, 256, 3, 2))
        self.branch2 = _seq((896, 256, 1), (256, 256, 3, 1, 1), (256, 256, 3, 2))
        self.branch3 = nn.MaxPool2d(3, 2)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), self.branch3(x)], 1)


class InceptionResnetV1(nn.Module):
    """(B, 160, 160, 3) RGB in [-1, 1] -> (B, 512) L2-normalised."""

    input_size = 160

    def __init__(self, embedding_dim: int = 512, device="cuda"):
        super().__init__()
        with torch.device(device):
            self.conv2d_1a = BasicConv2d(3, 32, 3, 2)
            self.conv2d_2a = BasicConv2d(32, 32, 3)
            self.conv2d_2b = BasicConv2d(32, 64, 3, 1, 1)
            self.maxpool_3a = nn.MaxPool2d(3, 2)
            self.conv2d_3b = BasicConv2d(64, 80, 1)
            self.conv2d_4a = BasicConv2d(80, 192, 3)
            self.conv2d_4b = BasicConv2d(192, 256, 3, 2)
            self.repeat_1 = nn.Sequential(*(Block35(0.17) for _ in range(5)))
            self.mixed_6a = Mixed6a()
            self.repeat_2 = nn.Sequential(*(Block17(0.10) for _ in range(10)))
            self.mixed_7a = Mixed7a()
            self.repeat_3 = nn.Sequential(*(Block8(0.20) for _ in range(5)))
            self.block8 = Block8(1.0, no_relu=True)
            self.last_linear = nn.Linear(1792, embedding_dim, bias=False)
            self.last_bn = BatchNormEval(embedding_dim, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        h = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(h)))
        h = self.conv2d_4b(self.conv2d_4a(self.conv2d_3b(self.maxpool_3a(h))))
        h = self.repeat_3(self.mixed_7a(self.repeat_2(self.mixed_6a(self.repeat_1(h)))))
        h = self.block8(h).mean(dim=(2, 3))
        h = self.last_bn(self.last_linear(h))
        return h / torch.clamp(h.norm(dim=-1, keepdim=True), min=1e-12)


@torch.no_grad()
def init_facenet(model: InceptionResnetV1, seed: int = 0) -> InceptionResnetV1:
    """Random weights from numpy, as flax's init gives them: LeCun normal
    convs and last_linear, zero conv biases, BatchNorm scale 1 / shift 0 /
    mean 0 / var 1."""
    rng = np.random.default_rng(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(p.shape)
        if leaf in ("weight", "running_var") and p.dim() == 1:
            v = np.ones(shape, np.float32)
        elif p.dim() == 1:  # conv biases, BN shifts and means
            v = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            v = rng.standard_normal(shape, dtype=np.float32) * np.float32(np.sqrt(1.0 / fan_in))
        p.copy_(torch.from_numpy(v))
    return model
