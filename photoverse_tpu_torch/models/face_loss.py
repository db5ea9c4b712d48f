"""Facial identity loss with the ArcFace embedder. Port of
photoverse_tpu/models/face_loss.py (the FaceNet branch is not ported;
`load_face_loss` refuses it).

  - grayscale (Rec.601 weights), bilinear resize to the embedder's input
    (F.interpolate, align_corners=False, no antialias: the JAX package's
    jax.image.resize(..., antialias=False));
  - optional /127.5 - 1 normalization (off in training, which feeds images
    in [-1, 1]);
  - loss = cosine embedding loss of emb(x) and emb(x_gen): 1 - cos when
    maximizing (training), max(0, cos) otherwise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
import torch.nn.functional as F

from photoverse_tpu_torch.models.arcface import ArcFaceResNet18, init_arcface

__all__ = ["rgb_to_grayscale", "face_preprocess", "FaceLoss", "make_face_loss_fn", "load_face_loss"]

REC601 = (0.2989, 0.5870, 0.1140)


def rgb_to_grayscale(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W, 1), Rec.601 weights."""
    w = torch.tensor(REC601, dtype=torch.float32, device=images.device)
    return torch.tensordot(images, w.to(images.dtype), dims=([-1], [0]))[..., None]


def face_preprocess(images: torch.Tensor, normalize: bool = True, size: int = 128) -> torch.Tensor:
    """NHWC images -> ArcFace's NHWC input: grayscale, bilinear resize to
    `size`, optional /127.5 - 1."""
    if images.shape[-1] == 3:
        images = rgb_to_grayscale(images)
    out = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                        align_corners=False, antialias=False).permute(0, 2, 3, 1)
    if normalize:
        out = out / 127.5 - 1.0
    return out


class FaceLoss(nn.Module):
    """(x, x_gen) -> cosine embedding loss under a frozen ArcFace."""

    def __init__(self, model: ArcFaceResNet18):
        super().__init__()
        self.model = model

    @property
    def input_size(self) -> int:
        return self.model.config.input_size

    def embed(self, images: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        x = face_preprocess(images, normalize, size=self.input_size)
        return self.model(x.to(self.model.conv1.weight.dtype))

    def forward(self, x: torch.Tensor, x_gen: torch.Tensor, maximize: bool = True,
                normalize: bool = True) -> torch.Tensor:
        e1 = self.embed(x, normalize).float()
        e2 = self.embed(x_gen, normalize).float()
        cos = (e1 * e2).sum(-1) / torch.clamp(e1.norm(dim=-1) * e2.norm(dim=-1), min=1e-8)
        if maximize:  # target +1: 1 - cos
            return (1.0 - cos).mean()
        return cos.clamp(min=0.0).mean()  # target -1, margin 0


def make_face_loss_fn(loss: FaceLoss) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The training loss: fn(x, x_gen) = loss(x, x_gen, maximize=True,
    normalize=False), x the [-1, 1] training image."""

    def fn(x, x_gen):
        return loss(x, x_gen, maximize=True, normalize=False)

    return fn


def load_face_loss(model_name: str, weights_path: Optional[str] = None, device="cuda") -> FaceLoss:
    """The frozen FaceLoss for `model_name`: ArcFace from a reference
    ResNetFace `.pt` state dict (a DataParallel "module." prefix and
    BatchNorm's num_batches_tracked are dropped; every other key must
    match), or with random weights (init_arcface, seed 0) when no path is
    given. FaceNet is not ported and is refused."""
    if model_name != "arcface":
        raise ValueError(f"--face_loss {model_name} is not ported to photoverse_tpu_torch yet; use arcface")
    model = ArcFaceResNet18(device=device)
    if weights_path is None:
        init_arcface(model, seed=0)
    else:
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()
              if not k.endswith("num_batches_tracked")}
        model.load_state_dict(sd, strict=True)
    return FaceLoss(model.eval().requires_grad_(False))
