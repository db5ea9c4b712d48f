"""Facial identity loss with the ArcFace or the FaceNet embedder. Port of
photoverse_tpu/models/face_loss.py.

  - arcface: grayscale (Rec.601 weights), bilinear resize to 128 px;
  - facenet: RGB, bilinear resize to 160 px;
    both with F.interpolate(align_corners=False, antialias=False), the JAX
    package's jax.image.resize(..., antialias=False);
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
from photoverse_tpu_torch.models.facenet import InceptionResnetV1, init_facenet

__all__ = ["rgb_to_grayscale", "face_preprocess", "FaceLoss", "make_face_loss_fn", "load_face_loss"]

REC601 = (0.2989, 0.5870, 0.1140)


def rgb_to_grayscale(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W, 1), Rec.601 weights."""
    w = torch.tensor(REC601, dtype=torch.float32, device=images.device)
    return torch.tensordot(images, w.to(images.dtype), dims=([-1], [0]))[..., None]


def face_preprocess(images: torch.Tensor, model_name: str, normalize: bool = True,
                    size: Optional[int] = None) -> torch.Tensor:
    """NHWC images -> the embedder's NHWC input: grayscale for arcface,
    bilinear resize to `size` (128 for arcface, 160 for facenet when not
    given), optional /127.5 - 1."""
    if size is None:
        size = 128 if model_name == "arcface" else 160
    if model_name == "arcface" and images.shape[-1] == 3:
        images = rgb_to_grayscale(images)
    out = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                        align_corners=False, antialias=False).permute(0, 2, 3, 1)
    if normalize:
        out = out / 127.5 - 1.0
    return out


class FaceLoss(nn.Module):
    """(x, x_gen) -> cosine embedding loss under a frozen ArcFace or FaceNet."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model
        self.model_name = "facenet" if isinstance(model, InceptionResnetV1) else "arcface"

    @property
    def input_size(self) -> int:
        if self.model_name == "facenet":
            return self.model.input_size
        return self.model.config.input_size

    def embed(self, images: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        x = face_preprocess(images, self.model_name, normalize, size=self.input_size)
        return self.model(x.to(next(self.model.parameters()).dtype))

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
    """The frozen FaceLoss for `model_name`, with random weights (seed 0)
    when no path is given, else from a `.pt` state dict loaded strictly:
    arcface from a reference ResNetFace file (a DataParallel "module."
    prefix and BatchNorm's num_batches_tracked are dropped), facenet from a
    facenet_pytorch InceptionResnetV1 file (its classifier `logits.*` and
    num_batches_tracked are dropped). Every other key must match."""
    if model_name not in ("arcface", "facenet"):
        raise ValueError(f"unknown face model {model_name!r}; use arcface or facenet")
    if model_name == "arcface":
        model, init = ArcFaceResNet18(device=device), init_arcface
    else:
        model, init = InceptionResnetV1(device=device), init_facenet
    if weights_path is None:
        init(model, seed=0)
    else:
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        if model_name == "arcface":
            sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
        else:
            sd = {k: v for k, v in sd.items() if not k.startswith("logits.")}
        model.load_state_dict({k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")},
                              strict=True)
    return FaceLoss(model.eval().requires_grad_(False))
