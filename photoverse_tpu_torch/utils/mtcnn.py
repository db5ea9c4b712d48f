"""MTCNN face detection: the P-, R- and O-Net cascade. Port of
photoverse_tpu/utils/mtcnn.py.

The three small convnets are nn.Modules named as facenet_pytorch names
them (`conv1`, `prelu1`, `conv4_1`, `dense5_2`, ...), so its pnet.pt /
rnet.pt / onet.pt state dicts load strictly. The cascade itself (image
pyramid, NMS, box regression and squaring, crops) is data-dependent and
runs in numpy and Pillow on the host, a copy of the JAX package's; only the
nets run on `device`. R-Net and O-Net run on exactly the crops the cascade
holds, so no padding row exists to leak into the outputs.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["PNet", "RNet", "ONet", "MTCNN"]


def _flatten_torch_whc(x: torch.Tensor) -> torch.Tensor:
    """facenet_pytorch flattens NCHW in permute(0, 3, 2, 1) order (W, H, C)
    before its dense layers; a plain flatten gives wrong boxes that still
    look plausible."""
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


class PNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 10, 3)
        self.prelu1 = nn.PReLU(10)
        self.pool1 = nn.MaxPool2d(2, 2, ceil_mode=True)
        self.conv2 = nn.Conv2d(10, 16, 3)
        self.prelu2 = nn.PReLU(16)
        self.conv3 = nn.Conv2d(16, 32, 3)
        self.prelu3 = nn.PReLU(32)
        self.conv4_1 = nn.Conv2d(32, 2, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def forward(self, x):
        """x (B, 3, H, W) -> face probabilities (B, 2, h, w), box offsets (B, 4, h, w)."""
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.prelu3(self.conv3(self.prelu2(self.conv2(x))))
        return torch.softmax(self.conv4_1(x), dim=1), self.conv4_2(x)


class RNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 28, 3)
        self.prelu1 = nn.PReLU(28)
        self.pool1 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv2 = nn.Conv2d(28, 48, 3)
        self.prelu2 = nn.PReLU(48)
        self.pool2 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv3 = nn.Conv2d(48, 64, 2)
        self.prelu3 = nn.PReLU(64)
        self.dense4 = nn.Linear(576, 128)
        self.prelu4 = nn.PReLU(128)
        self.dense5_1 = nn.Linear(128, 2)
        self.dense5_2 = nn.Linear(128, 4)

    def forward(self, x):
        """x (B, 3, 24, 24) -> probabilities (B, 2), box offsets (B, 4)."""
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.pool2(self.prelu2(self.conv2(x)))
        x = self.prelu4(self.dense4(_flatten_torch_whc(self.prelu3(self.conv3(x)))))
        return torch.softmax(self.dense5_1(x), dim=1), self.dense5_2(x)


class ONet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3)
        self.prelu1 = nn.PReLU(32)
        self.pool1 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.prelu2 = nn.PReLU(64)
        self.pool2 = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.conv3 = nn.Conv2d(64, 64, 3)
        self.prelu3 = nn.PReLU(64)
        self.pool3 = nn.MaxPool2d(2, 2, ceil_mode=True)
        self.conv4 = nn.Conv2d(64, 128, 2)
        self.prelu4 = nn.PReLU(128)
        self.dense5 = nn.Linear(1152, 256)
        self.prelu5 = nn.PReLU(256)
        self.dense6_1 = nn.Linear(256, 2)
        self.dense6_2 = nn.Linear(256, 4)
        self.dense6_3 = nn.Linear(256, 10)

    def forward(self, x):
        """x (B, 3, 48, 48) -> probabilities (B, 2), box offsets (B, 4), landmarks (B, 10)."""
        x = self.pool1(self.prelu1(self.conv1(x)))
        x = self.pool2(self.prelu2(self.conv2(x)))
        x = self.pool3(self.prelu3(self.conv3(x)))
        x = self.prelu5(self.dense5(_flatten_torch_whc(self.prelu4(self.conv4(x)))))
        return torch.softmax(self.dense6_1(x), dim=1), self.dense6_2(x), self.dense6_3(x)


# ---------------------------------------------------------------------------
# host-side cascade helpers (the JAX package's, unchanged)
# ---------------------------------------------------------------------------


def _nms(boxes: np.ndarray, scores: np.ndarray, thresh: float, mode: str = "union"):
    order = scores.argsort()[::-1]
    keep = []
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0, yy2 - yy1 + 1)
        if mode == "min":
            ov = inter / np.minimum(area[i], area[order[1:]])
        else:
            ov = inter / (area[i] + area[order[1:]] - inter)
        order = order[1:][ov <= thresh]
    return np.asarray(keep, dtype=np.int64)


def _bbreg(boxes: np.ndarray, reg: np.ndarray) -> np.ndarray:
    w = boxes[:, 2] - boxes[:, 0] + 1
    h = boxes[:, 3] - boxes[:, 1] + 1
    out = boxes.copy()
    out[:, 0] = boxes[:, 0] + reg[:, 0] * w
    out[:, 1] = boxes[:, 1] + reg[:, 1] * h
    out[:, 2] = boxes[:, 2] + reg[:, 2] * w
    out[:, 3] = boxes[:, 3] + reg[:, 3] * h
    return out


def _rerec(boxes: np.ndarray) -> np.ndarray:
    """Square the boxes around their centers."""
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    side = np.maximum(w, h)
    out = boxes.copy()
    out[:, 0] = boxes[:, 0] + w * 0.5 - side * 0.5
    out[:, 1] = boxes[:, 1] + h * 0.5 - side * 0.5
    out[:, 2] = out[:, 0] + side
    out[:, 3] = out[:, 1] + side
    return out


def _crop_resize(img: np.ndarray, boxes: np.ndarray, size: int) -> np.ndarray:
    from PIL import Image

    h, w = img.shape[:2]
    crops = []
    for x1, y1, x2, y2 in boxes[:, :4].astype(int):
        x1c, y1c = max(x1, 0), max(y1, 0)
        x2c, y2c = min(x2, w), min(y2, h)
        patch = np.zeros((max(y2 - y1, 1), max(x2 - x1, 1), 3), dtype=img.dtype)
        if x2c > x1c and y2c > y1c:
            patch[y1c - y1 : y2c - y1, x1c - x1 : x2c - x1] = img[y1c:y2c, x1c:x2c]
        crops.append(np.asarray(Image.fromarray(patch.astype(np.uint8)).resize((size, size))))
    return np.stack(crops).astype(np.float32)


def _norm(x: np.ndarray) -> np.ndarray:
    return (x - 127.5) * 0.0078125


class MTCNN:
    def __init__(self, pnet: PNet, rnet: RNet, onet: ONet, thresholds=(0.6, 0.7, 0.7),
                 min_face_size: int = 20, factor: float = 0.709):
        self.pnet, self.rnet, self.onet = (n.eval().requires_grad_(False) for n in (pnet, rnet, onet))
        self.device = next(pnet.parameters()).device
        self.thresholds = thresholds
        self.min_face_size = min_face_size
        self.factor = factor

    @classmethod
    def from_torch_weights(cls, path: str, device="cuda", **kw) -> "MTCNN":
        """facenet_pytorch weights: a directory holding pnet.pt, rnet.pt and
        onet.pt, or one file of {"pnet": ..., "rnet": ..., "onet": ...};
        loaded with weights_only=True (plain tensor state dicts) and
        strictly, onto `device` (the card unless the caller asks for the CPU)."""
        if os.path.isdir(path):
            sds = [torch.load(os.path.join(path, f"{n}.pt"), map_location="cpu", weights_only=True)
                   for n in ("pnet", "rnet", "onet")]
        else:
            blob = torch.load(path, map_location="cpu", weights_only=True)
            sds = [blob[n] for n in ("pnet", "rnet", "onet")]
        nets = []
        for net_cls, sd in zip((PNet, RNet, ONet), sds):
            with torch.device(device):
                net = net_cls()
            net.load_state_dict(sd, strict=True)
            nets.append(net)
        return cls(*nets, **kw)

    def _run(self, net, batch: np.ndarray):
        """NHWC float32 numpy -> the net's outputs as numpy (NCHW maps)."""
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device).permute(0, 3, 1, 2)
        with torch.no_grad():
            return [o.cpu().numpy() for o in net(x)]

    # ------------------------------------------------------------------
    def detect(self, image: np.ndarray) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """(H, W, 3) uint8 -> (boxes (N, 4), probs (N,)) or (None, None)."""
        from PIL import Image

        img = np.asarray(image).astype(np.float32)
        h, w = img.shape[:2]
        m = 12.0 / self.min_face_size

        # stage 1: pyramid + PNet
        scales = []
        scale = m
        while min(h, w) * scale >= 12:
            scales.append(scale)
            scale *= self.factor
        total_boxes = []
        for s in scales:
            hs, ws = int(np.ceil(h * s)), int(np.ceil(w * s))
            im = np.asarray(Image.fromarray(image.astype(np.uint8)).resize((ws, hs))).astype(np.float32)
            probs, reg = self._run(self.pnet, _norm(im)[None])
            probs = probs[0, 1]
            reg = reg[0].transpose(1, 2, 0)
            mask = probs >= self.thresholds[0]
            if not mask.any():
                continue
            yy, xx = np.nonzero(mask)
            score = probs[yy, xx]
            r = reg[yy, xx]  # (n, 4)
            stride, cell = 2, 12
            x1 = np.round((stride * xx + 1) / s)
            y1 = np.round((stride * yy + 1) / s)
            x2 = np.round((stride * xx + cell) / s)
            y2 = np.round((stride * yy + cell) / s)
            boxes = np.stack([x1, y1, x2, y2], axis=1)
            keep = _nms(boxes, score, 0.5)
            total_boxes.append(np.concatenate([boxes[keep], score[keep, None], r[keep]], axis=1))
        if not total_boxes:
            return None, None
        tb = np.concatenate(total_boxes, axis=0)
        keep = _nms(tb[:, :4], tb[:, 4], 0.7)
        tb = tb[keep]
        tb[:, :4] = _rerec(_bbreg(tb[:, :4], tb[:, 5:9]))

        # stage 2: RNet
        probs, reg = self._run(self.rnet, _norm(_crop_resize(img, tb, 24)))
        probs = probs[:, 1]
        mask = probs >= self.thresholds[1]
        if not mask.any():
            return None, None
        tb = np.concatenate([tb[mask, :4], probs[mask, None]], axis=1)
        reg = reg[mask]
        keep = _nms(tb[:, :4], tb[:, 4], 0.7)
        tb, reg = tb[keep], reg[keep]
        tb[:, :4] = _rerec(_bbreg(tb[:, :4], reg))

        # stage 3: ONet
        probs, reg, _ = self._run(self.onet, _norm(_crop_resize(img, tb, 48)))
        probs = probs[:, 1]
        mask = probs >= self.thresholds[2]
        if not mask.any():
            return None, None
        tb = np.concatenate([tb[mask, :4], probs[mask, None]], axis=1)
        tb[:, :4] = _bbreg(tb[:, :4], reg[mask])
        keep = _nms(tb[:, :4], tb[:, 4], 0.7, mode="min")
        tb = tb[keep]
        return tb[:, :4], tb[:, 4]
