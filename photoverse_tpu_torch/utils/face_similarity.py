"""Offline eval: face detection + identity cosine similarity. Port of
photoverse_tpu/utils/face_similarity.py.

Detect the largest face in both images (the MTCNN cascade,
utils/mtcnn.py), crop it (clamped to the image), scale it to [-1, 1], embed
it with the face loss's network (ArcFace: grayscale, 128 px; FaceNet: RGB,
160 px) and take the cosine of the embeddings; 0.0 when either image has
no detected face. Without MTCNN weights the detector is the full image
(a warning, once).
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from photoverse_tpu_torch.models.face_loss import FaceLoss, load_face_loss

__all__ = [
    "FaceSimilarity",
    "crop_face_from_image",
    "get_largest_bbox_face_analysis",
    "cosine_similarity_between_images",
]


class FaceSimilarity:
    def __init__(self, model_name: str = "arcface", face_loss: Optional[FaceLoss] = None,
                 weights_path: Optional[str] = None, mtcnn_weights_path: Optional[str] = None,
                 device="cuda"):
        """The embedder and the detector run on `device` (the card unless
        the caller asks for the CPU); a `face_loss` passed in keeps its own."""
        self.model_name = model_name
        self.face_loss = face_loss or load_face_loss(model_name, weights_path, device=device)
        self.detector = None
        if mtcnn_weights_path is not None:
            from photoverse_tpu_torch.utils.mtcnn import MTCNN

            self.detector = MTCNN.from_torch_weights(mtcnn_weights_path, device=device)
        self._warned = False

    def _largest_face(self, image: np.ndarray) -> Optional[np.ndarray]:
        """Crop of the max-area detected box, or None."""
        if self.detector is None:
            if not self._warned:
                warnings.warn("no MTCNN weights configured — face similarity uses the "
                              "full image instead of a detected crop")
                self._warned = True
            return image
        boxes, _ = self.detector.detect(image)
        if boxes is None or len(boxes) == 0:
            return None
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        x1, y1, x2, y2 = boxes[int(np.argmax(areas))].astype(int)
        h, w = image.shape[:2]
        x1, y1 = max(x1, 0), max(y1, 0)
        x2, y2 = min(x2, w), min(y2, h)
        if x2 <= x1 or y2 <= y1:
            return None
        return image[y1:y2, x1:x2]

    def face_embedding(self, image) -> Optional[np.ndarray]:
        """Identity embedding of the largest detected face, or None when no
        face is found. Embed a reference photo once when comparing it
        against many generations."""
        face = self._largest_face(_to_array(image))
        if face is None:
            return None
        dev = next(self.face_loss.model.parameters()).device
        fa = torch.from_numpy(np.array(face, np.float32)).to(dev)[None] / 127.5 - 1.0
        with torch.no_grad():
            return self.face_loss.embed(fa, normalize=False).float().cpu().numpy()[0]

    @staticmethod
    def cosine(e1, e2) -> float:
        denom = max(float(np.linalg.norm(e1) * np.linalg.norm(e2)), 1e-8)
        return float(np.dot(e1, e2) / denom)

    def calculate_face_similarity(self, image1, image2) -> float:
        """Images: paths, PIL images or (H, W, 3) uint8 arrays. The identity
        cosine in [-1, 1]; 0.0 if either has no face."""
        e1 = self.face_embedding(image1)
        e2 = self.face_embedding(image2)
        if e1 is None or e2 is None:
            return 0.0
        return self.cosine(e1, e2)


def _to_array(image) -> np.ndarray:
    if isinstance(image, str):
        from PIL import Image

        image = Image.open(image)
    if hasattr(image, "convert"):  # a PIL image
        if image.mode != "RGB":
            image = image.convert("RGB")
    return np.asarray(image)


# ---------------------------------------------------------------------------
# insightface-style helpers: "face analysis" dicts with 'bbox' (x1, y1, x2,
# y2) and 'embedding', the contract of insightface's FaceAnalysis results,
# so an external detector's output plugs in directly.
# ---------------------------------------------------------------------------

def crop_face_from_image(image: np.ndarray, face_analysis: dict) -> np.ndarray:
    """Bbox crop clamped to the image bounds."""
    x1, y1, x2, y2 = np.asarray(face_analysis["bbox"]).astype(int)
    h, w = image.shape[:2]
    x1, y1 = max(0, x1), max(0, y1)
    x2, y2 = min(w, x2), min(h, y2)
    return image[y1:y2, x1:x2]


def get_largest_bbox_face_analysis(face_analyses):
    """The analysis dict with the max-area bbox, or [] when the list is
    empty (the reference's empty-list return)."""
    if not face_analyses:
        return []
    return max(face_analyses, key=lambda fa: (fa["bbox"][2] - fa["bbox"][0]) * (fa["bbox"][3] - fa["bbox"][1]))


def cosine_similarity_between_images(image1, image2, face_analysis_func):
    """Cosine similarity of the largest-face embeddings of two images through
    a caller's detector / embedder; 0 when either image has no face."""
    best1 = get_largest_bbox_face_analysis(face_analysis_func(_to_array(image1)))
    best2 = get_largest_bbox_face_analysis(face_analysis_func(_to_array(image2)))
    if not best1 or not best2:
        return 0
    e1, e2 = best1["embedding"], best2["embedding"]
    return float(np.dot(e1, e2) / (np.linalg.norm(e1) * np.linalg.norm(e2)))
