"""Offline face-similarity eval CLI of the PyTorch port: the flags and the
output of photoverse_tpu/cli/eval_face_similarity.py, on one GPU (or the
CPU with --cpu).

Compares an input identity photo against every generated image (png / jpg)
in a results directory and prints each image's ArcFace or FaceNet cosine
similarity and their mean (a table, or one JSON object with --json); a
score is 0.0 when no face is detected. When the input photo has no face,
a warning goes to stderr and every score is 0.0.

Usage:
  python -m photoverse_tpu_torch.cli.eval_face_similarity \\
      --input_image face.jpg --results_dir results \\
      --model arcface --model_weights arcface_resnet18.pth \\
      --mtcnn_weights mtcnn_dir
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PhotoVerse face-similarity eval (PyTorch port)")
    p.add_argument("--input_image", type=str, required=True,
                   help="The identity photo the generations should match")
    p.add_argument("--results_dir", type=str, required=True,
                   help="Directory of generated images (png/jpg)")
    p.add_argument("--model", type=str, default="arcface", choices=["arcface", "facenet"])
    p.add_argument("--model_weights", type=str, default=None,
                   help="Pretrained embedder .pt; REQUIRED for meaningful scores")
    p.add_argument("--mtcnn_weights", type=str, default=None,
                   help="facenet_pytorch MTCNN weights (a directory with pnet.pt / rnet.pt / "
                        "onet.pt, or one file of the three); without them the full image is "
                        "used as the face crop")
    p.add_argument("--json", action="store_true", help="Emit one JSON object instead of a table")
    p.add_argument("--cpu", action="store_true", help="Run on the CPU (the default is the GPU)")
    return p


@contextlib.contextmanager
def _full_f32():
    """f32 convolutions and matmuls without TF32, so a score does not depend
    on the device it was computed on; the flags are restored on exit."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def main(argv=None):
    args = build_parser().parse_args(argv)

    from photoverse_tpu_torch.cli.generate import pick_device
    from photoverse_tpu_torch.utils.face_similarity import FaceSimilarity

    device = pick_device(args.cpu)
    if args.model_weights is None:
        print("WARNING: no --model_weights — the embedder is randomly "
              "initialized and similarities are meaningless (testing only)")
    exts = (".png", ".jpg", ".jpeg")
    files = sorted(f for f in os.listdir(args.results_dir) if f.lower().endswith(exts))
    if not files:
        raise SystemExit(f"no images in {args.results_dir}")
    with _full_f32():
        sim = FaceSimilarity(model_name=args.model, weights_path=args.model_weights,
                             mtcnn_weights_path=args.mtcnn_weights, device=device)
        # the input identity is embedded once, each generated image once
        ref_emb = sim.face_embedding(args.input_image)
        if ref_emb is None:
            # every score is 0.0 by the no-face rule; the per-image work
            # cannot change that
            print(f"WARNING: no face detected in {args.input_image}; all scores are 0.0", file=sys.stderr)
            scores = {f: 0.0 for f in files}
        else:
            scores = {}
            for f in files:
                gen_emb = sim.face_embedding(os.path.join(args.results_dir, f))
                scores[f] = 0.0 if gen_emb is None else sim.cosine(ref_emb, gen_emb)
    mean = sum(scores.values()) / len(scores)
    if args.json:
        print(json.dumps({"scores": scores, "mean": mean, "model": args.model}))
    else:
        for f, s in scores.items():
            print(f"{f:40s} {s:+.4f}")
        print(f"{'mean':40s} {mean:+.4f}")


if __name__ == "__main__":
    main()
