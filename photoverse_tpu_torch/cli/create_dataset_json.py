"""List an image folder into a JSON manifest (the flags and the JSON of
photoverse_tpu/cli/create_dataset_json.py):

    python -m photoverse_tpu_torch.cli.create_dataset_json \\
        --src_folder CelebaHQMaskDataset/train/images --output_json train.json

writes {"images": [the sorted .jpg / .jpeg / .png names], "root": the
folder's absolute path}.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Create a JSON manifest of images")
    p.add_argument("--src_folder", type=str, required=True)
    p.add_argument("--output_json", type=str, required=True)
    args = p.parse_args(argv)
    files = sorted(f for f in os.listdir(args.src_folder) if f.lower().endswith((".jpg", ".jpeg", ".png")))
    with open(args.output_json, "w") as f:
        json.dump({"images": files, "root": os.path.abspath(args.src_folder)}, f, indent=2)
    print(f"wrote {len(files)} entries to {args.output_json}")


if __name__ == "__main__":
    main()
