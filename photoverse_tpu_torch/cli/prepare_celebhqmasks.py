"""Dataset-prep CLI of the PyTorch port (the flags and the flow of
photoverse_tpu/cli/prepare_celebhqmasks.py): extract CelebAMask-HQ, fuse
its per-label masks, split 90/10.

    python -m photoverse_tpu_torch.cli.prepare_celebhqmasks --save_path ./CelebaHQMaskDataset

`save_path/CelebaHQMask.zip` must be in place (it is not downloaded;
`--gdrive_file_id` only names it in the error when it is missing). Writes
`save_path/train` and `save_path/test`, each with `images/` and `masks/`,
which `cli.train --img_subfolder images --mask_subfolder masks` reads.
Every step is skipped when its output exists, unless its --force_* flag is
given.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Download, extract and split the CelebAMask-HQ dataset")
    p.add_argument("--save_path", type=str, default="./CelebaHQMaskDataset")
    p.add_argument("--gdrive_file_id", type=str, default="1RGiGeumP_xVDN4RBC0K2m7Vh43IKSUPn")
    p.add_argument("--dataset_src_img_folder", type=str, default="CelebA-HQ-img")
    p.add_argument("--dataset_src_masks_folder", type=str, default="CelebAMask-HQ-mask-anno")
    p.add_argument("--dataset_src_folder", type=str, default="CelebAMask-HQ")
    p.add_argument("--train_ratio", type=float, default=0.9)
    p.add_argument("--force_download", action="store_true")
    p.add_argument("--force_extract", action="store_true")
    p.add_argument("--force_mask_creation", action="store_true")
    p.add_argument("--num_of_samples", type=int, default=30000, choices=range(100, 30001), metavar="[100-30000]")
    p.add_argument("--force_split", action="store_true")
    return p


def main(argv=None):
    from photoverse_tpu_torch.data.celebahq import (
        create_celebahq_masks,
        download_celebhq_masks,
        split_celebhqmasks_train_test,
    )

    args = build_parser().parse_args(argv)
    src = download_celebhq_masks(args.gdrive_file_id, args.save_path, args.force_download, args.force_extract)
    if src is None:
        src = args.dataset_src_folder

    src_masks = os.path.join(src, "masks")
    create_celebahq_masks(os.path.join(src, args.dataset_src_masks_folder), src_masks, args.force_mask_creation,
                          args.num_of_samples)
    src_imgs = os.path.join(src, args.dataset_src_img_folder)
    train_folder, test_folder = split_celebhqmasks_train_test(src_imgs, src_masks, args.save_path, args.train_ratio,
                                                              args.force_split)
    print(f"Train folder: {train_folder}")
    print(f"Test folder: {test_folder}")


if __name__ == "__main__":
    main()
