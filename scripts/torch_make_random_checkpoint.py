"""Write a random diffusers-layout model directory from the PyTorch port's
modules: tokenizer/ text_encoder/ image_encoder/ unet/ vae/ scheduler/, as
`models/assembly.py:load_models` (and the JAX package's) reads one.

    python3 scripts/torch_make_random_checkpoint.py --out "$TMPDIR"/sd15 --scale sd15
    python3 scripts/torch_make_random_checkpoint.py --out "$TMPDIR"/tiny --scale tiny --cpu

The weights come from `init_params` (numpy, `--seed`), each model's state
dict (the port's names are the diffusers / transformers names) saved as a
`.bin` with its config file. `sd15` is SD-1.5 / CLIP-L width in bf16 (about
2.4 GiB); `tiny` is a few-thousand-parameter bundle in f32 whose text
encoder takes 77 tokens and whose vision encoder takes 224px images with 16
layers, so the real-weight protocol (convert/real_goldens.py) and the
default `--image_encoder_layers_idx 4 8 12 16` run on it. The tokenizer is
a small synthetic CLIP BPE vocabulary (letters, a few merges, the
placeholder `*`, BOS / EOS) with 77 positions: the vocabulary's size does
not change any compute shape. The models are built on the card unless
`--cpu` is given.

The module also holds the other synthetic inputs that the soak, the smoke
script and the tests share: smooth random face photos and an archive laid
out as the published CelebAMask-HQ (`write_celebahq_archive`).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import zipfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from photoverse_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig  # noqa: E402
from photoverse_tpu_torch.models.unet import UNetConfig  # noqa: E402
from photoverse_tpu_torch.models.vae import VAEConfig  # noqa: E402

# model configs and storage dtype of each scale
SCALES = {
    "tiny": dict(
        text_config=CLIPTextConfig(hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32),
        vision_config=CLIPVisionConfig(hidden_size=16, num_layers=16, num_heads=2, intermediate_size=32,
                                       patch_size=32),
        unet_config=UNetConfig(block_out_channels=(16, 32), layers_per_block=1, cross_attention_dim=16,
                               num_heads=2, norm_num_groups=8),
        vae_config=VAEConfig(block_out_channels=(16, 32), layers_per_block=2, norm_num_groups=8),
        dtype=torch.float32,
    ),
    # the default configs are SD-1.5's UNet and VAE and CLIP-L's two towers
    "sd15": dict(dtype=torch.bfloat16),
}
ARCHIVE_IMAGES = 100  # cli.prepare_celebhqmasks' least --num_of_samples


def write_model_dir(root: str, models) -> float:
    """A diffusers-layout model directory from `models`: each model's state
    dict as a `.bin` in its own dtype with its config file, and the DDPM
    scheduler's config; the caller adds the tokenizer. Returns the weights'
    size in GiB."""
    t, c, u, v = (models.text_encoder.config, models.vision_encoder.config, models.unet.config,
                  models.vae.config)
    parts = {
        "text_encoder": (models.text_encoder, "pytorch_model.bin", dict(
            vocab_size=t.vocab_size, hidden_size=t.hidden_size, num_hidden_layers=t.num_layers,
            num_attention_heads=t.num_heads, intermediate_size=t.intermediate_size,
            max_position_embeddings=t.max_position_embeddings)),
        "image_encoder": (models.vision_encoder, "pytorch_model.bin", dict(
            hidden_size=c.hidden_size, num_hidden_layers=c.num_layers, num_attention_heads=c.num_heads,
            intermediate_size=c.intermediate_size, image_size=c.image_size, patch_size=c.patch_size)),
        "vae": (models.vae, "diffusion_pytorch_model.bin", dict(
            in_channels=v.in_channels, out_channels=v.out_channels, latent_channels=v.latent_channels,
            block_out_channels=list(v.block_out_channels), layers_per_block=v.layers_per_block,
            norm_num_groups=v.norm_num_groups, scaling_factor=v.scaling_factor)),
        # attention_head_dim of an SD-1.5 UNet config is its head count
        "unet": (models.unet, "diffusion_pytorch_model.bin", dict(
            in_channels=u.in_channels, out_channels=u.out_channels, block_out_channels=list(u.block_out_channels),
            layers_per_block=u.layers_per_block, cross_attention_dim=u.cross_attention_dim,
            attention_head_dim=u.num_heads, norm_num_groups=u.norm_num_groups)),
    }
    size = 0
    for sub, (module, fname, cfg) in parts.items():
        d = os.path.join(root, sub)
        os.makedirs(d)
        torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, os.path.join(d, fname))
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(cfg, f)
        size += os.path.getsize(os.path.join(d, fname))
    os.makedirs(os.path.join(root, "scheduler"))
    with open(os.path.join(root, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump({"num_train_timesteps": 1000, "beta_start": 0.00085, "beta_end": 0.012,
                   "beta_schedule": "scaled_linear", "prediction_type": "epsilon", "steps_offset": 1}, f)
    return size / 2**30


def synthetic_tokenizer(folder: str):
    """A CLIP-style tokenizer from a small synthetic vocabulary (letters,
    a few merges, the placeholder, BOS/EOS) written to `folder/tokenizer`,
    with the text encoder's 77 positions; returns it loaded."""
    from photoverse_tpu_torch.data.tokenizer import CLIPTokenizer

    vocab = {}
    for c in "abcdefghijklmnopqrstuvwxyz":
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    merges = ["p h", "ph o", "pho t", "phot o</w>", "o f</w>", "t h", "th e</w>"]
    for m in merges:
        vocab.setdefault(m.replace(" ", ""), len(vocab))
    vocab["*</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    d = os.path.join(folder, "tokenizer")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(merges))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"model_max_length": 77}, f)
    return CLIPTokenizer.from_pretrained(folder)


def face_photo(rng, size: int) -> np.ndarray:
    """A smooth random RGB image: 16x16 noise brought up to `size` by
    repeating pixels and averaging neighbours."""
    small = rng.randint(0, 256, (16, 16, 3)).astype(np.float32)
    big = np.repeat(np.repeat(small, size // 16, axis=0), size // 16, axis=1)
    for axis in (0, 1):
        big = (big + np.roll(big, 8, axis=axis)) / 2
    return big.round().clip(0, 255).astype(np.uint8)


def _label_masks(rng) -> dict:
    """512x512 uint8 masks (0 or 255) of four labels for one face:
    overlapping skin and hair (the later label wins in the fusion), an eye
    that some faces lack, and cloth (a label the fusion skips)."""
    yy, xx = np.mgrid[0:512, 0:512]
    cy, cx = 256 + rng.randint(-30, 31), 256 + rng.randint(-30, 31)
    ry, rx = rng.randint(150, 200), rng.randint(110, 150)
    skin = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    hair = (skin & (yy < cy - ry // 2)) | ((yy < cy - ry // 3) & (abs(xx - cx) < rx + 20) & (yy > cy - ry - 30))
    masks = {"skin": skin, "hair": hair, "cloth": yy > cy + ry + 10}
    if rng.rand() < 0.8:
        masks["l_eye"] = (yy - (cy - 30)) ** 2 + (xx - (cx - 45)) ** 2 <= 15 ** 2
    return {k: v.astype(np.uint8) * 255 for k, v in masks.items()}


def write_celebahq_archive(save_path: str, n_images: int = ARCHIVE_IMAGES, image_size: int = 1024,
                           seed: int = 0) -> str:
    """`save_path/CelebaHQMask.zip` laid out as the published CelebAMask-HQ
    archive: CelebAMask-HQ/CelebA-HQ-img/{k}.jpg (`image_size` px) and
    CelebAMask-HQ/CelebAMask-HQ-mask-anno/{k // 2000}/{k:05d}_{label}.png
    (512 px). Returns the zip's path."""
    from PIL import Image

    os.makedirs(save_path, exist_ok=True)
    path = os.path.join(save_path, "CelebaHQMask.zip")
    rng = np.random.RandomState(seed)

    def encode(arr, fmt, **kw) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format=fmt, **kw)
        return buf.getvalue()

    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for k in range(n_images):
            zf.writestr(f"CelebAMask-HQ/CelebA-HQ-img/{k}.jpg", encode(face_photo(rng, image_size), "JPEG",
                                                                      quality=90))
            for label, mask in _label_masks(rng).items():
                zf.writestr(f"CelebAMask-HQ/CelebAMask-HQ-mask-anno/{k // 2000}/{k:05d}_{label}.png",
                            encode(mask, "PNG"))
    return path


def make_checkpoint(root: str, scale: str = "sd15", seed: int = 0, device="cuda"):
    """Write the model directory `root` at `scale`; returns (the weights'
    size in GiB, the tokenizer)."""
    from photoverse_tpu_torch.models.assembly import build_models, init_params

    models = init_params(build_models(device=device, **SCALES[scale]), seed=seed)
    gib = write_model_dir(root, models)
    del models
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return gib, synthetic_tokenizer(root)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", type=str, required=True, help="The model directory to create")
    p.add_argument("--scale", type=str, default="sd15", choices=sorted(SCALES))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="Build the models on the CPU instead of the card")
    args = p.parse_args(argv)
    gib, _ = make_checkpoint(args.out, args.scale, args.seed, device="cpu" if args.cpu else "cuda")
    print(f"wrote {args.out} (scale {args.scale}, {gib:.3f} GiB of weights, seed {args.seed})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
