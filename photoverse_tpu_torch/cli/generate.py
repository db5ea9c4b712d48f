"""Inference CLI of the PyTorch port: the flag surface of
photoverse_tpu/cli/generate.py, on one GPU (or the CPU with --cpu).

Usage:
  python -m photoverse_tpu_torch.cli.generate --model_path /path/to/sd15 \\
      --checkpoint_path photoverse.pt --input_image_path face.jpg \\
      --text "a photo of a {}" --num_timesteps 25 --guidance_scale 6

`--int8_conditioning` puts the frozen CLIP encoders' layers on W8A8 int8
(ops/quant.py). Its activation scale is one per tensor, so a row's
conditioning depends on the other rows of its encoder call, as in the JAX
package.

Flags whose code the port does not have yet (`--sharding` other than none,
`--data_parallel`, `--model_parallel`) are parsed and refused with a
message; none is silently ignored.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

UNPORTED = ("is not ported to photoverse_tpu_torch yet (ROADMAP.md, Queue 1: "
            "`parallel/` via torch.distributed); run without it")


def build_parser() -> argparse.ArgumentParser:
    from photoverse_tpu_torch.core.schedulers import SCHEDULER_NAMES

    p = argparse.ArgumentParser(description="Run inference with pre-trained models")
    p.add_argument("--model_path", type=str, default="runwayml/stable-diffusion-v1-5",
                   help="Local diffusers-layout SD checkpoint directory")
    p.add_argument("--extra_num_tokens", type=int, default=4)
    p.add_argument("--encoder_layers_idx", nargs="+", type=int, default=[4, 8, 12, 16])
    p.add_argument("--guidance_scale", type=float, default=1.0)
    p.add_argument("--checkpoint_path", type=str, default="exp1/40k_simple.pt",
                   help="PhotoVerse checkpoint (.pt torch format)")
    p.add_argument("--input_image_path", type=str, required=False,
                   default=None, help="Path to the input identity photo")
    p.add_argument("--output_image_path", type=str, default="generated_image")
    p.add_argument("--num_timesteps", type=int, default=25)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--text", type=str, nargs="+", default=["a photo of a {}"],
                   help="Prompt template(s) with {} for the identity token; "
                        "several templates batch over the one identity in a "
                        "single denoise")
    p.add_argument("--negative_prompt", type=str, default=None)
    p.add_argument("--num_of_samples", type=int, default=None)
    p.add_argument("--from_noised_image", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute and weights")
    p.add_argument("--ip_adapter_mask_path", type=str, default=None,
                   help="Optional grayscale mask restricting where identity "
                        "tokens attend (spatial IP-adapter mask)")
    p.add_argument("--fast", action="store_true",
                   help="Fast path: bf16 + bf16 attention scores and norms, "
                        "and on a GPU the flash self-attention and fused "
                        "block-tail kernels")
    p.add_argument("--bf16_params", action="store_true",
                   help="Round the loaded weights through bfloat16. Under "
                        "--fast / --bf16 the weights are bf16 already; with "
                        "f32 compute this gives what bf16-stored weights compute")
    p.add_argument("--int8_conditioning", action="store_true",
                   help="W8A8 dynamic-int8 projections and MLPs in the frozen "
                        "CLIP encoders (inference-only); the activation scale "
                        "is per tensor, so rows encoded together affect each other")
    p.add_argument("--data_parallel", action="store_true",
                   help="Alias for --sharding data; not ported yet (refused)")
    p.add_argument("--sharding", type=str, default="none",
                   choices=["none", "data", "spatial", "tensor"],
                   help="Multi-GPU execution mode; only `none` is ported, "
                        "the others are refused")
    p.add_argument("--model_parallel", type=int, default=0,
                   help="Model-axis size for --sharding spatial|tensor; not "
                        "ported yet (refused when non-zero)")
    p.add_argument("--scheduler", type=str, default="dpm",
                   choices=list(SCHEDULER_NAMES),
                   help="dpm: DPM-Solver++(2M); ddim: DDIM eta=0; euler / "
                        "euler_a: (ancestral) Euler discrete; unipc: UniPC bh2 "
                        "predictor-corrector; dpm_sde: sde-dpmsolver++ "
                        "midpoint ('DPM++ 2M SDE'); heun: trapezoidal "
                        "2nd-order (2N-1 UNet evals); lms: k-lms order-4 "
                        "Adams-Bashforth; dpm_2s_a: DPM++ 2S ancestral "
                        "(2N-1 UNet evals); pndm: PNDM/PLMS, the historical "
                        "SD-1.5 default (N+1 UNet evals); *_karras: the same "
                        "sampler on the Karras rho-7 sigma grid")
    p.add_argument("--karras_sigmas", action="store_true",
                   help="Karras rho-7 sigma grid for the chosen scheduler "
                        "(as the *_karras scheduler names; invalid with ddim "
                        "and pndm)")
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (the default is the GPU)")
    return p


def refuse_unported(args) -> None:
    """Exit on a flag whose code the port lacks, naming the flag."""
    asked = []
    if getattr(args, "sharding", "none") != "none":
        asked.append(f"--sharding {args.sharding}")
    if getattr(args, "data_parallel", False):
        asked.append("--data_parallel")
    if getattr(args, "model_parallel", 0):
        asked.append("--model_parallel")
    if asked:
        raise SystemExit(f"{', '.join(asked)} {UNPORTED}")


def pick_device(cpu: bool) -> str:
    """The card unless the caller asked for the CPU; no silent fallback."""
    import torch

    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device found; pass --cpu to run on the CPU")
    return "cuda"


def preprocess_image_for_inference(
    image_path, tokenizer, template="a photo of a {}", placeholder_token="*",
    negative_prompt=None, num_of_samples=None, size=512, interpolation="bicubic",
    clip_size=224,
):
    """NHWC numpy example for one identity photo.

    `template` is one template string or a list of them: the batch is then
    templates x num_of_samples over the single photo, all denoised in one
    call. `image_path` may also be an already decoded PIL image (the server
    receives images in request bodies)."""
    from PIL import Image

    from photoverse_tpu_torch.data.preprocessing import clip_preprocess, preprocess_image
    from photoverse_tpu_torch.data.prompts import prepare_prompt

    raw = image_path if isinstance(image_path, Image.Image) else Image.open(image_path)
    if raw.mode != "RGB":
        raw = raw.convert("RGB")
    templates = [template] if isinstance(template, str) else list(template)
    exs = [
        prepare_prompt(tokenizer, t, placeholder_token,
                       negative_prompt=negative_prompt, num_of_samples=num_of_samples)
        for t in templates
    ]
    if len(exs) == 1:
        example = exs[0]
    else:
        def cat(key):
            return np.concatenate(
                [np.asarray(e[key]).reshape(-1, np.asarray(e[key]).shape[-1]) for e in exs])

        texts = []
        for e in exs:
            texts.extend(e["text"] if isinstance(e["text"], list) else [e["text"]])
        example = {
            "text": texts,
            "text_input_ids": cat("text_input_ids"),
            "concept_placeholder_idx": cat("concept_placeholder_idx"),
            "negative_text_input_ids": (
                cat("negative_text_input_ids")
                if exs[0].get("negative_text_input_ids") is not None else None),
        }
    n = example["text_input_ids"].shape[0]
    example["pixel_values_clip"] = np.repeat(clip_preprocess(raw, clip_size)[None], n, axis=0)
    example["pixel_values"] = np.repeat(preprocess_image(raw, size, interpolation)[None], n, axis=0)
    return example


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.input_image_path is None:
        raise SystemExit("--input_image_path is required")
    if args.karras_sigmas and args.scheduler in ("ddim", "pndm"):
        # fail before the model load; make_solver would reject it
        raise SystemExit(
            f"--karras_sigmas is invalid with --scheduler {args.scheduler} "
            "(ddim's grid is defined by its leading spacing and pndm's "
            "multistep coefficients assume it; pick euler/dpm/unipc/heun/"
            "lms/dpm_2s_a variants for Karras sigmas)"
        )
    refuse_unported(args)
    ckpt = args.checkpoint_path or None
    if ckpt and not os.path.exists(ckpt):
        raise SystemExit(f"checkpoint not found: {ckpt}")

    import torch

    from photoverse_tpu_torch.core.schedulers import make_solver
    from photoverse_tpu_torch.engine.inference import run_inference
    from photoverse_tpu_torch.models.assembly import cast_params, load_models
    from photoverse_tpu_torch.utils.image import denormalize, to_pil

    device = pick_device(args.cpu)
    # the hand-written kernels exist on the card only; --fast on the CPU
    # keeps the plain attention and the unfused tail
    on_card = device == "cuda"
    dtype = torch.bfloat16 if (args.bf16 or args.fast) else torch.float32
    tokenizer, models, _ = load_models(
        args.model_path,
        extra_num_tokens=args.extra_num_tokens,
        photoverse_path=ckpt,
        image_encoder_layers_idx=tuple(args.encoder_layers_idx),
        dtype=dtype,
        use_flash_attention=args.fast and on_card,
        fast_attention_scores=args.fast,
        fast_norms=args.fast,
        fused_blocks=args.fast and on_card,
        int8_conditioning=args.int8_conditioning,
        device=device,
    )
    if args.bf16_params:
        cast_params(models, torch.bfloat16)
    solver = make_solver(models.schedule, args.scheduler, args.num_timesteps,
                         use_karras_sigmas=args.karras_sigmas)

    # the latent size follows the VAE's downsampling depth, the CLIP branch
    # the vision encoder's input size
    latent_factor = 2 ** (len(models.vae.config.block_out_channels) - 1)
    latent_size = args.resolution // latent_factor
    example = preprocess_image_for_inference(
        args.input_image_path, tokenizer, template=args.text,
        negative_prompt=args.negative_prompt, num_of_samples=args.num_of_samples,
        size=args.resolution, clip_size=models.vision_encoder.config.image_size,
    )
    B = example["pixel_values"].shape[0]
    uncond_ids = np.asarray(tokenizer([""] * B))

    ip_mask = None
    if args.ip_adapter_mask_path:
        from PIL import Image

        m = Image.open(args.ip_adapter_mask_path).convert("L")
        ip_mask = np.repeat(np.asarray(m, np.float32)[None] / 255.0, B, axis=0)

    seed = args.seed if args.seed is not None else int.from_bytes(os.urandom(4), "little")
    images = run_inference(
        models, solver, example, torch.Generator(device=device).manual_seed(seed),
        guidance_scale=args.guidance_scale,
        token_index=0,
        latent_size=latent_size,
        from_noised_image=args.from_noised_image,
        uncond_input_ids=uncond_ids,
        ip_mask=ip_mask,
    )

    os.makedirs(args.results_dir, exist_ok=True)
    images = images.float().cpu().numpy()
    for idx, img in enumerate(images):
        to_pil(denormalize(img)).save(
            os.path.join(args.results_dir, f"{args.output_image_path}{idx}.png"))
    print(f"saved {len(images)} image(s) to {args.results_dir}")


if __name__ == "__main__":
    main()
