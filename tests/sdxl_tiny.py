"""A tiny SDXL-shaped PhotoVerse bundle for the CPU tests: the UNet at
channels 32/64/64 with no attention at the first level, transformer depth
1, 1, 2 and 2 in the mid block, heads of 8, linear projections and "text_time"
added conditioning; two 2-layer text encoders (quick_gelu, and gelu with a
pooled projection) whose widths make the 64-wide context; 16 x 16 latents;
one identity token (the adapters' 1024-wide MLPs for one feature set, the
last hidden state, which is all the serving path's token 0 reads).
Its weights are the benchmark's (`benchmark.weights`), so the plain
reference (`benchmark/reference/sdxl_nets.py`) reads the same tensors.
Imports no JAX, so the card's machine can use it too."""

from __future__ import annotations

import torch

from photoverse_tpu_torch.models.assembly import build_models
from photoverse_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig
from photoverse_tpu_torch.models.unet import UNetConfig
from photoverse_tpu_torch.models.vae import VAEConfig

LATENT = 16
RES = 32  # two VAE levels: a factor of 2
SEQ = 77
BOS, EOS = 126, 127
LORA = (4, 1.0)


def configs(**unet_overrides) -> dict:
    unet = UNetConfig(**{**dict(
        block_out_channels=(32, 64, 64), layers_per_block=1, cross_attention_dim=64, num_heads=8,
        norm_num_groups=8, lora_rank=LORA[0], lora_alpha=LORA[1], level_heads=(4, 8, 8),
        transformer_layers_per_block=(1, 1, 2),
        attention_levels=(False, True, True), use_linear_projection=True, addition_embed_type="text_time",
        addition_time_embed_dim=8, addition_text_embed_dim=16), **unet_overrides})
    vae = VAEConfig(block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8, scaling_factor=0.13025)
    text = CLIPTextConfig(vocab_size=128, hidden_size=24, num_layers=2, num_heads=3, intermediate_size=48,
                          penultimate_output=True)
    text_2 = CLIPTextConfig(vocab_size=128, hidden_size=40, num_layers=2, num_heads=5, intermediate_size=80,
                            hidden_act="gelu", penultimate_output=True, projection_dim=16)
    vision = CLIPVisionConfig(hidden_size=48, num_layers=4, num_heads=2, intermediate_size=64, image_size=28,
                              patch_size=14)
    return dict(unet_config=unet, vae_config=vae, text_config=text, text_config_2=text_2, vision_config=vision,
                extra_num_tokens=0, image_encoder_layers_idx=())


def ref_cfg() -> dict:
    """The reference's shape dictionaries for `configs()`."""
    return {
        "unet": {"channels": [32, 64, 64], "layers_per_block": 1, "heads": [4, 8, 8], "depth": [1, 1, 2],
                 "attention": [False, True, True], "groups": 8, "time_ids_dim": 8,
                 "lora": LORA},
        "vae": {"channels": [32, 64], "layers_per_block": 1, "groups": 8, "scaling_factor": 0.13025},
        "text": {"layers": 2, "heads": 3, "act": "quick_gelu"},
        "text_2": {"layers": 2, "heads": 5, "act": "gelu", "projection": True},
        "vision": {"layers": 4, "heads": 2, "patch": 14, "collect": []},
    }


def bundle(seed: int = 0, device="cpu", dtype=torch.float32, **unet_overrides):
    """(models, weights): the tiny SDXL bundle with the benchmark's weights
    drawn from `seed` (lora_B non-zero) and those weights by name."""
    from benchmark.weights import load_into, make_weights, named_params

    models = build_models(device="meta", **configs(**unet_overrides)).to_empty(device=device)
    weights = make_weights(named_params(models), seed, device, dtype)
    load_into(models, weights)
    return models.to(dtype).eval(), weights


def example(n: int, seed: int = 0) -> dict:
    """n rows of the benchmark's request inputs at the tiny size."""
    import numpy as np

    from benchmark.serving import prompt_ids

    rng = np.random.default_rng(seed)
    ids, pidx = zip(*(prompt_ids(rng, SEQ, BOS, EOS) for _ in range(n)))
    return {
        "pixel_values": np.zeros((n, 1, 1, 3), np.float32),
        "pixel_values_clip": rng.standard_normal((n, 28, 28, 3)).astype(np.float32),
        "text_input_ids": np.stack(ids).astype(np.int32),
        "concept_placeholder_idx": np.asarray(pidx, np.int32),
        "negative_text_input_ids": np.full((n, SEQ), EOS, np.int32),
    }
