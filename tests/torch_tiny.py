"""The PyTorch port built at the configuration of a JAX model bundle, with the
JAX bundle's weights (used by the tests/test_torch_*.py parity tests)."""

import dataclasses

import jax
import numpy as np

from photoverse_tpu_torch.convert.from_jax import load_jax_params
from photoverse_tpu_torch.models import assembly, clip, unet, vae


def _mirror(port_cls, jax_cfg, **overrides):
    """Port config with every field the JAX config also has copied over."""
    names = {f.name for f in dataclasses.fields(port_cls)}
    kw = {k: getattr(jax_cfg, k) for k in names if hasattr(jax_cfg, k)}
    kw.update(overrides)
    return port_cls(**kw)


def port_models(modules, params, unet_overrides=None, vae_overrides=None):
    """Port PhotoVerseModels (f32, CPU) mirroring a JAX (modules, params)."""
    models = assembly.build_models(
        extra_num_tokens=modules.num_tokens - 1,
        image_encoder_layers_idx=modules.image_encoder_layers_idx,
        unet_config=_mirror(unet.UNetConfig, modules.unet.config, **(unet_overrides or {})),
        vae_config=_mirror(vae.VAEConfig, modules.vae.config, **(vae_overrides or {})),
        text_config=_mirror(clip.CLIPTextConfig, modules.text_encoder.config),
        vision_config=_mirror(clip.CLIPVisionConfig, modules.vision_encoder.config),
        device="cpu",
    )
    load_jax_params(models, jax.tree.map(np.asarray, params))
    return models
