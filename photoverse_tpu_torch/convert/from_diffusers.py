"""Checkpoint state dicts (diffusers / transformers key schemas) -> the
port's modules, strictly. Counterpart of photoverse_tpu/convert/torch_to_jax.py.

The port's modules carry the diffusers UNet2DConditionModel / AutoencoderKL
and the transformers CLIPTextModel / CLIPVisionModel parameter names, so a
conversion is a key lookup per parameter of the module, not a re-layout.
Each `load_*` walks the module's own state dict, finds every key's source
in the checkpoint (a prefix, a legacy name, a peft `base_layer` name) and
fails both ways: a parameter without a source raises KeyError unless the
caller lists it as coming from init, and a checkpoint key that no parameter
consumed raises ValueError, so a renamed or extra tensor cannot silently
keep its random init.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Sequence

import torch
from torch import nn

__all__ = [
    "load_strict",
    "load_clip_text",
    "load_clip_vision",
    "load_vae",
    "load_unet",
    "load_cross_attention_adapter",
    "round_through",
    "read_state_dict",
]

# buffers that older dumps carry and no parameter reads
DEFAULT_IGNORES = ("position_ids", "num_batches_tracked")
# a full CLIPModel dump's text tower and projection heads are not a vision encoder's
VISION_IGNORES = DEFAULT_IGNORES + ("text_model", "text_projection", "visual_projection", "logit_scale")
# LoRA tensors of a UNet dump enter through the PhotoVerse checkpoint, never
# through the base SD checkpoint (ckpt/checkpoint.py)
UNET_IGNORES = DEFAULT_IGNORES + ("lora_A", "lora_B", "base_layer")
# fresh PhotoVerse parameters a plain SD checkpoint does not hold
UNET_FROM_INIT = ("to_k_ip", "to_v_ip", "lora_A", "lora_B")


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors / .bin / .pt weight file as a dict of CPU tensors."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return dict(load_file(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def load_strict(
    module: nn.Module,
    sd: Mapping[str, torch.Tensor],
    sources: Callable[[str], Sequence[str]],
    ignore: Iterable[str] = DEFAULT_IGNORES,
    from_init: Iterable[str] = (),
    what: str = "checkpoint",
) -> None:
    """Copy `sd` into `module`. `sources(key)` lists, in order of
    preference, the checkpoint keys that may hold the module's `key`.
    Parameters whose name contains an entry of `from_init` may be absent
    (they keep their initialisation); checkpoint keys containing an entry
    of `ignore` may stay unread. Shapes must agree (a 1x1-conv weight of a
    legacy attention layer is squeezed to its Linear shape)."""
    own = module.state_dict()
    consumed, found, missing = set(), {}, []
    for key, target in own.items():
        src = next((s for s in sources(key) if s in sd), None)
        if src is None:
            if not any(part in key for part in from_init):
                missing.append(key)
            continue
        consumed.add(src)
        value = torch.as_tensor(sd[src])
        if value.dim() == 4 and target.dim() == 2:
            value = value[:, :, 0, 0]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{what}: {src} is {tuple(value.shape)}, the model's {key} is {tuple(target.shape)}")
        found[key] = value
    if missing:
        raise KeyError(f"{what}: {len(missing)} parameters have no source: {missing[:8]}")
    leftover = sorted(k for k in sd if k not in consumed and not any(i in k for i in ignore))
    if leftover:
        raise ValueError(
            f"{what}: {len(leftover)} checkpoint keys not consumed (the model would silently "
            f"drop them): {leftover[:8]}" + ("..." if len(leftover) > 8 else "")
        )
    module.load_state_dict(found, strict=False)


def _prefixed(sd: Mapping, prefix: str) -> Callable[[str], Sequence[str]]:
    base = prefix if any(k.startswith(prefix) for k in sd) else ""
    return lambda key: (base + key,)


def load_clip_text(module: nn.Module, sd: Mapping) -> None:
    """transformers CLIPTextModel keys, with or without `text_model.`."""
    load_strict(module, sd, _prefixed(sd, "text_model."), what="text encoder")


def load_clip_vision(module: nn.Module, sd: Mapping) -> None:
    """transformers CLIPVisionModel (or a whole CLIPModel's) keys, with or
    without `vision_model.`."""
    load_strict(module, sd, _prefixed(sd, "vision_model."), ignore=VISION_IGNORES, what="vision encoder")


_LEGACY_VAE_ATTN = {".to_q.": ".query.", ".to_k.": ".key.", ".to_v.": ".value.", ".to_out.0.": ".proj_attn."}


def _vae_sources(key: str) -> Sequence[str]:
    for new, old in _LEGACY_VAE_ATTN.items():
        if ".attentions." in key and new in key:
            return (key, key.replace(new, old))
    return (key,)


def load_vae(module: nn.Module, sd: Mapping) -> None:
    """diffusers AutoencoderKL keys; the mid-block attention also under its
    legacy names (query / key / value / proj_attn, possibly as 1x1 convs)."""
    load_strict(module, sd, _vae_sources, what="vae")


def _unet_sources(key: str) -> Sequence[str]:
    # a projection may sit under peft's `base_layer` on either side
    if ".attn2.to_" in key and key.endswith(".base_layer.weight"):
        return (key, key.replace(".base_layer.weight", ".weight"))
    if ".attn2.to_" in key and key.endswith(".weight") and ".lora_" not in key and ".to_out." not in key:
        return (key.replace(".weight", ".base_layer.weight"), key)
    return (key,)


def load_unet(module: nn.Module, sd: Mapping) -> None:
    """diffusers UNet2DConditionModel keys (PhotoVerse-patched or plain).
    The identity projections and the LoRA factors keep their
    initialisation when the checkpoint has none."""
    load_strict(module, sd, _unet_sources, ignore=UNET_IGNORES, from_init=UNET_FROM_INIT, what="unet")


def load_cross_attention_adapter(unet: nn.Module, sd: Mapping) -> int:
    """Overlay a PhotoVerse checkpoint's `cross_attention_adapter` (the
    attn2 q/k/v projections with their peft LoRA factors, and the
    `processor.to_{k,v}_ip.0` identity projections) onto the UNet. A key
    whose slot the model lacks (LoRA factors on a model built without LoRA)
    is skipped, as the JAX package skips it; returns the number of tensors
    that landed."""
    own = unet.state_dict()
    found = {}
    for key, value in sd.items():
        if ".transformer_blocks.0.attn2." not in key:
            continue
        if key.endswith(".base_layer.weight"):
            other = key.replace(".base_layer.weight", ".weight")
        else:
            other = key.replace(".weight", ".base_layer.weight")
        for cand in (key, other):
            if cand in own and tuple(own[cand].shape) == tuple(value.shape):
                found[cand] = torch.as_tensor(value)
                break
    unet.load_state_dict(found, strict=False)
    return len(found)


def round_through(module: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Round every floating parameter through `dtype` in place, keeping its
    own dtype: the values a model computes with when its weights are stored
    in `dtype` and promoted at use."""
    with torch.no_grad():
        for p in module.parameters():
            if p.is_floating_point() and p.dtype != dtype:
                p.copy_(p.to(dtype).to(p.dtype))
    return module
