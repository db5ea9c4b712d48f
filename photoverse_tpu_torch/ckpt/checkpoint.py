"""The trainable / frozen split of the model bundle and the loading of
PhotoVerse checkpoints. Port of `partition_params`, `peek_lora_config` and
`load_photoverse_checkpoint` in photoverse_tpu/ckpt/checkpoint.py, for the
reference `.pt` layout ({image_adapter, text_adapter,
cross_attention_adapter, lora_config?}); saving is not ported, and the
native `.msgpack` layout (flax serialization) is refused with an error.

Trainable: both adapters, and in the UNet the identity projections
(`to_k_ip`, `to_v_ip`) and the LoRA factors (`lora_A`, `lora_B`); every other
parameter is frozen. Keys are "<model>.<parameter name>", so the first
component names the clipping group: text_adapter / image_adapter / unet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

__all__ = ["partition_params", "TRAINABLE_UNET_LEAVES", "peek_lora_config", "load_photoverse_checkpoint"]

TRAINABLE_UNET_LEAVES = ("to_k_ip", "to_v_ip", "lora_A", "lora_B")


def partition_params(models) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """-> (trainable, frozen), each {"<model>.<name>": Parameter}."""
    trainable: Dict[str, nn.Parameter] = {}
    frozen: Dict[str, nn.Parameter] = {}
    for model in ("text_adapter", "image_adapter", "text_encoder", "vision_encoder", "vae", "unet"):
        for name, p in getattr(models, model).named_parameters():
            if model.endswith("adapter") or (
                model == "unet" and any(part in TRAINABLE_UNET_LEAVES for part in name.split("."))
            ):
                trainable[f"{model}.{name}"] = p
            else:
                frozen[f"{model}.{name}"] = p
    return trainable, frozen


def _read_pt(path: str) -> dict:
    if path.endswith(".msgpack"):
        raise ValueError(
            f"{path}: the native .msgpack checkpoint layout is flax serialization, which the "
            "PyTorch port does not read; export a .pt with the JAX package "
            "(cli/train.py --checkpoint_format both, or ckpt.save_progress_pt) and load that"
        )
    return torch.load(path, map_location="cpu", weights_only=True)


def peek_lora_config(path: str) -> Optional[dict]:
    """The `lora_config` a `.pt` checkpoint carries, read without building
    any model, so `load_models` can re-inject LoRA before it loads weights."""
    return _read_pt(path).get("lora_config")


def load_photoverse_checkpoint(path: str, models) -> Optional[dict]:
    """Load a reference-format `.pt` into `models` in place: both adapters
    (strictly) and the cross-attention adapter (attn2 q/k/v with their LoRA
    factors, and the identity projections). Returns its lora_config."""
    from photoverse_tpu_torch.convert.from_diffusers import load_cross_attention_adapter

    state = _read_pt(path)
    for name in ("image_adapter", "text_adapter"):
        if name in state:
            getattr(models, name).load_state_dict(state[name], strict=True)
    if "cross_attention_adapter" in state:
        load_cross_attention_adapter(models.unet, state["cross_attention_adapter"])
    return state.get("lora_config")
