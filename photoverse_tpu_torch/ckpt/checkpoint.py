"""The trainable / frozen split of the model bundle. Port of
`partition_params` in photoverse_tpu/ckpt/checkpoint.py (checkpoint I/O is
not ported).

Trainable: both adapters, and in the UNet the identity projections
(`to_k_ip`, `to_v_ip`) and the LoRA factors (`lora_A`, `lora_B`); every other
parameter is frozen. Keys are "<model>.<parameter name>", so the first
component names the clipping group: text_adapter / image_adapter / unet.
"""

from __future__ import annotations

from typing import Dict, Tuple

from torch import nn

__all__ = ["partition_params", "TRAINABLE_UNET_LEAVES"]

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
