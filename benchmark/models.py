"""A configuration file's model, built two ways from the same weights: the
program's module bundle (`program_models`) and the reference's shape
dictionaries (`ref_cfg`). The program is built on the meta device and
given the benchmark's tensors, so nothing is drawn twice."""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["program_models", "ref_cfg", "DTYPES"]

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _port_configs(cfg: Dict, train: bool):
    from photoverse_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig
    from photoverse_tpu_torch.models.unet import UNetConfig
    from photoverse_tpu_torch.models.vae import VAEConfig

    u, v, t, i, pv, fl = (cfg[k] for k in ("unet", "vae", "text_encoder", "vision_encoder", "photoverse", "flags"))
    unet = UNetConfig(
        in_channels=u["in_channels"], out_channels=u["out_channels"],
        block_out_channels=tuple(u["block_out_channels"]), layers_per_block=u["layers_per_block"],
        cross_attention_dim=u["cross_attention_dim"], num_heads=u["attention_head_dim"],
        norm_num_groups=u["norm_num_groups"], lora_rank=pv["lora_rank"], lora_alpha=pv["lora_alpha"],
        lora_dropout=pv.get("lora_dropout", 0.0) if train else 0.0,
        use_flash_attention=fl["use_flash_attention"], fast_attention_scores=fl["fast_attention_scores"],
        fast_norms=fl["fast_norms"], fused_blocks=fl["fused_blocks"], remat=fl.get("remat", False))
    vae = VAEConfig(
        in_channels=v["in_channels"], out_channels=v["out_channels"], latent_channels=v["latent_channels"],
        block_out_channels=tuple(v["block_out_channels"]), layers_per_block=v["layers_per_block"],
        norm_num_groups=v["norm_num_groups"], scaling_factor=v["scaling_factor"],
        use_flash_attention=fl["use_flash_attention"], fast_norms=fl["fast_norms"], remat=fl.get("remat", False))
    text = CLIPTextConfig(
        vocab_size=t["vocab_size"], hidden_size=t["hidden_size"], num_layers=t["num_hidden_layers"],
        num_heads=t["num_attention_heads"], intermediate_size=t["intermediate_size"],
        max_position_embeddings=t["max_position_embeddings"])
    vision = CLIPVisionConfig(
        hidden_size=i["hidden_size"], num_layers=i["num_hidden_layers"], num_heads=i["num_attention_heads"],
        intermediate_size=i["intermediate_size"], image_size=i["image_size"], patch_size=i["patch_size"])
    return unet, vae, text, vision


def program_models(cfg: Dict, device, train: bool = False, kernels: bool = True):
    """The program's PhotoVerseModels for configuration `cfg`, empty (on
    the meta device, then allocated on `device`): the caller fills it.
    `kernels` False turns the hand-written kernel routes off (the CPU)."""
    import dataclasses

    from photoverse_tpu_torch.models.assembly import build_models

    unet, vae, text, vision = _port_configs(cfg, train)
    if not kernels:
        unet = dataclasses.replace(unet, use_flash_attention=False, fused_blocks=False)
        vae = dataclasses.replace(vae, use_flash_attention=False)
    pv = cfg["photoverse"]
    models = build_models(
        extra_num_tokens=pv["extra_num_tokens"], image_encoder_layers_idx=tuple(pv["image_encoder_layers_idx"]),
        dtype=DTYPES[cfg["precision"]], unet_config=unet, vae_config=vae, text_config=text,
        vision_config=vision, device="meta")
    return models.to_empty(device=device)


def ref_cfg(cfg: Dict) -> Dict[str, Dict]:
    """The reference's shape dictionaries for configuration `cfg`."""
    u, v, t, i, pv = (cfg[k] for k in ("unet", "vae", "text_encoder", "vision_encoder", "photoverse"))
    out = {
        "unet": {"channels": list(u["block_out_channels"]), "layers_per_block": u["layers_per_block"],
                 "heads": u["attention_head_dim"], "groups": u["norm_num_groups"],
                 "lora": (pv["lora_rank"], pv["lora_alpha"]) if pv["lora_rank"] else None},
        "vae": {"channels": list(v["block_out_channels"]), "layers_per_block": v["layers_per_block"],
                "groups": v["norm_num_groups"], "scaling_factor": v["scaling_factor"]},
        "text": {"layers": t["num_hidden_layers"], "heads": t["num_attention_heads"]},
        "vision": {"layers": i["num_hidden_layers"], "heads": i["num_attention_heads"],
                   "patch": i["patch_size"], "collect": list(pv["image_encoder_layers_idx"])},
        "tokens": pv["extra_num_tokens"] + 1,
    }
    if "face_model" in cfg:
        f = cfg["face_model"]
        out["arcface"] = {"channels": f["channels"], "layers": f["layers"], "input_size": f["input_size"]}
    return out


def latent_size(cfg: Dict) -> int:
    return cfg["resolution"] // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)

