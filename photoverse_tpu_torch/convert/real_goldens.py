"""Real-weight golden protocol of the PyTorch port: its own copy of the
protocol in photoverse_tpu/convert/real_goldens.py, run through the port's
modules.

One deterministic input set, so that the diffusers / transformers models
(recorded on a networked machine by scripts/verify_real_weights.py into
tests/fixtures/real_weight_goldens.json) and the port, fed the same
checkpoint, can be compared to float rounding:

  - text:   the SD-1.5 tokenizer ids of PROMPT (padded to 77)
  - vision: RandomState(11).randn(1, 224, 224, 3)
  - vae:    encode RandomState(12).uniform(-1, 1, (1, 128, 128, 3));
            decode RandomState(13).randn(1, 16, 16, 4)
  - unet:   sample RandomState(14).randn(1, 32, 32, 4), t=500, text
            context = the text encoder's output for PROMPT, identity
            context zeros with the to_k_ip / to_v_ip projections ZEROED, so
            the dual-context UNet is exactly the vanilla SD UNet

Inputs and outputs are NHWC, as the recording stores them (the recorder
transposes the diffusers NCHW outputs); `nhwc_keys` names the image-layout
outputs. A digest keeps a strided sample (about 2k floats) and summary
statistics.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

PROMPT = "a photo of an astronaut riding a horse on the moon"
UNET_T = 500
VISION_LAYERS = (4, 8, 12, 16)
DIGEST_TARGET = 2048  # max sampled values per digest


def make_inputs() -> Dict[str, np.ndarray]:
    return {
        "vision_pixels": np.random.RandomState(11).randn(1, 224, 224, 3).astype(np.float32),
        "vae_pixels": np.random.RandomState(12).uniform(-1.0, 1.0, (1, 128, 128, 3)).astype(np.float32),
        "vae_latents": np.random.RandomState(13).randn(1, 16, 16, 4).astype(np.float32),
        "unet_sample": np.random.RandomState(14).randn(1, 32, 32, 4).astype(np.float32),
    }


def digest(arr: np.ndarray) -> dict:
    flat = np.asarray(arr, np.float64).ravel()
    stride = max(1, len(flat) // DIGEST_TARGET)
    return {
        "shape": list(np.asarray(arr).shape),
        "stride": stride,
        "mean": float(flat.mean()),
        "std": float(flat.std()),
        "absmax": float(np.abs(flat).max()),
        "sample": flat[::stride].tolist(),
    }


def compare_digest(arr: np.ndarray, dig: dict) -> dict:
    """Max abs/rel deviation of arr against a recorded digest."""
    flat = np.asarray(arr, np.float64).ravel()
    got = flat[:: dig["stride"]]
    want = np.asarray(dig["sample"], np.float64)
    if list(np.asarray(arr).shape) != dig["shape"] or len(got) != len(want):
        return {
            "ok": False,
            "error": f"shape mismatch: got {list(np.asarray(arr).shape)} want {dig['shape']}",
        }
    max_abs = float(np.abs(got - want).max())
    scale = max(dig["absmax"], 1e-6)
    return {"ok": True, "max_abs": max_abs, "max_rel": max_abs / scale}


def zero_identity_projections(unet) -> None:
    """Zero every to_k_ip / to_v_ip weight of the port's UNet in place, so
    the identity cross-attention contributes exactly nothing."""
    import torch

    with torch.no_grad():
        for name, p in unet.named_parameters():
            if ".to_k_ip." in name or ".to_v_ip." in name:
                p.zero_()


def torch_outputs(
    sd_path: str,
    clip_vision_path: Optional[str] = None,
    families: tuple = ("text", "vision", "vae", "unet"),
    device=None,
) -> Dict[str, np.ndarray]:
    """Run the protocol through the port on a diffusers-layout checkpoint
    (models/assembly.py:load_models, f32), on `device` (the card when
    None). Returns NHWC float32 arrays under the recording's keys."""
    import torch

    from photoverse_tpu_torch.models.assembly import load_models

    dev = torch.device("cuda" if device is None else device)
    tokenizer, models, _ = load_models(
        sd_path, extra_num_tokens=4, image_encoder_path=clip_vision_path,
        image_encoder_layers_idx=VISION_LAYERS, device=dev,
    )
    inputs = {k: torch.from_numpy(v).to(dev) for k, v in make_inputs().items()}
    out: Dict[str, np.ndarray] = {}
    host = lambda t: t.float().cpu().numpy()  # noqa: E731

    ids = torch.as_tensor(
        tokenizer(PROMPT, padding="max_length", truncation=True, max_length=tokenizer.model_max_length),
        dtype=torch.long, device=dev,
    )
    with torch.no_grad():
        text_hidden = None
        if "text" in families or "unet" in families:
            text_hidden, pooled = models.text_encoder(ids)
            out["text_hidden"] = host(text_hidden)
            out["text_pooled"] = host(pooled)
        if "vision" in families:
            last, layers = models.vision_encoder(inputs["vision_pixels"], collect_layers=VISION_LAYERS)
            out["vision_last_hidden"] = host(last)
            for li, arr in zip(VISION_LAYERS, layers):
                out[f"vision_layer_{li}"] = host(arr)
        if "vae" in families:
            mean, logvar = models.vae.encode_moments(inputs["vae_pixels"])
            out["vae_enc_mean"] = host(mean)
            out["vae_enc_logvar"] = host(logvar)
            out["vae_decode"] = host(models.vae.decode(inputs["vae_latents"]))
        if "unet" in families:
            zero_identity_projections(models.unet)
            id_ctx = torch.zeros((1, 5, models.unet.config.cross_attention_dim), device=dev)
            t = torch.tensor([UNET_T], dtype=torch.long, device=dev)
            eps, _ = models.unet(inputs["unet_sample"], t, text_hidden, id_ctx)
            out["unet_eps"] = host(eps)
    return out


def nhwc_keys() -> set:
    """Outputs that are image-layout (NHWC here and in the recording)."""
    return {"vae_enc_mean", "vae_enc_logvar", "vae_decode", "unet_eps"}
