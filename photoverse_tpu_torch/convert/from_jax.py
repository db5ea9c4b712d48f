"""JAX parameter trees -> state dicts of the port's modules.

The inverse of photoverse_tpu/convert/torch_to_jax.py: the port's modules
are named by the diffusers / transformers key schema that those converters
read, so `convert_X(from_jax_X(tree)) == tree` leaf for leaf. Inputs are
the JAX package's PhotoVerseParams leaves as numpy arrays (flax layouts:
Dense kernel (in, out), Conv kernel (kh, kw, in, out)); outputs are numpy
arrays in torch layouts (Linear weight (out, in), Conv2d (out, in, kh, kw)).
Pure numpy: nothing here imports jax.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = [
    "adapter_state_dict",
    "clip_text_state_dict",
    "clip_vision_state_dict",
    "vae_state_dict",
    "unet_state_dict",
    "arcface_state_dict",
    "facenet_state_dict",
    "load_jax_params",
    "load_jax_arcface",
    "load_jax_facenet",
]

StateDict = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(out: StateDict, prefix: str, p: Mapping) -> None:
    out[prefix + ".weight"] = _a(p["kernel"]).T
    if "bias" in p:
        out[prefix + ".bias"] = _a(p["bias"])


def _norm(out: StateDict, prefix: str, p: Mapping) -> None:
    out[prefix + ".weight"] = _a(p["scale"])
    out[prefix + ".bias"] = _a(p["bias"])


def _conv(out: StateDict, prefix: str, p: Mapping) -> None:
    out[prefix + ".weight"] = _a(p["kernel"]).transpose(3, 2, 0, 1)
    out[prefix + ".bias"] = _a(p["bias"])


def adapter_state_dict(tree: Mapping, num_tokens: int) -> StateDict:
    """Stacked (K, in, out) adapter params -> per-token `mapping_{i}.*`."""
    out: StateDict = {}
    for branch in ("mapping", "mapping_patch"):
        p = tree[branch]
        for i in range(num_tokens):
            for j, (w, b) in zip((0, 3, 6), (("fc0_w", "fc0_b"), ("fc1_w", "fc1_b"), ("fc2_w", "fc2_b"))):
                out[f"{branch}_{i}.{j}.weight"] = _a(p[w][i]).T
                out[f"{branch}_{i}.{j}.bias"] = _a(p[b][i])
            for j, (g, b) in zip((1, 4), (("ln0_g", "ln0_b"), ("ln1_g", "ln1_b"))):
                out[f"{branch}_{i}.{j}.weight"] = _a(p[g][i])
                out[f"{branch}_{i}.{j}.bias"] = _a(p[b][i])
    return out


def _clip_layer(out: StateDict, prefix: str, p: Mapping) -> None:
    _norm(out, prefix + ".layer_norm1", p["ln1"])
    _norm(out, prefix + ".layer_norm2", p["ln2"])
    for k, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
        _linear(out, f"{prefix}.self_attn.{name}", p[k])
    _linear(out, prefix + ".mlp.fc1", p["fc1"])
    _linear(out, prefix + ".mlp.fc2", p["fc2"])


def clip_text_state_dict(tree: Mapping, num_layers: int) -> StateDict:
    out: StateDict = {
        "embeddings.token_embedding.weight": _a(tree["token_embedding"]),
        "embeddings.position_embedding.weight": _a(tree["position_embedding"]),
    }
    for i in range(num_layers):
        _clip_layer(out, f"encoder.layers.{i}", tree[f"layer_{i}"])
    _norm(out, "final_layer_norm", tree["final_ln"])
    return out


def clip_vision_state_dict(tree: Mapping, num_layers: int) -> StateDict:
    out: StateDict = {
        "embeddings.class_embedding": _a(tree["class_embedding"]),
        "embeddings.patch_embedding.weight": _a(tree["patch_embedding"]).transpose(3, 2, 0, 1),
        "embeddings.position_embedding.weight": _a(tree["position_embedding"]),
    }
    _norm(out, "pre_layrnorm", tree["pre_ln"])
    for i in range(num_layers):
        _clip_layer(out, f"encoder.layers.{i}", tree[f"layer_{i}"])
    _norm(out, "post_layernorm", tree["post_ln"])
    return out


def _resnet(out: StateDict, prefix: str, p: Mapping) -> None:
    _norm(out, prefix + ".norm1", p["norm1"])
    _conv(out, prefix + ".conv1", p["conv1"])
    _norm(out, prefix + ".norm2", p["norm2"])
    _conv(out, prefix + ".conv2", p["conv2"])
    if "time_emb_proj" in p:
        _linear(out, prefix + ".time_emb_proj", p["time_emb_proj"])
    if "conv_shortcut" in p:
        _conv(out, prefix + ".conv_shortcut", p["conv_shortcut"])


def _vae_attn(out: StateDict, prefix: str, p: Mapping) -> None:
    _norm(out, prefix + ".group_norm", p["group_norm"])
    for k in ("to_q", "to_k", "to_v"):
        _linear(out, f"{prefix}.{k}", p[k])
    _linear(out, prefix + ".to_out.0", p["to_out"])


def vae_state_dict(tree: Mapping, block_out_channels, layers_per_block: int) -> StateDict:
    """Whole AutoencoderKL tree -> diffusers keys (`encoder.*`,
    `quant_conv`, `decoder.*`, `post_quant_conv`)."""
    n = len(block_out_channels)
    out: StateDict = {}
    for side, blocks, count in (("encoder", "down", layers_per_block),
                                ("decoder", "up", layers_per_block + 1)):
        p = tree[side]
        _conv(out, f"{side}.conv_in", p["conv_in"])
        _norm(out, f"{side}.conv_norm_out", p["conv_norm_out"])
        _conv(out, f"{side}.conv_out", p["conv_out"])
        _resnet(out, f"{side}.mid_block.resnets.0", p["mid"]["resnet_0"])
        _vae_attn(out, f"{side}.mid_block.attentions.0", p["mid"]["attn"])
        _resnet(out, f"{side}.mid_block.resnets.1", p["mid"]["resnet_1"])
        sampler = "downsamplers" if blocks == "down" else "upsamplers"
        for i in range(n):
            for j in range(count):
                _resnet(out, f"{side}.{blocks}_blocks.{i}.resnets.{j}", p[f"{blocks}_{i}_res_{j}"])
            if i < n - 1:
                _conv(out, f"{side}.{blocks}_blocks.{i}.{sampler}.0.conv",
                      p[f"{blocks}_{i}_{blocks}sample"]["conv"])
    _conv(out, "quant_conv", tree["quant_conv"])
    _conv(out, "post_quant_conv", tree["post_quant_conv"])
    return out


def _maybe_lora(out: StateDict, prefix: str, p: Mapping) -> None:
    if "lora_A" in p:
        out[prefix + ".base_layer.weight"] = _a(p["base"]["kernel"]).T
        out[prefix + ".lora_A.default.weight"] = _a(p["lora_A"]).T
        out[prefix + ".lora_B.default.weight"] = _a(p["lora_B"]).T
    else:
        out[prefix + ".weight"] = _a(p["base"]["kernel"]).T


def _tf_block(out: StateDict, prefix: str, p: Mapping) -> None:
    b = prefix + ".transformer_blocks.0"
    _norm(out, prefix + ".norm", p["norm"])
    _conv(out, prefix + ".proj_in", p["proj_in"])
    _conv(out, prefix + ".proj_out", p["proj_out"])
    for k in ("norm1", "norm2", "norm3"):
        _norm(out, f"{b}.{k}", p[k])
    a1 = p["attn1"]
    for k in ("to_q", "to_k", "to_v"):
        _linear(out, f"{b}.attn1.{k}", a1[k])
    _linear(out, f"{b}.attn1.to_out.0", a1["to_out"])
    a2 = p["attn2"]
    for k in ("to_q", "to_k", "to_v"):
        _maybe_lora(out, f"{b}.attn2.{k}", a2[k])
    _linear(out, f"{b}.attn2.to_out.0", a2["to_out"])
    _linear(out, f"{b}.attn2.processor.to_k_ip.0", a2["to_k_ip"])
    _linear(out, f"{b}.attn2.processor.to_v_ip.0", a2["to_v_ip"])
    _linear(out, f"{b}.ff.net.0.proj", p["ff_proj"])
    _linear(out, f"{b}.ff.net.2", p["ff_out"])


def unet_state_dict(tree: Mapping, block_out_channels, layers_per_block: int) -> StateDict:
    n = len(block_out_channels)
    out: StateDict = {}
    _conv(out, "conv_in", tree["conv_in"])
    _linear(out, "time_embedding.linear_1", tree["time_embed_1"])
    _linear(out, "time_embedding.linear_2", tree["time_embed_2"])
    _norm(out, "conv_norm_out", tree["conv_norm_out"])
    _conv(out, "conv_out", tree["conv_out"])
    _resnet(out, "mid_block.resnets.0", tree["mid_res_0"])
    _resnet(out, "mid_block.resnets.1", tree["mid_res_1"])
    _tf_block(out, "mid_block.attentions.0", tree["mid_attn"])
    for i in range(n):
        for j in range(layers_per_block):
            _resnet(out, f"down_blocks.{i}.resnets.{j}", tree[f"down_{i}_res_{j}"])
            if i < n - 1:
                _tf_block(out, f"down_blocks.{i}.attentions.{j}", tree[f"down_{i}_attn_{j}"])
        if i < n - 1:
            _conv(out, f"down_blocks.{i}.downsamplers.0.conv", tree[f"down_{i}_downsample"])
        for j in range(layers_per_block + 1):
            _resnet(out, f"up_blocks.{i}.resnets.{j}", tree[f"up_{i}_res_{j}"])
            if i > 0:
                _tf_block(out, f"up_blocks.{i}.attentions.{j}", tree[f"up_{i}_attn_{j}"])
        if i < n - 1:
            _conv(out, f"up_blocks.{i}.upsamplers.0.conv", tree[f"up_{i}_upsample"])
    return out


def _bn(out: StateDict, prefix: str, p: Mapping) -> None:
    out[prefix + ".weight"] = _a(p["scale"])
    out[prefix + ".bias"] = _a(p["bias"])
    out[prefix + ".running_mean"] = _a(p["mean"])
    out[prefix + ".running_var"] = _a(p["var"])


def arcface_state_dict(tree: Mapping, config) -> StateDict:
    """ArcFaceResNet18 params -> the reference ResNetFace keys. The JAX fc5
    reads the (H, W, C) flattening; the port's (and the reference's) the
    (C, H, W) one, so fc5's columns are permuted back."""
    out: StateDict = {"conv1.weight": _a(tree["conv1"]["kernel"]).transpose(3, 2, 0, 1),
                      "prelu.weight": _a(tree["prelu"]["weight"])}
    _bn(out, "bn1", tree["bn1"])
    _bn(out, "bn4", tree["bn4"])
    _bn(out, "bn5", tree["bn5"])
    c, hw = config.channels[-1], config.input_size // 16
    w = _a(tree["fc5"]["kernel"]).T  # (emb, hw * hw * c), (H, W, C) order
    out["fc5.weight"] = np.ascontiguousarray(
        w.reshape(-1, hw, hw, c).transpose(0, 3, 1, 2).reshape(w.shape[0], -1))
    out["fc5.bias"] = _a(tree["fc5"]["bias"])
    for si, blocks in enumerate(config.layers):
        for bi in range(blocks):
            p, prefix = tree[f"layer{si + 1}_{bi}"], f"layer{si + 1}.{bi}"
            for k in ("bn0", "bn1", "bn2"):
                _bn(out, f"{prefix}.{k}", p[k])
            for k in ("conv1", "conv2"):
                out[f"{prefix}.{k}.weight"] = _a(p[k]["kernel"]).transpose(3, 2, 0, 1)
            out[f"{prefix}.prelu.weight"] = _a(p["prelu"]["weight"])
            if "downsample_conv" in p:
                out[f"{prefix}.downsample.0.weight"] = _a(p["downsample_conv"]["kernel"]).transpose(3, 2, 0, 1)
                _bn(out, f"{prefix}.downsample.1", p["downsample_bn"])
    return out


def load_jax_arcface(model, tree) -> None:
    """Copy a JAX ArcFaceResNet18 tree (numpy leaves) into the port's model."""
    _load(model, arcface_state_dict(tree, model.config))


def facenet_state_dict(tree: Mapping) -> StateDict:
    """InceptionResnetV1 params -> facenet_pytorch keys: `repeat_1_3` ->
    `repeat_1.3` and `branch1_2` -> `branch1.2` (nn.Sequential indices),
    conv kernels HWIO -> OIHW, `last_linear` transposed, BatchNorm
    scale / bias / mean / var -> weight / bias / running_mean / running_var."""
    out: StateDict = {}

    def walk(prefix: str, node: Mapping) -> None:
        if "mean" in node:
            _bn(out, prefix, node)
        elif "kernel" in node:
            k = _a(node["kernel"])
            out[prefix + ".weight"] = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
            if "bias" in node:
                out[prefix + ".bias"] = _a(node["bias"])
        else:
            for name, child in node.items():
                name = re.sub(r"^(repeat_\d|branch\d)_(\d+)$", r"\1.\2", name)
                walk(f"{prefix}.{name}" if prefix else name, child)

    walk("", tree)
    return out


def load_jax_facenet(model, tree) -> None:
    """Copy a JAX InceptionResnetV1 tree (numpy leaves) into the port's model."""
    _load(model, facenet_state_dict(tree))


def _load(module: torch.nn.Module, sd: StateDict) -> None:
    own = module.state_dict()
    tensors = {k: torch.tensor(v) for k, v in sd.items() if k in own}
    module.load_state_dict(tensors, strict=True)


def load_jax_params(models, params) -> None:
    """Copy a JAX PhotoVerseParams (numpy leaves) into a port
    PhotoVerseModels of the same configuration, every tensor checked."""
    u, v = models.unet.config, models.vae.config
    K = models.num_tokens
    _load(models.text_encoder, clip_text_state_dict(params.text_encoder, models.text_encoder.config.num_layers))
    _load(models.vision_encoder, clip_vision_state_dict(params.vision_encoder, models.vision_encoder.config.num_layers))
    _load(models.unet, unet_state_dict(params.unet, u.block_out_channels, u.layers_per_block))
    _load(models.vae, vae_state_dict(params.vae, v.block_out_channels, v.layers_per_block))
    _load(models.text_adapter, adapter_state_dict(params.text_adapter, K))
    _load(models.image_adapter, adapter_state_dict(params.image_adapter, K))
