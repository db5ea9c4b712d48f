"""The port's trainable parameters <-> the JAX package's trainable tree.

The inverse of convert/from_jax.py for the trainable set (both adapters,
and in the UNet the identity projections to_k_ip / to_v_ip and the LoRA
factors), so the native `.msgpack` checkpoint holds the JAX package's
layout: keys are the JAX tree paths, Dense kernels are (in, out), and each
adapter weight stacks its K per-token MLPs into one (K, ...) leaf.

Every port name maps to one (JAX path, token index or None, transposed)
entry, so the same mapping carries parameters, gradients and the Adam
moments. Pure numpy.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["JaxLeaf", "jax_leaf", "to_jax", "from_jax_trainable"]

Path = Tuple[str, ...]

_ADAPTER = re.compile(r"(text_adapter|image_adapter)\.(mapping|mapping_patch)_(\d+)\.(\d)\.(weight|bias)")
_UNET = re.compile(
    r"unet\.(?:down_blocks\.(?P<di>\d+)\.attentions\.(?P<dj>\d+)|mid_block\.attentions\.0"
    r"|up_blocks\.(?P<ui>\d+)\.attentions\.(?P<uj>\d+))\.transformer_blocks\.0\.attn2\."
    r"(?:processor\.(?P<ip>to_k_ip|to_v_ip)\.0\.weight"
    r"|(?P<proj>to_q|to_k|to_v)\.(?P<lora>lora_A|lora_B)\.default\.weight)"
)
# adapter Sequential index -> (weight leaf, bias leaf); Linear at 0/3/6, LayerNorm at 1/4
_ADAPTER_LEAVES = {0: ("fc0_w", "fc0_b"), 3: ("fc1_w", "fc1_b"), 6: ("fc2_w", "fc2_b"),
                   1: ("ln0_g", "ln0_b"), 4: ("ln1_g", "ln1_b")}


class JaxLeaf(NamedTuple):
    path: Path  # the JAX trainable tree path, model name first
    index: Optional[int]  # the token index in a stacked adapter leaf
    transpose: bool  # a torch (out, in) weight stored as a JAX (in, out) kernel


def jax_leaf(name: str) -> JaxLeaf:
    """Where the port's trainable `name` lives in the JAX trainable tree."""
    m = _ADAPTER.fullmatch(name)
    if m:
        model, branch, i, j, kind = m.groups()
        w, b = _ADAPTER_LEAVES[int(j)]
        linear = int(j) in (0, 3, 6)
        return JaxLeaf((model, branch, w if kind == "weight" else b), int(i), linear and kind == "weight")
    m = _UNET.fullmatch(name)
    if m:
        if m["di"] is not None:
            block = f"down_{m['di']}_attn_{m['dj']}"
        elif m["ui"] is not None:
            block = f"up_{m['ui']}_attn_{m['uj']}"
        else:
            block = "mid_attn"
        if m["ip"]:
            return JaxLeaf(("unet", block, "attn2", m["ip"], "kernel"), None, True)
        return JaxLeaf(("unet", block, "attn2", m["proj"], m["lora"]), None, True)
    raise KeyError(f"{name} is not a trainable parameter of the port")


def to_jax(named: Mapping[str, np.ndarray]) -> Dict[Path, np.ndarray]:
    """{port trainable name: array} -> {JAX path: array}; the adapters'
    per-token arrays are stacked in token order (every token must be there)."""
    out: Dict[Path, np.ndarray] = {}
    stacked: Dict[Path, Dict[int, np.ndarray]] = {}
    for name, value in named.items():
        leaf = jax_leaf(name)
        a = np.asarray(value)
        if leaf.transpose:
            a = a.T
        if leaf.index is None:
            out[leaf.path] = np.ascontiguousarray(a)
        else:
            stacked.setdefault(leaf.path, {})[leaf.index] = a
    for path, parts in stacked.items():
        if sorted(parts) != list(range(len(parts))):
            raise ValueError(f"{'/'.join(path)}: token rows {sorted(parts)} are not 0..K-1")
        out[path] = np.stack([parts[i] for i in range(len(parts))])
    return out


def from_jax_trainable(flat: Mapping[Path, np.ndarray], names) -> Dict[str, np.ndarray]:
    """{JAX path: array} -> {port name: array} for each of `names`; a
    missing JAX leaf raises KeyError naming it."""
    out: Dict[str, np.ndarray] = {}
    for name in names:
        leaf = jax_leaf(name)
        if leaf.path not in flat:
            raise KeyError(f"{'/'.join(leaf.path)} (for {name}) is missing")
        a = np.asarray(flat[leaf.path])
        if leaf.index is not None:
            a = a[leaf.index]
        out[name] = np.ascontiguousarray(a.T if leaf.transpose else a)
    return out
