"""The benchmark's weights: every parameter of a configuration made on the
device from the run's seed, in a few large draws, in the type it is
served in. The program and the reference are handed the same tensors.

Fill rules (those of the port's numpy initialisation, `_fill`, keyed on
the parameter's name and its module's type), except that lora_B is drawn
like any other weight, as a trained checkpoint holds it:
  - biases and batch-norm means: 0; norm scales and batch-norm variances: 1;
  - PReLU slopes: 0.25;
  - embeddings (token, position, class): N(0, 0.02);
  - lora_A: U(-sqrt(6 / fan_in), +sqrt(6 / fan_in));
  - every other weight: LeCun normal, N(0, 1 / fan_in).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch
from torch import nn

__all__ = ["fill_kind", "make_weights", "load_into"]

_NORMS = (nn.LayerNorm, nn.GroupNorm)


def fill_kind(name: str, module: nn.Module, shape: Tuple[int, ...]) -> Tuple[str, float]:
    """(kind, scale) of parameter `name` owned by `module`: kind is one of
    zeros, ones, const, normal, uniform."""
    leaf = name.rsplit(".", 1)[-1]
    owner = name.rsplit(".", 2)[-2] if name.count(".") else ""
    if "prelu" in name:
        return "const", 0.25
    if leaf in ("bias", "running_mean"):
        return "zeros", 0.0
    if leaf == "running_var" or isinstance(module, _NORMS):
        return "ones", 1.0
    if len(shape) == 1 and leaf == "weight":  # batch-norm scales
        return "ones", 1.0
    if "embedding" in leaf or "embedding" in owner:
        return "normal", 0.02
    fan_in = int(math.prod(shape[1:])) if len(shape) > 1 else 1
    if "lora_A" in name:
        return "uniform", math.sqrt(6.0 / fan_in)
    return "normal", math.sqrt(1.0 / max(fan_in, 1))


def _specs(named: Iterable[Tuple[str, nn.Module, torch.Tensor]]):
    return [(name, tuple(p.shape), fill_kind(name, mod, tuple(p.shape))) for name, mod, p in named]


def named_params(model: nn.Module, prefix: str = ""):
    """(name, owning module, parameter) of every parameter, in order."""
    owners = dict(model.named_modules())
    for name, p in model.named_parameters():
        mod = owners[name.rsplit(".", 1)[0]] if "." in name else model
        yield prefix + name, mod, p


@torch.no_grad()
def make_weights(named, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor} for the parameters `named` yields, drawn on `device`
    from a generator seeded `seed`: one normal draw and one uniform draw
    for all of them, cut into views and scaled in place."""
    specs = _specs(named)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    count = {"normal": 0, "uniform": 0, "zeros": 0, "ones": 0, "const": 0}
    for _, shape, (kind, _) in specs:
        count[kind] += math.prod(shape)
    pools = {
        "normal": torch.randn(count["normal"], generator=gen, device=device, dtype=dtype),
        "uniform": torch.rand(count["uniform"], generator=gen, device=device, dtype=dtype).mul_(2).sub_(1),
        "zeros": torch.zeros(count["zeros"], device=device, dtype=dtype),
        "ones": torch.ones(count["ones"], device=device, dtype=dtype),
        "const": torch.full((count["const"],), 0.25, device=device, dtype=dtype),
    }
    offset = dict.fromkeys(pools, 0)
    out = {}
    for name, shape, (kind, scale) in specs:
        n = math.prod(shape)
        view = pools[kind][offset[kind]:offset[kind] + n].view(shape)
        offset[kind] += n
        if kind in ("normal", "uniform"):
            view.mul_(scale)
        out[name] = view
    return out


@torch.no_grad()
def load_into(model: nn.Module, weights: Dict[str, torch.Tensor], prefix: str = "") -> None:
    """Copy the benchmark's tensors into every parameter of `model`
    (its own storage, in its own dtype); a parameter without a tensor, or a
    tensor without a parameter, raises."""
    names = set()
    for name, p in model.named_parameters():
        p.copy_(weights[prefix + name])
        names.add(prefix + name)
    extra = {k for k in weights if k.startswith(prefix)} - names
    if extra:
        raise KeyError(f"weights without a parameter: {sorted(extra)[:5]}")
