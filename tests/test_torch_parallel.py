"""The port's parallel/ against the JAX package's on the CPU: the tensor-
parallel spec map, the validation rules, the GEGLU shard, the sharded
GroupNorm's arithmetic, the state-dict shards, and the sharded flash
wrapper on two gloo ranks against JAX's shard_map wrapper on its 8-device
mesh (Pallas interpret mode), in f32.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from photoverse_tpu.parallel.flash import sharded_flash as jax_sharded_flash
from photoverse_tpu.parallel.sp import validate_sp as jax_validate_sp
from photoverse_tpu.parallel.tp import MODEL_AXIS, _segments, make_mesh_2d, unet_tp_spec
from photoverse_tpu.parallel.tp import validate_tp as jax_validate_tp
from photoverse_tpu_torch.convert.from_jax import unet_state_dict
from photoverse_tpu_torch.models.layers import GroupNorm
from photoverse_tpu_torch.models.unet import _GEGLUProj
from photoverse_tpu_torch.parallel.flash import enable_sharded_flash, sharded_flash
from photoverse_tpu_torch.parallel.sp import Spatial, validate_sp
from photoverse_tpu_torch.parallel.tp import shard_state_dict, unet_tp_dim, validate_tp
from tests.tiny_models import LATENT, tiny_bundle
from tests.torch_tiny import port_models, run_ranks

FLASH_ATOL = 1e-5  # f32, the JAX wrapper's own bound (tests/test_sharded_flash.py)


@pytest.fixture(scope="module")
def lora_bundle():
    return tiny_bundle(lora_rank=2)


def test_tp_spec_map_matches_jax(lora_bundle):
    """For every parameter of the tiny UNet with LoRA, the dim the port
    shards is the dim JAX's unet_tp_spec shards, through the converter's
    name map (flax kernels transposed): each leaf is filled with values that
    vary along JAX's model axis only, converted, and read back."""
    modules, params = lora_bundle

    def marker(path, x):
        spec = unet_tp_spec(_segments(path), x.ndim)
        axes = [i for i, a in enumerate(tuple(spec) + (None,) * x.ndim) if a == MODEL_AXIS]
        out = np.zeros(x.shape, np.float32)
        for a in axes:
            shape = [1] * x.ndim
            shape[a] = x.shape[a]
            out = out + np.arange(1, x.shape[a] + 1, dtype=np.float32).reshape(shape)
        return out

    tree = jax.tree_util.tree_map_with_path(marker, params.unet)
    cfg = modules.unet.config
    sd = unet_state_dict(tree, cfg.block_out_channels, cfg.layers_per_block)
    port = port_models(modules, params).unet.state_dict()
    assert set(sd) == set(port)
    sharded = 0
    for name, arr in sd.items():
        varies = [d for d in range(arr.ndim) if arr.shape[d] > 1 and np.ptp(arr, axis=d).max() > 0]
        want = varies[0] if varies else None
        assert len(varies) <= 1 and unet_tp_dim(name, arr.ndim) == want, (name, varies)
        sharded += want is not None
    assert sharded > 0


CASES = [  # (check, size, config overrides): tests/test_tp.py's cases and the fused tail
    ("tp", 2, {}), ("tp", 3, {}), ("tp", 2, {"use_flash_attention": True}),
    ("tp", 2, {"fused_blocks": True}), ("sp", 4, {}), ("sp", 16, {}), ("sp", 3, {}),
    ("sp", 2, {"use_flash_attention": True}), ("sp", 2, {"fused_blocks": True}), ("tp", 1, {"fused_blocks": True}),
]


@pytest.mark.parametrize("check,size,over", CASES)
def test_validate_tp_and_sp_match_jax(lora_bundle, check, size, over):
    modules, params = lora_bundle
    jcfg = dataclasses.replace(modules.unet.config, **over)
    tcfg = port_models(modules, params, unet_overrides=over).unet.config

    def verdict(fn, cfg):
        try:
            fn(cfg, LATENT, size) if check == "sp" else fn(cfg, size)
        except ValueError as e:
            return str(e).split(" (")[0].split(":")[0]
        return None

    jax_says = verdict(jax_validate_sp if check == "sp" else jax_validate_tp, jcfg)
    port_says = verdict(validate_sp if check == "sp" else validate_tp, tcfg)
    assert (jax_says is None) == (port_says is None)
    if "divide" in (jax_says or ""):
        assert port_says == jax_says  # the same message for the divisibility rules


def test_geglu_split_equals_fused(lora_bundle):
    """Under TP a rank's GEGLU up-projection splits its own output into
    value and gate as the whole layer does (its shard is [value r; gate r]),
    and gives slice r of the whole layer's a * gelu(gate): the JAX package
    needs tp_friendly_ffn for that, the port's shard layout carries it."""
    modules, params = lora_bundle
    unet = port_models(modules, params).unet
    ff = unet.down_blocks[0].attentions[0].transformer_blocks[0].ff.net[0]
    name = "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj."
    ch = ff.proj.in_features
    x = torch.as_tensor(np.random.RandomState(0).randn(2, 7, ch).astype(np.float32))
    with torch.no_grad():
        whole = ff(x)
    per = whole.shape[-1] // 2
    for r in range(2):
        shard = shard_state_dict(unet.state_dict(), r, 2)
        local = _GEGLUProj(ch, ff.proj.out_features // 2)
        local.proj.load_state_dict({"weight": shard[name + "weight"], "bias": shard[name + "bias"]})
        with torch.no_grad():
            got = local(x)
        torch.testing.assert_close(got, whole[..., r * per:(r + 1) * per], atol=1e-6, rtol=0)


def _one_rank():
    return Spatial(types.SimpleNamespace(size=1, rank=0, all_reduce=lambda t: t, all_gather=lambda t, dim: t))


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "fast_norms"])
def test_sharded_group_norm_is_the_layers_arithmetic(f32):
    """Spatial.group_norm (here over one rank) applies the moments as
    layers.GroupNorm does with and without f32 norms: in f32, one rounding
    to bf16, so the two differ by at most one bf16 step, and rarely."""
    torch.manual_seed(0)
    gn = GroupNorm(8, 32, 1e-5, f32)
    with torch.no_grad():
        gn.weight.normal_()
        gn.bias.normal_()
    gn = gn.to(torch.bfloat16)
    x = (torch.randn(2, 32, 16, 8) * 3 + 1).to(torch.bfloat16)
    with torch.no_grad():
        want = gn(x)
        got = _one_rank().group_norm(x, 8, gn.weight, gn.bias, gn.eps)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=1e-6, rtol=2 ** -7)
    assert (got != want).float().mean() < 1e-3


def test_shards_reassemble_the_state_dict(lora_bundle):
    """Concatenating the shards along each parameter's dim gives the whole
    tensor back; the GEGLU projection's shard r is [value r; gate r]."""
    modules, params = lora_bundle
    full = port_models(modules, params).unet.state_dict()
    shards = [shard_state_dict(full, r, 2) for r in range(2)]
    for name, t in full.items():
        dim = unet_tp_dim(name, t.dim())
        if dim is None:
            assert all(s[name] is t for s in shards)
        elif ".ff.net.0.proj." in name:
            halves = [s[name].chunk(2, dim=0) for s in shards]
            whole = torch.cat([h[0] for h in halves] + [h[1] for h in halves])
            assert torch.equal(whole, t)
        else:
            assert torch.equal(torch.cat([s[name] for s in shards], dim=dim), t)


def _qkv(B, S, H, d, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, S, H, d) * 0.3).astype(np.float32) for _ in range(3)]


FLASH_CASES = {"tensor": (4, 0), "spatial": (2, 1)}  # mode: (heads, seed)


@pytest.fixture(scope="module")
def flash_runs(tmp_path_factory):
    """Both modes on one pair of gloo ranks: {mode: (q, k, v, output)}."""
    qkv = {m: _qkv(4, 256, h, 16, seed) for m, (h, seed) in FLASH_CASES.items()}
    specs = [dict(task="flash", mode=m, dp=1, mp=2, q=q, k=k, v=v) for m, (q, k, v) in qkv.items()]
    outs = run_ranks(specs, 2, tmp_path_factory.mktemp("flash_ranks"))
    return {m: (*qkv[m], out.numpy()) for m, out in zip(qkv, outs)}


@pytest.mark.parametrize("mode", list(FLASH_CASES))
def test_sharded_flash_matches_jax(flash_runs, mode):
    """The port's wrapper on 2 gloo ranks against JAX's on the 8-device
    mesh (data 4 x model 2), the Pallas kernel in interpret mode."""
    q, k, v, got = flash_runs[mode]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(jax_sharded_flash(make_mesh_2d(4, 2), mode))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FLASH_ATOL


def test_sharded_flash_refusals(lora_bundle):
    with pytest.raises(ValueError, match="unknown sharded-flash mode"):
        sharded_flash(None, "pipeline")
    q = torch.zeros(1, 8, 2, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no-grad forward"):
        sharded_flash(None, "tensor")(q, q, q)
    modules, params = lora_bundle
    models = port_models(modules, params, unet_overrides={"fused_blocks": True})
    with pytest.raises(ValueError, match="fused_blocks has no sharded wrapper"):
        enable_sharded_flash(models, None, "tensor")
