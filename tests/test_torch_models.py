"""photoverse_tpu_torch models against photoverse_tpu models on the tiny
bundle (tests/tiny_models.py), f32 on the CPU.

Weights go JAX -> port through convert/from_jax.py; the port's modules are
named by the diffusers/transformers key schema, so the JAX package's own
torch_to_jax converters map the port's state dicts back onto the JAX tree
exactly. Module outputs are held to rtol 5e-4 / atol 5e-5, the tolerance of
the JAX package's own torch-replica test (tests/test_unet.py).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photoverse_tpu.convert import torch_to_jax as t2j
from photoverse_tpu.engine.inference import precompute_ctx_kv as jax_ctx_kv
from photoverse_tpu_torch.convert import from_jax
from photoverse_tpu_torch.engine.inference import precompute_ctx_kv
from photoverse_tpu_torch.models import layers
from photoverse_tpu_torch.models.assembly import build_models, init_params
from photoverse_tpu_torch.ops.group_norm import group_norm_nhwc
from tests.tiny_models import tiny_bundle
from tests.torch_tiny import port_models
from tests.torch_threads import worker_threads  # noqa: F401

RTOL, ATOL = 5e-4, 5e-5


@pytest.fixture(scope="module")
def pair():
    modules, params = tiny_bundle()
    return modules, params, port_models(modules, params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same_tree(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _np_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("name", ["unet", "text_encoder", "vision_encoder", "text_adapter", "image_adapter"])
def test_port_state_dict_converts_back_to_the_jax_tree(pair, name):
    modules, params, port = pair
    sd = _np_sd(getattr(port, name))
    if name == "unet":
        c = modules.unet.config
        back = t2j.convert_strict(t2j.convert_unet, sd, block_out_channels=c.block_out_channels,
                                  layers_per_block=c.layers_per_block)
    elif name == "text_encoder":
        back = t2j.convert_strict(t2j.convert_clip_text, sd, num_layers=modules.text_encoder.config.num_layers)
    elif name == "vision_encoder":
        back = t2j.convert_strict(t2j.convert_clip_vision, sd, num_layers=modules.vision_encoder.config.num_layers)
    else:
        back = t2j.convert_strict(t2j.convert_adapter, sd, num_tokens=modules.num_tokens)
    _assert_same_tree(back, jax.tree.map(np.asarray, getattr(params, name)))


def test_vae_state_dict_round_trip(pair):
    modules, params, port = pair
    c = modules.vae.config
    sd = from_jax.vae_state_dict(jax.tree.map(np.asarray, params.vae), c.block_out_channels, c.layers_per_block)
    back = t2j.convert_strict(t2j.convert_vae, sd, block_out_channels=c.block_out_channels,
                              layers_per_block=c.layers_per_block)
    _assert_same_tree(back, jax.tree.map(np.asarray, params.vae))
    own = _np_sd(port.vae)  # encoder, quant_conv, decoder and post_quant_conv: every entry
    assert sorted(own) == sorted(sd)
    for k, v in own.items():
        np.testing.assert_array_equal(v, sd[k])


def test_lora_unet_round_trip():
    modules, params = tiny_bundle(lora_rank=4)
    c = modules.unet.config
    tree = jax.tree.map(np.asarray, params.unet)
    port = port_models(modules, params)
    assert port.unet.cross_attentions()[0].attn2.to_q.lora_A["default"].weight.shape == (4, c.block_out_channels[0])
    back = t2j.convert_strict(t2j.convert_unet, _np_sd(port.unet), block_out_channels=c.block_out_channels,
                              layers_per_block=c.layers_per_block)
    _assert_same_tree(back, tree)


def _feats(modules, seed=0, B=2):
    cfg = modules.vision_encoder.config
    rng = np.random.RandomState(seed)
    return rng.randn(modules.num_tokens, B, cfg.seq_len, cfg.hidden_size).astype(np.float32)


@pytest.mark.parametrize("token_index", [None, 0, 2])
def test_adapters_match_jax(pair, token_index):
    modules, params, port = pair
    feats = _feats(modules)
    for name in ("text_adapter", "image_adapter"):
        want = getattr(modules, name).apply({"params": getattr(params, name)}, jnp.asarray(feats),
                                            token_index=token_index)
        got = getattr(port, name)(torch.from_numpy(feats), token_index=token_index)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("inject", [False, True])
def test_clip_text_matches_jax(pair, inject):
    modules, params, port = pair
    cfg = modules.text_encoder.config
    rng = np.random.RandomState(1)
    ids = rng.randint(0, cfg.vocab_size, (2, cfg.max_position_embeddings)).astype(np.int32)
    args_j, args_t = [jnp.asarray(ids)], [torch.from_numpy(ids).long()]
    if inject:
        concept = rng.randn(2, 1, cfg.hidden_size).astype(np.float32)
        pidx = np.array([0, 4], np.int32)
        args_j += [jnp.asarray(concept), jnp.asarray(pidx)]
        args_t += [torch.from_numpy(concept), torch.from_numpy(pidx)]
    want = modules.text_encoder.apply({"params": params.text_encoder}, *args_j)
    got = port.text_encoder(*args_t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_clip_vision_matches_jax(pair):
    modules, params, port = pair
    cfg = modules.vision_encoder.config
    px = np.random.RandomState(2).randn(2, cfg.image_size, cfg.image_size, 3).astype(np.float32)
    layers = (0,) + tuple(modules.image_encoder_layers_idx)
    want_last, want = modules.vision_encoder.apply({"params": params.vision_encoder}, jnp.asarray(px),
                                                   collect_layers=layers)
    got_last, got = port.vision_encoder(torch.from_numpy(px), collect_layers=layers)
    assert len(got) == len(layers)
    for g, w in zip((got_last, *got), (want_last, *want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cached", [False, True])
def test_unet_matches_jax(pair, cached):
    modules, params, port = pair
    cross = modules.unet.config.cross_attention_dim
    rng = np.random.RandomState(3)
    B = 2
    sample = rng.randn(B, 16, 16, 4).astype(np.float32)
    t = np.array([3, 777], np.int32)
    text = rng.randn(B, 12, cross).astype(np.float32)
    idc = rng.randn(B, 1, cross).astype(np.float32)
    kv_j = jax_ctx_kv(modules, params, jnp.asarray(text), jnp.asarray(idc)) if cached else None
    want, want_n = modules.unet.apply({"params": params.unet}, jnp.asarray(sample), jnp.asarray(t),
                                      jnp.asarray(text), jnp.asarray(idc), ctx_kv=kv_j)
    T = torch.from_numpy
    kv_t = precompute_ctx_kv(port, T(text), T(idc)) if cached else None
    got, got_n = port.unet(T(sample), T(t), T(text), T(idc), ctx_kv=kv_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=RTOL, atol=ATOL)


def test_vae_decode_matches_jax(pair):
    modules, params, port = pair
    lat = np.random.RandomState(4).randn(2, 16, 16, 4).astype(np.float32)
    want = modules.vae.apply({"params": params.vae}, jnp.asarray(lat), method="decode")
    got = port.vae.decode(torch.from_numpy(lat))
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_vae_encode_matches_jax(pair):
    # encode_moments and encode_sample with the same noise (the JAX package
    # draws it from its key inside encode_sample; the port takes it in)
    modules, params, port = pair
    rng = np.random.RandomState(5)
    px = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want_mean, want_logvar = modules.vae.apply({"params": params.vae}, jnp.asarray(px), method="encode_moments")
    want = modules.vae.apply({"params": params.vae}, jnp.asarray(px), key, method="encode_sample")
    noise = np.array(jax.random.normal(key, want_mean.shape, want_mean.dtype))
    mean, logvar = port.vae.encode_moments(torch.from_numpy(px))
    got = port.vae.encode_sample(torch.from_numpy(px), torch.from_numpy(noise))
    assert got.shape == (2, 16, 16, 4) and got.dtype == torch.float32
    for g, w in ((mean, want_mean), (logvar, want_logvar), (got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cached", [False, True])
def test_unet_train_mode_matches_jax(cached, pair):
    # train=True: stochastic fusion on JAX's per-layer uniforms
    # (uniform(fold_in(fusion_rng, i))), lora_dropout 0 (flax's masks cannot
    # be rebuilt outside flax); the fusion rules pick text-only, id-only or
    # the sum per layer, so all three branches appear across the layers
    modules, params = tiny_bundle(lora_rank=4, seed=2)
    port = port_models(modules, params)
    cross = modules.unet.config.cross_attention_dim
    rng = np.random.RandomState(7)
    sample = rng.randn(2, 16, 16, 4).astype(np.float32)
    t = np.array([10, 500], np.int32)
    text, idc = rng.randn(2, 12, cross).astype(np.float32), rng.randn(2, 5, cross).astype(np.float32)
    key = jax.random.PRNGKey(11)
    L = len(port.unet.cross_attentions())
    u = np.array([float(jax.random.uniform(jax.random.fold_in(key, i), ())) for i in range(L)], np.float32)
    kv_j = jax_ctx_kv(modules, params, jnp.asarray(text), jnp.asarray(idc)) if cached else None
    want, want_n = modules.unet.apply({"params": params.unet}, jnp.asarray(sample), jnp.asarray(t),
                                      jnp.asarray(text), jnp.asarray(idc), train=True, fusion_rng=key,
                                      ctx_kv=kv_j)
    T = torch.from_numpy
    kv_t = precompute_ctx_kv(port, T(text), T(idc)) if cached else None
    got, got_n = port.unet(T(sample), T(t), T(text), T(idc), ctx_kv=kv_t, train=True, fusion_u=T(u))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_n.detach().numpy(), np.asarray(want_n), rtol=RTOL, atol=ATOL)
    eval_out, _ = port.unet(T(sample), T(t), T(text), T(idc), ctx_kv=kv_t)
    assert not np.allclose(eval_out.detach().numpy(), got.detach().numpy())
    with pytest.raises(ValueError, match="fusion_u"):
        port.unet(T(sample), T(t), T(text), T(idc), train=True)


def test_init_params_follows_the_numpy_fill_rules(pair):
    modules, _, port = pair
    models = init_params(build_models(
        extra_num_tokens=modules.num_tokens - 1,
        unet_config=port.unet.config, vae_config=port.vae.config,
        text_config=port.text_encoder.config, vision_config=port.vision_encoder.config,
        image_encoder_layers_idx=modules.image_encoder_layers_idx,
        device="cpu",
    ), seed=3)
    sd = {k: v.clone() for k, v in models.unet.state_dict().items()}
    assert torch.all(sd["conv_norm_out.weight"] == 1) and torch.all(sd["conv_norm_out.bias"] == 0)
    w = sd["down_blocks.0.resnets.0.conv1.weight"]  # (out, in, 3, 3): LeCun normal
    assert abs(w.std().item() * np.sqrt(w[0].numel()) - 1.0) < 0.1
    emb = models.text_encoder.state_dict()["embeddings.token_embedding.weight"]
    assert abs(emb.std().item() - 0.02) < 0.002
    models.unet.conv_in.weight.zero_()
    again = init_params(models, seed=3).unet.state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_init_params_threads_draw_each_models_sequence_in_order(pair):
    """init_params fills the six models in threads; each model's values
    are those of one generator walked through its parameters in order."""
    from photoverse_tpu_torch.models.assembly import MODEL_NAMES, _fill

    modules, _, port = pair
    models = init_params(build_models(
        extra_num_tokens=modules.num_tokens - 1,
        unet_config=port.unet.config, vae_config=port.vae.config,
        text_config=port.text_encoder.config, vision_config=port.vision_encoder.config,
        image_encoder_layers_idx=modules.image_encoder_layers_idx,
        device="cpu",
    ), seed=5)
    for i, name in enumerate(MODEL_NAMES):
        rng = np.random.default_rng(5 + i)
        sub = getattr(models, name)
        owners = dict(sub.named_modules())
        for pname, p in sub.named_parameters():
            mod = owners[pname.rsplit(".", 1)[0]] if "." in pname else sub
            assert np.array_equal(p.detach().numpy(), _fill(pname, mod, tuple(p.shape), rng)), (name, pname)


def _norm_route_on_cpu(monkeypatch):
    """Let layers.GroupNorm take its channels-last route for CPU tensors too
    (the wrapper then runs the kernel's plain version) and record, per call,
    whether the norm's input was channels-last."""
    calls = []

    def spy(x, *args, **kwargs):
        calls.append(x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last))
        return group_norm_nhwc(x, *args, **kwargs)

    monkeypatch.setattr(layers, "nhwc_route", lambda x: not torch.is_grad_enabled() and x.is_contiguous(
        memory_format=torch.channels_last))
    monkeypatch.setattr(layers, "group_norm_nhwc", spy)
    return calls


def _layout_case(modules, port, which, seed=0):
    """(model with perturbed weights, call running it on seeded inputs,
    number of GroupNorms the call runs) for the tiny UNet or VAE decoder."""
    rng = np.random.RandomState(seed)
    T = torch.from_numpy
    model = copy.deepcopy(port.unet if which == "unet" else port.vae)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # norm scales and biases away from 1 and 0
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    if which == "unet":
        cross = modules.unet.config.cross_attention_dim
        args = (T(rng.randn(2, 16, 16, 4).astype(np.float32)), T(np.array([3, 777], np.int32)),
                T(rng.randn(2, 12, cross).astype(np.float32)), T(rng.randn(2, 1, cross).astype(np.float32)))
        norms = model
        run = lambda m: m(*args)[0]  # noqa: E731
    else:
        lat = T(rng.randn(2, 16, 16, 4).astype(np.float32))
        norms = model.decoder
        run = lambda m: m.decode(lat)  # noqa: E731
    return model, run, sum(isinstance(m, layers.GroupNorm) for m in norms.modules())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["unet", "vae_decoder"])
def test_channels_last_no_grad_forward_matches_the_nchw_forward(pair, monkeypatch, which, dtype):
    # the no-grad forward on channels_last weights with every GroupNorm on
    # the fused route (here the kernel's plain version) against the same
    # model with NCHW weights on torch's GroupNorm, add and SiLU. Every norm
    # takes the route and finds its input channels-last: nothing converts
    # back between the convolutions. In f32 the two are the same arithmetic;
    # in bf16 the route rounds once after each SiLU where torch rounds twice,
    # so each is held to the f32 forward on the same weights: the route no
    # farther from it than the NCHW forward is (1.25x)
    modules, _, port = pair
    model, run, n_norms = _layout_case(modules, port, which)
    assert model.conv_in.weight.is_contiguous(memory_format=torch.channels_last) if which == "unet" else \
        model.decoder.conv_in.weight.is_contiguous(memory_format=torch.channels_last)
    model = model.to(dtype)
    nchw = copy.deepcopy(model).to(memory_format=torch.contiguous_format)
    with torch.no_grad():
        want = run(nchw)
        f32 = run(nchw.float()) if dtype != torch.float32 else None
        calls = _norm_route_on_cpu(monkeypatch)
        got = run(model)
    assert len(calls) == n_norms and all(calls)
    assert got.dtype == want.dtype and got.shape == want.shape
    if f32 is None:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    else:
        assert (got - f32).abs().max() <= 1.25 * (want - f32).abs().max()


@pytest.mark.parametrize("which", ["unet", "vae_decoder"])
def test_grad_enabled_forward_keeps_torchs_group_norm(pair, monkeypatch, which):
    # the kernel has no backward: with grad enabled no norm takes the route,
    # whatever its input's layout, and the forward is the NCHW one's
    modules, _, port = pair
    model, run, _ = _layout_case(modules, port, which, seed=1)
    with torch.no_grad():
        want = run(copy.deepcopy(model).to(memory_format=torch.contiguous_format))
    calls = _norm_route_on_cpu(monkeypatch)
    with torch.enable_grad():
        got = run(model.requires_grad_(True))
    assert calls == []
    assert got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
