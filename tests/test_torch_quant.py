"""The port's W8A8 int8 conditioning (ops/quant.py and its wiring) against
the JAX package's (f32, CPU).

The quantizer and the int32 product are integer arithmetic around the same
f32 scales, so the codes, the accumulators and the output must equal the
JAX package's bit for bit. Whole encoders are held at 1e-5: their inputs
come out of LayerNorms that the two packages sum in another order.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from photoverse_tpu.models import clip as jclip
from photoverse_tpu.ops import quant as jquant
from photoverse_tpu_torch.cli import generate as tgen
from photoverse_tpu_torch.convert.from_jax import clip_text_state_dict, clip_vision_state_dict
from photoverse_tpu_torch.engine import inference as tinf
from photoverse_tpu_torch.engine.training import TrainConfig, TrainStep
from photoverse_tpu_torch.models import assembly as tassembly
from photoverse_tpu_torch.models import clip as tclip
from photoverse_tpu_torch.models.unet import UNetConfig
from photoverse_tpu_torch.models.vae import VAEConfig
from photoverse_tpu_torch.ops import quant
from tests.test_cli_e2e import _make_checkpoint
from tests.torch_threads import worker_threads  # noqa: F401

TCFG = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
            max_position_embeddings=12)
VCFG = dict(hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32, image_size=16, patch_size=8)


def _jax_codes(x, kernel):
    """photoverse_tpu/ops/quant.py:int8_matmul's codes and accumulators,
    step for step (the module returns only the output)."""
    k = kernel.astype(jnp.float32)
    w_scale = jnp.maximum(jnp.max(jnp.abs(k), axis=0), 1e-8) / jquant._QMAX
    w_q = jnp.clip(jnp.round(k / w_scale), -jquant._QMAX, jquant._QMAX).astype(jnp.int8)
    xf = x.astype(jnp.float32)
    a_scale = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-8) / jquant._QMAX
    x_q = jnp.clip(jnp.round(xf / a_scale), -jquant._QMAX, jquant._QMAX).astype(jnp.int8)
    acc = jax.lax.dot_general(x_q, w_q, (((x_q.ndim - 1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    return [np.asarray(a) for a in (w_q, w_scale, x_q, a_scale, acc)]


@pytest.mark.parametrize("shape,N,bias", [((2, 77, 768), 3072, True), ((5, 64), 40, False), ((3, 7, 24), 16, True)])
def test_int8_matmul_equals_jax_bit_for_bit(shape, N, bias):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 1.7).astype(np.float32)
    w = (rng.randn(shape[-1], N) / 16).astype(np.float32)  # flax (K, N)
    b = (rng.randn(N) * 0.1).astype(np.float32) if bias else None
    want = np.asarray(jquant.int8_matmul(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                                         jnp.float32))
    w_q, w_scale, x_q, a_scale, acc = _jax_codes(jnp.asarray(x), jnp.asarray(w))
    tw = torch.from_numpy(np.ascontiguousarray(w.T))  # nn.Linear (N, K)
    got_wq, got_ws = quant.quantize_weight(tw)
    got_xq, got_as = quant.quantize_activation(torch.from_numpy(x))
    assert got_wq.dtype == got_xq.dtype == torch.int8
    np.testing.assert_array_equal(got_wq.numpy().T, w_q)
    np.testing.assert_array_equal(got_ws.numpy(), w_scale)
    np.testing.assert_array_equal(got_xq.numpy(), x_q)
    assert got_as.item() == float(a_scale)
    got_acc = quant.int8_product(got_xq.reshape(-1, shape[-1]), got_wq)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy().reshape(acc.shape), acc)
    got = quant.int8_matmul(torch.from_numpy(x), tw, None if b is None else torch.from_numpy(b), torch.float32)
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)


def test_int8_linear_is_an_nn_linear_drop_in():
    torch.manual_seed(0)
    lin = torch.nn.Linear(32, 24)
    q = quant.Int8Linear(32, 24)
    assert {k: (v.shape, v.dtype) for k, v in q.state_dict().items()} == \
        {k: (v.shape, v.dtype) for k, v in lin.state_dict().items()}
    q.load_state_dict(lin.state_dict(), strict=True)
    x = torch.randn(4, 32)
    want, got = lin(x), q(x)
    cos = torch.nn.functional.cosine_similarity(want.flatten(), got.flatten(), dim=0)
    assert cos > 0.999 and not torch.equal(want, got)
    assert torch.equal(got, quant.int8_matmul(x, lin.weight, lin.bias, torch.float32))
    assert q(x.bfloat16()).dtype == torch.bfloat16


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("inject", [False, True])
def test_int8_text_encoder_matches_jax(inject):
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 64, (2, 12)).astype(np.int32)
    te = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(int8_dense=True, **TCFG))
    p = te.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    port = tclip.CLIPTextEncoder(tclip.CLIPTextConfig(int8_dense=True, **TCFG))
    port.load_state_dict({k: torch.tensor(v) for k, v in
                          clip_text_state_dict(jax.tree.map(np.asarray, p), 2).items()}, strict=True)
    args_j, args_t = [jnp.asarray(ids)], [torch.from_numpy(ids).long()]
    if inject:
        concept = rng.randn(2, 1, 16).astype(np.float32)
        pidx = np.array([0, 4], np.int32)
        args_j += [jnp.asarray(concept), jnp.asarray(pidx)]
        args_t += [torch.from_numpy(concept), torch.from_numpy(pidx)]
    want = te.apply({"params": p}, *args_j)
    with torch.no_grad():
        got = port(*args_t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    # and the int8 run is not the f32 one
    f32 = jclip.CLIPTextEncoder(jclip.CLIPTextConfig(**TCFG)).apply({"params": p}, *args_j)[0]
    assert 0.99 < _cos(f32, want[0]) < 1.0


def test_int8_vision_encoder_matches_jax():
    px = np.random.RandomState(3).randn(2, 16, 16, 3).astype(np.float32)
    ve = jclip.CLIPVisionEncoder(jclip.CLIPVisionConfig(int8_dense=True, **VCFG))
    p = ve.init(jax.random.PRNGKey(1), jnp.asarray(px))["params"]
    port = tclip.CLIPVisionEncoder(tclip.CLIPVisionConfig(int8_dense=True, **VCFG))
    port.load_state_dict({k: torch.tensor(v) for k, v in
                          clip_vision_state_dict(jax.tree.map(np.asarray, p), 2).items()}, strict=True)
    want_last, want = ve.apply({"params": p}, jnp.asarray(px), collect_layers=(0, 1, 2))
    with torch.no_grad():
        got_last, got = port(torch.from_numpy(px), collect_layers=(0, 1, 2))
    for g, w in zip((got_last, *got), (want_last, *want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_int8_conditioning_builds_int8_layers_only_inside_the_encoders():
    kw = dict(text_config=tclip.CLIPTextConfig(**TCFG), vision_config=tclip.CLIPVisionConfig(**VCFG),
              unet_config=UNetConfig(block_out_channels=(16, 32), layers_per_block=1, cross_attention_dim=16,
                                     num_heads=2, norm_num_groups=8),
              vae_config=VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8),
              device="cpu")
    plain = tassembly.build_models(**kw)
    models = tassembly.build_models(int8_conditioning=True, **kw)
    assert models.text_encoder.config.int8_dense and models.vision_encoder.config.int8_dense
    assert not plain.text_encoder.config.int8_dense
    int8 = {n for n, m in models.named_modules() if isinstance(m, quant.Int8Linear)}
    layers = [f"{e}.encoder.layers.{i}" for e in ("text_encoder", "vision_encoder") for i in range(2)]
    assert int8 == {f"{l}.{p}" for l in layers for p in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                                                          "self_attn.out_proj", "mlp.fc1", "mlp.fc2")}
    assert {k: v.shape for k, v in models.state_dict().items()} == {k: v.shape for k, v in plain.state_dict().items()}
    with pytest.raises(ValueError, match="inference-only"):
        TrainStep(models, TrainConfig())
    TrainStep(plain, TrainConfig())


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    d = tmp_path_factory.mktemp("int8")
    root = _make_checkpoint(d)
    face = d / "face.jpg"
    Image.fromarray((np.random.RandomState(0).rand(64, 64, 3) * 255).astype(np.uint8)).save(face)
    return d, root, face


def test_generate_cli_int8_conditioning_matches_jax_encoders(ws):
    from photoverse_tpu.models.assembly import load_models as jax_load_models

    d, root, face = ws
    seen = {}
    real = tinf.run_inference

    def spy(models, solver, example, *a, **kw):
        seen.update(models=models, example=example)
        return real(models, solver, example, *a, **kw)

    with mock.patch.object(tinf, "run_inference", spy):
        tgen.main(["--model_path", root, "--checkpoint_path", "", "--input_image_path", str(face),
                   "--results_dir", str(d / "out"), "--num_timesteps", "2", "--resolution", "32",
                   "--encoder_layers_idx", "1", "2", "3", "4", "--seed", "3", "--int8_conditioning",
                   "--guidance_scale", "2", "--cpu"])
    imgs = [np.asarray(Image.open(d / "out" / f)) for f in sorted(os.listdir(d / "out"))]
    assert len(imgs) == 1 and imgs[0].shape == (32, 32, 3)
    models, ex = seen["models"], seen["example"]
    assert models.text_encoder.config.int8_dense and models.vision_encoder.config.int8_dense
    # the encoders the CLI ran, against the JAX package's int8 encoders
    # loaded from the same directory, on the CLI's own example
    _, jm, jp, _ = jax_load_models(root, extra_num_tokens=4, image_encoder_layers_idx=(1, 2, 3, 4),
                                   int8_conditioning=True)
    assert jm.text_encoder.config.int8_dense
    layers = (1, 2, 3, 4)
    want_last, want = jm.vision_encoder.apply({"params": jp.vision_encoder}, jnp.asarray(ex["pixel_values_clip"]),
                                             collect_layers=layers)
    want_text, _ = jm.text_encoder.apply({"params": jp.text_encoder}, jnp.asarray(ex["text_input_ids"]))
    with torch.no_grad():
        got_last, got = models.vision_encoder(torch.from_numpy(ex["pixel_values_clip"]), collect_layers=layers)
        got_text, _ = models.text_encoder(torch.from_numpy(ex["text_input_ids"]).long())
    for g, w in zip((got_last, *got, got_text), (want_last, *want, want_text)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
