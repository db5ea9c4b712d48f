"""The port's loading path against the JAX package's on a tiny
diffusers-layout directory: the host code the CLIs call (tokenizer, prompt
preparation, image preprocessing, uint8 packing), the diffusers-directory
loader with its strictness, and `.pt` checkpoints with LoRA re-injected.
Everything here compares integers or copied f32 weights, so the two
packages must agree exactly.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from photoverse_tpu.data import preprocessing as jpre
from photoverse_tpu.data import prompts as jprompts
from photoverse_tpu.data.tokenizer import CLIPTokenizer as JaxTokenizer
from photoverse_tpu.utils import image as jimage
from photoverse_tpu_torch.ckpt import checkpoint as tckpt
from photoverse_tpu_torch.convert.from_jax import load_jax_params
from photoverse_tpu_torch.data import preprocessing as tpre
from photoverse_tpu_torch.data import prompts as tprompts
from photoverse_tpu_torch.data.tokenizer import CLIPTokenizer
from photoverse_tpu_torch.models import assembly as tassembly
from photoverse_tpu_torch.utils import image as timage
from tests.test_cli_e2e import _make_checkpoint
from tests.test_data import _tiny_tokenizer
from tests.torch_tiny import port_models
from tests.torch_threads import worker_threads  # noqa: F401

KW = dict(extra_num_tokens=4, image_encoder_layers_idx=(1, 2, 3, 4))
LORA_CFG = {"r": 2, "lora_alpha": 1.0, "lora_dropout": 0.0, "bias": "none",
            "target_modules": ["attn2.to_k", "attn2.to_v", "attn2.to_q"]}
LOADED = ("text_encoder", "vision_encoder", "unet", "vae")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _make_checkpoint(tmp_path_factory.mktemp("sd_dir"))


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    return _tiny_tokenizer(d), CLIPTokenizer.from_pretrained(str(d))


PROMPTS = ["the photo of *", "a photo of a *", "", "the the photo, of 12 b's!", "  The   PHOTO of  * ",
           "a " * 40]


@pytest.mark.parametrize("text", PROMPTS)
def test_tokenizer_matches_jax(tokenizers, text):
    jtok, ttok = tokenizers
    assert ttok.model_max_length == jtok.model_max_length
    want, got = jtok(text), ttok(text)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ttok([text, "of"], max_length=9), jtok([text, "of"], max_length=9))


@pytest.mark.parametrize("template,negative,n", [
    ("a photo of a {}", None, None), ("the photo of {}", "the the", 3), ("{} of the photo", "", 2)])
def test_prepare_prompt_matches_jax(tokenizers, template, negative, n):
    jtok, ttok = tokenizers
    want = jprompts.prepare_prompt(jtok, template, negative_prompt=negative, num_of_samples=n)
    got = tprompts.prepare_prompt(ttok, template, negative_prompt=negative, num_of_samples=n)
    assert set(got) == set(want) and got["text"] == want["text"]
    for k in ("text_input_ids", "concept_placeholder_idx", "negative_text_input_ids"):
        if want[k] is None:
            assert got[k] is None
        else:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert tprompts.find_placeholder_index("a photo of *") == jprompts.find_placeholder_index("a photo of *") == 4
    assert tprompts.find_placeholder_index("no placeholder") == 0


@pytest.mark.parametrize("size,hw", [((64, 48), 32), ((50, 77), 32), ((32, 32), 16), ((20, 64), 24)])
def test_image_preprocessing_matches_jax(size, hw):
    rng = np.random.RandomState(sum(size))
    img = Image.fromarray((rng.rand(size[1], size[0], 3) * 255).astype(np.uint8))
    np.testing.assert_array_equal(tpre.preprocess_image(img, hw), jpre.preprocess_image(img, hw))
    np.testing.assert_array_equal(tpre.preprocess_image(img, hw, "bilinear"),
                                  jpre.preprocess_image(img, hw, "bilinear"))
    np.testing.assert_array_equal(tpre.clip_preprocess(img, hw), jpre.clip_preprocess(img, hw))
    arr = np.asarray(img)
    np.testing.assert_array_equal(tpre.clip_preprocess(arr, hw), jpre.clip_preprocess(arr, hw))
    grey = img.convert("L")
    np.testing.assert_array_equal(tpre.preprocess_image(grey, hw), jpre.preprocess_image(grey, hw))
    np.testing.assert_array_equal(tpre.CLIP_MEAN, jpre.CLIP_MEAN)
    np.testing.assert_array_equal(tpre.CLIP_STD, jpre.CLIP_STD)


def test_denormalize_and_to_pil_match_jax():
    x = np.random.RandomState(3).randn(2, 8, 8, 3).astype(np.float32) * 0.8
    np.testing.assert_array_equal(timage.denormalize(x), jimage.denormalize(x))
    a, b = timage.to_pil(timage.denormalize(x[0])), jimage.to_pil(jimage.denormalize(x[0]))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(timage.to_uint8(timage.denormalize(x[1])),
                                  np.asarray(jimage.to_pil(jimage.denormalize(x[1]))))


def test_port_imports_neither_pillow_nor_jax_at_import_time():
    # in a fresh interpreter: the card's machine is not promised Pillow, and
    # the port must not need the JAX package
    import subprocess

    mods = ["photoverse_tpu_torch.cli.generate", "photoverse_tpu_torch.cli.serve",
            "photoverse_tpu_torch.data.preprocessing", "photoverse_tpu_torch.utils.image",
            "photoverse_tpu_torch.data.tokenizer", "photoverse_tpu_torch.data.prompts",
            "photoverse_tpu_torch.models.assembly", "photoverse_tpu_torch.ckpt.checkpoint",
            "photoverse_tpu_torch.convert.from_diffusers", "photoverse_tpu_torch.engine.inference",
            "photoverse_tpu_torch.cli.eval_face_similarity", "photoverse_tpu_torch.utils.face_similarity",
            "photoverse_tpu_torch.utils.mtcnn", "photoverse_tpu_torch.models.facenet",
            "photoverse_tpu_torch.ops.quant", "photoverse_tpu_torch.data.native_tokenizer",
            "photoverse_tpu_torch.parallel", "photoverse_tpu_torch.parallel.mesh", "photoverse_tpu_torch.parallel.tp",
            "photoverse_tpu_torch.parallel.sp", "photoverse_tpu_torch.parallel.flash",
            "photoverse_tpu_torch.data.celebahq", "photoverse_tpu_torch.cli.prepare_celebhqmasks",
            "photoverse_tpu_torch.cli.create_dataset_json", "photoverse_tpu_torch.convert.manifests",
            "photoverse_tpu_torch.convert.real_goldens", "scripts.torch_make_random_checkpoint",
            "scripts.torch_train_soak"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in ('PIL', 'jax', 'flax', 'photoverse_tpu', 'transformers') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _port_of(jmodules, jparams):
    """The JAX load result carried into a port bundle (tests/torch_tiny)."""
    return port_models(jmodules, jparams)


def _state(models, names):
    return {f"{n}.{k}": v for n in names for k, v in getattr(models, n).state_dict().items()}


def test_load_models_matches_jax_loader_exactly(root):
    from photoverse_tpu.models.assembly import load_models as jax_load_models

    jtok, jmodules, jparams, jlora = jax_load_models(root, **KW)
    ttok, models, tlora = tassembly.load_models(root, device="cpu", **KW)
    assert jlora is None and tlora is None
    assert models.device.type == "cpu" and models.dtype == torch.float32
    np.testing.assert_array_equal(ttok("the photo of *"), jtok("the photo of *"))
    want = _state(_port_of(jmodules, jparams), LOADED)
    got = _state(models, LOADED)
    assert set(got) == set(want)
    for k in want:  # copied f32 weights: bit-identical
        assert torch.equal(got[k], want[k]), k
    # the adapters come from each package's own init: shapes only
    for n in ("text_adapter", "image_adapter"):
        a, b = getattr(models, n).state_dict(), _state(_port_of(jmodules, jparams), (n,))
        assert {f"{n}.{k}": tuple(v.shape) for k, v in a.items()} == {k: tuple(v.shape) for k, v in b.items()}
    # configs and the schedule follow the directory's json files
    u = models.unet.config
    assert (u.block_out_channels, u.layers_per_block, u.num_heads, u.norm_num_groups) == ((16, 32), 1, 2, 8)
    assert models.vae.config.block_out_channels == (16, 32)
    assert models.vision_encoder.config.image_size == 16 and models.text_encoder.config.vocab_size == len(jtok.encoder)
    np.testing.assert_array_equal(models.schedule.alphas_cumprod, jmodules.schedule.alphas_cumprod)


def test_attention_head_dim_is_the_head_count(tmp_path):
    d = tmp_path / "sd2"
    (d / "unet").mkdir(parents=True)
    (d / "unet" / "config.json").write_text(json.dumps({"attention_head_dim": 8, "block_out_channels": [320, 640]}))
    unet_cfg, vae_cfg, text_cfg = tassembly._configs_from_checkpoint(str(d), 0, 1.0, 0.0)
    assert unet_cfg.num_heads == 8 and unet_cfg.block_out_channels == (320, 640)
    assert vae_cfg.block_out_channels == (128, 256, 512, 512) and text_cfg.vocab_size == 49408
    assert tassembly._schedule_from(str(d)).num_train_timesteps == 1000
    with pytest.raises(FileNotFoundError):
        tassembly._find_weight_file(str(d / "unet"))


@pytest.mark.parametrize("sub,name,key", [
    ("unet", "diffusion_pytorch_model.bin", "mid_block.attentions.0.transformer_blocks.0.attn9.to_q.weight"),
    ("vae", "diffusion_pytorch_model.bin", "decoder.stray.weight"),
    ("text_encoder", "pytorch_model.bin", "text_model.encoder.layers.7.mlp.fc1.weight"),
    ("image_encoder", "pytorch_model.bin", "vision_model.stray.bias"),
])
def test_load_models_refuses_a_stray_key(root, tmp_path, sub, name, key):
    import shutil

    copy = tmp_path / "sd"
    shutil.copytree(root, copy)
    f = copy / sub / name
    sd = torch.load(f, weights_only=True)
    sd[key] = torch.zeros(3)
    torch.save(sd, f)
    with pytest.raises(ValueError, match="not consumed"):
        tassembly.load_models(str(copy), device="cpu", **KW)


def test_load_models_refuses_a_missing_key_but_inits_the_identity_projections(root, tmp_path):
    import shutil

    copy = tmp_path / "sd"
    shutil.copytree(root, copy)
    f = copy / "unet" / "diffusion_pytorch_model.bin"
    sd = torch.load(f, weights_only=True)
    plain = {k: v for k, v in sd.items() if "processor" not in k}  # a plain SD UNet
    assert len(plain) < len(sd)
    torch.save(plain, f)
    _, models, _ = tassembly.load_models(str(copy), device="cpu", **KW)
    w = models.unet.mid_block.attentions[0].transformer_blocks[0].attn2.processor.to_k_ip[0].weight
    assert torch.isfinite(w).all() and w.abs().max() > 0  # from init_params
    assert torch.equal(models.unet.conv_in.weight, sd["conv_in.weight"])
    del plain["conv_in.weight"]
    torch.save(plain, f)
    with pytest.raises(KeyError, match="no source"):
        tassembly.load_models(str(copy), device="cpu", **KW)


def test_pt_checkpoint_reinjects_lora_and_matches_jax(root, tmp_path):
    """A LoRA-trained `.pt` and `.msgpack` written by the JAX package,
    loaded without LoRA flags: LoRA re-injected from the saved config, every
    weight of the bundle equal to the JAX loader's on the same files."""
    import jax.numpy as jnp

    from photoverse_tpu.ckpt.checkpoint import save_progress, save_progress_pt
    from photoverse_tpu.models.assembly import load_models as jax_load_models

    _, _, params, _ = jax_load_models(root, use_lora=True, lora_rank=2, **KW)
    blk = "down_0_attn_0"
    marked = np.full(params.unet[blk]["attn2"]["to_q"]["lora_B"].shape, 0.5, np.float32)
    params.unet[blk]["attn2"]["to_q"]["lora_B"] = jnp.asarray(marked)
    params.text_adapter = jax.tree.map(lambda x: x + 0.25, params.text_adapter)
    ck = str(tmp_path / "ck")
    save_progress_pt(ck, params, lora_config=LORA_CFG)
    save_progress(ck, params, lora_config=LORA_CFG)
    pt = os.path.join(ck, "photoverse.pt")

    assert tckpt.peek_lora_config(pt)["r"] == 2
    _, jmodules, jparams, jcfg = jax_load_models(root, photoverse_path=pt, **KW)
    _, models, tcfg = tassembly.load_models(root, photoverse_path=pt, device="cpu", **KW)
    assert tcfg == jcfg and int(tcfg["r"]) == 2
    assert models.unet.config.lora_rank == 2
    q = models.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn2.to_q
    np.testing.assert_array_equal(q.lora_B["default"].weight.numpy(), marked.T)
    names = LOADED + ("text_adapter", "image_adapter")
    want, got = _state(_port_of(jmodules, jparams), names), _state(models, names)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    # the native layout loads too, LoRA re-injected from its sidecar, and
    # gives the JAX loader's bundle on the same file
    native = os.path.join(ck, "photoverse.msgpack")
    _, jmodules, jparams, jcfg = jax_load_models(root, photoverse_path=native, **KW)
    _, models, ncfg = tassembly.load_models(root, photoverse_path=native, device="cpu", **KW)
    assert ncfg == jcfg == tcfg and models.unet.config.lora_rank == 2
    want, got = _state(_port_of(jmodules, jparams), names), _state(models, names)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_cast_params_rounds_through_bf16(root):
    _, models, _ = tassembly.load_models(root, device="cpu", **KW)
    before = models.unet.conv_in.weight.clone()
    tassembly.cast_params(models)
    after = models.unet.conv_in.weight
    assert after.dtype == torch.float32
    assert torch.equal(after, before.bfloat16().float()) and not torch.equal(after, before)
    _, bf, _ = tassembly.load_models(root, device="cpu", dtype=torch.bfloat16, **KW)
    w = bf.unet.conv_in.weight.clone()
    tassembly.cast_params(bf)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf.unet.conv_in.weight, w) and torch.equal(w.float(), after)
