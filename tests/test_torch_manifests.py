"""The port's parameter names at SD-1.5 / CLIP-L width against the published
checkpoint inventories (photoverse_tpu_torch/convert/manifests.py), with
no weight file and no allocation: the port's modules are built on the meta
device and fed zero-stride stubs of every manifest key. Each loader of
convert/from_diffusers.py must read every manifest key, and every
parameter of its module must come from one, apart from the fresh
PhotoVerse parameters (from_diffusers.UNET_FROM_INIT). The manifests
themselves equal the JAX package's and give the published counts.
"""

import pytest
import torch

from photoverse_tpu.convert import manifests as jm
from photoverse_tpu_torch.convert import from_diffusers as fd
from photoverse_tpu_torch.convert import manifests as tm
from photoverse_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig, CLIPVisionEncoder
from photoverse_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from photoverse_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from tests.torch_threads import worker_threads  # noqa: F401

# the meta module's load_state_dict warns that copying into it is a no-op
pytestmark = pytest.mark.filterwarnings("ignore:for .*copying from a non-meta parameter")

FAMILIES = {
    "unet": (tm.sd15_unet_manifest, tm.SD15_UNET_PARAMS, lambda: UNet2DCondition(UNetConfig()), fd.load_unet),
    "vae": (tm.sd_vae_manifest, tm.SD_VAE_PARAMS, lambda: AutoencoderKL(VAEConfig()), fd.load_vae),
    "text": (tm.clip_text_manifest, tm.CLIP_TEXT_PARAMS, lambda: CLIPTextEncoder(CLIPTextConfig()),
             fd.load_clip_text),
    "vision": (tm.clip_vision_manifest, tm.CLIP_VISION_PARAMS, lambda: CLIPVisionEncoder(CLIPVisionConfig()),
               fd.load_clip_vision),
}


class _Recorder(dict):
    """A state dict that remembers which keys were read."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def _stubs(manifest):
    return _Recorder({k: torch.zeros(()).expand(shape) for k, shape in manifest.items()})


def test_manifests_equal_the_jax_packages_and_give_the_published_counts():
    pairs = [(tm.sd15_unet_manifest, jm.sd15_unet_manifest), (tm.sd_vae_manifest, jm.sd_vae_manifest),
             (tm.clip_text_manifest, jm.clip_text_manifest), (tm.clip_vision_manifest, jm.clip_vision_manifest)]
    for mine, theirs in pairs:
        assert list(mine().items()) == list(theirs().items())
    assert (tm.SD15_UNET_PARAMS, tm.SD_VAE_PARAMS, tm.CLIP_TEXT_PARAMS, tm.CLIP_VISION_PARAMS) == (
        859_520_964, 83_653_863, 123_060_480, 303_179_776)
    for make, count, _, _ in FAMILIES.values():
        assert tm.manifest_param_count(make()) == count


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loaders_consume_every_manifest_key_at_sd15_width(family):
    make, count, build, load = FAMILIES[family]
    manifest = make()
    with torch.device("meta"):
        module = build()
    sd = _stubs(manifest)
    load(module, sd)
    assert sd.read == set(manifest), sorted(set(manifest) - sd.read)[:5]
    own = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    from_init = {k for k in own if any(part in k for part in fd.UNET_FROM_INIT)} if family == "unet" else set()
    # every parameter but the fresh PhotoVerse ones has a manifest source of its shape
    sources = {}
    for key in set(own) - from_init:
        if family == "unet":
            cands = fd._unet_sources(key)
        elif family == "vae":
            cands = fd._vae_sources(key)
        else:
            cands = (("text_model." if family == "text" else "vision_model.") + key,)
        src = next((c for c in cands if c in manifest), None)
        assert src is not None, key
        assert tuple(manifest[src]) == own[key], (key, src)
        sources[key] = src
    assert sorted(sources.values()) == sorted(manifest)
    n_own = sum(p.numel() for p in module.parameters())
    n_fresh = sum(p.numel() for n, p in module.named_parameters() if n in from_init)
    assert n_own - n_fresh == count
    if family == "unet":  # the identity projections: 16 cross-attention layers, two c x 768 each
        assert n_fresh == 2 * 768 * (320 * 5 + 640 * 5 + 1280 * 6)


@pytest.mark.parametrize("fault", ["renamed", "missing", "extra"])
def test_a_wrong_inventory_is_refused(fault):
    manifest = tm.sd_vae_manifest()
    sd = {k: torch.zeros(()).expand(s) for k, s in manifest.items()}
    if fault == "renamed":
        sd["decoder.conv_out.kernel"] = sd.pop("decoder.conv_out.weight")
    elif fault == "missing":
        del sd["encoder.mid_block.attentions.0.to_q.weight"]
    else:
        sd["encoder.mystery.weight"] = torch.zeros(()).expand(3, 3)
    with torch.device("meta"):
        vae = AutoencoderKL(VAEConfig())
    with pytest.raises((KeyError, ValueError)):
        fd.load_vae(vae, sd)
