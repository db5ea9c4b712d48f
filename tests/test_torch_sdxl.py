"""The SDXL route of the port on the CPU at a tiny SDXL shape
(tests/sdxl_tiny.py), in f32, against the plain reference in
benchmark/reference/sdxl_nets.py on the same weights: the UNet's eps with
added conditioning, both text encoders with the concept spliced in, one
request served by PhotoVerseService against the reference's generation;
the SD-1.5 bundle's modules unchanged; the flash route's plain path at
SDXL's head dim 64.

Tolerances: the port and the reference compute the same f32 arithmetic in
another order (fused attention sums, the linear projections' reshapes),
so they agree to a few f32 ulps of the largest value, taken at 1e-5 of it
(1e-4 for the UNet's eps, whose 14 products in series each add their
rounding); served images are compared in uint8 steps, where such a
difference flips at most one rounding: a gap of 1."""

import argparse

import numpy as np
import pytest
import torch

from benchmark.reference import nets, sdxl_nets
from photoverse_tpu_torch.engine.inference import sdxl_time_ids
from tests import sdxl_tiny as tiny


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two threads for this module's tiny products: more only wait on each
    other (a tiny UNet evaluation took 11 s on 8 busy cores, 0.08 s on
    one); the worker's setting comes back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle():
    return tiny.bundle(seed=3)


def _close(got, want, rel):
    scale = want.abs().max().item()
    return (got.float() - want.float()).abs().max().item() <= rel * scale


def _inputs(B=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return dict(sample=torch.randn(B, tiny.LATENT, tiny.LATENT, 4, generator=g),
                t=torch.tensor([999, 421][:B]),
                text=torch.randn(B, tiny.SEQ, 64, generator=g),
                idc=torch.randn(B, 1, 64, generator=g),
                pooled=torch.randn(B, 16, generator=g),
                tids=sdxl_time_ids(B, tiny.RES, "cpu"))


def test_unet_eps_with_added_conditioning_matches_the_reference(bundle):
    models, weights = bundle
    x = _inputs()
    with torch.no_grad():
        got, norms = models.unet(x["sample"], x["t"], x["text"], x["idc"], added_cond=(x["pooled"], x["tids"]))
        want = sdxl_nets.unet(nets.Weights(weights, "cpu"), nets.Numerics(), tiny.ref_cfg()["unet"], x["sample"],
                              x["t"], x["text"], x["idc"], x["pooled"], x["tids"])
    assert _close(got, want, 1e-4)
    # the added conditioning moves eps: the route is not a no-op
    with torch.no_grad():
        other, _ = models.unet(x["sample"], x["t"], x["text"], x["idc"], added_cond=(x["pooled"] * 0, x["tids"]))
    assert not _close(other, want, 1e-2)
    # one identity-norm vector a block, 8 heads each: down 1 + 2, mid 2, up 2 x 2 + 2 x 1 blocks
    assert len(models.unet.cross_attentions()) == 11 and norms.shape == (2, 11 * 8 * 1)
    with pytest.raises(ValueError, match="added conditioning"):
        models.unet(x["sample"], x["t"], x["text"], x["idc"])


def test_both_text_encoders_with_the_concept_spliced_match_the_reference(bundle):
    models, weights = bundle
    ex = tiny.example(2, seed=1)
    ids = torch.as_tensor(ex["text_input_ids"]).long()
    pidx = torch.as_tensor(ex["concept_placeholder_idx"]).long()
    W, N, rc = nets.Weights(weights, "cpu"), nets.Numerics(), tiny.ref_cfg()
    g = torch.Generator().manual_seed(2)
    for i, (enc, key, width) in enumerate([(models.text_encoder, "text_encoder", 24),
                                           (models.text_encoder_2, "text_encoder_2", 40)]):
        concept = torch.randn(2, 1, width, generator=g)
        with torch.no_grad():
            h, pooled = enc(ids, concept, pidx)
        want_h, want_pooled = sdxl_nets.text_encoder(W, N, key, rc["text" if i == 0 else "text_2"], ids, concept,
                                                     pidx)
        assert h.shape == (2, tiny.SEQ, width) and _close(h, want_h, 1e-5)
        assert _close(pooled, want_pooled, 1e-5)
    assert pooled.shape == (2, 16)  # the second encoder's pooled output is projected


@pytest.mark.parametrize("guidance", [1.0, 5.0])
def test_a_served_request_matches_the_reference_generation(bundle, guidance):
    from photoverse_tpu_torch.cli.serve import PhotoVerseService

    models, weights = bundle
    args = argparse.Namespace(
        sharding="none", model_path="", resolution=tiny.RES, cpu=True, dynamic_batching=True, max_batch=2,
        batch_wait_ms=5, max_queue=8, default_steps=2, native_tokenizer=False, fast=False,
        int8_conditioning=False, bf16_params=False, extra_num_tokens=0, encoder_layers_idx=[])
    svc = PhotoVerseService(args, models=(None, models))
    ex = tiny.example(2, seed=4)
    out = svc.submit(ex, 2, 11, (2, guidance, "dpm"))
    assert svc.drain(30) and out["batch_rows"] == 2
    noise = torch.randn((2, tiny.LATENT, tiny.LATENT, 4), generator=torch.Generator().manual_seed(11))
    ref_ex = dict(ex, add_time_ids=sdxl_nets.time_ids(2, tiny.RES))
    with torch.no_grad():
        want = sdxl_nets.generate(nets.Weights(weights, "cpu"), nets.Numerics(), tiny.ref_cfg(), ref_ex, noise, 2,
                                  guidance, "cpu")
    gap = np.abs(out["images"].astype(np.int32) - want.astype(np.int32))
    assert out["images"].shape == (2, tiny.RES, tiny.RES, 3) and gap.max() <= 1


def test_the_sd15_bundle_keeps_its_modules_and_parameters():
    import hashlib

    from photoverse_tpu_torch.models.assembly import build_models

    m = build_models(device="meta")
    names = [n for n, _ in m.named_parameters()]
    # the counts and names of the bundle before SDXL's options were added
    assert (sum(p.numel() for p in m.parameters()), len(names)) == (1446394283, 1753)
    assert hashlib.sha256("\n".join(names).encode()).hexdigest()[:16] == "b909c23a2a2f1e48"
    assert m.text_encoder_2 is None and m.text_adapter_2 is None and m.unet.add_embedding is None
    assert not m.sdxl and len(m.unet.cross_attentions()) == 16


def test_the_benchmarks_sdxl_file_builds_the_published_configs():
    # benchmark/configs/sdxl-photoverse-serve.json, read as the benchmark
    # reads it, gives the port's published SDXL widths (sdxl_configs) with
    # the serving flags
    import dataclasses
    import json
    import os

    from benchmark import serving_sdxl
    from photoverse_tpu_torch.models.assembly import sdxl_configs

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs", "sdxl-photoverse-serve.json")) as f:
        got = serving_sdxl._port_configs(json.load(f))
    want = sdxl_configs(lora_rank=128, use_flash_attention=True, fast_attention_scores=True, fast_norms=True)
    assert got["unet_config"] == dataclasses.replace(want["unet_config"], fused_blocks=True)
    for key in ("vae_config", "text_config", "text_config_2", "vision_config"):
        assert got[key] == want[key], key
    u = want["unet_config"]
    blocks = sum((2 * u.layers_per_block + 1) * u.depth(i) for i in range(3) if u.attends(i)) + u.depth(2)
    assert blocks == 70 and {c // u.heads(i) for i, c in enumerate(u.block_out_channels)} == {64}


def test_flash_sdpa_plain_path_at_head_dim_64():
    from photoverse_tpu_torch.ops import flash_sdpa as fs

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 80, 3, 64, generator=g) for _ in range(3))
    got = fs.flash_sdpa(q, k, v)
    want = torch.nn.functional.scaled_dot_product_attention(*(x.transpose(1, 2) for x in (q, k, v))).transpose(1, 2)
    assert got.shape == (2, 80, 3, 64) and _close(got, want, 1e-5)
    assert 64 in fs.KERNEL_HEAD_DIMS and 64 not in fs.BWD_HEAD_DIMS
