"""The hand-written CUDA kernels against their plain PyTorch versions on the
card. Marked `cuda`: they skip on a machine without an NVIDIA GPU. Run them
on the card with `python -m pytest --noconftest tests/test_torch_cuda.py -q`
(tests/conftest.py imports jax, which the card's machine does not have).

Inputs are bf16; the plain versions compute in f32 from the same bf16
tensors. The kernels accumulate in f32 (tensor-core products with bf16 or
bf16-pair operands) and round only their bf16 output. Tolerances: flash 2^-6 of
the largest |out| (2-4 bf16 ulps of it; 0.3*randn inputs give a near-uniform
softmax and small outputs, so an absolute limit would hide a dropped key
tile); the fused tail 1/32 on unit-scale activations (|out| < 8, one bf16
ulp). The lse forward and the flash backward take the same 2^-6 of the
largest |value| per output (lse, dq, dk, dv: bf16 outputs from f32 sums,
the backward's p and ds rounded to bf16 for its products); the autograd
Functions are held to gradients by
autograd through the plain f32 forward at the same limit. The channels-last
GroupNorm and its plain version both compute in f32 and round once, so
they may differ by one bf16 spacing (taken at 1/16 for smaller values).
The dual-context cross-attention is held to the f32 plain version by the
einsum route's own error on the same bf16 inputs: both round the
probabilities to bf16, and the kernel rounds its f32 sum once where the
einsum route rounds three times.
"""

import pytest
import torch

from photoverse_tpu_torch.ops import _build
from photoverse_tpu_torch.ops import dual_cross_attn as dca
from photoverse_tpu_torch.ops import flash_sdpa as fs
from photoverse_tpu_torch.ops import fused_block as fb
from photoverse_tpu_torch.ops import group_norm as gn
from photoverse_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _r(gen, *shape, scale=1.0):
    return (scale * torch.randn(*shape, generator=gen, device="cuda")).bfloat16()


def _flash_close(got, want):
    return (got.float() - want).abs().max().item() <= 2**-6 * want.abs().max().item()


@pytest.mark.parametrize("B,Sq,Skv,H,d", [
    (1, 100, 100, 2, 40),    # ragged tiles
    (2, 64, 200, 3, 80),     # Skv > Sq
    (1, 300, 77, 1, 512),    # the streaming head dim, short keys
])
def test_flash_kernel_matches_plain(gen, B, Sq, Skv, H, d):
    q = _r(gen, B, Sq, H, d, scale=0.3)
    k, v = _r(gen, B, Skv, H, d, scale=0.3), _r(gen, B, Skv, H, d, scale=0.3)
    with trace.counting("launch.") as launches:
        got = fs.flash_sdpa(q, k, v)
    torch.cuda.synchronize()
    assert launches.get("flash_sdpa") == 1
    want = fs.flash_sdpa_plain(q.float(), k.float(), v.float())
    assert _flash_close(got, want)


@pytest.mark.parametrize("d", [40, 64, 80])
@pytest.mark.parametrize("B,Sq,Skv,H", [
    (1, 1000, 4000, 2),   # neither length a multiple of the 64/128-row and 64-key tiles
    (4, 130, 77, 3),      # keys shorter than one tile, batch 4
    (1, 63, 65, 1),       # one ragged tile each way
    (4, 256, 256, 8),     # whole tiles, equal lengths
])
def test_wgmma_flash_kernel_ragged_lengths(gen, d, B, Sq, Skv, H):
    # with and without the lse output, against the plain version
    q = _r(gen, B, Sq, H, d, scale=0.3)
    k, v = _r(gen, B, Skv, H, d, scale=0.3), _r(gen, B, Skv, H, d, scale=0.3)
    want = fs.flash_sdpa_plain(q.float(), k.float(), v.float())
    got = fs.flash_sdpa(q, k, v)
    assert _flash_close(got, want)
    assert torch.equal(fs.flash_sdpa(q, k, v), got)  # repeat calls bit-identical
    if Sq == Skv:
        out, lse = fs.flash_fwd_lse(q, k, v)
        want_lse = fs.flash_fwd_lse_plain(q.float(), k.float(), v.float())[1]
        assert torch.equal(out, got)
        assert (lse - want_lse).abs().max().item() <= 2**-10


def _device_ms(fn, iters=20):
    """CUDA-event milliseconds a call of `fn`, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@pytest.mark.parametrize("B,S,H", [(8, 4096, 10), (8, 1024, 20)])
def test_flash_kernel_at_sdxl_shapes_against_plain_and_the_library(gen, B, S, H):
    # SDXL's self-attention at UNet batch 8 (4 rows under guidance), d = 64:
    # unit-scale inputs, against the plain f32 path (the 2^-6 rule and
    # about 1e-4 absolute), and no slower than 1.1 x one
    # scaled_dot_product_attention call on the same inputs
    q, k, v = (_r(gen, B, S, H, 64) for _ in range(3))
    with trace.counting("launch.") as launches:
        got = fs.flash_sdpa(q, k, v)
    want = fs.flash_sdpa_plain(q.float(), k.float(), v.float())
    assert launches.get("flash_sdpa") == 1 and _flash_close(got, want)
    err = (got.float() - want).abs().max().item()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ours = _device_ms(lambda: fs.flash_sdpa(q, k, v))
    lib = _device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))
    print(f"flash d=64 {(B, S, H)}: max err {err:.3g}, {ours:.4f} ms against the library's {lib:.4f} ms")
    assert ours <= 1.1 * lib


def test_sdxl_request_counts_its_d64_flash_launches(gen):
    # a tiny SDXL bundle served on the card with the flash route at a low
    # threshold: every self-attention of every UNet evaluation is one
    # `launch.flash_sdpa` (head dim 8 is not a kernel width, so a bundle at
    # head dim 64: 64 channels, one head)
    import importlib.util
    import os

    import numpy as np

    from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
    from photoverse_tpu_torch.engine.inference import run_inference

    # by path: the card's machine has another package named `tests`
    spec = importlib.util.spec_from_file_location(
        "sdxl_tiny", os.path.join(os.path.dirname(os.path.abspath(__file__)), "sdxl_tiny.py"))
    sdxl_tiny = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sdxl_tiny)

    models, _ = sdxl_tiny.bundle(device="cuda", dtype=torch.bfloat16, use_flash_attention=True, flash_min_seq=16,
                                 level_heads=(1, 1, 1), num_heads=1)
    steps = 2
    solver = DPMSolverMultistep.create(models.schedule, steps)
    with trace.counting("launch.") as launches:
        out = run_inference(models, solver, sdxl_tiny.example(2), guidance_scale=5.0, latent_size=sdxl_tiny.LATENT,
                            initial_noise=np.zeros((2, sdxl_tiny.LATENT, sdxl_tiny.LATENT, 4), np.float32))
        torch.cuda.synchronize()
    # 11 blocks, each at S = 64 or 16 tokens >= 16; one launch a block a step
    assert launches.get("flash_sdpa") == 11 * steps and torch.isfinite(out).all()


def test_flash_kernel_refuses_layouts_tma_cannot_read(gen):
    q = _r(gen, 1, 64, 2, 40)
    odd = torch.zeros(1, 64, 2, 44, device="cuda", dtype=torch.bfloat16)[..., :40]  # 88-byte head stride
    with pytest.raises(ValueError, match="aligned"):
        fs.flash_sdpa(odd, q, q)
    with pytest.raises(ValueError, match="aligned"):
        fs.flash_sdpa(q, q, odd)


def test_flash_kernel_reads_strided_inputs(gen):
    qkv = _r(gen, 2, 128, 3, 4, 40, scale=0.3)  # a packed (B, S, 3, H, d) projection
    q, k, v = qkv.unbind(dim=2)
    got = fs.flash_sdpa(q, k, v)
    want = fs.flash_sdpa_plain(q.float(), k.float(), v.float())
    assert _flash_close(got, want)


def test_flash_stream_kernel_matches_plain(gen):
    q, k, v = (_r(gen, 1, 256, 1, 512, scale=0.3) for _ in range(3))
    got = fs.flash_sdpa_stream(q, k, v)
    want = fs.flash_sdpa_plain(q.float(), k.float(), v.float())
    assert _flash_close(got, want)


@pytest.mark.parametrize("B,Sq,Skv,H", [
    (1, 1000, 4000, 1),   # keys longer than queries, a last tile shorter than a 64-row box
    (1, 77, 77, 1),       # fewer rows than one block, one full and one ragged tile
    (2, 63, 65, 2),       # one ragged tile each way, two heads
    (1, 300, 31, 1),      # keys shorter than one tile
])
def test_flash_stream_kernel_ragged_lengths(gen, B, Sq, Skv, H):
    # the d=512 kernel with and without its lse output, against the plain version
    q = _r(gen, B, Sq, H, 512, scale=0.3)
    k, v = _r(gen, B, Skv, H, 512, scale=0.3), _r(gen, B, Skv, H, 512, scale=0.3)
    want, want_lse = fs.flash_fwd_lse_plain(q.float(), k.float(), v.float())
    with trace.counting("launch.") as launches:
        got = fs.flash_sdpa_stream(q, k, v)
    assert launches.get("flash_sdpa_stream") == 1
    assert _flash_close(got, want)
    assert torch.equal(fs.flash_sdpa_stream(q, k, v), got)  # repeat calls bit-identical
    out, lse = fs.flash_fwd_lse(q, k, v)
    assert torch.equal(out, got)
    assert (lse - want_lse).abs().max().item() <= 2**-10


def test_flash_stream_kernel_reads_strided_inputs_and_refuses_what_tma_cannot_read(gen):
    qkv = _r(gen, 2, 130, 3, 1, 512, scale=0.3)  # a packed (B, S, 3, H, d) projection
    q, k, v = qkv.unbind(dim=2)
    got = fs.flash_sdpa_stream(q, k, v)
    assert _flash_close(got, fs.flash_sdpa_plain(q.float(), k.float(), v.float()))
    odd = torch.zeros(2, 130, 1, 516, device="cuda", dtype=torch.bfloat16)[..., 4:]  # 8-byte offset
    with pytest.raises(ValueError, match="aligned"):
        fs.flash_sdpa_stream(odd, k, v)
    with pytest.raises(ValueError, match="aligned"):
        fs.flash_fwd_lse(q, k, odd)


def test_kernel_rejects_other_dtypes_and_head_dims(gen):
    q = torch.zeros(1, 8, 1, 40, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        fs.flash_sdpa(q, q, q)
    q = torch.zeros(1, 8, 1, 48, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        fs.flash_sdpa(q, q, q)
    q = torch.zeros(1, 8, 1, 41, device="cuda", dtype=torch.bfloat16)[..., 1:]  # 2-byte offset
    with pytest.raises(ValueError, match="aligned"):
        fs.flash_sdpa(q, q, q)


def _fused_case(gen, B, S, St, K):
    C, H, F = 320, 8, 1280
    d = C // H
    vec = lambda n, base=0.0: base + 0.1 * torch.randn(n, generator=gen, device="cuda")  # noqa: E731
    bundle = {  # every matrix (out, in), as build_block_bundle stages them
        "ln2g": vec(C, 1.0), "ln2b": vec(C), "wq": _r(gen, C, C, scale=C**-0.5),
        "wout": _r(gen, C, C, scale=C**-0.5), "bout": vec(C),
        "ln3g": vec(C, 1.0), "ln3b": vec(C),
        "wpa": _r(gen, F, C, scale=C**-0.5), "wpg": _r(gen, F, C, scale=C**-0.5),
        "bpa": vec(F), "bpg": vec(F), "wo": _r(gen, C, F, scale=F**-0.5), "bo": vec(C),
        "ctx": tuple(_r(gen, B, H, n, d) for n in (St, St, K, K)),
    }
    return _r(gen, B, S, C), bundle, H


@pytest.mark.parametrize("B,S,K,St", [(2, 100, 1, 77), (1, 64, 5, 77), (2, 64, 1, 7), (1, 1000, 5, 77),
                                       (4, 130, 8, 80)])
def test_fused_kernel_matches_plain(gen, B, S, K, St):
    # S that is no multiple of the 64-token block, K = 1 and 5 (and the
    # kernel's limits 8 and 80), a short text context
    h, bundle, H = _fused_case(gen, B, S, St, K)
    assert all(bundle[k].dtype == torch.float32 for k in ("ln2g", "bo", "bpa"))
    with trace.counting("launch.") as launches:
        got = fb.fused_cross_ff(h, bundle, H)
    torch.cuda.synchronize()
    assert launches.get("fused_cross_ff") == 1
    want = fb.reference_cross_ff(h.float(), bundle, H)
    assert (got.float() - want).abs().max().item() <= 1 / 32
    assert torch.equal(fb.fused_cross_ff(h, bundle, H), got)  # repeat calls bit-identical


def test_fused_kernel_refuses_other_widths(gen):
    h, bundle, H = _fused_case(gen, 1, 64, 77, 1)
    with pytest.raises(ValueError, match="built for"):
        fb.fused_cross_ff(h, dict(bundle, ctx=tuple(_r(gen, 1, H, n, 40) for n in (81, 81, 1, 1))), H)
    with pytest.raises(ValueError, match="built for"):
        fb.fused_cross_ff(h, dict(bundle, ctx=tuple(_r(gen, 1, H, n, 40) for n in (77, 77, 9, 9))), H)
    with pytest.raises(ValueError, match="shape"):
        fb.fused_cross_ff(h, dict(bundle, wq=bundle["wq"].reshape(8, 320, 40)), H)


def test_fused_blocks_at_a_width_the_kernel_lacks_keep_the_unfused_tail(gen):
    # a narrow UNet with fused_blocks on the card: no layer is routed to the
    # CUDA kernel (built for C = 320, 8 heads), and a step runs without it
    import types

    from photoverse_tpu_torch.engine import inference
    from photoverse_tpu_torch.models.unet import UNet2DCondition, UNetConfig

    cfg = UNetConfig(block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=24,
                     num_heads=4, norm_num_groups=8, fused_blocks=True)
    with torch.device("cuda"):
        net = UNet2DCondition(cfg).to(torch.bfloat16).eval().requires_grad_(False)
    models = types.SimpleNamespace(unet=net, dtype=torch.bfloat16)
    text, ident = _r(gen, 2, 7, 24), _r(gen, 2, 1, 24)
    kv = inference.precompute_ctx_kv(models, text, ident)
    bundles = inference.precompute_fused_bundles(models, kv)
    assert all(b is None for b in bundles)
    with torch.no_grad(), trace.counting("launch.") as launches:
        out = net(_r(gen, 2, 8, 8, 4), torch.tensor([10, 10], device="cuda"), text, ident,
                  ctx_kv=kv, fused_bundles=bundles)
    out = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(out.float()).all()
    assert "fused_cross_ff" not in launches


@pytest.mark.parametrize("B,S,H,d", [(1, 100, 2, 40), (2, 256, 2, 80), (1, 200, 1, 512)])
def test_flash_fwd_lse_kernel_matches_plain(gen, B, S, H, d):
    q, k, v = (_r(gen, B, S, H, d, scale=0.3) for _ in range(3))
    counter = "flash_stream_fwd_lse" if d == 512 else "flash_sdpa_fwd_lse"
    with trace.counting("launch.") as launches:
        out, lse = fs.flash_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    assert launches.get(counter) == 1
    want_out, want_lse = fs.flash_fwd_lse_plain(q.float(), k.float(), v.float())
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert _flash_close(out, want_out) and _flash_close(lse, want_lse)


def _bwd_inputs(gen, B, S, H, d):
    q, k, v = (_r(gen, B, S, H, d, scale=0.3) for _ in range(3))
    out, lse = fs.flash_fwd_lse_plain(q, k, v)
    return q, k, v, out, lse, _r(gen, B, S, H, d)


@pytest.mark.parametrize("B,S,H,d", [(1, 100, 2, 40), (2, 256, 3, 80), (1, 64, 1, 40)])
def test_flash_bwd_kernel_matches_plain(gen, B, S, H, d):
    args = _bwd_inputs(gen, B, S, H, d)
    with trace.counting("launch.") as launches:
        got = fs.flash_bwd(*args)
    torch.cuda.synchronize()
    assert launches.get("flash_bwd") == 1
    want = fs.flash_bwd_plain(*(a.float() for a in args))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == (B, S, H, d)
        assert _flash_close(g, w)


@pytest.mark.parametrize("B,S,H,d", [
    (1, 1000, 8, 40),   # no multiple of the 64-row tiles or of the 128- and 192-row blocks
    (4, 333, 8, 80),    # batch 4, a last tile of 13 rows
    (1, 77, 8, 80),     # fewer rows than one block
    (2, 193, 2, 40),    # one row past a 192-row block
])
def test_flash_bwd_kernel_ragged_lengths(gen, B, S, H, d):
    q, k, v = (_r(gen, B, S, H, d) for _ in range(3))  # unit scale: a peaked softmax
    out, lse = fs.flash_fwd_lse_plain(q, k, v)
    args = (q, k, v, out, lse, _r(gen, B, S, H, d))
    got = fs.flash_bwd(*args)
    want = fs.flash_bwd_plain(*(a.float() for a in args))
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all() and _flash_close(g, w)
    assert all(torch.equal(a, b) for a, b in zip(got, fs.flash_bwd(*args)))  # bit-identical repeat


def test_flash_bwd_reads_strided_inputs(gen):
    qkv = _r(gen, 2, 200, 3, 4, 80, scale=0.3)  # a packed (B, S, 3, H, d) projection
    q, k, v = qkv.unbind(dim=2)
    out, lse = fs.flash_fwd_lse_plain(q, k, v)
    g = _r(gen, 2, 200, 8, 80)[:, :, ::2]  # not contiguous: the wrapper copies it
    got = fs.flash_bwd(q, k, v, out, lse, g)
    want = fs.flash_bwd_plain(*(a.float() for a in (q, k, v, out)), lse, g.float())
    for a, w in zip(got, want):
        assert a.is_contiguous() and _flash_close(a, w)


def test_flash_bwd_refuses_layouts_tma_cannot_read(gen):
    q, k, v, out, lse, g = _bwd_inputs(gen, 1, 64, 2, 40)
    odd = torch.zeros(1, 64, 2, 44, device="cuda", dtype=torch.bfloat16)[..., :40]  # 88-byte head stride
    for args in ((odd, k, v), (q, odd, v), (q, k, odd)):
        with pytest.raises(ValueError, match="aligned"):
            fs.flash_bwd(*args, out, lse, g)
    fs.flash_bwd(q, k, v, out, lse, odd)  # g is copied into a layout TMA reads


def test_flash_bwd_is_deterministic(gen):
    args = _bwd_inputs(gen, 2, 192, 2, 80)
    first = fs.flash_bwd(*args)
    again = fs.flash_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_bwd_refuses_unequal_lengths(gen):
    q, k = _r(gen, 1, 64, 1, 40), _r(gen, 1, 128, 1, 40)
    lse = torch.zeros(1, 1, 64, device="cuda")
    with pytest.raises(ValueError, match="equal"):
        fs.flash_bwd(q, k, k, q, lse, q)
    with pytest.raises(ValueError, match="equal"):
        fs.flash_sdpa_diff(q, k, k)


@pytest.mark.parametrize("diff,S,H,d", [
    (fs.flash_sdpa_diff, 100, 2, 40), (fs.flash_sdpa_diff, 128, 2, 80),
    (fs.flash_sdpa_stream_diff, 130, 1, 512),
    (fs.flash_sdpa_diff, 333, 3, 40), (fs.flash_sdpa_diff, 1000, 2, 80),
    (fs.flash_sdpa_stream_diff, 77, 1, 512),
])
def test_autograd_functions_match_autograd_through_plain(gen, diff, S, H, d):
    # the fault this guards against: a kernel output written into a fresh
    # buffer has no grad_fn, so gradients would stop at the layer silently
    q, k, v = (_r(gen, 2, S, H, d, scale=0.3).requires_grad_() for _ in range(3))
    w = torch.randn(2, S, H, d, generator=gen, device="cuda")
    out = diff(q, k, v)
    assert out.grad_fn is not None
    (out.float() * w).sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (fs.flash_sdpa_plain(q, k, v).float() * w).sum().backward()
    for g, t in zip(got, (q, k, v)):
        assert _flash_close(g, t.grad.float())


def test_no_grad_kernels_refuse_grad(gen):
    q = _r(gen, 1, 64, 1, 40).requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        fs.flash_sdpa(q, q, q)
    with pytest.raises(RuntimeError, match="no gradient"):
        fs.flash_sdpa_stream(q, q, q)
    with torch.no_grad():
        assert fs.flash_sdpa(q, q, q).shape == q.shape


def test_fused_kernel_refuses_grad(gen):
    h, bundle, H = _fused_case(gen, 1, 64, 7, 1)
    h.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fb.fused_cross_ff(h, bundle, H)
    with torch.no_grad():
        assert fb.fused_cross_ff(h, bundle, H).shape == h.shape


# ---------------------------------------------------------------------------
# the serving entry points on the card, at a narrow width: every flash and
# fused layer of this bundle is routed to its kernel (UNet levels of 320
# and 640 channels with 8 heads, a 512-channel VAE mid block, 64px images)

import contextlib
from unittest import mock

import numpy as np


def _narrow_bundle():
    from photoverse_tpu_torch.models.assembly import build_models, init_params
    from photoverse_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig
    from photoverse_tpu_torch.models.unet import UNetConfig
    from photoverse_tpu_torch.models.vae import VAEConfig

    return init_params(build_models(
        dtype=torch.bfloat16,
        unet_config=UNetConfig(block_out_channels=(320, 640), layers_per_block=1, cross_attention_dim=64,
                               num_heads=8, use_flash_attention=True, flash_min_seq=256,
                               fast_attention_scores=True, fast_norms=True, fused_blocks=True),
        vae_config=VAEConfig(block_out_channels=(32, 512), layers_per_block=1, use_flash_attention=True,
                             fast_norms=True),
        text_config=CLIPTextConfig(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
                                   intermediate_size=128, max_position_embeddings=16),
        vision_config=CLIPVisionConfig(hidden_size=32, num_layers=4, num_heads=2, intermediate_size=64,
                                       image_size=16, patch_size=8),
        image_encoder_layers_idx=(1, 2, 3, 4)), seed=0)


def _narrow_example(B, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 62, (B, 16))
    ids[:, 0], ids[:, -1] = 62, 63
    return {
        "pixel_values": rng.randn(B, 64, 64, 3).astype(np.float32).clip(-1, 1),
        "pixel_values_clip": rng.randn(B, 16, 16, 3).astype(np.float32),
        "text_input_ids": ids.astype(np.int32),
        "concept_placeholder_idx": np.full((B,), 3, np.int32),
        "negative_text_input_ids": np.tile(np.array([62] + [63] * 15, np.int32), (B, 1)),
    }


def _norms(module) -> int:
    """GroupNorms in `module`: the group_norm_nhwc calls of its no-grad
    forward."""
    from photoverse_tpu_torch.models.layers import GroupNorm

    return sum(isinstance(m, GroupNorm) for m in module.modules())


@contextlib.contextmanager
def _plain_kernels():
    from photoverse_tpu_torch.models import layers, unet, vae

    with mock.patch.object(layers, "group_norm_nhwc", gn.group_norm_nhwc_plain), \
            mock.patch.object(unet, "flash_sdpa", fs.flash_sdpa_plain), \
            mock.patch.object(unet, "fused_cross_ff", fb.reference_cross_ff), \
            mock.patch.object(unet, "dual_cross_attention", dca.dual_cross_attention_plain), \
            mock.patch.object(vae, "flash_sdpa_stream", fs.flash_sdpa_plain):
        yield


def test_masked_unet_evaluation_kernels_against_plain(gen):
    # a mask keeps flash self-attention and turns the fused tail off
    from photoverse_tpu_torch.engine import inference

    models = _narrow_bundle()
    B = 2
    lat = torch.randn(B, 32, 32, 4, generator=gen, device="cuda")
    text, ident = _r(gen, B, 16, 64), _r(gen, B, 1, 64)
    mask = torch.zeros(B, 64, 64, device="cuda")
    mask[:, :, 32:] = 1.0
    t = torch.tensor([500.5, 20.0], device="cuda")
    kv = inference.precompute_ctx_kv(models, text, ident)
    bundles = inference.precompute_fused_bundles(models, kv)
    assert sum(b is not None for b in bundles) == 3  # the C=320 blocks are served, the C=640 mid block not
    with torch.no_grad():
        with trace.counting("launch.") as free_counts:
            with trace.counting("launch.") as counts:
                got, _ = models.unet(lat, t, text, ident, ctx_kv=kv, fused_bundles=bundles, ip_mask=mask)
            free, _ = models.unet(lat, t, text, ident, ctx_kv=kv, fused_bundles=bundles)
        with _plain_kernels():
            want, _ = models.unet(lat, t, text, ident, ctx_kv=kv, fused_bundles=bundles, ip_mask=mask)
    n = _norms(models.unet)
    assert counts == {"flash_sdpa": 4, "group_norm_nhwc": n}  # S=1024 down and twice up, S=256 mid
    # without the mask the C=640 mid block's cross-attention takes its kernel
    assert free_counts == {"flash_sdpa": 8, "fused_cross_ff": 3, "dual_cross_attn": 1, "group_norm_nhwc": 2 * n}
    assert torch.isfinite(got).all()
    scale = want.abs().max().item()
    print(f"masked eval kernels vs plain {(got - want).abs().max().item():.6g} of {scale:.6g}, "
          f"mask vs none {(got - free).abs().max().item():.6g}")
    assert (got - want).abs().max().item() <= 2**-5 * scale  # bf16 activations, one evaluation
    assert (got - free).abs().max().item() > 2**-3 * scale  # the mask acts


def test_euler_a_run_kernels_against_plain(gen):
    from photoverse_tpu_torch.core.schedulers import make_solver
    from photoverse_tpu_torch.engine.inference import run_inference

    models = _narrow_bundle()
    solver = make_solver(models.schedule, "euler_a", 3)
    example = _narrow_example(2)
    kw = dict(guidance_scale=2.0, latent_size=32)
    with trace.counting("launch.") as counts:
        got = run_inference(models, solver, example, torch.Generator(device="cuda").manual_seed(4), **kw)
    with _plain_kernels():
        want = run_inference(models, solver, example, torch.Generator(device="cuda").manual_seed(4), **kw)
    other = run_inference(models, solver, example, torch.Generator(device="cuda").manual_seed(5), **kw)
    norms = 3 * _norms(models.unet) + _norms(models.vae.decoder)
    assert counts == {"flash_sdpa": 12, "fused_cross_ff": 9, "dual_cross_attn": 3, "flash_sdpa_stream": 1,
                      "group_norm_nhwc": norms}
    assert got.shape == (2, 64, 64, 3) and torch.isfinite(got).all()
    diff, seeds = (got - want).abs().max().item(), (got - other).abs().max().item()
    print(f"euler_a kernels vs plain {diff:.6g}, seed 4 vs seed 5 {seeds:.6g}")
    assert diff <= 0.1 and seeds > 2 * diff  # the guidance limit of the smoke run's pipeline phase


def test_service_worker_thread_launches_kernels_and_reuses_the_build(gen, tmp_path):
    import json
    import os

    from photoverse_tpu_torch.cli.serve import PhotoVerseService, build_parser
    from photoverse_tpu_torch.data.tokenizer import CLIPTokenizer

    vocab = {c + w: i for i, (c, w) in enumerate((c, w) for c in "abcdefghijklmnopqrstuvwxyz*" for w in ("", "</w>"))}
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 62, 63
    (tmp_path / "tokenizer").mkdir()
    (tmp_path / "tokenizer" / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "tokenizer" / "merges.txt").write_text("#version: 0.2\n")
    (tmp_path / "tokenizer" / "tokenizer_config.json").write_text(json.dumps({"model_max_length": 16}))
    tok = CLIPTokenizer.from_pretrained(str(tmp_path))
    models = _narrow_bundle()
    args = build_parser().parse_args(["--model_path", "unused", "--resolution", "64", "--fast",
                                      "--dynamic_batching", "--max_batch", "2", "--batch_wait_ms", "2000"])
    so = os.path.join(_build.BUILD_DIR, _build.LIB_NAME)
    built = os.path.getmtime(so)
    svc = PhotoVerseService(args, models=(tok, models))
    key = (3, 2.0, "euler_a")
    import threading

    out = {}

    def fire(seed):
        out[seed] = svc.submit(_narrow_example(1, seed), 1, seed, key)

    threads = [threading.Thread(target=fire, args=(s,)) for s in (3, 7)]
    with trace.counting("launch.") as launches:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert out[3]["batch_rows"] == out[7]["batch_rows"] == 2
    norms = 3 * _norms(models.unet) + _norms(models.vae.decoder)
    assert launches == {"flash_sdpa": 12, "fused_cross_ff": 9, "dual_cross_attn": 3, "flash_sdpa_stream": 1,
                        "group_norm_nhwc": norms}
    assert out[3]["images"].shape == (1, 64, 64, 3) and out[3]["images"].dtype == np.uint8
    assert not svc.thread_errors and svc.drain(30)

    # a second service in the same process: the same library, no rebuild,
    # and each request equals its coalesced run within uint8 rounding
    seq = PhotoVerseService(build_parser().parse_args(["--model_path", "unused", "--resolution", "64", "--fast"]),
                            models=(tok, models))
    assert os.path.getmtime(so) == built
    for seed in (3, 7):
        solo = seq.submit(_narrow_example(1, seed), 1, seed, key)["images"].astype(int)
        print(f"seed {seed}: coalesced vs solo {np.abs(solo - out[seed]['images'].astype(int)).max()} / 255")
        assert np.abs(solo - out[seed]["images"].astype(int)).max() <= 8
    assert np.abs(out[3]["images"].astype(int) - out[7]["images"].astype(int)).max() > 16


@pytest.mark.parametrize("M,K,N", [(154, 768, 768), (2 * 257, 1024, 4096), (3, 768, 3072)])
def test_int8_product_on_the_card_equals_the_plain_product(gen, M, K, N):
    # the conditioning encoders' shapes (CLIP-L text and ViT-L/14 at batch
    # 2) and fewer rows than torch._int_mm takes (padded): integer
    # products, so the accumulators must be equal, not close
    from photoverse_tpu_torch.ops import quant

    x_q = torch.randint(-127, 128, (M, K), generator=gen, device="cuda").to(torch.int8)
    w_q = torch.randint(-127, 128, (N, K), generator=gen, device="cuda").to(torch.int8)
    with trace.counting("launch.") as launches:
        got = quant.int8_product(x_q, w_q)
    torch.cuda.synchronize()
    assert launches.get("int8_matmul") == 1
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got.cpu(), quant.int8_product(x_q.cpu(), w_q.cpu()))
    # the whole route: the same codes and scales as the CPU's (the JAX
    # package's numerics), so the same f32 output
    x = torch.randn(M, K, generator=gen, device="cuda")
    w = torch.randn(N, K, generator=gen, device="cuda") / 32
    b = torch.randn(N, generator=gen, device="cuda")
    for f, t in ((quant.quantize_activation, x), (quant.quantize_weight, w)):
        for card, host in zip(f(t), f(t.cpu())):
            assert torch.equal(card.cpu(), host)
    assert torch.equal(quant.int8_matmul(x, w, b, torch.float32).cpu(),
                       quant.int8_matmul(x.cpu(), w.cpu(), b.cpu(), torch.float32))
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int8_product(x_q[:, :K - 4].contiguous(), w_q[:, :K - 4].contiguous())


def _gn_steps(got, want) -> float:
    """The largest |got - want| in units of the bf16 spacing at |want|, or
    at 1/16 for smaller values."""
    w = want.float()
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0**-4))) - 7)
    return ((got.float() - w).abs() / step).max().item()


@pytest.mark.parametrize("N,C,G,HW,add,silu,dtype,wdtype", [
    (16, 2560, 32, 8, True, True, torch.bfloat16, torch.bfloat16),  # the UNet's widest concatenation
    (16, 320, 32, 64, True, True, torch.bfloat16, torch.bfloat16),  # its first level at batch 16: norm2
    (16, 320, 32, 64, False, False, torch.bfloat16, torch.bfloat16),  # Transformer2D's norm
    (1, 128, 32, 512, False, True, torch.bfloat16, torch.bfloat16),  # the VAE decoder's last level
    (8, 128, 32, 512, False, True, torch.bfloat16, torch.bfloat16),  # ... at batch 8
    (2, 1920, 32, 16, True, True, torch.bfloat16, torch.float32),  # f32 norm weights
    (2, 64, 32, 9, True, True, torch.float32, torch.float32),  # an f32 model: 4-wide f32 vectors
    (3, 36, 4, 7, True, True, torch.bfloat16, torch.bfloat16),  # C no multiple of 8: scalar loads
])
def test_group_norm_kernel_matches_plain(gen, N, C, G, HW, add, silu, dtype, wdtype):
    x = (1.5 + 2 * torch.randn(N, HW, HW, C, generator=gen, device="cuda")).to(dtype).permute(0, 3, 1, 2)
    w = (1 + 0.3 * torch.randn(C, generator=gen, device="cuda")).to(wdtype)
    b = (0.3 * torch.randn(C, generator=gen, device="cuda")).to(wdtype)
    t = torch.randn(N, C, generator=gen, device="cuda").to(dtype) if add else None
    with trace.counting("launch.") as launches:
        got = gn.group_norm_nhwc(x, w, b, G, 1e-5, t, silu)
    torch.cuda.synchronize()
    assert launches == {"group_norm_nhwc": 1}
    assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous(memory_format=torch.channels_last)
    want = gn.group_norm_nhwc_plain(x, w, b, G, 1e-5, t, silu)
    steps = _gn_steps(got, want)
    print(f"group_norm_nhwc {[N, C, G, HW]}: {steps} bf16 spacings from plain")
    assert steps <= (2**-6 if dtype == torch.float32 else 1)  # f32 out: summation order only
    assert torch.equal(got, gn.group_norm_nhwc(x, w, b, G, 1e-5, t, silu))  # no atomics: the same bits
    if add:  # the add acts
        assert _gn_steps(gn.group_norm_nhwc(x, w, b, G, 1e-5, None, silu), want) > 4


def test_group_norm_kernel_refuses_what_it_cannot_read(gen):
    x = _r(gen, 2, 8, 8, 64).permute(0, 3, 1, 2)
    w = torch.ones(64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="channels_last"):
        gn.group_norm_nhwc(x.contiguous(), w, w, 32, 1e-5)
    with pytest.raises(TypeError, match="bf16 or f32"):
        gn.group_norm_nhwc(x.half(), w, w, 32, 1e-5)
    with pytest.raises(ValueError, match="groups"):
        gn.group_norm_nhwc(x, w, w, 24, 1e-5)
    with pytest.raises(ValueError, match="add must be"):
        gn.group_norm_nhwc(x, w, w, 32, 1e-5, add=torch.zeros(2, 64, device="cuda"))


def test_no_grad_unet_at_batch_16_keeps_channels_last_throughout(gen):
    # the UNet as the serving cells run it: SD-1.5 widths, bf16, the flash
    # routes, batch 16 at 64^2; built by build_models, which leaves its
    # convolution weights channels_last. One no-grad call after a warm-up:
    # every GroupNorm takes the channels-last kernel, and no device kernel
    # converts a layout or computes torch's GroupNorm moments
    from torch.profiler import ProfilerActivity, profile

    from photoverse_tpu_torch.models.assembly import build_models
    from photoverse_tpu_torch.models.unet import UNetConfig

    unet = build_models(dtype=torch.bfloat16, unet_config=UNetConfig(
        use_flash_attention=True, fast_attention_scores=True, fast_norms=True)).unet
    with torch.no_grad():
        for p in unet.parameters():
            p.normal_(0, 0.02, generator=gen)
    B = 16
    args = (torch.randn(B, 64, 64, 4, generator=gen, device="cuda"), torch.full((B,), 500, device="cuda"),
            _r(gen, B, 77, 768), _r(gen, B, 5, 768))
    with torch.no_grad():
        unet(*args)
        torch.cuda.synchronize()
        with trace.counting("launch.") as launches, profile(activities=[ProfilerActivity.CUDA]) as prof:
            eps, _ = unet(*args)
            torch.cuda.synchronize()
    kernels = {e.key: e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}
    attr = "self_device_time_total" if hasattr(next(iter(kernels.values())), "self_device_time_total") \
        else "self_cuda_time_total"
    top = sorted(kernels.items(), key=lambda kv: -getattr(kv[1], attr))[:12]
    print("UNet batch 16, device us by kernel: " + "; ".join(f"{k[:60]} {getattr(e, attr):.0f}" for k, e in top))
    assert launches.get("group_norm_nhwc") == _norms(unet) == 61
    assert not [k for k in kernels if "nchwToNhwc" in k or "nhwcToNchw" in k]
    assert not [k for k in kernels if "RowwiseMoments" in k]
    assert torch.isfinite(eps).all()


# ---------------------------------------------------------------------------
# the dual-context cross-attention kernel


def _dual_case(gen, B, S, H, d, St, K):
    return (_r(gen, B, S, H, d), _r(gen, B, St, H, d), _r(gen, B, St, H, d), _r(gen, B, K, H, d),
            _r(gen, B, K, H, d))


def _dual_errors(ts):
    """(kernel output, its max abs error, the einsum route's) against the
    plain version in f32 on the same bf16 inputs; one launch a call."""
    want = dca.dual_cross_attention_plain(*(t.float() for t in ts))
    route = dca.dual_cross_attention_plain(*ts)
    with trace.counting("launch.") as launches:
        got = dca.dual_cross_attention(*ts)
    torch.cuda.synchronize()
    assert launches == {"dual_cross_attn": 1}
    assert got.shape == ts[0].shape and got.dtype == torch.bfloat16
    return got, (got.float() - want).abs().max().item(), (route.float() - want).abs().max().item()


@pytest.mark.parametrize("B,S,H,d", [
    (8, 4096, 10, 64), (8, 1024, 20, 64),                   # SDXL at UNet batch 8
    (16, 1024, 8, 80), (16, 256, 8, 160), (16, 64, 8, 160),  # SD-1.5 serving at batch 16, the mid block last
    (8, 4096, 8, 40),                                        # training's face prefix
])
def test_dual_cross_kernel_at_the_unets_shapes(gen, B, S, H, d):
    # 77 text and 4 identity rows, unit-scale inputs: no larger error than
    # the einsum route's, repeat calls bit-identical, and faster than it
    ts = _dual_case(gen, B, S, H, d, 77, 4)
    got, err, route_err = _dual_errors(ts)
    ours = _device_ms(lambda: dca.dual_cross_attention(*ts))
    route = _device_ms(lambda: dca.dual_cross_attention_plain(*ts))
    print(f"dual cross {(B, S, H, d)}: max err {err:.3g} (einsum route {route_err:.3g}), "
          f"{ours:.4f} ms against the einsum route's {route:.4f} ms")
    assert err <= route_err
    assert torch.equal(dca.dual_cross_attention(*ts), got)
    assert ours < route


@pytest.mark.parametrize("d", [40, 64, 80, 160])
@pytest.mark.parametrize("St,K", [(1, 1), (7, 3), (16, 8), (33, 5), (64, 2), (79, 7), (80, 8)])
def test_dual_cross_kernel_ragged_contexts(gen, d, St, K):
    # 1-80 text and 1-8 identity rows, and 2100 query rows: no multiple of
    # the 128-row block or of a warp's 16
    ts = _dual_case(gen, 2, 2100, 3, d, St, K)
    got, err, route_err = _dual_errors(ts)
    assert err <= route_err
    assert torch.equal(dca.dual_cross_attention(*ts), got)


def test_dual_cross_kernel_reads_strided_inputs_and_refuses_what_it_cannot(gen):
    # the context as a slice of a wider buffer and q as a view of the
    # projection's rows: read in place; an odd offset, another dtype or
    # shape raises
    B, S, H, d = 2, 200, 4, 64
    q = _r(gen, B, S, 2, H, d)[:, :, 1]
    wide = _r(gen, B, 77, H, 2 * d)
    k, v = wide[..., :d], wide[..., d:]
    ki, vi = _r(gen, B, 4, H, d), _r(gen, B, 4, H, d)
    got, err, route_err = _dual_errors((q, k, v, ki, vi))
    assert err <= route_err
    odd = _r(gen, B, 77, H, d + 1)[..., 1:]  # 2-byte offset
    with pytest.raises(ValueError, match="aligned"):
        dca.dual_cross_attention(q, odd, v, ki, vi)
    with pytest.raises(TypeError, match="bf16"):
        dca.dual_cross_attention(q, k.half(), v, ki, vi)
    with pytest.raises(ValueError, match="shape"):
        dca.dual_cross_attention(q, k, v[:, :70], ki, vi)
    with pytest.raises(ValueError, match="built for"):
        dca.dual_cross_attention(q, k, v, _r(gen, B, 9, H, d), _r(gen, B, 9, H, d))
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        dca.dual_cross_attention(q, k, v, ki, vi)


def test_sdxl_tiny_unet_call_takes_the_kernel_in_every_block(gen):
    # the tiny SDXL bundle at head dim 64 (one head a level): its 11
    # transformer blocks are all unfused, each one launch a UNet call and no
    # einsum route; the output agrees with the einsum route's
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "sdxl_tiny", os.path.join(os.path.dirname(os.path.abspath(__file__)), "sdxl_tiny.py"))
    sdxl_tiny = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sdxl_tiny)
    models, _ = sdxl_tiny.bundle(device="cuda", dtype=torch.bfloat16, level_heads=(1, 1, 1), num_heads=1)
    unet = models.unet
    B, L = 2, sdxl_tiny.LATENT
    args = (torch.randn(B, L, L, 4, generator=gen, device="cuda"), torch.full((B,), 500.0, device="cuda"),
            _r(gen, B, 77, 64), _r(gen, B, 1, 64))
    added = (_r(gen, B, 16), torch.full((B, 6), 32.0, device="cuda"))
    with torch.no_grad():
        with trace.counting("launch.") as launches, trace.counting("route.") as routes:
            got, norms = unet(*args, added_cond=added)
            torch.cuda.synchronize()
        with _plain_kernels():
            want, want_norms = unet(*args, added_cond=added)
    assert launches.get("dual_cross_attn") == 11 and routes == {}
    assert torch.equal(norms, want_norms)
    assert (got - want).abs().max().item() <= 2**-5 * want.abs().max().item()


@pytest.mark.parametrize("fused", [True, False])
def test_sd15_tiny_unet_call_takes_the_kernel_in_every_unfused_block(gen, fused):
    # SD-1.5 widths 320 and 640 with 8 heads (d = 40 and 80): with fused
    # blocks the three C=320 blocks take the fused tail and the C=640 mid
    # block this kernel; without, all four blocks take this kernel
    from photoverse_tpu_torch.engine import inference

    models = _narrow_bundle()
    B = 2
    lat = torch.randn(B, 32, 32, 4, generator=gen, device="cuda")
    text, ident = _r(gen, B, 16, 64), _r(gen, B, 1, 64)
    t = torch.tensor([500.5, 20.0], device="cuda")
    kv = inference.precompute_ctx_kv(models, text, ident)
    bundles = inference.precompute_fused_bundles(models, kv) if fused else None
    with torch.no_grad():
        with trace.counting("launch.") as launches, trace.counting("route.") as routes:
            got, _ = models.unet(lat, t, text, ident, ctx_kv=kv, fused_bundles=bundles)
            torch.cuda.synchronize()
        with _plain_kernels():
            want, _ = models.unet(lat, t, text, ident, ctx_kv=kv, fused_bundles=bundles)
    assert launches.get("dual_cross_attn") == (1 if fused else 4) and routes == {}
    assert launches.get("fused_cross_ff", 0) == (3 if fused else 0)
    assert (got - want).abs().max().item() <= 2**-5 * want.abs().max().item()
