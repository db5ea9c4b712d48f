"""photoverse_tpu_torch.ops against photoverse_tpu.ops on the CPU (f32).

The same numpy inputs go through both packages. JAX functions that reach a
Pallas kernel run in interpret mode; the port's kernel wrappers take their
plain PyTorch versions because the tensors lie on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from photoverse_tpu.ops import attention as jattn
from photoverse_tpu.ops import flash_sdpa as jflash
from photoverse_tpu.ops import fused_block as jfused
from photoverse_tpu.ops.injection import inject_concept_embeddings as jinject
from photoverse_tpu_torch.ops import _build
from photoverse_tpu_torch.ops import attention as tattn
from photoverse_tpu_torch.ops import flash_sdpa as tflash
from photoverse_tpu_torch.ops import fused_block as tfused
from photoverse_tpu_torch.ops.injection import inject_concept_embeddings as tinject
from photoverse_tpu_torch.utils import trace

T = torch.from_numpy


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def test_sdpa_matches_jax():
    # rtol 1e-5 / atol 1e-6: both sides are f32 einsum + softmax
    rng = np.random.RandomState(0)
    q, k, v = _rand(rng, 2, 9, 2, 8), _rand(rng, 2, 7, 2, 8), _rand(rng, 2, 7, 2, 8)
    want = np.asarray(jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tattn.sdpa(T(q), T(k), T(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_dual_context_attention_matches_jax():
    # rtol 1e-5 / atol 1e-6 on the fused output and the v_ip norms
    rng = np.random.RandomState(1)
    q = _rand(rng, 2, 16, 2, 8)
    kt, vt = _rand(rng, 2, 7, 2, 8), _rand(rng, 2, 7, 2, 8)
    ki, vi = _rand(rng, 2, 3, 2, 8), _rand(rng, 2, 3, 2, 8)
    want, want_n = jattn.dual_context_attention(*map(jnp.asarray, (q, kt, vt, ki, vi)))
    got, got_n = tattn.dual_context_attention(*map(T, (q, kt, vt, ki, vi)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=1e-5, atol=1e-6)
    assert got_n.shape == (2, 2, 3)


def test_fuse_outputs_train_rules_match_jax():
    rng = np.random.RandomState(2)
    a, b = _rand(rng, 3, 4), _rand(rng, 3, 4)
    for u in (0.1, 0.5, 0.9):
        want = jattn.fuse_outputs(jnp.asarray(a), jnp.asarray(b), train=True, fusion_u=jnp.float32(u))
        got = tattn.fuse_outputs(T(a), T(b), train=True, fusion_u=torch.tensor(u))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("pidx", [[0, 0], [3, 5], [0, 9]])
def test_injection_matches_jax(pidx):
    # exact splice (a gather): rtol 1e-5 / atol 1e-6; p=0 puts the concept first
    rng = np.random.RandomState(3)
    emb, concept = _rand(rng, 2, 12, 4), _rand(rng, 2, 3, 4)
    p = np.asarray(pidx, np.int32)
    want = np.asarray(jinject(jnp.asarray(emb), jnp.asarray(concept), jnp.asarray(p)))
    got = tinject(T(emb), T(concept), T(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _qkv(B, Sq, Skv, H, d, seed):
    rng = np.random.RandomState(seed)
    return (_rand(rng, B, Sq, H, d, scale=0.3), _rand(rng, B, Skv, H, d, scale=0.3),
            _rand(rng, B, Skv, H, d, scale=0.3))


@pytest.mark.parametrize("Sq,Skv,d", [(256, 256, 40), (256, 256, 80), (128, 256, 40)])
def test_flash_sdpa_matches_jax(Sq, Skv, d):
    # atol 1e-5: the Pallas kernel's online softmax (interpret mode, 64-row
    # tiles) against the port's one-shot f32 softmax
    q, k, v = _qkv(2, Sq, Skv, 2, d, seed=d + Sq)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jflash.flash_sdpa(*map(jnp.asarray, (q, k, v)), q_tile=64, k_tile=64))
    got = tflash.flash_sdpa(T(q), T(k), T(v)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_flash_sdpa_stream_matches_jax():
    # atol 1e-5; k_tile 64 streams four K/V blocks through the Pallas kernel
    q, k, v = _qkv(1, 256, 256, 1, 64, seed=7)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jflash.flash_sdpa_stream(*map(jnp.asarray, (q, k, v)), q_tile=64, k_tile=64))
    got = tflash.flash_sdpa_stream(T(q), T(k), T(v)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _rand_bundle(rng, B, C, H, St, K):
    d, F = C // H, 4 * C
    r = lambda *s: _rand(rng, *s, scale=0.1)  # noqa: E731
    weights = {
        "ln2g": r(C), "ln2b": r(C), "wq": r(H, C, d), "wout": r(H, d, C), "bout": r(C),
        "ln3g": r(C), "ln3b": r(C), "wpa": r(C, F), "wpg": r(C, F), "bpa": r(F), "bpg": r(F),
        "wo": r(F, C), "bo": r(C),
    }
    ctx = tuple(r(B, n, H, d) * 3 for n in (St, St, K, K))  # (B, n, H, d) as the cache holds it
    return weights, ctx


def _torch_bundle(w):
    """The JAX bundle's weights ((H, C, d) q, (H, d, C) out, (in, out) ff) in
    the port's layout: every matrix (out, in), q and out over all heads."""
    C = w["wq"].shape[1]
    moved = {"wq": w["wq"].transpose(0, 2, 1).reshape(C, C), "wout": w["wout"].reshape(C, C).T,
             "wpa": w["wpa"].T, "wpg": w["wpg"].T, "wo": w["wo"].T}
    return {k: T(np.ascontiguousarray(moved.get(k, v))) for k, v in w.items()}


@pytest.mark.parametrize("St,K", [(7, 1), (7, 5), (77, 1), (77, 5)])
def test_fused_cross_ff_matches_jax(St, K):
    # atol 1e-4 (as the JAX package's own kernel test). The JAX bundle pads
    # the identity context to 8 tokens with a -1e9 bias; the port's does not.
    rng = np.random.RandomState(St + K)
    B, S, C, H = 2, 64, 32, 4
    w, ctx = _rand_bundle(rng, B, C, H, St, K)
    h = _rand(rng, B, S, C)
    vec = {"ln2g", "ln2b", "bout", "ln3g", "ln3b", "bpa", "bpg", "bo"}
    jb = {k: jnp.asarray(v.reshape(1, -1) if k in vec else v) for k, v in w.items()}
    jb = jfused.attach_ctx(jb, tuple(map(jnp.asarray, ctx)), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfused.fused_cross_ff(jnp.asarray(h), jb, H, q_tile=32))
    tb = tfused.attach_ctx(_torch_bundle(w), tuple(map(T, ctx)), torch.float32)
    got = tfused.fused_cross_ff(T(h), tb, H).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert tb["ctx"][2].shape == (B, H, K, C // H)
    assert tb["wq"].shape == (C, C) and tb["wpa"].shape == (4 * C, C) and tb["wo"].shape == (C, 4 * C)


@pytest.mark.parametrize("S,d", [(256, 40), (128, 80)])
def test_flash_fwd_lse_plain_matches_jax(S, d):
    # atol 1e-5 (out), 1e-5 (lse): the Pallas lse kernel in interpret mode,
    # 64-row tiles, against the port's one-shot f32 logsumexp; the TPU
    # kernel's 8-lane lse broadcast is gone from the port's (B, H, S)
    q, k, v = _qkv(2, S, S, 2, d, seed=S + d + 1)
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = jflash._flash_fwd_lse(*map(jnp.asarray, (q, k, v)), q_tile=64, k_tile=64)
    got, lse = tflash.flash_fwd_lse(T(q), T(k), T(v))
    assert lse.shape == (2, 2, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5)


def _bwd_args(B, S, H, d, seed):
    q, k, v = _qkv(B, S, S, H, d, seed)
    out, lse = tflash.flash_fwd_lse_plain(T(q), T(k), T(v))
    g = _rand(np.random.RandomState(seed + 1), B, S, H, d)
    return q, k, v, out.numpy(), lse.numpy(), g


@pytest.mark.parametrize("S,d", [(256, 40), (128, 80)])
def test_flash_bwd_plain_matches_jax(S, d):
    # atol 2e-5 on dq/dk/dv of size ~0.1-1: the two Pallas backward kernels
    # (dq; dk/dv over 64-row q tiles) in interpret mode against the port's
    # explicit formula, both f32
    args = _bwd_args(2, S, 2, d, seed=S + d)
    with pltpu.force_tpu_interpret_mode():
        want = jflash._flash_bwd(*map(jnp.asarray, args), q_tile=64, k_tile=64)
    got = tflash.flash_bwd(*map(T, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def test_stream_fwd_lse_and_chunked_bwd_match_jax():
    # the streaming lse forward (Pallas, interpret, four K/V blocks) and the
    # chunked backward (plain XLA; the port's in plain torch, chunks of 64):
    # atol 1e-5 / 2e-5
    args = _bwd_args(1, 256, 1, 64, seed=5)
    q, k, v = args[:3]
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = jflash._flash_stream_fwd_lse(*map(jnp.asarray, (q, k, v)), q_tile=64, k_tile=64)
    got, lse = tflash.flash_fwd_lse(T(q), T(k), T(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5)
    want = jflash._stream_bwd_chunked(*map(jnp.asarray, args), chunk=64)
    got = tflash.stream_bwd_chunked(*map(T, args), chunk=64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def test_differentiable_flash_refuses_unequal_lengths():
    q, k, v = map(jnp.asarray, _qkv(1, 64, 128, 1, 40, seed=1))
    with pytest.raises(ValueError, match="equal"):
        jflash._flash_fwd_lse(q, k, v)
    with pytest.raises(ValueError, match="equal"):
        jflash._flash_bwd(q, k, v, q, jnp.zeros((1, 1, 64)), q)
    tq, tk = T(np.array(q)), T(np.array(k))
    for fn in (tflash.flash_sdpa_diff, tflash.flash_sdpa_stream_diff):
        with pytest.raises(ValueError, match="equal"):
            fn(tq, tk, tk)
    with pytest.raises(ValueError, match="equal"):
        tflash.flash_bwd(tq, tk, tk, tq, torch.zeros(1, 1, 64), tq)


@pytest.mark.parametrize("diff", [tflash.flash_sdpa_diff, tflash.flash_sdpa_stream_diff])
def test_autograd_function_backward_matches_autograd(diff):
    # the Functions' plain backward (explicit formula / chunked) against
    # torch.autograd through the plain forward: rtol 1e-5 / atol 1e-6 (f32)
    q, k, v = (T(x).requires_grad_() for x in _qkv(2, 96, 96, 2, 16, seed=3))
    w = T(_rand(np.random.RandomState(4), 2, 96, 2, 16))
    out = diff(q, k, v)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    want = torch.autograd.grad((tflash.flash_sdpa_plain(q, k, v) * w).sum(), (q, k, v))
    for g, wt in zip(got, want):
        torch.testing.assert_close(g, wt, rtol=1e-5, atol=1e-6)


def test_no_grad_kernels_refuse_inputs_that_require_grad():
    # their kernels write fresh buffers without a grad_fn: refused under
    # grad on every device, accepted under no_grad
    q = T(_qkv(1, 64, 64, 2, 40, seed=0)[0]).requires_grad_()
    for fn in (tflash.flash_sdpa, tflash.flash_sdpa_stream):
        with pytest.raises(RuntimeError, match="no gradient"):
            fn(q, q, q)
        with torch.no_grad():
            fn(q, q, q)
    w, ctx = _rand_bundle(np.random.RandomState(0), 1, 16, 2, 7, 1)
    bundle = tfused.attach_ctx(_torch_bundle(w), tuple(map(T, ctx)), torch.float32)
    h = torch.zeros(1, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tfused.fused_cross_ff(h, bundle, 2)
    bundle["wq"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tfused.fused_cross_ff(h.detach(), bundle, 2)
    with torch.no_grad():
        tfused.fused_cross_ff(h, bundle, 2)


def test_wrappers_count_no_launch_on_cpu():
    with trace.counting("launch.") as launches:
        q, k, v = map(T, _qkv(1, 64, 64, 2, 40, seed=0))
        tflash.flash_sdpa(q, k, v)
        tflash.flash_sdpa_stream(q, k, v)
        out, lse = tflash.flash_fwd_lse(q, k, v)
        tflash.flash_bwd(q, k, v, out, lse, q)
        w, ctx = _rand_bundle(np.random.RandomState(0), 1, 16, 2, 7, 1)
        tfused.fused_cross_ff(torch.zeros(1, 8, 16), tfused.attach_ctx(
            _torch_bundle(w), tuple(map(T, ctx)), torch.float32), 2)
    assert launches == {}


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "NVCC_FALLBACKS", (str(tmp_path / "nvcc"),))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build_library(build_dir=str(tmp_path / "build"))
    assert not (tmp_path / "build").exists()


def test_wrappers_reject_devices_without_a_kernel():
    # only CPU (plain version) and CUDA (kernel) tensors are taken
    q = torch.zeros(1, 8, 1, 40, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tflash.flash_sdpa(q, q, q)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tfused.fused_cross_ff(torch.zeros(1, 8, 16, device="meta"), {}, 2)


@pytest.mark.parametrize("what", ["offset", "seq_stride", "head_stride", "inner_stride",
                                  "g_offset", "g_seq_stride", "d512_offset", "d512_seq_stride",
                                  "d512_inner_stride"])
def test_flash_wrapper_refuses_layouts_tma_cannot_read(what):
    # the kernels read q, k, v (and the backward its g) in place through TMA
    # tensor maps: the data 16-byte aligned, every stride but the head dim's
    # a multiple of 8 elements (16 bytes), unit stride on the head dim
    bf = torch.bfloat16
    base = torch.zeros(2, 16, 2, 48, dtype=bf)
    wide = torch.zeros(2, 16, 1, 520, dtype=bf)
    name, d, bad = {
        "offset": ("q", 40, base[..., 4:44]),                        # 8-byte offset
        "seq_stride": ("q", 40, torch.zeros(2, 16, 2 * 40 + 4, dtype=bf)[..., :80].reshape(2, 16, 2, 40)),
        "head_stride": ("q", 40, torch.zeros(2, 16, 2, 44, dtype=bf)[..., :40]),
        "inner_stride": ("q", 40, torch.zeros(2, 16, 2, 80, dtype=bf)[..., ::2]),
        # an output gradient that is a view into a wider buffer
        "g_offset": ("g", 80, torch.zeros(2, 16, 2, 88, dtype=bf)[..., 4:84]),
        "g_seq_stride": ("g", 80, torch.zeros(2, 16, 2 * 80 + 4, dtype=bf)[..., :160].reshape(2, 16, 2, 80)),
        # the VAE's single head of 512
        "d512_offset": ("q", 512, wide[..., 4:516]),
        "d512_seq_stride": ("k", 512, torch.zeros(2, 16, 516, dtype=bf)[..., :512].reshape(2, 16, 1, 512)),
        "d512_inner_stride": ("v", 512, torch.zeros(2, 16, 1, 1024, dtype=bf)[..., ::2]),
    }[what]
    assert bad.shape[:2] == (2, 16) and bad.shape[-1] == d
    with pytest.raises(ValueError, match=f"{name} must.*(aligned|unit stride)"):
        tflash._check_tma_layout(name, bad)
    tflash._check_tma_layout("q", base[..., :40])  # 96-byte head stride: fine
    tflash._check_tma_layout("q", wide[..., :512])
    packed = torch.zeros(2, 16, 3, 2, 40, dtype=bf)  # a packed qkv projection
    for t in packed.unbind(dim=2):
        tflash._check_tma_layout("q", t)
    assert tflash._check_tma_layout("g", bad.contiguous()) is None  # what flash_bwd hands its kernel


@pytest.mark.parametrize("B,S,H,d", [(1, 256, 2, 40), (1, 256, 2, 80)])
def test_flash_bwd_with_bf16_p_and_ds_stays_within_the_kernel_limit(B, S, H, d):
    # The CUDA backward hands p and ds to the tensor cores as bf16 (8
    # significant bits) where the plain version keeps f32. This copy of the
    # formula rounds them at the same places (p for dv only; ds, formed from
    # the unrounded p, for dq and dk) on unit-scale bf16 inputs and must stay
    # within the kernel's limit on the card, 2^-6 of each output's max |.|:
    # independent rounding errors of 2^-9 average out over the S terms of a
    # sum, so the worst element moves by a few percent of that limit.
    rng = np.random.RandomState(0)
    q, k, v, g = (T(_rand(rng, B, S, H, d)).bfloat16() for _ in range(4))
    out, lse = tflash.flash_fwd_lse_plain(q, k, v)
    want = tflash.flash_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse, g.float())

    bf16 = lambda x: x.bfloat16().float()  # noqa: E731
    scale = d**-0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = bf16(p * (dp - tflash._delta(out, g)[..., None]))
    got = (torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale,
           torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale,
           torch.einsum("bhqk,bqhd->bkhd", bf16(p), gf))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        limit = 2**-6 * w.float().abs().max().item()
        err = (a.bfloat16().float() - w.float()).abs().max().item()  # rounded as the kernel's output
        assert err <= limit, f"{name}: {err:.4g} over {limit:.4g}"


def test_wgmma_kernel_serves_the_unet_head_dims_by_default():
    assert tflash.KERNEL_HEAD_DIMS == (40, 80, 512) and tflash.BWD_HEAD_DIMS == (40, 80)
    # every forward goes one route: the same checks, one C signature
    assert _build.SIGNATURES["pv_flash_fwd_stream"] == _build.SIGNATURES["pv_flash_fwd_wgmma"]
    # one configuration of each wgmma kernel is built: the C entry points
    # take no selector after the shapes and strides, only the stream
    assert _build.SIGNATURES["pv_flash_fwd_wgmma"][-2:] == [_build.L, _build.P]
    assert _build.SIGNATURES["pv_fused_cross_ff"][-8:] == [_build.I] * 7 + [_build.P]


@pytest.mark.parametrize("change,match", [
    ({"C": 64, "H": 8}, "built for"), ({"St": 81}, "built for"), ({"K": 9}, "built for"),
])
def test_fused_wrapper_refuses_shapes_the_kernel_is_not_built_for(change, match):
    # checked before any launch, so a meta tensor (no data) reaches the check
    dims = {"B": 1, "S": 8, "C": 320, "H": 8, "St": 77, "K": 1, **change}
    B, S, C, H, St, K = (dims[k] for k in ("B", "S", "C", "H", "St", "K"))
    d, F = C // H, 4 * C
    z = lambda *s: torch.zeros(*s, device="meta", dtype=torch.bfloat16)  # noqa: E731
    bundle = {"wq": z(C, C), "wout": z(C, C), "wpa": z(F, C), "wpg": z(F, C), "wo": z(C, F),
              "ctx": (z(B, H, St, d), z(B, H, St, d), z(B, H, K, d), z(B, H, K, d))}
    h = z(B, S, C)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tfused.fused_cross_ff(h, bundle, H)
    with pytest.raises(ValueError, match=match):
        tfused.check_kernel_shape(C, H, St, K, F)
    tfused.check_kernel_shape(320, 8, 77, 5, 1280)


@pytest.mark.parametrize("sizes,served", [
    ((320, 8, 77, 1, 1280), True), ((320, 8, 80, 8, 64), True), ((320, 8, 7, 5, 1280), True),
    ((64, 8, 77, 1, 256), False), ((320, 5, 77, 1, 1280), False), ((640, 8, 77, 1, 2560), False),
    ((320, 8, 81, 1, 1280), False), ((320, 8, 77, 9, 1280), False), ((320, 8, 77, 1, 1288), False),
    ((320, 8, 77, 0, 1280), False),
])
def test_kernel_serves_is_the_rule_check_kernel_shape_raises_by(sizes, served):
    assert tfused.kernel_serves(*sizes) is served
    if served:
        tfused.check_kernel_shape(*sizes)
    else:
        with pytest.raises(ValueError, match="built for"):
            tfused.check_kernel_shape(*sizes)


def test_fused_bundles_are_routed_by_the_kernels_own_rule_on_the_card():
    # a narrow UNet with fused blocks: on the CPU every C <= 320 layer gets
    # a bundle (the plain version serves any width); context K/V that lie on
    # the card route a layer to the fused tail only if the CUDA kernel is
    # built for its sizes, so these layers keep the unfused tail
    import types

    from photoverse_tpu_torch.engine import inference
    from photoverse_tpu_torch.models.unet import UNet2DCondition, UNetConfig

    cfg = UNetConfig(block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=24,
                     num_heads=4, norm_num_groups=8, fused_blocks=True, fused_block_max_channels=32)
    with torch.device("cpu"):
        net = UNet2DCondition(cfg).eval().requires_grad_(False)
    models = types.SimpleNamespace(unet=net, dtype=torch.float32)
    kv = inference.precompute_ctx_kv(models, torch.zeros(2, 7, 24), torch.zeros(2, 1, 24))
    on_cpu = inference.precompute_fused_bundles(models, kv)
    widths = [blk.attn2.to_out[0].out_features for blk in net.cross_attentions()]
    assert 32 in widths and 64 in widths
    assert [b is not None for b in on_cpu] == [c <= 32 for c in widths]
    card = [tuple(types.SimpleNamespace(device=torch.device("cuda"), shape=t.shape) for t in layer)
            for layer in kv]
    assert all(b is None for b in inference.precompute_fused_bundles(models, card))
