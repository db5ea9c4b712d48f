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
autograd through the plain f32 forward at the same limit.
"""

import pytest
import torch

from photoverse_tpu_torch.ops import _build
from photoverse_tpu_torch.ops import flash_sdpa as fs
from photoverse_tpu_torch.ops import fused_block as fb

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
    before = _build.launch_counts["flash_sdpa"]
    got = fs.flash_sdpa(q, k, v)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_sdpa"] == before + 1
    want = fs.flash_sdpa_plain(q.float(), k.float(), v.float())
    assert _flash_close(got, want)


@pytest.mark.parametrize("d", [40, 80])
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
    before = _build.launch_counts["flash_sdpa_stream"]
    got = fs.flash_sdpa_stream(q, k, v)
    assert _build.launch_counts["flash_sdpa_stream"] == before + 1
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
    q = torch.zeros(1, 8, 1, 64, device="cuda", dtype=torch.bfloat16)
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
    before = _build.launch_counts["fused_cross_ff"]
    got = fb.fused_cross_ff(h, bundle, H)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_cross_ff"] == before + 1
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
    before = _build.launch_counts["fused_cross_ff"]
    with torch.no_grad():
        out = net(_r(gen, 2, 8, 8, 4), torch.tensor([10, 10], device="cuda"), text, ident,
                  ctx_kv=kv, fused_bundles=bundles)
    out = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(out.float()).all()
    assert _build.launch_counts["fused_cross_ff"] == before


@pytest.mark.parametrize("B,S,H,d", [(1, 100, 2, 40), (2, 256, 2, 80), (1, 200, 1, 512)])
def test_flash_fwd_lse_kernel_matches_plain(gen, B, S, H, d):
    q, k, v = (_r(gen, B, S, H, d, scale=0.3) for _ in range(3))
    counter = "flash_stream_fwd_lse" if d == 512 else "flash_sdpa_fwd_lse"
    before = _build.launch_counts[counter]
    out, lse = fs.flash_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    assert _build.launch_counts[counter] == before + 1
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
    before = _build.launch_counts["flash_bwd"]
    got = fs.flash_bwd(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_bwd"] == before + 1
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
