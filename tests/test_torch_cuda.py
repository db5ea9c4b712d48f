"""The hand-written CUDA kernels against their plain PyTorch versions on the
card. Marked `cuda`: they skip on a machine without an NVIDIA GPU. Run them
on the card with `python -m pytest --noconftest tests/test_torch_cuda.py -q`
(tests/conftest.py imports jax, which the card's machine does not have).

Inputs are bf16; the plain versions compute in f32 from the same bf16
tensors. Both kernels accumulate in f32 (tensor-core products with bf16 or
TF32 operands) and round only their bf16 output. Tolerances: flash 2^-6 of
the largest |out| (2-4 bf16 ulps of it; 0.3*randn inputs give a near-uniform
softmax and small outputs, so an absolute limit would hide a dropped key
tile); the fused tail 1/32 on unit-scale activations (|out| < 8, one bf16
ulp).
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


@pytest.mark.parametrize("S,K,St", [(100, 1, 77), (64, 5, 77), (64, 1, 7)])
def test_fused_kernel_matches_plain(gen, S, K, St):
    B, C, H, F = 2, 320, 8, 1280
    d = C // H
    f32 = torch.float32
    vec = lambda n, base=0.0: base + 0.1 * torch.randn(n, generator=gen, device="cuda")  # noqa: E731
    bundle = {
        "ln2g": vec(C, 1.0), "ln2b": vec(C), "wq": _r(gen, H, C, d, scale=C**-0.5),
        "wout": _r(gen, H, d, C, scale=C**-0.5), "bout": vec(C),
        "ln3g": vec(C, 1.0), "ln3b": vec(C),
        "wpa": _r(gen, C, F, scale=C**-0.5), "wpg": _r(gen, C, F, scale=C**-0.5),
        "bpa": vec(F), "bpg": vec(F), "wo": _r(gen, F, C, scale=F**-0.5), "bo": vec(C),
        "ctx": tuple(_r(gen, B, H, n, d) for n in (St, St, K, K)),
    }
    assert all(bundle[k].dtype == f32 for k in ("ln2g", "bo", "bpa"))
    h = _r(gen, B, S, C)
    got = fb.fused_cross_ff(h, bundle, H)
    torch.cuda.synchronize()
    want = fb.reference_cross_ff(h.float(), bundle, H)
    assert (got.float() - want).abs().max().item() <= 1 / 32
