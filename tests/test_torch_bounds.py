"""photoverse_tpu_torch.ops.bounds (the least time an H100 could take for
each kernel's call, from its shapes) and the port's device defaults."""

import inspect

import pytest

from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
from photoverse_tpu_torch.models.arcface import ArcFaceResNet18
from photoverse_tpu_torch.models.assembly import build_models, load_models
from photoverse_tpu_torch.models.face_loss import load_face_loss
from photoverse_tpu_torch.models.facenet import InceptionResnetV1
from photoverse_tpu_torch.utils.face_similarity import FaceSimilarity
from photoverse_tpu_torch.utils.mtcnn import MTCNN
from photoverse_tpu_torch.ops import bounds
from scripts.torch_make_random_checkpoint import make_checkpoint
from tests.torch_threads import worker_threads  # noqa: F401


@pytest.mark.parametrize("fn,shape,gflop,ms", [
    # the main paths' shapes; 989 TFLOP/s dense bf16, every one compute-bound
    (bounds.flash_fwd, (2, 4096, 4096, 8, 40), 42.95, 0.0434),
    (bounds.flash_fwd, (2, 1024, 1024, 8, 80), 5.37, 0.0054),
    (bounds.fused_cross_ff, (2, 4096, 320, 8, 77, 1, 1280), 24.31, 0.0246),
    (bounds.flash_fwd, (2, 4096, 4096, 1, 512), 68.72, 0.0695),
    (bounds.flash_bwd, (4, 4096, 8, 40), 214.7, 0.2171),
    (bounds.flash_fwd, (4, 4096, 4096, 8, 40), 85.9, 0.0869),
    (bounds.flash_bwd, (4, 1024, 8, 80), 26.84, 0.0271),
    # SDXL's self-attention at UNet batch 8 (4 rows under guidance), d = 64
    (bounds.flash_fwd, (8, 4096, 4096, 10, 64), 343.6, 0.3474),
    (bounds.flash_fwd, (8, 1024, 1024, 20, 64), 42.95, 0.0434),
])
def test_bounds_at_the_main_path_shapes(fn, shape, gflop, ms):
    ops, nbytes = fn(*shape)
    assert ops / 1e9 == pytest.approx(gflop, rel=1e-3)
    assert bounds.bound_ms(ops, nbytes) == pytest.approx(ms, abs=5e-5)  # the table's four decimals
    assert bounds.bound_by(ops, nbytes) == "operations"


def test_bytes_count_each_input_and_output_once():
    B, S, H, d = 2, 64, 4, 40
    _, nbytes = bounds.flash_fwd(B, S, S, H, d)
    assert nbytes == 4 * B * S * H * d * 2  # q, k, v, out in bf16
    _, with_lse = bounds.flash_fwd(B, S, S, H, d, with_lse=True)
    assert with_lse == nbytes + B * H * S * 4
    _, bwd = bounds.flash_bwd(B, S, H, d)
    assert bwd == 8 * B * S * H * d * 2 + B * H * S * 4  # q k v out g in, dq dk dv out, lse
    C, St, K, F = 320, 77, 1, 1280
    _, fused = bounds.fused_cross_ff(B, S, C, H, St, K, F)
    weights = 2 * C * C + 3 * C * F
    assert fused == 2 * (2 * B * S * C + weights + 2 * B * C * (St + K)) + 4 * (6 * C + 2 * F)
    # the channels-last GroupNorm: x in and out, the add, weight and bias; no
    # operation counts against the tensor cores, so bytes bound it
    ops, norm = bounds.group_norm(16, 64 * 64, C, add=True)
    assert ops == 0 and norm == 2 * (2 * 16 * 64 * 64 * C + 16 * C + 2 * C)
    assert bounds.bound_by(ops, norm) == "bytes"
    assert bounds.group_norm(1, 64, C, itemsize=4)[1] == 4 * (2 * 64 * C + 2 * C)


def test_bound_is_the_larger_quotient():
    assert bounds.bound_ms(989e12, 1.0) == pytest.approx(1e3)
    assert bounds.bound_ms(1.0, 3.35e12) == pytest.approx(1e3)
    assert bounds.bound_by(1.0, 3.35e12) == "bytes"
    assert bounds.bound_ms(1e12, 1e9, peak_flops=1e12, peak_bytes=1e12) == pytest.approx(1e3)


@pytest.mark.parametrize("entry,param", [
    (build_models, "device"), (ArcFaceResNet18.__init__, "device"),
    (DPMSolverMultistep.step_inputs, "device"), (load_models, "device"), (load_face_loss, "device"),
    (InceptionResnetV1.__init__, "device"), (MTCNN.from_torch_weights, "device"),
    (FaceSimilarity.__init__, "device"), (make_checkpoint, "device"),
])
def test_entry_points_default_to_the_card(entry, param):
    # the port's entry points run on the card unless the caller asks for
    # the CPU (as the tiny-model fixtures do)
    assert inspect.signature(entry).parameters[param].default == "cuda"


def test_tiny_fixtures_ask_for_the_cpu():
    import tests.torch_tiny as tiny

    assert 'device="cpu"' in inspect.getsource(tiny.port_models)
