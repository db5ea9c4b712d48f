"""The port's real-weight golden protocol (photoverse_tpu_torch/convert/
real_goldens.py): its helpers equal the JAX package's exactly, and
`torch_outputs` agrees with the JAX package's `jax_outputs` on one tiny
diffusers-layout directory that both packages load (f32, within
OUTPUT_RTOL of each output's largest magnitude). The consumer of the
recorded goldens skips without them, behind the JAX test's gate.
"""

import json
import os

import numpy as np
import pytest
import torch

from photoverse_tpu.convert import real_goldens as jg
from photoverse_tpu_torch.convert import real_goldens as tg
from scripts.torch_make_random_checkpoint import make_checkpoint
from tests.test_real_weight_goldens import FIXTURE, TOLERANCES, _gate
from tests.torch_threads import worker_threads  # noqa: F401

# both sides compute in f32 from the same weights; the orders of their
# reductions differ (XLA against ATen), about 1e-6 of max |x| on this
# directory, so 1e-4 leaves room and still fails a wrong operation
OUTPUT_RTOL = 1e-4


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    """scripts/torch_make_random_checkpoint.py --scale tiny: 77 text
    positions, a 16-layer vision encoder at 224px, f32 weights."""
    root = str(tmp_path_factory.mktemp("golden") / "sd")
    make_checkpoint(root, "tiny", seed=0, device="cpu")
    return root


def test_protocol_helpers_equal_the_jax_packages():
    assert (tg.PROMPT, tg.UNET_T, tg.VISION_LAYERS, tg.DIGEST_TARGET) == (
        jg.PROMPT, jg.UNET_T, jg.VISION_LAYERS, jg.DIGEST_TARGET)
    assert tg.nhwc_keys() == jg.nhwc_keys()
    mine, theirs = tg.make_inputs(), jg.make_inputs()
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype and np.array_equal(mine[k], theirs[k]), k
    rng = np.random.RandomState(0)
    for shape in [(1, 77, 768), (3,), (1, 16, 16, 4)]:
        x = rng.randn(*shape).astype(np.float32)
        assert tg.digest(x) == jg.digest(x)
        dig = jg.digest(x)
        y = x + rng.randn(*shape).astype(np.float32) * 1e-3
        assert tg.compare_digest(y, dig) == jg.compare_digest(y, dig)
        assert tg.compare_digest(y.reshape(-1, 1), dig) == jg.compare_digest(y.reshape(-1, 1), dig)


def test_torch_outputs_agree_with_jax_outputs(tiny_dir):
    mine = tg.torch_outputs(tiny_dir, device="cpu")
    theirs = jg.jax_outputs(tiny_dir)
    assert sorted(mine) == sorted(theirs)
    assert len(mine) == 11  # text 2, vision 5, vae 3, unet 1
    for k in mine:
        want = np.asarray(theirs[k])
        assert mine[k].shape == want.shape and mine[k].dtype == np.float32, k
        scale = float(np.abs(want).max())
        assert np.isfinite(mine[k]).all() and scale > 0, k
        assert float(np.abs(mine[k] - want).max()) <= OUTPUT_RTOL * scale, k
        # through the digest, as the recording is compared
        cmp = tg.compare_digest(mine[k], jg.digest(want))
        assert cmp["ok"] and cmp["max_rel"] <= OUTPUT_RTOL, (k, cmp)
    assert mine["unet_eps"].shape == (1, 32, 32, 4) and mine["vae_decode"].shape[-1] == 3


def test_zero_identity_projections_zeroes_only_them(tiny_dir):
    from photoverse_tpu_torch.models.assembly import load_models

    _, models, _ = load_models(tiny_dir, device="cpu")
    before = {k: v.clone() for k, v in models.unet.state_dict().items()}
    tg.zero_identity_projections(models.unet)
    after = models.unet.state_dict()
    ip = [k for k in before if ".to_k_ip." in k or ".to_v_ip." in k]
    assert ip and all(before[k].abs().max() > 0 and not after[k].any() for k in ip)
    assert all(torch.equal(before[k], after[k]) for k in before if k not in ip)


def test_real_weight_parity():
    """The recorded diffusers / transformers outputs against the port's, on
    a local SD-1.5 checkout (skips without one and the recording)."""
    sd_path, clip_path = _gate()
    with open(FIXTURE) as f:
        goldens = json.load(f)["digests"]
    mine = tg.torch_outputs(sd_path, clip_vision_path=clip_path,
                            device="cuda" if torch.cuda.is_available() else "cpu")
    failures = []
    for key, dig in goldens.items():
        tol = TOLERANCES.get(key.split("_")[0], 1e-4)
        cmp = tg.compare_digest(mine[key], dig)
        if not cmp.get("ok") or cmp["max_rel"] > tol:
            failures.append((key, cmp))
    assert not failures, f"real-weight parity failures: {failures}"
    assert os.path.exists(FIXTURE)
