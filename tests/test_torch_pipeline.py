"""The port's run_inference against the JAX package's on the tiny bundle.

Same weights (from_jax), same example batch and the same initial noise,
4 DPM-Solver++ steps, f32 on the CPU. Images are in [-1, 1]; the port is
held to a max abs pixel difference of 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from photoverse_tpu.core.schedulers import DPMSolverMultistep as JaxSolver
from photoverse_tpu.engine.inference import run_inference as jax_run_inference
from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
from photoverse_tpu_torch.engine.inference import run_inference
from photoverse_tpu_torch.utils import trace
from tests.tiny_models import LATENT, tiny_batch, tiny_bundle
from tests.torch_tiny import port_models

STEPS = 4
ATOL = 1e-3


@pytest.fixture(scope="module")
def bundle():
    return tiny_bundle()


def _inputs(B=2):
    rng = np.random.RandomState(11)
    noise = rng.randn(B, LATENT, LATENT, 4).astype(np.float32)
    uncond = rng.randint(0, 64, (B, 12)).astype(np.int32)
    return tiny_batch(B=B), noise, uncond


def _both(modules, params, port, guidance, interpret=False):
    example, noise, uncond = _inputs()
    kw = dict(guidance_scale=guidance, token_index=0, latent_size=LATENT)
    jkw = dict(kw, initial_noise=jnp.asarray(noise))
    if guidance != 1.0:
        jkw["uncond_input_ids"] = jnp.asarray(uncond)
        kw["uncond_input_ids"] = uncond
    jex = {k: jnp.asarray(v) for k, v in example.items()}
    solver = JaxSolver.create(modules.schedule, STEPS)
    if interpret:
        with pltpu.force_tpu_interpret_mode():
            want = jax_run_inference(modules, params, solver, jex, jax.random.PRNGKey(0), **jkw)
    else:
        want = jax_run_inference(modules, params, solver, jex, jax.random.PRNGKey(0), **jkw)
    got = run_inference(port, DPMSolverMultistep.create(port.schedule, STEPS), example,
                        initial_noise=noise, **kw)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("guidance", [1.0, 2.0])
def test_run_inference_matches_jax(bundle, guidance):
    modules, params = bundle
    want, got = _both(modules, params, port_models(modules, params), guidance)
    assert got.shape == want.shape == (2, 32, 32, 3)
    assert np.isfinite(got).all() and got.min() >= -1 and got.max() <= 1
    assert np.abs(got - want).max() <= ATOL


def test_run_inference_fast_path_matches_jax(bundle):
    # flash self-attention at every level (flash_min_seq 64) and the fused
    # block tail in both packages: the JAX kernels run in interpret mode,
    # the port's wrappers take their plain versions on the CPU
    modules, params = bundle
    fast = dict(use_flash_attention=True, flash_min_seq=64, fused_blocks=True)
    jmodules = dataclasses.replace(
        modules, unet=modules.unet.clone(config=dataclasses.replace(modules.unet.config, **fast))
    )
    port = port_models(modules, params, unet_overrides=fast)
    with trace.counting("launch.") as launches:
        want, got = _both(jmodules, params, port, 2.0, interpret=True)
    assert np.abs(got - want).max() <= ATOL
    assert launches == {}  # CPU tensors never launch a kernel
