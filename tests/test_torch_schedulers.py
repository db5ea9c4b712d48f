"""photoverse_tpu_torch.core.schedulers against photoverse_tpu.core.schedulers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photoverse_tpu.core import schedulers as jsched
from photoverse_tpu_torch.core import schedulers as tsched
from tests.torch_threads import worker_threads  # noqa: F401


@pytest.mark.parametrize("steps", [10, 25, 50])
def test_dpm_coefficient_tables_match_jax(steps):
    # the host math is the same numpy code; the f32 tables agree to 1e-7
    want = jsched.DPMSolverMultistep.create(jsched.make_sd15_schedule(), steps).scan_inputs()
    got = tsched.DPMSolverMultistep.create(tsched.make_sd15_schedule(), steps).step_inputs("cpu")
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["t"].numpy(), np.asarray(want["t"]))
    for k in ("a", "b", "c", "eps_coef", "x0_scale"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-7)


@pytest.mark.parametrize("beta_schedule", ["scaled_linear", "linear", "squaredcos_cap_v2"])
def test_ddpm_tables_match_jax(beta_schedule):
    want = jsched.DDPMSchedule.create(beta_schedule=beta_schedule).alphas_cumprod
    got = tsched.DDPMSchedule.create(beta_schedule=beta_schedule).alphas_cumprod
    np.testing.assert_array_equal(got, want)


def test_solver_steps_match_jax():
    # three steps of the (x, m_prev) carry on the same eps: rtol 1e-6 (f32)
    js = jsched.DPMSolverMultistep.create(jsched.make_sd15_schedule(), 5)
    ts = tsched.DPMSolverMultistep.create(tsched.make_sd15_schedule(), 5)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 4, 4).astype(np.float32)
    jc, tc = js.init_carry(jnp.asarray(x)), ts.init_carry(torch.from_numpy(x))
    jx, tx = js.scan_inputs(), ts.step_inputs("cpu")
    for i in range(3):
        eps = rng.randn(*x.shape).astype(np.float32)
        jc = js.advance({k: v[i] for k, v in jx.items()}, jc, jnp.asarray(eps))
        tc = ts.advance({k: v[i] for k, v in tx.items()}, tc, torch.from_numpy(eps))
        for a, b in zip(jc, tc):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)


def test_ddpm_add_noise_matches_jax():
    # per-row timesteps, f32: rtol 1e-6
    js, ts = jsched.make_sd15_schedule(), tsched.make_sd15_schedule()
    rng = np.random.RandomState(1)
    x, n = rng.randn(3, 4, 4, 4).astype(np.float32), rng.randn(3, 4, 4, 4).astype(np.float32)
    t = np.array([0, 421, 999])
    want = js.add_noise(jnp.asarray(x), jnp.asarray(n), jnp.asarray(t))
    got = ts.add_noise(torch.from_numpy(x), torch.from_numpy(n), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("step_index", [0, 3])
def test_solver_add_noise_matches_jax(step_index):
    js = jsched.DPMSolverMultistep.create(jsched.make_sd15_schedule(), 10)
    ts = tsched.DPMSolverMultistep.create(tsched.make_sd15_schedule(), 10)
    rng = np.random.RandomState(2)
    x, n = rng.randn(2, 4, 4, 4).astype(np.float32), rng.randn(2, 4, 4, 4).astype(np.float32)
    want = js.add_noise(jnp.asarray(x), jnp.asarray(n), step_index)
    got = ts.add_noise(torch.from_numpy(x), torch.from_numpy(n), step_index)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
