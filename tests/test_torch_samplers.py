"""Every sampler of photoverse_tpu_torch.core.schedulers against the JAX
package's, the masked identity route, `from_noised_image`, and ancestral
noise per batch row.

  - coefficient tables: both packages compute them in float64 numpy, so
    they agree to 1e-12; `t` keeps its kind (integer or fractional);
  - `advance` per carry family on seeded random carries, f32: 1e-6;
  - the frozen self-goldens of tests/fixtures replayed through the port by
    the protocol of tests/test_scheduler_goldens.py (rtol 2e-5, atol 2e-6);
  - the cubic mask resize against jax.image.resize: 1e-5;
  - the UNet with a mask: rtol 5e-4 / atol 5e-5 as tests/test_torch_models.py;
    whole pipelines on the tiny bundle (f32, 3 steps): max abs pixel
    difference 1e-3 as tests/test_torch_pipeline.py, with every random draw
    computed from the JAX keys and passed to the port.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photoverse_tpu.core import schedulers as jsched
from photoverse_tpu.engine.inference import run_inference as jax_run_inference
from photoverse_tpu.models.unet import _downsample_ip_mask as jax_downsample
from photoverse_tpu_torch.core import schedulers as tsched
from photoverse_tpu_torch.engine import inference as tinf
from photoverse_tpu_torch.models.unet import _cubic_resize_matrix, _downsample_ip_mask
from tests.tiny_models import LATENT, RES, tiny_batch, tiny_bundle
from tests.torch_tiny import port_models
from tests.torch_threads import worker_threads  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TABLES = ("timesteps", "sigmas", "a", "b", "c", "eps_coef", "x0_scale", "noise_sigma", "corr_ci",
          "corr_a", "corr_b_this", "corr_b_prev", "corr_b_pp", "lms_c", "pndm_c")
PIXEL_ATOL = 1e-3


def test_scheduler_names_match_jax():
    assert tsched.SCHEDULER_NAMES == jsched.SCHEDULER_NAMES and len(tsched.SCHEDULER_NAMES) == 18


@pytest.mark.parametrize("steps", [5, 25])
@pytest.mark.parametrize("name", jsched.SCHEDULER_NAMES)
def test_tables_match_jax(name, steps):
    js = jsched.make_solver(jsched.make_sd15_schedule(), name, steps)
    ts = tsched.make_solver(tsched.make_sd15_schedule(), name, steps)
    for k in TABLES:
        want, got = getattr(js, k), getattr(ts, k)
        assert (want is None) == (got is None), k
        if want is not None:
            assert np.asarray(got).shape == np.asarray(want).shape, k
            np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                       rtol=0, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(ts.init_noise_sigma, js.init_noise_sigma, rtol=0, atol=1e-12)
    assert (ts.num_steps, ts.has_corrector, ts.has_lms, ts.has_pndm, ts.is_ancestral) == (
        js.num_steps, js.has_corrector, js.has_lms, js.has_pndm, js.is_ancestral)
    # the device tables: the same keys, f32 coefficients, and `t` an integer
    # or a fractional f32 exactly where the JAX scan's is
    # (JAX's step index `i` only feeds fold_in; the port's step noise is drawn
    # before the loop and has no such table)
    jx, tx = js.scan_inputs(), ts.step_inputs("cpu")
    assert set(tx) == set(jx) - {"i"}
    assert (tx["t"].dtype == torch.int64) == bool(jnp.issubdtype(jx["t"].dtype, jnp.integer))
    assert tx["t"].dtype in (torch.int64, torch.float32)
    for k in tx:
        np.testing.assert_allclose(tx[k].numpy(), np.asarray(jx[k]), rtol=0, atol=1e-7, err_msg=k)
    assert ts.step_inputs("cpu") is tx  # uploaded once


@pytest.mark.parametrize("name", ["ddim", "pndm"])
def test_make_solver_errors_match_jax(name):
    for mod in (jsched, tsched):
        with pytest.raises(ValueError, match=f"{name} has no karras-sigma variant"):
            mod.make_solver(mod.make_sd15_schedule(), name, 6, use_karras_sigmas=True)
        with pytest.raises(ValueError, match="unknown scheduler"):
            mod.make_solver(mod.make_sd15_schedule(), "plms", 6)
        with pytest.raises(ValueError, match="exceeds"):
            mod.make_solver(mod.make_sd15_schedule(), name, 1000)
    a = tsched.make_solver(tsched.make_sd15_schedule(), "dpm_karras", 8)
    b = tsched.make_solver(tsched.make_sd15_schedule(), "dpm", 8, use_karras_sigmas=True)
    np.testing.assert_array_equal(a.timesteps, b.timesteps)
    np.testing.assert_array_equal(a.sigmas, b.sigmas)


# one sampler per carry: (x, m_prev), the same with noise, UniPC's, LMS's, PNDM's
@pytest.mark.parametrize("name", ["heun", "dpm_2s_a_karras", "unipc", "lms_karras", "pndm"])
def test_advance_matches_jax(name):
    js = jsched.make_solver(jsched.make_sd15_schedule(), name, 6)
    ts = tsched.make_solver(tsched.make_sd15_schedule(), name, 6)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 4, 4).astype(np.float32)
    jc, tc = js.init_carry(jnp.asarray(x)), ts.init_carry(torch.from_numpy(x))
    assert len(jc) == len(tc)
    jx, tx = js.scan_inputs(), ts.step_inputs("cpu")
    for i in range(js.num_steps):
        eps = rng.randn(*x.shape).astype(np.float32)
        jc = js.advance({k: v[i] for k, v in jx.items()}, jc, jnp.asarray(eps))
        tc = ts.advance({k: v[i] for k, v in tx.items()}, tc, torch.from_numpy(eps))
        if js.is_ancestral:
            z = rng.randn(*x.shape).astype(np.float32)
            jc = js.replace_latent(jc, js.latent(jc) + jx["noise_sigma"][i] * jnp.asarray(z))
            tc = ts.replace_latent(tc, ts.latent(tc) + tx["noise_sigma"][i] * torch.from_numpy(z))
        for a, b in zip(jc, tc):
            scale = max(1.0, float(np.abs(np.asarray(a)).max()))
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6 * scale, err_msg=f"step {i}")


# ---------------------------------------------------------------------------
# the frozen self-goldens, replayed through the port

GOLDEN_STEPS = (5, 10, 25, 50)
EXT_NAMES = ("euler", "euler_a", "dpm_karras", "euler_karras", "euler_a_karras", "unipc", "unipc_karras",
             "dpm_sde", "dpm_sde_karras", "heun", "heun_karras", "lms", "lms_karras", "dpm_2s_a",
             "dpm_2s_a_karras", "pndm")


def _load(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return json.load(f)


def _replay(name: str, n: int):
    """eps = 0.1 * x through init_carry / latent / advance / replace_latent;
    ancestral noise from RandomState(4321), one draw per substep."""
    solver = tsched.make_solver(tsched.DDPMSchedule.create(), name, n)
    z = np.random.RandomState(1234).randn(2, 4, 4, 4).astype(np.float32)
    carry = solver.init_carry(torch.from_numpy(z) * solver.init_noise_sigma)
    xs = solver.step_inputs("cpu")
    rs = np.random.RandomState(4321)
    noises = [rs.randn(2 * 4 * 4 * 4) for _ in range(solver.num_steps)] if solver.is_ancestral else None
    for i in range(solver.num_steps):
        step = {k: v[i] for k, v in xs.items()}
        carry = solver.advance(step, carry, 0.1 * solver.latent(carry))
        if solver.is_ancestral:
            zi = torch.from_numpy(noises[i].astype(np.float32).reshape(z.shape))
            carry = solver.replace_latent(carry, solver.latent(carry) + step["noise_sigma"] * zi)
    return solver.latent(carry).numpy().astype(np.float64).ravel()


@pytest.mark.parametrize("n", GOLDEN_STEPS)
def test_port_replays_dpm_self_goldens(n):
    run = _load("dpm_goldens_self.json")["runs"][str(n)]
    solver = tsched.DPMSolverMultistep.create(tsched.DDPMSchedule.create(), n)
    np.testing.assert_array_equal(solver.timesteps, np.asarray(run["timesteps"]))
    np.testing.assert_allclose(_replay("dpm", n), np.asarray(run["x_final"]), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("n", GOLDEN_STEPS)
@pytest.mark.parametrize("name", EXT_NAMES)
def test_port_replays_ext_self_goldens(name, n):
    run = _load("sampler_ext_goldens_self.json")[name]["runs"][str(n)]
    solver = tsched.make_solver(tsched.DDPMSchedule.create(), name, n)
    np.testing.assert_allclose(np.asarray(solver.timesteps, np.float64), np.asarray(run["timesteps"]),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(_replay(name, n), np.asarray(run["x_final"]), rtol=2e-5, atol=2e-6,
                               err_msg=f"{name} at {n} steps")


# ---------------------------------------------------------------------------
# the identity mask


@pytest.mark.parametrize("hin,hout", [(512, 64), (512, 32), (512, 16), (512, 8), (16, 32), (48, 16), (32, 32)])
def test_downsample_ip_mask_matches_jax_resize(hin, hout):
    # jax.image.resize(method="cubic"): Keys a = -0.5, antialiased when it
    # shrinks; F.interpolate(mode="bicubic") is another function
    rng = np.random.RandomState(hin + hout)
    m = (rng.rand(2, hin, hin) > 0.5).astype(np.float32)
    m[1] = rng.rand(hin, hin)
    want = np.asarray(jax_downsample(jnp.asarray(m), 2, hout, hout))
    got = _downsample_ip_mask(torch.from_numpy(m), 2, hout, hout)
    assert got.shape == (2, hout * hout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if hout < hin:
        plain = torch.nn.functional.interpolate(torch.from_numpy(m)[:, None], size=(hout, hout), mode="bicubic")
        assert (plain.reshape(2, -1) - got).abs().max() > 1e-2  # the library's bicubic would not do
    w = _cubic_resize_matrix(hin, hout)
    np.testing.assert_allclose(w.sum(axis=0), 1.0, atol=1e-6)
    assert _downsample_ip_mask(None, 2, hout, hout) is None
    wide = _downsample_ip_mask(torch.from_numpy(m[:, : hin // 2]), 2, hout, hout)  # (Hm, Wm) need not be square
    want_wide = np.asarray(jax_downsample(jnp.asarray(m[:, : hin // 2]), 2, hout, hout))
    np.testing.assert_allclose(wide.numpy(), want_wide, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    modules, params = tiny_bundle()
    return modules, params, port_models(modules, params)


def _half_plane(B, size=RES):
    m = np.zeros((B, size, size), np.float32)
    m[:, :, size // 2:] = 1.0
    m[:, : size // 4] *= 0.5
    return m


def test_unet_with_mask_matches_jax(pair):
    modules, params, port = pair
    rng = np.random.RandomState(5)
    B = 2
    x = rng.randn(B, LATENT, LATENT, 4).astype(np.float32)
    t = np.array([500.0, 37.5], np.float32)  # a fractional timestep, as the Euler grids feed
    text = rng.randn(B, 12, 16).astype(np.float32)
    idc = rng.randn(B, 5, 16).astype(np.float32)
    mask = _half_plane(B)
    want, want_n = modules.unet.apply({"params": params.unet}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(text),
                                      jnp.asarray(idc), ip_mask=jnp.asarray(mask))
    with torch.no_grad():
        got, got_n = port.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(text),
                               torch.from_numpy(idc), ip_mask=torch.from_numpy(mask))
        free, _ = port.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(text),
                            torch.from_numpy(idc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=5e-4, atol=5e-5)
    assert (got - free).abs().max() > 1e-3  # the mask acts
    with pytest.raises(ValueError, match="ip_mask has 1 rows"):
        port.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(text), torch.from_numpy(idc),
                  ip_mask=torch.from_numpy(mask[:1]))


# ---------------------------------------------------------------------------
# whole pipelines


def _inputs(B=2):
    rng = np.random.RandomState(11)
    noise = rng.randn(B, LATENT, LATENT, 4).astype(np.float32)
    uncond = rng.randint(0, 64, (B, 12)).astype(np.int32)
    return tiny_batch(B=B), noise, uncond


def _jax_step_noise(keys, n, B):
    """The JAX engine's ancestral noise: row b at step i is
    normal(fold_in(keys[b], i))."""
    return np.stack([
        np.stack([np.asarray(jax.random.normal(jax.random.fold_in(keys[b], i), (LATENT, LATENT, 4)))
                  for b in range(B)]) for i in range(n)])


def _both(modules, params, port, name, steps=3, guidance=2.0, ip_mask=None, from_noised_image=False):
    example, noise, uncond = _inputs()
    B = noise.shape[0]
    rng = jax.random.PRNGKey(7)
    js = jsched.make_solver(modules.schedule, name, steps)
    ts = tsched.make_solver(port.schedule, name, steps)
    kw = dict(guidance_scale=guidance, token_index=0, latent_size=LATENT, from_noised_image=from_noised_image)
    jkw = dict(kw, initial_noise=jnp.asarray(noise), uncond_input_ids=jnp.asarray(uncond))
    tkw = dict(kw, initial_noise=noise, uncond_input_ids=uncond)
    if ip_mask is not None:
        jkw["ip_mask"], tkw["ip_mask"] = jnp.asarray(ip_mask), ip_mask
    if js.is_ancestral:
        keys = jax.random.split(jax.random.PRNGKey(99), B)
        jkw["ancestral_keys"] = keys
        tkw["ancestral_noise"] = _jax_step_noise(keys, js.num_steps, B)
    if from_noised_image:  # the JAX VAE draws its sample noise from the second half of the key
        tkw["vae_noise"] = np.array(jax.random.normal(jax.random.split(rng)[1], noise.shape))
    want = jax_run_inference(modules, params, js, {k: jnp.asarray(v) for k, v in example.items()}, rng, **jkw)
    got = tinf.run_inference(port, ts, example, **tkw)
    return np.asarray(want), got.numpy()


FAST = ["dpm", "euler_a", "unipc", "heun"]
SLOW = [n for n in jsched.SCHEDULER_NAMES if n not in FAST]


@pytest.mark.parametrize("name", FAST + [pytest.param(n, marks=pytest.mark.slow) for n in SLOW])
def test_run_inference_matches_jax_per_sampler(pair, name):
    modules, params, port = pair
    want, got = _both(modules, params, port, name)
    assert got.shape == want.shape == (2, RES, RES, 3)
    assert np.isfinite(got).all() and got.min() >= -1 and got.max() <= 1
    assert np.abs(got - want).max() <= PIXEL_ATOL


@pytest.mark.parametrize("guidance", [1.0, 2.0])
def test_run_inference_with_ip_mask_matches_jax(pair, guidance):
    modules, params, port = pair
    mask = _half_plane(2)
    want, got = _both(modules, params, port, "dpm", guidance=guidance, ip_mask=mask)
    assert np.abs(got - want).max() <= PIXEL_ATOL
    _, free = _both(modules, params, port, "dpm", guidance=guidance)
    assert np.abs(got - free).max() > 10 * PIXEL_ATOL  # the mask acts (doubled under guidance)


@pytest.mark.parametrize("name", ["dpm", "euler"])
def test_run_inference_from_noised_image_matches_jax(pair, name):
    # euler: init_noise_sigma != 1 must not scale the noised image
    modules, params, port = pair
    want, got = _both(modules, params, port, name, from_noised_image=True)
    assert np.abs(got - want).max() <= PIXEL_ATOL
    _, pure = _both(modules, params, port, name)
    assert np.abs(got - pure).max() > 10 * PIXEL_ATOL


def test_fused_tail_is_off_under_a_mask(pair):
    from unittest import mock

    from photoverse_tpu_torch.models import unet as unet_mod

    modules, params, _ = pair
    port = port_models(modules, params, unet_overrides=dict(fused_blocks=True))
    example, noise, _ = _inputs()
    solver = tsched.make_solver(port.schedule, "dpm", 2)
    with mock.patch.object(unet_mod, "fused_cross_ff", wraps=unet_mod.fused_cross_ff) as spy:
        plain = tinf.run_inference(port, solver, example, initial_noise=noise, latent_size=LATENT)
        assert spy.call_count > 0
        spy.reset_mock()
        ones = tinf.run_inference(port, solver, example, initial_noise=noise, latent_size=LATENT,
                                  ip_mask=np.ones((2, RES, RES), np.float32))
        assert spy.call_count == 0
    # an all-ones mask is text + 2 x identity, the fused tail's sum is text + identity
    assert (ones - plain).abs().max() > 10 * PIXEL_ATOL


# ---------------------------------------------------------------------------
# ancestral noise per batch row


@pytest.mark.parametrize("name", ["euler_a", "dpm_sde"])
def test_ancestral_rows_do_not_depend_on_their_batch(pair, name):
    """The serving invariant: a row's image is a function of its own
    starting noise and its own generator, not of the batch it ran in."""
    _, _, port = pair
    solver = tsched.make_solver(port.schedule, name, 4)
    batch = tiny_batch(B=2, seed=3)
    noise = np.random.RandomState(5).randn(2, LATENT, LATENT, 4).astype(np.float32)
    kw = dict(guidance_scale=1.0, token_index=0, latent_size=LATENT)
    gens = lambda: tinf.make_row_generators(42, 2, "cpu")  # noqa: E731
    imgs2 = tinf.run_inference(port, solver, batch, initial_noise=noise, row_generators=gens(), **kw)
    one = {k: v[1:] for k, v in batch.items()}
    imgs1 = tinf.run_inference(port, solver, one, initial_noise=noise[1:], row_generators=gens()[1:], **kw)
    np.testing.assert_allclose(imgs2[1].numpy(), imgs1[0].numpy(), rtol=0, atol=1e-5)
    # and the noise flows: another generator, another image
    alt = tinf.run_inference(port, solver, one, initial_noise=noise[1:],
                             row_generators=tinf.make_row_generators(7, 1, "cpu"), **kw)
    assert (alt - imgs1).abs().max() > 1e-4


def test_row_generators_derive_from_the_seed(pair):
    _, _, port = pair
    solver = tsched.make_solver(port.schedule, "euler_a", 3)
    batch = tiny_batch(B=2, seed=4)
    kw = dict(guidance_scale=1.0, latent_size=LATENT)
    a = tinf.run_inference(port, solver, batch, torch.Generator().manual_seed(9), **kw)
    b = tinf.run_inference(port, solver, batch, torch.Generator().manual_seed(9), **kw)
    c = tinf.run_inference(port, solver, batch, torch.Generator().manual_seed(10), **kw)
    assert torch.equal(a, b) and (a - c).abs().max() > 1e-3
    # spelled out: the starting noise from the generator, row r's step noise
    # from a generator seeded row_seed(seed, r), all N steps in one draw
    g = torch.Generator().manual_seed(9)
    noise = tinf.draw_initial_noise(g, (2, LATENT, LATENT, 4), "cpu")
    step_noise = torch.stack([
        torch.randn((3, LATENT, LATENT, 4), generator=torch.Generator().manual_seed(tinf.row_seed(9, r)))
        for r in range(2)], dim=1)
    d = tinf.run_inference(port, solver, batch, initial_noise=noise, ancestral_noise=step_noise, **kw)
    assert torch.equal(a, d)
    seeds = {tinf.row_seed(s, r) for s in range(50) for r in range(8)}
    assert len(seeds) == 400 and all(0 <= s < 2**63 for s in seeds)


def test_denoise_refuses_an_ancestral_solver_without_noise(pair):
    _, _, port = pair
    solver = tsched.make_solver(port.schedule, "euler_a", 2)
    lat = torch.zeros(2, LATENT, LATENT, 4)
    ctx = torch.zeros(2, 12, 16), torch.zeros(2, 5, 16)
    with pytest.raises(ValueError, match="one generator per batch row"):
        tinf.denoise(port, solver, lat, *ctx, None, None, 1.0)
    with pytest.raises(ValueError, match="one generator per batch row"):
        tinf.denoise(port, solver, lat, *ctx, None, None, 1.0, row_generators=tinf.make_row_generators(0, 1, "cpu"))
    with pytest.raises(ValueError, match="ancestral_noise is"):
        tinf.denoise(port, solver, lat, *ctx, None, None, 1.0, ancestral_noise=torch.zeros(3, 2, LATENT, LATENT, 4))
