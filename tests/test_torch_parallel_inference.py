"""The port's sharded run_inference on gloo ranks (2, or 4 for the 2 x 2
mesh and sp 4) against the port's one-process run (2e-4, the JAX package's
own bound for its sharded runs, tests/test_tp.py) and the JAX package's
one-process run (1e-3, as tests/test_torch_pipeline.py), on the tiny
bundle: 4 steps, guidance 2, the flash route at every level (flash_min_seq
64), f32 on the CPU. Each case runs the same code the generate CLI runs
under --sharding (engine.inference.run_inference_sharded after
parallel.shard_models); the draws are the one-process run's, made whole in
this process, and every rank's weights come from the converter through a
saved state dict.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photoverse_tpu.core import schedulers as jsched
from photoverse_tpu.engine.inference import run_inference as jax_run_inference
from photoverse_tpu_torch.core.schedulers import make_solver
from photoverse_tpu_torch.engine.inference import run_inference
from tests.tiny_models import LATENT, RES, tiny_batch, tiny_bundle
from tests.torch_tiny import port_configs, port_models, run_ranks

STEPS = 4
GUIDANCE = 2.0
SHARDED_ATOL = 2e-4
JAX_ATOL = 1e-3
FLASH = dict(use_flash_attention=True, flash_min_seq=64)
B = 3  # odd: the data split pads it to 4


def _mask():
    m = np.zeros((B, RES, RES), np.float32)
    m[:, :, RES // 3:] = 1.0  # the identity acts on the right two thirds
    return m


@pytest.fixture(scope="module")
def setup():
    modules, params = tiny_bundle()
    port = port_models(modules, params, unet_overrides=FLASH)
    rng = np.random.RandomState(11)
    inputs = dict(example=tiny_batch(B=B), noise=rng.randn(B, LATENT, LATENT, 4).astype(np.float32),
                  uncond=rng.randint(0, 64, (B, 12)).astype(np.int32))
    return modules, params, port, inputs, {}


def _references(setup, scheduler, mask):
    """(JAX one-process images, port one-process images, the draws), once
    per (scheduler, mask)."""
    modules, params, port, inp, cache = setup
    if (scheduler, mask) in cache:
        return cache[(scheduler, mask)]
    ip_mask = _mask() if mask else None
    js = jsched.make_solver(modules.schedule, scheduler, STEPS)
    draws = {"initial_noise": inp["noise"]}
    jkw = dict(initial_noise=jnp.asarray(inp["noise"]), uncond_input_ids=jnp.asarray(inp["uncond"]))
    if js.is_ancestral:  # the JAX engine's step noise: normal(fold_in(keys[b], i)), passed whole
        keys = jax.random.split(jax.random.PRNGKey(99), B)
        jkw["ancestral_keys"] = keys
        draws["ancestral_noise"] = np.stack([np.stack([
            np.asarray(jax.random.normal(jax.random.fold_in(keys[b], i), (LATENT, LATENT, 4))) for b in range(B)])
            for i in range(STEPS)])
    if mask:
        jkw["ip_mask"] = jnp.asarray(ip_mask)
    kw = dict(guidance_scale=GUIDANCE, token_index=0, latent_size=LATENT)
    want = np.asarray(jax_run_inference(modules, params, js, {k: jnp.asarray(v) for k, v in inp["example"].items()},
                                        jax.random.PRNGKey(0), **kw, **jkw))
    solo = run_inference(port, make_solver(port.schedule, scheduler, STEPS), inp["example"],
                         initial_noise=inp["noise"], ancestral_noise=draws.get("ancestral_noise"),
                         uncond_input_ids=inp["uncond"], ip_mask=ip_mask, **kw).numpy()
    cache[(scheduler, mask)] = (want, solo, draws)
    return cache[(scheduler, mask)]


CASES = {  # id: (mode, dp, mp, scheduler, identity mask)
    "data": ("data", 2, 1, "dpm", False),
    "tensor": ("tensor", 1, 2, "dpm", False),
    "spatial": ("spatial", 1, 2, "dpm", False),
    "spatial_sp4": ("spatial", 1, 4, "dpm", False),
    "tensor_2x2": ("tensor", 2, 2, "dpm", False),
    "tensor_euler_a": ("tensor", 1, 2, "euler_a", False),
    "spatial_mask": ("spatial", 1, 2, "dpm", True),
}
FAULTS = ("zero_halos", "local_kv")  # planted in a spatial 1 x 2 run's ranks


def _spec(setup, mode, dp, mp, scheduler, mask, **extra):
    modules, params, port, inp, _ = setup
    _, _, draws = _references(setup, scheduler, mask)
    kwargs = dict(guidance_scale=GUIDANCE, token_index=0, latent_size=LATENT, uncond_input_ids=inp["uncond"],
                  ip_mask=_mask() if mask else None)
    # data runs every kernel route as one process; tensor / spatial load
    # with flash off and take it back through the sharded wrapper
    return dict(task="inference", mode=mode, dp=dp, mp=mp, flash=mode != "data", flash_min_seq=64,
                build=port_configs(modules, unet_overrides=FLASH if mode == "data" else {}),
                state=port.state_dict(), scheduler=scheduler, steps=STEPS, example=inp["example"],
                draws=draws, kwargs=kwargs, **extra)


JOBS_PER_LAUNCH = 4  # keeps each launch well inside its time limit under a loaded host


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """Every case's images: the 2-rank cases and the planted faults on
    pairs of ranks, the 4-rank cases on one set of four, a few jobs to a
    launch."""
    jobs = {case: _spec(setup, *CASES[case]) for case in CASES}
    jobs.update({fault: _spec(setup, "spatial", 1, 2, "dpm", False, fault=fault) for fault in FAULTS})
    out = {}
    for world in (2, 4):
        names = [n for n, spec in jobs.items() if spec["dp"] * spec["mp"] == world]
        for i in range(0, len(names), JOBS_PER_LAUNCH):
            part = names[i:i + JOBS_PER_LAUNCH]
            got = run_ranks([jobs[n] for n in part], world, tmp_path_factory.mktemp(f"ranks{world}_"))
            out.update({n: g.numpy() for n, g in zip(part, got)})
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_run_inference_matches_one_process(setup, runs, case):
    _, _, _, scheduler, mask = CASES[case]
    want, solo, _ = _references(setup, scheduler, mask)
    got = runs[case]
    assert got.shape == solo.shape == (B, RES, RES, 3) and np.isfinite(got).all()
    assert np.abs(got - solo).max() <= SHARDED_ATOL
    assert np.abs(got - want).max() <= JAX_ATOL


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_spatial_split_reads_above_the_limit(setup, runs, fault):
    """The comparison catches a spatial split that drops its halo rows or
    attends local keys only (planted in the ranks)."""
    _, solo, _ = _references(setup, "dpm", False)
    assert np.abs(runs[fault] - solo).max() > 100 * SHARDED_ATOL
