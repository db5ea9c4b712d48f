"""The PyTorch port built at the configuration of a JAX model bundle, with the
JAX bundle's weights (used by the tests/test_torch_*.py parity tests), and
the launcher of the gloo ranks that the tests/test_torch_parallel*.py
tests run on the CPU.

A rank process imports no JAX: `rank_main` (run as
`python -c "from tests.torch_tiny import rank_main; rank_main()" spec0.pt
spec1.pt ...`) runs each task in turn: it builds the port from the configs
and state dict saved in a spec, opens its process group through the spec's
file:// store and runs the task, or runs a CLI's main(argv). One set of
processes serves a test module's tasks: a rank's start (torch's import
alone) costs more than its tiny task.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 120


def _mirror(port_cls, jax_cfg, **overrides):
    """Port config with every field the JAX config also has copied over."""
    names = {f.name for f in dataclasses.fields(port_cls)}
    kw = {k: getattr(jax_cfg, k) for k in names if hasattr(jax_cfg, k)}
    kw.update(overrides)
    return port_cls(**kw)


def port_configs(modules, unet_overrides=None, vae_overrides=None) -> dict:
    """build_models' configuration arguments for the port at a JAX
    bundle's configuration."""
    from photoverse_tpu_torch.models import clip, unet, vae

    return dict(
        extra_num_tokens=modules.num_tokens - 1,
        image_encoder_layers_idx=modules.image_encoder_layers_idx,
        unet_config=_mirror(unet.UNetConfig, modules.unet.config, **(unet_overrides or {})),
        vae_config=_mirror(vae.VAEConfig, modules.vae.config, **(vae_overrides or {})),
        text_config=_mirror(clip.CLIPTextConfig, modules.text_encoder.config),
        vision_config=_mirror(clip.CLIPVisionConfig, modules.vision_encoder.config),
    )


def port_models(modules, params, unet_overrides=None, vae_overrides=None):
    """Port PhotoVerseModels (f32, CPU) mirroring a JAX (modules, params)."""
    import jax

    from photoverse_tpu_torch.convert.from_jax import load_jax_params
    from photoverse_tpu_torch.models import assembly

    models = assembly.build_models(**port_configs(modules, unet_overrides, vae_overrides), device="cpu")
    load_jax_params(models, jax.tree.map(np.asarray, params))
    return models


class Processes:
    """The commands `cmds`, started at once (the repository root as their
    working directory, one thread each, each in a session of its own so
    that it is killed with its children); their output goes to
    `workdir`/proc{i}.log."""

    def __init__(self, cmds, workdir, envs=None):
        os.makedirs(workdir, exist_ok=True)
        self.paths = [os.path.join(workdir, f"proc{i}.log") for i in range(len(cmds))]
        self.procs = []
        for i, cmd in enumerate(cmds):
            env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT, **((envs or [{}] * len(cmds))[i]))
            with open(self.paths[i], "w") as log:
                self.procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
                                                   start_new_session=True))

    def output(self, i: int) -> str:
        with open(self.paths[i]) as f:
            return f.read()

    def failed(self) -> bool:
        return any(p.poll() not in (None, 0) for p in self.procs)

    def wait(self, deadline: float):
        """Wait until every process has ended, one has failed or the
        monotonic clock passes `deadline`; then kill what still runs. Raises
        AssertionError with the exit codes and the end of each output
        unless every process exited with 0. Returns the outputs."""
        timed_out = False
        try:
            while any(p.poll() is None for p in self.procs) and not self.failed():
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            self.kill()
        outs = [self.output(i) for i in range(len(self.procs))]
        codes = [p.returncode for p in self.procs]
        if timed_out or any(codes):
            tails = "\n".join(f"--- process {i} (exit {c}) ---\n{o[-3000:]}" for i, (c, o) in enumerate(zip(codes, outs)))
            raise AssertionError(f"{'timed out; ' if timed_out else ''}exit codes {codes}\n{tails}")
        return outs

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def run_processes(cmds, workdir, timeout=RANK_TIMEOUT_S, envs=None):
    """Run `cmds` at once (`Processes`) and wait at most `timeout` seconds
    for all of them; returns their outputs (AssertionError on a failure)."""
    return Processes(cmds, workdir, envs).wait(time.monotonic() + timeout)


def rank_envs(world: int, **extra):
    """The launcher's variables for ranks 0..world-1 on one host."""
    return [dict(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world), **extra)
            for r in range(world)]


def start_ranks(specs, world: int, workdir):
    """Start `rank_main` on `world` gloo ranks for the tasks `specs`, run
    one after another in the same processes (each opens its own process
    group through a file:// store in `workdir`, the CLI tasks too).
    Returns (the rank commands, their variables, the specs as saved)."""
    import torch

    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    paths, saved = [], []
    for i, spec in enumerate(specs):
        spec = dict(spec, init=f"file://{os.path.join(workdir, f'store{i}')}",
                    out=os.path.join(workdir, f"out{i}.pt"))
        paths.append(os.path.join(workdir, f"spec{i}.pt"))
        torch.save(spec, paths[-1])
        saved.append(spec)
    cmd = [sys.executable, "-c", "from tests.torch_tiny import rank_main; rank_main()", *paths]
    return [cmd] * world, rank_envs(world), saved


def run_ranks(specs, world: int, workdir, timeout=RANK_TIMEOUT_S):
    """Run the tasks `specs` on `world` gloo ranks (`start_ranks`) and
    return what rank 0's task returned for each."""
    import torch

    cmds, envs, saved = start_ranks(specs, world, workdir)
    run_processes(cmds, workdir, timeout, envs)
    return [torch.load(spec["out"], weights_only=False) for spec in saved]


def _task_flash(mesh, spec):
    """sharded_flash on this rank's share of the spec's (q, k, v): its heads
    under tensor, its sequence block under spatial; the outputs gathered."""
    import torch

    from photoverse_tpu_torch.parallel.flash import sharded_flash

    dim = 2 if spec["mode"] == "tensor" else 1
    q, k, v = (torch.as_tensor(spec[n]).chunk(mesh.mp, dim=dim)[mesh.model_rank] for n in ("q", "k", "v"))
    out = sharded_flash(mesh.model_comm, spec["mode"])(q, k, v)
    return mesh.model_comm.all_gather(out, dim)


def _task_inference(mesh, spec):
    """run_inference_sharded on the spec's models and inputs."""
    import torch

    from photoverse_tpu_torch.core.schedulers import make_solver
    from photoverse_tpu_torch.engine.inference import run_inference_sharded
    from photoverse_tpu_torch.models.assembly import build_models
    from photoverse_tpu_torch.parallel import shard_models

    models = build_models(**spec["build"], device="cpu")
    models.load_state_dict(spec["state"])
    spatial = shard_models(models, mesh, spec["mode"], flash=spec["flash"], flash_min_seq=spec.get("flash_min_seq"))
    if spec.get("fault") == "zero_halos":  # planted: every halo row zero
        spatial.halos = lambda x: (torch.zeros_like(x[:, :, :1]),) * 2
    elif spec.get("fault") == "local_kv":  # planted: flash on the local keys only
        from photoverse_tpu_torch.ops.flash_sdpa import flash_sdpa

        models.unet.set_config(dataclasses.replace(models.unet.config, flash_fn=flash_sdpa))
    solver = make_solver(models.schedule, spec["scheduler"], spec["steps"])
    draws = {k: torch.as_tensor(v) for k, v in spec["draws"].items()}
    return run_inference_sharded(models, solver, spec["example"], None, mesh, spatial, draws=draws,
                                 **spec["kwargs"])


def _cli(spec):
    """A CLI's main(argv) on this rank, its process group opened through
    the spec's file:// store instead of the launcher's address."""
    import functools
    import importlib
    from unittest import mock

    from photoverse_tpu_torch.parallel import mesh as pm

    cli = importlib.import_module(f"photoverse_tpu_torch.cli.{spec['cli']}")
    with mock.patch.object(pm, "open_mesh", functools.partial(pm.open_mesh, init_method=spec["init"])):
        cli.main(spec["argv"])
    print(f"[rank] {spec['cli']} returned", flush=True)


RANK_TASKS = {"flash": _task_flash, "inference": _task_inference}


def rank_main():
    """Run each spec file named on the command line, in order."""
    import torch

    from photoverse_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    for path in sys.argv[1:]:
        spec = torch.load(path, weights_only=False)
        if spec["task"] == "cli":
            _cli(spec)
            continue
        mesh = pm.open_mesh(spec["dp"], spec["mp"], cpu=True, init_method=spec["init"])
        try:
            with torch.inference_mode():
                out = RANK_TASKS[spec["task"]](mesh, spec)
            if mesh.rank == 0:
                torch.save(out, spec["out"])
        finally:
            pm.close_mesh(mesh)
