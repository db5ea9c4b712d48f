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

import contextlib
import dataclasses
import os
import signal
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# seconds a launch of ranks may take before every rank is killed: a guard
# against a hung collective, not a time limit of the work. Under the suite's
# 6-worker load a launch takes up to about 2.5x its time on an idle host
# (the multi-rank training tests' ranks: 139 s, 90 s idle)
RANK_TIMEOUT_S = 300


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


def _rows(batch, mesh, face_rows=None):
    """This data rank's rows of a whole batch (the face keys by the face
    sub-batch's rows)."""
    from photoverse_tpu_torch.parallel.mesh import host_batch_slice

    out = {}
    for k, v in batch.items():
        n = len(v)
        out[k] = v[host_batch_slice(n, mesh)]
    return out


def _task_train(mesh, spec):
    """Micro-steps of the port's train step on this rank's share of the
    spec's models (`shard_training` with the spec's flags): each step's
    whole batch and draws come in the spec, every rank keeps its rows.
    Returns the metrics of every micro-step and, for the first optimizer
    step, the data-mean gradient the clip saw and the trainables after the
    update, both gathered whole. A planted `fault` breaks one collective of
    the sharded step. The models' state comes from the file `state_path`
    (one file for many tasks: a tiny bundle's adapters are full width)."""
    from unittest import mock

    import torch

    from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
    from photoverse_tpu_torch.engine import training as ttr
    from photoverse_tpu_torch.models import layers, unet
    from photoverse_tpu_torch.models.assembly import build_models
    from photoverse_tpu_torch.parallel import fsdp
    from photoverse_tpu_torch.parallel.training import TrainLayout, shard_training

    models = build_models(**spec["build"], device="cpu")
    models.load_state_dict(torch.load(spec["state_path"], weights_only=True))
    cfg = ttr.TrainConfig(**spec["cfg"])
    _, _, optimizer = ttr.init_train_state(models, cfg)
    optimizer = shard_training(models, optimizer, mesh, fsdp=spec.get("fsdp", False),
                               zero1=spec.get("zero1", False), min_size=spec.get("min_size", 2**16))
    layout = optimizer.layout
    kw = {}
    if spec.get("arcface") is not None:
        from photoverse_tpu_torch.models.arcface import ArcFaceConfig, ArcFaceResNet18
        from photoverse_tpu_torch.models.face_loss import FaceLoss, make_face_loss_fn

        arc = ArcFaceResNet18(ArcFaceConfig(**spec["arcface"]["config"]), device="cpu")
        arc.load_state_dict(spec["arcface"]["state"])
        kw = dict(face_loss_fn=make_face_loss_fn(FaceLoss(arc.requires_grad_(False))),
                  face_solver=DPMSolverMultistep.create(models.schedule, cfg.face_loss_timesteps))
    step = ttr.TrainStep(models, cfg, optimizer, **kw)
    seen = []
    real_clip = ttr.clip_groups

    def clip(grads, *a, **k):
        seen.append({n: layout.gather(n, g).clone() for n, g in grads.items()})
        return real_clip(grads, *a, **k)

    patches = [mock.patch.object(ttr, "clip_groups", clip)]
    spread = [0.0]
    if mesh.mp > 1:  # a replicated trainable's gradient must be whole, so equal, on every model rank
        def clip_and_spread(grads, *a, **k):
            for n, g in grads.items():
                if layout.placements[n].model is None:
                    every = mesh.model_comm.all_gather(g[None], 0)
                    spread[0] = max(spread[0], float((every - g[None]).abs().max()))
            return clip(grads, *a, **k)

        patches = [mock.patch.object(ttr, "clip_groups", clip_and_spread)]
    fault = spec.get("fault")
    if fault == "no_f":  # column-parallel inputs without the backward sum
        patches += [mock.patch.object(m, "copy_to_model", lambda x, comm: x) for m in (unet, layers)]
    elif fault == "summed":  # the data group's gradients summed, not averaged
        real_reduce = TrainLayout.reduce_grads

        def summed(self, acc):
            real_reduce(self, acc)
            for g in acc.values():
                g.mul_(self.mesh.dp)

        patches.append(mock.patch.object(TrainLayout, "reduce_grads", summed))
    elif fault == "zero1_no_gather":  # the updated slices gathered but never written
        def no_write(self, params, slices):
            self.mesh.data_comm.all_gather(torch.cat([t.reshape(-1) for t in slices.values()]), 0)

        patches.append(mock.patch.object(TrainLayout, "gather_slices", no_write))
    elif fault == "local_masks":  # dropout masks drawn at the rank's shape, not cut from the batch's
        real_draws = TrainLayout.local_draws

        def local_masks(self, draws, rows, face_rows):
            out = real_draws(self, draws, rows, face_rows)
            for d in (out, out.get("face", {})):
                if isinstance(d.get("dropout"), layers.RowGenerator):
                    d["dropout"] = d["dropout"].generator
            return out

        patches.append(mock.patch.object(TrainLayout, "local_draws", local_masks))
    elif fault == "stale_fsdp":  # the forward gathers each shard's value from before the update
        stale, real_gather = {}, fsdp.gather_shard

        def gather_stale(t, comm, dim):
            old = stale.setdefault(id(t), t.detach().clone())
            return real_gather(old + (t - t.detach()), comm, dim)  # the old value, the live gradient

        patches.append(mock.patch.object(fsdp, "gather_shard", gather_stale))
    out = {"metrics": [], "grads": [], "trainables": [], "placements": layout.placements}
    for batch, draws in spec["steps"]:
        local = _rows(batch, mesh)
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            metrics = step(local, _torch_tree(draws))
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        if optimizer.mini_step == 0 and not out["grads"]:
            out["grads"].append(seen[-1])
            out["trainables"].append({k: layout.gather(k, p.detach()).clone() for k, p in step.trainable.items()})
    out["replicated_spread"] = spread[0]
    return out


def _torch_tree(d):
    import torch

    if d is None or isinstance(d, torch.Generator):
        return d
    if isinstance(d, dict):
        return {k: _torch_tree(v) for k, v in d.items()}
    if isinstance(d, (int,)):  # a dropout seed: the generator it seeds
        return torch.Generator().manual_seed(d)
    return torch.as_tensor(d)


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
    the spec's file:// store instead of the launcher's address. With
    `step_keyed_draws` each micro-step's draws come from a generator seeded
    by the run's seed plus the micro-step's index since step 0 (a resumed
    run reseeds with seed + step: the same index), so that a resumed run
    and an uninterrupted one draw alike."""
    import contextlib
    import functools
    import importlib
    from unittest import mock

    import torch

    from photoverse_tpu_torch.engine import training as ttr
    from photoverse_tpu_torch.parallel import mesh as pm

    cli = importlib.import_module(f"photoverse_tpu_torch.cli.{spec['cli']}")
    keyed = contextlib.nullcontext()
    if spec.get("step_keyed_draws"):
        real, calls = ttr.make_draws, [0]

        def draws(gen, *a, **kw):
            g = torch.Generator(device=gen.device).manual_seed(1000 + gen.initial_seed() + calls[0])
            calls[0] += 1
            return real(g, *a, **kw)

        keyed = mock.patch.object(ttr, "make_draws", draws)
    with mock.patch.object(pm, "open_mesh", functools.partial(pm.open_mesh, init_method=spec["init"])), keyed:
        cli.main(spec["argv"])
    print(f"[rank] {spec['cli']} returned", flush=True)


RANK_TASKS = {"flash": _task_flash, "inference": _task_inference, "train": _task_train}
GRAD_TASKS = ("train",)


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
            with contextlib.nullcontext() if spec["task"] in GRAD_TASKS else torch.inference_mode():
                out = RANK_TASKS[spec["task"]](mesh, spec)
            if mesh.rank == 0:
                torch.save(out, spec["out"])
        finally:
            pm.close_mesh(mesh)
