"""The port's multi-rank training (parallel/training.py, parallel/fsdp.py and
the Megatron f and g of parallel/mesh.py) on CPU gloo ranks, f32, on the
tiny bundle with LoRA rank 4 and random lora_B (so lora_A has a gradient):

  * against the JAX package's sharded train step on the suite's 8 virtual
    CPU devices, built as tests/test_tp.py, tests/test_parallel.py and
    tests/test_sharded_flash.py build it: DP 2 with ZeRO-1, TP 2 (plain
    attention and the flash route, whose plain functions the port's
    wrapper takes on the CPU; the JAX side in Pallas interpret mode), FSDP
    2, and FSDP x TP 2 x 2 on four ranks. The same batches, and the JAX
    step's draws passed to the port (tests/test_torch_train.py:_jax_draws),
    for two optimizer steps;
  * DP 2 at LoRA dropout 0.1 with the face branch (the [uncond; cond]
    batch included) against one process of the port: the masks are drawn
    for the whole batch and cut to each rank's rows;
  * planted faults, each of which must fail its comparison.

Limits (the JAX tests' own): loss rtol 1e-4 at both steps (the second
step's loss is where a forward on stale weights shows); the trainables
after the first update rtol / atol 2e-4; the data-mean gradient the clip
sees 2e-3 of each leaf's largest |g| (tests/test_torch_train.py's
cross-framework limit). One Adam step is nearly blind to a gradient's
scale, so the gradient is compared itself. AdamW runs the recipe's
epsilon 1e-8. Its first update moves an element by lr g / (|g| + eps), so
where |g| is near eps (about 1e-9 beside a leaf maximum of 1e-3) a
gradient difference of f32 summation order moves the update by up to
lr: such elements (|g| below UPDATE_FLOOR = 1e-5 of the leaf's largest
in the JAX gradient; 267,363 to 298,935 of the 21,758,272 trainable
elements) are held by the gradient check alone, and `_worst` reports the
update reading among them.

All cases of a world size run on one set of ranks (tests/torch_tiny.py:
run_ranks; a rank's torch import costs more than its task), started before
the JAX steps are compiled in this process.
"""

import dataclasses
import shutil
import time
from unittest import mock

import jax
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from photoverse_tpu.engine import training as jtr
from photoverse_tpu.parallel.flash import enable_sharded_flash as jax_enable_sharded_flash
from photoverse_tpu.parallel.fsdp import fsdp_shardings, fsdp_spec
from photoverse_tpu.parallel.mesh import DATA_AXIS, batch_sharding, make_mesh, replicated, shard_batch
from photoverse_tpu.parallel.mesh import zero1_sharding
from photoverse_tpu.parallel.tp import make_mesh_2d, tree_tp_shardings
from photoverse_tpu_torch.ckpt.checkpoint import partition_params
from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
from photoverse_tpu_torch.engine import training as ttr
from photoverse_tpu_torch.models.arcface import ArcFaceConfig, ArcFaceResNet18, init_arcface
from photoverse_tpu_torch.models.face_loss import FaceLoss, make_face_loss_fn
from photoverse_tpu_torch.parallel.fsdp import flax_order, fsdp_dim
from photoverse_tpu_torch.parallel.mesh import zero1_dim
from photoverse_tpu_torch.parallel.training import MODELS
from tests.test_torch_train import _jax_draws, _lora_params, _port_grads_as_leaves, _recorder
from tests.tiny_models import LATENT, tiny_batch, tiny_bundle
from tests.torch_tiny import RANK_TIMEOUT_S, Processes, _torch_tree, port_configs, port_models, start_ranks
from tests.torch_threads import worker_threads  # noqa: F401

CFG = dict(max_train_steps=5, lr_warmup_steps=1, learning_rate=1e-3)
B = 4
LOSS_RTOL = 1e-4
PARAM_TOL = 2e-4
GRAD_REL = 2e-3
UPDATE_FLOOR = 1e-5
FLASH = dict(use_flash_attention=True, flash_min_seq=64)

# case: (rank flags, the JAX case it is held to); FSDP shards every leaf of
# at least 8 elements (the JAX tests' min_size) so that the tiny model shards
JAX_CASES = {
    "dp_zero1": dict(dp=2, mp=1, zero1=True),
    "tp": dict(dp=1, mp=2),
    "tp_flash": dict(dp=1, mp=2),
    "fsdp": dict(dp=2, mp=1, fsdp=True, min_size=8),
    "fsdp_tp": dict(dp=2, mp=2, fsdp=True, min_size=8),
}
# planted fault: (rank flags, the case whose reference it must miss)
FAULTS = {
    "no_f": (dict(dp=1, mp=2), "tp"),  # column-parallel inputs without the backward sum
    "summed": (dict(dp=2, mp=1), "dp_zero1"),  # the data group's gradients summed, not averaged
    "zero1_no_gather": (dict(dp=2, mp=1, zero1=True), "dp_zero1"),  # updated slices never gathered
    "stale_fsdp": (dict(dp=2, mp=1, fsdp=True, min_size=8), "fsdp"),  # the forward on the shards' old values
    "local_masks": (dict(dp=2, mp=1), "dropout"),  # dropout masks drawn at the rank's shape
}


def _port_steps(L, keys):
    """The two micro-steps' batches and the JAX step's draws (no dropout)."""
    steps = []
    for i, key in enumerate(keys):
        d = _jax_draws(key, B, L, 0, 0)
        d["dropout"] = None
        steps.append((tiny_batch(B=B, seed=3 + i), d))
    return steps


def _dropout_steps(L):
    """Two micro-steps with a face sub-batch of one row from each rank's
    half and the port's own draws (dropout generators as seeds)."""
    steps = []
    for i in range(2):
        batch = tiny_batch(B=B, seed=13 + i)
        rows = [0, 2]
        for k in ("pixel_values", "pixel_values_clip", "text_input_ids", "concept_placeholder_idx"):
            batch["face_" + k] = batch[k][rows]
        batch["face_uncond_input_ids"] = np.random.RandomState(20 + i).randint(0, 64, (2, 12)).astype(np.int32)
        d = ttr.make_draws(torch.Generator().manual_seed(10 + i), B, LATENT, L, face_rows=2)
        to_np = lambda x, seed: {k: v.numpy() if isinstance(v, torch.Tensor) else seed  # noqa: E731
                                 for k, v in x.items() if k != "face"}
        dd = to_np(d, 1000 + i)
        dd["face"] = to_np(d["face"], 2000 + i)
        steps.append((batch, dd))
    return steps


def _jax_case(case, modules, params, steps_jax):
    """Two optimizer steps of the JAX package's sharded step: {"loss",
    "grads" (the recorder's raw gradients), "trainables"} per step."""
    mp = JAX_CASES[case]["mp"]
    dp = JAX_CASES[case]["dp"]
    over = dict(FLASH) if case == "tp_flash" else {}
    if mp > 1:
        over["tp_friendly_ffn"] = True
    jm = dataclasses.replace(modules, unet=type(modules.unet)(dataclasses.replace(modules.unet.config, **over),
                                                               dtype=modules.unet.dtype))
    mesh = make_mesh_2d(dp, mp) if mp > 1 else make_mesh(dp)
    if case == "tp_flash":
        jm = jax_enable_sharded_flash(jm, mesh, "tensor", flash_min_seq=64)
    cfg = jtr.TrainConfig(**CFG)
    tx = optax.chain(_recorder(), jtr.make_optimizer(cfg)[0])
    trainable, frozen, opt_state = jtr.init_train_state(jm, params, tx)
    repl = replicated(mesh)
    if case == "dp_zero1":
        t_sh, f_sh, o_sh = repl, repl, zero1_sharding(mesh, opt_state)
    elif case in ("tp", "tp_flash"):
        t_sh, f_sh, o_sh = (tree_tp_shardings(mesh, x) for x in (trainable, frozen, opt_state))
    elif case == "fsdp":
        t_sh, f_sh, o_sh = (fsdp_shardings(mesh, x, min_size=8) for x in (trainable, frozen, opt_state))
    else:
        t_sh, f_sh, o_sh = (fsdp_shardings(mesh, x, base=tree_tp_shardings(mesh, x), min_size=8)
                            for x in (trainable, frozen, opt_state))
    def put(x, sh):
        return jax.tree.map(jax.device_put, x, sh) if isinstance(sh, dict) else jax.device_put(x, sh)

    jstep = jax.jit(jtr.make_train_step(jm, cfg, tx, latent_size=LATENT),
                    in_shardings=(t_sh, f_sh, o_sh, batch_sharding(mesh), repl), out_shardings=(t_sh, o_sh, repl))
    t, f, o = put(trainable, t_sh), put(frozen, f_sh), put(opt_state, o_sh)
    out = {"loss": [], "grads": [], "trainables": []}
    with pltpu.force_tpu_interpret_mode():
        for batch, key in steps_jax:
            t, o, metrics = jstep(t, f, o, shard_batch(mesh, batch), key)
            out["loss"].append(float(metrics["loss"]))
            if not out["grads"]:
                out["grads"].append(jax.device_get(o[0]["g"]))
                out["trainables"].append(jax.device_get(t))
    return out, frozen


def _ratio(got, want, rtol, atol):
    """max |got - want| / (atol + rtol |want|): at most 1 within the limit."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


def _worst(out, ref) -> dict:
    """The largest reading of each check against its limit (1 = at it),
    and the trainable where the update's reading is largest: (name, port,
    JAX, port gradient, JAX gradient, |JAX gradient| / the leaf's largest).
    The update is read where the JAX gradient is at least UPDATE_FLOOR of
    its leaf's largest; `floored` counts the elements left to the gradient
    check and gives the update reading among them."""
    names = list(ref["trainables"][0])
    moved, floored, at = {}, [0, 0.0], {}
    for k in names:
        got, want = out["trainables"][0][k].numpy(), ref["trainables"][0][k]
        g = np.abs(ref["grads"][0][k])
        r = np.abs(got.astype(np.float64) - want) / (PARAM_TOL + PARAM_TOL * np.abs(want.astype(np.float64)))
        held = g >= UPDATE_FLOOR * g.max()
        if not held.all():
            floored = [floored[0] + int((~held).sum()), max(floored[1], float(r[~held].max()))]
        moved[k] = float(r[held].max()) if held.any() else 0.0
        i = int(np.where(held, r, -1.0).argmax())
        at[k] = (k, float(got.flat[i]), float(want.flat[i]), float(out["grads"][0][k].numpy().flat[i]),
                 float(ref["grads"][0][k].flat[i]), float(g.flat[i] / g.max()) if g.max() > 0 else 0.0)
    worst_k = max(moved, key=moved.get)
    return {
        "loss": max(_ratio(out["metrics"][i]["loss"], ref["loss"][i], LOSS_RTOL, 0.0) for i in range(2)),
        "grads": float(max(np.abs(out["grads"][0][k].numpy() - ref["grads"][0][k]).max()
                           / (GRAD_REL * np.abs(ref["grads"][0][k]).max() + 1e-12) for k in names)),
        "trainables": moved[worst_k],
        "at": at[worst_k],
        "floored": tuple(floored),
    }


def _spec(build, state, steps, flags, **extra):
    return dict(task="train", build=build, state_path=state, cfg=extra.pop("cfg", CFG), steps=steps, **flags,
                **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (the ranks' output, the reference it is held to)}."""
    work = tmp_path_factory.mktemp("train_ranks")
    modules, params = _lora_params()
    port = port_models(modules, params)
    L = len(port.unet.cross_attentions())
    state = str(work / "state.pt")
    torch.save(port.state_dict(), state)
    build = port_configs(modules)
    build_flash = port_configs(modules, unet_overrides=FLASH)
    keys = [jax.random.PRNGKey(1), jax.random.PRNGKey(2)]
    steps = _port_steps(L, keys)
    # the dropout case: its own model (LoRA dropout 0.1) and a random ArcFace
    drop = dict(lora_dropout=0.1)
    dport = port_models(modules, params, unet_overrides=drop)
    arc = init_arcface(ArcFaceResNet18(ArcFaceConfig(input_size=32), device="cpu"), seed=0).requires_grad_(False)
    dcfg = dict(CFG, face_loss_timesteps=3, face_loss_guidance=2.0)
    dsteps = _dropout_steps(L)
    torch.save(dport.state_dict(), str(work / "dstate.pt"))
    dspec = dict(build=port_configs(modules, unet_overrides=drop), state_path=str(work / "dstate.pt"),
                 steps=dsteps, cfg=dcfg, arcface=dict(config=dict(input_size=32), state=arc.state_dict()))

    names, specs2, specs4 = [], [], []
    for case, flags in JAX_CASES.items():
        spec = _spec(build_flash if case == "tp_flash" else build, state, steps, flags)
        (specs4 if flags["dp"] * flags["mp"] == 4 else specs2).append(spec)
        if flags["dp"] * flags["mp"] == 2:
            names.append(case)
    specs2.append(dict(task="train", dp=2, mp=1, **dspec))
    names.append("dropout")
    for fault, (flags, _) in FAULTS.items():
        base = dict(task="train", **dspec) if fault == "local_masks" else _spec(build, state, steps, {})
        specs2.append(dict(base, fault=fault, **flags))
        names.append(fault)
    t0 = time.monotonic()
    procs = []
    for world, specs in ((2, specs2), (4, specs4)):
        cmds, envs, saved = start_ranks(specs, world, work / f"w{world}")
        procs.append((Processes(cmds, work / f"w{world}", envs), saved))

    # meanwhile: the JAX package's sharded steps and one process of the port
    refs = {case: _jax_case(case, modules, params, [(s[0], k) for s, k in zip(steps, keys)])
            for case in JAX_CASES}
    dref = {"loss": [], "grads": [], "trainables": []}
    tcfg = ttr.TrainConfig(**dcfg)
    _, _, opt = ttr.init_train_state(dport, tcfg)
    step = ttr.TrainStep(dport, tcfg, opt, face_loss_fn=make_face_loss_fn(FaceLoss(arc)),
                         face_solver=DPMSolverMultistep.create(dport.schedule, 3))
    real_clip = ttr.clip_groups
    for batch, d in dsteps:
        seen = {}

        def clip(grads, *a, **k):
            seen.update({n: g.clone().numpy() for n, g in grads.items()})
            return real_clip(grads, *a, **k)

        with mock.patch.object(ttr, "clip_groups", clip):
            metrics = step(batch, _torch_tree(d))
        dref["loss"].append(float(metrics["loss"]))
        if not dref["grads"]:
            dref["grads"].append(seen)
            dref["trainables"].append({k: p.detach().clone().numpy() for k, p in step.trainable.items()})

    outs = {}
    for (p, saved), specs_names in zip(procs, (names, [c for c in JAX_CASES if c not in names])):
        p.wait(t0 + RANK_TIMEOUT_S)
        for spec, name in zip(saved, specs_names):
            outs[name] = torch.load(spec["out"], weights_only=False)
    print(f"ranks done {time.monotonic() - t0:.1f}s after their start (limit {RANK_TIMEOUT_S}s)")
    shutil.rmtree(work)  # the outputs hold full-width adapters: hundreds of MB

    def as_port(case):
        out, frozen = refs[case]
        grads = outs[case]["grads"][0]
        return {"loss": out["loss"],
                "grads": [_port_grads_as_leaves(grads, g, frozen, modules) for g in out["grads"]],
                "trainables": [_port_grads_as_leaves(grads, t, frozen, modules) for t in out["trainables"]]}

    ported = {case: as_port(case) for case in JAX_CASES}
    ported["dropout"] = dref
    result = {case: (outs[case], ported[case]) for case in JAX_CASES}
    result["dropout"] = (outs["dropout"], dref)
    for fault, (_, against) in FAULTS.items():
        result[fault] = (outs[fault], ported[against])
    return result


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_sharded_step_matches_jax(runs, case):
    out, ref = runs[case]
    worst = _worst(out, ref)
    assert max(worst["loss"], worst["grads"], worst["trainables"]) <= 1.0, worst
    sharded = {k for k, p in out["placements"].items() if k in ref["trainables"][0] and p.model is not None}
    if JAX_CASES[case]["mp"] > 1:
        # lora_B, to_k_ip and to_v_ip are shards; lora_A and the adapters whole, and their gradient is
        # the same (whole) on every model rank
        assert sharded and all(any(s in k for s in ("lora_B", "to_k_ip", "to_v_ip")) for k in sharded)
        assert not any("lora_A" in k or "adapter" in k for k in sharded)
        assert out["replicated_spread"] == 0.0
    if JAX_CASES[case].get("fsdp"):
        assert sum(p.data is not None for p in out["placements"].values()) > 10
    if JAX_CASES[case].get("zero1"):
        assert any(p.zero is not None for p in out["placements"].values())


def test_data_parallel_dropout_equals_one_process(runs):
    """LoRA dropout 0.1 and the face branch: each rank's masks are its rows
    of the masks one process draws for the whole batch."""
    out, ref = runs["dropout"]
    worst = _worst(out, ref)
    assert max(worst["loss"], worst["grads"], worst["trainables"]) <= 1.0, worst
    assert all(m["loss_face"] != 0.0 for m in out["metrics"])


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails_the_comparison(runs, fault):
    out, ref = runs[fault]
    worst = _worst(out, ref)
    assert max(worst["loss"], worst["grads"], worst["trainables"]) > 1.0, worst
    if fault == "no_f":
        assert out["replicated_spread"] > 0.0  # lora_A's gradient is one rank's share


@pytest.mark.parametrize("n,min_size", [(2, 8), (4, 8), (8, 1024)])
def test_fsdp_dim_matches_jax(n, min_size):
    """For every parameter of the tiny bundle, the dim the port's fsdp_dim
    splits is the one JAX's fsdp_spec splits, through the weight converters
    (flax kernels transposed): each JAX leaf is filled with values that vary
    along its data axis only, converted, and read back."""
    modules, params = tiny_bundle(lora_rank=2)

    def marker(x):
        x = np.asarray(x)
        axes = [i for i, a in enumerate(tuple(fsdp_spec(x.shape, n, min_size=min_size)) + (None,) * x.ndim)
                if a == DATA_AXIS]
        out = np.zeros(x.shape, np.float32)
        for a in axes:
            shape = [1] * x.ndim
            shape[a] = x.shape[a]
            out = out + np.arange(1, x.shape[a] + 1, dtype=np.float32).reshape(shape)
        return out

    port = port_models(modules, jax.tree.map(marker, params))
    checked = split = 0
    for name in MODELS:
        for _, module in getattr(port, name).named_modules():
            for p in module._parameters.values():
                if p is None:
                    continue
                a = p.detach().numpy()
                varies = [d for d in range(a.ndim) if a.shape[d] > 1 and np.ptp(a, axis=d).max() > 0]
                assert len(varies) <= 1
                want = varies[0] if varies else None
                assert fsdp_dim(p.shape, n, min_size=min_size, order=flax_order(module, p.dim())) == want
                checked += 1
                split += want is not None
    assert checked > 500 and split > 0


def test_fsdp_dim_and_zero1_dim_rules():
    """The JAX tests' fsdp_spec cases (tests/test_tp.py) on torch shapes,
    and zero1_sharding's leading-dim rule."""
    lin = torch.nn.Linear(1, 1)
    conv = torch.nn.Conv2d(1, 1, 1)
    # a flax (3, 3, 512, 512) conv kernel splits its first 512 (in): torch dim 1
    assert fsdp_dim((512, 512, 3, 3), 8, order=flax_order(conv, 4)) == 1
    # a flax (4096, 320) kernel splits 4096 (in): torch (320, 4096) dim 1
    assert fsdp_dim((320, 4096), 8, order=flax_order(lin, 2)) == 1
    assert fsdp_dim((768,), 8) is None
    assert fsdp_dim((16, 16), 8, min_size=8) == 0
    assert fsdp_dim((768, 770), 8, order=flax_order(lin, 2)) == 0  # 770 does not divide
    assert fsdp_dim((7, 9), 8, min_size=1) is None
    assert fsdp_dim((2560, 320), 8, base=0, order=flax_order(lin, 2)) == 1  # beside a TP dim
    assert fsdp_dim((), 8) is None
    assert zero1_dim((8, 3), 2) == 0 and zero1_dim((3, 8), 2) is None and zero1_dim((), 2) is None
    assert zero1_dim((8, 3), 1) is None


def test_tensor_parallel_trainables_are_the_jax_tp_shards():
    """tree_tp_dim names as shards exactly the trainable leaves that
    JAX's tree_tp_shardings puts on the model axis (lora_B, to_k_ip,
    to_v_ip), through the converters."""
    from photoverse_tpu.ckpt.checkpoint import partition_params as jpartition
    from photoverse_tpu.parallel.tp import MODEL_AXIS
    from photoverse_tpu_torch.parallel.tp import tree_tp_dim

    modules, params = tiny_bundle(lora_rank=2)
    jt, jf = jpartition(params)
    sh = tree_tp_shardings(make_mesh_2d(4, 2), jt)
    on_model = {k: any(a == MODEL_AXIS for a in tuple(s.spec)) for k, s in sh.items()}
    marked = {k: np.full(np.asarray(v).shape, 2.0 if on_model[k] else 1.0, np.float32) for k, v in jt.items()}
    trainable, _ = partition_params(port_models(modules, params))
    want = _port_grads_as_leaves(trainable, marked, {k: np.asarray(v) for k, v in jf.items()}, modules)
    assert any(v.max() == 2.0 for v in want.values())
    for k, p in trainable.items():
        dim = tree_tp_dim(k, p.dim())
        assert (dim is not None) == bool(want[k].max() == 2.0), k
        assert dim in (None, 0)  # column-parallel: the output features of the (out, in) weight
