"""photoverse_tpu_torch's training step against photoverse_tpu's, f32 on the
CPU, on the tiny bundle (tests/tiny_models.py) with its weights
(tests/torch_tiny.py).

The random draws differ between the frameworks, so the tests repeat the JAX
package's `split` / `fold_in`s of the step key here and hand the port the
values JAX draws (`_jax_draws`). JAX gradients come out of the step through
a recording optax transformation chained in front of the optimizer; the
Pallas flash kernels run in interpret mode.

Tolerances: losses rtol 1e-4; per-leaf gradients 2e-3 of the leaf's largest
|g| (f32 on both sides, different summation orders through about twenty
layers and, with the face branch, a 3-step inner generation); optimizer
states and schedules rtol 1e-5 / atol 1e-7 (f32 Adam arithmetic in two
orders); the resize and ArcFace rtol 1e-4 / atol 1e-5.
"""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from photoverse_tpu.ckpt.checkpoint import combine_params
from photoverse_tpu.core.schedulers import DPMSolverMultistep as JaxSolver
from photoverse_tpu.engine import training as jtr
from photoverse_tpu.models.arcface import ArcFaceConfig as JaxArcFaceConfig
from photoverse_tpu.models.arcface import ArcFaceResNet18 as JaxArcFace
from photoverse_tpu.models.face_loss import FaceLoss as JaxFaceLoss
from photoverse_tpu.models.face_loss import face_preprocess as jax_face_preprocess
from photoverse_tpu_torch.ckpt.checkpoint import partition_params
from photoverse_tpu_torch.convert import from_jax
from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
from photoverse_tpu_torch.engine import training as ttr
from photoverse_tpu_torch.models import layers
from photoverse_tpu_torch.models.arcface import ArcFaceConfig, ArcFaceResNet18, init_arcface
from photoverse_tpu_torch.models.face_loss import FaceLoss, face_preprocess, make_face_loss_fn
from tests.tiny_models import LATENT, tiny_batch, tiny_bundle
from tests.torch_tiny import port_models
from tests.torch_threads import worker_threads  # noqa: F401

T = torch.from_numpy
FACE_STEPS = 3
ARC_SIZE = 32


def _recorder():
    """An optax transformation that passes the gradients on and keeps them
    in its state."""

    def init(params):
        return {"g": jax.tree.map(jnp.zeros_like, params)}

    def update(updates, state, params=None):
        return updates, {"g": updates}

    return optax.GradientTransformation(init, update)


def _jax_draws(key, B, L, face_rows, face_steps):
    """The values the JAX train step draws from `key` (loss_fn and
    _face_loss's splits, encode_sample's normal, the UNet's per-layer
    fold_in, denoise's fold_in by step index)."""
    k_vae, k_noise, k_t, k_fusion, k_face, _ = jax.random.split(key, 6)
    shape = (B, LATENT, LATENT, 4)
    u = lambda k: np.array([float(jax.random.uniform(jax.random.fold_in(k, i), ())) for i in range(L)],  # noqa: E731
                           np.float32)
    d = {"vae_noise": np.asarray(jax.random.normal(k_vae, shape)),
         "noise": np.asarray(jax.random.normal(k_noise, shape)),
         "timesteps": np.asarray(jax.random.randint(k_t, (B,), 0, 1000)).astype(np.int64),
         "fusion_u": u(k_fusion)}
    if face_rows:
        fk_noise, fk_vae, fk_fusion, _ = jax.random.split(k_face, 4)
        fshape = (face_rows, LATENT, LATENT, 4)
        d["face"] = {"noise": np.asarray(jax.random.normal(fk_noise, fshape)),
                     "vae_noise": np.asarray(jax.random.normal(fk_vae, fshape)),
                     "fusion_u": u(jax.random.fold_in(fk_fusion, face_steps - 1))}
    return d


def _to_torch(d):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.tensor(v) for k, v in d.items()}


def _face_batch(B=2):
    b = tiny_batch(B=B, seed=8)
    b["face_pixel_values"] = b["pixel_values"][:1]
    b["face_pixel_values_clip"] = b["pixel_values_clip"][:1]
    b["face_text_input_ids"] = b["text_input_ids"][:1]
    b["face_concept_placeholder_idx"] = b["concept_placeholder_idx"][:1]
    b["face_uncond_input_ids"] = np.random.RandomState(9).randint(0, 64, (1, 12)).astype(np.int32)
    return b


def _lora_params(seed=7):
    """The tiny bundle with LoRA rank 4 and random (non-zero) lora_B, so
    that lora_A receives gradient too."""
    modules, params = tiny_bundle(lora_rank=4, seed=seed)
    rng = np.random.RandomState(seed)
    unet = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1)
        if any(getattr(k, "key", None) == "lora_B" for k in p) else x,
        params.unet,
    )
    return modules, dataclasses.replace(params, unet=unet)


def _port_grads_as_leaves(grads, jgrads, frozen, modules):
    """JAX trainable gradients -> the port's names, through the weight
    converters (frozen leaves filled with zeros)."""
    zeros = {k: np.zeros_like(np.asarray(v)) for k, v in frozen.items()}
    tree = combine_params(jax.tree.map(np.asarray, jgrads), zeros)
    u = modules.unet.config
    want = {f"unet.{k}": v for k, v in from_jax.unet_state_dict(
        tree.unet, u.block_out_channels, u.layers_per_block).items()}
    for name in ("text_adapter", "image_adapter"):
        want.update({f"{name}.{k}": v for k, v in from_jax.adapter_state_dict(
            getattr(tree, name), modules.num_tokens).items()})
    return {k: want[k] for k in grads}


@pytest.mark.parametrize("face", [False, True])
def test_train_step_matches_jax(face):
    modules, params = _lora_params()
    flash = dict(use_flash_attention=True, flash_min_seq=64)
    jmodules = dataclasses.replace(
        modules, unet=modules.unet.clone(config=dataclasses.replace(modules.unet.config, **flash)))
    port = port_models(modules, params, unet_overrides=flash)
    cfg = jtr.TrainConfig(max_train_steps=5, lr_warmup_steps=0, learning_rate=1e-3,
                          face_loss_guidance=2.0)
    tx = optax.chain(_recorder(), jtr.make_optimizer(cfg)[0])
    trainable, frozen, opt_state = jtr.init_train_state(jmodules, params, tx)
    kw, tkw = {}, {}
    if face:
        acfg = JaxArcFaceConfig(input_size=ARC_SIZE)
        amodel = JaxArcFace(acfg)
        aparams = amodel.init(jax.random.PRNGKey(1), jnp.zeros((1, ARC_SIZE, ARC_SIZE, 1)))["params"]
        jloss = JaxFaceLoss("arcface", aparams)
        jloss.model = amodel
        kw = dict(face_loss_fn=lambda _p, x, gen: jloss(x, gen, maximize=True, normalize=False),
                  face_solver=JaxSolver.create(modules.schedule, FACE_STEPS), face_weight_scale=2.0)
        arc = ArcFaceResNet18(ArcFaceConfig(input_size=ARC_SIZE), device="cpu")
        from_jax.load_jax_arcface(arc, jax.tree.map(np.asarray, aparams))
        tkw = dict(face_loss_fn=make_face_loss_fn(FaceLoss(arc.requires_grad_(False))),
                   face_solver=DPMSolverMultistep.create(port.schedule, FACE_STEPS),
                   face_weight_scale=2.0)
    batch = _face_batch()
    key = jax.random.PRNGKey(3)
    with pltpu.force_tpu_interpret_mode():
        step = jax.jit(jtr.make_train_step(jmodules, cfg, tx, latent_size=LATENT, **kw))
        _, new_opt, jmetrics = step(trainable, frozen, opt_state, batch, key)
    jgrads = new_opt[0]["g"]

    ttr.init_train_state(port, ttr.TrainConfig(**dataclasses.asdict(cfg)))
    L = len(port.unet.cross_attentions())
    draws = _to_torch(_jax_draws(key, 2, L, 1 if face else 0, FACE_STEPS))
    if face:
        draws["face"]["dropout"] = None
    draws["dropout"] = None
    tstep = ttr.make_train_step(port, ttr.TrainConfig(**dataclasses.asdict(cfg)), **tkw)
    metrics, grads = tstep.compute_grads(batch, draws)

    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4, err_msg=k)
    if face:
        assert float(metrics["loss_face"]) != 0.0
    want = _port_grads_as_leaves(grads, jgrads, frozen, modules)
    assert any("lora_A" in k for k in grads) and any("to_v_ip" in k for k in grads)
    for k, g in grads.items():
        w = want[k]
        assert g.shape == w.shape, k
        err = np.abs(g.numpy() - w).max()
        assert err <= 2e-3 * np.abs(w).max() + 1e-9, (k, err, np.abs(w).max())


def test_partition_params_matches_jax():
    # the same leaves on each side; the JAX adapters stack their K token
    # MLPs into one leaf per weight, the port keeps K modules
    from photoverse_tpu.ckpt.checkpoint import partition_params as jpartition

    modules, params = tiny_bundle(lora_rank=4)
    jt, jf = jpartition(params)
    trainable, frozen = partition_params(port_models(modules, params))
    count = lambda keys, first: sum(k == first for k in keys)  # noqa: E731
    tk = [k.split(".", 1)[0] for k in trainable]
    fk = [k.split(".", 1)[0] for k in frozen]
    assert count(tk, "unet") == count([k[0] for k in jt], "unet")
    for name in ("text_adapter", "image_adapter"):
        assert count(tk, name) == modules.num_tokens * count([k[0] for k in jt], name)
    for name in ("unet", "vae", "vision_encoder", "text_encoder"):
        assert count(fk, name) == count([k[0] for k in jf], name), name
    assert all(any(s in k for s in ("to_k_ip", "to_v_ip", "lora_A", "lora_B"))
               for k in trainable if k.startswith("unet."))


@pytest.mark.parametrize("kind", ["constant", "constant_with_warmup", "linear", "cosine"])
def test_lr_schedules_match_optax(kind):
    cfg = dict(learning_rate=3e-4, lr_scheduler=kind, lr_warmup_steps=10, max_train_steps=50)
    want = jtr.make_lr_schedule(jtr.TrainConfig(**cfg))
    got = ttr.make_lr_schedule(ttr.TrainConfig(**cfg))
    for n in (0, 1, 5, 9, 10, 11, 30, 49, 50, 60):
        np.testing.assert_allclose(got(n), float(want(n)), rtol=1e-5, atol=1e-10, err_msg=str(n))


def _fixed_grads(rng, scale):
    shapes = {"text_adapter.a": (3, 4), "text_adapter.b": (5,), "image_adapter.a": (4, 2),
              "unet.x": (6, 3), "unet.y": (2,)}
    return {k: (rng.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()}


def _as_jax(d):
    return {tuple(k.split(".")): jnp.asarray(v) for k, v in d.items()}


def test_clip_groups_matches_jax():
    grads = _fixed_grads(np.random.RandomState(0), 1.0)
    grads["unet.y"] *= 0.0  # a group below the limit keeps its scale of 1
    grads["image_adapter.a"] *= 1e-3
    want = jtr.clip_groups(_as_jax(grads), 1.0)
    got = ttr.clip_groups({k: T(v) for k, v in grads.items()}, 1.0)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[tuple(k.split("."))]), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("kind", ["constant", "constant_with_warmup"])
def test_adamw_with_accumulation_matches_optax(kind):
    cfg = dict(learning_rate=1e-2, lr_scheduler=kind, lr_warmup_steps=2, max_train_steps=10,
               gradient_accumulation_steps=2, max_grad_norm=1.0)
    rng = np.random.RandomState(1)
    init = _fixed_grads(rng, 1.0)
    tx, _ = jtr.make_optimizer(jtr.TrainConfig(**cfg))
    jparams = _as_jax(init)
    jstate = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(T(v.copy())) for k, v in init.items()}
    opt = ttr.make_optimizer(ttr.TrainConfig(**cfg), tparams)
    for micro in range(6):  # three windows; the grads exceed the clip norm
        g = _fixed_grads(rng, 3.0)
        upd, jstate = tx.update(_as_jax(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        assert opt.step({k: T(v) for k, v in g.items()}) == (micro % 2 == 1)
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[tuple(k.split("."))]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{k} after micro-step {micro}")


def test_normalize_pixel_batch_matches_jax():
    rng = np.random.RandomState(2)
    batch = {"pixel_values": rng.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8),
             "face_pixel_values_clip": rng.randint(0, 256, (1, 8, 8, 3)).astype(np.uint8),
             "pixel_values_clip": rng.randn(2, 8, 8, 3).astype(np.float32)}
    want = jtr.normalize_pixel_batch({k: jnp.asarray(v) for k, v in batch.items()})
    got = ttr.normalize_pixel_batch({k: T(v) for k, v in batch.items()})
    for k in batch:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)


def test_face_preprocess_resize_matches_jax():
    # 512 -> 128 bilinear without antialias, the training call's resize
    x = np.random.RandomState(3).rand(2, 512, 512, 3).astype(np.float32) * 2 - 1
    want = np.asarray(jax_face_preprocess(jnp.asarray(x), "arcface", normalize=False, size=128))
    got = face_preprocess(T(x), "arcface", normalize=False, size=128).numpy()
    assert got.shape == (2, 128, 128, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_arcface_and_face_loss_match_jax():
    acfg = JaxArcFaceConfig(input_size=ARC_SIZE)
    amodel = JaxArcFace(acfg)
    aparams = amodel.init(jax.random.PRNGKey(4), jnp.zeros((1, ARC_SIZE, ARC_SIZE, 1)))["params"]
    # non-trivial BatchNorm statistics and PReLU slopes
    rng = np.random.RandomState(4)
    aparams = jax.tree_util.tree_map_with_path(
        lambda p, v: v + jnp.asarray(rng.rand(*v.shape).astype(np.float32) * 0.2)
        if getattr(p[-1], "key", "") in ("mean", "var", "weight") else v, aparams)
    arc = ArcFaceResNet18(ArcFaceConfig(input_size=ARC_SIZE), device="cpu")
    from_jax.load_jax_arcface(arc, jax.tree.map(np.asarray, aparams))
    x = rng.randn(2, ARC_SIZE, ARC_SIZE, 1).astype(np.float32)
    want = np.asarray(amodel.apply({"params": aparams}, jnp.asarray(x)))
    np.testing.assert_allclose(arc(T(x)).detach().numpy(), want, rtol=1e-4, atol=1e-5)
    jloss = JaxFaceLoss("arcface", aparams)
    jloss.model = amodel
    a, b = (rng.rand(2, 64, 64, 3).astype(np.float32) * 2 - 1 for _ in range(2))
    loss = FaceLoss(arc)
    for maximize in (True, False):
        want = float(jloss(jnp.asarray(a), jnp.asarray(b), maximize=maximize, normalize=False))
        got = float(loss(T(a), T(b), maximize=maximize, normalize=False).detach())
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_lora_dropout_semantics():
    # A = B = I and alpha = rank make the LoRA branch drop(x) itself, so the
    # mask can be read off y - x W^T: rate p, kept entries scaled by 1/(1-p),
    # the base projection untouched, eval mode without dropout
    torch.manual_seed(0)
    n = 64
    lin = layers.LoraLinear(n, n, rank=n, alpha=float(n), dropout=0.25)
    with torch.no_grad():
        lin.lora_A["default"].weight.copy_(torch.eye(n))
        lin.lora_B["default"].weight.copy_(torch.eye(n))
    x = torch.randn(2000, n)
    base = lin.base_layer(x)
    torch.testing.assert_close(lin(x) - base, x)  # eval: the identity
    gen = torch.Generator().manual_seed(1)
    y = lin(x, train=True, generator=gen)
    dropped = y - base
    kept = dropped != 0
    rate = 1.0 - kept.float().mean().item()
    assert abs(rate - 0.25) < 0.005, rate  # 128000 draws: 4 sigma is 0.0048
    torch.testing.assert_close(dropped[kept], x[kept] / 0.75, rtol=1e-5, atol=1e-5)
    assert dropped[~kept].abs().max().item() == 0.0
    # the same generator state gives the same mask; train mode needs one
    assert torch.equal(lin(x, train=True, generator=torch.Generator().manual_seed(1)), y)
    with pytest.raises(ValueError, match="Generator"):
        lin(x, train=True)


def test_make_draws_shapes_and_repeatability():
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    a = ttr.make_draws(gen(), 3, 8, 16, face_rows=2)
    b = ttr.make_draws(gen(), 3, 8, 16, face_rows=2)
    assert a["vae_noise"].shape == a["noise"].shape == (3, 8, 8, 4)
    assert a["timesteps"].shape == (3,) and a["fusion_u"].shape == (16,)
    assert a["face"]["noise"].shape == (2, 8, 8, 4) and "timesteps" not in a["face"]
    for k in ("vae_noise", "noise", "timesteps", "fusion_u"):
        assert torch.equal(a[k], b[k])
    assert torch.equal(torch.rand(4, generator=a["dropout"]), torch.rand(4, generator=b["dropout"]))


@pytest.fixture(scope="module")
def remat_setup():
    """The tiny bundle on the flash route with LoRA dropout 0.1, a face
    train step, and its no-remat gradients with the calls of the
    differentiable flash forwards (each one lse forward) counted at the
    UNet's and the VAE's call sites."""
    from photoverse_tpu_torch.models import unet as unet_mod
    from photoverse_tpu_torch.models import vae as vae_mod

    modules, params = _lora_params()
    port = port_models(modules, params, unet_overrides=dict(use_flash_attention=True, flash_min_seq=64,
                                                            lora_dropout=0.1),
                       vae_overrides=dict(use_flash_attention=True))
    cfg = ttr.TrainConfig(face_loss_guidance=2.0, face_loss_timesteps=FACE_STEPS)
    ttr.init_train_state(port, cfg)
    arc = init_arcface(ArcFaceResNet18(ArcFaceConfig(input_size=ARC_SIZE), device="cpu"), seed=0)
    arc.requires_grad_(False)
    step = ttr.make_train_step(port, cfg, face_loss_fn=make_face_loss_fn(FaceLoss(arc)),
                               face_solver=DPMSolverMultistep.create(port.schedule, FACE_STEPS))
    L = len(port.unet.cross_attentions())

    def run(remat, vae_remat=None):
        calls = {"unet": 0, "vae": 0}

        def counted(where, fn):
            def call(q, k, v):
                calls[where] += 1
                return fn(q, k, v)
            return call

        draws = ttr.make_draws(torch.Generator().manual_seed(3), 2, LATENT, L, face_rows=1)
        port.unet.config = dataclasses.replace(port.unet.config, remat=remat)
        port.vae.config = dataclasses.replace(port.vae.config, remat=remat if vae_remat is None else vae_remat)
        try:
            # the tiny VAE's mid block (4 x 4 latents) on the flash route too
            with mock.patch.object(unet_mod, "flash_sdpa_diff", counted("unet", unet_mod.flash_sdpa_diff)), \
                    mock.patch.object(vae_mod, "flash_sdpa_stream_diff", counted("vae", vae_mod.flash_sdpa_stream_diff)), \
                    mock.patch.object(vae_mod.AttnBlock, "FLASH_MIN_SEQ", 1):
                metrics, grads = step.compute_grads(_face_batch(), draws)
        finally:  # the shared bundle as the fixture built it
            port.unet.config = dataclasses.replace(port.unet.config, remat=False)
            port.vae.config = dataclasses.replace(port.vae.config, remat=False)
        return metrics, grads, calls

    return run, run(False)


@pytest.mark.parametrize("restored", [True, False])
def test_remat_gradients_equal_no_remat(remat_setup, restored):
    """Remat at the JAX package's block boundaries (UNet resnet and
    transformer blocks, the VAE decoder's blocks) recomputes each block in
    the backward with the same LoRA dropout masks, so the face micro-step's
    gradients equal the no-remat ones exactly (f32). With the explicit
    dropout generator not restored for the recompute (the planted fault:
    torch.utils.checkpoint restores only the default generators) they
    differ."""
    run, (m0, g0, c0) = remat_setup
    ctx = contextlib.nullcontext() if restored else mock.patch.object(layers, "replaying", lambda fn, gen: fn)
    with ctx:
        m1, g1, c1 = run(True)
    # each flash layer under grad runs its lse forward again in the recompute
    assert c1 == {k: 2 * v for k, v in c0.items()} and c0["unet"] > 0 and c0["vae"] > 0
    assert set(g1) == set(g0)
    same = [k for k in g0 if torch.equal(g0[k], g1[k])]
    if restored:
        assert m1 == m0 and len(same) == len(g0), sorted(set(g0) - set(same))[:4]
    else:
        assert len(same) < len(g0)


@pytest.mark.parametrize("which", ["unet", "vae"])
def test_remat_follows_each_models_config(remat_setup, which):
    """The UNet's remat is its config's, the VAE decoder's its
    AutoencoderKL's config's: with only one of them set, only that model's
    flash layers run their lse forward again, and the gradients still equal
    the no-remat ones."""
    run, (m0, g0, c0) = remat_setup
    m1, g1, c1 = run(which == "unet", vae_remat=which == "vae")
    assert c1 == {k: (2 if k == which else 1) * v for k, v in c0.items()}
    assert m1 == m0 and all(torch.equal(g0[k], g1[k]) for k in g0)
