"""Where the gradients at the flash layers part between the kernel run and
the plain run of one training micro-step, on one H100.

    python3 scripts/torch_flash_grad_gap.py

chip_smoke.py's train-phase configuration (SD-1.5 width, random numpy-seeded
weights, LoRA 128/1/0.1, a random ArcFace, a uint8 batch of 4, the face
branch on 2 rows with 10 inner steps at guidance 2 and face weight 2): the
face micro-step three ways, on the same batch, draws and weights:

  kernels     the bf16 model on the hand-written kernels;
  plain bf16  the same model, every kernel swapped for its plain version;
  plain f32   an f32 model holding the bf16 model's weights, plain versions.

Remat is on in all three (it moves no gradient: chip_smoke.py holds that bit
for bit), so the f32 run fits. Each differentiable flash call (the diffusion
UNet's layers, the face branch's grad-step UNet, the VAE decoder's
single-head layer) is recorded: its output, the gradient reaching its
output and those leaving its q, k and v; so is the face loss's gradient at
the decoded image and at the decoder's input. The
script prints, per call and from the loss back, the relative L2 distance of
each bf16 run's gradients to the f32 run's and of the kernel run's to the
plain bf16 run's; then the forward outputs in call order and the
trainable groups' gradients the same way. Where the kernel run and the plain
bf16 run sit at the same distance from f32, bf16 rounding amplified through
the network makes the gap; where the kernel run alone moves away, a kernel
does.
"""

from __future__ import annotations

import contextlib
import functools
import os
import subprocess
import sys
import time
from unittest import mock


sys.path.insert(0, os.getcwd())


def log(msg):
    print(msg, flush=True)


def rel(a, b):
    """||a - b|| / ||b||, in f64 on the host."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-300)).item()


def main():
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from photoverse_tpu_torch.core.schedulers import DPMSolverMultistep
    from photoverse_tpu_torch.engine import training as tr
    from photoverse_tpu_torch.models import unet as unet_mod
    from photoverse_tpu_torch.models import vae as vae_mod
    from photoverse_tpu_torch.models.arcface import ArcFaceResNet18, init_arcface
    from photoverse_tpu_torch.models.assembly import build_models, init_params
    from photoverse_tpu_torch.models.face_loss import FaceLoss, make_face_loss_fn
    from photoverse_tpu_torch.models.unet import UNetConfig
    from photoverse_tpu_torch.models.vae import VAEConfig
    from photoverse_tpu_torch.ops import _build
    from photoverse_tpu_torch.utils import trace

    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    _build.load_library()

    unet_cfg = UNetConfig(use_flash_attention=True, lora_rank=128, lora_alpha=1.0, lora_dropout=0.1, remat=True)
    vae_cfg = VAEConfig(use_flash_attention=True, remat=True)
    cfg = tr.TrainConfig(learning_rate=1e-5, gradient_accumulation_steps=2, face_loss_timesteps=10,
                         face_loss_guidance=2.0)
    face_net = init_arcface(ArcFaceResNet18(), seed=0).requires_grad_(False)
    face_fn = make_face_loss_fn(FaceLoss(face_net))
    B, n_face, latent = 4, 2, 64
    batch = cs._train_batch(B, n_face, seed=21)

    def build(dtype, like=None):
        models = init_params(build_models(dtype=dtype, unet_config=unet_cfg, vae_config=vae_cfg), seed=0)
        if like is not None:  # the bf16 model's weights, each parameter's value exactly
            with torch.no_grad():
                for (n, p), (n2, q) in zip(models.named_parameters(), like.named_parameters()):
                    assert n == n2
                    p.copy_(q.float())
        tr.init_train_state(models, cfg)
        step = tr.make_train_step(models, cfg, None, face_fn, DPMSolverMultistep.create(models.schedule, 10),
                                  face_weight_scale=2.0)
        return models, step

    def run(models, step, ctx):
        fwd, phase = [], {"bwd": False}

        def keep(entry, key, g):
            entry[key] = g.detach().float().cpu()

        def recording(fn, where):
            def call(q, k, v):
                out = fn(q, k, v)
                if phase["bwd"]:  # a remat block's recompute: its tensors only refill the saved ones
                    return out
                # the backward runs through the forward's graph, so the
                # hooks go on the forward's tensors
                e = {"where": where, "shape": tuple(q.shape), "out": out.detach().float().cpu()}
                for name, t in (("dq", q), ("dk", k), ("dv", v), ("dout", out)):
                    if t.requires_grad:
                        t.register_hook(functools.partial(keep, e, name))
                fwd.append(e)
                return out
            return call

        # the face branch's decode: the loss's gradient at the generated
        # image and at the decoder's input latents
        edge = {}
        real_decode = models.vae.decode

        def decode(z):
            gen = real_decode(z)
            if z.requires_grad and not phase["bwd"]:
                z.register_hook(functools.partial(keep, edge, "dz"))
                gen.register_hook(functools.partial(keep, edge, "dgen"))
            return gen

        L = len(models.unet.cross_attentions())
        draws = tr.make_draws(torch.Generator(device="cuda").manual_seed(101), B, latent, L, face_rows=n_face)
        with ctx(), mock.patch.object(models.vae, "decode", decode), \
                mock.patch.object(unet_mod, "flash_sdpa_diff", recording(unet_mod.flash_sdpa_diff, "unet")), \
                mock.patch.object(vae_mod, "flash_sdpa_stream_diff",
                                  recording(vae_mod.flash_sdpa_stream_diff, "vae")):
            total, metrics = step.loss_fn(batch, draws)
            phase["bwd"] = True
            names = list(step.trainable)
            grads = torch.autograd.grad(total, [step.trainable[k] for k in names], allow_unused=True)
        torch.cuda.synchronize()
        grads = {k: (torch.zeros_like(step.trainable[k]) if g is None else g).float().cpu()
                 for k, g in zip(names, grads)}
        fwd.append(dict(edge, where="decode"))
        return {k: float(v) for k, v in metrics.items()}, grads, fwd

    t0 = time.perf_counter()
    m16, s16 = build(torch.bfloat16)
    runs = {}
    with trace.counting("launch.") as launches:
        runs["kernels"] = run(m16, s16, contextlib.nullcontext)
    log(f"kernels run: launches {launches}")
    with trace.counting("launch.") as launches:
        runs["plain bf16"] = run(m16, s16, cs.plain_kernels)
    log(f"plain bf16 run: launches {launches or 0}")
    m32, s32 = build(torch.float32, like=m16)
    del m16, s16
    torch.cuda.empty_cache()
    with trace.counting("launch.") as launches:
        runs["plain f32"] = run(m32, s32, cs.plain_kernels)
    log(f"plain f32 run: launches {launches or 0}; three runs in {time.perf_counter() - t0:.1f}s, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    k, p, f = runs["kernels"], runs["plain bf16"], runs["plain f32"]
    for name, r in runs.items():
        log(f"{name}: " + " ".join(f"{key} {v:.6g}" for key, v in r[0].items()))
    pairs = (("kernels-f32", k, f), ("plainbf16-f32", p, f), ("kernels-plainbf16", k, p))
    log("trainable gradients, relative L2 distance per group: " + "; ".join(
        f"{label} " + " ".join(
            f"{grp} {rel(torch.cat([a[1][n].flatten() for n in a[1] if n.startswith(grp + '.')]), torch.cat([b[1][n].flatten() for n in b[1] if n.startswith(grp + '.')])):.4g}"
            for grp in ("text_adapter", "image_adapter", "unet"))
        for label, a, b in pairs))

    if len({len(r[2]) for r in runs.values()}) != 1:
        log(f"the runs recorded different calls: {[len(r[2]) for r in runs.values()]}")
        return 1
    ek, ep, ef = k[2].pop(), p[2].pop(), f[2].pop()
    log("the face loss's gradient at the decoded image (dgen) and at the decoder's input (dz): " + "; ".join(
        f"{key} {rel(ek[key], ef[key]):.4f} / {rel(ep[key], ef[key]):.4f} / {rel(ek[key], ep[key]):.4f}"
        for key in ("dgen", "dz")) + " (kernels-f32 / plainbf16-f32 / kernels-plainbf16)")
    log("backward, from the loss back: call (forward index), shape, then for dout dq dk dv the relative L2 "
        "distance kernels-f32 / plainbf16-f32 / kernels-plainbf16")
    for i in reversed(range(len(k[2]))):
        ek, ep, ef = k[2][i], p[2][i], f[2][i]
        cells = [f"{key} {rel(ek[key], ef[key]):.4f} / {rel(ep[key], ef[key]):.4f} / {rel(ek[key], ep[key]):.4f}"
                 for key in ("dout", "dq", "dk", "dv") if key in ek and key in ep and key in ef]
        log(f"  {i:2d} {ek['where']} {ek['shape']}: " + ("; ".join(cells) or "no gradient"))
    log("forward, in call order: call, shape, output distance kernels-f32 / plainbf16-f32 / kernels-plainbf16")
    for i, (ek, ep, ef) in enumerate(zip(k[2], p[2], f[2])):
        log(f"  {i:2d} {ek['where']} {ek['shape']}: {rel(ek['out'], ef['out']):.4f} / {rel(ep['out'], ef['out']):.4f} "
            f"/ {rel(ek['out'], ep['out']):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
