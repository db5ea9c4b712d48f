"""The port's training CLI (photoverse_tpu_torch/cli/train.py) on a tiny
diffusers-layout directory, on the CPU: a run with
the canonical recipe's machinery (accumulation, remat, ArcFace with fused
face accumulation, uint8 transfer, async checkpoints in both formats, a
sample grid, a profiler window), promotion of the boundary checkpoint,
resume, SIGTERM, and the host code held to the JAX CLI's: flags, the
accumulation plan, the face sub-batch and the refused flags.
"""

import json
import os
import shutil
import signal
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from photoverse_tpu.ckpt import checkpoint as jckpt
from photoverse_tpu.cli import train as jtrain
from photoverse_tpu.data import prompts as jprompts
from photoverse_tpu.data.tokenizer import CLIPTokenizer as JaxTokenizer
from photoverse_tpu.models.assembly import load_models as jax_load_models
from photoverse_tpu_torch.ckpt import checkpoint as tckpt
from photoverse_tpu_torch.ckpt import msgpack_codec
from photoverse_tpu_torch.cli import train as ttrain
from photoverse_tpu_torch.convert import to_jax
from photoverse_tpu_torch.data.tokenizer import CLIPTokenizer as TorchTokenizer
from photoverse_tpu_torch.engine import training as ttr
from photoverse_tpu_torch.utils import image as timage
from photoverse_tpu_torch.utils.metrics import MetricsWriter
from photoverse_tpu_torch.models.assembly import build_models, init_params
from photoverse_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig
from photoverse_tpu_torch.models.unet import UNetConfig
from photoverse_tpu_torch.models.vae import VAEConfig
from scripts.torch_make_random_checkpoint import write_model_dir
from tests.test_data import _tiny_tokenizer
from tests.torch_threads import worker_threads  # noqa: F401

# the scalars the JAX CLI logs every optimizer step
# (photoverse_tpu/cli/train.py:767-776), then "loss_face" with a face loss
STEP_KEYS = {"step", "time", "loss_mle", "loss_reg_concept_text", "loss_reg_cross_attn_visual", "lr",
             "step_time_s", "imgs_per_sec"}


def _tiny_model_dir(root):
    """A diffusers-layout directory at the sizes of
    tests/test_cli_e2e.py:_make_checkpoint (both packages load it), written
    from the port's own modules with random numpy-seeded weights by
    scripts/torch_make_random_checkpoint.py's writer, the one chip_smoke.py
    uses at SD-1.5 width."""
    tok = _tiny_tokenizer(root)
    models = init_params(build_models(
        extra_num_tokens=4, image_encoder_layers_idx=(1, 2, 3, 4),
        text_config=CLIPTextConfig(vocab_size=len(tok.encoder), hidden_size=16, num_layers=2, num_heads=2,
                                   intermediate_size=32, max_position_embeddings=16),
        vision_config=CLIPVisionConfig(hidden_size=16, num_layers=4, num_heads=2, intermediate_size=32,
                                       image_size=16, patch_size=8),
        unet_config=UNetConfig(block_out_channels=(16, 32), layers_per_block=1, cross_attention_dim=16, num_heads=2,
                               norm_num_groups=8),
        vae_config=VAEConfig(block_out_channels=(16, 32), layers_per_block=2, norm_num_groups=8), device="cpu"),
        seed=0)
    write_model_dir(str(root), models)
    return str(root)


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    ws = tmp_path_factory.mktemp("train_cli")
    sd = _tiny_model_dir(ws / "sd")
    images = ws / "ds" / "images"
    images.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(4):
        Image.fromarray((rng.rand(48, 40 + 4 * i, 3) * 255).astype(np.uint8)).save(images / f"{i}.jpg")
    yield ws, sd, str(ws / "ds")
    shutil.rmtree(ws)  # the runs' checkpoints: over 2 GB


def _argv(fixture_dirs, out, *extra):
    _, sd, ds = fixture_dirs
    return ["--pretrained_model_name_or_path", sd, "--data_root_path", ds, "--output_dir", str(out),
            "--resolution", "32", "--train_batch_size", "2", "--use_lora", "--lora_rank", "2",
            "--image_encoder_layers_idx", "1", "2", "3", "4", "--dataloader_num_workers", "2",
            "--seed", "0", "--samples_save_steps", "1000", "--report_to", "none", "--cpu", *extra]


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _step_of(path):
    with open(path, "rb") as f:
        return msgpack_codec.unpackb(f.read())["step"]


@pytest.fixture(scope="module")
def recipe_run(fixture_dirs):
    """3 optimizer steps of batch 2 as micro-batches of 1 x 2, remat, a
    random ArcFace with the fused face window, uint8 transfer, async
    checkpoints in both formats every 2 steps and a sample grid at step 3."""
    ws = fixture_dirs[0]
    out = ws / "recipe"
    models, opt, step = ttrain.main(_argv(
        fixture_dirs, out, "--max_train_steps", "3", "--checkpoint_save_steps", "2", "--checkpoint_format", "both",
        "--auto_grad_accum", "--max_microbatch_per_chip", "1", "--remat", "--face_loss", "arcface",
        "--allow_random_face_model", "--fuse_face_accum", "--uint8_transfer", "--async_checkpointing",
        "--samples_save_steps", "3", "--denoise_timesteps", "2"))
    return str(out), models, opt, step


def test_recipe_run_logs_checkpoints_and_samples(recipe_run):
    out, models, opt, step = recipe_run
    assert step == 3 and opt.updates == 3 and opt.accum == 2 and opt.mini_step == 0
    assert models.unet.config.remat and models.vae.config.remat
    rows = _metrics(out)
    steps = [r for r in rows if "loss_mle" in r]
    assert [r["step"] for r in steps] == [1, 2, 3]
    for r in steps:
        assert set(r) == STEP_KEYS | {"loss_face"}
        assert all(np.isfinite(v) for k, v in r.items())
        assert r["imgs_per_sec"] == pytest.approx(2 / r["step_time_s"])
    sim = [r for r in rows if "face_similarity" in r]
    assert len(sim) == 1 and sim[0]["step"] == 3 and -1 <= sim[0]["face_similarity"] <= 1
    names = set(os.listdir(out))
    for n in ("photoverse_000002.msgpack", "photoverse_000002.msgpack.lora.json", "photoverse_000002.pt",
              "photoverse.msgpack", "photoverse.msgpack.lora.json", "photoverse.pt", "00003.jpg",
              "metrics.jsonl", "config.json"):
        assert n in names, n
    assert not any(n.endswith(".tmp") for n in names)
    assert _step_of(os.path.join(out, "photoverse_000002.msgpack")) == 2
    assert _step_of(os.path.join(out, "photoverse.msgpack")) == 3  # the final one embeds its step
    assert Image.open(os.path.join(out, "00003.jpg")).size[1] > 3 * 32


def test_final_pt_loads_in_both_packages(recipe_run, fixture_dirs):
    out, models, _, _ = recipe_run
    pt = os.path.join(out, "photoverse.pt")
    trained = {k: v.detach().numpy() for k, v in tckpt.partition_params(models)[0].items()}
    want = to_jax.to_jax(trained)
    # the JAX package's loader, on the JAX bundle of the same directory
    _, modules, params, lora = jax_load_models(fixture_dirs[1], photoverse_path=pt,
                                               image_encoder_layers_idx=(1, 2, 3, 4))
    assert lora["r"] == 2
    jt, _ = jckpt.partition_params(params)
    assert set(jt) == set(want)
    for k, v in jt.items():
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=str(k))
    # the port's load_models, which re-injects LoRA from the checkpoint
    from photoverse_tpu_torch.models.assembly import load_models

    _, fresh, lora2 = load_models(fixture_dirs[1], photoverse_path=pt, image_encoder_layers_idx=(1, 2, 3, 4),
                                  device="cpu")
    assert lora2 == lora
    for k, p in tckpt.partition_params(fresh)[0].items():
        np.testing.assert_array_equal(p.detach().numpy(), trained[k], err_msg=k)


@pytest.fixture(scope="module")
def boundary_run(fixture_dirs):
    """2 optimizer steps ending on the checkpoint boundary, both formats,
    the second step under the profiler."""
    out = fixture_dirs[0] / "boundary"
    models, opt, step = ttrain.main(_argv(fixture_dirs, out, "--max_train_steps", "2", "--checkpoint_save_steps",
                                          "2", "--checkpoint_format", "both", "--async_checkpointing",
                                          "--profile_steps", "1,2"))
    return str(out), models, opt, step


def test_boundary_checkpoint_is_promoted(boundary_run):
    out, _, _, step = boundary_run
    assert step == 2
    assert os.path.getsize(os.path.join(out, "profile", "trace.json")) > 0
    summary = json.load(open(os.path.join(out, "profile", "summary.json")))
    assert summary["wall_s"] > 0 and summary["device_busy_s"] is None  # no device events on the CPU
    spans = json.load(open(os.path.join(out, "profile", "spans.json")))  # the program's spans of step 2
    names = [s["name"] for s in spans["spans"]]
    assert spans["anchor_host"] is None and names.count("optimizer") == names.count("micro_step") >= 1
    assert names.count("backward") == names.count("forward") == names.count("micro_step")
    for stepped, final in (("photoverse_000002.msgpack", "photoverse.msgpack"),
                           ("photoverse_000002.msgpack.lora.json", "photoverse.msgpack.lora.json"),
                           ("photoverse_000002.pt", "photoverse.pt")):
        with open(os.path.join(out, stepped), "rb") as a, open(os.path.join(out, final), "rb") as b:
            assert a.read() == b.read(), final


def test_resume_continues_at_the_saved_step(boundary_run, fixture_dirs):
    src, models, opt, _ = boundary_run
    saved = {k: v.copy() for k, v in tckpt.host_save_snapshot(models).items()}
    saved_opt = tckpt.optax_state(opt)
    out = fixture_dirs[0] / "resumed"
    loaded, seeds = {}, []
    real_load, real_draws = tckpt.load_progress, ttr.make_draws

    def load(path, m, o):
        step = real_load(path, m, o)
        loaded.update(snap=tckpt.host_save_snapshot(m), opt=tckpt.optax_state(o), step=step)
        return step

    def draws(gen, *a, **kw):
        seeds.append(gen.initial_seed())
        return real_draws(gen, *a, **kw)

    with mock.patch.object(tckpt, "load_progress", load), mock.patch.object(ttr, "make_draws", draws):
        _, _, step = ttrain.main(_argv(fixture_dirs, out, "--max_train_steps", "3", "--resume_from",
                                       os.path.join(src, "photoverse_000002.msgpack")))
    assert loaded["step"] == 2 and step == 3
    assert [r["step"] for r in _metrics(out)] == [3]
    for k, v in saved.items():
        if k in loaded["snap"]:
            np.testing.assert_array_equal(loaded["snap"][k], v, err_msg=k)
    jax.tree.map(np.testing.assert_array_equal, loaded["opt"], saved_opt)
    # the JAX CLI's PRNGKey(seed + start_step): the draws are reseeded
    assert seeds and set(seeds) == {0 + 2}


class _ArrayDataset:
    """uint8 examples made in numpy (no decoding), as the dataset seam of
    main() takes them."""

    def __init__(self, tokenizer, n=4, size=32, clip_size=16):
        self.tokenizer, self.n, self.size, self.clip_size = tokenizer, n, size, clip_size

    def __len__(self):
        return self.n

    def example(self, idx, rng=None):
        from photoverse_tpu_torch.data.prompts import prepare_prompt

        r = np.random.RandomState(idx)
        ex = prepare_prompt(self.tokenizer, "a photo of {}", "*")
        ex["pixel_values"] = r.randint(0, 256, (self.size, self.size, 3)).astype(np.uint8)
        ex["pixel_values_clip"] = r.randint(0, 256, (self.clip_size, self.clip_size, 3)).astype(np.uint8)
        return ex


def test_sigterm_checkpoints_at_the_next_step_and_returns(fixture_dirs):
    out = fixture_dirs[0] / "sigterm"
    real_log = MetricsWriter.log

    def log(self, metrics, step):
        real_log(self, metrics, step)
        if step == 1:  # in this (the main) thread, so the handler has run when this returns
            signal.raise_signal(signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    ds = _ArrayDataset(TorchTokenizer.from_pretrained(fixture_dirs[1]))
    with mock.patch.object(MetricsWriter, "log", log):
        _, opt, step = ttrain.main(_argv(fixture_dirs, out, "--max_train_steps", "10", "--checkpoint_format", "pt",
                                         "--uint8_transfer"), dataset=ds)
    assert step == 1 and opt.updates == 1
    assert [r["step"] for r in _metrics(out)] == [1]
    # a native checkpoint whatever --checkpoint_format says, so the run can resume
    assert _step_of(os.path.join(out, "photoverse_000001.msgpack")) == 1
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("argv", [
    [],
    ["--recipe", "canonical"],
    ["--recipe", "canonical", "--no-remat", "--train_batch_size", "8", "--no-uint8_transfer"],
    ["--face_loss", "arcface", "--gradient_accumulation_steps", "4", "--lora_rank", "16",
     "--image_encoder_layers_idx", "1", "2", "3", "4", "--seed", "3", "--mixed_precision", "bf16"],
    ["--checkpoint_format", "both", "--profile_steps", "2,4", "--resume_from", "x.msgpack", "--native_loader",
     "--mask_subfolder", "masks", "--save_samples_with_various_prompts", "--cpu"],
])
def test_parse_args_gives_the_jax_namespace(argv):
    argv = ["--data_root_path", "data", *argv]
    assert vars(ttrain.parse_args(argv)) == vars(jtrain.parse_args(argv))


@pytest.mark.parametrize("batch,manual,auto,max_micro,want", [
    # rows derived from photoverse_tpu/cli/train.py:376-400 with one device (n_mesh 1)
    (16, 1, True, 8, (2, 8)),  # the canonical recipe
    (16, 1, False, 8, (1, 16)),
    (16, 1, True, 16, (1, 16)),
    (4, 2, True, 1, (2, 4)),  # manual accumulation keeps the loader batch
    (12, 1, True, 5, (3, 4)),
    (10, 1, True, 3, (5, 2)),
    (7, 1, True, 4, (7, 1)),
])
def test_accumulation_plan(batch, manual, auto, max_micro, want):
    assert ttrain.accumulation_plan(batch, manual, auto, max_micro) == want


@pytest.mark.parametrize("fuse", [False, True])
def test_host_batch_matches_the_jax_cli(fixture_dirs, fuse):
    """The face sub-batch and the uncond ids as the JAX CLI assembles them
    inline (photoverse_tpu/cli/train.py:693-726, one host, one device)."""
    sd = fixture_dirs[1]
    jtok, ttok = JaxTokenizer.from_pretrained(sd), TorchTokenizer.from_pretrained(sd)
    rng = np.random.RandomState(4)
    B, accum, ratio = 4, 2, 0.25
    batch = {"pixel_values": rng.randint(0, 256, (B, 8, 8, 3)).astype(np.uint8),
             "pixel_values_clip": rng.randint(0, 256, (B, 6, 6, 3)).astype(np.uint8),
             "text_input_ids": rng.randint(0, 50, (B, 16)).astype(np.int32),
             "concept_placeholder_idx": rng.randint(1, 5, (B, 1)).astype(np.int32), "text": ["t"] * B}
    # the JAX CLI's lines
    want = {k: v for k, v in batch.items() if k != "text"}
    want["concept_placeholder_idx"] = want["concept_placeholder_idx"].reshape(-1)
    n_face = max(int(ratio * B), 1)
    if fuse:
        n_face = min(n_face * accum, B)
    ex = jprompts.prepare_prompt(jtok, "a photo of {}", "*", num_of_samples=B)
    merged = dict(batch, text_input_ids=ex["text_input_ids"], concept_placeholder_idx=ex["concept_placeholder_idx"])
    sliced = jprompts.random_batch_slicing(merged, B, n_face, np.random.RandomState(11))
    want.update(face_pixel_values=sliced["pixel_values"], face_pixel_values_clip=sliced["pixel_values_clip"],
                face_text_input_ids=sliced["text_input_ids"],
                face_concept_placeholder_idx=sliced["concept_placeholder_idx"].reshape(-1),
                face_uncond_input_ids=np.asarray(jtok([""] * n_face), np.int32))
    assert ttrain.face_rows(ratio, B, accum, fuse) == n_face
    got = ttrain.host_batch(batch, ttok, n_face, np.random.RandomState(11))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    plain = ttrain.host_batch(batch, ttok)
    assert set(plain) == {"pixel_values", "pixel_values_clip", "text_input_ids", "concept_placeholder_idx"}


@pytest.mark.parametrize("flags,world,message", [
    # --fsdp, --tensor_parallel and --shard_optimizer_state run on several
    # ranks (tests/test_torch_parallel_train*.py); what is refused is a mesh
    # the launched ranks cannot form, before any process group opens
    (["--tensor_parallel", "2"], 1, "--tensor_parallel 2 must divide the device count 1"),
    (["--tensor_parallel", "3"], 4, "--tensor_parallel 3 must divide the device count 4"),
    (["--tensor_parallel", "4"], 4, "tensor_parallel=4 must divide num_heads=2"),
    (["--train_batch_size", "3"], 2, "global batch 3 not divisible by process count 2"),
    (["--tensor_parallel", "2", "--train_batch_size", "3", "--fsdp"], 4,
     "global batch 3 not divisible by process count 2"),
    (["--push_to_hub"], 1, "--push_to_hub needs the network"),
    (["--mixed_precision", "fp16"], 1, "fp16 is not supported"),
])
def test_refused_flags_exit_with_their_message(fixture_dirs, tmp_path, monkeypatch, flags, world, message):
    monkeypatch.setenv("WORLD_SIZE", str(world))
    with pytest.raises(SystemExit, match=message):
        ttrain.main(_argv(fixture_dirs, tmp_path / "out", *flags))
    assert not os.path.exists(tmp_path / "out")  # refused before anything runs


def test_facenet_face_loss_runs(fixture_dirs, tmp_path):
    """--face_loss facenet: the random FaceNet in the face branch and in the
    sample grid's face_similarity row."""
    from photoverse_tpu_torch.models import face_loss
    from photoverse_tpu_torch.models.facenet import InceptionResnetV1

    built = []
    real = face_loss.load_face_loss

    def spy(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    out = tmp_path / "facenet"
    with mock.patch.object(face_loss, "load_face_loss", spy):
        _, _, step = ttrain.main(_argv(fixture_dirs, out, "--max_train_steps", "1", "--face_loss", "facenet",
                                       "--allow_random_face_model", "--samples_save_steps", "1",
                                       "--denoise_timesteps", "2", "--checkpoint_format", "pt"))
    assert step == 1 and len(built) == 1 and isinstance(built[0].model, InceptionResnetV1)
    rows = _metrics(out)
    steps = [r for r in rows if "loss_mle" in r]
    assert [r["step"] for r in steps] == [1]
    assert all(np.isfinite(r["loss_face"]) and r["loss_face"] != 0.0 for r in steps)
    sim = [r for r in rows if "face_similarity" in r]
    assert len(sim) == 1 and -1 <= sim[0]["face_similarity"] <= 1


def test_entry_point_wants_the_card_unless_cpu(fixture_dirs, tmp_path):
    argv = [a for a in _argv(fixture_dirs, tmp_path / "out") if a != "--cpu"]
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(SystemExit, match="no CUDA device"):
            ttrain.main(argv)


def test_metrics_writer_and_sample_grid_match_jax(tmp_path, monkeypatch):
    from photoverse_tpu.utils import image as jimage

    monkeypatch.setitem(__import__("sys").modules, "wandb", None)  # not installed: a warning, no failure
    w = MetricsWriter(str(tmp_path), report_to="wandb", config={"a": 1})
    w.log({"loss": np.float32(0.5), "name": "skipped"}, 3)
    w.close()
    rows = _metrics(str(tmp_path))
    assert len(rows) == 1 and rows[0]["step"] == 3 and rows[0]["loss"] == 0.5 and "name" not in rows[0]
    rng = np.random.RandomState(0)
    clip = rng.randn(2, 8, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(timage.denormalize_clip(clip), jimage.denormalize_clip(clip))
    ims = [Image.fromarray(rng.randint(0, 256, (8, 8 + i, 3)).astype(np.uint8)) for i in range(3)]
    grid = [("Input Images", ims[:2]), ("{} on the beach", ims), ("empty", [])]
    timage.save_images_grid(grid, str(tmp_path / "t.png"))
    jimage.save_images_grid(grid, str(tmp_path / "j.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))
    assert timage.GALLERY_PROMPTS == jimage.GALLERY_PROMPTS
