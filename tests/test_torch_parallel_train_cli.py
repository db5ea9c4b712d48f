"""The port's training CLI on several CPU gloo ranks (tests/torch_tiny.py
runs main(argv) in each rank; the rank processes import no JAX), on the
tiny diffusers-layout directory of tests/test_torch_train_cli.py:

  * multi-rank checkpoint save and restart, the counterpart of
    tests/test_multiprocess.py's FSDP restart: two FSDP ranks train three
    steps and save at step 2; two fresh ranks resume from that file to
    step 3, and their checkpoint equals the uninterrupted run's bit for bit
    (trainables, AdamW moments, step). The dataset is four copies of one
    image, so every shuffle gives the same batches, and each step's draws
    are keyed by its index (a resumed run reseeds them with seed + step, as
    the JAX CLI does, so they would differ otherwise);
  * the step-2 file loads array-equal in the JAX package's load_progress
    and in one process of the port (rank 0 wrote what one process writes);
  * --tensor_parallel 2 (with a sample grid through the sharded UNet),
    --shard_optimizer_state on two ranks, and --fsdp x --tensor_parallel 2
    on four: finite losses, one checkpoint, the metrics from rank 0.
"""

import json
import os
import shutil
import time

import jax
import numpy as np
import pytest
from flax import serialization
from PIL import Image

from photoverse_tpu.ckpt import checkpoint as jckpt
from photoverse_tpu.engine import training as jtr
from photoverse_tpu.models.assembly import load_models as jax_load_models
from photoverse_tpu_torch.ckpt import checkpoint as tckpt
from photoverse_tpu_torch.ckpt import msgpack_codec
from photoverse_tpu_torch.convert import to_jax
from photoverse_tpu_torch.engine import training as ttr
from photoverse_tpu_torch.models.assembly import load_models
from tests.test_torch_train_cli import _tiny_model_dir
from tests.torch_tiny import RANK_TIMEOUT_S, Processes, start_ranks
from tests.torch_threads import worker_threads  # noqa: F401

CFG_FLAGS = ["--resolution", "32", "--train_batch_size", "2", "--use_lora", "--lora_rank", "2",
             "--image_encoder_layers_idx", "1", "2", "3", "4", "--dataloader_num_workers", "1", "--seed", "0",
             "--report_to", "none", "--learning_rate", "1e-3", "--lr_warmup_steps", "0", "--cpu"]


def _read(path):
    with open(path, "rb") as f:
        return msgpack_codec.unpackb(f.read())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ws = tmp_path_factory.mktemp("train_ranks_cli")
    sd = _tiny_model_dir(ws / "sd")
    images = ws / "ds" / "images"
    images.mkdir(parents=True)
    img = Image.fromarray((np.random.RandomState(0).rand(40, 48, 3) * 255).astype(np.uint8))
    for i in range(4):
        img.save(images / f"{i}.jpg")
    base = ["--pretrained_model_name_or_path", sd, "--data_root_path", str(ws / "ds"), *CFG_FLAGS]

    def cli(out, *extra, keyed=False):
        return dict(task="cli", cli="train", argv=[*base, "--output_dir", str(ws / out), *extra],
                    step_keyed_draws=keyed)

    two = [cli("fsdp", "--fsdp", "--max_train_steps", "3", "--checkpoint_save_steps", "2", keyed=True),
           cli("tp", "--tensor_parallel", "2", "--max_train_steps", "2", "--samples_save_steps", "2",
               "--denoise_timesteps", "2", "--flash_attention"),
           cli("zero1", "--shard_optimizer_state", "--max_train_steps", "2")]
    four = [cli("fsdp_tp", "--fsdp", "--tensor_parallel", "2", "--max_train_steps", "2")]
    launches = []
    t0 = time.monotonic()
    for world, specs in ((2, two), (4, four)):
        cmds, envs, _ = start_ranks(specs, world, ws / f"launch{world}")
        launches.append(Processes(cmds, ws / f"launch{world}", envs))
    for p in launches:
        p.wait(t0 + RANK_TIMEOUT_S)
    print(f"first launches done in {time.monotonic() - t0:.1f}s (limit {RANK_TIMEOUT_S}s)")
    # fresh ranks: resume the FSDP run from its step-2 checkpoint
    resume = cli("resumed", "--fsdp", "--max_train_steps", "3", "--resume_from",
                 str(ws / "fsdp" / "photoverse_000002.msgpack"), keyed=True)
    cmds, envs, _ = start_ranks([resume], 2, ws / "launch_resume")
    t0 = time.monotonic()
    outs = Processes(cmds, ws / "launch_resume", envs).wait(t0 + RANK_TIMEOUT_S)
    print(f"resume launch done in {time.monotonic() - t0:.1f}s (limit {RANK_TIMEOUT_S}s)")
    yield ws, sd, outs
    shutil.rmtree(ws)  # full-width adapters: each checkpoint is hundreds of MB


def test_fsdp_resume_on_fresh_ranks_equals_the_uninterrupted_run(runs):
    ws, _, outs = runs
    assert "resumed from" in outs[0] and "FSDP shards" in outs[0]
    whole = _read(ws / "fsdp" / "photoverse.msgpack")
    resumed = _read(ws / "resumed" / "photoverse.msgpack")
    assert whole["step"] == resumed["step"] == 3
    a, b = dict(_leaves(whole)), dict(_leaves(resumed))
    assert set(a) == set(b) and any("/optimizer/" in k and "/mu/" in k for k in a)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
    # rank 0 alone writes
    assert sorted(os.listdir(ws / "resumed")) == ["config.json", "metrics.jsonl", "photoverse.msgpack",
                                                  "photoverse.msgpack.lora.json"]


def test_multi_rank_checkpoint_loads_in_jax_and_in_one_process(runs):
    ws, sd, _ = runs
    path = str(ws / "fsdp" / "photoverse_000002.msgpack")
    saved = _read(path)
    # one process of the port
    _, models, _ = load_models(sd, use_lora=True, lora_rank=2, image_encoder_layers_idx=(1, 2, 3, 4),
                               device="cpu")
    _, _, opt = ttr.init_train_state(models, ttr.TrainConfig(learning_rate=1e-3, lr_warmup_steps=0))
    assert tckpt.load_progress(path, models, opt) == 2 and opt.updates == 2
    snap = tckpt.host_save_snapshot(models)
    port = {"/".join(k): v for k, v in to_jax.to_jax({k: snap[k] for k in tckpt.partition_params(models)[0]}).items()}
    assert set(port) == set(saved["trainable"])
    for k, v in saved["trainable"].items():
        np.testing.assert_array_equal(port[k], np.asarray(v), err_msg=k)
    jax.tree.map(np.testing.assert_array_equal, tckpt.optax_state(opt), saved["optimizer"])
    # the JAX package's loader on the JAX bundle of the same directory
    _, modules, params, _ = jax_load_models(sd, use_lora=True, lora_rank=2, image_encoder_layers_idx=(1, 2, 3, 4))
    tx, _ = jtr.make_optimizer(jtr.TrainConfig(learning_rate=1e-3, lr_warmup_steps=0))
    jtrain, jfrozen, template = jtr.init_train_state(modules, params, tx)
    jparams, jopt, step = jckpt.load_progress(path, jckpt.combine_params(jtrain, jfrozen), template)
    assert step == 2
    jt, _ = jckpt.partition_params(jparams)
    assert {"/".join(k) for k in jt} == set(saved["trainable"])
    for k, v in jt.items():
        np.testing.assert_array_equal(np.asarray(v), port["/".join(k)], err_msg=str(k))
    jax.tree.map(np.testing.assert_array_equal, serialization.to_state_dict(jopt), tckpt.optax_state(opt))


@pytest.mark.parametrize("mode", ["tp", "zero1", "fsdp_tp"])
def test_cli_trains_in_each_mode(runs, mode):
    ws = runs[0]
    out = ws / mode
    with open(out / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if "loss_mle" in r]
    assert [r["step"] for r in steps] == [1, 2] and all(np.isfinite(r["loss_mle"]) for r in steps)
    assert _read(out / "photoverse.msgpack")["step"] == 2
    if mode == "tp":
        assert os.path.getsize(out / "00002.jpg") > 0  # the sharded UNet's sample grid, written by rank 0
