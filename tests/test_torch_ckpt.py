"""The port's checkpoints against the JAX package's, both ways, on the tiny
bundle (tests/tiny_models.py) with LoRA: the native `.msgpack` (trainables,
the optimizer state with MultiSteps accumulation, the step, the LoRA
sidecar) and the reference `.pt`. Both sides copy f32 arrays and count in
integers, so everything is compared array-equal. Also the port's own
MessagePack codec against flax's, atomic writes and the background
writer's error reporting.
"""

import copy
import ctypes
import ctypes.util
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from photoverse_tpu.ckpt import checkpoint as jckpt
from photoverse_tpu.engine import training as jtr
from photoverse_tpu_torch.ckpt import checkpoint as tckpt
from photoverse_tpu_torch.ckpt import msgpack_codec
from photoverse_tpu_torch.convert import to_jax
from photoverse_tpu_torch.engine import training as ttr
from tests.test_torch_train import _lora_params
from tests.torch_tiny import port_models

LORA_CFG = {"r": 4, "lora_alpha": 1.0, "lora_dropout": 0.0, "bias": "none",
            "target_modules": ["attn2.to_k", "attn2.to_v", "attn2.to_q"]}
CFG = dict(learning_rate=1e-3, lr_warmup_steps=0, max_train_steps=10, gradient_accumulation_steps=2)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A native checkpoint of the tiny bundle is over 300 MiB (the adapters
    are full width): each test's files go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module", autouse=True)
def _default_fp_env():
    """The JAX package's native loader is linked with -ffast-math (gcc adds
    crtfastmath.o) and so turns on flush-to-zero in the process that loads
    it (ROADMAP.md, Queue 3); a test file that loads it may run earlier in
    the same worker. Hypothesis refuses to run under flush-to-zero, so this
    file starts from glibc's default floating-point environment."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.fesetenv.argtypes = [ctypes.c_void_p]
    assert libm.fesetenv(ctypes.c_void_p(-1)) == 0  # glibc's FE_DFL_ENV is (const fenv_t *) -1
    yield


@pytest.fixture(scope="module")
def bundle():
    modules, params = _lora_params()
    return modules, params, port_models(modules, params)


def _port(bundle):
    models = copy.deepcopy(bundle[2])
    trainable, _, opt = ttr.init_train_state(models, ttr.TrainConfig(**CFG))
    return models, trainable, opt


def _grads(rng, named):
    return {k: (rng.randn(*v.shape) * 0.1).astype(np.float32) for k, v in named.items()}


def _tree_equal(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, sorted(set(a) ^ set(b))[:4])
        for k in a:
            _tree_equal(a[k], b[k], f"{where}/{k}")
        return
    if isinstance(a, (list, int, float, str)):
        assert type(a) is type(b) and a == b, where
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, a.shape, b.dtype, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=where)


def _port_trainables_as_jax(trainable):
    return to_jax.to_jax({k: v.detach().numpy() for k, v in trainable.items()})


def test_codec_writes_flax_bytes_and_reads_flax(tmp_path):
    rng = np.random.RandomState(0)
    tree = {"trainable": {"unet/a/kernel": rng.randn(3, 5).astype(np.float32),
                          "text_adapter/mapping/fc0_w": rng.randn(2, 4, 3).astype(np.float32)},
            "step": 70000, "neg": -40, "x": 1.5, "name": "p" * 40, "flag": True, "none": None,
            "optimizer": {"0": {}, "count": np.asarray(3, np.int32), "u8": np.arange(300, dtype=np.uint8),
                          "i64": np.asarray([-(2**40), 2**40], np.int64), "list": [1, [2, 3]]},
            "scalar": np.float32(2.5)}
    ours = msgpack_codec.packb(tree)
    assert ours == serialization.msgpack_serialize(tree)
    # the streaming writer the checkpoints use; a Fortran-ordered array is
    # written in C order
    wide = dict(tree, f=np.asfortranarray(rng.randn(3, 4).astype(np.float32)))
    with open(tmp_path / "t.msgpack", "wb") as f:
        msgpack_codec.dump(wide, f)
    assert (tmp_path / "t.msgpack").read_bytes() == msgpack_codec.packb(wide) == serialization.msgpack_serialize(wide)
    back = serialization.msgpack_restore(ours)
    mine = msgpack_codec.unpackb(serialization.msgpack_serialize(tree))
    for got in (back, mine):
        _tree_equal({k: v for k, v in got.items() if k not in ("name", "flag", "none", "scalar")},
                    {k: v for k, v in tree.items() if k not in ("name", "flag", "none", "scalar")})
        assert got["name"] == tree["name"] and got["flag"] is True and got["none"] is None
        assert got["scalar"] == np.float32(2.5) and isinstance(got["scalar"], np.float32)
    for bad in ({1: 2}, {"a": {3.0 + 1j}}, {"a": np.asarray(["x"], object)}):
        with pytest.raises(msgpack_codec.MsgpackError):
            msgpack_codec.packb(bad)
    with pytest.raises(msgpack_codec.MsgpackError, match="ext type"):
        msgpack_codec.unpackb(b"\xd4\x07\x00")  # an ext type flax does not emit
    with pytest.raises(msgpack_codec.MsgpackError, match="truncated"):
        msgpack_codec.unpackb(ours[:-3])


_arrays = st.one_of(
    st.builds(lambda shape, s: np.asarray(np.random.RandomState(s).randn(*shape), np.float32),
              st.lists(st.integers(0, 4), max_size=3), st.integers(0, 2**31 - 1)),
    st.builds(lambda shape, s: np.random.RandomState(s).randint(-2**31, 2**31 - 1, shape).astype(np.int32),
              st.lists(st.integers(0, 4), max_size=3), st.integers(0, 2**31 - 1)),
    st.builds(lambda shape, s: np.random.RandomState(s).randint(0, 256, shape).astype(np.uint8),
              st.lists(st.integers(0, 40), max_size=2), st.integers(0, 2**31 - 1)),
)
_leaves = st.one_of(_arrays, st.integers(-(2**63), 2**64 - 1), st.floats(allow_nan=False),
                    st.text(max_size=40), st.booleans(), st.none())
_trees = st.recursive(_leaves, lambda kids: st.dictionaries(st.text(max_size=12), kids, max_size=6), max_leaves=20)


@settings(max_examples=60, deadline=None)
@given(_trees)
def test_codec_round_trip(tree):
    data = msgpack_codec.packb(tree)
    assert data == serialization.msgpack_serialize(tree)

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, np.ndarray):
            assert b.dtype == a.dtype and b.shape == a.shape
            np.testing.assert_array_equal(a, b)
        else:
            assert type(a) is type(b) and a == b

    same(tree, msgpack_codec.unpackb(data))


def test_to_jax_inverts_from_jax(bundle):
    modules, params, _ = bundle
    models, trainable, _ = _port(bundle)
    jt, _ = jckpt.partition_params(params)
    got = _port_trainables_as_jax(trainable)
    assert set(got) == set(jt)
    for k, v in jt.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=str(k))
    back = to_jax.from_jax_trainable({k: np.asarray(v) for k, v in jt.items()}, trainable)
    for k, p in trainable.items():
        np.testing.assert_array_equal(back[k], p.detach().numpy(), err_msg=k)
    with pytest.raises(KeyError, match="not a trainable"):
        to_jax.jax_leaf("unet.conv_in.weight")


@pytest.fixture(scope="module")
def jax_tx():
    """The JAX optimizer (MultiSteps over 2) and its update, compiled once."""
    tx, _ = jtr.make_optimizer(jtr.TrainConfig(**CFG))
    return tx, jax.jit(tx.update)


def _jax_state_after(jax_tx, params, n_micro, seed=1):
    """The JAX optimizer's state after n_micro random micro-steps."""
    tx, update = jax_tx
    trainable, frozen, state = jtr.init_train_state(None, params, tx)
    rng = np.random.RandomState(seed)
    for _ in range(n_micro):
        g = {k: jnp.asarray(v) for k, v in _grads(rng, trainable).items()}
        upd, state = update(g, state, trainable)
        trainable = jax.tree.map(lambda p, u: p + u, trainable, upd)
    return trainable, frozen, state


def test_jax_native_checkpoint_loads_into_the_port(bundle, jax_tx, tmp_path):
    _, params, _ = bundle
    trainable, frozen, state = _jax_state_after(jax_tx, params, 3)  # one update, mini_step 1
    jckpt.save_progress(str(tmp_path), jckpt.combine_params(trainable, frozen), step=5,
                        lora_config=LORA_CFG, opt_state=state)
    path = str(tmp_path / "photoverse_000005.msgpack")
    models, ptrain, opt = _port(bundle)
    assert tckpt.load_progress(path, models, opt) == 5
    assert (opt.updates, opt.mini_step) == (1, 1)
    got = _port_trainables_as_jax(ptrain)
    for k, v in trainable.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=str(k))
    _tree_equal(tckpt.optax_state(opt), serialization.to_state_dict(state))
    assert tckpt.peek_lora_config(path) == LORA_CFG
    # the generic loader takes the trainables and the sidecar
    fresh, ftrain, _ = _port(bundle)
    assert tckpt.load_photoverse_checkpoint(path, fresh) == LORA_CFG
    for k, p in ftrain.items():
        assert torch.equal(p, ptrain[k]), k


def test_port_native_checkpoint_loads_into_jax(bundle, jax_tx, tmp_path):
    _, params, _ = bundle
    models, ptrain, opt = _port(bundle)
    rng = np.random.RandomState(2)
    for _ in range(5):  # two updates, mini_step 1
        opt.step({k: torch.from_numpy(v) for k, v in _grads(rng, ptrain).items()})
    snap = tckpt.host_save_snapshot(models)
    path = tckpt.save_progress(str(tmp_path), snap, step=7, lora_config=LORA_CFG,
                               opt_state=tckpt.optax_state(opt))
    assert path.endswith("photoverse_000007.msgpack")
    assert json.load(open(path + ".lora.json")) == LORA_CFG
    jtrain, jfrozen, template = _jax_state_after(jax_tx, params, 0)
    jparams, jopt, step = jckpt.load_progress(path, jckpt.combine_params(jtrain, jfrozen), template)
    assert step == 7
    want = _port_trainables_as_jax(ptrain)
    jt, _ = jckpt.partition_params(jparams)
    assert set(jt) == set(want)
    for k, v in jt.items():
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=str(k))
    # the JAX optimizer's own tree (keys, shapes, dtypes), filled with the port's values
    _tree_equal(serialization.to_state_dict(jopt), tckpt.optax_state(opt))
    assert int(jopt.mini_step) == 1 and int(jopt.gradient_step) == 2
    # and the JAX step continues from it: the same update as the port's next window
    rng = np.random.RandomState(3)
    g = _grads(rng, ptrain)
    opt.step({k: torch.from_numpy(v) for k, v in g.items()})
    gj = {k: jnp.asarray(v) for k, v in to_jax.to_jax(g).items()}
    upd, _ = jax_tx[1](gj, jopt, jt)
    stepped = jax.tree.map(lambda p, u: np.asarray(p + u), jt, upd)
    now = _port_trainables_as_jax(ptrain)
    for k in stepped:
        np.testing.assert_allclose(now[k], stepped[k], rtol=1e-5, atol=1e-7, err_msg=str(k))


def test_optimizer_state_mismatch_is_refused(bundle, tmp_path):
    _, params, _ = bundle
    tx1, _ = jtr.make_optimizer(jtr.TrainConfig(**dict(CFG, gradient_accumulation_steps=1)))
    trainable, frozen, state = jtr.init_train_state(None, params, tx1)
    jckpt.save_progress(str(tmp_path), jckpt.combine_params(trainable, frozen), step=1, opt_state=state)
    models, _, opt = _port(bundle)  # accumulates over 2: MultiSteps layout expected
    with pytest.raises(ValueError, match="optimizer"):
        tckpt.load_progress(str(tmp_path / "photoverse_000001.msgpack"), models, opt)
    # without accumulation the bare chain loads
    single = ttr.make_optimizer(ttr.TrainConfig(**dict(CFG, gradient_accumulation_steps=1)), opt.params)
    assert tckpt.load_progress(str(tmp_path / "photoverse_000001.msgpack"), models, single) == 1
    _tree_equal(tckpt.optax_state(single), serialization.to_state_dict(state))


def test_pt_checkpoints_load_in_both_packages(bundle, tmp_path):
    modules, params, _ = bundle
    models, ptrain, _ = _port(bundle)
    with torch.no_grad():
        for p in ptrain.values():
            p.add_(0.125)
    port_pt = tckpt.save_progress_pt(str(tmp_path / "port"), tckpt.host_save_snapshot(models), step=3,
                                     lora_config=LORA_CFG)
    jparams, lora = jckpt.load_photoverse_checkpoint(port_pt, modules, jax.tree.map(lambda x: x, params))
    assert lora == LORA_CFG
    jt, jf = jckpt.partition_params(jparams)
    want = _port_trainables_as_jax(ptrain)
    for k, v in jt.items():
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=str(k))
    # the frozen attn2 base q/k/v round-trip too
    _, frozen = tckpt.partition_params(models)
    jflat = {k: np.asarray(v) for k, v in jf.items()}
    n = 0
    for k, p in frozen.items():
        if ".attn2.to_q.base_layer" in k:
            blk = k.split(".transformer_blocks")[0].replace("unet.", "")
            parts = blk.split(".")
            name = "mid_attn" if parts[0] == "mid_block" else f"{parts[0].split('_')[0]}_{parts[1]}_attn_{parts[3]}"
            np.testing.assert_array_equal(jflat[("unet", name, "attn2", "to_q", "base", "kernel")], p.numpy().T)
            n += 1
    assert n == len(models.unet.cross_attentions())
    # the JAX package's .pt into the port
    jtr_, jfr = jckpt.partition_params(params)
    jtr_ = {k: v + 0.25 for k, v in jtr_.items()}
    jpt = jckpt.save_progress_pt(str(tmp_path / "jax"), jckpt.combine_params(jtr_, jfr), step=3,
                                 lora_config=LORA_CFG)
    fresh, ftrain, _ = _port(bundle)
    assert tckpt.load_photoverse_checkpoint(jpt, fresh) == LORA_CFG
    got = _port_trainables_as_jax(ftrain)
    for k, v in jtr_.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=str(k))
    # the two writers' files hold the same keys
    a = torch.load(port_pt, weights_only=True)
    b = torch.load(jpt, weights_only=False)
    for part in ("image_adapter", "text_adapter", "cross_attention_adapter"):
        assert set(a[part]) == set(b[part]), part


def test_a_failed_write_leaves_the_last_good_file(bundle, tmp_path, monkeypatch):
    models, _, opt = _port(bundle)
    snap = tckpt.host_save_snapshot(models)
    out = str(tmp_path)
    good = tckpt.save_progress(out, snap, step=2, lora_config=LORA_CFG, opt_state=tckpt.optax_state(opt))
    good_pt = tckpt.save_progress_pt(out, snap, step=2, lora_config=LORA_CFG)
    before = {p: open(p, "rb").read() for p in (good, good_pt)}
    # serialization fails midway (a value the format cannot hold)
    bad_state = dict(tckpt.optax_state(opt), skip_state={"x": object()})
    with pytest.raises(msgpack_codec.MsgpackError):
        tckpt.save_progress(out, snap, step=4, lora_config=LORA_CFG, opt_state=bad_state, final=True)

    def torch_save_dies(obj, f):
        f.write(b"PK\x03\x04 half a zip")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torch_save_dies)
    with pytest.raises(OSError, match="disk full"):
        tckpt.save_progress_pt(out, snap, step=4, lora_config=LORA_CFG, final=True)
    monkeypatch.undo()
    names = set(os.listdir(out))
    assert "photoverse.msgpack" not in names and "photoverse.pt" not in names
    assert not any(n.endswith(".tmp") for n in names), names
    assert "photoverse.msgpack.lora.json" not in names
    for p, data in before.items():
        assert open(p, "rb").read() == data
    assert tckpt.load_progress(good, models, opt) == 2


def test_async_checkpointer_raises_a_stored_error(tmp_path):
    ck = tckpt.AsyncCheckpointer()
    done = []

    def fails():
        raise OSError("no space")

    ck.submit(fails)
    with pytest.raises(OSError, match="no space"):
        ck.wait()
    ck.submit(lambda x: done.append(x.copy()), torch.ones(2))  # tensors reach the writer as numpy
    ck.wait()
    assert isinstance(done[0], np.ndarray) and done[0].tolist() == [1.0, 1.0]
    ck.submit(fails)
    with pytest.raises(OSError):
        ck.close()
    assert not ck._thread.is_alive()


def test_host_snapshot_is_a_copy(bundle):
    """The snapshot an async write serialises must not follow the
    parameters the next optimizer steps update in place (on the CPU a
    tensor's .numpy() would share their memory)."""
    models, trainable, opt = _port(bundle)
    snap = tckpt.host_save_snapshot(models)
    state = tckpt.optax_state(opt)
    before = {k: v.copy() for k, v in snap.items()}
    with torch.no_grad():
        for p in trainable.values():
            p.add_(1.0)
        for a in opt.acc.values():
            a.add_(1.0)
    for k, v in before.items():
        np.testing.assert_array_equal(snap[k], v, err_msg=k)
    assert all(np.all(a == 0) for a in state["acc_grads"].values())
