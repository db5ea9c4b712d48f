"""The port's training data layer (photoverse_tpu_torch/data) against the JAX
package's on the same files: datasets, the shuffled multi-worker loader, the
face sub-batch pick, preprocessing and the native C++ loader. None of it
draws from anything but seeded numpy RandomStates, so every output is held
array-equal, not close.
"""

import ctypes
import ctypes.util
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from PIL import Image

from photoverse_tpu.data import dataset as jds
from photoverse_tpu.data import preprocessing as jpre
from photoverse_tpu.data import prompts as jprompts
from photoverse_tpu_torch.data import dataset as tds
from photoverse_tpu_torch.data import preprocessing as tpre
from photoverse_tpu_torch.data import prompts as tprompts
from photoverse_tpu_torch.data.tokenizer import CLIPTokenizer as TorchTokenizer
from tests.test_data import _tiny_tokenizer
from tests.torch_threads import worker_threads  # noqa: F401


def _same_batch(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "text":
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture
def data_root(tmp_path):
    """Six photos of odd sizes (one greyscale, one PNG) and their masks."""
    root = tmp_path / "data"
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir()
    rng = np.random.RandomState(0)
    for i in range(6):
        h, w = 60 + 7 * i, 90 - 5 * i
        img = Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8))
        if i == 2:
            img = img.convert("L")
        img.save(root / "images" / (f"{i}.png" if i == 4 else f"{i}.jpg"))
        m = np.zeros((48, 40), np.uint8)
        m[8 + i:36, 6:30 - i] = 255
        Image.fromarray(m).save(root / "masks" / f"{i}.png")
    (root / "images" / "notes.txt").write_text("not an image")
    return root


def _tokenizers(tmp_path):
    jtok = _tiny_tokenizer(tmp_path)
    return jtok, TorchTokenizer.from_pretrained(str(tmp_path))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("uint8", [False, True])
def test_datasets_match_jax(tmp_path, data_root, masked, uint8):
    jtok, ttok = _tokenizers(tmp_path)
    kw = dict(size=32, clip_size=24, use_random_templates=True, seed=3, uint8_pixels=uint8)
    if masked:
        j = jds.CustomDatasetWithMasks(str(data_root), jtok, **kw)
        t = tds.CustomDatasetWithMasks(str(data_root), ttok, **kw)
    else:
        j = jds.CustomDataset(str(data_root), jtok, **kw)
        t = tds.CustomDataset(str(data_root), ttok, **kw)
    assert t.image_paths == j.image_paths and len(t) == len(j) == 6
    for i in range(len(j)):
        want = j.example(i, np.random.RandomState(i))
        got = t.example(i, np.random.RandomState(i))
        assert got["pixel_values"].dtype == (np.uint8 if uint8 else np.float32)
        _same_batch({k: np.asarray(v) if k != "text" else v for k, v in got.items()},
                    {k: np.asarray(v) if k != "text" else v for k, v in want.items()})
    # the dataset's own RandomState when no worker's is given, as in JAX
    _same_batch(jds.collate_fn([j[0], j[1]]), tds.collate_fn([t[0], t[1]]))


@pytest.mark.parametrize("workers", [1, 3])
def test_batch_loader_matches_jax(tmp_path, data_root, workers):
    jtok, ttok = _tokenizers(tmp_path)
    kw = dict(size=32, clip_size=24, use_random_templates=True, uint8_pixels=True)
    j = jds.BatchLoader(jds.CustomDataset(str(data_root), jtok, **kw), 2, shuffle=True, seed=5,
                        num_workers=workers)
    t = tds.BatchLoader(tds.CustomDataset(str(data_root), ttok, **kw), 2, shuffle=True, seed=5,
                        num_workers=workers)
    assert len(t) == len(j) == 3
    for _epoch in range(2):  # the second epoch reshuffles from the loader's RandomState
        want, got = list(j), list(t)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            _same_batch(a, b)


def test_random_batch_slicing_matches_jax(tmp_path):
    jtok, ttok = _tokenizers(tmp_path)
    batch = {"pixel_values": np.arange(8 * 5).reshape(8, 5).astype(np.uint8), "text": list("abcdefgh"),
             "scalar": 3}
    for tok, prompts in ((jtok, jprompts), (ttok, tprompts)):
        ex = prompts.prepare_prompt(tok, "a photo of {}", "*", num_of_samples=8)
        batch[f"ids_{prompts is tprompts}"] = ex["text_input_ids"]
    a = jprompts.random_batch_slicing(batch, 8, 3, np.random.RandomState(7))
    b = tprompts.random_batch_slicing(batch, 8, 3, np.random.RandomState(7))
    assert a.keys() == b.keys() and a["text"] == b["text"] and b["scalar"] == 3
    for k in ("pixel_values", "ids_True", "ids_False"):
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(b["ids_True"], b["ids_False"])
    assert tprompts.IMAGENET_TEMPLATES_SMALL == jprompts.IMAGENET_TEMPLATES_SMALL
    assert tprompts.EVAL_PROMPTS == jprompts.EVAL_PROMPTS
    with pytest.raises(ValueError):
        tprompts.random_batch_slicing(batch, 2, 3, np.random.RandomState(0))


def test_preprocessing_matches_jax(data_root):
    rng = np.random.RandomState(1)
    img = Image.fromarray((rng.rand(70, 53, 3) * 255).astype(np.uint8))
    for size in (32, 24):
        np.testing.assert_array_equal(tpre.preprocess_image_u8(img, size), jpre.preprocess_image_u8(img, size))
        np.testing.assert_array_equal(tpre.clip_preprocess_u8(img, size), jpre.clip_preprocess_u8(img, size))
    # uint8 crops normalised as the device normalises them give the float crop
    np.testing.assert_allclose(tpre.preprocess_image_u8(img, 32).astype(np.float32) / 127.5 - 1.0,
                               tpre.preprocess_image(img, 32), atol=1e-6)
    for i in range(6):
        raw = Image.open(data_root / "images" / (f"{i}.png" if i == 4 else f"{i}.jpg"))
        mask = Image.open(data_root / "masks" / f"{i}.png")
        np.testing.assert_array_equal(tpre.apply_mask_and_crop(raw, mask), jpre.apply_mask_and_crop(raw, mask))
    arr = rng.randint(0, 256, (50, 64, 3)).astype(np.uint8)
    for box in ((5, 40, 10, 20), (0, 50, 0, 3), (20, 22, 1, 63)):
        m = np.zeros((50, 64), np.uint8)
        m[box[0]:box[1], box[2]:box[3]] = 7
        for scale in (0.0, 0.15, 0.6):
            np.testing.assert_array_equal(tpre.crop_to_mask_and_scale(arr, m, scale),
                                          jpre.crop_to_mask_and_scale(arr, m, scale))
    with pytest.raises(ValueError, match="empty"):
        tpre.crop_to_mask_and_scale(arr, np.zeros((50, 64), np.uint8))


@pytest.fixture(scope="module", autouse=True)
def _default_fp_env():
    """This file loads the JAX package's native loader, which is linked with
    -ffast-math (gcc adds crtfastmath.o) and so turns on flush-to-zero in
    the process that loads it (ROADMAP.md, Queue 3). The JAX package stays
    as it is: when the file ends, the worker gets glibc's default
    floating-point environment back, for the files that run after it."""
    yield
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.fesetenv.argtypes = [ctypes.c_void_p]
    assert libm.fesetenv(ctypes.c_void_p(-1)) == 0  # glibc's FE_DFL_ENV is (const fenv_t *) -1


def _native_or_skip():
    # the JAX package's own native tests skip when its loader cannot build
    try:
        from photoverse_tpu.data.native_loader import get_loader

        get_loader()
    except Exception as e:
        pytest.skip(f"native loader unavailable: {e}")


def test_native_loader_matches_jax(tmp_path, data_root):
    _native_or_skip()
    from photoverse_tpu.data.native_loader import get_loader as jget
    from photoverse_tpu_torch.data import _native_build
    from photoverse_tpu_torch.data.native_loader import get_loader as tget

    t, j = tget(num_threads=2), jget(num_threads=2)
    assert t._lib._name.startswith(_native_build.BUILD_DIR)  # the port's own build
    paths = [str(data_root / "images" / f) for f in ("0.jpg", "2.jpg", "4.png")]
    masks = [str(data_root / "masks" / f"{i}.png") for i in (0, 2, 4)]
    for a, b in zip(t.load_batch(paths, size=32, clip_size=24), j.load_batch(paths, size=32, clip_size=24)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.load_batch_masked(paths, masks, size=32, clip_size=24),
                    j.load_batch_masked(paths, masks, size=32, clip_size=24)):
        np.testing.assert_array_equal(a, b)
    arr = np.random.RandomState(2).randint(0, 256, (40, 30, 3)).astype(np.uint8)
    for mode in ("vae", "clip"):
        np.testing.assert_array_equal(t.preprocess_rgb(arr, 16, mode), j.preprocess_rgb(arr, 16, mode))
    with pytest.raises(IOError):
        t.load_batch([str(data_root / "images" / "notes.txt")], size=32, clip_size=24)
    # the batch loader on the native path, plain and masked
    jtok, ttok = _tokenizers(tmp_path)
    for masked in (False, True):
        cls_j = jds.CustomDatasetWithMasks if masked else jds.CustomDataset
        cls_t = tds.CustomDatasetWithMasks if masked else tds.CustomDataset
        kw = dict(size=32, clip_size=24, use_random_templates=True)
        want = list(jds.BatchLoader(cls_j(str(data_root), jtok, **kw), 2, seed=1, native=True, num_workers=2))
        got = list(tds.BatchLoader(cls_t(str(data_root), ttok, **kw), 2, seed=1, native=True, num_workers=2))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            _same_batch(a, b)


# run in a fresh process: whatever this worker loaded before does not count
_SUBNORMAL_PROBE = """
import sys
from photoverse_tpu_torch.data.native_loader import NativeLoader, NativeLoaderUnavailable
try:
    NativeLoader()
except NativeLoaderUnavailable as e:
    print("unavailable", e)
    sys.exit(0)
sub = float.fromhex("0x0.0000000000001p-1022")  # the least double, a subnormal
print("ftz", sys.float_info.min / 2 == 0.0, "daz", sub * 1.0 == 0.0)
"""


def test_native_loader_keeps_ieee_subnormals():
    """Loading the port's native loader leaves flush-to-zero and
    denormals-are-zero off in the process: the library is compiled with
    -ffast-math but not linked with it (gcc would add crtfastmath.o)."""
    out = subprocess.run([sys.executable, "-c", _SUBNORMAL_PROBE], capture_output=True, text=True, timeout=120,
                         cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    if out.stdout.startswith("unavailable"):
        pytest.skip(f"native loader unavailable: {out.stdout}")
    assert out.stdout.split() == ["ftz", "False", "daz", "False"]


def test_batch_loader_raises_a_worker_error_and_releases_its_workers(tmp_path, data_root):
    _, ttok = _tokenizers(tmp_path)
    ds = tds.CustomDataset(str(data_root), ttok, size=32, clip_size=24)
    baseline = threading.active_count()
    it = iter(tds.BatchLoader(ds, 1, shuffle=False, num_workers=3, prefetch=1))
    next(it)
    it.close()  # a run that stops early (max_train_steps, SIGTERM)
    deadline = time.monotonic() + 10
    while threading.active_count() > baseline and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= baseline
    (data_root / "images" / "6.jpg").write_bytes(b"this is not a jpeg")
    ds = tds.CustomDataset(str(data_root), ttok, size=32, clip_size=24)
    with pytest.raises(Exception):
        list(tds.BatchLoader(ds, 7, shuffle=False, num_workers=2))
