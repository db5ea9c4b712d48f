"""The port's CelebAMask-HQ preparation (photoverse_tpu_torch/data/celebahq.py
and its two CLIs) against the JAX package's on the same files: the fused
masks, the seeded split, the known-list split and the dataset JSON array-
and byte-equal; prepare_celebhqmasks on a local zip leaves the same trees
and bytes; a missing zip raises the same text. The archive is a synthetic
one laid out as the published CelebAMask-HQ
(scripts/torch_make_random_checkpoint.py).
"""

import json
import os
import sys
import zipfile

import numpy as np
import pytest
from PIL import Image

from photoverse_tpu.cli import create_dataset_json as jjson
from photoverse_tpu.cli import prepare_celebhqmasks as jprep
from photoverse_tpu.data import celebahq as jc
from photoverse_tpu_torch.cli import create_dataset_json as tjson
from photoverse_tpu_torch.cli import prepare_celebhqmasks as tprep
from photoverse_tpu_torch.data import celebahq as tc
from scripts.torch_make_random_checkpoint import ARCHIVE_IMAGES, write_celebahq_archive


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    """The synthetic archive (100 identities, 32px photos, 512px label
    PNGs) and its extracted CelebAMask-HQ folder."""
    root = tmp_path_factory.mktemp("celeba")
    zip_path = write_celebahq_archive(str(root / "zip"), image_size=32)
    with zipfile.ZipFile(zip_path) as zf:
        zf.extractall(root / "x")
    return zip_path, root / "x" / "CelebAMask-HQ"


def test_fused_masks_equal_the_jax_package(extracted, tmp_path):
    _, src = extracted
    anno = str(src / "CelebAMask-HQ-mask-anno")
    n = 12
    tc.create_celebahq_masks(anno, str(tmp_path / "t"), num_of_images=n)
    jc.create_celebahq_masks(anno, str(tmp_path / "j"), num_of_images=n)
    t, j = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert sorted(t) == sorted(j) == sorted(f"{k}.png" for k in range(n))
    assert t == j
    labels = tc.MASKS_LABEL_LIST_CELEBAHQ
    seen = set()
    for k in range(n):
        m = np.asarray(Image.open(tmp_path / "t" / f"{k}.png"))
        assert m.shape == (512, 512) and m.dtype == np.uint8
        seen |= set(np.unique(m).tolist())
    # skin, l_eye and hair fused by label index + 1; cloth is a skipped label
    assert seen == {0, labels.index("skin") + 1, labels.index("l_eye") + 1, labels.index("hair") + 1}
    assert tc.MASKS_LABEL_LIST_CELEBAHQ == jc.MASKS_LABEL_LIST_CELEBAHQ
    assert tc._SKIP_LABELS == jc._SKIP_LABELS and tc.NUM_OF_IMAGES_IN_CELEBAHQ == jc.NUM_OF_IMAGES_IN_CELEBAHQ
    # idempotent: a second call skips, --force_* fuses again
    os.remove(tmp_path / "t" / "0.png")
    Image.fromarray(np.zeros((2, 2), np.uint8)).save(tmp_path / "t" / "extra.png")
    tc.create_celebahq_masks(anno, str(tmp_path / "t"), num_of_images=n)
    assert not (tmp_path / "t" / "0.png").exists()
    tc.create_celebahq_masks(anno, str(tmp_path / "t"), force_create=True, num_of_images=n)
    assert _tree(tmp_path / "t")["0.png"] == j["0.png"]


def test_seeded_split_equals_the_jax_package(extracted, tmp_path):
    _, src = extracted
    masks = tmp_path / "masks"
    tc.create_celebahq_masks(str(src / "CelebAMask-HQ-mask-anno"), str(masks), num_of_images=ARCHIVE_IMAGES)
    imgs = str(src / "CelebA-HQ-img")
    got = tc.split_celebhqmasks_train_test(imgs, str(masks), str(tmp_path / "t"), 0.8, seed=3)
    want = jc.split_celebhqmasks_train_test(imgs, str(masks), str(tmp_path / "j"), 0.8, seed=3)
    assert [os.path.relpath(p, tmp_path / "t") for p in got] == [os.path.relpath(p, tmp_path / "j") for p in want]
    t, j = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert t == j
    assert len([k for k in t if k.startswith("train/images/")]) == 80
    for part in ("train", "test"):  # every image beside its own mask
        stems = lambda sub: sorted(k.split("/")[-1].split(".")[0] for k in t if k.startswith(f"{part}/{sub}/"))  # noqa
        assert stems("images") == stems("masks")
    # another seed, another split
    tc.split_celebhqmasks_train_test(imgs, str(masks), str(tmp_path / "o"), 0.8, seed=4)
    assert sorted(_tree(tmp_path / "o")) != sorted(t)


def test_known_list_split_and_dataset_json_equal_the_jax_package(extracted, tmp_path):
    _, src = extracted
    imgs = str(src / "CelebA-HQ-img")
    (tmp_path / "train.txt").write_text("3.jpg\n0.jpg\n7.jpg\n")
    (tmp_path / "test.txt").write_text("5.jpg\n")
    lists = (str(tmp_path / "train.txt"), str(tmp_path / "test.txt"), imgs)
    tc.create_test_train_from_known_list(*lists, str(tmp_path / "t"))
    jc.create_test_train_from_known_list(*lists, str(tmp_path / "j"))
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    assert sorted(_tree(tmp_path / "t")) == ["test/images/5.jpg", "train/images/0.jpg", "train/images/3.jpg",
                                             "train/images/7.jpg"]

    folder = tmp_path / "t" / "train" / "images"
    (folder / "notes.txt").write_text("not an image")
    tjson.main(["--src_folder", str(folder), "--output_json", str(tmp_path / "t.json")])
    jjson.main(["--src_folder", str(folder), "--output_json", str(tmp_path / "j.json")])
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert json.loads((tmp_path / "t.json").read_text()) == {"images": ["0.jpg", "3.jpg", "7.jpg"],
                                                             "root": str(folder)}


def test_parser_equals_the_jax_package():
    def actions(p):
        return [(a.option_strings, a.dest, a.default, a.type, a.choices, a.metavar, a.nargs)
                for a in p._actions]

    assert actions(tprep.build_parser()) == actions(jprep.build_parser())
    for bad in ("99", "30001"):
        with pytest.raises(SystemExit):
            tprep.build_parser().parse_args(["--num_of_samples", bad])


def test_prepare_cli_on_a_local_zip_equals_the_jax_cli(extracted, tmp_path, monkeypatch, capsys):
    zip_path, _ = extracted
    # the CLI splits with RandomState(None); seed both runs alike
    seeded = np.random.RandomState
    monkeypatch.setattr(np.random, "RandomState", lambda seed=None: seeded(11 if seed is None else seed))
    for name, cli in (("t", tprep), ("j", jprep)):
        save = tmp_path / name
        save.mkdir()
        os.link(zip_path, save / "CelebaHQMask.zip")
        cli.main(["--save_path", str(save), "--num_of_samples", str(ARCHIVE_IMAGES)])
    t, j = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert sorted(t) == sorted(j) and t == j
    assert len([k for k in t if k.startswith("train/masks/")]) == 90
    assert len([k for k in t if k.startswith("test/images/")]) == 10
    assert len([k for k in t if k.startswith("CelebAMask-HQ/masks/")]) == ARCHIVE_IMAGES
    # a second run skips each step and changes nothing
    capsys.readouterr()
    tprep.main(["--save_path", str(tmp_path / "t"), "--num_of_samples", str(ARCHIVE_IMAGES)])
    out = capsys.readouterr().out
    assert "already extracted" in out and "already created" in out and "already split" in out
    assert _tree(tmp_path / "t") == t


def test_a_missing_zip_raises_the_jax_packages_text(tmp_path, monkeypatch):
    # the JAX function would fetch with gdown; make sure it cannot
    monkeypatch.setitem(sys.modules, "gdown", None)
    with pytest.raises(RuntimeError) as want:
        jc.download_celebhq_masks("some_id", str(tmp_path / "j"))
    with pytest.raises(RuntimeError) as got:
        tc.download_celebhq_masks("some_id", str(tmp_path / "j"))
    assert str(got.value) == str(want.value)
    assert "place the CelebAMask-HQ zip there manually" in str(got.value)
    assert "some_id" in str(got.value.__cause__)
    with pytest.raises(RuntimeError, match="manually"):
        tprep.main(["--save_path", str(tmp_path / "cli"), "--num_of_samples", "100"])
