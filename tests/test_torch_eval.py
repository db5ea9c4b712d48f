"""The port's eval slice against the JAX package on the same weights and
images (f32, CPU): the MTCNN nets and cascade, FaceSimilarity and the
face-similarity CLI.

The MTCNN weights are tests/test_utils.py's random facenet_pytorch-layout
state dicts with the face logit's bias raised, so that boxes survive all
three stages at the thresholds each test states. Tolerances: each net's
outputs 1e-5; boxes 1e-3 px (a box is a pixel grid position plus the
regression of two nets); similarities and CLI scores 1e-5.
"""

import contextlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from photoverse_tpu.cli import eval_face_similarity as jeval
from photoverse_tpu.models.arcface import ArcFaceConfig as JaxArcFaceConfig
from photoverse_tpu.models.arcface import convert_arcface
from photoverse_tpu.models.face_loss import FaceLoss as JaxFaceLoss
from photoverse_tpu.utils import face_similarity as jfs
from photoverse_tpu.utils import mtcnn as jm
from photoverse_tpu_torch.cli import eval_face_similarity as teval
from photoverse_tpu_torch.models.arcface import ArcFaceResNet18
from photoverse_tpu_torch.models.face_loss import FaceLoss
from photoverse_tpu_torch.utils import face_similarity as tfs
from photoverse_tpu_torch.utils import mtcnn as tm
from tests.test_face_models import _make_arcface_sd
from tests.test_utils import _mtcnn_state_dicts
from tests.torch_threads import worker_threads  # noqa: F401

NETS = ("pnet", "rnet", "onet")
FACE_BIAS = {"pnet": "conv4_1.bias", "rnet": "dense5_1.bias", "onet": "dense6_1.bias"}
# face-logit biases: boxes of these images survive the default thresholds
# (0.6, 0.7, 0.7), or none does
FACES, NO_FACES = 3.0, -5.0


def _mtcnn_sds(face_bias: float):
    """numpy state dicts of the three nets, the face logit's bias set and
    the box regression heads scaled down, so that boxes stay on the image."""
    sds = dict(zip(NETS, _mtcnn_state_dicts()))
    for n, key in FACE_BIAS.items():
        sds[n][key] = np.array([0.0, face_bias], np.float32)
        reg = key.replace("_1.", "_2.")
        for leaf in (reg, reg.replace("bias", "weight")):
            sds[n][leaf] = sds[n][leaf] * np.float32(0.02)
    return sds


def _write_mtcnn(d, face_bias: float) -> str:
    os.makedirs(d, exist_ok=True)
    for n, sd in _mtcnn_sds(face_bias).items():
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, os.path.join(d, f"{n}.pt"))
    return str(d)


def _pair(face_bias: float, thresholds):
    sds = _mtcnn_sds(face_bias)
    nets = []
    for cls, n in zip((tm.PNet, tm.RNet, tm.ONet), NETS):
        net = cls()
        net.load_state_dict({k: torch.from_numpy(v) for k, v in sds[n].items()}, strict=True)
        nets.append(net)
    jax_det = jm.MTCNN(*(jm._convert_net(sds[n]) for n in NETS), thresholds=thresholds)
    return tm.MTCNN(*nets, thresholds=thresholds), jax_det


def _image(seed, h, w):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def test_mtcnn_nets_match_jax():
    port, jax_det = _pair(1.0, (0.3, 0.3, 0.3))
    sds = _mtcnn_sds(1.0)
    rng = np.random.RandomState(0)
    cases = [(port.pnet, jm._pnet, "pnet", (1, 37, 45, 3)), (port.rnet, jm._rnet, "rnet", (3, 24, 24, 3)),
             (port.onet, jm._onet, "onet", (3, 48, 48, 3))]
    for net, jfn, name, shape in cases:
        x = rng.randn(*shape).astype(np.float32)
        want = jfn(jm._convert_net(sds[name]), jnp.asarray(x))
        with torch.no_grad():
            got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            g = g.numpy()
            if g.ndim == 4:  # P-Net's maps are NCHW in the port, NHWC in JAX
                g = g.transpose(0, 2, 3, 1)
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


def test_mtcnn_loads_directory_and_single_file(tmp_path):
    d = _write_mtcnn(tmp_path / "dir", 1.0)
    torch.save({n: torch.load(os.path.join(d, f"{n}.pt"), weights_only=True) for n in NETS}, tmp_path / "all.pt")
    a = tm.MTCNN.from_torch_weights(d, device="cpu")
    b = tm.MTCNN.from_torch_weights(str(tmp_path / "all.pt"), device="cpu")
    for x, y in zip((a.pnet, a.rnet, a.onet), (b.pnet, b.rnet, b.onet)):
        for (k, v), (k2, v2) in zip(x.state_dict().items(), y.state_dict().items()):
            assert k == k2 and torch.equal(v, v2)
    sd = torch.load(os.path.join(d, "rnet.pt"), weights_only=True)
    sd["dense4.stray"] = torch.zeros(1)
    torch.save(sd, os.path.join(d, "rnet.pt"))
    with pytest.raises(RuntimeError, match="stray"):
        tm.MTCNN.from_torch_weights(d, device="cpu")


def test_mtcnn_detect_matches_jax():
    port, jax_det = _pair(FACES, (0.5, 0.5, 0.5))
    img = _image(13, 128, 112)
    boxes, probs = port.detect(img)
    want_boxes, want_probs = jax_det.detect(img)
    assert want_boxes is not None and len(want_boxes) > 1  # the thresholds reach O-Net
    assert boxes.shape == want_boxes.shape
    np.testing.assert_allclose(boxes, want_boxes, rtol=0, atol=1e-3)
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=1e-5)
    port, jax_det = _pair(NO_FACES, (0.6, 0.7, 0.7))
    assert port.detect(img) == (None, None) == jax_det.detect(img)


def test_cascade_helpers_equal_jax():
    rng = np.random.RandomState(1)
    xy = rng.rand(40, 2) * 80
    boxes = np.concatenate([xy, xy + 5 + rng.rand(40, 2) * 30], 1)
    scores = rng.rand(40).astype(np.float32)
    reg = (rng.randn(40, 4) * 0.1).astype(np.float32)
    for mode in ("union", "min"):
        for t in (0.3, 0.7):
            np.testing.assert_array_equal(tm._nms(boxes, scores, t, mode), jm._nms(boxes, scores, t, mode))
    np.testing.assert_array_equal(tm._bbreg(boxes, reg), jm._bbreg(boxes, reg))
    np.testing.assert_array_equal(tm._rerec(boxes), jm._rerec(boxes))
    img = _image(2, 50, 60).astype(np.float32)
    np.testing.assert_array_equal(tm._crop_resize(img, boxes[:5] - 20, 24), jm._crop_resize(img, boxes[:5] - 20, 24))


@pytest.fixture(scope="module")
def arcface(tmp_path_factory):
    """A reference-layout ArcFace .pt (128 px), the port's FaceLoss and the
    JAX FaceLoss of it."""
    sd = _make_arcface_sd(JaxArcFaceConfig())
    path = tmp_path_factory.mktemp("arc") / "arcface.pt"
    torch.save(sd, path)
    model = ArcFaceResNet18(device="cpu")
    model.load_state_dict(sd, strict=True)
    jloss = JaxFaceLoss("arcface", convert_arcface({k: v.numpy() for k, v in sd.items()}))
    return str(path), FaceLoss(model.eval().requires_grad_(False)), jloss


@pytest.mark.parametrize("detector", [False, True])
def test_face_similarity_matches_jax(arcface, tmp_path, detector):
    _, loss, jloss = arcface
    mt = _write_mtcnn(tmp_path / "mtcnn", FACES) if detector else None
    port = tfs.FaceSimilarity(face_loss=loss, mtcnn_weights_path=mt, device="cpu")
    ref = jfs.FaceSimilarity(face_loss=jloss, mtcnn_weights_path=mt)
    a, b = _image(3, 96, 96), _image(9, 104, 96)
    if detector:
        assert port.detector.detect(a)[0] is not None and port.detector.detect(b)[0] is not None
    with pytest.warns(UserWarning, match="full image") if not detector else contextlib.nullcontext():
        got = port.calculate_face_similarity(a, b)
    want = ref.calculate_face_similarity(a, b)
    assert got != 0.0 and abs(got - want) <= 1e-5
    # the random ArcFace's embeddings are unnormalised (|e| up to 1e8)
    e, want_e = port.face_embedding(Image.fromarray(a)), np.asarray(ref.face_embedding(a))
    assert np.abs(e - want_e).max() <= 1e-5 * np.abs(want_e).max()


def test_insightface_style_helpers_equal_jax():
    img = np.arange(10 * 12 * 3, dtype=np.uint8).reshape(10, 12, 3)
    fa = {"bbox": np.array([-2.0, 3.0, 8.0, 99.0])}
    np.testing.assert_array_equal(tfs.crop_face_from_image(img, fa), jfs.crop_face_from_image(img, fa))
    fas = [{"bbox": [0, 0, 2, 2], "embedding": np.array([1.0, 0.5])},
           {"bbox": [0, 0, 5, 5], "embedding": np.array([0.2, 1.0])}]
    assert tfs.get_largest_bbox_face_analysis(fas) is fas[1] is jfs.get_largest_bbox_face_analysis(fas)
    assert tfs.get_largest_bbox_face_analysis([]) == [] == jfs.get_largest_bbox_face_analysis([])

    def det(image):
        return [{"bbox": [0, 0, image.shape[1], image.shape[0]], "embedding": image.reshape(-1, 3).mean(0)}]

    a, b = _image(5, 4, 4), _image(6, 4, 4)
    assert tfs.cosine_similarity_between_images(a, b, det) == jfs.cosine_similarity_between_images(a, b, det)
    assert tfs.cosine_similarity_between_images(a, b, lambda im: []) == 0


@pytest.fixture
def eval_dirs(tmp_path):
    """An identity photo and three generated images, as PNG files."""
    results = tmp_path / "results"
    results.mkdir()
    # with FACES, the third image has no detected face and scores 0.0
    for i, (h, w) in enumerate([(96, 96), (112, 96), (96, 128)]):
        Image.fromarray(_image(10 + i, h, w)).save(results / f"generated_image{i}.png")
    face = tmp_path / "face.png"
    Image.fromarray(_image(9, 104, 96)).save(face)
    return tmp_path, str(face), str(results)


def _json_of(capsys, main, argv):
    capsys.readouterr()
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_eval_cli_json_matches_jax(arcface, eval_dirs, capsys):
    d, face, results = eval_dirs
    argv = ["--input_image", face, "--results_dir", results, "--model", "arcface", "--model_weights",
            arcface[0], "--mtcnn_weights", _write_mtcnn(d / "mtcnn", FACES), "--json"]
    want = _json_of(capsys, jeval.main, argv)
    got = _json_of(capsys, teval.main, argv + ["--cpu"])
    assert got["model"] == want["model"] == "arcface"
    assert list(got["scores"]) == list(want["scores"]) == [f"generated_image{i}.png" for i in range(3)]
    assert [v != 0.0 for v in want["scores"].values()] == [True, True, False]
    for k, v in want["scores"].items():
        assert abs(got["scores"][k] - v) <= 1e-5, k
    assert abs(got["mean"] - want["mean"]) <= 1e-5


def test_eval_cli_no_face_scores_zero(arcface, eval_dirs, capsys):
    # the JAX CLI raises NameError on this path (no `import sys`); the port
    # follows the documented behaviour: a warning on stderr, every score 0.0
    d, face, results = eval_dirs
    capsys.readouterr()
    teval.main(["--input_image", face, "--results_dir", results, "--model_weights", arcface[0],
                "--mtcnn_weights", _write_mtcnn(d / "none", NO_FACES), "--cpu"])
    out = capsys.readouterr()
    assert "no face detected" in out.err
    rows = out.out.strip().splitlines()
    assert rows[-1].split() == ["mean", "+0.0000"] and len(rows) == 4
    assert all(r.split()[-1] == "+0.0000" for r in rows)


def test_eval_cli_wants_the_card_and_images(eval_dirs, tmp_path):
    d, face, results = eval_dirs
    from unittest import mock

    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(SystemExit, match="no CUDA device"):
            teval.main(["--input_image", face, "--results_dir", results])
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no images"):
        teval.main(["--input_image", face, "--results_dir", str(tmp_path / "empty"), "--cpu"])
