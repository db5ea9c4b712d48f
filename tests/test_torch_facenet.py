"""The port's FaceNet (InceptionResnetV1), its JAX-tree converter, its
strict facenet_pytorch loader and the FaceNet face loss against the JAX
package on the same weights and inputs (f32, CPU).

Tolerances: the forward at the JAX FaceNet test's (rtol 2e-3, atol 2e-4,
tests/test_facenet.py: 20+ residual blocks of f32 convolutions summed in
another order); the face loss at a relative 1e-4 and its gradient at 1e-4
of its largest value; face_preprocess at the resize test's 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photoverse_tpu.models.face_loss import FaceLoss as JaxFaceLoss
from photoverse_tpu.models.face_loss import face_preprocess as jax_face_preprocess
from photoverse_tpu.models.facenet import InceptionResnetV1 as JaxFaceNet
from photoverse_tpu.models.facenet import convert_facenet
from photoverse_tpu_torch.convert.from_jax import facenet_state_dict, load_jax_facenet
from photoverse_tpu_torch.models.face_loss import FaceLoss, face_preprocess, load_face_loss
from photoverse_tpu_torch.models.facenet import InceptionResnetV1, init_facenet
from tests.test_facenet import _make_sd
from tests.torch_threads import worker_threads  # noqa: F401


@pytest.fixture(scope="module")
def weights():
    """A facenet_pytorch-layout state dict (torch) and the JAX params of it."""
    sd = _make_sd()
    return sd, convert_facenet({k: v.numpy() for k, v in sd.items()})


@pytest.fixture(scope="module")
def port(weights):
    model = InceptionResnetV1(device="cpu")
    model.load_state_dict(weights[0], strict=True)
    return model.eval().requires_grad_(False)


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_facenet_matches_jax(weights, port):
    x = _x(0, (1, 160, 160, 3))
    want = np.asarray(JaxFaceNet().apply({"params": weights[1]}, jnp.asarray(x)))
    got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 512)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_facenet_state_dict_inverts_the_jax_converter(weights, port):
    sd, params = weights
    back = facenet_state_dict(jax.tree.map(np.asarray, params))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
    model = InceptionResnetV1(device="cpu")
    load_jax_facenet(model, jax.tree.map(np.asarray, params))
    x = torch.from_numpy(_x(1, (1, 160, 160, 3)))
    assert torch.equal(model.eval()(x), port(x))


def test_load_face_loss_facenet_is_strict(weights, port, tmp_path):
    sd = dict(weights[0])
    full = dict(sd, **{"logits.weight": torch.zeros(8631, 512), "logits.bias": torch.zeros(8631),
                       "conv2d_1a.bn.num_batches_tracked": torch.tensor(0)})
    torch.save(full, tmp_path / "facenet.pt")
    loss = load_face_loss("facenet", str(tmp_path / "facenet.pt"), device="cpu")
    assert loss.model_name == "facenet" and loss.input_size == 160
    x = torch.from_numpy(_x(2, (1, 160, 160, 3)))
    assert torch.equal(loss.model(x), port(x))
    torch.save(dict(sd, **{"repeat_1.0.stray": torch.zeros(1)}), tmp_path / "stray.pt")
    with pytest.raises(RuntimeError, match="stray"):
        load_face_loss("facenet", str(tmp_path / "stray.pt"), device="cpu")
    del sd["last_bn.running_var"]
    torch.save(sd, tmp_path / "missing.pt")
    with pytest.raises(RuntimeError, match="last_bn.running_var"):
        load_face_loss("facenet", str(tmp_path / "missing.pt"), device="cpu")


def test_random_facenet_is_seeded_and_normalised():
    a = load_face_loss("facenet", device="cpu")
    b = init_facenet(InceptionResnetV1(device="cpu"), seed=0)
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    e = a.embed(torch.from_numpy(_x(3, (2, 40, 40, 3))), normalize=False)
    np.testing.assert_allclose(e.norm(dim=-1).numpy(), 1.0, atol=1e-5)


@pytest.fixture(scope="module")
def random_facenet():
    """The train CLI's random FaceNet (init_facenet, seed 0) and its JAX
    params: its embeddings of two random images sit further apart (cos
    about 0.997) than the small test weights' (0.9998), so the f32
    rounding of 1 - cos stays under 1e-4 of the loss."""
    model = load_face_loss("facenet", device="cpu").model
    return model, convert_facenet({k: v.numpy() for k, v in model.state_dict().items()})


@pytest.mark.parametrize("maximize", [True, False])
def test_facenet_face_loss_and_gradient_match_jax(random_facenet, maximize):
    # [-1, 1] images at the training call's convention (normalize=False),
    # resized 64 -> 160 inside the loss
    x = np.tanh(_x(4, (2, 64, 64, 3)))
    x_gen = np.tanh(_x(5, (2, 64, 64, 3)))
    port, params = random_facenet
    jloss = JaxFaceLoss("facenet", params)

    def jfn(g):
        return jloss(jnp.asarray(x), g, maximize=maximize, normalize=False)

    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(x_gen))
    loss = FaceLoss(port)
    g = torch.from_numpy(x_gen).requires_grad_(True)
    got = loss(torch.from_numpy(x), g, maximize=maximize, normalize=False)
    got.backward()
    want_g = np.asarray(want_g)
    assert abs(got.item() - float(want)) <= 1e-4 * abs(float(want))
    assert np.abs(g.grad.numpy() - want_g).max() <= 1e-4 * np.abs(want_g).max()


@pytest.mark.parametrize("name,normalize,size", [("arcface", True, None), ("arcface", False, 128),
                                                 ("facenet", True, None), ("facenet", False, 160)])
def test_face_preprocess_matches_jax(name, normalize, size):
    x = np.random.RandomState(6).rand(2, 96, 80, 3).astype(np.float32) * 255
    want = np.asarray(jax_face_preprocess(jnp.asarray(x), name, normalize, size))
    got = face_preprocess(torch.from_numpy(x), name, normalize, size).numpy()
    assert got.shape == want.shape == (2,) + ((128, 128, 1) if name == "arcface" else (160, 160, 3))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * (1 if normalize else 255))
