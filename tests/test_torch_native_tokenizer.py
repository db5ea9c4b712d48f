"""The port's native tokenizer (native/tokenizer.cc through
data/native_tokenizer.py) against the port's Python tokenizer and the JAX
package's native tokenizer, on tests/test_native_tokenizer.py's corpus and
non-ASCII text: the ids must be equal. The JAX tokenizer builds into
native/build/, the port's into photoverse_tpu_torch/_build/.
"""

from unittest import mock

import numpy as np
import pytest

from photoverse_tpu.data.native_tokenizer import NativeCLIPTokenizer as JaxNative
from photoverse_tpu_torch.data import _native_build
from photoverse_tpu_torch.data import native_tokenizer as nt
from photoverse_tpu_torch.data.tokenizer import CLIPTokenizer
from tests.test_data import _tiny_tokenizer
from tests.test_native_tokenizer import PROMPTS
from tests.torch_threads import worker_threads  # noqa: F401

NON_ASCII = ["Ünified photo", "café photo of the *", "photo of ß and ǅ", "日本 photo", "naïve  PHOTO"]
MORE = ["photo!!'s of", "photo!<the", "photo ''of", "photo <of", "photo &amp; photo", "a " * 20]


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    _tiny_tokenizer(d)
    return (nt.NativeCLIPTokenizer.from_pretrained(str(d)), CLIPTokenizer.from_pretrained(str(d)),
            JaxNative.from_pretrained(str(d)))


@pytest.mark.parametrize("text", PROMPTS + NON_ASCII + MORE)
def test_native_ids_equal_python_and_jax(toks, text):
    native, py, jax_native = toks
    got = native(text)
    assert got.dtype == np.int32 and got.shape == (1, 16)
    np.testing.assert_array_equal(got, py(text))
    np.testing.assert_array_equal(got, jax_native(text))


def test_native_batch_mixes_ascii_and_not(toks):
    native, py, _ = toks
    batch = PROMPTS + NON_ASCII
    np.testing.assert_array_equal(native(batch), py(batch))
    np.testing.assert_array_equal(native(batch, max_length=8), py(batch, max_length=8))
    with pytest.raises(ValueError, match="truncation=False"):
        native(["photo of " * 10], truncation=False)
    assert native.decode(native("the photo")[0][1:3]) == py.decode(py("the photo")[0][1:3])
    assert (native.model_max_length, native.bos_token_id, native.eos_token_id, native.pad_token_id) == \
        (py.model_max_length, py.bos_token_id, py.eos_token_id, py.pad_token_id)


def test_a_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    _tiny_tokenizer(tmp_path)
    monkeypatch.setattr(nt, "_lib", None)  # not built yet in this process
    monkeypatch.setattr(_native_build, "BUILD_DIR", str(tmp_path / "build"))
    with mock.patch.object(_native_build.subprocess, "run", side_effect=OSError("no g++")):
        with pytest.raises(_native_build.NativeBuildError, match="no g"):
            nt.NativeCLIPTokenizer.from_pretrained(str(tmp_path))
    monkeypatch.setattr(_native_build, "NATIVE_DIR", str(tmp_path / "no_sources"))
    with pytest.raises(_native_build.NativeBuildError, match="not found"):
        nt.NativeCLIPTokenizer.from_pretrained(str(tmp_path))
