"""The port's ctypes wrapper of the C++ image bridge
(``sparkdl_tpu_torch/runtime/native.py``) against the JAX package's
(``sparkdl_tpu/runtime/native.py``), byte for byte: both load a build of
``native/imagebridge.cc``, the port's its own (``sparkdl_tpu_torch/_build``).
Also the ``SPARKDL_TPU_NO_NATIVE`` switch, a failed build's recorded
reason, and ``imageIO.default_decode``."""

import io

import numpy as np
import pytest

from sparkdl_tpu.image import imageIO as jax_imageIO
from sparkdl_tpu.runtime import native as jax_native
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.runtime import native
from jax_bridge import ensure_built as ensure_jax_bridge



@pytest.fixture(autouse=True)
def jax_bridge(monkeypatch):
    if not ensure_jax_bridge(monkeypatch):
        pytest.skip("the JAX package's bridge is not built")


def _encode(arr, fmt, mode=None, **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format=fmt, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(11)
    rgb = lambda h, w: rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)  # noqa: E731
    return [
        _encode(rgb(40, 56), "PNG"),
        _encode(rng.integers(0, 256, size=(17, 23), dtype=np.uint8), "PNG", "L"),
        _encode(rng.integers(0, 256, size=(16, 16, 4), dtype=np.uint8), "PNG", "RGBA"),
        _encode(rgb(48, 64), "JPEG", quality=90),
        _encode(rgb(31, 9), "JPEG", quality=75),
        _encode(rgb(12, 12), "GIF"),  # outside the bridge: not decoded
        b"not an image at all, sorry",
        b"\xff\xd8trunc",
        None,
    ]


def test_the_port_builds_its_own_library():
    assert native.available(), native.status()
    assert native.status().startswith("built: ")
    assert "sparkdl_tpu_torch" in native.library_path()
    assert native.library_path() != jax_native._SO_PATH


def test_decode_equals_the_jax_wrapper(blobs):
    for b in blobs:
        if b is None:
            continue
        ours, theirs = native.decode(b), jax_native.decode(b)
        if theirs is None:
            assert ours is None
        else:
            assert ours.dtype == np.uint8
            np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("src,dst", [((20, 20), (20, 20)), ((64, 48), (224, 224)),
                                     ((300, 250), (224, 224)), ((7, 5), (3, 11))])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_equals_the_jax_wrapper(src, dst, channels):
    arr = np.random.default_rng(3).integers(0, 256, size=(*src, channels), dtype=np.uint8)
    np.testing.assert_array_equal(native.resize_bilinear(arr, *dst), jax_native.resize_bilinear(arr, *dst))


@pytest.mark.parametrize("chw", [False, True])
@pytest.mark.parametrize("n_channels", [1, 3])
def test_assemble_batch_equals_the_jax_wrapper(chw, n_channels):
    rng = np.random.default_rng(5)
    arrays = [
        rng.integers(0, 256, size=(32, 48, 3), dtype=np.uint8),
        None,
        rng.integers(0, 256, size=(10, 30), dtype=np.uint8),
        rng.integers(0, 256, size=(24, 24, 4), dtype=np.uint8),
        rng.integers(0, 256, size=(24, 24, 1), dtype=np.uint8),
    ]
    ours = native.assemble_batch(arrays, 24, 20, n_channels=n_channels, chw=chw)
    theirs = jax_native.assemble_batch(arrays, 24, 20, n_channels=n_channels, chw=chw)
    shape = (5, n_channels, 24, 20) if chw else (5, 24, 20, n_channels)
    assert ours[0].shape == shape
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    # the bridge turns RGBA into 3 channels only
    assert ours[1].tolist() == [True, False, True, n_channels == 3, True]


@pytest.mark.parametrize("chw", [False, True])
def test_decode_resize_batch_equals_the_jax_wrapper(blobs, chw):
    ours = native.decode_resize_batch(blobs, 32, 28, chw=chw)
    theirs = jax_native.decode_resize_batch(blobs, 32, 28, chw=chw)
    assert ours[0].shape == ((9, 3, 32, 28) if chw else (9, 32, 28, 3))
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert ours[1].tolist() == [True] * 5 + [False] * 4
    empty = native.decode_resize_batch([], 8, 8, chw=chw)
    assert empty[0].shape[0] == 0 and empty[1].shape == (0,)


def test_the_switch_is_read_at_every_call(monkeypatch, blobs):
    assert native.available()
    monkeypatch.setenv("SPARKDL_TPU_NO_NATIVE", "1")
    assert not native.available()
    assert "SPARKDL_TPU_NO_NATIVE" in native.status()
    with pytest.raises(RuntimeError, match="SPARKDL_TPU_NO_NATIVE"):
        native.decode(blobs[0])
    monkeypatch.setenv("SPARKDL_TPU_NO_NATIVE", "0")
    assert native.available()


def test_a_failed_build_is_recorded_with_its_reason(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failure", None)
    monkeypatch.setattr(native, "library_path", lambda: str(tmp_path / "lib" / "libimagebridge.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.warns(RuntimeWarning, match="no-such-compiler"):
        assert not native.available()
    assert native.status().startswith("unavailable: FileNotFoundError")
    assert not native.available()  # recorded once, not rebuilt
    with pytest.raises(RuntimeError, match="unavailable"):
        native.resize_bilinear(np.zeros((2, 2, 3), np.uint8), 4, 4)


def test_a_compiler_error_is_recorded(monkeypatch, tmp_path):
    src = tmp_path / "broken.cc"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failure", None)
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "library_path", lambda: str(tmp_path / "build" / "lib.so"))
    with pytest.warns(RuntimeWarning, match="g\\+\\+ exit"):
        assert not native.available()
    assert "broken.cc" in native.status()


@pytest.mark.parametrize("bridge", ["on", "off"])
def test_default_decode_equals_the_jax_package(blobs, monkeypatch, bridge):
    if bridge == "off":
        monkeypatch.setenv("SPARKDL_TPU_NO_NATIVE", "1")
        monkeypatch.setattr(jax_native, "available", lambda: False)
    for b in blobs:
        if b is None:
            continue
        ours, theirs = imageIO.default_decode(b), jax_imageIO.default_decode(b)
        if theirs is None:
            assert ours is None
        else:
            np.testing.assert_array_equal(ours, theirs)
    # the GIF decodes through PIL either way
    assert imageIO.default_decode(blobs[5]).shape == (12, 12, 3)
