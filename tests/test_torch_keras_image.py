"""The port's ``KerasImageFileTransformer`` against the JAX package's on
the CPU: the same in-test Keras model (seeded weights) and the same files
(PNG, JPEG, a GIF outside the C++ bridge, a corrupt file, a missing path
and a None URI) in two partitions, at relative 1e-5.

- the fused path (files decoded, resized and packed by the C++ bridge,
  normalization on the device) in all four ``preprocessing`` modes, with
  the bridge on and off, and the count of PIL decodes;
- the custom ``imageLoader`` path;
- persistence: a ``model=`` stage and a ``modelFile=`` stage round-trip
  through the port's stage directory, a stage saved by the JAX package
  loads and scores as the JAX stage does, and a foreign class is refused;
- the device fn is built once per configuration; the default device is
  cuda and the transform raises without one; the fused path refuses a
  model without (H, W, 3) geometry.
"""

import json

import numpy as np
import pytest
import torch

import keras
from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.runtime import native as jax_native
from sparkdl_tpu.transformers import KerasImageFileTransformer as JaxKerasImageFileTransformer
from sparkdl_tpu_torch import persistence
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.transformers import KerasImageFileTransformer
from sparkdl_tpu_torch.utils.metrics import metrics
from jax_bridge import ensure_built as ensure_jax_bridge
from test_torch_keras_graph import randomize

L = keras.layers
REL = 1e-5
N_DECODABLE = 6  # 3 PNGs, 2 JPEGs, the GIF


def _model(channels=3):
    return randomize(keras.Sequential([
        L.Input((8, 8, channels)),
        L.Conv2D(4, 3, padding="same", activation="relu"),
        L.BatchNormalization(),
        L.MaxPooling2D(3, strides=2, padding="same"),
        L.GlobalAveragePooling2D(),
        L.Dense(5),
    ], name="tiny"), seed=2)


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(scope="module")
def uris(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("keras_image_files")
    rng = np.random.default_rng(7)
    paths = []
    for i, (h, w, fmt) in enumerate([(8, 8, "PNG"), (16, 12, "PNG"), (9, 30, "PNG"),
                                     (8, 8, "JPEG"), (20, 14, "JPEG"), (10, 14, "GIF")]):
        p = d / f"im_{i}.{fmt.lower()}"
        Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8), "RGB").save(p, format=fmt)
        paths.append(str(p))
    (d / "broken.png").write_bytes(b"nope")
    paths += [str(d / "broken.png"), str(d / "missing.png"), None]
    return paths


def _rows(df, col="out"):
    return [r[col] for r in df.collect()]


def _assert_rows_close(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if b is None:
            assert a is None
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= REL * np.abs(b).max()


def _both(uris, monkeypatch, bridge, **kw):
    if bridge == "off":
        monkeypatch.setenv("SPARKDL_TPU_NO_NATIVE", "1")
        monkeypatch.setattr(jax_native, "available", lambda: False)
    metrics.reset()
    ours = _rows(KerasImageFileTransformer(inputCol="uri", outputCol="out", device="cpu", **kw)
                 .transform(DataFrame.fromColumns({"uri": uris}, numPartitions=2)))
    theirs = _rows(JaxKerasImageFileTransformer(inputCol="uri", outputCol="out", **kw)
                   .transform(JaxDataFrame.fromColumns({"uri": uris}, numPartitions=2)))
    return ours, theirs


@pytest.mark.parametrize("bridge", ["on", "off"])
@pytest.mark.parametrize("preprocessing", ["tf", "caffe", "torch", "none"])
def test_fused_path_against_the_jax_package(model, uris, monkeypatch, bridge, preprocessing):
    # the JAX bridge built under a lock: a build that lost a race between
    # test processes must not turn the expectation off
    jax_bridge_on = ensure_jax_bridge(monkeypatch)
    ours, theirs = _both(uris, monkeypatch, bridge, model=model, batchSize=2, preprocessing=preprocessing)
    assert [r is None for r in ours] == [False] * N_DECODABLE + [True] * 3
    _assert_rows_close(ours, theirs)
    # with the bridge only the GIF goes through PIL (where the JAX package's
    # bridge builds, the port's must too: same source, same toolchain)
    on = bridge == "on" and jax_bridge_on
    assert metrics.counter("image.pil_decodes") == (1 if on else N_DECODABLE)


def _loader(uri):
    from PIL import Image

    img = Image.open(uri).convert("RGB").resize((8, 8), Image.BILINEAR)
    return np.asarray(img, np.float32) / 127.5 - 1.0


def test_custom_loader_path_against_the_jax_package(model, uris, monkeypatch):
    ours, theirs = _both(uris, monkeypatch, "on", model=model, imageLoader=_loader, batchSize=4)
    assert [r is None for r in ours] == [False] * N_DECODABLE + [True] * 3
    _assert_rows_close(ours, theirs)


def test_the_device_fn_is_built_once(model, uris):
    stage = KerasImageFileTransformer(inputCol="uri", outputCol="out", model=model, batchSize=2,
                                      preprocessing="tf", device="cpu")
    df = DataFrame.fromColumns({"uri": uris}, numPartitions=2)
    first = _rows(stage.transform(df))
    assert len(stage._device_fn_cache) == 1
    fn = next(iter(stage._device_fn_cache.values()))[1]
    again = _rows(stage.transform(df))
    assert next(iter(stage._device_fn_cache.values()))[1] is fn
    for a, b in zip(first, again):
        assert (a is None and b is None) or np.array_equal(a, b)
    stage._set(preprocessing="caffe")  # a new mode is a new configuration
    stage.transform(df).collect()
    assert len(stage._device_fn_cache) == 2


@pytest.mark.parametrize("source", ["model", "modelFile"])
def test_persistence_round_trip(model, uris, tmp_path, source):
    if source == "model":
        kw = {"model": model}
    else:
        kw = {"modelFile": str(tmp_path / "tiny.keras")}
        model.save(kw["modelFile"])
    stage = KerasImageFileTransformer(inputCol="uri", outputCol="out", batchSize=2, preprocessing="caffe",
                                      device="cpu", **kw)
    df = DataFrame.fromColumns({"uri": uris}, numPartitions=2)
    before = _rows(stage.transform(df))
    stage.save(str(tmp_path / "stage"))
    loaded = persistence.load(str(tmp_path / "stage"), device="cpu")
    assert type(loaded) is KerasImageFileTransformer and loaded.uid == stage.uid
    assert loaded.getOrDefault("preprocessing") == "caffe"
    after = _rows(loaded.transform(df))
    for a, b in zip(before, after):
        assert (a is None and b is None) or np.array_equal(a, b)


def test_a_jax_stage_loads_and_a_foreign_one_is_refused(model, uris, tmp_path):
    jax_stage = JaxKerasImageFileTransformer(inputCol="uri", outputCol="out", model=model, batchSize=2,
                                             preprocessing="caffe")
    jax_stage.save(str(tmp_path / "jax"))
    loaded = persistence.load(str(tmp_path / "jax"), device="cpu")
    assert type(loaded) is KerasImageFileTransformer and loaded.uid == jax_stage.uid
    assert loaded.getOrDefault("preprocessing") == "caffe"
    ours = _rows(loaded.transform(DataFrame.fromColumns({"uri": uris}, numPartitions=2)))
    theirs = _rows(jax_stage.transform(JaxDataFrame.fromColumns({"uri": uris}, numPartitions=2)))
    assert [r is None for r in ours] == [False] * N_DECODABLE + [True] * 3
    _assert_rows_close(ours, theirs)
    meta = persistence.read_metadata(str(tmp_path / "jax"))
    meta["class"] = "keras.Model"
    with open(str(tmp_path / "jax" / "metadata.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="Refusing to load class 'keras.Model'"):
        persistence.load(str(tmp_path / "jax"), device="cpu")


def test_default_device_is_cuda(model, uris, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stage = KerasImageFileTransformer(inputCol="uri", outputCol="out", model=model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stage.transform(DataFrame.fromColumns({"uri": uris})).collect()


def test_fused_path_needs_rgb_geometry(uris):
    stage = KerasImageFileTransformer(inputCol="uri", outputCol="out", model=_model(channels=1), device="cpu")
    with pytest.raises(ValueError, match="pass imageLoader"):
        stage.transform(DataFrame.fromColumns({"uri": uris})).collect()
    with pytest.raises(ValueError, match="Set modelFile or pass model="):
        KerasImageFileTransformer(inputCol="uri", outputCol="out", device="cpu").transform(
            DataFrame.fromColumns({"uri": uris})).collect()
