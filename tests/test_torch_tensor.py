"""The port's tensor-column transformers (``sparkdl_tpu_torch/transformers/tensor.py``)
against the JAX package's ``transformers/tensor.py`` on the CPU, with the
same inputs (seeded, numpy) in two partitions and a None cell:

- ``KerasTransformer`` over an in-test Keras model (``model=`` and a
  ``.keras`` file), over 1-D rows and over image-shaped (H, W, C) rows,
  flattened or not, at several batch sizes: relative 1e-5;
- ``ModelTransformer`` over the same function built on each side
  (``ModelIngest.from_callable``), with an int32 input column: exact;
- ``TFTransformer`` is ``ModelTransformer``; the exports resolve; the
  default device is cuda and the stage raises without one.
"""

import jax.numpy as jnp
import keras
import numpy as np
import pytest
import torch

import sparkdl_tpu_torch
from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.graph.ingest import ModelIngest as JaxModelIngest
from sparkdl_tpu.transformers import KerasTransformer as JaxKerasTransformer
from sparkdl_tpu.transformers import ModelTransformer as JaxModelTransformer
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.graph.ingest import ModelIngest
from sparkdl_tpu_torch.transformers import KerasTransformer, ModelTransformer, TFTransformer
from test_torch_keras_graph import randomize

L = keras.layers
REL = 1e-5


def _dense_model():
    return randomize(keras.Sequential([L.Input((5,)), L.Dense(7, activation="tanh"), L.Dense(2)], name="mlp"),
                     seed=4)


def _conv_model():
    return randomize(keras.Sequential([L.Input((6, 7, 3)), L.Conv2D(4, 3, strides=2, padding="same"),
                                       L.BatchNormalization()], name="convs"), seed=4)


def _cells(shape, n=7, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)] + [None]


def _rows(stage, cells, frame):
    return [r["y"] for r in stage.transform(frame.fromColumns({"x": cells}, numPartitions=2)).collect()]


def _assert_close(ours, theirs, rel=REL):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if b is None:
            assert a is None
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rel * np.abs(b).max()


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("kind", ["dense", "conv", "conv-unflattened"])
def test_keras_transformer_against_the_jax_package(kind, batch):
    model = _dense_model() if kind == "dense" else _conv_model()
    shape = (5,) if kind == "dense" else (6, 7, 3)
    kw = {"batchSize": batch}
    if kind == "conv-unflattened":
        kw["flattenOutput"] = False
    cells = _cells(shape)
    ours = _rows(KerasTransformer(inputCol="x", outputCol="y", model=model, device="cpu", **kw), cells, DataFrame)
    theirs = _rows(JaxKerasTransformer(inputCol="x", outputCol="y", model=model, **kw), cells, JaxDataFrame)
    _assert_close(ours, theirs)
    assert ours[-1] is None
    if kind == "conv-unflattened":
        assert ours[0].shape == (3, 4, 4)  # the model's NHWC row
    elif kind == "conv":
        assert ours[0].shape == (48,)


def test_keras_transformer_from_a_file(tmp_path):
    model = _dense_model()
    path = str(tmp_path / "mlp.keras")
    model.save(path)
    cells = _cells((5,))
    stage = KerasTransformer(inputCol="x", outputCol="y", modelFile=path, batchSize=4, device="cpu")
    assert stage.getOrDefault("modelFile") == path
    ours = _rows(stage, cells, DataFrame)
    theirs = _rows(JaxKerasTransformer(inputCol="x", outputCol="y", modelFile=path, batchSize=4), cells, JaxDataFrame)
    _assert_close(ours, theirs)


def test_model_transformer_against_the_jax_package():
    table = np.random.default_rng(0).normal(size=(11, 3)).astype(np.float32)
    jax_mf = JaxModelIngest.from_callable(lambda x: jnp.asarray(table)[x].sum(axis=1), input_dtype=np.int32)
    torch_table = torch.from_numpy(table)
    mf = ModelIngest.from_callable(lambda x: torch_table[x.long()].sum(dim=1), device="cpu")
    rng = np.random.default_rng(1)
    cells = [rng.integers(0, 11, size=(4,)).astype(np.int32) for _ in range(6)] + [None]
    kw = {"batchSize": 4, "inputDtype": "int32"}
    ours = _rows(ModelTransformer(inputCol="x", outputCol="y", modelFunction=mf, **kw), cells, DataFrame)
    theirs = _rows(JaxModelTransformer(inputCol="x", outputCol="y", modelFunction=jax_mf, **kw), cells, JaxDataFrame)
    _assert_close(ours, theirs, rel=1e-6)


def test_names_and_default_device(monkeypatch):
    assert TFTransformer is ModelTransformer
    assert sparkdl_tpu_torch.KerasTransformer is KerasTransformer
    assert sparkdl_tpu_torch.TFTransformer is ModelTransformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KerasTransformer(inputCol="x", outputCol="y", model=_dense_model())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelIngest.from_callable(lambda x: x)
    with pytest.raises(ValueError, match="modelFunction"):
        ModelTransformer(inputCol="x", outputCol="y").transform(DataFrame.fromColumns({"x": [None]}))
