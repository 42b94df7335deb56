"""Keras model files read by the port (``sparkdl_tpu_torch/graph/keras_file.py``)
without keras: ``.keras`` archives and legacy ``.h5`` files written here
by Keras 3, then translated and run on the CPU against the model they were
saved from (``model.predict``, relative 1e-5) and against the JAX
package's ``ModelIngest.from_keras_file``.

- a ``.keras`` archive keys weights by object path (class name and order
  of appearance), not by layer name: the model repeats Conv2D and
  BatchNormalization classes, and its layer names run against that order;
- a legacy ``.h5`` file of a model that nests a frozen Functional model
  lists that model's trainable variables before the others;
- the refusals: an unknown layer class and a bfloat16 policy
  (NotImplementedError naming the ROADMAP item);
- the port reads the files with its own HDF5 reader, so a missing h5py
  changes nothing.
"""

import sys
import zipfile

import keras
import numpy as np
import pytest
import torch

from sparkdl_tpu.graph.ingest import ModelIngest as JaxModelIngest
from sparkdl_tpu_torch.graph.ingest import ModelIngest
from sparkdl_tpu_torch.graph.keras_file import read_keras_file
from sparkdl_tpu_torch.graph.keras_graph import walk_layers
from test_torch_keras_graph import REL, inputs, randomize, rel, to_torch

L = keras.layers


def _model():
    """Layer names in the reverse of their creation order, classes
    repeated, a nested frozen Functional model and a Sequential head."""
    inp = L.Input((9, 10, 3))
    x = L.Conv2D(4, 3, strides=2, padding="same", name="z_conv")(inp)
    x = L.BatchNormalization(epsilon=1.001e-5, name="y_bn")(x)
    x = L.Activation("relu")(x)
    inner_in = L.Input((5, 5, 4))
    y = L.Conv2D(4, 3, padding="same", use_bias=False, name="x_conv")(inner_in)
    y = L.BatchNormalization(scale=False, name="w_bn")(y)
    inner = keras.Model(inner_in, L.Add()([inner_in, y]), name="inner")
    x = inner(x)
    x = L.DepthwiseConv2D(3, depth_multiplier=2, padding="same", name="v_dw")(x)
    x = L.Conv2D(6, 1, name="u_conv")(x)
    head = keras.Sequential([L.GlobalAveragePooling2D(), L.Dense(5, activation="softmax", name="t_dense")],
                            name="head")
    model = randomize(keras.Model(inp, head(x), name="filed"), seed=5)
    inner.trainable = False
    return model


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("keras_files")
    model = _model()
    paths = {}
    for ext in ("keras", "h5"):
        paths[ext] = str(d / f"model.{ext}")
        model.save(paths[ext])
    seq = randomize(keras.Sequential([L.Input((6,)), L.Dense(4, activation="relu"), L.Dense(2)], name="seq"))
    paths["sequential"] = str(d / "seq.keras")
    seq.save(paths["sequential"])
    return model, seq, paths


@pytest.mark.parametrize("ext", ["keras", "h5"])
def test_file_against_the_model_it_was_saved_from(saved, ext):
    model, _, paths = saved
    x = inputs((9, 10, 3))
    mf = ModelIngest.from_keras_file(paths[ext], device="cpu")
    assert mf.input_shape == (9, 10, 3) and mf.name == "filed"
    ours = mf(to_torch(x)).numpy()
    assert rel(ours, model.predict(x, verbose=0)) <= REL
    jax_mf = JaxModelIngest.from_keras_file(paths[ext])
    assert rel(ours, np.asarray(jax_mf(x))) <= REL


def test_sequential_file(saved):
    _, seq, paths = saved
    x = inputs((6,))
    mf = ModelIngest.from_keras_file(paths["sequential"], device="cpu")
    assert mf.input_shape == (6,)
    assert rel(mf(torch.from_numpy(x)).numpy(), seq.predict(x, verbose=0)) <= REL


def test_archive_keys_are_object_paths_not_names(saved):
    model, _, paths = saved
    with zipfile.ZipFile(paths["keras"]) as z:
        assert {"config.json", "metadata.json", "model.weights.h5"} <= set(z.namelist())
    config = model.get_config()
    walked = {path: obj for path, obj, _, _ in walk_layers(config)}
    assert walked == {
        "z_conv": "layers/conv2d",
        "y_bn": "layers/batch_normalization",
        "inner/x_conv": "layers/functional/layers/conv2d",
        "inner/w_bn": "layers/functional/layers/batch_normalization",
        "v_dw": "layers/depthwise_conv2d",
        "u_conv": "layers/conv2d_1",
        "head/t_dense": "layers/sequential/layers/dense",
    }
    frozen = {path for path, _, _, trainable in walk_layers(config) if not trainable}
    assert frozen == {"inner/x_conv", "inner/w_bn"}
    for ext in ("keras", "h5"):
        spec = read_keras_file(paths[ext])
        for path in walked:
            layer = spec
            for name in path.split("/"):
                layer = layer.get_layer(name)
            real = model
            for name in path.split("/"):
                real = real.get_layer(name)
            got, want = layer.get_weights(), real.get_weights()
            assert len(got) == len(want), (ext, path)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def _save(model, tmp_path, ext):
    path = str(tmp_path / f"m.{ext}")
    model.save(path)
    return path


@pytest.mark.parametrize("ext", ["keras", "h5"])
@pytest.mark.parametrize("case", ["layer-class", "bf16-policy"])
def test_refusals(tmp_path, ext, case):
    if case == "layer-class":
        model = keras.Sequential([L.Input((6, 4)), L.Conv1D(2, 3)])
        match = "'Conv1D'"
    else:
        model = keras.Sequential([L.Input((6,)), L.Dense(3, dtype="bfloat16")])
        match = "dtype policy 'bfloat16'"
    with pytest.raises(NotImplementedError, match=match) as err:
        ModelIngest.from_keras_file(_save(model, tmp_path, ext), device="cpu")
    assert "ROADMAP Queue A item 9" in str(err.value)


@pytest.mark.parametrize("ext", ["keras", "h5"])
def test_without_h5py_the_read_raises(saved, monkeypatch, ext):
    """The read no longer raises where h5py is absent: the port's own
    HDF5 reader reads the file, to the model's output (relative 1e-5)."""
    model, _, paths = saved
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py raises ImportError
    mf = ModelIngest.from_keras_file(paths[ext], device="cpu")
    x = inputs((9, 10, 3))
    assert rel(mf(to_torch(x)).numpy(), model.predict(x, verbose=0)) <= REL
