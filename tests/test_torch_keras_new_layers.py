"""The layers of ``keras.applications``' newer families (PR-era
EfficientNet, MobileNetV3, ConvNeXt, NASNet, InceptionResNetV2) through
the rest of the port's Keras path, against Keras on the CPU:

- a ``.keras`` archive and a legacy ``.h5`` file of a small model that
  holds every new weighted class (an adapted Normalization,
  LayerNormalization, ConvNeXt's LayerScale; one of each inside a nested
  Sequential, as ConvNeXt's stem), written by Keras and read by
  ``graph/keras_file.read_keras_file``: its weights are found by object
  path (``layers/layer_normalization_1``, ``layers/layer_scale``,
  ``layers/normalization``) and its output matches ``model.predict`` at
  relative 1e-5; ``spec_from_module`` writes every weight back in Keras's
  layout, order and dtype;
- one ``keras_fit`` epoch (adam, categorical cross-entropy, batch 8, no
  shuffle) of a small model with an SE block, LayerNormalization and
  LayerScale (dropout 0) against Keras's own ``fit``: every weight within
  relative 1e-4 of its max |value|, and the Normalization's statistics
  unchanged on both sides;
- in ``train()`` mode a Dropout with ``noise_shape`` (None, 1, 1, 1)
  drops whole rows and (None, 1, 1, None) whole channel maps.
"""

import keras
import numpy as np
import pytest
import torch
from keras.src.applications.convnext import LayerScale
from keras.src.applications.inception_resnet_v2 import CustomScaleLayer

from sparkdl_tpu_torch.estimators import keras_fit
from sparkdl_tpu_torch.graph.ingest import ModelIngest
from sparkdl_tpu_torch.graph.keras_file import read_keras_file
from sparkdl_tpu_torch.graph.keras_graph import KerasModelSpec, KerasModule, collect_weights, spec_from_module, walk_layers
from test_torch_keras_apps import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_keras_graph import REL, inputs, randomize, rel, to_torch

pytestmark = pytest.mark.usefixtures("one_torch_thread")

L = keras.layers
FIT_REL = 1e-4
SIDE = 8


def _model(classes=3):
    """Layer names against their classes' order; every new class."""
    inp = L.Input((SIDE, SIDE, 3))
    x = L.Rescaling(1.0 / 255.0, name="z_rescale")(inp)
    x = L.Normalization(axis=-1, name="z_norm")(x)  # adapted: its statistics are weights
    stem = keras.Sequential([L.Conv2D(8, 2, strides=2, name="stem_conv"),
                             L.LayerNormalization(epsilon=1e-6, name="stem_ln")], name="stem")
    x = stem(x)
    # a ConvNeXt block: grouped conv, LayerNormalization, Dense on channels, LayerScale, an op-node add
    y = L.Conv2D(8, 3, padding="same", groups=8, name="y_dw")(x)
    y = L.LayerNormalization(epsilon=1e-6, name="y_ln")(y)
    y = L.Dense(16, activation="gelu", name="y_pw1")(y)
    y = L.Dense(8, name="y_pw2")(y)
    y = LayerScale(1e-6, 8, name="y_scale")(y)
    x = x + y
    # an EfficientNet squeeze and excitation
    se = L.GlobalAveragePooling2D(name="x_squeeze")(x)
    se = L.Reshape((1, 1, 8), name="x_reshape")(se)
    se = L.Conv2D(4, 1, activation="swish", name="x_reduce")(se)
    se = L.Conv2D(8, 1, activation="sigmoid", name="x_expand")(se)
    x = L.Multiply(name="x_excite")([x, se])
    x = L.Cropping2D(((1, 0), (1, 0)), name="w_crop")(x)
    x = CustomScaleLayer(0.2, name="w_custom")([x, L.Conv2D(8, 1, name="w_conv")(x)])
    x = L.Activation("hard_silu", name="w_act")(x)
    x = LayerScale(1e-6, 8, name="v_scale")(x)
    x = L.LayerNormalization(center=False, name="v_ln")(x)
    x = L.Dropout(0.0, noise_shape=(None, 1, 1, 1), name="v_drop")(x)
    x = L.GlobalAveragePooling2D(name="u_pool")(x)
    out = L.Dense(classes, activation="softmax", name="u_head")(x)
    return randomize(keras.Model(inp, out, name="new_layers"), seed=3)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("new_layers")
    model = _model()
    paths = {}
    for ext in ("keras", "h5"):
        paths[ext] = str(d / f"model.{ext}")
        model.save(paths[ext])
    return model, paths


@pytest.mark.parametrize("ext", ["keras", "h5"])
def test_file_against_the_model_it_was_saved_from(saved, ext):
    model, paths = saved
    spec = read_keras_file(paths[ext])
    want = collect_weights(model)
    assert sorted(spec._weights) == sorted(want)
    for path, arrays in want.items():
        assert len(spec._weights[path]) == len(arrays), path
        for a, b in zip(spec._weights[path], arrays):
            np.testing.assert_array_equal(a, b)
    x = inputs((SIDE, SIDE, 3), lo=0, hi=255)
    ours = ModelIngest.from_keras(spec, device="cpu")(to_torch(x)).numpy()
    assert rel(ours, model.predict(x, verbose=0)) <= REL


def test_object_paths_of_the_new_classes(saved):
    model, _ = saved
    paths = {path: obj for path, obj, _, _ in walk_layers(model.get_config())}
    assert paths["z_norm"] == "layers/normalization"
    assert paths["stem/stem_ln"] == "layers/sequential/layers/layer_normalization"
    assert paths["y_ln"] == "layers/layer_normalization"
    assert paths["v_ln"] == "layers/layer_normalization_1"
    assert paths["y_scale"] == "layers/layer_scale"
    assert paths["v_scale"] == "layers/layer_scale_1"
    assert "z_rescale" not in paths and "w_custom" not in paths  # no weights


def test_weights_written_back_in_keras_layout(saved):
    model, _ = saved
    want = collect_weights(model)
    module = KerasModule(model.get_config(), model)
    got = spec_from_module(module)._weights
    assert sorted(got) == sorted(want)
    for path, arrays in want.items():
        assert [a.shape for a in got[path]] == [a.shape for a in arrays], path
        for a, b in zip(got[path], arrays):
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b)


def test_fit_epoch_against_keras():
    model = _model(classes=4)
    start = collect_weights(model)
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 255, (24, SIDE, SIDE, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 24)]
    module = KerasModule(model.get_config(), KerasModelSpec(model.get_config(), start))
    history = keras_fit.fit(module, x, y, optimizer="adam", loss="categorical_crossentropy",
                            params={"epochs": 1, "batch_size": 8, "shuffle": False})
    model.compile(optimizer="adam", loss="categorical_crossentropy")
    keras_history = model.fit(x, y, epochs=1, batch_size=8, shuffle=False, verbose=0)
    assert abs(history["loss"][0] - keras_history.history["loss"][0]) <= FIT_REL * abs(history["loss"][0])
    ours, theirs = spec_from_module(module)._weights, collect_weights(model)
    moved = 0
    for path, arrays in theirs.items():
        for i, (a, b) in enumerate(zip(ours[path], arrays)):
            scale = max(float(np.abs(b).max()), 1e-12)
            assert float(np.abs(a.astype(np.float64) - b).max()) / scale <= FIT_REL, (path, i)
            moved += not np.array_equal(b, start[path][i])
    for i in range(2):  # the Normalization's statistics: buffers, not trained
        np.testing.assert_array_equal(ours["z_norm"][i], start["z_norm"][i])
        np.testing.assert_array_equal(theirs["z_norm"][i], start["z_norm"][i])
    assert moved >= 18  # every trainable weight moved


@pytest.mark.parametrize("noise_shape", [(None, 1, 1, 1), (None, 1, 1, None)])
def test_dropout_noise_shape_drops_whole_units(noise_shape):
    model = keras.Sequential([L.Input((4, 5, 3)), L.Dropout(0.5, noise_shape=noise_shape)])
    module = KerasModule(model.get_config(), model)
    module.seed_dropout(0)
    module.train()
    out = module(torch.ones(64, 3, 4, 5)).numpy()  # NHWC out
    assert set(np.unique(out)) == {0.0, 2.0}
    units = out.reshape(64, -1) if noise_shape[-1] == 1 else out.transpose(0, 3, 1, 2).reshape(64 * 3, -1)
    assert (units.min(axis=1) == units.max(axis=1)).all()  # each unit kept or dropped whole
    kept = float((units[:, 0] > 0).mean())
    assert 0.3 <= kept <= 0.7, kept
    module.eval()
    np.testing.assert_array_equal(module(torch.ones(2, 3, 4, 5)).numpy(), np.ones((2, 4, 5, 3), np.float32))
