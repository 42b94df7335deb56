"""The port's Keras-to-torch translator (``sparkdl_tpu_torch/graph/keras_graph.py``
through ``graph/ingest.ModelIngest.from_keras``) against Keras itself on
the CPU (keras on its jax backend, as ``tests/conftest.py`` sets it).

- every layer of the translator's table against ``model.predict`` at
  small shapes, odd and even sizes, strides 1 and 2, with the traps the
  translation has to get right: TF's "same" padding at stride 2 (the odd
  unit at the end, -inf for max pooling), average pooling without the
  padding in its count, each BatchNormalization's own epsilon and its
  optional gamma/beta, the depthwise output order, NHWC flattening,
  Concatenate's axis and ReLU's three arguments: relative 1e-5;
- nested models (a Functional model and a Sequential head inside a
  Sequential and a Functional model, a frozen one, a model called twice)
  and a model with two outputs;
- the refusals: another layer class, a bfloat16 policy, two inputs,
  ``channels_first``;
- the refusals name the class and the ROADMAP item.

The keras.applications models and the committed ResNet50 config are in
``test_torch_keras_apps.py`` and ``test_torch_keras_apps_inception.py``.
"""

import keras
import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.graph.ingest import ModelIngest
from sparkdl_tpu_torch.graph.keras_graph import LAYER_CLASSES, KerasModelSpec, collect_weights

L = keras.layers
REL = 1e-5
APP_REL = 1e-4


def leaf_layers(model):
    for layer in model.layers:
        if isinstance(layer, keras.Model):
            yield from leaf_layers(layer)
        else:
            yield layer


def randomize(model, seed=0, bn_var=(1e-3, 1.0)):
    """Seeded weights for every layer of ``model``: kernels He-scaled,
    BatchNorm statistics drawn (variance in ``bn_var``, so each layer's
    epsilon shows), biases and betas small."""
    rng = np.random.default_rng(seed)
    for layer in leaf_layers(model):
        weights = layer.get_weights()
        if not weights:
            continue
        if isinstance(layer, L.BatchNormalization):
            new = [rng.normal(0.0, 0.2, w.shape) for w in weights[:-2]]
            if layer.scale:
                new[0] = rng.uniform(0.5, 1.5, weights[0].shape)
            new += [rng.normal(0.0, 0.2, weights[-2].shape), rng.uniform(*bn_var, weights[-1].shape)]
        else:
            new = []
            for w in weights:
                fan_in = int(np.prod(w.shape[:-1])) if w.ndim > 1 else 0
                if isinstance(layer, (L.DepthwiseConv2D, L.SeparableConv2D)) and w.ndim == 4 and w.shape[0] > 1:
                    fan_in = w.shape[0] * w.shape[1]
                new.append(rng.normal(0.0, np.sqrt(2.0 / fan_in), w.shape) if fan_in else rng.normal(0.0, 0.1, w.shape))
        layer.set_weights([np.asarray(w, np.float32) for w in new])
    return model


def to_torch(x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(x)
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def port(model, x):
    """The port's ModelFunction of ``model`` over NHWC ``x``, on the CPU,
    with outputs as numpy in Keras's structure."""
    y = ModelIngest.from_keras(model, device="cpu")(to_torch(x))
    return [t.numpy() for t in y] if isinstance(y, list) else y.numpy()


def rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def inputs(shape, seed=1, lo=-1.0, hi=1.0, n=2):
    return np.random.default_rng(seed).uniform(lo, hi, (n, *shape)).astype(np.float32)


# -- the layer table ------------------------------------------------------------

# id: (input shape, layers after the input, input range)
SEQUENTIAL_CASES = {
    "conv3x3-s1-same": ((9, 10, 3), lambda: [L.Conv2D(4, 3, padding="same")], (-1, 1)),
    "conv3x3-s1-valid-relu": ((9, 10, 3), lambda: [L.Conv2D(4, 3, activation="relu")], (-1, 1)),
    "conv3x3-s2-same-odd": ((9, 11, 3), lambda: [L.Conv2D(4, 3, strides=2, padding="same")], (-1, 1)),
    "conv3x3-s2-same-even": ((8, 10, 3), lambda: [L.Conv2D(4, 3, strides=2, padding="same")], (-1, 1)),
    "conv7x7-s2-valid": ((15, 16, 3), lambda: [L.Conv2D(5, 7, strides=2)], (-1, 1)),
    "conv2x2-s1-same": ((7, 8, 3), lambda: [L.Conv2D(4, 2, padding="same")], (-1, 1)),
    "conv1x1-s2-same": ((9, 10, 4), lambda: [L.Conv2D(6, 1, strides=2, padding="same", use_bias=False)], (-1, 1)),
    "conv3x3-dilated-same": ((11, 12, 3), lambda: [L.Conv2D(4, 3, dilation_rate=2, padding="same")], (-1, 1)),
    "conv3x3-groups": ((9, 10, 4), lambda: [L.Conv2D(6, 3, groups=2, padding="same")], (-1, 1)),
    "conv1x7-same": ((9, 10, 3), lambda: [L.Conv2D(4, (1, 7), padding="same")], (-1, 1)),
    "depthwise-m2-s1-same": ((9, 10, 3), lambda: [L.DepthwiseConv2D(3, depth_multiplier=2, padding="same")], (-1, 1)),
    "depthwise-s2-same-odd": ((9, 11, 4), lambda: [L.DepthwiseConv2D(3, strides=2, padding="same")], (-1, 1)),
    "depthwise-s2-valid-nobias": ((10, 9, 4), lambda: [L.DepthwiseConv2D(3, strides=2, use_bias=False)], (-1, 1)),
    "separable-s1-same": ((9, 10, 3), lambda: [L.SeparableConv2D(5, 3, padding="same")], (-1, 1)),
    "separable-m2-s2-same-relu": ((9, 10, 3), lambda: [L.SeparableConv2D(5, 3, strides=2, depth_multiplier=2,
                                                                           padding="same", activation="relu")], (-1, 1)),
    "separable-nobias": ((8, 8, 4), lambda: [L.SeparableConv2D(6, 3, padding="same", use_bias=False)], (-1, 1)),
    "batchnorm-eps-resnet": ((5, 6, 4), lambda: [L.BatchNormalization(epsilon=1.001e-5)], (-1, 1)),
    "batchnorm-eps-default": ((5, 6, 4), lambda: [L.BatchNormalization()], (-1, 1)),
    "batchnorm-no-scale": ((5, 6, 4), lambda: [L.BatchNormalization(scale=False)], (-1, 1)),
    "batchnorm-no-center": ((5, 6, 4), lambda: [L.BatchNormalization(center=False)], (-1, 1)),
    "batchnorm-neither": ((5, 6, 4), lambda: [L.BatchNormalization(scale=False, center=False)], (-1, 1)),
    "batchnorm-rank2": ((6,), lambda: [L.BatchNormalization(epsilon=0.01)], (-1, 1)),
    "relu6": ((5, 6, 3), lambda: [L.ReLU(6.0)], (-8, 8)),
    "relu-slope": ((5, 6, 3), lambda: [L.ReLU(negative_slope=0.1)], (-8, 8)),
    "relu-threshold": ((5, 6, 3), lambda: [L.ReLU(threshold=0.5)], (-8, 8)),
    "relu-all-three": ((5, 6, 3), lambda: [L.ReLU(max_value=2.0, negative_slope=0.1, threshold=0.3)], (-8, 8)),
    "zeropad-mobilenet": ((7, 8, 3), lambda: [L.ZeroPadding2D(((0, 1), (0, 1)))], (-1, 1)),
    "zeropad-int": ((7, 8, 3), lambda: [L.ZeroPadding2D(3)], (-1, 1)),
    "zeropad-uneven": ((7, 8, 3), lambda: [L.ZeroPadding2D(((1, 2), (3, 4))), L.Conv2D(2, 3)], (-1, 1)),
    "maxpool3-s2-same-odd": ((9, 11, 3), lambda: [L.MaxPooling2D(3, strides=2, padding="same")], (-3, -1)),
    "maxpool3-s2-same-even": ((8, 10, 3), lambda: [L.MaxPooling2D(3, strides=2, padding="same")], (-3, -1)),
    "maxpool2-valid": ((9, 10, 3), lambda: [L.MaxPooling2D(2)], (-1, 1)),
    "maxpool3-s1-same": ((7, 8, 3), lambda: [L.MaxPooling2D(3, strides=1, padding="same")], (-3, -1)),
    "avgpool3-s1-same": ((7, 8, 3), lambda: [L.AveragePooling2D(3, strides=1, padding="same")], (1, 2)),
    "avgpool3-s2-same-odd": ((9, 11, 3), lambda: [L.AveragePooling2D(3, strides=2, padding="same")], (1, 2)),
    "avgpool2-s1-same": ((7, 8, 3), lambda: [L.AveragePooling2D(2, strides=1, padding="same")], (1, 2)),
    "avgpool2-valid": ((9, 10, 3), lambda: [L.AveragePooling2D(2)], (-1, 1)),
    "gap": ((5, 6, 4), lambda: [L.GlobalAveragePooling2D()], (-1, 1)),
    "gap-keepdims": ((5, 6, 4), lambda: [L.GlobalAveragePooling2D(keepdims=True)], (-1, 1)),
    "gmp": ((5, 6, 4), lambda: [L.GlobalMaxPooling2D()], (-1, 1)),
    "gmp-keepdims-conv": ((5, 6, 4), lambda: [L.GlobalMaxPooling2D(keepdims=True), L.Conv2D(3, 1)], (-1, 1)),
    "dense": ((7,), lambda: [L.Dense(5)], (-1, 1)),
    "dense-softmax-nobias": ((7,), lambda: [L.Dense(5, activation="softmax", use_bias=False)], (-1, 1)),
    "dense-on-channels": ((4, 5, 3), lambda: [L.Dense(6)], (-1, 1)),
    "flatten-nhwc": ((5, 7, 3), lambda: [L.Conv2D(4, 3, padding="same"), L.Flatten(), L.Dense(6)], (-1, 1)),
    "dropout": ((5, 6, 3), lambda: [L.Dropout(0.5), L.Conv2D(2, 1)], (-1, 1)),
    "softmax-on-channels": ((4, 5, 6), lambda: [L.Activation("softmax")], (-3, 3)),
}

ACTIVATIONS = ("linear", "relu", "relu6", "sigmoid", "tanh", "softmax", "swish", "silu", "gelu")


@pytest.mark.parametrize("case", sorted(SEQUENTIAL_CASES))
def test_layer_against_keras(case):
    shape, layers, (lo, hi) = SEQUENTIAL_CASES[case]
    model = randomize(keras.Sequential([L.Input(shape), *layers()]))
    x = inputs(shape, lo=lo, hi=hi)
    ours, ref = port(model, x), model.predict(x, verbose=0)
    assert ours.shape == ref.shape
    assert rel(ours, ref) <= REL, case


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_against_keras(name):
    model = keras.Sequential([L.Input((4, 5, 3)), L.Activation(name)])
    x = inputs((4, 5, 3), lo=-3, hi=3)
    assert rel(port(model, x), model.predict(x, verbose=0)) <= REL


@pytest.mark.parametrize("merge", ["add", "concat-channels", "concat-axis1", "concat-axis2"])
def test_merge_layers_against_keras(merge):
    inp = L.Input((6, 7, 3))
    a = L.Conv2D(4, 3, padding="same")(inp)
    b = L.Conv2D(4, 3, strides=1, padding="same", activation="relu")(inp)
    c = L.Conv2D(4, 1)(inp)
    if merge == "add":
        out = L.Add()([a, b, c])
    else:
        axis = {"concat-channels": -1, "concat-axis1": 1, "concat-axis2": 2}[merge]
        out = L.Concatenate(axis=axis)([a, b, c])
    model = randomize(keras.Model(inp, out))
    x = inputs((6, 7, 3))
    assert rel(port(model, x), model.predict(x, verbose=0)) <= REL


def test_the_table_is_the_documented_one():
    assert set(LAYER_CLASSES) == {
        "InputLayer", "Conv2D", "DepthwiseConv2D", "SeparableConv2D", "BatchNormalization",
        "Activation", "ReLU", "ZeroPadding2D", "MaxPooling2D", "AveragePooling2D",
        "GlobalAveragePooling2D", "GlobalMaxPooling2D", "Add", "Concatenate", "Dense",
        "Flatten", "Dropout",
    }


# -- graphs -----------------------------------------------------------------------


def _base(name="base", shape=(8, 8, 3)):
    inp = L.Input(shape)
    x = L.Conv2D(4, 3, padding="same", name=f"{name}_c1")(inp)
    x = L.BatchNormalization(name=f"{name}_bn1")(x)
    x = L.Activation("relu")(x)
    y = L.Conv2D(4, 3, padding="same", name=f"{name}_c2")(x)
    y = L.BatchNormalization(scale=False, name=f"{name}_bn2")(y)
    return keras.Model(inp, L.Add()([x, y]), name=name)


def _head(name="head"):
    return keras.Sequential([L.GlobalAveragePooling2D(), L.Dense(3, activation="softmax")], name=name)


def test_nested_sequential_base_and_head():
    model = randomize(keras.Sequential([L.Input((8, 8, 3)), _base(), _head()], name="outer"))
    x = inputs((8, 8, 3))
    assert rel(port(model, x), model.predict(x, verbose=0)) <= REL


def test_nested_functional_frozen_shared_and_two_outputs():
    base = _base()
    inp = L.Input((8, 8, 3))
    pre = L.Conv2D(3, 1, name="pre")(inp)
    once, twice = base(pre), base(inp)  # one model, two nodes
    model = randomize(keras.Model(inp, [_head()(once), L.Add()([once, twice])], name="two_out"))
    base.trainable = False
    x = inputs((8, 8, 3))
    ours, ref = port(model, x), model.predict(x, verbose=0)
    assert isinstance(ours, list) and len(ours) == 2
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        assert rel(a, b) <= REL


def test_weights_are_read_by_layer_path():
    model = randomize(keras.Sequential([L.Input((8, 8, 3)), _base(), _head()], name="outer"))
    weights = collect_weights(model)
    assert sorted(weights) == sorted([
        "base/base_c1", "base/base_bn1", "base/base_c2", "base/base_bn2",
        f"head/{model.layers[1].layers[1].name}",
    ])
    assert len(weights["base/base_bn2"]) == 3  # no gamma
    spec = KerasModelSpec(model.get_config(), weights)
    x = inputs((8, 8, 3))
    np.testing.assert_array_equal(port(spec, x), port(model, x))


# -- refusals -----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["layer-class", "activation", "bf16-policy", "mixed-policy", "two-inputs",
                                  "channels-first"])
def test_refusals(case):
    if case == "layer-class":
        model = keras.Sequential([L.Input((6, 4)), L.LayerNormalization()])
        match = "'LayerNormalization'"
    elif case == "activation":
        model = keras.Sequential([L.Input((6,)), L.Dense(3, activation="elu")])
        match = "activation 'elu'"
    elif case in ("bf16-policy", "mixed-policy"):
        dtype = "bfloat16" if case == "bf16-policy" else "mixed_bfloat16"
        model = keras.Sequential([L.Input((6,)), L.Dense(3, dtype=dtype)])
        match = f"dtype policy '{dtype}'"
    elif case == "two-inputs":
        a, b = L.Input((4,)), L.Input((4,))
        model = keras.Model([a, b], L.Add()([a, b]))
        match = "2 inputs"
    else:
        model = keras.Sequential([L.Input((3, 6, 6)), L.Conv2D(2, 3, data_format="channels_first")])
        match = "channels_first"
    with pytest.raises(NotImplementedError, match=match) as err:
        ModelIngest.from_keras(model, device="cpu")
    assert "ROADMAP Queue A item 9" in str(err.value)
