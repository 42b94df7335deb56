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
- the layers of EfficientNet, MobileNetV3, ConvNeXt, NASNet and
  InceptionResNetV2: Rescaling (a number and a list), Normalization
  (adapted, its mean and variance weights, and fixed in its config),
  Reshape across ranks (Keras's NHWC order against the module's NCHW),
  Multiply with broadcasting, the op nodes ``keras.src.ops.numpy``
  records for ``x + 3.0`` (the number on either side), hard_sigmoid and
  hard_silu, LayerNormalization on ranks 2-4, ConvNeXt's LayerScale,
  Cropping2D, InceptionResNetV2's CustomScaleLayer and Dropout with a
  ``noise_shape``: relative 1e-5;
- the refusals: another layer class (a ConvLSTM1D), a bfloat16 policy, two
  inputs, ``channels_first``, ``rms_scaling``, ``Normalization(invert)``,
  an op node over a numpy array, an op outside the table, a noise shape
  with a channel entry and a LayerScale from another module than
  ConvNeXt's;
- the refusals name the class and the ROADMAP item.

The keras.applications models and the committed ResNet50 config are in
``test_torch_keras_apps*.py``.
"""

import keras
import numpy as np
import pytest
import torch
from keras.src.applications.convnext import LayerScale
from keras.src.applications.inception_resnet_v2 import CustomScaleLayer

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
        elif isinstance(layer, L.Normalization):  # adapted: mean, positive variance, count
            new = [rng.normal(0.0, 0.5, weights[0].shape), rng.uniform(0.5, 2.0, weights[1].shape)]
            layer.set_weights([np.asarray(w, np.float32) for w in new] + [weights[2]])
            layer.finalize_state()  # what adapt() and a file's load do: the call reads the new statistics
            continue
        elif isinstance(layer, L.LayerNormalization):
            new = [rng.uniform(0.5, 1.5, w.shape) if i == 0 and layer.scale else rng.normal(0.0, 0.2, w.shape)
                   for i, w in enumerate(weights)]
        elif isinstance(layer, LayerScale):
            new = [rng.uniform(0.1, 0.5, weights[0].shape)]
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
    "rescaling-number": ((5, 6, 3), lambda: [L.Rescaling(1.0 / 127.5, offset=-1.0)], (0, 255)),
    "rescaling-list": ((5, 6, 3), lambda: [L.Rescaling([0.5, 2.0, 1.5], offset=[0.1, -0.2, 0.3])], (-1, 1)),
    "rescaling-rank2": ((3,), lambda: [L.Rescaling([0.5, 2.0, 1.5], offset=0.25)], (-1, 1)),
    "normalization-adapted": ((5, 6, 3), lambda: [L.Normalization(axis=-1)], (-2, 2)),
    "normalization-adapted-axes": ((5, 6, 3), lambda: [L.Normalization(axis=(1, 3))], (-2, 2)),
    "normalization-fixed": ((5, 6, 3), lambda: [L.Normalization(mean=[123.675, 116.28, 103.53],
                                                                 variance=[3409.98, 3262.69, 3291.89])], (0, 255)),
    "normalization-fixed-number": ((4,), lambda: [L.Normalization(axis=None, mean=2.0, variance=4.0)], (-3, 3)),
    "reshape-2to4": ((12,), lambda: [L.Reshape((1, 1, 12)), L.Conv2D(4, 1)], (-1, 1)),
    "reshape-4to2": ((2, 3, 4), lambda: [L.Conv2D(5, 1), L.Reshape((30,))], (-1, 1)),
    "reshape-4to4": ((2, 3, 4), lambda: [L.Conv2D(4, 1), L.Reshape((3, 2, 4)), L.Conv2D(3, (2, 1))], (-1, 1)),
    "reshape-minus-one": ((2, 3, 4), lambda: [L.Conv2D(4, 1), L.Reshape((-1, 2, 2)), L.Conv2D(3, 1)], (-1, 1)),
    "reshape-4to3": ((2, 3, 4), lambda: [L.Reshape((6, 4)), L.Dense(3)], (-1, 1)),
    "reshape-mobilenet-head": ((4, 5, 6), lambda: [L.GlobalAveragePooling2D(keepdims=True), L.Conv2D(7, 1),
                                                   L.Reshape((7,))], (-1, 1)),
    "layernorm-rank2": ((7,), lambda: [L.LayerNormalization()], (-2, 2)),
    "layernorm-rank3": ((5, 6), lambda: [L.LayerNormalization(epsilon=1e-6)], (-2, 2)),
    "layernorm-rank4": ((4, 5, 6), lambda: [L.LayerNormalization(epsilon=1e-6)], (-2, 2)),
    "layernorm-rank4-axes": ((4, 5, 6), lambda: [L.LayerNormalization(axis=[1, 2, 3])], (-2, 2)),
    "layernorm-rank4-hw": ((4, 5, 6), lambda: [L.LayerNormalization(axis=[1, 2])], (-2, 2)),
    "layernorm-no-center": ((4, 5, 6), lambda: [L.LayerNormalization(center=False)], (-2, 2)),
    "layernorm-no-scale": ((4, 5, 6), lambda: [L.LayerNormalization(scale=False)], (-2, 2)),
    "layernorm-neither": ((7,), lambda: [L.LayerNormalization(center=False, scale=False, epsilon=0.1)], (-2, 2)),
    "layer-scale": ((4, 5, 6), lambda: [LayerScale(1e-6, 6)], (-2, 2)),
    "layer-scale-rank2": ((6,), lambda: [LayerScale(1e-6, 6)], (-2, 2)),
    "cropping-int": ((7, 8, 3), lambda: [L.Cropping2D(2)], (-1, 1)),
    "cropping-pair": ((7, 8, 3), lambda: [L.Cropping2D((1, 2))], (-1, 1)),
    "cropping-nasnet": ((7, 8, 3), lambda: [L.ZeroPadding2D(((0, 1), (0, 1))), L.Cropping2D(((1, 0), (1, 0)))],
                        (-1, 1)),
    "cropping-asymmetric": ((9, 8, 3), lambda: [L.Cropping2D(((1, 3), (2, 0))), L.Conv2D(2, 3)], (-1, 1)),
    "dropout-noise-shape": ((5, 6, 3), lambda: [L.Dropout(0.2, noise_shape=(None, 1, 1, 1)), L.Conv2D(2, 1)],
                            (-1, 1)),
}

ACTIVATIONS = ("linear", "relu", "relu6", "sigmoid", "tanh", "softmax", "swish", "silu", "gelu",
               "hard_sigmoid", "hard_silu", "hard_swish")


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


def _op_node_model(case):
    """A Functional model over the op nodes Keras records for Python
    arithmetic on tensors: the number on the right or on the left."""
    inp = L.Input((5, 6, 3))
    y = L.Conv2D(4, 3, padding="same")(inp)
    out = {
        "add-right": lambda: y + 3.0,
        "add-left": lambda: 3.0 + y,
        "multiply-right": lambda: y * (1.0 / 6.0),
        "multiply-left": lambda: 0.5 * y,
        "subtract-left": lambda: 2.0 - y,
        "subtract-right": lambda: y - 2,
        "divide-left": lambda: 1.0 / (y * y + 1.0),
        "divide-right": lambda: y / 4.0,
        "hard-sigmoid-mobilenetv3": lambda: L.ReLU(6.0)(y + 3.0) * (1.0 / 6.0),
        "tensor-tensor": lambda: y + L.Conv2D(4, 1)(inp) * y,
    }[case]()
    return randomize(keras.Model(inp, out))


@pytest.mark.parametrize("case", ["add-right", "add-left", "multiply-right", "multiply-left", "subtract-left",
                                  "subtract-right", "divide-left", "divide-right", "hard-sigmoid-mobilenetv3",
                                  "tensor-tensor"])
def test_op_nodes_against_keras(case):
    model = _op_node_model(case)
    assert any(l.get("module") == "keras.src.ops.numpy" for l in model.get_config()["layers"])
    x = inputs((5, 6, 3), lo=-3, hi=3)
    assert rel(port(model, x), model.predict(x, verbose=0)) <= REL


@pytest.mark.parametrize("case", ["se-block", "multiply-three", "custom-scale", "custom-scale-relu"])
def test_gated_merges_against_keras(case):
    inp = L.Input((6, 7, 4))
    x = L.Conv2D(8, 3, padding="same", activation="swish")(inp)
    if case == "se-block":  # EfficientNet's squeeze and excitation
        se = L.GlobalAveragePooling2D()(x)
        se = L.Reshape((1, 1, 8))(se)
        se = L.Conv2D(2, 1, activation="swish")(se)
        se = L.Conv2D(8, 1, activation="sigmoid")(se)
        out = L.Multiply()([x, se])
    elif case == "multiply-three":
        out = L.Multiply()([x, L.Conv2D(8, 1)(inp), L.Conv2D(8, 1)(inp)])
    else:  # InceptionResNetV2's residual scaling
        branch = L.Conv2D(8, 1)(x)
        out = CustomScaleLayer(0.17)([x, branch])
        if case == "custom-scale-relu":
            out = L.Activation("relu")(out)
    model = randomize(keras.Model(inp, out))
    x = inputs((6, 7, 4), lo=-2, hi=2)
    assert rel(port(model, x), model.predict(x, verbose=0)) <= REL


def test_the_table_is_the_documented_one():
    assert set(LAYER_CLASSES) == {
        "InputLayer", "Conv2D", "DepthwiseConv2D", "SeparableConv2D", "BatchNormalization",
        "Activation", "ReLU", "ZeroPadding2D", "MaxPooling2D", "AveragePooling2D",
        "GlobalAveragePooling2D", "GlobalMaxPooling2D", "Add", "Concatenate", "Dense",
        "Flatten", "Dropout", "Rescaling", "Normalization", "Reshape", "Multiply",
        "LayerNormalization", "LayerScale", "Cropping2D", "CustomScaleLayer",
        # the sequence layers (graph/keras_seq.py, test_torch_keras_seq*.py)
        "Embedding", "Masking", "Conv1D", "MaxPooling1D", "AveragePooling1D", "GlobalAveragePooling1D",
        "GlobalMaxPooling1D", "SpatialDropout1D", "SimpleRNN", "LSTM", "GRU", "Bidirectional",
        "MultiHeadAttention",
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
                                  "channels-first", "rms-scaling", "normalization-invert", "op-numpy-argument",
                                  "op-class", "dropout-noise-shape", "app-class-of-another-module"])
def test_refusals(case):
    if case == "layer-class":
        model = keras.Sequential([L.Input((5, 6, 4)), L.ConvLSTM1D(2, 3)])
        match = "'ConvLSTM1D'"
    elif case == "rms-scaling":
        model = keras.Sequential([L.Input((6, 4)), L.LayerNormalization(rms_scaling=True)])
        match = "rms_scaling=True"
    elif case == "normalization-invert":
        model = keras.Sequential([L.Input((6,)), L.Normalization(mean=1.0, variance=2.0, invert=True)])
        match = "invert=True"
    elif case in ("op-numpy-argument", "op-class"):
        inp = L.Input((4, 4, 3))
        y = L.Conv2D(3, 1)(inp)
        out = y + np.ones(3, np.float32) if case == "op-numpy-argument" else keras.ops.maximum(y, 0.0)
        model = keras.Model(inp, out)
        match = "neither a tensor nor a number" if case == "op-numpy-argument" else "Keras op 'Maximum'"
    elif case == "app-class-of-another-module":  # a user's own LayerScale is not ConvNeXt's
        model = keras.Sequential([L.Input((4, 4, 3)), LayerScale(1e-6, 3)])
        config = model.get_config()
        config["layers"][-1]["module"] = "my_project.layers"
        model = KerasModelSpec(config, collect_weights(model))
        match = "'LayerScale' of 'my_project.layers'"
    elif case == "dropout-noise-shape":
        model = keras.Sequential([L.Input((4, 4, 3)), L.Dropout(0.5, noise_shape=(None, 1, 1, 3))])
        match = r"noise_shape \[None, 1, 1, 3\]"
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
