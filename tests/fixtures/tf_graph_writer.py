"""Write a frozen TF GraphDef for a Keras model, without TensorFlow or
protobuf.

``chip_smoke.py`` phase 21 runs on a machine with neither, so the GraphDef
it ingests comes from here: :func:`frozen_graph_def` takes a Keras model
as data (anything with ``get_config()`` and ``get_layer(name).get_weights()``,
such as the port's ``KerasModelSpec``) and emits, in protobuf's wire
format, the nodes that TF's ``convert_variables_to_constants_v2`` gives for
each layer, every weight a ``Const``:

- ``InputLayer``: ``Placeholder`` (float32, ``[-1, H, W, C]``);
- ``ZeroPadding2D``: ``Pad``;
- ``Conv2D``: ``Conv2D`` (+ ``BiasAdd``); ``DepthwiseConv2D``:
  ``DepthwiseConv2dNative`` (+ ``BiasAdd``); ``SeparableConv2D``: both,
  the pointwise one a 1x1 ``Conv2D``;
- ``BatchNormalization``: ``FusedBatchNormV3`` (inference);
- ``Activation``/``ReLU`` and a layer's ``activation``: ``Relu``,
  ``Relu6``, ``Softmax``;
- ``MaxPooling2D``: ``MaxPool``;
- ``Add``: ``AddV2``; ``GlobalAveragePooling2D``: ``Mean`` over H and W;
- ``Dense``: ``MatMul`` + ``BiasAdd``;
- the output: ``Identity``.

Functional models with one input and one output, NHWC, float32: the
layers of the Keras ResNet50 config and of ``keras_cnn.keras``. The
field numbers are those of TF's ``graph.proto``, ``node_def.proto``,
``attr_value.proto``, ``tensor.proto`` and ``tensor_shape.proto``; TF's
own parser reads the bytes (``tests/test_torch_tf_ingest.py``).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

DT_FLOAT, DT_INT32 = 1, 3
_MASK64 = (1 << 64) - 1


# -- the wire format --------------------------------------------------------


def _varint(v: int) -> bytes:
    v &= _MASK64
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _field(number: int, wire: int) -> bytes:
    return _varint(number << 3 | wire)


def _bytes(number: int, payload: bytes) -> bytes:
    return _field(number, 2) + _varint(len(payload)) + payload


def _int(number: int, v: int) -> bytes:
    return _field(number, 0) + _varint(int(v))


def _shape(dims) -> bytes:
    return b"".join(_bytes(2, _int(1, d)) for d in dims)  # TensorShapeProto.dim { size }


def _tensor(arr: np.ndarray) -> bytes:
    dtype = {np.dtype(np.float32): DT_FLOAT, np.dtype(np.int32): DT_INT32}[arr.dtype]
    return (_int(1, dtype) + _bytes(2, _shape(arr.shape))
            + _bytes(4, np.ascontiguousarray(arr).astype(arr.dtype.newbyteorder("<")).tobytes()))


# AttrValue
def _a_type(dtype: int) -> bytes:
    return _int(6, dtype)


def _a_s(s: str) -> bytes:
    return _bytes(2, s.encode())


def _a_f(v: float) -> bytes:
    return _field(4, 5) + struct.pack("<f", v)


def _a_b(v: bool) -> bytes:
    return _int(5, 1 if v else 0)


def _a_ints(vs) -> bytes:
    return _bytes(1, _bytes(3, b"".join(_varint(v) for v in vs)))  # list { i: packed }


def _a_shape(dims) -> bytes:
    return _bytes(7, _shape(dims))


def _a_tensor(arr: np.ndarray) -> bytes:
    return _bytes(8, _tensor(arr))


def _node(name: str, op: str, inputs: List[str], attrs: Dict[str, bytes]) -> bytes:
    body = _bytes(1, name.encode()) + _bytes(2, op.encode())
    body += b"".join(_bytes(3, i.encode()) for i in inputs)
    body += b"".join(_bytes(5, _bytes(1, k.encode()) + _bytes(2, v)) for k, v in sorted(attrs.items()))
    return body


# -- Keras layers -> nodes ----------------------------------------------------


class _Graph:
    def __init__(self):
        self.nodes: List[bytes] = []

    def add(self, name: str, op: str, inputs: List[str], **attrs: bytes) -> str:
        self.nodes.append(_node(name, op, inputs, attrs))
        return name

    def const(self, name: str, value: np.ndarray) -> str:
        value = np.asarray(value)
        dtype = DT_INT32 if value.dtype.kind in "iu" else DT_FLOAT
        value = value.astype(np.int32 if dtype == DT_INT32 else np.float32)
        return self.add(name, "Const", [], dtype=_a_type(dtype), value=_a_tensor(value))

    def serialize(self, producer: int = 1994) -> bytes:
        return b"".join(_bytes(1, n) for n in self.nodes) + _bytes(4, _int(1, producer))


_ACTIVATIONS = {"relu": "Relu", "softmax": "Softmax"}
_T = {"T": _a_type(DT_FLOAT)}


def _activation(g: _Graph, name: str, act, x: str) -> str:
    if act in (None, "linear"):
        return x
    if act not in _ACTIVATIONS:
        raise NotImplementedError(f"activation {act!r} of layer {name!r}")
    op = _ACTIVATIONS[act]
    return g.add(f"{name}/{op}", op, [x], **_T)


def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _conv_attrs(cfg: dict) -> Dict[str, bytes]:
    sh, sw = _pair(cfg.get("strides", 1))
    dh, dw = _pair(cfg.get("dilation_rate", 1))
    return dict(_T, strides=_a_ints([1, sh, sw, 1]), dilations=_a_ints([1, dh, dw, 1]),
                padding=_a_s(cfg.get("padding", "valid").upper()), data_format=_a_s("NHWC"))


def _bias(g: _Graph, name: str, x: str, bias) -> str:
    b = g.const(f"{name}/bias", bias)
    return g.add(f"{name}/BiasAdd", "BiasAdd", [x, b], data_format=_a_s("NHWC"), **_T)


def _layer(g: _Graph, cls: str, cfg: dict, name: str, xs: List[str], weights: List[np.ndarray]) -> str:
    x = xs[0]
    if cls == "ZeroPadding2D":
        (t, b), (left, r) = cfg["padding"]  # ((top, bottom), (left, right))
        pads = g.const(f"{name}/paddings", np.array([[0, 0], [t, b], [left, r], [0, 0]]))
        return g.add(f"{name}/Pad", "Pad", [x, pads], Tpaddings=_a_type(DT_INT32), **_T)
    if cls == "Conv2D":
        k = g.const(f"{name}/kernel", weights[0])
        y = g.add(f"{name}/Conv2D", "Conv2D", [x, k], use_cudnn_on_gpu=_a_b(True), **_conv_attrs(cfg))
        if cfg.get("use_bias", True):
            y = _bias(g, name, y, weights[1])
        return _activation(g, name, cfg.get("activation"), y)
    if cls in ("DepthwiseConv2D", "SeparableConv2D"):
        k = g.const(f"{name}/depthwise_kernel", weights[0])
        y = g.add(f"{name}/depthwise", "DepthwiseConv2dNative", [x, k], **_conv_attrs(cfg))
        rest = weights[1:]
        if cls == "SeparableConv2D":
            p = g.const(f"{name}/pointwise_kernel", rest[0])
            y = g.add(f"{name}/Conv2D", "Conv2D", [y, p], use_cudnn_on_gpu=_a_b(True),
                      **_conv_attrs({"padding": "valid"}))
            rest = rest[1:]
        if cfg.get("use_bias", True):
            y = _bias(g, name, y, rest[0])
        return _activation(g, name, cfg.get("activation"), y)
    if cls == "BatchNormalization":
        if cfg.get("axis", -1) not in (-1, 3, [3], [-1]):
            raise NotImplementedError(f"BatchNormalization over axis {cfg['axis']} ({name!r})")
        if not (cfg.get("scale", True) and cfg.get("center", True)):
            raise NotImplementedError(f"BatchNormalization without scale or center ({name!r})")
        gamma, beta, mean, var = weights
        ins = [g.const(f"{name}/{part}", v) for part, v in
               (("gamma", gamma), ("beta", beta), ("moving_mean", mean), ("moving_variance", var))]
        return g.add(f"{name}/FusedBatchNormV3", "FusedBatchNormV3", [x] + ins, U=_a_type(DT_FLOAT),
                     epsilon=_a_f(cfg.get("epsilon", 1e-3)), data_format=_a_s("NHWC"),
                     is_training=_a_b(False), exponential_avg_factor=_a_f(1.0), **_T)
    if cls == "Activation":
        return _activation(g, name, cfg["activation"], x)
    if cls == "ReLU":
        if cfg.get("negative_slope") or cfg.get("threshold"):
            raise NotImplementedError(f"ReLU with a slope or threshold ({name!r})")
        top = cfg.get("max_value")
        if top is None:
            return g.add(f"{name}/Relu", "Relu", [x], **_T)
        if float(top) == 6.0:
            return g.add(f"{name}/Relu6", "Relu6", [x], **_T)
        raise NotImplementedError(f"ReLU with max_value {top} ({name!r})")
    if cls == "MaxPooling2D":
        kh, kw = _pair(cfg.get("pool_size", 2))
        sh, sw = _pair(cfg.get("strides") or (kh, kw))
        return g.add(f"{name}/MaxPool", "MaxPool", [x], ksize=_a_ints([1, kh, kw, 1]), strides=_a_ints([1, sh, sw, 1]),
                     padding=_a_s(cfg.get("padding", "valid").upper()), data_format=_a_s("NHWC"), **_T)
    if cls == "Add":
        y = xs[0]
        for i, other in enumerate(xs[1:]):
            y = g.add(f"{name}/add" + (f"_{i}" if i else ""), "AddV2", [y, other], **_T)
        return y
    if cls == "GlobalAveragePooling2D":
        axes = g.const(f"{name}/Mean/reduction_indices", np.array([1, 2]))
        return g.add(f"{name}/Mean", "Mean", [x, axes], keep_dims=_a_b(bool(cfg.get("keepdims", False))),
                     Tidx=_a_type(DT_INT32), **_T)
    if cls == "Dense":
        k = g.const(f"{name}/kernel", weights[0])
        y = g.add(f"{name}/MatMul", "MatMul", [x, k], transpose_a=_a_b(False), transpose_b=_a_b(False), **_T)
        if cfg.get("use_bias", True):
            y = _bias(g, name, y, weights[1])
        return _activation(g, name, cfg.get("activation"), y)
    raise NotImplementedError(f"Keras layer class {cls!r} ({name!r}) in the GraphDef writer")


def _inbound(layer: dict) -> List[str]:
    nodes = layer.get("inbound_nodes") or []
    if len(nodes) != 1:
        raise NotImplementedError(f"layer {layer['name']!r} called {len(nodes)} times")
    args = nodes[0]["args"]
    arg = args[0] if len(args) == 1 else args
    tensors = arg if isinstance(arg, list) else [arg]
    return [t["config"]["keras_history"][0] for t in tensors]


def frozen_graph_def(model) -> Tuple[bytes, str, str]:
    """``model`` (``get_config()`` of a Functional model,
    ``get_layer(name).get_weights()``) -> ``(GraphDef bytes, input tensor
    name, output tensor name)``."""
    config = model.get_config()
    g = _Graph()
    out: Dict[str, str] = {}
    input_name = None
    for layer in config["layers"]:
        cls, cfg, name = layer["class_name"], layer["config"], layer.get("name") or layer["config"]["name"]
        if cls == "InputLayer":
            shape = [-1] + [int(d) for d in (cfg.get("batch_shape") or cfg["batch_input_shape"])[1:]]
            out[name] = input_name = g.add(name, "Placeholder", [], dtype=_a_type(DT_FLOAT), shape=_a_shape(shape))
            continue
        xs = [out[src] for src in _inbound(layer)]
        weights = [np.asarray(w, np.float32) for w in model.get_layer(name).get_weights()]
        out[name] = _layer(g, cls, cfg, name, xs, weights)
    last = config["output_layers"]
    last = last[0] if isinstance(last[0], list) else last
    g.add("Identity", "Identity", [out[last[0]]], **_T)
    return g.serialize(), f"{input_name}:0", "Identity:0"


__all__ = ["frozen_graph_def"]
