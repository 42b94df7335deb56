"""Keras weights onto the registry's image models, and the ImageNet class
labels of keras' ``imagenet_class_index.json``.

Port of the JAX package's ``models/keras_weights.py``. Users hold their
weights as Keras files (``.keras``, legacy ``.h5``, ``.weights.h5``);
``load_keras_weights`` maps a ``keras.applications`` architecture's
weights onto the registry module of that family. The port never imports
keras: a model file is read by ``graph/keras_file.py`` (the port's own
HDF5 reader) into a :class:`~sparkdl_tpu_torch.graph.keras_graph.KerasModelSpec`,
and a weights-only file, which holds no config, is mapped through the
architecture's layer list (``models/keras_app_layers.py``, written from
keras.applications by ``tools/keras_app_layers.py``).

Each converter emits the flax variables the JAX converter emits, leaf for
leaf (``{"params": ..., "batch_stats": ...}`` of numpy arrays), and
``models/convert.cnn_params_from_flax`` carries them into the port's
module. Two exact folds, as in the JAX package:

- a Keras conv's bias feeds its BatchNorm; the module's convs have no
  bias, so the bias is folded into the BatchNorm's moving mean
  (BN(y + b) = BN'(y) with mean' = mean - b);
- a Keras DepthwiseConv2D kernel (H, W, C, 1) becomes the grouped conv's
  (H, W, 1, C).

InceptionV3's layers and Xception's four residual projections are
auto-numbered by Keras (``conv2d_7``), so they map by creation order: the
numeric suffix sorts them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
from torch import nn

from sparkdl_tpu_torch.models.convert import HEAD_PARTS, flax_leaf_shapes
from sparkdl_tpu_torch.models.keras_app_layers import KERAS_APP_LAYERS

_KERAS_SUFFIXES = (".h5", ".hdf5", ".keras", ".weights.h5")
#: InceptionV3's conv/BatchNorm pairs (the JAX package's NUM_CONV_BN)
INCEPTION_CONV_BN = 94


def is_keras_weights_file(path: str) -> bool:
    return path.endswith(_KERAS_SUFFIXES)


def _nested_set(tree: Dict[str, Any], path, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


class KerasLayers:
    """A Keras model's top-level layers by name: each one's class, config
    and weight arrays. Built from a model (a Keras model or a
    ``KerasModelSpec``: ``get_config`` and ``get_layer(name).get_weights()``)
    or, for a weights-only file, from an architecture's layer list."""

    def __init__(self, layers: Sequence[Tuple[str, str, dict]], weights: Callable[[str], List[np.ndarray]]):
        self.order = [name for _, name, _ in layers]
        self._class = {name: cls for cls, name, _ in layers}
        self._config = {name: cfg for _, name, cfg in layers}
        self._weights = weights

    @classmethod
    def from_model(cls, model) -> "KerasLayers":
        layers = [(l["class_name"], l["config"]["name"], l["config"]) for l in model.get_config()["layers"]]
        return cls(layers, lambda name: model.get_layer(name).get_weights())

    @classmethod
    def from_arrays(cls, arch: str, weights: Dict[str, List[np.ndarray]]) -> "KerasLayers":
        """The layers of ``KERAS_APP_LAYERS[arch]`` that ``weights`` holds."""
        layers = [(e[0], e[1], dict(e[2]) if len(e) > 2 else {})
                  for e in KERAS_APP_LAYERS[arch]["layers"] if e[1] in weights]
        return cls(layers, lambda name: weights[name])

    def has(self, name: str) -> bool:
        return name in self._class

    def config(self, name: str) -> dict:
        return self._config[name]

    def weights(self, name: str) -> List[np.ndarray]:
        if name not in self._class:
            raise ValueError(
                f"Keras model has no layer {name!r}: expected a stock "
                "keras.applications architecture"
            )
        return [np.asarray(w) for w in self._weights(name)]

    def of_class(self, class_name: str, prefix: str = "") -> List[str]:
        """The names of the layers of one class (and name prefix), in
        creation order: auto-numbered names sort by their suffix."""
        names = [n for n in self.order if self._class[n] == class_name and n.startswith(prefix)]

        def counter(name):
            suffix = name.rsplit("_", 1)[-1]
            return int(suffix) if suffix.isdigit() else 0

        return sorted(names, key=counter)


class _TreeBuilder:
    """Accumulates params/batch_stats as nested dicts."""

    def __init__(self, layers: KerasLayers):
        self.layers = layers
        self.params: Dict[str, Any] = {}
        self.stats: Dict[str, Any] = {}

    def conv(self, name: str, flax_path, depthwise: bool = False):
        """Map a conv layer; returns its bias (or None) for BN folding."""
        ws = self.layers.weights(name)
        kernel = ws[0]
        if depthwise:
            kernel = np.transpose(kernel, (0, 1, 3, 2))  # HWC1 -> HW1C
        _nested_set(self.params, (*flax_path, "kernel"), kernel)
        return ws[1] if len(ws) > 1 else None

    def bn(self, name: str, flax_path, fold_bias=None):
        ws = self.layers.weights(name)
        cfg = self.layers.config(name)
        # Keras BN omits gamma when scale=False (InceptionV3) and beta
        # when center=False
        gamma = ws.pop(0) if cfg.get("scale", True) else None
        beta = ws.pop(0) if cfg.get("center", True) else None
        mean, var = ws
        if fold_bias is not None:
            mean = mean - fold_bias
        if gamma is not None:
            _nested_set(self.params, (*flax_path, "scale"), gamma)
        if beta is not None:
            _nested_set(self.params, (*flax_path, "bias"), beta)
        _nested_set(self.stats, (*flax_path, "mean"), mean)
        _nested_set(self.stats, (*flax_path, "var"), var)

    def conv_bn(self, conv: str, bn: str, flax_conv, flax_bn, **kw):
        self.bn(bn, flax_bn, fold_bias=self.conv(conv, flax_conv, **kw))

    def dense(self, name: str, flax_path):
        kernel, bias = self.layers.weights(name)
        _nested_set(self.params, (*flax_path, "kernel"), kernel)
        _nested_set(self.params, (*flax_path, "bias"), bias)

    def variables(self) -> Dict[str, Any]:
        return {"params": self.params, "batch_stats": self.stats}


def resnet50_keras_to_flax(layers: KerasLayers) -> Dict[str, Any]:
    """keras.applications.ResNet50 -> the flax ResNet50's variables
    (without 'predictions', no head: mode='features' only)."""
    tb = _TreeBuilder(layers)
    tb.conv_bn("conv1_conv", "conv1_bn", ("conv_init",), ("bn_init",))
    for i, n_blocks in enumerate([3, 4, 6, 3]):
        ks = i + 2  # keras stages are conv2..conv5
        for j in range(1, n_blocks + 1):
            blk, kb = f"stage{i + 1}_block{j}", f"conv{ks}_block{j}"
            for c in (1, 2, 3):
                tb.conv_bn(f"{kb}_{c}_conv", f"{kb}_{c}_bn", (blk, f"conv{c}"), (blk, f"bn{c}"))
            if j == 1:  # projection shortcut
                tb.conv_bn(f"{kb}_0_conv", f"{kb}_0_bn", (blk, "conv_proj"), (blk, "bn_proj"))
    if layers.has("predictions"):
        tb.dense("predictions", ("head",))
    return tb.variables()


def mobilenetv2_keras_to_flax(layers: KerasLayers) -> Dict[str, Any]:
    """keras.applications.MobileNetV2 (width 1.0) -> the flax
    MobileNetV2's variables."""
    tb = _TreeBuilder(layers)
    tb.conv_bn("Conv1", "bn_Conv1", ("stem",), ("stem_bn",))
    # 17 inverted-residual blocks; Keras names the first 'expanded_conv'
    # (no expand conv) and the rest 'block_1'..'block_16'
    for idx in range(17):
        prefix, blk = ("expanded_conv" if idx == 0 else f"block_{idx}"), f"block_{idx}"
        if idx > 0:
            tb.conv_bn(f"{prefix}_expand", f"{prefix}_expand_BN", (blk, "expand"), (blk, "expand_bn"))
        tb.conv_bn(f"{prefix}_depthwise", f"{prefix}_depthwise_BN", (blk, "depthwise"), (blk, "depthwise_bn"),
                   depthwise=True)
        tb.conv_bn(f"{prefix}_project", f"{prefix}_project_BN", (blk, "project"), (blk, "project_bn"))
    tb.conv_bn("Conv_1", "Conv_1_bn", ("head",), ("head_bn",))
    if layers.has("predictions"):
        tb.dense("predictions", ("classifier",))
    return tb.variables()


def inceptionv3_keras_to_flax(layers: KerasLayers) -> Dict[str, Any]:
    """keras.applications.InceptionV3 -> the flax InceptionV3's
    variables. The builder auto-numbers its layers, so the k-th Conv2D
    (creation order) pairs with the k-th BatchNormalization and becomes
    ``conv_k``/``bn_k``."""
    tb = _TreeBuilder(layers)
    convs, bns = layers.of_class("Conv2D"), layers.of_class("BatchNormalization")
    if len(convs) != INCEPTION_CONV_BN or len(bns) != INCEPTION_CONV_BN:
        raise ValueError(
            "Expected a stock keras.applications InceptionV3 with "
            f"{INCEPTION_CONV_BN} conv/BN pairs; got {len(convs)} convs and "
            f"{len(bns)} batch-norms"
        )
    for i, (c, b) in enumerate(zip(convs, bns)):
        tb.conv_bn(c, b, (f"conv_{i}",), (f"bn_{i}",))
    if layers.has("predictions"):
        tb.dense("predictions", ("head",))
    return tb.variables()


def xception_keras_to_flax(layers: KerasLayers) -> Dict[str, Any]:
    """keras.applications.Xception -> the flax Xception's variables.
    Separable convs and the stem map by name; the four residual
    projections, the builder's only auto-numbered layers, by creation
    order onto res2/res3/res4/res13."""
    tb = _TreeBuilder(layers)
    res_convs = layers.of_class("Conv2D", prefix="conv2d")
    res_bns = layers.of_class("BatchNormalization", prefix="batch_normalization")
    if len(res_convs) != 4 or len(res_bns) != 4:
        raise ValueError(
            "Expected a stock keras.applications Xception with 4 unnamed "
            f"residual-projection conv/BN pairs; got {len(res_convs)} "
            f"convs and {len(res_bns)} batch-norms"
        )
    for stem in ("block1_conv1", "block1_conv2"):
        tb.conv_bn(stem, f"{stem}_bn", (stem,), (f"{stem}_bn",))
    for tag, c, b in zip(("res2", "res3", "res4", "res13"), res_convs, res_bns):
        tb.conv_bn(c, b, (f"{tag}_conv",), (f"{tag}_bn",))
    sep_blocks = (
        [(i, j) for i in (2, 3, 4) for j in (1, 2)]
        + [(i, j) for i in range(5, 13) for j in (1, 2, 3)]
        + [(13, 1), (13, 2), (14, 1), (14, 2)]
    )
    for i, j in sep_blocks:
        name = f"block{i}_sepconv{j}"
        # SeparableConv2D (no bias): depthwise (H, W, Cin, 1) -> (H, W,
        # 1, Cin), pointwise (1, 1, Cin, Cout) as it is
        dw, pw = layers.weights(name)
        _nested_set(tb.params, (f"{name}_dw", "kernel"), np.transpose(dw, (0, 1, 3, 2)))
        _nested_set(tb.params, (f"{name}_pw", "kernel"), pw)
        tb.bn(f"{name}_bn", (f"{name}_bn",))
    if layers.has("predictions"):
        tb.dense("predictions", ("head",))
    return tb.variables()


def _vgg_keras_to_flax(layers: KerasLayers, block_convs) -> Dict[str, Any]:
    """keras.applications VGG16/VGG19 -> the flax VGG's variables: biased
    convs map kernel and bias as they are, no BatchNorm."""
    tb = _TreeBuilder(layers)
    for b, n_convs in enumerate(block_convs, start=1):
        for j in range(1, n_convs + 1):
            name = f"block{b}_conv{j}"
            tb.dense(name, (name,))  # kernel + bias, as a Dense layer holds them
    if layers.has("fc1"):
        tb.dense("fc1", ("fc1",))
        tb.dense("fc2", ("fc2",))
    if layers.has("predictions"):
        tb.dense("predictions", ("head",))
    return tb.variables()


def vgg16_keras_to_flax(layers: KerasLayers) -> Dict[str, Any]:
    return _vgg_keras_to_flax(layers, (2, 2, 3, 3, 3))


def vgg19_keras_to_flax(layers: KerasLayers) -> Dict[str, Any]:
    return _vgg_keras_to_flax(layers, (2, 2, 4, 4, 4))


_CONVERTERS = {
    "resnet50": ("ResNet50", resnet50_keras_to_flax),
    "mobilenetv2": ("MobileNetV2", mobilenetv2_keras_to_flax),
    "inceptionv3": ("InceptionV3", inceptionv3_keras_to_flax),
    "xception": ("Xception", xception_keras_to_flax),
    "vgg16": ("VGG16", vgg16_keras_to_flax),
    "vgg19": ("VGG19", vgg19_keras_to_flax),
}


def _weights_only(arch: str, path: str) -> KerasLayers:
    """A weights-only file mapped through the architecture's layer list:
    with its top where the file holds it, else without (a headless
    source, as the JAX package's retry against ``include_top=False``)."""
    from sparkdl_tpu_torch.graph.keras_file import read_keras_weights

    entry = KERAS_APP_LAYERS[arch]
    full = [(e[0], e[1]) for e in entry["layers"]]
    errors = []
    for layers in (full, full[: len(full) - entry["head"]]):
        try:
            return KerasLayers.from_arrays(arch, read_keras_weights(path, layers))
        except ValueError as e:
            errors.append(str(e))
    raise ValueError(
        f"{path!r} holds neither a whole Keras model nor the weights of a "
        f"stock {arch} (with or without its top): {errors}"
    )


def _keras_layers(arch: str, path: str) -> KerasLayers:
    """A Keras file -> its layers: a whole model file through its config,
    a weights-only file through the architecture's layer list."""
    from sparkdl_tpu_torch.graph import hdf5
    from sparkdl_tpu_torch.graph.keras_file import read_keras_file

    if path.endswith(".weights.h5"):
        return _weights_only(arch, path)
    if path.endswith(".keras"):
        return KerasLayers.from_model(read_keras_file(path))
    with hdf5.File(path) as f:
        whole = "model_config" in f.attrs
    return KerasLayers.from_model(read_keras_file(path)) if whole else _weights_only(arch, path)


def check_against_module(variables: Dict[str, Any], module: nn.Module,
                         allow_missing_head: bool = True) -> None:
    """Leaf for leaf, the converted variables against ``module``'s
    entries and shapes (the JAX package's check against ``module.init``).
    A missing classification head (a headless source) is the one gap
    allowed, and only with ``allow_missing_head``."""
    want = flax_leaf_shapes(module)
    got = {}

    def visit(node, prefix):
        for key, sub in node.items():
            if hasattr(sub, "items"):
                visit(sub, prefix + (key,))
            else:
                got["/".join(prefix + (key,))] = tuple(np.shape(sub))

    for collection in ("params", "batch_stats"):
        visit(variables.get(collection, {}), (collection,))
    missing = sorted(set(want) - set(got))
    head_missing = [m for m in missing if any(p in m.split("/") for p in HEAD_PARTS)]
    if head_missing and not allow_missing_head:
        raise ValueError(
            "The keras weights have no classification head "
            f"(include_top=False source?): missing {head_missing[:4]}. "
            "Only mode='features' works with headless weights."
        )
    missing = [m for m in missing if m not in head_missing]
    extra = sorted(set(got) - set(want))
    bad_shape = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    if missing or extra or bad_shape:
        raise ValueError(
            "Converted keras weights do not match the architecture: "
            f"missing={missing[:5]} extra={extra[:5]} "
            f"shape_mismatch={[(k, got[k], want[k]) for k in bad_shape[:5]]}"
        )


def load_keras_weights(
    arch_name: str,
    path_or_model,
    module: Optional[nn.Module] = None,
    allow_missing_head: bool = True,
) -> Dict[str, Any]:
    """Keras weights (a file path, a ``KerasModelSpec`` or a Keras model)
    for the named architecture -> flax variables ``{"params": ...,
    "batch_stats": ...}`` of numpy arrays, the JAX package's tree.
    ``module``: a port module (``meta`` will do) to check the tree
    against."""
    key = arch_name.lower()
    if key not in _CONVERTERS:
        raise ValueError(
            f"No keras converter for {arch_name!r}; available: "
            f"{sorted(v[0] for v in _CONVERTERS.values())}"
        )
    arch, convert = _CONVERTERS[key]
    layers = (_keras_layers(arch, path_or_model) if isinstance(path_or_model, (str, os.PathLike))
              else KerasLayers.from_model(path_or_model))
    variables = convert(layers)
    if module is not None:
        check_against_module(variables, module, allow_missing_head=allow_missing_head)
    return variables


# -- ImageNet labels ----------------------------------------------------------


def imagenet_labels(class_index_json: Optional[str] = None) -> Dict[int, str]:
    """``{idx: label}`` from keras' ``imagenet_class_index.json``
    (``{"0": ["n01440764", "tench"], ...}``), read from ``class_index_json``
    or from ``$KERAS_HOME/models/`` (``~/.keras/models/`` without
    ``KERAS_HOME``). An explicit path that does not exist raises rather
    than fall back to the keras cache, which would label predictions from
    another file; so does a cache without the file."""
    if class_index_json:
        if not os.path.exists(class_index_json):
            raise FileNotFoundError(
                f"imagenet_class_index file not found: {class_index_json!r}"
            )
        path = class_index_json
    else:
        keras_home = os.environ.get(
            "KERAS_HOME", os.path.join(os.path.expanduser("~"), ".keras")
        )
        path = os.path.join(keras_home, "models", "imagenet_class_index.json")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"No imagenet_class_index.json found (searched: {[path]}). "
                "Pass its path explicitly: offline environments must ship "
                "the index file with their weights."
            )
    with open(path) as f:
        blob = json.load(f)
    return {int(k): v[1] for k, v in blob.items()}
