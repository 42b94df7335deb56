"""Keras model files read without keras: ``.keras`` archives and legacy
``.h5`` model files, into a :class:`~sparkdl_tpu_torch.graph.keras_graph.KerasModelSpec`.

- A ``.keras`` archive is a zip of ``config.json`` (the model's class and
  config), ``metadata.json`` and ``model.weights.h5``. The weights file
  keys each layer's variables by its object path
  (``layers/functional/layers/conv2d/vars/0``: class name and order of
  appearance, ``keras_graph.walk_layers``), not by the layer's name.
- A legacy ``.h5`` file holds the config in its ``model_config``
  attribute and the weights under ``model_weights/<top-level layer>/``,
  listed in order by each group's ``weight_names``. A nested model's group
  lists its trainable variables first and then the rest, each in layer
  order, as Keras's legacy writer does.

Both weight stores are HDF5, read by the port's own reader
(``graph/hdf5.py``, numpy only), so a model file is read where h5py is
not installed, as on the card's machine. A configuration the translator
does not cover fails when the model is built from the spec.

A weights-only file holds no config. :func:`read_keras_weights` maps one
onto an architecture's weighted layers, given them in order as
(Keras class, layer name) (``models/keras_app_layers.py`` lists
keras.applications'):

- a Keras 3 ``.weights.h5`` keys each layer by its object path (class
  name and order of appearance, ``layers/conv2d_1/vars/0``), not by its
  name;
- a legacy ``.h5`` weight file lists its layers in order (the
  ``layer_names`` attribute); Keras loads such a file by topology, the
  k-th layer holding weights into the model's k-th weighted layer, and
  so does the port.
"""

from __future__ import annotations

import json
import zipfile
from typing import Dict, List, Sequence, Tuple

import numpy as np

from sparkdl_tpu_torch.graph import hdf5
from sparkdl_tpu_torch.graph.keras_graph import (
    MODEL_CLASSES,
    ROADMAP_ITEM,
    KerasModelSpec,
    walk_layers,
    weight_groups,
)

ARCHIVE_CONFIG = "config.json"
ARCHIVE_WEIGHTS = "model.weights.h5"


def _model_config(blob: dict, path: str) -> dict:
    if blob.get("class_name") not in MODEL_CLASSES:
        raise NotImplementedError(
            f"{path}: a Keras {blob.get('class_name')!r} model is not "
            f"translated to torch ({ROADMAP_ITEM})"
        )
    return blob["config"]


def read_keras_file(path: str) -> KerasModelSpec:
    """A ``.keras`` archive or a legacy ``.h5``/``.hdf5`` model file ->
    its config and weights."""
    if zipfile.is_zipfile(path):
        return _read_archive(path)
    return _read_legacy_h5(path)


def _read_archive(path: str) -> KerasModelSpec:
    with zipfile.ZipFile(path) as z:
        config = _model_config(json.loads(z.read(ARCHIVE_CONFIG)), path)
        raw = z.read(ARCHIVE_WEIGHTS)
    weights: Dict[str, List[np.ndarray]] = {}
    with hdf5.File(raw) as f:
        for layer_path, obj_path, layer, _ in walk_layers(config):
            weights[layer_path] = _archive_arrays(f, path, layer_path, obj_path, layer["class_name"])
    return KerasModelSpec(config, weights)


def _archive_arrays(f, path: str, layer_path: str, obj_path: str, class_name: str) -> List[np.ndarray]:
    """A layer's variables in a Keras 3 weights store, from each of its
    groups (``keras_graph.weight_groups``) in turn."""
    arrays = []
    for sub in weight_groups(class_name):
        group = f.get(f"{obj_path}/{sub}vars")
        if group is None:
            raise ValueError(f"{path}: no weights for layer {layer_path!r} at {obj_path}/{sub}vars")
        arrays += [np.asarray(group[str(i)]) for i in range(len(group))]
    return arrays


def _var_trainable(layer: dict) -> List[bool]:
    """Which of a weighted layer's variables Keras marks trainable, in
    the order ``get_weights`` gives them."""
    cfg = layer.get("config") or {}
    if layer["class_name"] == "BatchNormalization":
        return [True] * (cfg.get("scale", True) + cfg.get("center", True)) + [False, False]
    if layer["class_name"] == "LayerNormalization":
        return [True] * (cfg.get("scale", True) + cfg.get("center", True))
    if layer["class_name"] == "LayerScale":
        return [True]
    if layer["class_name"] == "Normalization":  # mean, variance, count
        return [False] * 3
    if layer["class_name"] == "Bidirectional":
        return [t for key in ("layer", "backward_layer") for t in _var_trainable(cfg.get(key) or cfg["layer"])]
    if layer["class_name"] == "MultiHeadAttention":
        return [True] * (8 if cfg.get("use_bias", True) else 4)
    if layer["class_name"] == "Embedding":
        return [True]
    kernels = {"SeparableConv2D": 2, "SimpleRNN": 2, "LSTM": 2, "GRU": 2}.get(layer["class_name"], 1)
    return [True] * (kernels + cfg.get("use_bias", True))


def _read_legacy_h5(path: str) -> KerasModelSpec:
    weights: Dict[str, List[np.ndarray]] = {}
    with hdf5.File(path) as f:
        raw = f.attrs.get("model_config")
        if raw is None:
            raise ValueError(f"{path}: no model_config (a weights-only file?)")
        config = _model_config(json.loads(raw.decode() if isinstance(raw, bytes) else raw), path)
        store = f["model_weights"] if "model_weights" in f else f
        for layer in config.get("layers") or []:
            name = layer["config"]["name"]
            if name not in store:
                continue
            group = store[name]
            arrays = _legacy_arrays(group)
            if layer["class_name"] in MODEL_CLASSES:
                slots = _legacy_slots(layer["config"], name)
            else:
                slots = [(name, i) for i in range(len(arrays))]
            if len(slots) != len(arrays):
                raise ValueError(
                    f"{path}: layer {name!r} stores {len(arrays)} arrays, its config needs {len(slots)}"
                )
            for (leaf, _), a in zip(slots, arrays):
                weights.setdefault(leaf, []).append(a)
    return KerasModelSpec(config, weights)


def _legacy_slots(config: dict, name: str) -> list:
    """(leaf path, variable index) in the order a nested model's legacy
    group stores them: its trainable variables, then the others."""
    trainable, frozen = [], []
    for leaf, _, layer, on in walk_layers(config, prefix=name + "/", trainable=config.get("trainable", True)):
        for i, t in enumerate(_var_trainable(layer)):
            (trainable if t and on else frozen).append((leaf, i))
    return trainable + frozen


def _str(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


def _legacy_attribute(group, name: str) -> list:
    """A legacy list attribute, which Keras splits into ``name0``,
    ``name1``, ... when it outgrows an object header."""
    if name in group.attrs:
        return [_str(v) for v in group.attrs[name]]
    out, i = [], 0
    while f"{name}{i}" in group.attrs:
        out += [_str(v) for v in group.attrs[f"{name}{i}"]]
        i += 1
    return out


def _legacy_arrays(group) -> List[np.ndarray]:
    return [np.asarray(group[n]) for n in _legacy_attribute(group, "weight_names")]


def read_keras_weights(path: str, layers: Sequence[Tuple[str, str]]) -> Dict[str, List[np.ndarray]]:
    """A weights-only file (Keras 3 ``.weights.h5`` or legacy ``.h5``)
    -> ``{layer name: weight arrays}`` for ``layers``, the model's
    weighted layers in order as (Keras class, layer name). Raises
    ValueError when the file's layers do not fit ``layers``."""
    with hdf5.File(path) as f:
        if "layer_names" in f.attrs or "layer_names0" in f.attrs:
            stored = [n for n in _legacy_attribute(f, "layer_names") if _legacy_attribute(f[n], "weight_names")]
            if len(stored) != len(layers):
                raise ValueError(
                    f"{path}: {len(stored)} layers hold weights, the architecture has {len(layers)}"
                )
            return {name: _legacy_arrays(f[s]) for (_, name), s in zip(layers, stored)}
        config = {"input_layers": [], "layers": [
            {"class_name": cls, "config": {"name": name}} for cls, name in layers]}
        return {name: _archive_arrays(f, path, name, obj_path, layer["class_name"])
                for name, obj_path, layer, _ in walk_layers(config)}
