"""Carry BERT and image-model weights from the JAX package's flax trees
into PyTorch.

``bert_params_from_flax`` maps the ``{"params": ...}`` tree of the flax
``BertEncoder`` (numpy arrays, or anything ``np.asarray`` takes) onto the
``state_dict`` of :class:`~sparkdl_tpu_torch.models.bert.BertEncoder`:

================================  ===================================
flax                              port
================================  ===================================
``Dense.kernel [in, out]``        ``Linear.weight [out, in]`` (transposed)
``Dense.bias``                    ``Linear.bias``
``Embed.embedding``               ``Embedding.weight``
``LayerNorm.scale`` / ``bias``    ``LayerNorm.weight`` / ``bias``
``layer_{i}``                     ``layers.{i}`` (a ``ModuleList`` entry)
================================  ===================================

Module names are otherwise the same on both sides.

``cnn_params_from_flax`` maps the ``{"params", "batch_stats"}`` variables
of a flax image model (ResNet, InceptionV3, Xception, VGG, MobileNetV2)
onto the port module of the same family and geometry:

==================================  ===================================
flax                                port
==================================  ===================================
``Conv.kernel [kh, kw, in/g, out]`` ``Conv2d.weight [out, in/g, kh, kw]``
                                    (a depthwise ``[kh, kw, 1, C]``
                                    becomes ``[C, 1, kh, kw]``)
``Conv.bias`` (VGG)                 ``Conv2d.bias``
``Dense.kernel [in, out]``          ``Linear.weight [out, in]`` (transposed)
``BatchNorm.scale`` / ``bias``      ``BatchNorm.weight`` / ``bias``
                                    (InceptionV3 has no scale, and its
                                    port BatchNorm no weight)
``mean`` / ``var`` (batch_stats)    ``running_mean`` / ``running_var``
==================================  ===================================

VGG's ``fc1`` rows stay in the flax order: the port flattens block 5 in
NHWC order, as the flax module does. ``cnn_params_to_flax`` is the
inverse: a port module's weights as flax variables, which
``registry.save_flax_npz`` writes in the layout the JAX package's
``save_flax_weights`` uses.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from sparkdl_tpu_torch.models.bert import BertConfig, BertEncoder
from sparkdl_tpu_torch.models.layers import BatchNorm

_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight", "bias": "bias"}
_LAYER = re.compile(r"layer_(\d+)$")
_STATS = {"mean": "running_mean", "var": "running_var"}
_SCANNED = re.compile(r"stage\d+_rest$")


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if hasattr(tree, "items"):
        for key, sub in tree.items():
            yield from _leaves(sub, path + (str(key),))
    else:
        yield path, tree


def expected_keys(config: BertConfig) -> set:
    """The state_dict keys of a BertEncoder of this geometry."""
    with torch.device("meta"):
        return set(BertEncoder(config).state_dict())


def bert_params_from_flax(tree: Any, config: BertConfig) -> Dict[str, torch.Tensor]:
    """Map a flax BertEncoder param tree onto a port ``state_dict`` (f32
    CPU tensors). Raises if a flax leaf has no place in the port or a
    port parameter gets no flax leaf."""
    if "params" in tree:
        tree = tree["params"]
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree):
        *mods, name = path
        if name not in _LEAF:
            raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
        mods = [
            f"layers.{_LAYER.match(m).group(1)}" if _LAYER.match(m) else m
            for m in mods
        ]
        arr = np.asarray(leaf, dtype=np.float32)
        if name == "kernel":
            arr = arr.T
        state[".".join(mods + [_LEAF[name]])] = torch.tensor(arr)
    want = expected_keys(config)
    missing, extra = want - set(state), set(state) - want
    if missing or extra:
        raise ValueError(
            f"flax tree does not match the BERT geometry: missing "
            f"{sorted(missing)}, unexpected {sorted(extra)}"
        )
    return state


def cnn_params_from_flax(variables: Any, module: nn.Module) -> Dict[str, torch.Tensor]:
    """Map a flax image model's variables (``{"params": ...,
    "batch_stats": ...}``, numpy arrays or anything ``np.asarray`` takes)
    onto ``module``'s ``state_dict`` (f32 CPU tensors). Raises if a flax
    leaf has no place in the port or a port entry gets no flax leaf."""
    family = type(module).__name__
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(
            f"unexpected flax collections {sorted(unknown)}; a {family} has "
            "'params' and 'batch_stats'"
        )
    state: Dict[str, torch.Tensor] = {}
    for collection, leaf_names in (("params", _LEAF), ("batch_stats", _STATS)):
        for path, leaf in _leaves(variables.get(collection, {})):
            *mods, name = path
            if any(_SCANNED.match(m) for m in mods):
                raise ValueError(
                    f"flax leaf {'/'.join(path)} is in the scan_blocks layout "
                    "(identity blocks stacked under stage<i>_rest), which the "
                    "port does not take; save the weights of a ResNet built "
                    "with scan_blocks=False"
                )
            if name not in leaf_names:
                raise ValueError(f"unexpected flax leaf {collection}/{'/'.join(path)}")
            arr = np.asarray(leaf, dtype=np.float32)
            if name == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            state[".".join(mods + [leaf_names[name]])] = torch.tensor(
                np.ascontiguousarray(arr)
            )
    want = set(module.state_dict())
    missing, extra = want - set(state), set(state) - want
    if missing or extra:
        raise ValueError(
            f"flax variables do not match the {family} geometry: missing "
            f"{sorted(missing)}, unexpected {sorted(extra)}"
        )
    return state


def cnn_params_to_flax(module: nn.Module) -> Dict[str, Dict[str, Any]]:
    """``module``'s weights as flax variables (``{"params": ...,
    "batch_stats": ...}`` of f32 numpy arrays), the inverse of
    :func:`cnn_params_from_flax`."""
    variables: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for name, mod in module.named_modules():
        if isinstance(mod, nn.Conv2d):
            leaves = {"params": {"kernel": mod.weight.permute(2, 3, 1, 0), "bias": mod.bias}}
        elif isinstance(mod, nn.Linear):
            leaves = {"params": {"kernel": mod.weight.T, "bias": mod.bias}}
        elif isinstance(mod, BatchNorm):
            leaves = {
                "params": {"scale": mod.weight, "bias": mod.bias},
                "batch_stats": {"mean": mod.running_mean, "var": mod.running_var},
            }
        else:
            continue
        for collection, named in leaves.items():
            node = variables[collection]
            for part in name.split("."):
                node = node.setdefault(part, {})
            for leaf, t in named.items():
                if t is not None:
                    node[leaf] = np.ascontiguousarray(t.detach().float().cpu().numpy())
    return variables
