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
``registry.save_flax_weights`` writes in the layout the JAX package's
``save_flax_weights`` uses.

The flax ResNet's ``scan_blocks`` layout stacks each stage's identity
blocks on a leading axis under ``stage<i>_rest/block``
(``stage<i>_block<j>`` for j >= 2 is row j - 2). ``cnn_params_from_flax``
unstacks it into the port's unrolled blocks (eager torch gains nothing
from a scan), and ``cnn_params_to_flax(..., scan_blocks=True)`` stacks
them back.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from sparkdl_tpu_torch.models.bert import BertConfig, BertEncoder
from sparkdl_tpu_torch.models.layers import BatchNorm

_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight", "bias": "bias"}
_LAYER = re.compile(r"layer_(\d+)$")
_STATS = {"mean": "running_mean", "var": "running_var"}
_SCANNED = re.compile(r"(stage\d+)_rest$")
_BLOCK = re.compile(r"(stage\d+)_block(\d+)$")
#: the module names of a classification head, which a headless
#: (include_top=False) source lacks
HEAD_PARTS = ("head", "classifier", "fc1", "fc2")


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


def bert_params_to_flax(module: BertEncoder) -> Dict[str, Any]:
    """A port BertEncoder's weights as the flax ``{"params": ...}`` tree
    (f32 numpy arrays), the inverse of :func:`bert_params_from_flax`."""
    tree: Dict[str, Any] = {}
    for key, t in module.state_dict().items():
        *mods, name = key.split(".")
        owner = module.get_submodule(".".join(mods))
        if name not in ("weight", "bias"):
            raise ValueError(f"unexpected BertEncoder entry {key}")
        if isinstance(owner, nn.Linear):
            leaf = "kernel" if name == "weight" else "bias"
        elif isinstance(owner, nn.Embedding):
            leaf = "embedding"
        else:  # LayerNorm
            leaf = "scale" if name == "weight" else "bias"
        arr = t.detach().float().cpu().numpy()
        if leaf == "kernel":
            arr = arr.T
        path = []
        for i, m in enumerate(mods):
            if m == "layers":
                continue
            path.append(f"layer_{m}" if i and mods[i - 1] == "layers" else m)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": tree}


def unstack_blocks(tree: Any) -> Any:
    """A flax ResNet collection in the ``scan_blocks`` layout
    (``stage<i>_rest/block/...`` stacked on a leading axis) -> the
    unrolled layout (``stage<i>_block<j>`` for j = 2, 3, ...). Other
    entries are kept as they are."""
    out: Dict[str, Any] = {}
    for key, sub in tree.items():
        m = _SCANNED.match(str(key))
        if not m:
            out[key] = sub
            continue
        if set(sub) != {"block"}:
            raise ValueError(f"flax scan_blocks entry {key!r} holds {sorted(sub)}, not 'block'")
        stacked = list(_leaves(sub["block"]))
        count = {np.shape(leaf)[0] for _, leaf in stacked}
        if len(count) != 1:
            raise ValueError(f"flax scan_blocks entry {key!r}: leading axes {sorted(count)} differ")
        for j in range(count.pop()):
            block: Dict[str, Any] = {}
            for path, leaf in stacked:
                node = block
                for part in path[:-1]:
                    node = node.setdefault(part, {})
                node[path[-1]] = np.asarray(leaf)[j]
            out[f"{m.group(1)}_block{j + 2}"] = block
    return out


def stack_blocks(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`unstack_blocks`: each stage's blocks 2, 3,
    ... stacked under ``stage<i>_rest/block``."""
    out: Dict[str, Any] = {}
    stages: Dict[str, Dict[int, Any]] = {}
    for key, sub in tree.items():
        m = _BLOCK.match(str(key))
        if m and int(m.group(2)) >= 2:
            stages.setdefault(m.group(1), {})[int(m.group(2))] = sub
        else:
            out[key] = sub
    for stage, blocks in stages.items():
        if sorted(blocks) != list(range(2, len(blocks) + 2)):
            raise ValueError(f"{stage}: blocks {sorted(blocks)} are not 2, 3, ...")
        rows = [dict(_leaves(blocks[j])) for j in sorted(blocks)]
        stacked: Dict[str, Any] = {}
        for path in rows[0]:
            node = stacked
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = np.stack([r[path] for r in rows])
        out[f"{stage}_rest"] = {"block": stacked}
    return out


def cnn_params_from_flax(variables: Any, module: nn.Module,
                         allow_missing_head: bool = False) -> Dict[str, torch.Tensor]:
    """Map a flax image model's variables (``{"params": ...,
    "batch_stats": ...}``, numpy arrays or anything ``np.asarray`` takes;
    a ResNet's in either layout) onto ``module``'s ``state_dict`` (f32
    CPU tensors). Raises if a flax leaf has no place in the port or a
    port entry gets no flax leaf; with ``allow_missing_head``, the
    classification head (``HEAD_PARTS``) may be missing, and is then
    missing from the result."""
    family = type(module).__name__
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(
            f"unexpected flax collections {sorted(unknown)}; a {family} has "
            "'params' and 'batch_stats'"
        )
    state: Dict[str, torch.Tensor] = {}
    for collection, leaf_names in (("params", _LEAF), ("batch_stats", _STATS)):
        for path, leaf in _leaves(unstack_blocks(variables.get(collection, {}))):
            *mods, name = path
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
    if allow_missing_head:
        missing = {k for k in missing if k.split(".")[0] not in HEAD_PARTS}
    if missing or extra:
        raise ValueError(
            f"flax variables do not match the {family} geometry: missing "
            f"{sorted(missing)}, unexpected {sorted(extra)}"
        )
    return state


def _flax_view(module: nn.Module) -> Iterator[Tuple[str, List[str], str, torch.Tensor]]:
    """(collection, module path, flax leaf name, tensor in flax's layout)
    for every entry of ``module`` that a flax variable holds."""
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
            for leaf, t in named.items():
                if t is not None:
                    yield collection, name.split("."), leaf, t


def flax_leaf_shapes(module: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """``{"collection/module/path/leaf": shape}`` of the flax variables
    that :func:`cnn_params_from_flax` maps onto ``module`` (the unrolled
    layout; a module on ``meta`` will do)."""
    return {
        "/".join([collection, *parts, leaf]): tuple(t.shape)
        for collection, parts, leaf, t in _flax_view(module)
    }


def cnn_params_to_flax(module: nn.Module, scan_blocks: bool = False) -> Dict[str, Dict[str, Any]]:
    """``module``'s weights as flax variables (``{"params": ...,
    "batch_stats": ...}`` of f32 numpy arrays), the inverse of
    :func:`cnn_params_from_flax`; ``scan_blocks=True`` writes a
    ResNet's identity blocks stacked, as a flax ``ResNet(scan_blocks=True)``
    holds them."""
    variables: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for collection, parts, leaf, t in _flax_view(module):
        node = variables[collection]
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(t.detach().float().cpu().numpy())
    if scan_blocks:
        variables = {c: stack_blocks(tree) for c, tree in variables.items()}
    return variables
