"""Carry BERT weights from the JAX package's flax param tree into PyTorch.

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
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.models.bert import BertConfig, BertEncoder

_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight", "bias": "bias"}
_LAYER = re.compile(r"layer_(\d+)$")


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
