"""The data-parallel mesh over the process group, and batch padding.

The port of the part of the JAX package's ``parallel/mesh.py`` that data
parallelism uses. In the JAX package a mesh is a named grid of devices
and XLA inserts the collectives; here one process drives one GPU, so the
``dp`` axis is the process group (``torch.distributed``) and its size the
world size. Tensor, pipeline and expert axes are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """``axes`` (``{"dp": world size}``), this process's ``rank``, and the
    process group the collectives run on (None: one process, no group)."""

    axes: Dict[str, int]
    rank: int = 0
    group: Any = None

    @property
    def size(self) -> int:
        return int(np.prod(list(self.axes.values())))


def make_mesh(axes: Optional[Dict[str, int]] = None, group: Any = None) -> Mesh:
    """The ``dp`` mesh over the process group (the default group when one
    is initialized, else a single process). ``axes`` maps axis name ->
    size; ``-1`` means "every process"; the sizes must multiply to the
    world size, as the JAX package's must to the device count."""
    if dist.is_initialized():
        world = dist.get_world_size(group)
        rank = dist.get_rank(group)
        group = group if group is not None else dist.group.WORLD
    else:
        world, rank, group = 1, 0, None
    if axes is None:
        axes = {"dp": world}
    names = list(axes)
    if names != ["dp"]:
        raise NotImplementedError(
            f"mesh axes {names}: the port runs the 'dp' axis only; tensor, "
            "pipeline and expert parallelism are not ported yet"
        )
    size = int(axes["dp"])
    if size == -1:
        size = world
    if size != world:
        raise ValueError(f"Mesh axes {{'dp': {size}}} need {size} processes, have {world}")
    return Mesh({"dp": size}, rank=rank, group=group)


def pad_batch_to_multiple(
    arrays: Tuple[np.ndarray, ...], multiple: int
) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
    """Pad each array's dim 0 to a multiple of ``multiple``, returning
    (padded arrays, valid mask): static, evenly divisible shapes."""
    n = arrays[0].shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    pad = target - n
    mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    if pad == 0:
        return arrays, mask
    padded = tuple(
        np.concatenate([a, np.zeros((pad, *a.shape[1:]), dtype=a.dtype)], axis=0)
        for a in arrays
    )
    return padded, mask
