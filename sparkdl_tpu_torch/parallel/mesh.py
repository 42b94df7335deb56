"""The mesh over the process group, and batch padding.

The port of the JAX package's ``parallel/mesh.py``. In the JAX package a
mesh is a named grid of devices and XLA inserts the collectives; here one
process drives one GPU, so a mesh is a named grid of the processes of a
``torch.distributed`` group. Its axes take any names, as the JAX
package's do; the port's parallel code reads ``dp`` (data parallelism,
``parallel/data_parallel.py``), ``sp`` (sequence parallelism,
``ops/ring_attention.py`` and ``ops/ulysses.py``), ``tp`` (tensor,
``parallel/tensor_parallel.py``), ``pp`` (pipeline,
``parallel/pipeline_parallel.py``) and ``ep`` (expert,
``parallel/expert_parallel.py``), each under the name its caller passes.
Ranks sit in the JAX package's major-to-minor order: under ``{"dp": a,
"tp": b}`` rank ``r`` sits at ``dp = r // b``, ``tp = r % b``. Each axis
of more than one process and fewer than all has its own subgroup
(``dist.new_group``); ``parallel/collectives.py`` runs the differentiable
collectives over them.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch.distributed as dist

@dataclass(frozen=True)
class Mesh:
    """``axes`` (name -> size, major to minor), this process's ``rank`` in
    ``group``, the process group of the whole mesh (None: one process, no
    group), and each axis's group (``axis_groups``; None for an axis of
    one process)."""

    axes: Dict[str, int]
    rank: int = 0
    group: Any = None
    axis_groups: Dict[str, Any] = field(default_factory=dict)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.axes.values())))

    def _check_axis(self, name: str) -> None:
        if name not in self.axes:
            raise ValueError(f"mesh has no axis {name!r}; its axes are {list(self.axes)}")

    def axis_size(self, name: str) -> int:
        self._check_axis(name)
        return int(self.axes[name])

    def axis_index(self, name: str) -> int:
        """This process's coordinate along ``name`` (``jax.lax.axis_index``)."""
        self._check_axis(name)
        return _coords(self.rank, list(self.axes.values()))[list(self.axes).index(name)]

    def axis_group(self, name: str) -> Any:
        """The process group of this process's fiber along ``name``: the
        processes that differ from it in that coordinate only. None for an
        axis of one process."""
        self._check_axis(name)
        return self.axis_groups.get(name)


def _coords(rank: int, sizes: List[int]) -> Tuple[int, ...]:
    """Major-to-minor coordinates of ``rank`` in a grid of ``sizes``."""
    return tuple(int(c) for c in np.unravel_index(rank, sizes)) if sizes else ()


def _axis_groups(names: List[str], sizes: List[int], rank: int, group: Any) -> Dict[str, Any]:
    """One subgroup per fiber of each axis of more than one process and
    fewer than all. ``dist.new_group`` is collective: every process makes
    every group, in the same order, and keeps the one it belongs to."""
    world = int(np.prod(sizes))
    members = dist.get_process_group_ranks(group)  # group rank -> global rank
    out: Dict[str, Any] = {}
    for a, name in enumerate(names):
        if sizes[a] == 1:
            continue
        if sizes[a] == world:
            out[name] = group
            continue
        others = [range(s) for i, s in enumerate(sizes) if i != a]
        for rest in itertools.product(*others):
            ranks = []
            for k in range(sizes[a]):
                coord = list(rest)
                coord.insert(a, k)
                ranks.append(members[int(np.ravel_multi_index(coord, sizes))])
            sub = dist.new_group(ranks)
            if members[rank] in ranks:
                out[name] = sub
    return out


def make_mesh(axes: Optional[Dict[str, int]] = None, group: Any = None) -> Mesh:
    """The mesh over the process group (the default group when one is
    initialized, else a single process). ``axes`` maps axis names to their
    sizes, major to minor (default: every process on ``dp``); ``-1`` for at
    most one axis means "the remaining processes"; the sizes must multiply
    to the world size, as the JAX package's must to the device count. On
    one process, with no group, axes of size 1 make a valid mesh."""
    if dist.is_initialized():
        world = dist.get_world_size(group)
        rank = dist.get_rank(group)
        group = group if group is not None else dist.group.WORLD
    else:
        world, rank, group = 1, 0, None
    if axes is None:
        axes = {"dp": world}
    names = list(axes)
    sizes = [int(axes[n]) for n in names]
    if sizes.count(-1) > 1:
        raise ValueError("At most one axis may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1])) or 1
        if world % known:
            raise ValueError(f"Cannot infer -1 axis: {world} processes not divisible by {known}")
        sizes[sizes.index(-1)] = world // known
    if any(s < 1 for s in sizes) or int(np.prod(sizes)) != world:
        raise ValueError(
            f"Mesh axes {dict(zip(names, sizes))} need {int(np.prod(sizes))} processes, have {world}"
        )
    groups = _axis_groups(names, sizes, rank, group) if group is not None else {}
    return Mesh(dict(zip(names, sizes)), rank=rank, group=group, axis_groups=groups)


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
