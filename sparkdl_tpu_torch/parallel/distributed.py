"""The process group: one process per GPU, gang-started.

The port of the JAX package's ``parallel/distributed.py``, over
``torch.distributed``: :func:`initialize` joins the process group (NCCL
for CUDA, gloo for the CPU) at the address, world size and rank the
caller gives (nothing on the machine announces a cluster); a call with
none of them leaves the process alone, a single process of world size 1.
A failed rendezvous raises: no process-group failure falls back to a
single-process run. DataFrame partitions are pinned to processes
round-robin (:func:`partitions_for_host`).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Join the process group (idempotent). ``init_method`` is a URL such
    as ``tcp://localhost:<port>``; ``backend`` defaults to NCCL when
    ``device`` is a CUDA device and gloo otherwise. With no argument at
    all this is a no-op: one process, world size 1, no group."""
    if dist.is_initialized():
        return
    if init_method is None and world_size is None and rank is None:
        return
    if init_method is None or world_size is None or rank is None:
        raise ValueError(
            "initialize needs init_method, world_size and rank together "
            f"(got {init_method!r}, {world_size!r}, {rank!r})"
        )
    if backend is None:
        on_cuda = device is not None and torch.device(device).type == "cuda"
        backend = "nccl" if on_cuda else "gloo"
    kwargs = {}
    if backend == "nccl" and device is not None:
        d = torch.device(device)
        kwargs["device_id"] = d if d.index is not None else torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(world_size),
        rank=int(rank), **kwargs,
    )


def shutdown() -> None:
    """Leave the process group, if any (idempotent)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def partitions_for_host(
    num_partitions: int,
    host_index: Optional[int] = None,
    host_count: Optional[int] = None,
) -> List[int]:
    """Round-robin partition -> process pinning: process h owns partitions
    {i : i % num_processes == h} and reads only those."""
    h = host_index if host_index is not None else process_index()
    n = host_count if host_count is not None else process_count()
    return [i for i in range(num_partitions) if i % n == h]
