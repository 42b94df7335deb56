"""Device selection and float32 precision for the port's entry points."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Union

import torch

DeviceLike = Union[str, torch.device, None]


@contextmanager
def exact_float32() -> Iterator[None]:
    """Run float32 convolutions and matmuls in float32, not TF32.

    PyTorch lets cuDNN convolutions round float32 inputs to TF32 by default
    (``torch.backends.cudnn.allow_tf32``); a model that promises float32
    results turns both TF32 switches off around its own forward and puts
    back what the caller had. The switches are process-wide, so another
    thread's float32 work inside this window also runs without TF32.
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    With the default and no CUDA device this raises instead of falling
    back to the CPU; a caller that wants the CPU says ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
