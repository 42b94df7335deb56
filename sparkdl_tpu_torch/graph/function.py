"""``ModelFunction``: the unit a transformer applies to each batch.

The PyTorch counterpart of the JAX package's ``ModelFunction`` (a pure
``fn(params, x)`` with its param pytree). Here it is ``fn(module, x)``
with an ``nn.Module`` that already lives on ``device``; calls run under
``torch.inference_mode``. There is no jit and no export: PyTorch runs
eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch import nn


@dataclass
class ModelFunction:
    """A model with its parameters and its device.

    Attributes:
        fn: ``fn(module, x) -> y`` over batches already on ``device``.
        module: the ``nn.Module`` holding the parameters.
        device: where the module lives and batches must be sent.
        name: diagnostic name.
        vocab_size: token-id bound for text models (tokenizers hash into
            ``[0, vocab_size)``), else None.
    """

    fn: Callable[[nn.Module, Any], torch.Tensor]
    module: nn.Module
    device: torch.device
    name: str = "model_fn"
    vocab_size: Optional[int] = None

    def __call__(self, x):
        with torch.inference_mode():
            return self.fn(self.module, x)
