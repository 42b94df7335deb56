"""``ModelFunction``: the unit a transformer applies to each batch.

The PyTorch counterpart of the JAX package's ``ModelFunction`` (a pure
``fn(params, x)`` with its param pytree). Here it is ``fn(module, x)``
with an ``nn.Module`` that already lives on ``device``; calls run under
``torch.inference_mode``. There is no jit and no export: PyTorch runs
eagerly.

Functions compose (``and_then``/``before``, as in the JAX package's
``graph/function.py``): the composed function holds the modules of its
parts in one ``nn.ModuleList``, all on one device. A :func:`piece` is a
parameter-free function with an empty module and no device of its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Union

import torch
from torch import nn


@dataclass
class ModelFunction:
    """A model with its parameters and its device.

    Attributes:
        fn: ``fn(module, x) -> y`` over batches already on ``device``.
        module: the ``nn.Module`` holding the parameters.
        device: where the module lives and batches must be sent; None for
            a parameter-free piece, which runs wherever its input is.
        name: diagnostic name.
        vocab_size: token-id bound for text models (tokenizers hash into
            ``[0, vocab_size)``), else None.
        input_shape: per-row input geometry the model was built for
            (``(height, width, channels)`` for image models), else None.
        input_dtype: dtype the model takes its input in (image models: the
            compute dtype, so the converter casts once), else None.
        precision: the serving precision rung the function was built at
            (``graph/precision.py``), or None for a plain build.
    """

    fn: Callable[[nn.Module, Any], torch.Tensor]
    module: nn.Module
    device: Optional[torch.device]
    name: str = "model_fn"
    vocab_size: Optional[int] = None
    input_shape: Optional[tuple] = None
    input_dtype: Optional[torch.dtype] = None
    precision: Optional[str] = None

    def __call__(self, x):
        with torch.inference_mode():
            return self.fn(self.module, x)

    def and_then(self, g: Union["ModelFunction", Callable]) -> "ModelFunction":
        """self, then g: the output of self feeds g."""
        g_mf = g if isinstance(g, ModelFunction) else piece(
            g, name=getattr(g, "__name__", "fn")
        )
        if None not in (self.device, g_mf.device) and torch.device(
            self.device
        ) != torch.device(g_mf.device):
            raise ValueError(
                f"cannot compose {self.name!r} on {self.device} with "
                f"{g_mf.name!r} on {g_mf.device}: parts must share a device"
            )
        f_fn, g_fn = self.fn, g_mf.fn

        def composed(mods, x):
            return g_fn(mods[1], f_fn(mods[0], x))

        return ModelFunction(
            fn=composed,
            module=nn.ModuleList([self.module, g_mf.module]),
            device=self.device if self.device is not None else g_mf.device,
            name=f"{self.name}>>{g_mf.name}",
            vocab_size=self.vocab_size,
            input_shape=self.input_shape,
            input_dtype=self.input_dtype,
        )

    def before(self, pre: Union["ModelFunction", Callable]) -> "ModelFunction":
        """pre, then self."""
        pre_mf = pre if isinstance(pre, ModelFunction) else piece(
            pre, name=getattr(pre, "__name__", "fn")
        )
        return pre_mf.and_then(self)


def piece(fn: Callable[[Any], Any], name: str = "piece") -> ModelFunction:
    """Wrap a parameter-free tensor function as a ModelFunction."""
    return ModelFunction(lambda _module, x: fn(x), nn.Module(), None, name=name)
