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

Training goes around ``__call__`` (which runs under ``inference_mode``):
:meth:`ModelFunction.named_params` gives float32 master copies of the
module's floating parameters AND buffers (the JAX package trains its
whole variable tree, BatchNorm statistics included),
:meth:`ModelFunction.apply` runs ``fn`` over a given set of them with
autograd on (``torch.func.functional_call``), each cast to the dtype the
module stores it in, and :meth:`ModelFunction.with_params` gives a new
function over a copy of the module that holds them.
:meth:`ModelFunction.from_module` is the counterpart of the JAX package's
``ModelIngest.from_flax``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

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
        takes_nhwc: ``fn`` takes image rows as NHWC itself (the JAX
            layout), so the device fn hands them over as they are.
        params: float32 master values of the module's floating tensors
            where they hold more than the module stores (a module built in
            bf16: :meth:`from_module`), else None (read from the module).
    """

    fn: Callable[[nn.Module, Any], torch.Tensor]
    module: nn.Module
    device: Optional[torch.device]
    name: str = "model_fn"
    vocab_size: Optional[int] = None
    input_shape: Optional[tuple] = None
    input_dtype: Optional[torch.dtype] = None
    precision: Optional[str] = None
    takes_nhwc: bool = False
    params: Optional[Dict[str, torch.Tensor]] = None

    def __call__(self, x):
        with torch.inference_mode():
            return self.fn(self.module, x)

    # -- training -----------------------------------------------------------

    def _floating(self) -> Dict[str, torch.Tensor]:
        named = list(self.module.named_parameters()) + list(self.module.named_buffers())
        return {n: t for n, t in named if t.is_floating_point()}

    def named_params(self) -> Dict[str, torch.Tensor]:
        """``{name: float32 tensor}`` over the module's floating parameters
        and buffers, detached copies on the module's device: the master
        values a trainer updates."""
        if self.params is not None:
            return {n: t.detach().clone() for n, t in self.params.items()}
        return {n: t.detach().float().clone() for n, t in self._floating().items()}

    def apply(self, params: Dict[str, torch.Tensor], x) -> torch.Tensor:
        """``fn`` over ``params`` in place of the module's own tensors, with
        autograd on: each is cast to the dtype the module stores it in
        (differentiably, so a bf16 conv weight's gradient comes back in
        float32, as flax promotes an f32 param at use)."""
        stored = self._floating()
        missing = set(stored) - set(params)
        if missing:
            raise KeyError(f"params lack {sorted(missing)[:4]}")
        view = {
            f"inner.{n}": params[n].to(t.dtype) if params[n].dtype != t.dtype else params[n]
            for n, t in stored.items()
        }
        wrapper = self.__dict__.get("_apply_wrapper")
        if wrapper is None:
            wrapper = self.__dict__["_apply_wrapper"] = _Apply(self.fn, self.module)
        return torch.func.functional_call(wrapper, view, (x,))

    def with_params(self, params: Dict[str, torch.Tensor]) -> "ModelFunction":
        """A new ModelFunction over a copy of the module that holds
        ``params`` (cast to its storage dtypes); ``params`` are kept as the
        new function's float32 master values."""
        module = copy.deepcopy(self.module)
        tensors = dict(module.named_parameters())
        tensors.update(module.named_buffers())
        with torch.no_grad():
            for n, v in params.items():
                tensors[n].copy_(v)
        return ModelFunction(
            self.fn, module, self.device, name=self.name,
            vocab_size=self.vocab_size, input_shape=self.input_shape,
            input_dtype=self.input_dtype, precision=self.precision,
            takes_nhwc=self.takes_nhwc,
            params={n: v.detach().clone() for n, v in params.items()},
        )

    @staticmethod
    def from_module(
        module: nn.Module,
        input_shape: Optional[tuple] = None,
        device=None,
        name: Optional[str] = None,
    ) -> "ModelFunction":
        """An ``nn.Module`` -> ModelFunction, the counterpart of the JAX
        package's ``ModelIngest.from_flax``. ``fn(module, x)`` is
        ``module(x)``, except for an image model of the registry
        (``models/layers.ImageCNN``) with a ``(height, width, channels)``
        ``input_shape``: its fn takes NHWC rows, as the flax module does,
        and permutes them (a view; on the card the module and its input are
        ``channels_last``), and its conv and dense weights are stored in
        its compute dtype (``cast_compute``) with their float32 values kept
        as the master copy. ``device``: ``cuda`` by default (raises when
        there is none); ``"cpu"`` for the CPU."""
        from sparkdl_tpu_torch.models.layers import ImageCNN
        from sparkdl_tpu_torch.runtime.device import resolve_device

        device = resolve_device(device)
        image = isinstance(module, ImageCNN) and input_shape is not None and len(input_shape) == 3
        fmt = torch.channels_last if image and device.type == "cuda" else torch.preserve_format
        module = module.to(device, memory_format=fmt).eval()
        master = None
        if image:
            master = {
                n: t.detach().float().clone()
                for n, t in list(module.named_parameters()) + list(module.named_buffers())
                if t.is_floating_point()
            }
            module.cast_compute()
            fn = lambda mod, x: mod(x.permute(0, 3, 1, 2))  # noqa: E731
        else:
            fn = lambda mod, x: mod(x)  # noqa: E731
        return ModelFunction(
            fn, module, device, name=name or type(module).__name__,
            input_shape=tuple(input_shape) if input_shape is not None else None,
            takes_nhwc=image, params=master,
        )

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
            takes_nhwc=self.takes_nhwc,
        )

    def before(self, pre: Union["ModelFunction", Callable]) -> "ModelFunction":
        """pre, then self."""
        pre_mf = pre if isinstance(pre, ModelFunction) else piece(
            pre, name=getattr(pre, "__name__", "fn")
        )
        return pre_mf.and_then(self)


class _Apply(nn.Module):
    """``fn(module, x)`` as a module's forward, so ``functional_call`` can
    swap the inner module's tensors."""

    def __init__(self, fn, inner: nn.Module):
        super().__init__()
        self.fn = fn
        self.inner = inner

    def forward(self, x):
        return self.fn(self.inner, x)


def piece(fn: Callable[[Any], Any], name: str = "piece") -> ModelFunction:
    """Wrap a parameter-free tensor function as a ModelFunction."""
    return ModelFunction(lambda _module, x: fn(x), nn.Module(), None, name=name)
