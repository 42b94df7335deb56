"""ModelIngest: model sources -> :class:`~sparkdl_tpu_torch.graph.function.ModelFunction`.

The counterpart of the JAX package's ``graph/ingest.py``, for the sources
the port reads so far: a Python callable, a Keras model and a Keras model
file. The JAX package runs a Keras model through keras on its jax
backend; the port reads the model's config and weights and translates the
model into torch (``graph/keras_graph.py``), so it never imports keras.
A Keras model here is anything with ``get_config()``,
``get_layer(name).get_weights()``, ``name`` and ``input_shape``: a Keras
model object, or a :class:`~sparkdl_tpu_torch.graph.keras_graph.KerasModelSpec`
(a config and weights held as data, as ``from_keras_file`` reads them).

Every constructor puts the model on ``device``: ``cuda`` by default
(raising when there is none), ``"cpu"`` for the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.runtime.device import resolve_device


class ModelIngest:
    """Namespace of ingestion constructors (all static)."""

    @staticmethod
    def from_callable(
        fn: Callable,
        module: Optional[nn.Module] = None,
        input_shape: Optional[Tuple[int, ...]] = None,
        input_dtype: Optional[torch.dtype] = None,
        name: str = "callable",
        device=None,
    ) -> ModelFunction:
        """``fn(module, x)`` over ``module`` (moved to ``device``), or
        ``fn(x)`` when there is no module (the JAX package's ``fn(params,
        x)`` or ``fn(x)``)."""
        device = resolve_device(device)
        if module is None:
            module, wrapped = nn.Module(), (lambda _module, x: fn(x))
        else:
            module, wrapped = module.to(device).eval(), fn
        return ModelFunction(
            wrapped, module, device, name=name,
            input_shape=tuple(input_shape) if input_shape is not None else None,
            input_dtype=input_dtype,
        )

    @staticmethod
    def from_keras(model, input_shape=None, input_dtype=None, device=None) -> ModelFunction:
        """A Keras model -> ModelFunction over its torch translation, at
        inference (BatchNorm uses its moving statistics, Dropout is the
        identity), as the JAX package's ``stateless_call(...,
        training=False)``. ``input_shape`` defaults to the model's own
        (``(H, W, C)`` for an image model, whose fn then takes NCHW
        batches, as the registry's image models do)."""
        from sparkdl_tpu_torch.graph.keras_graph import KerasModule

        config = model.get_config()
        if input_shape is None:
            shape = getattr(model, "input_shape", None)
            input_shape = tuple(shape[1:]) if shape else None
        device = resolve_device(device)
        image = input_shape is not None and len(input_shape) == 3
        fmt = torch.channels_last if image and device.type == "cuda" else torch.preserve_format
        module = KerasModule(config, model).to(device, memory_format=fmt).eval()
        return ModelFunction(
            lambda mod, x: mod(x), module, device,
            name=getattr(model, "name", None) or "keras_model",
            input_shape=tuple(input_shape) if input_shape is not None else None,
            input_dtype=input_dtype,
        )

    @staticmethod
    def from_keras_file(path: str, device=None, **kwargs) -> ModelFunction:
        """A ``.keras`` or ``.h5`` model file -> ModelFunction
        (``graph/keras_file.py`` reads it; its weights need h5py)."""
        from sparkdl_tpu_torch.graph.keras_file import read_keras_file

        return ModelIngest.from_keras(read_keras_file(path), device=device, **kwargs)
