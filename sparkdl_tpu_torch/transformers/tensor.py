"""Tensor-column transformers: a model over a column of fixed-shape arrays.

Port of the JAX package's ``transformers/tensor.py``:
:class:`ModelTransformer` applies a
:class:`~sparkdl_tpu_torch.graph.function.ModelFunction`,
:class:`KerasTransformer` a Keras model (``modelFile`` or ``model=``,
translated into torch by ``graph/ingest.py``), and ``TFTransformer`` is
the upstream name of ``ModelTransformer``. Rows go through the batched
engine (``execution.run_batched_shared``); a None cell gives a null row.
An image-shaped column (rows ``(H, W, C)`` for a model that records that
input shape) is handed to the model as NCHW by its device fn.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.graph.ingest import ModelIngest
from sparkdl_tpu_torch.graph.pieces import build_flattener
from sparkdl_tpu_torch.params import (
    HasBatchSize,
    HasInputCol,
    HasModelFunction,
    HasOutputCol,
    Param,
    TypeConverters,
    keyword_only,
)
from sparkdl_tpu_torch.pipeline import Transformer
from sparkdl_tpu_torch.transformers.execution import (
    arrays_to_batch,
    model_device_fn,
    run_batched_shared,
)


class ModelTransformer(
    Transformer, HasInputCol, HasOutputCol, HasBatchSize, HasModelFunction
):
    """Applies a ModelFunction to a column of arrays (any fixed per-row
    shape). With ``flattenOutput`` (the default) each output row is a flat
    float32 vector."""

    _persist_ignore = ("_device_fn_cache",)

    inputDtype = Param(
        None,
        "inputDtype",
        "numpy dtype name for the stacked input batch",
        TypeConverters.toString,
    )
    flattenOutput = Param(
        None,
        "flattenOutput",
        "flatten model output to a per-row vector",
        TypeConverters.toBoolean,
    )

    @keyword_only
    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelFunction: Optional[ModelFunction] = None,
        batchSize: Optional[int] = None,
        inputDtype: Optional[str] = None,
        flattenOutput: Optional[bool] = None,
    ):
        super().__init__()
        self._setDefault(batchSize=64, inputDtype="float32", flattenOutput=True)
        self._set(**self._input_kwargs)

    def _device_fn(self):
        """The device fn per (model, flattenOutput), built once; the entry
        holds the ModelFunction so its id() cannot be recycled."""
        mf = self.getModelFunction() if self.isDefined("modelFunction") else None
        if mf is None:
            raise ValueError("modelFunction param must be set")
        flatten = self.getOrDefault("flattenOutput")
        key = (id(mf), flatten)
        cache = self.__dict__.setdefault("_device_fn_cache", {})
        if key not in cache or cache[key][0] is not mf:
            cache[key] = (mf, model_device_fn(mf.and_then(build_flattener()) if flatten else mf))
        return cache[key][1]

    def _transform(self, dataset: DataFrame) -> DataFrame:
        in_col, out_col = self.getInputCol(), self.getOutputCol()
        batch_size = self.getBatchSize()
        dtype = np.dtype(self.getOrDefault("inputDtype"))
        device_fn = self._device_fn()

        def run_partition(part):
            outputs = run_batched_shared(
                part[in_col],
                to_batch=lambda chunk: arrays_to_batch(chunk, dtype=dtype),
                device_fn=device_fn,
                batch_size=batch_size,
            )
            return {out_col: outputs}

        return dataset.withColumnPartition(
            out_col, run_partition, serial=device_fn.single_stream
        )


class KerasTransformer(ModelTransformer):
    """Applies a Keras model (a ``.keras``/``.h5`` file or an in-memory
    model) to an array column. The model is translated when the stage is
    built, on ``device`` (``cuda`` by default, raising when there is none;
    ``"cpu"`` for the CPU)."""

    modelFile = Param(
        None, "modelFile", "path to a saved Keras model", TypeConverters.toString
    )

    @keyword_only
    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelFile: Optional[str] = None,
        model=None,
        batchSize: Optional[int] = None,
        inputDtype: Optional[str] = None,
        flattenOutput: Optional[bool] = None,
        device=None,
    ):
        parent_kwargs = {
            k: v
            for k, v in self._input_kwargs.items()
            if k not in ("model", "modelFile", "device")
        }
        super().__init__(**parent_kwargs)
        if modelFile is not None:
            self._set(modelFile=modelFile)
            self._set(modelFunction=ModelIngest.from_keras_file(modelFile, device=device))
        elif model is not None:
            self._set(modelFunction=ModelIngest.from_keras(model, device=device))


#: the upstream name (sparkdl.TFTransformer)
TFTransformer = ModelTransformer
