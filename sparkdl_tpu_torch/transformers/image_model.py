"""ImageModelTransformer: apply a ModelFunction to an image column.

Port of the JAX package's ``transformers/image_model.py``. The image
converter piece, the model and (for ``outputMode='vector'``) the
flattener compose into one ``ModelFunction`` on the model's device,
dispatched through its ``model_device_fn`` (on CUDA, on the device's launch
thread); the batched engine (``execution.run_batched_shared``: the shared
feeder when partitions run at once) feeds it uint8 NCHW batches that the
host stage decodes and resizes to the model's fixed geometry.

The JAX package's on-device resize arm (``SPARKDL_DEVICE_PREPROC``) is
not ported: the host always resizes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.graph.pieces import (
    build_flattener,
    build_image_converter,
    image_structs_to_batch,
)
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.params import (
    HasBatchSize,
    HasChannelOrder,
    HasInputCol,
    HasModelFunction,
    HasOutputCol,
    HasOutputMode,
    Param,
    TypeConverters,
    keyword_only,
)
from sparkdl_tpu_torch.pipeline import Transformer
from sparkdl_tpu_torch.transformers.execution import model_device_fn, run_batched_shared


class ImageModelTransformer(
    Transformer,
    HasInputCol,
    HasOutputCol,
    HasOutputMode,
    HasBatchSize,
    HasChannelOrder,
    HasModelFunction,
):
    """Applies a ModelFunction to an image-struct column.

    The model sees normalized RGB float batches of shape
    [batchSize, 3, targetHeight, targetWidth] (``channels_last`` memory
    format) in its ``input_dtype``; its output is flattened to a float32
    vector per row (outputMode='vector') or, for an image-to-image model
    whose rows come out as (C, H, W), re-wrapped as an image struct
    (outputMode='image').
    """

    targetHeight = Param(
        None, "targetHeight", "model input height", TypeConverters.toInt
    )
    targetWidth = Param(
        None, "targetWidth", "model input width", TypeConverters.toInt
    )
    preprocessing = Param(
        None,
        "preprocessing",
        "input normalization convention: tf | caffe | torch | none",
        TypeConverters.toChoice("tf", "caffe", "torch", "none"),
    )

    @keyword_only
    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelFunction: Optional[ModelFunction] = None,
        targetHeight: Optional[int] = None,
        targetWidth: Optional[int] = None,
        preprocessing: Optional[str] = None,
        channelOrder: Optional[str] = None,
        outputMode: Optional[str] = None,
        batchSize: Optional[int] = None,
    ):
        super().__init__()
        self._setDefault(
            outputMode="vector",
            batchSize=32,
            channelOrder="BGR",
            preprocessing="none",
        )
        self._set(**self._input_kwargs)

    def _build_device_fn(self):
        """converter ∘ model ∘ flattener as a device fn
        (``execution.model_device_fn``), built once per configuration.
        Keyed by the modelFunction's identity too, so setModelFunction or
        a ParamMap override never reuses a stale model; the entry holds
        the ModelFunction itself so its id() cannot be recycled.

        The composed function is the device stage, the counterpart of the
        JAX package's ``flat_device_fn`` without its flat 1-D buffer: that
        buffer carries a channel-major batch to the TPU, and channel-major
        is PyTorch's native NCHW, so the host packs NCHW (``chw=True``) and
        the device fn copies the batch to the device as it is. The same fn
        object serves every transform, so the shared feeder keeps one
        stream for it."""
        mf: ModelFunction = self.getModelFunction()
        if mf is None:
            raise ValueError("modelFunction param must be set")
        key = (
            id(mf),
            self.getOrDefault("preprocessing"),
            self.getChannelOrder(),
            self.getOutputMode(),
        )
        cache = self.__dict__.setdefault("_device_fn_cache", {})
        if key in cache and cache[key][0] is mf:
            return cache[key][1]
        converter = build_image_converter(
            channel_order_in=self.getChannelOrder(),
            preprocessing=self.getOrDefault("preprocessing"),
            out_dtype=mf.input_dtype or torch.float32,
        )
        pipeline_mf = converter.and_then(mf)
        if self.getOutputMode() == "vector":
            pipeline_mf = pipeline_mf.and_then(build_flattener())
        fn = model_device_fn(pipeline_mf)
        cache[key] = (mf, fn)
        return fn

    def _geometry(self):
        mf: ModelFunction = self.getModelFunction()
        if self.isDefined("targetHeight") and self.isDefined("targetWidth"):
            return self.getOrDefault("targetHeight"), self.getOrDefault(
                "targetWidth"
            )
        if mf is not None and mf.input_shape and len(mf.input_shape) == 3:
            return mf.input_shape[0], mf.input_shape[1]
        raise ValueError(
            "Set targetHeight/targetWidth or use a modelFunction with a "
            "recorded input_shape"
        )

    def _transform(self, dataset: DataFrame) -> DataFrame:
        in_col = self.getInputCol()
        out_col = self.getOutputCol()
        batch_size = self.getBatchSize()
        height, width = self._geometry()
        device_fn = self._build_device_fn()
        image_output = self.getOutputMode() == "image"

        def to_batch(chunk):
            return image_structs_to_batch(
                chunk, height=height, width=width, chw=True
            )

        def run_partition(part):
            outputs = run_batched_shared(
                part[in_col],
                to_batch=to_batch,
                device_fn=device_fn,
                batch_size=batch_size,
            )
            if image_output:
                outputs = [
                    imageIO.imageArrayToStruct(
                        np.clip(np.moveaxis(o, 0, -1), 0, 255)
                    )
                    if o is not None
                    else None
                    for o in outputs
                ]
            return {out_col: outputs}

        return dataset.withColumnPartition(out_col, run_partition)
