"""ImageModelTransformer: apply a ModelFunction to an image column.

Port of the JAX package's ``transformers/image_model.py``. The image
converter piece, the model and (for ``outputMode='vector'``) the
flattener compose into one ``ModelFunction`` on the model's device,
dispatched through its ``model_device_fn`` (on CUDA, on the device's launch
thread); the batched engine (``execution.run_batched_shared``: the shared
feeder when partitions run at once) feeds it uint8 NCHW batches that the
host stage decodes and resizes to the model's fixed geometry. A model
function that takes NHWC rows itself (``takes_nhwc``: a translated TF
graph) gets the converter's batch as an NHWC view. ``TFImageTransformer``
is the upstream name of this class.

With ``SPARKDL_DEVICE_PREPROC`` on (read at each transform), the host
ships each partition's uint8 rows at the partition's source geometry
(its first decodable image's; rows of another size are host-resized to
it first) and the resize to the model's geometry runs on the device
(``graph/pieces.build_device_preproc``, ``jax.image.resize``'s bilinear),
so the H2D bytes scale with the source. The device fn is built once per
source geometry, under a lock, since partitions build it from their own
threads and the shared feeder keys its streams by the fn. At identity
geometry the resize is skipped and the arm is bit-identical to the host
path.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.graph.pieces import (
    build_device_preproc,
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
from sparkdl_tpu_torch.transformers.execution import (
    device_preproc_enabled,
    model_device_fn,
    run_batched_shared,
)


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

    @keyword_only
    def setParams(self, **kwargs):
        """Set any of the constructor's params by keyword."""
        return self._set(**self._input_kwargs)

    def _build_device_fn(self, src_hw: Optional[Tuple[int, int]] = None):
        """converter ∘ model ∘ flattener as a device fn
        (``execution.model_device_fn``), built once per configuration.
        Keyed by the modelFunction's identity too, so setModelFunction or
        a ParamMap override never reuses a stale model; the entry holds
        the ModelFunction itself so its id() cannot be recycled.
        ``src_hw`` (the device-preproc arm): the source geometry the host
        ships; a device resize to the model's geometry goes in front of
        the converter.

        The composed function is the device stage, the counterpart of the
        JAX package's ``flat_device_fn`` without its flat 1-D buffer: that
        buffer carries a channel-major batch to the TPU, and channel-major
        is PyTorch's native NCHW, so the host packs NCHW (``chw=True``) and
        the device fn copies the batch to the device as it is. The same fn
        object serves every transform, so the shared feeder keeps one
        stream for it; the build runs under a lock, because the
        device-preproc arm builds from the partitions' threads."""
        mf: ModelFunction = self.getModelFunction()
        if mf is None:
            raise ValueError("modelFunction param must be set")
        key = (
            id(mf),
            self.getOrDefault("preprocessing"),
            self.getChannelOrder(),
            self.getOutputMode(),
            None if src_hw is None else tuple(src_hw),
        )
        cache = self.__dict__.setdefault("_device_fn_cache", {})
        lock = self.__dict__.setdefault("_device_fn_lock", threading.Lock())
        with lock:
            if key in cache and cache[key][0] is mf:
                return cache[key][1]
            converter = build_image_converter(
                channel_order_in=self.getChannelOrder(),
                preprocessing=self.getOrDefault("preprocessing"),
                out_dtype=mf.input_dtype or torch.float32,
            )
            if mf.takes_nhwc:
                # a function that takes NHWC rows itself (a translated TF
                # graph): the converter's NCHW batch in channels_last
                # memory is that as a view
                converter = converter.and_then(lambda x: x.permute(0, 2, 3, 1))
            pipeline_mf = converter.and_then(mf)
            if src_hw is not None:
                pipeline_mf = build_device_preproc(src_hw, self._geometry()).and_then(pipeline_mf)
            if self.getOutputMode() == "vector":
                pipeline_mf = pipeline_mf.and_then(build_flattener())
            fn = model_device_fn(pipeline_mf)
            cache[key] = (mf, fn)
            return fn

    @staticmethod
    def _source_geometry(cells) -> Optional[Tuple[int, int]]:
        """The first decodable struct's (height, width): the partition's
        source geometry in the device-preproc arm. None when nothing
        decodes (the geometry does not matter then)."""
        for s in cells:
            if s is None:
                continue
            try:
                arr = imageIO.imageStructToArray(s)
            except (ValueError, KeyError, TypeError):
                continue
            return int(arr.shape[0]), int(arr.shape[1])
        return None

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
        on_device = device_preproc_enabled()
        host_fn = None if on_device else self._build_device_fn()
        image_output = self.getOutputMode() == "image"

        def run_partition(part):
            cells = part[in_col]
            if on_device:
                src = self._source_geometry(cells) or (height, width)
                fn = self._build_device_fn(src)
            else:
                src, fn = (height, width), host_fn
            outputs = run_batched_shared(
                cells,
                to_batch=lambda chunk: image_structs_to_batch(chunk, height=src[0], width=src[1], chw=True),
                device_fn=fn,
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


#: the upstream name (sparkdl.TFImageTransformer)
TFImageTransformer = ImageModelTransformer
