"""Shared Param mixins: column names, batch size, channel order, output
mode, model function, image loader."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from sparkdl_tpu_torch.params.base import Param, Params, TypeConverters


class HasInputCol(Params):
    inputCol = Param(
        None, "inputCol", "name of the input column", TypeConverters.toString
    )

    def setInputCol(self, value: str):
        return self._set(inputCol=value)

    def getInputCol(self) -> str:
        return self.getOrDefault(self.inputCol)


class HasOutputCol(Params):
    outputCol = Param(
        None, "outputCol", "name of the output column", TypeConverters.toString
    )

    def setOutputCol(self, value: str):
        return self._set(outputCol=value)

    def getOutputCol(self) -> str:
        return self.getOrDefault(self.outputCol)


class HasLabelCol(Params):
    labelCol = Param(
        None, "labelCol", "name of the label column", TypeConverters.toString
    )

    def setLabelCol(self, value: str):
        return self._set(labelCol=value)

    def getLabelCol(self) -> str:
        return self.getOrDefault(self.labelCol)


class HasOutputMode(Params):
    """'vector' flattens model output to a float vector per row; 'image'
    re-wraps an image model's output as an image struct."""

    outputMode = Param(
        None,
        "outputMode",
        "one of 'vector' or 'image'",
        TypeConverters.toChoice("vector", "image"),
    )

    def setOutputMode(self, value: str):
        return self._set(outputMode=value)

    def getOutputMode(self) -> str:
        return self.getOrDefault(self.outputMode)


class HasChannelOrder(Params):
    """Channel order of the *stored* image data ('BGR' per the OpenCV
    convention, 'RGB', or 'L' for grayscale); the converter piece flips
    BGR to the RGB the models expect."""

    channelOrder = Param(
        None,
        "channelOrder",
        "channel order of image data: 'BGR', 'RGB', or 'L'",
        TypeConverters.toChoice("BGR", "RGB", "L"),
    )

    def setChannelOrder(self, value: str):
        return self._set(channelOrder=value)

    def getChannelOrder(self) -> str:
        return self.getOrDefault(self.channelOrder)


class HasBatchSize(Params):
    batchSize = Param(
        None,
        "batchSize",
        "device batch size for model execution; the tail batch is "
        "zero-padded to this size",
        TypeConverters.toInt,
    )

    def setBatchSize(self, value: int):
        return self._set(batchSize=value)

    def getBatchSize(self) -> int:
        return self.getOrDefault(self.batchSize)


class HasModelFunction(Params):
    """Param holding a ModelFunction (see sparkdl_tpu_torch.graph.function)."""

    modelFunction = Param(
        None,
        "modelFunction",
        "ModelFunction to apply (torch module + device)",
        TypeConverters.identity,
    )

    def setModelFunction(self, value):
        return self._set(modelFunction=value)

    def getModelFunction(self):
        return self.getOrDefault(self.modelFunction)


class CanLoadImage(Params):
    """The image loader of URI-column paths: a callable that turns a file
    path into one preprocessed HWC float array of the model's input
    geometry."""

    imageLoader = Param(
        None,
        "imageLoader",
        "callable (uri: str) -> np.ndarray HWC float array, loading and "
        "preprocessing one image for the model",
        TypeConverters.identity,
    )

    def setImageLoader(self, value: Callable):
        return self._set(imageLoader=value)

    def getImageLoader(self) -> Optional[Callable]:
        return self.getOrDefault(self.imageLoader)

    def _load_uris(self, uris: Sequence[Optional[str]]) -> List[Optional[np.ndarray]]:
        """Each URI through the loader as a float32 array; a None URI, or
        one the loader fails on, gives None (a null row)."""
        loader = self.getImageLoader()
        out: List[Optional[np.ndarray]] = []
        for u in uris:
            if u is None:
                out.append(None)
                continue
            try:
                out.append(np.asarray(loader(u), dtype=np.float32))
            except Exception:  # noqa: BLE001 - any loader failure is a null row
                out.append(None)
        return out

    def loadImagesInternal(self, dataframe, input_col: str, output_col: str):
        """URI column -> image-array column through the imageLoader; null
        or unloadable URIs give null cells."""
        if not self.isDefined("imageLoader"):
            raise ValueError("imageLoader param must be set")
        return dataframe.withColumnPartition(
            output_col, lambda part: {output_col: self._load_uris(part[input_col])}
        )
