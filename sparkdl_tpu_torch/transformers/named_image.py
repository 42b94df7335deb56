"""DeepImageFeaturizer: bottleneck features from a named image model.

Port of the JAX package's ``transformers/named_image.py``: a registry
lookup (geometry, preprocessing, feature width) wrapped around an inner
:class:`~sparkdl_tpu_torch.transformers.image_model.ImageModelTransformer`
that runs converter ∘ model ∘ flattener. ``DeepImagePredictor`` and its
label decoding are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.models.registry import get_image_model, supported_models
from sparkdl_tpu_torch.params import (
    HasBatchSize,
    HasInputCol,
    HasOutputCol,
    Param,
    TypeConverters,
    keyword_only,
)
from sparkdl_tpu_torch.pipeline import Transformer
from sparkdl_tpu_torch.transformers.image_model import ImageModelTransformer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _NamedImageTransformer(
    Transformer, HasInputCol, HasOutputCol, HasBatchSize
):
    """Shared plumbing: registry lookup and the inner transformer.

    ``device`` is a keyword of the constructor, not a Param: ``cuda`` by
    default (the transform raises when there is none), ``"cpu"`` to run
    on the CPU."""

    modelName = Param(
        None,
        "modelName",
        "name of the registered model architecture",
        TypeConverters.toString,
    )
    weightsFile = Param(
        None,
        "weightsFile",
        "optional flax .npz weights (as the JAX package's "
        "save_flax_weights writes them); random init from a fixed seed "
        "if unset",
        TypeConverters.toString,
    )
    computeDtype = Param(
        None,
        "computeDtype",
        "device compute dtype: float32 | bfloat16",
        TypeConverters.toChoice("float32", "bfloat16"),
    )

    _mode = "features"  # overridden by subclasses

    def getModelName(self) -> str:
        return self.getOrDefault("modelName")

    def setModelName(self, value: str):
        return self._set(modelName=value)

    @classmethod
    def supportedModels(cls):
        return supported_models(kind="image")

    def _inner(self) -> ImageModelTransformer:
        # keyed by every param that shapes the inner transformer, so
        # setModelName or a ParamMap override rebuilds it
        weights_file = (
            self.getOrDefault("weightsFile")
            if self.isDefined("weightsFile")
            else None
        )
        cache_key = (
            self.getModelName(),
            weights_file,
            self.getOrDefault("computeDtype"),
            self.getInputCol(),
            self.getOutputCol(),
            self.getBatchSize(),
            self._mode,
        )
        cache = getattr(self, "_inner_cache", None)
        if cache is not None and cache[0] == cache_key:
            return cache[1]
        spec = get_image_model(self.getModelName())
        mf = spec.model_function(
            mode=self._mode,
            dtype=_DTYPES[self.getOrDefault("computeDtype")],
            weights_file=weights_file,
            device=self._device,
        )
        inner = ImageModelTransformer(
            inputCol=self.getInputCol(),
            outputCol=self.getOutputCol(),
            modelFunction=mf,
            targetHeight=spec.height,
            targetWidth=spec.width,
            preprocessing=spec.preprocessing,
            channelOrder="BGR",  # image-schema storage order
            outputMode="vector",
            batchSize=self.getBatchSize(),
        )
        self._inner_cache = (cache_key, inner)
        return inner

    def _transform(self, dataset: DataFrame) -> DataFrame:
        return self._inner()._transform(dataset)


class DeepImageFeaturizer(_NamedImageTransformer):
    """Bottleneck features from a named model, for transfer learning:
    chain it with a LogisticRegression head in a Pipeline."""

    _mode = "features"

    @keyword_only
    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelName: Optional[str] = None,
        weightsFile: Optional[str] = None,
        computeDtype: Optional[str] = None,
        batchSize: Optional[int] = None,
        device=None,
    ):
        super().__init__()
        self._setDefault(batchSize=32, computeDtype="bfloat16")
        kwargs = dict(self._input_kwargs)
        self._device = kwargs.pop("device", None)
        self._set(**kwargs)
