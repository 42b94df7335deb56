"""DeepImageFeaturizer and DeepImagePredictor over the named image models
(InceptionV3, MobileNetV2, ResNet50, VGG16, VGG19, Xception).

Port of the JAX package's ``transformers/named_image.py``: a registry
lookup (geometry, preprocessing, feature width) wrapped around an inner
:class:`~sparkdl_tpu_torch.transformers.image_model.ImageModelTransformer`
that runs converter ∘ model ∘ flattener. The featurizer emits the pooled
features, the predictor the class probabilities or their decoded top k.
With ``SPARKDL_DEVICE_PREPROC`` on, the inner transformer ships rows at
their source geometry and resizes them on the device to the entry's
geometry (its height and width stay the model's).
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch

from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.models.keras_weights import imagenet_labels
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
    #: a loaded stage runs where ``load``'s ``device`` puts it (cuda when
    #: none is given); the inner transformer is rebuilt on first use
    _device = None
    _persist_ignore = ("_inner_cache", "_device")

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


class DeepImagePredictor(_NamedImageTransformer):
    """Class predictions from a named model.

    The output column holds each row's probability vector; with
    ``decodePredictions=True`` it holds the top ``topK`` classes instead,
    as ``[{'classIdx', 'label', 'score'}, ...]`` by falling score. Labels
    come from ``labelsFile`` (a JSON list, or a ``{idx: label}`` map), else
    from keras' ``imagenet_class_index.json`` in ``$KERAS_HOME/models/``
    (``~/.keras/models/``), else ``class_<idx>``. The JAX package looks in
    its manifest's artifact store first; that store is not ported, and
    nothing is fetched from the network. Null rows stay null.
    """

    _mode = "probabilities"

    decodePredictions = Param(
        None,
        "decodePredictions",
        "emit top-k decoded predictions instead of the raw probability vector",
        TypeConverters.toBoolean,
    )
    topK = Param(None, "topK", "number of predictions to keep", TypeConverters.toInt)
    labelsFile = Param(
        None,
        "labelsFile",
        "JSON file with class labels (list or idx->label map)",
        TypeConverters.toString,
    )

    @keyword_only
    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelName: Optional[str] = None,
        weightsFile: Optional[str] = None,
        computeDtype: Optional[str] = None,
        batchSize: Optional[int] = None,
        decodePredictions: bool = False,
        topK: Optional[int] = None,
        labelsFile: Optional[str] = None,
        device=None,
    ):
        super().__init__()
        self._setDefault(
            batchSize=32, computeDtype="bfloat16", decodePredictions=False, topK=5
        )
        kwargs = dict(self._input_kwargs)
        self._device = kwargs.pop("device", None)
        self._set(**kwargs)

    def _labels(self) -> Optional[Dict[int, str]]:
        if self.isDefined("labelsFile"):
            with open(self.getOrDefault("labelsFile")) as f:
                blob = json.load(f)
            if isinstance(blob, list):
                return dict(enumerate(blob))
            return {int(k): v for k, v in blob.items()}
        try:
            return imagenet_labels()
        except (OSError, ValueError):
            return None

    def _transform(self, dataset: DataFrame) -> DataFrame:
        out = super()._transform(dataset)
        if not self.getOrDefault("decodePredictions"):
            return out
        k = self.getOrDefault("topK")
        labels = self._labels() or {}
        out_col = self.getOutputCol()

        def decode(row):
            probs = row[out_col]
            if probs is None:
                return None
            probs = np.asarray(probs)
            return [
                {
                    "classIdx": int(i),
                    "label": labels.get(int(i), f"class_{int(i)}"),
                    "score": float(probs[i]),
                }
                for i in np.argsort(probs)[::-1][:k]
            ]

        return out.withColumn(out_col, decode)
