"""ImageFileEstimator: fine-tune a Keras model on a column of image file
URIs, one trained ``KerasImageFileTransformer`` per ParamMap.

Port of the JAX package's ``estimators/image_file_estimator.py``. ``fit``
loads and preprocesses each partition's images through ``imageLoader``,
gathers the features and labels as numpy (integer class labels one-hot),
and trains the Keras model named by ``modelFile`` (``.keras`` or ``.h5``,
read by the port's own reader), or given as ``model=`` (a Keras model or
a ``KerasModelSpec``), with ``kerasOptimizer``, ``kerasLoss`` and
``kerasFitParams`` read as Keras reads them (``estimators/keras_fit.py``).
The JAX package runs ``model.fit`` on keras's JAX backend; the port
trains the model translated to torch (``graph/keras_graph.py``) on its
device, ``cuda`` by default (raising where there is none; ``device="cpu"``
for the CPU), and returns a transformer over the trained weights (a
``KerasModelSpec``, which the transformer saves with itself).

``fitMultiple`` materializes the features once and shares them between
fits, unless a ParamMap sets ``inputCol``, ``labelCol`` or
``imageLoader``; so it composes with ``tuning.py``'s ``CrossValidator``.
``seed`` (a keyword, like ``device``) seeds the shuffle and Dropout.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.estimators import keras_fit
from sparkdl_tpu_torch.params import (
    CanLoadImage,
    HasBatchSize,
    HasInputCol,
    HasLabelCol,
    HasOutputCol,
    Param,
    TypeConverters,
    keyword_only,
)
from sparkdl_tpu_torch.pipeline import Estimator, Model, ThreadSafeIterator
from sparkdl_tpu_torch.runtime.device import resolve_device
from sparkdl_tpu_torch.transformers.keras_image import KerasImageFileTransformer

#: the Params whose override makes a fit materialize its own features
DATA_PARAMS = ("inputCol", "labelCol", "imageLoader")


class ImageFileEstimator(
    Estimator,
    HasInputCol,
    HasOutputCol,
    HasLabelCol,
    HasBatchSize,
    CanLoadImage,
):
    modelFile = Param(
        None, "modelFile", "path to the starting Keras model",
        TypeConverters.toString,
    )
    kerasOptimizer = Param(
        None, "kerasOptimizer", "keras optimizer name or config",
        TypeConverters.identity,
    )
    kerasLoss = Param(
        None, "kerasLoss", "keras loss name", TypeConverters.identity
    )
    kerasFitParams = Param(
        None, "kerasFitParams", "kwargs forwarded to keras Model.fit",
        TypeConverters.toDict,
    )

    @keyword_only
    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        labelCol: Optional[str] = None,
        modelFile: Optional[str] = None,
        imageLoader=None,
        kerasOptimizer=None,
        kerasLoss=None,
        kerasFitParams: Optional[dict] = None,
        batchSize: Optional[int] = None,
        model=None,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        self._setDefault(
            kerasOptimizer="adam",
            kerasLoss="categorical_crossentropy",
            kerasFitParams={"verbose": 0},
            batchSize=32,
        )
        self._set(**{k: v for k, v in self._input_kwargs.items() if k not in ("model", "device", "seed")})
        self._model_obj = model
        self._device = device
        self._seed = seed

    # -- data (the reference's _getNumpyFeaturesAndLabels) -----------------

    def _numpy_features_and_labels(self, dataset: DataFrame) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        in_col = self.getInputCol()
        label_col = self.getLabelCol() if self.isDefined("labelCol") else None
        loaded = self.loadImagesInternal(dataset, in_col, "__img_arr__")
        cols = loaded.collectColumns()
        arrays = cols["__img_arr__"]
        labels = cols[label_col] if label_col else None
        keep = [
            i for i, a in enumerate(arrays)
            if a is not None and (labels is None or labels[i] is not None)
        ]
        x = np.stack([np.asarray(arrays[i], np.float32) for i in keep])
        y = None
        if labels is not None:
            y = np.asarray([np.asarray(labels[i]) for i in keep])
            if y.ndim == 1 and not np.issubdtype(y.dtype, np.floating):
                # integer class labels -> one-hot for categorical losses
                k = int(y.max()) + 1
                y = np.eye(k, dtype=np.float32)[y.astype(np.int64)]
        return x, y

    # -- fitting --------------------------------------------------------------

    def _source(self):
        """The starting model: ``model=`` or ``modelFile``, read anew for
        every fit."""
        if getattr(self, "_model_obj", None) is not None:
            return self._model_obj
        if not self.isDefined("modelFile"):
            raise ValueError("modelFile param must be set (or pass model=)")
        from sparkdl_tpu_torch.graph.keras_file import read_keras_file

        return read_keras_file(self.getOrDefault("modelFile"))

    def _fit_on_arrays(self, x: np.ndarray, y: Optional[np.ndarray]) -> Model:
        from sparkdl_tpu_torch.graph.keras_graph import KerasModule, spec_from_module

        if y is None:
            raise ValueError("labelCol param must be set: Keras fit needs targets")
        device = resolve_device(getattr(self, "_device", None))
        source = self._source()
        fmt = torch.channels_last if x.ndim == 4 and device.type == "cuda" else torch.preserve_format
        module = KerasModule(source.get_config(), source).to(device, memory_format=fmt)
        params = dict(self.getOrDefault("kerasFitParams"))
        params.setdefault("verbose", 0)
        params.setdefault("batch_size", self.getBatchSize())
        history = keras_fit.fit(
            module, x, y,
            optimizer=self.getOrDefault("kerasOptimizer"),
            loss=self.getOrDefault("kerasLoss"),
            params=params,
            seed=getattr(self, "_seed", 0),
        )
        model = KerasImageFileTransformer(
            inputCol=self.getInputCol(),
            outputCol=self.getOutputCol(),
            model=spec_from_module(module),
            imageLoader=self.getImageLoader(),
            batchSize=self.getBatchSize(),
            device=getattr(self, "_device", None),
        )
        model.history = history
        return model

    def _fit(self, dataset: DataFrame) -> Model:
        x, y = self._numpy_features_and_labels(dataset)
        return self._fit_on_arrays(x, y)

    def fitMultiple(self, dataset: DataFrame, paramMaps: Sequence[dict]) -> Iterator[Tuple[int, Model]]:
        """One trained model per ParamMap, in order. The features are
        materialized once and shared, unless a ParamMap overrides
        ``inputCol``, ``labelCol`` or ``imageLoader``; that fit then
        materializes its own. The fits run one after another (each holds
        the device), behind a thread-safe iterator for
        CrossValidator-style use."""
        shared = None

        def affects_data(pm: dict) -> bool:
            return any((k.name if hasattr(k, "name") else str(k)) in DATA_PARAMS for k in pm)

        def gen():
            nonlocal shared
            for i, pm in enumerate(paramMaps):
                est: ImageFileEstimator = self.copy(pm)
                if affects_data(pm):
                    x, y = est._numpy_features_and_labels(dataset)
                else:
                    if shared is None:
                        shared = self._numpy_features_and_labels(dataset)
                    x, y = shared
                yield i, est._fit_on_arrays(x, y)

        return ThreadSafeIterator(gen())


#: the reference's name
KerasImageFileEstimator = ImageFileEstimator
