"""LogisticRegression head over feature-vector columns.

Port of the JAX package's ``estimators/logistic_regression.py``: the head
of the north-star pipeline (DeepImageFeaturizer -> LogisticRegression), a
multinomial logistic regression trained with Adam. The same Params,
defaults, initialisation, data order and loss; the JAX package trains
data-parallel over its device mesh, the port on one device (``cuda`` by
default, ``device="cpu"`` for the CPU).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.params import (
    HasBatchSize,
    HasLabelCol,
    Param,
    TypeConverters,
    keyword_only,
)
from sparkdl_tpu_torch.pipeline import Estimator, Model
from sparkdl_tpu_torch.runtime.device import resolve_device
from sparkdl_tpu_torch.transformers.execution import arrays_to_batch, run_batched


class LogisticRegressionModel(Model):
    """``softmax(x @ w + b)`` per row, with the argmax as the prediction.
    ``w`` [d, k] and ``b`` [k] live on ``device`` (``cuda`` by default)."""

    def __init__(
        self, w: np.ndarray, b: np.ndarray, featuresCol: str,
        predictionCol: str, probabilityCol: Optional[str], device=None,
    ):
        super().__init__()
        self._device = resolve_device(device)
        self._set_weights(w, b)
        self._features_col = featuresCol
        self._prediction_col = predictionCol
        self._probability_col = probabilityCol

    def _set_weights(self, w, b) -> None:
        self.w = torch.as_tensor(np.asarray(w, np.float32), device=self._device)
        self.b = torch.as_tensor(np.asarray(b, np.float32), device=self._device)

    @property
    def numClasses(self) -> int:
        return int(self.b.shape[0])

    # -- persistence (the JAX package's save/load layout) -------------------

    def _save_extra(self, path: str) -> dict:
        np.savez(
            os.path.join(path, "model.npz"),
            w=self.w.cpu().numpy(),
            b=self.b.cpu().numpy(),
        )
        return {
            "featuresCol": self._features_col,
            "predictionCol": self._prediction_col,
            "probabilityCol": self._probability_col,
        }

    def _load_extra(self, path: str, meta: dict) -> None:
        if not hasattr(self, "_device"):  # load_stage without a device
            self._device = resolve_device(None)
        with np.load(os.path.join(path, "model.npz")) as blob:
            self._set_weights(blob["w"], blob["b"])
        extra = meta["extra"]
        self._features_col = extra["featuresCol"]
        self._prediction_col = extra["predictionCol"]
        self._probability_col = extra["probabilityCol"]

    def _transform(self, dataset: DataFrame) -> DataFrame:
        f_col = self._features_col
        p_col = self._prediction_col
        prob_col = self._probability_col

        def probabilities(x: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return torch.softmax(x @ self.w + self.b, dim=-1)

        probabilities.device = self._device

        def op(part):
            probs = run_batched(
                part[f_col],
                to_batch=arrays_to_batch,
                device_fn=probabilities,
                batch_size=256,
            )
            out = dict(part)
            out[p_col] = [
                None if p is None else int(np.argmax(p)) for p in probs
            ]
            if prob_col:
                out[prob_col] = probs
            return out

        new_cols = dataset.columns + [p_col] + ([prob_col] if prob_col else [])
        return dataset.mapPartitions(op, new_cols)


class LogisticRegression(Estimator, HasLabelCol, HasBatchSize):
    """Multinomial logistic regression: softmax cross-entropy (the mean
    over a mini-batch's rows; one device needs no padding rows, so no mask)
    plus ``regParam * sum(w**2)``, Adam at ``stepSize``, ``maxIter`` epochs
    of shuffled mini-batches. ``w`` starts at ``normal(0, 0.01)`` from
    ``np.random.default_rng(seed)``, ``b`` at 0; each epoch's order comes
    from ``default_rng(seed + 1)``, as in the JAX package.

    ``device`` is a keyword of the constructor, not a Param: ``cuda`` by
    default (``fit`` raises when there is none), ``"cpu"`` for the CPU.
    """

    featuresCol = Param(
        None, "featuresCol", "feature vector column", TypeConverters.toString
    )
    predictionCol = Param(
        None, "predictionCol", "predicted class index column",
        TypeConverters.toString,
    )
    probabilityCol = Param(
        None, "probabilityCol", "class probability column (optional)",
        TypeConverters.toString,
    )
    maxIter = Param(None, "maxIter", "training epochs", TypeConverters.toInt)
    stepSize = Param(None, "stepSize", "learning rate", TypeConverters.toFloat)
    regParam = Param(
        None, "regParam", "L2 regularization strength", TypeConverters.toFloat
    )
    numClasses = Param(
        None, "numClasses", "number of classes (inferred if unset)",
        TypeConverters.toInt,
    )
    seed = Param(None, "seed", "init seed", TypeConverters.toInt)

    #: not saved: a loaded estimator fits where ``load`` puts it
    _persist_ignore = ("_device",)

    @keyword_only
    def __init__(
        self,
        featuresCol: str = None,
        labelCol: str = None,
        predictionCol: str = None,
        probabilityCol: str = None,
        maxIter: int = None,
        stepSize: float = None,
        regParam: float = None,
        batchSize: int = None,
        numClasses: int = None,
        seed: int = None,
        device=None,
    ):
        super().__init__()
        self._setDefault(
            featuresCol="features",
            labelCol="label",
            predictionCol="prediction",
            maxIter=100,
            stepSize=0.05,
            regParam=1e-4,
            batchSize=512,
            seed=0,
        )
        kwargs = dict(self._input_kwargs)
        self._device = kwargs.pop("device", None)
        self._set(**kwargs)

    def _load_extra(self, path: str, meta: dict) -> None:
        if not hasattr(self, "_device"):  # load_stage without a device
            self._device = None

    def _fit(self, dataset: DataFrame) -> LogisticRegressionModel:
        device = resolve_device(self._device)
        f_col = self.getOrDefault("featuresCol")
        cols = dataset.select(f_col, self.getLabelCol()).collectColumns()
        feats, labels = cols[f_col], cols[self.getLabelCol()]
        keep = [
            i for i, (f, lab) in enumerate(zip(feats, labels))
            if f is not None and lab is not None
        ]
        x = np.stack([np.asarray(feats[i], np.float32).ravel() for i in keep])
        y = np.asarray([int(labels[i]) for i in keep], np.int64)
        n, d = x.shape
        k = (
            self.getOrDefault("numClasses")
            if self.isDefined("numClasses")
            else int(y.max()) + 1
        )
        reg = self.getOrDefault("regParam")

        rng = np.random.default_rng(self.getOrDefault("seed"))
        w = torch.tensor(
            rng.normal(scale=0.01, size=(d, k)).astype(np.float32),
            device=device, requires_grad=True,
        )
        b = torch.zeros(k, device=device, requires_grad=True)
        # torch's Adam defaults (betas 0.9/0.999, eps 1e-8) are optax's
        optimizer = torch.optim.Adam([w, b], lr=self.getOrDefault("stepSize"))
        x_dev = torch.from_numpy(x).to(device)
        y_dev = torch.from_numpy(y).to(device)

        batch_size = min(self.getBatchSize(), max(1, n))
        order = np.arange(n)
        shuffle_rng = np.random.default_rng(self.getOrDefault("seed") + 1)
        for _ in range(self.getOrDefault("maxIter")):
            shuffle_rng.shuffle(order)
            for start in range(0, n, batch_size):
                idx = torch.from_numpy(order[start : start + batch_size]).to(device)
                logits = x_dev[idx] @ w + b
                loss = F.cross_entropy(logits, y_dev[idx]) + reg * (w * w).sum()
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                optimizer.step()

        return LogisticRegressionModel(
            w.detach().cpu().numpy(),
            b.detach().cpu().numpy(),
            featuresCol=f_col,
            predictionCol=self.getOrDefault("predictionCol"),
            probabilityCol=self.getOrDefault("probabilityCol")
            if self.isDefined("probabilityCol")
            else None,
            device=device,
        )
