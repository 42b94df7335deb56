"""Evaluators for model selection.

A copy of the JAX package's ``evaluation.py`` (host code: vectorized numpy
over collected prediction and label columns): the three evaluators of
pyspark.ml.evaluation that model selection plugs in.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.params import Param, Params, TypeConverters, keyword_only
from sparkdl_tpu_torch.params.shared import HasLabelCol


class Evaluator(Params):
    """Base evaluator: maps a DataFrame with predictions to a scalar metric."""

    def evaluate(self, dataset: DataFrame, params: Optional[dict] = None) -> float:
        if params:
            return self.copy(params)._evaluate(dataset)
        return self._evaluate(dataset)

    def _evaluate(self, dataset: DataFrame) -> float:
        raise NotImplementedError

    def isLargerBetter(self) -> bool:
        return True


def _column_pair(dataset: DataFrame, label_col: str, pred_col: str):
    cols = dataset.select(label_col, pred_col).collectColumns()
    y = np.asarray([float(v) for v in cols[label_col]])
    yhat = cols[pred_col]
    return y, yhat


class MulticlassClassificationEvaluator(Evaluator, HasLabelCol):
    predictionCol = Param(
        None, "predictionCol", "predicted class index column",
        TypeConverters.toString,
    )
    metricName = Param(
        None, "metricName", "accuracy | f1 | weightedPrecision | weightedRecall",
        TypeConverters.toChoice(
            "accuracy", "f1", "weightedPrecision", "weightedRecall"
        ),
    )

    @keyword_only
    def __init__(self, labelCol=None, predictionCol=None, metricName=None):
        super().__init__()
        self._setDefault(
            labelCol="label", predictionCol="prediction", metricName="accuracy"
        )
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, labelCol=None, predictionCol=None, metricName=None):
        return self._set(**self._input_kwargs)

    def _evaluate(self, dataset: DataFrame) -> float:
        y, yhat = _column_pair(
            dataset, self.getLabelCol(), self.getOrDefault("predictionCol")
        )
        yhat = np.asarray([float(v) for v in yhat])
        metric = self.getOrDefault("metricName")
        if metric == "accuracy":
            return float(np.mean(y == yhat)) if len(y) else 0.0
        classes = np.unique(np.concatenate([y, yhat]))
        # per-class precision/recall/f1, weighted by true-class support
        precisions, recalls, f1s, weights = [], [], [], []
        for c in classes:
            tp = float(np.sum((yhat == c) & (y == c)))
            fp = float(np.sum((yhat == c) & (y != c)))
            fn = float(np.sum((yhat != c) & (y == c)))
            p = tp / (tp + fp) if tp + fp > 0 else 0.0
            r = tp / (tp + fn) if tp + fn > 0 else 0.0
            f = 2 * p * r / (p + r) if p + r > 0 else 0.0
            precisions.append(p)
            recalls.append(r)
            f1s.append(f)
            weights.append(float(np.sum(y == c)))
        w = np.asarray(weights)
        w = w / w.sum() if w.sum() > 0 else w
        if metric == "f1":
            return float(np.dot(w, f1s))
        if metric == "weightedPrecision":
            return float(np.dot(w, precisions))
        return float(np.dot(w, recalls))


class BinaryClassificationEvaluator(Evaluator, HasLabelCol):
    rawPredictionCol = Param(
        None, "rawPredictionCol",
        "score column: float P(class=1) or a length-2 probability vector",
        TypeConverters.toString,
    )
    metricName = Param(
        None, "metricName", "areaUnderROC | areaUnderPR",
        TypeConverters.toChoice("areaUnderROC", "areaUnderPR"),
    )

    @keyword_only
    def __init__(self, labelCol=None, rawPredictionCol=None, metricName=None):
        super().__init__()
        self._setDefault(
            labelCol="label",
            rawPredictionCol="probability",
            metricName="areaUnderROC",
        )
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, labelCol=None, rawPredictionCol=None, metricName=None):
        return self._set(**self._input_kwargs)

    def _evaluate(self, dataset: DataFrame) -> float:
        y, raw = _column_pair(
            dataset, self.getLabelCol(), self.getOrDefault("rawPredictionCol")
        )
        scores = np.asarray(
            [
                float(np.asarray(v).reshape(-1)[-1])  # P(class=1) if a vector
                for v in raw
            ]
        )
        pos = float(np.sum(y == 1))
        neg = float(len(y) - pos)
        if pos == 0 or neg == 0:
            return 0.0
        # Evaluate the curve only at distinct-score thresholds so tied scores
        # contribute one diagonal segment (a constant classifier scores 0.5),
        # not a row-order-dependent staircase.
        order = np.argsort(-scores, kind="stable")
        y_sorted = y[order]
        s_sorted = scores[order]
        tps = np.cumsum(y_sorted == 1)
        fps = np.cumsum(y_sorted == 0)
        distinct = np.nonzero(np.diff(s_sorted))[0]  # last index of each group
        thresh = np.concatenate([distinct, [len(s_sorted) - 1]])
        tps, fps = tps[thresh], fps[thresh]
        trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy<2
        tpr = np.concatenate([[0.0], tps / pos])
        fpr = np.concatenate([[0.0], fps / neg])
        if self.getOrDefault("metricName") == "areaUnderROC":
            return float(trapezoid(tpr, fpr))
        precision = np.concatenate(
            [[1.0], tps / np.maximum(tps + fps, 1)]
        )
        return float(trapezoid(precision, tpr))


class RegressionEvaluator(Evaluator, HasLabelCol):
    predictionCol = Param(
        None, "predictionCol", "predicted value column", TypeConverters.toString
    )
    metricName = Param(
        None, "metricName", "rmse | mse | mae | r2",
        TypeConverters.toChoice("rmse", "mse", "mae", "r2"),
    )

    @keyword_only
    def __init__(self, labelCol=None, predictionCol=None, metricName=None):
        super().__init__()
        self._setDefault(
            labelCol="label", predictionCol="prediction", metricName="rmse"
        )
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, labelCol=None, predictionCol=None, metricName=None):
        return self._set(**self._input_kwargs)

    def isLargerBetter(self) -> bool:
        return self.getOrDefault("metricName") == "r2"

    def _evaluate(self, dataset: DataFrame) -> float:
        y, yhat = _column_pair(
            dataset, self.getLabelCol(), self.getOrDefault("predictionCol")
        )
        yhat = np.asarray([float(v) for v in yhat])
        err = y - yhat
        metric = self.getOrDefault("metricName")
        if metric == "mse":
            return float(np.mean(err**2))
        if metric == "rmse":
            return float(np.sqrt(np.mean(err**2)))
        if metric == "mae":
            return float(np.mean(np.abs(err)))
        ss_res = float(np.sum(err**2))
        ss_tot = float(np.sum((y - y.mean()) ** 2))
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0


__all__ = [
    "Evaluator",
    "MulticlassClassificationEvaluator",
    "BinaryClassificationEvaluator",
    "RegressionEvaluator",
]
