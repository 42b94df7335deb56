"""Estimators: trainable pipeline stages."""

from sparkdl_tpu_torch.estimators.logistic_regression import (
    LogisticRegression,
    LogisticRegressionModel,
)

__all__ = ["LogisticRegression", "LogisticRegressionModel"]
