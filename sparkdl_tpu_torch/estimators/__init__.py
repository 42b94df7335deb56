"""Estimators: trainable pipeline stages."""

from sparkdl_tpu_torch.estimators.data_parallel_estimator import (
    DataParallelEstimator,
    DataParallelModel,
    HorovodEstimator,
)
from sparkdl_tpu_torch.estimators.image_file_estimator import (
    ImageFileEstimator,
    KerasImageFileEstimator,
)
from sparkdl_tpu_torch.estimators.logistic_regression import (
    LogisticRegression,
    LogisticRegressionModel,
)

__all__ = [
    "DataParallelEstimator",
    "DataParallelModel",
    "HorovodEstimator",
    "ImageFileEstimator",
    "KerasImageFileEstimator",
    "LogisticRegression",
    "LogisticRegressionModel",
]
