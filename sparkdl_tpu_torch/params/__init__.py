"""spark.ml-style Param system (the subset the ported slices use)."""

from sparkdl_tpu_torch.params.base import (
    Param,
    Params,
    TypeConverters,
    keyword_only,
)
from sparkdl_tpu_torch.params.shared import (
    CanLoadImage,
    HasBatchSize,
    HasChannelOrder,
    HasInputCol,
    HasLabelCol,
    HasModelFunction,
    HasOutputCol,
    HasOutputMode,
)

__all__ = [
    "Param",
    "Params",
    "TypeConverters",
    "keyword_only",
    "CanLoadImage",
    "HasBatchSize",
    "HasChannelOrder",
    "HasInputCol",
    "HasLabelCol",
    "HasModelFunction",
    "HasOutputCol",
    "HasOutputMode",
]
