"""spark.ml-style Param system (the subset the text slice uses)."""

from sparkdl_tpu_torch.params.base import (
    Param,
    Params,
    TypeConverters,
    keyword_only,
)
from sparkdl_tpu_torch.params.shared import (
    HasBatchSize,
    HasInputCol,
    HasModelFunction,
    HasOutputCol,
)

__all__ = [
    "Param",
    "Params",
    "TypeConverters",
    "keyword_only",
    "HasBatchSize",
    "HasInputCol",
    "HasModelFunction",
    "HasOutputCol",
]
