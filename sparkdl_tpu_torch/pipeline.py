"""Pipeline stage abstraction: ``Transformer`` (spark.ml semantics)."""

from __future__ import annotations

from typing import Optional

from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.params import Params


class Transformer(Params):
    def transform(
        self, dataset: DataFrame, params: Optional[dict] = None
    ) -> DataFrame:
        if params:
            return self.copy(params)._transform(dataset)
        return self._transform(dataset)

    def _transform(self, dataset: DataFrame) -> DataFrame:
        raise NotImplementedError
