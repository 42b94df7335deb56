"""Pipeline stages: ``Transformer``, ``Estimator``, ``Model``, ``Pipeline``.

spark.ml semantics, as in the JAX package's ``pipeline.py``: an
Estimator's ``fit`` returns a Model (itself a Transformer); a Pipeline
fits its stages left to right, transforming the running DataFrame
through each fitted stage; ParamMap overrides flow through
``fit(df, params=...)`` and ``fitMultiple``, whose thread-safe iterator
model selection (``tuning.py``) consumes from ``parallelism`` threads.

Persistence uses the JAX package's layout: a ``Pipeline`` or
``PipelineModel`` saves each stage in ``<path>/stages/<i>_<uid>/`` and
lists those directories under ``stageDirs`` in its metadata's ``extra``.
``load(path, device)`` puts the tensors of every fitted stage on
``device``.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.params import Param, Params, TypeConverters, keyword_only


class FitMultipleIterator:
    """Thread-safe (index, model) iterator: ``next()`` claims the next
    index under a lock and runs the fit outside it, so N consumers train
    N models at once (pyspark's ``fitMultiple`` contract)."""

    def __init__(self, fit_single: Callable[[int], "Model"], n: int):
        self._fit_single = fit_single
        self._n = n
        self._counter = 0
        self._lock = threading.Lock()

    def __iter__(self) -> "FitMultipleIterator":
        return self

    def __next__(self) -> Tuple[int, "Model"]:
        with self._lock:
            i = self._counter
            if i >= self._n:
                raise StopIteration
            self._counter = i + 1
        return i, self._fit_single(i)


class ThreadSafeIterator:
    """A plain iterator made safe for several consumers: ``next()`` runs
    under a lock, the work included (for fits that must not overlap)."""

    def __init__(self, it: Iterator):
        self._it = it
        self._lock = threading.Lock()

    def __iter__(self) -> "ThreadSafeIterator":
        return self

    def __next__(self):
        with self._lock:
            return next(self._it)


class Transformer(Params):
    def transform(
        self, dataset: DataFrame, params: Optional[dict] = None
    ) -> DataFrame:
        if params:
            return self.copy(params)._transform(dataset)
        return self._transform(dataset)

    def _transform(self, dataset: DataFrame) -> DataFrame:
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer produced by an Estimator."""


class Estimator(Params):
    def fit(self, dataset: DataFrame, params: Optional[dict] = None) -> Model:
        if params:
            return self.copy(params)._fit(dataset)
        return self._fit(dataset)

    def fitMultiple(
        self, dataset: DataFrame, paramMaps: Sequence[dict]
    ) -> Iterator[Tuple[int, Model]]:
        """One model per ParamMap, as a thread-safe iterator of
        (index, model); each ``next()`` trains one."""
        maps = list(paramMaps)
        return FitMultipleIterator(
            lambda i: self.fit(dataset, params=maps[i]), len(maps)
        )

    def _fit(self, dataset: DataFrame) -> Model:
        raise NotImplementedError


def _save_stage_list(stages: Sequence[Params], path: str) -> dict:
    """Save each stage in ``<path>/stages/<i>_<uid>/`` (MLlib's layout for
    a Pipeline and a PipelineModel alike)."""
    from sparkdl_tpu_torch import persistence

    dirs = []
    for i, stage in enumerate(stages):
        sub = os.path.join("stages", f"{i}_{stage.uid}")
        os.makedirs(os.path.join(path, sub), exist_ok=True)
        persistence.save_stage(stage, os.path.join(path, sub), overwrite=True)
        dirs.append(sub)
    return {"stageDirs": dirs}


def _load_stage_list(path: str, meta: dict, device=None) -> List[Params]:
    from sparkdl_tpu_torch import persistence

    return [
        persistence.load_stage(os.path.join(path, sub), device=device)
        for sub in meta["extra"]["stageDirs"]
    ]


class PipelineModel(Model):
    def __init__(self, stages: List[Transformer]):
        super().__init__()
        self.stages = stages

    def _transform(self, dataset: DataFrame) -> DataFrame:
        for stage in self.stages:
            dataset = stage.transform(dataset)
        return dataset

    def _save_extra(self, path: str) -> dict:
        return _save_stage_list(self.stages, path)

    def _load_extra(self, path: str, meta: dict) -> None:
        self.stages = _load_stage_list(path, meta, getattr(self, "_device", None))


class Pipeline(Estimator):
    stages = Param(None, "stages", "pipeline stages", TypeConverters.toList)

    @keyword_only
    def __init__(self, stages: Optional[List[Params]] = None):
        super().__init__()
        self._set(stages=stages or [])

    def setStages(self, value: List[Params]) -> "Pipeline":
        return self._set(stages=value)

    def getStages(self) -> List[Params]:
        return self.getOrDefault(self.stages)

    def _non_json_params(self) -> List[str]:
        return ["stages"]

    def _save_extra(self, path: str) -> dict:
        return _save_stage_list(self.getStages(), path)

    def _load_extra(self, path: str, meta: dict) -> None:
        self._set(stages=_load_stage_list(path, meta, getattr(self, "_device", None)))

    def copy(self, extra: Optional[dict] = None) -> "Pipeline":
        """Propagate ParamMap overrides into the stages (pyspark parity)."""
        that = super().copy(extra)
        that._set(stages=[s.copy(extra) for s in self.getStages()])
        return that

    def _fit(self, dataset: DataFrame) -> PipelineModel:
        fitted: List[Transformer] = []
        for stage in self.getStages():
            if isinstance(stage, Estimator):
                model = stage.fit(dataset)
                fitted.append(model)
                dataset = model.transform(dataset)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                dataset = stage.transform(dataset)
            else:
                raise TypeError(
                    f"Pipeline stage {stage!r} is neither Estimator nor "
                    "Transformer"
                )
        return PipelineModel(fitted)
