"""Model selection: ParamGridBuilder, CrossValidator, TrainValidationSplit.

Port of the JAX package's ``tuning.py`` (host code): upstream's
transfer-learning recipe runs pyspark.ml.tuning's ``CrossValidator`` over
the featurizer's output, and this is that surface.

- ``ParamGridBuilder.addGrid(...).build()``: the cartesian product of the
  grid as a list of ParamMaps;
- ``CrossValidator``: k folds from ``randomSplit`` (the JAX package's
  draws) or from a ``foldCol``; the folds run one after another, and
  within a fold the ParamMaps fan out over ``parallelism`` threads that
  consume ``Estimator.fitMultiple``. Fits on one card share it: each
  thread issues its own kernels, and a fit's result does not depend on
  the others;
- ``TrainValidationSplit``: one split by ``trainRatio``;
- the best ParamMap is fitted again on the whole dataset;
- ``save``/``load`` through ``persistence.py``: the estimator and the
  evaluator as nested stages, the grid keyed by (stage uid, param name);
  a fitted model keeps its best model and metrics (not its sub-models).
"""

from __future__ import annotations

import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from sparkdl_tpu_torch import persistence
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.evaluation import Evaluator
from sparkdl_tpu_torch.params import Param, Params, TypeConverters, keyword_only
from sparkdl_tpu_torch.pipeline import Estimator, Model, Pipeline, PipelineModel


class ParamGridBuilder:
    """Builds the cartesian product of param values as ParamMaps."""

    def __init__(self):
        self._grid: Dict[Param, List[Any]] = {}

    def addGrid(self, param: Param, values: Sequence[Any]) -> "ParamGridBuilder":
        if not isinstance(param, Param):
            raise TypeError(f"addGrid expects a Param, got {param!r}")
        self._grid[param] = list(values)
        return self

    def baseOn(self, *args) -> "ParamGridBuilder":
        """(param, value) pairs, or one dict of them, in every map."""
        if len(args) == 1 and isinstance(args[0], dict):
            args = tuple(args[0].items())
        for param, value in args:
            self.addGrid(param, [value])
        return self

    def build(self) -> List[Dict[Param, Any]]:
        keys = list(self._grid)
        if not keys:
            return [{}]
        return [
            dict(zip(keys, combo))
            for combo in itertools.product(*(self._grid[k] for k in keys))
        ]


class _ValidatorParams(Params):
    estimator = Param(None, "estimator", "estimator to tune")
    estimatorParamMaps = Param(None, "estimatorParamMaps", "param grid")
    evaluator = Param(None, "evaluator", "metric evaluator")
    seed = Param(None, "seed", "random seed", TypeConverters.toInt)
    parallelism = Param(
        None, "parallelism", "number of models trained at once (threads)",
        TypeConverters.toInt,
    )
    collectSubModels = Param(
        None, "collectSubModels", "keep every sub-model (memory-heavy)",
        TypeConverters.toBoolean,
    )

    def getEstimator(self) -> Estimator:
        return self.getOrDefault("estimator")

    def getEstimatorParamMaps(self) -> List[dict]:
        return self.getOrDefault("estimatorParamMaps")

    def getEvaluator(self) -> Evaluator:
        return self.getOrDefault("evaluator")

    def _fit_and_eval_maps(
        self, train: DataFrame, valid: DataFrame, param_maps: Sequence[dict]
    ) -> List[tuple]:
        """One model per ParamMap through ``fitMultiple``, each evaluated on
        ``valid``, consumed by ``parallelism`` threads:
        [(map index, metric, model), ...]."""
        est = self.getEstimator()
        ev = self.getEvaluator()
        it = est.fitMultiple(train, param_maps)

        def consume(_i) -> Optional[tuple]:
            try:
                idx, model = next(it)
            except StopIteration:
                return None
            return idx, ev.evaluate(model.transform(valid)), model

        parallelism = max(1, self.getOrDefault("parallelism"))
        if parallelism == 1:
            results = [consume(i) for i in range(len(param_maps))]
        else:
            with ThreadPoolExecutor(max_workers=parallelism) as pool:
                results = list(pool.map(consume, range(len(param_maps))))
        return [r for r in results if r is not None]

    def _select_best(self, metrics: Sequence[float]) -> int:
        arr = np.asarray(metrics, dtype=float)
        return int(np.argmax(arr) if self.getEvaluator().isLargerBetter() else np.argmin(arr))

    # -- persistence ---------------------------------------------------------

    def _non_json_params(self) -> List[str]:
        return ["estimator", "estimatorParamMaps", "evaluator"]

    @staticmethod
    def _walk_stages(stage: Params):
        """A stage and every stage nested in it: a grid param may belong
        to a stage inside a Pipeline, so grid keys are (owner uid, name)
        and rebind by walking the loaded tree."""
        yield stage
        if isinstance(stage, Pipeline):
            children = stage.getStages()
        elif isinstance(stage, PipelineModel):
            children = stage.stages
        elif isinstance(stage, _ValidatorParams):
            children = [stage.getEstimator()]
        else:
            children = []
        for child in children:
            yield from _ValidatorParams._walk_stages(child)

    def _save_extra(self, path: str) -> dict:
        for sub, stage in (("estimator", self.getEstimator()), ("evaluator", self.getEvaluator())):
            persistence.save_stage(stage, os.path.join(path, sub), overwrite=True)
        owned_uids = {s.uid for s in self._walk_stages(self.getEstimator())}
        grid = []
        for pm in self.getEstimatorParamMaps():
            entry = {}
            for p, v in pm.items():
                if not isinstance(p, Param):
                    raise ValueError(f"estimatorParamMaps key {p!r} is not a Param")
                if p.parent not in owned_uids:
                    raise ValueError(
                        f"Cannot save: grid param {p} does not belong to the "
                        f"estimator or any of its nested stages"
                    )
                entry[f"{p.parent}::{p.name}"] = v
            grid.append(entry)
        return {"paramGrid": grid}

    def _load_extra(self, path: str, meta: dict) -> None:
        device = getattr(self, "_device", None)
        est = persistence.load_stage(os.path.join(path, "estimator"), device=device)
        ev = persistence.load_stage(os.path.join(path, "evaluator"))
        by_uid = {s.uid: s for s in self._walk_stages(est)}
        grid = []
        for entry in meta["extra"]["paramGrid"]:
            pm = {}
            for key, v in entry.items():
                uid, _, name = key.partition("::")
                owner = by_uid.get(uid)
                if owner is None or not owner.hasParam(name):
                    raise ValueError(
                        f"Saved grid references param {key!r} not found on "
                        f"the loaded estimator tree"
                    )
                pm[owner.getParam(name)] = v
            grid.append(pm)
        self._set(estimator=est, evaluator=ev, estimatorParamMaps=grid)


class _BestModelPersistence:
    """Save and load of a validator's model: the best model as a nested
    stage (its tensors on ``load``'s device) and the metrics list named
    by ``_metrics_attr``. Sub-models are not saved."""

    _metrics_attr: str = ""

    def _save_extra(self, path: str) -> dict:
        persistence.save_stage(self.bestModel, os.path.join(path, "bestModel"), overwrite=True)
        return {self._metrics_attr: getattr(self, self._metrics_attr)}

    def _load_extra(self, path: str, meta: dict) -> None:
        self.bestModel = persistence.load_stage(
            os.path.join(path, "bestModel"), device=getattr(self, "_device", None)
        )
        setattr(self, self._metrics_attr, meta["extra"][self._metrics_attr])
        self.subModels = None


class CrossValidatorModel(_BestModelPersistence, Model):
    _metrics_attr = "avgMetrics"

    def __init__(
        self,
        bestModel: Model,
        avgMetrics: List[float],
        subModels: Optional[List[List[Model]]] = None,
    ):
        super().__init__()
        self.bestModel = bestModel
        self.avgMetrics = list(avgMetrics)
        self.subModels = subModels

    def _transform(self, dataset: DataFrame) -> DataFrame:
        return self.bestModel.transform(dataset)


class CrossValidator(Estimator, _ValidatorParams):
    numFolds = Param(None, "numFolds", "number of cross-validation folds", TypeConverters.toInt)
    foldCol = Param(
        None, "foldCol",
        "column of user-assigned fold indices in [0, numFolds); empty "
        "string: random k-fold",
        TypeConverters.toString,
    )

    @keyword_only
    def __init__(
        self,
        estimator: Estimator = None,
        estimatorParamMaps: List[dict] = None,
        evaluator: Evaluator = None,
        numFolds: int = None,
        seed: int = None,
        parallelism: int = None,
        collectSubModels: bool = None,
        foldCol: str = None,
    ):
        super().__init__()
        self._setDefault(numFolds=3, seed=0, parallelism=1, collectSubModels=False, foldCol="")
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, **kwargs):
        return self._set(**self._input_kwargs)

    def _kfold(self, dataset: DataFrame):
        k = self.getOrDefault("numFolds")
        if k < 2:
            raise ValueError(f"numFolds must be >= 2, got {k}")
        fold_col = self.getOrDefault("foldCol")
        if fold_col:
            if fold_col not in dataset.columns:
                raise KeyError(f"foldCol {fold_col!r} not in dataset columns")
            # a bad fold value fails before any training
            bad = dataset.filter(
                lambda r: not (isinstance(r[fold_col], (int, np.integer)) and 0 <= r[fold_col] < k)
            ).count()
            if bad:
                raise ValueError(
                    f"foldCol {fold_col!r} has {bad} rows outside integer range [0, {k})"
                )
            for i in range(k):
                yield (
                    dataset.filter(lambda r, i=i: r[fold_col] != i),
                    dataset.filter(lambda r, i=i: r[fold_col] == i),
                )
            return
        folds = dataset.randomSplit([1.0] * k, seed=self.getOrDefault("seed"))
        for i in range(k):
            train: Optional[DataFrame] = None
            for j, f in enumerate(folds):
                if j != i:
                    train = f if train is None else train.union(f)
            yield train, folds[i]

    def _fit(self, dataset: DataFrame) -> CrossValidatorModel:
        param_maps = self.getEstimatorParamMaps()
        k = self.getOrDefault("numFolds")
        dataset = dataset.cache()
        metrics = np.zeros((k, len(param_maps)))
        collect = self.getOrDefault("collectSubModels")
        sub: Optional[List[List[Model]]] = (
            [[None] * len(param_maps) for _ in range(k)] if collect else None
        )
        for fold_idx, (train, valid) in enumerate(self._kfold(dataset)):
            train, valid = train.cache(), valid.cache()
            for pm_idx, metric, model in self._fit_and_eval_maps(train, valid, param_maps):
                metrics[fold_idx][pm_idx] = metric
                if collect:
                    sub[fold_idx][pm_idx] = model
        avg = metrics.mean(axis=0).tolist()
        best_model = self.getEstimator().fit(dataset, params=param_maps[self._select_best(avg)])
        return CrossValidatorModel(best_model, avg, sub)


class TrainValidationSplitModel(_BestModelPersistence, Model):
    _metrics_attr = "validationMetrics"

    def __init__(
        self,
        bestModel: Model,
        validationMetrics: List[float],
        subModels: Optional[List[Model]] = None,
    ):
        super().__init__()
        self.bestModel = bestModel
        self.validationMetrics = list(validationMetrics)
        self.subModels = subModels

    def _transform(self, dataset: DataFrame) -> DataFrame:
        return self.bestModel.transform(dataset)


class TrainValidationSplit(Estimator, _ValidatorParams):
    trainRatio = Param(None, "trainRatio", "fraction of rows used for training", TypeConverters.toFloat)

    @keyword_only
    def __init__(
        self,
        estimator: Estimator = None,
        estimatorParamMaps: List[dict] = None,
        evaluator: Evaluator = None,
        trainRatio: float = None,
        seed: int = None,
        parallelism: int = None,
        collectSubModels: bool = None,
    ):
        super().__init__()
        self._setDefault(trainRatio=0.75, seed=0, parallelism=1, collectSubModels=False)
        self._set(**self._input_kwargs)

    @keyword_only
    def setParams(self, **kwargs):
        return self._set(**self._input_kwargs)

    def _fit(self, dataset: DataFrame) -> TrainValidationSplitModel:
        ratio = self.getOrDefault("trainRatio")
        if not 0.0 < ratio < 1.0:
            raise ValueError(f"trainRatio must be in (0, 1), got {ratio}")
        dataset = dataset.cache()
        train, valid = dataset.randomSplit([ratio, 1.0 - ratio], seed=self.getOrDefault("seed"))
        train, valid = train.cache(), valid.cache()
        param_maps = self.getEstimatorParamMaps()
        metrics = [0.0] * len(param_maps)
        models: List[Optional[Model]] = [None] * len(param_maps)
        for pm_idx, metric, model in self._fit_and_eval_maps(train, valid, param_maps):
            metrics[pm_idx] = metric
            models[pm_idx] = model
        best_model = self.getEstimator().fit(dataset, params=param_maps[self._select_best(metrics)])
        sub = models if self.getOrDefault("collectSubModels") else None
        return TrainValidationSplitModel(best_model, metrics, sub)


__all__ = [
    "ParamGridBuilder",
    "CrossValidator",
    "CrossValidatorModel",
    "TrainValidationSplit",
    "TrainValidationSplitModel",
]
