"""The port's model selection (``sparkdl_tpu_torch/tuning.py``) against the
JAX package's ``tuning.py`` on the CPU.

Both packages tune ``LogisticRegression`` over the same blobs with the
same seeds: the folds come from ``randomSplit`` (the same draws in both)
or from a fold column, and the JAX fit runs over a one-device mesh, where
its step is the port's arithmetic (``test_torch_logistic_regression.py``
holds the fits at atol 1e-5). The metrics (accuracy over the validation
rows) must agree within 1e-6 and the best ParamMap must be the same.
Parallelism 1 and 2 give the same models; a validator and its fitted
model round-trip through ``save``/``load``.
"""

import jax
import numpy as np
import pytest

from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.estimators import LogisticRegression as JaxLogisticRegression
from sparkdl_tpu.estimators import logistic_regression as jax_lr_module
from sparkdl_tpu.evaluation import MulticlassClassificationEvaluator as JaxMulticlass
from sparkdl_tpu.tuning import CrossValidator as JaxCrossValidator
from sparkdl_tpu.tuning import ParamGridBuilder as JaxParamGridBuilder
from sparkdl_tpu.tuning import TrainValidationSplit as JaxTrainValidationSplit
from sparkdl_tpu_torch import persistence
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.estimators import LogisticRegression
from sparkdl_tpu_torch.evaluation import MulticlassClassificationEvaluator
from sparkdl_tpu_torch.tuning import (
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    TrainValidationSplit,
    TrainValidationSplitModel,
)

METRIC_ATOL = 1e-6
W_ATOL = 1e-5


@pytest.fixture
def one_device_mesh(monkeypatch):
    make_mesh = jax_lr_module.make_mesh
    monkeypatch.setattr(jax_lr_module, "make_mesh", lambda: make_mesh(devices=jax.devices()[:1]))


def _blobs(n=96, seed=0):
    """Three overlapping Gaussian blobs in 4-d (so neither every model nor
    every fold scores 1.0), and a fold column."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0.0, 1.2, size=(3, 4))
    labels = [i % 3 for i in range(n)]
    feats = [(centres[c] + rng.normal(size=4)).astype(np.float32) for c in labels]
    return {"features": feats, "label": labels, "fold": [int(i) for i in rng.integers(0, 3, size=n)]}


def _frames(n=96, seed=0, parts=3):
    cols = _blobs(n, seed)
    return DataFrame.fromColumns(cols, numPartitions=parts), JaxDataFrame.fromColumns(cols, numPartitions=parts)


def _grid(builder, lr):
    return builder().addGrid(lr.regParam, [0.0, 0.5]).addGrid(lr.stepSize, [0.002, 0.05]).build()


def _pair(kind, **kw):
    """The same validator in both packages (LR maxIter 8, seed 3)."""
    lr = LogisticRegression(maxIter=8, seed=3, device="cpu")
    jlr = JaxLogisticRegression(maxIter=8, seed=3)
    ours_cls, ref_cls = {
        "cv": (CrossValidator, JaxCrossValidator),
        "tvs": (TrainValidationSplit, JaxTrainValidationSplit),
    }[kind]
    ours = ours_cls(estimator=lr, estimatorParamMaps=_grid(ParamGridBuilder, lr),
                    evaluator=MulticlassClassificationEvaluator(), seed=7, **kw)
    ref = ref_cls(estimator=jlr, estimatorParamMaps=_grid(JaxParamGridBuilder, jlr),
                  evaluator=JaxMulticlass(), seed=7, **kw)
    return ours, ref


def test_param_grid_matches_jax():
    lr, jlr = LogisticRegression(device="cpu"), JaxLogisticRegression()
    ours, ref = _grid(ParamGridBuilder, lr), _grid(JaxParamGridBuilder, jlr)
    as_names = lambda grid: [sorted((p.name, v) for p, v in m.items()) for m in grid]  # noqa: E731
    assert len(ours) == 4 and as_names(ours) == as_names(ref)
    assert all(p.parent == lr.uid for m in ours for p in m)
    based = ParamGridBuilder().baseOn({lr.maxIter: 3}).addGrid(lr.seed, [1, 2]).build()
    assert [sorted((p.name, v) for p, v in m.items()) for m in based] == [
        [("maxIter", 3), ("seed", 1)], [("maxIter", 3), ("seed", 2)]
    ]
    assert ParamGridBuilder().build() == [{}]
    with pytest.raises(TypeError):
        ParamGridBuilder().addGrid("regParam", [1])


@pytest.mark.parametrize("kw", [{"numFolds": 3}, {"numFolds": 3, "foldCol": "fold"}, {"numFolds": 2}],
                         ids=["3 folds", "foldCol", "2 folds"])
def test_cross_validator_matches_jax(one_device_mesh, kw):
    ours, ref = _pair("cv", **kw)
    df, jdf = _frames()
    got, want = ours.fit(df), ref.fit(jdf)
    assert len(got.avgMetrics) == 4
    np.testing.assert_allclose(got.avgMetrics, want.avgMetrics, rtol=0, atol=METRIC_ATOL)
    assert int(np.argmax(got.avgMetrics)) == int(np.argmax(want.avgMetrics))
    assert len(set(np.round(got.avgMetrics, 6))) > 1  # the grid's models differ
    np.testing.assert_allclose(got.bestModel.w.numpy(), np.asarray(want.bestModel.w), rtol=0, atol=W_ATOL)
    preds = [r.prediction for r in got.transform(df).collect()]
    assert preds == [r.prediction for r in want.transform(jdf).collect()]


def test_train_validation_split_matches_jax(one_device_mesh):
    ours, ref = _pair("tvs", trainRatio=0.7)
    df, jdf = _frames()
    got, want = ours.fit(df), ref.fit(jdf)
    np.testing.assert_allclose(got.validationMetrics, want.validationMetrics, rtol=0, atol=METRIC_ATOL)
    assert int(np.argmax(got.validationMetrics)) == int(np.argmax(want.validationMetrics))
    np.testing.assert_allclose(got.bestModel.b.numpy(), np.asarray(want.bestModel.b), rtol=0, atol=W_ATOL)


def test_fold_col_splits_by_the_column():
    ours, _ = _pair("cv", numFolds=3, foldCol="fold")
    df, _ = _frames(n=30)
    folds = _blobs(30)["fold"]
    for i, (train, valid) in enumerate(ours._kfold(df)):
        assert [r.fold for r in valid.collect()] == [f for f in folds if f == i]
        assert [r.fold for r in train.collect()] == [f for f in folds if f != i]
    bad = DataFrame.fromColumns({**_blobs(30), "fold": [5] + folds[1:]})
    with pytest.raises(ValueError, match="outside integer range"):
        list(ours._kfold(bad))
    with pytest.raises(KeyError, match="nope"):
        list(ours.copy({ours.foldCol: "nope"})._kfold(df))


@pytest.mark.parametrize("kind", ["cv", "tvs"])
def test_parallelism_gives_the_same_models(kind):
    """Fits from two threads at once give what one thread gives."""
    df, _ = _frames(seed=1)
    models = [_pair(kind, parallelism=p, collectSubModels=True)[0].fit(df) for p in (1, 2)]
    attr = "avgMetrics" if kind == "cv" else "validationMetrics"
    assert getattr(models[0], attr) == getattr(models[1], attr)
    subs = [m.subModels if kind == "tvs" else [s for fold in m.subModels for s in fold] for m in models]
    assert len(subs[0]) == (4 if kind == "tvs" else 12)
    for a, b in zip(*subs):
        assert np.array_equal(a.w.numpy(), b.w.numpy()) and np.array_equal(a.b.numpy(), b.b.numpy())


def test_fit_multiple_from_threads():
    from concurrent.futures import ThreadPoolExecutor

    lr = LogisticRegression(maxIter=2, device="cpu")
    maps = [{lr.regParam: r} for r in (0.0, 0.1, 0.2, 0.3, 0.4)]
    it = lr.fitMultiple(_frames()[0], maps)

    def drain(_):
        return [i for i, _m in it]

    with ThreadPoolExecutor(max_workers=3) as pool:
        seen = [i for got in pool.map(drain, range(3)) for i in got]
    assert sorted(seen) == [0, 1, 2, 3, 4]


def test_thread_safe_iterator_hands_each_item_out_once():
    from concurrent.futures import ThreadPoolExecutor

    from sparkdl_tpu_torch.pipeline import ThreadSafeIterator

    it = ThreadSafeIterator(iter(range(200)))

    def drain(_):
        return list(it)

    with ThreadPoolExecutor(max_workers=4) as pool:
        seen = [i for got in pool.map(drain, range(4)) for i in got]
    assert sorted(seen) == list(range(200))


def test_validation_refusals():
    df, _ = _frames(n=12)
    with pytest.raises(ValueError, match="numFolds"):
        _pair("cv", numFolds=1)[0].fit(df)
    with pytest.raises(ValueError, match="trainRatio"):
        _pair("tvs", trainRatio=1.5)[0].fit(df)


@pytest.mark.parametrize("kind", ["cv", "tvs"])
def test_save_and_load(tmp_path, kind):
    """The validator (its estimator, evaluator and grid rebound to the
    loaded estimator) and its fitted model (best model, metrics) round
    trip; the loaded validator fits the same model."""
    ours, _ = _pair(kind, parallelism=2)
    ours.save(str(tmp_path / "validator"))
    loaded = persistence.load(str(tmp_path / "validator"), device="cpu")
    assert type(loaded) is type(ours) and loaded.uid == ours.uid
    est = loaded.getEstimator()
    assert est.uid == ours.getEstimator().uid and est._device.type == "cpu"
    assert [{(p.parent, p.name): v for p, v in m.items()} for m in loaded.getEstimatorParamMaps()] == [
        {(p.parent, p.name): v for p, v in m.items()} for m in ours.getEstimatorParamMaps()
    ]
    assert all(p.parent == est.uid and est.hasParam(p.name) for m in loaded.getEstimatorParamMaps() for p in m)
    df, _ = _frames(seed=2)
    fitted, refit = ours.fit(df), loaded.fit(df)
    attr = "avgMetrics" if kind == "cv" else "validationMetrics"
    assert getattr(fitted, attr) == getattr(refit, attr)
    fitted.save(str(tmp_path / "model"))
    back = persistence.load(str(tmp_path / "model"), device="cpu")
    assert isinstance(back, CrossValidatorModel if kind == "cv" else TrainValidationSplitModel)
    assert getattr(back, attr) == getattr(fitted, attr) and back.subModels is None
    assert np.array_equal(back.bestModel.w.numpy(), fitted.bestModel.w.numpy())
    assert [r.prediction for r in back.transform(df).collect()] == [
        r.prediction for r in fitted.transform(df).collect()
    ]
