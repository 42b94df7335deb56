"""``Pipeline`` and ``PipelineModel`` persistence in the port against the
JAX package's, on the CPU.

Both packages save each stage in ``<path>/stages/<i>_<uid>/`` and list
those directories under ``extra.stageDirs``; the saved trees are held
equal file by file and key by key (uids, class paths, timestamps and the
weights' values aside). Round trips hold the loaded stages' params,
uids and predictions equal to the saved ones, a ``CrossValidator`` over a
``Pipeline`` included, and a fitted pipeline of the port predicts what
the JAX package's does from the same weights.
"""

import json
import os

import jax
import numpy as np
import pytest

from sparkdl_tpu import pipeline as jax_pipeline
from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.estimators import LogisticRegression as JaxLogisticRegression
from sparkdl_tpu.estimators import LogisticRegressionModel as JaxLogisticRegressionModel
from sparkdl_tpu.estimators import logistic_regression as jax_lr_module
from sparkdl_tpu.evaluation import MulticlassClassificationEvaluator as JaxMulticlass
from sparkdl_tpu.transformers import DeepImageFeaturizer as JaxDeepImageFeaturizer
from sparkdl_tpu.tuning import CrossValidator as JaxCrossValidator
from sparkdl_tpu.tuning import ParamGridBuilder as JaxParamGridBuilder
from sparkdl_tpu_torch import persistence
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.estimators import LogisticRegression, LogisticRegressionModel
from sparkdl_tpu_torch.evaluation import MulticlassClassificationEvaluator
from sparkdl_tpu_torch.pipeline import Pipeline, PipelineModel
from sparkdl_tpu_torch.transformers.named_image import DeepImageFeaturizer
from sparkdl_tpu_torch.tuning import CrossValidator, CrossValidatorModel, ParamGridBuilder


@pytest.fixture
def one_device_mesh(monkeypatch):
    make_mesh = jax_lr_module.make_mesh
    monkeypatch.setattr(jax_lr_module, "make_mesh", lambda: make_mesh(devices=jax.devices()[:1]))


def _cols(n=80, seed=0):
    rng = np.random.default_rng(seed)
    half = n // 2
    x = np.concatenate([rng.normal(-2, 1, (half, 4)), rng.normal(2, 1, (n - half, 4))]).astype(np.float32)
    return {"features": list(x), "label": [0] * half + [1] * (n - half)}


def _frames(n=80, seed=0):
    cols = _cols(n, seed)
    return DataFrame.fromColumns(cols, numPartitions=2), JaxDataFrame.fromColumns(cols, numPartitions=2)


def _predictions(model, df):
    return [r.prediction for r in model.transform(df).collect()]


def _layout(path, uids):
    """The saved tree with every stage uid replaced by its class name: the
    relative file paths, and each metadata file's keys (nested ``extra``
    and param names included) with its stage directories."""
    out = {}
    for root, _, files in os.walk(path):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), path)
            for uid, tag in uids.items():
                rel = rel.replace(uid, tag)
            if name != "metadata.json":
                out[rel] = None
                continue
            with open(os.path.join(root, name)) as f:
                meta = json.load(f)
            extra = meta.get("extra", {})
            dirs = [d for d in extra.get("stageDirs", [])]
            for uid, tag in uids.items():
                dirs = [d.replace(uid, tag) for d in dirs]
            out[rel] = {
                "keys": sorted(meta),
                "class": meta["class"].rsplit(".", 1)[1],
                "extra": sorted(extra),
                "stageDirs": dirs,
                "paramMap": sorted(meta["paramMap"]),
                "defaultParamMap": sorted(meta["defaultParamMap"]),
            }
    return out


def _uids(*stages):
    return {s.uid: type(s).__name__ for s in stages}


class TestLayout:
    def test_unfitted_pipeline_layout_equals_jax(self, tmp_path):
        ours_lr = LogisticRegression(maxIter=5, regParam=0.01, device="cpu")
        ref_lr = JaxLogisticRegression(maxIter=5, regParam=0.01)
        ours, ref = Pipeline(stages=[ours_lr]), jax_pipeline.Pipeline(stages=[ref_lr])
        ours.save(str(tmp_path / "ours"))
        ref.save(str(tmp_path / "ref"))
        ours_layout = _layout(str(tmp_path / "ours"), _uids(ours, ours_lr))
        assert ours_layout == _layout(str(tmp_path / "ref"), _uids(ref, ref_lr))
        assert ours_layout["metadata.json"]["stageDirs"] == ["stages/0_LogisticRegression"]

    def test_fitted_pipeline_model_layout_equals_jax(self, tmp_path):
        w = np.arange(8, dtype=np.float32).reshape(4, 2) / 10
        b = np.array([0.1, -0.1], np.float32)
        ours_m = LogisticRegressionModel(w, b, featuresCol="features", predictionCol="prediction",
                                         probabilityCol="prob", device="cpu")
        ref_m = JaxLogisticRegressionModel(w, b, featuresCol="features", predictionCol="prediction",
                                           probabilityCol="prob")
        ours, ref = PipelineModel([ours_m]), jax_pipeline.PipelineModel([ref_m])
        ours.save(str(tmp_path / "ours"))
        ref.save(str(tmp_path / "ref"))
        assert _layout(str(tmp_path / "ours"), _uids(ours, ours_m)) == _layout(
            str(tmp_path / "ref"), _uids(ref, ref_m)
        )
        # each package reads the weights the other wrote under the same name
        sub = lambda p, m: os.path.join(p, "stages", f"0_{m.uid}", "model.npz")  # noqa: E731
        with np.load(sub(str(tmp_path / "ours"), ours_m)) as a, np.load(sub(str(tmp_path / "ref"), ref_m)) as r:
            assert sorted(a.files) == sorted(r.files)
            for k in a.files:
                assert np.array_equal(a[k], r[k]), k
        df, jdf = _frames()
        loaded = PipelineModel.load(str(tmp_path / "ours"), device="cpu")
        assert _predictions(loaded, df) == _predictions(ref, jdf)


class TestRoundTrip:
    def test_unfitted_pipeline(self, tmp_path):
        lr = LogisticRegression(maxIter=5, device="cpu")
        Pipeline(stages=[lr]).save(str(tmp_path / "pipe"))
        loaded = Pipeline.load(str(tmp_path / "pipe"), device="cpu")
        (stage,) = loaded.getStages()
        assert isinstance(stage, LogisticRegression) and stage.uid == lr.uid
        assert stage.getOrDefault("maxIter") == 5 and stage._device.type == "cpu"
        df, _ = _frames(60)
        assert _predictions(loaded.fit(df), df) == _predictions(Pipeline(stages=[lr]).fit(df), df)

    def test_fitted_pipeline_model_predicts_the_same(self, tmp_path, one_device_mesh):
        df, jdf = _frames()
        pm = Pipeline(stages=[LogisticRegression(maxIter=20, device="cpu")]).fit(df)
        pm.save(str(tmp_path / "pm"))
        loaded = persistence.load(str(tmp_path / "pm"), device="cpu")
        assert isinstance(loaded, PipelineModel)
        assert np.array_equal(loaded.stages[0].w.numpy(), pm.stages[0].w.numpy())
        assert _predictions(loaded, df) == _predictions(pm, df)
        # the JAX package's fit of the same pipeline predicts the same rows
        ref = jax_pipeline.Pipeline(stages=[JaxLogisticRegression(maxIter=20)]).fit(jdf)
        assert _predictions(loaded, df) == _predictions(ref, jdf)

    def test_featurizer_stage_round_trips(self, tmp_path):
        feat = DeepImageFeaturizer(inputCol="image", outputCol="features", modelName="ResNet50",
                                   computeDtype="float32", batchSize=8, device="cpu")
        pm = PipelineModel([feat, LogisticRegressionModel(np.zeros((2048, 2), np.float32),
                                                          np.zeros(2, np.float32), "features",
                                                          "prediction", None, device="cpu")])
        pm.save(str(tmp_path / "pm"))
        loaded = PipelineModel.load(str(tmp_path / "pm"), device="cpu")
        lf = loaded.stages[0]
        assert isinstance(lf, DeepImageFeaturizer) and lf.uid == feat.uid and lf._device.type == "cpu"
        assert lf.extractParamMap() == {lf.getParam(p.name): v for p, v in feat.extractParamMap().items()}
        ref = JaxDeepImageFeaturizer(inputCol="image", outputCol="features", modelName="ResNet50",
                                     computeDtype="float32", batchSize=8)
        ref.save(str(tmp_path / "ref"))
        assert _layout(str(tmp_path / "ref"), _uids(ref)) == _layout(
            os.path.join(str(tmp_path / "pm"), "stages", f"0_{feat.uid}"), _uids(feat)
        )


class TestTuning:
    def test_cross_validator_over_pipeline(self, tmp_path):
        df, _ = _frames(60)
        lr = LogisticRegression(maxIter=5, device="cpu")
        pipe = Pipeline(stages=[lr])
        cv = CrossValidator(estimator=pipe, estimatorParamMaps=ParamGridBuilder().addGrid(lr.maxIter, [2, 4]).build(),
                            evaluator=MulticlassClassificationEvaluator(), numFolds=2)
        model = cv.fit(df)
        cv.save(str(tmp_path / "cv"))
        loaded = CrossValidator.load(str(tmp_path / "cv"), device="cpu")
        inner = loaded.getEstimator().getStages()[0]
        assert [pm[inner.getParam("maxIter")] for pm in loaded.getEstimatorParamMaps()] == [2, 4]
        assert loaded.fit(df).avgMetrics == model.avgMetrics
        model.save(str(tmp_path / "cvm"))
        back = CrossValidatorModel.load(str(tmp_path / "cvm"), device="cpu")
        assert isinstance(back.bestModel, PipelineModel) and back.avgMetrics == model.avgMetrics
        assert _predictions(back, df) == _predictions(model, df)

    def test_cross_validator_over_pipeline_layout_equals_jax(self, tmp_path):
        lr, jlr = LogisticRegression(device="cpu"), JaxLogisticRegression()
        pipe, jpipe = Pipeline(stages=[lr]), jax_pipeline.Pipeline(stages=[jlr])
        ours = CrossValidator(estimator=pipe, estimatorParamMaps=ParamGridBuilder().addGrid(lr.maxIter, [2, 4]).build(),
                              evaluator=MulticlassClassificationEvaluator(), numFolds=2)
        ref = JaxCrossValidator(estimator=jpipe,
                                estimatorParamMaps=JaxParamGridBuilder().addGrid(jlr.maxIter, [2, 4]).build(),
                                evaluator=JaxMulticlass(), numFolds=2)
        ours.save(str(tmp_path / "ours"))
        ref.save(str(tmp_path / "ref"))
        ours_uids = _uids(ours, pipe, lr, ours.getEvaluator())
        ref_uids = _uids(ref, jpipe, jlr, ref.getEvaluator())
        assert _layout(str(tmp_path / "ours"), ours_uids) == _layout(str(tmp_path / "ref"), ref_uids)
