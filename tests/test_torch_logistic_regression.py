"""The port's LogisticRegression against the JAX package's, and the image
main path (DeepImageFeaturizer -> LogisticRegression) through the port's
Pipeline.

The JAX package fits over a device mesh: each step takes the mean of
per-shard masked means (``pmean``). On the tests' 8-device CPU mesh that
equals the port's one-device mean over the batch only when every batch
holds a multiple of 8 rows (64 rows at batch 16 agree; at batch 15 the
fits part by 0.07 in ``w``). The 8-device mesh cannot be used here all the
same: under CPU load XLA's CPU all-reduce rendezvous can wait for device
threads that never arrive and aborts the process after 40 s. So the
parity fit gives the JAX package a one-device mesh, where its step is the
port's arithmetic at any batch size, and runs at 64 rows in batches of 16
and of 15. Tolerances: ``w`` and ``b`` at atol 1e-5 after 100 epochs of
Adam (both run in f32 and sum in another order; the measured gap is at
most 3.1e-6), probabilities at atol 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.estimators import logistic_regression as jax_lr_module
from sparkdl_tpu.estimators import LogisticRegression as JaxLogisticRegression
from sparkdl_tpu.estimators.logistic_regression import (
    LogisticRegressionModel as JaxLogisticRegressionModel,
)
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.estimators import LogisticRegression, LogisticRegressionModel
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.pipeline import Pipeline, PipelineModel
from sparkdl_tpu_torch.transformers.named_image import DeepImageFeaturizer

W_ATOL = 1e-5
PROB_ATOL = 1e-6


def _blobs(n_per=20, k=3, d=6, seed=0):
    """k Gaussian blobs; ``n_per * k`` rows in total."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 2.0, size=(k, d))
    feats, labels = [], []
    for i in range(n_per * k):
        c = i % k
        feats.append((centres[c] + rng.normal(size=d)).astype(np.float32))
        labels.append(c)
    return {"features": feats, "label": labels}


def _parity_data():
    cols = _blobs(n_per=22, k=3)  # 66 rows; two of them null
    cols["features"][5] = None
    cols["label"][9] = None
    return cols  # 64 usable rows


@pytest.fixture
def one_device_mesh(monkeypatch):
    make_mesh = jax_lr_module.make_mesh
    monkeypatch.setattr(
        jax_lr_module, "make_mesh", lambda: make_mesh(devices=jax.devices()[:1])
    )


@pytest.mark.parametrize("batch", [16, 15])
@pytest.mark.parametrize("reg", [1e-4, 0.05])
def test_fit_matches_jax(reg, batch, one_device_mesh):
    cols = _parity_data()
    kwargs = dict(batchSize=batch, regParam=reg, stepSize=0.05, seed=3)
    ours = LogisticRegression(device="cpu", **kwargs).fit(
        DataFrame.fromColumns(cols, numPartitions=3)
    )
    ref = JaxLogisticRegression(**kwargs).fit(
        JaxDataFrame.fromColumns(cols, numPartitions=3)
    )
    assert ours.w.shape == (6, 3) and ours.numClasses == ref.numClasses == 3
    np.testing.assert_allclose(ours.w.numpy(), np.asarray(ref.w), rtol=0, atol=W_ATOL)
    np.testing.assert_allclose(ours.b.numpy(), np.asarray(ref.b), rtol=0, atol=W_ATOL)


def test_transform_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    b = rng.normal(size=4).astype(np.float32)
    cols = _blobs(n_per=100, k=3)  # 300 rows: a 256-row batch and a tail
    cols["features"][7] = None
    cols["features"][280] = None
    ours = LogisticRegressionModel(w, b, "features", "pred", "prob", device="cpu")
    ref = JaxLogisticRegressionModel(w, b, "features", "pred", "prob")
    got = ours.transform(DataFrame.fromColumns(cols, numPartitions=2)).collect()
    want = ref.transform(JaxDataFrame.fromColumns(cols, numPartitions=2)).collect()
    assert list(got[0]) == ["features", "label", "pred", "prob"]
    assert [r.pred for r in got] == [r.pred for r in want]
    assert got[7].pred is None and got[7].prob is None
    for g, h in zip(got, want):
        if h.prob is not None:
            np.testing.assert_allclose(g.prob, np.asarray(h.prob), rtol=0, atol=PROB_ATOL)
            assert abs(float(g.prob.sum()) - 1.0) < 1e-5
    no_prob = LogisticRegressionModel(w, b, "features", "pred", None, device="cpu")
    assert no_prob.transform(DataFrame.fromColumns(cols)).columns == [
        "features", "label", "pred"
    ]


def test_params_follow_the_jax_package():
    ours, ref = LogisticRegression(device="cpu"), JaxLogisticRegression()
    for name in ("featuresCol", "labelCol", "predictionCol", "maxIter", "stepSize",
                 "regParam", "batchSize", "seed"):
        assert ours.getOrDefault(name) == ref.getOrDefault(name)
    assert not ours.isDefined("probabilityCol") and not ours.isDefined("numClasses")
    with pytest.raises(TypeError):
        LogisticRegression(maxIter="many")
    df = DataFrame.fromColumns(_blobs(n_per=8, k=2), numPartitions=2)
    lr = LogisticRegression(maxIter=1, stepSize=0.1, device="cpu")
    # the override (30 epochs) must apply; the stage itself is unchanged
    model = lr.fit(df, params={lr.maxIter: 30, lr.numClasses: 3})
    assert lr.getOrDefault("maxIter") == 1 and model.numClasses == 3
    acc = np.mean([r.prediction == r.label for r in model.transform(df).collect()])
    assert acc > 0.9


def test_model_save_and_load_extra(tmp_path):
    rng = np.random.default_rng(2)
    w, b = rng.normal(size=(5, 2)), rng.normal(size=2)
    model = LogisticRegressionModel(w, b, "f", "p", "q", device="cpu")
    meta = {"extra": model._save_extra(str(tmp_path))}
    other = LogisticRegressionModel(np.zeros((1, 1)), np.zeros(1), "x", "y", None,
                                    device="cpu")
    other._load_extra(str(tmp_path), meta)
    torch.testing.assert_close(other.w, torch.tensor(w, dtype=torch.float32))
    torch.testing.assert_close(other.b, torch.tensor(b, dtype=torch.float32))
    assert (other._features_col, other._prediction_col, other._probability_col) == (
        "f", "p", "q"
    )


def _colour_images(n, seed):
    """Two colour classes of 40x40 BGR images with per-pixel noise:
    class 0 reddish, class 1 bluish."""
    rng = np.random.default_rng(seed)
    structs, labels = [], []
    for i in range(n):
        label = i % 2
        bgr = np.array([40, 60, 200] if label == 0 else [200, 80, 40], np.int16)
        arr = np.clip(bgr + rng.integers(-40, 41, size=(40, 40, 3)), 0, 255)
        structs.append(imageIO.imageArrayToStruct(arr.astype(np.uint8)))
        labels.append(label)
    return structs, labels


def test_featurizer_then_logistic_regression_pipeline():
    """The image main path on the port: ResNet50 at 224x224 (random
    weights, host resize from 40x40), f32, into LogisticRegression, fitted
    by Pipeline on one split and applied to the other."""
    structs, labels = _colour_images(24, seed=4)
    structs[3] = None  # a null image gives a null feature row, skipped by fit
    df = DataFrame.fromColumns({"image": structs, "label": labels}, numPartitions=2)
    train, test = df.randomSplit([0.5, 0.5], seed=1)
    pipe = Pipeline(stages=[
        DeepImageFeaturizer(inputCol="image", outputCol="features", modelName="ResNet50",
                            computeDtype="float32", batchSize=8, device="cpu"),
        LogisticRegression(maxIter=30, stepSize=0.05, probabilityCol="prob",
                           device="cpu"),
    ])
    model = pipe.fit(train)
    assert isinstance(model, PipelineModel) and len(model.stages) == 2
    rows = model.transform(test).collect()
    assert list(rows[0]) == ["image", "label", "features", "prediction", "prob"]
    scored = [r for r in rows if r.image is not None]
    assert all(r.features.shape == (2048,) for r in scored)
    assert all(r.prediction is None for r in rows if r.image is None)
    acc = np.mean([r.prediction == r.label for r in scored])
    assert acc >= 0.9, acc
