"""The port's image-struct training feed, its evaluators and stage
persistence, against the JAX package's, on the CPU.

- ``DataParallelEstimator`` over an image-struct column
  (``targetHeight``/``targetWidth``): the structs decode to uint8 NHWC on
  the host and are cast to float32 inside the step, as in the JAX package.
  A small ResNet (``stage_sizes`` [1, 1, 1, 1], 32x32, 10 classes) with the
  same weights in both packages, SGD: the history, and every trained
  parameter tensor, BatchNorm statistics included, within 1e-5 plus 1e-4
  of the tensor's own largest move in training (unnormalized 0-255 pixels
  give gradients of about 1e3 to the BatchNorm variances, which move from
  1 to as far as 500 in two steps; float32's summation order is then a
  few 1e-5 of the move). 32 rows and a global batch of 16: every shard of
  the JAX package's ``dp=8`` is full.
- the uint8 feed equals the float feed of the same pixels;
- the trained model scores image structs as the JAX package's does;
- the three evaluators give the JAX package's numbers;
- a stage saved and loaded keeps its Params, uid and weights, and a class
  path outside the port is refused.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparkdl_tpu import evaluation as jax_evaluation
from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.estimators import DataParallelEstimator as JaxEstimator
from sparkdl_tpu.graph.ingest import ModelIngest
from sparkdl_tpu.image import imageIO as jax_imageIO
from sparkdl_tpu.models import resnet as jax_resnet
from sparkdl_tpu_torch import evaluation, persistence
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.estimators import DataParallelEstimator, LogisticRegressionModel
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.models.convert import cnn_params_to_flax
from sparkdl_tpu_torch.models.layers import init_cnn_params
from sparkdl_tpu_torch.models.resnet import ResNet

SIDE = 32
ROWS = 32
BATCH = 16
LR = 0.01
ATOL = 1e-5
#: of each tensor's largest move in training
MOVE_REL = 1e-4


def _port_resnet():
    module = ResNet([1, 1, 1, 1], num_classes=10)
    init_cnn_params(module, torch.Generator().manual_seed(0))
    return ModelFunction.from_module(module, input_shape=(SIDE, SIDE, 3), device="cpu")


def _pixels(seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.integers(0, 256, size=(SIDE, SIDE, 3)).astype(np.uint8) for _ in range(ROWS)]
    labels = [int(v) for v in rng.integers(0, 10, size=ROWS)]
    return arrays, labels


def _flat(tree, prefix=""):
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def image_fits():
    arrays, labels = _pixels()
    mf = _port_resnet()
    variables = jax.tree_util.tree_map(jnp.asarray, cnn_params_to_flax(mf.module))
    jax_mf = ModelIngest.from_flax(
        jax_resnet.ResNet(stage_sizes=[1, 1, 1, 1], num_classes=10), variables,
        input_shape=(SIDE, SIDE, 3),
    )
    common = dict(inputCol="image", labelCol="label", outputCol="logits", batchSize=BATCH,
                  epochs=1, targetHeight=SIDE, targetWidth=SIDE)
    jax_df = JaxDataFrame.fromColumns(
        {"image": [jax_imageIO.imageArrayToStruct(a) for a in arrays], "label": labels}, numPartitions=4
    )
    df = DataFrame.fromColumns(
        {"image": [imageIO.imageArrayToStruct(a) for a in arrays], "label": labels}, numPartitions=4
    )
    ref = JaxEstimator(model=jax_mf, optimizer=optax.sgd(LR), **common).fit(jax_df)
    ours = DataParallelEstimator(
        model=mf, optimizer=functools.partial(torch.optim.SGD, lr=LR), device="cpu", **common
    ).fit(df)
    return jax_df, df, ref, ours, _flat(jax.tree_util.tree_map(np.asarray, variables))


def test_image_struct_fit_matches_jax(image_fits):
    _, _, ref, ours, initial = image_fits
    assert [h["steps"] for h in ours.history] == [h["steps"] for h in ref.history] == [ROWS // BATCH]
    np.testing.assert_allclose([h["loss"] for h in ours.history], [h["loss"] for h in ref.history], rtol=1e-5)
    want = _flat(jax.tree_util.tree_map(np.asarray, ref.modelFunction.params))
    got = _flat(cnn_params_to_flax(ours.modelFunction.module))
    assert sorted(got) == sorted(want) and any(k.startswith("batch_stats") for k in got)
    for k, v in want.items():
        move = np.abs(v - initial[k]).max()
        assert np.abs(got[k] - v).max() <= ATOL + MOVE_REL * move, k


def test_trained_image_model_scores_structs_as_jax_does(image_fits):
    jax_df, df, ref, ours, _ = image_fits
    ref_rows = np.stack([r.logits for r in ref.transform(jax_df).collect()])
    rows = np.stack([r.logits for r in ours.transform(df).collect()])
    assert rows.shape == (ROWS, 10)
    np.testing.assert_allclose(rows, ref_rows, rtol=1e-5, atol=1e-5)


def test_uint8_image_feed_matches_the_float_tensor_feed():
    arrays, labels = _pixels(seed=1)
    structs = DataFrame.fromColumns(
        {"image": [imageIO.imageArrayToStruct(a) for a in arrays], "label": labels}, numPartitions=2
    )
    floats = DataFrame.fromColumns(
        {"features": [a.astype(np.float32) for a in arrays], "label": labels}, numPartitions=2
    )

    def fit(df, **cols):
        return DataParallelEstimator(
            model=_port_resnet(), labelCol="label", outputCol="logits", batchSize=8,
            epochs=2, stepSize=1e-3, device="cpu", **cols,
        ).fit(df)

    a = fit(structs, inputCol="image", targetHeight=SIDE, targetWidth=SIDE)
    b = fit(floats, inputCol="features")
    np.testing.assert_allclose([h["loss"] for h in a.history], [h["loss"] for h in b.history], rtol=1e-6)


def _eval_frames():
    rng = np.random.default_rng(7)
    labels = [int(v) for v in rng.integers(0, 3, 40)]
    preds = [float(v) for v in rng.integers(0, 3, 40)]
    binary = [int(v) for v in rng.integers(0, 2, 40)]
    scores = [np.asarray([1 - p, p]) for p in rng.random(40)]
    reg = [float(v) for v in rng.normal(size=40)]
    cols = {"label": labels, "prediction": preds, "bin": binary, "probability": scores, "value": reg}
    return JaxDataFrame.fromColumns(cols, numPartitions=3), DataFrame.fromColumns(cols, numPartitions=3)


@pytest.mark.parametrize("cls,kwargs", [
    ("MulticlassClassificationEvaluator", {"metricName": "accuracy"}),
    ("MulticlassClassificationEvaluator", {"metricName": "f1"}),
    ("MulticlassClassificationEvaluator", {"metricName": "weightedPrecision"}),
    ("MulticlassClassificationEvaluator", {"metricName": "weightedRecall"}),
    ("BinaryClassificationEvaluator", {"labelCol": "bin", "metricName": "areaUnderROC"}),
    ("BinaryClassificationEvaluator", {"labelCol": "bin", "metricName": "areaUnderPR"}),
    ("RegressionEvaluator", {"predictionCol": "value", "metricName": "rmse"}),
    ("RegressionEvaluator", {"predictionCol": "value", "metricName": "r2"}),
])
def test_evaluators_match_jax(cls, kwargs):
    jax_df, df = _eval_frames()
    ref = getattr(jax_evaluation, cls)(**kwargs)
    ours = getattr(evaluation, cls)(**kwargs)
    assert ours.evaluate(df) == ref.evaluate(jax_df)
    assert ours.isLargerBetter() == ref.isLargerBetter()


def test_stage_save_and_load_round_trip(tmp_path):
    est = DataParallelEstimator(inputCol="image", epochs=3, stepSize=0.05, targetHeight=SIDE,
                                targetWidth=SIDE, meshAxes={"dp": -1}, device="cpu")
    est.save(str(tmp_path / "est"))
    back = persistence.load(str(tmp_path / "est"))
    assert type(back) is DataParallelEstimator and back.uid == est.uid
    for name in ("epochs", "stepSize", "targetHeight", "meshAxes", "batchSize", "shuffleBufferRows"):
        assert back.getOrDefault(name) == est.getOrDefault(name)
    assert back.model is None
    # callables are code, not Params: saving them is refused
    est.model = _port_resnet()
    with pytest.raises(ValueError, match="cannot persist"):
        est.save(str(tmp_path / "est2"))
    # a fitted stage with tensors loads onto the device it is given
    lr = LogisticRegressionModel(np.ones((3, 2)), np.zeros(2), "f", "p", None, device="cpu")
    lr.save(str(tmp_path / "lr"))
    loaded = LogisticRegressionModel.load(str(tmp_path / "lr"), device="cpu")
    np.testing.assert_array_equal(loaded.w.numpy(), np.ones((3, 2), np.float32))
    with pytest.raises(TypeError, match="expected DataParallelEstimator"):
        DataParallelEstimator.load(str(tmp_path / "lr"))
    with pytest.raises(FileExistsError):
        lr.save(str(tmp_path / "lr"))
    meta = persistence.read_metadata(str(tmp_path / "lr"))
    meta["class"] = "sparkdl_tpu.estimators.LogisticRegressionModel"
    with pytest.raises(ValueError, match="only instantiates sparkdl_tpu_torch"):
        persistence._locate(meta["class"])
