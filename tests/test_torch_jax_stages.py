"""Stages saved by the JAX package load in the port
(``sparkdl_tpu_torch/persistence.py``), on the CPU.

- Every persistable class of the JAX package is saved by the JAX package,
  loaded by ``sparkdl_tpu_torch.persistence.load`` as the port's class of
  the same name with the same uid and params, and used: fitted models
  score as the JAX stage scores, estimators fit, stages without a
  persisted model score once the port's model is set.
- ``tests/fixtures/jax_stages`` (what ``chip_smoke.py`` phase 23 loads on
  a machine without JAX) is rebuilt here by
  ``tests/fixtures/make_jax_stage_fixtures.py`` and equals the committed
  files: each ``model.npz`` member byte for byte, each ``metadata.json``
  apart from its timestamp, and the embedded ``model.keras``'s config and
  weights. Its ResNet50 + LR pipeline, with a ``weightsFile`` written
  here, gives the JAX package's rows (f32, relative 1e-5).
- A JAX class with no counterpart in the port, and any class outside the
  two packages, is refused with a ``ValueError`` naming it; the port
  imports nothing of the JAX package to map them.
- The param values are spelled alike in both packages: the test lists
  every enumerated param of the persistable classes and holds its
  choices equal.
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

from sparkdl_tpu import persistence as jax_persistence
from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.estimators import data_parallel_estimator as jdpe
from sparkdl_tpu.estimators import image_file_estimator as jife
from sparkdl_tpu.estimators import logistic_regression as jlr
from sparkdl_tpu import evaluation as jev
from sparkdl_tpu import pipeline as jpipe
from sparkdl_tpu import tuning as jtune
from sparkdl_tpu.graph.ingest import ModelIngest as JaxModelIngest
from sparkdl_tpu.image import imageIO as jax_imageIO
from sparkdl_tpu.transformers import image_model as jim
from sparkdl_tpu.transformers import named_image as jni
from sparkdl_tpu.transformers import tensor as jts
from sparkdl_tpu.transformers import text as jtx
from sparkdl_tpu_torch import persistence
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.graph.ingest import ModelIngest
from sparkdl_tpu_torch.graph.keras_file import read_keras_file
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.models import get_image_model
from sparkdl_tpu_torch.models.convert import cnn_params_to_flax
from sparkdl_tpu_torch.models.registry import save_flax_weights
from sparkdl_tpu_torch.pipeline import PipelineModel

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures")
JAX_STAGES = os.path.join(FIXTURES, "jax_stages")
REL = 1e-5


def _save_jax(stage, tmp_path, name="stage"):
    path = str(tmp_path / name)
    stage.save(path)
    return path


def _params(stage) -> dict:
    return {p.name: stage.getOrDefault(p) for p in stage.params if stage.isDefined(p)
            and _jsonable(stage.getOrDefault(p))}


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


def _load(path):
    return persistence.load(path, device="cpu")


def _features(rng, n=6, d=4):
    return [rng.normal(size=d).astype(np.float32) for _ in range(n)]


# -- every persistable class ----------------------------------------------------


def _lr_model():
    rng = np.random.default_rng(3)
    return jlr.LogisticRegressionModel(rng.normal(size=(4, 3)).astype(np.float32),
                                       rng.normal(size=3).astype(np.float32),
                                       featuresCol="f", predictionCol="p", probabilityCol="prob")


def _use_lr_model(ours, ref, tmp_path):
    np.testing.assert_array_equal(ours.w.numpy(), np.asarray(ref.w))
    np.testing.assert_array_equal(ours.b.numpy(), np.asarray(ref.b))
    feats = _features(np.random.default_rng(4))
    got = ours.transform(DataFrame.fromColumns({"f": feats}, numPartitions=2)).collect()
    want = ref.transform(JaxDataFrame.fromColumns({"f": feats}, numPartitions=2)).collect()
    assert [r.p for r in got] == [int(r.p) for r in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.prob, np.asarray(b.prob), rtol=REL, atol=1e-7)


def _fit_frame():
    rng = np.random.default_rng(5)
    feats = _features(rng, 24)
    return DataFrame.fromColumns({"features": feats, "label": [int(f[0] > 0) for f in feats]}, numPartitions=2)


def _use_estimator(ours, ref, tmp_path):
    model = ours.fit(_fit_frame())
    assert model.transform(_fit_frame()).count() == 24


def _use_pipeline(ours, ref, tmp_path):
    assert [type(s).__name__ for s in ours.getStages()] == [type(s).__name__ for s in ref.getStages()]
    assert [s.uid for s in ours.getStages()] == [s.uid for s in ref.getStages()]
    _use_estimator(ours, ref, tmp_path)


def _use_pipeline_model(ours, ref, tmp_path):
    assert [s.uid for s in ours.stages] == [s.uid for s in ref.stages]
    _use_lr_model(ours.stages[0], ref.stages[0], tmp_path)


def _use_evaluator(ours, ref, tmp_path):
    labels = [0.0, 1.0, 1.0, 0.0, 1.0, 2.0]
    preds = [0.0, 1.0, 0.0, 0.0, 1.0, 2.0]
    cols = {"label": labels, "prediction": preds, "probability": [0.1, 0.9, 0.4, 0.2, 0.8, 0.7]}
    if ours.getOrDefault("metricName") in ("areaUnderROC", "areaUnderPR"):
        cols["label"] = [min(x, 1.0) for x in labels]
    assert ours.evaluate(DataFrame.fromColumns(cols)) == ref.evaluate(JaxDataFrame.fromColumns(cols))


def _use_validator(ours, ref, tmp_path):
    assert type(ours.getEstimator()).__name__ == type(ref.getEstimator()).__name__
    assert ours.getEstimator().uid == ref.getEstimator().uid
    grid = [{p.name: v for p, v in pm.items()} for pm in ours.getEstimatorParamMaps()]
    assert grid == [{p.name: v for p, v in pm.items()} for pm in ref.getEstimatorParamMaps()]
    for pm in ours.getEstimatorParamMaps():
        assert all(p.parent == ours.getEstimator().uid for p in pm)  # rebound by uid
    best = ours.fit(_fit_frame()).bestModel
    assert best.transform(_fit_frame()).count() == 24


def _use_validator_model(ours, ref, tmp_path):
    for name in ("avgMetrics", "validationMetrics"):
        if hasattr(ref, name):
            assert getattr(ours, name) == getattr(ref, name)
    _use_lr_model(ours.bestModel, ref.bestModel, tmp_path)


def _use_params_only(ours, ref, tmp_path):
    """A stage whose model is code (not persisted, in either package)
    scores once the port's model is set."""
    if type(ours).__name__ == "TextEmbedder":
        from sparkdl_tpu_torch.models import get_model

        ours._set(modelFunction=get_model("bert-tiny").model_function(device="cpu"))
        out = ours.transform(DataFrame.fromColumns({"t": ["a b c", None, "d"]})).collect()
        assert [r.o is None for r in out] == [False, True, False]
        return
    if type(ours).__name__ in ("ModelTransformer", "TFTransformer"):
        ours._set(modelFunction=ModelIngest.from_callable(lambda x: x * 2, device="cpu"))
        out = ours.transform(DataFrame.fromColumns({"a": [np.ones(3, np.float32)]})).collect()
        np.testing.assert_array_equal(out[0].o, np.full(3, 2.0, np.float32))
        return
    if type(ours).__name__ in ("ImageModelTransformer", "TFImageTransformer"):
        identity = ModelFunction(lambda m, x: x, torch.nn.Module(), torch.device("cpu"), input_shape=(8, 8, 3))
        ours._set(modelFunction=identity, targetHeight=8, targetWidth=8)
        arr = np.arange(8 * 8 * 3, dtype=np.uint8).reshape(8, 8, 3)
        out = ours.transform(DataFrame.fromColumns({"image": [imageIO.imageArrayToStruct(arr), None]})).collect()
        assert out[0].o is not None and out[1].o is None
        return
    assert type(ours).__name__ in ("DataParallelEstimator", "HorovodEstimator", "ImageFileEstimator",
                                   "KerasImageFileEstimator", "KerasTransformer")
    assert getattr(ours, "model", None) is None


def _use_predictor(ours, ref, tmp_path):
    assert ours.getOrDefault("modelName") == "MobileNetV2" and ours.getOrDefault("topK") == 3


#: class -> (the JAX stage, a check of the port's loaded stage against it)
PERSISTABLE = {
    "LogisticRegressionModel": (_lr_model, _use_lr_model),
    "LogisticRegression": (lambda: jlr.LogisticRegression(maxIter=7, regParam=0.01, stepSize=0.5, batchSize=8,
                                                         seed=3), _use_estimator),
    "Pipeline": (lambda: jpipe.Pipeline(stages=[jlr.LogisticRegression(maxIter=5)]), _use_pipeline),
    "PipelineModel": (lambda: jpipe.PipelineModel([_lr_model()]), _use_pipeline_model),
    "MulticlassClassificationEvaluator": (lambda: jev.MulticlassClassificationEvaluator(metricName="f1"),
                                          _use_evaluator),
    "BinaryClassificationEvaluator": (lambda: jev.BinaryClassificationEvaluator(), _use_evaluator),
    "RegressionEvaluator": (lambda: jev.RegressionEvaluator(metricName="mae"), _use_evaluator),
    "CrossValidator": (lambda: _validator(jtune.CrossValidator, numFolds=2, parallelism=2), _use_validator),
    "TrainValidationSplit": (lambda: _validator(jtune.TrainValidationSplit, trainRatio=0.5), _use_validator),
    "CrossValidatorModel": (lambda: jtune.CrossValidatorModel(_lr_model(), [0.5, 0.75]), _use_validator_model),
    "TrainValidationSplitModel": (lambda: jtune.TrainValidationSplitModel(_lr_model(), [0.25]),
                                  _use_validator_model),
    "DataParallelEstimator": (lambda: jdpe.DataParallelEstimator(inputCol="x", labelCol="y", epochs=3,
                                                                 stepSize=0.05), _use_params_only),
    "HorovodEstimator": (lambda: jdpe.HorovodEstimator(inputCol="x", labelCol="y", batchSize=16), _use_params_only),
    "ImageFileEstimator": (lambda: jife.ImageFileEstimator(
        inputCol="u", outputCol="o", labelCol="l", modelFile="m.keras", kerasOptimizer="adam",
        kerasLoss="categorical_crossentropy", kerasFitParams={"epochs": 2}), _use_params_only),
    "KerasImageFileEstimator": (lambda: jife.KerasImageFileEstimator(
        inputCol="u", outputCol="o", labelCol="l", modelFile="m.keras"), _use_params_only),
    "ImageModelTransformer": (lambda: jim.ImageModelTransformer(inputCol="image", outputCol="o",
                                                                channelOrder="RGB", batchSize=2), _use_params_only),
    "TFImageTransformer": (lambda: jim.TFImageTransformer(inputCol="image", outputCol="o", outputMode="vector"),
                           _use_params_only),
    "ModelTransformer": (lambda: jts.ModelTransformer(inputCol="a", outputCol="o", batchSize=3), _use_params_only),
    "TFTransformer": (lambda: jts.TFTransformer(inputCol="a", outputCol="o", flattenOutput=True), _use_params_only),
    "KerasTransformer": (lambda: jts.KerasTransformer(inputCol="a", outputCol="o", inputDtype="float32"),
                         _use_params_only),
    "TextEmbedder": (lambda: jtx.TextEmbedder(inputCol="t", outputCol="o", maxLength=16, batchSize=2),
                     _use_params_only),
    "DeepImagePredictor": (lambda: jni.DeepImagePredictor(inputCol="image", outputCol="o", modelName="MobileNetV2",
                                                          decodePredictions=True, topK=3), _use_predictor),
}


def _validator(cls, **kw):
    lr = jlr.LogisticRegression(maxIter=5)
    grid = jtune.ParamGridBuilder().addGrid(lr.regParam, [0.0, 0.1]).build()
    return cls(estimator=lr, estimatorParamMaps=grid, evaluator=jev.MulticlassClassificationEvaluator(), **kw)


@pytest.mark.parametrize("name", list(PERSISTABLE))
def test_a_jax_saved_stage_loads_and_is_used(name, tmp_path):
    build, use = PERSISTABLE[name]
    ref = build()
    path = _save_jax(ref, tmp_path)
    assert persistence.read_metadata(path)["class"].startswith("sparkdl_tpu.")
    ours = _load(path)
    # HorovodEstimator, KerasImageFileEstimator, TFImageTransformer and
    # TFTransformer are aliases: the JAX package saves the class they name
    assert type(ours).__name__ == type(ref).__name__
    assert type(ours).__module__ == type(ref).__module__.replace("sparkdl_tpu", "sparkdl_tpu_torch", 1)
    assert ours.uid == ref.uid
    assert _params(ours) == _params(ref)
    use(ours, ref, tmp_path)


def test_the_persistable_list_is_every_jax_stage_class():
    """Every JAX Transformer/Estimator/Evaluator class that saves is
    listed above (DataParallelModel holds a ModelFunction and refuses to
    save, in the JAX package, and KerasImageFileTransformer has its own
    tests)."""
    import inspect

    from sparkdl_tpu import estimators, evaluation, pipeline, transformers, tuning
    from sparkdl_tpu.params.base import Params

    found = set()
    for mod in (estimators, evaluation, pipeline, transformers, tuning):
        for name, cls in vars(mod).items():
            if inspect.isclass(cls) and issubclass(cls, Params) and hasattr(cls, "save") \
                    and not name.startswith(("_", "Has")) and cls.__module__.startswith("sparkdl_tpu."):
                found.add(name)
    abstract = {"Transformer", "Estimator", "Model", "Evaluator", "Params"}
    assert found - abstract - set(PERSISTABLE) <= {"DataParallelModel", "KerasImageFileTransformer",
                                                     "DeepImageFeaturizer"}


ENUMERATED = [
    ("transformers.named_image", "DeepImageFeaturizer", "computeDtype"),
    ("transformers.named_image", "DeepImagePredictor", "computeDtype"),
    ("transformers.image_model", "ImageModelTransformer", "channelOrder"),
    ("transformers.image_model", "ImageModelTransformer", "outputMode"),
    ("transformers.image_model", "ImageModelTransformer", "preprocessing"),
    ("transformers.keras_image", "KerasImageFileTransformer", "preprocessing"),
    ("evaluation", "MulticlassClassificationEvaluator", "metricName"),
    ("evaluation", "BinaryClassificationEvaluator", "metricName"),
    ("evaluation", "RegressionEvaluator", "metricName"),
]


@pytest.mark.parametrize("module, cls, param", ENUMERATED, ids=[f"{c}.{p}" for _, c, p in ENUMERATED])
def test_enumerated_param_values_are_spelled_alike(module, cls, param):
    """No value needs mapping at load: each package accepts the other's
    spellings and refuses the same others. ``device``, the one setting
    only the port has, is ``load``'s argument, not a saved param."""
    import importlib

    ours = getattr(importlib.import_module(f"sparkdl_tpu_torch.{module}"), cls)
    ref = getattr(importlib.import_module(f"sparkdl_tpu.{module}"), cls)
    probe = ["float32", "bfloat16", "float16", "RGB", "BGR", "L", "vector", "image", "tf", "caffe", "torch",
             "none", "f1", "accuracy", "weightedPrecision", "areaUnderROC", "areaUnderPR", "rmse", "mae", "r2",
             "mse", "nonsense"]

    def accepted(klass):
        conv = getattr(klass, param).typeConverter
        out = []
        for v in probe:
            try:
                out.append(conv(v))
            except (TypeError, ValueError):
                out.append(None)
        return out

    assert accepted(ours) == accepted(ref)


# -- refusals ---------------------------------------------------------------------


@pytest.mark.parametrize("class_path", ["sparkdl_tpu.estimators.NoSuchModel", "sparkdl_tpu.no_such_module.Stage",
                                        "sparkdl_tpu.pipeline.NoSuchPipeline"])
def test_a_jax_class_without_a_counterpart_is_refused(class_path, tmp_path):
    path = _save_jax(_lr_model(), tmp_path)
    meta = persistence.read_metadata(path)
    meta["class"] = class_path
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match=f"Refusing to load class '{class_path}'"):
        _load(path)


@pytest.mark.parametrize("class_path", ["os.path.join", "builtins.dict", "sparkdl_tpu_torchx.Stage",
                                        "sparkdl_tpux.pipeline.PipelineModel"])
def test_a_class_outside_both_packages_is_refused(class_path, tmp_path):
    path = _save_jax(_lr_model(), tmp_path)
    meta = persistence.read_metadata(path)
    meta["class"] = class_path
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="only instantiates sparkdl_tpu_torch classes"):
        _load(path)


@pytest.mark.parametrize("error", [ModuleNotFoundError("No module named 'pandas'", name="pandas"),
                                   ImportError("cannot import name 'missing' from 'numpy'"),
                                   AttributeError("module 'numpy' has no attribute 'missing'")],
                         ids=["missing dependency", "import error", "attribute error"])
def test_a_port_module_that_fails_to_import_raises_its_own_error(error, tmp_path, monkeypatch):
    """Only an absent port module or class is a missing counterpart: a port
    module that exists but fails to import raises as it is."""
    path = _save_jax(_lr_model(), tmp_path)
    port_module = "sparkdl_tpu_torch.estimators.logistic_regression"
    import_module = persistence.importlib.import_module

    def failing(name, *args):
        if name == port_module:
            raise error
        return import_module(name, *args)

    monkeypatch.setattr(persistence.importlib, "import_module", failing)
    with pytest.raises(type(error), match=str(error).split("'")[1]) as raised:
        _load(path)
    assert raised.value is error


def test_mapping_imports_nothing_of_the_jax_package():
    import subprocess
    import sys

    code = ("import sys, json; from sparkdl_tpu_torch import persistence; "
            f"s = persistence.load({os.path.join(JAX_STAGES, 'resnet50_lr')!r}, device='cpu'); "
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'sparkdl_tpu'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(HERE), env={**os.environ, "PYTHONPATH": os.path.dirname(HERE)})
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# -- the committed fixture ----------------------------------------------------------


def _meta_tree(root):
    """Every metadata.json below ``root`` by relative directory, without
    its timestamp."""
    out = {}
    for dirpath, _, files in os.walk(root):
        if "metadata.json" in files:
            with open(os.path.join(dirpath, "metadata.json")) as f:
                meta = json.load(f)
            meta.pop("timestamp")
            out[os.path.relpath(dirpath, root)] = meta
    return out


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_the_fixture_is_what_the_script_writes(tmp_path):
    import sys

    sys.path.insert(0, FIXTURES)
    try:
        import make_jax_stage_fixtures as make
    finally:
        sys.path.remove(FIXTURES)
    make.write(str(tmp_path))
    assert _meta_tree(str(tmp_path)) == _meta_tree(JAX_STAGES)
    npz = os.path.join("resnet50_lr", "stages", "1_LogisticRegressionModel_fixture", "model.npz")
    assert _npz_members(str(tmp_path / npz)) == _npz_members(os.path.join(JAX_STAGES, npz))
    w, b = make.lr_weights()
    with np.load(os.path.join(JAX_STAGES, npz)) as z:
        assert z["w"].shape == (2048, 2) and np.array_equal(z["w"], w) and np.array_equal(z["b"], b)
    fresh = read_keras_file(str(tmp_path / "keras_cnn" / "model.keras"))
    committed = read_keras_file(os.path.join(JAX_STAGES, "keras_cnn", "model.keras"))
    assert fresh.get_config() == committed.get_config()
    assert fresh._weights.keys() == committed._weights.keys()
    for k in fresh._weights:
        for a, c in zip(fresh._weights[k], committed._weights[k]):
            np.testing.assert_array_equal(a, c)
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(JAX_STAGES) for f in fs)
    assert total < 200_000


@pytest.fixture(scope="module")
def resnet_weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("resnet_weights") / "resnet50.npz")
    module = get_image_model("ResNet50").model_function(mode="logits", seed=18, device="cpu").module
    save_flax_weights(cnn_params_to_flax(module), path)
    return path


def test_the_fixture_pipeline_gives_the_jax_rows(resnet_weights):
    """The committed ResNet50 + LR stage, loaded by both packages with the
    same weightsFile in f32: rows equal the JAX package's at relative 1e-5."""
    rng = np.random.default_rng(18)
    arrays = [rng.integers(0, 256, size=(224, 224, 3), dtype=np.uint8) for _ in range(3)]
    ours = _load(os.path.join(JAX_STAGES, "resnet50_lr"))
    ref = jax_persistence.load(os.path.join(JAX_STAGES, "resnet50_lr"))
    assert type(ours) is PipelineModel
    for stage in (ours.stages[0], ref.stages[0]):
        stage._set(weightsFile=resnet_weights, computeDtype="float32", batchSize=2)
    got = ours.transform(DataFrame.fromColumns(
        {"image": [imageIO.imageArrayToStruct(a) for a in arrays] + [None]}, numPartitions=2)).collect()
    want = ref.transform(JaxDataFrame.fromColumns(
        {"image": [jax_imageIO.imageArrayToStruct(a) for a in arrays] + [None]}, numPartitions=2)).collect()
    assert got[-1].features is None and got[-1].probability is None
    for a, b in zip(got[:-1], want[:-1]):
        fa, fb = np.asarray(a.features), np.asarray(b.features)
        assert np.abs(fa - fb).max() <= REL * np.abs(fb).max()
        pa, pb = np.asarray(a.probability), np.asarray(b.probability)
        assert np.abs(pa - pb).max() <= REL
        assert a.prediction == b.prediction
