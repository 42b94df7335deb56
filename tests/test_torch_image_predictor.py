"""The port's registry entries of the image families against the JAX
package's, DeepImageFeaturizer over InceptionV3 at 299x299, and
DeepImagePredictor with every label source against the JAX package's: the
helpers of ``test_torch_image_family.py``, f32 at its relative bound."""

import json

import numpy as np
import pytest
import torch

import test_torch_image_family as family
from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.runtime import native as jax_native
from sparkdl_tpu.transformers import DeepImageFeaturizer as JaxFeaturizer
from sparkdl_tpu.transformers.named_image import DeepImagePredictor as JaxPredictor
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.models import get_image_model, supported_models
from sparkdl_tpu_torch.models.keras_weights import imagenet_labels
from sparkdl_tpu_torch.transformers.named_image import (
    DeepImageFeaturizer,
    DeepImagePredictor,
)

F32_REL, FAMILIES, _rel = family.F32_REL, family.FAMILIES, family._rel


# -- registry ------------------------------------------------------------------


@pytest.mark.parametrize("name", list(FAMILIES))
def test_registry_family_entry_matches_jax(name):
    ours, ref = get_image_model(name.lower()), jax_registry.get_model(name)
    for field in ("name", "height", "width", "preprocessing", "feature_dim", "num_classes"):
        assert getattr(ours, field) == getattr(ref, field)
    # the JAX registry's own image entries; other tests may register more
    assert supported_models(kind="image") == sorted(list(FAMILIES) + ["ResNet50"])
    assert set(supported_models(kind="image")) <= set(jax_registry.supported_models(kind="image"))
    assert "ResNet101" not in supported_models() and "ResNet152" not in supported_models()


def test_registry_builds_every_mode_on_the_cpu():
    """One small family through all three modes: features, logits, and a
    softmax over the logits."""
    spec = get_image_model("MobileNetV2")
    x = torch.from_numpy(family._inputs("MobileNetV2", 224, seed=6, n=1)).permute(0, 3, 1, 2)
    out = {
        mode: spec.model_function(mode=mode, seed=2, device="cpu")(x)
        for mode in ("features", "logits", "probabilities")
    }
    assert out["features"].shape == (1, 1280)
    assert out["logits"].shape == out["probabilities"].shape == (1, 1000)
    torch.testing.assert_close(out["probabilities"], torch.softmax(out["logits"], -1))
    bf = spec.model_function(dtype=torch.bfloat16, seed=2, device="cpu")
    assert bf.module.block_3.depthwise.weight.dtype == torch.bfloat16
    assert bf.module.block_3.depthwise_bn.running_var.dtype == torch.float32


# -- transformers ----------------------------------------------------------


@pytest.fixture
def no_bridge(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)


def _structs(rng, shapes):
    return [
        None if s is None else imageIO.imageArrayToStruct(rng.integers(0, 256, size=s, dtype=np.uint8))
        for s in shapes
    ]


def _weights(tmp_path_factory, name, size):
    path = str(tmp_path_factory.mktemp("weights") / f"{name}.npz")
    jax_registry.save_flax_weights(family._flax_variables(name, size, seed=7), path)
    return path


def test_inception_featurizer_matches_jax_at_299(tmp_path_factory, no_bridge):
    """InceptionV3 f32 from the same .npz in both packages at 299x299: a
    struct at the model's size, one the host resizes, and a null row."""
    weights = _weights(tmp_path_factory, "InceptionV3", 299)
    shapes = [(299, 299, 3), None, (120, 200, 3)]
    structs = _structs(np.random.default_rng(8), shapes)
    kwargs = dict(inputCol="image", outputCol="features", modelName="InceptionV3",
                  weightsFile=weights, computeDtype="float32", batchSize=4)
    ours = DeepImageFeaturizer(device="cpu", **kwargs).transform(
        DataFrame.fromColumns({"image": structs})).collect()
    ref = JaxFeaturizer(**kwargs).transform(JaxDataFrame.fromColumns({"image": structs})).collect()
    assert [r.features is None for r in ours] == [s is None for s in shapes]
    for got, want in zip(ours, ref):
        if want.features is not None:
            assert got.features.shape == (2048,) and got.features.dtype == np.float32
            assert _rel(got.features, want.features) <= F32_REL


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    """The JAX package's DeepImagePredictor and the port's over MobileNetV2
    (f32, the same .npz), over five structs (one null) in two partitions
    at batch 2."""
    weights = _weights(tmp_path_factory, "MobileNetV2", 224)
    structs = _structs(np.random.default_rng(9), [(224, 224, 3), (224, 224, 3), None, (224, 224, 3), (224, 224, 3)])
    kwargs = dict(inputCol="image", outputCol="pred", modelName="MobileNetV2",
                  weightsFile=weights, computeDtype="float32", batchSize=2)
    ours = DeepImagePredictor(device="cpu", **kwargs)
    ref = JaxPredictor(**kwargs)
    frames = (DataFrame.fromColumns({"image": structs}, numPartitions=2),
              JaxDataFrame.fromColumns({"image": structs}, numPartitions=2))
    return ours, ref, frames


def _predict(predictors, **params):
    ours, ref, (df, jdf) = predictors
    got = ours.copy({getattr(ours, k): v for k, v in params.items()}).transform(df).collect()
    want = ref.copy({getattr(ref, k): v for k, v in params.items()}).transform(jdf).collect()
    return [r.pred for r in got], [r.pred for r in want]


@pytest.fixture(scope="module")
def probabilities(predictors):
    """Both packages' probability vectors of the five rows. The stages keep
    their models, and the copies that ``_predict`` makes share them."""
    ours, ref, (df, jdf) = predictors
    return ([r.pred for r in ours.transform(df).collect()],
            [r.pred for r in ref.transform(jdf).collect()])


def test_predictor_probabilities_match_jax(predictors, probabilities):
    ours, ref = probabilities
    assert predictors[0].getOrDefault("decodePredictions") is False
    assert predictors[0].getOrDefault("topK") == 5
    assert [p is None for p in ours] == [p is None for p in ref] == [False, False, True, False, False]
    for got, want in zip(ours, ref):
        if want is not None:
            assert got.shape == (1000,) and abs(float(got.sum()) - 1.0) < 1e-5
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            assert _rel(got, want) <= F32_REL


def _assert_same_decoding(ours, ref, k):
    assert [p is None for p in ours] == [p is None for p in ref]
    for got, want in zip(ours, ref):
        if want is None:
            continue
        assert len(got) == len(want) == k
        assert [(d["classIdx"], d["label"]) for d in got] == [(d["classIdx"], d["label"]) for d in want]
        np.testing.assert_allclose([d["score"] for d in got], [d["score"] for d in want], rtol=0, atol=1e-6)


def _labels_list():
    return [f"label {i}" for i in range(1000)]


@pytest.mark.parametrize("source", ["list", "map", "keras_home", "fallback"])
def test_predictor_decoding_matches_jax(predictors, probabilities, source, tmp_path, monkeypatch):
    # the JAX package looks in its artifact store first: point it at an
    # empty one, so both packages read what this test writes
    monkeypatch.setenv("SPARKDL_TPU_MODEL_CACHE", str(tmp_path / "store"))
    monkeypatch.setenv("KERAS_HOME", str(tmp_path / "keras"))
    params = {"decodePredictions": True, "topK": 3}
    labels_file = tmp_path / "labels.json"
    if source == "list":
        labels_file.write_text(json.dumps(_labels_list()))
        params["labelsFile"] = str(labels_file)
    elif source == "map":  # a map of only some classes: the rest fall back
        labels_file.write_text(json.dumps({str(i): f"m{i}" for i in range(0, 1000, 2)}))
        params["labelsFile"] = str(labels_file)
    elif source == "keras_home":
        (tmp_path / "keras" / "models").mkdir(parents=True)
        index = {str(i): [f"n{i:08d}", f"syn{i}"] for i in range(1000)}
        (tmp_path / "keras" / "models" / "imagenet_class_index.json").write_text(json.dumps(index))
    ours, ref = _predict(predictors, **params)
    _assert_same_decoding(ours, ref, 3)
    decoded = [d for row in ours if row is not None for d in row]
    if source == "fallback":
        assert all(d["label"] == f"class_{d['classIdx']}" for d in decoded)
    elif source == "keras_home":
        assert all(d["label"] == f"syn{d['classIdx']}" for d in decoded)
    # each decoded row is the top k of the row's own probabilities
    for row, p in zip(ours, probabilities[0]):
        if row is not None:
            assert [d["classIdx"] for d in row] == list(np.argsort(p)[::-1][:3])


def test_predictor_default_top_k_and_labels_helper(predictors, probabilities, tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKDL_TPU_MODEL_CACHE", str(tmp_path / "store"))
    monkeypatch.setenv("KERAS_HOME", str(tmp_path / "keras"))
    ours, ref = _predict(predictors, decodePredictions=True)
    _assert_same_decoding(ours, ref, 5)
    with pytest.raises(FileNotFoundError, match="not found"):
        imagenet_labels(str(tmp_path / "missing.json"))
    with pytest.raises(FileNotFoundError, match="No imagenet_class_index"):
        imagenet_labels()
    path = tmp_path / "index.json"
    path.write_text(json.dumps({"0": ["n0", "tench"], "1": ["n1", "goldfish"]}))
    assert imagenet_labels(str(path)) == {0: "tench", 1: "goldfish"}
    with pytest.raises(TypeError):
        DeepImagePredictor(decodePredictions="yes")
