"""The public ``Params`` API and the registry's user surface, in the port
against the JAX package, on the CPU.

- Every case of ``tests/test_params.py`` runs on both packages, over one
  stage class declared in each with the same params, and the
  ``explainParams()`` strings are held equal character for character;
  for the real stages (whose docs describe each package) the names,
  order and states of their lines are.
- ``register_model``: a user image entry built from a torch module
  factory, served by ``Router`` over its default registry loader, answers
  what the entry's ModelFunction does called directly, and with the flax
  weights of the JAX package's registered twin it computes the twin's
  features (atol 1e-5).
- ``save_flax_weights``: the port writes the JAX package's ``.npz``
  byte-for-byte key and value, and a ``weights_file`` round trip gives
  the module back at atol 0.
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu import params as jax_params
from sparkdl_tpu.estimators import LogisticRegression as JaxLogisticRegression
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.transformers import DeepImageFeaturizer as JaxDeepImageFeaturizer
from sparkdl_tpu.transformers import ImageModelTransformer as JaxImageModelTransformer
from sparkdl_tpu_torch import params as torch_params
from sparkdl_tpu_torch.estimators import LogisticRegression
from sparkdl_tpu_torch.models import registry
from sparkdl_tpu_torch.models.convert import cnn_params_to_flax
from sparkdl_tpu_torch.models.layers import ImageCNN, global_mean
from sparkdl_tpu_torch.serving import Router
from sparkdl_tpu_torch.transformers.image_model import ImageModelTransformer
from sparkdl_tpu_torch.transformers.named_image import DeepImageFeaturizer

PACKAGES = ("jax", "torch")


def _stage_class(mod):
    """tests/test_params.py's stage, declared on one package's params."""

    class _Stage(mod.HasInputCol, mod.HasOutputCol):
        threshold = mod.Param(None, "threshold", "a float threshold", mod.TypeConverters.toFloat)

        @mod.keyword_only
        def __init__(self, inputCol=None, outputCol=None, threshold=None):
            super().__init__()
            self._setDefault(threshold=0.5, outputCol="out")
            self._set(**self._input_kwargs)

    return _Stage


STAGES = {"jax": _stage_class(jax_params), "torch": _stage_class(torch_params)}
CONVERTERS = {"jax": jax_params.TypeConverters, "torch": torch_params.TypeConverters}


@pytest.mark.parametrize("pkg", PACKAGES)
class TestParamsCases:
    def test_defaults_and_set(self, pkg):
        s = STAGES[pkg](inputCol="x")
        assert s.getInputCol() == "x"
        assert s.getOrDefault("threshold") == 0.5
        assert s.getOutputCol() == "out"
        s.set(s.threshold, 0.9)
        assert s.getOrDefault(s.threshold) == 0.9

    def test_type_converter_rejects(self, pkg):
        s = STAGES[pkg](inputCol="x")
        with pytest.raises(TypeError):
            s._set(threshold="not a float")
        with pytest.raises(TypeError):
            s._set(inputCol=3)

    def test_keyword_only_rejects_positional(self, pkg):
        with pytest.raises(TypeError):
            STAGES[pkg]("x")

    def test_params_are_instance_bound(self, pkg):
        a, b = STAGES[pkg](inputCol="a"), STAGES[pkg](inputCol="b")
        assert a.uid != b.uid and a.threshold != b.threshold
        a.set(a.threshold, 0.1)
        assert b.getOrDefault(b.threshold) == 0.5

    def test_copy_with_extra_parammap(self, pkg):
        s = STAGES[pkg](inputCol="x", threshold=0.2)
        s2 = s.copy({s.threshold: 0.7})
        assert s.getOrDefault(s.threshold) == 0.2
        assert s2.getOrDefault(s2.threshold) == 0.7 and s2.getInputCol() == "x"

    def test_extract_param_map(self, pkg):
        s = STAGES[pkg](inputCol="x")
        pm = s.extractParamMap()
        assert pm[s.inputCol] == "x" and pm[s.threshold] == 0.5
        assert s.extractParamMap({"threshold": 0.3})[s.threshold] == 0.3
        with pytest.raises(ValueError):
            s.extractParamMap({STAGES[pkg]().threshold: 0.3})  # another stage's param

    def test_explain_params(self, pkg):
        s = STAGES[pkg](inputCol="x")
        text = s.explainParams()
        assert "threshold" in text and "inputCol" in text

    def test_params_json_roundtrip(self, pkg, tmp_path):
        s = STAGES[pkg](inputCol="x", threshold=0.25)
        p = tmp_path / "params.json"
        s.saveParams(str(p))
        blob = json.loads(p.read_text())
        assert blob["paramMap"]["threshold"] == 0.25
        s2 = STAGES[pkg]()
        s2._load_params_json(str(p))
        assert s2.getOrDefault("threshold") == 0.25 and s2.getInputCol() == "x"

    def test_clear_restores_the_default(self, pkg):
        s = STAGES[pkg](inputCol="x", threshold=0.2)
        assert s.clear(s.threshold) is s
        assert s.getOrDefault("threshold") == 0.5 and not s.isSet("threshold")
        s.clear("inputCol")
        assert not s.isDefined("inputCol")


def test_explain_params_strings_equal():
    ours, ref = STAGES["torch"](inputCol="x", threshold=0.25), STAGES["jax"](inputCol="x", threshold=0.25)
    assert ours.explainParams() == ref.explainParams()
    assert [p.name for p in ours.params] == [p.name for p in ref.params] == ["inputCol", "outputCol", "threshold"]
    for name in ("inputCol", "outputCol", "threshold"):
        assert ours.explainParam(name) == ref.explainParam(name)
    ours.clear("threshold")
    ref.clear("threshold")
    assert ours.explainParams() == ref.explainParams()
    assert json.loads(ours._params_to_json())["paramMap"] == json.loads(ref._params_to_json())["paramMap"]


def _lines(stage):
    """(name, state) of each explainParams line: the docs describe each
    package's own implementation."""
    out = []
    for line in stage.explainParams().splitlines():
        name = line.split(":", 1)[0]
        out.append((name, line.rsplit("(", 1)[1]))
    return out


@pytest.mark.parametrize("make", [
    lambda pkg: (LogisticRegression(maxIter=3, device="cpu") if pkg == "torch"
                 else JaxLogisticRegression(maxIter=3)),
    lambda pkg: (ImageModelTransformer if pkg == "torch" else JaxImageModelTransformer)(
        inputCol="i", outputCol="o", targetHeight=8),
    lambda pkg: (DeepImageFeaturizer if pkg == "torch" else JaxDeepImageFeaturizer)(
        inputCol="i", modelName="ResNet50"),
], ids=["LogisticRegression", "ImageModelTransformer", "DeepImageFeaturizer"])
def test_real_stages_explain_the_same_params(make):
    assert _lines(make("torch")) == _lines(make("jax"))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_list_converters(pkg):
    tc = CONVERTERS[pkg]
    assert tc.toListString(("a", "b")) == ["a", "b"]
    assert tc.toListInt([1, 2.0]) == [1, 2]
    assert tc.toListFloat((1, 2.5)) == [1.0, 2.5]
    for conv, bad in ((tc.toListString, ["a", 1]), (tc.toListInt, [1.5]), (tc.toListFloat, [True]),
                      (tc.toListInt, "12")):
        with pytest.raises(TypeError):
            conv(bad)


def test_list_converters_agree():
    for name in ("toListString", "toListInt", "toListFloat"):
        for value in (["x"], [1, 2], (3.0, 4), [], [True]):
            results = []
            for pkg in PACKAGES:
                try:
                    results.append(getattr(CONVERTERS[pkg], name)(value))
                except TypeError:
                    results.append(TypeError)
            assert results[0] == results[1], (name, value)


def test_image_model_transformer_set_params():
    ours = ImageModelTransformer(inputCol="i", outputCol="o")
    ref = JaxImageModelTransformer(inputCol="i", outputCol="o")
    assert ours.setParams(targetHeight=8, targetWidth=6, batchSize=4) is ours
    ref.setParams(targetHeight=8, targetWidth=6, batchSize=4)
    assert _lines(ours) == _lines(ref)
    with pytest.raises(TypeError):
        ours.setParams(8)


# -- the registry: register_model and save_flax_weights ------------------------

TINY = "TinyTorchTest"
TINY_HW = 8


class TinyCNN(ImageCNN):
    """A 3x3 conv, ReLU, global mean and a dense head: the JAX package's
    ``tests/test_transformers.py`` TinyCNN in torch."""

    def __init__(self, dtype=torch.float32, num_classes=10):
        super().__init__(dtype)
        self.conv = nn.Conv2d(3, 4, 3, padding=1)
        self.head = nn.Linear(4, num_classes)

    def _forward(self, x, features_only):
        x = global_mean(F.relu(self.conv(x)))
        return x if features_only else self.head(x)


class FlaxTinyCNN(fnn.Module):
    num_classes: int = 10
    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x, features_only: bool = False):
        x = fnn.relu(fnn.Conv(4, (3, 3), name="conv")(x.astype(self.dtype)))
        x = jnp.mean(x, axis=(1, 2))
        if features_only:
            return x.astype(jnp.float32)
        return fnn.Dense(self.num_classes, name="head")(x).astype(jnp.float32)


@pytest.fixture
def tiny_entry():
    spec = registry.NamedImageModel(
        TINY, TINY_HW, TINY_HW, "tf", 4, num_classes=10,
        module_factory=lambda dtype, num_classes, input_size: TinyCNN(dtype, num_classes),
    )
    registry.register_model(spec)
    jax_registry.register_model(jax_registry.NamedImageModel(
        TINY, TINY_HW, TINY_HW, "tf", 4, "flax",
        jax_registry._flax_cnn_builder(lambda dtype, num_classes: FlaxTinyCNN(num_classes, dtype)),
        num_classes=10,
    ))
    yield spec
    registry._REGISTRY.pop(TINY.lower(), None)
    jax_registry._REGISTRY.pop(TINY.lower(), None)
    jax_registry._ESTIMATE_CACHE.pop(TINY, None)


def _images(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, TINY_HW, TINY_HW, 3)).astype(np.float32)


def test_register_model_entry_is_served_by_the_router(tiny_entry):
    assert TINY in registry.supported_models(kind="image")
    assert tiny_entry.flops_per_item() == 2.0 * (TINY_HW * TINY_HW * 4 * 27 + 4 * 10)
    direct = tiny_entry.model_function(seed=0, device="cpu")
    x = _images(5)
    want = direct(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    router = Router(device="cpu")
    try:
        got = router.submit(TINY, x, priority="interactive").result(timeout=60)
        (row,) = [m for m in router.stats()["models"] if m["name"] == TINY]
        assert row["param_bytes"] == registry.param_bytes(direct)
    finally:
        router.close()
    np.testing.assert_array_equal(np.asarray(got), want)


def test_register_model_with_the_jax_twins_weights(tiny_entry, tmp_path):
    variables = FlaxTinyCNN().init(jax.random.PRNGKey(3), jnp.zeros((1, TINY_HW, TINY_HW, 3)))
    path = str(tmp_path / "tiny.npz")
    jax_registry.save_flax_weights(jax.tree_util.tree_map(np.asarray, dict(variables)), path)
    x = _images(4, seed=1)
    ref = jax_registry.get_model(TINY).model_function(mode="features", weights_file=path)
    ours = tiny_entry.model_function(mode="features", weights_file=path, device="cpu")
    want = np.asarray(ref(jnp.asarray(x)))
    got = ours(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_save_flax_weights_round_trip(tiny_entry, tmp_path):
    module = tiny_entry.model_function(seed=5, device="cpu").module
    tree = cnn_params_to_flax(module)
    ours, ref = str(tmp_path / "ours.npz"), str(tmp_path / "ref.npz")
    registry.save_flax_weights(tree, ours)
    jax_registry.save_flax_weights(jax.tree_util.tree_map(np.asarray, tree), ref)
    with np.load(ours) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    back = tiny_entry.model_function(weights_file=ours, device="cpu").module
    for (name, t), (name2, t2) in zip(module.state_dict().items(), back.state_dict().items()):
        assert name == name2 and torch.equal(t, t2), name
