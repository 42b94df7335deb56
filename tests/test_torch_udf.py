"""The port's UDF catalog (``sparkdl_tpu_torch/udf``) against the JAX
package's on the CPU.

- the catalog API (register, get and its KeyError, list, apply_udf and
  callUDF, the ``SPARKDL_SQL_VECTORIZE`` switch);
- ``registerModelUDF`` against the JAX one over null cells, in both arms:
  exact;
- ``registerImageUDF("MobileNetV2")`` at 32x32, the JAX package's flax
  weights carried into both registries' entry (``weights_file``), against
  the JAX package's registry-name UDF at relative 1e-4
  (``test_torch_image_family.F32_REL``);
- the preprocessor branch against the JAX one (exact up to f32 sums);
- the keras branches (a Keras model, a .keras, .h5 and .hdf5 file)
  against the JAX package's at relative 1e-5; a Keras model outside the
  translator's table, another object and ``blocked=False`` raise; the
  counting wrapper is built once per registration, so queries reuse one
  feeder.
"""

import numpy as np
import pytest
import torch

import test_torch_image_family as family
from sparkdl_tpu import udf as jax_udf
from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.graph.ingest import ModelIngest
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.runtime import native as jax_native
from sparkdl_tpu_torch import udf as udf_catalog
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.models import registry as torch_registry
from sparkdl_tpu_torch.utils.metrics import metrics

F32_REL = family.F32_REL


@pytest.fixture
def no_bridge(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)


@pytest.fixture
def names():
    """UDF names registered by a test, unregistered from both catalogs."""
    used = []
    yield used
    for n in used:
        udf_catalog.unregister(n)
        jax_udf.unregister(n)


def _collect(df, col):
    return [r[col] for r in df.collect()]


# -- the catalog -----------------------------------------------------------------


def test_catalog_api(names, monkeypatch):
    names += ["t_upper", "t_vec"]
    fn = lambda cells: [None if c is None else c.upper() for c in cells]  # noqa: E731
    udf_catalog.register("t_upper", fn, doc="upper")
    udf_catalog.register("t_vec", fn, batch_fn=fn)
    assert {"t_upper", "t_vec"} <= set(udf_catalog.list_udfs())
    assert udf_catalog.list_udfs() == sorted(udf_catalog.list_udfs())
    assert udf_catalog.get("t_upper").doc == "upper"
    assert not udf_catalog.get("t_upper").vectorized and udf_catalog.get("t_vec").vectorized
    with pytest.raises(KeyError, match="t_upper"):
        udf_catalog.get("t_missing")
    df = DataFrame.fromColumns({"s": ["a", None, "c"]}, numPartitions=2)
    assert _collect(udf_catalog.apply_udf("t_upper", df, "s", "u"), "u") == ["A", None, "C"]
    assert udf_catalog.callUDF is udf_catalog.apply_udf
    monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", "0")
    assert not udf_catalog.sql_vectorize_enabled()
    udf_catalog.apply_udf("t_vec", df, "s", "u")
    assert metrics.snapshot()["gauges"]["sql.udf.vectorized"] == 0.0
    monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", "1")
    assert udf_catalog.sql_vectorize_enabled()
    udf_catalog.apply_udf("t_vec", df, "s", "u")
    assert metrics.snapshot()["gauges"]["sql.udf.vectorized"] == 1.0
    udf_catalog.unregister("t_upper")
    assert "t_upper" not in udf_catalog.list_udfs()
    udf_catalog.unregister("t_upper")  # unregistering twice is fine


# -- model UDFs --------------------------------------------------------------------


def _affine():
    """y = x @ W + b in both packages, W and b from a seed."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    ref = ModelIngest.from_callable(lambda x: x @ w + b, input_shape=(5,))
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    ours = ModelFunction(lambda _m, x: x @ wt + bt, torch.nn.Module(), torch.device("cpu"),
                         name="affine", input_shape=(5,))
    return ours, ref


@pytest.mark.parametrize("arm", ["1", "0"])
def test_model_udf_matches_jax_with_null_cells(names, monkeypatch, arm):
    """Rows of a model UDF over 4 partitions with null cells, batch 3,
    equal the JAX package's; the nulls stay null."""
    names.append("t_affine")
    monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", arm)
    ours, ref = _affine()
    udf_catalog.registerModelUDF("t_affine", ours, batch_size=3, device="cpu")
    jax_udf.registerModelUDF("t_affine", ref, batch_size=3)
    rng = np.random.default_rng(5)
    cells = [None if i % 4 == 1 else rng.normal(size=5).astype(np.float32) for i in range(11)]
    got = _collect(udf_catalog.apply_udf("t_affine", DataFrame.fromColumns({"x": cells}, 4), "x", "y"), "y")
    want = _collect(jax_udf.apply_udf("t_affine", JaxDataFrame.fromColumns({"x": cells}, 4), "x", "y"), "y")
    assert [g is None for g in got] == [c is None for c in cells] == [w is None for w in want]
    for g, w in zip(got, want):
        if w is not None:
            assert g.shape == (3,)
            np.testing.assert_array_equal(g, np.asarray(w))


def test_model_udf_counts_batches_and_keeps_one_feeder(names):
    """The vectorized arm counts each dispatch and its rows; a second
    query over the same registration opens no new feeder (the counting
    wrapper is the registration's, not the query's)."""
    from sparkdl_tpu_torch.runtime.feeder import shutdown_feeders

    names.append("t_affine")
    udf_catalog.registerModelUDF("t_affine", _affine()[0], batch_size=4, device="cpu")
    cells = [np.ones(5, np.float32)] * 10 + [None, None]
    df = DataFrame.fromColumns({"x": cells}, numPartitions=3)
    shutdown_feeders()
    try:
        opened0 = metrics.counter("feeder.opened")
        rows0 = metrics.counter("sql.udf.batch_rows")
        batches0 = metrics.counter("sql.udf.batches")
        for _ in range(2):
            out = _collect(udf_catalog.apply_udf("t_affine", df, "x", "y"), "y")
            assert [o is None for o in out] == [c is None for c in cells]
        assert metrics.counter("sql.udf.batch_rows") - rows0 == 20
        assert metrics.counter("sql.udf.batches") - batches0 >= 2 * 3  # 10 rows in batches of 4
        assert metrics.counter("feeder.opened") - opened0 == 1
    finally:
        shutdown_feeders()


def test_make_graph_udf_refuses_row_at_a_time(names):
    names.append("t_graph")
    with pytest.raises(ValueError, match="blocked=False"):
        udf_catalog.makeGraphUDF(_affine()[0], "t_graph", blocked=False, device="cpu")
    udf_catalog.makeGraphUDF(_affine()[0], "t_graph", device="cpu")
    assert udf_catalog.get("t_graph").vectorized


def test_registration_holds_the_model_on_its_device(names, monkeypatch):
    """The default device is cuda: with no card a registration raises,
    and a model on another device than the one asked for is refused."""
    names.append("t_dev")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        udf_catalog.registerImageUDF("t_dev", "MobileNetV2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        udf_catalog.registerModelUDF("t_dev", _affine()[0])
    with pytest.raises(ValueError, match="lives on cpu"):
        udf_catalog.registerModelUDF("t_dev", _affine()[0], device="meta")
    assert "t_dev" not in udf_catalog.list_udfs()


def _keras_model(unsupported: bool = False):
    import keras

    from test_torch_keras_graph import randomize

    L = keras.layers
    middle = [L.UpSampling2D()] if unsupported else [L.BatchNormalization()]
    return randomize(keras.Sequential(
        [L.Input((8, 8, 3)), L.Conv2D(4, 3, padding="same", activation="relu"), *middle,
         L.GlobalAveragePooling2D(), L.Dense(6, activation="softmax")], name="udf_keras"), seed=9)


def _keras_source(kind, model, tmp_path):
    if kind == "keras object":
        return model
    path = str(tmp_path / f"model.{kind}")
    model.save(path)
    return path


@pytest.mark.parametrize("kind", ["h5", "keras", "hdf5", "keras object"])
def test_keras_branches_raise(names, tmp_path, kind):
    """A Keras model or file with a layer outside the translator's table
    is refused, naming the ROADMAP item; another object is a TypeError."""
    names.append("t_keras")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 9"):
        udf_catalog.registerKerasImageUDF("t_keras", _keras_source(kind, _keras_model(True), tmp_path),
                                          device="cpu")
    with pytest.raises(TypeError, match="object is not a registry model name"):
        udf_catalog.registerKerasImageUDF("t_keras", object(), device="cpu")
    assert "t_keras" not in udf_catalog.list_udfs()
    assert udf_catalog.registerKerasImageUDF is udf_catalog.registerImageUDF


@pytest.mark.parametrize("kind", ["keras object", "keras", "h5", "hdf5"])
def test_keras_branches_match_jax(names, tmp_path, no_bridge, kind):
    """registerKerasImageUDF over a Keras model, a .keras and a .h5/.hdf5
    file (seeded weights) in both packages: rows at the model's size,
    resized and null, over 2 partitions at batch 2, within 1e-5 of the
    JAX UDF's."""
    names.append("t_keras")
    source = _keras_source(kind, _keras_model(), tmp_path)
    udf_catalog.registerKerasImageUDF("t_keras", source, batch_size=2, device="cpu")
    jax_udf.registerKerasImageUDF("t_keras", source, batch_size=2)
    structs = _structs(14, [(8, 8, 3), None, (12, 10, 3), (8, 8, 3), (8, 8, 1)])
    got = _collect(udf_catalog.apply_udf("t_keras", DataFrame.fromColumns({"image": structs}, 2), "image", "p"), "p")
    want = _collect(jax_udf.apply_udf("t_keras", JaxDataFrame.fromColumns({"image": structs}, 2), "image", "p"), "p")
    assert [g is None for g in got] == [s is None for s in structs] == [w is None for w in want]
    for g, w in zip(got, want):
        if w is not None:
            assert g.shape == (6,) and abs(float(g.sum()) - 1.0) < 1e-5
            assert family._rel(g, np.asarray(w)) <= 1e-5


# -- image UDFs ----------------------------------------------------------------------


class _WithWeights:
    """A registry entry whose ``model_function`` loads ``weights``."""

    def __init__(self, spec, weights):
        self._spec, self._weights = spec, weights

    def __getattr__(self, name):
        return getattr(self._spec, name)

    def model_function(self, **kw):
        return self._spec.model_function(weights_file=self._weights, **kw)


def _structs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [
        None if s is None else imageIO.imageArrayToStruct(rng.integers(0, 256, size=s, dtype=np.uint8))
        for s in shapes
    ]


@pytest.fixture(scope="module")
def mobilenet_weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("weights") / "MobileNetV2.npz")
    jax_registry.save_flax_weights(family._flax_variables("MobileNetV2", 32, seed=11), path)
    return path


@pytest.mark.parametrize("arm", ["1", "0"])
def test_image_udf_registry_name_matches_jax(names, mobilenet_weights, monkeypatch, no_bridge, arm):
    """registerImageUDF("MobileNetV2") at 32x32 with the same flax weights
    in both packages: probabilities within F32_REL of the JAX UDF's, rows
    at the size, resized and null, over 2 partitions at batch 2."""
    names.append("t_mnv2")
    monkeypatch.setenv("SPARKDL_SQL_VECTORIZE", arm)
    for mod in (jax_registry, torch_registry):
        spec = mod.get_image_model("MobileNetV2")
        monkeypatch.setattr(mod, "get_image_model", lambda name, spec=spec: _WithWeights(spec, mobilenet_weights))
    udf_catalog.registerImageUDF("t_mnv2", "MobileNetV2", height=32, width=32, batch_size=2, device="cpu")
    jax_udf.registerImageUDF("t_mnv2", "MobileNetV2", height=32, width=32, batch_size=2)
    structs = _structs(12, [(32, 32, 3), None, (40, 48, 3), (32, 32, 3), (32, 32, 1)])
    got = _collect(udf_catalog.apply_udf("t_mnv2", DataFrame.fromColumns({"image": structs}, 2), "image", "p"), "p")
    want = _collect(jax_udf.apply_udf("t_mnv2", JaxDataFrame.fromColumns({"image": structs}, 2), "image", "p"), "p")
    assert [g is None for g in got] == [s is None for s in structs] == [w is None for w in want]
    for g, w in zip(got, want):
        if w is not None:
            assert g.shape == (1000,) and g.dtype == np.float32
            assert abs(float(g.sum()) - 1.0) < 1e-5
            assert family._rel(g, w) <= F32_REL


def test_image_udf_preprocessor_branch_matches_jax(names, no_bridge):
    """A host preprocessor replaces the converter: it gets each image as
    HWC uint8 RGB, and the model its float output. A per-channel mean
    model in both packages; its rows equal the JAX UDF's."""
    names.append("t_pre")
    seen = []

    def preprocessor(rgb):
        seen.append((rgb.shape, rgb.dtype))
        return rgb.astype(np.float32) / 255.0

    ref = ModelIngest.from_callable(lambda x: x.mean(axis=(1, 2)), input_shape=(8, 8, 3))
    ours = ModelFunction(lambda _m, x: x.mean(dim=(2, 3)), torch.nn.Module(), torch.device("cpu"),
                         name="channel_mean", input_shape=(8, 8, 3))
    udf_catalog.registerImageUDF("t_pre", ours, preprocessor=preprocessor, batch_size=2, device="cpu")
    jax_udf.registerImageUDF("t_pre", ref, preprocessor=preprocessor, batch_size=2)
    structs = _structs(13, [(8, 8, 3), (8, 8, 3), None, (10, 12, 3)])
    got = _collect(udf_catalog.apply_udf("t_pre", DataFrame.fromColumns({"image": structs}, 2), "image", "c"), "c")
    assert seen and all(s == ((8, 8, 3), np.uint8) for s in seen)
    want = _collect(jax_udf.apply_udf("t_pre", JaxDataFrame.fromColumns({"image": structs}, 2), "image", "c"), "c")
    assert [g is None for g in got] == [s is None for s in structs]
    for g, w, s in zip(got, want, structs):
        if s is not None:
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7)
            # RGB order: the first output is the mean of the struct's last
            # (BGR storage) channel
            arr = imageIO.imageStructToArray(s)
            if arr.shape[:2] == (8, 8):
                np.testing.assert_allclose(g[0], arr[..., 2].mean() / 255.0, rtol=1e-6)
