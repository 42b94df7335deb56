"""``XlaCallModule`` on the port: keras-3 / jax2tf SavedModels through
``ModelIngest.from_saved_model``, on the CPU.

The JAX package runs the op's StableHLO module through ``jax.export``
(``sparkdl_tpu/graph/tf_import.py`` ``_xla_call_module``); the port runs it
on its own reader and interpreter. Held here:

- a keras-3 MLP export (the twin of ``tests/test_tf_ingest.py``'s
  ``TestKeras3Export``) against Keras and the JAX package's ingestion,
  ``rtol=1e-5, atol=1e-6``;
- a keras-3 export of ``keras_cnn.keras`` made here, and the committed
  224x224 ResNet50 export (its data shard rebuilt from the seeded weights
  ``shard.json`` names), against Keras / the port's ``KerasModule`` on the
  same weights (relative 1e-4) and against the JAX package's own
  ``XlaCallModule`` translation on the same inputs (relative 1e-5). The
  JAX package's ``from_saved_model`` itself fails on a keras-3 export that
  holds BatchNormalization (TF's importer refuses the graph's
  ``AssignVariableOp``), so the op is compared where it runs;
- the LRU of 16 programs keyed by digest, shapes and dtypes; the
  refusals (a multi-platform ``main``, an output shape that cannot be
  inferred), each naming ROADMAP item 13;
- ``chip_smoke.py`` phase 29 rehearsed on the CPU at a cut size.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.graph import tf_import as jax_tf_import
from sparkdl_tpu.graph.ingest import ModelIngest as JaxModelIngest
from sparkdl_tpu_torch.graph import ModelIngest, tf_import, tf_proto
from sparkdl_tpu_torch.graph.keras_graph import KerasModelSpec
from sparkdl_tpu_torch.graph.tf_import import UnsupportedTFOpError, translate_graph_def

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
ITEM = "ROADMAP Queue A item 13"


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


class _Spy:
    """Records the port's ``XlaCallModule`` node, arguments and outputs."""

    def __init__(self):
        self.calls = []
        self.handler = tf_import._OP_TABLE["XlaCallModule"]

    def __call__(self, node, args):
        out = self.handler(node, args)
        self.calls.append((node, [a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in args],
                           [o.numpy() for o in out]))
        return out


@pytest.fixture
def spy(monkeypatch):
    s = _Spy()
    monkeypatch.setitem(tf_import._OP_TABLE, "XlaCallModule", s)
    return s


def _jax_translation(node, args):
    """The JAX package's ``XlaCallModule`` translation of the port's node."""
    from tensorflow.core.framework import node_def_pb2

    nd = node_def_pb2.NodeDef(name=node.name, op="XlaCallModule")
    nd.attr["module"].s = node.attr["module"].s
    nd.attr["version"].i = node.attr["version"].i
    nd.attr["platforms"].list.s.extend(node.attr["platforms"].list.s)
    nd.attr["Tout"].list.type.extend(node.attr["Tout"].list.type)
    for s in node.attr["Sout"].list.shape:
        shape = nd.attr["Sout"].list.shape.add()
        for d in s.dim:
            shape.dim.add().size = d.size
    return [np.asarray(o) for o in jax_tf_import._xla_call_module(nd, args)]


def _mlp_keras():
    import keras

    rng = np.random.default_rng(0)
    inp = keras.Input((4,), name="x")
    h = keras.layers.Dense(8, activation="relu", name="d1")(inp)
    out = keras.layers.Dense(3, activation="softmax", name="d2")(h)
    model = keras.Model(inp, out)
    for layer in model.layers[1:]:
        layer.set_weights([rng.normal(size=w.shape).astype(np.float32) for w in layer.get_weights()])
    return model


@pytest.fixture(scope="module")
def mlp_export(tmp_path_factory):
    """A keras-3 export of ``_mlp_keras()``: (model, SavedModel path)."""
    model = _mlp_keras()
    path = str(tmp_path_factory.mktemp("mlp") / "k3_export")
    model.export(path)
    return model, path


def test_xla_call_module_is_in_the_table():
    assert "XlaCallModule" in tf_import._OP_TABLE and "XlaCallModule" not in tf_import.REFUSED
    assert set(tf_import._OP_TABLE) == set(jax_tf_import._OP_TABLE) | {"FloorMod"}


def test_a_keras3_mlp_export_ingests_like_keras_and_the_jax_package(mlp_export, spy):
    model, sm = mlp_export
    x = np.random.default_rng(11).normal(size=(6, 4)).astype(np.float32)
    oracle = np.asarray(model(x))
    mf = ModelIngest.from_saved_model(sm, device="cpu")
    y = mf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, oracle, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y, np.asarray(JaxModelIngest.from_saved_model(sm)(x)), rtol=1e-5, atol=1e-6)
    assert len(spy.calls) == 1  # the whole model is one XlaCallModule
    # a batch of another size runs the same program
    np.testing.assert_allclose(mf(torch.from_numpy(x[:2])).numpy(), oracle[:2], rtol=1e-5, atol=1e-6)


def test_a_keras3_cnn_export_ingests_like_keras_and_the_jax_translation(tmp_path, spy):
    import keras

    model = keras.saving.load_model(os.path.join(FIXTURES, "keras_cnn.keras"))
    x = np.random.default_rng(3).random((3,) + tuple(model.input_shape[1:])).astype(np.float32)
    oracle = np.asarray(model(x))
    sm = str(tmp_path / "cnn")
    model.export(sm, format="tf_saved_model", verbose=False)
    mf = ModelIngest.from_saved_model(sm, device="cpu")
    assert mf.takes_nhwc and mf.input_shape == tuple(model.input_shape[1:])
    y = mf(torch.from_numpy(x)).numpy()
    assert _rel(y, oracle) <= 1e-4
    (node, args, outs), = spy.calls
    jax_outs = _jax_translation(node, args)
    assert len(jax_outs) == len(outs)
    for got, want in zip(outs, jax_outs):
        assert got.shape == want.shape and _rel(got, want) <= 1e-5
    with pytest.raises(Exception, match="AssignVariableOp"):  # why the op is compared, not the ingestion
        JaxModelIngest.from_saved_model(sm)


@pytest.fixture(scope="module")
def resnet_saved_model(tmp_path_factory):
    sys.path.insert(0, FIXTURES)
    try:
        from keras3_shard import shard_spec, write_saved_model
    finally:
        sys.path.remove(FIXTURES)
    import chip_smoke

    config = chip_smoke._resnet50_config()
    weights = chip_smoke._seeded_keras_weights(config, shard_spec()["seed"])
    path = write_saved_model(str(tmp_path_factory.mktemp("k3r50")), weights)
    return path, KerasModelSpec(config, weights)


def test_the_committed_resnet50_export_matches_keras_module_and_the_jax_translation(resnet_saved_model, spy):
    path, spec = resnet_saved_model
    mf = ModelIngest.from_saved_model(path, device="cpu")
    x = (np.random.default_rng(5).random((2, 224, 224, 3)) * 255 - 120).astype(np.float32)
    y = mf(torch.from_numpy(x)).numpy()
    keras_y = ModelIngest.from_keras(spec, device="cpu")(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert y.shape == (2, 1000) and _rel(y, keras_y) <= 1e-4
    (node, args, outs), = spy.calls
    assert len(args) == 321 and len(outs) == 107
    assert _rel(outs[0], _jax_translation(node, args)[0]) <= 1e-5


def test_a_weight_written_in_place_is_read_at_the_next_call(mlp_export):
    _, sm = mlp_export
    model = _mlp_keras()  # a copy of the exported weights, changed below
    mf = ModelIngest.from_saved_model(sm, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(5, 4)).astype(np.float32))
    before = mf(x).numpy()
    np.testing.assert_allclose(before, np.asarray(model(x.numpy())), rtol=1e-5, atol=1e-6)
    layer = model.get_layer("d2")
    w, b = layer.get_weights()
    layer.set_weights([w * 0.5, b])
    state = mf.module.tf_state_dict()
    name = next(n for n, t in state.items() if tuple(t.shape) == w.shape and np.allclose(t.numpy(), w))
    with torch.no_grad():
        state[name].mul_(0.5)
    after = mf(x).numpy()
    assert np.abs(after - before).max() > 1e-3
    np.testing.assert_allclose(after, np.asarray(model(x.numpy())), rtol=1e-5, atol=1e-6)


def test_the_program_cache_holds_no_model_kernels(mlp_export):
    """A program left in the LRU keeps no kernel of a dropped model alive
    (the keys hold weights weakly); a bias it broadcast stays with the kept
    views until the program leaves the LRU."""
    import gc
    import weakref

    _, sm = mlp_export
    mf = ModelIngest.from_saved_model(sm, device="cpu")
    mf(torch.ones(3, 4))
    state = mf.module.tf_state_dict()
    kernels = [weakref.ref(t) for t in state.values() if t.dim() == 2]
    rest = [weakref.ref(t) for t in state.values() if t.dim() != 2]
    assert len(kernels) == 2 and tf_import._XCM_CACHE
    del mf, state
    gc.collect()
    assert all(r() is None for r in kernels)
    tf_import._XCM_CACHE.clear()
    gc.collect()
    assert all(r() is None for r in rest)


def test_a_data_shard_that_differs_fails_its_crc(resnet_saved_model, tmp_path):
    import shutil

    from sparkdl_tpu_torch.graph.tf_bundle import BundleError

    path, _ = resnet_saved_model
    bad = str(tmp_path / "bad")
    shutil.copytree(path, bad)
    shard = os.path.join(bad, "variables", "variables.data-00000-of-00001")
    with open(shard, "r+b") as f:
        f.seek(1000)
        byte = f.read(1)
        f.seek(1000)
        f.write(bytes([byte[0] ^ 1]))
    with pytest.raises(BundleError, match="CRC-32C"):
        ModelIngest.from_saved_model(bad, device="cpu")


def test_programs_are_kept_in_an_lru_of_16(mlp_export):
    _, sm = mlp_export
    mf = ModelIngest.from_saved_model(sm, device="cpu")
    tf_import._XCM_CACHE.clear()
    for n in range(1, 20):
        mf(torch.zeros(n, 4))
    assert len(tf_import._XCM_CACHE) == 16
    keys = list(tf_import._XCM_CACHE)
    assert keys[-1][1][-1] == (19, 4) and keys[0][1][-1] == (4, 4)
    assert len({id(p) for p in tf_import._XCM_CACHE.values()}) == 1  # one program serves every batch size
    mf(torch.zeros(4, 4))  # a hit moves to the end
    assert list(tf_import._XCM_CACHE)[-1][1][-1] == (4, 4)


def _graph_with_module(module: bytes, sout, n_inputs: int = 1):
    from tensorflow.core.framework import graph_pb2

    gd = graph_pb2.GraphDef()
    names = []
    for i in range(n_inputs):
        x = gd.node.add(name=f"x{i}", op="Placeholder")
        x.attr["dtype"].type = 1
        names.append(f"x{i}")
    call = gd.node.add(name="call", op="XlaCallModule", input=names)
    call.attr["module"].s = module
    call.attr["version"].i = 10
    call.attr["Tout"].list.type.append(1)
    shape = call.attr["Sout"].list.shape.add()
    for d in sout:
        shape.dim.add().size = d
    return tf_proto.parse("GraphDef", gd.SerializeToString())


def test_a_multi_platform_main_is_refused():
    exp = jax.export.export(jax.jit(lambda x: x * 2), platforms=("cpu", "cuda"))(
        jax.ShapeDtypeStruct((2, 3), jnp.float32))
    gd = _graph_with_module(exp.mlir_module_serialized, [2, 3])
    mod, fn = translate_graph_def(gd, ["x0:0"], ["call:0"])
    with pytest.raises(UnsupportedTFOpError, match="main takes 2 args, graph provides 1.*" + ITEM):
        fn(mod, torch.ones(2, 3))


def test_an_output_shape_that_cannot_be_inferred_is_refused():
    exp = jax.export.export(jax.jit(lambda x: x * 2))(jax.ShapeDtypeStruct((2, 3), jnp.float32))
    gd = _graph_with_module(exp.mlir_module_serialized, [-1, 3])
    mod, fn = translate_graph_def(gd, ["x0:0"], ["call:0"])
    with pytest.raises(UnsupportedTFOpError, match="output shape not inferable.*" + ITEM):
        fn(mod, torch.ones(2, 3))
    gd = _graph_with_module(exp.mlir_module_serialized, [2, 3])
    mod, fn = translate_graph_def(gd, ["x0:0"], ["call:0"])
    np.testing.assert_array_equal(fn(mod, torch.ones(2, 3)).numpy(), np.full((2, 3), 2.0, np.float32))


def test_chip_smoke_phase_29_rehearses_on_the_cpu(monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "X_IMAGES", 4)
    monkeypatch.setattr(chip_smoke, "X_BATCH", 2)
    assert chip_smoke.phase_stablehlo(0, "cpu", device="cpu") == 0
    out = capsys.readouterr().out
    assert "all 321 CRC-32C checks passed" in out and "flash launches 0" in out
    assert "torch ops dispatched per batch" in out and "phase 29:" in out
