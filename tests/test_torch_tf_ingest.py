"""TF model ingestion in the port (``TFInputGraph``) against the JAX
package's and TF's, on the CPU.

The parity matrix: the committed fixture model (``tests/fixtures/tf_model``,
written by ``make_tf_fixtures.py``) as a frozen GraphDef, a SavedModel and
a TF1 checkpoint gives TF's stored outputs through each door, the JAX
package's doors give the same, and the three agree with each other;
signature keys and dict outputs in sorted-key order; ``TFImageTransformer``
over Keras's frozen CNN against the JAX ``TFImageTransformer``; the
GraphDef writer that ``chip_smoke.py`` uses, against TF's parser and TF's
own frozen graph; the JAX package's params carried across; the TF-era
names; and, in a subprocess, that the port's ingestion imports no jax,
tensorflow, protobuf or JAX package.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame  # noqa: E402
from sparkdl_tpu.graph import tf_import as jax_tf_import  # noqa: E402
from sparkdl_tpu.graph.ingest import ModelIngest as JaxIngest  # noqa: E402
from sparkdl_tpu.image import imageIO as jax_imageIO  # noqa: E402
from sparkdl_tpu.transformers.image_model import TFImageTransformer as JaxTFImageTransformer  # noqa: E402
from sparkdl_tpu_torch.dataframe import DataFrame  # noqa: E402
from sparkdl_tpu_torch.graph import tf_import  # noqa: E402
from sparkdl_tpu_torch.graph.function import ModelFunction  # noqa: E402
from sparkdl_tpu_torch.graph.ingest import ModelIngest, TFInputGraph  # noqa: E402
from sparkdl_tpu_torch.graph.keras_file import read_keras_file  # noqa: E402
from sparkdl_tpu_torch.image import imageIO  # noqa: E402
from sparkdl_tpu_torch.transformers.image_model import ImageModelTransformer, TFImageTransformer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
TF_MODEL = os.path.join(FIXTURES, "tf_model")
sys.path.insert(0, FIXTURES)
from tf_graph_writer import frozen_graph_def  # noqa: E402

IO = np.load(os.path.join(TF_MODEL, "io.npz"))
GD_INPUTS, GD_OUTPUTS = [str(s) for s in IO["gd_inputs"]], [str(s) for s in IO["gd_outputs"]]
FROZEN = os.path.join(TF_MODEL, "frozen.pb")
SAVED = os.path.join(TF_MODEL, "saved_model")
CKPT = os.path.join(TF_MODEL, "ckpt", "model")


def _doors(ingest, **kw):
    return {
        "graph_def": ingest.from_graph_def(FROZEN, GD_INPUTS, GD_OUTPUTS, **kw),
        "saved_model": ingest.from_saved_model(SAVED, **kw),
        "checkpoint": ingest.from_tf_checkpoint(CKPT, inputs=["image"], outputs=["features", "probs"], **kw),
    }


@pytest.fixture(scope="module")
def port_doors():
    return _doors(ModelIngest, device="cpu")


@pytest.fixture(scope="module")
def jax_doors():
    return _doors(JaxIngest)


def _np(outputs):
    return [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in outputs]


@pytest.mark.parametrize("door", ["graph_def", "saved_model", "checkpoint"])
def test_each_door_gives_tf_and_the_jax_package(door, port_doors, jax_doors):
    features, probs = _np(port_doors[door](torch.from_numpy(IO["x"])))
    np.testing.assert_allclose(features, IO["features"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(probs, IO["probs"], rtol=1e-5, atol=1e-6)
    jax_features, jax_probs = _np(jax_doors[door](IO["x"]))
    np.testing.assert_allclose(features, jax_features, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(probs, jax_probs, rtol=1e-5, atol=1e-6)


def test_the_three_formats_agree(port_doors):
    outs = [_np(mf(IO["x"])) for mf in port_doors.values()]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    # the same weights, lifted under each format's node names
    sizes = [sorted(v.numel() for v in mf.module.tf_state_dict().values()) for mf in port_doors.values()]
    assert sizes[0] == [32, 216] and sizes[1] == sizes[2] == [8, 32, 216]


def test_signature_keys_and_sorted_dict_outputs(port_doors, jax_doors):
    """Signature keys name feeds and fetches; omitted, the outputs come in
    sorted-key order (features before probs), as TF flattens the dict."""
    mf = ModelIngest.from_saved_model(SAVED, inputs=["image"], outputs=["probs"], device="cpu")
    np.testing.assert_allclose(mf(IO["x"]).numpy(), IO["probs"], rtol=1e-5, atol=1e-6)
    jax_mf = JaxIngest.from_saved_model(SAVED, inputs=["image"], outputs=["probs"])
    np.testing.assert_allclose(mf(IO["x"]).numpy(), np.asarray(jax_mf(IO["x"])), rtol=1e-5, atol=1e-6)
    both = ModelIngest.from_saved_model(SAVED, outputs=["probs", "features"], device="cpu")
    probs, features = _np(both(IO["x"]))
    np.testing.assert_allclose(features, IO["features"], rtol=1e-5, atol=1e-6)
    default = port_doors["saved_model"]
    assert default.name == "saved_model:serving_default" == jax_doors["saved_model"].name
    assert default.input_shape == (8, 8, 3) == tuple(jax_doors["saved_model"].input_shape)
    assert default.takes_nhwc and default.device == torch.device("cpu")
    with pytest.raises(KeyError, match="no signature"):
        ModelIngest.from_saved_model(SAVED, signature="missing", device="cpu")
    with pytest.raises(KeyError, match="no MetaGraphDef"):
        ModelIngest.from_saved_model(SAVED, tag_set="train", device="cpu")


def test_graph_def_sources_and_the_default_device(port_doors):
    with open(FROZEN, "rb") as f:
        raw = f.read()
    proto = tf.compat.v1.GraphDef.FromString(raw)
    want = _np(port_doors["graph_def"](IO["x"]))
    for source in (raw, bytearray(raw), proto):
        got = _np(ModelIngest.from_graph_def(source, GD_INPUTS, GD_OUTPUTS, device="cpu")(IO["x"]))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError):
        ModelIngest.from_graph_def(3, GD_INPUTS, GD_OUTPUTS, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ModelIngest.from_graph_def(raw, GD_INPUTS, GD_OUTPUTS)


def _structs(n, side, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.integers(0, 256, (side, side, 3), dtype=np.uint8) for _ in range(n)]
    return ([imageIO.imageArrayToStruct(a, origin=f"s/{i}") for i, a in enumerate(arrays)] + [None],
            [jax_imageIO.imageArrayToStruct(a, origin=f"s/{i}") for i, a in enumerate(arrays)] + [None])


def test_tf_image_transformer_against_the_jax_package():
    """TFImageTransformer over Keras's frozen CNN (16x16x3, 5 classes) from
    TF, against the JAX package's TFImageTransformer over the same bytes:
    vector rows at 1e-5, the null row null."""
    io = np.load(os.path.join(FIXTURES, "keras_cnn_frozen_io.npz"))
    pb = os.path.join(FIXTURES, "keras_cnn_frozen.pb")
    ins, outs = [str(s) for s in io["inputs"]], [str(s) for s in io["outputs"]]
    mf = TFInputGraph.from_graph_def(pb, ins, outs, input_shape=(16, 16, 3), device="cpu")
    jax_mf = JaxIngest.from_graph_def(pb, ins, outs, input_shape=(16, 16, 3))
    assert mf.takes_nhwc
    ours, theirs = _structs(9, 16, 4)
    kw = dict(inputCol="image", outputCol="out", outputMode="vector", batchSize=4, preprocessing="tf")
    got = TFImageTransformer(modelFunction=mf, **kw).transform(
        DataFrame.fromColumns({"image": ours}, numPartitions=2)).collect()
    want = JaxTFImageTransformer(modelFunction=jax_mf, **kw).transform(
        JaxDataFrame.fromColumns({"image": theirs}, numPartitions=2)).collect()
    assert got[-1].out is None and want[-1].out is None
    g = np.stack([np.asarray(r.out) for r in got[:-1]])
    w = np.stack([np.asarray(r.out) for r in want[:-1]])
    assert g.shape == (9, 5)
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    assert TFImageTransformer is ImageModelTransformer


@pytest.fixture(scope="module")
def written():
    spec = read_keras_file(os.path.join(FIXTURES, "keras_cnn.keras"))
    return frozen_graph_def(spec)


def _run_tf(graph_def, feed, fetch, x):
    graph = tf.Graph()
    with graph.as_default():
        tf.import_graph_def(graph_def, name="")
        with tf.compat.v1.Session(graph=graph) as sess:
            return sess.run(fetch, {feed: x})


def test_the_writer_against_tf_parser_and_tf_frozen_graph(written):
    raw, feed, fetch = written
    parsed = tf.compat.v1.GraphDef.FromString(raw)
    ops = {n.op for n in parsed.node}
    assert {"Placeholder", "Const", "Conv2D", "BiasAdd", "FusedBatchNormV3", "Relu", "Relu6",
            "DepthwiseConv2dNative", "MaxPool", "Mean", "MatMul", "Softmax", "Identity"} == ops
    x = np.load(os.path.join(FIXTURES, "keras_cnn_io.npz"))["x"]
    io = np.load(os.path.join(FIXTURES, "keras_cnn_frozen_io.npz"))
    frozen = tf.compat.v1.GraphDef.FromString(open(os.path.join(FIXTURES, "keras_cnn_frozen.pb"), "rb").read())
    want = _run_tf(frozen, str(io["inputs"][0]), str(io["outputs"][0]), x)
    np.testing.assert_allclose(want, io["y"], rtol=1e-6)
    np.testing.assert_allclose(_run_tf(parsed, feed, fetch, x), want, rtol=1e-5, atol=1e-6)
    port = ModelIngest.from_graph_def(raw, [feed], [fetch], device="cpu")(x).numpy()
    np.testing.assert_allclose(port, want, rtol=1e-5, atol=1e-6)


def test_jax_params_carried_across(written):
    """The JAX package's translated params (keyed by TF node name) load
    into the port's module bit for bit, and the port then gives the JAX
    package's outputs."""
    raw, feed, fetch = written
    jax_fn, jax_params = jax_tf_import.translate_graph_def(tf.compat.v1.GraphDef.FromString(raw), [feed], [fetch])
    mf = ModelIngest.from_graph_def(raw, [feed], [fetch], device="cpu")
    own = {k: v.clone() for k, v in mf.module.tf_state_dict().items()}
    assert set(own) == set(jax_params) and len(own) == 5
    for buf in mf.module.tf_state_dict().values():
        buf.zero_()
    tf_import.load_translated_params(mf.module, {k: np.asarray(v) for k, v in jax_params.items()})
    for k, v in mf.module.tf_state_dict().items():
        assert torch.equal(v, own[k]), k
    x = np.load(os.path.join(FIXTURES, "keras_cnn_io.npz"))["x"]
    np.testing.assert_allclose(mf(x).numpy(), np.asarray(jax_fn(jax_params, x)), rtol=1e-5, atol=1e-6)


def test_tf_era_names():
    import sparkdl_tpu_torch
    from sparkdl_tpu_torch import graph

    assert sparkdl_tpu_torch.TFInputGraph is ModelIngest is TFInputGraph
    assert sparkdl_tpu_torch.TFImageTransformer is ImageModelTransformer
    assert sparkdl_tpu_torch.GraphFunction is ModelFunction is graph.GraphFunction
    from sparkdl_tpu_torch.transformers import TFImageTransformer as exported

    assert exported is ImageModelTransformer
    with pytest.raises(NotImplementedError, match="no counterpart in the port"):
        sparkdl_tpu_torch.IsolatedSession()
    spec = sparkdl_tpu_torch.imageInputPlaceholder(3)
    assert spec.tensor_name == "sparkdl_image_input:0" and spec.shape == (None, None, None, 3)

    @tf.function
    def g(img):
        return tf.reduce_mean(img, axis=[1, 2])

    cf = g.get_concrete_function(tf.TensorSpec((None, 4, 4, 3), tf.float32, name="sparkdl_image_input"))
    mf = ModelIngest.from_graph_def(cf.graph.as_graph_def(), inputs=[spec.tensor_name],
                                    outputs=[cf.outputs[0].name], device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(mf(x).numpy(), g(tf.constant(x)).numpy(), rtol=1e-5, atol=1e-6)
    assert mf.takes_nhwc  # a rank-4 placeholder


_NO_TF_SCRIPT = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, os.path.join(sys.argv[1], "tests", "fixtures"))
from sparkdl_tpu_torch import TFInputGraph, TFImageTransformer, GraphFunction, imageInputPlaceholder
from sparkdl_tpu_torch.graph import tf_bundle, tf_import, tf_proto
from sparkdl_tpu_torch.graph.keras_file import read_keras_file
from tf_graph_writer import frozen_graph_def
model = os.path.join(sys.argv[1], "tests", "fixtures", "tf_model")
io = np.load(os.path.join(model, "io.npz"))
x = io["x"]
outs = [
    TFInputGraph.from_graph_def(os.path.join(model, "frozen.pb"), [str(s) for s in io["gd_inputs"]],
                                [str(s) for s in io["gd_outputs"]], device="cpu")(x),
    TFInputGraph.from_saved_model(os.path.join(model, "saved_model"), device="cpu")(x),
    TFInputGraph.from_tf_checkpoint(os.path.join(model, "ckpt", "model"), ["image"], ["features", "probs"],
                                    device="cpu")(x),
]
err = max(float(np.abs(o[1].numpy() - io["probs"]).max()) for o in outs)
raw, feed, fetch = frozen_graph_def(read_keras_file(os.path.join(sys.argv[1], "tests", "fixtures", "keras_cnn.keras")))
TFInputGraph.from_graph_def(raw, [feed], [fetch], device="cpu")
roots = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"err": err, "roots": roots, "protobuf": "google.protobuf" in sys.modules}))
"""


def test_ingestion_imports_no_tf_protobuf_or_jax(tmp_path):
    script = tmp_path / "no_tf.py"
    script.write_text(_NO_TF_SCRIPT)
    env = {k: v for k, v in os.environ.items() if k not in ("KERAS_BACKEND",)}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, str(script), REPO], capture_output=True, text=True, timeout=300,
                       env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["err"] < 1e-6
    assert not out["protobuf"]
    for forbidden in ("jax", "jaxlib", "tensorflow", "keras", "sparkdl_tpu", "flax"):
        assert forbidden not in out["roots"], forbidden
