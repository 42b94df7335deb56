"""The port stands alone: no module of ``sparkdl_tpu_torch`` and not
``chip_smoke.py`` (nor the fixture writers it imports, nor
``tools/torch_text_ab.py``) imports jax, flax, keras, tensorflow, h5py, pyarrow, pandas, orbax,
tensorstore, zstandard, ml_dtypes, flatbuffers or the JAX package, save pandas inside the functions of the pandas
surfaces (``functions.py``, ``dataframe/frame.py``, ``session.py``) and never at module level; the frame's
and the session's file, statistics and catalog paths load neither pandas nor pyarrow when they run, and an
entry point left at its default device refuses to run without CUDA."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import sparkdl_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO, "sparkdl_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "keras", "tensorflow", "h5py", "pyarrow", "pandas",
             "tensorstore", "zstandard", "ml_dtypes", "flatbuffers", "sparkdl_tpu")


def _port_files():
    # chip_smoke.py and what it imports or runs from outside the package
    files = [os.path.join(REPO, p) for p in ("chip_smoke.py", "tests/fixtures/orbax_writer.py",
                                             "tests/fixtures/tf_graph_writer.py", "tests/fixtures/keras3_shard.py",
                                             "tools/torch_text_ab.py")]
    for dirpath, _, names in os.walk(PKG_DIR):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


#: the port files that may import pandas inside a function (the pandas
#: surfaces), and never at module level
PANDAS_LOCAL = {os.path.join("sparkdl_tpu_torch", p) for p in ("functions.py", "dataframe/frame.py", "session.py")}


def _imports(path):
    """(root module, inside a function) of every absolute import in ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)

    def visit(node, local):
        for child in ast.iter_child_nodes(node):
            inner = local or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if isinstance(child, ast.Import):
                for alias in child.names:
                    yield alias.name.split(".")[0], inner
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module.split(".")[0], inner
            yield from visit(child, inner)

    yield from visit(tree, False)


def _imported_roots(path):
    for root, _local in _imports(path):
        yield root


def test_no_port_file_imports_jax_flax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10 and os.path.exists(files[0])
    rel = {os.path.relpath(path, PKG_DIR) for path in files}
    for sub in ("serving", "obs", "resilience", "runtime", "parallel", "estimators", "udf"):
        assert any(r.startswith(sub + os.sep) for r in rel), sub
    for required in ("graph/ingest.py", "graph/keras_graph.py", "graph/keras_file.py",
                     "runtime/native.py", "transformers/keras_image.py", "transformers/tensor.py",
                     "graph/hdf5.py", "models/keras_app_layers.py", "estimators/keras_fit.py",
                     "estimators/image_file_estimator.py", "serving/generation.py",
                     "runtime/locksmith.py", "runtime/heartbeat.py", "resilience/faults.py",
                     "resilience/supervisor.py", "resilience/__main__.py", "obs/timeseries.py",
                     "obs/fleet.py", "serving/gateway.py", "serving/canary_loader.py",
                     "utils/zstd.py", "graph/orbax_ckpt.py", "parallel/collectives.py",
                     "parallel/tensor_parallel.py", "parallel/pipeline_parallel.py",
                     "parallel/expert_parallel.py", "graph/mlir_bytecode.py", "graph/stablehlo.py",
                     "graph/jax_exported.py"):
        assert required.replace("/", os.sep) in rel, required
    offenders = {
        (os.path.relpath(path, REPO), root)
        for path in files
        for root, local in _imports(path)
        if root in FORBIDDEN
        and not (root == "pandas" and local and os.path.relpath(path, REPO) in PANDAS_LOCAL)
    }
    assert not offenders
    # the check tells the JAX package from the port's own prefix
    assert "sparkdl_tpu_torch" not in FORBIDDEN


def test_no_port_file_imports_pandas_at_module_level():
    """pandas stands only inside the functions of the pandas surfaces: each
    of those files imports it there, and no port file does at module
    level, so importing the port needs no pandas."""
    module_level = {
        os.path.relpath(path, REPO)
        for path in _port_files()
        for root, local in _imports(path)
        if root == "pandas" and not local
    }
    assert not module_level
    for rel in PANDAS_LOCAL:
        assert ("pandas", True) in set(_imports(os.path.join(REPO, rel))), rel


def test_importing_every_port_module_loads_no_jax():
    modules = [
        m.name
        for m in pkgutil.walk_packages(
            sparkdl_tpu_torch.__path__, "sparkdl_tpu_torch."
        )
    ]
    for name in (
        "sparkdl_tpu_torch.ops.flash_attention",
        "sparkdl_tpu_torch.runtime.feeder",
        "sparkdl_tpu_torch.runtime.readback",
        "sparkdl_tpu_torch.runtime.transfer",
        "sparkdl_tpu_torch.graph.precision",
        "sparkdl_tpu_torch.obs.trace",
        "sparkdl_tpu_torch.resilience.policy",
        "sparkdl_tpu_torch.serving.request",
        "sparkdl_tpu_torch.serving.residency",
        "sparkdl_tpu_torch.serving.generation",
        "sparkdl_tpu_torch.serving.router",
        "sparkdl_tpu_torch.serving.server",
        "sparkdl_tpu_torch.serving.__main__",
        "sparkdl_tpu_torch.runtime.executor",
        "sparkdl_tpu_torch.parallel",
        "sparkdl_tpu_torch.parallel.mesh",
        "sparkdl_tpu_torch.parallel.distributed",
        "sparkdl_tpu_torch.parallel.data_parallel",
        "sparkdl_tpu_torch.parallel.collectives",
        "sparkdl_tpu_torch.parallel.tensor_parallel",
        "sparkdl_tpu_torch.parallel.pipeline_parallel",
        "sparkdl_tpu_torch.parallel.expert_parallel",
        "sparkdl_tpu_torch.estimators.data_parallel_estimator",
        "sparkdl_tpu_torch.evaluation",
        "sparkdl_tpu_torch.persistence",
        "sparkdl_tpu_torch.udf",
        "sparkdl_tpu_torch.udf.registry",
        "sparkdl_tpu_torch.sql",
        "sparkdl_tpu_torch.session",
        "sparkdl_tpu_torch.tuning",
        "sparkdl_tpu_torch.graph.ingest",
        "sparkdl_tpu_torch.graph.keras_graph",
        "sparkdl_tpu_torch.graph.keras_file",
        "sparkdl_tpu_torch.runtime.native",
        "sparkdl_tpu_torch.transformers.keras_image",
        "sparkdl_tpu_torch.transformers.tensor",
        "sparkdl_tpu_torch.graph.hdf5",
        "sparkdl_tpu_torch.models.keras_app_layers",
        "sparkdl_tpu_torch.estimators.keras_fit",
        "sparkdl_tpu_torch.estimators.image_file_estimator",
        # the supervised serving gang
        "sparkdl_tpu_torch.runtime.locksmith",
        "sparkdl_tpu_torch.runtime.heartbeat",
        "sparkdl_tpu_torch.resilience",
        "sparkdl_tpu_torch.resilience.faults",
        "sparkdl_tpu_torch.resilience.supervisor",
        "sparkdl_tpu_torch.resilience.__main__",
        "sparkdl_tpu_torch.obs.timeseries",
        "sparkdl_tpu_torch.obs.fleet",
        "sparkdl_tpu_torch.obs.export",
        "sparkdl_tpu_torch.serving.gateway",
        "sparkdl_tpu_torch.serving.canary_loader",
        # the rest of model ingestion
        "sparkdl_tpu_torch.utils.zstd",
        "sparkdl_tpu_torch.graph.orbax_ckpt",
    ):
        assert name in modules, name
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_the_frame_and_session_paths_load_no_pandas_or_pyarrow(tmp_path):
    """Every reader and writer, the statistics, NA, partitioning and
    catalog paths run in a fresh process; neither pandas nor pyarrow (nor
    any other forbidden module) is loaded after."""
    code = f"""
import sys
import numpy as np
from sparkdl_tpu_torch.session import SparkSession
from sparkdl_tpu_torch import functions as F
spark = SparkSession.builder.enableHiveSupport().getOrCreate()
df = spark.createDataFrame([(i, "k%d" % (i % 3), float(i) / 3, None if i % 4 else "x") for i in range(12)],
                           "id long, k string, v double, s string")
df = df.withColumn("emb", lambda r: np.full(3, r["v"], np.float32))
for fmt in ("parquet", "json"):
    df.write.mode("overwrite").format(fmt).save(r"{tmp_path}/t." + fmt)
    back = spark.read.format(fmt).load(r"{tmp_path}/t." + fmt)
df.drop("emb").write.csv(r"{tmp_path}/t.csv", header=True)
back = spark.read.option("header", "true").csv(r"{tmp_path}/t.csv")
back.select("k").write.text(r"{tmp_path}/t.txt")
spark.read.text(r"{tmp_path}/t.txt").collect()
df.describe().collect(); df.summary("10%").collect(); df.corr("id", "v"); df.cov("id", "v")
df.approxQuantile("v", [0.5]); df.crosstab("k", "s").collect(); df.freqItems(["k"]).collect()
df.sample(0.5, 1).collect(); df.stat.sampleBy("k", {{"k0": 0.5}}, 1).collect()
df.dropna().collect(); df.na.fill("y").collect(); df.na.replace("k0", "z", ["k"]).collect()
df.melt("id", ["k"]).collect(); df.repartition(2).coalesce(1).collect()
df.repartitionByRange(2, "v").sortWithinPartitions(F.col("v").desc()).collect()
df.toJSON(); list(df.toLocalIterator()); df.foreach(lambda r: None)
df.createGlobalTempView("g"); spark.sql("SELECT k, count(*) AS n FROM global_temp.g GROUP BY k").collect()
spark.catalog.listTables("global_temp"); spark.catalog.listColumns("g", "global_temp")
spark.catalog.dropGlobalTempView("g"); spark.range(5).join(df, "id").collect()
spark.conf.set("a", "b"); spark.conf.get("a")
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_package_exports_resolve():
    import sparkdl_tpu_torch.tuning as tuning

    for name in sparkdl_tpu_torch.__all__:
        assert getattr(sparkdl_tpu_torch, name) is not None, name
    assert sparkdl_tpu_torch.CrossValidator is tuning.CrossValidator
    with pytest.raises(AttributeError):
        sparkdl_tpu_torch.not_an_export


def test_parallel_exports_match_the_jax_package():
    """The port's ``parallel`` exports every name of the JAX package's
    ``__all__`` (read from its source, not imported) but its sharding
    helpers, which a process group has no use for, and adds its ``Mesh``."""
    import sparkdl_tpu_torch.parallel as port_parallel

    path = os.path.join(REPO, "sparkdl_tpu", "parallel", "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    jax_all = next(
        ast.literal_eval(node.value) for node in tree.body
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets)
    )
    shardings = {"batch_sharding", "replicated", "shard_batch"}
    assert set(port_parallel.__all__) - {"Mesh"} == set(jax_all) - shardings
    for name in ("pipeline_apply", "stack_stage_params", "shard_dense_params", "tp_block_sharded", "tp_mlp",
                 "moe_apply", "switch_route"):
        assert callable(getattr(port_parallel, name)), name


def test_default_device_entry_point_raises_without_cuda(monkeypatch):
    import numpy as np

    from sparkdl_tpu_torch.dataframe import DataFrame
    from sparkdl_tpu_torch.estimators import (
        LogisticRegression,
        LogisticRegressionModel,
    )
    from sparkdl_tpu_torch.models import get_model
    from sparkdl_tpu_torch.runtime.device import resolve_device
    from sparkdl_tpu_torch.transformers.named_image import (
        DeepImageFeaturizer,
        DeepImagePredictor,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("bert-tiny").model_function()
    for name in ("ResNet50", "InceptionV3"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model(name).model_function()
    images = DataFrame.fromColumns({"image": [None]})
    featurizer = DeepImageFeaturizer(
        inputCol="image", outputCol="features", modelName="ResNet50"
    )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        featurizer.transform(images)
    predictor = DeepImagePredictor(
        inputCol="image", outputCol="pred", modelName="MobileNetV2",
        decodePredictions=True,
    )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predictor.transform(images)
    rows = DataFrame.fromColumns({"features": [np.ones(2)], "label": [0]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LogisticRegression().fit(rows)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LogisticRegressionModel(np.ones((2, 1)), np.ones(1), "f", "p", None)
    from sparkdl_tpu_torch.serving import ResidencyManager, Router

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Router()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResidencyManager()
    # the trainer and what it builds on
    from sparkdl_tpu_torch.estimators import DataParallelEstimator
    from sparkdl_tpu_torch.graph.function import ModelFunction

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelFunction.from_module(torch.nn.Linear(2, 2))
    mf = ModelFunction.from_module(torch.nn.Linear(2, 2), device="cpu")
    labelled = DataFrame.fromColumns({"features": [np.ones(2, np.float32)], "label": [0]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DataParallelEstimator(model=mf, inputCol="features").fit(labelled)
    # SQL scoring: a registration builds or takes its model on cuda
    from sparkdl_tpu_torch.udf import registerKerasImageUDF, registerModelUDF

    with pytest.raises(RuntimeError, match="device='cpu'"):
        registerKerasImageUDF("no_card", "MobileNetV2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registerModelUDF("no_card", mf)
    # Keras models: ingest, the transformers (a stage built over a spec)
    from sparkdl_tpu_torch.graph.ingest import ModelIngest
    from sparkdl_tpu_torch.graph.keras_graph import KerasModelSpec
    from sparkdl_tpu_torch.transformers import KerasImageFileTransformer, KerasTransformer

    spec = KerasModelSpec({"name": "head", "layers": [
        {"class_name": "InputLayer", "config": {"name": "in", "batch_shape": [None, 2]}},
        {"class_name": "Dense", "config": {"name": "fc", "units": 1}},
    ]}, {"fc": [np.ones((2, 1), np.float32), np.zeros(1, np.float32)]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelIngest.from_keras(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelIngest.from_callable(lambda x: x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KerasTransformer(inputCol="x", outputCol="y", model=spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KerasImageFileTransformer(inputCol="uri", outputCol="y", model=spec).transform(
            DataFrame.fromColumns({"uri": [None]}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registerKerasImageUDF("no_card", spec)
    assert ModelIngest.from_keras(spec, device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    # fine-tuning a Keras model: no CPU training behind the caller's back
    from sparkdl_tpu_torch.estimators import ImageFileEstimator

    est = ImageFileEstimator(inputCol="x", labelCol="y", model=spec, imageLoader=lambda u: np.ones(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        est._fit_on_arrays(np.ones((2, 2), np.float32), np.ones((2, 1), np.float32))
