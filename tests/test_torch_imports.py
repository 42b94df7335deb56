"""The port stands alone: no module of ``sparkdl_tpu_torch`` and not
``chip_smoke.py`` imports jax, flax, keras, tensorflow, h5py or the JAX
package, and an entry point left at its default device refuses to run
without CUDA."""

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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "keras", "tensorflow", "h5py", "sparkdl_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG_DIR):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_flax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10 and os.path.exists(files[0])
    rel = {os.path.relpath(path, PKG_DIR) for path in files}
    for sub in ("serving", "obs", "resilience", "runtime", "parallel", "estimators", "udf"):
        assert any(r.startswith(sub + os.sep) for r in rel), sub
    for required in ("graph/ingest.py", "graph/keras_graph.py", "graph/keras_file.py",
                     "runtime/native.py", "transformers/keras_image.py", "transformers/tensor.py",
                     "graph/hdf5.py", "models/keras_app_layers.py", "estimators/keras_fit.py",
                     "estimators/image_file_estimator.py", "serving/generation.py"):
        assert required.replace("/", os.sep) in rel, required
    offenders = {
        (os.path.relpath(path, REPO), root)
        for path in files
        for root in _imported_roots(path)
        if root in FORBIDDEN
    }
    assert not offenders
    # the check tells the JAX package from the port's own prefix
    assert "sparkdl_tpu_torch" not in FORBIDDEN


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


def test_package_exports_resolve():
    import sparkdl_tpu_torch.tuning as tuning

    for name in sparkdl_tpu_torch.__all__:
        assert getattr(sparkdl_tpu_torch, name) is not None, name
    assert sparkdl_tpu_torch.CrossValidator is tuning.CrossValidator
    with pytest.raises(AttributeError):
        sparkdl_tpu_torch.not_an_export


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
