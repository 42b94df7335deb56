#!/usr/bin/env python3
"""Write stages saved by the JAX package (``sparkdl_tpu``), which the port
loads with ``sparkdl_tpu_torch.persistence.load`` on a machine without
JAX (``chip_smoke.py`` phase 23(a)) and in ``tests/test_torch_jax_stages.py``:

- ``jax_stages/resnet50_lr/``: a ``PipelineModel`` of
  ``DeepImageFeaturizer(modelName="ResNet50")`` with no ``weightsFile``,
  then a ``LogisticRegressionModel`` with ``w [2048, 2]`` and ``b [2]``
  drawn from a seed;
- ``jax_stages/keras_cnn/``: a ``KerasImageFileTransformer`` whose
  ``model=`` (``keras_cnn.keras``, from ``make_keras_cnn_fixtures.py``) the
  JAX package embeds as ``model.keras``.

The stages get fixed uids, so the files are the same on every run but
for the timestamps inside ``metadata.json`` and the zip members'. About
70 KB. Needs the JAX package and keras; run from the repository root:

    JAX_PLATFORMS=cpu KERAS_BACKEND=jax python3 tests/fixtures/make_jax_stage_fixtures.py
"""

import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "jax_stages")
SEED = 18
FEATURES = 2048  # ResNet50's pooled features
CLASSES = 2


def lr_weights():
    rng = np.random.default_rng(SEED)
    w = rng.normal(0.0, 0.05, (FEATURES, CLASSES)).astype(np.float32)
    b = rng.normal(0.0, 0.1, (CLASSES,)).astype(np.float32)
    return w, b


def _fixed_uid(stage, uid):
    stage._reset_uid(uid)
    return stage


def write(out_dir: str = OUT) -> None:
    """Write both stages under ``out_dir`` (replacing what is there)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import keras

    from sparkdl_tpu.estimators.logistic_regression import LogisticRegressionModel
    from sparkdl_tpu.pipeline import PipelineModel
    from sparkdl_tpu.transformers import DeepImageFeaturizer, KerasImageFileTransformer

    w, b = lr_weights()
    featurizer = _fixed_uid(
        DeepImageFeaturizer(inputCol="image", outputCol="features", modelName="ResNet50"),
        "DeepImageFeaturizer_fixture",
    )
    head = _fixed_uid(
        LogisticRegressionModel(w=w, b=b, featuresCol="features", predictionCol="prediction",
                                probabilityCol="probability"),
        "LogisticRegressionModel_fixture",
    )
    pipeline = _fixed_uid(PipelineModel(stages=[featurizer, head]), "PipelineModel_fixture")
    cnn = _fixed_uid(
        KerasImageFileTransformer(inputCol="uri", outputCol="scores", batchSize=4, preprocessing="tf",
                                  model=keras.saving.load_model(os.path.join(HERE, "keras_cnn.keras"))),
        "KerasImageFileTransformer_fixture",
    )
    os.makedirs(out_dir, exist_ok=True)
    for name, stage in (("resnet50_lr", pipeline), ("keras_cnn", cnn)):
        path = os.path.join(out_dir, name)
        shutil.rmtree(path, ignore_errors=True)
        stage.save(path)


if __name__ == "__main__":
    os.environ.setdefault("KERAS_BACKEND", "jax")
    write()
    print(f"wrote {OUT}")
