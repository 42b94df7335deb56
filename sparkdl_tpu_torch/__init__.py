"""PyTorch/CUDA port of the Deep Learning Pipelines library for NVIDIA Hopper.

A second package beside ``sparkdl_tpu`` (the JAX reference). It imports
``torch`` and never ``jax``, ``flax`` or ``sparkdl_tpu``; host modules the
slice needs are kept here as copies. Module names follow the JAX package's
so each module's counterpart is easy to find.

What it covers today:

- the image main path: an image DataFrame (``image.imageIO``) through
  :class:`~sparkdl_tpu_torch.transformers.named_image.DeepImageFeaturizer`
  (ResNet50 on cuDNN) into
  :class:`~sparkdl_tpu_torch.estimators.LogisticRegression`, composed by
  :class:`~sparkdl_tpu_torch.pipeline.Pipeline`;
- the BERT text-embedding path: a text DataFrame through
  :class:`~sparkdl_tpu_torch.transformers.text.TextEmbedder`, the hashing
  tokenizer and sequence-length buckets, into
  :class:`~sparkdl_tpu_torch.models.bert.BertEncoder`, whose attention
  runs the hand-written CUDA kernel in ``csrc/flash_attention.cu``;
- online serving (``serving/``) over the shared device feeder;
- partitions run at once by ``runtime/executor.py``, their rows coalesced
  by the shared feeder;
- data-parallel training over a ``torch.distributed`` process group:
  :class:`~sparkdl_tpu_torch.estimators.DataParallelEstimator`
  (``parallel/``), the evaluators and stage persistence;
- SQL scoring: a model registered as a UDF
  (:func:`~sparkdl_tpu_torch.udf.registerKerasImageUDF`) and called from
  :func:`~sparkdl_tpu_torch.sql.sql` over a temp view, inside the JAX
  dialect's row expressions (CASE, CAST, ``||``, the row builtins,
  higher-order functions over lambdas), with projection and predicate
  pushdown (``sql.py``, ``sql_builtins.py``, ``session.py``); the same
  expressions as Columns (``functions`` as ``F``: ``col``, ``lit``,
  ``when``, ``expr``, the builtins, ``udf``) in ``DataFrame.select``,
  ``withColumn``, ``filter`` and ``orderBy`` (``dataframe/column.py``);
  the relational core (joins, GROUP BY, set operations, CTEs,
  subqueries), windows (``OVER``, ``Window``/``WindowSpec``,
  ``Column.over``), the generators and LATERAL VIEW, and the
  partition-seeded ``rand``/``randn``/ids;
- stages saved by the JAX package load here
  (``persistence.load`` maps their ``sparkdl_tpu`` class paths);
- model selection: ``CrossValidator`` and ``TrainValidationSplit`` over
  ``Estimator.fitMultiple`` (``tuning.py``);
- Keras models, translated into torch without keras
  (``graph/keras_graph.py``, ``graph/ingest.py``): a column of image
  file URIs through
  :class:`~sparkdl_tpu_torch.transformers.keras_image.KerasImageFileTransformer`
  (decoded by the C++ image bridge, ``runtime/native.py``), and array
  columns through ``KerasTransformer``/``ModelTransformer``; Keras model
  and weight files read by the port's own HDF5 reader (``graph/hdf5.py``);
  fine-tuning with
  :class:`~sparkdl_tpu_torch.estimators.ImageFileEstimator`
  (``KerasImageFileEstimator``), Keras's optimizers and losses by name;
- the serving control plane (``obs/``): the SLO engine, the device-memory
  and utilization ledgers with the ``serve.mfu`` gauge, and the canary
  rollout in the router;
- TF models (``TFInputGraph``: a frozen GraphDef, a SavedModel, a TF1
  checkpoint), read without TensorFlow or protobuf and translated once
  into torch ops (``graph/tf_proto.py``, ``tf_bundle.py``,
  ``tf_import.py``), scored by ``TFImageTransformer`` and
  ``TFTransformer``;
- exported programs (``ModelFunction.export``/``load``,
  ``ModelIngest.from_exported``: ``torch.export``, with the flash kernel
  as the registered op ``sparkdl_tpu_torch::flash_attention``) and orbax
  checkpoints read without orbax (``ModelIngest.from_orbax_checkpoint``,
  ``graph/orbax_ckpt.py`` over the port's zstd decoder ``utils/zstd.py``).

Two modules of the JAX package need no counterpart here: torch builds a
model's weights on the host, so ``SPARKDL_BERT_INIT=host`` has nothing to
choose, and the port runs eagerly, with nothing compiled to cache, so
``runtime/compile_cache.py`` has nothing to keep.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with the default device and no CUDA card they raise. The names below are
exported lazily: importing the package imports none of its modules
(``sparkdl_tpu_torch.sql`` is the module; its ``sql`` is the function).
"""

__version__ = "0.1.0"

_EXPORTS = {
    "DataFrame": "sparkdl_tpu_torch.dataframe",
    "Row": "sparkdl_tpu_torch.dataframe",
    "imageIO": "sparkdl_tpu_torch.image",
    "ModelFunction": "sparkdl_tpu_torch.graph.function",
    "ModelIngest": "sparkdl_tpu_torch.graph.ingest",
    "TFInputGraph": "sparkdl_tpu_torch.graph.ingest",
    "GraphFunction": "sparkdl_tpu_torch.graph",
    "IsolatedSession": "sparkdl_tpu_torch.graph",
    "imageInputPlaceholder": "sparkdl_tpu_torch.graph.pieces",
    "Transformer": "sparkdl_tpu_torch.pipeline",
    "Estimator": "sparkdl_tpu_torch.pipeline",
    "Pipeline": "sparkdl_tpu_torch.pipeline",
    "PipelineModel": "sparkdl_tpu_torch.pipeline",
    "ImageModelTransformer": "sparkdl_tpu_torch.transformers.image_model",
    "TFImageTransformer": "sparkdl_tpu_torch.transformers.image_model",
    "DeepImageFeaturizer": "sparkdl_tpu_torch.transformers.named_image",
    "DeepImagePredictor": "sparkdl_tpu_torch.transformers.named_image",
    "KerasImageFileTransformer": "sparkdl_tpu_torch.transformers.keras_image",
    "KerasTransformer": "sparkdl_tpu_torch.transformers.tensor",
    "ModelTransformer": "sparkdl_tpu_torch.transformers.tensor",
    "TFTransformer": "sparkdl_tpu_torch.transformers.tensor",
    "LogisticRegression": "sparkdl_tpu_torch.estimators",
    "DataParallelEstimator": "sparkdl_tpu_torch.estimators",
    "HorovodEstimator": "sparkdl_tpu_torch.estimators",
    "ImageFileEstimator": "sparkdl_tpu_torch.estimators",
    "KerasImageFileEstimator": "sparkdl_tpu_torch.estimators",
    "registerImageUDF": "sparkdl_tpu_torch.udf",
    "registerKerasImageUDF": "sparkdl_tpu_torch.udf",
    "registerModelUDF": "sparkdl_tpu_torch.udf",
    "makeGraphUDF": "sparkdl_tpu_torch.udf",
    "SQLContext": "sparkdl_tpu_torch.sql",
    # column expressions (from sparkdl_tpu_torch import functions as F)
    "Column": "sparkdl_tpu_torch.dataframe.column",
    "col": "sparkdl_tpu_torch.functions",
    "lit": "sparkdl_tpu_torch.functions",
    "when": "sparkdl_tpu_torch.functions",
    "Window": "sparkdl_tpu_torch.dataframe.window",
    "WindowSpec": "sparkdl_tpu_torch.dataframe.window",
    "functions": "sparkdl_tpu_torch",
    "F": "sparkdl_tpu_torch",
    "registerDataFrameAsTable": "sparkdl_tpu_torch.sql",
    "Evaluator": "sparkdl_tpu_torch.evaluation",
    "MulticlassClassificationEvaluator": "sparkdl_tpu_torch.evaluation",
    "BinaryClassificationEvaluator": "sparkdl_tpu_torch.evaluation",
    "RegressionEvaluator": "sparkdl_tpu_torch.evaluation",
    "load": "sparkdl_tpu_torch.persistence",
    "SparkSession": "sparkdl_tpu_torch.session",
    "ParamGridBuilder": "sparkdl_tpu_torch.tuning",
    "CrossValidator": "sparkdl_tpu_torch.tuning",
    "CrossValidatorModel": "sparkdl_tpu_torch.tuning",
    "TrainValidationSplit": "sparkdl_tpu_torch.tuning",
    "TrainValidationSplitModel": "sparkdl_tpu_torch.tuning",
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module 'sparkdl_tpu_torch' has no attribute {name!r}")
    from importlib import import_module

    if name in ("functions", "F"):
        return import_module("sparkdl_tpu_torch.functions")

    # a submodule (imageIO) is imported as one
    module = import_module(_EXPORTS[name])
    return getattr(module, name) if hasattr(module, name) else import_module(f"{_EXPORTS[name]}.{name}")
