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
  (``parallel/``), the evaluators and stage persistence.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with the default device and no CUDA card they raise.
"""

__version__ = "0.1.0"
