"""Text-embedding transformer: text column -> tokens -> BERT -> vector.

Port of the JAX package's ``transformers/text.py`` (BASELINE config[3],
"KerasTransformer BERT-base text-embedding UDF over text DataFrame"). A
text column is tokenized on the host (any callable str -> list[int]; the
offline :class:`HashingTokenizer` is the default) and embedded by a
BERT-family :class:`~sparkdl_tpu_torch.graph.function.ModelFunction` on
its device. By default rows run in sequence-length buckets
(``text/bucketing.py``); ``SPARKDL_TEXT_BUCKETING=0`` pads every row to
``maxLength`` instead.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional

import numpy as np
import torch

from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.graph.function import piece
from sparkdl_tpu_torch.params import (
    HasBatchSize,
    HasInputCol,
    HasModelFunction,
    HasOutputCol,
    Param,
    TypeConverters,
    keyword_only,
)
from sparkdl_tpu_torch.pipeline import Transformer
from sparkdl_tpu_torch.text.bucketing import bucketing_enabled, run_bucketed
from sparkdl_tpu_torch.transformers.execution import model_device_fn, run_batched_shared
from sparkdl_tpu_torch.utils.metrics import metrics

_WORD = re.compile(r"[\w']+")


class HashingTokenizer:
    """Deterministic offline tokenizer: lowercased word split, stable
    FNV-1a hash into [n_reserved, vocab_size). Reserved ids: 0=pad,
    1=cls, 2=sep, 3=unk. The same ids as the JAX package's tokenizer."""

    def __init__(self, vocab_size: int = 30522, add_special: bool = True):
        self.vocab_size = vocab_size
        self.add_special = add_special

    @staticmethod
    def _fnv1a(word: str) -> int:
        h = 0xCBF29CE484222325
        for b in word.encode("utf-8"):
            h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        return h

    def __call__(self, text: str) -> List[int]:
        words = _WORD.findall(text.lower())
        ids = [3 + 1 + self._fnv1a(w) % (self.vocab_size - 4) for w in words]
        if self.add_special:
            ids = [1] + ids + [2]
        return ids


def pad_or_truncate(ids: List[int], max_len: int) -> np.ndarray:
    if len(ids) > max_len:
        # the one choke point both text paths truncate rows through
        metrics.inc("text.truncated_rows")
    arr = np.zeros((max_len,), np.int32)
    n = min(len(ids), max_len)
    arr[:n] = ids[:n]
    return arr


class TextEmbedder(
    Transformer, HasInputCol, HasOutputCol, HasBatchSize, HasModelFunction
):
    """text column -> tokenize -> model embed -> embedding vector column.

    ``modelFunction`` takes ``(ids, mask)`` int32 batches on its device and
    returns [B, D] embeddings (e.g. ``get_model("bert-base")
    .model_function()``). The mask is ``ids != 0``.
    """

    maxLength = Param(
        None, "maxLength", "token sequence length (pad/truncate)",
        TypeConverters.toInt,
    )
    tokenizer = Param(
        None, "tokenizer", "callable str -> list[int]",
        TypeConverters.identity,
    )

    @keyword_only
    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelFunction=None,
        tokenizer: Optional[Callable] = None,
        maxLength: Optional[int] = None,
        batchSize: Optional[int] = None,
    ):
        super().__init__()
        self._setDefault(maxLength=128, batchSize=32)
        self._set(**self._input_kwargs)

    def _device_fn(self):
        """``(ids, ids != 0)`` into the model, as a device fn
        (``execution.model_device_fn``: on CUDA, issued on the device's
        launch thread), built once per modelFunction so the shared feeder
        keeps one stream for it."""
        if not self.isDefined("modelFunction"):
            raise ValueError("modelFunction param must be set")
        mf = self.getModelFunction()
        cached = self.__dict__.get("_device_fn_cache")
        if cached is not None and cached[0] is mf:
            return cached[1]
        with_mask = piece(lambda ids: (ids, (ids != 0).to(torch.int32)), name="mask").and_then(mf)
        fn = model_device_fn(with_mask)
        self.__dict__["_device_fn_cache"] = (mf, fn)
        return fn

    def _tokenizer(self):
        if self.isDefined("tokenizer"):
            return self.getOrDefault("tokenizer")
        # bound the hash space by the model's vocab: out-of-vocab ids
        # would index past the embedding table
        vocab = getattr(self.getModelFunction(), "vocab_size", None) or 30522
        return HashingTokenizer(vocab_size=vocab)

    def _transform(self, dataset: DataFrame) -> DataFrame:
        in_col, out_col = self.getInputCol(), self.getOutputCol()
        max_len = self.getOrDefault("maxLength")
        device_fn = self._device_fn()
        tok = self._tokenizer()
        batch_size = self.getBatchSize()

        if bucketing_enabled() and not getattr(device_fn, "single_stream", False):
            # single_stream fns keep the fixed geometry: their sequence
            # sharding was built for exactly max_len

            def run_partition_bucketed(part):
                return {
                    out_col: run_bucketed(
                        part[in_col], tok, device_fn, batch_size, max_len
                    )
                }

            return dataset.withColumnPartition(out_col, run_partition_bucketed)

        def to_batch(chunk):
            ids = np.zeros((len(chunk), max_len), np.int32)
            mask = np.zeros((len(chunk),), bool)
            for i, text in enumerate(chunk):
                if text is None:
                    continue
                try:
                    ids[i] = pad_or_truncate(tok(text), max_len)
                    mask[i] = True
                except Exception:  # noqa: BLE001 — a failed row becomes None
                    continue
            return ids, mask

        def run_partition(part):
            outputs = run_batched_shared(
                part[in_col],
                to_batch=to_batch,
                device_fn=device_fn,
                batch_size=batch_size,
            )
            return {out_col: outputs}

        return dataset.withColumnPartition(
            out_col, run_partition, serial=device_fn.single_stream
        )
