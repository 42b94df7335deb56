"""KerasImageFileTransformer: a column of image file URIs -> a Keras
model's output vectors.

Port of the JAX package's ``transformers/keras_image.py``. The model
comes from ``modelFile`` (``.keras`` or ``.h5``) or ``model=`` (a Keras
model, or anything with its ``get_config``/``get_layer``/``name``/
``input_shape``), translated into torch by ``graph/ingest.py``. Two
paths:

- with an ``imageLoader`` (uri -> HWC float array), each partition loads
  its files through it, and the host batch stage packs the arrays NCHW;
- without one, the fused path: in the host batch stage (a partition's
  producer thread, or the partition's own thread when partitions share a
  feeder) each batch's files are read, then decoded, resized to the
  model's ``(H, W)`` and packed as one NCHW uint8 batch by the C++ image
  bridge (``runtime/native.py``, one multithreaded pass), and the
  ``preprocessing`` normalization
  ('tf' | 'caffe' | 'torch' | 'none') runs on the device in the image
  converter in front of the model. A file the bridge cannot decode (GIF,
  BMP, ...), or every file where the bridge is off or not built, is
  decoded by PIL (``image.pil_decodes`` counts them).

A stage saved by the JAX package embeds its ``model=`` as a ``.keras``
archive, which loads through the port's own reader (``graph/keras_file.py``).

A None, missing or undecodable URI gives a null row. ``device`` is a
keyword of the constructor: ``cuda`` by default (raising when there is
none), ``"cpu"`` for the CPU.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.graph.function import piece
from sparkdl_tpu_torch.graph.ingest import ModelIngest
from sparkdl_tpu_torch.graph.pieces import (
    build_flattener,
    build_image_converter,
    host_resize_uint8,
)
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.params import (
    CanLoadImage,
    HasBatchSize,
    HasInputCol,
    HasOutputCol,
    Param,
    TypeConverters,
    keyword_only,
)
from sparkdl_tpu_torch.pipeline import Transformer
from sparkdl_tpu_torch.runtime import native
from sparkdl_tpu_torch.runtime.device import resolve_device
from sparkdl_tpu_torch.transformers.execution import (
    arrays_to_batch,
    model_device_fn,
    run_batched_shared,
)
from sparkdl_tpu_torch.utils.metrics import metrics

#: the files a saved stage keeps an in-memory ``model=`` in
MODEL_CONFIG_FILE = "keras_config.json"
MODEL_WEIGHTS_FILE = "keras_weights.npz"
#: the embedded model of a stage saved by the JAX package (``model.save``)
JAX_MODEL_FILE = "model.keras"


def _read_blob(uri: Optional[str]) -> Optional[bytes]:
    if uri is None:
        return None
    try:
        with open(uri, "rb") as f:
            return f.read()
    except OSError:
        return None


def _pil_slot(blob: bytes, height: int, width: int) -> Optional[np.ndarray]:
    """One blob -> an (H, W, 3) RGB uint8 slot, or None: decoded as
    ``imageIO.default_decode`` does, resized by the bridge where it is on,
    else by PIL."""
    bgr = imageIO.default_decode(blob)
    if bgr is None:
        return None
    rgb = np.ascontiguousarray(bgr[:, :, ::-1])
    if native.available():
        return native.resize_bilinear(rgb, height, width)
    return host_resize_uint8(rgb, height, width)


def uris_to_batch(uris, height: int, width: int):
    """The fused path's host stage: file URIs -> (n, 3, H, W) uint8 RGB
    batch and its valid mask."""
    blobs = [_read_blob(u) for u in uris]
    if native.available():
        batch, mask = native.decode_resize_batch(blobs, height=height, width=width, chw=True)
    else:
        batch = np.zeros((len(blobs), 3, height, width), dtype=np.uint8)
        mask = np.zeros((len(blobs),), dtype=bool)
    for i, blob in enumerate(blobs):
        if blob and not mask[i]:
            slot = _pil_slot(blob, height, width)
            if slot is not None:
                batch[i] = slot.transpose(2, 0, 1)
                mask[i] = True
                metrics.inc("image.pil_decodes")
    return batch, mask


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last) if x.dim() == 4 else x


class KerasImageFileTransformer(
    Transformer, HasInputCol, HasOutputCol, HasBatchSize, CanLoadImage
):
    modelFile = Param(
        None, "modelFile", "path to a saved Keras model", TypeConverters.toString
    )
    preprocessing = Param(
        None,
        "preprocessing",
        "normalization fused on device when using the default (fused "
        "native) loader: tf | caffe | torch | none",
        TypeConverters.toChoice("tf", "caffe", "torch", "none"),
    )

    @keyword_only
    def __init__(
        self,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        modelFile: Optional[str] = None,
        model=None,
        imageLoader=None,
        batchSize: Optional[int] = None,
        preprocessing: Optional[str] = None,
        device=None,
    ):
        super().__init__()
        self._setDefault(batchSize=32, preprocessing="none")
        self._set(**{k: v for k, v in self._input_kwargs.items() if k not in ("model", "device")})
        self._model_obj = model
        self._device = device

    def _model_function(self):
        """The model on its device, built once per model source."""
        source = self.getOrDefault("modelFile") if self.isDefined("modelFile") else None
        cached = self.__dict__.get("_mf_cache")
        if cached is not None and cached[0] == source:
            return cached[1]
        device = resolve_device(getattr(self, "_device", None))
        if source is not None:
            mf = ModelIngest.from_keras_file(source, device=device)
        elif getattr(self, "_model_obj", None) is not None:
            mf = ModelIngest.from_keras(self._model_obj, device=device)
        else:
            raise ValueError("Set modelFile or pass model=")
        self.__dict__["_mf_cache"] = (source, mf)
        return mf

    def _device_fn(self, key, build):
        """The device fn of one configuration, built once: the same fn
        object serves every transform, so the shared feeder keeps one
        stream for it."""
        mf = self._model_function()
        cache = self.__dict__.setdefault("_device_fn_cache", {})
        full = (id(mf), *key)
        if full not in cache or cache[full][0] is not mf:
            cache[full] = (mf, model_device_fn(build(mf)))
        return cache[full][1]

    # -- persistence: an in-memory model= is kept as its config and weights --

    def _save_extra(self, path: str):
        from sparkdl_tpu_torch.graph.keras_graph import collect_weights

        model = getattr(self, "_model_obj", None)
        if model is None:
            return None
        with open(os.path.join(path, MODEL_CONFIG_FILE), "w") as f:
            json.dump(model.get_config(), f)
        arrays = {
            f"{layer}#{i}": a
            for layer, weights in collect_weights(model).items()
            for i, a in enumerate(weights)
        }
        np.savez(os.path.join(path, MODEL_WEIGHTS_FILE), **arrays)
        return {"embeddedModel": True}

    def _load_extra(self, path: str, meta: dict) -> None:
        from sparkdl_tpu_torch.graph.keras_graph import KerasModelSpec

        self._model_obj = None
        self.__dict__.pop("_mf_cache", None)
        self.__dict__.pop("_device_fn_cache", None)
        if not (meta.get("extra") or {}).get("embeddedModel"):
            return
        if os.path.exists(os.path.join(path, JAX_MODEL_FILE)):
            # saved by the JAX package: keras's own model.save archive
            from sparkdl_tpu_torch.graph.keras_file import read_keras_file

            self._model_obj = read_keras_file(os.path.join(path, JAX_MODEL_FILE))
            return
        with open(os.path.join(path, MODEL_CONFIG_FILE)) as f:
            config = json.load(f)
        weights = {}
        with np.load(os.path.join(path, MODEL_WEIGHTS_FILE)) as z:
            for key in sorted(z.files, key=lambda k: (k.rpartition("#")[0], int(k.rpartition("#")[2]))):
                weights.setdefault(key.rpartition("#")[0], []).append(z[key])
        self._model_obj = KerasModelSpec(config, weights)

    # -- transform ----------------------------------------------------------

    def _transform(self, dataset: DataFrame) -> DataFrame:
        if self.isDefined("imageLoader") and self.getImageLoader() is not None:
            return self._transform_custom_loader(dataset)
        return self._transform_fused(dataset)

    def _transform_custom_loader(self, dataset: DataFrame) -> DataFrame:
        in_col, out_col = self.getInputCol(), self.getOutputCol()
        batch_size = self.getBatchSize()
        shape = self._model_function().input_shape
        image = shape is not None and len(shape) == 3
        # the host packs image rows NCHW; the device makes them
        # channels_last for the convolutions
        device_fn = self._device_fn(
            ("loader",),
            lambda mf: piece(_channels_last, name="channels_last").and_then(mf).and_then(build_flattener()),
        )

        def to_batch(chunk):
            batch, mask = arrays_to_batch(chunk)
            if image and batch.ndim == 4:
                batch = np.ascontiguousarray(batch.transpose(0, 3, 1, 2))
            return batch, mask

        def run_partition(part):
            arrays = self._load_uris(part[in_col])
            return {out_col: run_batched_shared(arrays, to_batch, device_fn, batch_size)}

        return dataset.withColumnPartition(out_col, run_partition)

    def _geometry(self):
        shape = self._model_function().input_shape
        if not shape or len(shape) != 3 or int(shape[2]) != 3:
            raise ValueError(
                "Default (fused) loading needs a model with recorded "
                f"(H, W, 3) input geometry; this model records {shape!r}: "
                "pass imageLoader instead"
            )
        return int(shape[0]), int(shape[1])

    def _transform_fused(self, dataset: DataFrame) -> DataFrame:
        in_col, out_col = self.getInputCol(), self.getOutputCol()
        batch_size = self.getBatchSize()
        height, width = self._geometry()
        preprocessing = self.getOrDefault("preprocessing")
        # the bridge emits RGB; the normalization runs on the device
        device_fn = self._device_fn(
            ("fused", preprocessing),
            lambda mf: build_image_converter(channel_order_in="RGB", preprocessing=preprocessing)
            .and_then(mf)
            .and_then(build_flattener()),
        )

        def run_partition(part):
            outputs = run_batched_shared(
                part[in_col],
                to_batch=lambda chunk: uris_to_batch(chunk, height, width),
                device_fn=device_fn,
                batch_size=batch_size,
            )
            return {out_col: outputs}

        return dataset.withColumnPartition(out_col, run_partition)
