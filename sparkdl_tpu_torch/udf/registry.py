"""Model-as-UDF registry and one-call deployment.

Port of the JAX package's ``udf/registry.py``: a process-global,
thread-safe catalog in which a name maps to a column-level UDF (a
function over one partition's cells, ``None`` cells kept ``None``). A
model UDF carries two surfaces over the same device function: the
per-partition ``partition_fn`` (``run_batched``: each partition its own
pipeline) and the vectorized ``batch_fn`` (``run_batched_shared``: when
the executor runs partitions at once their rows coalesce in the shared
feeder). :func:`apply_udf` picks ``batch_fn`` when the SQL optimizer arm
is on (``SPARKDL_SQL_VECTORIZE``), and ``sql.py`` resolves function
names here, so a registered model is at once SQL-callable.

Every registration that builds or takes a model runs it on ``device``:
``cuda`` by default (raising when there is none), ``"cpu"`` to run on the
CPU. ``registerImageUDF`` takes a registry name, a
:class:`~sparkdl_tpu_torch.graph.function.ModelFunction`, a Keras model
or a Keras model file (both translated into torch by ``graph/ingest.py``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.runtime import knobs
from sparkdl_tpu_torch.runtime.device import resolve_device
from sparkdl_tpu_torch.utils.metrics import metrics

_KERAS_EXTENSIONS = (".keras", ".h5", ".hdf5")


@dataclass
class RegisteredUDF:
    name: str
    #: fn(partition cells: list) -> list of output cells (None kept None)
    partition_fn: Callable[[list], list]
    doc: str = ""
    #: the same contract, dispatched through ``run_batched_shared``; None
    #: for plain Python UDFs, which always run ``partition_fn``
    batch_fn: Optional[Callable[[list], list]] = None
    #: the model is ``single_stream``: its column runs the partitions one
    #: at a time, in index order (``DataFrame.withColumnPartition``)
    single_stream: bool = False

    @property
    def vectorized(self) -> bool:
        return self.batch_fn is not None


_registry: Dict[str, RegisteredUDF] = {}
_lock = threading.Lock()


def sql_vectorize_enabled() -> bool:
    """SPARKDL_SQL_VECTORIZE gates the SQL optimizer arm (default on):
    batched catalog-UDF dispatch through the shared feeder plus the
    planner's projection and predicate pushdown; 0/off gives the
    row-path planner, the A/B arm."""
    return knobs.get_flag("SPARKDL_SQL_VECTORIZE")


class _CountingDeviceFn:
    """The vectorized arm's device function: counts each dispatch as
    ``sql.udf.batches`` (one per batch the shared feeder packs) and
    forwards every other attribute (``device``, ``stream``,
    ``stage_put``, ``launcher``, ...) to the wrapped function. Built once
    per registration: the feeder keys its streams by ``id(device_fn)``,
    so a wrapper per query would open a feeder per query."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, batch):
        metrics.inc("sql.udf.batches")
        return self._fn(batch)

    def __getattr__(self, name):
        return getattr(self._fn, name)


def register(
    name: str,
    partition_fn: Callable[[list], list],
    doc: str = "",
    batch_fn: Optional[Callable[[list], list]] = None,
    single_stream: bool = False,
) -> None:
    with _lock:
        _registry[name] = RegisteredUDF(name, partition_fn, doc, batch_fn, single_stream)


def unregister(name: str) -> None:
    with _lock:
        _registry.pop(name, None)


def get(name: str) -> RegisteredUDF:
    with _lock:
        if name not in _registry:
            raise KeyError(
                f"No UDF registered under {name!r}; registered: "
                f"{sorted(_registry)}"
            )
        return _registry[name]


def list_udfs() -> list:
    with _lock:
        return sorted(_registry)


def apply_udf(
    name: str, dataset: DataFrame, inputCol: str, outputCol: str
) -> DataFrame:
    """SELECT <name>(<inputCol>) AS <outputCol>, a partition at a time:
    through ``batch_fn`` when the UDF has one and the optimizer arm is
    on, else through ``partition_fn``."""
    udf = get(name)
    vectorized = udf.batch_fn is not None and sql_vectorize_enabled()
    metrics.gauge("sql.udf.vectorized", 1.0 if vectorized else 0.0)
    fn = udf.batch_fn if vectorized else udf.partition_fn

    def op(part):
        return {outputCol: fn(part[inputCol])}

    return dataset.withColumnPartition(outputCol, op, serial=udf.single_stream)


#: ``callUDF(name, df, ...)``, as spark.sql's callUDF reads
callUDF = apply_udf


def _register_model(udfName, device_fn, to_batch, batch_size, doc) -> None:
    """A model UDF over ``device_fn`` (a ``model_device_fn``): both
    surfaces, the vectorized one through one counting wrapper."""
    from sparkdl_tpu_torch.transformers.execution import (
        run_batched,
        run_batched_shared,
    )

    def partition_fn(cells):
        return run_batched(
            cells, to_batch=to_batch, device_fn=device_fn, batch_size=batch_size
        )

    counted = _CountingDeviceFn(device_fn)

    def batch_fn(cells):
        metrics.inc("sql.udf.batch_rows", sum(c is not None for c in cells))
        return run_batched_shared(
            cells, to_batch=to_batch, device_fn=counted, batch_size=batch_size
        )

    register(
        udfName, partition_fn, doc=doc, batch_fn=batch_fn,
        single_stream=device_fn.single_stream,
    )


def _on_device(model_function, device) -> torch.device:
    """The registration's device (``cuda`` by default, raising without
    one); a given ModelFunction must already live there."""
    device = resolve_device(device)
    mf_device = torch.device(model_function.device or "cpu")
    if mf_device != device:
        raise ValueError(
            f"{model_function.name!r} lives on {mf_device}, the registration "
            f"asks for {device}: build the ModelFunction on {device}"
        )
    return device


def registerModelUDF(
    udfName: str,
    model_function,
    to_batch: Optional[Callable] = None,
    batch_size: int = 32,
    doc: str = "",
    device=None,
) -> None:
    """Register any ModelFunction as a UDF over array cells
    (``arrays_to_batch`` unless ``to_batch`` is given)."""
    from sparkdl_tpu_torch.transformers.execution import (
        arrays_to_batch,
        model_device_fn,
    )

    _on_device(model_function, device)
    _register_model(
        udfName, model_device_fn(model_function), to_batch or arrays_to_batch,
        batch_size, doc,
    )


def makeGraphUDF(
    graph,
    udfName: str,
    outputs=None,
    blocked: bool = True,
    batch_size: int = 32,
    device=None,
) -> None:
    """Upstream's ``makeGraphUDF(graph, udfName, outputs, blocked)``:
    ``graph`` is a ModelFunction; ``outputs`` is accepted for the
    signature and unused (a ModelFunction has one output). Execution is
    always batched, so ``blocked=False`` is refused."""
    if not blocked:
        raise ValueError(
            "Row-at-a-time UDF execution (blocked=False) is not "
            "supported: batches are the device's execution unit"
        )
    registerModelUDF(udfName, graph, batch_size=batch_size, device=device)


def registerImageUDF(
    udfName: str,
    kerasModelOrFile,
    preprocessor: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    height: Optional[int] = None,
    width: Optional[int] = None,
    batch_size: int = 32,
    device=None,
) -> None:
    """Deploy an image model as a named UDF over an image-struct column
    (upstream's ``registerKerasImageUDF(udfName, keras_model_or_file,
    preprocessor)``).

    ``kerasModelOrFile``: a registry model name (``"MobileNetV2"``: its
    class probabilities, seeded random weights), a ModelFunction, a Keras
    model (anything with ``get_config`` and ``get_layer``) or a
    ``.keras``/``.h5``/``.hdf5`` file; any other object raises TypeError.
    ``preprocessor``: an optional host function (HWC uint8 RGB) -> HWC
    float applied per image in place of the converter.
    """
    from sparkdl_tpu_torch.graph.function import ModelFunction, piece
    from sparkdl_tpu_torch.graph.ingest import ModelIngest
    from sparkdl_tpu_torch.graph.pieces import (
        build_flattener,
        build_image_converter,
        image_structs_to_batch,
    )
    from sparkdl_tpu_torch.transformers.execution import model_device_fn

    preprocessing = "none"
    if isinstance(kerasModelOrFile, ModelFunction):
        mf = kerasModelOrFile
        _on_device(mf, device)
    elif isinstance(kerasModelOrFile, str) and kerasModelOrFile.endswith(_KERAS_EXTENSIONS):
        mf = ModelIngest.from_keras_file(kerasModelOrFile, device=resolve_device(device))
    elif isinstance(kerasModelOrFile, str):
        from sparkdl_tpu_torch.models.registry import get_image_model

        spec = get_image_model(kerasModelOrFile)
        mf = spec.model_function(mode="probabilities", device=resolve_device(device))
        preprocessing = spec.preprocessing
        height, width = height or spec.height, width or spec.width
    elif hasattr(kerasModelOrFile, "get_config") and hasattr(kerasModelOrFile, "get_layer"):
        mf = ModelIngest.from_keras(kerasModelOrFile, device=resolve_device(device))
    else:
        raise TypeError(
            f"registerImageUDF({udfName!r}): {type(kerasModelOrFile).__name__} is "
            "not a registry model name, a ModelFunction, a Keras model or a "
            "Keras model file"
        )

    if height is None or width is None:
        if mf.input_shape and len(mf.input_shape) == 3:
            height, width = mf.input_shape[0], mf.input_shape[1]
        else:
            raise ValueError("height/width required for this model")

    if preprocessor is not None:
        # the host emits the final float batch, image rows channel-major
        # as the converter branch packs them; the device casts to the
        # model's input dtype
        dtype = mf.input_dtype or torch.float32

        def cast(x: torch.Tensor) -> torch.Tensor:
            x = x.to(dtype)
            return x.contiguous(memory_format=torch.channels_last) if x.dim() == 4 else x

        device_fn = model_device_fn(
            piece(cast, name="cast").and_then(mf).and_then(build_flattener())
        )

        def to_batch(chunk):
            batch, mask = image_structs_to_batch(chunk, height=height, width=width)
            # batch[i][..., ::-1] (BGR -> RGB) has a negative stride,
            # which torch.from_numpy refuses
            processed = np.stack(
                [
                    np.asarray(
                        preprocessor(np.ascontiguousarray(batch[i][..., ::-1])),
                        dtype=np.float32,
                    )
                    for i in range(batch.shape[0])
                ]
            )
            if processed.ndim == 4:
                processed = np.ascontiguousarray(processed.transpose(0, 3, 1, 2))
            return processed, mask

    else:
        converter = build_image_converter(
            channel_order_in="BGR",
            preprocessing=preprocessing,
            out_dtype=mf.input_dtype or torch.float32,
        )
        device_fn = model_device_fn(converter.and_then(mf).and_then(build_flattener()))

        def to_batch(chunk):
            return image_structs_to_batch(chunk, height=height, width=width, chw=True)

    _register_model(
        udfName, device_fn, to_batch, batch_size,
        f"image UDF over {getattr(mf, 'name', 'model')}",
    )


#: upstream's name
registerKerasImageUDF = registerImageUDF
