"""DataParallelEstimator: synchronous data-parallel training.

The port of the JAX package's ``estimators/data_parallel_estimator.py``
(``HorovodEstimator``, BASELINE config[4]): one process per GPU in a
``torch.distributed`` process group; each step every process computes the
loss and gradients of its shard of the global batch, one ``all_reduce``
averages them, and every process applies the same update
(``parallel/data_parallel.py``). ``modelDir`` / ``checkpointEvery`` save
the training state with ``torch.save`` and ``fit`` resumes from the
latest save, as the JAX estimator does with orbax; the port reads its own
checkpoints only.

Input: a feature column of fixed-shape arrays, or image structs decoded
to ``targetHeight`` x ``targetWidth`` and fed as uint8 NHWC, cast to
float32 inside the step without normalization, as in the JAX package;
and an integer label column. In memory (the whole dataset decoded once,
reshuffled each epoch with ``np.random.default_rng(0)``) or streamed
(``streaming=True``: partitions in an epoch-seeded order, rows through a
shuffle buffer, one partition in memory at a time, decoded on a producer
thread). The seeds are the JAX package's, so the same rows land in the
same steps.

``model`` is a trainable :class:`~sparkdl_tpu_torch.graph.function.ModelFunction`
(``ModelFunction.from_module``); ``optimizer`` a ``torch.optim`` factory
(default ``torch.optim.Adam`` at ``stepSize``); ``lossFn(params, (x, y,
mask))`` a scalar (default: softmax cross-entropy over the valid rows,
through ``model.apply``). ``device`` is a keyword, not a Param: ``cuda``
by default (``fit`` raises when there is none), ``"cpu"`` for the CPU
(the process group is then gloo). The fitted :class:`DataParallelModel`
scores through the executor and the shared feeder like every
transformer.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.graph.pieces import image_structs_to_batch
from sparkdl_tpu_torch.parallel import (
    create_train_state,
    distributed,
    make_data_parallel_step,
    make_mesh,
    make_zero1_data_parallel_step,
    pad_batch_to_multiple,
)
from sparkdl_tpu_torch.params import (
    HasBatchSize,
    HasInputCol,
    HasLabelCol,
    HasOutputCol,
    Param,
    TypeConverters,
    keyword_only,
)
from sparkdl_tpu_torch.pipeline import Estimator, Model
from sparkdl_tpu_torch.runtime.device import resolve_device
from sparkdl_tpu_torch.transformers.execution import (
    arrays_to_batch,
    model_device_fn,
    prefetch_iter,
    run_batched_shared,
)
from sparkdl_tpu_torch.utils.metrics import metrics as metrics_registry

#: steps between host syncs on the loss: bounds the work queued ahead of
#: a device failure, as in the JAX package
_SYNC_EVERY = 32


def _check_trainable(model: ModelFunction) -> None:
    """The flash-attention kernel has no backward (the JAX kernel has no
    ``custom_vjp`` either): a module that runs it on the card cannot
    train, and it never falls back quietly to another attention."""
    from sparkdl_tpu_torch.models.bert import BertSelfAttention

    if torch.device(model.device).type != "cuda":
        return
    for m in model.module.modules():
        if isinstance(m, BertSelfAttention) and getattr(m.attention_fn, "flash", False):
            raise ValueError(
                "this BERT runs the flash-attention kernel, which has no "
                "backward: train the dense-attention build "
                "(models.registry._bert_text_builder(size, attention='dense'))"
            )


class DataParallelModel(Model):
    """The trained ModelFunction over an input column: logits per row,
    scored through ``run_batched_shared`` (the executor's concurrent
    partitions share one feeder)."""

    def __init__(
        self,
        model_function: ModelFunction,
        inputCol: str,
        outputCol: str,
        batchSize: int = 64,
        image_geometry: Optional[Tuple[int, int]] = None,
        history: Optional[List[dict]] = None,
    ):
        super().__init__()
        self.modelFunction = model_function
        self._input_col = inputCol
        self._output_col = outputCol
        self._batch_size = batchSize
        self._geometry = image_geometry
        self.history = history or []
        self._fn = None

    def _device_fn(self):
        if self._fn is None:
            self._fn = model_device_fn(self.modelFunction)
        return self._fn

    def _transform(self, dataset: DataFrame) -> DataFrame:
        in_col, out_col = self._input_col, self._output_col
        geom = self._geometry
        device_fn = self._device_fn()

        if geom is not None:
            def to_batch(chunk):
                return image_structs_to_batch(chunk, height=geom[0], width=geom[1])
        else:
            to_batch = arrays_to_batch

        def run_partition(part):
            outputs = run_batched_shared(
                part[in_col], to_batch=to_batch, device_fn=device_fn,
                batch_size=self._batch_size,
            )
            return {out_col: outputs}

        return dataset.withColumnPartition(out_col, run_partition)


class DataParallelEstimator(Estimator, HasInputCol, HasOutputCol, HasLabelCol, HasBatchSize):
    """Synchronous data-parallel trainer. ``batchSize`` is the GLOBAL
    batch, split evenly over the ``dp`` axis (the process group) each
    step."""

    epochs = Param(None, "epochs", "training epochs", TypeConverters.toInt)
    stepSize = Param(None, "stepSize", "learning rate", TypeConverters.toFloat)
    modelDir = Param(
        None, "modelDir",
        "checkpoint directory (enables save + auto-resume)",
        TypeConverters.toString,
    )
    checkpointEvery = Param(
        None, "checkpointEvery", "steps between checkpoints", TypeConverters.toInt,
    )
    targetHeight = Param(
        None, "targetHeight", "image input height (image-struct columns)",
        TypeConverters.toInt,
    )
    targetWidth = Param(
        None, "targetWidth", "image input width (image-struct columns)",
        TypeConverters.toInt,
    )
    meshAxes = Param(
        None, "meshAxes", "mesh axes dict, e.g. {'dp': -1}", TypeConverters.toDict,
    )
    gradAccumSteps = Param(
        None, "gradAccumSteps",
        "microbatches per step (local grad accumulation before the "
        "all-reduce; global batch must divide by dp_size * this)",
        TypeConverters.toInt,
    )
    computeDtype = Param(
        None, "computeDtype",
        "forward/backward dtype ('bfloat16': the forward sees bf16-rounded "
        "weights); master params and optimizer state stay float32",
        TypeConverters.toString,
    )
    streaming = Param(
        None, "streaming",
        "feed training from partitions through a shuffle buffer (memory "
        "bounded at O(buffer + partition)) instead of materializing the "
        "dataset; in a process group each rank reads ONLY its own partitions",
        TypeConverters.toBoolean,
    )
    shuffleBufferRows = Param(
        None, "shuffleBufferRows",
        "shuffle-buffer size in rows for streaming=True (coarse order from "
        "the epoch's partition permutation; fine order from this buffer)",
        TypeConverters.toInt,
    )
    shardOptimizerState = Param(
        None, "shardOptimizerState",
        "ZeRO-1: optimizer state split 1/N across the dp axis "
        "(reduce-scatter grads, all-gather updated params). Requires an "
        "ELEMENTWISE optimizer; a build-time probe rejects others "
        "(parallel/data_parallel.py _assert_elementwise_optimizer)",
        TypeConverters.toBoolean,
    )
    validateOptimizer = Param(
        None, "validateOptimizer",
        "run the ZeRO-1 elementwise-optimizer probe at build time "
        "(default True)",
        TypeConverters.toBoolean,
    )

    @keyword_only
    def __init__(
        self,
        model: Optional[ModelFunction] = None,
        lossFn: Optional[Callable] = None,
        optimizer: Optional[Callable] = None,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        labelCol: Optional[str] = None,
        batchSize: Optional[int] = None,
        epochs: Optional[int] = None,
        stepSize: Optional[float] = None,
        modelDir: Optional[str] = None,
        checkpointEvery: Optional[int] = None,
        targetHeight: Optional[int] = None,
        targetWidth: Optional[int] = None,
        meshAxes: Optional[dict] = None,
        gradAccumSteps: Optional[int] = None,
        computeDtype: Optional[str] = None,
        shardOptimizerState: Optional[bool] = None,
        validateOptimizer: Optional[bool] = None,
        streaming: Optional[bool] = None,
        shuffleBufferRows: Optional[int] = None,
        device=None,
    ):
        super().__init__()
        self._setDefault(
            batchSize=64, epochs=1, stepSize=1e-3, checkpointEvery=100,
            labelCol="label", gradAccumSteps=1, streaming=False,
            shuffleBufferRows=4096, validateOptimizer=True,
        )
        kwargs = {
            k: v for k, v in self._input_kwargs.items()
            if k not in ("model", "lossFn", "optimizer", "device")
        }
        self._set(**kwargs)
        self.model = model
        self.lossFn = lossFn
        self.optimizer = optimizer
        self._device = device

    # -- persistence ----------------------------------------------------------
    # model, loss and optimizer are code, not Params: a saved estimator
    # carries its Params only, and refuses to drop callables silently.

    def _save_extra(self, path):
        set_attrs = [k for k in ("model", "lossFn", "optimizer") if getattr(self, k) is not None]
        if set_attrs:
            raise ValueError(
                f"DataParallelEstimator cannot persist {set_attrs}: keep "
                "these None when saving and set them after loading"
            )
        return None

    def _load_extra(self, path, meta):
        self.model = None
        self.lossFn = None
        self.optimizer = None
        self._device = getattr(self, "_device", None)

    # -- checkpointing ---------------------------------------------------------

    @staticmethod
    def _rank_file(model_dir: str, step: int, rank: int) -> str:
        return os.path.join(os.path.abspath(model_dir), f"step_{step}", f"rank{rank}.pt")

    def _latest_step(self, model_dir: str, rank: int = 0) -> Optional[int]:
        if not os.path.isdir(model_dir):
            return None
        steps = [
            int(name[5:]) for name in os.listdir(model_dir)
            if name.startswith("step_") and name[5:].isdigit()
            and os.path.exists(self._rank_file(model_dir, int(name[5:]), rank))
        ]
        return max(steps) if steps else None

    def _save(self, model_dir: str, state, rank: int) -> None:
        """Each rank writes its own file (its ZeRO-1 optimizer shard; the
        replicated rest), through a temporary name, so a cut save is never
        read back."""
        path = self._rank_file(model_dir, state.step, rank)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)

    def _restore(self, model_dir: str, state, rank: int):
        step = self._latest_step(model_dir, rank)
        if step is not None:
            state.load_state_dict(
                torch.load(self._rank_file(model_dir, step, rank), map_location="cpu", weights_only=True)
            )
        return state

    # -- data -----------------------------------------------------------------

    def _decode_chunk(self, cells, labels):
        """(x, y) arrays from raw column chunks: null rows dropped, image
        structs decoded to targetHeight x targetWidth as uint8 NHWC
        (undecodable structs dropped: never a zero image with a real
        label)."""
        keep = [i for i in range(len(cells)) if cells[i] is not None and labels[i] is not None]
        if self.isDefined("targetHeight"):
            h = self.getOrDefault("targetHeight")
            w = self.getOrDefault("targetWidth")
            batch, mask = image_structs_to_batch([cells[i] for i in keep], height=h, width=w)
            x = batch[mask]
            keep = [i for i, ok in zip(keep, mask) if ok]
        else:
            x = (
                np.stack([np.asarray(cells[i], np.float32) for i in keep])
                if keep else np.zeros((0,), np.float32)
            )
        y = np.asarray([int(labels[i]) for i in keep], np.int32)
        return x, y

    def _materialize(self, dataset: DataFrame):
        in_col, label_col = self.getInputCol(), self.getLabelCol()
        cols = dataset.select(in_col, label_col).collectColumns()
        return self._decode_chunk(cols[in_col], cols[label_col])

    def _stream_chunks(self, dataset: DataFrame, owned, epoch: int):
        """Decoded (x, y) chunks from ``owned`` partitions in an
        epoch-seeded order, one partition in memory at a time."""
        in_col, label_col = self.getInputCol(), self.getLabelCol()
        proj = dataset.select(in_col, label_col)
        rng = np.random.default_rng(982_451 + epoch)
        order = [owned[i] for i in rng.permutation(len(owned))]
        for part in proj.iterPartitions(order=order):
            x, y = self._decode_chunk(list(part[in_col]), list(part[label_col]))
            if x.shape[0]:
                yield x, y

    def _stream_batches(self, dataset: DataFrame, owned, epoch: int, batch_rows: int,
                        buffer_rows: int):
        """Host batches of exactly ``batch_rows`` rows (the last may be
        short) through a shuffle buffer of about ``buffer_rows`` rows."""
        rng = np.random.default_rng(77_003 + epoch)
        buf_x: List[np.ndarray] = []
        buf_y: List[np.ndarray] = []
        held = 0

        def drain(final: bool):
            nonlocal buf_x, buf_y, held
            x = np.concatenate(buf_x) if len(buf_x) > 1 else buf_x[0]
            y = np.concatenate(buf_y) if len(buf_y) > 1 else buf_y[0]
            perm = rng.permutation(x.shape[0])
            x, y = x[perm], y[perm]
            emit_end = x.shape[0] if final else (x.shape[0] // batch_rows) * batch_rows
            for s in range(0, emit_end, batch_rows):
                yield x[s : s + batch_rows], y[s : s + batch_rows]
            buf_x, buf_y = [x[emit_end:]], [y[emit_end:]]
            held = x.shape[0] - emit_end

        for x, y in self._stream_chunks(dataset, owned, epoch):
            buf_x.append(x)
            buf_y.append(y)
            held += x.shape[0]
            if held >= max(buffer_rows, batch_rows):
                yield from drain(final=False)
        if held:
            yield from drain(final=True)

    # -- fit ------------------------------------------------------------------

    def _fit(self, dataset: DataFrame) -> DataParallelModel:
        if self.model is None:
            raise ValueError("model (ModelFunction) must be provided")
        device = resolve_device(self._device)
        model = self.model
        if model.device is None or torch.device(model.device) != device:
            raise ValueError(f"the model lives on {model.device}, the estimator trains on {device}")
        _check_trainable(model)
        streaming = bool(self.getOrDefault("streaming"))
        x = y = None
        if not streaming:
            x, y = self._materialize(dataset)

        loss_fn = self.lossFn
        if loss_fn is None:

            def loss_fn(params, batch):
                bx, by, bm = batch
                logits = model.apply(params, bx).float()
                per_ex = F.cross_entropy(logits, by.long(), reduction="none")
                return (per_ex * bm).sum() / torch.clamp(bm.sum(), min=1.0)

        inner_loss = loss_fn

        def loss_fn(params, batch):
            # the image feed arrives as uint8; only uint8 is cast (an
            # integer feature column, token ids, stays integer)
            bx, by, bm = batch
            if bx.dtype == torch.uint8:
                bx = bx.float()
            return inner_loss(params, (bx, by, bm))

        optimizer = self.optimizer or functools.partial(
            torch.optim.Adam, lr=self.getOrDefault("stepSize")
        )
        mesh = make_mesh(self.getOrDefault("meshAxes") if self.isDefined("meshAxes") else None)
        n_dev = mesh.size
        rank = mesh.rank
        multiproc = n_dev > 1
        compute_dtype = (
            getattr(torch, self.getOrDefault("computeDtype"))
            if self.isDefined("computeDtype") else None
        )
        zero1 = self.isDefined("shardOptimizerState") and self.getOrDefault("shardOptimizerState")
        accum = max(1, self.getOrDefault("gradAccumSteps"))
        weight_fn = lambda b: b[2].sum()  # noqa: E731 — valid rows per microbatch
        init_params = model.named_params()
        if zero1:
            step_fn, zero1_init = make_zero1_data_parallel_step(
                loss_fn, optimizer, mesh, init_params,
                compute_dtype=compute_dtype, grad_accum_steps=accum,
                microbatch_weight_fn=weight_fn,
                validate_elementwise=self.getOrDefault("validateOptimizer"),
            )
            state = zero1_init(init_params)
        else:
            step_fn = make_data_parallel_step(
                loss_fn, mesh, grad_accum_steps=accum,
                compute_dtype=compute_dtype, microbatch_weight_fn=weight_fn,
            )
            state = create_train_state(init_params, optimizer)

        model_dir = self.getOrDefault("modelDir") if self.isDefined("modelDir") else None
        if model_dir:
            state = self._restore(model_dir, state, rank)

        if streaming:
            part_counts = dataset.partitionRowCounts()
            n = sum(part_counts)
        else:
            n = x.shape[0]
        if n == 0:
            raise ValueError("No training data: every row was null or undecodable")
        pad_unit = n_dev * accum  # every shard splits into `accum` microbatches
        global_batch = max(self.getBatchSize(), pad_unit)
        if global_batch % pad_unit:
            global_batch += pad_unit - global_batch % pad_unit
        per_rank_batch = global_batch // n_dev
        ckpt_every = self.getOrDefault("checkpointEvery")
        owned = (
            distributed.partitions_for_host(dataset.numPartitions, rank, n_dev)
            if multiproc else list(range(dataset.numPartitions))
        )
        if streaming and multiproc:
            # lockstep step count = the heaviest rank's (every rank computes
            # it from the same metadata); lighter ranks pad masked steps
            rank_rows = [
                sum(c for i, c in enumerate(part_counts) if i % n_dev == r) for r in range(n_dev)
            ]
            steps_per_epoch = max(-(-rr // per_rank_batch) for rr in rank_rows)
        else:
            steps_per_epoch = -(-n // global_batch)

        def to_device(hx, hy, mask):
            return (
                torch.from_numpy(np.ascontiguousarray(hx)).to(device),
                torch.from_numpy(np.ascontiguousarray(hy)).to(device),
                torch.from_numpy(mask.astype(np.float32)).to(device),
            )

        def pad_rows(hx, hy, target):
            k = hx.shape[0]
            mask = np.zeros((target,), np.float32)
            mask[:k] = 1.0
            if k < target:
                hx = np.concatenate([hx, np.zeros((target - k, *hx.shape[1:]), hx.dtype)])
                hy = np.concatenate([hy, np.zeros((target - k,), hy.dtype)])
            return hx, hy, mask

        epoch_steps = 0
        metrics = None

        def run_step(batch):
            nonlocal state, epoch_steps, metrics
            state, metrics = step_fn(state, batch)
            epoch_steps += 1
            if model_dir and state.step % ckpt_every == 0:
                self._save(model_dir, state, rank)
            elif state.step % _SYNC_EVERY == 0:
                metrics["loss"].item()

        history: List[dict] = []
        order = np.arange(n) if not streaming else None
        rng = np.random.default_rng(0)
        feat_shape: Optional[Tuple[int, ...]] = None
        for epoch in range(self.getOrDefault("epochs")):
            epoch_t0 = time.perf_counter()
            epoch_steps = 0
            if streaming:
                gen = prefetch_iter(self._stream_batches(
                    dataset, owned, epoch, per_rank_batch,
                    self.getOrDefault("shuffleBufferRows"),
                ))
                try:
                    for _ in range(steps_per_epoch):
                        t_wait = time.perf_counter()
                        nxt = next(gen, None)
                        metrics_registry.record_time("train.data_wait", time.perf_counter() - t_wait)
                        if nxt is None and not multiproc:
                            break
                        if nxt is None:
                            # this rank ran dry: masked pad steps keep lockstep
                            if feat_shape is None:
                                if model.input_shape is None:
                                    raise ValueError(
                                        "rank received no data and the model records no "
                                        "input_shape to pad with; use more partitions "
                                        "than processes"
                                    )
                                feat_shape = tuple(model.input_shape)
                            pad_dtype = np.uint8 if self.isDefined("targetHeight") else np.float32
                            hx = np.zeros((0, *feat_shape), pad_dtype)
                            hy = np.zeros((0,), np.int32)
                        else:
                            hx, hy = nxt
                            feat_shape = tuple(hx.shape[1:])
                        run_step(to_device(*pad_rows(hx, hy, per_rank_batch)))
                finally:
                    gen.close()
            else:
                rng.shuffle(order)
                for start in range(0, n, global_batch):
                    idx = order[start : start + global_batch]
                    (bx, by), mask = pad_batch_to_multiple((x[idx], y[idx]), pad_unit)
                    local = bx.shape[0] // n_dev
                    rows = slice(rank * local, (rank + 1) * local)
                    run_step(to_device(bx[rows], by[rows], mask[rows]))
            if not epoch_steps:
                raise ValueError("No training data: every row was null or undecodable")
            loss_val = float(metrics["loss"])  # waits for the epoch's last step
            epoch_time = time.perf_counter() - epoch_t0
            history.append({
                "epoch": epoch,
                "loss": loss_val,
                "steps": epoch_steps,
                "mean_step_time_s": epoch_time / epoch_steps,
                "epoch_time_s": epoch_time,
                "timing": "epoch_wall_over_steps",
            })
        if model_dir:
            self._save(model_dir, state, rank)

        geom = (
            (self.getOrDefault("targetHeight"), self.getOrDefault("targetWidth"))
            if self.isDefined("targetHeight") else None
        )
        return DataParallelModel(
            model.with_params({k: v.detach() for k, v in state.params.items()}),
            inputCol=self.getInputCol(),
            outputCol=self.getOutputCol() if self.isDefined("outputCol") else "prediction",
            batchSize=self.getBatchSize(),
            image_geometry=geom,
            history=history,
        )


# The reference's name for the Horovod-backed estimator
HorovodEstimator = DataParallelEstimator
