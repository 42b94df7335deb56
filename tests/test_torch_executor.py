"""The port's partition executor, the DataFrame's use of it, and the router
into the shared feeder, against the JAX package's on the CPU.

The semantics of the JAX package's ``tests/test_execution.py`` and
``tests/test_feeder.py``: results in partition order, bounded retry and
``PartitionTaskError``, the TaskContext each partition thread sees,
``run_batched_shared`` in each of its branches (rows equal to
``run_batched``'s, and the feeder engaged only where partitions run at
once), ``prefetch_iter``, and a DataFrame's ``withColumnPartition`` over 4
partitions equal to the JAX DataFrame's.
"""

import threading
import time

import numpy as np
import pytest

from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.runtime import executor as jax_executor
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.graph.function import piece
from sparkdl_tpu_torch.runtime import executor
from sparkdl_tpu_torch.runtime.executor import (
    Executor,
    PartitionTaskError,
    current_task_context,
)
from sparkdl_tpu_torch.runtime.feeder import shutdown_feeders
from sparkdl_tpu_torch.transformers import execution
from sparkdl_tpu_torch.transformers.execution import (
    model_device_fn,
    prefetch_iter,
    run_batched,
    run_batched_shared,
    shared_feeder_enabled,
)
from sparkdl_tpu_torch.utils.metrics import metrics


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("SPARKDL_EXEC_RETRY_BASE_MS", "0")
    yield
    shutdown_feeders()


@pytest.fixture(params=["port", "jax"])
def mod(request, monkeypatch):
    monkeypatch.setenv("SPARKDL_EXEC_RETRY_BASE_MS", "0")
    return executor if request.param == "port" else jax_executor


def _batcher(chunk):
    batch = np.zeros((len(chunk), 2), dtype=np.float32)
    mask = np.zeros((len(chunk),), dtype=bool)
    for i, c in enumerate(chunk):
        if c is not None:
            batch[i] = c
            mask[i] = True
    return batch, mask


def _parts(n_parts, rows, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_parts):
        cells = [rng.normal(size=(2,)).astype(np.float32) for _ in range(rows)]
        if rows > 3:
            cells[1] = cells[-1] = None
        out.append(cells)
    return out


def _double():
    return model_device_fn(piece(lambda x: x * 2.0, name="double"))


def _run(parts, fn, batch_size=4, workers=None):
    return Executor(max_workers=workers or len(parts)).map_partitions(
        lambda i, cells: run_batched_shared(cells, _batcher, fn, batch_size), parts, count_rows=len,
    )


def _same(a_parts, b_parts):
    assert len(a_parts) == len(b_parts)
    for a_rows, b_rows in zip(a_parts, b_parts):
        assert len(a_rows) == len(b_rows)
        for a, b in zip(a_rows, b_rows):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


def test_results_come_back_in_partition_order(mod):
    def fn(i, part):
        time.sleep(0.02 * (5 - i))  # later partitions finish first
        return (i, part * 3)

    ex = mod.Executor(max_workers=5)
    assert ex.map_partitions(fn, list(range(5))) == [(i, i * 3) for i in range(5)]
    assert ex.last_metrics.num_partitions == 5 and len(ex.last_metrics.partition_times_s) == 5
    ex.close()


def test_a_failed_partition_is_retried_then_raises(mod):
    calls = {}
    lock = threading.Lock()

    def flaky(i, part):
        with lock:
            calls[i] = calls.get(i, 0) + 1
            n = calls[i]
        if i == 1 and n == 1:
            raise ValueError("transient")
        return part

    ex = mod.Executor(max_workers=3, max_failures=2)
    assert ex.map_partitions(flaky, ["a", "b", "c"]) == ["a", "b", "c"]
    assert calls[1] == 2 and ex.last_metrics.num_failures == 1

    def broken(i, part):
        raise KeyError(f"bad {i}")

    with pytest.raises(mod.PartitionTaskError) as info:
        ex.map_partitions(broken, ["a"])
    assert info.value.partition_index == 0 and info.value.attempts == 2
    assert isinstance(info.value.cause, KeyError)
    ex.close()


def test_task_context_and_concurrency(mod):
    seen = {}

    def fn(i, part):
        seen[i] = mod.current_task_context()
        return part

    mod.Executor(max_workers=4).map_partitions(fn, ["a", "b", "c"])
    assert seen[1] == mod.TaskContext(partition_index=1, num_partitions=3, concurrency=3)
    assert mod.current_task_context() is None
    mod.Executor(max_workers=1).map_partitions(fn, ["a", "b"])
    assert seen[1].concurrency == 1 and seen[1].num_partitions == 2


def test_pool_is_reused_and_nested_calls_do_not_deadlock(mod):
    ex = mod.Executor(max_workers=2)
    names = set(ex.map_partitions(lambda i, p: threading.current_thread().name, list(range(4))))
    pool = ex._pool
    ex.map_partitions(lambda i, p: p, list(range(4)))
    assert pool is not None and ex._pool is pool
    assert all(n.startswith("sparkdl-exec") for n in names)

    def outer(i, part):
        return sum(ex.map_partitions(lambda j, q: q * 10, [part, part + 1]))

    assert ex.map_partitions(outer, [1, 2, 3, 4]) == [30, 50, 70, 90]
    ex.close()
    assert ex._pool is None


def test_default_executor_is_settable():
    ex = Executor(max_workers=3)
    old = executor.default_executor()
    executor.set_default_executor(ex)
    try:
        assert executor.default_executor() is ex
    finally:
        executor.set_default_executor(old)
        ex.close()


def test_shared_feeder_rows_equal_run_batched(monkeypatch):
    parts = _parts(6, 23)
    fn = _double()
    monkeypatch.setenv("SPARKDL_SHARED_FEEDER", "1")
    metrics.reset()
    shared = _run(parts, fn)
    assert metrics.counter("feeder.coalesced_batches") > 0
    assert metrics.counter("transform.batches") == 0
    monkeypatch.setenv("SPARKDL_SHARED_FEEDER", "0")
    assert not shared_feeder_enabled()
    metrics.reset()
    legacy = _run(parts, fn)
    assert metrics.counter("feeder.coalesced_batches") == 0
    assert metrics.counter("transform.batches") == 6 * 6  # ceil(23 / 4) per partition
    _same(shared, legacy)
    direct = [run_batched(cells, _batcher, fn, 4) for cells in parts]
    _same(shared, direct)
    for cells, rows in zip(parts, shared):
        for c, r in zip(cells, rows):
            assert (r is None) == (c is None)
            if c is not None:
                np.testing.assert_array_equal(r, c * 2.0)


@pytest.mark.parametrize("branch", ["one partition", "sequential", "outside the executor", "single_stream"])
def test_router_keeps_run_batched(branch, monkeypatch):
    monkeypatch.setenv("SPARKDL_SHARED_FEEDER", "1")
    fn = _double()
    parts = _parts(1 if branch == "one partition" else 3, 9, seed=1)
    metrics.reset()
    if branch == "outside the executor":
        out = [run_batched_shared(cells, _batcher, fn, 4) for cells in parts]
    elif branch == "single_stream":
        fn.single_stream = True
        out = _run(parts, fn)
    else:
        out = _run(parts, fn, workers=1 if branch == "sequential" else None)
    assert metrics.counter("feeder.coalesced_batches") == 0
    assert metrics.counter("transform.batches") > 0
    _same(out, [run_batched(cells, _batcher, fn, 4) for cells in parts])


def test_run_batched_hands_a_model_device_fn_the_host_batch():
    """A ``model_device_fn`` fn copies its own input (on its stream, on the
    card); a plain callable gets the batch on its device already."""
    seen = []

    def plain(x):
        seen.append(x.device)
        return x + 1.0

    plain.device = "cpu"
    out = run_batched([np.ones(2, np.float32)] * 5, _batcher, plain, 2)
    assert len(seen) == 3 and all(r is not None for r in out)
    fn = _double()
    assert hasattr(fn, "stage_put") and fn.launcher is None  # the CPU has no launch thread
    np.testing.assert_array_equal(run_batched([np.ones(2, np.float32)], _batcher, fn, 2)[0], [2.0, 2.0])
    assert execution.default_prefetch(fn) == 2


def test_prefetch_iter_order_exceptions_and_abandonment():
    assert list(prefetch_iter(iter(range(20)), depth=3)) == list(range(20))

    def boom():
        yield 1
        raise RuntimeError("producer failed")

    it = prefetch_iter(boom())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        list(it)
    produced = {"n": 0}

    def endless():
        while True:
            produced["n"] += 1
            yield produced["n"]

    it = prefetch_iter(endless(), depth=2)
    assert next(it) == 1
    it.close()
    mark = produced["n"]
    time.sleep(0.3)
    assert produced["n"] <= mark + 1, (mark, produced["n"])


def test_four_partition_with_column_partition_equals_the_jax_dataframe():
    rng = np.random.default_rng(3)
    cols = {"a": [float(v) for v in rng.normal(size=37)], "b": list(range(37))}

    def fn(part):
        return {"c": [x * 2 + y for x, y in zip(part["a"], part["b"])]}

    ours = DataFrame.fromColumns(cols, numPartitions=4).withColumnPartition("c", fn)
    ref = JaxDataFrame.fromColumns(cols, numPartitions=4).withColumnPartition("c", fn)
    assert ours.numPartitions == ref.numPartitions == 4
    assert ours.partitionRowCounts() == ref.partitionRowCounts() == [10, 9, 9, 9]
    assert ours.collectColumns() == ref.select("a", "b", "c").collectColumns()
    order = [2, 0, 3]
    assert [p["b"] for p in ours.iterPartitions(order=order)] == [
        p["b"] for p in ref.iterPartitions(order=order)
    ]
    # the partitions ran on the executor's threads, all four at once
    def where(part):
        ctx = current_task_context()
        return {"t": [(threading.current_thread().name, ctx.concurrency)] * len(part["a"])}

    seen = DataFrame.fromColumns(cols, numPartitions=4).withColumnPartition("t", where).collectColumns()["t"]
    assert all(name.startswith("sparkdl-exec") and conc == 4 for name, conc in seen)


def test_iter_partitions_retries_then_raises():
    calls = {"n": 0}

    def flaky(part):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("once")
        return {"c": part["a"]}

    df = DataFrame.fromColumns({"a": [1, 2, 3]}, numPartitions=1).withColumnPartition("c", flaky)
    assert [p["c"] for p in df.iterPartitions()] == [[1, 2, 3]]
    bad = DataFrame.fromColumns({"a": [1]}).withColumnPartition("c", lambda p: 1 / 0)
    with pytest.raises(PartitionTaskError, match="ZeroDivisionError"):
        list(bad.iterPartitions())


def test_text_buckets_of_concurrent_partitions_share_feeders(monkeypatch):
    """TextEmbedder over 4 partitions run at once: every partition submits
    all its length buckets into the shared feeders before it waits on any;
    the embeddings equal the per-partition pipelines'."""
    from sparkdl_tpu_torch.models import get_model
    from sparkdl_tpu_torch.transformers.text import TextEmbedder

    rng = np.random.default_rng(4)
    texts = [" ".join(f"w{v}" for v in rng.integers(0, 5000, size=int(n))) for n in rng.integers(3, 120, 40)]
    texts[5] = None
    df = DataFrame.fromColumns({"text": texts}, numPartitions=4)
    emb = TextEmbedder(inputCol="text", outputCol="emb", maxLength=128, batchSize=8,
                       modelFunction=get_model("bert-tiny").model_function(device="cpu"))
    monkeypatch.setenv("SPARKDL_TEXT_BUCKETING", "1")
    metrics.reset()
    shared = [r.emb for r in emb.transform(df).collect()]
    assert metrics.counter("feeder.coalesced_batches") > 0 and metrics.counter("transform.batches") == 0
    monkeypatch.setenv("SPARKDL_SHARED_FEEDER", "0")
    own = [r.emb for r in emb.transform(df).collect()]
    assert shared[5] is None and own[5] is None
    for a, b in zip(shared, own):
        if b is not None:
            np.testing.assert_allclose(a, b, atol=1e-5)
