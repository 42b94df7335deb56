"""Partitioned execution: a function mapped over DataFrame partitions.

The port of the JAX package's ``runtime/executor.py``:

- :class:`Executor` runs ``fn(index, partition)`` over the partitions on
  a pool of host threads, returns the results in partition order, and
  retries a failed partition under a :class:`RetryPolicy`
  (``SPARKDL_EXEC_RETRY_*`` knobs; Spark's ``spark.task.maxFailures``);
  a partition that exhausts its attempts raises :class:`PartitionTaskError`;
- :class:`TaskContext` is published on the partition's thread while its
  task runs: the shared device feeder reads ``concurrency`` (coalescing
  rows across partitions pays only when more than one runs at once) and
  labels its streams with ``partition_index``;
- :class:`TaskMetrics` aggregates per-partition times and rows.

One process drives one device; the threads overlap host work (decode,
batch assembly) with the device, whose forwards the launch thread issues
(``runtime/device.Launcher``). Each attempt runs the fault-injection hook
``maybe_fault("executor.partition", partition=i, attempt=n)``
(``resilience/faults.py``). A partition that fails past its retries
flushes the flight recorder
(``obs/export.dump_on_failure("partition_task_error")``).
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed, wait
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

from sparkdl_tpu_torch.obs import span
from sparkdl_tpu_torch.obs.export import dump_on_failure
from sparkdl_tpu_torch.resilience.faults import maybe_fault
from sparkdl_tpu_torch.resilience.policy import RetryPolicy, policy_from_env
from sparkdl_tpu_torch.runtime import locksmith
from sparkdl_tpu_torch.utils.metrics import metrics as global_metrics


@dataclass(frozen=True)
class TaskContext:
    """What a partition task knows about its run, published thread-locally
    for the duration of ``fn(i, part)``."""

    partition_index: int
    num_partitions: int
    concurrency: int = 1


_task_local = threading.local()


def current_task_context() -> Optional[TaskContext]:
    """The TaskContext of the map_partitions task running on THIS thread,
    or None outside one (direct calls, producer threads)."""
    return getattr(_task_local, "ctx", None)


@dataclass
class TaskMetrics:
    """Aggregated metrics across one map_partitions run."""

    num_partitions: int = 0
    num_failures: int = 0
    rows: int = 0
    wall_time_s: float = 0.0
    partition_times_s: List[float] = field(default_factory=list)


class PartitionTaskError(RuntimeError):
    """A partition task exhausted its retries."""

    def __init__(self, partition_index: int, attempts: int, cause: BaseException):
        super().__init__(
            f"Partition task {partition_index} failed after {attempts} attempts: "
            f"{type(cause).__name__}: {cause}"
        )
        self.partition_index = partition_index
        self.attempts = attempts
        self.cause = cause


class Executor:
    """Thread-pool partition executor with bounded retry; results always
    come back in partition order."""

    def __init__(
        self,
        max_workers: Optional[int] = None,
        max_failures: int = 2,
        retry_policy: Optional[RetryPolicy] = None,
    ):
        self.max_workers = max_workers or min(16, (os.cpu_count() or 4))
        self.max_failures = max(1, max_failures)
        self.retry_policy = retry_policy or policy_from_env(
            "SPARKDL_EXEC_RETRY",
            max_attempts=self.max_failures,
            base_delay_s=0.05,
            max_delay_s=2.0,
        )
        self._lock = locksmith.lock("sparkdl_tpu_torch/runtime/executor.py::Executor._lock")
        self._pool: Optional[ThreadPoolExecutor] = None
        self._active_calls = 0
        self.last_metrics: Optional[TaskMetrics] = None

    def _acquire_pool(self):
        """The persistent pool for the first concurrent call; a nested call
        (a partition fn that itself executes a DataFrame) gets a private
        pool, since the shared one may be full of the outer tasks.
        Returns (pool, is_private)."""
        with self._lock:
            self._active_calls += 1
            if self._active_calls == 1:
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(
                        max_workers=self.max_workers,
                        thread_name_prefix="sparkdl-exec",
                    )
                return self._pool, False
        return ThreadPoolExecutor(max_workers=self.max_workers), True

    def _release_pool(self, pool, private: bool) -> None:
        with self._lock:
            self._active_calls -= 1
        if private:
            pool.shutdown(wait=True)

    def close(self) -> None:
        """Shut down the persistent pool (idempotent); the next call
        re-creates it."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def map_partitions(
        self,
        fn: Callable[[int, Any], Any],
        partitions: Sequence[Any],
        count_rows: Optional[Callable[[Any], int]] = None,
        sequential: bool = False,
    ) -> List[Any]:
        """Run ``fn(index, partition)`` over all partitions; ordered results.
        ``sequential``: run them one after another in index order, on this
        thread (a plan whose model pairs its batches with other processes'
        by order: ``DataFrame.withColumnPartition(..., serial=True)``)."""
        metrics = TaskMetrics(num_partitions=len(partitions))
        t0 = time.perf_counter()
        results: List[Any] = [None] * len(partitions)
        sequential = sequential or len(partitions) <= 1 or self.max_workers == 1
        concurrency = 1 if sequential else min(self.max_workers, len(partitions))

        def run_one(i: int, part: Any) -> Any:
            prev_ctx = getattr(_task_local, "ctx", None)
            _task_local.ctx = TaskContext(
                partition_index=i,
                num_partitions=len(partitions),
                concurrency=concurrency,
            )
            try:
                return _attempts(i, part)
            finally:
                _task_local.ctx = prev_ctx

        def _attempts(i: int, part: Any) -> Any:
            policy = self.retry_policy
            attempt = 0
            t_start = time.monotonic()
            while True:
                pt0 = time.perf_counter()
                try:
                    with span("executor.partition", partition=i, attempt=attempt) as sp:
                        maybe_fault("executor.partition", partition=i, attempt=attempt)
                        out = fn(i, part)
                        rows = count_rows(out) if count_rows else None
                        if rows is not None:
                            sp.add(rows=rows)
                    dt = time.perf_counter() - pt0
                    global_metrics.record_time("executor.partition.time", dt)
                    with self._lock:
                        metrics.partition_times_s.append(dt)
                        if rows is not None:
                            metrics.rows += rows
                    if rows is not None:
                        global_metrics.inc("executor.rows", rows)
                    return out
                except Exception as e:  # retried; re-raised on exhaustion
                    last_err = e
                    global_metrics.inc("executor.partition.failures")
                    with self._lock:
                        metrics.num_failures += 1
                    if policy.classify(e) and policy.allows(
                        attempt + 1, time.monotonic() - t_start
                    ):
                        global_metrics.inc("executor.partition.retries")
                        delay = policy.delay_s(attempt)
                        if delay > 0.0:
                            time.sleep(delay)
                        attempt += 1
                        continue
                    break
            global_metrics.inc(
                "executor.partition.retry_exhausted"
                if attempt > 0
                else "executor.partition.fatal_errors"
            )
            err = PartitionTaskError(i, attempt + 1, last_err)
            # the flight recorder around a failed partition (env-gated)
            dump_on_failure("partition_task_error")
            raise err

        with span("executor.map_partitions", partitions=len(partitions)):
            if sequential:
                for i, part in enumerate(partitions):
                    results[i] = run_one(i, part)
            else:
                pool, private = self._acquire_pool()
                try:
                    futs = {pool.submit(run_one, i, part): i for i, part in enumerate(partitions)}
                    try:
                        for fut in as_completed(futs):
                            results[futs[fut]] = fut.result()
                    except BaseException:
                        # no task outlives the call: cancel what has not
                        # started, wait out the rest
                        for f in futs:
                            f.cancel()
                        wait(list(futs))
                        raise
                finally:
                    self._release_pool(pool, private)

        metrics.wall_time_s = time.perf_counter() - t0
        self.last_metrics = metrics
        return results


_default_executor: Optional[Executor] = None
_default_lock = locksmith.lock("sparkdl_tpu_torch/runtime/executor.py::_default_lock")


def default_executor() -> Executor:
    global _default_executor
    with _default_lock:
        if _default_executor is None:
            _default_executor = Executor()
        return _default_executor


def set_default_executor(executor: Executor) -> None:
    global _default_executor
    with _default_lock:
        _default_executor = executor
