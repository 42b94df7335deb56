"""The port's shared feeder (``runtime/feeder.py``), readback, staging and
device fn against the JAX package's, on the CPU.

Both feeders dispatch the same numpy matmul weights (``x @ w``): the JAX
side through its ``model_device_fn`` on one CPU device, the port through
its own on ``device="cpu"``. Same rows from a numpy seed on both sides;
outputs equal at atol 1e-6 (one f32 matmul of 8 terms, summed in the same
order up to the library's blocking). Also: exact_float32's reference
count under two threads, and the launch thread that every CUDA device fn's
calls go through (driven here with a CPU fn that has one).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
from sparkdl_tpu.runtime import feeder as jax_feeder
from sparkdl_tpu.runtime import readback as jax_readback
from sparkdl_tpu.transformers import execution as jax_execution
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.runtime import feeder, readback, transfer
from sparkdl_tpu_torch.runtime.device import Launcher, exact_float32
from sparkdl_tpu_torch.transformers.execution import (
    default_prefetch,
    model_device_fn,
)
from sparkdl_tpu_torch.utils.metrics import metrics

ROW, OUT = 8, 4
ATOL = 1e-6


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("SPARKDL_INFERENCE_MODE", "roundrobin")
    monkeypatch.setenv("SPARKDL_INFERENCE_DEVICES", "1")
    monkeypatch.setenv("SPARKDL_FEEDER_LINGER_MS", "5")
    yield
    feeder.shutdown_feeders()
    jax_feeder.shutdown_feeders()


def _weights(seed=0):
    return np.random.default_rng(seed).normal(size=(ROW, OUT)).astype(np.float32)


class _MatMul(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))


def _port_fn(w):
    return model_device_fn(
        ModelFunction(lambda m, x: x @ m.w, _MatMul(w), torch.device("cpu"),
                      input_shape=(ROW,))
    )


def _jax_fn(w):
    return jax_execution.model_device_fn(
        JaxModelFunction(lambda p, x: x @ p, jnp.asarray(w), input_shape=(ROW,))
    )


def _rows(n, seed):
    return np.random.default_rng(seed).normal(size=(n, ROW)).astype(np.float32)


def _interleaved(mod, device_fn, dispatch_rows=8):
    """Three handles submitting interleaved chunks with masked (skipped)
    destinations and partial tails; returns the three output lists."""
    f = mod.get_feeder(device_fn, dispatch_rows, (ROW,), np.float32, 2)
    sizes = (13, 7, 20)
    outs = [[None] * n for n in sizes]
    handles = [f.open_handle(o, partition=i) for i, o in enumerate(outs)]
    for step in range(4):
        for i, (h, n) in enumerate(zip(handles, sizes)):
            lo, hi = step * n // 4, (step + 1) * n // 4
            dest = np.arange(lo, hi)
            keep = dest[dest % 5 != 3]  # masked rows never reach the device
            if len(keep):
                f.submit_rows(h, keep, _rows(n, seed=i)[keep])
    for h in handles:
        f.finish(h)
    for h in handles:
        h.wait(timeout=60)
    return outs


def _assert_outs_equal(ours, ref, w):
    for i, (o, r) in enumerate(zip(ours, ref)):
        x = _rows(len(o), seed=i)
        for k, (a, b) in enumerate(zip(o, r)):
            if k % 5 == 3:
                assert a is None and b is None
                continue
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
            np.testing.assert_allclose(a, x[k] @ w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("stage", ["1", "0"], ids=["staged", "unstaged"])
@pytest.mark.parametrize("async_readback", ["1", "0"], ids=["async", "sync"])
def test_interleaved_handles_match_jax(stage, async_readback, monkeypatch):
    monkeypatch.setenv("SPARKDL_DEVICE_STAGE", stage)
    monkeypatch.setenv("SPARKDL_ASYNC_READBACK", async_readback)
    w = _weights()
    ours = _interleaved(feeder, _port_fn(w))
    ref = _interleaved(jax_feeder, _jax_fn(w))
    _assert_outs_equal(ours, ref, w)


def test_arms_give_the_same_rows(monkeypatch):
    """Every (stage, readback) arm gives the same rows as the default."""
    w = _weights(3)
    fn = _port_fn(w)
    results = {}
    for stage in ("1", "0"):
        for rb in ("1", "0"):
            monkeypatch.setenv("SPARKDL_DEVICE_STAGE", stage)
            monkeypatch.setenv("SPARKDL_ASYNC_READBACK", rb)
            results[stage, rb] = _interleaved(feeder, fn)
            feeder.shutdown_feeders()
    base = results["1", "1"]
    for outs in results.values():
        for o, b in zip(outs, base):
            for a, c in zip(o, b):
                assert (a is None) == (c is None)
                if a is not None:
                    np.testing.assert_array_equal(a, c)


def test_stage_and_readback_counters_move(monkeypatch):
    monkeypatch.setenv("SPARKDL_DEVICE_STAGE", "1")
    monkeypatch.setenv("SPARKDL_ASYNC_READBACK", "1")
    hits0 = metrics.counter("transfer.stage_hits")
    rows0 = metrics.counter("feeder.rows")
    _interleaved(feeder, _port_fn(_weights()))
    # CPU staging has no copy in flight: every claim is a hit
    assert metrics.counter("transfer.stage_hits") > hits0
    assert metrics.counter("feeder.rows") - rows0 == sum(
        1 for n in (13, 7, 20) for k in range(n) if k % 5 != 3
    )


def test_run_shared_matches_jax():
    w = _weights(1)
    cells = [None if i % 7 == 2 else _rows(1, seed=i)[0] for i in range(45)]

    def to_batch(chunk):
        batch = np.zeros((len(chunk), ROW), np.float32)
        mask = np.array([c is not None for c in chunk])
        for i, c in enumerate(chunk):
            if c is not None:
                batch[i] = c
        return batch, mask

    ours = feeder.run_shared(_port_fn(w), cells, to_batch, batch_size=8)
    ref = jax_feeder.run_shared(_jax_fn(w), cells, to_batch, batch_size=8)
    for a, b in zip(ours, ref):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mod", [feeder, jax_feeder], ids=["torch", "jax"])
def test_close_feeders_for_closes_every_stream_of_one_fn(mod):
    w = _weights()
    fn, other = (_port_fn(w), _port_fn(w)) if mod is feeder else (_jax_fn(w), _jax_fn(w))
    fa = mod.get_feeder(fn, 4, (ROW,), np.float32, 2)
    fb = mod.get_feeder(fn, 8, (ROW,), np.float32, 2)
    fc = mod.get_feeder(other, 4, (ROW,), np.float32, 2)
    assert mod.get_feeder(fn, 4, (ROW,), np.float32, 2) is fa
    assert mod.close_feeders_for(fn) == 2
    assert fa._closed and fb._closed and not fc._closed
    with pytest.raises(RuntimeError, match="closed"):
        fa.open_handle([])
    assert mod.get_feeder(fn, 4, (ROW,), np.float32, 2) is not fa
    assert mod.close_feeders_for(fn) == 1


@pytest.mark.parametrize("mod", [feeder, jax_feeder], ids=["torch", "jax"])
def test_lru_cap_closes_the_oldest_idle_feeder(mod, monkeypatch):
    monkeypatch.setenv("SPARKDL_MAX_FEEDERS", "2")
    fn = _port_fn(_weights()) if mod is feeder else _jax_fn(_weights())
    f1 = mod.get_feeder(fn, 1, (ROW,), np.float32, 2)
    f2 = mod.get_feeder(fn, 2, (ROW,), np.float32, 2)
    assert mod.get_feeder(fn, 1, (ROW,), np.float32, 2) is f1  # f1 now newest
    f3 = mod.get_feeder(fn, 4, (ROW,), np.float32, 2)
    assert f2._closed and not f1._closed and not f3._closed
    # a busy feeder is never evicted, even past the cap
    h = f1.open_handle([None])
    mod.get_feeder(fn, 8, (ROW,), np.float32, 2)
    assert not f1._closed
    f1.finish(h)


def test_a_cap_eviction_never_fails_a_stream_opened_under_it(monkeypatch):
    """The idle check and the close are one step: a producer that looked
    its feeder up before an eviction either holds it busy or finds it
    closed and is handed a fresh one (``run_shared``'s open retries), so
    no open handle is failed with "DeviceFeeder closed"."""
    monkeypatch.setenv("SPARKDL_MAX_FEEDERS", "1")
    fn = _port_fn(_weights())
    f1 = feeder.get_feeder(fn, 1, (ROW,), np.float32, 2)
    h = f1.open_handle([None])
    assert not f1.retire_if_idle() and not f1._closed
    f1.finish(h)
    deadline = time.monotonic() + 5.0  # the owner takes the end marker
    while not f1.idle() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert f1.retire_if_idle() and f1._closed
    with pytest.raises(RuntimeError, match="DeviceFeeder is closed"):
        f1.open_handle([None])
    f1.close()
    f2 = feeder.get_feeder(fn, 2, (ROW,), np.float32, 2)
    assert feeder.get_feeder(fn, 1, (ROW,), np.float32, 2) is not f1
    assert f2._closed  # the cap of 1 retired it for the new stream
    rows = [np.full(ROW, 1.0, np.float32)] * 3
    out = feeder.run_shared(fn, rows, lambda c: (np.stack(c), np.ones(len(c), bool)), 2)
    assert len(out) == 3 and all(o is not None for o in out)


def test_allocated_block_bytes_needs_cuda_tensors():
    """The load charge reads the allocator's blocks only for a module on
    a CUDA device; off it the residency keeps its own measurement."""
    from sparkdl_tpu_torch.obs import memory

    assert memory.allocated_block_bytes(torch.nn.Linear(4, 4)) is None


@pytest.mark.parametrize("mod", [feeder, jax_feeder], ids=["torch", "jax"])
def test_device_fn_error_reaches_every_open_handle(mod, monkeypatch):
    monkeypatch.setenv("SPARKDL_DEVICE_STAGE", "0")
    calls = []

    def boom(batch):
        calls.append(1)
        raise RuntimeError("device exploded")

    boom.device = torch.device("cpu")
    f = mod.get_feeder(boom, 4, (ROW,), np.float32, 2)
    outs = [[None] * 4 for _ in range(3)]
    handles = [f.open_handle(o) for o in outs]
    for h in handles[:2]:
        f.submit_rows(h, np.arange(2), _rows(2, seed=0))
    for h in handles:
        f.finish(h)
    for h in handles[:2]:
        with pytest.raises(RuntimeError, match="device exploded"):
            h.wait(timeout=30)
    assert calls
    # the feeder resets: later work through a good fn on it still runs
    good = _port_fn(_weights()) if mod is feeder else _jax_fn(_weights())
    g = mod.get_feeder(good, 4, (ROW,), np.float32, 2)
    out = [None] * 4
    h = g.open_handle(out)
    g.submit_rows(h, np.arange(4), _rows(4, seed=5))
    g.finish(h)
    h.wait(timeout=30)
    np.testing.assert_allclose(np.stack(out), _rows(4, seed=5) @ _weights(), atol=ATOL)


def test_scatter_rows_matches_jax():
    rows = _rows(6, seed=2)
    for dest in (np.arange(3, 9), np.array([0, 2, 3, 7, 8, 11])):
        ours, ref = [None] * 12, [None] * 12
        readback.scatter_rows(ours, dest, rows)
        jax_readback.scatter_rows(ref, dest, rows)
        assert [o is None for o in ours] == [r is None for r in ref]
        for o, r in zip(ours, ref):
            if o is not None:
                np.testing.assert_array_equal(o, r)


def test_readback_and_staging_on_the_cpu():
    y = torch.arange(6.0).reshape(2, 3)
    assert readback.start_copy(y) is y  # already on the host
    assert readback.is_ready(y) is None
    np.testing.assert_array_equal(readback.to_host(y), y.numpy())
    host = torch.ones(2, 3)
    slot = transfer.stage_batch(_port_fn(_weights()).stage_put, host, rows=2)
    staged = slot.take()
    assert staged.tensor is host and staged.event is None
    slot.settle()


def test_model_device_fn_attributes_and_nhwc_permute():
    seen = []
    mf = ModelFunction(
        lambda m, x: seen.append(tuple(x.shape)) or x.mean(dim=(2, 3)),
        torch.nn.Module(), torch.device("cpu"), input_shape=(5, 6, 3),
    )
    fn = model_device_fn(mf)
    assert fn.device == torch.device("cpu") and fn.stream is None
    assert fn.batch_multiplier == 1 and fn.single_stream is False
    assert default_prefetch(fn) == default_prefetch() == 2
    x = np.random.default_rng(0).normal(size=(2, 5, 6, 3)).astype(np.float32)
    out = fn(x)
    assert seen == [(2, 3, 5, 6)]  # NHWC rows reach the module as NCHW
    np.testing.assert_allclose(out.numpy(), x.mean(axis=(1, 2)), atol=1e-6)


def test_exact_float32_is_reference_counted_across_threads():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    first_in, second_in = threading.Event(), threading.Event()
    first_out = threading.Event()
    seen = {}

    def first():
        with exact_float32():
            first_in.set()
            second_in.wait(5)
        first_out.set()

    def second():
        first_in.wait(5)
        with exact_float32():
            second_in.set()
            first_out.wait(5)
            # the first holder left: TF32 must still be off for this one
            seen["inside"] = (cudnn.allow_tf32, matmul.allow_tf32)

    try:
        threads = [threading.Thread(target=f) for f in (first, second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        assert seen["inside"] == (False, False)
        # the last holder put the caller's switches back
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_exact_float32_stress_restores_the_switches():
    import sys

    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    errors = []

    def worker():
        for _ in range(300):
            with exact_float32():
                if cudnn.allow_tf32:
                    errors.append("TF32 on inside a holder")

    try:
        cudnn.allow_tf32 = True
        threads = [threading.Thread(target=worker) for _ in range(8)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert time.monotonic() - t0 < 30
        assert not any(t.is_alive() for t in threads)
        assert not errors
        assert cudnn.allow_tf32 is True
    finally:
        sys.setswitchinterval(old)
        cudnn.allow_tf32 = saved


@pytest.mark.parametrize("stage", ["1", "0"], ids=["staged", "unstaged"])
@pytest.mark.parametrize("async_readback", ["1", "0"], ids=["async", "sync"])
def test_an_ended_stream_does_not_wait_for_the_queue_poll(stage, async_readback, monkeypatch):
    """A serving group submits exactly full batches and ends its stream at
    once: its results come back without the owner waiting out a queue
    poll (here 5 s), on every arm."""
    monkeypatch.setenv("SPARKDL_DEVICE_STAGE", stage)
    monkeypatch.setenv("SPARKDL_ASYNC_READBACK", async_readback)
    monkeypatch.setattr(feeder, "_POLL_S", 5.0)
    w = _weights(4)
    f = feeder.get_feeder(_port_fn(w), 4, (ROW,), np.float32, 2)
    for group in range(3):
        rows = _rows(8, seed=group)
        out = [None] * 8
        t0 = time.monotonic()
        h = f.open_handle(out)
        f.submit_rows(h, np.arange(8), rows)
        f.finish(h)
        h.wait(timeout=30)
        assert time.monotonic() - t0 < 2.5
        np.testing.assert_allclose(np.stack(out), rows @ w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("depth", ["1", "3"])
def test_stage_depth_sizes_the_ring_and_keeps_the_rows(depth, monkeypatch):
    """Staged slots riding ahead of dispatch: any depth gives the JAX
    feeder's rows, and the ring holds 1 filling + depth + prefetch + 1."""
    monkeypatch.setenv("SPARKDL_DEVICE_STAGE", "1")
    monkeypatch.setenv("SPARKDL_DEVICE_STAGE_DEPTH", depth)
    monkeypatch.setenv("SPARKDL_ASYNC_READBACK", "1")
    w = _weights(6)
    fn = _port_fn(w)
    ours = _interleaved(feeder, fn, dispatch_rows=4)
    f = feeder.get_feeder(fn, 4, (ROW,), np.float32, 2)
    assert f._ring_cap == 2 + int(depth) + 2
    assert f._allocated <= f._ring_cap
    _assert_outs_equal(ours, _interleaved(jax_feeder, _jax_fn(w), dispatch_rows=4), w)


@pytest.mark.parametrize("async_readback", ["1", "0"], ids=["async", "sync"])
def test_feeders_issue_every_call_on_the_launcher_thread(async_readback, monkeypatch):
    """Two feeders of two fns that share a launcher: every call of either
    runs on the launcher's one thread, and the rows are the JAX feeder's."""
    monkeypatch.setenv("SPARKDL_ASYNC_READBACK", async_readback)
    la = Launcher("test-launch")
    callers = set()
    ws = (_weights(7), _weights(8))
    fns = []
    for w in ws:
        inner = _port_fn(w)

        def fn(batch, inner=inner):
            callers.add(threading.current_thread().name)
            return inner(batch)

        fn.device, fn.stream, fn.stage_put = inner.device, None, inner.stage_put
        fn.launcher = la
        fns.append(fn)
    results = [None, None]

    def run(i):
        results[i] = _interleaved(feeder, fns[i], dispatch_rows=4)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert callers == {"test-launch"}
    for ours, w in zip(results, ws):
        _assert_outs_equal(ours, _interleaved(jax_feeder, _jax_fn(w), dispatch_rows=4), w)


def test_launcher_returns_results_and_raises_errors_in_the_caller():
    la = Launcher("test-launch-2")
    assert la.run(lambda a, b: (a + b, threading.current_thread().name), 2, 3) == (5, "test-launch-2")

    def boom():
        raise ValueError("no such kernel")

    with pytest.raises(ValueError, match="no such kernel"):
        la.run(boom)
    # a call made from the launcher's own thread runs in place, not queued
    # behind itself
    assert la.run(lambda: la.run(lambda: 7)) == 7
