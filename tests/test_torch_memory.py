"""The port's device-memory ledger (``sparkdl_tpu_torch/obs/memory.py``)
against the JAX package's, on the CPU.

One sequence of model loads and evicts, staged and readback buffers and
K/V charges goes into both ledgers with explicit clocks; the per-model
and per-device tables, the watermarks, the ring and the registry's
``mem.*`` counters are held equal as integers after every step. Ground
truth differs by design (the JAX package sizes ``jax.live_arrays()`` on
the CPU; the port reads ``torch.cuda.memory_allocated`` and has no CPU
probe), so the leak check and the OOM record run under a probe injected
into both. Then a port router on the CPU attributes its own loads,
evicts, staging and readback, and ``GET /v1/memory`` reports them.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from sparkdl_tpu.obs import memory as jax_memory
from sparkdl_tpu.utils.metrics import metrics as jax_metrics
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.obs import memory
from sparkdl_tpu_torch.runtime import feeder
from sparkdl_tpu_torch.serving import AdmissionRejected, Router, ServingServer
from sparkdl_tpu_torch.utils.metrics import metrics

T0 = 500.0


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv("SPARKDL_SERVE_HBM_BUDGET_MB", raising=False)
    monkeypatch.setenv("SPARKDL_MEM_RING", "16")
    memory.reset()
    yield
    memory.reset()
    feeder.shutdown_feeders()


STEPS = [
    ("load", "alpha", 1000),
    ("staged", 256),
    ("readback", 64),
    ("load", "beta", 3001),
    ("kv_alloc", 4096),
    ("staged", 301),
    ("release_staged", 256),
    ("kv_alloc", 2048),
    ("release_readback", 64),
    ("evict", "alpha", 1000),
    ("kv_free", 4096),
    ("release_staged", 301),
    ("load", "alpha", 1200),
    ("kv_free", 2048),
    ("evict", "beta", 3001),
    ("release_staged", 999),  # a stray release floors at 0
]


def _apply(ledger, step, t):
    """One step into the port's ledger, or into the JAX ledger (whose
    notes take a device fn first: None, one device)."""
    op = step[0]
    ref = isinstance(ledger, jax_memory.MemoryLedger)
    if op == "load":
        ledger.note_model_loaded(step[1], step[2], estimate_bytes=step[2] - 10, now=t)
    elif op == "evict":
        ledger.note_model_evicted(step[1], step[2], now=t)
    else:
        fn = {"staged": ledger.note_staged, "release_staged": ledger.release_staged,
              "readback": ledger.note_readback, "release_readback": ledger.release_readback,
              "kv_alloc": ledger.note_kv_alloc, "kv_free": ledger.note_kv_free}[op]
        fn(*((None,) if ref else ()), step[1], now=t)


def _events(ledger, n=None):
    """The allocation ring, without the JAX ledger's ``width`` field."""
    tail = ledger.events_tail() if n is None else ledger.events_tail(n)
    return [{k: v for k, v in e.items() if k != "width"} for e in tail]


def _view(ledger, registry, before, t):
    status = ledger.status(now=t)
    for key in ("ground_truth_bytes", "ground_truth_source", "unattributed_bytes"):
        status.pop(key)
    counters = registry.snapshot()["counters"]
    gauges = registry.snapshot()["gauges"]
    deltas = {k: int(v - before.get(k, 0)) for k, v in counters.items() if k.startswith("mem.")}
    # mem.unattributed_bytes is ground truth's, which differs by design
    return status, deltas, {k: int(v) for k, v in gauges.items()
                            if k.startswith("mem.") and k != "mem.unattributed_bytes"}, _events(ledger)


def test_ledgers_agree_step_by_step():
    metrics.reset()  # the registries are process-global: start both empty
    jax_metrics.reset()
    ours, ref = memory.MemoryLedger(probe=lambda: (None, None)), jax_memory.MemoryLedger()
    before_ours = dict(metrics.snapshot()["counters"])
    before_ref = dict(jax_metrics.snapshot()["counters"])
    assert ours.status() is None and ref.status() is None
    for i, step in enumerate(STEPS):
        t = T0 + i
        _apply(ours, step, t)
        _apply(ref, step, t)
        mine = _view(ours, metrics, before_ours, t)
        theirs = _view(ref, jax_metrics, before_ref, t)
        assert mine == theirs, (i, step)
    status = ours.status(now=T0 + 99)
    assert status["models"] == {"alpha": 1200} and status["tracked_bytes"] == 1200
    assert sorted(status["devices"]) == ["0"]
    assert status["watermark_bytes"] == status["devices"]["0"]["watermark_bytes"]
    assert status["devices"]["0"]["kv_bytes"] == 0 and len(ours.events_tail(100)) == 16  # the ring's cap


class _Probe:
    """An injected ground truth: a value the test moves."""

    def __init__(self, value):
        self.value = value

    def __call__(self):
        return self.value, "test"


@pytest.mark.parametrize("residue", [0, 4 * 2**20, 64 * 2**20], ids=["clean", "inside-tolerance", "leak"])
def test_leak_check_under_an_injected_probe(residue, monkeypatch, tmp_path):
    results = []
    for name, mod, make in (("ours", memory, lambda p: memory.MemoryLedger(probe=p)),
                            ("ref", jax_memory, lambda p: jax_memory.MemoryLedger())):
        probe = _Probe(10 * 2**20)
        monkeypatch.setattr(jax_memory, "ground_truth_bytes", probe)
        jsonl = str(tmp_path / f"{name}.jsonl")
        monkeypatch.setenv("SPARKDL_OBS_JSONL", jsonl)
        ledger = make(probe)
        baseline = (probe.value, ledger.tracked_bytes())
        ledger.note_model_loaded("m", 5 * 2**20, now=T0)
        probe.value += 5 * 2**20
        ledger.note_model_evicted("m", 5 * 2**20, now=T0 + 1)
        probe.value -= 5 * 2**20 - residue
        leaked = ledger.leak_check("m", *baseline, now=T0 + 2)
        try:
            with open(jsonl) as f:
                events = [json.loads(line) for line in f]
        except FileNotFoundError:
            events = []
        for e in events:
            e.pop("ts")
        status = ledger.status(now=T0 + 3)
        results.append((leaked, events, status["leaked_bytes"], status["leak_events"],
                        status["ground_truth_bytes"], status["unattributed_bytes"]))
    assert results[0] == results[1]
    leaked, events = results[0][:2]
    assert leaked == (residue if residue > 8 * 2**20 else 0)
    assert [e["kind"] for e in events] == (["mem_leak"] if leaked else [])


def test_record_oom_event_under_an_injected_probe(monkeypatch, tmp_path):
    events = []
    for name, make in (("ours", lambda p: memory.MemoryLedger(probe=p)),
                       ("ref", lambda p: jax_memory.MemoryLedger())):
        probe = _Probe(7 * 2**20)
        monkeypatch.setattr(jax_memory, "ground_truth_bytes", probe)
        monkeypatch.setattr(jax_memory, "dump_on_failure", lambda *a, **k: None, raising=False)
        jsonl = str(tmp_path / f"{name}.jsonl")
        monkeypatch.setenv("SPARKDL_OBS_JSONL", jsonl)
        ledger = make(probe)
        ledger.note_model_loaded("resnet", 3 * 2**20, now=T0)
        ledger.note_model_loaded("bert", 2 * 2**20, now=T0 + 1)
        _apply(ledger, ("kv_alloc", 4096), T0 + 2)
        err = MemoryError("out of memory")
        ledger.record_oom("admission", "bert", err, now=T0 + 3)
        ledger.record_oom("dispatch", "bert", err, now=T0 + 4)  # once per exception
        with open(jsonl) as f:
            (event,) = [json.loads(line) for line in f]
        event.pop("ts")
        event["recent_allocations"] = [{k: v for k, v in e.items() if k != "width"}
                                       for e in event["recent_allocations"]]
        events.append(event)
        assert ledger.status(now=T0 + 5)["oom_events"] == 1
    assert events[0] == events[1]
    assert events[0]["models"] == {"resnet": 3 * 2**20, "bert": 2 * 2**20}
    assert events[0]["ground_truth_bytes"] == 7 * 2**20 and events[0]["phase"] == "admission"
    assert [e["op"] for e in events[0]["recent_allocations"]] == ["model_load", "model_load", "kv_alloc"]


@pytest.mark.parametrize("err,want", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (MemoryError(), True),
    (RuntimeError("cannot load model 'x' (10.0 MB): HBM budget 5.0 MB has 0.0 MB resident"), True),
    (AdmissionRejected("KV-cache reservation of 1.00 MB refused: HBM budget 2.0 MB has 2.0 MB"), True),
    (RuntimeError("device exploded"), False),
    (ValueError("Unknown model"), False),
])
def test_is_oom_error_agrees(err, want):
    assert memory.is_oom_error(err) is want
    if not isinstance(err, torch.cuda.OutOfMemoryError):
        assert jax_memory.is_oom_error(err) is want


def test_cpu_has_no_ground_truth():
    assert memory.ground_truth_bytes() == (None, None)
    ledger = memory.MemoryLedger()
    assert ledger.reconcile() is None and ledger.leak_check("m", None, 0) is None


# -- the router's attribution and GET /v1/memory -------------------------------

ROW = 8


def _loader(name, mode):
    w = torch.nn.Module()
    seed = {"a": 1, "b": 2}[name]
    w.w = torch.nn.Parameter(torch.from_numpy(np.random.default_rng(seed).normal(size=(ROW, 4)).astype(np.float32)))
    return ModelFunction(lambda m, x: x @ m.w, w, torch.device("cpu"), name=name, input_shape=(ROW,))


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_router_attribution_and_http_payload(monkeypatch):
    model_bytes = ROW * 4 * 4
    router = Router(loader=_loader, device="cpu", budget_bytes=model_bytes + 16)
    server = ServingServer(router, port=0)
    base = f"http://127.0.0.1:{server.port}"
    before = dict(metrics.snapshot()["counters"])
    rows = np.random.default_rng(0).normal(size=(3, ROW)).astype(np.float32)
    try:
        assert _get(base, "/v1/memory") == (200, {"tracked": False, "budget_bytes": model_bytes + 16})
        for name in ("a", "b", "a"):  # one fits: every switch evicts
            router.submit(name, rows, priority="interactive").result(timeout=60)
        status, payload = _get(base, "/v1/memory")
        assert status == 200 and payload["budget_bytes"] == model_bytes + 16
        assert payload["models"] == {m["name"]: m["param_bytes"] for m in router.stats()["models"]} == {
            "a": model_bytes}
        assert payload["tracked_bytes"] == model_bytes and payload["ground_truth_bytes"] is None
        assert payload["watermark_bytes"] > model_bytes  # staged and readback bytes peaked through
        assert router.stats()["memory"]["models"] == payload["models"]
        snap = metrics.snapshot()["counters"]
        delta = {k: int(snap[k] - before.get(k, 0)) for k in snap if k.startswith("mem.")}
        assert delta["mem.alloc_bytes_total.model"] == 3 * model_bytes
        assert delta["mem.free_bytes_total.model"] == 2 * model_bytes
        for cls in ("staged", "readback"):
            assert delta[f"mem.alloc_bytes_total.{cls}"] == delta[f"mem.free_bytes_total.{cls}"] > 0
    finally:
        server.stop(close_router=True)
    status = memory.memory_status()
    assert status["tracked_bytes"] == 0 and status["models"] == {} and status["leak_events"] == 0
