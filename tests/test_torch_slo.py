"""The port's SLO engine (``sparkdl_tpu_torch/obs/slo.py``) against the JAX
package's, on the CPU.

One seeded sequence of ``note_ok`` / ``note_bad`` events with explicit
clocks goes into both engines under the same knobs, and every
``evaluate()`` along the way (trip, steady, recovery) is held equal key by
key, floats within 1e-12; so are the JSONL events (the timestamp and the
trace store's exemplars aside), the windows and the registry's
``slo.*`` metrics. Then one router per package behind its HTTP server
answers ``GET /v1/slo`` with the same payload after the same requests.
"""

import json
import math
import urllib.request

import numpy as np
import pytest
import torch

import sparkdl_tpu.serving as jax_serving
from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
from sparkdl_tpu.obs import slo as jax_slo
from sparkdl_tpu.obs import trace as jax_trace
from sparkdl_tpu.utils.metrics import metrics as jax_metrics
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.obs import slo, trace
from sparkdl_tpu_torch.runtime import feeder
from sparkdl_tpu_torch.serving import Router, ServingServer
from sparkdl_tpu_torch.utils.metrics import metrics

FLOAT_TOL = 1e-12
T0 = 1000.0


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    monkeypatch.setenv("SPARKDL_INFERENCE_MODE", "roundrobin")
    monkeypatch.setenv("SPARKDL_INFERENCE_DEVICES", "1")
    for name in ("SPARKDL_SLO_AVAIL", "SPARKDL_SLO_P95_MS"):
        for suffix in ("", "_INTERACTIVE", "_BATCH", "_BACKGROUND"):
            monkeypatch.delenv(name + suffix, raising=False)
    monkeypatch.setenv("SPARKDL_SLO_FAST_S", "2")
    monkeypatch.setenv("SPARKDL_SLO_SLOW_S", "8")
    monkeypatch.setenv("SPARKDL_SLO_BURN_FAST", "10")
    monkeypatch.setenv("SPARKDL_SLO_BURN_SLOW", "2")
    monkeypatch.setenv("SPARKDL_SLO_MIN_REQUESTS", "5")
    slo.reset()
    jax_slo.reset()
    yield
    slo.reset()
    jax_slo.reset()
    feeder.shutdown_feeders()


def _equal(a, b, path="$"):
    """Key-by-key equality; floats within FLOAT_TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=0, abs_tol=FLOAT_TOL), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _events(path):
    try:
        with open(path) as f:
            return [json.loads(line) for line in f]
    except FileNotFoundError:
        return []


def _sequence(seed=0):
    """(dt, kind, cls, latency) events: a healthy spell, a spell of
    interactive failures and slow completions, then quiet traffic."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):  # healthy, every class, ~0.05 s apart
        out.append((0.05, "ok", ("interactive", "batch", "background")[i % 3], float(rng.uniform(0.001, 0.02))))
    for i in range(30):  # interactive burns both budgets
        kind = ("failure", "expired", "rejected", "ok")[i % 4]
        out.append((0.04, kind, "interactive", float(rng.uniform(0.2, 0.4))))
    for i in range(20):  # quiet and healthy, long after the fast window
        out.append((0.3 if i else 3.0, "ok", ("interactive", "batch")[i % 2], float(rng.uniform(0.001, 0.02))))
    return out


def _replay(mod, registry, jsonl, monkeypatch):
    """Feed the sequence to a fresh engine of ``mod``; returns the
    evaluations at fixed points, the windows, the events and the deltas of
    the slo.* counters."""
    monkeypatch.setenv("SPARKDL_OBS_JSONL", jsonl)
    registry.reset()  # process-global: other tests leave slo.* metrics behind
    engine = mod.SloEngine(now=T0)
    before = dict(registry.snapshot()["counters"])
    t = T0
    evaluations = [engine.evaluate(now=t)]
    for i, (dt, kind, cls, latency) in enumerate(_sequence()):
        t += dt
        if kind == "ok":
            engine.note_ok(cls, latency, now=t)
        else:
            engine.note_bad(cls, kind, now=t)
        if i % 10 == 9:
            evaluations.append(engine.status(now=t))
    evaluations.append(engine.evaluate(now=t + 10.0))  # the fast window drained
    after = registry.snapshot()["counters"]
    counters = {k: after[k] - before.get(k, 0.0) for k in after if k.startswith("slo.")}
    gauges = {k: v for k, v in registry.snapshot()["gauges"].items() if k.startswith("slo.alert.")}
    return evaluations, engine.window_totals(now=t), _events(jsonl), counters, gauges


@pytest.mark.parametrize("knobs", [
    {"SPARKDL_SLO_AVAIL": "0.99", "SPARKDL_SLO_P95_MS_INTERACTIVE": "100"},
    {"SPARKDL_SLO_AVAIL_INTERACTIVE": "0.999", "SPARKDL_SLO_AVAIL": "0.9"},
    {"SPARKDL_SLO_P95_MS": "50", "SPARKDL_SLO_P95_MS_BATCH": "0"},
], ids=["avail+p95", "per-class-avail", "p95-batch-disarmed"])
def test_engines_agree_on_one_sequence(knobs, monkeypatch, tmp_path):
    for name, value in knobs.items():
        monkeypatch.setenv(name, value)
    trace.reset()  # the alerts name the tail exemplars: none were offered here
    jax_trace.reset()
    ours = _replay(slo, metrics, str(tmp_path / "ours.jsonl"), monkeypatch)
    ref = _replay(jax_slo, jax_metrics, str(tmp_path / "ref.jsonl"), monkeypatch)
    ours_evals, ours_windows, ours_events, ours_counters, ours_gauges = ours
    ref_evals, ref_windows, ref_events, ref_counters, ref_gauges = ref
    _equal(ours_evals, ref_evals)
    _equal(ours_windows, ref_windows)
    assert [e["kind"] for e in ours_events] == [e["kind"] for e in ref_events]
    for mine, theirs in zip(ours_events, ref_events):
        assert mine.pop("exemplar_trace_ids", None) == theirs.pop("exemplar_trace_ids", None)
        mine.pop("ts"), theirs.pop("ts")
        _equal(mine, theirs)
    _equal(ours_counters, ref_counters)
    _equal(ours_gauges, ref_gauges)
    # the sequence trips the interactive class and recovers it
    assert any(e["classes"]["interactive"]["tripped"] for e in ours_evals)
    assert not ours_evals[-1]["classes"]["interactive"]["tripped"]
    assert [e["kind"] for e in ours_events] == ["slo_alert", "slo_recovery"]


def test_unarmed_engine_is_dormant(monkeypatch):
    assert slo.engine_status() is None and jax_slo.engine_status() is None
    slo.note_bad("interactive", "failure")
    assert slo.window_totals() is None
    monkeypatch.setenv("SPARKDL_SLO_AVAIL", "1.5")
    for mod in (slo, jax_slo):
        with pytest.raises(ValueError, match="must be in"):
            mod.engine_status()
        mod.note_bad("batch", "failure")  # the hook swallows the bad knob


def test_disarming_a_tripped_class_recovers_it(monkeypatch, tmp_path):
    monkeypatch.setenv("SPARKDL_SLO_AVAIL", "0.9")

    def run(mod, jsonl):
        monkeypatch.setenv("SPARKDL_SLO_AVAIL", "0.9")
        monkeypatch.setenv("SPARKDL_OBS_JSONL", jsonl)
        engine = mod.SloEngine(now=T0)
        for i in range(10):
            engine.note_bad("batch", "failure", now=T0 + 0.01 * i)
        tripped = engine.evaluate(now=T0 + 0.2)["classes"]["batch"]["tripped"]
        monkeypatch.setenv("SPARKDL_SLO_AVAIL", "0")
        status = engine.evaluate(now=T0 + 0.3)
        return tripped, status, [{k: v for k, v in e.items() if k not in ("ts", "exemplar_trace_ids")}
                                 for e in _events(jsonl)]

    ours, ref = run(slo, str(tmp_path / "a.jsonl")), run(jax_slo, str(tmp_path / "b.jsonl"))
    _equal(ours, ref)
    assert ours[0] is True and ours[2][-1]["reason"] == "disarmed"


# -- GET /v1/slo ------------------------------------------------------------------

ROW = 8


def _weights():
    return np.random.default_rng(4).normal(size=(ROW, 4)).astype(np.float32)


def _port_loader(name, mode):
    w = torch.nn.Module()
    w.w = torch.nn.Parameter(torch.from_numpy(_weights()))
    return ModelFunction(lambda m, x: x @ m.w, w, torch.device("cpu"), name=name, input_shape=(ROW,))


def _jax_loader(name, mode):
    return JaxModelFunction(lambda p, x: x @ p, _weights(), input_shape=(ROW,), name=name)


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_http_slo_payload_equals_jax(monkeypatch):
    monkeypatch.setenv("SPARKDL_SLO_AVAIL", "0.99")
    monkeypatch.setenv("SPARKDL_SLO_P95_MS", "60000")  # never slow: latency varies by run
    rows = np.random.default_rng(1).normal(size=(3, ROW)).astype(np.float32)
    payloads, submitted = [], []
    for engine, server_cls, router in ((slo, ServingServer, Router(loader=_port_loader, device="cpu")),
                                       (jax_slo, jax_serving.ServingServer, jax_serving.Router(loader=_jax_loader))):
        trace.reset()
        jax_trace.reset()
        server = server_cls(router, port=0)
        base = f"http://127.0.0.1:{server.port}"
        try:
            assert _get(base, "/v1/slo")[1]["armed"] is True
            ids = {}
            for i in range(12):
                req = router.submit("m", rows[i % 3:i % 3 + 1], priority=("interactive", "batch")[i % 2])
                req.result(timeout=60)
                ids.setdefault(req.priority, set()).add(req.trace_id)
            submitted.append(ids)
            status, payload = _get(base, "/v1/slo")
            assert status == 200
            payloads.append(payload)
        finally:
            server.stop(close_router=True)
        engine.reset()
    ours, ref = payloads
    for payload in payloads:  # measured latency differs run to run
        for name, cls in payload["classes"].items():
            for obj in cls["objectives"]:
                if obj["objective"] == "latency_p95":
                    observed = obj.pop("observed_p95_ms", None)
                    assert (observed is None) == (name == "background")
    # each class's tail exemplars: as many as the JAX server names (the
    # slowest K of its completions), each one of that class's own requests
    ex_ours, ex_ref = ours.pop("exemplars"), ref.pop("exemplars")
    assert set(ex_ours) == set(ex_ref) == set(slo.CLASSES)
    for cls in slo.CLASSES:
        assert len(ex_ours[cls]) == len(ex_ref[cls]) == (0 if cls == "background" else 4)
        assert set(ex_ours[cls]) <= submitted[0].get(cls, set())
        assert set(ex_ref[cls]) <= submitted[1].get(cls, set())
    trace.reset()
    jax_trace.reset()
    _equal(ours, ref)
    assert ours["windows"]["interactive"]["ok_fast"] == 6.0


def test_http_slo_unarmed(monkeypatch):
    router = Router(loader=_port_loader, device="cpu")
    server = ServingServer(router, port=0)
    try:
        assert _get(f"http://127.0.0.1:{server.port}", "/v1/slo") == (200, {"armed": False})
        assert "slo" not in router.stats()
    finally:
        server.stop(close_router=True)
