"""The port's serving gateway (``sparkdl_tpu_torch/serving/gateway.py``)
against the JAX package's, on the CPU.

Fake in-process workers (loopback HTTP servers speaking the worker
protocol) stand in for the subprocess gang, as in the JAX file
``tests/test_gateway.py``: each scenario runs once through a JAX gateway
and once through a port gateway, each over its own fake gang, and the
routing sequence (which worker answered), the status codes, the
``Retry-After`` headers, the workers' states, the gateway trace records,
and the resize, autoscale and canary-wave decisions are held equal.
``AffinityRing.order`` is equal for 500 keys at several replica counts,
and ``placement_key`` for a corpus of bodies. The real gang (subprocess
workers under the supervisor, a crash mid-flood) is
``tests/test_torch_gang.py``.
"""

import json
import sys
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from sparkdl_tpu.obs import trace as jax_trace
from sparkdl_tpu.serving import gateway as jax_gateway
from sparkdl_tpu_torch.obs import trace
from sparkdl_tpu_torch.serving import gateway

PACKAGES = {"jax": (jax_gateway, jax_trace), "torch": (gateway, trace)}


class FakeWorker:
    """Just enough worker protocol: ``/healthz`` with a settable status,
    ``/v1/predict`` answering with this worker's index (or dying or
    draining on demand), ``/admin/canary``, ``/admin/drain`` and
    ``/admin/profile``."""

    def __init__(self, index):
        self.index = index
        self.health = "ok"
        self.predict_mode = "ok"  # ok | draining | die | overload | bad
        self.hits = []
        self.canary_weights = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, code, payload, headers=None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"status": outer.health})
                elif self.path in ("/v1/models", "/v1/slo", "/v1/memory"):
                    self._json(200, {"rank": outer.index, "path": self.path})
                else:
                    self._json(404, {})

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length)
                outer.hits.append((self.path, self.headers.get("X-Sparkdl-Trace")))
                if self.path == "/admin/canary":
                    w = float(json.loads(body or b"{}")["weight"])
                    outer.canary_weights.append(w)
                    self._json(200, {"weight": w, "tripped": False})
                    return
                if self.path == "/admin/drain":
                    self._json(200, {"status": "draining"})
                    return
                if self.path == "/admin/profile":
                    seconds = json.loads(body or b"{}")["seconds"]
                    self._json(200, {"status": "ok", "worker": outer.index, "seconds": seconds})
                    return
                if self.path != "/v1/predict":
                    self._json(404, {"error": "not found"})
                    return
                mode = outer.predict_mode
                if mode == "die":
                    self.connection.close()
                elif mode == "draining":
                    self._json(503, {"error": "draining", "status": "draining"},
                               headers={"Retry-After": 1})
                elif mode == "overload":
                    self._json(429, {"error": "queue full"}, headers={"Retry-After": 2})
                elif mode == "bad":
                    self._json(400, {"error": "bad request"})
                else:
                    self._json(200, {"worker": outer.index, "outputs": [[1.0]]})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, args=(0.05,),
                                        name=f"sparkdl-test-fakeworker-{self.port}", daemon=True)
        self._thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def _make_gang(mod, tmp_path, n=2):
    tmp_path.mkdir(parents=True, exist_ok=True)
    workers = [FakeWorker(i) for i in range(n)]
    gw = mod.ServingGateway(num_workers=n, gang_dir=str(tmp_path))
    gw._on_generation(0, [])
    for rank, w in enumerate(workers):
        with open(mod.port_file(str(tmp_path), rank), "w") as f:
            json.dump({"rank": rank, "port": w.port, "pid": 1, "generation": 0}, f)
    gw._poll_health_once()
    return gw, workers


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("SPARKDL_GATEWAY_PENDING_S", "2")
    for name in ("SPARKDL_GATEWAY_AFFINITY", "SPARKDL_SERVE_CANARY_WAVES", "SPARKDL_TRACE_SAMPLE",
                 "SPARKDL_SERVE_PRECISION", "SPARKDL_SERVE_PRECISION_BATCH"):
        monkeypatch.delenv(name, raising=False)


def _answer(code, body, headers):
    try:
        payload = json.loads(body)
    except ValueError:
        payload = None
    who = payload.get("worker") if isinstance(payload, dict) else None
    status = payload.get("status") if isinstance(payload, dict) else None
    return (code, who, status, headers.get("Retry-After"))


def _states(gw):
    return [(w["rank"], w["status"], w["generation"]) for w in gw.workers()]


def _predicts(gw, n, body=b'{"model": "m"}', rank=None):
    return [_answer(*gw.forward("/v1/predict", body, rank=rank)) for _ in range(n)]


# -- the scenarios: each returns what it observed ---------------------------


def sc_round_robin(gw, ws, tr, monkeypatch):
    return _predicts(gw, 6), _states(gw)


def sc_draining_health(gw, ws, tr, monkeypatch):
    ws[0].health = "draining"
    gw._poll_health_once()
    return _states(gw), _predicts(gw, 4)


def sc_dead_probe(gw, ws, tr, monkeypatch):
    ws[0].stop()
    gw._poll_health_once()
    return _states(gw), _predicts(gw, 3)


def sc_redispatch_off_dying(gw, ws, tr, monkeypatch):
    ws[0].predict_mode = "die"
    return _predicts(gw, 4), _states(gw)


def sc_redispatch_off_draining(gw, ws, tr, monkeypatch):
    ws[0].predict_mode = "draining"
    return _predicts(gw, 4), _states(gw)


def sc_unroutable(gw, ws, tr, monkeypatch):
    monkeypatch.setenv("SPARKDL_GATEWAY_PENDING_S", "0.3")
    for w in ws:
        w.predict_mode = "die"
    return _predicts(gw, 1), _states(gw)


def sc_all_draining(gw, ws, tr, monkeypatch):
    monkeypatch.setenv("SPARKDL_GATEWAY_PENDING_S", "0.3")
    for w in ws:
        w.predict_mode = "draining"
    return _predicts(gw, 1)


def sc_all_overloaded(gw, ws, tr, monkeypatch):
    monkeypatch.setenv("SPARKDL_GATEWAY_PENDING_S", "0.3")
    for w in ws:
        w.predict_mode = "overload"
    return _predicts(gw, 1), _states(gw)


def sc_non_retryable(gw, ws, tr, monkeypatch):
    ws[0].predict_mode = ws[1].predict_mode = "bad"
    out = _predicts(gw, 2)
    out.append(_answer(*gw.forward("/v1/predictx", b"{}")))
    return out, [len(w.hits) for w in ws]


def sc_pinned(gw, ws, tr, monkeypatch):
    out = [_answer(*gw.forward("/v1/predict", b'{"model": "m"}', rank=r)) for r in (1, 0, 1)]
    ws[1].predict_mode = "draining"
    out.append(_answer(*gw.forward("/v1/predict", b'{"model": "m"}', rank=1)))  # pinned: no re-dispatch
    ws[0].predict_mode = "die"
    out.append(_answer(*gw.forward("/v1/predict", b'{"model": "m"}', rank=0)))
    out.append(_answer(*gw.forward("/admin/drain", b"{}", rank=1)))
    return out, [[p for p, _ in w.hits] for w in ws]


def sc_get_forwards(gw, ws, tr, monkeypatch):
    return [_answer(*gw.forward(p)) + (json.loads(gw.forward(p)[1])["path"],)
            for p in ("/v1/models", "/v1/slo", "/v1/memory")]


def sc_generation_bump(gw, ws, tr, monkeypatch):
    gw._on_generation(1, [])
    before = _states(gw)
    gw._poll_health_once()
    return before, _states(gw), gw.generation


def _trace_view(tr, tid):
    recs = tr.get_store().get(tid)
    return [
        {**{k: v for k, v in r.items() if k not in ("e2e_s", "start_unix")},
         "attempts": [{k: v for k, v in a.items() if k != "dur_ms"} for a in r["attempts"]]}
        for r in recs
    ]


def sc_trace_redispatch(gw, ws, tr, monkeypatch):
    ws[0].predict_mode = "die"
    tr.reset()
    tid = "00ab" * 4
    gw._rr = 0
    code, body, headers = gw.forward("/v1/predict", b'{"model": "m"}', trace_id=tid)
    seen = [h for w in ws for _, h in w.hits]
    return code, headers.get("X-Sparkdl-Trace"), seen, _trace_view(tr, tid)


def sc_trace_unsampled_and_unroutable(gw, ws, tr, monkeypatch):
    monkeypatch.setenv("SPARKDL_TRACE_SAMPLE", "0")
    tr.reset()
    clean = gw.forward("/v1/predict", b'{"model": "m"}', trace_id="1234" * 4)
    monkeypatch.setenv("SPARKDL_GATEWAY_PENDING_S", "0.3")
    for w in ws:
        w.predict_mode = "die"
    failed = gw.forward("/v1/predict", b'{"model": "m"}', trace_id="5678" * 4)
    return (clean[0], _trace_view(tr, "1234" * 4), failed[0], json.loads(failed[1])["trace_id"],
            _trace_view(tr, "5678" * 4))


def sc_trace_sampled(gw, ws, tr, monkeypatch):
    monkeypatch.setenv("SPARKDL_TRACE_SAMPLE", "1")
    tr.reset()
    gw.forward("/v1/predict", b'{"model": "m"}', trace_id="abcd" * 4)
    return _trace_view(tr, "abcd" * 4), tr.trace_sampled("abcd" * 4)


def sc_affinity_sticks_and_spills(gw, ws, tr, monkeypatch):
    monkeypatch.setenv("SPARKDL_GATEWAY_AFFINITY", "1")
    out = _predicts(gw, 4)
    for i in range(40):
        out += _predicts(gw, 1, json.dumps({"model": f"model-{i}", "priority": "batch"}).encode())
    home = out[0][1]
    ws[home].health = "draining"
    gw._poll_health_once()
    out += _predicts(gw, 3)
    ws[home].health = "ok"
    gw._poll_health_once()
    out += _predicts(gw, 2)
    return out


def sc_affinity_saturation(gw, ws, tr, monkeypatch):
    monkeypatch.setenv("SPARKDL_GATEWAY_AFFINITY", "1")
    mod = sys.modules[type(gw).__module__]
    home, second, third = mod.AffinityRing((0, 1, 2), 64).order(mod.placement_key(b'{"model": "m"}'))
    monkeypatch.setattr(gw.fleet, "rank_busy", lambda: {home: 0.99})
    monkeypatch.setattr(gw.fleet, "resident_models", lambda: {third: ["m"]})
    out = _predicts(gw, 1)
    monkeypatch.setattr(gw.fleet, "resident_models", dict)
    out += _predicts(gw, 1)
    return out, (home, second, third), [w.index for w in ws if w.hits]


def sc_resize(gw, ws, tr, monkeypatch):
    grown = gw.resize(3)
    states = _states(gw)
    shrunk = gw.resize(1)
    same = gw.resize(1)
    return grown, states, shrunk, same, _states(gw), gw._sup.num_ranks, _predicts(gw, 3), \
        [[p for p, _ in w.hits] for w in ws]


def sc_autoscale(gw, ws, tr, monkeypatch):
    monkeypatch.setenv("SPARKDL_FLEET_MAX_WORKERS", "3")
    monkeypatch.setenv("SPARKDL_FLEET_COOLDOWN_S", "60")
    rec = {"action": "scale_up", "reason": "fleet SLO alert active for interactive",
           "evidence": {"busy_frac": 0.97}}
    box = {"rec": rec}
    monkeypatch.setattr(gw.fleet, "recommendation", lambda: box["rec"])
    out = []
    for now in (1000.0, 1030.0, 1100.0):
        ev = gw.autoscale_once(now=now)
        out.append(ev and {k: v for k, v in ev.items() if k != "ts"})
    box["rec"] = {**rec, "action": "scale_down", "reason": "idle"}
    ev = gw.autoscale_once(now=1200.0)
    out.append({k: v for k, v in ev.items() if k != "ts"})
    monkeypatch.setenv("SPARKDL_FLEET_MIN_WORKERS", "2")
    out.append(gw.autoscale_once(now=1300.0))
    for action in (None, "hold", "rebalance"):
        box["rec"] = {"action": action, "reason": "", "evidence": {}} if action else None
        out.append(gw.autoscale_once(now=5000.0))
    return out, gw.num_workers


def sc_canary_waves(gw, ws, tr, monkeypatch):
    monkeypatch.setattr(gw.fleet, "tripped_classes", list)
    monkeypatch.setattr(gw.fleet, "canary_fleet", lambda: {"tripped_ranks": []})
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_WAVES", "0.25, 1.0,")
    out = []
    for _ in range(3):
        ev = gw.canary_wave_once()
        out.append(ev and {k: v for k, v in ev.items() if k != "ts"})
    out.append([w.canary_weights for w in ws])
    return out


def sc_canary_rollback(gw, ws, tr, monkeypatch):
    monkeypatch.setattr(gw.fleet, "tripped_classes", list)
    monkeypatch.setattr(gw.fleet, "canary_fleet", lambda: {"tripped_ranks": []})
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_WAVES", "0.5,1.0")
    out = [gw.canary_wave_once()["weight"]]
    monkeypatch.setattr(gw.fleet, "tripped_classes", lambda: ["interactive"])
    ev = gw.canary_wave_once()
    out.append({k: v for k, v in ev.items() if k != "ts"})
    monkeypatch.setattr(gw.fleet, "tripped_classes", list)
    out.append(gw.canary_wave_once())
    out.append([w.canary_weights for w in ws])
    return out


def sc_no_rollout_into_alert(gw, ws, tr, monkeypatch):
    monkeypatch.setattr(gw.fleet, "tripped_classes", list)
    monkeypatch.setattr(gw.fleet, "canary_fleet", lambda: {"tripped_ranks": [1]})
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_WAVES", "1.0")
    return gw.canary_wave_once(), gw._canary_wave, gw._canary_rolled_back


def _http(port, method, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def sc_http_door(gw, ws, tr, monkeypatch):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), sys.modules[type(gw).__module__]._GatewayHandler)
    httpd.daemon_threads = True
    httpd.gateway = gw
    t = threading.Thread(target=httpd.serve_forever, name="sparkdl-test-gwhttp", daemon=True)
    t.start()
    port = httpd.server_address[1]
    try:
        out = [_http(port, "GET", "/healthz"), _http(port, "GET", "/v1/workers")[0],
               _http(port, "POST", "/v1/predict", b'{"model": "m"}'),
               _http(port, "POST", "/admin/drain", b'{"rank": 1}'),
               _http(port, "POST", "/admin/drain", b'{"nope": 1}')[0],
               _http(port, "GET", "/nope")[0], _http(port, "POST", "/nope", b"{}")[0]]
        out[1:2] = [[{k: v for k, v in w.items() if k != "port"}
                     for w in _http(port, "GET", "/v1/workers")[1]["workers"]]]
        profile = _http(port, "POST", "/admin/profile", b'{"rank": 0, "seconds": 1}')
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=5)
    return out, profile


SCENARIOS = {name[3:]: fn for name, fn in dict(globals()).items() if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_scenario_same_routing(name, tmp_path, monkeypatch):
    scenario = SCENARIOS[name]
    n = 3 if name == "affinity_saturation" else 2
    seen = {}
    for key, (mod, tr) in PACKAGES.items():
        with monkeypatch.context() as m:
            gw, workers = _make_gang(mod, tmp_path / key, n)
            try:
                seen[key] = scenario(gw, workers, tr, m)
            finally:
                for w in workers:
                    w.stop()
    if name == "http_door":
        # /admin/profile is a pinned-rank forward in both gateways
        profile = seen["torch"][1]
        assert profile[0] == 200 and profile[1]["worker"] == 0 and profile[1]["seconds"] == 1.0
    assert seen["torch"] == seen["jax"]


def test_scenarios_observe_what_they_name(tmp_path, monkeypatch):
    """A few of the shared observations, read on the port's gateway, so a
    scenario that observed nothing on both sides does not pass."""
    gw, ws = _make_gang(gateway, tmp_path)
    try:
        rr, _ = sc_round_robin(gw, ws, trace, monkeypatch)
        assert [w for _, w, _, _ in rr] == [0, 1, 0, 1, 0, 1]
        ws[0].predict_mode = "die"
        out, states = sc_redispatch_off_dying(gw, ws, trace, monkeypatch)
        assert all(o[:2] == (200, 1) for o in out) and states[0][1] == "down"
        monkeypatch.setenv("SPARKDL_GATEWAY_PENDING_S", "0.3")
        ws[1].predict_mode = "die"
        (code, _, _, retry), = _predicts(gw, 1)
        assert code == 503 and retry
    finally:
        for w in ws:
            w.stop()


@pytest.mark.parametrize("replicas", [1, 16, 64, 200])
@pytest.mark.parametrize("ranks", [(0,), (0, 1), (0, 1, 2), (0, 2, 5, 7)])
def test_affinity_ring_order_equal(ranks, replicas):
    ours, ref = gateway.AffinityRing(ranks, replicas), jax_gateway.AffinityRing(ranks, replicas)
    keys = [(f"model-{i}", ("f32", "bf16")[i % 2], 1) for i in range(500)]
    orders = [ours.order(k) for k in keys]
    assert orders == [ref.order(k) for k in keys]
    assert all(sorted(o) == sorted(ranks) for o in orders)
    assert gateway.AffinityRing((), replicas).order(keys[0]) == []


BODIES = [
    b'{"model": "m"}', b'{"model": "bert-base", "priority": "batch"}',
    b'{"model": "bert-base", "priority": "interactive"}', b'{"model": "x", "priority": "nope"}',
    b'{"priority": "batch"}', b"[1, 2]", b"not json", b"", None, b'{"model": ""}',
    b'{"model": 5, "mode": "generate", "stream": true}',
]


@pytest.mark.parametrize("precision_env", [None, "bf16", "typo"])
@pytest.mark.parametrize("body", BODIES)
def test_placement_key_and_wants_stream_equal(body, precision_env, monkeypatch):
    if precision_env is not None:
        monkeypatch.setenv("SPARKDL_SERVE_PRECISION_BATCH", precision_env)
    assert gateway.placement_key(body) == jax_gateway.placement_key(body)
    if body is not None:
        assert gateway.wants_stream(body) == jax_gateway.wants_stream(body)


def test_knob_readers_agree(monkeypatch):
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_WAVES", "0.1, 2, -1,,0.5")
    for fn in ("gateway_workers", "health_interval_s", "pending_s", "forward_timeout_s",
               "affinity_enabled", "affinity_replicas", "spill_busy", "canary_waves"):
        assert getattr(gateway, fn)() == getattr(jax_gateway, fn)(), fn
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_WAVES", "0.1,x")
    with pytest.raises(ValueError, match="not numeric"):
        gateway.canary_waves()


def test_worker_argv_passes_device_seed_and_loader(tmp_path):
    gw = gateway.ServingGateway(num_workers=1, gang_dir=str(tmp_path), device="cpu", seed=7,
                                loader_spec="pkg.mod:fn", budget_mb=512.0, max_batch=8)
    argv = gw._worker_argv(0)
    assert argv[1:4] == ["-m", "sparkdl_tpu_torch.serving", "worker"]
    i = argv.index("--device")
    assert argv[i + 1] == "cpu" and argv[argv.index("--seed") + 1] == "7"
    assert argv[argv.index("--loader") + 1] == "pkg.mod:fn"
    assert argv[argv.index("--budget-mb") + 1] == "512.0"
    default = gateway.ServingGateway(num_workers=1, gang_dir=str(tmp_path))._worker_argv(0)
    assert "--device" not in default  # the worker's own default: cuda


def test_stop_without_start_is_noop(tmp_path):
    gateway.ServingGateway(num_workers=1, gang_dir=str(tmp_path)).stop()


def test_a_closed_router_is_redispatched(tmp_path):
    """Two real workers (port routers behind port HTTP servers); one
    worker's router closes after the gateway saw it healthy. The request
    routed there is answered 503 with ``Retry-After``, as a draining
    worker answers, so the gateway re-dispatches it and the client gets
    200 from the other worker: one retry for the two requests, wherever
    the round-robin cursor starts. A real model failure stays 500."""
    import numpy as np
    import torch

    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.serving import Router, ServingServer
    from sparkdl_tpu_torch.utils.metrics import metrics

    class Linear(torch.nn.Module):
        def __init__(self):
            super().__init__()
            w = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
            self.w = torch.nn.Parameter(torch.from_numpy(w))

    def loader(name, mode):
        def fn(m, x):
            if name == "broken":
                raise RuntimeError("device failure")
            return x @ m.w

        return ModelFunction(fn, Linear(), torch.device("cpu"), name=name, input_shape=(4,))

    servers = [ServingServer(Router(loader=loader, device="cpu"), port=0) for _ in range(2)]
    gw = gateway.ServingGateway(num_workers=2, gang_dir=str(tmp_path))
    try:
        gw._on_generation(0, [])
        for rank, server in enumerate(servers):
            with open(gateway.port_file(str(tmp_path), rank), "w") as f:
                json.dump({"rank": rank, "port": server.port, "pid": 1, "generation": 0}, f)
        gw._poll_health_once()
        assert [s for _, s, _ in _states(gw)] == ["ready", "ready"]
        servers[0].router.close()
        body = json.dumps({"model": "m", "inputs": [[1.0, 2.0, 3.0, 4.0]]}).encode()
        before = metrics.counter("gateway.retries")
        answers = [gw.forward("/v1/predict", body) for _ in range(2)]
        assert [code for code, _, _ in answers] == [200, 200]
        assert metrics.counter("gateway.retries") - before == 1
        assert [len(json.loads(p)["outputs"][0]) for _, p, _ in answers] == [3, 3]
        code, payload, _ = gw.forward("/v1/predict", json.dumps(
            {"model": "broken", "inputs": [[1.0, 2.0, 3.0, 4.0]]}).encode(), rank=1)
        assert code == 500 and "device failure" in json.loads(payload)["error"]
    finally:
        gw.stop()
        for server in servers:
            server.stop(close_router=True)


def test_a_closed_router_refuses_as_a_draining_one():
    """A closed router, started or not, refuses a submit with ``Closed``, a
    ``Draining`` (503 with ``Retry-After`` at the HTTP layer), where the
    JAX package raises a plain RuntimeError (500)."""
    import numpy as np
    import torch

    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.serving import Router
    from sparkdl_tpu_torch.serving.request import Closed, Draining

    def loader(name, mode):
        return ModelFunction(lambda m, x: x * 2, torch.nn.Module(), torch.device("cpu"), name=name,
                             input_shape=(4,))

    x = np.ones((1, 4), np.float32)
    started, never = Router(loader=loader, device="cpu"), Router(loader=loader, device="cpu")
    assert np.array_equal(started.submit("m", x).result(timeout=60), x * 2)
    for router in (started, never):
        router.close()
        with pytest.raises(Closed) as info:
            router.submit("m", x)
        assert isinstance(info.value, Draining)
