"""``POST /admin/profile`` on the port (``utils/profiler.py`` over
``torch.profiler``), against the JAX server's answers, on the CPU.

Mirrors ``TestProfileEndpoint`` (``tests/test_slo.py``): a capture answers
200 with a run directory under ``SPARKDL_PROFILE_DIR`` (here with the
real ``torch.profiler`` on the CPU: its trace parses and holds the ops
the traffic ran), a profiler that will not start 501, bad seconds or a
body that is not an object 400, a capture in flight 409. Both servers get
the same bodies and must give the same status codes (the JAX profiler is
stubbed there, as the JAX test does). A capture that asks for CUDA
activity where the build cannot record it is refused, never downgraded
to a CPU trace. The gateway forwards the capture to one pinned rank and
caps its seconds at the forward timeout less 5 s, as the JAX gateway.
"""

import json
import os
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.runtime.feeder import shutdown_feeders
from sparkdl_tpu_torch.serving import Router, ServingServer, gateway
from sparkdl_tpu_torch.utils import profiler

ROW = 8


def _port_loader(name, mode):
    w = torch.nn.Module()
    w.w = torch.nn.Parameter(torch.from_numpy(np.random.default_rng(3).normal(size=(ROW, 4)).astype(np.float32)))
    return ModelFunction(lambda m, x: torch.tanh(x @ m.w), w, torch.device("cpu"), name=name, input_shape=(ROW,))


def _jax_loader(name, mode):
    import jax.numpy as jnp

    from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction

    w = jnp.asarray(np.random.default_rng(3).normal(size=(ROW, 4)).astype(np.float32))
    return JaxModelFunction(lambda p, x: jnp.tanh(x @ p), w, input_shape=(ROW,), name=name)


@pytest.fixture(autouse=True)
def _profile_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("SPARKDL_PROFILE_DIR", str(tmp_path / "profiles"))
    yield
    shutdown_feeders()


def _servers():
    """(port server, JAX server) over the same matmul model."""
    from sparkdl_tpu import serving as jax_serving

    return (ServingServer(Router(loader=_port_loader, max_batch=8, device="cpu"), port=0),
            jax_serving.ServingServer(jax_serving.Router(loader=_jax_loader, max_batch=8), port=0))


def _post(port, path, body, timeout=60):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture()
def stub_jax_profiler(monkeypatch):
    import jax

    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)


def test_capture_ok_path_records_the_traffic(tmp_path, monkeypatch, stub_jax_profiler):
    """200 from both servers; the port's run directory holds a Chrome trace
    of the real torch.profiler with the ops of the requests served during
    it, and a {"kind": "profile"} event is written."""
    monkeypatch.setenv("SPARKDL_OBS_JSONL", str(tmp_path / "events.jsonl"))
    ours, ref = _servers()
    stop = threading.Event()

    def traffic():
        rows = np.ones((2, ROW), np.float32).tolist()
        while not stop.is_set():
            _post(ours.port, "/v1/predict", {"model": "m", "inputs": rows})

    try:
        _post(ours.port, "/v1/predict", {"model": "m", "inputs": [[0.5] * ROW]})  # load first
        flood = threading.Thread(target=traffic, daemon=True)
        flood.start()
        code, body = _post(ours.port, "/admin/profile", {"seconds": 0.5})
        stop.set()
        flood.join(timeout=30)
        code_ref, body_ref = _post(ref.port, "/admin/profile", {"seconds": 0.05})
    finally:
        ours.stop(close_router=True)
        ref.stop(close_router=True)
    assert code == code_ref == 200, body
    assert set(body) == set(body_ref) == {"status", "path", "seconds"}
    assert body["path"].startswith(str(tmp_path / "profiles")) and body["seconds"] == 0.5
    with open(os.path.join(body["path"], profiler.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("tanh" in n for n in names), sorted(names)[:20]
    # the JAX server wrote its own event beside it (a run directory of the
    # same second may share the name): the port's is the 0.5 s one
    events = [json.loads(x) for x in (tmp_path / "events.jsonl").read_text().splitlines()]
    (event,) = [e for e in events if e["kind"] == "profile" and e["seconds"] == 0.5]
    assert event["path"] == body["path"]


def test_unavailable_degrades_to_501(monkeypatch):
    import jax

    def _boom(*a, **k):
        raise RuntimeError("no profiler on this build")

    monkeypatch.setattr(jax.profiler, "start_trace", _boom)
    monkeypatch.setattr(torch.profiler.profile, "start", _boom)
    codes = []
    for server in _servers():
        try:
            codes.append(_post(server.port, "/admin/profile", {"seconds": 0.05}))
        finally:
            server.stop(close_router=True)
    (ours, body), (ref, body_ref) = codes
    assert ours == ref == 501 and body["status"] == body_ref["status"] == "unavailable"
    profiles = os.environ["SPARKDL_PROFILE_DIR"]
    assert not os.path.exists(profiles) or os.listdir(profiles) == []  # no run directory left


def test_cuda_capture_is_never_downgraded_to_a_cpu_trace(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(profiler.ProfilerUnavailable, match="CUDA"):
        profiler.capture_profile(str(tmp_path), 0.01, cuda=True)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("body", [{"seconds": -1}, {"seconds": "lots"}, {"seconds": 601}, b"[1, 2]", b"{not json"],
                         ids=["negative", "string", "too-long", "list", "garbage"])
def test_bad_body_is_400(body, stub_jax_profiler):
    codes = []
    for server in _servers():
        try:
            codes.append(_post(server.port, "/admin/profile", body)[0])
        finally:
            server.stop(close_router=True)
    assert codes == [400, 400]


def test_busy_is_409():
    from sparkdl_tpu.utils import profiler as jax_profiler

    codes = []
    for prof, server in zip((profiler, jax_profiler), _servers()):
        with prof._capture_lock:
            prof._capturing = True
        try:
            codes.append(_post(server.port, "/admin/profile", {"seconds": 0.05})[0])
        finally:
            with prof._capture_lock:
                prof._capturing = False
            server.stop(close_router=True)
    assert codes == [409, 409]


def test_an_active_torch_profiler_is_409_and_the_handler_survives():
    ours, ref = _servers()
    ref.stop(close_router=True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            code, body = _post(ours.port, "/admin/profile", {"seconds": 0.05})
        assert code == 409, body
        assert _post(ours.port, "/admin/profile", {"seconds": 0.05})[0] == 200
    finally:
        ours.stop(close_router=True)


def test_annotate_names_a_region_in_the_capture(tmp_path):
    stop = threading.Event()

    def work():
        while not stop.is_set():
            with profiler.annotate("sparkdl.unit_region"):
                torch.ones(8).sum()

    t = threading.Thread(target=work, daemon=True)
    t.start()
    try:
        run_dir = profiler.capture_profile(str(tmp_path), 0.2)
    finally:
        stop.set()
        t.join(timeout=10)
    with open(os.path.join(run_dir, profiler.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "sparkdl.unit_region" in names


# -- the gateway's pinned-rank forward ---------------------------------------------


def _gateway_http(mod, gw):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), sys.modules[type(gw).__module__]._GatewayHandler)
    httpd.daemon_threads = True
    httpd.gateway = gw
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t


@pytest.mark.parametrize("body", [{"seconds": 1}, {"rank": "x"}, {"rank": 0, "seconds": 0},
                                  {"rank": 0, "seconds": 3600}],
                         ids=["no-rank", "bad-rank", "zero", "past-the-forward-timeout"])
def test_gateway_refuses_what_the_jax_gateway_refuses(body, tmp_path):
    from sparkdl_tpu.serving import gateway as jax_gateway

    answers = []
    for mod in (gateway, jax_gateway):
        gw = mod.ServingGateway(num_workers=1, gang_dir=str(tmp_path / mod.__name__))
        httpd, t = _gateway_http(mod, gw)
        try:
            answers.append(_post(httpd.server_address[1], "/admin/profile", body))
        finally:
            httpd.shutdown()
            httpd.server_close()
            t.join(timeout=5)
    (ours, reply), (ref, reply_ref) = answers
    assert ours == ref == 400 and reply == reply_ref


def test_gateway_forwards_a_capture_to_the_pinned_rank(tmp_path):
    """A real port worker behind the port's gateway: the capture runs in
    the worker and its run directory comes back through the forward."""
    worker = ServingServer(Router(loader=_port_loader, device="cpu"), port=0)
    gang_dir = str(tmp_path / "gang")
    gw = gateway.ServingGateway(num_workers=1, gang_dir=gang_dir)
    gw._on_generation(0, [])
    os.makedirs(gang_dir, exist_ok=True)
    with open(gateway.port_file(gang_dir, 0), "w") as f:
        json.dump({"rank": 0, "port": worker.port, "pid": os.getpid(), "generation": 0}, f)
    gw._poll_health_once()
    httpd, t = _gateway_http(gateway, gw)
    try:
        code, body = _post(httpd.server_address[1], "/admin/profile", {"rank": 0, "seconds": 0.1})
        assert code == 200, body
        assert body["path"].startswith(os.environ["SPARKDL_PROFILE_DIR"])
        assert os.path.exists(os.path.join(body["path"], profiler.TRACE_FILE))
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=5)
        worker.stop(close_router=True)
