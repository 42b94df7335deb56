"""One real serving gang of the port on the CPU: a ``ServingGateway`` runs 2
``python -m sparkdl_tpu_torch.serving worker --device cpu`` processes over
bert-tiny, with the fault plan ``site=serve.request:rank=0:request=6:crash``
(its claim in a temp dir, so it fires once across generations).

A 40-request flood from 8 client threads crosses the crash: every reply is
200 (the gateway re-dispatches what the dead worker stranded), the
supervisor restarts the gang once, and every row equals bert-tiny called
directly on the CPU with the same seed (atol 1e-5). Then a pinned drain of
rank 1: it reads ``draining``, a direct submit to it gets 503 with
``Retry-After``, the gateway keeps answering 200, and rank 1 exits 0 into a
relaunched generation. After ``stop()`` no worker process is alive and no
gateway thread is left. A worker started without ``--device cpu`` on a
machine with no card exits non-zero and names the missing device.

Every wait is bounded in the test itself (HTTP timeouts, polls with a
deadline, subprocess timeouts).
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.models import get_model
from sparkdl_tpu_torch.serving.gateway import ServingGateway, port_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL, SEED, N_REQUESTS, CLIENTS = "bert-tiny", 3, 40, 8
ATOL = 1e-5


def _post(base, path, body, timeout=120):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as resp:
        return json.loads(resp.read())


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if cond():
                return
        except (OSError, ValueError):
            pass
        time.sleep(0.1)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


def _requests():
    rng = np.random.default_rng(SEED)
    out = []
    for i in range(N_REQUESTS):
        rows, width = int(rng.integers(1, 5)), int(rng.integers(8, 65))
        ids = rng.integers(4, 1000, size=(rows, width)).astype(np.int32)
        for r in range(rows):
            ids[r, int(rng.integers(4, width + 1)):] = 0
        out.append((ids, ("interactive", "batch")[i % 2]))
    return out


def _all_ready(base, generation):
    table = _get(base, "/v1/workers")
    return table["generation"] == generation and [w["status"] for w in table["workers"]] == ["ready"] * 2


@pytest.fixture
def gang(tmp_path):
    gw = ServingGateway(
        num_workers=2, device="cpu", seed=SEED, gang_dir=str(tmp_path / "gang"),
        extra_env={
            "SPARKDL_FAULT_PLAN": "site=serve.request:rank=0:request=6:crash",
            "SPARKDL_FAULT_STATE": str(tmp_path / "faults"),
            "SPARKDL_LOCK_SANITIZER": "1",
            "SPARKDL_SERVE_DRAIN_TIMEOUT_S": "20",
        },
    )
    gw.start()
    try:
        yield gw, f"http://127.0.0.1:{gw.port}"
    finally:
        procs = list(gw._sup._procs) + list(gw._sup._retired)
        gw.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()


def test_gang_survives_a_crash_mid_flood_and_drains(gang):
    gw, base = gang
    _wait(lambda: _all_ready(base, 0), 120, "generation 0 ready")
    first_pids = [w["pid"] for w in _get(base, "/v1/workers")["workers"]]
    requests = _requests()

    def send(req):
        ids, cls = req
        return _post(base, "/v1/predict", {"model": MODEL, "mode": "embed", "dtype": "int32",
                                           "inputs": ids.tolist(), "priority": cls})

    with ThreadPoolExecutor(CLIENTS) as pool:
        replies = list(pool.map(send, requests))
    assert [r[0] for r in replies] == [200] * N_REQUESTS, [r[2] for r in replies if r[0] != 200]

    # exactly one restart, then generation 1 with both ranks ready
    _wait(lambda: _all_ready(base, 1), 120, "generation 1 ready")
    table = _get(base, "/v1/workers")
    assert table["restarts"] == 1 and gw.restarts() == 1
    assert table["rerouted"] >= 1  # requests stranded on the dead rank 0
    assert all(w["pid"] not in first_pids for w in table["workers"])
    log0 = open(os.path.join(gw.gang_dir, "worker.0.log")).read()
    assert '"generation": 0' in log0 and '"generation": 1' in log0

    # every row equals bert-tiny called directly with the same seed
    mf = get_model(MODEL).model_function(mode="embed", seed=SEED, device="cpu")
    worst = 0.0
    for (ids, _), (_, _, reply) in zip(requests, replies):
        with torch.no_grad():
            ref = mf(torch.from_numpy(ids)).numpy()
        got = np.asarray(reply["outputs"], np.float32)
        assert got.shape == ref.shape == (len(ids), 128)
        worst = max(worst, float(np.abs(got - ref).max()))
    assert worst <= ATOL, worst

    # the lock sanitizer ran in the workers and saw no cycle. A relaunched
    # rank's lines join the federated /metrics at the gateway's first fresh
    # scrape of it, which a loaded machine delays past "ready": wait for it
    def federated():
        return urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()

    _wait(lambda: all(f'sparkdl_serve_completed_total{{rank="{r}"}}' in federated() for r in (0, 1)),
          60, "both ranks' lines in the federated /metrics")
    metrics_text = federated()
    assert 'sparkdl_serve_completed_total{rank="0"}' in metrics_text
    assert 'sparkdl_serve_completed_total{rank="1"}' in metrics_text
    assert "locks_cycles" not in metrics_text

    # a pinned drain of rank 1: draining, direct 503 + Retry-After, the
    # gateway still answers, rank 1 exits 0 into a relaunched generation
    rank1 = table["workers"][1]
    status, _, reply = _post(base, "/admin/drain", {"rank": 1})
    assert status == 200 and reply["status"] == "draining"
    _wait(lambda: _get(f"http://127.0.0.1:{rank1['port']}", "/healthz")["status"] == "draining",
          10, "rank 1 draining")
    ids, _ = requests[0]
    code, headers, _ = _post(f"http://127.0.0.1:{rank1['port']}", "/v1/predict",
                             {"model": MODEL, "mode": "embed", "dtype": "int32",
                              "inputs": ids.tolist()})
    assert code == 503 and headers.get("Retry-After")
    for _ in range(3):
        code, _, reply = send(requests[1])
        assert code == 200
    _wait(lambda: _all_ready(base, 2), 120, "generation 2 ready after the drain")
    assert _get(base, "/v1/workers")["restarts"] == 2
    log1 = open(os.path.join(gw.gang_dir, "worker.1.log")).read()
    assert '"serving_worker": "drained", "rank": 1, "generation": 1' in log1

    # the federated fleet view saw both ranks
    fleet = _get(base, "/v1/fleet")
    assert {w["rank"] for w in fleet["workers"]} == {0, 1}

    procs = list(gw._sup._procs)
    gw.stop()
    assert all(p.poll() is not None for p in procs)
    assert not [t.name for t in threading.enumerate() if t.name.startswith("sparkdl-gateway")]


def test_worker_without_a_card_names_the_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "sparkdl_tpu_torch.serving", "worker", "--rank", "0",
         "--gang-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr and "device='cpu'" in proc.stderr
    assert not os.path.exists(port_file(str(tmp_path), 0))  # it never published a port
