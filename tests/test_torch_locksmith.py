"""The port's lock sanitizer (``sparkdl_tpu_torch/runtime/locksmith.py``)
against the JAX package's, on the CPU.

The JAX file's cases run on the port's proxies; then one scripted
acquisition order goes through both sanitizers, and the edges, the
cycles and the ``cross_check`` findings are held equal with the names
mapped from one package's prefix to the other's. The port's locks are
created through the sanitizer under the JAX package's names with the
port's prefix, which the last cases check module by module.
"""

import os
import re
import threading
import time

import pytest

from sparkdl_tpu.runtime import locksmith as jax_locksmith
from sparkdl_tpu_torch.runtime import locksmith
from sparkdl_tpu_torch.utils.metrics import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_tracker():
    locksmith.reset()
    jax_locksmith.reset()
    yield
    locksmith.reset()
    jax_locksmith.reset()


@pytest.fixture
def sanitizer_on(monkeypatch):
    monkeypatch.setenv("SPARKDL_LOCK_SANITIZER", "1")


def _run(target, name):
    t = threading.Thread(target=target, name=name, daemon=True)
    t.start()
    t.join(timeout=5.0)
    assert not t.is_alive()


# ---------------------------------------------------------------------------
# the JAX file's cases on the port
# ---------------------------------------------------------------------------


def test_disabled_returns_plain_primitives(monkeypatch):
    monkeypatch.delenv("SPARKDL_LOCK_SANITIZER", raising=False)
    lk = locksmith.lock("x::a")
    assert not isinstance(lk, locksmith.LockProxy)
    with lk:
        assert lk.locked()
    assert isinstance(locksmith.condition("x::b"), threading.Condition)
    assert not isinstance(locksmith.rlock("x::r"), locksmith.LockProxy)


def test_lock_proxy_transparent(sanitizer_on):
    lk = locksmith.lock("x::a")
    assert isinstance(lk, locksmith.LockProxy)
    assert not lk.locked()
    with lk:
        assert lk.locked()
    assert not lk.locked()
    assert lk.acquire(timeout=1.0)
    assert lk.acquire(blocking=False) is False
    lk.release()


def test_rlock_proxy_transparent(sanitizer_on):
    lk = locksmith.rlock("x::r")
    assert isinstance(lk, locksmith.LockProxy)
    with lk:
        with lk:  # reentrant; same-name nesting records no edge
            pass
    assert not lk.locked()
    assert locksmith.observed_edges() == set()


def test_condition_proxy_transparent(sanitizer_on):
    cv = locksmith.condition("x::cv")
    state = {"ready": False}

    def setter():
        with cv:
            state["ready"] = True
            cv.notify_all()

    t = threading.Thread(target=setter, name="sparkdl-test-setter", daemon=True)
    with cv:
        t.start()
        while not state["ready"]:
            assert cv.wait(timeout=2.0)
    t.join(timeout=2.0)
    assert state["ready"]


def test_release_on_another_thread(sanitizer_on):
    lk = locksmith.lock("x::handoff")
    lk.acquire()
    _run(lk.release, "sparkdl-test-rel")
    assert not lk.locked()


def test_nested_acquisition_records_edge(sanitizer_on):
    a, b = locksmith.lock("x::a"), locksmith.lock("x::b")
    with a:
        with b:
            pass
    assert ("x::a", "x::b") in locksmith.observed_edges()
    assert locksmith.observed_cycles() == []


def test_deliberate_abba_detected(sanitizer_on):
    a, b = locksmith.lock("x::a"), locksmith.lock("x::b")
    with a:
        with b:
            pass
    cycles0 = metrics.counter("locks.cycles")

    def inverted():
        with b:
            with a:
                pass

    _run(inverted, "sparkdl-test-abba")
    cycles = locksmith.observed_cycles()
    assert cycles and {"x::a", "x::b"} <= set(cycles[0])
    assert metrics.counter("locks.cycles") == cycles0 + 1


def test_wait_breaks_hold_for_ordering(sanitizer_on):
    cv = locksmith.condition("x::cv")
    other = locksmith.lock("x::other")
    woke = threading.Event()

    def waker():
        with other:
            pass
        with cv:
            cv.notify_all()
        woke.set()

    with cv:
        t = threading.Thread(target=waker, name="sparkdl-test-waker", daemon=True)
        t.start()
        cv.wait(timeout=2.0)
    assert woke.wait(timeout=2.0)
    t.join(timeout=2.0)
    assert ("x::cv", "x::other") not in locksmith.observed_edges()


def test_held_too_long_reported(sanitizer_on, monkeypatch):
    monkeypatch.setenv("SPARKDL_LOCK_HELD_MS", "10")
    lk = locksmith.lock("x::slow")
    with lk:
        time.sleep(0.05)
    snap = locksmith.report(jsonl=False)
    assert any(h["lock"] == "x::slow" and h["held_s"] >= 0.01 for h in snap["held_too_long"])


def test_fast_hold_not_reported(sanitizer_on, monkeypatch):
    monkeypatch.setenv("SPARKDL_LOCK_HELD_MS", "500")
    with locksmith.lock("x::fast"):
        pass
    assert locksmith.report(jsonl=False)["held_too_long"] == []


@pytest.mark.parametrize(
    "static, order, findings",
    [
        ({("m::a", "m::b"), ("m::b", "m::c")}, ("m::a", "m::b"), 0),
        ({("m::a", "m::b"), ("m::b", "m::c")}, ("m::a", "m::c"), 0),  # the closure
        ({("m::a", "m::b")}, ("m::b", "m::a"), 1),
    ],
)
def test_cross_check(sanitizer_on, static, order, findings):
    outer, inner = (locksmith.lock(n) for n in order)
    with outer:
        with inner:
            pass
    problems = locksmith.cross_check(static)
    assert len(problems) == findings
    if findings:
        assert f"{order[0]} -> {order[1]}" in problems[0]


def test_report_shape_and_jsonl(sanitizer_on, tmp_path, monkeypatch):
    import json

    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("SPARKDL_OBS_JSONL", str(log))
    a, b = locksmith.lock("x::a"), locksmith.lock("x::b")
    with a:
        with b:
            pass
    snap = locksmith.report()
    assert snap["acquisitions"] == 2
    assert ("x::a", "x::b") in set(snap["edges"])
    assert snap["cycles"] == []
    event = json.loads(log.read_text().splitlines()[-1])
    assert event["kind"] == "locks" and event["edges"] == ["x::a -> x::b"]


# ---------------------------------------------------------------------------
# one scripted order through both sanitizers
# ---------------------------------------------------------------------------

JAX_PREFIX, PORT_PREFIX = "sparkdl_tpu/", "sparkdl_tpu_torch/"

#: lock names of the JAX package (mapped to the port's by prefix)
NAMES = [
    "sparkdl_tpu/runtime/feeder.py::_feeders_lock",
    "sparkdl_tpu/runtime/feeder.py::DeviceFeeder._lock",
    "sparkdl_tpu/runtime/feeder.py::DeviceFeeder._drain_cv",
    "sparkdl_tpu/serving/router.py::Router._lock",
    "sparkdl_tpu/serving/residency.py::ResidencyManager._lock",
    "sparkdl_tpu/obs/memory.py::MemoryLedger._lock",
]

#: per thread: the nesting orders it takes (each a chain acquired outer
#: to inner and released inner to outer); thread 2 closes a cycle
SCRIPT = [
    [(0, 1), (3, 4, 5), (1, 2)],
    [(3, 5), (4, 5), (0, 2)],
    [(5, 3)],  # memory -> router: closes router -> ... -> memory
]

#: the static graph the script is checked against (JAX names)
STATIC = {(NAMES[0], NAMES[1]), (NAMES[1], NAMES[2]), (NAMES[3], NAMES[4]),
          (NAMES[4], NAMES[5])}


def _to_port(name: str) -> str:
    return PORT_PREFIX + name[len(JAX_PREFIX):]


def _drive(mod, names):
    locks = {}
    for i, n in enumerate(names):
        locks[i] = mod.condition(n) if n.endswith("_cv") else mod.lock(n)
    for chains in SCRIPT:
        def body(chains=chains):
            for chain in chains:
                held = []
                for i in chain:
                    locks[i].acquire()
                    held.append(locks[i])
                for lk in reversed(held):
                    lk.release()
        _run(body, "sparkdl-test-script")
    snap = mod.report(jsonl=False)
    return snap


def test_scripted_order_same_edges_cycles_and_findings(sanitizer_on):
    jax_snap = _drive(jax_locksmith, NAMES)
    port_snap = _drive(locksmith, [_to_port(n) for n in NAMES])
    mapped_edges = {(_to_port(a), _to_port(b)) for a, b in jax_snap["edges"]}
    assert mapped_edges == set(port_snap["edges"])
    assert port_snap["acquisitions"] == jax_snap["acquisitions"]
    assert [[_to_port(n) for n in c] for c in jax_snap["cycles"]] == port_snap["cycles"]
    assert len(port_snap["cycles"]) == 1
    jax_findings = jax_locksmith.cross_check(STATIC)
    port_findings = locksmith.cross_check({(_to_port(a), _to_port(b)) for a, b in STATIC})
    assert [f.replace(JAX_PREFIX, PORT_PREFIX) for f in jax_findings] == port_findings
    assert port_findings  # the script strays from the static graph


# ---------------------------------------------------------------------------
# the port's locks go through the sanitizer under the JAX package's names
# ---------------------------------------------------------------------------

NAME_RE = re.compile(r'locksmith\.(?:lock|rlock|condition)\(\s*"([^"]+)"', re.S)
MODULES = [
    "runtime/feeder.py", "runtime/executor.py", "runtime/native.py",
    "serving/router.py", "serving/request.py", "serving/residency.py",
    "serving/generation.py", "serving/gateway.py", "obs/memory.py",
    "obs/timeseries.py", "resilience/faults.py", "resilience/supervisor.py",
]


def _names(path):
    with open(path) as f:
        src = f.read()
    # residency's load-lock name is split over two literals in the JAX file
    src = re.sub(r'"\s*\n\s*"', "", src)
    return set(NAME_RE.findall(src))


@pytest.mark.parametrize("rel", MODULES)
def test_port_lock_names_are_the_jax_names(rel):
    jax_names = _names(os.path.join(REPO, "sparkdl_tpu", rel))
    port_names = _names(os.path.join(REPO, "sparkdl_tpu_torch", rel))
    assert jax_names
    assert port_names == {_to_port(n) for n in jax_names}


def test_real_router_locks_are_proxies_when_on(sanitizer_on):
    from sparkdl_tpu_torch.serving import Router

    router = Router(device="cpu")
    try:
        assert isinstance(router._lock, locksmith.LockProxy)
        assert router._lock.name == "sparkdl_tpu_torch/serving/router.py::Router._lock"
        assert isinstance(router.queue._cv, locksmith.ConditionProxy)
    finally:
        router.close()
