"""The port's serving layer (``sparkdl_tpu_torch/serving``) against the
JAX package's, on the CPU.

Every behaviour runs through both packages on the same inputs: the same
admission queue operations, the same routers over loaders that build one
model from one set of weights (a numpy matmul, ``bert-tiny`` from one
flax tree, ResNet50 at 32x32 from one flax tree), the same HTTP bodies.
Their answers are held equal: the matmul models at atol 1e-5, bert-tiny
at the f32 atol 1e-4 of ``tests/test_torch_bert.py``, ResNet50 at the
relative 1e-4 of ``tests/test_torch_image.py``. The JAX side runs on one
CPU device (roundrobin mode), its flash attention on the dense path off
the TPU, as the JAX package's own tests run it; the port runs on
``device="cpu"``, its flash attention on the kernel's plain version.

Each package keeps its own process-global metrics registry, so counters
are read as differences around the action under test.
"""

import gc
import json
import threading
import time
import urllib.error
import urllib.request
import weakref
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparkdl_tpu.serving as jax_serving
import sparkdl_tpu_torch.serving as serving
from sparkdl_tpu.graph import precision as jax_precision
from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.obs import trace as jax_trace
from sparkdl_tpu.resilience import policy as jax_policy
from sparkdl_tpu.runtime import feeder as jax_feeder
from sparkdl_tpu.serving import router as jax_router
from sparkdl_tpu.transformers import execution as jax_execution
from sparkdl_tpu.utils.metrics import metrics as jax_metrics
from sparkdl_tpu_torch.graph import precision
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.models import get_model, param_bytes, supported_models
from sparkdl_tpu_torch.models.resnet import ResNet
from sparkdl_tpu_torch.obs import trace
from sparkdl_tpu_torch.resilience import policy
from sparkdl_tpu_torch.runtime import feeder
from sparkdl_tpu_torch.serving import residency
from sparkdl_tpu_torch.serving import router as port_router
from sparkdl_tpu_torch.transformers import execution
from sparkdl_tpu_torch.utils.metrics import metrics

ROW = 8  # input width of the matmul models
ATOL = 1e-5
BERT_ATOL = 1e-4
RESNET_REL = 1e-4


@pytest.fixture(autouse=True)
def _serving_env(monkeypatch):
    """One CPU device for the JAX side, deterministic knobs, no feeder
    left behind."""
    monkeypatch.setenv("SPARKDL_INFERENCE_MODE", "roundrobin")
    monkeypatch.setenv("SPARKDL_INFERENCE_DEVICES", "1")
    monkeypatch.setenv("SPARKDL_SERVE_MAX_BATCH", "32")
    for name in (
        "SPARKDL_FAULT_PLAN", "SPARKDL_SERVE_HBM_BUDGET_MB",
        "SPARKDL_SERVE_CANARY_MODEL", "SPARKDL_SERVE_CANARY_VERSION",
        "SPARKDL_SERVE_PRECISION", "SPARKDL_SERVE_PRECISION_INTERACTIVE",
        "SPARKDL_SERVE_PRECISION_BATCH", "SPARKDL_SERVE_PRECISION_BACKGROUND",
        "SPARKDL_SERVE_QUEUE_CAP",
    ):
        monkeypatch.delenv(name, raising=False)
    yield
    feeder.shutdown_feeders()
    jax_feeder.shutdown_feeders()


# -- the two packages behind one surface -------------------------------------


def _weights(name, shape=(ROW, 4)):
    seed = zlib.crc32(name.encode()) % 1000
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


class _Linear(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))


def _port_mlp(name, width=4):
    return ModelFunction(
        lambda m, x: x @ m.w, _Linear(_weights(name, (ROW, width))),
        torch.device("cpu"), name=name, input_shape=(ROW,),
    )


def _jax_mlp(name, width=4):
    w = jnp.asarray(_weights(name, (ROW, width)))
    return JaxModelFunction(lambda p, x: x @ p, w, input_shape=(ROW,), name=name)


class Side:
    """One package's serving surface: its modules, metrics registry and a
    matmul loader over the shared weights."""

    def __init__(self, name, mod, metrics_registry, mlp, router_kwargs):
        self.name = name
        self.mod = mod
        self.metrics = metrics_registry
        self.mlp = mlp
        self.router_kwargs = router_kwargs

    def loader(self, width=4):
        return lambda name, mode: self.mlp(name, width)

    def router(self, loader=None, **kwargs):
        if loader is None:
            loader = self.loader()
        return self.mod.Router(loader=loader, **kwargs, **self.router_kwargs)

    def direct(self, name, x, width=4):
        """The model called directly, without the router."""
        mf = self.mlp(name, width)
        return np.asarray(mf(torch.from_numpy(x) if self is PORT else x))


PORT = Side("torch", serving, metrics, _port_mlp, {"device": "cpu"})
JAX = Side("jax", jax_serving, jax_metrics, _jax_mlp, {})
SIDES = (PORT, JAX)


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, ROW)).astype(np.float32)


def _both(fn):
    """``fn(side)`` on the port and on the JAX package."""
    return fn(PORT), fn(JAX)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def _http(base, path, body=None, headers=None, timeout=60):
    """(status, headers, parsed JSON or text) of one HTTP call."""
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode()
    )
    req = urllib.request.Request(base + path, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, hdrs, raw = resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        status, hdrs, raw = e.code, e.headers, e.read()
    try:
        return status, hdrs, json.loads(raw)
    except ValueError:
        return status, hdrs, raw.decode()


# -- admission queue ----------------------------------------------------------


class TestAdmissionQueue:
    def test_strict_priority_ordering(self):
        def order(side):
            q = side.mod.AdmissionQueue(aging_s_override=1e9)
            for cls in ("background", "batch", "interactive", "background"):
                q.put(side.mod.Request("m", _rows(1), priority=cls))
            return [q.pop(timeout=1).priority for _ in range(4)]

        ours, ref = _both(order)
        assert ours == ref == ["interactive", "batch", "background", "background"]

    def test_fifo_within_class(self):
        def order(side):
            q = side.mod.AdmissionQueue(aging_s_override=1e9)
            reqs = [side.mod.Request("m", _rows(1, i), priority="batch") for i in range(3)]
            for r in reqs:
                q.put(r)
            return [reqs.index(q.pop(timeout=1)) for _ in range(3)]

        assert _both(order) == ([0, 1, 2], [0, 1, 2])

    def test_aging_promotes_background_past_fresh_interactive(self):
        def first(side):
            q = side.mod.AdmissionQueue(aging_s_override=0.05)
            old = side.mod.Request("m", _rows(1), priority="background")
            q.put(old)
            time.sleep(0.15)  # about 3 levels of credit
            q.put(side.mod.Request("m", _rows(1), priority="interactive"))
            return q.pop(timeout=1) is old

        assert _both(first) == (True, True)

    def test_capacity_rejection_counts(self):
        def run(side):
            q = side.mod.AdmissionQueue(cap_rows=4, aging_s_override=1e9)
            before = side.metrics.counter("serve.rejected")
            q.put(side.mod.Request("m", _rows(3)))
            with pytest.raises(side.mod.AdmissionRejected):
                q.put(side.mod.Request("m", _rows(2)))
            q.put(side.mod.Request("m", _rows(1)))  # a 1-row request still fits
            return side.metrics.counter("serve.rejected") - before, q.depth_rows()

        assert _both(run) == ((1, 4), (1, 4))

    def test_expired_request_failed_at_pop(self):
        def run(side):
            q = side.mod.AdmissionQueue(aging_s_override=1e9)
            dead = side.mod.Request("m", _rows(1), deadline_s=0.01)
            live = side.mod.Request("m", _rows(1))
            q.put(dead)
            q.put(live)
            expired0 = side.metrics.counter("serve.expired")
            failures0 = side.metrics.counter("serve.failures")
            time.sleep(0.05)
            assert q.pop(timeout=1) is live
            with pytest.raises(side.mod.DeadlineExceeded):
                dead.result(timeout=1)
            # expiry is serve.expired, not a failure of the serving path
            return (
                side.metrics.counter("serve.expired") - expired0,
                side.metrics.counter("serve.failures") - failures0,
            )

        assert _both(run) == ((1, 0), (1, 0))

    def test_close_fails_queued_requests(self):
        def run(side):
            q = side.mod.AdmissionQueue()
            req = side.mod.Request("m", _rows(1))
            q.put(req)
            failures0 = side.metrics.counter("serve.failures")
            q.close()
            with pytest.raises(RuntimeError):
                req.result(timeout=1)
            with pytest.raises(RuntimeError):
                q.put(side.mod.Request("m", _rows(1)))
            return side.metrics.counter("serve.failures") - failures0

        assert _both(run) == (0, 0)

    def test_pop_matching_takes_the_most_urgent_matches_under_the_row_cap(self):
        def run(side):
            q = side.mod.AdmissionQueue(aging_s_override=1e9)
            plan = [("a", "background", 2), ("b", "batch", 1), ("a", "interactive", 3),
                    ("a", "batch", 2), ("a", "interactive", 1)]
            reqs = [side.mod.Request(m, _rows(n), priority=c) for m, c, n in plan]
            for r in reqs:
                q.put(r)
            got = q.pop_matching(lambda r: r.model == "a", 5)
            return [reqs.index(r) for r in got], q.depth_rows()

        ours, ref = _both(run)
        assert ours == ref
        assert ours[0] == [2, 4]  # both interactive; the batch one would pass 5 rows

    def test_bad_requests_raise_the_same_errors(self):
        for side in SIDES:
            with pytest.raises(ValueError, match="priority"):
                side.mod.Request("m", _rows(1), priority="urgent")
            with pytest.raises(ValueError, match="row"):
                side.mod.Request("m", np.zeros((0, ROW)))


# -- adaptive batching --------------------------------------------------------


class TestAdaptiveBatching:
    def test_choose_rung_matches_jax(self):
        for cap in (1, 8, 32):
            for rows in range(1, 100):
                assert port_router.choose_rung(rows, cap) == jax_router.choose_rung(rows, cap)
        assert [port_router.choose_rung(n, 32) for n in (1, 2, 3, 9, 32, 1000)] == [
            1, 2, 4, 16, 32, 32]

    @pytest.mark.parametrize("buckets", ["half", "pow2", "16,48,100"])
    def test_choose_seq_bucket_matches_jax(self, buckets, monkeypatch):
        monkeypatch.setenv("SPARKDL_TEXT_BUCKETS", buckets)
        for n in range(1, 700):
            assert port_router.choose_seq_bucket(n) == jax_router.choose_seq_bucket(n)

    @pytest.mark.parametrize("bucketing", ["1", "0"])
    def test_bucket_token_payload_matches_jax(self, bucketing, monkeypatch):
        monkeypatch.setenv("SPARKDL_TEXT_BUCKETING", bucketing)
        rng = np.random.default_rng(4)
        for model, length in (("bert-tiny", 5), ("bert-tiny", 37), ("bert-tiny", 128),
                              ("custom", 37), ("bert-base", 300)):
            ids = rng.integers(1, 900, size=(3, length)).astype(np.int64)
            ids[0, length // 2:] = 0
            for payload in (ids, ids.astype(np.float32)):
                ours = port_router._bucket_token_payload(model, payload)
                ref = jax_router._bucket_token_payload(model, payload)
                np.testing.assert_array_equal(ours[0], ref[0])
                assert ours[0].dtype == ref[0].dtype and ours[1:] == ref[1:]
        for mod in (port_router, jax_router):
            with pytest.raises(ValueError, match="position table"):
                mod._bucket_token_payload("bert-tiny", np.ones((1, 129), np.int32))
            with pytest.raises(ValueError, match="integer token ids"):
                mod._bucket_token_payload("bert-tiny", np.full((1, 4), 0.5, np.float32))

    def _batch_rows(self, side):
        stat = side.metrics.timing("serve.batch_rows")
        return [] if stat is None else [int(v) for v in stat.samples]

    def test_shallow_queue_dispatches_a_short_rung(self):
        def run(side):
            router = side.router(max_batch=32)
            try:
                n0 = len(self._batch_rows(side))
                out = side.mod.ServingClient(router).predict(
                    "m", _rows(1, 2), priority="interactive", timeout=60)
                return out, self._batch_rows(side)[n0:]
            finally:
                router.close()

        (ours, tail), (ref, ref_tail) = _both(run)
        assert tail == ref_tail == [1]  # latency mode: a 1-row batch
        assert ours.shape == (1, 4)
        _close(ours, ref)

    def test_deep_queue_dispatches_the_full_geometry(self):
        def run(side):
            router = side.router(max_batch=32)
            try:
                # the queue is full before the dispatcher starts
                reqs = [side.mod.Request("m", _rows(1, i), priority="background")
                        for i in range(64)]
                for r in reqs:
                    router.queue.put(r)
                n0 = len(self._batch_rows(side))
                router.start()
                outs = np.concatenate([r.result(timeout=60) for r in reqs])
                return outs, self._batch_rows(side)[n0:]
            finally:
                router.close()

        (ours, tail), (ref, ref_tail) = _both(run)
        assert max(tail) == max(ref_tail) == 32
        _close(ours, ref)
        _close(ours, PORT.direct("m", np.concatenate([_rows(1, i) for i in range(64)])))

    def test_multi_row_request_larger_than_the_geometry_splits(self):
        def run(side):
            router = side.router(max_batch=8)
            try:
                d0 = side.metrics.counter("serve.dispatches")
                out = side.mod.ServingClient(router).predict("m", _rows(20, 3), timeout=60)
                return out, side.metrics.counter("serve.dispatches") - d0
            finally:
                router.close()

        (ours, n), (ref, n_ref) = _both(run)
        assert ours.shape == (20, 4) and n == n_ref == 3
        _close(ours, ref)
        _close(ours, PORT.direct("m", _rows(20, 3)))


# -- residency ----------------------------------------------------------------


class TestResidency:
    def test_loads_once_and_reuses(self):
        def run(side):
            mgr = side.mod.ResidencyManager(loader=side.loader(), **side.router_kwargs)
            a1 = mgr.acquire("a")
            mgr.release(a1)
            a2 = mgr.acquire("a")
            mgr.release(a2)
            mgr.unload_all()
            return a1 is a2, a1.loads, a1.requests, a1.param_bytes

        assert _both(run) == ((True, 1, 2, 128), (True, 1, 2, 128))

    def test_budget_evicts_the_lru_cold_model(self):
        def run(side):
            # 8x4 float32 = 128 bytes per model: the budget fits one
            mgr = side.mod.ResidencyManager(
                loader=side.loader(), budget_bytes=200, **side.router_kwargs)
            ev0 = side.metrics.counter("serve.evictions")
            a = mgr.acquire("a")
            mgr.release(a)
            mgr.release(mgr.acquire("b"))  # evicts idle "a"
            names = {m["name"] for m in mgr.models()}
            a2 = mgr.acquire("a")  # reloads, evicting "b"
            mgr.release(a2)
            mgr.unload_all()
            return side.metrics.counter("serve.evictions") - ev0, names, a2 is a

        assert _both(run) == ((2, {"b"}, False), (2, {"b"}, False))

    def test_busy_model_never_evicted(self):
        for side in SIDES:
            mgr = side.mod.ResidencyManager(
                loader=side.loader(), budget_bytes=200, **side.router_kwargs)
            a = mgr.acquire("a")  # pinned
            with pytest.raises(RuntimeError, match="open streams"):
                mgr.acquire("b")
            mgr.release(a)
            mgr.release(mgr.acquire("b"))
            mgr.unload_all()

    def test_keys_are_case_insensitive(self):
        def run(side):
            mgr = side.mod.ResidencyManager(loader=side.loader(), **side.router_kwargs)
            a1 = mgr.acquire("ModelA")
            mgr.release(a1)
            a2 = mgr.acquire("modela")
            mgr.release(a2)
            n = len(mgr.models())
            mgr.unload_all()
            return a1 is a2, n

        assert _both(run) == ((True, 1), (True, 1))

    def test_lru_order_picks_the_coldest(self):
        def run(side):
            mgr = side.mod.ResidencyManager(
                loader=side.loader(), budget_bytes=300, **side.router_kwargs)
            for name in ("a", "b", "a", "c"):  # "b" is the coldest at "c"
                mgr.release(mgr.acquire(name))
            names = {m["name"] for m in mgr.models()}
            mgr.unload_all()
            return names

        assert _both(run) == ({"a", "c"}, {"a", "c"})

    def test_concurrent_first_loads_never_jointly_exceed_the_budget(self):
        def run(side):
            def slow_loader(name, mode):
                time.sleep(0.15)  # holds the load window open
                return side.mlp(name)

            mgr = side.mod.ResidencyManager(
                loader=slow_loader, budget_bytes=200, **side.router_kwargs)
            errors = []

            def load(name):
                try:
                    mgr.release(mgr.acquire(name))
                except RuntimeError as e:
                    errors.append(str(e))

            threads = [threading.Thread(target=load, args=(n,)) for n in ("a", "b")]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            resident = mgr.resident_bytes()
            mgr.unload_all()
            assert all("cannot load model" in e for e in errors)
            return resident <= 200

        assert _both(run) == (True, True)

    def test_failed_load_releases_its_reservation(self, monkeypatch):
        def mb_loader(side):
            def loader(name, mode):
                if name == "bad":
                    raise RuntimeError(f"load of {name} blew up")
                return side.mlp(name, width=65536)  # 2 MB
            return loader

        for side, mod in ((PORT, execution), (JAX, jax_execution)):
            orig = mod.model_device_fn

            def flaky(mf, *a, _orig=orig, **k):
                if mf.name == "bad2":
                    raise RuntimeError("device wrap blew up")
                return _orig(mf, *a, **k)

            monkeypatch.setattr(mod, "model_device_fn", flaky)
            mgr = side.mod.ResidencyManager(
                loader=mb_loader(side), budget_bytes=5 * 2**20, **side.router_kwargs)
            with pytest.raises(RuntimeError, match="blew up"):
                mgr.acquire("bad")
            with pytest.raises(RuntimeError, match="device wrap blew up"):
                mgr.acquire("bad2")
            assert mgr._reserved == {}
            a, b = mgr.acquire("good_a"), mgr.acquire("good_b")  # both still fit
            assert mgr.resident_bytes() == a.param_bytes + b.param_bytes == 2 * ROW * 65536 * 4
            mgr.release(a)
            mgr.release(b)
            mgr.unload_all()

    def test_eviction_closes_the_feeders_and_frees_the_module(self):
        """What the card shows with ``torch.cuda.memory_allocated``: once
        evicted, nothing holds the model's module."""
        router = PORT.router(budget_bytes=200)
        client = serving.ServingClient(router)
        try:
            client.predict("a", _rows(2), timeout=60)
            entry = router.residency._models[("a", "features", "f32")]
            module, device_fn = weakref.ref(entry.model_function.module), entry.device_fn
            assert any(f.device_fn is device_fn for f in feeder._feeders.values())
            del entry
            client.predict("b", _rows(2), timeout=60)  # evicts "a"
            assert not any(f.device_fn is device_fn for f in feeder._feeders.values())
            del device_fn
            gc.collect()
            assert module() is None
        finally:
            router.close()

    def test_default_loader_evicts_before_it_builds(self, monkeypatch):
        """The registry loader builds straight onto the device: its victim
        must be gone before the build, sized by the registry's estimate."""
        seen = []
        orig = residency._default_loader
        mgr = None

        def spy(name, mode, precision="f32", device=None, seed=0):
            seen.append(sorted((m["name"], m["precision"]) for m in mgr.models()))
            return orig(name, mode, precision, device=device, seed=seed)

        monkeypatch.setattr(residency, "_default_loader", spy)
        est = get_model("bert-tiny").param_bytes_estimate()
        mgr = residency.ResidencyManager(budget_bytes=int(est * 1.2), device="cpu")
        mgr.release(mgr.acquire("bert-tiny", "embed"))
        mgr.release(mgr.acquire("bert-tiny", "embed", precision="bf16"))
        assert seen == [[], []]
        [row] = mgr.models()
        assert row["precision"] == "bf16" and row["param_bytes"] < est
        mgr.unload_all()

    def test_end_to_end_eviction_outputs_stay_correct(self):
        def run(side):
            router = side.router(budget_bytes=200)
            client = side.mod.ServingClient(router)
            try:
                return [client.predict(n, _rows(4, 7), timeout=60) for n in ("a", "b", "a")]
            finally:
                router.close()

        ours, ref = _both(run)
        for name, a, b in zip(("a", "b", "a"), ours, ref):
            _close(a, b)
            _close(a, PORT.direct(name, _rows(4, 7)))

    def test_hbm_budget_knob_matches_jax(self, monkeypatch):
        for raw in ("", "0", "1.5", "500"):
            monkeypatch.setenv("SPARKDL_SERVE_HBM_BUDGET_MB", raw)
            assert residency.hbm_budget_bytes() == jax_serving.residency.hbm_budget_bytes()
        for raw in ("-1", "lots", "inf"):
            monkeypatch.setenv("SPARKDL_SERVE_HBM_BUDGET_MB", raw)
            for mod in (residency, jax_serving.residency):
                with pytest.raises(ValueError):
                    mod.hbm_budget_bytes()


# -- router -------------------------------------------------------------------


class TestRouter:
    def test_per_class_latency_timers_and_stats(self):
        def run(side):
            router = side.router()
            client = side.mod.ServingClient(router)
            try:
                counts = {}
                for cls in ("interactive", "background"):
                    stat = side.metrics.timing(f"serve.latency.{cls}")
                    counts[cls] = stat.count if stat else 0
                outs = [client.predict("m", _rows(1, 4), priority=c, timeout=60)
                        for c in ("interactive", "background")]
                for cls in counts:
                    assert side.metrics.timing(f"serve.latency.{cls}").count == counts[cls] + 1
                stats = router.stats()
                assert {"interactive", "background"} <= set(stats["latency"])
                assert [m["name"] for m in stats["models"]] == ["m"]
                return outs
            finally:
                router.close()

        ours, ref = _both(run)
        for a, b in zip(ours, ref):
            _close(a, b)

    def test_backlog_stays_in_the_priority_queue_under_load(self):
        """The dispatcher holds a worker slot before it pops, so a
        background flood stays in the admission queue and an interactive
        arrival overtakes it. Both devices take 30 ms a batch; each
        8-row background request fills a batch of its own."""
        rng = np.random.default_rng(0)
        w1 = rng.normal(size=(ROW, 256)).astype(np.float32) / ROW
        w2 = rng.normal(size=(256, 64)).astype(np.float32) / 16

        class Mlp(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.w1 = torch.nn.Parameter(torch.from_numpy(w1))
                self.w2 = torch.nn.Parameter(torch.from_numpy(w2))

        def port_fn(m, x):
            time.sleep(0.03)
            return torch.tanh(x @ m.w1) @ m.w2

        def slow(x):
            time.sleep(0.03)
            return x

        def jax_fn(p, x):
            x = jax.pure_callback(slow, jax.ShapeDtypeStruct(x.shape, x.dtype), x)
            return jnp.tanh(x @ p[0]) @ p[1]

        loaders = {
            "torch": lambda name, mode: ModelFunction(
                port_fn, Mlp(), torch.device("cpu"), input_shape=(ROW,), name=name),
            "jax": lambda name, mode: JaxModelFunction(
                jax_fn, (jnp.asarray(w1), jnp.asarray(w2)), input_shape=(ROW,), name=name),
        }

        def run(side):
            router = side.router(loader=loaders[side.name], max_batch=8, workers=2)
            client = side.mod.ServingClient(router)
            try:
                for n in (1, 8):  # load the model, build both rungs
                    client.predict("m", _rows(n), timeout=120)
                bg = [side.mod.Request("m", _rows(8, i), priority="background")
                      for i in range(12)]
                for r in bg:
                    router.queue.put(r)
                time.sleep(0.05)
                assert router.queue.depth() > 0  # not parked wholesale in the pool
                inter = router.submit("m", _rows(1), priority="interactive")
                out = inter.result(timeout=120)
                pending = sum(1 for r in bg if not r.done())
                outs = [r.result(timeout=120) for r in bg]
                return out, pending, outs
            finally:
                router.close()

        (ours, pending, bg), (ref, ref_pending, ref_bg) = _both(run)
        # under FIFO parking the interactive answer would come last
        assert pending >= 4 and ref_pending >= 4, (pending, ref_pending)
        _close(ours, ref, atol=1e-4)
        for a, b in zip(bg, ref_bg):
            _close(a, b, atol=1e-4)

    def test_rejected_submit_does_not_consume_an_ordinal(self, monkeypatch):
        def run(side):
            router = side.router()
            client = side.mod.ServingClient(router)
            try:
                client.predict("m", _rows(1), timeout=60)
                base = router._ordinal
                monkeypatch.setenv("SPARKDL_SERVE_QUEUE_CAP", "1")
                with pytest.raises(side.mod.AdmissionRejected):
                    router.submit("m", _rows(2))
                monkeypatch.delenv("SPARKDL_SERVE_QUEUE_CAP")
                req = client.submit("m", _rows(1))
                req.result(timeout=60)
                return req.ordinal - base
            finally:
                router.close()

        assert _both(run) == (0, 0)

    def test_unknown_model_fails_the_request(self):
        for side in SIDES:
            router = side.mod.Router(**side.router_kwargs)  # the registry loader
            try:
                with pytest.raises(ValueError, match="Unknown model"):
                    side.mod.ServingClient(router).predict("no-such-model", _rows(1), timeout=60)
            finally:
                router.close()

    def test_device_error_fails_every_request_of_the_group(self):
        def broken_port(name, mode):
            def fn(m, x):
                raise RuntimeError("device exploded")
            return ModelFunction(fn, _Linear(_weights(name)), torch.device("cpu"),
                                 input_shape=(ROW,), name=name)

        def broken_jax(name, mode):
            def fn(p, x):
                raise RuntimeError("device exploded")
            return JaxModelFunction(fn, jnp.asarray(_weights(name)), input_shape=(ROW,), name=name)

        for side, loader in ((PORT, broken_port), (JAX, broken_jax)):
            router = side.router(loader=loader)
            try:
                failures0 = side.metrics.counter("serve.failures")
                reqs = [side.mod.Request("m", _rows(2, i)) for i in range(3)]
                for r in reqs:
                    router.queue.put(r)
                router.start()
                for r in reqs:
                    with pytest.raises(RuntimeError, match="device exploded"):
                        r.result(timeout=60)
                assert side.metrics.counter("serve.failures") - failures0 == 3
            finally:
                router.close()

    def test_deadline_expired_before_dispatch(self):
        for side in SIDES:
            router = side.router()
            try:
                req = router.submit("m", _rows(1), deadline_s=0.0)
                with pytest.raises(side.mod.DeadlineExceeded):
                    req.result(timeout=60)
            finally:
                router.close()

    def test_close_is_idempotent_and_refuses_later_submits(self):
        for side in SIDES:
            router = side.router()
            router.start()
            router.close()
            router.close()
            with pytest.raises(RuntimeError):
                router.submit("m", _rows(1))

    def test_generate_is_not_ported(self):
        """Generation serves the registry's text models only
        (``tests/test_torch_generation.py``): on a custom-loader model or
        an image model ``mode="generate"`` is a ValueError (HTTP 400) on
        both sides, and nothing is reserved."""
        for side in SIDES:
            router = side.router()
            try:
                with pytest.raises(ValueError, match="Unknown model"):
                    router.submit("m", _rows(1), mode="generate")
                with pytest.raises(ValueError, match="generate"):
                    router.submit("ResNet50", _rows(1), mode="generate")
                assert router.residency.kv_reserved_bytes() == 0
            finally:
                router.close()

    def test_router_and_residency_default_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serving.Router()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            residency.ResidencyManager()
        assert serving.Router(device="cpu").device == torch.device("cpu")


# -- precision rungs ----------------------------------------------------------


class TestPrecision:
    @pytest.mark.parametrize("env", [
        {},
        {"SPARKDL_SERVE_PRECISION": "bf16"},
        {"SPARKDL_SERVE_PRECISION_BATCH": "bf16"},
        {"SPARKDL_SERVE_PRECISION": "bf16", "SPARKDL_SERVE_PRECISION_INTERACTIVE": "f32"},
    ], ids=["default", "global", "batch", "override"])
    def test_serve_precision_matches_jax(self, env, monkeypatch):
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        for cls in (None, "interactive", "batch", "background"):
            assert precision.serve_precision(cls) == jax_precision.serve_precision(cls)
        assert precision.precision_active() == jax_precision.precision_active() == bool(env)

    def test_unknown_rung_raises_naming_the_knob(self, monkeypatch):
        monkeypatch.setenv("SPARKDL_SERVE_PRECISION_BATCH", "fp9")
        for mod in (precision, jax_precision):
            with pytest.raises(ValueError, match="SPARKDL_SERVE_PRECISION_BATCH"):
                mod.serve_precision("batch")
        monkeypatch.setenv("SPARKDL_SERVE_PRECISION_BATCH", "int8-dynamic")
        assert precision.serve_precision("batch") == jax_precision.serve_precision("batch") == "int8-dynamic"

    def test_apply_precision_bf16_casts_at_the_edges(self):
        mf = _port_mlp("m")
        assert precision.apply_precision(mf, "f32") is mf
        low = precision.apply_precision(mf, "bf16")
        assert low.precision == "bf16" and low.name == "m@bf16"
        assert mf.module.w.dtype == torch.float32  # the caller's module is kept
        assert low.module.w.dtype == torch.bfloat16
        assert precision.apply_precision(low, "bf16") is low
        x = _rows(3, 1)
        out = low(torch.from_numpy(x))
        assert out.dtype == torch.float32
        ref = np.asarray(jax_precision.apply_precision(_jax_mlp("m"), "bf16")(x))
        _close(out.numpy(), ref, atol=3e-2)
        ids = precision._cast_floating(torch.ones(2, dtype=torch.int32), torch.bfloat16)
        assert ids.dtype == torch.int32  # token ids are never cast

    def test_router_serves_each_class_at_its_rung(self, monkeypatch):
        monkeypatch.setenv("SPARKDL_SERVE_PRECISION_BATCH", "bf16")

        def run(side):
            router = side.router()
            client = side.mod.ServingClient(router)
            try:
                outs = {cls: client.predict("m", _rows(3, 5), priority=cls, timeout=60)
                        for cls in ("interactive", "batch")}
                rungs = sorted(m["precision"] for m in router.stats()["models"])
                return outs, rungs
            finally:
                router.close()

        (ours, rungs), (ref, ref_rungs) = _both(run)
        assert rungs == ref_rungs == ["bf16", "f32"]
        _close(ours["interactive"], ref["interactive"])
        _close(ours["batch"], ref["batch"], atol=3e-2)
        assert np.abs(ours["batch"] - ours["interactive"]).max() > 0  # bf16 really ran


# -- HTTP ---------------------------------------------------------------------


class TestHTTP:
    def _serve(self, side, **kwargs):
        router = side.router(**kwargs)
        server = side.mod.ServingServer(router, port=0)
        return server, f"http://127.0.0.1:{server.port}"

    def test_predict_models_healthz_round_trip(self):
        x = _rows(2, 5)

        def run(side):
            server, base = self._serve(side)
            try:
                status, hdrs, reply = _http(base, "/v1/predict", {
                    "model": "m", "inputs": x.tolist(), "priority": "interactive"},
                    headers={"X-Sparkdl-Trace": "ABCDEF12"})
                assert status == 200 and reply["rows"] == 2
                assert reply["trace_id"] == hdrs["X-Sparkdl-Trace"] == "abcdef12"
                assert reply["precision"] == "f32"
                status, _, models = _http(base, "/v1/models")
                assert status == 200 and models["admitted"] >= 1
                assert [m["name"] for m in models["models"]] == ["m"]
                supported = {r["name"]: r for r in models["supported"]}
                status, _, health = _http(base, "/healthz")
                assert status == 200 and health["status"] == "ok"
                return np.asarray(reply["outputs"], np.float32), supported
            finally:
                server.stop(close_router=True)

        (ours, sup), (ref, ref_sup) = _both(run)
        _close(ours, ref)
        _close(ours, PORT.direct("m", x))
        # other JAX tests may register extra models in the same process
        assert set(sup) == set(supported_models()) and set(sup) <= set(ref_sup)
        for name in ("ResNet50", "bert-tiny"):  # the JAX scrape skips its estimates
            assert sup[name]["param_bytes"] == jax_registry.get_model(name).param_bytes_estimate()

    def test_single_row_and_bad_requests(self):
        x = _rows(1, 9)[0]
        bad = [
            b'{"inputs": [1]}',  # no model
            b"not json",
            json.dumps({"model": "m", "inputs": x.tolist(), "deadline_ms": "soon"}).encode(),
            json.dumps({"model": "m", "inputs": x.tolist(), "priority": "urgent"}).encode(),
            json.dumps({"model": "bert-tiny", "inputs": [[5] * 129], "dtype": "int32",
                        "mode": "embed"}).encode(),  # longer than the position table
        ]

        def run(side):
            server, base = self._serve(side)
            try:
                status, _, reply = _http(base, "/v1/predict", {"model": "m", "inputs": x.tolist()})
                assert status == 200 and reply["rows"] == 1
                codes = [_http(base, "/v1/predict", body)[0] for body in bad]
                return np.asarray(reply["outputs"], np.float32), codes
            finally:
                server.stop(close_router=True)

        (ours, codes), (ref, ref_codes) = _both(run)
        assert ours.shape == (4,)  # a single row comes back without its batch axis
        _close(ours, ref)
        assert codes == ref_codes == [400] * len(bad)

    def test_unknown_model_is_400(self):
        def run(side):
            router = side.mod.Router(**side.router_kwargs)
            server = side.mod.ServingServer(router, port=0)
            try:
                return _http(f"http://127.0.0.1:{server.port}", "/v1/predict",
                             {"model": "no-such-model", "inputs": _rows(1).tolist()})[0]
            finally:
                server.stop(close_router=True)

        assert _both(run) == (400, 400)

    def test_429_carries_retry_after(self, monkeypatch):
        monkeypatch.setenv("SPARKDL_SERVE_QUEUE_CAP", "1")

        def run(side):
            server, base = self._serve(side)
            try:
                status, hdrs, _ = _http(base, "/v1/predict", {"model": "m", "inputs": _rows(4).tolist()})
                return status, bool(hdrs.get("Retry-After"))
            finally:
                server.stop(close_router=True)

        assert _both(run) == ((429, True), (429, True))

    def test_device_error_is_500(self):
        def broken(name, mode):
            def fn(m, x):
                raise RuntimeError("device exploded")
            return ModelFunction(fn, _Linear(_weights(name)), torch.device("cpu"),
                                 input_shape=(ROW,), name=name)

        server, base = self._serve(PORT, loader=broken)
        try:
            status, _, reply = _http(base, "/v1/predict", {"model": "m", "inputs": _rows(1).tolist()})
            assert status == 500 and "device exploded" in reply["error"]
        finally:
            server.stop(close_router=True)

    def test_deadline_is_504(self):
        server, base = self._serve(PORT)
        try:
            status, _, _ = _http(base, "/v1/predict",
                                 {"model": "m", "inputs": _rows(1).tolist(), "deadline_ms": 0})
            assert status == 504
        finally:
            server.stop(close_router=True)

    def test_features_not_ported_answer_501(self, tmp_path, monkeypatch):
        """Every endpoint of the JAX server answers on the port: the
        profiler capture too (200 with a run directory on the CPU)."""
        monkeypatch.setenv("SPARKDL_PROFILE_DIR", str(tmp_path))
        server, base = self._serve(PORT)
        try:
            status, _, reply = _http(base, "/admin/profile", {"seconds": 0.1})
            assert status == 200 and reply["path"].startswith(str(tmp_path))
            # the control plane's endpoints answer now
            for path, body, code in (("/v1/slo", None, 200), ("/v1/memory", None, 200),
                                     ("/admin/canary", {}, 400), ("/admin/canary", {"weight": 0.5}, 200)):
                status, _, reply = _http(base, path, body)
                assert status == code and "not ported" not in reply.get("error", ""), path
            # generate is served for the registry's text models; on this
            # custom-loader model it is a bad request
            status, _, reply = _http(base, "/v1/predict", {
                "model": "m", "inputs": _rows(1).tolist(), "mode": "generate"})
            assert status == 400 and "Unknown model" in reply["error"]
            assert _http(base, "/v1/nothing")[0] == 404
        finally:
            server.stop(close_router=True)

    def test_metrics_exports_the_serving_counters(self):
        server, base = self._serve(PORT)
        try:
            assert _http(base, "/v1/predict", {"model": "m", "inputs": _rows(1).tolist()})[0] == 200
            status, _, text = _http(base, "/metrics")
            assert status == 200
            assert "sparkdl_serve_completed_total" in text
            assert 'sparkdl_serve_latency_interactive_seconds{quantile="0.95"}' in text
        finally:
            server.stop(close_router=True)

    def test_start_server_reads_the_port_knob(self, monkeypatch):
        monkeypatch.delenv("SPARKDL_SERVE_PORT", raising=False)
        assert serving.start_server(PORT.router()) is None
        server = serving.start_server(PORT.router(), port=0)
        try:
            assert _http(f"http://127.0.0.1:{server.port}", "/healthz")[0] == 200
        finally:
            server.stop(close_router=True)


# -- graceful drain -----------------------------------------------------------


class TestDrain:
    def test_draining_queue_rejects_new_submits(self):
        def run(side):
            q = side.mod.AdmissionQueue(cap_rows=64)
            q.put(side.mod.Request("m", _rows(1)))
            rejects0 = side.metrics.counter("serve.draining_rejects")
            q.drain()
            assert q.draining
            with pytest.raises(side.mod.Draining):
                q.put(side.mod.Request("m", _rows(1)))
            popped = q.pop(timeout=1.0)
            assert popped is not None and q.pop(timeout=0.05) is None
            q.drain()
            q.close()
            with pytest.raises(RuntimeError):
                q.put(side.mod.Request("m", _rows(1)))
            return side.metrics.counter("serve.draining_rejects") - rejects0

        assert _both(run) == (1, 1)

    def test_drain_completes_queued_and_inflight(self):
        def run(side):
            router = side.router(max_batch=8)
            client = side.mod.ServingClient(router)
            try:
                reqs = [client.submit("m", _rows(2, i), priority="background") for i in range(12)]
                router.drain()
                with pytest.raises(side.mod.Draining):
                    client.submit("m", _rows(1))
                outs = [r.result(timeout=120) for r in reqs]
                assert router.wait_drained(timeout=30)
                assert router.residency.models() == []  # unloaded at quiesce
                assert router.stats()["draining"] is True
                return outs
            finally:
                router.close()

        ours, ref = _both(run)
        for i, (a, b) in enumerate(zip(ours, ref)):
            _close(a, b)
            _close(a, PORT.direct("m", _rows(2, i)))

    def test_close_during_drain_neither_deadlocks_nor_drops_results(self):
        for side in SIDES:
            router = side.router(max_batch=8)
            client = side.mod.ServingClient(router)
            reqs = [client.submit("m", _rows(1, i), priority="background") for i in range(8)]
            router.drain()
            t0 = time.monotonic()
            router.close(timeout=30)
            assert time.monotonic() - t0 < 30
            for i, req in enumerate(reqs):
                assert req.done()
                try:
                    _close(req.result(timeout=0), PORT.direct("m", _rows(1, i)))
                except RuntimeError:
                    pass  # failed by close: an error, not a hang
            assert router.wait_drained(timeout=1)

    def test_drain_before_start_is_immediate(self):
        for side in SIDES:
            router = side.router()
            router.drain()
            assert router.wait_drained(timeout=1)
            with pytest.raises(side.mod.Draining):
                router.submit("m", _rows(1))
            router.close()

    def test_http_drain_503_retry_after_and_healthz(self):
        def run(side):
            router = side.router()
            server = side.mod.ServingServer(router, port=0)
            base = f"http://127.0.0.1:{server.port}"
            try:
                drain = _http(base, "/admin/drain", b"{}")
                health = _http(base, "/healthz")[2]["status"]
                status, hdrs, reply = _http(base, "/v1/predict", {"model": "m", "inputs": _rows(1).tolist()})
                return drain[0], drain[2]["status"], health, status, bool(hdrs.get("Retry-After")), reply["status"]
            finally:
                server.stop(close_router=True)

        expected = (200, "draining", "draining", 503, True, "draining")
        assert _both(run) == (expected, expected)


# -- the feeder's keepalive, retry policy, trace ids, registry memory ---------


def test_feeder_idle_knob_matches_jax(monkeypatch):
    for raw in ("0", "-1", "0.01", "2.5"):
        monkeypatch.setenv("SPARKDL_FEEDER_IDLE_S", raw)
        assert feeder._idle_s() == jax_feeder._idle_s()
    monkeypatch.setenv("SPARKDL_FEEDER_IDLE_S", "0")
    assert feeder._idle_s() == float("inf")


@pytest.mark.parametrize("idle", ["0", "0.2"], ids=["never", "short"])
def test_feeder_owner_keepalive(idle, monkeypatch):
    monkeypatch.setenv("SPARKDL_FEEDER_IDLE_S", idle)
    monkeypatch.setenv("SPARKDL_FEEDER_LINGER_MS", "1")
    f = feeder.DeviceFeeder(execution.model_device_fn(_port_mlp("m")), 4, (ROW,), np.float32, 1)
    try:
        out = [None] * 4
        h = f.open_handle(out)
        f.submit_rows(h, np.arange(4), _rows(4))
        f.finish(h)
        h.wait(timeout=30)
        deadline = time.monotonic() + 5.0
        while f._owner_alive() and time.monotonic() < deadline and idle != "0":
            time.sleep(0.05)
        time.sleep(0.3 if idle == "0" else 0)
        assert f._owner_alive() == (idle == "0")
    finally:
        f.close()


def test_retry_policy_matches_jax(monkeypatch):
    ours = policy.RetryPolicy(max_attempts=4, base_delay_s=0.01, seed=7)
    ref = jax_policy.RetryPolicy(max_attempts=4, base_delay_s=0.01, seed=7)
    assert [ours.delay_s(a) for a in range(6)] == [ref.delay_s(a) for a in range(6)]
    for exc in (RuntimeError("x"), policy.FatalError("x")):
        assert ours.classify(exc) == ref.classify(
            jax_policy.FatalError("x") if isinstance(exc, policy.FatalError) else exc)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    assert ours.call(flaky, sleep=lambda s: None) == "ok" and len(calls) == 3
    monkeypatch.setenv("SPARKDL_SERVE_RETRY_ATTEMPTS", "5")
    monkeypatch.setenv("SPARKDL_SERVE_RETRY_BASE_MS", "20")
    got = policy.policy_from_env("SPARKDL_SERVE_RETRY", max_attempts=2)
    want = jax_policy.policy_from_env("SPARKDL_SERVE_RETRY", max_attempts=2)
    assert (got.max_attempts, got.base_delay_s) == (want.max_attempts, want.base_delay_s) == (5, 0.02)
    monkeypatch.setenv("SPARKDL_SERVE_RETRY_ATTEMPTS", "many")
    with pytest.raises(ValueError, match="SPARKDL_SERVE_RETRY_ATTEMPTS"):
        policy.policy_from_env("SPARKDL_SERVE_RETRY")


def test_trace_ids_match_jax():
    assert trace.TRACE_HEADER == jax_trace.TRACE_HEADER
    for raw in ("ABCDEF12", "abcd-ef12-3456", "  0123456789abcdef "):
        assert trace.coerce_trace_id(raw) == jax_trace.coerce_trace_id(raw)
    for raw in (None, "", "not hex!", "abc"):
        minted = trace.coerce_trace_id(raw)
        assert len(minted) == 16 and int(minted, 16) >= 0
    assert trace.mint_trace_id() != trace.mint_trace_id()


def test_registry_memory_estimates_match_jax():
    for name in ("bert-tiny", "bert-base", "ResNet50", "MobileNetV2"):
        assert get_model(name).param_bytes_estimate() == \
            jax_registry.get_model(name).param_bytes_estimate(), name
    rows = {r["name"]: r for r in supported_models(with_memory=True)}
    assert set(rows) == set(supported_models())
    row = rows["MobileNetV2"]
    assert row["param_bytes"] == get_model("MobileNetV2").param_bytes_estimate()
    assert row["param_mb"] == round(row["param_bytes"] / 2**20, 2)
    assert row["input_dtype"] == "float32" and rows["bert-tiny"]["input_dtype"] == "int32"
    # buffers count: the BatchNorm statistics are part of the charge
    net = ResNet((1, 1, 1, 1))
    assert param_bytes(net) == sum(p.nbytes for p in net.parameters()) + sum(
        b.nbytes for b in net.buffers())


def test_serve_cli_refuses_without_cuda_and_lists_models(monkeypatch, capsys):
    from sparkdl_tpu_torch.serving.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("SPARKDL_FEEDER_IDLE_S", "30")
    monkeypatch.setenv("SPARKDL_MAX_FEEDERS", "8")
    assert main(["serve", "--port", "0"]) == 2
    assert "device='cpu'" in capsys.readouterr().err
    assert main(["models"]) == 0
    names = [r["name"] for r in json.loads(capsys.readouterr().out)]
    assert names == supported_models()
