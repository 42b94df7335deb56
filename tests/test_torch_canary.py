"""The port's canary rollout (``Router`` with ``SPARKDL_SERVE_CANARY_*``)
against the JAX package's, on the CPU.

Under the same knobs and a tiny loader (a matmul per model version), the
Bresenham split routes the same admissions to the same arm in both
packages, each arm's rows are its own version's, the rollback trips at
the same admission after the same failures (a canary whose loader
raises), with the same ``canary_rollback`` event and counters, and
``POST /admin/canary`` moves the split the same way.
"""

import json
import urllib.error
import urllib.request
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparkdl_tpu.serving as jax_serving
from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
from sparkdl_tpu.utils.metrics import metrics as jax_metrics
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.runtime import feeder
from sparkdl_tpu_torch.serving import Router, ServingServer, canary_config
from sparkdl_tpu_torch.utils.metrics import metrics

ROW = 8
BASE, VERSION = "m", "m-canary"


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("SPARKDL_INFERENCE_MODE", "roundrobin")
    monkeypatch.setenv("SPARKDL_INFERENCE_DEVICES", "1")
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_MODEL", BASE)
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_VERSION", VERSION)
    for name in ("SPARKDL_SERVE_CANARY_WEIGHT", "SPARKDL_SERVE_CANARY_TRIP_RATE",
                 "SPARKDL_SERVE_CANARY_MIN_REQUESTS", "SPARKDL_FAULT_PLAN"):
        monkeypatch.delenv(name, raising=False)
    yield
    feeder.shutdown_feeders()


def _weights(name):
    return np.random.default_rng(zlib.crc32(name.encode())).normal(size=(ROW, 4)).astype(np.float32)


def _port_loader(name, mode):
    if name == "broken":
        raise RuntimeError("canary build failed")
    w = torch.nn.Module()
    w.w = torch.nn.Parameter(torch.from_numpy(_weights(name)))
    return ModelFunction(lambda m, x: x @ m.w, w, torch.device("cpu"), name=name, input_shape=(ROW,))


def _jax_loader(name, mode):
    if name == "broken":
        raise RuntimeError("canary build failed")
    return JaxModelFunction(lambda p, x: x @ p, jnp.asarray(_weights(name)), input_shape=(ROW,), name=name)


SIDES = {
    "torch": (lambda: Router(loader=_port_loader, device="cpu"), metrics, ServingServer),
    "jax": (lambda: jax_serving.Router(loader=_jax_loader), jax_metrics, jax_serving.ServingServer),
}


def _rows(i):
    return np.random.default_rng(i).normal(size=(1, ROW)).astype(np.float32)


def test_canary_config(monkeypatch):
    assert canary_config() == (BASE, VERSION, 0.1)
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_WEIGHT", "7")
    assert canary_config() == (BASE, VERSION, 1.0)
    monkeypatch.delenv("SPARKDL_SERVE_CANARY_VERSION")
    assert canary_config() is None


@pytest.mark.parametrize("weight,n", [(0.25, 64), (0.1, 40), (0.5, 33), (0.0, 10), (1.0, 12)])
def test_split_equals_jax_arm_by_arm(weight, n, monkeypatch):
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_WEIGHT", str(weight))
    arms = {}
    for name, (make, registry, _) in SIDES.items():
        router = make()
        before = (registry.counter("serve.canary.requests"), registry.counter("serve.primary.requests"))
        try:
            reqs = [router.submit(BASE, _rows(i)) for i in range(n)]
            reqs.append(router.submit("other", _rows(n)))  # not canaried
            outs = [np.asarray(r.result(timeout=60)) for r in reqs]
        finally:
            router.close()
        arms[name] = [(r.canary_arm, r.model) for r in reqs]
        for r, out in zip(reqs, outs):  # each arm's rows are its own version's
            np.testing.assert_allclose(out, _rows(reqs.index(r)) @ _weights(r.model), rtol=1e-5, atol=1e-6)
        counted = (registry.counter("serve.canary.requests") - before[0],
                   registry.counter("serve.primary.requests") - before[1])
        taken = sum(arm == "canary" for arm, _ in arms[name])
        assert counted == (taken, n - taken)
    assert arms["torch"] == arms["jax"]
    taken = sum(arm == "canary" for arm, _ in arms["torch"])
    assert abs(taken - round(n * weight)) <= 1
    assert arms["torch"][-1] == (None, "other")


def test_rollback_trips_like_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_VERSION", "broken")
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_WEIGHT", "0.5")
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_MIN_REQUESTS", "4")
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_TRIP_RATE", "0.5")
    seen = {}
    for name, (make, registry, _) in SIDES.items():
        jsonl = str(tmp_path / f"{name}.jsonl")
        monkeypatch.setenv("SPARKDL_OBS_JSONL", jsonl)
        router = make()
        rollbacks = registry.counter("serve.canary.rollbacks")
        failures = registry.counter("serve.canary.failures")
        arms, errors = [], []
        try:
            for i in range(20):  # one at a time: each failure lands before the next admission
                req = router.submit(BASE, _rows(i))
                try:
                    req.result(timeout=60)
                    errors.append(None)
                except RuntimeError as e:
                    errors.append(str(e))
                arms.append(req.canary_arm)
            stats = router.stats()["canary"]
            assert router.canary_tripped
        finally:
            router.close()
        with open(jsonl) as f:
            events = [json.loads(line) for line in f if '"canary_rollback"' in line]
        for e in events:
            e.pop("ts")
        seen[name] = (arms, [e is not None for e in errors], events, stats,
                      registry.counter("serve.canary.rollbacks") - rollbacks,
                      registry.counter("serve.canary.failures") - failures)
    assert seen["torch"] == seen["jax"]
    arms, failed, events, stats, rollbacks, failures = seen["torch"]
    # admissions 1, 3, 5 and 7 take the canary and fail; the 9th trips
    assert [i for i, a in enumerate(arms) if a == "canary"] == [1, 3, 5, 7] == [i for i, f in enumerate(failed) if f]
    assert rollbacks == 1 and failures == 4 and all(a == "primary" for a in arms[8:])
    assert events == [{"kind": "canary_rollback", "model": BASE, "version": "broken", "requests": 4,
                       "failures": 4, "rate": 1.0}]
    assert stats["tripped"] is True and stats["failures"] == 4


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=body if isinstance(body, bytes) else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_admin_canary_moves_the_split_like_jax(monkeypatch):
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_WEIGHT", "0.25")
    seen = {}
    for name, (make, _, server_cls) in SIDES.items():
        router = make()
        server = server_cls(router, port=0)
        base = f"http://127.0.0.1:{server.port}"
        try:
            first = [router.submit(BASE, _rows(i)).canary_arm for i in range(16)]
            replies = [_post(base, "/admin/canary", body) for body in (
                {"weight": 0.5}, {}, b"not json", {"weight": "x"})]
            second = [router.submit(BASE, _rows(i)).canary_arm for i in range(32)]
            replies.append(_post(base, "/admin/canary", {"weight": 9}))
            seen[name] = (first, replies, second, router.stats()["canary"]["weight"])
        finally:
            server.stop(close_router=True)
    assert seen["torch"] == seen["jax"]
    first, replies, second, weight = seen["torch"]
    assert first.count("canary") == 4 and abs(second.count("canary") - 16) <= 1
    assert replies[0] == (200, {"weight": 0.5, "tripped": False})
    assert [code for code, _ in replies[1:4]] == [400, 400, 400]
    assert replies[4] == (200, {"weight": 1.0, "tripped": False}) and weight == 1.0


class _SmallerCanary:
    """A canary of ``bert-tiny`` with a smaller vocabulary (500 of 1000
    ids) and a shorter position table (64 of 128), built with tables of
    those sizes, so an id or a length only the primary has would fail in
    its forward. Its KV charge per token is twice the primary's, so a
    reservation shows which spec sized it."""

    NAME, VOCAB, MAX_LEN = "bert-tiny-v500", 500, 64

    @classmethod
    def spec(cls):
        from dataclasses import replace

        from sparkdl_tpu_torch.models import NamedTextModel, get_model
        from sparkdl_tpu_torch.models.bert import BERT_CONFIGS
        from sparkdl_tpu_torch.models.registry import _bert_text_builder

        tiny = get_model("bert-tiny")
        small = replace(BERT_CONFIGS["tiny"], vocab_size=cls.VOCAB, max_position_embeddings=cls.MAX_LEN)
        seen = []

        def build(spec, mode, dtype, seed, params, device):
            BERT_CONFIGS[cls.NAME] = small  # the builder reads its preset by name
            try:
                mf = _bert_text_builder(cls.NAME, attention="dense")(spec, mode, dtype, seed, params, device)
            finally:
                del BERT_CONFIGS[cls.NAME]
            inner = mf.fn

            def fn(mod, x):
                seen.append(int(x.max()))
                return inner(mod, x)

            mf.fn = fn
            return mf

        class Spec(NamedTextModel):
            def kv_bytes_per_token(self):
                return 2 * tiny.kv_bytes_per_token()

        return Spec(cls.NAME, cls.MAX_LEN, tiny.feature_dim, build, vocab_size=cls.VOCAB, size="tiny"), seen


def test_a_canary_takes_only_what_its_own_spec_admits(monkeypatch):
    """Admission screens a request against the model it routes to: an id
    inside the primary's vocabulary but past the canary's, or a length past
    the canary's position table, stays on the primary and never reaches the
    canary's forward; the canary's share holds over the requests it can
    take; a generate request reserves the KV bytes of the model that serves
    it. The JAX package has no such case: its gathers clamp."""
    from sparkdl_tpu_torch.models import get_model, register_model
    from sparkdl_tpu_torch.models.registry import _REGISTRY

    spec, seen = _SmallerCanary.spec()
    register_model(spec)
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_MODEL", "bert-tiny")
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_VERSION", spec.name)
    monkeypatch.setenv("SPARKDL_SERVE_CANARY_WEIGHT", "0.5")
    monkeypatch.delenv("SPARKDL_SERVE_HBM_BUDGET_MB", raising=False)
    rng = np.random.default_rng(7)
    payloads = []
    for i in range(24):
        ids = rng.integers(1, _SmallerCanary.VOCAB, size=(1, 12))
        if i % 3 == 1:
            ids[0, 5] = 700  # the primary's vocabulary only
        elif i % 3 == 2:
            ids = rng.integers(1, _SmallerCanary.VOCAB, size=(1, 100))  # the primary's table only
        payloads.append(ids.astype(np.int32))
    router = Router(device="cpu")
    ineligible0 = metrics.counter("serve.canary.ineligible")
    try:
        reqs = [router.submit("bert-tiny", p, mode="embed") for p in payloads]
        for r in reqs:
            assert np.isfinite(r.result(timeout=120)).all()
        prompt = np.arange(3, 9, dtype=np.int32)[None]
        gens = [router.submit("bert-tiny", p, mode="generate", gen_params={"max_new_tokens": 4})
                for p in (prompt, prompt, np.concatenate([prompt, [[700]]], axis=1))]
        kv = [(g.model, g.kv_bytes, get_model(g.model).kv_bytes_per_token()) for g in gens]
        for g in gens:
            assert g.result(timeout=120).shape == (1, 4)
        assert router.residency.kv_reserved_bytes() == 0
        failures = router.stats()["canary"]["failures"]
    finally:
        router.close()
        _REGISTRY.pop(spec.name.lower(), None)
    arms = [(r.canary_arm, r.model) for r in reqs]
    assert all(arm == ("primary", "bert-tiny") for i, arm in enumerate(arms) if i % 3)
    eligible = [arm for i, arm in enumerate(arms) if i % 3 == 0]
    assert [a for a, _ in eligible] == ["primary", "canary"] * 4  # the split over what it can take
    assert all(model == spec.name for a, model in eligible if a == "canary")
    assert seen and max(seen) < _SmallerCanary.VOCAB and failures == 0
    # the 8 eligible embeds leave the split at 8: the 1st prompt stays on
    # the primary, the 2nd takes the canary, the 3rd (id 700) cannot
    assert [m for m, _, _ in kv] == ["bert-tiny", spec.name, "bert-tiny"]
    prompt_lens = (prompt.shape[1], prompt.shape[1], prompt.shape[1] + 1)
    for (_, nbytes, per_token), n in zip(kv, prompt_lens):
        assert nbytes == per_token * (n + 4)
    assert kv[1][1] == 2 * kv[0][1]  # sized by the canary's own spec
    assert metrics.counter("serve.canary.ineligible") - ineligible0 == 16 + 1
