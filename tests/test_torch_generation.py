"""The port's generation path (``BertGenerator``, ``serving/generation.py``,
KV reservations, ``mode="generate"`` through the router and over HTTP)
against the JAX package's, on the CPU.

The generators are held to each other with the JAX package's bert-tiny
weights (``get_model("bert-tiny").generate_function(seed=0)``) carried
across by ``models/convert.bert_params_from_flax``: prefill and decode
logits and K/V at atol 1e-5 (the same float32 math, summed in another
order), greedy tokens equal. The serving cases mirror
``tests/test_generation.py``: a port router is held to a cacheless oracle
over the same weights (the port's registry with the same seed, or the
JAX generator itself when the router's loader carries the JAX weights),
and admission screening, KV arithmetic and HTTP status codes to the JAX
package's on the same calls. Each package keeps its own metrics registry,
so counters are read as differences around the action under test.
"""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import sparkdl_tpu.serving as jax_serving
import sparkdl_tpu_torch.serving as serving
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.runtime import feeder as jax_feeder
from sparkdl_tpu.serving import generation as jax_generation
from sparkdl_tpu.serving import router as jax_router
from sparkdl_tpu_torch.models import get_model, supported_models
from sparkdl_tpu_torch.runtime import feeder
from sparkdl_tpu_torch.serving import generation
from sparkdl_tpu_torch.serving import router as port_router
from sparkdl_tpu_torch.utils.metrics import metrics

MODEL = "bert-tiny"  # max_length 128, vocabulary 1000
ATOL = 1e-5
TIMEOUT = 120


@pytest.fixture(autouse=True)
def _serving_env(monkeypatch):
    """One CPU device for the JAX side, default generation knobs, no
    budget; no feeder left behind."""
    monkeypatch.setenv("SPARKDL_INFERENCE_MODE", "roundrobin")
    monkeypatch.setenv("SPARKDL_INFERENCE_DEVICES", "1")
    for name in ("SPARKDL_SERVE_HBM_BUDGET_MB", "SPARKDL_GEN_MAX_SEQS",
                 "SPARKDL_GEN_MAX_NEW_TOKENS", "SPARKDL_SERVE_PRECISION",
                 "SPARKDL_SERVE_PRECISION_INTERACTIVE", "SPARKDL_SERVE_PRECISION_BATCH",
                 "SPARKDL_FAULT_PLAN", "SPARKDL_SERVE_CANARY_MODEL"):
        monkeypatch.delenv(name, raising=False)
    yield
    feeder.shutdown_feeders()
    jax_feeder.shutdown_feeders()


@pytest.fixture(scope="module")
def jax_gen():
    return jax_registry.get_model(MODEL).generate_function(seed=0)


@pytest.fixture(scope="module")
def jax_tree(jax_gen):
    return {"params": jax.tree_util.tree_map(np.asarray, jax_gen._p)}


@pytest.fixture(scope="module")
def port_gen(jax_tree):
    """The port's generator over the JAX generator's weights."""
    return get_model(MODEL).generate_function(params=jax_tree, device="cpu")


@pytest.fixture(scope="module")
def oracle():
    """The port's registry generator at the default loader's seed: the
    cacheless oracle of a ``Router(device="cpu")``."""
    return get_model(MODEL).generate_function(seed=0, device="cpu")


def _prompt(n, start=1):
    return np.arange(start, start + n, dtype=np.int32)


def _ids(seed, length, width, vocab=1000):
    ids = np.zeros((1, width), np.int32)
    ids[0, :length] = np.random.default_rng(seed).integers(4, vocab, size=length)
    return ids


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def _submit(router, prompt, **gen_params):
    return router.submit(MODEL, np.asarray(prompt, np.int32).reshape(1, -1),
                         mode="generate", gen_params=gen_params or None)


def _tokens(req):
    return np.asarray(req.result(timeout=TIMEOUT)).ravel().tolist()


def _port_router(**kwargs):
    return serving.Router(device="cpu", **kwargs)


def _http(base, body, timeout=TIMEOUT):
    """(status, headers, raw body) of one POST /v1/predict."""
    req = urllib.request.Request(base + "/v1/predict", data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


# -- the generator -------------------------------------------------------------


class TestGenerator:
    @pytest.mark.parametrize("length,width", [(1, 16), (11, 16), (16, 16), (40, 48), (100, 128)])
    def test_prefill_matches_jax(self, jax_gen, port_gen, length, width):
        ids = _ids(length, length, width)
        jk, jv, jl = jax_gen.prefill(ids, length)
        pk, pv, pl = port_gen.prefill(ids, length)
        assert tuple(pk.shape) == tuple(jk.shape) == (4, 1, 4, width, 32)
        assert tuple(pl.shape) == tuple(jl.shape) == (1, 1000)
        _close(pk, jk)
        _close(pv, jv)
        _close(pl, jl)

    def test_write_prefill_matches_jax(self, jax_gen, port_gen):
        ids = _ids(3, 9, 16)
        jk, jv, _ = jax_gen.prefill(ids, 9)
        pk, pv, _ = port_gen.prefill(ids, 9)
        jkc, jvc = jax_gen.new_cache(3)
        pkc, pvc = port_gen.new_cache(3)
        assert tuple(pkc.shape) == tuple(jkc.shape) == (4, 3, 4, 128, 32)
        assert float(pkc.abs().max()) == 0.0
        jkc, jvc = jax_gen.write_prefill(jkc, jvc, 1, jk, jv)
        out = port_gen.write_prefill(pkc, pvc, 1, pk, pv)
        assert out[0] is pkc and out[1] is pvc  # in place
        _close(pkc, jkc)
        _close(pvc, jvc)
        assert float(pkc[:, 0].abs().max()) == float(pkc[:, 2].abs().max()) == 0.0

    def test_decode_steps_match_jax_and_write_the_same_slab(self, jax_gen, port_gen):
        # three slots at different positions: slot 0 free (token 0 at
        # position 0), slots 1 and 2 prefilled with prompts of 11 and 4
        jkc, jvc = jax_gen.new_cache(3)
        pkc, pvc = port_gen.new_cache(3)
        for slot, n in ((1, 11), (2, 4)):
            ids = _ids(slot, n, 16)
            jk, jv, _ = jax_gen.prefill(ids, n)
            pk, pv, _ = port_gen.prefill(ids, n)
            jkc, jvc = jax_gen.write_prefill(jkc, jvc, slot, jk, jv)
            port_gen.write_prefill(pkc, pvc, slot, pk, pv)
        tokens = np.array([0, 17, 923], np.int32)
        positions = np.array([0, 11, 4], np.int32)
        for _ in range(3):
            jkc, jvc, jl = jax_gen.decode_step(jkc, jvc, tokens, positions)
            pkc, pvc, pl = port_gen.decode_step(pkc, pvc, tokens, positions)
            assert tuple(pl.shape) == (3, 1000)
            _close(pl, jl)
            _close(pkc, jkc)
            _close(pvc, jvc)
            tokens = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
            tokens[0] = 0
            positions = positions + np.array([0, 1, 1], np.int32)

    def test_decode_logits_equal_the_cacheless_recompute(self, port_gen):
        prompt = _ids(7, 6, 6)[0].tolist()
        kc, vc = port_gen.new_cache(2)
        k, v, logits = port_gen.prefill(np.asarray([prompt]), len(prompt))
        port_gen.write_prefill(kc, vc, 1, k, v)
        ids = list(prompt)
        for _ in range(4):
            tok = int(torch.argmax(logits[-1]))
            ids.append(tok)
            _, _, logits = port_gen.decode_step(kc, vc, [0, tok], [0, len(ids) - 1])
            _close(logits[1], port_gen.oracle_logits(ids))

    @pytest.mark.parametrize("name", ["bert-tiny", "bert-base", "bert-long-2048"])
    def test_kv_bytes_per_token_equal(self, name):
        spec, jspec = get_model(name), jax_registry.get_model(name)
        assert spec.supports_generate() and jspec.supports_generate()
        assert spec.kv_bytes_per_token() == jspec.kv_bytes_per_token()

    def test_generator_bytes_equal(self, jax_gen, port_gen):
        assert port_gen.kv_bytes_per_token == jax_gen.kv_bytes_per_token == 4096
        assert port_gen.param_bytes == jax_gen.param_bytes
        assert port_gen.max_length == jax_gen.max_length == 128
        assert port_gen.vocab_size == jax_gen.vocab_size == 1000

    @pytest.mark.parametrize("prompt,n", [([3, 4, 5, 6], 8), ([900, 12, 77], 6),
                                          (list(range(20, 60)), 5)])
    def test_greedy_oracle_matches_jax(self, jax_gen, port_gen, prompt, n):
        assert port_gen.greedy_oracle(prompt, n) == jax_gen.greedy_oracle(prompt, n)

    def test_greedy_oracle_stops_at_eos_and_max_length(self, jax_gen, port_gen):
        first = jax_gen.oracle_next_token([3, 4, 5])
        assert port_gen.greedy_oracle([3, 4, 5], 8, eos_id=first) == [first]
        long = list(range(1, 126))
        assert port_gen.greedy_oracle(long, 8) == jax_gen.greedy_oracle(long, 8)
        assert len(port_gen.greedy_oracle(long, 8)) == 3

    def test_embed_and_generate_share_weights(self):
        spec = get_model(MODEL)
        embed = spec.model_function(seed=3, device="cpu").module
        gen = spec.generate_function(seed=3, device="cpu").encoder
        for (name, a), (_, b) in zip(embed.state_dict().items(), gen.state_dict().items()):
            assert torch.equal(a, b), name

    def test_generate_function_refuses_bf16(self):
        with pytest.raises(ValueError, match="float32"):
            get_model(MODEL).generate_function(dtype=torch.bfloat16, device="cpu")

    def test_generator_defaults_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model(MODEL).generate_function()


# -- sampling and admission screening -------------------------------------------


def _seq(mod, gen_params):
    req = mod.Request(MODEL, np.ones((1, 3), np.int32), mode="generate")
    req.gen_params, req.prompt_len = gen_params, 3
    return mod._Seq(req, 0)


@pytest.mark.parametrize("gen_params", [
    {},
    {"temperature": 0.7, "seed": 1},
    {"temperature": 1.3, "top_k": 5, "seed": 2},
    {"temperature": 2.0, "top_k": 1, "seed": 3},
    {"temperature": 0.5, "top_k": 40, "seed": 4},
])
def test_sample_matches_jax(gen_params):
    logits = np.random.default_rng(5).normal(0, 3, size=(6, 1000)).astype(np.float32)
    ours, ref = _seq(generation, gen_params), _seq(jax_generation, gen_params)
    assert [ours.sample(row) for row in logits] == [ref.sample(row) for row in logits]


def test_finished_matches_jax():
    for mod in (generation, jax_generation):
        seq = _seq(mod, {"max_new_tokens": 2, "eos_id": 9})
        assert seq.finished(9)
        seq.emitted = [1]
        assert not seq.finished(3)
        seq.emitted = [1, 2]
        assert seq.finished(3)


@pytest.mark.parametrize("payload,gen_params", [
    (np.arange(1, 6), {"max_new_tokens": 8}),  # 1-D prompt
    (np.arange(1, 6)[None].astype(np.float32), None),  # integral floats, default cap
    (np.arange(1, 6)[None], {"max_new_tokens": 10**6}),  # clamped to the cap
    (np.arange(1, 121)[None], {"max_new_tokens": 8}),  # exactly the table
])
def test_validate_generate_matches_jax(payload, gen_params):
    ours = port_router._validate_generate(MODEL, payload, gen_params)
    ref = jax_router._validate_generate(MODEL, payload, gen_params)
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[0].dtype == ref[0].dtype == np.int32
    assert ours[1:] == ref[1:]


@pytest.mark.parametrize("model,payload,gen_params,match", [
    (MODEL, np.arange(1, 127)[None], {"max_new_tokens": 8}, "position table"),
    (MODEL, np.ones((2, 4)), None, "ONE prompt"),
    (MODEL, np.array([[1.5, 2.0]]), None, "integer"),
    (MODEL, np.ones((1, 0)), None, "at least one token"),
    (MODEL, np.ones((1, 4)), {"max_new_tokens": -1}, "max_new_tokens"),
    ("ResNet50", np.ones((1, 4)), None, "generate"),
    ("no-such-model", np.ones((1, 4)), None, "Unknown model"),
])
def test_validate_generate_refusals_match_jax(model, payload, gen_params, match):
    with pytest.raises(ValueError, match=match):
        port_router._validate_generate(model, payload, gen_params)
    with pytest.raises(ValueError, match=match):
        jax_router._validate_generate(model, payload, gen_params)


def test_cap_knobs_match_jax(monkeypatch):
    assert generation.max_seqs() == jax_generation.max_seqs() == 8
    assert generation.max_new_tokens_cap() == jax_generation.max_new_tokens_cap() == 64
    monkeypatch.setenv("SPARKDL_GEN_MAX_SEQS", "0")
    monkeypatch.setenv("SPARKDL_GEN_MAX_NEW_TOKENS", "4")
    assert generation.max_seqs() == jax_generation.max_seqs() == 1
    assert generation.max_new_tokens_cap() == jax_generation.max_new_tokens_cap() == 4


# -- KV reservations -------------------------------------------------------------


def test_reserve_release_arithmetic_matches_jax():
    def run(mod, **kwargs):
        mgr = mod.ResidencyManager(budget_bytes=1000, **kwargs)
        trail = []
        for op, n in (("r", 900), ("r", 200), ("f", 400), ("r", 200), ("r", 301),
                      ("f", 10**9), ("r", 1000), ("f", 1)):
            try:
                (mgr.reserve_kv if op == "r" else mgr.release_kv)(n)
                trail.append(("ok", mgr.kv_reserved_bytes()))
            except mod.AdmissionRejected:
                trail.append(("429", mgr.kv_reserved_bytes()))
        mgr.unload_all()
        return trail

    ours = run(serving, device="cpu")
    assert ours == run(jax_serving)
    assert ours[1] == ("429", 900) and ours[3] == ("ok", 700) and ours[5] == ("ok", 0)


def test_kv_reservation_counts_against_model_loads():
    # reserved KV bytes leave that much less room for parameters
    mgr = serving.ResidencyManager(
        loader=lambda name, mode: get_model(MODEL).model_function(device="cpu"),
        budget_bytes=4 * 2**20, device="cpu",
    )
    mgr.reserve_kv(3 * 2**20)
    with pytest.raises(RuntimeError, match="budget"):
        mgr.acquire(MODEL, "embed")
    mgr.release_kv(3 * 2**20)
    mgr.release(mgr.acquire(MODEL, "embed"))
    mgr.unload_all()


def test_failed_submit_releases_reservation():
    def run(side_router):
        try:
            side_router.queue.drain()
            with pytest.raises(serving.Draining if isinstance(side_router, serving.Router)
                               else jax_serving.Draining):
                _submit(side_router, _prompt(3), max_new_tokens=4)
            return side_router.residency.kv_reserved_bytes()
        finally:
            side_router.close()

    assert run(_port_router()) == run(jax_serving.Router()) == 0


def test_submit_to_a_closed_router_reserves_nothing():
    router = _port_router()
    router.close()
    with pytest.raises(RuntimeError):
        _submit(router, _prompt(3), max_new_tokens=4)
    assert router.residency.kv_reserved_bytes() == 0


# -- the router and the engine ------------------------------------------------------


class TestGenerateServing:
    def test_tokens_match_the_jax_oracle(self, jax_gen, jax_tree):
        # the router's loader carries the JAX weights: the port's cached
        # continuous-batching path against the JAX package's cacheless one
        def loader(name, mode):
            assert mode == "generate"
            return get_model(name).generate_function(params=jax_tree, device="cpu")

        router = _port_router(loader=loader)
        try:
            prompts = [_prompt(5), _ids(9, 30, 30)[0], _prompt(2, start=500)]
            reqs = [_submit(router, p, max_new_tokens=7) for p in prompts]
            for p, req in zip(prompts, reqs):
                assert _tokens(req) == jax_gen.greedy_oracle(p, 7)
                assert req.prompt_len == len(p)
        finally:
            router.close()

    def test_greedy_matches_cacheless_oracle(self, oracle):
        router = _port_router()
        try:
            req = _submit(router, _prompt(5), max_new_tokens=8)
            assert _tokens(req) == oracle.greedy_oracle(_prompt(5), 8)
            assert router.residency.models()[0]["mode"] == "generate"
            assert router.residency.models()[0]["param_bytes"] == oracle.param_bytes
        finally:
            router.close()

    def test_streamed_tokens_match_result(self):
        router = _port_router()
        try:
            req = _submit(router, _prompt(4), max_new_tokens=6)
            streamed = list(req.iter_tokens(timeout=TIMEOUT))
            assert [i for _, i in streamed] == list(range(6))
            assert [t for t, _ in streamed] == _tokens(req)
        finally:
            router.close()

    def test_max_new_tokens_clamped_to_cap(self, monkeypatch, oracle):
        monkeypatch.setenv("SPARKDL_GEN_MAX_NEW_TOKENS", "4")
        router = _port_router()
        try:
            req = _submit(router, _prompt(3), max_new_tokens=10**6)
            assert req.gen_params["max_new_tokens"] == 4
            assert _tokens(req) == oracle.greedy_oracle(_prompt(3), 4)
        finally:
            router.close()

    def test_eos_ends_the_sequence(self, oracle):
        first = oracle.oracle_next_token(_prompt(6))
        router = _port_router()
        try:
            req = _submit(router, _prompt(6), max_new_tokens=8, eos_id=first)
            assert _tokens(req) == [first]
        finally:
            router.close()

    def test_sampled_request_replays_exactly(self):
        router = _port_router()
        try:
            a = _submit(router, _prompt(4), max_new_tokens=6, temperature=1.5, top_k=50, seed=7)
            b = _submit(router, _prompt(4), max_new_tokens=6, temperature=1.5, top_k=50, seed=7)
            assert _tokens(a) == _tokens(b)
        finally:
            router.close()

    def test_embed_mode_still_serves_same_entry(self):
        router = _port_router()
        try:
            _tokens(_submit(router, _prompt(4), max_new_tokens=2))
            req = router.submit(MODEL, np.arange(1, 9, dtype=np.int32).reshape(1, -1), mode="embed")
            assert np.asarray(req.result(timeout=TIMEOUT)).shape == (1, get_model(MODEL).feature_dim)
            assert sorted(m["mode"] for m in router.residency.models()) == ["embed", "generate"]
        finally:
            router.close()

    def test_flood_conserves_kv_bytes_and_matches_oracle(self, monkeypatch, oracle):
        # 2 slots x 6 staggered sequences: mid-batch joins and slot reuse
        monkeypatch.setenv("SPARKDL_GEN_MAX_SEQS", "2")
        joins0, reuse0 = metrics.counter("gen.joins"), metrics.counter("gen.slot_reuse")
        seqs0, tokens0 = metrics.counter("gen.seqs"), metrics.counter("gen.tokens_out")
        router = _port_router()
        try:
            prompts = [_prompt(3 + i) for i in range(6)]
            news = [4 + (i % 3) for i in range(6)]
            reqs = [_submit(router, p, max_new_tokens=n) for p, n in zip(prompts, news)]
            assert router.residency.kv_reserved_bytes() <= sum(
                4096 * (len(p) + n) for p, n in zip(prompts, news))
            for p, n, req in zip(prompts, news, reqs):
                assert _tokens(req) == oracle.greedy_oracle(p, n)
                assert req.trace_segments["decode"] > 0
            assert metrics.counter("gen.slot_reuse") > reuse0
            assert metrics.counter("gen.joins") > joins0
            assert metrics.counter("gen.seqs") - seqs0 == 6
            assert metrics.counter("gen.tokens_out") - tokens0 == sum(news)
            assert router.residency.kv_reserved_bytes() == 0
            # the stream counts its slots after the step that retired the
            # last sequence: wait for it to go idle
            deadline = time.monotonic() + 10
            while router.stats()["generation"]["active_seqs"] and time.monotonic() < deadline:
                time.sleep(0.01)
            status = router.stats()["generation"]
            assert status["streams"][0]["slots"] == 2
            assert status["active_seqs"] == status["pending_seqs"] == 0
            assert metrics.gauge_stats("gen.kv_bytes")["last"] == 0
            assert metrics.gauge_stats("gen.kv_bytes")["max"] > 0
        finally:
            router.close()

    def test_kv_reservation_refused_is_429_then_served(self, oracle):
        budget = 64 * 2**20
        router = _port_router(budget_bytes=budget)
        try:
            rejected0 = metrics.counter("gen.kv_rejected")
            router.residency.reserve_kv(budget - 1024)
            with pytest.raises(serving.AdmissionRejected, match="KV-cache"):
                _submit(router, _prompt(4), max_new_tokens=8)
            assert metrics.counter("gen.kv_rejected") == rejected0 + 1
            assert router.residency.models() == []  # refused before any load
            router.residency.release_kv(budget - 1024)
            assert router.residency.kv_reserved_bytes() == 0
            req = _submit(router, _prompt(4), max_new_tokens=8)
            assert _tokens(req) == oracle.greedy_oracle(_prompt(4), 8)
            assert router.residency.kv_reserved_bytes() == 0
        finally:
            router.close()

    def test_deadline_expiry_fails_and_releases(self):
        router = _port_router()
        try:
            req = router.submit(MODEL, _prompt(3)[None], mode="generate", deadline_s=0.0,
                                gen_params={"max_new_tokens": 4})
            with pytest.raises(serving.DeadlineExceeded):
                req.result(timeout=TIMEOUT)
            assert router.residency.kv_reserved_bytes() == 0
        finally:
            router.close()

    def test_load_failure_fails_the_request_and_is_not_sticky(self):
        calls = []

        def loader(name, mode):
            calls.append(mode)
            if len(calls) == 1:
                raise RuntimeError("load exploded")
            return get_model(name).generate_function(seed=0, device="cpu")

        router = _port_router(loader=loader)
        try:
            with pytest.raises(RuntimeError, match="load exploded"):
                _submit(router, _prompt(3), max_new_tokens=2).result(timeout=TIMEOUT)
            assert len(_tokens(_submit(router, _prompt(3), max_new_tokens=2))) == 2
            assert router.residency.kv_reserved_bytes() == 0
        finally:
            router.close()

    def test_drain_waits_for_running_generations(self, oracle):
        router = _port_router()
        try:
            req = _submit(router, _prompt(5), max_new_tokens=24)
            next(req.iter_tokens(timeout=TIMEOUT))  # decoding has begun
            router.drain()
            with pytest.raises(serving.Draining):
                _submit(router, _prompt(3), max_new_tokens=2)
            assert router.wait_drained(timeout=TIMEOUT)
            assert _tokens(req) == oracle.greedy_oracle(_prompt(5), 24)
            assert router.residency.models() == []
            assert router.residency.kv_reserved_bytes() == 0
        finally:
            router.close()

    def test_close_fails_running_generations_without_counting_a_failure(self):
        router = _port_router()
        req = _submit(router, _prompt(5), max_new_tokens=100)
        next(req.iter_tokens(timeout=TIMEOUT))
        failures0 = metrics.counter("serve.failures")
        router.close()
        with pytest.raises(RuntimeError, match="shut down"):
            req.result(timeout=TIMEOUT)
        assert metrics.counter("serve.failures") == failures0
        assert router.residency.kv_reserved_bytes() == 0

    def test_client_generate(self, oracle):
        router = _port_router()
        try:
            req = serving.ServingClient(router).generate(MODEL, _prompt(4), max_new_tokens=3)
            assert _tokens(req) == oracle.greedy_oracle(_prompt(4), 3)
        finally:
            router.close()


# -- HTTP ------------------------------------------------------------------------


class TestGenerateHTTP:
    def _serve(self, router):
        server = serving.ServingServer(router, port=0)
        return server, f"http://127.0.0.1:{server.port}"

    def test_models_rows_advertise_modes_and_kv(self):
        server, base = self._serve(_port_router())
        try:
            with urllib.request.urlopen(base + "/v1/models", timeout=TIMEOUT) as resp:
                rows = {r["name"]: r for r in json.loads(resp.read())["supported"]}
        finally:
            server.stop(close_router=True)
        jax_rows = {r["name"]: r for r in jax_registry.supported_models(with_memory=True)}
        for name in supported_models(kind="text"):
            assert rows[name]["modes"] == jax_rows[name]["modes"] == ["embed", "generate"]
            assert rows[name]["kv_bytes_per_token"] == jax_rows[name]["kv_bytes_per_token"]
        assert rows["bert-base"]["kv_bytes_per_token"] == 73728
        assert "generate" not in rows["ResNet50"]["modes"]

    def test_streamed_generate_roundtrip(self, oracle):
        server, base = self._serve(_port_router())
        try:
            prompt = _prompt(4).tolist()
            req = urllib.request.Request(base + "/v1/predict", data=json.dumps({
                "model": MODEL, "inputs": prompt, "mode": "generate",
                "max_new_tokens": 6, "stream": True}).encode())
            with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
                assert resp.headers["Content-Type"].startswith("application/x-ndjson")
                assert resp.headers["Transfer-Encoding"] == "chunked"
                trace = resp.headers["X-Sparkdl-Trace"]
                records = [json.loads(line) for line in resp if line.strip()]
        finally:
            server.stop(close_router=True)
        done = records[-1]
        assert done["done"] is True and done["trace_id"] == trace
        expected = oracle.greedy_oracle(prompt, 6)
        assert [r["token"] for r in records[:-1]] == expected
        assert [r["index"] for r in records[:-1]] == list(range(6))
        assert all(r["trace_id"] == trace for r in records[:-1])
        assert done["tokens"] == [expected] and done["prompt_len"] == 4

    def test_blocking_generate_reply(self, oracle):
        server, base = self._serve(_port_router())
        try:
            status, _, raw = _http(base, {"model": MODEL, "inputs": [[9, 8, 7]], "mode": "generate",
                                          "max_new_tokens": 5, "priority": "batch"})
        finally:
            server.stop(close_router=True)
        reply = json.loads(raw)
        assert status == 200
        assert reply["tokens"] == [oracle.greedy_oracle([9, 8, 7], 5)]
        assert reply["prompt_len"] == 3 and reply["priority"] == "batch"

    def test_overlong_prompt_maps_to_400(self):
        body = {"model": MODEL, "inputs": list(range(1, 127)), "mode": "generate",
                "max_new_tokens": 8}
        for router in (_port_router(), jax_serving.Router()):
            server, base = self._serve(router) if isinstance(router, serving.Router) else (
                jax_serving.ServingServer(router, port=0), None)
            base = base or f"http://127.0.0.1:{server.port}"
            try:
                status, _, raw = _http(base, body)
                assert status == 400 and b"position table" in raw
            finally:
                server.stop(close_router=True)

    def test_kv_budget_breach_maps_to_429(self):
        budget = 64 * 2**20
        body = {"model": MODEL, "inputs": [1, 2, 3], "mode": "generate", "max_new_tokens": 8}
        codes = []
        for mod in (serving, jax_serving):
            router = (_port_router(budget_bytes=budget) if mod is serving
                      else mod.Router(budget_bytes=budget))
            router.residency.reserve_kv(budget - 1024)
            server = mod.ServingServer(router, port=0)
            try:
                status, headers, _ = _http(f"http://127.0.0.1:{server.port}", body)
                codes.append((status, bool(headers.get("Retry-After"))))
                assert router.residency.kv_reserved_bytes() == budget - 1024
            finally:
                server.stop(close_router=True)
        assert codes == [(429, True), (429, True)]

    def test_stream_error_before_first_token_keeps_its_status(self):
        server, base = self._serve(_port_router())
        try:
            status, _, raw = _http(base, {"model": MODEL, "inputs": [[1, 2]], "mode": "generate",
                                          "stream": True, "deadline_ms": 0})
            assert status == 504
            status, _, _ = _http(base, {"model": "ResNet50", "inputs": [[1, 2]],
                                        "mode": "generate", "stream": True})
            assert status == 400
        finally:
            server.stop(close_router=True)


def test_concurrent_http_streams_and_submits(monkeypatch, oracle):
    # streamed HTTP requests and router submits share one decode batch
    monkeypatch.setenv("SPARKDL_GEN_MAX_SEQS", "3")
    router = _port_router()
    server = serving.ServingServer(router, port=0)
    base = f"http://127.0.0.1:{server.port}"
    streamed = {}

    def stream(i):
        req = urllib.request.Request(base + "/v1/predict", data=json.dumps({
            "model": MODEL, "inputs": _prompt(3 + i).tolist(), "mode": "generate",
            "max_new_tokens": 5, "stream": True}).encode())
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            streamed[i] = [json.loads(line) for line in resp if line.strip()]

    try:
        threads = [threading.Thread(target=stream, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        reqs = [_submit(router, _prompt(8 + i, start=40), max_new_tokens=5) for i in range(3)]
        for t in threads:
            t.join(timeout=TIMEOUT)
        for i in range(2):
            tokens = [r["token"] for r in streamed[i][:-1]]
            assert tokens == streamed[i][-1]["tokens"][0] == oracle.greedy_oracle(_prompt(3 + i), 5)
        for i, req in enumerate(reqs):
            assert _tokens(req) == oracle.greedy_oracle(_prompt(8 + i, start=40), 5)
        assert router.residency.kv_reserved_bytes() == 0
    finally:
        server.stop(close_router=True)


def test_kv_reservations_hold_under_thread_stress():
    # more threads than cores, a short switch interval: a lost update in
    # the reservation count would leave it off zero or over the budget
    budget = 64 * 4096
    mgr = serving.ResidencyManager(budget_bytes=budget, device="cpu")
    peak = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def churn(seed):
        rng = np.random.default_rng(seed)
        for _ in range(300):
            n = int(rng.integers(1, 9)) * 4096
            try:
                mgr.reserve_kv(n)
            except serving.AdmissionRejected:
                continue
            peak.append(mgr.kv_reserved_bytes())
            mgr.release_kv(n)

    try:
        threads = [threading.Thread(target=churn, args=(i,)) for i in range(4 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert mgr.kv_reserved_bytes() == 0
    assert peak and max(peak) <= budget
