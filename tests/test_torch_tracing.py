"""The port's request tracing against the JAX package's, on the CPU.

Mirrors ``tests/test_tracing.py`` (trace ids, sampling, the stores and
exemplars, the seven-segment waterfall through the port's router and
feeder, exemplar lines on ``/metrics``, the report's tracing line, trace
ids on every HTTP reply, stitching and the ``obs trace`` CLI, the
failure-edge dumps) and the merge tests of ``tests/test_aggregate.py``
(lanes per rank, merged metrics, stragglers, the merge CLI). Pure
functions take the same inputs in both packages and must give equal
outputs; the served paths use a tiny matmul model on the CPU.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sparkdl_tpu.obs import aggregate as jax_aggregate
from sparkdl_tpu.obs import trace as jax_trace
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.obs import aggregate, export, trace
from sparkdl_tpu_torch.obs.spans import SpanRecorder, set_recorder
from sparkdl_tpu_torch.obs.trace import (
    SEGMENTS,
    TRACE_HEADER,
    ExemplarStore,
    TraceStore,
    coerce_trace_id,
    collect_trace,
    mint_trace_id,
    render_waterfall,
    trace_sampled,
)
from sparkdl_tpu_torch.runtime.feeder import shutdown_feeders
from sparkdl_tpu_torch.serving import Router, ServingClient, ServingServer
from sparkdl_tpu_torch.utils.metrics import TimerStat, metrics

ROW = 8


@pytest.fixture(autouse=True)
def _tracing_env(monkeypatch):
    monkeypatch.setenv("SPARKDL_TRACE_SAMPLE", "1")
    set_recorder(SpanRecorder(capacity=4096))
    trace.reset()
    yield
    trace.reset()
    set_recorder(None)
    shutdown_feeders()


def _mlp_loader(name, mode):
    w = torch.nn.Module()
    rng = np.random.default_rng(7)
    w.w = torch.nn.Parameter(torch.from_numpy(rng.normal(size=(ROW, 4)).astype(np.float32)))
    return ModelFunction(lambda m, x: x @ m.w, w, torch.device("cpu"), name=name, input_shape=(ROW,))


def _router(loader=_mlp_loader):
    return Router(loader=loader, device="cpu")


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, ROW)).astype(np.float32)


# -- trace ids + sampling ------------------------------------------------------


class TestTraceIds:
    def test_mint_is_16_hex_and_unique(self):
        ids = {mint_trace_id() for _ in range(64)}
        assert len(ids) == 64 and all(len(t) == 16 and int(t, 16) >= 0 for t in ids)

    def test_coerce_matches_jax(self):
        for raw in ("DEADbeef1234", "123e4567-e89b-12d3-a456-426614174000"):
            assert coerce_trace_id(raw) == jax_trace.coerce_trace_id(raw)
        for bad in (None, "", "zzzz", "abc", "x" * 70, "has space"):
            got = coerce_trace_id(bad)
            assert len(got) == 16 and got != bad

    @pytest.mark.parametrize("rate", ["0", "1", "0.5", "0.01"])
    def test_sampling_coin_equals_jax(self, rate, monkeypatch):
        monkeypatch.setenv("SPARKDL_TRACE_SAMPLE", rate)
        ids = [f"{i:016x}" for i in range(0, 4000, 7)]
        ours = [trace_sampled(t) for t in ids]
        assert ours == [jax_trace.trace_sampled(t) for t in ids]
        if rate == "0.5":
            assert 0.4 < sum(ours) / len(ours) < 0.6


# -- stores ---------------------------------------------------------------------


class TestStores:
    def test_trace_store_ring_bound_evicts_oldest_unpinned(self):
        store = TraceStore(capacity=3)
        for i in range(5):
            store.add({"trace_id": f"t{i:04x}", "e2e_s": 0.1})
        assert len(store) == 3 and store.get("t0000") == []
        assert store.get("t0004")[0]["trace_id"] == "t0004"

    def test_pinned_traces_survive_eviction(self):
        store = TraceStore(capacity=2)
        store.add({"trace_id": "aaaa", "e2e_s": 0.5}, pin=True)
        for i in range(4):
            store.add({"trace_id": f"b{i:03x}", "e2e_s": 0.1})
        assert store.get("aaaa")

    def test_unique_prefix_lookup(self):
        store = TraceStore(capacity=8)
        store.add({"trace_id": "abcd1234"})
        store.add({"trace_id": "abff5678"})
        assert store.get("abcd")[0]["trace_id"] == "abcd1234"
        assert store.get("ab") == []

    def test_exemplar_store_keeps_top_k_slowest_as_jax(self):
        notes = [("m", 0.5, "a"), ("m", 1.0, "b"), ("m", 0.1, "c"), ("m", 0.7, "d"), ("n", 0.2, "e")]
        ours, ref = ExemplarStore(k=2), jax_trace.ExemplarStore(k=2)
        assert [ours.note(*n) for n in notes] == [ref.note(*n) for n in notes]
        assert ours.note("m", 0.7, "z") == (False, [])
        assert ours.snapshot() == ref.snapshot()
        assert [e["trace_id"] for e in ours.snapshot()["m"]] == ["b", "d"]
        assert ours.exemplar("m") == ref.exemplar("m") == {"value_s": 1.0, "trace_id": "b"}

    def test_displaced_exemplar_unpins_so_ring_stays_bounded(self, monkeypatch):
        monkeypatch.setenv("SPARKDL_TRACE_SAMPLE", "0")
        monkeypatch.setenv("SPARKDL_TRACE_RING", "4")
        monkeypatch.setenv("SPARKDL_TRACE_EXEMPLARS", "1")
        trace.reset()

        class _Req:
            priority = "batch"
            model = "m"
            rows = 1
            mode = "features"
            trace_segments = {s: 0.0 for s in SEGMENTS}

        for i in range(12):
            r = _Req()
            r.trace_id = f"aa{i:014x}"
            trace.record_serve_trace(r, 0.1 * (i + 1))
        store = trace.get_store()
        assert len(store) <= 4
        with store._lock:
            assert len(store._pinned) <= 2

    def test_exact_id_wins_over_longer_prefix_sibling(self):
        short = {"trace_id": "abcd", "kind": "serve", "start_unix": 1.0, "e2e_s": 0.1,
                 "segments": {}, "status": "ok"}
        long_ = {**short, "trace_id": "abcd111122223333", "start_unix": 2.0}
        snaps = {0: {"spans": [], "traces": [short, long_]}}
        got = collect_trace("abcd", snaps)
        assert [r["trace_id"] for r in got] == ["abcd"]
        assert got == jax_trace.collect_trace("abcd", snaps)
        assert collect_trace("abcd1", snaps) == jax_trace.collect_trace("abcd1", snaps)

    def test_record_serve_trace_equals_jax(self, monkeypatch):
        """One completion, both packages' records (the rank from the env)."""
        monkeypatch.setenv("SPARKDL_OBS_RANK", "3")
        jax_trace.reset()

        class _Req:
            trace_id = "0123456789abcdef"
            priority = "interactive"
            model = "m"
            rows = 2
            enqueue_unix = 123.25
            trace_segments = {s: 0.001 * (i + 1) for i, s in enumerate(SEGMENTS)}

        assert trace.record_serve_trace(_Req(), 0.03, status="error", error="E: x") == \
            jax_trace.record_serve_trace(_Req(), 0.03, status="error", error="E: x")
        jax_trace.reset()


# -- the waterfall through the port's router -----------------------------------------


class TestWaterfall:
    def test_segments_present_and_sum_to_e2e(self):
        router = _router()
        client = ServingClient(router)
        try:
            client.predict("m", _rows(2), timeout=120)
            req = client.submit("m", _rows(2), priority="interactive")
            req.result(timeout=120)
        finally:
            router.close()
        (rec,) = trace.get_store().get(req.trace_id)
        assert rec["status"] == "ok" and rec["kind"] == "serve"
        assert set(rec["segments"]) == set(SEGMENTS)
        assert abs(sum(rec["segments"].values()) - rec["e2e_s"]) < max(0.01, 0.05 * rec["e2e_s"])
        assert rec["segments"]["dispatch"] > 0
        assert rec["start_unix"] > 0 and rec["rows"] == 2

    def test_queue_and_group_wait_timers_recorded(self):
        router = _router()
        before = metrics.timing("serve.queue_wait")
        n0 = before.count if before else 0
        try:
            ServingClient(router).predict("m", _rows(1), timeout=120)
        finally:
            router.close()
        assert metrics.timing("serve.queue_wait").count > n0
        assert metrics.timing("serve.group_wait").count > 0

    def test_unsampled_success_measures_but_does_not_store(self, monkeypatch):
        monkeypatch.setenv("SPARKDL_TRACE_SAMPLE", "0")
        router = _router()
        client = ServingClient(router)
        try:
            client.predict("m", _rows(1), timeout=120)
            trace.reset()
            req = client.submit("m", _rows(1))
            req.result(timeout=120)
        finally:
            router.close()
        assert req.trace_segments["dispatch"] > 0
        recs = trace.get_store().get(req.trace_id)
        ex = trace.get_exemplars().exemplar("serve.latency.batch")
        if recs:
            assert ex and ex["trace_id"] == req.trace_id
        else:
            assert not ex or ex["trace_id"] != req.trace_id

    def test_failed_request_always_stores_with_error(self, monkeypatch):
        monkeypatch.setenv("SPARKDL_TRACE_SAMPLE", "0")

        def bad_loader(name, mode):
            raise RuntimeError("no such model today")

        router = _router(bad_loader)
        try:
            req = ServingClient(router).submit("m", _rows(1))
            with pytest.raises(RuntimeError):
                req.result(timeout=60)
        finally:
            router.close()
        recs = trace.get_store().get(req.trace_id)
        assert recs and recs[0]["status"] == "error"
        assert "no such model today" in recs[0]["error"]


# -- exemplars: /metrics and the report ---------------------------------------------


class TestExemplars:
    def _flood(self):
        router = _router()
        client = ServingClient(router)
        try:
            for i in range(6):
                client.predict("m", _rows(1, seed=i), priority="interactive", timeout=120)
        finally:
            router.close()

    def test_prometheus_exemplar_lines_resolve_in_store(self):
        self._flood()
        text = export.prometheus_text()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("sparkdl_serve_latency_interactive_seconds_exemplar{")]
        assert len(lines) == 4, text  # SPARKDL_TRACE_EXEMPLARS
        tid = lines[0].split('trace_id="')[1].split('"')[0]
        recs = trace.get_store().get(tid)
        assert recs and set(recs[0]["segments"]) == set(SEGMENTS)

    def test_report_names_exemplar_and_tracing_line(self):
        from sparkdl_tpu.obs import report as jax_report
        from sparkdl_tpu_torch.obs.report import render_report, serving_summary, trace_summary

        self._flood()
        snap = export.snapshot()
        cls = serving_summary(snap)["by_class"]["interactive"]
        assert cls["p99_exemplar"] in {e["trace_id"] for e in snap["exemplars"]["serve.latency.interactive"]}
        summary = trace_summary(snap)
        assert summary == jax_report.trace_summary(snap)
        assert summary["records"] >= 1 and "queue_wait" in summary
        text = render_report(snap)
        assert text == jax_report.render_report(snap)
        assert "request tracing:" in text and "[trace " in text


# -- HTTP: trace ids on every reply ---------------------------------------------------


def _post(port, payload, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


class TestHTTP:
    @pytest.fixture()
    def server(self):
        srv = ServingServer(_router(), port=0)
        yield srv
        srv.stop(close_router=True)

    def test_success_reply_carries_trace_id_body_and_header(self, server):
        status, body, headers = _post(server.port, {"model": "m", "inputs": [[0.5] * ROW]})
        assert status == 200 and len(body["trace_id"]) == 16
        assert headers.get(TRACE_HEADER) == body["trace_id"]

    def test_inbound_header_honored_end_to_end(self, server):
        tid = mint_trace_id()
        status, body, headers = _post(server.port, {"model": "m", "inputs": [[0.5] * ROW]},
                                      headers={TRACE_HEADER: tid})
        assert status == 200 and body["trace_id"] == tid and headers.get(TRACE_HEADER) == tid
        assert trace.get_store().get(tid)  # the worker's record carries the same id

    def test_rejected_429_returns_trace_id(self, server, monkeypatch):
        monkeypatch.setenv("SPARKDL_SERVE_QUEUE_CAP", "1")
        tid = mint_trace_id()
        status, body, headers = _post(server.port, {"model": "m", "inputs": _rows(3).tolist()},
                                      headers={TRACE_HEADER: tid})
        assert status == 429 and body["trace_id"] == tid and headers.get("Retry-After")

    def test_bad_body_400_returns_trace_id(self, server):
        status, body, headers = _post(server.port, {"inputs": [[1.0]]})
        assert status == 400 and headers.get(TRACE_HEADER) == body["trace_id"]


# -- snapshot, merge and CLI stitching ---------------------------------------------------


def _fake_serve_record(tid, rank, start, e2e=0.05):
    per_seg = e2e / len(SEGMENTS)
    return {"kind": "serve", "trace_id": tid, "model": "m", "cls": "interactive", "rows": 1,
            "rank": rank, "start_unix": start, "e2e_s": e2e,
            "segments": {s: per_seg for s in SEGMENTS}, "status": "ok"}


def _gateway_record(tid, start, rank=None):
    return {"kind": "gateway", "trace_id": tid, "path": "/v1/predict", "rank": rank,
            "start_unix": start, "e2e_s": 0.2,
            "attempts": [{"rank": 0, "dur_ms": 30.0, "outcome": "transport"},
                         {"rank": 1, "dur_ms": 150.0, "outcome": "ok"}],
            "status": 200}


class TestStitching:
    def test_snapshot_carries_traces_and_exemplars(self):
        trace.get_store().add(_fake_serve_record("feed0001", 0, 10.0))
        snap = export.snapshot()
        assert any(r["trace_id"] == "feed0001" for r in snap["traces"])
        assert "exemplars" in snap

    def test_merge_stitches_one_trace_across_lanes(self):
        tid = "cafe0123beef4567"
        snaps = {
            1: {"spans": [], "traces": [_fake_serve_record(tid, 1, 100.05)]},
            2: {"spans": [], "traces": [_gateway_record(tid, 100.0)], "role": "gateway"},
        }
        merged = aggregate.merge_chrome_trace(snaps)
        assert merged == jax_aggregate.merge_chrome_trace(snaps)
        events = merged["traceEvents"]
        slices = [e for e in events if e.get("ph") == "X" and e.get("args", {}).get("trace_id") == tid]
        assert {e["pid"] for e in slices} == {1, 2}
        flows = [e for e in events if e.get("ph") in ("s", "t", "f")]
        assert {e["pid"] for e in flows} == {1, 2}
        names = {e["name"] for e in events}
        assert "dispatch" in names and "queue_wait" in names
        labels = [e["args"]["name"] for e in events if e.get("name") == "process_name"]
        assert any(label.startswith("gateway") for label in labels)

    def test_collect_and_render_waterfall_two_attempts(self):
        tid = "beef000011112222"
        snaps = {0: {"spans": [], "traces": [_gateway_record(tid, 5.0)]},
                 1: {"spans": [], "traces": [_fake_serve_record(tid, 1, 5.01)]}}
        records = collect_trace(tid, snaps)
        assert records == jax_trace.collect_trace(tid, snaps) and len(records) == 2
        text = render_waterfall(tid, records)
        assert text == jax_trace.render_waterfall(tid, records)
        assert "attempt 1 -> rank 0" in text and "attempt 2 -> rank 1" in text
        assert all(seg in text for seg in SEGMENTS)
        assert collect_trace(tid[:8], snaps)
        assert render_waterfall("ffff", []) == "trace ffff: no records found"

    def test_obs_trace_cli_renders_from_snapshot(self, tmp_path, capsys):
        from sparkdl_tpu.obs.__main__ import main as jax_main
        from sparkdl_tpu_torch.obs.__main__ import main as obs_main

        tid = "0123456789abcdef"
        path = tmp_path / "snap.json"
        path.write_text(json.dumps({"spans": [], "traces": [_fake_serve_record(tid, 0, 1.0)]}))
        assert obs_main(["trace", tid, "--snapshot", str(path)]) == 0
        ours = capsys.readouterr().out
        assert jax_main(["trace", tid, "--snapshot", str(path)]) == 0
        assert ours == capsys.readouterr().out
        with pytest.raises(SystemExit):
            obs_main(["trace", "ffff9999", "--snapshot", str(path)])


# -- failure-edge dumps name the trace -------------------------------------------------


class TestDumpOnFailure:
    def test_retry_exhaustion_dumps_with_trace_id(self, tmp_path, monkeypatch):
        monkeypatch.setenv("SPARKDL_OBS_DUMP_DIR", str(tmp_path))
        monkeypatch.setenv("SPARKDL_SERVE_RETRY_ATTEMPTS", "1")

        def bad_loader(name, mode):
            raise RuntimeError("device is on fire")

        router = _router(bad_loader)
        try:
            req = ServingClient(router).submit("m", _rows(1))
            with pytest.raises(RuntimeError):
                req.result(timeout=60)
        finally:
            router.close()
        dumps = [p for p in tmp_path.iterdir() if p.name.startswith("obs-serve_retry_exhausted")]
        assert dumps
        snap = json.loads(dumps[0].read_text())
        assert snap["context"]["trace_id"] == req.trace_id
        assert "device is on fire" in snap["context"]["error"]

    def test_canary_rollback_dumps(self, tmp_path, monkeypatch):
        monkeypatch.setenv("SPARKDL_OBS_DUMP_DIR", str(tmp_path))
        Router._emit_canary_rollback({"model": "m", "version": "v2", "requests": 8, "failures": 4, "rate": 0.5})
        dumps = [p for p in tmp_path.iterdir() if p.name.startswith("obs-canary_rollback")]
        assert dumps and json.loads(dumps[0].read_text())["context"]["version"] == "v2"

    def test_oom_dumps_with_phase_and_model(self, tmp_path, monkeypatch):
        from sparkdl_tpu_torch.obs import memory

        monkeypatch.setenv("SPARKDL_OBS_DUMP_DIR", str(tmp_path))
        memory.record_oom("load", "bert-base", torch.cuda.OutOfMemoryError("CUDA out of memory"))
        dumps = [p for p in tmp_path.iterdir() if p.name.startswith("obs-oom")]
        assert len(dumps) == 1
        assert json.loads(dumps[0].read_text())["context"]["model"] == "bert-base"

    def test_slo_trip_dumps_and_names_exemplars(self, tmp_path, monkeypatch):
        from sparkdl_tpu_torch.obs import slo

        monkeypatch.setenv("SPARKDL_OBS_DUMP_DIR", str(tmp_path / "dumps"))
        monkeypatch.setenv("SPARKDL_OBS_JSONL", str(tmp_path / "events.jsonl"))
        monkeypatch.setenv("SPARKDL_SLO_AVAIL", "0.9")
        for name, value in (("SPARKDL_SLO_FAST_S", "2"), ("SPARKDL_SLO_SLOW_S", "8"),
                            ("SPARKDL_SLO_MIN_REQUESTS", "5"), ("SPARKDL_SLO_BURN_FAST", "10"),
                            ("SPARKDL_SLO_BURN_SLOW", "2")):
            monkeypatch.setenv(name, value)
        trace.get_exemplars().note("serve.latency.batch", 0.4, "aaaa0000bbbb1111")
        slo.reset()
        engine = slo.SloEngine(now=1000.0)
        for i in range(10):
            engine.note_bad("batch", "failure", now=1000.0 + 0.01 * i)
        assert engine.evaluate(now=1000.2)["classes"]["batch"]["tripped"]
        (dump,) = list((tmp_path / "dumps").iterdir())
        assert dump.name.startswith("obs-slo_burn-")
        context = json.loads(dump.read_text())["context"]
        assert context["cls"] == "batch" and context["exemplar_trace_ids"] == ["aaaa0000bbbb1111"]
        alert = [json.loads(x) for x in (tmp_path / "events.jsonl").read_text().splitlines()
                 if json.loads(x)["kind"] == "slo_alert"][0]
        assert alert["exemplar_trace_ids"] == ["aaaa0000bbbb1111"]
        slo.reset()


# -- cross-rank merge (tests/test_aggregate.py) ------------------------------------------


def _sp(name, start, dur, rank_thread=1, **attrs):
    return {"name": name, "span_id": start * 1000 + rank_thread, "parent_id": None,
            "thread_id": rank_thread, "thread_name": f"t{rank_thread}", "start_unix": float(start),
            "dur_s": float(dur), "attrs": attrs}


def _snap(rank, spans, counters=None, timers=None, open_spans=None):
    return {"schema": 1, "pid": 1000 + rank, "rank": rank, "host": f"host{rank}",
            "generated_unix": 100.0, "spans": spans, "open_spans": open_spans or [],
            "metrics": {"counters": counters or {}, "gauges": {}, "timers": timers or {}}}


def _gang(num_ranks=4, straggler_rank=None, straggler_stage="device_wait"):
    return {
        r: _snap(r, [_sp("ingest", 10, 0.1), _sp("dispatch", 11, 0.2),
                     _sp(straggler_stage, 12, 0.5 * (5.0 if r == straggler_rank else 1.0))],
                 counters={"feeder.rows": 100.0})
        for r in range(num_ranks)
    }


class TestMerge:
    def test_merge_chrome_trace_per_rank_lanes(self):
        snaps = {
            0: _snap(0, [_sp("ingest", 10, 0.1), _sp("dispatch", 11, 0.2)]),
            1: _snap(1, [_sp("ingest", 10, 0.15)], open_spans=[
                {"name": "device_wait", "age_s": 42.0, "thread": "t1", "attrs": {"partition": 9}}]),
        }
        merged = aggregate.merge_chrome_trace(snaps)
        assert merged == jax_aggregate.merge_chrome_trace(snaps)
        events = merged["traceEvents"]
        complete = [e for e in events if e["ph"] == "X"]
        assert {e["pid"] for e in complete} == {0, 1}
        assert all(e["args"]["rank"] == e["pid"] for e in complete)
        labels = {e["pid"]: e["args"]["name"] for e in events if e["ph"] == "M" and e["name"] == "process_name"}
        assert labels == {0: "rank 0 (host0)", 1: "rank 1 (host1)"}
        (marker,) = [e for e in events if e["ph"] == "i"]
        assert marker["pid"] == 1 and marker["name"] == "OPEN device_wait"

    def test_write_merged_trace_round_trip(self, tmp_path):
        path = aggregate.write_merged_trace(str(tmp_path / "merged.json"), _gang(num_ranks=2))
        with open(path) as f:
            assert {e["pid"] for e in json.load(f)["traceEvents"] if e["ph"] == "X"} == {0, 1}

    def test_merged_metrics_counters_and_timers(self):
        a, b = TimerStat(), TimerStat()
        for _ in range(10):
            a.record(0.1)
        for _ in range(30):
            b.record(0.3)
        snaps = {0: _snap(0, [], counters={"rows": 10}, timers={"t": a.as_dict()}),
                 1: _snap(1, [], counters={"rows": 32}, timers={"t": b.as_dict()})}
        merged = aggregate.merged_metrics(snaps)
        assert merged == jax_aggregate.merged_metrics(snaps)
        assert merged["counters"]["rows"] == 42 and merged["timers"]["t"]["count"] == 40
        assert merged["timers"]["t"]["p50_s"] == pytest.approx(0.3)

    @pytest.mark.parametrize("straggler_rank", [None, 2])
    def test_straggler_flagging_equals_jax(self, straggler_rank):
        snaps = _gang(num_ranks=4, straggler_rank=straggler_rank)
        rows = aggregate.rank_stage_rows(snaps, factor=1.5)
        assert rows == jax_aggregate.rank_stage_rows(snaps, factor=1.5)
        flagged = aggregate.straggler_summary(snaps)
        assert flagged == jax_aggregate.straggler_summary(snaps)
        by = {r["stage"]: r for r in rows}
        assert by["device_wait"]["straggler"] is (straggler_rank == 2)
        assert by["ingest"]["straggler"] is False
        if straggler_rank:
            assert by["device_wait"]["slowest_rank"] == 2 and by["device_wait"]["ratio"] == pytest.approx(5.0)

    def test_small_absolute_gaps_never_flag(self, monkeypatch):
        snaps = {0: _snap(0, [_sp("ingest", 10, 0.020)]), 1: _snap(1, [_sp("ingest", 10, 0.075)])}
        (row,) = aggregate.rank_stage_rows(snaps, factor=1.5)
        assert row["straggler"] is False
        monkeypatch.setenv("SPARKDL_OBS_STRAGGLER_MIN_S", "0.01")
        (row,) = aggregate.rank_stage_rows(snaps, factor=1.5)
        assert row["straggler"] is True

    def test_render_rank_report_equals_jax(self):
        snaps = _gang(num_ranks=3, straggler_rank=1)
        del snaps[2]["spans"][2]  # rank 2 never reached device_wait
        text = aggregate.render_rank_report(snaps, factor=1.5)
        assert text == jax_aggregate.render_rank_report(snaps, factor=1.5)
        assert "straggler" in text and "r0_s" in text
        assert aggregate.render_rank_report({}) == "(no per-rank snapshots found)"

    def test_cli_merge_and_rank_report(self, tmp_path, capsys):
        from sparkdl_tpu_torch.obs.__main__ import main

        d = str(tmp_path / "hb")
        for rank, snap in _gang(num_ranks=2, straggler_rank=1).items():
            aggregate.write_rank_snapshot(d, rank, snap)
        out_path = str(tmp_path / "merged.json")
        assert main(["merge", d, "--out", out_path]) == 0
        assert capsys.readouterr().out.strip() == out_path
        with open(out_path) as f:
            assert {e["pid"] for e in json.load(f)["traceEvents"] if e["ph"] == "X"} == {0, 1}
        assert main(["report", "--rank-dir", d, "--straggler-factor", "1.5"]) == 0
        assert "straggler" in capsys.readouterr().out
        with pytest.raises(SystemExit, match="no obs.rank"):
            main(["merge", str(tmp_path / "empty")])
