"""The port's flight recorder against the JAX package's, on the CPU.

Mirrors ``tests/test_obs.py``: span nesting (across threads too), the
ring's bound, ``SPARKDL_OBS=0``, the snapshot and Chrome-trace schemas,
the env-gated dump, the executor's and a gang rank's dumps, the
heartbeat's obs payload, the report's overlap ratio and stage rows, the
CLI round trip, and the spans of the port's batched engine (the shared
feeder's ``ingest``, ``dispatch`` and ``drain_wait``). Where both
packages can take the same input, the same spans or one snapshot dict go
through both and the outputs must be equal.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from sparkdl_tpu.obs import export as jax_export
from sparkdl_tpu.obs import report as jax_report
from sparkdl_tpu.obs import spans as jax_spans
from sparkdl_tpu_torch import obs
from sparkdl_tpu_torch.obs import export, report
from sparkdl_tpu_torch.obs.spans import SpanRecorder, set_recorder, span
from sparkdl_tpu_torch.utils.metrics import metrics


@pytest.fixture(autouse=True)
def fresh_recorder():
    """An isolated ring per test in both packages."""
    rec = SpanRecorder(capacity=4096)
    set_recorder(rec)
    jax_spans.set_recorder(jax_spans.SpanRecorder(capacity=4096))
    yield rec
    set_recorder(None)
    jax_spans.set_recorder(None)


def _shape(spans):
    """What two packages' rings must agree on: names in close order, the
    parent links (as indices), attrs."""
    ids = {s.span_id: i for i, s in enumerate(spans)}
    return [(s.name, ids.get(s.parent_id), s.attrs) for s in spans]


# -- span model -------------------------------------------------------------


def test_span_nesting_and_attrs(fresh_recorder):
    for mod in (obs.spans, jax_spans):
        with mod.span("outer", partition=3):
            with mod.span("inner") as sp:
                sp.add(rows=7, bytes=128)
    spans = fresh_recorder.spans()
    assert _shape(spans) == _shape(jax_spans.get_recorder().spans())
    inner, outer = spans
    assert [s.name for s in spans] == ["inner", "outer"]
    assert inner.parent_id == outer.span_id and outer.parent_id is None
    assert inner.attrs == {"rows": 7, "bytes": 128}
    assert inner.dur_s <= outer.dur_s
    assert metrics.timing("span.inner").count >= 1
    assert metrics.counter("span.inner.rows") >= 7


def test_span_nesting_across_threads(fresh_recorder):
    barrier = threading.Barrier(2)

    def work(tag):
        with span(f"outer.{tag}"):
            barrier.wait(timeout=10)
            with span(f"inner.{tag}"):
                pass

    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    [t.start() for t in threads]
    [t.join() for t in threads]
    by_name = {s.name: s for s in fresh_recorder.spans()}
    assert len(by_name) == 4
    for tag in ("a", "b"):
        inner, outer = by_name[f"inner.{tag}"], by_name[f"outer.{tag}"]
        assert inner.parent_id == outer.span_id
        assert inner.thread_id == outer.thread_id
    assert by_name["outer.a"].thread_id != by_name["outer.b"].thread_id


def test_ring_buffer_is_bounded():
    rec = SpanRecorder(capacity=8)
    set_recorder(rec)
    for i in range(20):
        with span(f"s{i}"):
            pass
    assert [s.name for s in rec.spans()] == [f"s{i}" for i in range(12, 20)]


def test_ring_capacity_knob_matches_jax(monkeypatch):
    monkeypatch.setenv("SPARKDL_OBS_RING", "3")
    assert obs.spans.ring_capacity() == jax_spans.ring_capacity() == 3
    assert SpanRecorder()._ring.maxlen == 3


def test_obs_disabled_records_nothing(fresh_recorder, monkeypatch):
    monkeypatch.setenv("SPARKDL_OBS", "0")
    metrics.reset()
    with span("ghost") as sp:
        sp.add(rows=1)
    assert fresh_recorder.spans() == []
    assert metrics.timing("span.ghost") is None  # the timer too, as in JAX


def test_exception_exit_tags_span(fresh_recorder):
    with pytest.raises(ValueError):
        with span("doomed"):
            raise ValueError("boom")
    (rec,) = fresh_recorder.spans()
    assert rec.attrs["error"] == "ValueError"


def test_active_spans_visible_while_open(fresh_recorder):
    with span("long.task", partition=5):
        active = obs.active_spans()
        assert [a["name"] for a in active] == ["long.task"]
        assert active[0]["attrs"]["partition"] == 5
        # the trace module re-exports the span layer for its call sites
        from sparkdl_tpu_torch.obs import trace

        assert [{k: v for k, v in a.items() if k != "age_s"} for a in trace.active_spans()] == \
            [{k: v for k, v in a.items() if k != "age_s"} for a in active]
        assert trace.compact_status()["active"][0]["name"] == "long.task"
    assert obs.active_spans() == []


# -- exports ----------------------------------------------------------------


def test_snapshot_schema(fresh_recorder):
    with span("stage.x", rows=4):
        pass
    with jax_spans.span("stage.x", rows=4):
        pass
    snap, ref = export.snapshot(), jax_export.snapshot()
    assert snap["schema"] == 1 and snap["pid"] == os.getpid()
    assert {"counters", "gauges", "timers"} <= set(snap["metrics"])
    (sp,) = snap["spans"]
    assert sp["name"] == "stage.x" and sp["dur_s"] >= 0 and sp["start_unix"] > 0
    assert set(sp) == set(ref["spans"][0])
    assert {"schema", "pid", "host", "rank", "reason", "spans", "open_spans",
            "metrics", "traces", "exemplars"} <= set(snap)
    timer = snap["metrics"]["timers"]["span.stage.x"]
    assert set(timer) == set(ref["metrics"]["timers"]["span.stage.x"])
    json.dumps(snap)


def test_chrome_trace_schema(fresh_recorder, tmp_path):
    with span("outer"):
        with span("inner", bytes=64):
            pass
    path = export.write_chrome_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    complete = [e for e in events if e["ph"] == "X"]
    assert {e["name"] for e in complete} == {"outer", "inner"}
    for e in complete:
        assert isinstance(e["ts"], float) and isinstance(e["dur"], float)
        assert "span_id" in e["args"]
    by = {e["name"]: e for e in complete}
    assert by["outer"]["ts"] <= by["inner"]["ts"]
    assert trace["displayTimeUnit"] == "ms"
    assert any(e["ph"] == "M" for e in events)
    # one snapshot dict, both packages' renderings
    snap = export.snapshot()
    assert export.to_chrome_trace(snap, pid=3, extra_args={"rank": 3}) == jax_export.to_chrome_trace(
        snap, pid=3, extra_args={"rank": 3})


def test_dump_on_failure_env_gated(fresh_recorder, tmp_path, monkeypatch):
    monkeypatch.delenv("SPARKDL_OBS_DUMP_DIR", raising=False)
    assert export.dump_on_failure("nope") is None
    monkeypatch.setenv("SPARKDL_OBS_DUMP_DIR", str(tmp_path))
    monkeypatch.setenv("SPARKDL_OBS_JSONL", str(tmp_path / "events.jsonl"))
    with span("before.crash"):
        pass
    path = export.dump_on_failure("unit_test", cls="interactive")
    assert path and os.path.exists(path)
    assert os.path.basename(path).startswith("obs-unit_test-")
    with open(path) as f:
        snap = json.load(f)
    assert snap["reason"] == "unit_test" and snap["context"] == {"cls": "interactive"}
    assert [s["name"] for s in snap["spans"]] == ["before.crash"]
    (event,) = [json.loads(x) for x in (tmp_path / "events.jsonl").read_text().splitlines()]
    assert event["kind"] == "obs_dump" and event["path"] == path and event["cls"] == "interactive"
    # an unwritable directory never raises
    monkeypatch.setenv("SPARKDL_OBS_DUMP_DIR", str(tmp_path / "events.jsonl" / "sub"))
    assert export.dump_on_failure("broken_disk") is None


# -- runtime integration ----------------------------------------------------


def test_executor_records_global_metrics_and_spans(fresh_recorder):
    from sparkdl_tpu_torch.runtime.executor import Executor

    metrics.reset()
    out = Executor(max_workers=2).map_partitions(
        lambda i, part: [x * 2 for x in part], [[1, 2], [3, 4, 5], [6]], count_rows=len,
    )
    assert out == [[2, 4], [6, 8, 10], [12]]
    assert metrics.counter("executor.rows") == 6
    names = [s.name for s in fresh_recorder.spans()]
    assert names.count("executor.partition") == 3
    assert "executor.map_partitions" in names
    part_spans = [s for s in fresh_recorder.spans() if s.name == "executor.partition"]
    assert sorted(s.attrs["partition"] for s in part_spans) == [0, 1, 2]


def test_executor_failure_counts_and_dumps(fresh_recorder, tmp_path, monkeypatch):
    from sparkdl_tpu_torch.runtime.executor import Executor, PartitionTaskError

    monkeypatch.setenv("SPARKDL_OBS_DUMP_DIR", str(tmp_path))
    metrics.reset()

    def explode(i, part):
        raise RuntimeError("kaboom")

    with pytest.raises(PartitionTaskError):
        Executor(max_workers=1, max_failures=2).map_partitions(explode, [[1]])
    assert metrics.counter("executor.partition.failures") == 2
    dumps = [p for p in os.listdir(tmp_path) if "partition_task_error" in p]
    assert len(dumps) == 1
    with open(tmp_path / dumps[0]) as f:
        snap = json.load(f)
    errs = [s for s in snap["spans"]
            if s["name"] == "executor.partition" and s["attrs"].get("error") == "RuntimeError"]
    assert len(errs) == 2


def test_heartbeat_payload_carries_obs(fresh_recorder, tmp_path):
    from sparkdl_tpu_torch.runtime.heartbeat import Heartbeat

    d = str(tmp_path / "hb")
    metrics.reset()
    metrics.inc("executor.rows", 42)
    hb = Heartbeat(d, rank=0, interval=60.0)
    with span("worker.partition", partition=7, rank=0):
        hb._write()
    with open(os.path.join(d, "hb.0")) as f:
        status = json.load(f)["obs"]
    assert status["counters"]["executor.rows"] == 42
    (active,) = status["active"]
    assert active["name"] == "worker.partition" and active["attrs"]["partition"] == 7


def test_heartbeat_cli_obs_flag(fresh_recorder, tmp_path, capsys):
    from sparkdl_tpu_torch.runtime.heartbeat import Heartbeat, main

    d = str(tmp_path / "hb")
    hb = Heartbeat(d, rank=0, interval=60.0)
    with span("worker.partition", partition=3, rank=0):
        hb._write()
    rc = main(["--dir", d, "--num-ranks", "2", "--stale-after", "0", "--obs"])
    assert rc == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["stale_ranks"] == [0, 1]
    assert out["obs"]["0"]["active"][0]["name"] == "worker.partition"
    assert out["obs"]["1"] is None


def test_gang_rank_exception_dumps(fresh_recorder, tmp_path, monkeypatch):
    from sparkdl_tpu_torch.obs.aggregate import load_rank_snapshots
    from sparkdl_tpu_torch.runtime.heartbeat import Heartbeat

    monkeypatch.setenv("SPARKDL_OBS_DUMP_DIR", str(tmp_path / "dumps"))
    hb = Heartbeat(str(tmp_path / "hb"), rank=2, interval=60.0)
    hb.__enter__()
    hb.__exit__(RuntimeError, RuntimeError("collective hang"), None)
    dumps = os.listdir(tmp_path / "dumps")
    assert len(dumps) == 1 and "gang_rank2_RuntimeError" in dumps[0]
    assert list(load_rank_snapshots(str(tmp_path / "hb"))) == [2]  # the final drop


# -- report + CLI -----------------------------------------------------------


def _synthetic_snap(spans):
    return {"schema": 1, "pid": 1, "spans": spans, "metrics": {}}


def _sp(name, start, dur, **attrs):
    return {"name": name, "span_id": 0, "parent_id": None, "thread_id": 1,
            "thread_name": "t", "start_unix": start, "dur_s": dur, "attrs": attrs}


def test_overlap_ratio_known_intervals():
    spans = [_sp("ingest", 0.0, 2.0), _sp("device_wait", 1.0, 2.0)]
    assert report.overlap_ratio(spans) == pytest.approx(0.5) == jax_report.overlap_ratio(spans)
    assert report.overlap_ratio([_sp("ingest", 0.0, 1.0)]) is None


def test_stage_rows_percentiles_and_throughput():
    spans = [_sp("h2d", float(i), 0.1 * (i + 1), bytes=1000) for i in range(10)]
    (row,) = report.stage_rows(_synthetic_snap(spans))
    assert row == jax_report.stage_rows(_synthetic_snap(spans))[0]
    assert row["stage"] == "h2d" and row["count"] == 10
    assert row["p50_s"] == pytest.approx(0.55)
    assert row["bytes_per_s"] == pytest.approx(10000 / row["total_s"])


def test_report_sections_equal_jax_on_one_snapshot(fresh_recorder):
    """Every section summary and the rendered report, from one snapshot
    dict, equal the JAX package's; a compile section is None in both when
    its counters are absent."""
    metrics.reset()
    with span("dispatch", rows=8, bytes=512):
        pass
    for name, v in (("feeder.coalesced_batches", 4), ("feeder.rows", 100), ("feeder.pad_rows", 12),
                    ("feeder.flushes", 1), ("feeder.readback_async_hits", 3),
                    ("feeder.readback_async_misses", 1), ("serve.completed", 5),
                    ("serve.admitted", 6), ("trace.records", 2)):
        metrics.inc(name, v)
    metrics.record_time("serve.latency.interactive", 0.01)
    snap = export.snapshot()
    for fn in ("stage_summary", "feeder_summary", "compile_summary", "text_summary", "sql_summary",
               "serving_summary", "generation_summary", "gateway_summary", "fleet_summary",
               "trace_summary", "slo_summary", "utilization_summary", "memory_summary",
               "resilience_summary"):
        assert getattr(report, fn)(snap) == getattr(jax_report, fn)(snap), fn
    assert report.compile_summary(snap) is None
    assert report.render_report(snap) == jax_report.render_report(snap)
    assert "async readback: 3 copies complete at drain" in report.render_report(snap)


def test_cli_report_and_chrome_round_trip(fresh_recorder, tmp_path, capsys):
    from sparkdl_tpu_torch.obs.__main__ import main

    with span("ingest", rows=8, bytes=256):
        pass
    with span("device_wait", rows=8):
        pass
    snap_path = str(tmp_path / "snap.json")
    obs.write_snapshot(snap_path)
    assert main(["report", "--snapshot", snap_path]) == 0
    out = capsys.readouterr().out
    assert "ingest" in out and "device_wait" in out and "p99_ms" in out
    trace_path = str(tmp_path / "trace.json")
    assert main(["chrome", "--snapshot", snap_path, "--out", trace_path]) == 0
    capsys.readouterr()
    with open(trace_path) as f:
        trace = json.load(f)
    assert {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"} == {"ingest", "device_wait"}
    # the JAX CLI reads the port's snapshot the same way
    from sparkdl_tpu.obs.__main__ import main as jax_main

    assert jax_main(["report", "--snapshot", snap_path]) == 0
    assert capsys.readouterr().out == out


def test_cli_rejects_non_snapshot(tmp_path):
    from sparkdl_tpu_torch.obs.__main__ import main

    bad = tmp_path / "not_a_snap.json"
    bad.write_text(json.dumps({"hello": 1}))
    with pytest.raises(SystemExit, match="not an obs snapshot"):
        main(["report", "--snapshot", str(bad)])


@pytest.mark.parametrize("cmd", ["slo", "fleet", "mem"])
def test_cli_live_views_answer_unarmed_as_jax(cmd, capsys):
    """Unarmed live views print the JAX CLI's JSON. Both packages' SLO
    engine, memory ledger and fleet series are reset first: an earlier
    test file on the same worker may have left state in either."""
    from sparkdl_tpu.obs import memory as jax_memory
    from sparkdl_tpu.obs import slo as jax_slo
    from sparkdl_tpu.obs import timeseries as jax_timeseries
    from sparkdl_tpu.obs.__main__ import main as jax_main
    from sparkdl_tpu_torch.obs import memory, slo, timeseries
    from sparkdl_tpu_torch.obs.__main__ import main

    for pkg_slo, pkg_memory, pkg_timeseries in ((slo, memory, timeseries),
                                                (jax_slo, jax_memory, jax_timeseries)):
        pkg_slo.reset()
        pkg_memory.get_ledger().clear()
        pkg_timeseries.fleet_clear()
    assert main([cmd]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jax_main([cmd]) == 0
    assert ours == json.loads(capsys.readouterr().out)


# -- the batched engine -----------------------------------------------------


def test_batched_engine_end_to_end_snapshot(fresh_recorder, tmp_path):
    """Two concurrent partitions through the port's shared feeder on the
    CPU leave ingest, dispatch and drain_wait spans with their rows; the
    report and the Chrome export render them."""
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.runtime.executor import Executor
    from sparkdl_tpu_torch.runtime.feeder import shutdown_feeders
    from sparkdl_tpu_torch.transformers.execution import (
        arrays_to_batch, model_device_fn, run_batched_shared,
    )

    mf = ModelFunction(lambda m, x: torch.tanh(x).sum(dim=1), torch.nn.Module(),
                       torch.device("cpu"), name="tanh_sum")
    device_fn = model_device_fn(mf)
    rng = np.random.default_rng(0)
    parts = [[rng.normal(size=(16,)).astype(np.float32) for _ in range(5)] for _ in range(2)]
    parts[0][3] = None
    try:
        out = Executor(max_workers=2).map_partitions(
            lambda i, part: run_batched_shared(part, arrays_to_batch, device_fn, batch_size=4), parts)
    finally:
        shutdown_feeders()
    assert out[0][3] is None and sum(o is not None for p in out for o in p) == 9
    snap = export.snapshot()
    stages = {s["name"] for s in snap["spans"]}
    assert {"ingest", "dispatch", "drain_wait"} <= stages
    summary = report.stage_summary(snap)
    for stage in ("ingest", "dispatch", "drain_wait"):
        assert summary[stage]["n"] >= 1 and summary[stage]["p50_ms"] >= 0
    ingest = [s for s in snap["spans"] if s["name"] == "ingest"]
    assert sum(s["attrs"]["rows"] for s in ingest) == 9
    assert all(s["attrs"]["bytes"] > 0 for s in ingest)
    assert "ingest" in report.render_report(snap)
    path = export.write_chrome_trace(str(tmp_path / "e2e.json"), snap)
    with open(path) as f:
        assert json.load(f)["traceEvents"]


def test_report_renders_async_readback_line(fresh_recorder):
    assert report.DEVICE_STAGES == jax_report.DEVICE_STAGES and "drain_wait" in report.DEVICE_STAGES
    snap = {"spans": [], "metrics": {"counters": {
        "feeder.coalesced_batches": 4, "feeder.rows": 100, "feeder.pad_rows": 12,
        "feeder.flushes": 1, "feeder.readback_async_hits": 3, "feeder.readback_async_misses": 1}}}
    summary = report.feeder_summary(snap)
    assert summary == jax_report.feeder_summary(snap)
    assert summary["readback_async_hits"] == 3
    rendered = report.render_report(snap)
    assert "async readback: 3 copies complete at drain" in rendered
    assert "75.0% of drains fully overlapped" in rendered


def test_prometheus_text_carries_exemplars(fresh_recorder):
    from sparkdl_tpu_torch.obs import trace

    trace.reset()
    metrics.reset()
    metrics.record_time("serve.latency.batch", 0.25)
    trace.get_exemplars().note("serve.latency.batch", 0.25, "abcd1234")
    text = export.prometheus_text(rank=1)
    assert 'sparkdl_serve_latency_batch_seconds_exemplar{trace_id="abcd1234",rank="1"} 0.25' in text
    # a registry of its own has no exemplar store
    from sparkdl_tpu_torch.utils.metrics import MetricsRegistry

    assert "exemplar" not in export.prometheus_text(MetricsRegistry())
    trace.reset()
