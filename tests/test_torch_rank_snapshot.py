"""The port's periodic, time-gated rank snapshot
(``sparkdl_tpu_torch/obs/aggregate.maybe_write_rank_snapshot`` with
``SPARKDL_OBS_SNAP_S``, called from ``runtime/heartbeat.Heartbeat``)
against the JAX package's, on the CPU, in one process.

The same sequence of calls goes through both packages' gates under the
same knob, and both must write on the same calls: the first always, a
second inside the interval never, ``force`` always, another rank or
directory on its own clock, nothing at an interval of 0 or less unless
forced. A heartbeat drops the first snapshot with its first beat, is
gated between beats, and forces a final drop on a clean exit and on an
exception. A drop written by either package reads and merges in the
other.
"""

import json
import os
import time

import pytest

from sparkdl_tpu.obs import aggregate as jax_aggregate
from sparkdl_tpu.obs import export as jax_export
from sparkdl_tpu.obs import spans as jax_spans
from sparkdl_tpu.runtime import heartbeat as jax_heartbeat
from sparkdl_tpu.runtime import knobs as jax_knobs
from sparkdl_tpu_torch.obs import aggregate, export
from sparkdl_tpu_torch.obs import spans as torch_spans
from sparkdl_tpu_torch.runtime import heartbeat, knobs

PACKAGES = {
    "jax": (jax_aggregate, jax_heartbeat, jax_export, jax_spans),
    "torch": (aggregate, heartbeat, export, torch_spans),
}


@pytest.fixture(autouse=True)
def fresh_recorders():
    """An isolated span ring per test in both packages."""
    torch_spans.set_recorder(torch_spans.SpanRecorder(capacity=4096))
    jax_spans.set_recorder(jax_spans.SpanRecorder(capacity=4096))
    yield
    torch_spans.set_recorder(None)
    jax_spans.set_recorder(None)


def _count_writes(monkeypatch, exp):
    """Count the snapshot files ``exp.write_snapshot`` writes."""
    writes = []
    real = exp.write_snapshot

    def counting(path, snap):
        writes.append((path, snap.get("generated_unix")))
        return real(path, snap)

    monkeypatch.setattr(exp, "write_snapshot", counting)
    return writes


# (env value, rank, force) per call; each call also names its directory
_SEQUENCE = [
    ("3600", 0, False, "a"),  # first: writes
    ("3600", 0, False, "a"),  # inside the interval: gated
    ("3600", 0, True, "a"),  # forced: writes
    ("3600", 0, False, "a"),  # the forced write restarted the clock: gated
    ("3600", 1, False, "a"),  # another rank: its own clock
    ("3600", 0, False, "b"),  # another directory: its own clock
    ("0", 2, False, "a"),  # off at 0
    ("0", 2, True, "a"),  # forced still writes
    ("-1", 3, False, "a"),  # off below 0
    ("-1", 3, True, "a"),
    ("junk", 4, False, "a"),  # malformed: the 30 s default, first writes
    ("junk", 4, False, "a"),  # and gates
]


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_gate_sequence_matches_jax(package, tmp_path, monkeypatch):
    agg = PACKAGES[package][0]
    written = []
    for env, rank, force, sub in _SEQUENCE:
        monkeypatch.setenv("SPARKDL_OBS_SNAP_S", env)
        d = str(tmp_path / sub)
        out = agg.maybe_write_rank_snapshot(d, rank, force=force)
        written.append(out is not None)
        if out is not None:
            assert out == agg.rank_snapshot_path(d, rank)
            with open(out) as f:
                assert json.load(f)["rank"] == rank
    assert written == [True, False, True, False, True, True, False, True, False, True, True, False]


def test_gate_agrees_between_packages(tmp_path, monkeypatch):
    got = {}
    for name, (agg, *_rest) in PACKAGES.items():
        seq = []
        for env, rank, force, sub in _SEQUENCE:
            monkeypatch.setenv("SPARKDL_OBS_SNAP_S", env)
            seq.append(agg.maybe_write_rank_snapshot(str(tmp_path / name / sub), rank, force=force) is not None)
        got[name] = seq
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_gate_reopens_after_the_interval(package, tmp_path, monkeypatch):
    agg = PACKAGES[package][0]
    monkeypatch.setenv("SPARKDL_OBS_SNAP_S", "0.2")
    d = str(tmp_path / "hb")
    assert agg.maybe_write_rank_snapshot(d, 0) is not None
    assert agg.maybe_write_rank_snapshot(d, 0) is None
    time.sleep(0.25)
    assert agg.maybe_write_rank_snapshot(d, 0) is not None


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_never_raises(package, tmp_path, monkeypatch):
    """A directory that cannot be made (a file stands in its way) returns
    None instead of raising, forced or not."""
    agg = PACKAGES[package][0]
    monkeypatch.setenv("SPARKDL_OBS_SNAP_S", "3600")
    blocker = tmp_path / "file"
    blocker.write_text("x")
    d = str(blocker / "hb")
    assert agg.maybe_write_rank_snapshot(d, 0) is None
    assert agg.maybe_write_rank_snapshot(d, 0, force=True) is None


def test_knob_default_matches_jax(monkeypatch):
    monkeypatch.delenv("SPARKDL_OBS_SNAP_S", raising=False)
    assert knobs.get_float("SPARKDL_OBS_SNAP_S") == jax_knobs.get_float("SPARKDL_OBS_SNAP_S") == 30.0
    assert aggregate.snap_interval_s() == jax_aggregate.snap_interval_s() == 30.0
    monkeypatch.setenv("SPARKDL_OBS_SNAP_S", "2.5")
    assert aggregate.snap_interval_s() == jax_aggregate.snap_interval_s() == 2.5


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_first_beat_drops_and_done_forces(package, tmp_path, monkeypatch):
    agg, hb_mod, _exp, spans_mod = PACKAGES[package]
    monkeypatch.setenv("SPARKDL_OBS_SNAP_S", "3600")
    d = str(tmp_path / "hb")
    hb = hb_mod.Heartbeat(d, rank=0, interval=60.0)
    with spans_mod.span("worker.partition", partition=4, rank=0):
        hb._write()
    snaps = agg.load_rank_snapshots(d)
    assert list(snaps) == [0]  # the first beat drops the first snapshot
    with spans_mod.span("worker.partition", partition=5, rank=0):
        pass
    hb._write()  # gated: the drop still holds partition 4 only
    parts = [s["attrs"].get("partition") for s in agg.load_rank_snapshots(d)[0]["spans"]]
    assert 5 not in parts
    hb._write(done=True)  # the done beat forces a final drop
    parts = [s["attrs"].get("partition") for s in agg.load_rank_snapshots(d)[0]["spans"]]
    assert 4 in parts and 5 in parts


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_beats_drive_periodic_drops(package, tmp_path, monkeypatch):
    """A heartbeat beating every 0.05 s under a 0.2 s gate for about a
    second drops about one snapshot per 0.2 s, plus the forced exit drop;
    each beat does not."""
    _agg, hb_mod, exp, _spans = PACKAGES[package]
    monkeypatch.setenv("SPARKDL_OBS_SNAP_S", "0.2")
    writes = _count_writes(monkeypatch, exp)
    d = str(tmp_path / "hb")
    with hb_mod.Heartbeat(d, rank=3, interval=0.05) as hb:
        time.sleep(1.0)
    assert hb._beats >= 8
    assert all(p.endswith("obs.rank.3.json") for p, _t in writes)
    assert 4 <= len(writes) <= 8, writes
    assert len(writes) < hb._beats


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_beats_drop_nothing_when_off(package, tmp_path, monkeypatch):
    """At ``SPARKDL_OBS_SNAP_S=0`` the beats drop nothing; the clean exit
    still forces the final drop."""
    agg, hb_mod, exp, _spans = PACKAGES[package]
    monkeypatch.setenv("SPARKDL_OBS_SNAP_S", "0")
    writes = _count_writes(monkeypatch, exp)
    d = str(tmp_path / "hb")
    with hb_mod.Heartbeat(d, rank=1, interval=0.05):
        time.sleep(0.3)
        assert writes == []
    assert len(writes) == 1
    assert list(agg.load_rank_snapshots(d)) == [1]


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_exception_exit_forces_the_drop(package, tmp_path, monkeypatch):
    """A rank dying by exception force-drops its final snapshot, inside the
    gate, and its beat is left to go stale (not done)."""
    agg, hb_mod, _exp, spans_mod = PACKAGES[package]
    monkeypatch.setenv("SPARKDL_OBS_SNAP_S", "3600")
    monkeypatch.setenv("SPARKDL_OBS_DUMP_DIR", str(tmp_path / "dumps"))
    d = str(tmp_path / "hb")
    hb = hb_mod.Heartbeat(d, rank=2, interval=60.0)
    hb.__enter__()
    with spans_mod.span("worker.partition", partition=9, rank=2):
        pass
    hb.__exit__(RuntimeError, RuntimeError("collective hang"), None)
    parts = [s["attrs"].get("partition") for s in agg.load_rank_snapshots(d)[2]["spans"]]
    assert 9 in parts
    with open(os.path.join(d, "hb.2")) as f:
        assert json.load(f)["done"] is False


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_periodic_drops_read_across_packages(writer, reader, tmp_path, monkeypatch):
    """Two ranks beat under one package; the other package loads their
    periodic drops and merges them into a trace with a lane per rank."""
    _agg, hb_mod, _exp, spans_mod = PACKAGES[writer]
    read_agg = PACKAGES[reader][0]
    monkeypatch.setenv("SPARKDL_OBS_SNAP_S", "3600")
    d = str(tmp_path / "hb")
    for rank in (0, 1):
        with spans_mod.span("worker.partition", partition=rank, rank=rank):
            pass
        hb_mod.Heartbeat(d, rank=rank, interval=60.0)._write()
    snaps = read_agg.load_rank_snapshots(d)
    assert sorted(snaps) == [0, 1]
    for rank in (0, 1):
        assert snaps[rank]["rank"] == rank
        assert "worker.partition" in [s["name"] for s in snaps[rank]["spans"]]
    trace = read_agg.merge_chrome_trace(snaps)
    lanes = {e["pid"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    assert lanes == {0, 1}
