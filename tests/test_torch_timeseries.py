"""The port's metrics time series (``sparkdl_tpu_torch/obs/timeseries.py``)
against the JAX package's, on the CPU.

The same scripted registry updates (counters, gauges, timers, the
feeder's row and pad counters) go into one registry of each package, and
a sampler of each samples them at the same explicit clocks: every sample
event (counters, gauges, windowed rates, ``feeder.pad_ratio``), the ring
series, ``latest`` and ``as_dict`` are equal, with the ring bounded at
its capacity. The fleet and memory rings keep the same samples under the
same capacities, and the sampler's thread starts, samples and stops.
"""

import json
import threading
import time

import pytest

from sparkdl_tpu.obs import timeseries as jax_ts
from sparkdl_tpu.utils.metrics import MetricsRegistry as JaxRegistry
from sparkdl_tpu_torch.obs import timeseries as ts
from sparkdl_tpu_torch.utils.metrics import MetricsRegistry

#: per sample: the updates applied before it
SCRIPT = [
    [("inc", "serve.completed", 0), ("gauge", "feeder.queue_depth", 0)],
    [("inc", "serve.completed", 5), ("inc", "feeder.rows", 30), ("inc", "feeder.pad_rows", 2),
     ("gauge", "feeder.queue_depth", 3), ("time", "span.dispatch", 0.01)],
    [("inc", "serve.completed", 7), ("inc", "feeder.rows", 64), ("gauge", "feeder.queue_depth", 1),
     ("time", "span.dispatch", 0.02), ("time", "span.dispatch", 0.03)],
    [("gauge", "util.busy_frac", 0.5)],
    [("inc", "feeder.pad_rows", 6), ("inc", "feeder.rows", 2), ("inc", "serve.failures", 1)],
    [],
    [("inc", "serve.completed", 1), ("gauge", "feeder.queue_depth", 0)],
]
CLOCKS = [1000.0, 1000.5, 1001.5, 1001.5, 1004.0, 1005.0, 1005.25]


def _apply(registry, updates):
    for op, name, value in updates:
        if op == "inc":
            registry.inc(name, value)
        elif op == "gauge":
            registry.gauge(name, value)
        else:
            registry.record_time(name, value)


@pytest.fixture(autouse=True)
def _no_log(monkeypatch):
    monkeypatch.delenv("SPARKDL_OBS_JSONL", raising=False)
    monkeypatch.delenv("SPARKDL_OBS_RANK", raising=False)


@pytest.mark.parametrize("capacity", [3, 720])
@pytest.mark.parametrize("rank", [None, "1"])
def test_samples_rates_and_series_agree(capacity, rank, monkeypatch, tmp_path):
    if rank is not None:
        monkeypatch.setenv("SPARKDL_OBS_RANK", rank)
    samplers = {
        "jax": jax_ts.MetricsSampler(JaxRegistry(), interval=1.0, capacity=capacity,
                                     jsonl_path=str(tmp_path / "jax.jsonl")),
        "torch": ts.MetricsSampler(MetricsRegistry(), interval=1.0, capacity=capacity,
                                   jsonl_path=str(tmp_path / "torch.jsonl")),
    }
    events = {key: [] for key in samplers}
    for updates, now in zip(SCRIPT, CLOCKS):
        for key, sampler in samplers.items():
            _apply(sampler.registry, updates)
            events[key].append(sampler.sample_once(now=now))
    assert events["torch"] == events["jax"]
    ours, ref = samplers["torch"], samplers["jax"]
    assert ours.series() == ref.series()
    assert ours.as_dict() == ref.as_dict()
    for name in ("serve.completed/s", "feeder.pad_ratio", "feeder.queue_depth", "nope"):
        assert ours.latest(name) == ref.latest(name)
    assert all(len(points) <= capacity for points in ours.series().values())
    # the same JSONL lines, the rank stamped when the process has one
    logs = {key: [json.loads(line) for line in (tmp_path / f"{key}.jsonl").read_text().splitlines()]
            for key in samplers}
    assert logs["torch"] == logs["jax"] == events["torch"]
    assert all(e.get("rank") == (None if rank is None else int(rank)) for e in logs["torch"])
    rates = events["torch"][1]["rates"]
    assert rates["serve.completed/s"] == 10.0 and rates["feeder.pad_ratio"] == round(2 / 32, 4)
    ours.clear()
    assert ours.series() == {}


@pytest.mark.parametrize("kind", ["fleet", "mem"])
def test_rings_keep_the_same_samples(kind, monkeypatch):
    knob = {"fleet": "SPARKDL_FLEET_RING", "mem": "SPARKDL_MEM_WATERMARK_RING"}[kind]
    monkeypatch.setenv(knob, "4")
    out = {}
    for key, mod in (("jax", jax_ts), ("torch", ts)):
        append, series, clear = (getattr(mod, f"{kind}_{op}") for op in ("append", "series", "clear"))
        clear()
        for i in range(7):
            append({"ts": 100.0 + i, "value": i})
        out[key] = series()
        clear()
        assert series() == []
    assert out["torch"] == out["jax"]
    assert [s["value"] for s in out["torch"]] == [3, 4, 5, 6]


def test_capacity_knobs_agree(monkeypatch):
    for knob, fns in (("SPARKDL_OBS_SERIES", "series_capacity"), ("SPARKDL_FLEET_RING", "fleet_ring_capacity"),
                      ("SPARKDL_MEM_WATERMARK_RING", "mem_ring_capacity")):
        for value in (None, "1", "50", "bad"):
            if value is None:
                monkeypatch.delenv(knob, raising=False)
            else:
                monkeypatch.setenv(knob, value)
            assert getattr(ts, fns)() == getattr(jax_ts, fns)(), (knob, value)
    for value in (None, "0.5", "0", "bad"):
        if value is None:
            monkeypatch.delenv("SPARKDL_OBS_SAMPLE_S", raising=False)
        else:
            monkeypatch.setenv("SPARKDL_OBS_SAMPLE_S", value)
        assert ts.sample_interval_s() == jax_ts.sample_interval_s()


def test_sampler_thread_lifecycle():
    reg = MetricsRegistry()
    sampler = ts.MetricsSampler(reg, interval=0.05, capacity=50)
    assert not sampler.running()
    sampler.start()
    sampler.start()  # idempotent: one thread
    names = [t.name for t in threading.enumerate() if t.name == "sparkdl-obs-sampler"]
    assert len(names) == 1 and sampler.running()
    reg.inc("x", 3)
    time.sleep(0.3)
    reg.gauge("g", 2.0)
    sampler.stop()
    assert not sampler.running()
    series = sampler.series()
    assert series["x"][-1][1] == 3.0 and series["g"][-1][1] == 2.0  # the tail sample
    assert len(series["x"]) >= 3
    sampler.stop()  # idempotent


def test_global_sampler_off_at_zero(monkeypatch):
    monkeypatch.setenv("SPARKDL_OBS_SAMPLE_S", "0")
    assert ts.start_sampler() is None
    monkeypatch.setenv("SPARKDL_OBS_SAMPLE_S", "0.05")
    s = ts.start_sampler()
    try:
        assert s is ts.get_sampler() and s.running() and s.interval == 0.05
    finally:
        ts.stop_sampler()
        ts.set_sampler(None)
