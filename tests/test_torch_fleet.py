"""The port's fleet plane (``sparkdl_tpu_torch/obs/fleet.py``) against the
JAX package's, on the CPU.

Two engines, one per package, scrape the same scripted workers through an
injected fetch at explicit clocks: every cycle's fused view (rates,
per-model and per-class roll-ups, headroom, the memory roll-up, fleet SLO
fusion), the recommendation, the status payload, the federated
``/metrics`` text, the routing oracles, the fleet gauges, the JSONL
events and the fleet-sample ring are held equal. The scenarios are the
JAX file's: rates from counter deltas, headroom scaled by busy and its
floor, a counter reset, sub-floor workers tripping at the fleet sum and
recovering, a dead worker going stale, a relaunched generation, a resized
gang, and each verdict of the recommender.
"""

import json

import pytest

from sparkdl_tpu.obs import fleet as jax_fleet
from sparkdl_tpu.obs import slo as jax_slo
from sparkdl_tpu.obs import timeseries as jax_ts
from sparkdl_tpu.utils.metrics import metrics as jax_metrics
from sparkdl_tpu_torch.obs import fleet, slo
from sparkdl_tpu_torch.obs import timeseries as ts
from sparkdl_tpu_torch.utils.metrics import metrics


@pytest.fixture(autouse=True)
def _fleet_env(monkeypatch):
    for name in ("SPARKDL_SLO_AVAIL", "SPARKDL_SLO_P95_MS", "SPARKDL_SLO_AVAIL_INTERACTIVE",
                 "SPARKDL_SLO_P95_MS_INTERACTIVE", "SPARKDL_OBS_JSONL"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SPARKDL_SLO_FAST_S", "60")
    monkeypatch.setenv("SPARKDL_SLO_SLOW_S", "300")
    monkeypatch.setenv("SPARKDL_SLO_BURN_FAST", "10")
    monkeypatch.setenv("SPARKDL_SLO_BURN_SLOW", "2")
    monkeypatch.setenv("SPARKDL_SLO_MIN_REQUESTS", "3")
    monkeypatch.setenv("SPARKDL_FLEET_STALE_S", "5")
    monkeypatch.setenv("SPARKDL_FLEET_RING", "8")
    for mod in (slo, jax_slo):
        mod.reset()
    for mod in (ts, jax_ts):
        mod.fleet_clear()
    metrics.reset()
    jax_metrics.reset()
    yield
    for mod in (slo, jax_slo):
        mod.reset()
    for mod in (ts, jax_ts):
        mod.fleet_clear()


class FakeWorker:
    """One scriptable worker endpoint triple behind the injected fetch."""

    def __init__(self, rank):
        self.rank = rank
        self.fail = False
        self.completed = 0
        self.model_requests = {"m": 0}
        self.busy = 0.5
        self.latency_count = 0
        self.p95 = 40.0
        self.windows = None
        self.exemplars = None
        self.memory = None
        self.canary = None

    def metrics_text(self):
        return (
            "# TYPE serve_completed counter\n"
            f'serve_completed_total{{rank="{self.rank}"}} {self.completed}\n'
            "# TYPE kernel_flash_attention_launches_float32 counter\n"
            f'kernel_flash_attention_launches_float32_total{{rank="{self.rank}"}} {12 * self.completed}\n'
        )

    def stats(self):
        out = {
            "completed": self.completed,
            "models": [
                {"name": name, "requests": n, "precision": "bf16" if name == "m" else "f32",
                 "mesh_width": 1}
                for name, n in sorted(self.model_requests.items())
            ],
            "latency": {"interactive": {"count": self.latency_count, "p95_ms": self.p95}},
            "utilization": {"busy_frac": self.busy},
        }
        if self.memory is not None:
            out["memory"] = self.memory
        if self.canary is not None:
            out["canary"] = self.canary
        return out

    def slo_payload(self):
        out = {"armed": True, "rank": self.rank}
        if self.windows is not None:
            out["windows"] = self.windows
        if self.exemplars is not None:
            out["exemplars"] = self.exemplars
        return out


def _fetcher(workers):
    def fetch(base_url, path, timeout):
        w = workers[int(base_url.rsplit("w", 1)[1])]
        if w.fail:
            raise ConnectionError("connection refused")
        if path == "/metrics":
            return w.metrics_text().encode()
        if path == "/v1/slo":
            return json.dumps(w.slo_payload()).encode()
        if path == "/v1/models":
            return json.dumps(w.stats()).encode()
        raise AssertionError(path)

    return fetch


def _sub_floor(bad=1):
    return {"interactive": {"ok_fast": 1, "bad_fast": bad, "slow_fast": 0,
                            "ok_slow": 2, "bad_slow": 2 * bad, "slow_slow": 0}}


def _healthy():
    return {"interactive": {"ok_fast": 50, "bad_fast": 0, "slow_fast": 0,
                            "ok_slow": 50, "bad_slow": 0, "slow_slow": 0}}


def _memory(rank):
    return {"tracked_bytes": 1000 + rank, "watermark_bytes": 2000 + rank,
            "leaked_bytes": 0, "unattributed_bytes": 7 * rank, "budget_bytes": 5000,
            "models": {"m": 1000 + rank}}


# each scenario: (number of workers, env, {cycle: step(workers, states)})
def _rates(ws, st):
    for w, n in zip(ws, (6, 4)):
        w.completed = n
        w.model_requests["m"] = n
        w.latency_count = n


def _headroom(ws, st):
    ws[1].busy = 0.25
    _rates(ws, st)


def _floor(ws, st):
    ws[0].busy = 0.001
    ws[0].completed = ws[0].model_requests["m"] = 1


def _reset_first(ws, st):
    ws[0].completed = ws[0].model_requests["m"] = 100


def _reset_then(ws, st):
    ws[0].completed = ws[0].model_requests["m"] = 2


def _trip(ws, st):
    for w in ws:
        w.windows = _sub_floor()
        w.exemplars = {"interactive": [f"trace-{w.rank}"]}


def _recover(ws, st):
    for w in ws:
        w.windows = _healthy()


def _die(ws, st):
    ws[1].fail = True


def _relaunch(ws, st):
    st[0]["generation"] = 1
    ws[0].completed = ws[0].model_requests["m"] = 2


def _grow(ws, st):
    ws[0].completed = ws[0].model_requests["m"] = 7


def _busy(value):
    def step(ws, st):
        for w in ws:
            w.busy = value
    return step


def _spread(ws, st):
    ws[0].busy, ws[1].busy = 0.75, 0.1


def _memory_and_canary(ws, st):
    for w in ws:
        w.memory = _memory(w.rank)
        w.canary = {"requests": 10 + w.rank, "failures": w.rank, "tripped": w.rank == 1}
        w.model_requests["bert-base-canary"] = 3


def _trip_over_floor(ws, st):
    _trip(ws, st)
    ws[0].windows["interactive"].update(ok_fast=2, bad_fast=2)


def _fail_first(ws, st):
    ws[0].fail = True


def _draining(ws, st):
    st[1]["status"] = "draining"


def _shrink(ws, st):
    del st[1:]


SCENARIOS = {
    "rates": (2, {}, {1: _rates}),
    "headroom": (2, {}, {1: _headroom}),
    "busy_floor": (1, {}, {1: _floor}),
    "counter_reset": (1, {}, {0: _reset_first, 1: _reset_then}),
    "slo_trip_recover": (2, {"SPARKDL_SLO_AVAIL_INTERACTIVE": "0.99"}, {0: _trip, 2: _recover}),
    "p95_objective": (2, {"SPARKDL_SLO_P95_MS_INTERACTIVE": "10"}, {0: _trip}),
    "dead_goes_stale": (2, {}, {1: _die}),
    "stale_gang_keeps_trip": (1, {"SPARKDL_SLO_AVAIL_INTERACTIVE": "0.99"},
                              {0: _trip_over_floor, 1: _fail_first}),
    "relaunch": (1, {}, {0: _reset_first, 1: _relaunch, 2: _grow}),
    "scale_up_busy": (2, {}, {1: _busy(0.9)}),
    "rebalance": (2, {}, {0: _spread}),
    "scale_down": (2, {}, {0: _busy(0.05)}),
    "memory_canary": (2, {}, {0: _memory_and_canary, 1: _rates}),
    "draining_and_resize": (3, {}, {1: _draining, 2: _shrink}),
}

#: the clock of each cycle (the 4th jumps past SPARKDL_FLEET_STALE_S)
CLOCKS = [100.0, 101.0, 102.0, 108.0, 109.0]


def _gauges(registry):
    return {k: v for k, v in registry.snapshot()["gauges"].items() if k.startswith("fleet.")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_scrapes_same_fleet(name, monkeypatch, tmp_path):
    n, env, steps = SCENARIOS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    workers = [FakeWorker(r) for r in range(n)]
    states = [{"rank": r, "generation": 0, "status": "ready", "base_url": f"http://w{r}"}
              for r in range(n)]
    engines = {"jax": jax_fleet.FleetEngine(fetch=_fetcher(workers)),
               "torch": fleet.FleetEngine(fetch=_fetcher(workers))}
    logs = {key: tmp_path / f"{key}.jsonl" for key in engines}
    for i, now in enumerate(CLOCKS):
        if i in steps:
            steps[i](workers, states)
        seen = {}
        for key, eng in engines.items():
            monkeypatch.setenv("SPARKDL_OBS_JSONL", str(logs[key]))
            fused = eng.scrape_once([dict(s) for s in states], now=now)
            rec = eng.recommend_once(now=now + 0.5)
            seen[key] = (
                fused, rec, eng.status(now=now + 0.5),
                eng.federated_text("# TYPE up gauge\nup 1\n", now=now + 0.5),
                eng.rank_busy(), eng.resident_models(), eng.tripped_classes(), eng.canary_fleet(),
                eng.recommendation(),
            )
        assert seen["torch"] == seen["jax"], (name, i)
        assert _gauges(metrics) == _gauges(jax_metrics), (name, i)
    read = {key: [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []
            for key, path in logs.items()}
    for events in read.values():
        for e in events:
            if e["kind"].startswith("fleet_slo_"):
                e.pop("ts")  # an alert's stamp is the wall clock's
    assert read["torch"] == read["jax"]
    assert ts.fleet_series() == jax_ts.fleet_series()
    assert len(ts.fleet_series()) == len(CLOCKS)


def test_scenarios_reach_each_verdict(monkeypatch):
    """The scenarios above are not vacuous: each recommender verdict and
    a fleet SLO trip happen in them (read on the port's engine)."""
    verdicts = set()
    tripped = False
    for name, (n, env, steps) in SCENARIOS.items():
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            slo.reset()
            workers = [FakeWorker(r) for r in range(n)]
            states = [{"rank": r, "generation": 0, "status": "ready", "base_url": f"http://w{r}"}
                      for r in range(n)]
            eng = fleet.FleetEngine(fetch=_fetcher(workers))
            for i, now in enumerate(CLOCKS):
                if i in steps:
                    steps[i](workers, states)
                eng.scrape_once([dict(s) for s in states], now=now)
                verdicts.add(eng.recommend_once(now=now + 0.5)["action"])
                tripped = tripped or bool(eng.tripped_classes())
    assert verdicts == {"hold", "scale_up", "scale_down", "rebalance"}
    assert tripped


def test_rank_labels_on_the_port_exposition():
    from sparkdl_tpu_torch.utils.metrics import MetricsRegistry, prometheus_text

    reg = MetricsRegistry()
    reg.inc("serve.completed", 3)
    reg.record_time("serve.latency", 0.01)
    text = prometheus_text(reg, rank=2)
    assert 'sparkdl_serve_completed_total{rank="2"} 3' in text
    assert '{quantile="0.5",rank="2"}' in text
    assert all("rank=" not in ln for ln in text.splitlines() if ln.startswith("#"))
    assert "rank=" not in prometheus_text(reg)
    # the label rule is the JAX package's, line for line
    from sparkdl_tpu.obs.export import _label_line as jax_label_line
    from sparkdl_tpu_torch.utils.metrics import _label_line

    for line in text.splitlines() + ['x{a="1",b="2"} 4', "# HELP x y"]:
        assert _label_line(line, 'rank="5"') == jax_label_line(line, 'rank="5"')


def test_a_host_bound_worker_with_an_idle_card_is_not_scaled_up(monkeypatch):
    """A worker whose host dispatch fills the wall while NVML reads the card
    at 5% busy: its ledger publishes 0.05, and the fleet does not read it
    as saturated (the host-dispatch number, near 1, would scale up)."""
    from sparkdl_tpu_torch.obs import utilization

    verdicts = {}
    for name, probe_share in (("nvml", 0.05), ("host_dispatch", None)):
        ledger = utilization.DeviceLedger(busy_probe=None)
        clock = {"t": 100.0}
        if probe_share is not None:
            ledger.set_busy_probe(lambda: probe_share * (clock["t"] - 100.0))
        for _ in range(40):
            clock["t"] += 0.1
            ledger.note_busy(0.1, now=clock["t"])
        view = ledger.status(now=clock["t"])
        assert view["busy_source"] == name
        workers = [FakeWorker(r) for r in range(2)]
        for w in workers:
            w.busy = view["busy_frac"]
        states = [{"rank": r, "generation": 0, "status": "ready", "base_url": f"http://w{r}"}
                  for r in range(2)]
        eng = fleet.FleetEngine(fetch=_fetcher(workers))
        for now in CLOCKS[:3]:
            eng.scrape_once([dict(s) for s in states], now=now)
        verdicts[name] = eng.recommend_once(now=CLOCKS[2] + 0.5)["action"]
    assert verdicts["nvml"] != "scale_up"
    assert verdicts["host_dispatch"] == "scale_up"
