"""Fleet observability plane: the gang-wide fused view of serving workers.

A copy of the JAX package's ``obs/fleet.py``. The gateway owns a
:class:`FleetEngine` and a scrape thread: every ``SPARKDL_FLEET_SCRAPE_S``
it pulls each ready worker's ``/metrics``, ``/v1/slo`` (with the raw
windowed SLO counts) and ``/v1/models`` (whose ``utilization`` key is the
busy roll-up and ``memory`` key the device-memory ledger), and fuses them:

- **federated ``/metrics``**: the gateway's own registry plus every
  rank's cached exposition (worker lines carry a ``rank="N"`` label, so
  families never collide), plus per-rank staleness markers; a failed
  pull degrades to a stale-marked sample, never a 500.
- **fleet SLO fusion**: burn rates recomputed over the summed windowed
  counters across ranks, so a class burning fleet-wide trips here even
  when every worker sits under ``SPARKDL_SLO_MIN_REQUESTS``. Trips are
  sticky (``fleet.slo.alert.<class>``), and the JSONL alert and recovery
  events name the contributing ranks.
- **capacity headroom**: per-model achievable requests/s, each resident
  arm's observed rate scaled by 1 / its rank's ``util.busy_frac``
  (``fleet.headroom.<model>`` gauges). On the card ``busy_frac`` is the
  card's own kernel-busy share, from NVML (``obs/utilization.py``,
  ``busy_source: nvml``), so a host-bound worker does not read as
  saturated.
- **advisory recommender**: a scale_up / scale_down / rebalance / hold
  verdict re-derived every ``SPARKDL_FLEET_RECOMMEND_S``, with a
  ``{"kind": "fleet_recommendation"}`` JSONL event when it changes. It
  actuates nothing; the gateway's autoscaler (off by default) reads it.
- **HBM roll-up**: summed device/watermark/unattributed/leaked bytes and
  the remaining budget headroom (``fleet.mem.*``).

Read surfaces: ``GET /v1/fleet`` on the gateway (:meth:`FleetEngine.status`),
the fleet-sample ring in ``obs/timeseries.py`` and the fleet gauges on the
gateway's registry. One plain leaf lock guards the sample table and trip
state; HTTP pulls happen before it, JSONL and gauges after its release.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from sparkdl_tpu_torch.obs import slo as slo_mod
from sparkdl_tpu_torch.runtime import knobs
from sparkdl_tpu_torch.utils.metrics import metrics

#: headroom extrapolation floor: an arm observed at ~0 busy would
#: otherwise divide its rate by ~0 and claim near-infinite capacity
MIN_BUSY_FRAC = 0.05

#: per-rank busy-fraction spread past which the recommender calls the
#: gang imbalanced (one hot rank + one cold rank = routing/affinity
#: problem, not a capacity problem)
REBALANCE_SPREAD = 0.5


def fleet_scrape_s() -> float:
    """Scrape cadence (``SPARKDL_FLEET_SCRAPE_S``)."""
    return max(0.05, knobs.get_float("SPARKDL_FLEET_SCRAPE_S"))


def fleet_scrape_timeout_s() -> float:
    """Per-endpoint pull bound (``SPARKDL_FLEET_SCRAPE_TIMEOUT_S``)."""
    return max(0.1, knobs.get_float("SPARKDL_FLEET_SCRAPE_TIMEOUT_S"))


def fleet_stale_s() -> float:
    """Sample age past which a rank is stale (``SPARKDL_FLEET_STALE_S``)."""
    return max(0.1, knobs.get_float("SPARKDL_FLEET_STALE_S"))


def fleet_recommend_s() -> float:
    """Recommender cadence (``SPARKDL_FLEET_RECOMMEND_S``)."""
    return max(0.1, knobs.get_float("SPARKDL_FLEET_RECOMMEND_S"))


def scale_up_busy() -> float:
    return knobs.get_float("SPARKDL_FLEET_SCALE_UP_BUSY")


def scale_down_busy() -> float:
    return knobs.get_float("SPARKDL_FLEET_SCALE_DOWN_BUSY")


def _http_fetch(base_url: str, path: str, timeout: float) -> bytes:
    with urllib.request.urlopen(base_url + path, timeout=timeout) as resp:
        return resp.read()


class RankSample:
    """One rank's last-good scrape + freshness bookkeeping. A failed
    pull keeps the previous payloads (the last-good view is still the
    best available evidence) and lets ``age_s`` grow past the stale
    threshold — staleness, not absence, is the degradation signal."""

    __slots__ = (
        "rank", "generation", "ts", "metrics_text", "slo", "stats",
        "error", "counters",
    )

    def __init__(self, rank: int):
        self.rank = rank
        self.generation: Optional[int] = None
        self.ts: Optional[float] = None  # time.time() of last GOOD pull
        self.metrics_text: Optional[str] = None
        self.slo: Optional[dict] = None
        self.stats: Optional[dict] = None
        self.error: Optional[str] = None
        #: previous cycle's cumulative counters for rate derivation:
        #: {"ts", "completed", "models": {name: requests},
        #:  "classes": {cls: count}}
        self.counters: Optional[dict] = None

    def age_s(self, now: float) -> Optional[float]:
        return None if self.ts is None else max(0.0, now - self.ts)

    def stale(self, now: float) -> bool:
        age = self.age_s(now)
        return age is None or age > fleet_stale_s()


class FleetEngine:
    """Scrape-and-fuse engine the gateway owns. ``fetch`` is the HTTP
    pull (injectable for churn tests); every public method is safe to
    call from the gateway's handler threads."""

    def __init__(
        self,
        fetch: Optional[Callable[[str, str, float], bytes]] = None,
    ):
        self._fetch = fetch or _http_fetch
        self._lock = threading.Lock()  # leaf lock (trace-store discipline)
        self._samples: Dict[int, RankSample] = {}
        self._tripped: Dict[str, bool] = {}
        self._trip_info: Dict[str, dict] = {}
        self._fused: Optional[dict] = None
        self._recommendation: Optional[dict] = None

    # -- scrape cycle ---------------------------------------------------------

    def _pull(self, base_url: str) -> Tuple[Optional[dict], Optional[str]]:
        """One rank's three-endpoint pull; (payloads, error)."""
        timeout = fleet_scrape_timeout_s()
        try:
            text = self._fetch(base_url, "/metrics", timeout).decode()
            slo_reply = json.loads(
                self._fetch(base_url, "/v1/slo", timeout) or b"{}"
            )
            stats = json.loads(
                self._fetch(base_url, "/v1/models", timeout) or b"{}"
            )
        except Exception as e:  # refused/reset/timeout/torn JSON: degrade
            return None, f"{type(e).__name__}: {e}"
        return {"metrics": text, "slo": slo_reply, "stats": stats}, None

    def scrape_once(
        self, workers: List[dict], now: Optional[float] = None
    ) -> dict:
        """One scrape cycle over the gateway's worker-state snapshot
        (``workers``: the health poll's verdicts — this path never
        probes ``/healthz`` itself). Pulls run before the lock, fusion
        under it, gauge/JSONL emission after release. Returns the fused
        fleet view (also cached for :meth:`status`)."""
        t = time.time() if now is None else float(now)
        pulls: Dict[int, Tuple[Optional[dict], Optional[str], dict]] = {}
        for w in workers:
            if w.get("status") == "ready" and w.get("base_url"):
                payload, err = self._pull(w["base_url"])
                pulls[int(w["rank"])] = (payload, err, w)
            else:
                pulls[int(w["rank"])] = (None, None, w)
        with self._lock:
            fused, transitions = self._ingest_locked(pulls, t)
        for tr in transitions:
            self._emit_transition(tr)
        self._publish_gauges(fused)
        from sparkdl_tpu_torch.obs import timeseries

        timeseries.fleet_append(
            {
                "ts": round(t, 3),
                "ready_workers": fused["ready_workers"],
                "stale_workers": fused["stale_workers"],
                "busy_frac": fused["busy_frac"],
                "req_per_s": fused["req_per_s"],
                "tripped": sorted(
                    cls
                    for cls, st in fused["slo"]["classes"].items()
                    if st["tripped"]
                ),
                "stale_ranks": fused["stale_ranks"],
            }
        )
        return fused

    def _ingest_locked(
        self,
        pulls: Dict[int, Tuple[Optional[dict], Optional[str], dict]],
        now: float,
    ) -> Tuple[dict, List[dict]]:
        # prune ranks the gateway no longer tracks (gang resize)
        for rank in [r for r in self._samples if r not in pulls]:
            del self._samples[rank]
        for rank, (payload, err, w) in pulls.items():
            s = self._samples.get(rank)
            if s is None:
                s = self._samples[rank] = RankSample(rank)
            gen = int(w.get("generation", 0))
            if payload is not None:
                if s.generation is not None and s.generation != gen:
                    # a relaunched incarnation: its counters restart at
                    # zero — drop the rate baseline, keep nothing stale
                    s.counters = None
                s.generation = gen
                prev_counters = s.counters
                s.metrics_text = payload["metrics"]
                s.slo = payload["slo"]
                s.stats = payload["stats"]
                s.error = None
                s.counters = self._cumulative(payload["stats"], now)
                s.counters["rates"] = self._rates(
                    prev_counters, s.counters
                )
                s.ts = now
            elif err is not None:
                s.error = err
        fused = self._fuse_locked(now)
        transitions = self._transitions_locked(fused, now)
        self._fused = fused
        return fused, transitions

    @staticmethod
    def _cumulative(stats: dict, now: float) -> dict:
        return {
            "ts": now,
            "completed": float(stats.get("completed") or 0),
            "models": {
                m["name"]: float(m.get("requests") or 0)
                for m in stats.get("models") or []
                if m.get("name")
            },
            "classes": {
                cls: float((st or {}).get("count") or 0)
                for cls, st in (stats.get("latency") or {}).items()
            },
        }

    @staticmethod
    def _rates(prev: Optional[dict], cur: dict) -> dict:
        """Per-rank rates from two cumulative pulls; a negative delta
        (counter reset under an unseen restart) yields no rate rather
        than a poisoned one."""
        out: dict = {"completed_per_s": None, "models": {}, "classes": {}}
        if prev is None:
            return out
        dt = cur["ts"] - prev["ts"]
        if dt <= 0:
            return out

        def _rate(new: float, old: float) -> Optional[float]:
            d = new - old
            return None if d < 0 else d / dt

        out["completed_per_s"] = _rate(
            cur["completed"], prev["completed"]
        )
        for name, v in cur["models"].items():
            out["models"][name] = _rate(v, prev["models"].get(name, 0.0))
        for cls, v in cur["classes"].items():
            out["classes"][cls] = _rate(v, prev["classes"].get(cls, 0.0))
        return out

    # -- fusion ---------------------------------------------------------------

    def _fuse_locked(self, now: float) -> dict:
        fresh = [
            s
            for s in self._samples.values()
            if not s.stale(now) and s.stats is not None
        ]
        stale_ranks = sorted(
            s.rank
            for s in self._samples.values()
            if s.ts is not None and s.stale(now)
        )
        busy = {
            s.rank: (s.stats.get("utilization") or {}).get("busy_frac")
            for s in fresh
        }
        busy_vals = [v for v in busy.values() if v is not None]
        req_rates = [
            (s.counters or {}).get("rates", {}).get("completed_per_s")
            for s in fresh
        ]
        req_known = [v for v in req_rates if v is not None]
        per_model: Dict[str, dict] = {}
        per_class: Dict[str, dict] = {}
        headroom = self._headroom_locked(fresh, busy)
        for s in fresh:
            rates = (s.counters or {}).get("rates", {})
            for m in s.stats.get("models") or []:
                name = m.get("name")
                if not name:
                    continue
                agg = per_model.setdefault(
                    name, {"requests": 0, "req_per_s": None, "ranks": 0}
                )
                agg["requests"] += int(m.get("requests") or 0)
                agg["ranks"] += 1
                r = rates.get("models", {}).get(name)
                if r is not None:
                    agg["req_per_s"] = (agg["req_per_s"] or 0.0) + r
            for cls, st in (s.stats.get("latency") or {}).items():
                agg = per_class.setdefault(
                    cls, {"count": 0, "req_per_s": None, "p95_ms": None}
                )
                agg["count"] += int((st or {}).get("count") or 0)
                p95 = (st or {}).get("p95_ms")
                if p95 is not None:
                    agg["p95_ms"] = max(agg["p95_ms"] or 0.0, p95)
                r = rates.get("classes", {}).get(cls)
                if r is not None:
                    agg["req_per_s"] = (agg["req_per_s"] or 0.0) + r
        return {
            "ts": now,
            "ready_workers": len(fresh),
            "stale_workers": len(stale_ranks),
            "stale_ranks": stale_ranks,
            "busy_frac": (
                round(sum(busy_vals) / len(busy_vals), 4)
                if busy_vals
                else None
            ),
            "rank_busy": {
                r: (round(v, 4) if v is not None else None)
                for r, v in sorted(busy.items())
            },
            "req_per_s": (
                round(sum(req_known), 4) if req_known else None
            ),
            "models": per_model,
            "classes": per_class,
            "headroom": headroom,
            "memory": self._fuse_memory_locked(fresh),
            "slo": self._fuse_slo_locked(fresh),
        }

    @staticmethod
    def _fuse_memory_locked(
        fresh: List[RankSample],
    ) -> Optional[dict]:
        """Fleet HBM roll-up over each rank's ``/v1/models`` ``memory``
        key (the worker's reconciled device-memory ledger): summed
        tracked/watermark/unattributed/leaked bytes, per-model totals,
        and — where ranks report a budget — the fleet's remaining HBM
        headroom, the memory twin of the req/s headroom model. None
        when no fresh rank has a memory story to tell."""
        per_rank: Dict[int, dict] = {}
        for s in fresh:
            mem = (s.stats or {}).get("memory")
            if mem:
                per_rank[s.rank] = mem
        if not per_rank:
            return None
        device = watermark = leaked = unattr = 0
        unattr_known = False
        headroom: Optional[int] = None
        models: Dict[str, int] = {}
        for mem in per_rank.values():
            tracked = int(mem.get("tracked_bytes") or 0)
            device += tracked
            watermark += int(mem.get("watermark_bytes") or 0)
            leaked += int(mem.get("leaked_bytes") or 0)
            if mem.get("unattributed_bytes") is not None:
                unattr += int(mem["unattributed_bytes"])
                unattr_known = True
            budget = mem.get("budget_bytes")
            if budget:
                headroom = (headroom or 0) + max(
                    0, int(budget) - tracked
                )
            for name, b in (mem.get("models") or {}).items():
                models[name] = models.get(name, 0) + int(b or 0)
        return {
            "ranks": sorted(per_rank),
            "device_bytes": device,
            "watermark_bytes": watermark,
            "unattributed_bytes": unattr if unattr_known else None,
            "leaked_bytes": leaked,
            "headroom_bytes": headroom,
            "models": models,
        }

    def _headroom_locked(
        self, fresh: List[RankSample], busy: Dict[int, Optional[float]]
    ) -> Dict[str, dict]:
        """Per-model capacity model: each resident arm's observed
        requests/s scaled by 1/busy_frac is what that arm could sustain
        at saturation; the sum across ranks minus the observed sum is
        the headroom the autoscaler will read."""
        out: Dict[str, dict] = {}
        for s in fresh:
            rates = (s.counters or {}).get("rates", {})
            b = busy.get(s.rank)
            for m in s.stats.get("models") or []:
                name = m.get("name")
                r = rates.get("models", {}).get(name)
                if not name or r is None:
                    continue
                entry = out.setdefault(
                    name,
                    {
                        "observed_per_s": 0.0,
                        "achievable_per_s": 0.0,
                        "arms": [],
                    },
                )
                scale_b = max(b if b is not None else 1.0, MIN_BUSY_FRAC)
                entry["observed_per_s"] += r
                entry["achievable_per_s"] += r / scale_b
                entry["arms"].append(
                    {
                        "rank": s.rank,
                        "precision": m.get("precision"),
                        "mesh_width": m.get("mesh_width", 1),
                        "busy_frac": (
                            round(b, 4) if b is not None else None
                        ),
                        "req_per_s": round(r, 4),
                    }
                )
        for entry in out.values():
            entry["observed_per_s"] = round(entry["observed_per_s"], 4)
            entry["achievable_per_s"] = round(
                entry["achievable_per_s"], 4
            )
            entry["headroom_per_s"] = round(
                entry["achievable_per_s"] - entry["observed_per_s"], 4
            )
        return out

    def _fuse_slo_locked(self, fresh: List[RankSample]) -> dict:
        """Burn rates over the fleet-summed windowed counters. The
        gateway and its workers share one env, so the objective/threshold
        knobs read HERE are the ones each worker evaluated under."""
        armed_classes = [
            cls for cls in slo_mod.CLASSES if slo_mod.slo_armed(cls)
        ]
        if not armed_classes:
            return {"armed": False, "classes": {}}
        try:
            fast_thr = slo_mod.burn_fast_threshold()
            slow_thr = slo_mod.burn_slow_threshold()
            floor = slo_mod.min_requests()
        except ValueError as e:
            return {"armed": True, "error": str(e), "classes": {}}
        classes: Dict[str, dict] = {}
        for cls in armed_classes:
            sums = {
                k: 0.0
                for k in (
                    "ok_fast", "bad_fast", "slow_fast",
                    "ok_slow", "bad_slow", "slow_slow",
                )
            }
            ranks: List[int] = []
            exemplars: List[str] = []
            for s in fresh:
                wins = ((s.slo or {}).get("windows") or {}).get(cls)
                if wins is None:
                    continue
                contributed = False
                for k in sums:
                    v = float(wins.get(k) or 0)
                    sums[k] += v
                    if v and k in ("bad_fast", "slow_fast"):
                        contributed = True
                if contributed:
                    ranks.append(s.rank)
                    exemplars.extend(
                        ((s.slo or {}).get("exemplars") or {}).get(cls)
                        or []
                    )
            objectives: List[dict] = []
            try:
                avail = slo_mod.slo_avail_target(cls)
            except ValueError:
                avail = None
            if avail is not None:
                budget = 1.0 - avail
                total_f = sums["ok_fast"] + sums["bad_fast"]
                total_s = sums["ok_slow"] + sums["bad_slow"]
                objectives.append(
                    {
                        "objective": "availability",
                        "target": avail,
                        "fast_events": total_f,
                        "burn_fast": self._burn(
                            sums["bad_fast"], total_f, budget
                        ),
                        "burn_slow": self._burn(
                            sums["bad_slow"], total_s, budget
                        ),
                    }
                )
            try:
                target_s = slo_mod.slo_p95_target_s(cls)
            except ValueError:
                target_s = None
            if target_s is not None:
                objectives.append(
                    {
                        "objective": "latency_p95",
                        "target_ms": round(target_s * 1e3, 3),
                        "fast_events": sums["ok_fast"],
                        "burn_fast": self._burn(
                            sums["slow_fast"],
                            sums["ok_fast"],
                            slo_mod.P95_BUDGET,
                        ),
                        "burn_slow": self._burn(
                            sums["slow_slow"],
                            sums["ok_slow"],
                            slo_mod.P95_BUDGET,
                        ),
                    }
                )
            condition = False
            for obj in objectives:
                bf, bs = obj["burn_fast"], obj["burn_slow"]
                obj["tripping"] = (
                    bf is not None
                    and bs is not None
                    and bf >= fast_thr
                    and bs >= slow_thr
                    and obj["fast_events"] >= floor
                )
                condition = condition or obj["tripping"]
            classes[cls] = {
                "tripped": condition,
                "objectives": [
                    {
                        k: (round(v, 4) if isinstance(v, float) else v)
                        for k, v in obj.items()
                    }
                    for obj in objectives
                ],
                "ranks": ranks,
                "exemplar_trace_ids": exemplars[:8],
            }
        return {"armed": True, "classes": classes}

    @staticmethod
    def _burn(
        bad: float, total: float, budget: float
    ) -> Optional[float]:
        if total <= 0 or budget <= 0:
            return None
        return (bad / total) / budget

    def _transitions_locked(
        self, fused: dict, now: float
    ) -> List[dict]:
        """Apply sticky trip/recovery against the fused verdicts. A
        STALE gang (no fresh sample at all) evaluates nothing — silence
        must neither fabricate a fleet alert nor clear a real one."""
        transitions: List[dict] = []
        if not fused["slo"].get("armed") or fused["ready_workers"] == 0:
            return transitions
        for cls, st in fused["slo"]["classes"].items():
            was = self._tripped.get(cls, False)
            if st["tripped"] and not was:
                self._tripped[cls] = True
                hot = next(
                    o for o in st["objectives"] if o.get("tripping")
                )
                self._trip_info[cls] = {
                    "cls": cls,
                    "objective": hot["objective"],
                    "burn_fast": hot["burn_fast"],
                    "burn_slow": hot["burn_slow"],
                    "fast_events": hot["fast_events"],
                    "ranks": st["ranks"],
                    "exemplar_trace_ids": st["exemplar_trace_ids"],
                }
                transitions.append(
                    {"event": "trip", **self._trip_info[cls]}
                )
            elif was and not st["tripped"]:
                self._tripped[cls] = False
                info = self._trip_info.pop(cls, {"cls": cls})
                transitions.append({"event": "recovery", **info})
            st["tripped"] = self._tripped.get(cls, False)
        return transitions

    # -- emission (outside the engine lock) -----------------------------------

    def _emit_transition(self, tr: dict) -> None:
        from sparkdl_tpu_torch.obs.export import append_jsonl

        cls = tr["cls"]
        if tr["event"] == "trip":
            metrics.gauge(f"fleet.slo.alert.{cls}", 1)
            metrics.inc(f"fleet.slo.trips.{cls}")
            kind = "fleet_slo_alert"
        else:
            metrics.gauge(f"fleet.slo.alert.{cls}", 0)
            metrics.inc(f"fleet.slo.recoveries.{cls}")
            kind = "fleet_slo_recovery"
        append_jsonl(
            {
                "kind": kind,
                "ts": round(time.time(), 3),
                **{
                    k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in tr.items()
                    if k != "event"
                },
            }
        )

    def _publish_gauges(self, fused: dict) -> None:
        metrics.gauge("fleet.ready_workers", fused["ready_workers"])
        metrics.gauge("fleet.stale_workers", fused["stale_workers"])
        if fused["busy_frac"] is not None:
            metrics.gauge("fleet.busy_frac", fused["busy_frac"])
        if fused["req_per_s"] is not None:
            metrics.gauge("fleet.req_per_s", fused["req_per_s"])
        for name, agg in fused["models"].items():
            if agg["req_per_s"] is not None:
                metrics.gauge(
                    f"fleet.model.{name}.req_per_s",
                    round(agg["req_per_s"], 4),
                )
        for cls, agg in fused["classes"].items():
            if agg["req_per_s"] is not None:
                metrics.gauge(
                    f"fleet.class.{cls}.req_per_s",
                    round(agg["req_per_s"], 4),
                )
        for name, entry in fused["headroom"].items():
            metrics.gauge(
                f"fleet.headroom.{name}", entry["headroom_per_s"]
            )
        mem = fused.get("memory")
        if mem:
            metrics.gauge("fleet.mem.device_bytes", mem["device_bytes"])
            metrics.gauge(
                "fleet.mem.watermark_bytes", mem["watermark_bytes"]
            )
            metrics.gauge("fleet.mem.leaked_bytes", mem["leaked_bytes"])
            if mem["unattributed_bytes"] is not None:
                metrics.gauge(
                    "fleet.mem.unattributed_bytes",
                    mem["unattributed_bytes"],
                )
            if mem["headroom_bytes"] is not None:
                metrics.gauge(
                    "fleet.mem.headroom_bytes", mem["headroom_bytes"]
                )
        # sticky alert gauges published every cycle (not just on
        # transitions): an armed-but-healthy class reads 0, not absent
        for cls, st in fused["slo"].get("classes", {}).items():
            metrics.gauge(
                f"fleet.slo.alert.{cls}", 1 if st["tripped"] else 0
            )

    # -- federated /metrics ---------------------------------------------------

    def federated_text(
        self, gateway_text: str, now: Optional[float] = None
    ) -> str:
        """Gateway exposition + every rank's cached (rank-labeled)
        exposition + per-rank staleness markers. Duplicate ``# TYPE``
        lines across ranks are deduped (one declaration per family);
        sample lines never collide because worker lines carry the rank
        label."""
        now = time.time() if now is None else float(now)
        with self._lock:
            samples = sorted(
                self._samples.values(), key=lambda s: s.rank
            )
            parts: List[Tuple[int, Optional[str], Optional[float], bool]] = [
                (s.rank, s.metrics_text, s.age_s(now), s.stale(now))
                for s in samples
            ]
        lines = gateway_text.rstrip("\n").split("\n") if gateway_text else []
        seen_types = {
            ln for ln in lines if ln.startswith("# TYPE ")
        }
        for rank, text, age, stale in parts:
            for ln in (text or "").rstrip("\n").split("\n"):
                if not ln:
                    continue
                if ln.startswith("# TYPE "):
                    if ln in seen_types:
                        continue
                    seen_types.add(ln)
                lines.append(ln)
        stale_type = "# TYPE fleet_scrape_stale gauge"
        age_type = "# TYPE fleet_scrape_age_seconds gauge"
        for type_ln in (stale_type, age_type):
            if parts and type_ln not in seen_types:
                lines.append(type_ln)
        for rank, _text, age, stale in parts:
            lines.append(
                f'fleet_scrape_stale{{rank="{rank}"}} '
                f"{1 if stale else 0}"
            )
            if age is not None:
                lines.append(
                    f'fleet_scrape_age_seconds{{rank="{rank}"}} '
                    f"{age:.3f}"
                )
        return "\n".join(lines) + "\n"

    # -- recommender ----------------------------------------------------------

    def recommend_once(self, now: Optional[float] = None) -> Optional[dict]:
        """Derive the advisory verdict from the latest fused view and
        emit a ``fleet_recommendation`` JSONL event when it CHANGES
        (first verdict included). Pure advice: nothing here launches,
        kills, or re-routes anything."""
        t = time.time() if now is None else float(now)
        with self._lock:
            fused = self._fused
            prev = self._recommendation
        if fused is None:
            return None
        tripped = sorted(
            cls
            for cls, st in fused["slo"].get("classes", {}).items()
            if st["tripped"]
        )
        busy = fused["busy_frac"]
        busy_vals = [
            v for v in fused["rank_busy"].values() if v is not None
        ]
        spread = (
            max(busy_vals) - min(busy_vals) if len(busy_vals) > 1 else 0.0
        )
        if tripped:
            action, reason = "scale_up", (
                f"fleet SLO alert active for {', '.join(tripped)}"
            )
        elif busy is not None and busy >= scale_up_busy():
            action, reason = "scale_up", (
                f"fleet busy_frac {busy:.3f} >= "
                f"{scale_up_busy():g} (SPARKDL_FLEET_SCALE_UP_BUSY)"
            )
        elif spread > REBALANCE_SPREAD:
            action, reason = "rebalance", (
                f"per-rank busy_frac spread {spread:.3f} > "
                f"{REBALANCE_SPREAD:g}"
            )
        elif (
            busy is not None
            and busy <= scale_down_busy()
            and fused["ready_workers"] > 1
        ):
            action, reason = "scale_down", (
                f"fleet busy_frac {busy:.3f} <= "
                f"{scale_down_busy():g} (SPARKDL_FLEET_SCALE_DOWN_BUSY) "
                "with no alert active"
            )
        else:
            action, reason = "hold", "no actionable signal"
        rec = {
            "action": action,
            "reason": reason,
            "ts": round(t, 3),
            "evidence": {
                "busy_frac": busy,
                "ready_workers": fused["ready_workers"],
                "stale_ranks": fused["stale_ranks"],
                "req_per_s": fused["req_per_s"],
                "tripped_classes": tripped,
                "burns": {
                    cls: [
                        {
                            "objective": o["objective"],
                            "burn_fast": o["burn_fast"],
                            "burn_slow": o["burn_slow"],
                        }
                        for o in st["objectives"]
                    ]
                    for cls, st in fused["slo"]
                    .get("classes", {})
                    .items()
                },
                "headroom": {
                    name: entry["headroom_per_s"]
                    for name, entry in fused["headroom"].items()
                },
            },
        }
        with self._lock:
            self._recommendation = rec
        if prev is None or prev["action"] != action:
            from sparkdl_tpu_torch.obs.export import append_jsonl

            append_jsonl({"kind": "fleet_recommendation", **rec})
        return rec

    # -- oracles (routing + actuation read surfaces) --------------------------

    def recommendation(self) -> Optional[dict]:
        """The standing verdict (the autoscaler's actuation input) —
        exactly what ``status()`` reports, without the full payload."""
        with self._lock:
            return self._recommendation

    def rank_busy(self) -> Dict[int, Optional[float]]:
        """Latest per-rank ``util.busy_frac`` from the fused view — the
        affinity router's saturation/spill oracle. Empty before the
        first scrape."""
        with self._lock:
            fused = self._fused
        if not fused:
            return {}
        return dict(fused.get("rank_busy") or {})

    def resident_models(self) -> Dict[int, List[str]]:
        """Per-rank resident model names off the cached ``/v1/models``
        pulls — the affinity router's resident-set oracle (a spill
        prefers a rank that already paid the cold load)."""
        with self._lock:
            return {
                s.rank: sorted(
                    m["name"]
                    for m in (s.stats or {}).get("models") or []
                    if m.get("name")
                )
                for s in self._samples.values()
            }

    def tripped_classes(self) -> List[str]:
        """Currently-tripped fleet SLO classes (sticky verdicts) — the
        canary wave controller's advance/rollback gate."""
        with self._lock:
            fused = self._fused
        if not fused:
            return []
        return sorted(
            cls
            for cls, st in fused["slo"].get("classes", {}).items()
            if st["tripped"]
        )

    def canary_fleet(self) -> dict:
        """Fleet roll-up of each rank's canary split state (the
        ``canary`` key of the cached ``/v1/models`` pulls)."""
        with self._lock:
            per_rank = {
                s.rank: (s.stats or {}).get("canary")
                for s in self._samples.values()
            }
        per_rank = {r: c for r, c in per_rank.items() if c}
        return {
            "ranks": sorted(per_rank),
            "tripped_ranks": sorted(
                r for r, c in per_rank.items() if c.get("tripped")
            ),
            "requests": sum(
                int(c.get("requests") or 0) for c in per_rank.values()
            ),
            "failures": sum(
                int(c.get("failures") or 0) for c in per_rank.values()
            ),
        }

    # -- read surfaces --------------------------------------------------------

    def status(self, now: Optional[float] = None) -> dict:
        """The ``GET /v1/fleet`` payload: fused view + per-rank sample
        table + the standing recommendation."""
        t = time.time() if now is None else float(now)
        with self._lock:
            fused = self._fused
            rec = self._recommendation
            workers = []
            for s in sorted(self._samples.values(), key=lambda x: x.rank):
                age = s.age_s(t)
                rates = (s.counters or {}).get("rates", {})
                util = (
                    (s.stats or {}).get("utilization") or {}
                ).get("busy_frac")
                workers.append(
                    {
                        "rank": s.rank,
                        "generation": s.generation,
                        "stale": s.stale(t),
                        "age_s": round(age, 3) if age is not None else None,
                        "error": s.error,
                        "busy_frac": (
                            round(util, 4) if util is not None else None
                        ),
                        "req_per_s": rates.get("completed_per_s"),
                    }
                )
        from sparkdl_tpu_torch.obs import timeseries

        return {
            "scrape_s": fleet_scrape_s(),
            "stale_s": fleet_stale_s(),
            "workers": workers,
            "fused": fused,
            "recommendation": rec,
            "samples": len(timeseries.fleet_series()),
        }


__all__ = [
    "FleetEngine",
    "MIN_BUSY_FRAC",
    "REBALANCE_SPREAD",
    "RankSample",
    "fleet_recommend_s",
    "fleet_scrape_s",
    "fleet_scrape_timeout_s",
    "fleet_stale_s",
    "scale_down_busy",
    "scale_up_busy",
]
