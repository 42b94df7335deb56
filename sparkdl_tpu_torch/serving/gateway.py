"""Serving gateway: a supervised gang of serving workers behind one door.

The port of the JAX package's ``serving/gateway.py``. One thin HTTP
**gateway** fronts N **worker** processes, each running the port's
Router / residency / server stack through ``python -m
sparkdl_tpu_torch.serving worker``. On one card the workers share the
device: each has its own CUDA context, caching allocator and launch
thread, and their kernels time-slice. What the gang buys is survival:

- **supervision**: the workers run under
  :class:`~sparkdl_tpu_torch.resilience.supervisor.GangSupervisor`
  (liveness by ``Popen.poll``, wedges by the generation-tagged heartbeat
  files each worker writes into the gang dir). A dead worker restarts the
  gang into a new generation; ``complete_on_exit0=False`` makes even a
  clean exit relaunch (exit after a drain is the rolling-restart path).
- **readiness routing**: a health thread polls each worker's
  generation-tagged port file and ``/healthz``; requests go only to ready
  workers (``draining``/``down``/``starting`` are routed around). State
  changes land in ``{"kind": "gateway"}`` JSONL events and the
  ``gateway.ready_workers`` gauge.
- **no lost accepted request**: a request stranded on a dying worker (a
  transport error mid-forward) or refused by a draining one (503) is
  re-dispatched to another ready worker under a RetryPolicy
  (``SPARKDL_GATEWAY_RETRY_*``) whose deadline
  (``SPARKDL_GATEWAY_PENDING_S``, default 30 s) covers the supervisor's
  kill -> backoff -> relaunch window, the relaunched worker's torch
  import, CUDA context and first model load included. Inference is pure,
  so a re-dispatch is safe.
- **model-affinity routing** (``SPARKDL_GATEWAY_AFFINITY=1``, off by
  default): the placement key ``(model, precision, mesh)``
  consistent-hashes onto a ring of ready workers, spilling past
  draining/down ranks and ranks the fleet scrape reports saturated
  (``util.busy_frac >= SPARKDL_GATEWAY_SPILL_BUSY``; on the card the
  card's NVML kernel-busy share, ``obs/utilization.py``). The port's
  programs run on one device, so the key's mesh width is 1.
- **elasticity**: :meth:`ServingGateway.resize` grows or shrinks the gang
  through the normal verbs, and ``SPARKDL_FLEET_AUTOSCALE=1`` turns the
  fleet engine's scale_up/scale_down advice into ``resize`` calls under
  hysteresis (``SPARKDL_FLEET_COOLDOWN_S``, ``SPARKDL_FLEET_MIN/MAX_WORKERS``).
- **canary waves**: the split itself lives in each worker's Router (the
  ``SPARKDL_SERVE_CANARY_*`` knobs ride the launch env);
  ``SPARKDL_SERVE_CANARY_WAVES`` adds the burn-gated wave controller,
  which pushes each wave's weight to every worker's ``/admin/canary`` while
  the fused fleet burn is clean and rolls back to 0 (sticky) on a trip.

``device`` and ``seed`` are passed to every worker (``--device``,
``--seed``): every worker draws the same random weights, so any worker's
reply is the same model's. Without a card and without ``device="cpu"`` a
worker exits non-zero naming the missing device; the supervisor counts a
failed rank and ``/healthz`` never reads ok.

Endpoints: ``POST /v1/predict`` (forwarded; a streamed
``mode="generate"`` body is the one the gateway inspects, and its chunked
ndjson reply passes through line by line, re-dispatched only before the
first streamed byte), ``GET /healthz`` (ok when >= 1 worker is ready),
``GET /v1/workers`` (the gang table), ``GET /v1/models`` / ``/v1/slo`` /
``/v1/memory`` (forwarded to one ready worker), ``GET /v1/fleet`` (the
fused fleet view, ``obs/fleet.py``), ``GET /metrics`` (federated),
``POST /admin/drain`` (body ``{"rank": N}``, a pinned forward) and ``POST
/admin/profile`` (body ``{"rank": N, "seconds": S}``, a pinned forward of
the worker's ``torch.profiler`` capture; S at most the forward timeout
less 5 s, else 400).

CLI: ``python -m sparkdl_tpu_torch.serving gateway --workers 2 --port 8000``.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Set, Tuple

from sparkdl_tpu_torch.obs.fleet import (
    FleetEngine,
    fleet_recommend_s,
    fleet_scrape_s,
)
from sparkdl_tpu_torch.obs.trace import (
    TRACE_HEADER,
    coerce_trace_id,
    record_gateway_trace,
)
from sparkdl_tpu_torch.resilience.policy import policy_from_env
from sparkdl_tpu_torch.resilience.supervisor import (
    GENERATION_ENV,
    GangFailedError,
    GangSupervisor,
)
from sparkdl_tpu_torch.runtime import knobs, locksmith
from sparkdl_tpu_torch.serving.request import PRIORITY_CLASSES
from sparkdl_tpu_torch.serving.server import (
    bind_address,
    retry_after_s,
    send_json,
    send_raw,
)
from sparkdl_tpu_torch.utils.metrics import metrics


def gateway_workers() -> int:
    """Gang size (``SPARKDL_GATEWAY_WORKERS``, default 2)."""
    return max(1, knobs.get_int("SPARKDL_GATEWAY_WORKERS"))


def health_interval_s() -> float:
    """Readiness poll cadence (``SPARKDL_GATEWAY_HEALTH_S``)."""
    return max(0.05, knobs.get_float("SPARKDL_GATEWAY_HEALTH_S"))


def pending_s() -> float:
    """How long one request may wait for a ready worker
    (``SPARKDL_GATEWAY_PENDING_S``) — sized to cover a supervisor
    relaunch, not just a routing blip."""
    return max(0.1, knobs.get_float("SPARKDL_GATEWAY_PENDING_S"))


def forward_timeout_s() -> float:
    """Per-attempt bound on a forwarded request
    (``SPARKDL_GATEWAY_FORWARD_TIMEOUT_S``)."""
    return knobs.get_float("SPARKDL_GATEWAY_FORWARD_TIMEOUT_S")


def affinity_enabled() -> bool:
    """Model-affinity routing on/off (``SPARKDL_GATEWAY_AFFINITY``,
    default OFF — the round-robin cursor is the legacy arm)."""
    return knobs.get_flag("SPARKDL_GATEWAY_AFFINITY")


def affinity_replicas() -> int:
    """Virtual nodes per rank on the affinity hash ring
    (``SPARKDL_GATEWAY_AFFINITY_REPLICAS``)."""
    return max(1, knobs.get_int("SPARKDL_GATEWAY_AFFINITY_REPLICAS"))


def spill_busy() -> float:
    """Scraped ``util.busy_frac`` at/above which an affinity-preferred
    rank counts saturated (``SPARKDL_GATEWAY_SPILL_BUSY``)."""
    return knobs.get_float("SPARKDL_GATEWAY_SPILL_BUSY")


def canary_waves() -> Optional[List[float]]:
    """The wave controller's weight schedule
    (``SPARKDL_SERVE_CANARY_WAVES``, comma-separated floats clamped to
    [0, 1]); None when unset (no wave controller)."""
    raw = knobs.get_str("SPARKDL_SERVE_CANARY_WAVES")
    if not raw:
        return None
    out: List[float] = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            w = float(part)
        except ValueError:
            raise ValueError(
                f"SPARKDL_SERVE_CANARY_WAVES entry {part!r} is not "
                "numeric"
            ) from None
        out.append(min(1.0, max(0.0, w)))
    return out or None


def _ring_hash(s: str) -> int:
    """Stable 64-bit ring position. blake2b, not ``hash()``: Python's
    string hash is per-process salted, and ring positions must agree
    across gateway restarts for the placement to be a fleet property."""
    return int.from_bytes(
        hashlib.blake2b(s.encode(), digest_size=8).digest(), "big"
    )


class AffinityRing:
    """Consistent-hash ring over worker ranks with ``replicas`` virtual
    nodes per rank. Vnode positions hash ``"{rank}#{i}"`` ONLY — no
    generation, no port — so a rank that dies and relaunches re-occupies
    exactly its old positions, and adding/removing one rank moves only
    that rank's share of the keyspace (the consistent-hashing property
    the churn tests pin)."""

    __slots__ = ("ranks", "replicas", "_hashes", "_owners")

    def __init__(self, ranks, replicas: int):
        self.ranks: Tuple[int, ...] = tuple(sorted(set(int(r) for r in ranks)))
        self.replicas = int(replicas)
        points = sorted(
            (_ring_hash(f"{rank}#{i}"), rank)
            for rank in self.ranks
            for i in range(self.replicas)
        )
        self._hashes = [h for h, _ in points]
        self._owners = [r for _, r in points]

    def order(self, key: Tuple) -> List[int]:
        """Distinct ranks in clockwise ring-walk order from ``key``'s
        position: the first entry is the key's home rank, the rest are
        its spill sequence."""
        if not self._hashes:
            return []
        h = _ring_hash("|".join(str(p) for p in key))
        start = bisect.bisect_right(self._hashes, h)
        out: List[int] = []
        seen: Set[int] = set()
        n = len(self._hashes)
        for j in range(n):
            r = self._owners[(start + j) % n]
            if r not in seen:
                seen.add(r)
                out.append(r)
                if len(out) == len(self.ranks):
                    break
        return out


def placement_key(body: Optional[bytes]) -> Optional[Tuple[str, str, int]]:
    """The affinity placement key ``(model, precision, mesh)`` from one
    predict body — parsed only when affinity routing is ON (with it off
    the gateway inspects nothing beyond :func:`wants_stream`). The
    precision/mesh arms ride the key because each arm is a distinct
    resident entry worker-side: ``m@bf16`` on rank 0 does not make
    ``m@f32`` warm there. None (fall back to round-robin) for bodies
    with no usable model — the worker 400s those anyway."""
    try:
        parsed = json.loads(body or b"{}")
    except Exception:
        return None
    if not isinstance(parsed, dict) or not parsed.get("model"):
        return None
    from sparkdl_tpu_torch.graph.precision import serve_precision

    priority = parsed.get("priority")
    if priority not in PRIORITY_CLASSES:
        priority = None
    try:
        precision = serve_precision(priority)
    except ValueError:
        precision = "f32"  # a typo'd rung fails at the worker, loudly
    # the port's programs run on one device: mesh width 1, the JAX
    # package's key with SPARKDL_SERVE_MESH_WIDTH unset
    return (str(parsed["model"]), precision, 1)


def wants_stream(body: bytes) -> bool:
    """True when the request body asks for a streamed generation —
    the ONLY body the gateway ever inspects (one ``json.loads``); every
    other predict forwards blind."""
    try:
        parsed = json.loads(body or b"{}")
    except Exception:
        return False  # malformed: forward blind, the worker 400s it
    return (
        isinstance(parsed, dict)
        and parsed.get("mode") == "generate"
        and bool(parsed.get("stream"))
    )


def _begin_stream_reply(handler, trace_id: str, content_type: str) -> None:
    """Start the client-side chunked reply (mirrors the worker
    server's ``_begin_stream``)."""
    handler.send_response(200)
    handler.send_header("Content-Type", content_type)
    handler.send_header("Transfer-Encoding", "chunked")
    handler.send_header(TRACE_HEADER, trace_id)
    handler.end_headers()


def _chunk_raw(handler, data: bytes) -> None:
    handler.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
    handler.wfile.flush()


def _end_chunks(handler) -> None:
    handler.wfile.write(b"0\r\n\r\n")
    handler.wfile.flush()


def port_file(gang_dir: str, rank: int) -> str:
    """Where worker ``rank`` publishes its bound port (JSON with
    ``rank``/``port``/``pid``/``generation``, written tmp+rename like a
    heartbeat so the gateway never reads a torn file)."""
    return os.path.join(gang_dir, f"port.{int(rank)}")


class WorkerState:
    """One worker's last-observed routing state."""

    __slots__ = ("rank", "generation", "port", "pid", "status", "base_url")

    def __init__(self, rank: int, generation: int):
        self.rank = rank
        self.generation = generation
        self.port: Optional[int] = None
        self.pid: Optional[int] = None
        #: starting | ready | draining | down
        self.status = "starting"
        self.base_url: Optional[str] = None

    def as_dict(self) -> dict:
        return {
            "rank": self.rank,
            "generation": self.generation,
            "port": self.port,
            "pid": self.pid,
            "status": self.status,
        }


class ServingGateway:
    """Supervised serving gang + the HTTP front door that routes into it.

    ``loader_spec`` is a ``pkg.mod:fn`` string resolved inside each
    worker (``fn(name, mode[, precision]) -> ModelFunction``, given the
    worker's ``device`` and ``seed`` as keywords when it takes them); None
    means the named-model registry. ``extra_env`` rides into every worker
    launch (canary knobs, fault plans for chaos runs). ``device``: every
    worker's device (``cuda`` when None); ``seed``: every worker's weight
    seed."""

    def __init__(
        self,
        num_workers: Optional[int] = None,
        port: int = 0,
        gang_dir: Optional[str] = None,
        loader_spec: Optional[str] = None,
        budget_mb: Optional[float] = None,
        max_batch: Optional[int] = None,
        extra_env: Optional[dict] = None,
        restart_policy=None,
        stale_after: float = 15.0,
        poll_interval: float = 0.2,
        drain_wait_s: Optional[float] = None,
        device: Optional[str] = None,
        seed: int = 0,
    ):
        self.num_workers = num_workers or gateway_workers()
        self.device = device
        self.seed = int(seed)
        self._port_arg = int(port)
        self.gang_dir = gang_dir or tempfile.mkdtemp(prefix="sparkdl_gang_")
        self.loader_spec = loader_spec
        self.budget_mb = budget_mb
        self.max_batch = max_batch
        self.extra_env = dict(extra_env or {})
        self._drain_wait_s = (
            float(drain_wait_s)
            if drain_wait_s is not None
            else knobs.get_float("SPARKDL_SERVE_DRAIN_TIMEOUT_S")
        )
        self._states_cv = locksmith.condition(
            "sparkdl_tpu_torch/serving/gateway.py::ServingGateway._states_cv"
        )
        self._states: Dict[int, WorkerState] = {}
        self._generation = 0
        self._rr = 0  # round-robin cursor over ready workers
        self._gang_error: Optional[str] = None
        self._stop = threading.Event()
        self._started = False
        self._restarts_base = metrics.counter("supervisor.restarts")
        self._sup = GangSupervisor(
            self._launch_worker,
            self.num_workers,
            heartbeat_dir=self.gang_dir,
            stale_after=stale_after,
            poll_interval=poll_interval,
            # TERM must leave room for the worker's graceful drain
            # before the KILL escalation strands accepted requests
            kill_wait_s=self._drain_wait_s + 5.0,
            restart_policy=restart_policy,
            complete_on_exit0=False,
            on_generation=self._on_generation,
        )
        self._sup_thread: Optional[threading.Thread] = None
        self._health_thread: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        # the fleet observability plane (obs/fleet.py): scrape + fuse
        # every ready worker's /metrics + /v1/slo + /v1/models into the
        # federated view behind GET /v1/fleet and the fleet gauges
        self.fleet = FleetEngine()
        self._fleet_thread: Optional[threading.Thread] = None
        self._recommend_thread: Optional[threading.Thread] = None
        #: affinity ring cache, rebuilt when the ready set or replica
        #: count changes (guarded by _states_cv like the states it maps)
        self._ring: Optional[AffinityRing] = None
        #: autoscaler state: last actuation clock (hysteresis) — only
        #: the autoscale thread touches it
        self._last_scale_t: Optional[float] = None
        self._autoscale_thread: Optional[threading.Thread] = None
        #: canary wave controller state: current wave index (-1 = not
        #: started) and the sticky rollback latch — only the canary
        #: thread (or test-driven canary_wave_once calls) touch them
        self._canary_wave = -1
        self._canary_rolled_back = False
        self._canary_thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ServingGateway":
        if self._started:
            return self
        self._started = True
        os.makedirs(self.gang_dir, exist_ok=True)
        self._sup_thread = threading.Thread(
            target=self._supervise,
            name="sparkdl-gateway-supervise",
            daemon=True,
        )
        self._sup_thread.start()
        self._health_thread = threading.Thread(
            target=self._health_loop,
            name="sparkdl-gateway-health",
            daemon=True,
        )
        self._health_thread.start()
        self._httpd = ThreadingHTTPServer(
            (bind_address(), self._port_arg), _GatewayHandler
        )
        self._httpd.daemon_threads = True
        self._httpd.gateway = self  # type: ignore[attr-defined]
        self.port = int(self._httpd.server_address[1])
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"sparkdl-gateway-http-{self.port}",
            daemon=True,
        )
        self._http_thread.start()
        self._fleet_thread = threading.Thread(
            target=self._fleet_loop,
            name="sparkdl-gateway-fleet",
            daemon=True,
        )
        self._fleet_thread.start()
        self._recommend_thread = threading.Thread(
            target=self._recommend_loop,
            name="sparkdl-gateway-recommend",
            daemon=True,
        )
        self._recommend_thread.start()
        if knobs.get_flag("SPARKDL_FLEET_AUTOSCALE"):
            self._autoscale_thread = threading.Thread(
                target=self._autoscale_loop,
                name="sparkdl-gateway-autoscale",
                daemon=True,
            )
            self._autoscale_thread.start()
        if canary_waves():
            self._canary_thread = threading.Thread(
                target=self._canary_loop,
                name="sparkdl-gateway-canary",
                daemon=True,
            )
            self._canary_thread.start()
        return self

    def stop(self) -> None:
        """Graceful gang shutdown: supervision ends (TERM -> workers
        drain accepted work -> exit), THEN the front door closes — a
        request already forwarded still gets its answer."""
        if not self._started:
            return
        self._stop.set()
        self._sup.request_stop()
        if self._sup_thread is not None:
            self._sup_thread.join(timeout=self._drain_wait_s + 15.0)
            self._sup_thread = None
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)
            self._health_thread = None
        if self._fleet_thread is not None:
            self._fleet_thread.join(timeout=5.0)
            self._fleet_thread = None
        if self._recommend_thread is not None:
            self._recommend_thread.join(timeout=5.0)
            self._recommend_thread = None
        if self._autoscale_thread is not None:
            self._autoscale_thread.join(timeout=5.0)
            self._autoscale_thread = None
        if self._canary_thread is not None:
            self._canary_thread.join(timeout=5.0)
            self._canary_thread = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._http_thread is not None:
            self._http_thread.join(timeout=5.0)
            self._http_thread = None
        metrics.gauge("gateway.ready_workers", 0)

    # -- worker launch / supervision ----------------------------------------

    def _worker_argv(self, rank: int) -> List[str]:
        argv = [
            sys.executable, "-m", "sparkdl_tpu_torch.serving", "worker",
            "--rank", str(rank),
            "--gang-dir", self.gang_dir,
            "--port", "0",
            "--seed", str(self.seed),
        ]
        if self.device is not None:
            argv += ["--device", str(self.device)]
        if self.loader_spec:
            argv += ["--loader", self.loader_spec]
        if self.budget_mb is not None:
            argv += ["--budget-mb", str(self.budget_mb)]
        if self.max_batch is not None:
            argv += ["--max-batch", str(self.max_batch)]
        return argv

    def _launch_worker(self, rank: int, generation: int) -> subprocess.Popen:
        env = {
            **os.environ,
            **self.extra_env,
            GENERATION_ENV: str(generation),
            "SPARKDL_OBS_RANK": str(rank),
        }
        # per-rank log, appended across generations: the post-mortem for
        # a crash loop is one file per worker, not a lost DEVNULL
        log = open(
            os.path.join(self.gang_dir, f"worker.{rank}.log"), "ab"
        )
        try:
            return subprocess.Popen(
                self._worker_argv(rank), env=env, stdout=log, stderr=log
            )
        finally:
            log.close()  # the child holds its own descriptor

    def _on_generation(self, generation: int, procs) -> None:
        """Supervisor hook: a new gang generation launched — every
        cached port/readiness verdict is now about dead processes."""
        with self._states_cv:
            self._generation = generation
            self._states = {
                r: WorkerState(r, generation) for r in range(self.num_workers)
            }
            self._states_cv.notify_all()
        metrics.gauge("gateway.ready_workers", 0)

    def _supervise(self) -> None:
        try:
            self._sup.run()
        except GangFailedError as e:
            self._gang_error = str(e)
            self._emit_event("gang_failed", error=str(e))
            with self._states_cv:
                for ws in self._states.values():
                    ws.status = "down"
                self._states_cv.notify_all()
            metrics.gauge("gateway.ready_workers", 0)
        except Exception as e:  # noqa: BLE001 — supervision must not die silently
            self._gang_error = f"{type(e).__name__}: {e}"
            self._emit_event("supervisor_error", error=self._gang_error)

    @property
    def generation(self) -> int:
        with self._states_cv:
            return self._generation

    def restarts(self) -> int:
        return int(
            metrics.counter("supervisor.restarts") - self._restarts_base
        )

    # -- health / readiness --------------------------------------------------

    def _health_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._poll_health_once()
            except Exception:
                pass  # a probe bug must not kill readiness tracking
            self._stop.wait(health_interval_s())

    def _read_port_file(self, rank: int, generation: int) -> Optional[dict]:
        try:
            with open(port_file(self.gang_dir, rank)) as f:
                info = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if int(info.get("generation", -1)) != generation:
            return None  # a previous incarnation's port: not this gang
        return info

    def _probe_health(self, base_url: str) -> str:
        """'ready' | 'draining' | 'down' from one /healthz probe."""
        try:
            with urllib.request.urlopen(
                base_url + "/healthz", timeout=2.0
            ) as resp:
                payload = json.loads(resp.read() or b"{}")
        except Exception:
            return "down"
        return (
            "draining" if payload.get("status") == "draining" else "ready"
        )

    def _worker_snapshot(self) -> List[dict]:
        """One consistent worker-state snapshot (rank, generation,
        status, base_url) — the SHARED read both the health poll and
        the fleet scrape cycle start from, so the scrape consumes the
        poll's verdicts instead of double-probing ``/healthz``."""
        with self._states_cv:
            return [
                {
                    "rank": ws.rank,
                    "generation": ws.generation,
                    "status": ws.status,
                    "base_url": ws.base_url,
                }
                for ws in self._states.values()
            ]

    def _poll_health_once(self) -> None:
        snapshot = self._worker_snapshot()
        generation = (
            snapshot[0]["generation"] if snapshot else self.generation
        )
        ranks = [w["rank"] for w in snapshot]
        verdicts: Dict[int, tuple] = {}
        for rank in ranks:
            info = self._read_port_file(rank, generation)
            if info is None:
                verdicts[rank] = ("starting", None, None)
                continue
            base_url = f"http://127.0.0.1:{int(info['port'])}"
            verdicts[rank] = (
                self._probe_health(base_url),
                info,
                base_url,
            )
        transitions = []
        with self._states_cv:
            if self._generation != generation:
                return  # a relaunch raced the probes: verdicts are stale
            for rank, (status, info, base_url) in verdicts.items():
                ws = self._states.get(rank)
                if ws is None:
                    continue
                if info is not None:
                    ws.port = int(info["port"])
                    ws.pid = info.get("pid")
                    ws.base_url = base_url
                if ws.status != status:
                    transitions.append((rank, ws.status, status))
                    ws.status = status
            ready = sum(
                1 for ws in self._states.values() if ws.status == "ready"
            )
            if transitions:
                self._states_cv.notify_all()
        metrics.gauge("gateway.ready_workers", ready)
        for rank, old, new in transitions:
            self._emit_event(
                f"worker_{new}", rank=rank, generation=generation, was=old
            )

    # -- fleet observability plane -------------------------------------------

    def _fleet_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.fleet.scrape_once(self._worker_snapshot())
            except Exception:
                pass  # a scrape bug must not kill the fleet view
            self._stop.wait(fleet_scrape_s())

    def _recommend_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.fleet.recommend_once()
            except Exception:
                pass  # advice must never break anything
            self._stop.wait(fleet_recommend_s())

    def fleet_status(self) -> dict:
        """The ``GET /v1/fleet`` payload."""
        return self.fleet.status()

    def federated_metrics_text(self) -> str:
        """Gateway registry + every rank's cached rank-labeled
        exposition + staleness markers — the gateway's ``/metrics``."""
        from sparkdl_tpu_torch.obs.export import prometheus_text

        return self.fleet.federated_text(prometheus_text())

    def _emit_event(self, event: str, **fields) -> None:
        try:
            from sparkdl_tpu_torch.obs.export import append_jsonl

            append_jsonl(
                {
                    "kind": "gateway",
                    "event": event,
                    "ts": round(time.time(), 3),
                    **fields,
                }
            )
        except Exception:
            pass  # event export must never break routing

    def _mark(self, ws: WorkerState, status: str) -> None:
        """Demote a worker the FORWARD path caught misbehaving (the
        health poll will promote it back when it answers again)."""
        changed = False
        with self._states_cv:
            cur = self._states.get(ws.rank)
            if (
                cur is ws
                and cur.generation == self._generation
                and cur.status != status
            ):
                cur.status = status
                changed = True
                self._states_cv.notify_all()
        if changed:
            self._emit_event(
                f"worker_{status}", rank=ws.rank, generation=ws.generation,
                via="forward",
            )

    # -- elasticity: resize + the autoscale control loop ---------------------

    def resize(self, n: int) -> dict:
        """Resize the gang to ``n`` workers through the normal verbs.

        Grow: new WorkerStates are registered first (so the health poll
        adopts the ranks the moment their port files land), then the
        supervisor launches them through the ordinary launch path.
        Shrink: each victim gets a pinned ``/admin/drain`` forward (it
        flips to ``draining``, so routing stops immediately while
        accepted work completes), then the supervisor retires the
        process (SIGTERM -> graceful drain -> exit 0, never counted as
        a gang death), then the state entry is dropped."""
        n = int(n)
        if n < 1:
            raise ValueError("resize target must be >= 1")
        with self._states_cv:
            old = self.num_workers
            generation = self._generation
        if n == old:
            return {"from": old, "to": n, "generation": generation}
        if n > old:
            with self._states_cv:
                generation = self._generation
                for rank in range(old, n):
                    self._states[rank] = WorkerState(rank, generation)
                self.num_workers = n
                self._states_cv.notify_all()
            self._sup.resize(n)
        else:
            victims = list(range(n, old))
            for rank in victims:
                try:
                    self.forward("/admin/drain", b"{}", rank=rank)
                except Exception:
                    pass  # a dead victim is already out of rotation
            # retire BEFORE the drained worker's exit(0) lands, so the
            # supervisor never mistakes the planned exit for gang death
            self._sup.resize(n)
            with self._states_cv:
                for rank in victims:
                    self._states.pop(rank, None)
                self.num_workers = n
                self._ring = None
                self._states_cv.notify_all()
        self._emit_event(
            "resize", **{"from": old, "to": n}, generation=generation
        )
        metrics.gauge("gateway.target_workers", n)
        return {"from": old, "to": n, "generation": generation}

    def _autoscale_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.autoscale_once()
            except Exception:
                pass  # an actuation bug must not kill the control loop
            self._stop.wait(fleet_recommend_s())

    def autoscale_once(self, now: Optional[float] = None) -> Optional[dict]:
        """One autoscaler tick: the fleet engine's standing verdict ->
        hysteresis (``SPARKDL_FLEET_COOLDOWN_S``) + bounds
        (``SPARKDL_FLEET_MIN/MAX_WORKERS``) -> one-step ``resize``.
        Every actuation lands as a ``fleet_scale`` JSONL event carrying
        the recommendation's evidence. Returns the event when it acted,
        None when it held (no verdict, cooldown, or at a bound)."""
        rec = self.fleet.recommendation()
        if not rec or rec.get("action") not in ("scale_up", "scale_down"):
            return None
        now = time.monotonic() if now is None else float(now)
        cooldown = knobs.get_float("SPARKDL_FLEET_COOLDOWN_S")
        if (
            self._last_scale_t is not None
            and now - self._last_scale_t < cooldown
        ):
            return None
        lo = max(1, knobs.get_int("SPARKDL_FLEET_MIN_WORKERS"))
        hi = max(lo, knobs.get_int("SPARKDL_FLEET_MAX_WORKERS"))
        cur = self.num_workers
        step = 1 if rec["action"] == "scale_up" else -1
        target = min(hi, max(lo, cur + step))
        if target == cur:
            return None
        self._last_scale_t = now
        self.resize(target)
        metrics.inc(f"gateway.autoscale.{rec['action']}")
        event = {
            "kind": "fleet_scale",
            "ts": round(time.time(), 3),
            "action": rec["action"],
            "from": cur,
            "to": target,
            "reason": rec.get("reason"),
            "evidence": rec.get("evidence"),
        }
        try:
            from sparkdl_tpu_torch.obs.export import append_jsonl

            append_jsonl(event)
        except Exception:
            pass  # the actuation already happened; export is best-effort
        return event

    # -- burn-rate-driven canary waves ---------------------------------------

    def _canary_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.canary_wave_once()
            except Exception:
                pass  # a wave bug must not kill serving
            self._stop.wait(
                knobs.get_float("SPARKDL_SERVE_CANARY_WAVE_S")
            )

    def canary_wave_once(self) -> Optional[dict]:
        """One wave tick of the burn-gated rollout controller.

        While the fused fleet burn is clean (no tripped fleet SLO
        class, no per-rank canary trip), the rollout advances one wave
        per dwell through the ``SPARKDL_SERVE_CANARY_WAVES`` schedule,
        pushing the wave's weight to every ready worker (the re-push
        each tick also covers relaunched workers, whose routers boot
        back at the env-knob weight). A dirty burn mid-rollout rolls
        the weight back to 0 everywhere and latches — no further waves
        this gateway. Returns the emitted ``canary_wave`` event, or
        None on a steady-state tick."""
        waves = canary_waves()
        if not waves or self._canary_rolled_back:
            return None
        dirty = bool(self.fleet.tripped_classes()) or bool(
            self.fleet.canary_fleet().get("tripped_ranks")
        )
        if dirty:
            if self._canary_wave < 0:
                return None  # never start a rollout into an alerting fleet
            self._canary_rolled_back = True
            pushed = self._push_canary_weight(0.0)
            event = {
                "kind": "canary_wave",
                "ts": round(time.time(), 3),
                "event": "rollback",
                "wave": self._canary_wave,
                "weight": 0.0,
                "pushed_ranks": pushed,
                "tripped_classes": self.fleet.tripped_classes(),
                "canary": self.fleet.canary_fleet(),
            }
        else:
            advanced = False
            if self._canary_wave + 1 < len(waves):
                self._canary_wave += 1
                advanced = True
            weight = waves[self._canary_wave]
            pushed = self._push_canary_weight(weight)
            if not advanced:
                return None  # terminal wave held: re-push is maintenance
            event = {
                "kind": "canary_wave",
                "ts": round(time.time(), 3),
                "event": "advance",
                "wave": self._canary_wave,
                "weight": weight,
                "pushed_ranks": pushed,
            }
        try:
            from sparkdl_tpu_torch.obs.export import append_jsonl

            append_jsonl(event)
        except Exception:
            pass
        return event

    def _push_canary_weight(self, weight: float) -> List[int]:
        """Pinned ``/admin/canary`` forward to every ready worker;
        returns the ranks that acknowledged."""
        body = json.dumps({"weight": float(weight)}).encode()
        pushed: List[int] = []
        for w in self._worker_snapshot():
            if w["status"] != "ready" or not w["base_url"]:
                continue
            try:
                code, _, _ = self.forward(
                    "/admin/canary", body, rank=w["rank"]
                )
            except Exception:
                continue
            if code == 200:
                pushed.append(w["rank"])
        return pushed

    def _pick_ready(
        self,
        exclude: Set[int],
        deadline: float,
        placement: Optional[Tuple[str, str, int]] = None,
    ) -> Optional[WorkerState]:
        """Pick a ready worker, waiting (up to ``deadline``) for one to
        appear — the wait IS the relaunch window. With ``placement``
        (affinity routing on), the request consistent-hashes onto the
        ready-worker ring and spills past excluded/saturated ranks;
        without it, the legacy round-robin cursor runs untouched."""
        busy = resident = None
        if placement is not None:
            # oracle snapshots BEFORE the states lock: advisory data,
            # and the fleet engine's leaf lock must never nest under
            # _states_cv (lock-order discipline)
            busy = self.fleet.rank_busy()
            resident = self.fleet.resident_models()
        with self._states_cv:
            while True:
                ready_all = [
                    ws
                    for ws in self._states.values()
                    if ws.status == "ready" and ws.base_url
                ]
                ready = [
                    ws for ws in ready_all if ws.rank not in exclude
                ]
                if ready:
                    if placement is not None:
                        ws = self._affinity_pick_locked(
                            ready_all, exclude, placement, busy, resident
                        )
                        if ws is not None:
                            return ws
                    ready.sort(key=lambda ws: ws.rank)
                    ws = ready[self._rr % len(ready)]
                    self._rr += 1
                    return ws
                if ready_all:
                    # every routable worker already failed THIS request
                    # (e.g. 429 everywhere): don't camp on the deadline
                    # — return now so the caller can clear the exclude
                    # set or propagate the overload in milliseconds
                    return None
                if self._gang_error is not None or self._stop.is_set():
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._states_cv.wait(timeout=min(0.1, remaining))

    def _affinity_pick_locked(
        self,
        ready_all: List[WorkerState],
        exclude: Set[int],
        placement: Tuple[str, str, int],
        busy: Dict[int, Optional[float]],
        resident: Dict[int, List[str]],
    ) -> Optional[WorkerState]:
        """Consistent-hash ``placement`` onto the ready-worker ring.

        Caller holds ``_states_cv``. The ring is rebuilt only when the
        READY membership changes (vnode positions hash rank ids, not
        generations, so a relaunched rank reclaims its old arc and only
        a dead rank's keys move). Spill policy, in preference order:
        the home rank unless it is excluded or saturated (scraped
        ``util.busy_frac`` >= ``SPARKDL_GATEWAY_SPILL_BUSY``); then a
        non-saturated ring successor already holding the model (the
        fleet ``/v1/models`` cache is the resident-set oracle); then
        the first non-saturated successor; then the home rank anyway
        (saturation is advisory — better a queued request than an
        unroutable one)."""
        members = tuple(sorted(ws.rank for ws in ready_all))
        if not members:
            return None
        ring = self._ring
        if (
            ring is None
            or ring.ranks != members
            or ring.replicas != affinity_replicas()
        ):
            ring = AffinityRing(members, affinity_replicas())
            self._ring = ring
        by_rank = {ws.rank: ws for ws in ready_all}
        threshold = spill_busy()
        model = placement[0]

        def _saturated(rank: int) -> bool:
            frac = busy.get(rank) if busy else None
            return frac is not None and frac >= threshold

        order = [r for r in ring.order(placement) if r not in exclude]
        if not order:
            return None
        home = order[0]
        if not _saturated(home):
            return by_rank[home]
        spill = None
        for rank in order[1:]:
            if _saturated(rank):
                continue
            if resident and model in (resident.get(rank) or ()):
                spill = rank
                break
            if spill is None:
                spill = rank
        metrics.inc("gateway.affinity.spills")
        return by_rank[spill if spill is not None else home]

    # -- the forward path ----------------------------------------------------

    def workers(self) -> List[dict]:
        with self._states_cv:
            return [
                self._states[r].as_dict() for r in sorted(self._states)
            ]

    def stats(self) -> dict:
        with self._states_cv:
            states = [ws.as_dict() for ws in self._states.values()]
            generation = self._generation
        states.sort(key=lambda s: s["rank"])
        return {
            "generation": generation,
            "restarts": self.restarts(),
            "workers": states,
            "gang_error": self._gang_error,
            "requests": int(metrics.counter("gateway.requests")),
            "rerouted": int(metrics.counter("gateway.rerouted")),
            "unroutable": int(metrics.counter("gateway.unroutable")),
        }

    def forward(
        self,
        path: str,
        body: Optional[bytes] = None,
        rank: Optional[int] = None,
        trace_id: Optional[str] = None,
    ):
        """Forward one request; returns ``(status, body, headers)``.

        ``POST /v1/predict`` semantics: transport failures (the worker
        died under us) and 503-draining replies re-dispatch to another
        ready worker under ``SPARKDL_GATEWAY_RETRY_*`` — inference is
        pure, so the re-sent request is the same request. 429s hedge
        too (another worker's queue may have room); non-retryable
        replies (200/400/404/500) propagate as-is. ``rank`` pins the
        forward to one worker (the admin drain path) — pinned forwards
        never re-dispatch.

        ``trace_id`` (the HTTP handler coerces/mints it from
        ``X-Sparkdl-Trace``) rides the forward header so the worker's
        Request carries the SAME id; every attempt lands in this
        forward's attempt ledger, and the gateway-side trace record
        (stored when sampled, re-dispatched, or failed) is what the
        merge stitches against the worker-side waterfalls — a
        re-dispatch off a dying worker IS two attempts under one id."""
        start_unix = time.time()
        t_start = time.monotonic()
        attempts: List[dict] = []
        code, payload, headers = self._forward_attempts(
            path, body, rank, trace_id, attempts
        )
        if trace_id is not None:
            headers = {**headers, TRACE_HEADER: trace_id}
            if path == "/v1/predict":
                record_gateway_trace(
                    trace_id,
                    path,
                    attempts,
                    time.monotonic() - t_start,
                    code,
                    start_unix=start_unix,
                )
        return code, payload, headers

    def _forward_attempts(
        self,
        path: str,
        body: Optional[bytes],
        rank: Optional[int],
        trace_id: Optional[str],
        attempts: List[dict],
    ):
        t0 = time.monotonic()
        deadline = t0 + pending_s()
        policy = policy_from_env(
            "SPARKDL_GATEWAY_RETRY",
            max_attempts=16,
            base_delay_s=0.05,
            max_delay_s=1.0,
        )
        if path == "/v1/predict":
            metrics.inc("gateway.requests")
        placement = (
            placement_key(body)
            if rank is None
            and path == "/v1/predict"
            and affinity_enabled()
            else None
        )
        exclude: Set[int] = set()
        cleared = False
        last_overload = None
        attempt = 0
        while True:
            if rank is not None:
                ws = self._worker_by_rank(rank)
            else:
                ws = self._pick_ready(exclude, deadline, placement)
                if ws is None and exclude and not (
                    self._stop.is_set() or self._gang_error
                ):
                    # every worker failed at least once this request:
                    # give relaunched/recovered ones a second chance
                    exclude = set()
                    cleared = True
                    ws = self._pick_ready(exclude, deadline, placement)
            if ws is None:
                break
            attempt += 1
            t_att = time.monotonic()

            def _attempt(outcome: str) -> None:
                attempts.append(
                    {
                        "rank": ws.rank,
                        "generation": ws.generation,
                        "dur_ms": round(
                            (time.monotonic() - t_att) * 1e3, 3
                        ),
                        "outcome": outcome,
                    }
                )

            try:
                out_headers = (
                    {"Content-Type": "application/json"}
                    if body is not None
                    else {}
                )
                if trace_id is not None:
                    out_headers[TRACE_HEADER] = trace_id
                req = urllib.request.Request(
                    ws.base_url + path,
                    data=body,
                    headers=out_headers,
                    method="POST" if body is not None else "GET",
                )
                with urllib.request.urlopen(
                    req, timeout=forward_timeout_s()
                ) as resp:
                    _attempt("ok")
                    return resp.status, resp.read(), {}
            except urllib.error.HTTPError as e:
                payload = e.read()
                _attempt(str(e.code))
                if e.code not in (429, 503) or rank is not None:
                    # propagate the worker's verdict; only Retry-After
                    # is worth forwarding (the reply envelope — content
                    # type/length — is rebuilt by our own handler)
                    headers = {}
                    if e.headers.get("Retry-After"):
                        headers["Retry-After"] = e.headers["Retry-After"]
                    return e.code, payload, headers
                if e.code == 503:
                    self._mark(ws, "draining")
                last_overload = (e.code, payload)
                exclude.add(ws.rank)
                metrics.inc("gateway.retries")
            except Exception:
                # connection refused/reset, timeout, torn response: the
                # worker died (or is dying) under this request — demote
                # it and re-dispatch; the health poll re-promotes a
                # survivor, the supervisor replaces a corpse
                _attempt("transport")
                if rank is not None:
                    break
                self._mark(ws, "down")
                exclude.add(ws.rank)
                metrics.inc("gateway.rerouted")
            # `attempt` counts COMPLETED attempts, which is exactly the
            # 0-based index of the next one — allows() is 0-based
            if not policy.allows(attempt, time.monotonic() - t0):
                break
            if time.monotonic() >= deadline:
                break
            if cleared:
                # we already tried everyone once: pace the next lap
                time.sleep(min(policy.delay_s(attempt - 1), 0.25))
        if last_overload is not None:
            code, payload = last_overload
            return code, payload, {"Retry-After": retry_after_s()}
        metrics.inc("gateway.unroutable")
        return (
            503,
            json.dumps(
                {
                    "error": (
                        "no ready serving worker"
                        + (
                            f" (gang failed: {self._gang_error})"
                            if self._gang_error
                            else ""
                        )
                    ),
                    # an unroutable request never reached a worker, so
                    # the gateway is the only process that can name it
                    **({"trace_id": trace_id} if trace_id else {}),
                }
            ).encode(),
            {"Retry-After": retry_after_s()},
        )

    def forward_generate_stream(
        self, body: bytes, trace_id: str, handler
    ) -> None:
        """Streamed ``mode="generate"`` forward — the one path where
        the gateway is NOT a buffered proxy. The worker's chunked
        ndjson reply is read incrementally (urllib undoes the worker's
        chunk framing) and re-chunked to the client line by line, so
        time-to-first-token is one hop, not one full generation, and
        the worker's trace id rides every frame. Re-dispatch keeps its
        usual semantics BEFORE the first streamed byte (429/503/
        transport failures hedge to another ready worker — nothing has
        reached the client yet); once a token has been forwarded the
        request is pinned to its worker, because a replay would resend
        the already-delivered prefix — a mid-stream worker death
        becomes a terminal ``error`` record on the stream instead."""
        start_unix = time.time()
        t0 = time.monotonic()
        attempts: List[dict] = []
        code = 500
        try:
            code = self._stream_attempts(
                body, trace_id, handler, attempts, t0
            )
        finally:
            record_gateway_trace(
                trace_id,
                "/v1/predict",
                attempts,
                time.monotonic() - t0,
                code,
                start_unix=start_unix,
            )

    def _stream_attempts(
        self,
        body: bytes,
        trace_id: str,
        handler,
        attempts: List[dict],
        t0: float,
    ) -> int:
        deadline = t0 + pending_s()
        policy = policy_from_env(
            "SPARKDL_GATEWAY_RETRY",
            max_attempts=16,
            base_delay_s=0.05,
            max_delay_s=1.0,
        )
        metrics.inc("gateway.requests")
        placement = placement_key(body) if affinity_enabled() else None
        exclude: Set[int] = set()
        cleared = False
        last_overload = None
        attempt = 0
        while True:
            ws = self._pick_ready(exclude, deadline, placement)
            if ws is None and exclude and not (
                self._stop.is_set() or self._gang_error
            ):
                exclude = set()
                cleared = True
                ws = self._pick_ready(exclude, deadline, placement)
            if ws is None:
                break
            attempt += 1
            t_att = time.monotonic()

            def _attempt(outcome: str) -> None:
                attempts.append(
                    {
                        "rank": ws.rank,
                        "generation": ws.generation,
                        "dur_ms": round(
                            (time.monotonic() - t_att) * 1e3, 3
                        ),
                        "outcome": outcome,
                    }
                )

            started = False
            try:
                req = urllib.request.Request(
                    ws.base_url + "/v1/predict",
                    data=body,
                    headers={
                        "Content-Type": "application/json",
                        TRACE_HEADER: trace_id,
                    },
                    method="POST",
                )
                with urllib.request.urlopen(
                    req, timeout=forward_timeout_s()
                ) as resp:
                    content_type = (
                        resp.headers.get("Content-Type")
                        or "application/x-ndjson"
                    )
                    for line in resp:
                        if not started:
                            _begin_stream_reply(
                                handler, trace_id, content_type
                            )
                            started = True
                        _chunk_raw(handler, line)
                    if not started:
                        # an empty 200 body can't happen today, but an
                        # empty stream must still close cleanly
                        _begin_stream_reply(
                            handler, trace_id, content_type
                        )
                        started = True
                    _end_chunks(handler)
                    _attempt("ok")
                    return 200
            except urllib.error.HTTPError as e:
                payload = e.read()
                _attempt(str(e.code))
                if e.code not in (429, 503):
                    headers = {TRACE_HEADER: trace_id}
                    if e.headers.get("Retry-After"):
                        headers["Retry-After"] = e.headers["Retry-After"]
                    send_raw(handler, e.code, payload, headers)
                    return e.code
                if e.code == 503:
                    self._mark(ws, "draining")
                last_overload = (e.code, payload)
                exclude.add(ws.rank)
                metrics.inc("gateway.retries")
            except Exception as e:  # noqa: BLE001 — see forward()
                _attempt("transport")
                if started:
                    # tokens already reached the client: no replay
                    metrics.inc("gateway.stream_broken")
                    try:
                        _chunk_raw(
                            handler,
                            (
                                json.dumps(
                                    {
                                        "done": True,
                                        "error": (
                                            f"{type(e).__name__}: {e}"
                                        ),
                                        "trace_id": trace_id,
                                    }
                                )
                                + "\n"
                            ).encode(),
                        )
                        _end_chunks(handler)
                    except Exception:
                        pass  # the client went away too
                    return 200
                self._mark(ws, "down")
                exclude.add(ws.rank)
                metrics.inc("gateway.rerouted")
            if not policy.allows(attempt, time.monotonic() - t0):
                break
            if time.monotonic() >= deadline:
                break
            if cleared:
                time.sleep(min(policy.delay_s(attempt - 1), 0.25))
        if last_overload is not None:
            code, payload = last_overload
            send_raw(
                handler,
                code,
                payload,
                {"Retry-After": retry_after_s(), TRACE_HEADER: trace_id},
            )
            return code
        metrics.inc("gateway.unroutable")
        send_raw(
            handler,
            503,
            json.dumps(
                {
                    "error": (
                        "no ready serving worker"
                        + (
                            f" (gang failed: {self._gang_error})"
                            if self._gang_error
                            else ""
                        )
                    ),
                    "trace_id": trace_id,
                }
            ).encode(),
            {"Retry-After": retry_after_s(), TRACE_HEADER: trace_id},
        )
        return 503

    def _worker_by_rank(self, rank: int) -> Optional[WorkerState]:
        with self._states_cv:
            ws = self._states.get(rank)
            return ws if ws is not None and ws.base_url else None


class _GatewayHandler(BaseHTTPRequestHandler):
    server_version = "sparkdl-gateway"
    #: HTTP/1.1 is required for the chunked streamed-generation
    #: passthrough; safe everywhere else because send_raw always sets
    #: Content-Length (keep-alive framing).
    protocol_version = "HTTP/1.1"

    def log_message(self, *args) -> None:
        pass

    def _send_json(self, code, payload, headers=None) -> None:
        send_json(self, code, payload, headers)

    def _send_raw(self, code, body: bytes, headers=None) -> None:
        send_raw(self, code, body, headers)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        gw: ServingGateway = self.server.gateway  # type: ignore[attr-defined]
        try:
            if path in ("/", "/healthz"):
                stats = gw.stats()
                ready = sum(
                    1 for w in stats["workers"] if w["status"] == "ready"
                )
                self._send_json(
                    200 if ready else 503,
                    {
                        "status": "ok" if ready else "degraded",
                        "ready_workers": ready,
                        "generation": stats["generation"],
                        "restarts": stats["restarts"],
                    },
                )
            elif path == "/v1/workers":
                self._send_json(200, gw.stats())
            elif path == "/v1/models":
                code, body, headers = gw.forward("/v1/models")
                self._send_raw(code, body, headers)
            elif path == "/v1/slo":
                # forwarded to a ready worker like /v1/models — each
                # worker evaluates its own admission stream, so the
                # answer is ONE worker's live burn-rate view (its reply
                # names its rank); /v1/fleet is the gang-wide fusion
                code, body, headers = gw.forward("/v1/slo")
                self._send_raw(code, body, headers)
            elif path == "/v1/memory":
                # forwarded like /v1/slo: one worker's reconciled
                # memory ledger (its reply names its rank); the fused
                # fleet.mem.* aggregates live on /v1/fleet + /metrics
                code, body, headers = gw.forward("/v1/memory")
                self._send_raw(code, body, headers)
            elif path == "/v1/fleet":
                self._send_json(200, gw.fleet_status())
            elif path == "/metrics":
                # federated: gateway registry + every rank's cached
                # (rank-labeled) exposition + staleness markers; a
                # failed scrape degrades per-rank, never to a 500 here
                send_raw(
                    self,
                    200,
                    gw.federated_metrics_text().encode(),
                    content_type=(
                        "text/plain; version=0.0.4; charset=utf-8"
                    ),
                )
            else:
                self._send_json(404, {"error": "not found"})
        except Exception as e:  # a handler bug must never kill the gateway
            try:
                self._send_json(500, {"error": str(e)})
            except Exception:
                pass

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        gw: ServingGateway = self.server.gateway  # type: ignore[attr-defined]
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b"{}"
            if path == "/v1/predict":
                # mint (or honor) the trace id HERE, the first hop: the
                # forward propagates it to the worker and the reply
                # carries it back whatever the outcome
                trace_id = coerce_trace_id(self.headers.get(TRACE_HEADER))
                if wants_stream(body):
                    gw.forward_generate_stream(body, trace_id, self)
                    return
                code, out, headers = gw.forward(
                    "/v1/predict", body, trace_id=trace_id
                )
                self._send_raw(code, out, headers)
            elif path == "/admin/drain":
                try:
                    rank = int(json.loads(body or b"{}").get("rank"))
                except (TypeError, ValueError, json.JSONDecodeError):
                    self._send_json(
                        400, {"error": "body must carry {'rank': N}"}
                    )
                    return
                code, out, headers = gw.forward(
                    "/admin/drain", b"{}", rank=rank
                )
                self._send_raw(code, out, headers)
            elif path == "/admin/profile":
                # a pinned-rank forward, as /admin/drain: a profile is a
                # statement about one worker's card, never re-dispatched
                try:
                    payload = json.loads(body or b"{}")
                    rank = int(payload.get("rank"))
                except (TypeError, ValueError, AttributeError, json.JSONDecodeError):
                    self._send_json(
                        400, {"error": "body must carry {'rank': N, 'seconds': S}"}
                    )
                    return
                # the worker holds the reply for the whole capture: a
                # window the forward timeout cannot cover is refused here
                cap = forward_timeout_s() - 5.0
                try:
                    seconds = float(payload.get("seconds", 1.0))
                except (TypeError, ValueError):
                    seconds = -1.0
                if not 0.0 < seconds <= cap:
                    self._send_json(400, {"error": (
                        f"seconds must be in (0, {cap:g}] via the gateway "
                        "(the forward timeout, SPARKDL_GATEWAY_FORWARD_TIMEOUT_S, "
                        "bounds the capture; POST the worker directly for "
                        "longer windows)"
                    )})
                    return
                code, out, headers = gw.forward(
                    "/admin/profile", json.dumps({"seconds": seconds}).encode(), rank=rank
                )
                self._send_raw(code, out, headers)
            else:
                self._send_json(404, {"error": "not found"})
        except Exception as e:
            try:
                self._send_json(500, {"error": str(e)})
            except Exception:
                pass


__all__ = [
    "AffinityRing",
    "ServingGateway",
    "WorkerState",
    "affinity_enabled",
    "affinity_replicas",
    "canary_waves",
    "forward_timeout_s",
    "gateway_workers",
    "health_interval_s",
    "pending_s",
    "placement_key",
    "port_file",
    "spill_busy",
    "wants_stream",
]
