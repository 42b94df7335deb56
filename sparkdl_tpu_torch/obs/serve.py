"""The pull exporter: a small HTTP server over this process's telemetry.

The port of the JAX package's ``obs/serve.py``. Off by default;
``SPARKDL_OBS_PORT`` turns it on (:func:`maybe_start_from_env`: gang rank
``r`` binds ``SPARKDL_OBS_PORT + r``, so co-hosted ranks get distinct
ports; the batch worker and the serving worker call it). Endpoints, all
``GET``:

- ``/metrics``: the registry in Prometheus text, with the tail exemplars
  (``obs/export.prometheus_text``);
- ``/snapshot``: the obs snapshot (``obs/export.snapshot``);
- ``/series``: the metrics sampler's history (``obs/timeseries.py``);
- ``/slo``: the SLO engine's status (``{"armed": false}`` unarmed);
- ``/healthz`` (and ``/``): ``ok`` and the endpoint list.

The server binds ``SPARKDL_OBS_BIND`` (loopback by default: the endpoints
are unauthenticated). A scrape that fails answers 500 and never stops
the server.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from sparkdl_tpu_torch.runtime import knobs, locksmith


def configured_port() -> Optional[int]:
    """``SPARKDL_OBS_PORT`` as an int, or None when unset/0/invalid
    (0 means "off" here; an ephemeral bind must be asked for in code)."""
    return knobs.get_port("SPARKDL_OBS_PORT")


def bind_address() -> str:
    """``SPARKDL_OBS_BIND``, default loopback. The endpoints are
    unauthenticated and ``/snapshot`` carries span attrs + hostnames, so
    on a shared host nothing is network-exposed unless the operator
    opts in (``SPARKDL_OBS_BIND=0.0.0.0`` for cross-host Prometheus
    scrapes)."""
    return knobs.get_str("SPARKDL_OBS_BIND")


class _Handler(BaseHTTPRequestHandler):
    server_version = "sparkdl-obs"

    def log_message(self, *args) -> None:  # quiet: no per-scrape stderr spam
        pass

    def _send(self, code: int, ctype: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        from sparkdl_tpu_torch.obs import export, timeseries

        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                self._send(
                    200,
                    "text/plain; version=0.0.4; charset=utf-8",
                    export.prometheus_text().encode(),
                )
            elif path == "/slo":
                # the burn-rate engine's live status (reading IS an
                # evaluation — a quiet tripped class recovers when
                # scraped); {"armed": false} when no objective is set
                from sparkdl_tpu_torch.obs import slo as slo_mod

                status = slo_mod.engine_status()
                self._send(
                    200,
                    "application/json",
                    json.dumps(status or {"armed": False}).encode(),
                )
            elif path == "/snapshot":
                self._send(
                    200,
                    "application/json",
                    json.dumps(export.snapshot()).encode(),
                )
            elif path == "/series":
                self._send(
                    200,
                    "application/json",
                    json.dumps(timeseries.get_sampler().as_dict()).encode(),
                )
            elif path in ("/", "/healthz"):
                self._send(
                    200,
                    "text/plain; charset=utf-8",
                    b"ok\nendpoints: /metrics /slo /snapshot /series /healthz\n",
                )
            else:
                self._send(404, "text/plain", b"not found\n")
        except Exception as e:  # a scrape bug must never kill the server
            try:
                self._send(500, "text/plain", f"error: {e}\n".encode())
            except Exception:
                pass


class ObsServer:
    """One running exporter: the http server + its serve thread."""

    def __init__(self, port: int):
        self._httpd = ThreadingHTTPServer((bind_address(), port), _Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"sparkdl-obs-serve-{self.port}",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


_server: Optional[ObsServer] = None
_server_lock = locksmith.lock("sparkdl_tpu_torch/obs/serve.py::_server_lock")


def start_server(port: Optional[int] = None) -> Optional[ObsServer]:
    """Start (or return) the process-global exporter. ``port=None`` reads
    ``SPARKDL_OBS_PORT`` and returns None when that is unset — callers
    can pass env-resolution straight through. ``port=0`` binds an
    ephemeral port (tests read ``server.port`` back). Asking for a
    SPECIFIC port while a server already runs elsewhere raises — silently
    returning the wrong-port singleton would break the "rank r is on
    port+r" contract without anyone noticing."""
    global _server
    if port is None:
        port = configured_port()
        if port is None:
            return None
    with _server_lock:
        if _server is not None:
            if port == 0 or _server.port == int(port):
                return _server
            raise RuntimeError(
                f"obs server already running on :{_server.port}; "
                f"cannot also bind :{port}"
            )
        _server = ObsServer(int(port))
        return _server


def stop_server() -> None:
    global _server
    with _server_lock:
        server, _server = _server, None
    if server is not None:
        server.stop()


def server_port() -> Optional[int]:
    with _server_lock:
        return _server.port if _server is not None else None


def maybe_start_from_env(rank: Optional[int] = None) -> Optional[ObsServer]:
    """Env-gated start: ``SPARKDL_OBS_PORT`` set => serve on it (+rank
    for gang workers, so co-hosted ranks get distinct ports); unset =>
    None. Never raises — a busy port must not kill a worker whose actual
    job is fine."""
    port = configured_port()
    if port is None:
        return None
    try:
        return start_server(port + (rank or 0))
    except Exception:
        return None


__all__ = [
    "ObsServer",
    "bind_address",
    "configured_port",
    "maybe_start_from_env",
    "server_port",
    "start_server",
    "stop_server",
]
