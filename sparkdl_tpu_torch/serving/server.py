"""Serving front ends: a stdlib HTTP endpoint and an in-process client.

The port of the JAX package's ``serving/server.py``, with its wire
contract. A daemon-threaded ``ThreadingHTTPServer``, no third-party
dependencies, bound to loopback by default (``SPARKDL_SERVE_BIND``).
Endpoints:

- ``POST /v1/predict``: body ``{"model": "...", "inputs": [[...], ...],
  "priority": "interactive|batch|background", "deadline_ms": N, "mode":
  "features|embed|logits|probabilities", "dtype": "float32"}``. ``inputs``
  is a STACK of rows: image rows are preprocessed NHWC float32 ``[n, H, W,
  3]``, text rows int32 token ids ``[n, L]`` (``"dtype": "int32"``). A
  bare 1-D list is one row; a single multi-dimensional row carries its
  leading batch axis or sets ``"single_row": true``. Replies ``{"model",
  "outputs", "rows", "priority", "precision", "latency_ms", "trace_id"}``.
  An unknown model or a bad body is 400, admission rejection 429 with
  ``Retry-After``, draining 503 with ``Retry-After``, deadline expiry 504,
  a device failure 500. ``"mode": "generate"`` takes one prompt of token
  ids as ``inputs`` and the fields ``max_new_tokens``, ``temperature``,
  ``top_k``, ``eos_id`` and ``seed``; it replies ``{"model", "priority",
  "prompt_len", "tokens": [[...]], "latency_ms", "trace_id"}``, or with
  ``"stream": true`` a chunked ``application/x-ndjson`` stream of one
  ``{"token", "index", "trace_id"}`` record per token and a terminal
  ``{"done": true, ...}`` record (an error after the first byte becomes
  that record's ``"error"``). A prompt whose length plus
  ``max_new_tokens`` exceeds the model's position table is 400; a KV-cache
  reservation over ``SPARKDL_SERVE_HBM_BUDGET_MB`` is 429.
- ``GET /v1/models``: the residency table, queue and latency stats, and
  the registry with its memory estimates (``supported``).
- ``GET /healthz``: ``{"status": "ok"}``, or ``"draining"`` once a drain
  began, so load balancers route around the worker.
- ``GET /metrics``: Prometheus text of the whole metrics registry.
- ``POST /admin/drain``: graceful drain; admission answers 503 while
  queued and in-flight work completes.
- ``GET /v1/slo``: the SLO engine's live burn-rate status (reading it is
  an evaluation, so a quiet tripped class recovers when polled), with the
  raw per-class window counts (``windows``); ``{"armed": false}`` when no
  ``SPARKDL_SLO_*`` objective is set. ``exemplars`` is empty until the
  trace store is ported (ROADMAP Queue A item 4.11).
- ``GET /v1/memory``: the device-memory ledger reconciled against
  ``torch.cuda.memory_allocated`` on read, with ``budget_bytes``;
  ``{"tracked": false}`` before anything was tracked.
- ``POST /admin/canary``: body ``{"weight": W}`` overrides the canary
  split weight; replies ``{"weight", "tripped"}``; a body without a
  number is 400.
- ``POST /admin/profile`` answers 501: the profiler capture is not ported
  yet (ROADMAP Queue A item 4.10).

HTTP threads only decode JSON and block in ``Request.result()``; every
policy decision lives in the :class:`~sparkdl_tpu_torch.serving.router.Router`,
which the in-process :class:`ServingClient` shares: the client is the
reference semantics of the handler. Nothing binds unless
``ServingServer``/``start_server`` is called.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from sparkdl_tpu_torch.obs.trace import TRACE_HEADER, coerce_trace_id
from sparkdl_tpu_torch.runtime import knobs
from sparkdl_tpu_torch.serving.request import (
    PRIORITY_CLASSES,
    AdmissionRejected,
    DeadlineExceeded,
    Draining,
)
from sparkdl_tpu_torch.serving.router import Router

#: endpoints of the JAX server that the port answers with 501
NOT_PORTED = {
    ("POST", "/admin/profile"): "on-demand profiling",
}


def configured_port() -> Optional[int]:
    """``SPARKDL_SERVE_PORT`` as an int, or None when unset/0/invalid."""
    return knobs.get_port("SPARKDL_SERVE_PORT")


def retry_after_s() -> int:
    """``Retry-After`` value for 429 and 503 replies, whole seconds >= 1
    (``SPARKDL_SERVE_RETRY_AFTER_S``)."""
    return max(1, round(knobs.get_float("SPARKDL_SERVE_RETRY_AFTER_S")))


def bind_address() -> str:
    """``SPARKDL_SERVE_BIND``, default loopback: the predict endpoint is
    unauthenticated, so exposure is an explicit operator choice."""
    return knobs.get_str("SPARKDL_SERVE_BIND")


class ServingClient:
    """In-process front end: the reference semantics the HTTP handler
    matches (it calls exactly this)."""

    def __init__(self, router: Router):
        self.router = router

    def predict(
        self,
        model: str,
        inputs,
        priority: str = "interactive",
        deadline_ms: Optional[float] = None,
        mode: str = "features",
        timeout: Optional[float] = None,
        trace_id: Optional[str] = None,
    ) -> np.ndarray:
        """Synchronous predict: admit, wait, return the output rows."""
        req = self.router.submit(
            model,
            np.asarray(inputs),
            priority=priority,
            # deadline_ms=0 means "no budget left", not "no deadline"
            deadline_s=deadline_ms / 1e3 if deadline_ms is not None else None,
            mode=mode,
            trace_id=trace_id,
        )
        return req.result(timeout=timeout)

    def submit(self, *args, **kwargs):
        """Async variant: the underlying :class:`Request` future."""
        return self.router.submit(*args, **kwargs)

    def generate(
        self,
        model: str,
        prompt,
        priority: str = "interactive",
        deadline_ms: Optional[float] = None,
        **gen_params,
    ):
        """Admit one autoregressive request (``max_new_tokens``,
        ``temperature``, ``top_k``, ``eos_id``, ``seed`` as keywords) and
        return its :class:`Request`: stream with ``req.iter_tokens()`` or
        block in ``req.result()`` for the [1, n_new] tokens."""
        return self.router.submit(
            model,
            np.asarray(prompt, np.int32).reshape(1, -1),
            priority=priority,
            deadline_s=deadline_ms / 1e3 if deadline_ms is not None else None,
            mode="generate",
            gen_params=gen_params or None,
        )


def send_raw(
    handler: BaseHTTPRequestHandler,
    code: int,
    body: bytes,
    headers: Optional[dict] = None,
    content_type: str = "application/json",
) -> None:
    handler.send_response(code)
    handler.send_header("Content-Type", content_type)
    handler.send_header("Content-Length", str(len(body)))
    for name, value in (headers or {}).items():
        handler.send_header(name, str(value))
    handler.end_headers()
    handler.wfile.write(body)


def send_json(
    handler: BaseHTTPRequestHandler, code: int, payload: dict,
    headers: Optional[dict] = None,
) -> None:
    send_raw(handler, code, json.dumps(payload).encode(), headers)


def send_prometheus(handler: BaseHTTPRequestHandler) -> None:
    from sparkdl_tpu_torch.utils.metrics import prometheus_text

    send_raw(
        handler, 200, prometheus_text().encode(),
        content_type="text/plain; version=0.0.4; charset=utf-8",
    )


#: the generate body's sampling and limit fields
GEN_FIELDS = ("max_new_tokens", "temperature", "top_k", "eos_id", "seed")


class _Handler(BaseHTTPRequestHandler):
    server_version = "sparkdl-serve"
    #: HTTP/1.1: keep-alive (every other reply sets a length) and the
    #: chunked coding of the streamed generate reply
    protocol_version = "HTTP/1.1"

    def log_message(self, *args) -> None:  # no per-request stderr lines
        pass

    def _send_json(self, code: int, payload: dict, headers: Optional[dict] = None) -> None:
        send_json(self, code, payload, headers)

    def _not_ported(self, method: str, path: str) -> bool:
        what = NOT_PORTED.get((method, path))
        if what is None:
            return False
        length = int(self.headers.get("Content-Length") or 0)
        if length:
            self.rfile.read(length)
        self._send_json(
            501,
            {"error": f"{what} ({method} {path}) is not ported to "
                      "sparkdl_tpu_torch yet", "status": "unavailable"},
        )
        return True

    # -- GET ----------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        router: Router = self.server.router  # type: ignore[attr-defined]
        try:
            if self._not_ported("GET", path):
                return
            if path == "/v1/models":
                from sparkdl_tpu_torch.models.registry import supported_models

                self._send_json(
                    200,
                    {**router.stats(), "supported": supported_models(with_memory=True)},
                )
            elif path == "/v1/slo":
                from sparkdl_tpu_torch.obs import slo

                payload = dict(slo.engine_status() or {"armed": False})
                totals = slo.window_totals()
                if totals is not None:
                    payload["windows"] = totals
                    payload["exemplars"] = {}  # the trace store is not ported
                self._send_json(200, payload)
            elif path == "/v1/memory":
                from sparkdl_tpu_torch.obs import memory

                payload = memory.memory_status() or {"tracked": False}
                try:
                    payload["budget_bytes"] = router.residency.budget_bytes()
                except ValueError as e:
                    payload["budget_error"] = str(e)
                self._send_json(200, payload)
            elif path in ("/", "/healthz"):
                self._send_json(
                    200,
                    {
                        "status": "draining" if router.draining else "ok",
                        "endpoints": [
                            "POST /v1/predict", "/v1/models", "/v1/slo",
                            "/v1/memory", "/healthz", "/metrics",
                            "POST /admin/drain", "POST /admin/canary",
                        ],
                    },
                )
            elif path == "/metrics":
                send_prometheus(self)
            else:
                self._send_json(404, {"error": "not found"})
        except Exception as e:  # a handler bug must never kill the server
            try:
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            except OSError:
                pass

    # -- streamed generation -------------------------------------------------

    def _begin_stream(self, trace_id: str) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header(TRACE_HEADER, trace_id)
        self.end_headers()

    def _chunk(self, record: dict) -> None:
        data = (json.dumps(record) + "\n").encode()
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _end_stream(self) -> None:
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    def _finish_generate(self, req, stream: bool, reply, priority: str, t0: float) -> None:
        """Answer one admitted generate request: the whole token array, or
        one chunked ndjson record per token as the engine emits it and a
        terminal ``done`` record. An error before the first streamed byte
        raises into ``do_POST``'s status mapping; after it the status line
        is gone, and the error becomes the terminal record."""
        timeout = knobs.get_float("SPARKDL_SERVE_HTTP_TIMEOUT_S")
        if not stream:
            tokens = req.result(timeout=timeout)
            reply(200, {
                "model": req.model,
                "priority": priority,
                "prompt_len": req.prompt_len,
                "tokens": np.asarray(tokens).tolist(),
                "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
            })
            return
        started = False
        try:
            for token, index in req.iter_tokens(timeout=timeout):
                if not started:
                    # headers once the first token exists: an admission-
                    # time failure still gets its own status
                    self._begin_stream(req.trace_id)
                    started = True
                self._chunk({"token": token, "index": index, "trace_id": req.trace_id})
            tokens = req.result(timeout=timeout)
            if not started:
                self._begin_stream(req.trace_id)
                started = True
            self._chunk({
                "done": True,
                "model": req.model,
                "prompt_len": req.prompt_len,
                "tokens": np.asarray(tokens).tolist(),
                "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
                "trace_id": req.trace_id,
            })
            self._end_stream()
        except Exception as e:  # noqa: BLE001 - see the docstring
            if not started:
                raise
            try:
                self._chunk({"done": True, "error": f"{type(e).__name__}: {e}",
                             "trace_id": req.trace_id})
                self._end_stream()
            except OSError:  # the client went away mid-stream
                pass

    # -- POST ---------------------------------------------------------------

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        router: Router = self.server.router  # type: ignore[attr-defined]
        if path == "/admin/drain":
            router.drain()
            self._send_json(200, {"status": "draining"})
            return
        if path == "/admin/canary":
            try:
                length = int(self.headers.get("Content-Length") or 0)
                weight = float(json.loads(self.rfile.read(length) or b"{}")["weight"])
            except (KeyError, TypeError, ValueError, json.JSONDecodeError):
                self._send_json(400, {"error": "body must carry {'weight': W}"})
                return
            self._send_json(200, router.set_canary_weight(weight))
            return
        if self._not_ported("POST", path):
            return
        if path != "/v1/predict":
            self._send_json(404, {"error": "not found"})
            return
        # the trace id exists before the body parses, so a 400 or a 429
        # still names it
        trace_id = coerce_trace_id(self.headers.get(TRACE_HEADER))

        def _reply(code: int, payload: dict, headers: Optional[dict] = None) -> None:
            self._send_json(
                code,
                {**payload, "trace_id": trace_id},
                headers={**(headers or {}), TRACE_HEADER: trace_id},
            )

        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            model = body.get("model")
            if not model:
                raise ValueError("missing 'model'")
            mode = body.get("mode", "features")
            gen_params = None
            if mode == "generate":
                gen_params = {k: body[k] for k in GEN_FIELDS if body.get(k) is not None}
            inputs = np.asarray(body.get("inputs"), dtype=body.get("dtype", "float32"))
            single_row = bool(body.get("single_row", inputs.ndim == 1))
            if single_row:
                inputs = inputs[None]
            priority = body.get("priority", "interactive")
            if priority not in PRIORITY_CLASSES:
                raise ValueError(f"priority must be one of {PRIORITY_CLASSES}")
            deadline_ms = body.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)  # malformed -> 400
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            _reply(400, {"error": f"bad request: {e}"})
            return
        t0 = time.monotonic()
        try:
            req = router.submit(
                model,
                inputs,
                priority=priority,
                deadline_s=deadline_ms / 1e3 if deadline_ms is not None else None,
                mode=mode,
                trace_id=trace_id,
                gen_params=gen_params,
            )
            if mode == "generate":
                self._finish_generate(req, bool(body.get("stream", False)), _reply, priority, t0)
                return
            outputs = req.result(
                timeout=knobs.get_float("SPARKDL_SERVE_HTTP_TIMEOUT_S")
            )
        except Draining as e:
            _reply(503, {"error": str(e), "status": "draining"},
                   headers={"Retry-After": retry_after_s()})
            return
        except AdmissionRejected as e:
            _reply(429, {"error": str(e)}, headers={"Retry-After": retry_after_s()})
            return
        except DeadlineExceeded as e:
            _reply(504, {"error": str(e)})
            return
        except ValueError as e:  # unknown model / bad payload geometry
            _reply(400, {"error": str(e)})
            return
        except Exception as e:
            _reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if single_row:
            outputs = outputs[0]
        _reply(
            200,
            {
                "model": req.model,
                "priority": priority,
                "precision": req.precision,
                "rows": 1 if single_row else int(len(outputs)),
                "outputs": np.asarray(outputs).tolist(),
                "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
            },
        )


class ServingServer:
    """One running HTTP front end bound to a router."""

    def __init__(self, router: Router, port: int = 0):
        self.router = router
        self._httpd = ThreadingHTTPServer((bind_address(), port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.router = router  # type: ignore[attr-defined]
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"sparkdl-serve-http-{self.port}",
            daemon=True,
        )
        self._thread.start()

    def stop(self, close_router: bool = False) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        if close_router:
            self.router.close()


def start_server(
    router: Optional[Router] = None, port: Optional[int] = None
) -> Optional[ServingServer]:
    """Bind the HTTP front end. ``port=None`` reads ``SPARKDL_SERVE_PORT``
    and returns None when it is unset; ``port=0`` binds an ephemeral port
    (read ``server.port`` back)."""
    if port is None:
        port = configured_port()
        if port is None:
            return None
    return ServingServer(router if router is not None else Router(), int(port))


__all__ = [
    "NOT_PORTED",
    "ServingClient",
    "ServingServer",
    "bind_address",
    "configured_port",
    "retry_after_s",
    "send_json",
    "send_prometheus",
    "send_raw",
    "start_server",
]
