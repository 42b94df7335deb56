"""Request router: SLA-classed continuous batching over feeder streams.

The port of the JAX package's ``serving/router.py``. Requests are
admitted into ONE class-aware queue (``request.py``); a dispatcher thread
groups them by ``(model, mode, row shape, dtype, precision)``, and each
group rides the shared feeder (``runtime/feeder.py``): ``get_feeder``
keyed by ``(device_fn, dispatch geometry)`` gives one owner thread per
(model, batch-size rung).

Adaptive batch sizing: each dispatch uses a batch-size rung, the smallest
power of two covering the rows on hand, capped at
``SPARKDL_SERVE_MAX_BATCH``. A shallow queue dispatches a 1-row request
as a 1-row batch; a deep queue assembles groups to the full geometry.
Between the two, a short batch window (``SPARKDL_SERVE_WINDOW_MS``) lets a
partial group wait for late arrivals, but only while its strictest class
is under its target p95 (``SPARKDL_SERVE_TARGET_P95_MS[_<CLASS>]``, over a
recent-completion window). Text payloads are padded at admission to a
sequence bucket (``text/bucketing.next_bucket``), so nearby lengths share
one stream; over-long payloads are refused there (HTTP 400).

A group is padded to an exact multiple of its rung, so the feeder's buffer
fills and flushes at once; serving never waits out the feeder's linger.
Padding is counted (``serve.pad_rows``) and never returned. Each group's
dispatch runs under a retry policy (``SPARKDL_SERVE_RETRY_*``).

Graceful drain (:meth:`Router.drain`): admission closes
(:class:`~sparkdl_tpu_torch.serving.request.Draining`, HTTP 503 with
``Retry-After``) while everything already admitted completes; once queue
and in-flight groups quiesce, resident models unload and their feeder
streams close. A closed router answers the same way
(:class:`~sparkdl_tpu_torch.serving.request.Closed`, a ``Draining``): a
request it refused or failed before it ran is 503, which a gateway
re-dispatches; the JAX package answers 500 there.

Generation (``mode="generate"``): one prompt per request, screened at
admission (:func:`_validate_generate`), its KV-cache bytes reserved
against the residency budget before it is queued (a refusal is HTTP 429);
the dispatcher hands it to the :class:`~sparkdl_tpu_torch.serving.generation.GenerationEngine`,
which carries it in the in-flight count until it retires, so a drain
waits for running generations.

Token ids are checked at admission: an id outside ``[0, vocab_size)`` of
a registry text model is a ``ValueError`` (HTTP 400) on both paths, with
nothing reserved. The JAX package's gathers clamp such an id and answer
with silently wrong rows; the port refuses it, the contract the JAX
``_validate_generate`` states for positions. On CUDA the embedding gather
would raise a device-side assert instead, which leaves the process's CUDA
context unusable for every later request.

The canary rollout (:func:`canary_config`): with
``SPARKDL_SERVE_CANARY_MODEL`` and ``_VERSION`` set, a deterministic
Bresenham split routes ``SPARKDL_SERVE_CANARY_WEIGHT`` of that model's
admissions to the canary version (``req.canary_arm``; per-arm
``serve.canary.*`` / ``serve.primary.*`` metrics); once the canary's
failure rate reaches ``SPARKDL_SERVE_CANARY_TRIP_RATE`` over at least
``SPARKDL_SERVE_CANARY_MIN_REQUESTS`` requests, every later admission
routes to the primary (sticky; ``serve.canary.rollbacks`` and a
``{"kind": "canary_rollback"}`` event). ``set_canary_weight`` (``POST
/admin/canary``) overrides the weight at run time. A request is screened
against the spec of the model it routes to: a request that the canary's
own vocabulary, position table or modes refuse stays on the primary and
takes no turn of the split (``serve.canary.ineligible``), and a generate
request reserves the KV bytes of the model that serves it.

The control plane: admission shedding spends the SLO engine's budget
(``obs/slo.py``); each dispatch that landed notes its real rows' analytic
FLOPs, at the sequence bucket that ran, into the utilization ledger's
``serve.mfu`` (``obs/utilization.py``); an allocation failure at admission
or dispatch is filed with the memory ledger (``obs/memory.record_oom``).
``stats()`` carries their ``slo``, ``utilization``, ``memory`` and
``canary`` blocks.

The router runs on ``cuda`` unless the caller passes ``device="cpu"``;
without a card the default raises.

Fault injection: ``maybe_fault("serve.request", request=<admission
ordinal>, model=..., cls=...)`` runs for each request as its group is
served (``resilience/faults.py``). Not ported yet: mesh widths.
"""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np

from sparkdl_tpu_torch.obs import memory as mem_mod
from sparkdl_tpu_torch.obs import slo, span
from sparkdl_tpu_torch.resilience.faults import maybe_fault
from sparkdl_tpu_torch.resilience.policy import policy_from_env
from sparkdl_tpu_torch.runtime import knobs, locksmith
from sparkdl_tpu_torch.runtime.device import DeviceLike
from sparkdl_tpu_torch.serving.request import (
    PRIORITY_CLASSES,
    AdmissionQueue,
    AdmissionRejected,
    Closed,
    DeadlineExceeded,
    Request,
    recent_p95_s,
)
from sparkdl_tpu_torch.serving.residency import ResidencyManager
from sparkdl_tpu_torch.utils.metrics import metrics

#: Per-class default target p95, milliseconds (override all with
#: SPARKDL_SERVE_TARGET_P95_MS, per class with _INTERACTIVE/_BATCH/...).
_DEFAULT_TARGET_P95_MS = {
    "interactive": 50.0,
    "batch": 500.0,
    "background": 5000.0,
}


def max_batch_rows() -> int:
    """Full batch geometry per dispatch (``SPARKDL_SERVE_MAX_BATCH``,
    default 32): the throughput-mode rung."""
    return max(1, knobs.get_int("SPARKDL_SERVE_MAX_BATCH"))


def batch_window_s() -> float:
    """How long a partially filled group may wait for late arrivals
    (``SPARKDL_SERVE_WINDOW_MS``, default 2)."""
    return max(0.0, knobs.get_float("SPARKDL_SERVE_WINDOW_MS")) / 1e3


def target_p95_s(priority: str) -> float:
    """The class's latency objective, seconds: the per-class knob, then
    the global one, then the built-in class default."""
    for name in (
        f"SPARKDL_SERVE_TARGET_P95_MS_{priority.upper()}",
        "SPARKDL_SERVE_TARGET_P95_MS",
    ):
        target = knobs.get_float(name)
        if target:
            return target / 1e3
    return _DEFAULT_TARGET_P95_MS[priority] / 1e3


def observed_p95_s(priority: str) -> Optional[float]:
    """The recent-completion p95 the batch window consults."""
    return recent_p95_s(priority)


def choose_rung(rows: int, max_rows: Optional[int] = None) -> int:
    """Batch-size rung for ``rows`` rows on hand: the smallest power of
    two >= rows, clamped to the full geometry. Rungs keep the stream
    population per (model, row shape) at log2(max) + 1."""
    cap = max_rows if max_rows is not None else max_batch_rows()
    rows = max(1, int(rows))
    if rows >= cap:
        return cap
    return min(cap, 1 << max(0, math.ceil(math.log2(rows))))


def canary_config() -> Optional[tuple]:
    """``(base_name_lower, canary_version, weight)`` when a canary rollout
    is set (both ``SPARKDL_SERVE_CANARY_MODEL`` and ``_VERSION``), else
    None. The weight is clamped to [0, 1]; the split is a deterministic
    Bresenham counter over admissions, so N requests route
    ``round(N * weight)`` +- 1 of them to the canary."""
    base = knobs.get_str("SPARKDL_SERVE_CANARY_MODEL")
    version = knobs.get_str("SPARKDL_SERVE_CANARY_VERSION")
    if not base or not version:
        return None
    weight = min(1.0, max(0.0, knobs.get_float("SPARKDL_SERVE_CANARY_WEIGHT")))
    return (base.lower(), version, weight)


def _check_vocabulary(model: str, payload: np.ndarray, vocab_size: int) -> None:
    """Refuse token ids outside ``[0, vocab_size)`` (checked before the
    int32 cast, so a wide id cannot wrap into range)."""
    bad = payload[(payload < 0) | (payload >= vocab_size)]
    if bad.size:
        raise ValueError(
            f"token id {bad.flat[0]} is outside model {model!r}'s vocabulary "
            f"[0, {vocab_size}) (vocab_size {vocab_size})"
        )


def choose_seq_bucket(seq_len: int) -> int:
    """The sequence-length sibling of :func:`choose_rung`: the text
    ladder's bucket edge a token payload of ``seq_len`` pads up to."""
    from sparkdl_tpu_torch.text.bucketing import next_bucket

    return next_bucket(seq_len)


def _text_spec(model: str):
    """The registry text spec of ``model``, or None (an image model, or a
    custom-loader name)."""
    from sparkdl_tpu_torch.models import NamedTextModel, get_model

    try:
        spec = get_model(model)
    except ValueError:
        return None
    return spec if isinstance(spec, NamedTextModel) else None


def _bucket_token_payload(model: str, payload: np.ndarray):
    """Seq-bucket an embed-mode token payload [rows, L] at admission: pad
    the sequence axis with id 0 (registry text models derive their mask as
    ``ids != 0``, so zero padding never changes an embedding) up to
    :func:`choose_seq_bucket`'s edge, capped at the spec's position table.
    Runs before the Request is built, so the grouping key carries the
    bucket. int32-normalized: JSON ids arrive as int64 or float.

    For registry text models the spec's ``max_length`` is the hard
    ceiling, and every id must lie in ``[0, vocab_size)``: a longer
    payload or an id outside the vocabulary raises ``ValueError`` (HTTP
    400). Custom-loader models bucket uncapped, and a non-integer payload
    for one passes through untouched.

    Returns ``(payload, real_tokens, pad_tokens)``."""
    if payload.ndim != 2:
        return payload, 0, 0
    spec = _text_spec(model)
    max_len = spec.max_length if spec is not None else None
    if not np.issubdtype(payload.dtype, np.integer):
        if max_len is None:
            return payload, 0, 0
        if not np.all(np.mod(payload, 1) == 0):
            raise ValueError(
                f"model {model!r} expects integer token ids; got "
                f"non-integral {payload.dtype} values"
            )
    if spec is not None:
        _check_vocabulary(model, payload, spec.vocab_size)
    payload = payload.astype(np.int32, copy=False)
    rows, length = payload.shape
    if max_len is not None and length > max_len:
        raise ValueError(
            f"token payload length {length} exceeds model {model!r}'s "
            f"position table ({max_len})"
        )
    real = int(np.count_nonzero(payload))
    if not knobs.get_flag("SPARKDL_TEXT_BUCKETING"):
        return payload, real, rows * length - real
    bucket = choose_seq_bucket(length)
    if max_len is not None:
        bucket = min(bucket, max_len)
    if bucket > length:
        payload = np.concatenate(
            [payload, np.zeros((rows, bucket - length), np.int32)], axis=1
        )
    return payload, real, rows * bucket - real


def _validate_generate(model: str, payload: np.ndarray, gen_params):
    """Admission-time screening of a generate request. Returns ``(payload
    [1, L] int32, prompt_len, params, kv_bytes)`` or raises ``ValueError``
    (HTTP 400):

    - one prompt per request (one admission, one decode slot);
    - integer token ids in ``[0, vocab_size)``, as the embed path takes
      them;
    - ``prompt_len + max_new_tokens`` within the spec's position table (a
      longer sequence has no position embedding for its tail);
    - ``max_new_tokens`` (default and cap ``SPARKDL_GEN_MAX_NEW_TOKENS``)
      clamped to the cap, the bound the KV reservation is computed from.
    """
    from sparkdl_tpu_torch.models import NamedTextModel, get_model
    from sparkdl_tpu_torch.serving.generation import max_new_tokens_cap

    spec = get_model(model)  # ValueError (400) for an unknown name
    if not isinstance(spec, NamedTextModel) or not spec.supports_generate():
        raise ValueError(f"model {model!r} does not support mode='generate'")
    if payload.ndim == 1:
        payload = payload.reshape(1, -1)
    if payload.ndim != 2 or payload.shape[0] != 1:
        raise ValueError(
            "generate mode takes ONE prompt per request (shape [1, "
            f"prompt_len] or [prompt_len]); got {payload.shape}"
        )
    if not np.issubdtype(payload.dtype, np.integer) and not np.all(np.mod(payload, 1) == 0):
        raise ValueError(
            f"model {model!r} expects integer token ids; got non-integral "
            f"{payload.dtype} values"
        )
    _check_vocabulary(model, payload, spec.vocab_size)
    payload = payload.astype(np.int32, copy=False)
    prompt_len = int(payload.shape[1])
    if prompt_len < 1:
        raise ValueError("generate prompt must hold at least one token")
    params = dict(gen_params or {})
    cap = max_new_tokens_cap()
    max_new = int(params.get("max_new_tokens") or cap)
    if max_new < 1:
        raise ValueError(f"max_new_tokens must be >= 1; got {max_new}")
    max_new = min(max_new, cap)
    if prompt_len + max_new > spec.max_length:
        raise ValueError(
            f"prompt_len {prompt_len} + max_new_tokens {max_new} exceeds "
            f"model {model!r}'s position table ({spec.max_length}); shorten "
            "the prompt or request fewer tokens"
        )
    params["max_new_tokens"] = max_new
    return payload, prompt_len, params, spec.kv_bytes_per_token() * (prompt_len + max_new)


def _prepare_payload(model: str, mode: str, payload: np.ndarray, gen_params):
    """Screen and shape one admission's payload for ``model`` (``ValueError``,
    HTTP 400, when it cannot serve it). Returns ``(payload, real_tokens,
    pad_tokens, prompt_len, gen_params, kv_bytes)``; the last three are
    for generate requests, the token counts for text payloads."""
    if mode == "generate":
        payload, prompt_len, gen_params, kv_bytes = _validate_generate(
            model, payload, gen_params
        )
        return payload, 0, 0, prompt_len, gen_params, kv_bytes
    if mode == "embed" or _text_spec(model) is not None:
        # registry text models bucket whatever the mode ('features' is an
        # alias of 'embed'), so the position-table guard cannot be
        # bypassed by the alias
        payload, tokens, pad_tokens = _bucket_token_payload(model, payload)
        return payload, tokens, pad_tokens, 0, None, 0
    return payload, 0, 0, 0, None, 0


class Router:
    """Admission queue + dispatcher + completion pool over a residency
    manager. One router per serving process; :class:`ServingClient` and
    the HTTP server are thin front ends over :meth:`submit`.

    ``device``: where the default registry loader builds models (``cuda``
    by default, raising without one; ``"cpu"`` on request). ``seed``: the
    default loader's weight seed."""

    def __init__(
        self,
        loader: Optional[Callable] = None,
        budget_bytes: Optional[int] = None,
        max_batch: Optional[int] = None,
        workers: Optional[int] = None,
        device: DeviceLike = None,
        seed: int = 0,
    ):
        self.residency = ResidencyManager(
            loader=loader, budget_bytes=budget_bytes, device=device, seed=seed
        )
        self.device = self.residency.device
        self.queue = AdmissionQueue()
        self._max_batch = max_batch
        self._workers = workers or max(2, knobs.get_int("SPARKDL_SERVE_WORKERS"))
        self._lock = locksmith.lock("sparkdl_tpu_torch/serving/router.py::Router._lock")
        self._ordinal = 0
        self._dispatcher: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        #: one slot per completion worker: the dispatcher takes a slot
        #: BEFORE popping, so at most `workers` groups are ever popped but
        #: unfinished and the admission queue (where priority applies)
        #: stays the only backlog
        self._slots = threading.Semaphore(self._workers)
        self._stop = threading.Event()
        self._started = False
        self._closed = False
        #: drain state: the flag flips in drain(); the event sets once
        #: queue and in-flight groups have quiesced and models unloaded
        self._draining = False
        self._drained = threading.Event()
        self._idle_cv = locksmith.condition("sparkdl_tpu_torch/serving/router.py::Router._idle_cv")
        self._inflight = 0
        #: created by the dispatcher on the first generate admission
        self._gen_engine = None
        #: canary split state, under _lock: the Bresenham admission
        #: counter, the sticky rollback trip and POST /admin/canary's
        #: weight. The trip reads the canary counters' deltas from this
        #: router's construction (the registry is process-global).
        self._canary_count = 0
        self._canary_tripped = False
        self._canary_weight_override: Optional[float] = None
        self._canary_base_requests = metrics.counter("serve.canary.requests")
        self._canary_base_failures = metrics.counter("serve.canary.failures")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Router":
        with self._lock:
            if self._closed:
                raise Closed("Router is closed")
            if self._started:
                return self
            self._started = True
            self._stop.clear()
            self._pool = ThreadPoolExecutor(
                max_workers=self._workers,
                thread_name_prefix="sparkdl-serve-worker",
            )
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop,
                name="sparkdl-serve-dispatch",
                daemon=True,
            )
            self._dispatcher.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        """Stop admitting, fail queued requests, finish in-flight groups,
        and unload every resident model."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            dispatcher, pool = self._dispatcher, self._pool
            self._dispatcher, self._pool = None, None
        self.queue.close()
        self._stop.set()
        if dispatcher is not None and dispatcher.is_alive():
            dispatcher.join(timeout=timeout)
        if pool is not None:
            pool.shutdown(wait=True)
        self._close_generation(timeout)
        self.residency.unload_all()
        # a drain interrupted by close still terminates
        self._drained.set()

    # -- submission ---------------------------------------------------------

    def submit(
        self,
        model: str,
        payload,
        priority: str = "batch",
        deadline_s: Optional[float] = None,
        mode: str = "features",
        trace_id: Optional[str] = None,
        gen_params: Optional[dict] = None,
    ) -> Request:
        """Admit one request (raises :class:`AdmissionRejected`,
        :class:`Draining` or ``ValueError`` synchronously); the returned
        request's ``result()`` blocks for the answer. Starts the router
        lazily.

        ``mode="generate"`` admits ONE prompt for autoregressive decode
        (``gen_params``: max_new_tokens, temperature, top_k, eos_id,
        seed). Its KV-cache bytes are reserved against the budget here,
        so an over-budget sequence is refused (429) before it reaches the
        device; tokens stream through ``req.iter_tokens`` and
        ``req.result()`` returns the [1, n_new] int32 tokens."""
        from sparkdl_tpu_torch.graph.precision import (
            precision_active,
            serve_precision,
        )

        generate = mode == "generate"
        raw = np.asarray(payload)
        prepared = _prepare_payload(model, mode, raw, gen_params)
        # a canary that cannot take this payload (a smaller vocabulary, a
        # shorter position table) leaves it on the primary: screened here
        # against the canary's own spec, outside the lock
        canary = self._canary_candidate(model, mode, raw, gen_params)
        req = Request(
            model, prepared[0], priority=priority, deadline_s=deadline_s,
            mode=mode, trace_id=trace_id,
        )
        # the precision rung, resolved at admission from the SLA class:
        # it rides the grouping key and the residency key
        req.precision = serve_precision(priority)
        req.precision_armed = precision_active()
        if not self._started:
            self.start()
        if generate:
            # generation runs the generator's own f32 forward: the rungs
            # are an embed/feature arm
            req.precision, req.precision_armed = "f32", False
        # put() never blocks, so holding the lock across it keeps (assign
        # ordinal, enqueue) atomic; a rejected submit spends no ordinal.
        # The canary split counts admissions under the same lock, so the
        # routed arm is a function of admission order; the routed model's
        # payload and KV reservation are settled before the put.
        tripped_now = None
        try:
            with self._lock:
                tripped_now, routed = self._canary_resolve_locked(req, canary)
                if routed is not None:
                    prepared = routed
                    req.payload = prepared[0]
                if generate:
                    self._reserve_kv(req, *prepared[3:])
                req.ordinal = self._ordinal
                self.queue.put(req)
                self._ordinal += 1
        except BaseException as e:
            # never admitted (rejected, draining, closed): the KV
            # reservation must not strand. Shedding spends the SLO
            # budget; a drain does not.
            if isinstance(e, AdmissionRejected):
                slo.note_bad(req.priority, "rejected")
                if generate and mem_mod.is_oom_error(e):
                    mem_mod.record_oom("admission", req.model, e)
            req.release_kv()
            raise
        finally:
            # the trip is sticky: this admission alone carries its event
            if tripped_now is not None:
                self._emit_canary_rollback(tripped_now)
        tokens, pad_tokens = prepared[1], prepared[2]
        if tokens:
            metrics.inc("text.tokens", tokens)
        if pad_tokens:
            metrics.inc("text.pad_tokens", pad_tokens)
        if req.canary_arm is not None:
            metrics.inc(f"serve.{req.canary_arm}.requests")
        if req.precision_armed:
            metrics.inc(f"serve.precision.{req.precision}.requests")
            metrics.inc(f"serve.precision.{req.precision}.rows", req.rows)
        return req

    def _reserve_kv(self, req: Request, prompt_len: int, gen_params: dict, kv_bytes: int) -> None:
        """Reserve a generate request's KV-cache bytes, sized for the model
        it routes to (raises :class:`AdmissionRejected`, 429)."""
        req.gen_params, req.prompt_len = gen_params, prompt_len
        self.residency.reserve_kv(kv_bytes)
        req.kv_bytes = kv_bytes
        req._kv_release = lambda: self.residency.release_kv(kv_bytes)

    # -- canary rollout -----------------------------------------------------

    def _canary_candidate(self, model: str, mode: str, raw: np.ndarray, gen_params):
        """``(version, prepared)`` when a canary split applies to ``model``:
        ``prepared`` is the payload screened against the canary version's
        own spec, or None when the canary cannot take it (its vocabulary,
        position table or mode refuse it). None when no split applies."""
        cfg = canary_config()
        if cfg is None or str(model).lower() != cfg[0]:
            return None
        version = cfg[1]
        try:
            return version, _prepare_payload(version, mode, raw, gen_params)
        except ValueError:
            return version, None

    def _canary_resolve_locked(self, req: Request, candidate) -> tuple:
        """Apply the split to one admission (the caller holds ``_lock``):
        on the Bresenham take ``req.model`` becomes the canary version,
        and ``req.canary_arm`` is set either way. ``candidate`` is
        :meth:`_canary_candidate`'s answer. A request the canary cannot
        serve stays on the primary and leaves the counter where it was, so
        the canary's share holds over the requests it can take
        (``serve.canary.ineligible`` counts the others). Returns (the
        rollback info when this admission tripped it, the canary's
        prepared payload when it took the request)."""
        if candidate is None:
            return None, None
        cfg = canary_config()
        if cfg is None or str(req.model).lower() != cfg[0]:
            return None, None
        base, version, weight = cfg
        if self._canary_weight_override is not None:
            weight = self._canary_weight_override
        tripped_now = self._maybe_trip_canary_locked(base, version)
        req.canary_arm = "primary"
        cand_version, prepared = candidate
        if prepared is None or cand_version != version:
            metrics.inc("serve.canary.ineligible")
            return tripped_now, None
        take = False
        if not self._canary_tripped and weight > 0.0:
            n = self._canary_count
            take = math.floor((n + 1) * weight) > math.floor(n * weight)
        self._canary_count += 1
        if not take:
            return tripped_now, None
        req.model = version
        req.canary_arm = "canary"
        return tripped_now, prepared

    def _maybe_trip_canary_locked(self, base: str, version: str) -> Optional[dict]:
        """The rollback rule: the canary's failure rate (this router's
        deltas) at or over ``SPARKDL_SERVE_CANARY_TRIP_RATE`` after at
        least ``SPARKDL_SERVE_CANARY_MIN_REQUESTS`` canary requests.
        Sticky until the router is replaced."""
        if self._canary_tripped:
            return None
        reqs = metrics.counter("serve.canary.requests") - self._canary_base_requests
        if reqs < max(1, knobs.get_int("SPARKDL_SERVE_CANARY_MIN_REQUESTS")):
            return None
        fails = metrics.counter("serve.canary.failures") - self._canary_base_failures
        trip_rate = knobs.get_float("SPARKDL_SERVE_CANARY_TRIP_RATE")
        rate = fails / reqs
        if trip_rate <= 0 or rate < trip_rate:
            return None
        self._canary_tripped = True
        metrics.inc("serve.canary.rollbacks")
        return {
            "model": base,
            "version": version,
            "requests": int(reqs),
            "failures": int(fails),
            "rate": round(rate, 4),
        }

    @staticmethod
    def _emit_canary_rollback(info: dict) -> None:
        from sparkdl_tpu_torch.obs.export import append_jsonl, dump_on_failure

        append_jsonl({"kind": "canary_rollback", "ts": round(time.time(), 3), **info})
        # the failing canary requests' spans and traces are still in the
        # ring: flush it with the rollback decision attached
        dump_on_failure("canary_rollback", **info)

    def set_canary_weight(self, weight: float) -> dict:
        """Override the split weight at run time (``POST /admin/canary``),
        clamped to [0, 1]. A sticky trip stays tripped."""
        w = min(1.0, max(0.0, float(weight)))
        with self._lock:
            self._canary_weight_override = w
            tripped = self._canary_tripped
        return {"weight": w, "tripped": tripped}

    @property
    def canary_tripped(self) -> bool:
        with self._lock:
            return self._canary_tripped

    # -- graceful drain -----------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self) -> "Router":
        """Begin graceful drain: later submits raise :class:`Draining`
        (HTTP 503 + ``Retry-After``) while queued and in-flight requests
        complete. Non-blocking and idempotent; :meth:`wait_drained`
        observes the end."""
        with self._lock:
            already = self._draining
            self._draining = True
            started, closed = self._started, self._closed
            if not already:
                # under the lock submit() holds across queue.put: no
                # admission slips in after the quiesce check
                self.queue.drain()
        if already:
            return self
        metrics.inc("serve.drains")
        if closed or not started:
            self._finish_drain()
        return self

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Block until the drain completes; False on timeout."""
        return self._drained.wait(timeout=timeout)

    def _maybe_finish_drain(self) -> None:
        """Dispatcher-side quiesce check: the dispatcher is the only
        popper, so an empty queue with no group in flight while draining
        means no request is still on its way to the device."""
        if not self._draining or self._drained.is_set():
            return
        with self._idle_cv:
            if self._inflight > 0:
                return
        if self.queue.depth() == 0:
            self._finish_drain()

    def _finish_drain(self) -> None:
        if self._drained.is_set():
            return
        # quiesced: the streams are idle, and closing them unpins their
        # generators so the unload below evicts them
        self._close_generation()
        self.residency.unload_all()
        self._drained.set()

    def _close_generation(self, timeout: float = 10.0) -> None:
        with self._lock:
            engine = self._gen_engine
        if engine is not None:
            engine.close(timeout=timeout)

    def _generation_engine(self):
        from sparkdl_tpu_torch.serving.generation import GenerationEngine

        with self._lock:
            if self._gen_engine is None or self._gen_engine.closed:
                self._gen_engine = GenerationEngine(self)
            return self._gen_engine

    def _inflight_inc(self) -> None:
        with self._idle_cv:
            self._inflight += 1

    def _inflight_dec(self) -> None:
        with self._idle_cv:
            self._inflight -= 1
            self._idle_cv.notify_all()

    # -- dispatcher ---------------------------------------------------------

    @staticmethod
    def _stream_key(req: Request) -> tuple:
        # the full coordinate of one feeder stream: batch rung x seq
        # bucket x precision rung never mix
        return (
            req.model,
            req.mode,
            tuple(req.payload.shape[1:]),
            str(req.payload.dtype),
            req.precision,
        )

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            # backpressure: hold a worker slot before popping
            if not self._slots.acquire(timeout=0.2):
                continue
            submitted = False
            popped = False
            try:
                req = self.queue.pop(timeout=0.2)
                if req is None:
                    self._maybe_finish_drain()
                    continue
                if req.mode == "generate":
                    # token-level work: the engine's decode thread takes
                    # it and this worker slot frees at once; the engine
                    # carries the in-flight count until the sequence
                    # retires, so a drain waits for running generations
                    self._inflight_inc()
                    try:
                        self._generation_engine().enroll(req)
                    except RuntimeError as e:  # the stream failed to load or closed
                        req.set_error(e)
                        self._inflight_dec()
                    continue
                self._inflight_inc()
                popped = True
                group = self._assemble_group(req)
                pool = self._pool
                if pool is None:
                    self._fail_group(group)
                    return
                try:
                    pool.submit(self._serve_group_slot, group)
                    submitted = True
                except RuntimeError:  # close() raced us: pool shut down
                    self._fail_group(group)
                    return
            finally:
                if not submitted:
                    self._slots.release()
                    if popped:
                        self._inflight_dec()

    @staticmethod
    def _fail_group(group: List[Request]) -> None:
        for r in group:
            r.set_error(Closed("serving shut down"), count_failure=False)

    def _serve_group_slot(self, group: List[Request]) -> None:
        try:
            self._serve_group(group)
        finally:
            self._slots.release()
            self._inflight_dec()

    def _assemble_group(self, first: Request) -> List[Request]:
        """Grow a same-stream group from the queue: absorb everything
        already waiting (queue depth IS the load signal), and only when
        still short of the full geometry, with the strictest class under
        its p95 target, wait the batch window for late arrivals."""
        key = self._stream_key(first)
        cap = self._max_batch or max_batch_rows()
        group = [first]
        rows = first.rows
        pred = lambda r: self._stream_key(r) == key  # noqa: E731
        if rows < cap:
            group += self.queue.pop_matching(pred, cap - rows)
            rows = sum(r.rows for r in group)
        window = batch_window_s()
        if rows < cap and window > 0.0:
            strictest = min(group, key=lambda r: r.class_index).priority
            p95 = observed_p95_s(strictest)
            if p95 is None or p95 < target_p95_s(strictest):
                deadline = time.monotonic() + window
                gen = self.queue.put_generation()
                while rows < cap and time.monotonic() < deadline:
                    if self._stop.wait(timeout=min(0.001, window)):
                        break
                    new_gen = self.queue.put_generation()
                    if new_gen == gen:
                        continue  # nothing admitted since the last scan
                    gen = new_gen
                    more = self.queue.pop_matching(pred, cap - rows)
                    if more:
                        group += more
                        rows = sum(r.rows for r in group)
        return group

    # -- completion workers --------------------------------------------------

    def _serve_group(self, group: List[Request]) -> None:
        """One group end to end: deadline screening, residency acquire
        (pin), retried dispatch through the feeder stream, scatter back
        into per-request results."""
        live: List[Request] = []
        for req in group:
            if req.expired():
                metrics.inc("serve.expired")
                req.set_error(
                    DeadlineExceeded(f"request {req.id} expired before dispatch")
                )
                continue
            try:
                # chaos hook (a no-op without a fault plan), keyed by the
                # admission ordinal
                maybe_fault(
                    "serve.request", request=req.ordinal, model=req.model, cls=req.priority
                )
            except BaseException as e:  # noqa: BLE001 - an injected fault
                if mem_mod.is_oom_error(e):
                    # the {"kind": "oom"} forensics name what was resident
                    mem_mod.record_oom("dispatch", req.model, e)
                req.set_error(e)
                continue
            live.append(req)
        if not live:
            return
        try:
            policy = policy_from_env(
                "SPARKDL_SERVE_RETRY",
                max_attempts=2,
                base_delay_s=0.01,
                max_delay_s=0.5,
            )
            # acquire() runs INSIDE the retried callable: transient
            # residency contention resolves on retry
            out, starts = policy.call(self._acquire_and_dispatch, live)
            t_scatter = time.monotonic()
            for req, start in zip(live, starts):
                rows = out[start : start + req.rows]
                if any(r is None for r in rows):
                    raise RuntimeError(
                        f"serving dispatch dropped rows for request "
                        f"{req.id} ({req.model})"
                    )
                req.trace_segments["scatter"] = max(
                    0.0, time.monotonic() - t_scatter
                )
                req.set_result(np.stack(rows))
        except BaseException as e:  # noqa: BLE001 — fail, never hang
            for req in live:
                req.set_error(e)
            if mem_mod.is_oom_error(e):
                # filed once: a load that already recorded it marked it
                mem_mod.record_oom("dispatch", live[0].model, e)
            # the requests are lost after the retries: flush the flight
            # recorder naming their trace ids
            from sparkdl_tpu_torch.obs.export import dump_on_failure

            dump_on_failure(
                "serve_retry_exhausted",
                trace_id=live[0].trace_id,
                trace_ids=[r.trace_id for r in live],
                model=live[0].model,
                error=f"{type(e).__name__}: {e}",
            )

    def _acquire_and_dispatch(self, group: List[Request]):
        entry = self.residency.acquire(
            group[0].model, group[0].mode, precision=group[0].precision
        )
        try:
            return self._dispatch_once(entry, group)
        finally:
            self.residency.release(entry)

    def _dispatch_once(self, entry, group: List[Request]):
        """Pad the group to an exact multiple of its rung and push it
        through the (device_fn, geometry) feeder stream. Exact fill means
        the feeder flushes every batch at once: no linger."""
        from sparkdl_tpu_torch.runtime.feeder import get_feeder, open_handle_policy
        from sparkdl_tpu_torch.transformers.execution import default_prefetch

        t_dispatch0 = time.monotonic()
        for req in group:
            dequeued = req.dequeue_t if req.dequeue_t is not None else req.enqueue_t
            req.trace_segments["queue_wait"] = max(0.0, dequeued - req.enqueue_t)
            req.trace_segments["group_wait"] = max(0.0, t_dispatch0 - dequeued)
        rows = np.concatenate([r.payload for r in group], axis=0)
        n = int(rows.shape[0])
        rung = choose_rung(n, self._max_batch)
        n_batches = max(1, math.ceil(n / rung))
        total = n_batches * rung
        pad = total - n
        if pad:
            rows = np.concatenate(
                [rows, np.zeros((pad, *rows.shape[1:]), rows.dtype)], axis=0
            )
        out: List[Optional[np.ndarray]] = [None] * total

        def _open():
            feeder = get_feeder(
                entry.device_fn, rung, rows.shape[1:], rows.dtype,
                default_prefetch(entry.device_fn),
            )
            return feeder, feeder.open_handle(out)

        # LRU feeder eviction (or a model eviction racing a new request)
        # can close a feeder between lookup and first use: retried
        feeder, handle = open_handle_policy.call(_open)
        with span(
            "serve.dispatch", model=entry.name, rows=n, rung=rung,
            batches=n_batches, group=len(group), precision=entry.precision,
        ):
            try:
                feeder.submit_rows(handle, np.arange(total), rows)
            finally:
                try:
                    feeder.finish(handle)
                except RuntimeError:
                    pass  # feeder closed underneath us; handle failed
            handle.wait(timeout=self._dispatch_timeout_s())
        # the handle is fresh per group, so its stage_wait / drain_wait
        # are this group's; the rest of the wall is the dispatch segment
        wall = max(0.0, time.monotonic() - t_dispatch0)
        segs = handle.segments_snapshot()
        stage_wait = min(wall, max(0.0, segs.get("stage_wait", 0.0)))
        drain_wait = min(wall - stage_wait, max(0.0, segs.get("drain_wait", 0.0)))
        for req in group:
            req.trace_segments["stage_wait"] = stage_wait
            req.trace_segments["dispatch"] = max(0.0, wall - stage_wait - drain_wait)
            req.trace_segments["drain_wait"] = drain_wait
        # counted only once the group's results landed: a retried attempt
        # must not count twice
        metrics.record_times(
            "serve.queue_wait", [r.trace_segments["queue_wait"] for r in group]
        )
        metrics.record_times(
            "serve.group_wait", [r.trace_segments["group_wait"] for r in group]
        )
        metrics.record_times("serve.batch_rows", [float(rung)] * n_batches)
        metrics.inc("serve.dispatches", n_batches)
        metrics.inc(f"serve.dispatches.{entry.name}.{entry.precision}", n_batches)
        metrics.inc("serve.dispatched_rows", n)
        flops_per_row = entry.flops_per_item
        if entry.flops_fn is not None and rows.ndim == 2:
            # a token dispatch: the FLOPs of the sequence bucket that ran
            flops_per_row = entry.flops_fn(int(rows.shape[1]))
        if flops_per_row:
            # the real rows that landed (padding is device time, not
            # goodput), with the other landed-only counts
            from sparkdl_tpu_torch.obs import utilization

            utilization.note_flops(flops_per_row * n)
        if pad:
            metrics.inc("serve.pad_rows", pad)
        starts = []
        off = 0
        for req in group:
            starts.append(off)
            off += req.rows
        return out, starts

    @staticmethod
    def _dispatch_timeout_s() -> float:
        """Hard bound on one group's device wait
        (``SPARKDL_SERVE_DISPATCH_TIMEOUT_S``, default 120)."""
        return knobs.get_float("SPARKDL_SERVE_DISPATCH_TIMEOUT_S")

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """Live status for ``/v1/models`` and the CLI."""
        per_class: Dict[str, dict] = {}
        for cls in PRIORITY_CLASSES:
            stat = metrics.timing(f"serve.latency.{cls}")
            if stat is None or not stat.count:
                continue
            per_class[cls] = {
                "count": stat.count,
                "p50_ms": round(stat.percentile(50) * 1e3, 2),
                "p95_ms": round(stat.percentile(95) * 1e3, 2),
            }
        out = {
            "device": str(self.device),
            "queue_depth_rows": self.queue.depth_rows(),
            "queued_requests": self.queue.depth(),
            "models": self.residency.models(),
            "latency": per_class,
            "admitted": int(metrics.counter("serve.admitted")),
            "completed": int(metrics.counter("serve.completed")),
            "rejected": int(metrics.counter("serve.rejected")),
            "expired": int(metrics.counter("serve.expired")),
            "failures": int(metrics.counter("serve.failures")),
            "evictions": int(metrics.counter("serve.evictions")),
            "draining": self._draining,
        }
        engine = self._gen_engine
        if engine is not None:
            out["generation"] = engine.status()
        from sparkdl_tpu_torch.graph.precision import PRECISIONS, precision_active

        if precision_active():
            arms = {}
            for p in PRECISIONS:
                reqs = int(metrics.counter(f"serve.precision.{p}.requests"))
                if not reqs:
                    continue
                arm = {"requests": reqs}
                stat = metrics.timing(f"serve.precision.{p}.latency")
                if stat is not None and stat.count:
                    arm["p95_ms"] = round(stat.percentile(95) * 1e3, 2)
                arms[p] = arm
            if arms:
                out["precision"] = arms
        try:
            slo_status = slo.engine_status()
        except ValueError as e:
            # a malformed SLO knob must not take /v1/models down; GET
            # /v1/slo raises it
            slo_status = {"armed": True, "error": str(e)}
        if slo_status is not None:
            out["slo"] = slo_status
        from sparkdl_tpu_torch.obs import utilization

        util = utilization.utilization_status()
        if util is not None:
            out["utilization"] = util
        mem = mem_mod.memory_status()
        if mem is not None:
            try:
                mem["budget_bytes"] = self.residency.budget_bytes()
            except ValueError:
                mem["budget_bytes"] = None  # a malformed knob: stats stay up
            out["memory"] = mem
        cfg = canary_config()
        if cfg is not None:
            base, version, weight = cfg
            with self._lock:
                if self._canary_weight_override is not None:
                    weight = self._canary_weight_override
                tripped = self._canary_tripped
            out["canary"] = {
                "model": base,
                "version": version,
                "weight": weight,
                "requests": int(metrics.counter("serve.canary.requests") - self._canary_base_requests),
                "failures": int(metrics.counter("serve.canary.failures") - self._canary_base_failures),
                "tripped": tripped,
            }
        return out


__all__ = [
    "Router",
    "batch_window_s",
    "canary_config",
    "choose_rung",
    "choose_seq_bucket",
    "max_batch_rows",
    "observed_p95_s",
    "target_p95_s",
]
