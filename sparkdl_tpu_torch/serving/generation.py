"""Autoregressive generation engine: token-level continuous batching.

The port of the JAX package's ``serving/generation.py``. The embed path's
unit of device work is a group of rows that dispatch and complete
together. Decode cannot live on that shape: one sequence is many
single-token steps, and grouping by request would make every sequence
wait for the longest in its batch. This engine regroups per token:

- each ``(model, precision)`` gets one :class:`GenStream`: a decode
  thread, a table of ``SPARKDL_GEN_MAX_SEQS`` slots and ONE K/V slab
  (``BertGenerator.new_cache``) that the slots share;
- every loop iteration advances all occupied slots one token through one
  ``decode_step`` over the fixed ``(slots, max_length)`` cache;
- a new sequence joins the running batch at a prefill boundary: its
  prompt runs the (sequence-bucketed) prefill, its K/V block lands in a
  free slot, and the next decode step carries it beside sequences
  admitted earlier (``gen.joins``);
- a finished sequence frees its slot at once, for the next admission
  (``gen.slot_reuse``);
- when the last slot empties the stream drops the slab, so the device's
  allocated bytes return to what they were before the sequences came.

KV-cache bytes are reserved by the router at admission
(``ResidencyManager.reserve_kv``: ``kv_bytes_per_token x (prompt +
max_new)``, refusal is HTTP 429) and released by the request's completion,
whichever path completes it. The memory ledger (``obs/memory.py``)
charges them to its ``kv_cache`` class at slot assignment and frees them
when the sequence retires; an allocation failure at load, prefill or
decode is filed there as an ``{"kind": "oom"}`` event.

Tokens stream back as they land (``Request.push_token``, read by the HTTP
layer's chunked reply), and each sequence's ``decode`` trace segment sums
the wall time of the steps it rode.

On CUDA the decode thread hands its prefills and decode steps to the
device's launch thread (``runtime/device.Launcher``), which issues every
forward of the serving path, on the device's compute stream; the decode
thread itself only waits for each step's logits ([slots, vocab] float32),
copied back on that stream.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from sparkdl_tpu_torch.obs import memory as mem_mod
from sparkdl_tpu_torch.obs import span
from sparkdl_tpu_torch.runtime import knobs, locksmith
from sparkdl_tpu_torch.runtime.device import compute_stream, launcher
from sparkdl_tpu_torch.serving.request import Closed, DeadlineExceeded, Request
from sparkdl_tpu_torch.utils.metrics import metrics


def max_seqs() -> int:
    """Decode slots per stream (``SPARKDL_GEN_MAX_SEQS``, default 8): the
    token-level counterpart of ``SPARKDL_SERVE_MAX_BATCH``."""
    return max(1, knobs.get_int("SPARKDL_GEN_MAX_SEQS"))


def max_new_tokens_cap() -> int:
    """Default and cap of a request's ``max_new_tokens``
    (``SPARKDL_GEN_MAX_NEW_TOKENS``, default 64): the bound the KV
    reservation is computed from."""
    return max(1, knobs.get_int("SPARKDL_GEN_MAX_NEW_TOKENS"))


class _Seq:
    """One active sequence in a decode slot."""

    __slots__ = (
        "req", "slot", "length", "last_token", "emitted", "max_new",
        "eos_id", "temperature", "top_k", "rng", "kv_noted",
    )

    def __init__(self, req: Request, slot: int):
        gp = req.gen_params or {}
        self.req = req
        self.slot = slot
        #: whether the memory ledger holds this sequence's KV charge
        self.kv_noted = False
        #: tokens so far (prompt + emitted): the next decode step writes
        #: ``last_token`` at position ``length - 1``
        self.length = req.prompt_len
        self.last_token = 0
        self.emitted: List[int] = []
        self.max_new = int(gp.get("max_new_tokens", 1))
        self.eos_id = gp.get("eos_id")
        self.temperature = float(gp.get("temperature") or 0.0)
        self.top_k = int(gp.get("top_k") or 0)
        #: per request: a seeded request replays exactly, whichever slots
        #: its batchmates hold
        self.rng = np.random.default_rng(int(gp.get("seed") or 0))

    def sample(self, logits: np.ndarray) -> int:
        """The next token from one row of logits: greedy at temperature 0
        (the oracle-comparable mode), else a temperature softmax with an
        optional top-k cut."""
        if self.temperature <= 0.0:
            return int(np.argmax(logits))
        scaled = logits.astype(np.float64) / self.temperature
        if 0 < self.top_k < scaled.shape[0]:
            kth = np.partition(scaled, -self.top_k)[-self.top_k]
            scaled = np.where(scaled >= kth, scaled, -np.inf)
        scaled -= scaled.max()
        probs = np.exp(scaled)
        probs /= probs.sum()
        return int(self.rng.choice(scaled.shape[0], p=probs))

    def finished(self, token: int) -> bool:
        return len(self.emitted) >= self.max_new or (
            self.eos_id is not None and token == int(self.eos_id)
        )


class GenStream:
    """One model's continuous-batching decode stream.

    The decode thread owns all slot state (the active table, the K/V
    slab); the condition guards only the hand-off (``_pending``, the stop
    flag, the status counters), and no device work runs under it."""

    def __init__(self, engine: "GenerationEngine", model: str, precision: str):
        self._router = engine.router
        self.model = model
        self.precision = precision
        self._cv = locksmith.condition("sparkdl_tpu_torch/serving/generation.py::GenStream._cv")
        self._pending: deque = deque()
        self._stop = False
        self._failed: Optional[BaseException] = None
        self._active_count = 0
        self._tokens_out = 0
        self._entry = None  # the pinned generate-mode ResidentModel
        self._generator = None
        self._slots = max_seqs()
        self._used_slots: set = set()
        device = self._router.device
        self._stream = compute_stream(device) if device.type == "cuda" else None
        self._launcher = launcher(device) if device.type == "cuda" else None
        self._thread = threading.Thread(
            target=self._run, name=f"sparkdl-gen-{model}", daemon=True
        )
        self._thread.start()

    # -- hand-off (dispatcher side) ------------------------------------------

    def enroll(self, req: Request) -> None:
        """Queue one admitted request for a slot. Raises if the stream's
        model failed to load or the stream is closed; the dispatcher then
        fails the request."""
        with self._cv:
            if self._failed is not None:
                raise RuntimeError(
                    f"generation stream for {self.model!r} failed to load: "
                    f"{self._failed}"
                ) from self._failed
            if self._stop:
                raise Closed("generation stream is closed")
            self._pending.append(req)
            self._cv.notify()

    def close(self, timeout: float = 10.0) -> None:
        """Stop the decode thread; what it still held fails as a shutdown
        (not counted as a failure)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)

    def status(self) -> dict:
        with self._cv:
            return {
                "model": self.model,
                "slots": self._slots,
                "active": self._active_count,
                "pending": len(self._pending),
                "tokens_out": self._tokens_out,
            }

    # -- device calls ---------------------------------------------------------

    def _on_device(self, fn, *args):
        """Run ``fn(*args)`` where the serving path issues device work: on
        the CPU here, on CUDA on the device's launch thread and compute
        stream."""
        if self._launcher is None:
            return fn(*args)

        def issue():
            with torch.cuda.stream(self._stream):
                return fn(*args)

        return self._launcher.run(issue)

    def _to_host(self, logits: torch.Tensor) -> np.ndarray:
        """The logits on the host, copied on the stream that made them
        (the copy waits for them; the launch thread does not)."""
        if self._stream is None:
            return logits.numpy()
        with torch.cuda.stream(self._stream):
            return logits.cpu().numpy()

    # -- decode thread --------------------------------------------------------

    def _run(self) -> None:
        try:
            self._entry = self._router.residency.acquire(
                self.model, "generate", precision=self.precision
            )
            self._generator = self._entry.model_function
            if self._stream is not None:
                # the weights were written on this thread's stream: the
                # compute stream waits for them once
                self._stream.wait_stream(torch.cuda.current_stream(self._router.device))
        except Exception as e:  # noqa: BLE001 - the load failed
            if mem_mod.is_oom_error(e):
                mem_mod.record_oom("load", self.model, e)
            with self._cv:
                self._failed = e
                doomed = list(self._pending)
                self._pending.clear()
            for req in doomed:
                self._retire_error(req, e)
            return
        active: Dict[int, _Seq] = {}
        cache = None  # (k_cache, v_cache) while any slot is occupied
        try:
            while True:
                with self._cv:
                    while not self._stop and not self._pending and not active:
                        self._cv.wait(timeout=0.2)
                    if self._stop:
                        break
                    newly: List[Request] = []
                    while self._pending and len(active) + len(newly) < self._slots:
                        newly.append(self._pending.popleft())
                for req in newly:
                    if cache is None:
                        cache = self._on_device(self._generator.new_cache, self._slots)
                    self._admit(req, active, cache)
                if active:
                    self._step(active, cache)
                if not active:
                    # idle: drop the slab, so the device's allocated bytes
                    # return to their value before these sequences
                    cache = None
                with self._cv:
                    self._active_count = len(active)
                metrics.gauge("gen.active_seqs", len(active))
        except Exception as e:  # noqa: BLE001 - fail, never hang
            if mem_mod.is_oom_error(e):
                mem_mod.record_oom("decode", self.model, e)
            with self._cv:
                # the next admission builds a fresh stream
                self._failed = e
            for seq in list(active.values()):
                self._retire(seq, active, error=e)
        finally:
            shutdown = Closed("serving shut down")
            for seq in list(active.values()):
                self._retire(seq, active, error=shutdown, count_failure=False)
            with self._cv:
                doomed = list(self._pending)
                self._pending.clear()
                self._active_count = 0
            for req in doomed:
                self._retire_error(req, shutdown, count_failure=False)
            metrics.gauge("gen.active_seqs", 0)
            self._router.residency.release(self._entry)
            self._entry = self._generator = None

    def _admit(self, req: Request, active: Dict[int, _Seq], cache) -> None:
        """Prefill one request into a free slot. The first new token comes
        from the prefill's logits (the oracle's first step); a sequence
        that this already finishes retires without taking a decode slot."""
        from sparkdl_tpu_torch.text.bucketing import next_bucket

        now = time.monotonic()
        if req.expired(now):
            metrics.inc("serve.expired")
            self._retire_error(
                req, DeadlineExceeded(f"request {req.id} ({req.model}) expired before prefill")
            )
            return
        dequeued = req.dequeue_t if req.dequeue_t is not None else req.enqueue_t
        req.trace_segments["queue_wait"] = max(0.0, dequeued - req.enqueue_t)
        req.trace_segments["group_wait"] = max(0.0, now - dequeued)
        slot = next(s for s in range(self._slots) if s not in active)
        gen = self._generator
        length = req.prompt_len
        bucket = max(length, min(next_bucket(length), gen.max_length))
        prompt = np.zeros((1, bucket), np.int64)
        prompt[0, :length] = np.asarray(req.payload).reshape(-1)

        def prefill():
            k, v, logits = gen.prefill(prompt, length)
            gen.write_prefill(*cache, slot, k, v)
            return logits[0]

        t0 = time.monotonic()
        try:
            with span("gen.prefill", model=self.model, tokens=length, bucket=bucket,
                      slot=slot, trace_id=req.trace_id):
                logits = self._to_host(self._on_device(prefill))
        except Exception as e:  # noqa: BLE001 - fail this sequence only
            if mem_mod.is_oom_error(e):
                mem_mod.record_oom("prefill", self.model, e)
            self._retire_error(req, e)
            return
        dt = time.monotonic() - t0
        req.trace_segments["dispatch"] = dt
        metrics.record_time("gen.prefill_ms", dt * 1e3)
        seq = _Seq(req, slot)
        mem_mod.note_kv_alloc(req.kv_bytes)
        seq.kv_noted = True
        metrics.inc("gen.seqs")
        if active:
            # the continuous-batching event: this prefill landed while
            # others were mid-decode, and the next step carries them all
            metrics.inc("gen.joins")
        if slot in self._used_slots:
            metrics.inc("gen.slot_reuse")
        self._used_slots.add(slot)
        token = seq.sample(logits)
        self._emit(seq, token)
        if seq.finished(token):
            self._retire(seq, None)
        else:
            active[slot] = seq

    def _step(self, active: Dict[int, _Seq], cache) -> None:
        """One decode step: every occupied slot advances one token; free
        slots ride along with token 0 at position 0."""
        now = time.monotonic()
        for seq in list(active.values()):
            if seq.req.expired(now):
                metrics.inc("serve.expired")
                self._retire(seq, active, error=DeadlineExceeded(
                    f"request {seq.req.id} ({seq.req.model}) expired after "
                    f"{len(seq.emitted)} tokens"
                ))
        if not active:
            return
        tokens = np.zeros(self._slots, np.int64)
        positions = np.zeros(self._slots, np.int64)
        for slot, seq in active.items():
            tokens[slot] = seq.last_token
            positions[slot] = seq.length - 1
        t0 = time.monotonic()
        logits = self._to_host(
            self._on_device(lambda: self._generator.decode_step(*cache, tokens, positions)[2])
        )
        dt = time.monotonic() - t0
        metrics.record_time("gen.decode_step_ms", dt * 1e3)
        metrics.inc("gen.decode_steps")
        for slot, seq in list(active.items()):
            seq.req.trace_segments["decode"] += dt
            token = seq.sample(logits[slot])
            self._emit(seq, token)
            if seq.finished(token):
                self._retire(seq, active)

    def _emit(self, seq: _Seq, token: int) -> None:
        seq.req.push_token(token, len(seq.emitted))
        seq.emitted.append(token)
        seq.last_token = token
        seq.length += 1
        with self._cv:
            self._tokens_out += 1
        metrics.inc("gen.tokens_out")

    # -- retirement -----------------------------------------------------------

    def _retire(
        self,
        seq: _Seq,
        active: Optional[Dict[int, _Seq]],
        error: Optional[BaseException] = None,
        count_failure: bool = True,
    ) -> None:
        """Finish one slotted sequence: free its slot and complete the
        request (whose completion releases its KV reservation)."""
        if active is not None:
            active.pop(seq.slot, None)
        if seq.kv_noted:
            mem_mod.note_kv_free(seq.req.kv_bytes)
            seq.kv_noted = False
        req = seq.req
        req.trace_segments["scatter"] = 0.0
        if error is not None:
            req.set_error(error, count_failure=count_failure)
        else:
            req.set_result(np.asarray([seq.emitted], np.int32).reshape(1, -1))
        self._router._inflight_dec()

    def _retire_error(
        self, req: Request, error: BaseException, count_failure: bool = True
    ) -> None:
        """Fail a request that never reached a slot (expired while pending,
        load failure, shutdown)."""
        req.set_error(error, count_failure=count_failure)
        self._router._inflight_dec()


class GenerationEngine:
    """The router's :class:`GenStream` s, keyed by ``(model, precision)``
    like the residency table. The router's dispatcher creates it on the
    first generate admission; the router's close and drain close it."""

    def __init__(self, router):
        self.router = router
        self._lock = locksmith.lock("sparkdl_tpu_torch/serving/generation.py::GenerationEngine._lock")
        self._streams: Dict[tuple, GenStream] = {}
        self._closed = False

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def enroll(self, req: Request) -> None:
        key = (str(req.model).lower(), req.precision or "f32")
        with self._lock:
            if self._closed:
                raise Closed("generation engine is closed")
            stream = self._streams.get(key)
            if stream is not None and stream._failed is not None:
                # a failed load is not sticky: the next admission retries
                # it, as the embed path's residency acquire does
                stream = None
            if stream is None:
                stream = self._streams[key] = GenStream(self, key[0], key[1])
        stream.enroll(req)

    def close(self, timeout: float = 10.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            streams = list(self._streams.values())
            self._streams.clear()
        for s in streams:
            s.close(timeout=timeout)

    def status(self) -> dict:
        with self._lock:
            streams = list(self._streams.values())
        rows = [s.status() for s in streams]
        return {
            "streams": rows,
            "active_seqs": sum(r["active"] for r in rows),
            "pending_seqs": sum(r["pending"] for r in rows),
            "tokens_out": int(metrics.counter("gen.tokens_out")),
            "seqs": int(metrics.counter("gen.seqs")),
            "joins": int(metrics.counter("gen.joins")),
            "slot_reuse": int(metrics.counter("gen.slot_reuse")),
            "kv_rejected": int(metrics.counter("gen.kv_rejected")),
        }


__all__ = ["GenStream", "GenerationEngine", "max_new_tokens_cap", "max_seqs"]
