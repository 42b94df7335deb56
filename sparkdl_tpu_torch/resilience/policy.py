"""Unified retry policy: backoff, deadline, retryable-vs-fatal.

A copy of the JAX package's ``resilience/policy.py`` (host code, no
device): one :class:`RetryPolicy` shared by the call sites that retry —
here the feeder's handle-open race and the serving router's group
dispatch. Backoff jitter is a pure function of ``(seed, attempt)``, so a
replay with the same seed sleeps the same schedule.

Two ways to consume a policy:

- ``policy.call(fn)``: the whole loop in one call: run ``fn``, classify
  failures, sleep the backoff, re-raise the last error on exhaustion;
- the primitives ``classify`` / ``allows`` / ``delay_s``, for call sites
  that own their loop.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple


class FatalError(Exception):
    """An error that no :class:`RetryPolicy` will ever retry. Raise it
    (or wrap a cause in it) from inside a retried callable to mean
    "stop — more attempts cannot help": bad configuration, a pinned
    digest mismatch, an assertion about the world that failed."""


class RetryBudgetExceeded(RuntimeError):
    """Raised by :meth:`RetryPolicy.call` when the deadline expires with
    the work still failing (distinct from attempt exhaustion, which
    re-raises the last underlying error)."""


def _jitter_factor(seed: int, attempt: int, spread: float) -> float:
    """Deterministic jitter multiplier in ``[1 - spread, 1 + spread]``:
    a pure hash of (seed, attempt), so every process/replay that shares
    the seed sleeps the same schedule. sha256 rather than ``hash()``:
    PYTHONHASHSEED must not leak into the schedule."""
    if spread <= 0.0:
        return 1.0
    h = hashlib.sha256(f"retry|{seed}|{attempt}".encode()).digest()
    unit = int.from_bytes(h[:8], "big") / float(1 << 64)  # [0, 1)
    return 1.0 - spread + 2.0 * spread * unit


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + deterministic jitter + error classification.

    ``retryable``/``fatal`` are exception-class tuples: ``fatal`` wins,
    then ``retryable`` must match for a retry (default: any
    ``Exception``). ``classify_fn`` (exc -> True/False/None) runs first
    and can overrule both; ``None`` falls through to the class check.
    :class:`FatalError` is always fatal. ``deadline_s`` bounds the WHOLE
    loop (attempts + sleeps), not one attempt."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 5.0
    jitter: float = 0.25
    deadline_s: Optional[float] = None
    seed: int = 0
    retryable: Tuple[type, ...] = (Exception,)
    fatal: Tuple[type, ...] = ()
    classify_fn: Optional[Callable[[BaseException], Optional[bool]]] = field(
        default=None, compare=False
    )

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    # -- primitives (call sites that own their loop) -------------------------

    def classify(self, exc: BaseException) -> bool:
        """True if ``exc`` is worth another attempt under this policy."""
        if isinstance(exc, FatalError):
            return False
        if self.classify_fn is not None:
            verdict = self.classify_fn(exc)
            if verdict is not None:
                return bool(verdict)
        if self.fatal and isinstance(exc, self.fatal):
            return False
        return isinstance(exc, self.retryable)

    def allows(self, next_attempt: int, elapsed_s: float = 0.0) -> bool:
        """May attempt number ``next_attempt`` (0-based) start, given the
        time already spent? Attempt 0 is always allowed — a deadline can
        cut retries short but never the first try."""
        if next_attempt == 0:
            return True
        if next_attempt >= self.max_attempts:
            return False
        if self.deadline_s is not None and elapsed_s >= self.deadline_s:
            return False
        return True

    def delay_s(self, attempt: int) -> float:
        """Backoff before retrying after failed attempt ``attempt``
        (0-based): ``base * multiplier**attempt`` capped at
        ``max_delay_s``, scaled by the deterministic jitter factor."""
        if self.base_delay_s <= 0.0:
            return 0.0
        raw = self.base_delay_s * (self.multiplier ** attempt)
        return min(raw, self.max_delay_s) * _jitter_factor(
            self.seed, attempt, self.jitter
        )

    # -- the whole loop ------------------------------------------------------

    def call(
        self,
        fn: Callable,
        *args,
        on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
        sleep: Callable[[float], None] = time.sleep,
        **kwargs,
    ):
        """Run ``fn(*args, **kwargs)`` under this policy. On a retryable
        failure with budget left, calls ``on_retry(attempt, exc,
        delay_s)`` (metrics/log hook), sleeps, and tries again. On
        exhaustion or a fatal error the LAST exception re-raises
        unchanged — callers keep their exception types. A deadline that
        expires mid-loop raises :class:`RetryBudgetExceeded` from the
        last error instead, so "too slow" is distinguishable from
        "failed N times"."""
        t0 = time.monotonic()
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except Exception as exc:
                if not self.classify(exc):
                    raise
                elapsed = time.monotonic() - t0
                if not self.allows(attempt + 1, elapsed):
                    if (
                        self.deadline_s is not None
                        and elapsed >= self.deadline_s
                        and attempt + 1 < self.max_attempts
                    ):
                        raise RetryBudgetExceeded(
                            f"retry deadline {self.deadline_s}s exceeded "
                            f"after {attempt + 1} attempts: "
                            f"{type(exc).__name__}: {exc}"
                        ) from exc
                    raise
                delay = self.delay_s(attempt)
                if on_retry is not None:
                    on_retry(attempt, exc, delay)
                if delay > 0.0:
                    sleep(delay)
                attempt += 1


def policy_from_env(prefix: str, **defaults) -> RetryPolicy:
    """A :class:`RetryPolicy` with field defaults overridable via
    ``<PREFIX>_ATTEMPTS`` / ``_BASE_MS`` / ``_MAX_MS`` / ``_DEADLINE_S``
    / ``_SEED`` — the knob surface of the retrying call sites
    (the ``*_RETRY`` families). Malformed values raise a named error: a
    typo'd knob fails loudly instead of silently using the defaults.
    Reads go through the knob registry, which also validates that a
    ``SPARKDL_*`` prefix is declared; other prefixes (tests) pass
    through undeclared."""
    from sparkdl_tpu_torch.runtime import knobs

    def _num(suffix: str, cast, key: str, scale: float = 1.0):
        raw = knobs.get_raw(f"{prefix}_{suffix}")
        if raw is None or raw == "":
            return
        try:
            defaults[key] = cast(float(raw) * scale)
        except ValueError:
            raise ValueError(
                f"{prefix}_{suffix}={raw!r} is not numeric"
            ) from None

    _num("ATTEMPTS", int, "max_attempts")
    _num("BASE_MS", float, "base_delay_s", 1e-3)
    _num("MAX_MS", float, "max_delay_s", 1e-3)
    _num("DEADLINE_S", float, "deadline_s")
    _num("SEED", int, "seed")
    return RetryPolicy(**defaults)
