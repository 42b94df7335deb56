"""Deterministic, env-gated fault injection for the recovery paths.

A copy of the JAX package's ``resilience/faults.py``: the same grammar,
claims, coin and event, so one fault plan means the same thing to either
package. An env var describes exactly which hook point fires, when and
how, so a chaos run can kill rank 0 at its 7th request today and replay
the identical failure tomorrow.

Grammar (``SPARKDL_FAULT_PLAN``)::

    plan  := rule (';' rule)*
    rule  := term (':' term)*
    term  := key '=' value | 'crash'
    key   := site | rank | partition | attempt | request | model | cls
             | ... | times | p | raise | sleep | exit

    site=serve.request:rank=0:request=6:crash
    partition=4:attempt=0:raise=IOError
    site=feeder.dispatch:times=2:raise=RuntimeError
    site=serve.request:raise=torch.cuda.OutOfMemoryError

Match keys compare against the coordinates the hook passes to
:func:`maybe_fault` (plus ``site``, the hook's name, and ``rank``
defaulted from ``SPARKDL_OBS_RANK``); a key the hook did not supply never
matches, an omitted key is a wildcard. Actions: ``crash``
(``os._exit(CRASH_EXIT_CODE)``, the SIGKILL-shaped death that strands a
gang's peers), ``raise=<ExcName>`` (a builtin or ``pkg.mod.Cls``,
resolved through importlib: ``torch.cuda.OutOfMemoryError`` as any
other), ``exit=<code>``, ``sleep=<seconds>``. Exactly one action a rule.

``times`` (default 1) caps how often a rule fires. Within one process the
count is in memory; when ``SPARKDL_FAULT_STATE`` names a directory,
firings claim ``claim.<rule>.<n>`` files there with ``O_EXCL``, so the cap
holds **across processes and gang generations**: a crash that killed
generation 0's rank 0 does not fire again in generation 1. ``p`` gates a
matching rule on a pure hash of ``(SPARKDL_FAULT_SEED, rule,
match-ordinal)``, never a live RNG. Every firing bumps
``faults.injected`` and appends a ``{"kind": "fault"}`` JSONL event before
it acts.

Hook points: the executor's partition loop (``site=executor.partition``),
the feeder's owner thread before a dispatch (``site=feeder.dispatch``)
the serving router's per-request path (``site=serve.request``,
coordinates ``request``/``model``/``cls``) and the batch gang worker's
partition loop (``site=worker.partition``, coordinates
``rank``/``step``/``partition``/``gen``). A hook costs one env lookup
when no plan is set.
"""

from __future__ import annotations

import builtins
import hashlib
import importlib
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from sparkdl_tpu_torch.runtime import knobs, locksmith

PLAN_ENV = "SPARKDL_FAULT_PLAN"
STATE_ENV = "SPARKDL_FAULT_STATE"
SEED_ENV = "SPARKDL_FAULT_SEED"

#: Exit code for ``crash`` — distinctive enough that a supervisor log
#: reading "rank died rc=77" points at the plan, not at the workload.
CRASH_EXIT_CODE = 77

_ACTIONS = ("crash", "raise", "exit", "sleep")
_META_KEYS = ("times", "p")


class FaultPlanError(ValueError):
    """A fault plan that does not parse. Raised eagerly and loudly: a
    chaos run with a typo'd plan must not silently run fault-free."""


@dataclass(frozen=True)
class FaultRule:
    """One parsed rule: match coordinates + a single action."""

    index: int
    source: str
    action: str
    arg: Optional[str]
    match: Tuple[Tuple[str, str], ...]
    times: int = 1  # 0 = unlimited
    p: Optional[float] = None

    def matches(self, coords: Dict[str, object]) -> bool:
        for key, want in self.match:
            have = coords.get(key)
            if have is None:
                return False
            if str(have) != want:
                return False
        return True


def parse_plan(plan: str) -> List[FaultRule]:
    """Parse a ``SPARKDL_FAULT_PLAN`` string into rules (see module
    docstring for the grammar)."""
    rules: List[FaultRule] = []
    for index, chunk in enumerate(
        c.strip() for c in plan.split(";") if c.strip()
    ):
        match: List[Tuple[str, str]] = []
        action: Optional[str] = None
        arg: Optional[str] = None
        times = 1
        p: Optional[float] = None
        for term in (t.strip() for t in chunk.split(":")):
            if not term:
                raise FaultPlanError(
                    f"fault rule {chunk!r}: empty term (stray ':')"
                )
            if term == "crash":
                key, val = "crash", None
            elif "=" in term:
                key, _, val = term.partition("=")
                key, val = key.strip(), val.strip()
                if not key or val == "":
                    raise FaultPlanError(
                        f"fault rule {chunk!r}: malformed term {term!r}"
                    )
            else:
                raise FaultPlanError(
                    f"fault rule {chunk!r}: term {term!r} is neither "
                    f"'key=value' nor 'crash'"
                )
            if key in _ACTIONS:
                if action is not None:
                    raise FaultPlanError(
                        f"fault rule {chunk!r}: two actions "
                        f"({action!r} and {key!r})"
                    )
                action, arg = key, val
                if key == "sleep":
                    try:
                        float(val)
                    except (TypeError, ValueError):
                        raise FaultPlanError(
                            f"fault rule {chunk!r}: sleep={val!r} is not "
                            f"a number of seconds"
                        ) from None
                elif key == "exit":
                    try:
                        int(val)
                    except (TypeError, ValueError):
                        raise FaultPlanError(
                            f"fault rule {chunk!r}: exit={val!r} is not "
                            f"an integer exit code"
                        ) from None
            elif key == "times":
                try:
                    times = int(val)
                except (TypeError, ValueError):
                    raise FaultPlanError(
                        f"fault rule {chunk!r}: times={val!r} is not an "
                        f"integer"
                    ) from None
                if times < 0:
                    raise FaultPlanError(
                        f"fault rule {chunk!r}: times must be >= 0 "
                        f"(0 = unlimited)"
                    )
            elif key == "p":
                try:
                    p = float(val)
                except (TypeError, ValueError):
                    raise FaultPlanError(
                        f"fault rule {chunk!r}: p={val!r} is not a "
                        f"probability"
                    ) from None
                if not 0.0 <= p <= 1.0:
                    raise FaultPlanError(
                        f"fault rule {chunk!r}: p={p} outside [0, 1]"
                    )
            else:
                match.append((key, val))
        if action is None:
            raise FaultPlanError(
                f"fault rule {chunk!r}: no action (one of "
                f"{', '.join(_ACTIONS)})"
            )
        rules.append(
            FaultRule(
                index=index,
                source=chunk,
                action=action,
                arg=arg,
                match=tuple(match),
                times=times,
                p=p,
            )
        )
    if not rules:
        raise FaultPlanError(f"fault plan {plan!r} contains no rules")
    return rules


def _resolve_exception(name: str) -> type:
    """``IOError`` (builtin) or ``pkg.mod.Cls`` -> the exception class."""
    cls = getattr(builtins, name, None)
    if cls is None and "." in name:
        mod_name, _, cls_name = name.rpartition(".")
        try:
            cls = getattr(importlib.import_module(mod_name), cls_name, None)
        except ImportError:
            cls = None
    if not (isinstance(cls, type) and issubclass(cls, BaseException)):
        raise FaultPlanError(
            f"raise={name!r}: not a builtin or importable exception class"
        )
    return cls


# -- plan cache + firing state ------------------------------------------------

_state_lock = locksmith.lock(
    "sparkdl_tpu_torch/resilience/faults.py::_state_lock"
)
_plan_cache: Tuple[Optional[str], List[FaultRule]] = (None, [])
#: per-process: rule index -> number of MATCHES so far (feeds the p-coin
#: ordinal) and number of FIRES (the times cap when no state dir).
_match_counts: Dict[int, int] = {}
_fire_counts: Dict[int, int] = {}


def _rules_for_env() -> List[FaultRule]:
    global _plan_cache
    plan = knobs.get_str(PLAN_ENV)
    if not plan:
        return []
    with _state_lock:
        cached_plan, rules = _plan_cache
        if cached_plan == plan:
            return rules
    rules = parse_plan(plan)  # may raise FaultPlanError — loudly
    with _state_lock:
        _plan_cache = (plan, rules)
        _match_counts.clear()
        _fire_counts.clear()
    return rules


def reset_state() -> None:
    """Forget per-process match/fire counts (tests)."""
    global _plan_cache
    with _state_lock:
        _plan_cache = (None, [])
        _match_counts.clear()
        _fire_counts.clear()


def _claim_fire(rule: FaultRule) -> bool:
    """Atomically claim one firing of ``rule`` against its ``times`` cap.
    With ``SPARKDL_FAULT_STATE`` set, claims are ``O_EXCL`` files shared
    by every process of the job (generations included); otherwise the
    count is per-process."""
    if rule.times == 0:  # unlimited
        return True
    state_dir = knobs.get_str(STATE_ENV)
    if not state_dir:
        with _state_lock:
            fired = _fire_counts.get(rule.index, 0)
            if fired >= rule.times:
                return False
            _fire_counts[rule.index] = fired + 1
        return True
    os.makedirs(state_dir, exist_ok=True)
    for n in range(rule.times):
        path = os.path.join(state_dir, f"claim.{rule.index}.{n}")
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
        except FileExistsError:
            continue
        try:
            os.write(fd, f"pid={os.getpid()}\n".encode())
        finally:
            os.close(fd)
        return True
    return False


def _p_gate(rule: FaultRule, ordinal: int) -> bool:
    """Deterministic pseudo-coin for ``p=`` rules: pure hash of (seed,
    rule index, match ordinal) — replays with the same seed fire the
    same subset, which is what makes probabilistic chaos reproducible."""
    if rule.p is None:
        return True
    seed = knobs.get_str(SEED_ENV)
    h = hashlib.sha256(
        f"fault|{seed}|{rule.index}|{ordinal}".encode()
    ).digest()
    unit = int.from_bytes(h[:8], "big") / float(1 << 64)
    return unit < rule.p


def _default_rank() -> Optional[str]:
    raw = knobs.get_raw("SPARKDL_OBS_RANK")
    return raw if raw not in (None, "") else None


def maybe_fault(site: str, **coords) -> None:
    """The hook point: fire any armed rule matching this invocation.

    No-op (one env lookup) when ``SPARKDL_FAULT_PLAN`` is unset. The
    hook's keyword coordinates — plus ``site`` and a ``rank`` defaulted
    from ``SPARKDL_OBS_RANK`` — are the namespace plan rules match
    against. A firing logs a JSONL event and bumps ``faults.injected``
    BEFORE acting, so even a ``crash`` leaves its record."""
    rules = _rules_for_env()
    if not rules:
        return
    full: Dict[str, object] = dict(coords)
    full["site"] = site
    if full.get("rank") is None:
        rank = _default_rank()
        if rank is not None:
            full["rank"] = rank
    for rule in rules:
        if not rule.matches(full):
            continue
        with _state_lock:
            ordinal = _match_counts.get(rule.index, 0)
            _match_counts[rule.index] = ordinal + 1
        if not _p_gate(rule, ordinal):
            continue
        if not _claim_fire(rule):
            continue
        _fire(rule, site, full)


def _fire(rule: FaultRule, site: str, coords: Dict[str, object]) -> None:
    try:
        from sparkdl_tpu_torch.obs.export import append_jsonl
        from sparkdl_tpu_torch.utils.metrics import metrics

        metrics.inc("faults.injected")
        append_jsonl(
            {
                "kind": "fault",
                "ts": round(time.time(), 3),
                "rule": rule.source,
                "action": rule.action,
                "site": site,
                "coords": {
                    k: v for k, v in sorted(coords.items()) if k != "site"
                },
                "pid": os.getpid(),
            }
        )
    except Exception:
        pass  # observability must not change whether the fault fires
    if rule.action == "crash":
        os._exit(CRASH_EXIT_CODE)
    if rule.action == "exit":
        os._exit(int(rule.arg))
    if rule.action == "sleep":
        time.sleep(float(rule.arg))
        return
    # raise=<ExcName>
    cls = _resolve_exception(rule.arg)
    raise cls(f"injected fault [{rule.source}] at {site}")
