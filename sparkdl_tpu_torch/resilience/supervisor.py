"""Gang supervisor: the recovery half of the heartbeat protocol.

A copy of the JAX package's ``resilience/supervisor.py``. Something
outside a gang must notice that a rank died or went quiet and restart it:
:class:`GangSupervisor` kills the whole gang, bumps a generation counter
and relaunches everything, under a capped, backed-off restart budget.

Detection is two-channel, matching the two ways a rank dies:

- **process liveness** (``Popen.poll``): a crash or an OOM kill exits
  with a code, caught within one poll interval;
- **heartbeat staleness** (``runtime/heartbeat.stale_ranks``): a wedged
  rank never exits, and its beat going quiet is the only signal.
  Generation-tagged beats mean an earlier incarnation's files never read
  as the current gang's state.

Every decision bumps an obs counter (``supervisor.restarts``,
``supervisor.ranks_killed``) and appends a ``{"kind": "supervisor"}``
JSONL event. Restarts are capped by a
:class:`~sparkdl_tpu_torch.resilience.policy.RetryPolicy`
(``SPARKDL_SUPERVISOR_RETRY_*``), whose backoff is the pause between
generations. The serving gateway (``serving/gateway.py``) runs one over
its workers; :func:`worker_launcher` launches the batch gang worker
(``python -m sparkdl_tpu_torch.worker``). CLI: ``python -m
sparkdl_tpu_torch.resilience supervise --job`` or ``--cmd``.
"""

from __future__ import annotations

import json
import os
import shlex
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from sparkdl_tpu_torch.resilience.policy import RetryPolicy, policy_from_env
from sparkdl_tpu_torch.utils.metrics import metrics

#: env var the supervisor sets for each launched rank: the gang
#: generation, carried into heartbeat payloads (staleness filtering) and
#: fault-plan coordinates.
GENERATION_ENV = "SPARKDL_GANG_GENERATION"
#: set to "1" for generations > 0: workers skip partitions whose output
#: already published and verifies (see worker.py resume plumbing).
RESUME_ENV = "SPARKDL_GANG_RESUME"


class GangFailedError(RuntimeError):
    """The gang kept dying and the restart budget ran out. Carries the
    per-generation failure history for the post-mortem."""

    def __init__(self, message: str, history: List[dict]):
        super().__init__(message)
        self.history = history


@dataclass
class SupervisorResult:
    """What a supervised job looked like end-to-end."""

    generations: int = 1  # how many gang incarnations ran (>= 1)
    restarts: int = 0
    ranks_killed: int = 0
    events: List[dict] = field(default_factory=list)


def default_restart_policy() -> RetryPolicy:
    """Restart budget: ``SPARKDL_SUPERVISOR_RETRY_*`` env overrides over
    (3 restarts, 0.5 s base backoff, 30 s cap)."""
    return policy_from_env(
        "SPARKDL_SUPERVISOR_RETRY",
        max_attempts=4,  # 1 initial launch + 3 restarts
        base_delay_s=0.5,
        max_delay_s=30.0,
        jitter=0.25,
    )


class GangSupervisor:
    """Launch an N-rank gang, watch it, gang-restart it on any death.

    ``launch(rank, generation) -> subprocess.Popen`` is caller-provided
    (see :func:`worker_launcher` for the standard worker shape); the
    supervisor owns everything after the fork: liveness polling,
    staleness polling, whole-gang kill, backoff, relaunch, giving up.

    ``stale_after <= 0`` disables the staleness channel (liveness only —
    for workloads that don't write heartbeats).

    Long-running gangs (the serving tier) use three hooks batch jobs
    don't need: ``complete_on_exit0=False`` makes a rank that exits 0
    count as DEAD (a serving worker never legitimately finishes, so a
    clean exit — e.g. after an operator drain — still relaunches the
    gang: the rolling-restart path); ``on_generation(gen, procs)`` fires
    after every gang launch (the gateway resets its readiness cache
    there); and :meth:`request_stop` ends supervision from another
    thread — the gang is killed (TERM first, so draining workers finish
    in-flight work) and :meth:`run` returns instead of relaunching."""

    def __init__(
        self,
        launch: Callable[[int, int], subprocess.Popen],
        num_ranks: int,
        heartbeat_dir: Optional[str] = None,
        *,
        stale_after: float = 60.0,
        poll_interval: float = 0.5,
        grace_s: Optional[float] = None,
        restart_policy: Optional[RetryPolicy] = None,
        kill_wait_s: float = 10.0,
        complete_on_exit0: bool = True,
        on_generation: Optional[Callable[[int, List], None]] = None,
    ):
        if num_ranks < 1:
            raise ValueError("num_ranks must be >= 1")
        self.launch = launch
        self.num_ranks = int(num_ranks)
        self.heartbeat_dir = heartbeat_dir
        self.stale_after = float(stale_after)
        self.poll_interval = max(0.05, float(poll_interval))
        #: how long after launch before staleness verdicts count — a
        #: gang still importing torch must not read as wedged.
        self.grace_s = (
            float(grace_s) if grace_s is not None else max(self.stale_after, 5.0)
        )
        self.restart_policy = restart_policy or default_restart_policy()
        self.kill_wait_s = float(kill_wait_s)
        self.complete_on_exit0 = bool(complete_on_exit0)
        self.on_generation = on_generation
        self._stop_requested = threading.Event()
        self._events: List[dict] = []
        # Gang state is INSTANCE state (not run()-local) so resize()
        # can grow/shrink a live gang from another thread.
        from sparkdl_tpu_torch.runtime import locksmith

        #: guards _procs / _retired / _launch_times / _generation /
        #: num_ranks — everything resize() and the run loop both touch
        self._gang_lock = locksmith.lock(
            "sparkdl_tpu_torch/resilience/supervisor.py::GangSupervisor._gang_lock"
        )
        self._procs: List[subprocess.Popen] = []
        #: shrunk ranks' processes, TERM'd and awaiting their drain ->
        #: exit-0 — reaped by the poll loop, never counted as gang death
        self._retired: List[subprocess.Popen] = []
        #: per-rank launch clocks: a rank grown into a running gang gets
        #: its own staleness grace instead of inheriting the gang's
        self._launch_times: Dict[int, float] = {}
        self._generation = 0

    def request_stop(self) -> None:
        """Ask a running :meth:`run` (possibly on another thread) to end
        supervision: the gang is killed — TERM first, so workers with a
        drain handler finish accepted work — and run() returns its
        result instead of relaunching. Idempotent; safe before run()."""
        self._stop_requested.set()

    @property
    def stop_requested(self) -> bool:
        return self._stop_requested.is_set()

    # -- event plumbing ------------------------------------------------------

    def _event(self, event: str, **fields) -> None:
        """Record + export one supervisor decision. The JSONL record is
        the replay-comparison data plane, so everything except ``ts`` is
        deterministic for a fixed plan + seed."""
        rec = {"kind": "supervisor", "event": event, **fields}
        self._events.append(rec)
        try:
            from sparkdl_tpu_torch.obs.export import append_jsonl

            append_jsonl({**rec, "ts": round(time.time(), 3)})
        except Exception:
            pass  # the event log must not take down recovery itself

    # -- gang lifecycle ------------------------------------------------------

    def _clear_heartbeats(self) -> None:
        """Remove the previous generation's beat files before relaunch:
        a dead incarnation's stale mtimes must not trip the staleness
        check the moment the new gang starts."""
        if not self.heartbeat_dir or not os.path.isdir(self.heartbeat_dir):
            return
        for name in os.listdir(self.heartbeat_dir):
            if name.startswith("hb."):
                try:
                    os.remove(os.path.join(self.heartbeat_dir, name))
                except OSError:
                    pass

    def _launch_gang(self, generation: int) -> List[subprocess.Popen]:
        self._clear_heartbeats()
        with self._gang_lock:
            self._generation = generation
            now = time.monotonic()
            procs = [
                self.launch(rank, generation)
                for rank in range(self.num_ranks)
            ]
            self._procs = procs
            self._launch_times = {r: now for r in range(len(procs))}
        self._event(
            "gang_start",
            generation=generation,
            num_ranks=len(procs),
            pids=[p.pid for p in procs],
        )
        if self.on_generation is not None:
            try:
                self.on_generation(generation, procs)
            except Exception:
                pass  # an observer bug must not take down supervision
        return procs

    def resize(self, n: int) -> dict:
        """Grow or shrink the LIVE gang to ``n`` ranks. Grow launches ranks
        ``[old, n)`` through the normal ``launch`` path at the current
        generation; shrink retires the tail ranks — their processes get
        SIGTERM, which a serving worker answers by draining accepted
        work and exiting 0, and the poll loop reaps the retirees
        without ever counting them as a gang death. The new size is
        also the relaunch size: a gang restart after a resize comes
        back at ``n`` ranks, not the construction-time count. Safe to
        call before :meth:`run` (just retargets the first launch).
        Returns ``{"from": old, "to": n, "generation": g}``."""
        n = int(n)
        if n < 1:
            raise ValueError("resize target must be >= 1")
        with self._gang_lock:
            old = self.num_ranks
            generation = self._generation
            running = bool(self._procs)
            if n > old and running:
                now = time.monotonic()
                for rank in range(old, n):
                    self._procs.append(self.launch(rank, generation))
                    self._launch_times[rank] = now
            retired: List[subprocess.Popen] = []
            if n < old and running:
                retired = self._procs[n:]
                del self._procs[n:]
                for rank in range(n, old):
                    self._launch_times.pop(rank, None)
                self._retired.extend(retired)
            self.num_ranks = n
        for p in retired:
            # TERM, not KILL: the serving worker's SIGTERM handler
            # drains accepted work and exits 0 (the graceful path)
            try:
                p.terminate()
            except OSError:
                pass
        if n != old:
            self._event(
                "gang_resize",
                generation=generation,
                **{"from": old, "to": n},
                retired_pids=[p.pid for p in retired],
            )
        return {"from": old, "to": n, "generation": generation}

    def _kill_gang(self) -> int:
        """Terminate every still-running rank — current AND retired
        (TERM, then KILL after ``kill_wait_s``); returns how many had
        to be killed."""
        with self._gang_lock:
            procs = self._procs + self._retired
            self._procs = []
            self._retired = []
            self._launch_times = {}
        running = [p for p in procs if p.poll() is None]
        for p in running:
            try:
                p.terminate()
            except OSError:
                pass
        deadline = time.monotonic() + self.kill_wait_s
        for p in running:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                try:
                    p.kill()
                    p.wait(timeout=5.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        return len(running)

    def _poll_gang(self, generation: int) -> Optional[dict]:
        """One poll tick. Returns None while the gang is healthy and
        incomplete, ``{"ok": True}`` when every rank exited 0, or a
        failure description naming the dead/stale ranks."""
        with self._gang_lock:
            procs = list(self._procs)
            num_ranks = self.num_ranks
            launch_times = dict(self._launch_times)
            # reap retirees here: a shrunk rank's drain -> exit-0 is a
            # resize completing, never a gang death
            self._retired = [
                p for p in self._retired if p.poll() is None
            ]
        dead: Dict[int, int] = {}
        exited_ok: List[int] = []
        for rank, p in enumerate(procs):
            rc = p.poll()
            if rc is None:
                continue
            if rc == 0 and self.complete_on_exit0:
                exited_ok.append(rank)
            else:
                # serving mode (complete_on_exit0=False): a worker that
                # exits CLEANLY is still a missing worker — relaunch
                dead[rank] = rc
        if dead:
            return {"ok": False, "dead": dead, "stale": []}
        if len(exited_ok) == num_ranks:
            return {"ok": True}
        if self.heartbeat_dir and self.stale_after > 0:
            now = time.monotonic()
            # per-rank grace: a rank grown into a running gang mid-life
            # judges staleness from ITS launch, not the gang's
            eligible = {
                r
                for r in range(num_ranks)
                if now - launch_times.get(r, now) >= self.grace_s
            }
            if eligible:
                from sparkdl_tpu_torch.runtime.heartbeat import stale_ranks

                stale = [
                    r
                    for r in stale_ranks(
                        self.heartbeat_dir,
                        num_ranks,
                        self.stale_after,
                        generation=generation,
                    )
                    if r in eligible and r not in exited_ok
                ]
                if stale:
                    return {"ok": False, "dead": {}, "stale": stale}
        return None

    def run(self) -> SupervisorResult:
        """Supervise until the gang completes or the restart budget runs
        out (:class:`GangFailedError`)."""
        result = SupervisorResult(events=self._events)
        history: List[dict] = []
        generation = 0
        t0 = time.monotonic()
        while True:
            self._launch_gang(generation)
            try:
                verdict: Optional[dict] = None
                while verdict is None:
                    if self._stop_requested.is_set():
                        killed = self._kill_gang()
                        self._event(
                            "supervisor_stop",
                            generation=generation,
                            killed=killed,
                        )
                        result.generations = generation + 1
                        return result
                    self._stop_requested.wait(self.poll_interval)
                    verdict = self._poll_gang(generation)
                if verdict["ok"]:
                    self._event("gang_complete", generation=generation)
                    result.generations = generation + 1
                    return result
            except BaseException:
                # Supervisor dying (KeyboardInterrupt, bug): never leave
                # an orphan gang running behind the operator's back.
                self._kill_gang()
                self._event("supervisor_abort", generation=generation)
                raise
            # -- a rank died or went quiet: the gang fails as a unit ---------
            dead, stale = verdict["dead"], verdict["stale"]
            for rank, rc in sorted(dead.items()):
                self._event(
                    "rank_dead", generation=generation, rank=rank, returncode=rc
                )
            for rank in stale:
                self._event("rank_stale", generation=generation, rank=rank)
            killed = self._kill_gang()
            metrics.inc("supervisor.ranks_killed", killed)
            result.ranks_killed += killed
            self._event(
                "gang_killed",
                generation=generation,
                dead_ranks=sorted(dead),
                stale_ranks=sorted(stale),
                killed=killed,
            )
            history.append(
                {
                    "generation": generation,
                    "dead": {str(r): rc for r, rc in sorted(dead.items())},
                    "stale": sorted(stale),
                }
            )
            if self._stop_requested.is_set():
                # stop raced a gang failure: the gang is already killed;
                # end supervision instead of relaunching into a shutdown
                self._event("supervisor_stop", generation=generation, killed=0)
                result.generations = generation + 1
                return result
            elapsed = time.monotonic() - t0
            if not self.restart_policy.allows(generation + 1, elapsed):
                self._event(
                    "giving_up", generation=generation, restarts=generation
                )
                raise GangFailedError(
                    f"gang failed {generation + 1} time(s); restart budget "
                    f"({self.restart_policy.max_attempts - 1} restarts"
                    + (
                        f", {self.restart_policy.deadline_s}s deadline"
                        if self.restart_policy.deadline_s is not None
                        else ""
                    )
                    + f") exhausted; last failure: dead={dict(dead)} "
                    f"stale={sorted(stale)}",
                    history,
                )
            delay = self.restart_policy.delay_s(generation)
            metrics.inc("supervisor.restarts")
            result.restarts += 1
            self._event(
                "gang_restart",
                generation=generation + 1,
                backoff_s=round(delay, 4),
            )
            if delay > 0:
                # interruptible backoff: a stop during the pause ends
                # supervision at the next loop's stop check instead of
                # waiting out the full delay first
                self._stop_requested.wait(delay)
            if self._stop_requested.is_set():
                self._event(
                    "supervisor_stop", generation=generation, killed=0
                )
                result.generations = generation + 1
                return result
            generation += 1


def worker_launcher(
    job_path: str,
    num_ranks: int,
    *,
    python: Optional[str] = None,
    device: Optional[str] = None,
    distributed: bool = False,
    coordinator: Optional[str] = None,
    extra_env: Optional[dict] = None,
    stdout=subprocess.DEVNULL,
    stderr=subprocess.DEVNULL,
) -> Callable[[int, int], subprocess.Popen]:
    """The standard ``launch`` callable: one ``python -m
    sparkdl_tpu_torch.worker`` per rank, generation and resume plumbed
    through the environment. Generations > 0 run with
    ``SPARKDL_GANG_RESUME=1``: already-published partition outputs are
    verified and skipped, so a restart re-pays only the partitions the
    dead generation never finished. ``device``: the worker's ``--device``
    (its own default, ``cuda``, when None)."""

    def launch(rank: int, generation: int) -> subprocess.Popen:
        argv = [
            python or sys.executable, "-m", "sparkdl_tpu_torch.worker",
            "--job", job_path,
            "--process-id", str(rank),
            "--num-processes", str(num_ranks),
        ]
        if not distributed:
            argv.append("--no-distributed")
        if coordinator:
            argv += ["--coordinator", coordinator]
        if device:
            argv += ["--device", device]
        env = {**os.environ, **(extra_env or {}), GENERATION_ENV: str(generation)}
        if generation > 0:
            env.setdefault(RESUME_ENV, "1")
        return subprocess.Popen(argv, env=env, stdout=stdout, stderr=stderr)

    return launch


def _cmd_launcher(
    template: str, num_ranks: int, stdout=None, stderr=None
) -> Callable[[int, int], subprocess.Popen]:
    """``--cmd`` launcher: a shlex-split template with ``{rank}`` /
    ``{generation}`` / ``{num_ranks}`` placeholders substituted per
    process: any gang binary under supervision."""

    def launch(rank: int, generation: int) -> subprocess.Popen:
        argv = [
            part.format(
                rank=rank, generation=generation, num_ranks=num_ranks
            )
            for part in shlex.split(template)
        ]
        env = {**os.environ, GENERATION_ENV: str(generation)}
        if generation > 0:
            env.setdefault(RESUME_ENV, "1")
        return subprocess.Popen(argv, env=env, stdout=stdout, stderr=stderr)

    return launch


def supervise_main(args) -> int:
    """Body of ``python -m sparkdl_tpu_torch.resilience supervise``."""
    hb_dir = args.heartbeat_dir
    if hb_dir is None and args.job:
        try:
            with open(args.job) as f:
                hb_dir = json.load(f).get("heartbeat_dir")
        except (OSError, json.JSONDecodeError) as e:
            print(f"supervise: cannot read job spec {args.job}: {e}", file=sys.stderr)
            return 2
    if args.cmd:
        launch = _cmd_launcher(args.cmd, args.num_ranks)
    elif args.job:
        launch = worker_launcher(
            args.job,
            args.num_ranks,
            device=args.device,
            distributed=args.distributed,
            coordinator=args.coordinator,
            stdout=None,  # operator CLI: rank output flows to the terminal
            stderr=None,
        )
    else:
        print("supervise: need --job or --cmd", file=sys.stderr)
        return 2
    policy = default_restart_policy()
    if args.max_restarts is not None:
        policy = RetryPolicy(
            max_attempts=args.max_restarts + 1,
            base_delay_s=policy.base_delay_s,
            multiplier=policy.multiplier,
            max_delay_s=policy.max_delay_s,
            jitter=policy.jitter,
            deadline_s=policy.deadline_s,
            seed=policy.seed,
        )
    sup = GangSupervisor(
        launch,
        args.num_ranks,
        heartbeat_dir=hb_dir,
        stale_after=args.stale_after,
        poll_interval=args.poll_interval,
        grace_s=args.grace,
        restart_policy=policy,
    )
    # Ctrl-C must kill the gang, not orphan it: run() converts the
    # KeyboardInterrupt into a gang kill on its way out.
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        result = sup.run()
    except GangFailedError as e:
        print(
            json.dumps(
                {
                    "supervise": "FAIL",
                    "error": str(e),
                    "history": e.history,
                }
            ),
            file=sys.stderr,
        )
        return 1
    print(
        json.dumps(
            {
                "supervise": "OK",
                "generations": result.generations,
                "restarts": result.restarts,
                "ranks_killed": result.ranks_killed,
            }
        )
    )
    return 0
