"""Gang heartbeats: failure detection for supervised worker processes.

A copy of the JAX package's ``runtime/heartbeat.py``. A rank that wedges
(deadlocked, blocked on the device) never exits, so something outside it
must notice that it went quiet. The data plane is files:

- each rank runs a :class:`Heartbeat` (a background thread) that rewrites
  ``<dir>/hb.<rank>`` every ``interval`` seconds with a small JSON
  payload: pid, beat count, wall time, ``done``, the gang ``generation``
  and a compact obs status (the rank's open spans and top counters,
  ``obs/spans.compact_status``), so a reader sees what a rank was doing
  when it went quiet, and drops its full obs snapshot as
  ``<dir>/obs.rank.<rank>.json`` at most once per ``SPARKDL_OBS_SNAP_S``
  (default 30 s; ``obs/aggregate.maybe_write_rank_snapshot``) for the
  cross-rank merge and straggler tools;
- the supervisor (``resilience/supervisor.py``) polls :func:`stale_ranks`,
  and an operator runs the CLI: ``python -m
  sparkdl_tpu_torch.runtime.heartbeat --dir D --num-ranks N
  --stale-after 60`` exits 1 listing the stale ranks (``--json`` for the
  per-rank verdicts, ``--obs`` for each stale rank's last obs payload).

A rank that exits by exception flushes the flight recorder
(``obs/export.dump_on_failure("gang_rank<r>_<Exception>")``) and drops
its final ``obs.rank.<r>.json`` beside the beat, and the CLI's ``--obs``
adds the cross-rank stage comparison of those drops
(``stage_divergence``, ``obs/aggregate.straggler_summary``). The files
keep the JAX package's names and format, so either package's reader
judges the other's writers.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from typing import List, Optional

from sparkdl_tpu_torch.obs.aggregate import maybe_write_rank_snapshot


def _hb_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"hb.{int(rank)}")


class Heartbeat:
    """Background heartbeat writer for one rank (a context manager).

    Writes are atomic (tmp + rename), so a reader never sees a torn file;
    the thread is a daemon and also stops cleanly on ``__exit__``."""

    def __init__(
        self,
        directory: str,
        rank: int,
        interval: float = 5.0,
        generation: int = 0,
    ):
        self.directory = directory
        self.rank = int(rank)
        self.interval = float(interval)
        #: gang incarnation this rank belongs to (the supervisor bumps it on
        #: every gang restart): beats of an earlier generation never read
        #: as the current gang's liveness
        self.generation = int(generation)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._beats = 0

    def _write(self, done: bool = False) -> None:
        os.makedirs(self.directory, exist_ok=True)
        path = _hb_path(self.directory, self.rank)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            from sparkdl_tpu_torch.obs.spans import compact_status

            obs_status = compact_status()
        except Exception:  # a broken obs layer must not stop the beat
            obs_status = None
        with open(tmp, "w") as f:
            json.dump(
                {
                    "rank": self.rank,
                    "pid": os.getpid(),
                    "beats": self._beats,
                    "time": time.time(),
                    "done": done,
                    "generation": self.generation,
                    "obs": obs_status,
                },
                f,
            )
        os.replace(tmp, path)
        self._beats += 1
        # the periodic full-snapshot drop beside the beat (time-gated;
        # `done` forces a final one; it never raises), so a wedged rank's
        # last ring buffer is on disk before anything has to attach to a
        # dead process
        maybe_write_rank_snapshot(self.directory, self.rank, force=done)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._write()
            except OSError:
                pass  # a full or broken disk must not kill the worker
            self._stop.wait(self.interval)

    def __enter__(self) -> "Heartbeat":
        self._write()  # first beat synchronously: liveness visible at start
        self._thread = threading.Thread(
            target=self._run, name="sparkdl-heartbeat", daemon=True
        )
        self._thread.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 5)
        if exc_type is not None:
            # dying by exception: the beat goes stale (the supervisor's
            # signal), and the flight recorder and the rank's final
            # snapshot are written; a broken obs layer must never mask
            # the worker's own exception
            try:
                from sparkdl_tpu_torch.obs.export import dump_on_failure

                dump_on_failure(f"gang_rank{self.rank}_{exc_type.__name__}")
                maybe_write_rank_snapshot(self.directory, self.rank, force=True)
            except Exception:
                pass
        if exc_type is None:
            # terminal state: finished-and-exited reads as done, not as a
            # crash whose beat aged out. A rank dying by exception leaves
            # its last beat to go stale, the supervisor's signal.
            try:
                self._write(done=True)
            except OSError:
                pass


def stale_ranks(
    directory: str,
    num_ranks: int,
    stale_after: float,
    generation: Optional[int] = None,
) -> List[int]:
    """Ranks whose heartbeat is missing or older than ``stale_after``
    seconds, by file mtime. A rank whose final beat carries ``done: true``
    exited cleanly and is never stale. With ``generation`` given, a beat
    tagged with another generation counts as missing: an earlier
    incarnation's file is no evidence the current rank ever started."""
    return [
        st["rank"]
        for st in rank_status(directory, num_ranks, stale_after, generation)
        if st["status"] in ("stale", "missing")
    ]


def rank_status(
    directory: str,
    num_ranks: int,
    stale_after: float,
    generation: Optional[int] = None,
) -> List[dict]:
    """Per-rank verdicts, behind both :func:`stale_ranks` and the CLI's
    ``--json``: one dict per rank with ``rank``, ``status`` (``ok`` |
    ``done`` | ``stale`` | ``missing``), ``age_s`` (absent when missing)
    and the beat's ``beats``/``pid``/``generation`` when readable."""
    now = time.time()
    out: List[dict] = []
    for r in range(num_ranks):
        path = _hb_path(directory, r)
        try:
            age = now - os.stat(path).st_mtime
        except OSError:
            out.append({"rank": r, "status": "missing"})
            continue
        payload: Optional[dict] = None
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            payload = None  # torn or vanished mid-read: judge by age alone
        st = {"rank": r, "age_s": round(age, 3)}
        if payload is not None:
            for key in ("beats", "pid", "generation"):
                if key in payload:
                    st[key] = payload[key]
        beat_gen = (payload or {}).get("generation")
        if (
            generation is not None
            and beat_gen is not None
            and int(beat_gen) != int(generation)
        ):
            st["status"] = "missing"
        elif payload is not None and payload.get("done"):
            st["status"] = "done"
        elif age > stale_after:
            st["status"] = "stale"
        else:
            st["status"] = "ok"
        out.append(st)
    return out


def last_obs(directory: str, rank: int) -> Optional[dict]:
    """The ``obs`` field of a rank's last beat; None for a missing or torn
    file."""
    try:
        with open(_hb_path(directory, rank)) as f:
            return json.load(f).get("obs")
    except (OSError, json.JSONDecodeError):
        return None


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparkdl_tpu_torch.runtime.heartbeat",
        description="Check gang heartbeats; exit 1 listing stale ranks.",
    )
    ap.add_argument("--dir", required=True)
    ap.add_argument("--num-ranks", type=int, required=True)
    ap.add_argument(
        "--stale-after", type=float, default=60.0,
        help="seconds without a beat before a rank counts as dead",
    )
    ap.add_argument(
        "--obs", action="store_true",
        help="include each stale rank's last obs payload (open spans and "
        "counters from its final beat)",
    )
    ap.add_argument(
        "--json", action="store_true",
        help="per-rank status records (ok/done/stale/missing, beat age, "
        "pid, generation) beside the stale_ranks list",
    )
    ap.add_argument(
        "--generation", type=int, default=None,
        help="expected gang generation: beats of another generation count "
        "as missing",
    )
    args = ap.parse_args(argv)
    statuses = rank_status(
        args.dir, args.num_ranks, args.stale_after, args.generation
    )
    stale = [
        st["rank"] for st in statuses if st["status"] in ("stale", "missing")
    ]
    out = {"stale_ranks": stale}
    if args.json:
        out["ranks"] = statuses
        out["stale_after"] = args.stale_after
        if args.generation is not None:
            out["generation"] = args.generation
    if args.obs and stale:
        out["obs"] = {str(r): last_obs(args.dir, r) for r in stale}
        # which stage diverged, from the ranks' snapshot drops
        try:
            from sparkdl_tpu_torch.obs.aggregate import load_rank_snapshots, straggler_summary

            snaps = load_rank_snapshots(args.dir)
            if snaps:
                flagged = straggler_summary(snaps)
                if flagged:
                    out["stage_divergence"] = flagged
        except Exception:
            pass  # the diagnosis must not break the staleness report
    print(json.dumps(out))
    return 1 if stale else 0


if __name__ == "__main__":
    raise SystemExit(main())
