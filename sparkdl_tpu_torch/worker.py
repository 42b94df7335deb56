"""The batch gang worker: ``python -m sparkdl_tpu_torch.worker``.

The port of the JAX package's ``worker.py``, the executor half of the
upstream system: one worker process per GPU, gang-started with a rank.

- Control plane: ``torch.distributed`` (``parallel/distributed.py``;
  gloo on the CPU, NCCL on the card) when collectives are needed, i.e. for
  a train job; an inference job runs with explicit
  ``--process-id/--num-processes`` and no rendezvous at all, because
  scoring is embarrassingly parallel over partitions.
- Data plane: each rank reads ONLY its own partitions of the input
  Parquet file (round-robin ownership, ``partitions_for_host``; only the
  row groups that meet an owned span are decoded), runs the saved stage
  and publishes one Arrow IPC file per owned partition,
  ``part-%05d.arrow`` by global index, atomically. The gather is plain
  files: :func:`gather_results` reads them back in global order, equal to
  a single-process ``transform``. Parquet and Arrow go through the port's
  own readers and writers (``dataframe/parquet.py``,
  ``dataframe/arrow_ipc.py``); the files are the JAX package's, so either
  package gathers the other's outputs.

Job spec (JSON file), the JAX package's::

    {
      "stage_path":    "<dir written by save_stage of either package>",
      "input_parquet": "<input dataframe>",
      "num_partitions": 16,
      "output_dir":    "<dir for part-*.arrow>",
      "heartbeat_dir": "<optional: beats + obs.rank.<r>.json drops>",
      "model":         {"builder": "pkg.mod:fn", "kwargs": {...}}   # optional
    }

``model`` is the port's one addition: a stage with a ``modelFunction``
Param (``TextEmbedder``) cannot persist its model, in either package, so
the worker builds it from code importable on its host, as a train job
builds its model, with ``device=`` the worker's device (for example
``sparkdl_tpu_torch.models.registry:build_model_function`` over a
``weights_file``). The JAX worker does not read it. A stage saved by the
JAX package loads here (``persistence._locate`` maps its class paths), so
one job file without ``model`` runs under both workers.

Resilience, as in the JAX package: ``_STARTED.<rank>`` and
``_SUCCESS.<rank>`` JSON markers (``resumed`` and ``generation`` in the
latter), the ``worker.partition`` fault site and span, the supervisor's
``SPARKDL_GANG_GENERATION`` and ``SPARKDL_GANG_RESUME`` (published
partitions that verify are skipped on a restart), heartbeats and a final
per-rank obs snapshot beside them (``obs/aggregate.py``).

The CLI runs on the card unless asked for the CPU (``--device cpu``); a
worker asked for ``cuda`` on a machine without a card exits 2 naming it.
The JAX package's ``--platform`` (a jax backend) has no counterpart.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import sys
from typing import Iterator, List, Optional, Tuple

from sparkdl_tpu_torch.dataframe import arrow_ipc
from sparkdl_tpu_torch.dataframe.frame import DataFrame, partition_row_spans
from sparkdl_tpu_torch.obs import span
from sparkdl_tpu_torch.runtime import knobs


def _write_partition_arrow(columns: dict, path: str) -> None:
    """Atomic publish (``path.tmp`` then ``os.replace``): the gather never
    sees a partial file."""
    arrow_ipc.write_partition(columns, path)


def _read_owned_partitions(path: str, num_partitions: int, owned,
                           on_group=None) -> Iterator[Tuple[int, DataFrame]]:
    """Yield ``(global_index, one-partition DataFrame)`` for the owned
    partitions, decoding ONLY the row groups that meet an owned span, one
    group at a time; a partition is yielded as soon as its span is read.
    ``on_group(index)`` sees each decoded row group."""
    from sparkdl_tpu_torch.dataframe.parquet import ParquetFile

    pf = ParquetFile(path)
    names = pf.column_names
    spans = partition_row_spans(pf.num_rows, num_partitions)
    owned_set = {gi for gi in owned if gi < len(spans)}
    if not owned_set:
        return
    pending = {gi: [] for gi in sorted(owned_set)}
    for r, (b0, b1) in enumerate(pf.row_group_spans()):
        hits = [gi for gi in sorted(pending)
                if max(b0, spans[gi][0]) < min(b1, spans[gi][1])]
        if not hits:
            continue
        if on_group is not None:
            on_group(r)
        group = pf.read_row_group(r, names)
        for gi in hits:
            lo, hi = max(b0, spans[gi][0]), min(b1, spans[gi][1])
            pending[gi].append({c: group[c][lo - b0:hi - b0] for c in names})
        for gi in sorted(pending):
            if spans[gi][1] <= b1 and pending[gi]:
                yield gi, _one_partition(pending.pop(gi), names, pf, gi)
    # zero-row partitions (an empty span) still owe an output slot
    for gi in sorted(pending):
        if not pending[gi]:
            yield gi, _one_partition([], names, pf, gi)


def _one_partition(pieces, names, pf, gi: int) -> DataFrame:
    """Partition ``gi`` as a one-partition frame that keeps its global
    index, so partition-seeded columns match a single-process run."""
    from sparkdl_tpu_torch.dataframe.parquet import _concat

    cols = {c: _concat([p[c] for p in pieces], pf._by_name[c]) for c in names}
    return DataFrame([cols], names, first_index=gi)


def _resolve_device(device):
    """``resolve_device``, with a bare ``cuda`` pinned to the current
    device's index (a builder's model and a loaded estimator compare
    devices)."""
    import torch

    from sparkdl_tpu_torch.runtime.device import resolve_device

    d = resolve_device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _join(job: dict, process_id, num_processes, coordinator, device) -> Tuple[int, int]:
    from sparkdl_tpu_torch.parallel import distributed as dist

    if coordinator and "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.initialize(init_method=coordinator, world_size=num_processes,
                    rank=process_id, device=device)
    return dist.process_index(), dist.process_count()


def run_worker(
    job: dict,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
    coordinator: Optional[str] = None,
    distributed: bool = True,
    device=None,
) -> List[int]:
    """Run one rank's share of an inference job; returns its partitions.

    ``distributed=True`` joins the process group first (``coordinator``
    is ``host:port``); an inference job may pass ``distributed=False``
    with explicit ids: no rendezvous, no ports. ``device``: ``cuda`` by
    default (raises when there is none), ``"cpu"`` for the CPU."""
    device = _resolve_device(device)
    if distributed:
        pid, n = _join(job, process_id, num_processes, coordinator, device)
    else:
        if process_id is None or num_processes is None:
            raise ValueError(
                "distributed=False requires explicit process_id and num_processes"
            )
        pid, n = int(process_id), int(num_processes)
    with _obs_services(job, pid), _maybe_heartbeat(job, pid):
        with span("worker.job", rank=pid, hosts=n):
            return _run_worker_body(job, pid, n, device)


def _gang_generation(job: dict) -> int:
    """This incarnation's gang generation: the supervisor exports
    ``SPARKDL_GANG_GENERATION`` on every (re)launch; an unsupervised run
    is generation 0 (or what the job spec pins)."""
    try:
        raw = knobs.get_int("SPARKDL_GANG_GENERATION")
    except ValueError:
        raw = None
    if raw is not None:
        return raw
    return int(job.get("generation", 0))


def _resume_enabled(job: dict) -> bool:
    """Whether this run may SKIP partitions whose output already
    published and verifies: ``SPARKDL_GANG_RESUME=1`` (the supervisor sets
    it for generations > 0) or ``"resume": true`` in the job spec. Off by
    default: a plain re-run recomputes everything."""
    if knobs.get_flag("SPARKDL_GANG_RESUME"):
        return True
    return bool(job.get("resume"))


def _valid_arrow_output(path: str) -> bool:
    """The resume check: a complete, readable Arrow IPC file. Torn writes
    and garbage fail it and are recomputed."""
    return arrow_ipc.valid_output(path)


def _resolve_model_builder(spec: dict, device=None):
    """``{"builder": "pkg.mod:fn", "kwargs": {...}}`` -> ModelFunction.

    Every rank CONSTRUCTS the model from code importable on its host;
    weights never ride the job spec. A builder that takes ``device`` gets
    the worker's device unless the kwargs name one."""
    import importlib

    target = spec["builder"]
    mod_name, sep, fn_name = target.partition(":")
    if not sep or not mod_name or not fn_name:
        raise ValueError(f"model builder {target!r} must be 'module:function'")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    kwargs = dict(spec.get("kwargs", {}))
    if device is not None and "device" not in kwargs and (
            "device" in inspect.signature(fn).parameters):
        kwargs["device"] = str(device)
    return fn(**kwargs)


def _load_job_stage(job: dict, device):
    from sparkdl_tpu_torch.persistence import load_stage

    stage = load_stage(job["stage_path"], device=device)
    if job.get("model"):
        if not stage.hasParam("modelFunction"):
            raise ValueError(
                f"the job names a model but its stage {type(stage).__name__} "
                "has no modelFunction Param"
            )
        stage.setModelFunction(_resolve_model_builder(job["model"], device))
    return stage


def _run_worker_body(job: dict, pid: int, n: int, device=None) -> List[int]:
    from sparkdl_tpu_torch.parallel import distributed as dist
    from sparkdl_tpu_torch.resilience.faults import maybe_fault
    from sparkdl_tpu_torch.utils.metrics import metrics

    stage = _load_job_stage(job, device)
    num_partitions = int(job["num_partitions"])
    owned = dist.partitions_for_host(num_partitions, host_index=pid, host_count=n)
    out_dir = job["output_dir"]
    os.makedirs(out_dir, exist_ok=True)
    generation = _gang_generation(job)
    resume = _resume_enabled(job)

    # Start marker: tells a rank that NEVER started from one that died
    # mid-write (its owned list is the evidence trail); the latest
    # generation's attempt wins, like the outputs.
    with open(os.path.join(out_dir, f"_STARTED.{pid}"), "w") as f:
        f.write(json.dumps({
            "process_id": pid, "pid": os.getpid(), "generation": generation,
            "partitions": owned,
        }))

    # Only the owned partitions, one at a time (this rank reads its own
    # row spans, never the whole file), each published under its GLOBAL
    # index; one span per partition, so a quiet rank's heartbeat names the
    # partition it was on.
    step = 0
    resumed: List[int] = []
    for gi, part_df in _read_owned_partitions(job["input_parquet"], num_partitions, owned):
        out_path = os.path.join(out_dir, f"part-{gi:05d}.arrow")
        if resume and _valid_arrow_output(out_path):
            # an earlier generation published it atomically: a restart
            # re-pays only the unfinished work
            metrics.inc("worker.partitions.resumed")
            resumed.append(gi)
            step += 1
            continue
        maybe_fault("worker.partition", rank=pid, step=step, partition=gi, gen=generation)
        with span("worker.partition", partition=gi, rank=pid) as sp:
            result = stage.transform(part_df)
            # a stage whose result has several partitions collapses into
            # this one file: no batch is dropped
            columns = result.collectColumns()
            rows = len(columns[result.columns[0]]) if result.columns else 0
            sp.add(rows=rows)
            _write_partition_arrow(columns, out_path)
        metrics.inc("worker.partitions.published")
        step += 1
    # Success marker: the gather waits for one per rank; `resumed` and
    # `generation` are the restart evidence trail.
    with open(os.path.join(out_dir, f"_SUCCESS.{pid}"), "w") as f:
        f.write(json.dumps({
            "process_id": pid, "partitions": owned, "generation": generation,
            "resumed": resumed,
        }))
    return owned


def _maybe_heartbeat(job: dict, rank: int):
    """A heartbeat for the rank when the job spec has ``heartbeat_dir``
    (the supervisor polls its staleness); a no-op context otherwise."""
    hb_dir = job.get("heartbeat_dir")
    if not hb_dir:
        return contextlib.nullcontext()
    from sparkdl_tpu_torch.runtime.heartbeat import Heartbeat

    return Heartbeat(hb_dir, rank, interval=float(job.get("heartbeat_interval", 5.0)),
                     generation=_gang_generation(job))


@contextlib.contextmanager
def _obs_services(job: dict, rank: int):
    """Telemetry around one gang rank's run: the process is tagged with its
    rank (``SPARKDL_OBS_RANK``), the metrics sampler runs
    (``SPARKDL_OBS_SAMPLE_S=0`` turns it off), and on the way out a final
    snapshot drops beside the heartbeat files, so a reader always has the
    rank's terminal counters. The pull exporter (``obs/serve.py``) binds
    ``SPARKDL_OBS_PORT`` + rank when that is set. Only what this context
    started is stopped on the way out. Telemetry failures never
    propagate."""
    prev_rank = knobs.get_raw("SPARKDL_OBS_RANK")
    os.environ["SPARKDL_OBS_RANK"] = str(rank)
    sampler = server = None
    try:
        from sparkdl_tpu_torch.obs import serve, timeseries

        if not timeseries.get_sampler().running():
            sampler = timeseries.start_sampler()
        if serve.server_port() is None:
            server = serve.maybe_start_from_env(rank=rank)
    except Exception:
        pass
    try:
        yield
    finally:
        try:
            hb_dir = job.get("heartbeat_dir")
            if hb_dir:
                from sparkdl_tpu_torch.obs.aggregate import write_rank_snapshot

                write_rank_snapshot(hb_dir, rank)
        except Exception:
            pass
        try:
            if sampler is not None:
                from sparkdl_tpu_torch.obs import timeseries

                timeseries.stop_sampler()
            if server is not None:
                from sparkdl_tpu_torch.obs import serve

                serve.stop_server()
        except Exception:
            pass
        if prev_rank is None:
            os.environ.pop("SPARKDL_OBS_RANK", None)
        else:
            os.environ["SPARKDL_OBS_RANK"] = prev_rank


def run_train_worker(
    job: dict,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
    coordinator: Optional[str] = None,
    distributed: bool = True,
    device=None,
):
    """Gang-train a DataParallelEstimator: every rank joins the process
    group, after which the estimator's step all-reduces gradients across
    them. Rank 0 publishes the trained params and history; ``modelDir``
    on the saved estimator gives kill-and-restart resume. NCCL refuses
    two ranks on one device, so on one card a train job runs at one rank.

    Job spec::

        {
          "type": "train",
          "estimator_path": "<saved DataParallelEstimator (no model)>",
          "model": {"builder": "mymodels:build", "kwargs": {...}},
          "input_parquet": "<training dataframe>",
          "num_partitions": 4,
          "output_dir": "<dir for trained_params.pkl / history.json>"
        }
    """
    device = _resolve_device(device)
    if distributed:
        rank, _ = _join(job, process_id, num_processes, coordinator, device)
    elif (num_processes or 1) > 1:
        raise ValueError(
            "distributed=False train jobs must be single-process: the "
            "cross-process gradient all-reduce needs the rendezvous"
        )
    else:
        rank = process_id or 0
    with _obs_services(job, rank), _maybe_heartbeat(job, rank):
        with span("worker.train", rank=rank):
            return _run_train_body(job, rank, device)


def _flax_tree(model_function) -> dict:
    """The trained module's weights as flax variables (the JAX tree layout,
    ``models/convert.cnn_params_to_flax``; an empty collection is left
    out)."""
    from sparkdl_tpu_torch.models.convert import cnn_params_to_flax

    tree = cnn_params_to_flax(model_function.module)
    return {k: v for k, v in tree.items() if v}


def _run_train_body(job: dict, rank: int, device=None):
    import pickle

    from sparkdl_tpu_torch.estimators import DataParallelEstimator
    from sparkdl_tpu_torch.parallel import distributed as dist
    from sparkdl_tpu_torch.persistence import load_stage

    est = load_stage(job["estimator_path"], DataParallelEstimator, device=device)
    est.model = _resolve_model_builder(job["model"], device)
    try:
        use_streaming = bool(est.getOrDefault("streaming"))
    except KeyError:
        use_streaming = False
    # a streaming estimator gets the LAZY scan: each rank's partitions
    # load row-group-wise on demand; nothing reads the whole file
    reader = DataFrame.scanParquet if use_streaming else DataFrame.readParquet
    df = reader(job["input_parquet"], numPartitions=int(job.get("num_partitions", 1)))
    fitted = est.fit(df)

    out_dir = job["output_dir"]
    if dist.process_index() == 0:
        os.makedirs(out_dir, exist_ok=True)
        tmp = os.path.join(out_dir, "trained_params.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(_flax_tree(fitted.modelFunction), f)
        os.replace(tmp, os.path.join(out_dir, "trained_params.pkl"))
        with open(os.path.join(out_dir, "history.json"), "w") as f:
            json.dump(fitted.history, f, indent=1)
        with open(os.path.join(out_dir, "_SUCCESS.train"), "w") as f:
            f.write(json.dumps({"epochs": len(fitted.history)}))
    return fitted


def _diagnose_missing_rank(output_dir: str, p: int) -> str:
    """One missing rank's story for the gather error: never started (no
    ``_STARTED.p``, a launch problem) reads differently from died
    mid-write (started, published some partitions, maybe left ``.tmp``
    debris: a crash the supervisor should have caught)."""
    started_path = os.path.join(output_dir, f"_STARTED.{p}")
    try:
        with open(started_path) as f:
            started = json.load(f)
    except (OSError, json.JSONDecodeError):
        started = None
    if started is None:
        return f"rank {p} never started (no _STARTED.{p} marker)"
    owned = started.get("partitions") or []
    published = [
        gi for gi in owned
        if os.path.exists(os.path.join(output_dir, f"part-{gi:05d}.arrow"))
    ]
    try:
        debris = sorted(name for name in os.listdir(output_dir) if name.endswith(".tmp"))
    except OSError:
        debris = []
    msg = (
        f"rank {p} started (generation {started.get('generation', 0)}, owns "
        f"partitions {owned}) but died before finishing: {len(published)}/"
        f"{len(owned)} partition outputs published"
    )
    if debris:
        msg += f", tmp write debris present ({', '.join(debris[:4])})"
    return msg


def gather_results(output_dir: str, num_processes: Optional[int] = None) -> DataFrame:
    """The ranks' outputs as one DataFrame in global partition order. With
    ``num_processes``, raises unless every rank's success marker is there
    (a partially failed gang). The frame is lazy, one partition per file:
    only the first file's schema is read here."""
    if num_processes is not None:
        missing = [
            p for p in range(num_processes)
            if not os.path.exists(os.path.join(output_dir, f"_SUCCESS.{p}"))
        ]
        if missing:
            raise RuntimeError(
                f"Workers {missing} have not published success markers in "
                f"{output_dir}; gang incomplete or failed: "
                + "; ".join(_diagnose_missing_rank(output_dir, p) for p in missing)
            )
    names = sorted(f for f in os.listdir(output_dir) if f.endswith(".arrow"))
    return DataFrame.fromArrowFiles([os.path.join(output_dir, f) for f in names])


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparkdl_tpu_torch.worker",
        description="sparkdl_tpu_torch batch gang worker (one per GPU)",
    )
    ap.add_argument("--job", required=True, help="path to job spec JSON")
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--coordinator", default=None,
                    help="process-group address host:port (torch.distributed)")
    ap.add_argument("--no-distributed", action="store_true",
                    help="skip the rendezvous (inference jobs with explicit "
                    "--process-id/--num-processes)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the stage runs (default cuda; no fallback)")
    args = ap.parse_args(argv)
    rank = args.process_id if args.process_id is not None else 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print(
                f"worker {rank}: no CUDA device is available; pass --device "
                "cpu to run on the CPU (device='cpu')",
                file=sys.stderr, flush=True,
            )
            return 2
    with open(args.job) as f:
        job = json.load(f)
    if job.get("type") == "train":
        if args.no_distributed and (args.num_processes or 1) > 1:
            ap.error("train jobs need the process group for the cross-process "
                     "gradient all-reduce; drop --no-distributed")
        run_train_worker(
            job, process_id=args.process_id, num_processes=args.num_processes,
            coordinator=args.coordinator, distributed=not args.no_distributed,
            device=args.device,
        )
        print("train worker done", flush=True)
        return 0
    owned = run_worker(
        job, process_id=args.process_id, num_processes=args.num_processes,
        coordinator=args.coordinator, distributed=not args.no_distributed,
        device=args.device,
    )
    print(f"worker done: partitions {owned}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
