"""CLI for the port's serving layer.

    python -m sparkdl_tpu_torch.serving serve   [--port P] [--budget-mb N]
                                                [--max-batch N] [--device D]
                                                [--seed S]
    python -m sparkdl_tpu_torch.serving gateway [--workers N] [--port P]
                                                [--gang-dir D] [--loader M:F]
                                                [--budget-mb N] [--max-batch N]
                                                [--device D] [--seed S]
    python -m sparkdl_tpu_torch.serving worker  --rank R --gang-dir D
                                                [--port P] [--loader M:F]
                                                [--budget-mb N] [--max-batch N]
                                                [--device D] [--seed S]
                                                [--heartbeat-interval S]
    python -m sparkdl_tpu_torch.serving models

``serve`` binds the single-process HTTP front end over the named-model
registry (port from ``--port`` or ``SPARKDL_SERVE_PORT``, default 8000)
and blocks until interrupted. ``gateway`` runs the supervised gang: N
``worker`` processes under the GangSupervisor behind one health-checked
routing door (``serving/gateway.py``); ``--device`` and ``--seed`` go to
every worker. ``worker`` is the gang member the gateway launches: the same
Router / residency / server stack plus the gang protocol, a
generation-tagged port file and heartbeats in ``--gang-dir``, and a
SIGTERM (or a drain through ``POST /admin/drain``) that drains accepted
work before it exits 0. Each runs on ``cuda`` unless ``--device cpu`` is
given, and exits with code 2 naming the missing device without a card.
``models`` prints the registry with each model's parameter-byte estimate.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import inspect
import json
import os
import signal
import sys
import threading
import time
from typing import List, Optional


def serving_env_defaults() -> None:
    """Serving-process feeder defaults (explicit env still wins): owners
    never idle-exit between bursts, and the stream registry is sized for
    model x rung x geometry populations."""
    os.environ.setdefault("SPARKDL_FEEDER_IDLE_S", "0")
    os.environ.setdefault("SPARKDL_MAX_FEEDERS", "32")


def _resolve_loader(spec: Optional[str], device: Optional[str], seed: int):
    """``pkg.mod:attr`` -> the loader callable, or None for the
    named-model registry. A loader that takes ``device`` and ``seed``
    keywords gets the worker's."""
    if not spec:
        return None
    mod_name, sep, attr = spec.partition(":")
    if not sep or not attr:
        raise SystemExit(f"--loader {spec!r}: expected 'pkg.mod:function'")
    fn = getattr(importlib.import_module(mod_name), attr, None)
    if not callable(fn):
        raise SystemExit(f"--loader {spec!r}: {attr!r} is not a callable in {mod_name!r}")
    params = inspect.signature(fn).parameters
    bound = {k: v for k, v in (("device", device), ("seed", seed)) if k in params}
    return functools.partial(fn, **bound) if bound else fn


def _write_port_file(gang_dir: str, rank: int, port: int, generation: int) -> None:
    """Publish the worker's bound port for the gateway, atomically (tmp +
    rename) and generation-tagged, so a gateway never routes to a dead
    incarnation's port."""
    from sparkdl_tpu_torch.serving.gateway import port_file

    path = port_file(gang_dir, rank)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(
            {"rank": rank, "port": port, "pid": os.getpid(), "generation": generation}, f
        )
    os.replace(tmp, path)


def _worker_main(args) -> int:
    """One serving gang member. Bind an ephemeral port -> publish it ->
    heartbeat -> serve until SIGTERM or a drain -> drain (admission 503s
    with Retry-After, queued and in-flight work completes, feeders close)
    -> exit 0. The supervisor TERMs before it KILLs, so the drain window
    is the graceful half of every gang restart."""
    serving_env_defaults()
    from sparkdl_tpu_torch.runtime import knobs
    from sparkdl_tpu_torch.runtime.heartbeat import Heartbeat
    from sparkdl_tpu_torch.serving.router import Router
    from sparkdl_tpu_torch.serving.server import ServingServer

    rank = int(args.rank)
    os.environ.setdefault("SPARKDL_OBS_RANK", str(rank))
    generation = knobs.get_int("SPARKDL_GANG_GENERATION") or 0
    os.makedirs(args.gang_dir, exist_ok=True)
    if args.budget_mb is not None:
        os.environ["SPARKDL_SERVE_HBM_BUDGET_MB"] = str(args.budget_mb)
    loader = _resolve_loader(args.loader, args.device, args.seed)
    try:
        router = Router(
            loader=loader, max_batch=args.max_batch, device=args.device, seed=args.seed
        )
    except RuntimeError as e:  # no CUDA device and no --device cpu
        print(f"worker {rank}: {e}", file=sys.stderr, flush=True)
        return 2
    router.start()
    server = ServingServer(router, port=args.port)
    _write_port_file(args.gang_dir, rank, server.port, generation)
    # the pull exporter on SPARKDL_OBS_PORT + rank (off when unset)
    from sparkdl_tpu_torch.obs import serve as obs_serve

    obs_serve.maybe_start_from_env(rank=rank)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    print(
        json.dumps({
            "serving_worker": "up", "rank": rank, "generation": generation,
            "port": server.port, "pid": os.getpid(), "device": str(router.device),
        }),
        flush=True,
    )
    drain_timeout = knobs.get_float("SPARKDL_SERVE_DRAIN_TIMEOUT_S")
    with Heartbeat(
        args.gang_dir, rank, interval=args.heartbeat_interval, generation=generation
    ):
        admin_drained = False
        drain_deadline = None
        while not stop.wait(0.2):
            if not router.draining:
                continue
            if drain_deadline is None:
                # a POST /admin/drain began: bound the wait as the SIGTERM
                # path does, so a wedged group cannot pin the worker in
                # 'draining' forever
                drain_deadline = time.monotonic() + drain_timeout
            if router.wait_drained(timeout=0) or time.monotonic() >= drain_deadline:
                # drained through /admin/drain (or timed out): exit so the
                # supervisor replaces this worker with a fresh one, the
                # rolling restart. A short linger first keeps the draining
                # state observable to health polls.
                admin_drained = True
                break
        if admin_drained:
            time.sleep(2.0)
        router.drain()
        drained = router.wait_drained(timeout=drain_timeout)
        server.stop(close_router=True)
        obs_serve.stop_server()
    print(
        json.dumps({
            "serving_worker": "drained" if drained else "drain_timeout",
            "rank": rank, "generation": generation,
        }),
        flush=True,
    )
    # exit 0 either way: a drain timeout is printed above, and the
    # supervisor's KILL is the backstop for a true wedge
    return 0


def _gateway_main(args) -> int:
    from sparkdl_tpu_torch.serving.gateway import ServingGateway
    from sparkdl_tpu_torch.serving.server import configured_port

    port = args.port if args.port is not None else (configured_port() or 8000)
    gw = ServingGateway(
        num_workers=args.workers,
        port=port,
        gang_dir=args.gang_dir,
        loader_spec=args.loader,
        budget_mb=args.budget_mb,
        max_batch=args.max_batch,
        device=args.device,
        seed=args.seed,
    ).start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    print(
        json.dumps({
            "gateway": "up", "port": gw.port, "workers": gw.num_workers,
            "gang_dir": gw.gang_dir, "device": args.device or "cuda",
            "endpoints": [
                "POST /v1/predict", "/v1/workers", "/v1/models", "/v1/fleet",
                "/healthz", "/metrics", "POST /admin/drain",
            ],
        }),
        flush=True,
    )
    try:
        while not stop.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        gw.stop()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sparkdl_tpu_torch.serving",
        description="Online serving on the port: HTTP front end + registry info.",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_serve = sub.add_parser("serve", help="run the HTTP serving endpoint")
    p_serve.add_argument(
        "--port", type=int, default=None,
        help="bind port (default SPARKDL_SERVE_PORT or 8000; 0 = ephemeral)",
    )
    p_serve.add_argument(
        "--budget-mb", type=float, default=None,
        help="residency budget (overrides SPARKDL_SERVE_HBM_BUDGET_MB)",
    )
    p_serve.add_argument(
        "--max-batch", type=int, default=None,
        help="full batch geometry (overrides SPARKDL_SERVE_MAX_BATCH)",
    )
    p_serve.add_argument(
        "--device", default=None,
        help="device to serve on (default cuda; 'cpu' on request)",
    )
    p_serve.add_argument(
        "--seed", type=int, default=0, help="seed of the models' random weights",
    )
    p_gw = sub.add_parser(
        "gateway", help="run the supervised serving gang behind one routing door"
    )
    p_gw.add_argument(
        "--workers", type=int, default=None,
        help="gang size (default SPARKDL_GATEWAY_WORKERS)",
    )
    p_gw.add_argument("--port", type=int, default=None)
    p_gw.add_argument(
        "--gang-dir", default=None,
        help="port files, heartbeats and worker logs (default: a temp dir)",
    )
    p_w = sub.add_parser("worker", help="one supervised serving worker (gateway-launched)")
    p_w.add_argument("--rank", type=int, required=True)
    p_w.add_argument("--gang-dir", required=True)
    p_w.add_argument("--port", type=int, default=0)
    p_w.add_argument("--heartbeat-interval", type=float, default=1.0)
    for p in (p_gw, p_w):
        p.add_argument(
            "--loader", default=None,
            help="pkg.mod:function model loader (default: the registry)",
        )
        p.add_argument("--budget-mb", type=float, default=None)
        p.add_argument("--max-batch", type=int, default=None)
        p.add_argument(
            "--device", default=None,
            help="each worker's device (default cuda; 'cpu' on request)",
        )
        p.add_argument("--seed", type=int, default=0, help="seed of the models' random weights")
    sub.add_parser("models", help="print the registry with memory estimates")
    args = parser.parse_args(argv)
    if args.cmd == "worker":
        return _worker_main(args)
    if args.cmd == "gateway":
        return _gateway_main(args)

    if args.cmd == "models":
        from sparkdl_tpu_torch.models import supported_models

        print(json.dumps(supported_models(with_memory=True), indent=2))
        return 0

    from sparkdl_tpu_torch.serving.router import Router
    from sparkdl_tpu_torch.serving.server import ServingServer, configured_port

    if args.budget_mb is not None:
        os.environ["SPARKDL_SERVE_HBM_BUDGET_MB"] = str(args.budget_mb)
    serving_env_defaults()
    port = args.port if args.port is not None else (configured_port() or 8000)
    try:
        router = Router(max_batch=args.max_batch, device=args.device, seed=args.seed)
    except RuntimeError as e:  # no CUDA device and no --device cpu
        print(f"serve: {e}", file=sys.stderr)
        return 2
    router.start()
    server = ServingServer(router, port=port)
    print(
        json.dumps(
            {
                "serving": "up",
                "port": server.port,
                "device": str(router.device),
                "endpoints": [
                    "POST /v1/predict", "/v1/models", "/healthz", "/metrics",
                    "POST /admin/drain",
                ],
            }
        ),
        flush=True,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop(close_router=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
