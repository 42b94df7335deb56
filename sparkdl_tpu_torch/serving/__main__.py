"""CLI for the port's serving layer.

    python -m sparkdl_tpu_torch.serving serve  [--port P] [--budget-mb N]
                                               [--max-batch N] [--device D]
                                               [--seed S]
    python -m sparkdl_tpu_torch.serving models

``serve`` binds the single-process HTTP front end over the named-model
registry (port from ``--port`` or ``SPARKDL_SERVE_PORT``, default 8000)
and blocks until interrupted. It runs on ``cuda`` unless ``--device cpu``
is given, and exits with an error without a card. ``models`` prints the
registry with each model's parameter-byte estimate. The JAX package's
``gateway`` and ``worker`` subcommands are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional


def serving_env_defaults() -> None:
    """Serving-process feeder defaults (explicit env still wins): owners
    never idle-exit between bursts, and the stream registry is sized for
    model x rung x geometry populations."""
    os.environ.setdefault("SPARKDL_FEEDER_IDLE_S", "0")
    os.environ.setdefault("SPARKDL_MAX_FEEDERS", "32")


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
    sub.add_parser("models", help="print the registry with memory estimates")
    args = parser.parse_args(argv)

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
