"""``python -m sparkdl_tpu_torch.resilience``: supervisor and fault-plan CLI.

Subcommands::

    supervise --num-ranks N (--job JOB.json | --cmd TEMPLATE)
              [--device cuda|cpu] [--distributed] [--coordinator H:P]
              [--heartbeat-dir D] [--stale-after S] [--poll-interval S]
              [--grace S] [--max-restarts R]
        Launch and supervise an N-rank gang: gang-kill + relaunch on any
        rank death or staleness, capped restarts, a JSON verdict on
        stdout. --job runs ``python -m sparkdl_tpu_torch.worker`` per rank
        (the heartbeat dir defaults to the job's ``heartbeat_dir``);
        --cmd is a shlex template with {rank}/{generation}/{num_ranks}
        placeholders, for any other gang binary.

    plan [PLAN]
        Parse a fault plan (argument, or $SPARKDL_FAULT_PLAN) and print
        the parsed rules as JSON; exit 2 with the grammar error on a bad
        plan.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from sparkdl_tpu_torch.resilience import faults
from sparkdl_tpu_torch.resilience.supervisor import supervise_main
from sparkdl_tpu_torch.runtime import knobs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparkdl_tpu_torch.resilience",
        description="Gang supervision and fault-plan tooling.",
    )
    sub = ap.add_subparsers(dest="cmd_name", required=True)

    p_sup = sub.add_parser(
        "supervise", help="launch + watch + gang-restart an N-rank gang"
    )
    p_sup.add_argument("--num-ranks", type=int, required=True)
    p_sup.add_argument(
        "--job", default=None,
        help="batch worker job spec (python -m sparkdl_tpu_torch.worker per rank)",
    )
    p_sup.add_argument(
        "--device", choices=("cuda", "cpu"), default=None,
        help="--job: the workers' device (their default: cuda)",
    )
    p_sup.add_argument(
        "--distributed", action="store_true",
        help="--job: join the torch.distributed process group (train jobs)",
    )
    p_sup.add_argument(
        "--coordinator", default=None,
        help="--job with --distributed: the process group's host:port",
    )
    p_sup.add_argument(
        "--cmd", default=None,
        help="launch template with {rank}/{generation}/{num_ranks} "
        "placeholders",
    )
    p_sup.add_argument(
        "--heartbeat-dir", default=None,
        help="gang heartbeat dir (none: liveness only)",
    )
    p_sup.add_argument("--stale-after", type=float, default=60.0,
                       help="seconds without a beat before a rank counts "
                       "as wedged; <= 0 disables the staleness channel")
    p_sup.add_argument("--poll-interval", type=float, default=0.5)
    p_sup.add_argument(
        "--grace", type=float, default=None,
        help="seconds after launch before staleness verdicts count "
        "(default: max(stale-after, 5))",
    )
    p_sup.add_argument(
        "--max-restarts", type=int, default=None,
        help="restart cap (default SPARKDL_SUPERVISOR_RETRY_ATTEMPTS-1, "
        "or 3)",
    )

    p_plan = sub.add_parser(
        "plan", help="validate + pretty-print a fault plan"
    )
    p_plan.add_argument(
        "plan", nargs="?", default=None,
        help=f"plan string (default ${faults.PLAN_ENV})",
    )

    args = ap.parse_args(argv)
    if args.cmd_name == "supervise":
        return supervise_main(args)
    # plan
    plan = (
        args.plan if args.plan is not None else knobs.get_str(faults.PLAN_ENV)
    )
    if not plan:
        print(
            f"plan: no plan given and ${faults.PLAN_ENV} is unset",
            file=sys.stderr,
        )
        return 2
    try:
        rules = faults.parse_plan(plan)
    except faults.FaultPlanError as e:
        print(json.dumps({"plan": "INVALID", "error": str(e)}),
              file=sys.stderr)
        return 2
    print(
        json.dumps(
            {
                "plan": "OK",
                "rules": [
                    {
                        "index": r.index,
                        "source": r.source,
                        "action": r.action,
                        "arg": r.arg,
                        "match": dict(r.match),
                        "times": r.times,
                        "p": r.p,
                    }
                    for r in rules
                ],
            },
            indent=1,
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
