"""``python -m sparkdl_tpu_torch.obs``: the flight recorder's and the
fleet telemetry's CLI, the port of the JAX package's ``obs/__main__.py``
(the same subcommands, flags and exit codes).

Subcommands::

    report   [--snapshot F]           per-stage p50/p95/p99 breakdown table
             [--rank-dir D]           ...plus the per-rank stage table with
             [--straggler-factor X]   straggler flags, from obs.rank.*.json
    trace    ID [--snapshot F]        render one request's end-to-end
             [--rank-dir D]           waterfall (queue/group/stage/dispatch/
                                      drain/scatter) across every process
                                      that recorded it; ID may be a unique
                                      prefix (e.g. off a p99 exemplar line)
    slo      [--snapshot F]           burn-rate SLO status: live engine
                                      (JSON), or a snapshot's recorded
                                      view ({"armed": false} when no
                                      objective knob is set)
    fleet    [--snapshot F]           fused fleet view: the gateway's
             [--history N]            live fleet-sample ring (latest
                                      fused sample + optional trend
                                      history), or a snapshot's view
    mem      [--snapshot F]           device-memory ledger: live per-
             [--history N]            device/per-model bytes + watermark
                                      ring trend, or a snapshot's
                                      recorded view ({"tracked": false}
                                      when nothing was attributed)
    chrome   --out F [--snapshot F]   chrome://tracing / Perfetto export
    merge    DIR --out F              fuse per-rank snapshot drops into ONE
                                      Chrome trace with a lane per rank and
                                      request flows stitched across lanes
    snapshot --out F                  dump the LIVE process recorder (only
                                      useful in-process / from tooling)
    serve    [--port N]               run the Prometheus/JSON HTTP exporter
                                      in the foreground (Ctrl-C to stop)

``--snapshot`` reads a JSON file produced by ``obs.write_snapshot`` (or
a dump-on-failure file); without it, report/chrome read the current
process's live recorder. ``--rank-dir`` points at a heartbeat directory
where gang ranks drop ``obs.rank.<r>.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from sparkdl_tpu_torch.obs import aggregate, export, report


def _load(path: Optional[str]) -> dict:
    if path is None:
        return export.snapshot()
    with open(path) as f:
        snap = json.load(f)
    if "spans" not in snap:
        raise SystemExit(
            f"{path}: not an obs snapshot (no 'spans' key; expected the "
            "schema written by sparkdl_tpu_torch.obs.export.write_snapshot)"
        )
    return snap


def _load_rank_dir(directory: str) -> dict:
    snaps = aggregate.load_rank_snapshots(directory)
    if not snaps:
        raise SystemExit(
            f"{directory}: no obs.rank.<r>.json snapshots found (gang "
            "ranks drop them beside their heartbeat files)"
        )
    return snaps


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparkdl_tpu_torch.obs",
        description="Pipeline flight recorder: reports and exports.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_report = sub.add_parser("report", help="per-stage breakdown table")
    p_report.add_argument("--snapshot", default=None)
    p_report.add_argument(
        "--rank-dir", default=None,
        help="directory of per-rank obs.rank.<r>.json drops: also render "
        "the cross-rank stage table with straggler flags",
    )
    p_report.add_argument(
        "--straggler-factor", type=float, default=None,
        help="flag a stage when its slowest rank exceeds the median by "
        "this factor (default SPARKDL_OBS_STRAGGLER_X or 1.5)",
    )

    p_trace = sub.add_parser(
        "trace", help="render one request's cross-process waterfall"
    )
    p_trace.add_argument(
        "trace_id",
        help="trace id (or unique prefix) from a reply header/body, a "
        "/metrics exemplar line, or an obs report latency line",
    )
    p_trace.add_argument("--snapshot", default=None)
    p_trace.add_argument(
        "--rank-dir", default=None,
        help="directory of per-rank obs.rank.<r>.json drops: stitch the "
        "waterfall across every process that recorded this trace",
    )

    p_slo = sub.add_parser(
        "slo",
        help="burn-rate SLO status: live engine, or a snapshot's view",
    )
    p_slo.add_argument("--snapshot", default=None)

    p_fleet = sub.add_parser(
        "fleet",
        help="fused fleet view: the live fleet-sample ring (gateway "
        "process), or a snapshot's recorded view",
    )
    p_fleet.add_argument("--snapshot", default=None)
    p_fleet.add_argument(
        "--history", type=int, default=0,
        help="also print the last N banked fleet samples (trend lines)",
    )

    p_mem = sub.add_parser(
        "mem",
        help="device-memory ledger: live per-device/per-model bytes "
        "and watermark trend, or a snapshot's recorded view",
    )
    p_mem.add_argument("--snapshot", default=None)
    p_mem.add_argument(
        "--history", type=int, default=0,
        help="also print the last N watermark-ring samples (trend lines)",
    )

    p_chrome = sub.add_parser(
        "chrome", help="export a chrome://tracing / Perfetto trace"
    )
    p_chrome.add_argument("--snapshot", default=None)
    p_chrome.add_argument("--out", required=True)

    p_merge = sub.add_parser(
        "merge",
        help="fuse per-rank snapshot drops into one multi-lane Chrome trace",
    )
    p_merge.add_argument("dir", help="heartbeat dir with obs.rank.<r>.json")
    p_merge.add_argument("--out", default=None)

    p_snap = sub.add_parser(
        "snapshot", help="write the live recorder to a JSON snapshot"
    )
    p_snap.add_argument("--out", required=True)

    p_serve = sub.add_parser(
        "serve", help="run the HTTP exporter in the foreground"
    )
    p_serve.add_argument(
        "--port", type=int, default=None,
        help="port to bind (default SPARKDL_OBS_PORT; 0 = ephemeral)",
    )

    args = ap.parse_args(argv)
    if args.cmd == "report":
        if args.snapshot is not None or args.rank_dir is None:
            print(report.render_report(_load(args.snapshot)))
        if args.rank_dir is not None:
            snaps = _load_rank_dir(args.rank_dir)
            print(
                aggregate.render_rank_report(
                    snaps, factor=args.straggler_factor
                )
            )
    elif args.cmd == "trace":
        from sparkdl_tpu_torch.obs import trace as trace_mod

        if args.rank_dir is not None:
            snaps = _load_rank_dir(args.rank_dir)
        else:
            snaps = {0: _load(args.snapshot)}
        records = trace_mod.collect_trace(args.trace_id, snaps)
        if not records:
            raise SystemExit(
                f"trace {args.trace_id!r}: no records found (not "
                "sampled/retained, ambiguous prefix, or wrong "
                "snapshot source — pass --rank-dir for gang runs)"
            )
        print(trace_mod.render_waterfall(args.trace_id, records))
    elif args.cmd == "slo":
        from sparkdl_tpu_torch.obs import slo as slo_mod

        if args.snapshot is not None:
            summary = report.slo_summary(_load(args.snapshot))
            if summary is None:
                raise SystemExit(
                    f"{args.snapshot}: no SLO state recorded (no "
                    "objective was armed in that process)"
                )
            print(json.dumps(summary, indent=1))
        else:
            print(
                json.dumps(
                    slo_mod.engine_status() or {"armed": False}, indent=1
                )
            )
    elif args.cmd == "fleet":
        from sparkdl_tpu_torch.obs import timeseries as ts_mod

        if args.snapshot is not None:
            summary = report.fleet_summary(_load(args.snapshot))
            if summary is None:
                raise SystemExit(
                    f"{args.snapshot}: no fleet state recorded (no "
                    "fleet scrape ran in that process — only the "
                    "gateway fuses the gang)"
                )
            print(json.dumps(summary, indent=1))
        else:
            hist = ts_mod.fleet_series()
            out = {
                "samples": len(hist),
                "latest": hist[-1] if hist else None,
            }
            if args.history:
                out["history"] = hist[-args.history:]
            print(json.dumps(out, indent=1))
    elif args.cmd == "mem":
        from sparkdl_tpu_torch.obs import memory as mem_mod
        from sparkdl_tpu_torch.obs import timeseries as ts_mod

        if args.snapshot is not None:
            summary = report.memory_summary(_load(args.snapshot))
            if summary is None:
                raise SystemExit(
                    f"{args.snapshot}: no memory state recorded (the "
                    "ledger never attributed any bytes in that process)"
                )
            print(json.dumps(summary, indent=1))
        else:
            out = mem_mod.memory_status() or {"tracked": False}
            if args.history:
                out["history"] = ts_mod.mem_series()[-args.history:]
            print(json.dumps(out, indent=1))
    elif args.cmd == "chrome":
        path = export.write_chrome_trace(args.out, _load(args.snapshot))
        print(path)
    elif args.cmd == "merge":
        snaps = _load_rank_dir(args.dir)
        import os

        out = args.out or os.path.join(args.dir, "obs_merged_trace.json")
        path = aggregate.write_merged_trace(out, snaps)
        print(path)
    elif args.cmd == "snapshot":
        print(export.write_snapshot(args.out))
    elif args.cmd == "serve":
        from sparkdl_tpu_torch.obs import serve as serve_mod

        server = serve_mod.start_server(
            args.port if args.port is not None else serve_mod.configured_port() or 0
        )
        print(f"serving obs on :{server.port} (/metrics /snapshot /series)")
        try:
            import time

            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            serve_mod.stop_server()
    return 0


if __name__ == "__main__":
    sys.exit(main())
