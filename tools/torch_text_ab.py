#!/usr/bin/env python3
"""Text main path of the PyTorch port, one source tree against another, on
one card: bert-base TextEmbedder rows/s (``chip_smoke.py`` phase 4's pass)
and warm direct dispatches, f32 and bf16.

Each tree runs in a child process of its own, in the order given, so that
two trees are compared within one machine's run (give them as A B B A).
A child imports the port and ``chip_smoke.py`` from its tree, builds the
kernel there, and prints one JSON line; this script prints them and, last,
a summary of each tree's median. Run from the repository root::

    python3 tools/torch_text_ab.py --tree parent=DIR --tree change=. \\
        --order parent,change,change,parent

The summary gives each tree's median, range and dispatch times, the
first tree's interquartile range of rows/s, and how many of the pairs
(consecutive children) the second tree won.

Needs a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = r"""
import json, os, sys, time
import numpy as np, torch
import chip_smoke as cs
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.models import get_model
from sparkdl_tpu_torch.ops.flash_attention import flash_attention

seed, n_texts, passes, iters = (int(a) for a in sys.argv[1:5])
cs.phase_device()
cs.phase_build()
os.environ["SPARKDL_TEXT_BUCKETING"] = "1"
texts = cs._texts(seed, n_texts)
df = DataFrame.fromColumns({"text": texts}, numPartitions=4)
warm = DataFrame.fromColumns({"text": texts[:64]}, numPartitions=1)
rng = np.random.default_rng(seed)
ids = torch.from_numpy(rng.integers(1, 30000, size=(32, 128)).astype(np.int32)).cuda()
mask = torch.ones_like(ids)
out = {}
for dtype in (torch.float32, torch.bfloat16):
    tag = str(dtype)[6:]
    mf = get_model("bert-base").model_function(dtype=dtype, seed=seed)
    cs._embed(mf, warm)
    rates = []
    for _ in range(passes):
        _, dt, _, _ = cs._embed(mf, df)
        rates.append(len(texts) / dt)
    inner = mf.module
    with torch.inference_mode():
        for _ in range(5):
            inner.embed(ids, mask)
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        for _ in range(iters):
            inner.embed(ids, mask)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / iters * 1e3
    out[tag] = {"rows_per_s": rates, "dispatch_ms": ms, "launches_per_dispatch": flash_attention.launches / iters}
    del mf, inner
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, help="NAME=DIR, a source tree of the repository")
    ap.add_argument("--order", required=True, help="tree names in running order, comma-separated")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--texts", type=int, default=512)
    ap.add_argument("--passes", type=int, default=3, help="TextEmbedder passes per dtype and child")
    ap.add_argument("--iters", type=int, default=50, help="timed direct dispatches per dtype and child")
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    results = {name: [] for name in trees}
    order = args.order.split(",")
    runs_in_order = []
    for name in order:
        root = os.path.abspath(trees[name])
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, str(args.seed), str(args.texts), str(args.passes), str(args.iters)],
            cwd=root, env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{name}: the child failed with {proc.returncode}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        results[name].append(got)
        runs_in_order.append((name, got))
        print(json.dumps({"tree": name, **got}), flush=True)
    summary = {}
    for name, runs in results.items():
        summary[name] = {}
        for tag in ("float32", "bfloat16"):
            rates = [r for run in runs for r in run[tag]["rows_per_s"]]
            ms = [run[tag]["dispatch_ms"] for run in runs]
            summary[name][tag] = {"rows_per_s_median": statistics.median(rates), "rows_per_s_min": min(rates),
                                  "rows_per_s_max": max(rates), "dispatch_ms_median": statistics.median(ms),
                                  "dispatch_ms": ms,
                                  "launches_per_dispatch": runs[0][tag]["launches_per_dispatch"]}
    # consecutive children form pairs (give the order as A B B A A B ...):
    # per dtype, how often the second-named tree's median pass beat the first's
    if len(trees) == 2 and len(order) % 2 == 0:
        first, second = sorted(trees, key=order.index)
        for tag in ("float32", "bfloat16"):
            wins = 0
            for (n1, r1), (n2, r2) in zip(runs_in_order[::2], runs_in_order[1::2]):
                med = {n1: statistics.median(r1[tag]["rows_per_s"]), n2: statistics.median(r2[tag]["rows_per_s"])}
                wins += med[second] > med[first]
            rates = sorted(r for run in results[first] for r in run[tag]["rows_per_s"])
            q = statistics.quantiles(rates, n=4) if len(rates) > 1 else [rates[0]] * 3
            summary[second][tag]["pairs_won"] = f"{wins}/{len(order) // 2}"
            summary[first][tag]["rows_per_s_iqr"] = q[2] - q[0]
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
