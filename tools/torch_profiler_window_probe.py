#!/usr/bin/env python3
"""Which of a torch.profiler window's kernel records are lost, in a process
minutes old, and does ``chip_smoke.counted_profile`` keep every one?

Each window launches 40 spin kernels from the main thread, 5 ms apart, and
finds by CUDA correlation id which of them have a kernel record in the
exported trace; it also reports what ``chip_smoke.device_kernels`` (the
reader behind the smoke script's launch checks) counts. Two windows run
while the process is fresh; then, after a 150 s wait, six plain
``profile(activities=[CUDA])`` windows alternate with six
``counted_profile`` windows, and a last ``counted_profile`` window launches
from a second thread. The last line gives the records lost by each kind.
Run from the repository root::

    python3 tools/torch_profiler_window_probe.py

Needs a CUDA device; takes about 3 minutes.
"""
import json
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, ".")
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs

N, GAP, CYC = 40, 0.005, 20000
OUT = tempfile.mkdtemp(prefix="profiler_probe_")
print(torch.__version__, torch.cuda.get_device_name(0), flush=True)
torch.cuda._sleep(1000)
torch.cuda.synchronize()
T0 = time.monotonic()


def measured():
    for i in range(N):
        torch.cuda._sleep(CYC * (i + 1))
        time.sleep(GAP)


def window(tag, counted, body=measured):
    torch.cuda.synchronize()
    ctx = cs.counted_profile() if counted else profile(activities=[ProfilerActivity.CUDA])
    with ctx as prof:
        body()
        torch.cuda.synchronize()
    p = f"{OUT}/{tag}.json"
    prof.export_chrome_trace(p)
    ev = json.load(open(p))["traceEvents"]
    ls = sorted((e for e in ev if e.get("name") == "cudaLaunchKernel"), key=lambda e: e["ts"])
    ks = {e["args"].get("correlation") for e in ev if e.get("cat") == "kernel"}
    missing = [i for i, e in enumerate(ls[-N:]) if e["args"]["correlation"] not in ks]
    early = sum(e["args"]["correlation"] not in ks for e in ls[:-N])
    spins = sum(n for k, (_, n) in cs.device_kernels(prof).items() if "spin" in k or "sleep" in k)
    print(f"{tag} at {time.monotonic() - T0:.1f} s: counted {counted}: measured missing {len(missing)} {missing[:3]}.."
          f"{missing[-2:]}; warm-up records missing {early} of {len(ls) - N}; device_kernels spin launches {spins}",
          flush=True)
    os.remove(p)
    return len(missing)


window("fresh_plain", False)
window("fresh_counted", True)
time.sleep(150)
lost = {False: 0, True: 0}
for k in range(6):
    lost[False] += window(f"aged_plain_{k}", False)
    lost[True] += window(f"aged_counted_{k}", True)


def threaded():
    t = threading.Thread(target=measured, name="sparkdl-probe-launch", daemon=False)
    t.start()
    t.join()


lost[True] += window("aged_counted_thread", True, threaded)
os.rmdir(OUT)
print("lost", lost, flush=True)
