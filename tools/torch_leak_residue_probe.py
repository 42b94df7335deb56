"""What a serving router's leak checks see on the card.

Runs ``chip_smoke.py``'s phases 1-5 (with ``--whole``, 6-10 too), then phase
11 with the CUDA caching allocator's history on. At each model's leak check
(``obs/memory.MemoryLedger.leak_check``, after an evict) it records the
residue (ground truth minus the baseline moved by what the ledger tracked)
and every live block of 1 MiB or more with its state and the Python frames
that allocated it, into ``chiprun_out/leak_residue_<tag>.json``, with each
load's charge (the allocator's blocks behind the module) beside
``memory_allocated`` at that point; it prints both. Run from the repository root on a machine with
a CUDA device: ``python3 tools/torch_leak_residue_probe.py [--whole] [tag]``
(about 2 minutes; 10 with ``--whole``).
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sparkdl_tpu_torch.obs import memory as mem  # noqa: E402


def live_blocks() -> list:
    blocks = []
    for seg in torch.cuda.memory._snapshot()["segments"]:
        for b in seg["blocks"]:
            if b["state"] == "inactive" or b["size"] < (1 << 20):
                continue
            frames = [f"{f['filename'].rsplit('/', 2)[-1]}:{f['line']}:{f['name']}" for f in b.get("frames", [])]
            blocks.append({"size": b["size"], "state": b["state"], "frames": frames[:14]})
    return blocks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--whole", action="store_true", help="run phases 6-10 before phase 11 too")
    ap.add_argument("tag", nargs="?", default="0")
    args = ap.parse_args()
    out = os.path.join("chiprun_out", f"leak_residue_{args.tag}.json")
    checks = []
    leak_check = mem.MemoryLedger.leak_check

    def traced(self, name, baseline_truth, baseline_tracked, now=None):
        truth = torch.cuda.memory_allocated()
        with self._lock:
            tracked, _ = self._totals_locked()
        checks.append({
            "model": name, "t": time.time(), "truth": truth, "baseline_truth": baseline_truth,
            "tracked": tracked, "baseline_tracked": baseline_tracked,
            "residue": truth - (baseline_truth + tracked - (baseline_tracked or 0)), "blocks": live_blocks(),
        })
        return leak_check(self, name, baseline_truth, baseline_tracked, now=now)

    mem.MemoryLedger.leak_check = traced
    loads = []
    block_bytes = mem.allocated_block_bytes

    def traced_blocks(module):
        charge = block_bytes(module)
        loads.append({"charge": charge, "truth": torch.cuda.memory_allocated()})
        return charge

    mem.allocated_block_bytes = traced_blocks
    name = cs.phase_device()
    cs.phase_build()
    cs.phase_kernels(0)
    cs.phase_main_path(0, 512, name)
    cs.phase_breakdown(0, 512)
    if args.whole:
        with tempfile.TemporaryDirectory() as tmp:
            for model in ("ResNet50", "InceptionV3"):
                structs, labels = cs._colour_structs(0, cs.N_IMAGES[model], cs.get_image_model(model).height)
                weights = os.path.join(tmp, f"{model}.npz")
                cs._write_seeded_weights(model, 0, weights)
                cs.phase_transfer_learning(model, 0, structs, labels, name, weights)
                cs.phase_image_breakdown(model, structs, weights)
                del structs
                os.remove(weights)
            for model in cs.FAMILIES:
                cs.phase_family(model, 0, name, tmp)
            cs.phase_predictor(cs.PREDICTOR_MODEL, 0, tmp)
    torch.cuda.memory._record_memory_history(enabled="all", context="all", stacks="python", max_entries=200000)
    try:
        cs.phase_serving(0, name)
    finally:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"checks": checks, "loads": loads}, f)
        print("leak checks (model, residue B):", [(c["model"], c["residue"]) for c in checks])
        print("loads (charge from the allocator's blocks, memory_allocated at that point):",
              [(ld["charge"], ld["truth"]) for ld in loads])
    return 0


if __name__ == "__main__":
    sys.exit(main())
