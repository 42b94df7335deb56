#!/usr/bin/env python3
"""Where an eager pipeline call spends its time, on one GPU.

``parallel.pipeline_apply`` over ``{"pp": 1}`` runs bert-base's 12 layers
(over the flash kernel, no padding mask) once per microbatch, so it
issues the layers' kernels once per microbatch. This script times, in
bf16 and f32 at B=32 L=512, each of: the 12 layers called directly on
the whole batch; one microbatch (B/4) through the layers, called directly
and through ``torch.func.functional_call`` over stacked parameters (the
stage function ``chip_smoke.py`` phase 28(b) uses); and the whole
pipeline call (4 microbatches). For each it prints the host's enqueue
time (the host clock around one call issued onto an idle device, no
synchronize inside) and the time per call of back-to-back calls (CUDA
events), so a call whose enqueue time is close to its time per call is
bound by the host.

    python3 tools/torch_pipeline_probe.py [--seed 0] [--iters 10]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from dataclasses import replace

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sparkdl_tpu_torch.models.bert import BERT_CONFIGS  # noqa: E402
from sparkdl_tpu_torch.models.registry import _bert_encoder  # noqa: E402
from sparkdl_tpu_torch.ops.flash_attention import make_flash_attention_fn  # noqa: E402
from sparkdl_tpu_torch.parallel import make_mesh, pipeline_apply, stack_stage_params  # noqa: E402

B, L, MICRO = 32, 512, 4


class _LayerStack(torch.nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = layers

    def forward(self, h):
        for layer in self.layers:
            h = layer(h, None)
        return h


def _times(fn, iters: int):
    """(host enqueue ms, ms per call), after two warm-up calls."""
    for _ in range(2):
        fn()
    host = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host += time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return host * 1e3 / iters, start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} ({smi}), torch {torch.__version__}")
    config = BERT_CONFIGS["base"]
    mesh = make_mesh({"pp": 1})
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x0 = torch.randn((B, L, config.hidden_size), generator=gen, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        stack = _LayerStack(_bert_encoder(replace(config, dtype=dtype), make_flash_attention_fn(), args.seed, None,
                                          "cuda").layers)
        stacked = stack_stage_params([{n: p.detach() for n, p in stack.named_parameters()}])
        local = {n: t[0] for n, t in stacked.items()}

        def stage(params, h):
            return torch.func.functional_call(stack, params, (h,))

        x = x0.to(dtype)
        mb = x[: B // MICRO]
        rows = {
            "12 layers, whole batch": lambda: stack(x),
            "12 layers, one microbatch": lambda: stack(mb),
            "functional_call, one microbatch": lambda: stage(local, mb),
            f"pipeline_apply, {MICRO} microbatches": lambda: pipeline_apply(stage, stacked, x, mesh,
                                                                             n_microbatches=MICRO),
        }
        with torch.no_grad():
            for name, fn in rows.items():
                host, per_call = _times(fn, args.iters)
                print(f"{str(dtype)[6:]} {name}: host enqueue {host:.3f} ms, {per_call:.3f} ms per call "
                      f"back to back{' (host-bound)' if host > 0.9 * per_call else ''}")
        del stack, stacked, local
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
