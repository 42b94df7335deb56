#!/usr/bin/env python3
"""Drive the PyTorch port (``sparkdl_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--texts 512]

Phases; any failure ends the run with a non-zero exit and no result line:

1. device: a CUDA device must be present; prints its name,
   ``nvidia-smi``'s name and power limit, and the TF32 switches, which
   stay at PyTorch's defaults.
2. build: compiles every kernel of the path from ``sparkdl_tpu_torch/csrc``
   with nvcc for sm_90a (printing ptxas' resource use).
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the path gives it (bert-base B=32 H=12 L in {128, 512} Dh=64
   in f32 and bf16, a ragged L=200, bert-long B=4 H=4 L=2048 Dh=32), with
   a padding mask and one row whose keys are all masked (that row must
   come out as exactly 0). Tolerances: f32 atol 1e-4 (summation order;
   the f32 kernel runs 3xTF32), bf16 atol 3e-2 (P and the output rounded
   to bf16); the bf16 kernel is also held, at rtol 1e-2 and atol 4e-3,
   against the plain version with P rounded to bf16 as the kernel does,
   and the mean |output| is printed beside. Times by CUDA events over
   back-to-back calls, and the kernel's own device time from
   torch.profiler (at short lengths the calls are bound by the wrapper's
   host time); the least time the card could take for the kernel's route
   (``sparkdl_tpu_torch.bench_bounds``: HBM bytes, or the products at the
   bf16 tensor-core peak, or three TF32 products at the TF32 peak for
   f32; H100 SXM data sheet), with every share of it checked <= 1.05; the
   plain version's time; and F.scaled_dot_product_attention as a
   yardstick only (the port never calls it).
4. main path: ``TextEmbedder`` over ``get_model("bert-base")`` (768 wide,
   12 layers, random weights from ``--seed``), maxLength 512, batchSize
   32, sequence bucketing on, over a 4-partition DataFrame of synthetic
   texts of 8 to 500 words. Checks a finite 768-d vector per row, that
   the flash kernel ran exactly 12 times per dispatched batch, and that
   the embeddings match the dense-attention build at f32 atol 1e-3 and
   bf16 atol 3e-2. Prints rows/s and real tokens/s.
5. breakdown: host tokenization alone, and device time by kernel from
   torch.profiler over one more pass in f32 and in bf16.
6. image path, ResNet50 (BASELINE config[1]'s model):
   ``DeepImageFeaturizer(modelName="ResNet50")`` (224x224, stages
   [3, 4, 6, 3], 2048-d features, caffe preprocessing; random weights from
   ``--seed``, written as a flax ``.npz`` and passed as ``weightsFile``)
   over 1024 synthetic 224x224 BGR structs in two colour classes, 4
   partitions, batchSize 32, in bf16 and f32, each after a warm-up pass.
   Checks a finite 2048-d vector per row; the card's f32 features of 40
   rows (10 from each partition, first to last row) against the port on
   the CPU with the same weights, and the same rows on the card again as a
   full and a zero-padded tail batch (relative max error 1e-5, which TF32
   would not meet: the f32 model turns TF32 off itself); bf16 against f32
   on the card, row by row against each row's own scale (``BF16_ROW_REL``);
   a ``LogisticRegression`` fit on the card against the same fit on the
   CPU (``w``, ``b`` at atol 1e-4), and prints its accuracy on a held-out
   split. Prints images/s per dtype. The path runs no hand-written kernel:
   the convolutions are cuDNN's.
7. image breakdown, ResNet50: MACs per image (convs and head), then one
   more featurizer pass per dtype under torch.profiler: wall time, device
   busy and its share, the conv and head FLOP rate over device busy as a
   share of the dtype's peak, and the top 5 device kernels.
8. BASELINE config[0]: phase 6's checks and head over
   ``DeepImageFeaturizer(modelName="InceptionV3")`` (299x299, 'tf'
   preprocessing, 2048-d) and 1024 synthetic 299x299 structs.
9. image breakdown, InceptionV3, as phase 7.
10. the rest of the family: for Xception (299x299), VGG16, VGG19 and
    MobileNetV2 (224x224), a features pass over 256 synthetic images at
    the model's size in bf16 and f32: images/s, one profiled pass (device
    busy, its share, the FLOP rate over it), the card's f32 against the
    CPU's over 8 rows (relative 1e-5) and bf16 against f32 row by row.
    Then ``DeepImagePredictor(decodePredictions=True, topK=5)`` over
    MobileNetV2 in f32 with a labels file this script writes, over 40 rows
    with one null: its probabilities against the CPU's (relative 1e-5),
    and each decoded row the top 5 of the card's own probabilities, under
    the file's labels.

The line before the last is the ``kernels`` JSON record (the f32 and the
bf16 kernel at bert-base L=512, launches from each dtype's main-path run);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from sparkdl_tpu_torch.bench_bounds import (
    PEAK_FLOP_PER_S,
    flash_attention_bound_ms,
    model_macs,
)
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.dataframe.frame import partition_row_spans
from sparkdl_tpu_torch.estimators import LogisticRegression
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.models import get_image_model, get_model
from sparkdl_tpu_torch.models.convert import cnn_params_to_flax
from sparkdl_tpu_torch.models.registry import _bert_text_builder, save_flax_npz
from sparkdl_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from sparkdl_tpu_torch.runtime import cuda_build
from sparkdl_tpu_torch.transformers.named_image import (
    DeepImageFeaturizer,
    DeepImagePredictor,
)
from sparkdl_tpu_torch.transformers.text import HashingTokenizer, TextEmbedder
from sparkdl_tpu_torch.utils.metrics import metrics

ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
#: the bf16 kernel against the plain version with P rounded to bf16 as
#: the kernel rounds it: what is left is the output's own bf16 rounding
#: (rtol) and P elements that round the other way (atol)
BF16_EMULATION_TOL = {"rtol": 1e-2, "atol": 4e-3}
MASK_MIN = float(np.finfo(np.float32).min)
BERT_BASE_LAYERS = 12
#: a measured time below its bound is impossible; 5 % covers event timing
MAX_SHARE_OF_BOUND = 1.05
#: the kernels of csrc/flash_attention.cu, as the profiler names them
FLASH_KERNEL_NAMES = ("flash_bf16_wgmma_kernel", "flash_f32_tf32x3_kernel")
#: the kernels line: the f32 kernel keeps the name it has had since the
#: first slice, the bf16 kernel gets its own record
RECORD_NAMES = {torch.float32: "flash_attention", torch.bfloat16: "flash_attention_bf16"}
#: the image paths' workload: synthetic images at the model's size for
#: ResNet50 (phase 6) and InceptionV3 (phase 8), partitions, batch
N_IMAGES = {"ResNet50": 1024, "InceptionV3": 1024}
IMAGE_PARTITIONS = 4
IMAGE_BATCH = 32
#: rows of each partition held against the CPU: the first and last rows
#: and rows spread over the batches between
SAMPLE_PER_PARTITION = 10
#: relative max error (max |a - b| / max |b|) of the card's f32 features
#: against the CPU's: only the summation order differs. TF32 rounds each
#: conv's inputs to a 10-bit mantissa (unit roundoff 4.9e-4), far above
#: this bound, so it also shows that the f32 model ran without TF32.
IMAGE_F32_REL = 1e-5
#: the card's bf16 features against its f32, row by row, each row's gap
#: over that row's own max |f32 feature| (bf16 convs and BatchNorm
#: outputs): about twice the gap measured on an H100 80GB HBM3 (ResNet50
#: 6.930e-03, InceptionV3 1.612e-02, Xception 1.216e-02, VGG16 6.515e-03,
#: VGG19 7.728e-03, MobileNetV2 2.353e-02)
BF16_ROW_REL = {
    "ResNet50": 1.5e-2,
    "InceptionV3": 3.5e-2,
    "Xception": 2.5e-2,
    "VGG16": 1.5e-2,
    "VGG19": 1.5e-2,
    "MobileNetV2": 5e-2,
}
#: phase 10: the other families, images per pass, rows held against the
#: CPU; the predictor's family and rows
FAMILIES = ("Xception", "VGG16", "VGG19", "MobileNetV2")
FAMILY_IMAGES = 256
FAMILY_CPU_ROWS = 8
PREDICTOR_MODEL = "MobileNetV2"
PREDICTOR_IMAGES = 40
#: the head fitted on the card against the same fit on the CPU
LR_ATOL = 1e-4
#: the head's L2 penalty: the default for ResNet50; none for InceptionV3,
#: whose features from random weights are about 1e-3 (no residual path
#: keeps their scale), so that the default penalty holds every weight
#: near 0 and the fit predicts one class
LR_REG = {"ResNet50": 1e-4, "InceptionV3": 0.0}
#: BGR colours of the two synthetic classes, and the noise around them
CLASS_BGR = ((40, 60, 200), (200, 80, 40))
NOISE = 40


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def time_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, by CUDA events, after a
    warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(prof) -> dict:
    """``{kernel name: (device seconds, launches recorded)}`` in a finished
    torch.profiler run. Device-side events only: a host op's device total
    repeats the time of the kernels it launched."""
    from torch.autograd import DeviceType

    return {
        ev.key: (ev.self_device_time_total / 1e6, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    }


def device_ms(fn, iters: int, names=None):
    """Mean device time per call in ms of the kernels whose names contain
    one of ``names`` (all kernels if None), from torch.profiler over
    ``iters`` calls. None when the reading is incomplete: no device time,
    or a kernel recorded a number of times that is not a whole number per
    call (the profiler sometimes drops events, and the time it then
    reports is a fraction of the true one)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    picked = [
        (sec, count) for key, (sec, count) in device_kernels(prof).items()
        if names is None or any(n in key for n in names)
    ]
    if not picked or any(count % iters for _, count in picked):
        return None
    return sum(sec for sec, _ in picked) / iters * 1e3


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device: chip_smoke needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"device: {name} (count {torch.cuda.device_count()})")
    print(f"nvidia-smi name, power.limit: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(
        f"TF32 switches at PyTorch's defaults, left as they are: cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
    )
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = cuda_build.build_library("flash_attention")
    print(f"build: flash_attention -> {os.path.relpath(lib)} in "
          f"{time.perf_counter() - t0:.1f} s")
    print(cuda_build.build_log("flash_attention").strip())


def _attention_inputs(B, H, L, Dh, dtype, seed, fully_masked_row):
    rng = np.random.default_rng(seed)
    q, k, v = (
        torch.from_numpy(rng.normal(size=(B, H, L, Dh)).astype(np.float32))
        .to("cuda", dtype)
        for _ in range(3)
    )
    lengths = rng.integers(L // 4, L + 1, size=B)
    lengths[-1] = L
    if fully_masked_row:
        lengths[0] = 0
    mask = torch.zeros(B, L)
    for b, n in enumerate(lengths):
        mask[b, n:] = MASK_MIN
    return q, k, v, mask.cuda()


def phase_kernels(seed: int) -> dict:
    """flash_attention against its plain version; returns the records of
    the main path's largest shape (bert-base, L=512) by dtype."""
    cases = [
        ("bert-base", 32, 12, 128, 64, torch.float32),
        ("bert-base", 32, 12, 512, 64, torch.float32),
        ("bert-base", 32, 12, 128, 64, torch.bfloat16),
        ("bert-base", 32, 12, 512, 64, torch.bfloat16),
        ("ragged", 32, 12, 200, 64, torch.float32),
        ("ragged", 32, 12, 200, 64, torch.bfloat16),
        ("bert-long", 4, 4, 2048, 32, torch.float32),
        ("bert-long", 4, 4, 2048, 32, torch.bfloat16),
    ]
    records = {}
    for label, B, H, L, Dh, dtype in cases:
        q, k, v, mask = _attention_inputs(B, H, L, Dh, dtype, seed, True)
        out = flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q, k, v, mask)
        err = (out.float() - ref.float()).abs().max().item()
        tag = f"{label} B={B} H={H} L={L} Dh={Dh} {str(dtype)[6:]}"
        check(bool(torch.isfinite(out).all()), f"{tag}: non-finite output")
        check(err <= ATOL[dtype], f"{tag}: max |kernel - plain| {err} > {ATOL[dtype]}")
        check(not out[0].any().item(), f"{tag}: fully masked row is not 0")
        emu_note = ""
        if dtype == torch.bfloat16:
            emu = flash_attention_reference(q, k, v, mask, p_dtype=torch.bfloat16).float()
            emu_err = (out.float() - emu).abs().max().item()
            ok = torch.isclose(out.float(), emu, **BF16_EMULATION_TOL).all().item()
            check(ok, f"{tag}: kernel vs P-rounding emulation {emu_err} outside {BF16_EMULATION_TOL}")
            emu_note = (
                f" max_abs_err_vs_p_rounding={emu_err:.3e} "
                f"(rtol {BF16_EMULATION_TOL['rtol']}, atol {BF16_EMULATION_TOL['atol']})"
            )
            del emu
        mean_abs_out = out.float().abs().mean().item()

        ms = time_ms(lambda: flash_attention(q, k, v, mask), 20)
        plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, mask), 5)
        # the yardstick has no fully masked row (SDPA gives NaN or the
        # mean of V there); same shapes and mask otherwise
        lq, lk, lv, lmask = _attention_inputs(B, H, L, Dh, dtype, seed, False)
        lmask4 = lmask[:, None, None, :].to(dtype)
        library = lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask4)  # noqa: E731
        library_ms = time_ms(library, 20)
        kernel_dev_ms = device_ms(lambda: flash_attention(q, k, v, mask), 20, FLASH_KERNEL_NAMES)
        library_dev_ms = device_ms(library, 20)
        bound_ms, bound_by = flash_attention_bound_ms(B, H, L, Dh, dtype, masked=True)
        route = "3xTF32 at 494.7 TFLOP/s" if dtype == torch.float32 else "bf16 at 989 TFLOP/s"
        print(
            f"kernel flash_attention {tag}: ms={ms:.4f} bound_us={bound_ms * 1e3:.1f} "
            f"({bound_by}; {route}) share_of_bound={bound_ms / ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"device_ms={_fmt(kernel_dev_ms)} library_device_ms={_fmt(library_dev_ms)} "
            f"max_abs_err={err:.3e} atol={ATOL[dtype]}{emu_note} mean_abs_out={mean_abs_out:.4f}"
        )
        for t_ms in (ms, kernel_dev_ms):
            if t_ms is not None:
                check(
                    bound_ms / t_ms <= MAX_SHARE_OF_BOUND,
                    f"{tag}: share of bound {bound_ms / t_ms:.4f} > {MAX_SHARE_OF_BOUND}: "
                    "the time or the bound is wrong",
                )
        if (label, L) == ("bert-base", 512):
            records[dtype] = {
                "name": RECORD_NAMES[dtype],
                "route": "cuda",
                "source": "sparkdl_tpu_torch/csrc/flash_attention.cu",
                "replaces": "sparkdl_tpu/ops/flash_attention.py:160",
                "launches": None,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library_ms,
            }
        del q, k, v, mask, out, ref, lq, lk, lv, lmask, lmask4, library
    torch.cuda.empty_cache()
    return records


def _texts(seed: int, n: int):
    rng = np.random.default_rng(seed)
    counts = rng.integers(8, 501, size=n)
    words = rng.integers(0, 200_000, size=int(counts.sum()))
    texts, start = [], 0
    for c in counts:
        texts.append(" ".join(f"w{w}" for w in words[start : start + c]))
        start += c
    return texts


def _embed(mf, df):
    """One TextEmbedder pass; returns (embeddings, seconds, batches,
    real tokens)."""
    metrics.reset()
    emb = TextEmbedder(
        inputCol="text", outputCol="emb", modelFunction=mf,
        maxLength=512, batchSize=32,
    )
    t0 = time.perf_counter()
    rows = emb.transform(df).collect()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return (
        [r.emb for r in rows],
        dt,
        int(metrics.counter("transform.batches")),
        int(metrics.counter("text.tokens")),
    )


def phase_main_path(seed: int, n_texts: int, device_name: str) -> dict:
    """Returns the flash kernel's launches in each dtype's main-path run."""
    os.environ["SPARKDL_TEXT_BUCKETING"] = "1"
    texts = _texts(seed, n_texts)
    df = DataFrame.fromColumns({"text": texts}, numPartitions=4)
    warm = DataFrame.fromColumns({"text": texts[:64]}, numPartitions=1)
    spec = get_model("bert-base")
    launches_by_dtype = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        flash_mf = spec.model_function(dtype=dtype, seed=seed)
        _embed(flash_mf, warm)  # cuBLAS/allocator warm-up, not counted
        flash_attention.launches = 0
        flash, dt, batches, tokens = _embed(flash_mf, df)
        launches = flash_attention.launches
        check(batches > 0, f"{tag}: no batch dispatched")
        check(
            launches == BERT_BASE_LAYERS * batches,
            f"{tag}: flash kernel launched {launches} times for {batches} "
            f"batches (expected {BERT_BASE_LAYERS} per batch)",
        )
        for i, e in enumerate(flash):
            check(e is not None and e.shape == (768,), f"{tag}: row {i} has no 768-d vector")
            check(bool(np.isfinite(e).all()), f"{tag}: row {i} is not finite")
        del flash_mf
        dense_mf = _bert_text_builder("base", attention="dense")(
            spec, mode="embed", dtype=dtype, seed=seed, params=None,
            device=torch.device("cuda"),
        )
        dense, dense_dt, _, _ = _embed(dense_mf, df)
        del dense_mf
        torch.cuda.empty_cache()
        err = max(float(np.abs(a - b).max()) for a, b in zip(flash, dense))
        atol = 1e-3 if dtype == torch.float32 else 3e-2
        check(err <= atol, f"{tag}: flash vs dense embeddings differ by {err} > {atol}")
        print(
            f"main path bert-base {tag} on {device_name}: {len(texts)} rows, "
            f"{batches} batches, {launches} flash launches, {tokens} real tokens; "
            f"flash {dt:.3f} s = {len(texts) / dt:.1f} rows/s, {tokens / dt:.0f} tokens/s; "
            f"dense {dense_dt:.3f} s = {len(texts) / dense_dt:.1f} rows/s; "
            f"max |flash - dense| {err:.3e} (atol {atol})"
        )
        launches_by_dtype[dtype] = launches
    return launches_by_dtype


def phase_breakdown(seed: int, n_texts: int) -> None:
    """Where the main path's time goes: host tokenization alone (host
    clock), and device time by kernel from torch.profiler over one more
    pass per dtype (the profiler's overhead is in that pass's wall time)."""
    from torch.profiler import ProfilerActivity, profile

    texts = _texts(seed, n_texts)
    spec = get_model("bert-base")
    tok = HashingTokenizer(vocab_size=spec.vocab_size)
    t0 = time.perf_counter()
    for t in texts:
        tok(t)
    print(f"breakdown: host tokenization alone {time.perf_counter() - t0:.3f} s")
    df = DataFrame.fromColumns({"text": texts}, numPartitions=4)
    warm = DataFrame.fromColumns({"text": texts[:64]}, numPartitions=1)
    for dtype in (torch.float32, torch.bfloat16):
        mf = spec.model_function(dtype=dtype, seed=seed)
        _embed(mf, warm)
        flash_attention.launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall, _, _ = _embed(mf, df)
        del mf
        kernels = device_kernels(prof)
        by_kernel = {key: sec for key, (sec, _) in kernels.items()}
        busy = sum(by_kernel.values())
        flash = [kernels[k] for k in kernels if any(n in k for n in FLASH_KERNEL_NAMES)]
        # fewer launches recorded than made: the profiler dropped events
        print(
            f"breakdown bert-base {str(dtype)[6:]} (profiled pass): wall {wall:.3f} s, "
            f"device busy {busy:.3f} s (share {busy / wall:.3f}), "
            f"flash kernel {sum(s for s, _ in flash):.3f} s "
            f"({sum(n for _, n in flash)} of {flash_attention.launches} launches recorded)"
        )
        for name, sec in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]:
            print(f"  device {sec:.4f} s  {name[:90]}")


def _relative_error(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def _row_relative_error(a: np.ndarray, b: np.ndarray) -> float:
    """The largest over rows of each row's max |a - b| over its max |b|."""
    return float((np.abs(a - b).max(axis=1) / np.abs(b).max(axis=1)).max())


def _sample_rows(n_rows: int) -> list:
    """Row indices held against the CPU: SAMPLE_PER_PARTITION rows of each
    partition, from its first row to its last, spread over its batches."""
    rows = []
    for start, end in partition_row_spans(n_rows, IMAGE_PARTITIONS):
        rows += np.linspace(start, end - 1, SAMPLE_PER_PARTITION).round().astype(int).tolist()
    return rows


def _colour_structs(seed: int, n: int, size: int):
    """``n`` ``size``x``size`` BGR image structs, alternating between two
    colour classes with uniform noise of +-NOISE per pixel; and their
    labels. Built at the model's size, so the host does not resize."""
    rng = np.random.default_rng(seed)
    structs, labels = [], []
    for i in range(n):
        label = i % 2
        noise = rng.integers(-NOISE, NOISE + 1, size=(size, size, 3), dtype=np.int16)
        arr = np.clip(np.asarray(CLASS_BGR[label], np.int16) + noise, 0, 255)
        structs.append(imageIO.imageArrayToStruct(arr.astype(np.uint8), origin=f"synthetic/{i}"))
        labels.append(label)
    return structs, labels


def _write_seeded_weights(model: str, seed: int, path: str) -> None:
    """``model``'s weights drawn from ``seed`` (flax's distributions, on a
    CPU generator), saved as the flax ``.npz`` that ``weightsFile`` takes."""
    module = get_image_model(model).model_function(mode="logits", seed=seed, device="cpu").module
    save_flax_npz(cnn_params_to_flax(module), path)


def _featurizer(model: str, dtype_name: str, weights: str, device=None) -> DeepImageFeaturizer:
    return DeepImageFeaturizer(
        inputCol="image", outputCol="features", modelName=model,
        weightsFile=weights, computeDtype=dtype_name, batchSize=IMAGE_BATCH, device=device,
    )


def _featurize(feat, df, col: str = "features"):
    """One pass; returns (output rows, seconds). The stage keeps its model
    between passes, so after a warm-up pass this times the transform
    alone, not the model's build."""
    t0 = time.perf_counter()
    rows = feat.transform(df).collect()
    torch.cuda.synchronize()
    return [r[col] for r in rows], time.perf_counter() - t0


def _profiled_pass(feat, df):
    """One more pass under torch.profiler (its overhead is in the wall
    time): (wall seconds, device busy seconds, {kernel: device seconds})."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _featurize(feat, df)
    by_kernel = {key: sec for key, (sec, _) in device_kernels(prof).items()}
    busy = sum(by_kernel.values())
    check(busy > 0, "the profiler saw no device time")
    return wall, busy, by_kernel


def _macs(feat) -> int:
    """MACs per image of the featurizer's model, convs and dense layers."""
    mf = feat._inner().getModelFunction()
    return model_macs(mf.module, (3,) + tuple(mf.input_shape[:2]), features_only=True)


def _rate(macs: int, n_images: int, busy: float, peak: str) -> str:
    rate = 2 * macs * n_images / busy
    return (
        f"{rate / 1e12:.2f} TFLOP/s over device busy = {rate / PEAK_FLOP_PER_S[peak]:.3f} "
        f"of the {peak} peak ({PEAK_FLOP_PER_S[peak] / 1e12:.0f} TFLOP/s)"
    )


def phase_transfer_learning(model: str, seed: int, structs, labels, device_name: str,
                            weights: str) -> None:
    """DeepImageFeaturizer(model) -> LogisticRegression on the card."""
    spec = get_image_model(model)
    n_images = len(structs)
    df = DataFrame.fromColumns({"image": structs}, numPartitions=IMAGE_PARTITIONS)
    warm = DataFrame.fromColumns({"image": structs[:64]}, numPartitions=1)
    expected_batches = sum(
        -(-(end - start) // IMAGE_BATCH) for start, end in partition_row_spans(n_images, IMAGE_PARTITIONS)
    )
    tf32_default = torch.backends.cudnn.allow_tf32
    features, f32_feat = {}, None
    for dtype_name in ("bfloat16", "float32"):
        feat = _featurizer(model, dtype_name, weights)
        _featurize(feat, warm)  # model build, cuDNN and allocator warm-up: not counted
        metrics.reset()
        rows, dt = _featurize(feat, df)
        batches = int(metrics.counter("transform.batches"))
        check(batches == expected_batches, f"{model} {dtype_name}: {batches} batches dispatched, not {expected_batches}")
        for i, f in enumerate(rows):
            check(f is not None and f.shape == (spec.feature_dim,),
                  f"{model} {dtype_name}: row {i} has no {spec.feature_dim}-d vector")
            check(bool(np.isfinite(f).all()), f"{model} {dtype_name}: row {i} is not finite")
        features[dtype_name] = np.stack(rows)
        timers = metrics.snapshot()["timers"]
        print(
            f"image path {model} {spec.height}x{spec.width} {dtype_name} on {device_name}: {n_images} images, "
            f"{batches} batches, {dt:.3f} s = {n_images / dt:.1f} images/s; host batch stage "
            f"{timers['transform.host_batch']['total_s']:.3f} s (producer thread), waits for "
            f"the device {timers['transform.device_wait']['total_s']:.3f} s"
        )
        if dtype_name == "float32":
            f32_feat = feat
    check(
        torch.backends.cudnn.allow_tf32 == tf32_default,
        f"the f32 {model} featurizer did not put cudnn.allow_tf32 back",
    )
    # the card's f32 against the port on the CPU, same weights and images:
    # rows from every partition and from batches across each, and the same
    # rows again on the card as a batch of 32 and a zero-padded tail batch
    sample = _sample_rows(n_images)
    few = DataFrame.fromColumns({"image": [structs[i] for i in sample]}, numPartitions=1)
    cpu_rows, cpu_dt = _featurize(_featurizer(model, "float32", weights, device="cpu"), few)
    cpu = np.stack(cpu_rows)
    card_tail = np.stack(_featurize(f32_feat, few)[0])
    err = _relative_error(features["float32"][sample], cpu)
    tail_err = _relative_error(card_tail, cpu)
    bf16_err = _row_relative_error(features["bfloat16"], features["float32"])
    print(
        f"image path {model} checks: card f32 vs CPU f32 ({len(sample)} rows of {IMAGE_PARTITIONS} partitions, "
        f"CPU {cpu_dt:.2f} s) relative error {err:.3e}, the same rows as one batch and a tail "
        f"batch on the card {tail_err:.3e} (limit {IMAGE_F32_REL}, cudnn.allow_tf32={tf32_default} "
        f"outside the model); card bf16 vs card f32, worst row relative to its own scale "
        f"{bf16_err:.3e} (limit {BF16_ROW_REL[model]}), over all rows relative to the max "
        f"{_relative_error(features['bfloat16'], features['float32']):.3e}; "
        f"max |f32 feature| {np.abs(features['float32']).max():.3f}, least row max "
        f"{np.abs(features['float32']).max(axis=1).min():.3f}"
    )
    check(err <= IMAGE_F32_REL, f"{model} card f32 vs CPU features: relative error {err:.3e} > {IMAGE_F32_REL}")
    check(tail_err <= IMAGE_F32_REL, f"{model} card tail batch vs CPU: relative error {tail_err:.3e} > {IMAGE_F32_REL}")
    check(bf16_err <= BF16_ROW_REL[model],
          f"{model} bf16 vs f32 features: row relative error {bf16_err:.3e} > {BF16_ROW_REL[model]}")
    # the head: LogisticRegression on the default (bf16) features
    feats = DataFrame.fromColumns(
        {"features": list(features["bfloat16"]), "label": labels}, numPartitions=4
    )
    train, test = feats.randomSplit([0.75, 0.25], seed=seed)
    fits = []
    for device in (None, "cpu"):
        t0 = time.perf_counter()
        head = LogisticRegression(regParam=LR_REG[model], device=device)
        fits.append((head.fit(train), time.perf_counter() - t0))
    (card, card_s), (cpu_fit, cpu_s) = fits
    w_err = float((card.w.cpu() - cpu_fit.w).abs().max())
    b_err = float((card.b.cpu() - cpu_fit.b).abs().max())
    check(
        w_err <= LR_ATOL and b_err <= LR_ATOL,
        f"{model} LogisticRegression card vs CPU fit: max |w| gap {w_err:.3e}, |b| gap {b_err:.3e} > {LR_ATOL}",
    )
    scored = card.transform(test).collect()
    acc = float(np.mean([r.prediction == r.label for r in scored]))
    check(acc >= 0.5, f"{model} test accuracy {acc} below chance")
    print(
        f"image path {model} LogisticRegression (bf16 features, regParam {LR_REG[model]}): card fit "
        f"{card_s:.2f} s, CPU fit {cpu_s:.2f} s, max |w| gap {w_err:.3e}, "
        f"|b| gap {b_err:.3e} (atol {LR_ATOL}); test accuracy: {acc:.3f} on {len(scored)} rows"
    )


def phase_image_breakdown(model: str, structs, weights: str) -> None:
    """Where the image path's time goes: one more featurizer pass per
    dtype under torch.profiler."""
    spec = get_image_model(model)
    df = DataFrame.fromColumns({"image": structs}, numPartitions=IMAGE_PARTITIONS)
    warm = DataFrame.fromColumns({"image": structs[:64]}, numPartitions=1)
    for dtype_name, peak in (("bfloat16", "bf16"), ("float32", "f32")):
        feat = _featurizer(model, dtype_name, weights)
        _featurize(feat, warm)
        if dtype_name == "bfloat16":
            macs = _macs(feat)
            print(
                f"{model} {spec.height}x{spec.width} features: {macs} MAC per image in its convs and "
                f"head (bench_bounds.model_macs), {2 * macs * len(structs) / 1e12:.4f} TFLOP per pass"
            )
        wall, busy, by_kernel = _profiled_pass(feat, df)
        print(
            f"breakdown {model} {dtype_name} (profiled pass, {len(structs)} images): wall {wall:.3f} s, "
            f"device busy {busy:.3f} s (share {busy / wall:.3f}), {len(by_kernel)} kernel names; "
            f"conv and head work {_rate(macs, len(structs), busy, peak)}"
        )
        for name, sec in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]:
            print(f"  device {sec:.4f} s  {name[:90]}")


def phase_family(model: str, seed: int, device_name: str, tmp: str) -> None:
    """A features pass of ``model`` at its full geometry in both dtypes:
    images/s, device busy and the FLOP rate over it, and the card's f32
    against the CPU's and bf16 against f32."""
    spec = get_image_model(model)
    weights = os.path.join(tmp, f"{model}.npz")
    _write_seeded_weights(model, seed, weights)
    structs, _ = _colour_structs(seed, FAMILY_IMAGES, spec.height)
    df = DataFrame.fromColumns({"image": structs}, numPartitions=IMAGE_PARTITIONS)
    warm = DataFrame.fromColumns({"image": structs[:IMAGE_BATCH]}, numPartitions=1)
    features, macs = {}, None
    for dtype_name, peak in (("bfloat16", "bf16"), ("float32", "f32")):
        feat = _featurizer(model, dtype_name, weights)
        _featurize(feat, warm)
        macs = macs or _macs(feat)
        rows, dt = _featurize(feat, df)
        for i, f in enumerate(rows):
            check(f is not None and f.shape == (spec.feature_dim,) and bool(np.isfinite(f).all()),
                  f"{model} {dtype_name}: row {i} is not a finite {spec.feature_dim}-d vector")
        features[dtype_name] = np.stack(rows)
        wall, busy, by_kernel = _profiled_pass(feat, df)
        top = max(by_kernel.items(), key=lambda kv: kv[1])
        print(
            f"family {model} {spec.height}x{spec.width} {dtype_name} on {device_name}: {FAMILY_IMAGES} images "
            f"in {dt:.3f} s = {FAMILY_IMAGES / dt:.1f} images/s; {macs} MAC per image; profiled pass wall "
            f"{wall:.3f} s, device busy {busy:.3f} s (share {busy / wall:.3f}), {_rate(macs, FAMILY_IMAGES, busy, peak)}; "
            f"top kernel {top[1]:.4f} s {top[0][:60]}"
        )
        del feat
        torch.cuda.empty_cache()
    sample = np.linspace(0, FAMILY_IMAGES - 1, FAMILY_CPU_ROWS).round().astype(int).tolist()
    few = DataFrame.fromColumns({"image": [structs[i] for i in sample]}, numPartitions=1)
    cpu = np.stack(_featurize(_featurizer(model, "float32", weights, device="cpu"), few)[0])
    err = _relative_error(features["float32"][sample], cpu)
    bf16_err = _row_relative_error(features["bfloat16"], features["float32"])
    print(
        f"family {model} checks: card f32 vs CPU f32 over {len(sample)} rows relative error {err:.3e} "
        f"(limit {IMAGE_F32_REL}); card bf16 vs card f32 worst row {bf16_err:.3e} (limit {BF16_ROW_REL[model]})"
    )
    check(err <= IMAGE_F32_REL, f"{model} card f32 vs CPU features: relative error {err:.3e} > {IMAGE_F32_REL}")
    check(bf16_err <= BF16_ROW_REL[model],
          f"{model} bf16 vs f32 features: row relative error {bf16_err:.3e} > {BF16_ROW_REL[model]}")
    os.remove(weights)


def phase_predictor(model: str, seed: int, tmp: str) -> None:
    """DeepImagePredictor(decodePredictions=True, topK=5) with a labels
    file this script writes: the card's f32 probabilities against the
    CPU's, and each decoded row the top 5 of the card's own probabilities
    under the file's labels."""
    spec = get_image_model(model)
    weights = os.path.join(tmp, f"{model}-predictor.npz")
    _write_seeded_weights(model, seed, weights)
    labels_file = os.path.join(tmp, "labels.json")
    labels = [f"synthetic class {i}" for i in range(spec.num_classes)]
    with open(labels_file, "w") as f:
        json.dump(labels, f)
    structs, _ = _colour_structs(seed + 1, PREDICTOR_IMAGES, spec.height)
    structs[3] = None  # a null row stays null
    df = DataFrame.fromColumns({"image": structs}, numPartitions=2)

    def predictor(device=None, **kwargs):
        return DeepImagePredictor(
            inputCol="image", outputCol="pred", modelName=model, weightsFile=weights,
            computeDtype="float32", batchSize=IMAGE_BATCH, labelsFile=labels_file,
            device=device, **kwargs,
        )

    card = predictor()
    probs, _ = _featurize(card, df, "pred")
    decoded, dt = _featurize(card.copy({card.decodePredictions: True}), df, "pred")
    cpu_probs, _ = _featurize(predictor(device="cpu"), df, "pred")
    check([p is None for p in probs] == [s is None for s in structs], f"{model} predictor: null rows moved")
    check([d is None for d in decoded] == [s is None for s in structs], f"{model} decoded: null rows moved")
    got = np.stack([p for p in probs if p is not None])
    want = np.stack([p for p in cpu_probs if p is not None])
    err = _relative_error(got, want)
    check(err <= IMAGE_F32_REL, f"{model} predictor card vs CPU probabilities: relative error {err:.3e} > {IMAGE_F32_REL}")
    for i, (p, row) in enumerate(zip(probs, decoded)):
        if p is None:
            continue
        check(len(row) == 5, f"{model} decoded row {i} holds {len(row)} classes, not 5")
        top = np.sort(p)[::-1][:5]
        scores = np.array([d["score"] for d in row])
        # a near-tie may order two classes either way: compare scores
        check(bool(np.allclose(scores, top, rtol=0, atol=1e-7)), f"{model} decoded row {i} is not its top 5")
        for d in row:
            check(abs(p[d["classIdx"]] - d["score"]) <= 1e-7 and d["label"] == labels[d["classIdx"]],
                  f"{model} decoded row {i}: {d} does not match its probabilities and labels")
    print(
        f"predictor {model} f32 decodePredictions topK=5: {len(structs)} rows (1 null) in {dt:.3f} s; "
        f"card vs CPU probabilities relative error {err:.3e} (limit {IMAGE_F32_REL}); "
        f"row 0: {[(d['classIdx'], d['label'], round(d['score'], 6)) for d in decoded[0]]}"
    )
    os.remove(weights)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--texts", type=int, default=512)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    def done(phases: str) -> None:
        print(f"[{time.perf_counter() - t_start:.1f} s] {phases} done")

    device_name = phase_device()
    phase_build()
    records = phase_kernels(args.seed)
    done("phases 1-3")
    for dtype, launches in phase_main_path(args.seed, args.texts, device_name).items():
        records[dtype]["launches"] = launches
    phase_breakdown(args.seed, args.texts)
    done("phases 4-5")
    with tempfile.TemporaryDirectory() as tmp:
        for model in ("ResNet50", "InceptionV3"):  # phases 6-7, then 8-9
            size = get_image_model(model).height
            t0 = time.perf_counter()
            structs, labels = _colour_structs(args.seed, N_IMAGES[model], size)
            print(f"image path {model}: {len(structs)} synthetic {size}x{size} structs in "
                  f"{time.perf_counter() - t0:.2f} s (host)")
            weights = os.path.join(tmp, f"{model}.npz")
            _write_seeded_weights(model, args.seed, weights)
            phase_transfer_learning(model, args.seed, structs, labels, device_name, weights)
            phase_image_breakdown(model, structs, weights)
            del structs
            os.remove(weights)
            done(f"{model}'s phases")
        for model in FAMILIES:  # phase 10
            phase_family(model, args.seed, device_name, tmp)
            done(f"phase 10 {model}")
        phase_predictor(PREDICTOR_MODEL, args.seed, tmp)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [records[torch.float32], records[torch.bfloat16]]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": device_name,
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
