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
   bf16 atol 3e-2. Prints rows/s and real tokens/s. The 4 partitions run
   at once and each bucket's rows share a feeder; one more pass with
   ``SPARKDL_SHARED_FEEDER=0`` is timed beside it, its embeddings within
   ``ATOL`` of the shared pass's.
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
   split; for ResNet50 then ``CrossValidator`` (``LogisticRegression`` on
   the card, ``regParam`` in {0, 0.01}, 3 folds, parallelism 2) over the
   f32 features, whose ``avgMetrics`` must equal the same CrossValidator
   on the CPU (atol 1e-4) with the same best ParamMap; its seconds are
   printed. Prints images/s per dtype. The DataFrame runs its 4 partitions at
   once (``runtime/executor.py``) and their rows share one feeder
   (``run_batched_shared``; every forward issued by the device's launch
   thread); each dtype's pass is timed against one more with
   ``SPARKDL_SHARED_FEEDER=0`` (each partition its own pipeline), whose
   rows must equal the shared pass's (f32 relative 1e-5, bf16 row by row
   within ``BF16_ROW_REL``). The path runs no hand-written kernel: the
   convolutions are cuDNN's.
7. image breakdown, ResNet50: MACs per image (convs and head), then one
   more featurizer pass per dtype and per feeder arm under torch.profiler:
   wall time, device busy and its share, the conv and head FLOP rate over
   device busy as a share of the dtype's peak, and the top 5 device
   kernels of the shared arm.
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
11. serving: ``Router()`` (the registry loader on cuda, random weights
    from ``--seed``) behind ``ServingServer(router, port=0)``, with the
    ``serve`` CLI's feeder settings (``SPARKDL_FEEDER_IDLE_S=0``,
    ``SPARKDL_MAX_FEEDERS=32``) and
    ``SPARKDL_SERVE_PRECISION_BATCH=bf16``: the interactive class serves
    bert-base at f32, the batch class at bf16, so both flash kernels
    launch from this path. After one warm-up request per model and rung:
    64 bert-base ``embed`` requests over HTTP (1-4 rows of token ids,
    widths 8-512 from the seed, half interactive, half batch) from 8
    client threads, and 32 ResNet50 requests (1-2 NHWC 224x224 rows, f32)
    of which 4 go over HTTP and the rest through ``ServingClient``; each
    burst twice, cold (streams met for the first time) and warm, the warm
    text burst under torch.profiler. Checks every reply row against the
    registry's ModelFunction called directly on the card (bert-base f32
    atol 1e-4, the bf16 rung atol 3e-2, ResNet50 relative 1e-5), and
    every bert-base row against the dense-attention build, the flash
    kernel's plain version, at phase 4's limits (f32 1e-3, bf16 3e-2); the
    flash launches, counted by the wrapper and recorded by the profiler,
    equal 12 x bert-base dispatches in each dtype; an unknown model and a
    513-token request get 400; ``POST /admin/drain`` turns admission into
    503 while the queued requests complete. Then a second router under
    ``SPARKDL_SERVE_HBM_BUDGET_MB=500`` (bert-base or ResNet50 fits, not
    both), f32: alternating models evict, ``memory_allocated`` moves by
    the parameters swapped, and a reloaded model answers correctly. The
    bf16 rung's direct model is the rung's own build
    (``graph/precision.bf16_rung``: every parameter and buffer in bf16).
    Prints requests/s and rows/s per model, p50/p95 latency per class,
    rows per dispatch, the feeder's staging and readback counts, the
    feeders opened and closed by the cap, the router's and feeder's host
    segments, the device busy share of the profiled burst, what the
    closed router left allocated, and a launch probe (the same forwards
    from one thread, as the device's launch thread issues them, and from
    4 at once).
12. training, BASELINE config[4] (HorovodEstimator's ResNet50
    fine-tune): ``DataParallelEstimator`` over ``ResNet50(num_classes=10)``
    at 224x224 (random weights from ``--seed``) in an NCCL process group
    of world size 1, over 256 synthetic 224x224 image structs in phase 6's
    two colour classes, 4 partitions, uint8 image feed (``targetHeight`` /
    ``targetWidth`` 224), global batch 32, Adam at stepSize 0.01, 2
    epochs: f32 (BASELINE's configuration), then the module built in bf16,
    then one more f32 epoch streamed (``streaming=True``, a 64-row shuffle
    buffer). Prints epoch 2's ``mean_step_time_s`` (the BASELINE metric)
    and images/s per arm, the streamed arm's ``train.data_wait``; one more
    1-epoch fit per dtype under torch.profiler, from the trained weights
    (the process is warm, so it runs as epoch 2 does): device busy, its
    share of that epoch and, per step, of the unprofiled epoch 2 step (the
    profiler slows the host), the top 5 device kernels, the training FLOP rate
    (6 x the forward's MACs per image, logits mode) over busy as a share of
    the dtype's peak, the NCCL kernels recorded, and the step's
    all-reduce (every gradient and the loss, 90 MiB) timed alone by CUDA
    events. Checks: every
    loss finite; two SGD steps (lr 1e-4, 8 rows each) in f32 on the card
    equal the same two steps of the port on the CPU from the same weights
    and rows, each parameter tensor within 1e-4 of its own max |value|
    (the backward convolutions must run without TF32); the BatchNorm
    statistics moved; ``DataParallelModel.transform`` over 64 rows in 4
    partitions (executor and shared feeder) equals the trained module
    called directly (relative 1e-5); a ``modelDir`` run stopped after one
    epoch resumes at step 8 and saves step 16.
13. SQL scoring, BASELINE config[2] ("registerKerasImageUDF MobileNetV2
    Spark-SQL scoring"): ``registerKerasImageUDF("mnv2", "MobileNetV2",
    batch_size=128)`` (the registry's seeded random weights, f32, on the
    card) over a temp view of 2048 synthetic 224x224 BGR structs and one
    null image in 4 partitions, with a ``label`` column of 'a'/'b' drawn
    from ``--seed``. Each after a warm-up on a 128-row view: ``apply_udf``
    directly; ``SELECT mnv2(image) AS probs FROM images`` through
    ``SparkSession.sql``; the same with ``WHERE label = 'a'``; the plain
    query under ``SPARKDL_SQL_VECTORIZE=0`` (the row-path planner) and
    under ``SPARKDL_SHARED_FEEDER=0``. Checks: every non-null row a
    finite 1000-vector summing to 1 within 1e-5 and the null image null;
    40 rows (10 per partition) equal to the port on the CPU with the same
    weights (relative 1e-5); every arm's rows equal to the plain query's
    (relative 1e-5); under WHERE the model scored exactly the non-null
    'a' rows (``sql.udf.batch_rows``) and the pushdown skipped exactly the
    'b' rows (``sql.pushdown.skipped_rows``); the shared feeder's
    ``sql.udf.batches`` at most the per-partition arm's; no flash kernel
    launched. Prints images/s per arm, the SQL arm's overhead over
    ``apply_udf`` (two passes each, in the order apply, sql, sql, apply),
    the counters, and one profiled pass of the plain query (device busy,
    its share, the top 5 kernels).
14. Keras file scoring, BASELINE config[1] ("KerasImageFileTransformer
    ResNet50 batch inference", as bench.py's keras_image mode builds it):
    ``KerasImageFileTransformer(model=..., batchSize=64,
    preprocessing="caffe")`` over Keras ResNet50 at 224x224 with its
    1000-way softmax, the model a ``KerasModelSpec`` of the committed
    ``keras.applications.ResNet50(weights=None, input_shape=(224, 224,
    3))`` config (``tests/fixtures/``) and weights drawn from ``--seed``
    (He-scaled convs, BatchNorm gamma 0.2-0.4, positive variance), over
    1024 random-pixel JPEGs (quality 90), 8 PNGs at 224x224, 8 at 250x300,
    a corrupt file, a missing path and None, in a seeded order over 4
    partitions. Prints the C++ image bridge's status (it must build where
    the libjpeg and libpng headers exist). Each after a one-batch warm-up,
    timed in images/s: (a) the fused path; (b) the same with
    ``SPARKDL_TPU_NO_NATIVE=1``; (c) an ``imageLoader`` that does the
    fused host stage in numpy/PIL with caffe normalization; (d)
    ``SPARKDL_SHARED_FEEDER=0``; (e) ``KerasTransformer`` over (a)'s
    column with a 1000 -> 64 relu -> 10 Dense head given as a config dict.
    Checks: every non-null row a finite 1000-vector summing to 1 within
    1e-5 and the null rows null in every arm; 40 rows (every PNG row and 6
    JPEG rows of each partition) equal to the port on the CPU (relative
    1e-5); (a) equal to (d) (relative 1e-6); (b) equal to (c) (atol 1e-5);
    (a) equal to (b) on the 224x224 PNG rows (relative 1e-5; the JPEG and
    resized rows' max difference printed, not gated: libjpeg against PIL
    decode, the C++ against PIL's resize); (e) against its float64
    reference (relative 1e-5); no flash kernel launched. Prints the
    median row-max probability, the host batch stage's ms per batch, the
    count of PIL decodes, and a profiled pass of (a) (device busy, its
    share, the top 5 kernels).

15. the rest of the Keras path, on a machine with neither keras nor h5py:
    (a) the committed fixtures (``tests/fixtures/keras_cnn.keras``,
    ``.h5`` and ``.weights.h5``, a small CNN) read by the port's own HDF5
    reader, each model built on the card and held to the Keras output
    stored beside them (relative 1e-5); (b) a seeded full-width Keras
    ResNet50 (phase 14's ``KerasModelSpec``) mapped by
    ``load_keras_weights("ResNet50", spec)`` into the registry ResNet50
    (a flax ``.npz`` as ``weightsFile``): ``DeepImageFeaturizer``'s f32
    features over 64 structs equal the translated Keras graph's
    ``avg_pool`` output on the card (relative 1e-5); (c) ``ImageFileEstimator``
    fine-tunes that Keras ResNet50 with a 10-way head on the card over 512
    synthetic 224x224 images in 10 colour classes (an ``imageLoader``,
    caffe), Adam and categorical cross-entropy, ``epochs=2,
    batch_size=32, shuffle=False``: prints epoch 2's mean step ms and
    images/s, and a profiled 1-epoch fit's device busy share; the first
    3 steps' weights and moving statistics on the card against the same
    steps on the CPU, each tensor within 1e-4 + 4 x the CPU's own float32
    error of float64 steps on the card (relative to its max |value|);
    (d) ``DeepImageFeaturizer(ResNet50)`` over 512 structs at a 320x320
    source with ``SPARKDL_DEVICE_PREPROC=1`` (the host ships 320x320
    uint8 rows and the bilinear resize runs on the card) and with 0:
    images/s and a profiled pass's busy share per arm, the device arm's
    rows against the same arm on the CPU over 8 rows (relative 1e-5);
    (e) a seeded bert-base flax ``.npz`` loaded through ``weights_file``:
    ``TextEmbedder`` rows over 64 texts equal those of the model built
    from the same params (atol 1e-6) and the flash kernel launched (the
    count is printed and must be > 0).

16. generation (``mode="generate"``) over bert-base (768 wide, 12 layers,
    ``max_length`` 512, random weights from ``--seed``), f32 on the card:
    (a) ``get_model("bert-base").generate_function()`` called directly:
    prompts of 7, 64, 200 and 447 seeded tokens prefilled (sequence
    buckets) into slots 0-3 of an 8-slot cache, then 16 batched decode
    steps. Checks: prefill logits, K and V against the same generator on
    the CPU with the same weights, and each decode step's logits against
    the cacheless recompute (``oracle_logits``: a prefill over the grown
    prefix) on the card, each within relative 1e-4 of the tensor's max
    |value|; the 17 greedy tokens of each slot equal to the oracle's under
    the near-tie rule: a token that differs fails unless the served
    token's oracle logit is within 1e-4 x that step's max |logit| of the
    oracle's top, and then the step, the top-two gap and both tokens are
    printed and the sequence is compared up to that step. (b)
    ``Router()`` behind ``ServingServer`` at ``SPARKDL_GEN_MAX_SEQS=8``:
    after a warm-up request, 32 greedy requests at once (prompts of 8-128
    seeded tokens, ``max_new_tokens`` 32), 4 of them streamed over HTTP
    (chunked ndjson) and 28 through ``router.submit``. Checks: every
    sequence 32 tokens and equal to the oracle on the card under the
    near-tie rule; the streamed tokens equal to each request's result;
    ``gen.joins`` and ``gen.slot_reuse`` > 0; no KV bytes reserved once
    idle, and ``memory_allocated`` back at its value before the flood
    (the stream drops its slab when the last slot empties); no flash
    kernel launched (the path runs dense causal prefill and einsum decode,
    as the JAX package's does). Prints new tokens/s (as ``bench.py``'s
    generate mode counts them: new tokens over the flood's wall), prefill
    and decode-step ms (mean, p95), the peak of ``gen.kv_bytes``, and a
    profiled burst of 8 requests (device busy share, top 5 kernels). (c)
    a prompt of 500 tokens with ``max_new_tokens`` 32 gets 400; under
    ``SPARKDL_SERVE_HBM_BUDGET_MB`` = the generator's parameters + half of
    one 48-token reservation, that request gets 429 and the reserved KV
    bytes return to 0. About 30 s.
17. the serving control plane: after a warm-up router has dispatched
    bert-base and ResNet50 and closed (the baseline of memory_allocated,
    the launch thread's cuBLAS workspace in it), one ``Router`` behind
    ``ServingServer`` on the card, f32, random weights from ``--seed``,
    events to ``SPARKDL_OBS_JSONL`` in a temp dir. (a) 64 bert-base
    requests over HTTP and 32 ResNet50 through the client at once, under
    torch.profiler: the f32 flash kernel launches (> 0, the profiler's
    count equal to the wrapper's); the utilization ledger's busy + idle
    equal to the flood's wall by the script's clock within max(10 ms, 5 %);
    ``serve.mfu`` in (0, 1], printed with ``util.busy_frac`` and the
    profiler's busy share; ``GET /v1/memory``'s per-model bytes equal to
    residency's charges, ground truth from ``memory_allocated``. (b) 8
    generate requests of 32 tokens: the ``kv_cache`` class allocates and
    frees equal bytes and holds 0 once idle; under
    ``SPARKDL_SERVE_HBM_BUDGET_MB=1`` a generate request gets 429 and one
    ``{"kind": "oom"}`` event names the resident models. (c) with
    ``SPARKDL_SLO_AVAIL=0.999``, ``SPARKDL_SLO_P95_MS_INTERACTIVE=0.001``
    and windows of 2 s and 4 s: 32 healthy batch requests trip nothing, 20
    interactive ones trip ``interactive`` (``GET /v1/slo``,
    ``slo.trips.interactive``, an ``slo_alert`` event), and a poll after
    the fast window drains recovers it (``slo_recovery``). (d) a
    registered ``bert-base-canary`` (weights from ``--seed`` + 1) at weight
    0.25 takes 16 +- 1 of 64 requests and, after ``POST /admin/canary
    {"weight": 0.5}``, 16 +- 1 of 32; each arm's rows equal its own model
    called directly (relative 1e-5); on a router of its own, a canary
    whose build raises fails 4 requests, rolls back once
    (``serve.canary.rollbacks``, a ``canary_rollback`` event) and later
    requests are the primary's; a ``bert-base-v30000`` canary (a table of
    30000 ids) gets none of 8 requests holding id 30100 and 4 +- 1 of 8
    without (``serve.canary.ineligible`` +8). (e) token id 30522 in an embed and a
    generate request: 400 each, nothing reserved or loaded, and the next
    request's rows equal its rows before. Then, the router closed:
    tracked bytes 0, memory_allocated back at the baseline within
    ``SPARKDL_MEM_LEAK_TOL_MB``, no ``mem_leak`` event, and no leak record
    in the ledger from any router of the run (phases 11, 16 and 17). ``serve.mfu``
    is checked as published, unclamped. About 25 s.
    Phases 6 and 8 also save the fitted featurizer -> LogisticRegression
    ``PipelineModel`` and load it back on the card: its predictions on the
    40 sampled rows equal the fitted one's.

The line before the last is the ``kernels`` JSON record (the f32 and the
bf16 kernel at bert-base L=512, launches from each dtype's main-path run);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

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
from sparkdl_tpu_torch import udf as udf_catalog
from sparkdl_tpu_torch.estimators import DataParallelEstimator, ImageFileEstimator, LogisticRegression
from sparkdl_tpu_torch.estimators import keras_fit
from sparkdl_tpu_torch.evaluation import MulticlassClassificationEvaluator
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.graph.ingest import ModelIngest
from sparkdl_tpu_torch.graph.keras_file import read_keras_file, read_keras_weights
from sparkdl_tpu_torch.graph.keras_graph import (
    KerasModelSpec,
    KerasModule,
    collect_weights,
    spec_from_module,
    walk_layers,
)
from sparkdl_tpu_torch.graph.pieces import host_resize_uint8, image_structs_to_batch
from sparkdl_tpu_torch.graph.precision import bf16_rung
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.models import get_image_model, get_model
from sparkdl_tpu_torch.models.convert import bert_params_to_flax, cnn_params_to_flax
from sparkdl_tpu_torch.models.keras_weights import load_keras_weights
from sparkdl_tpu_torch.models.layers import init_cnn_params
from sparkdl_tpu_torch.models.registry import NamedTextModel, _bert_text_builder, register_model, save_flax_weights
from sparkdl_tpu_torch.models.resnet import ResNet50
from sparkdl_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from sparkdl_tpu_torch.parallel import (
    Mesh,
    create_train_state,
    distributed,
    make_data_parallel_step,
    make_mesh,
)
from sparkdl_tpu_torch import persistence
from sparkdl_tpu_torch.obs import memory as mem_ledger
from sparkdl_tpu_torch.obs import slo, utilization
from sparkdl_tpu_torch.pipeline import PipelineModel
from sparkdl_tpu_torch.runtime import cuda_build, knobs, native
from sparkdl_tpu_torch.runtime.feeder import shutdown_feeders
from sparkdl_tpu_torch.session import SparkSession
from sparkdl_tpu_torch.transformers.named_image import (
    DeepImageFeaturizer,
    DeepImagePredictor,
)
from sparkdl_tpu_torch.transformers.image_model import ImageModelTransformer
from sparkdl_tpu_torch.transformers.keras_image import KerasImageFileTransformer
from sparkdl_tpu_torch.transformers.tensor import KerasTransformer
from sparkdl_tpu_torch.transformers.text import HashingTokenizer, TextEmbedder
from sparkdl_tpu_torch.tuning import CrossValidator, ParamGridBuilder
from sparkdl_tpu_torch.utils.metrics import metrics

ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
#: bert-base embeddings through the flash kernel against the dense-attention
#: build (the kernel's plain version inside the whole encoder): 12 layers
#: of differently ordered sums in f32, bf16 activations in bf16
DENSE_ATOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}
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
#: phase 6's model selection (ResNet50 only): the grid, folds and threads
#: of CrossValidator over the f32 features, and its card-vs-CPU metric gap
CV_MODEL = "ResNet50"
CV_REG = (0.0, 0.01)
CV_FOLDS = 3
CV_PARALLELISM = 2
CV_ATOL = 1e-4
#: BGR colours of the two synthetic classes, and the noise around them
CLASS_BGR = ((40, 60, 200), (200, 80, 40))
NOISE = 40
#: phase 11, serving: the models, where the router runs (None: its
#: default, cuda), the requests and the client threads that send them,
#: the SLA classes (SPARKDL_SERVE_PRECISION_BATCH=bf16 puts ``batch`` on
#: the bf16 rung) and the eviction phase's budget, which holds bert-base
#: (415.4 MiB of f32 parameters) or ResNet50 (97.7 MiB), not both
SERVE_TEXT_MODEL = "bert-base"
SERVE_IMAGE_MODEL = "ResNet50"
SERVE_DEVICE = None
SERVE_TEXT_REQUESTS = 64
SERVE_IMAGE_REQUESTS = 32
SERVE_IMAGE_HTTP = 4
SERVE_CLIENT_THREADS = 8
SERVE_CLASSES = ("interactive", "batch")
SERVE_BUDGET_MB = 500
#: what memory_allocated may gain at a model swap beyond the parameters:
#: a cuBLAS workspace of a thread that had not run a GEMM yet
SERVE_ALLOC_SLACK_MB = 64
#: the launch probe: forwards, and the threads that share them
SERVE_PROBE_BATCHES = 32
SERVE_PROBE_THREADS = 4
#: each burst runs twice: first on streams it meets for the first time
SERVE_PASSES = ("cold", "warm")
#: the router's and the feeder's host segments, as the metrics name them
SERVE_SEGMENTS = (
    ("queue wait", "serve.queue_wait"),
    ("group wait", "serve.group_wait"),
    ("group dispatch", "span.serve.dispatch"),
    ("H2D issue", "span.h2d"),
    ("stage claim", "span.stage_wait"),
    ("device fn call", "span.dispatch"),
    ("readback wait", "span.drain_wait"),
)


#: phase 12, BASELINE config[4]: images, partitions, global batch, epochs
#: and Adam's step size of the fine-tune; ResNet50's head width and side
TRAIN_IMAGES = 256
TRAIN_PARTITIONS = 4
TRAIN_BATCH = 32
TRAIN_EPOCHS = 2
TRAIN_STEP_SIZE = 0.01
TRAIN_CLASSES = 10
TRAIN_SIDE = 224
#: the streamed arm's shuffle buffer: a quarter of the rows, so the feed
#: streams instead of holding the epoch
TRAIN_SHUFFLE_ROWS = 64
#: the card-vs-CPU check: two SGD steps of 8 rows each, at a rate the
#: unnormalized 0-255 pixels survive (at 1e-2 the second step's loss is
#: 1e29 on the CPU). Both float32 runs are held against the same two
#: steps in float64 on the card, each parameter tensor relative to its own
#: max |value|: the card within TRAIN_SGD_REL plus TRAIN_SGD_NOISE times
#: the CPU's own float32 error. Float32 alone is far from 1e-4 here: the
#: BatchNorm biases and means start at 0, so their scale is their move,
#: and on the CPU float32 against float64 differs by up to 2.2e-3 of it
#: (75 tensors over 1e-4 after one step, 109 after two); TF32 in a
#: convolution (10-bit mantissa) would be about 1e3 times that error.
TRAIN_SGD_ROWS = 8
TRAIN_SGD_LR = 1e-4
TRAIN_SGD_REL = 1e-4
TRAIN_SGD_NOISE = 4.0
#: the all-reduce of one step's gradients and loss, timed alone
TRAIN_ALLREDUCE_ITERS = 20
#: rows scored by the trained model through the executor and the feeder
TRAIN_SCORE_ROWS = 64
#: phase 13, BASELINE config[2]: the UDF and its model, images (and where
#: the null image goes), partitions, the UDF's batch (bench.py's udf modes
#: on a chip), the warm-up view's rows; a probability row sums to 1
SQL_UDF = "mnv2"
SQL_MODEL = "MobileNetV2"
SQL_IMAGES = 2048
SQL_NULL_ROW = 777
SQL_PARTITIONS = 4
SQL_BATCH = 128
SQL_WARM_ROWS = 128
SQL_SUM_ATOL = 1e-5
SQL_QUERY = "SELECT mnv2(image) AS probs FROM {table}"
SQL_FILTER_QUERY = "SELECT label, mnv2(image) AS probs FROM {table} WHERE label = 'a'"

# phase 14: BASELINE config[1] as bench.py's keras_image mode builds it
KERAS_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                            "keras_resnet50_224_config.json")
KERAS_SIDE = 224
KERAS_JPEGS = 1024
KERAS_JPEG_QUALITY = 90
KERAS_PNGS = 8  # at 224x224 (no resize), and as many at KERAS_PNG_RESIZED
KERAS_PNG_RESIZED = (250, 300)  # (height, width)
KERAS_PARTITIONS = 4
KERAS_BATCH = 64
KERAS_CPU_ROWS = 40
KERAS_BN_GAMMA = (0.2, 0.4)  # keeps the seeded softmax off saturation
KERAS_ARM_REL = 1e-6  # the shared feeder's rows against the partitions' own
KERAS_LOADER_ATOL = 1e-5  # the fused path without the bridge against the numpy/PIL loader
KERAS_HEAD = (64, 10)
CAFFE_MEAN_BGR = np.array([103.939, 116.779, 123.68], np.float32)
# the headers the C++ image bridge includes; where both exist, it must build
BRIDGE_HEADERS = ("/usr/include/jpeglib.h", "/usr/include/png.h")

# phase 15: the rest of the Keras path
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures")
FIXTURE_MODEL = "keras_cnn"
REGISTRY_ROWS = 64
FT_IMAGES = 512
FT_CLASSES = 10
FT_BATCH = 32
FT_FIT = {"epochs": 2, "batch_size": FT_BATCH, "shuffle": False}
FT_PARTITIONS = 4
FT_CHECK_STEPS = 3
FT_REL = 1e-4  # plus FT_NOISE x the CPU's own float32 error, as phase 12
FT_NOISE = 4.0
FT_PROFILE_ROWS = 256
PREPROC_IMAGES = 512
PREPROC_SIDE = 320
PREPROC_CPU_ROWS = 8
TEXT_WEIGHT_TEXTS = 64
TEXT_WEIGHT_ATOL = 1e-6
# phase 16: generation over bert-base, f32
GEN_MODEL = "bert-base"
GEN_SLOTS = 8  # SPARKDL_GEN_MAX_SEQS, the default
GEN_PROMPTS = (7, 64, 200, 447)  # (a): one per slot, 447 + 16 + 1 <= 512
GEN_STEPS = 16
GEN_REL = 1e-4  # card vs CPU and decode vs recompute, of the tensor's max |value|
GEN_TIE_REL = 1e-4  # the near-tie rule, of the step's max |logit|
GEN_FLOOD = 32
GEN_FLOOD_HTTP = 4  # of GEN_FLOOD, streamed over HTTP
GEN_FLOOD_LENGTHS = (8, 128)
GEN_FLOOD_NEW = 32
GEN_PROFILED = 8  # requests in the profiled burst
GEN_IDLE_S = 10.0  # how long the check waits for the stream to drop its slab
CP_TEXT_REQUESTS = 64  # phase 17(a)'s flood, bert-base f32 over HTTP
CP_IMAGE_REQUESTS = 32  # and ResNet50 f32 through ServingClient, at once
CP_CONSERVATION_ABS_S = 0.010  # busy + idle against the flood's wall: max(10 ms, 5 %)
CP_CONSERVATION_REL = 0.05
CP_GEN = 8  # 17(b): generate requests of CP_GEN_NEW tokens
CP_GEN_NEW = 32
CP_SLO = {"SPARKDL_SLO_AVAIL": "0.999", "SPARKDL_SLO_P95_MS_INTERACTIVE": "0.001",
          "SPARKDL_SLO_FAST_S": "2", "SPARKDL_SLO_SLOW_S": "4", "SPARKDL_SLO_MIN_REQUESTS": "5"}
CP_SLO_BATCH = 32  # 17(c): a healthy batch-class flood, then interactive requests
CP_SLO_INTERACTIVE = 20
CP_CANARY = "bert-base-canary"  # 17(d): bert-base with weights from --seed + 1
CP_CANARY_BROKEN = "bert-base-broken"  # a canary whose loader raises
CP_CANARY_WEIGHT, CP_CANARY_N = 0.25, 64  # 16 +- 1 to the canary
CP_CANARY_WIDENED, CP_CANARY_N2 = 0.5, 32  # after POST /admin/canary: 16 +- 1
CP_CANARY_MIN = 4  # SPARKDL_SERVE_CANARY_MIN_REQUESTS of the rollback arm
CP_CANARY_REL = 1e-5  # each arm's rows against its own model called directly
CP_CANARY_SMALL = "bert-base-v30000"  # a canary whose vocabulary (and table) is smaller
CP_SMALL_VOCAB, CP_SMALL_N = 30000, 8  # CP_SMALL_N requests with an id past it, CP_SMALL_N without


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
    repeats the time of the kernels it launched, and so does the device
    span of a ``record_function`` range (``Optimizer.step#Adam.step``),
    which is left out."""
    from torch.autograd import DeviceType

    out: dict = {}
    for ev in prof.events():
        if (ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False)
                or ev.self_device_time_total <= 0):
            continue
        sec, n = out.get(ev.key, (0.0, 0))
        out[ev.key] = (sec + ev.self_device_time_total / 1e6, n + 1)
    return out


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


def _dispatches() -> int:
    """Batches dispatched since the last ``metrics.reset()``: by the
    partitions' own pipelines (``run_batched``) and by the shared feeders."""
    return int(metrics.counter("transform.batches") + metrics.counter("feeder.coalesced_batches"))


def _embed(mf, df):
    """One TextEmbedder pass; returns (embeddings, seconds, batches
    dispatched by the partitions' own pipelines or the shared feeders,
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
        _dispatches(),
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
        os.environ["SPARKDL_SHARED_FEEDER"] = "0"
        own, own_dt, own_batches, _ = _embed(flash_mf, df)
        os.environ.pop("SPARKDL_SHARED_FEEDER")
        arm_err = max(float(np.abs(a - b).max()) for a, b in zip(flash, own))
        check(arm_err <= ATOL[dtype], f"{tag}: the feeder arms' embeddings differ by {arm_err} > {ATOL[dtype]}")
        del flash_mf
        dense_mf = _bert_text_builder("base", attention="dense")(
            spec, mode="embed", dtype=dtype, seed=seed, params=None,
            device=torch.device("cuda"),
        )
        dense, dense_dt, _, _ = _embed(dense_mf, df)
        del dense_mf
        torch.cuda.empty_cache()
        err = max(float(np.abs(a - b).max()) for a, b in zip(flash, dense))
        atol = DENSE_ATOL[dtype]
        check(err <= atol, f"{tag}: flash vs dense embeddings differ by {err} > {atol}")
        print(
            f"main path bert-base {tag} on {device_name}: {len(texts)} rows, "
            f"{batches} batches, {launches} flash launches, {tokens} real tokens; "
            f"flash {dt:.3f} s = {len(texts) / dt:.1f} rows/s, {tokens / dt:.0f} tokens/s; "
            f"dense {dense_dt:.3f} s = {len(texts) / dense_dt:.1f} rows/s; "
            f"max |flash - dense| {err:.3e} (atol {atol}); SPARKDL_SHARED_FEEDER=0 (one pipeline "
            f"per partition): {own_batches} batches, {own_dt:.3f} s = {len(texts) / own_dt:.1f} rows/s, "
            f"max |shared - own| {arm_err:.3e} (atol {ATOL[dtype]})"
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
    save_flax_weights(cnn_params_to_flax(module), path)


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


def _profiled(run):
    """``run()`` under torch.profiler (its overhead is in the wall time):
    (wall seconds, device busy seconds, {kernel: device seconds})."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {key: sec for key, (sec, _) in device_kernels(prof).items()}
    busy = sum(by_kernel.values())
    check(busy > 0, "the profiler saw no device time")
    return wall, busy, by_kernel


def _profiled_pass(feat, df):
    """One more featurizer pass under torch.profiler."""
    return _profiled(lambda: _featurize(feat, df))


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
        arms = {}
        for arm in ("shared feeder", "SPARKDL_SHARED_FEEDER=0"):
            os.environ["SPARKDL_SHARED_FEEDER"] = "1" if arm == "shared feeder" else "0"
            metrics.reset()
            rows, dt = _featurize(feat, df)
            batches = _dispatches()
            if arm == "shared feeder":
                # one stream packs the 4 partitions' rows: only a flush
                # after a quiet spell is padded
                fed = int(metrics.counter("feeder.rows"))
                pad = int(metrics.counter("feeder.pad_rows"))
                check(fed == n_images and batches * IMAGE_BATCH == fed + pad
                      and int(metrics.counter("transform.batches")) == 0,
                      f"{model} {dtype_name}: the shared feeder dispatched {batches} batches of "
                      f"{fed} rows and {pad} padding")
                how = f"{batches} coalesced batches, {pad} padded rows"
            else:
                check(batches == expected_batches,
                      f"{model} {dtype_name}: {batches} batches dispatched, not {expected_batches}")
                how = f"{batches} batches"
            for i, f in enumerate(rows):
                check(f is not None and f.shape == (spec.feature_dim,),
                      f"{model} {dtype_name}: row {i} has no {spec.feature_dim}-d vector")
                check(bool(np.isfinite(f).all()), f"{model} {dtype_name}: row {i} is not finite")
            arms[arm] = np.stack(rows)
            timers = metrics.snapshot()["timers"]
            print(
                f"image path {model} {spec.height}x{spec.width} {dtype_name} on {device_name}, {arm}: "
                f"{n_images} images, {how}, {dt:.3f} s = {n_images / dt:.1f} images/s; host batch stage "
                f"{timers['transform.host_batch']['total_s']:.3f} s, waits for "
                f"the device {timers['transform.device_wait']['total_s']:.3f} s"
            )
        os.environ.pop("SPARKDL_SHARED_FEEDER")
        shared, own = arms.values()
        arm_err = (
            _relative_error(shared, own) if dtype_name == "float32" else _row_relative_error(shared, own)
        )
        arm_limit = IMAGE_F32_REL if dtype_name == "float32" else BF16_ROW_REL[model]
        print(f"image path {model} {dtype_name}: shared feeder vs per-partition rows, "
              f"{'relative' if dtype_name == 'float32' else 'worst row relative'} error {arm_err:.3e} "
              f"(limit {arm_limit})")
        check(arm_err <= arm_limit, f"{model} {dtype_name}: the feeder arms' rows differ by {arm_err:.3e}")
        features[dtype_name] = shared
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
    # the fitted featurizer -> head pipeline saved and loaded back (Queue
    # C item 4): the loaded one predicts exactly what the fitted one does
    fitted = PipelineModel([_featurizer(model, "bfloat16", weights), card])
    saved = os.path.join(os.path.dirname(weights), f"{model}-pipeline")
    t0 = time.perf_counter()
    fitted.save(saved)
    loaded = persistence.load(saved)
    io_s = time.perf_counter() - t0
    before = fitted.transform(few).collect()
    after = loaded.transform(few).collect()
    check(type(loaded) is PipelineModel and [s.uid for s in loaded.stages] == [s.uid for s in fitted.stages],
          f"{model} pipeline: loaded {loaded!r} with stages {[s.uid for s in loaded.stages]}")
    check([r.prediction for r in after] == [r.prediction for r in before],
          f"{model} pipeline: the loaded model's predictions differ from the fitted one's")
    feat_gap = max(float(np.abs(a.features - b.features).max()) for a, b in zip(after, before))
    print(f"image path {model} PipelineModel(featurizer bf16, LogisticRegression) saved and loaded back on "
          f"{loaded.stages[1].w.device} in {io_s:.2f} s ({sorted(os.listdir(os.path.join(saved, 'stages')))}): "
          f"{len(after)} predictions equal, features max |diff| {feat_gap:.3e}")
    if model == CV_MODEL:
        _cross_validate(model, features["float32"], labels, seed)


def _cross_validate(model: str, feats: np.ndarray, labels, seed: int) -> None:
    """CrossValidator over LogisticRegression on the card against the
    same on the CPU, over the same features."""
    df = DataFrame.fromColumns({"features": list(feats), "label": labels}, numPartitions=IMAGE_PARTITIONS)
    runs = []
    for device in (None, "cpu"):
        lr = LogisticRegression(device=device)
        cv = CrossValidator(
            estimator=lr, estimatorParamMaps=ParamGridBuilder().addGrid(lr.regParam, CV_REG).build(),
            evaluator=MulticlassClassificationEvaluator(), numFolds=CV_FOLDS,
            parallelism=CV_PARALLELISM, seed=seed,
        )
        t0 = time.perf_counter()
        fitted = cv.fit(df)
        torch.cuda.synchronize()
        runs.append((fitted, time.perf_counter() - t0))
    (card, card_s), (cpu, cpu_s) = runs
    gap = float(np.abs(np.asarray(card.avgMetrics) - np.asarray(cpu.avgMetrics)).max())
    best = (int(np.argmax(card.avgMetrics)), int(np.argmax(cpu.avgMetrics)))
    print(
        f"image path {model} CrossValidator(LogisticRegression, regParam in {list(CV_REG)}, {CV_FOLDS} folds, "
        f"parallelism {CV_PARALLELISM}) over {len(labels)} f32 feature rows: card {card_s:.2f} s, CPU "
        f"{cpu_s:.2f} s; avgMetrics (accuracy) card {card.avgMetrics}, CPU {cpu.avgMetrics}, max gap "
        f"{gap:.3e} (atol {CV_ATOL}); best ParamMap card {best[0]}, CPU {best[1]}"
    )
    check(gap <= CV_ATOL, f"{model} CrossValidator: card avgMetrics off the CPU's by {gap:.3e}")
    check(best[0] == best[1], f"{model} CrossValidator: the card picked ParamMap {best[0]}, the CPU {best[1]}")


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
        for arm, flag in (("SPARKDL_SHARED_FEEDER=0", "0"), ("shared feeder", "1")):
            os.environ["SPARKDL_SHARED_FEEDER"] = flag
            wall, busy, by_kernel = _profiled_pass(feat, df)
            print(
                f"breakdown {model} {dtype_name}, {arm} (profiled pass, {len(structs)} images): wall "
                f"{wall:.3f} s = {len(structs) / wall:.1f} images/s, device busy {busy:.3f} s (share "
                f"{busy / wall:.3f}), {len(by_kernel)} kernel names; conv and head work "
                f"{_rate(macs, len(structs), busy, peak)}"
            )
        os.environ.pop("SPARKDL_SHARED_FEEDER")
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


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _percentiles_ms(seconds) -> str:
    if not len(seconds):
        return "no requests"
    ms = np.asarray(seconds) * 1e3
    return f"p50 {np.percentile(ms, 50):.2f} ms, p95 {np.percentile(ms, 95):.2f} ms (n={len(ms)})"


def _post(base: str, body: dict, timeout: float = 300.0):
    """One ``POST /v1/predict``: (status, headers, reply, seconds)."""
    req = urllib.request.Request(
        base + "/v1/predict", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, headers, raw = resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        status, headers, raw = e.code, e.headers, e.read()
    return status, headers, json.loads(raw), time.perf_counter() - t0


def _text_requests(seed: int, spec, n: int):
    """``n`` embed requests of 1-4 rows; each request's width and each
    row's own length (id 0 after it) drawn from ``seed`` in
    [8, max_length]; classes alternate interactive, batch."""
    rng = np.random.default_rng(seed + 11)
    out = []
    for i in range(n):
        rows, width = int(rng.integers(1, 5)), int(rng.integers(8, spec.max_length + 1))
        ids = rng.integers(4, spec.vocab_size, size=(rows, width)).astype(np.int32)
        for r in range(rows):
            ids[r, int(rng.integers(8, width + 1)):] = 0
        out.append((ids, SERVE_CLASSES[i % 2]))
    return out


def _image_requests(seed: int, spec, n: int):
    """``n`` requests of 1-2 preprocessed NHWC float32 rows (caffe-scale
    values), all on the interactive class (the f32 rung)."""
    rng = np.random.default_rng(seed + 12)
    return [
        rng.normal(0.0, 60.0, size=(int(rng.integers(1, 3)), spec.height, spec.width, 3)).astype(np.float32)
        for _ in range(n)
    ]


def _direct(mf, x: np.ndarray, nhwc: bool) -> np.ndarray:
    """Rows through the registry's ModelFunction called directly."""
    t = torch.from_numpy(x).to(mf.device)
    if nhwc:
        t = t.permute(0, 3, 1, 2)
    out = mf(t)
    return out.float().cpu().numpy()


def _feeder_counts(counters: dict) -> str:
    def n(name):
        return int(counters.get(name, 0))

    return (
        f"staged copies landed before dispatch {n('transfer.stage_hits')}, not yet "
        f"{n('transfer.stage_misses')}; readback landed before the drain {n('feeder.readback_async_hits')}, "
        f"not yet {n('feeder.readback_async_misses')}; feeders opened {n('feeder.opened')}, closed by "
        f"the SPARKDL_MAX_FEEDERS={knobs.get_int('SPARKDL_MAX_FEEDERS')} cap {n('feeder.evicted')}"
    )


def _segments(timers: dict) -> str:
    """Mean host milliseconds of the router's and the feeder's segments."""
    parts = []
    for label, key in SERVE_SEGMENTS:
        t = timers.get(key)
        if t and t["count"]:
            parts.append(f"{label} {t['total_s'] / t['count'] * 1e3:.2f} ms x{t['count']}")
    return ", ".join(parts)


def _flash_kernel_counts(prof) -> dict:
    """Launches of each flash kernel that torch.profiler recorded, by dtype."""
    kernels = device_kernels(prof)
    return {
        dtype: sum(n for key, (_, n) in kernels.items() if name in key)
        for dtype, name in zip((torch.bfloat16, torch.float32), FLASH_KERNEL_NAMES)
    }


def phase_serving(seed: int, device_name: str) -> None:
    """Phase 11: the online serving path on the card."""
    from torch.profiler import ProfilerActivity, profile

    from sparkdl_tpu_torch.serving import Router, ServingClient, ServingServer
    from sparkdl_tpu_torch.serving.__main__ import serving_env_defaults

    card = f"{device_name} ({_smi()})"
    text_spec, image_spec = get_model(SERVE_TEXT_MODEL), get_model(SERVE_IMAGE_MODEL)
    os.environ["SPARKDL_SERVE_PRECISION_BATCH"] = "bf16"
    for name in ("SPARKDL_FEEDER_IDLE_S", "SPARKDL_MAX_FEEDERS", "SPARKDL_SERVE_HBM_BUDGET_MB"):
        os.environ.pop(name, None)
    # the offline phases' feeders (their owner threads idle out after 30 s,
    # but the serving keepalive below would keep them polling): a server
    # process starts without them
    shutdown_feeders()
    serving_env_defaults()  # the serve CLI's feeder keepalive and registry cap
    allocated_before = torch.cuda.memory_allocated()
    router = Router(seed=seed, device=SERVE_DEVICE)
    server = ServingServer(router, port=0)
    client = ServingClient(router)
    base = f"http://127.0.0.1:{server.port}"
    texts = _text_requests(seed, text_spec, SERVE_TEXT_REQUESTS)
    images = _image_requests(seed, image_spec, SERVE_IMAGE_REQUESTS)

    def text_body(ids, cls):
        return {"model": SERVE_TEXT_MODEL, "inputs": ids.tolist(), "dtype": "int32",
                "mode": "embed", "priority": cls}

    # warm-up: each model and rung loads once, outside the timed bursts
    t0 = time.perf_counter()
    for ids, cls in texts[:2]:
        status, _, reply, _ = _post(base, text_body(ids, cls))
        check(status == 200, f"serving warm-up {cls}: HTTP {status} {reply}")
    client.predict(SERVE_IMAGE_MODEL, images[0], priority="interactive", timeout=300)
    print(f"serving: router on {router.device}, models loaded and warm in {time.perf_counter() - t0:.2f} s "
          f"(resident: {[(m['name'], m['precision'], m['param_mb']) for m in router.stats()['models']]})")

    # The text burst over HTTP from SERVE_CLIENT_THREADS threads, twice:
    # the cold pass meets each (rung, batch size, sequence bucket) stream
    # for the first time (its feeder threads, pinned buffers, cuBLAS
    # handles and GEMM shapes), the warm pass runs under torch.profiler.
    text_rows = sum(len(ids) for ids, _ in texts)
    text_passes = {}
    for name in SERVE_PASSES:
        metrics.reset()
        flash_attention.launches = 0
        flash_attention.launches_by_dtype = dict.fromkeys(flash_attention.launches_by_dtype, 0)
        with profile(activities=[ProfilerActivity.CUDA]) if name == "warm" else nullcontext() as prof:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(SERVE_CLIENT_THREADS) as pool:
                replies = list(pool.map(lambda r: _post(base, text_body(*r)), texts))
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
        launched = dict(flash_attention.launches_by_dtype)
        snap = metrics.snapshot()
        counters = snap["counters"]
        dispatches = {
            dtype: int(counters.get(f"serve.dispatches.{SERVE_TEXT_MODEL}.{rung}", 0))
            for dtype, rung in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
        }
        for (ids, cls), (status, _, reply, _) in zip(texts, replies):
            check(status == 200, f"serving text {cls}: HTTP {status} {reply}")
            check(reply["precision"] == ("bf16" if cls == "batch" else "f32"),
                  f"serving text {cls}: served at {reply['precision']}")
        recorded = _flash_kernel_counts(prof) if prof is not None else launched
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype)[6:]
            check(launched[dtype] > 0, f"serving: the {tag} flash kernel was never launched")
            check(
                launched[dtype] == recorded[dtype] == BERT_BASE_LAYERS * dispatches[dtype],
                f"serving {tag}: flash launches counted {launched[dtype]}, recorded by the profiler "
                f"{recorded[dtype]}, expected {BERT_BASE_LAYERS} x {dispatches[dtype]} dispatches",
            )
        busy_note = ""
        if prof is not None:
            busy = sum(sec for sec, _ in device_kernels(prof).values())
            check(busy > 0, "serving: the profiler saw no device time in the text burst")
            busy_note = (f"; device busy {busy:.3f} s of {wall:.3f} s (share {busy / wall:.3f}), "
                         f"the profiler recorded the same flash launches")
        print(
            f"serving text burst {SERVE_TEXT_MODEL}, {name} pass, on {card}: {len(texts)} HTTP requests "
            f"({text_rows} rows, widths 8-{text_spec.max_length}) from {SERVE_CLIENT_THREADS} threads in "
            f"{wall:.3f} s = {len(texts) / wall:.1f} requests/s, {text_rows / wall:.1f} rows/s; "
            f"{int(counters['serve.dispatches'])} dispatches (f32 {dispatches[torch.float32]}, bf16 "
            f"{dispatches[torch.bfloat16]}), {counters['serve.dispatched_rows'] / counters['serve.dispatches']:.2f} "
            f"real rows per dispatch; flash launches f32 {launched[torch.float32]}, bf16 "
            f"{launched[torch.bfloat16]} (= {BERT_BASE_LAYERS} x dispatches){busy_note}; "
            f"{_feeder_counts(counters)}"
        )
        for cls in SERVE_CLASSES:
            client_s = [rep[3] for (_, c), rep in zip(texts, replies) if c == cls]
            timer = snap["timers"][f"serve.latency.{cls}"]
            print(f"serving text latency {cls} ({'bf16' if cls == 'batch' else 'f32'} rung), {name} pass, on "
                  f"{card}: HTTP round trip {_percentiles_ms(client_s)}; router submit-to-result p50 "
                  f"{timer['p50_s'] * 1e3:.2f} ms, p95 {timer['p95_s'] * 1e3:.2f} ms")
        print(f"serving text segments, {name} pass: {_segments(snap['timers'])}")
        text_passes[name] = replies

    # the image burst: a few requests over HTTP, the rest through the
    # client; cold, then warm
    def image_call(i):
        x = images[i]
        if i < SERVE_IMAGE_HTTP:
            status, _, reply, dt = _post(base, {"model": SERVE_IMAGE_MODEL, "inputs": x.tolist(),
                                                "priority": "interactive"})
            check(status == 200, f"serving image over HTTP: {status} {reply}")
            return np.asarray(reply["outputs"], np.float32), dt
        t = time.perf_counter()
        out = client.predict(SERVE_IMAGE_MODEL, x, priority="interactive", timeout=300)
        return out, time.perf_counter() - t

    image_rows = sum(len(x) for x in images)
    image_passes = {}
    for name in SERVE_PASSES:
        metrics.reset()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_CLIENT_THREADS) as pool:
            replies = list(pool.map(image_call, range(len(images))))
        wall = time.perf_counter() - t0
        snap = metrics.snapshot()
        counters = snap["counters"]
        http_s = [dt for i, (_, dt) in enumerate(replies) if i < SERVE_IMAGE_HTTP]
        client_s = [dt for i, (_, dt) in enumerate(replies) if i >= SERVE_IMAGE_HTTP]
        print(
            f"serving image burst {SERVE_IMAGE_MODEL} {image_spec.height}x{image_spec.width} f32, {name} pass, "
            f"on {card}: {len(images)} interactive requests ({image_rows} rows; {SERVE_IMAGE_HTTP} over HTTP, "
            f"the rest through ServingClient) in {wall:.3f} s = {len(images) / wall:.1f} requests/s, "
            f"{image_rows / wall:.1f} rows/s; latency over HTTP {_percentiles_ms(http_s)}, through the client "
            f"{_percentiles_ms(client_s)}; {counters['serve.dispatched_rows'] / counters['serve.dispatches']:.2f} "
            f"real rows per dispatch; {_feeder_counts(counters)}"
        )
        print(f"serving image segments, {name} pass: {_segments(snap['timers'])}")
        image_passes[name] = replies

    # refusals: an unknown model and an over-long payload are 400
    status, _, reply, _ = _post(base, {"model": "no-such-model", "inputs": images[0].tolist()})
    check(status == 400, f"serving: unknown model gave HTTP {status}, not 400")
    long_ids = np.full((1, text_spec.max_length + 1), 7, np.int32)
    status, _, reply, _ = _post(base, text_body(long_ids, "interactive"))
    check(status == 400, f"serving: {long_ids.shape[1]} tokens gave HTTP {status}, not 400")

    # every reply row against the registry's ModelFunction called directly
    # (the same flash kernel), and against the dense-attention build, the
    # kernel's plain version, at phase 4's limits
    rungs = {"f32": torch.float32, "bf16": torch.bfloat16}

    def at_rung(mf, rung):  # the bf16 rung's own build, as the router's loader makes it
        return bf16_rung(mf) if rung == "bf16" else mf

    direct = {rung: at_rung(_direct_fn(text_spec, "embed", dtype, seed), rung) for rung, dtype in rungs.items()}
    plain = {
        rung: at_rung(_bert_text_builder(text_spec.size, attention="dense")(
            text_spec, mode="embed", dtype=dtype, seed=seed, params=None, device=torch.device("cuda")), rung)
        for rung, dtype in rungs.items()
    }
    worst = {"f32": 0.0, "bf16": 0.0}
    worst_plain = {"f32": 0.0, "bf16": 0.0}
    expected_text = {}
    for i, (ids, cls) in enumerate(texts):
        rung = "bf16" if cls == "batch" else "f32"
        want = _direct(direct[rung], ids, nhwc=False)
        dense = _direct(plain[rung], ids, nhwc=False)
        for replies in text_passes.values():
            got = np.asarray(replies[i][2]["outputs"], np.float32)
            check(got.shape == want.shape and np.isfinite(got).all(),
                  f"serving text request {i}: {got.shape} replies for {want.shape}")
            worst[rung] = max(worst[rung], float(np.abs(got - want).max()))
            worst_plain[rung] = max(worst_plain[rung], float(np.abs(got - dense).max()))
        if rung == "f32":
            expected_text[i] = want
    del direct, plain
    image_direct = _direct_fn(image_spec, "features", torch.float32, seed)
    expected_image = [_direct(image_direct, x, nhwc=True) for x in images]
    del image_direct
    image_err = max(
        _relative_error(out, want)
        for replies in image_passes.values()
        for (out, _), want in zip(replies, expected_image)
    )
    print(
        f"serving checks: {SERVE_TEXT_MODEL} replies vs the direct model max |diff| f32 {worst['f32']:.3e} "
        f"(atol {ATOL[torch.float32]}), bf16 rung {worst['bf16']:.3e} (atol {ATOL[torch.bfloat16]}); vs the "
        f"dense-attention build f32 {worst_plain['f32']:.3e} (atol {DENSE_ATOL[torch.float32]}), bf16 rung "
        f"{worst_plain['bf16']:.3e} (atol {DENSE_ATOL[torch.bfloat16]}); {SERVE_IMAGE_MODEL} relative error "
        f"{image_err:.3e} (limit {IMAGE_F32_REL}); unknown model and {long_ids.shape[1]} tokens: 400"
    )
    for rung, dtype in rungs.items():
        check(worst[rung] <= ATOL[dtype], f"serving {rung} text replies off the direct model by {worst[rung]}")
        check(worst_plain[rung] <= DENSE_ATOL[dtype],
              f"serving {rung} text replies off the dense-attention build by {worst_plain[rung]}")
    check(image_err <= IMAGE_F32_REL, f"serving image replies: relative error {image_err:.3e}")

    # drain: admission turns to 503 while the queued requests complete
    queued = [client.submit(SERVE_IMAGE_MODEL, x, priority="batch" if i % 2 else "interactive")
              for i, x in enumerate(images[:8])]
    req = urllib.request.Request(base + "/admin/drain", data=b"{}", method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        check(json.loads(resp.read())["status"] == "draining", "serving: /admin/drain did not drain")
    status, headers, reply, _ = _post(base, text_body(*texts[0]))
    check(status == 503 and headers.get("Retry-After"), f"serving while draining: HTTP {status}, not 503")
    drained = [r.result(timeout=300) for r in queued]
    check(router.wait_drained(timeout=120), "serving: the drain did not finish")
    print(f"serving drain: /admin/drain, then HTTP 503 with Retry-After {headers.get('Retry-After')} s; "
          f"{len(drained)} queued requests completed; resident models after the drain: {router.stats()['models']}")
    server.stop(close_router=True)
    del router, client, server
    gc.collect()
    # what the closed router left on the card: no model is resident, and
    # the launch thread (and this one, through the direct models) hold a
    # cuBLAS workspace for each (handle, stream) they ran a GEMM on
    left = torch.cuda.memory_allocated()
    clear_workspaces = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear_workspaces is not None:
        clear_workspaces()
    print(
        f"serving router closed: memory_allocated {allocated_before / 2**20:.1f} MiB before the router, "
        f"{left / 2**20:.1f} MiB after it closed with no model resident, "
        + (f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB after clearing the cuBLAS workspaces"
           if clear_workspaces is not None else "cuBLAS workspaces not cleared (no such call)")
    )
    _launch_probe(_direct_fn(text_spec, "embed", torch.float32, seed), text_spec, seed, card)

    # eviction under a budget that holds one model, f32 rung only
    os.environ.pop("SPARKDL_SERVE_PRECISION_BATCH")
    os.environ["SPARKDL_SERVE_HBM_BUDGET_MB"] = str(SERVE_BUDGET_MB)
    router = Router(seed=seed, device=SERVE_DEVICE)
    client = ServingClient(router)
    text_i = next(iter(expected_text))
    evict0 = metrics.counter("serve.evictions")
    steps = []
    for model in (SERVE_TEXT_MODEL, SERVE_IMAGE_MODEL, SERVE_TEXT_MODEL, SERVE_IMAGE_MODEL):
        before, ev = torch.cuda.memory_allocated(), metrics.counter("serve.evictions")
        if model == SERVE_TEXT_MODEL:
            out = client.predict(model, texts[text_i][0], priority="interactive", mode="embed", timeout=300)
            err = float(np.abs(out - expected_text[text_i]).max())
            check(err <= ATOL[torch.float32], f"eviction: {model} after a reload off by {err}")
        else:
            out = client.predict(model, images[1], priority="interactive", timeout=300)
            err = _relative_error(out, expected_image[1])
            check(err <= IMAGE_F32_REL, f"eviction: {model} after a reload off by {err:.3e}")
        gc.collect()
        after = torch.cuda.memory_allocated()
        steps.append((model, int(metrics.counter("serve.evictions") - ev), before, after, err))
        check(router.residency.resident_bytes() <= router.residency.budget_bytes(),
              "eviction: resident parameters over the budget")
    print(f"serving eviction (SPARKDL_SERVE_HBM_BUDGET_MB={SERVE_BUDGET_MB}) on {card}: " + "; ".join(
        f"{m}: {n} evicted, memory_allocated {b / 2**20:.1f} -> {a / 2**20:.1f} MiB, err {e:.2e}"
        for m, n, b, a, e in steps))
    check(all(n >= 1 for _, n, _, _, _ in steps[1:]), f"eviction: a load evicted nothing: {steps}")
    # each load after the first replaced the other model: memory_allocated
    # moves by the difference of their parameter bytes (less, plus 10 % and
    # SERVE_ALLOC_SLACK_MB of workspaces), so the victim's parameters left
    param_mb = {s.name: s.param_bytes_estimate() / 2**20 for s in (text_spec, image_spec)}
    for (prev, *_), (model, _, before, after, _) in zip(steps, steps[1:]):
        moved, expected = (after - before) / 2**20, param_mb[model] - param_mb[prev]
        check(moved <= expected + 0.1 * abs(expected) + SERVE_ALLOC_SLACK_MB,
              f"eviction: memory_allocated moved {moved:+.1f} MiB when {model} ({param_mb[model]:.1f} MiB) "
              f"replaced {prev} ({param_mb[prev]:.1f} MiB)")
    check(any(after < before for _, _, before, after, _ in steps[1:]),
          "eviction: memory_allocated never fell after an eviction")
    check(metrics.counter("serve.evictions") - evict0 >= 3, "eviction: fewer than 3 evictions")
    router.close()
    shutdown_feeders()
    for name in ("SPARKDL_SERVE_HBM_BUDGET_MB", "SPARKDL_FEEDER_IDLE_S", "SPARKDL_MAX_FEEDERS"):
        os.environ.pop(name, None)


def _launch_probe(mf, spec, seed: int, card: str) -> None:
    """Host wall of SERVE_PROBE_BATCHES forwards of ``mf`` (4 rows of
    width 256) on the serving compute stream: launched from one thread in
    turn, as the device's launch thread issues the feeders' forwards, then
    split over SERVE_PROBE_THREADS threads at once, as feeder threads
    calling the model themselves would; each run ends in a synchronize.
    Isolates what concurrent launching costs the host."""
    import threading

    from sparkdl_tpu_torch.runtime.device import compute_stream

    stream = compute_stream(torch.device(mf.device))
    rng = np.random.default_rng(seed + 13)
    width = min(256, spec.max_length)
    ids = torch.from_numpy(rng.integers(4, spec.vocab_size, size=(4, width)).astype(np.int32)).to(mf.device)

    def work(n):
        with torch.cuda.stream(stream):
            for _ in range(n):
                mf(ids)

    work(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    work(SERVE_PROBE_BATCHES)
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    threads = [threading.Thread(target=work, args=(SERVE_PROBE_BATCHES // SERVE_PROBE_THREADS,))
               for _ in range(SERVE_PROBE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    many = time.perf_counter() - t0
    print(f"serving launch probe on {card}: {SERVE_PROBE_BATCHES} {spec.name} f32 forwards (4 x {width} tokens) "
          f"from 1 thread {one:.3f} s ({one / SERVE_PROBE_BATCHES * 1e3:.2f} ms each), from "
          f"{SERVE_PROBE_THREADS} threads at once {many:.3f} s ({many / SERVE_PROBE_BATCHES * 1e3:.2f} ms each)")


def _train_model(dtype, seed: int, device) -> ModelFunction:
    """BASELINE config[4]'s model: ResNet50 with a 10-way head at 224x224,
    weights from ``seed`` (a CPU generator: the same on every device),
    taking NHWC rows as the JAX package's flax module does."""
    module = ResNet50(dtype=dtype, num_classes=TRAIN_CLASSES)
    init_cnn_params(module, torch.Generator().manual_seed(seed))
    return ModelFunction.from_module(module, input_shape=(TRAIN_SIDE, TRAIN_SIDE, 3), device=device)


def _train_estimator(model: ModelFunction, **kw) -> DataParallelEstimator:
    params = dict(
        inputCol="image", labelCol="label", outputCol="logits", batchSize=TRAIN_BATCH,
        epochs=TRAIN_EPOCHS, stepSize=TRAIN_STEP_SIZE, targetHeight=TRAIN_SIDE, targetWidth=TRAIN_SIDE,
    )
    params.update(kw)
    return DataParallelEstimator(model=model, **params)


def _cross_entropy(mf: ModelFunction):
    """The estimator's default loss: masked mean cross-entropy over the
    uint8 feed cast to float32."""
    def loss(params, batch):
        bx, by, bm = batch
        logits = mf.apply(params, bx.float()).float()
        per_ex = F.cross_entropy(logits, by.long(), reduction="none")
        return (per_ex * bm).sum() / torch.clamp(bm.sum(), min=1.0)

    return loss


def _sgd_two_steps(mf: ModelFunction, mesh, x: np.ndarray, y: np.ndarray) -> dict:
    """Two SGD steps of TRAIN_SGD_ROWS rows each; the trained params."""
    import functools

    device = torch.device(mf.device)
    state = create_train_state(mf.named_params(), functools.partial(torch.optim.SGD, lr=TRAIN_SGD_LR))
    step = make_data_parallel_step(_cross_entropy(mf), mesh)
    for k in range(2):
        rows = slice(k * TRAIN_SGD_ROWS, (k + 1) * TRAIN_SGD_ROWS)
        batch = (torch.from_numpy(x[rows]).to(device), torch.from_numpy(y[rows]).to(device),
                 torch.ones(TRAIN_SGD_ROWS, device=device))
        state, m = step(state, batch)
        check(bool(torch.isfinite(m["loss"])), f"SGD check step {k}: loss {float(m['loss'])}")
    return {n: p.detach().cpu() for n, p in state.params.items()}


def _sgd_reference_f64(seed: int, device, x: np.ndarray, y: np.ndarray) -> dict:
    """The two SGD steps of :func:`_sgd_two_steps` in float64, without the
    trainer: the same weights cast up, ``functional_call`` over float64
    leaves (BatchNorm statistics included), plain ``p -= lr * g``."""
    module = ResNet50(num_classes=TRAIN_CLASSES)
    init_cnn_params(module, torch.Generator().manual_seed(seed))
    module = module.to(device, torch.float64)
    module.dtype = torch.float64
    params = {
        n: t.detach().clone().requires_grad_(True)
        for n, t in list(module.named_parameters()) + list(module.named_buffers())
    }
    for k in range(2):
        rows = slice(k * TRAIN_SGD_ROWS, (k + 1) * TRAIN_SGD_ROWS)
        xb = torch.from_numpy(x[rows]).to(device).permute(0, 3, 1, 2).contiguous().double()
        logits = torch.func.functional_call(module, params, (xb,)).double()
        loss = F.cross_entropy(logits, torch.from_numpy(y[rows]).to(device).long())
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p -= TRAIN_SGD_LR * g
    return {n: p.detach().cpu() for n, p in params.items()}


def phase_training(seed: int, device_name: str, tmp: str) -> None:
    """Phase 12: BASELINE config[4], data-parallel ResNet50 fine-tuning."""
    import socket

    from torch.profiler import ProfilerActivity, profile

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cuda = torch.device("cuda", torch.cuda.current_device())
    distributed.initialize(f"tcp://localhost:{port}", world_size=1, rank=0, device=cuda)
    try:
        mesh = make_mesh()
        check(mesh.group is not None and torch.distributed.get_backend() == "nccl" and mesh.size == 1,
              f"phase 12: expected an NCCL group of world size 1, got {mesh}")
        structs, labels = _colour_structs(seed, TRAIN_IMAGES, TRAIN_SIDE)
        df = DataFrame.fromColumns({"image": structs, "label": labels}, numPartitions=TRAIN_PARTITIONS)
        steps = TRAIN_IMAGES // TRAIN_BATCH
        print(f"training: ResNet50(num_classes={TRAIN_CLASSES}) {TRAIN_SIDE}x{TRAIN_SIDE}, {TRAIN_IMAGES} image "
              f"structs in {TRAIN_PARTITIONS} partitions, global batch {TRAIN_BATCH}, Adam {TRAIN_STEP_SIZE}, "
              f"NCCL world size {mesh.size} on {device_name}")
        macs = None
        fitted = {}
        for arm, dtype, peak in (("f32", torch.float32, "f32"), ("bf16", torch.bfloat16, "bf16")):
            mf = _train_model(dtype, seed, cuda)
            if macs is None:
                macs = model_macs(mf.module, (3, TRAIN_SIDE, TRAIN_SIDE))
                print(f"training: {macs} MAC per image in the forward (logits, bench_bounds.model_macs); "
                      f"6 x that = {6 * macs * TRAIN_BATCH / 1e9:.1f} GFLOP per step")
            initial_var = mf.module.bn_init.running_var.detach().float().clone()
            torch.cuda.synchronize()
            model = _train_estimator(mf).fit(df)
            hist = model.history
            check([h["steps"] for h in hist] == [steps] * TRAIN_EPOCHS, f"training {arm}: steps {hist}")
            check(all(np.isfinite(h["loss"]) for h in hist), f"training {arm}: losses {[h['loss'] for h in hist]}")
            step_s = hist[-1]["mean_step_time_s"]
            print(f"training {arm}: losses {[round(h['loss'], 4) for h in hist]}; epoch {TRAIN_EPOCHS} "
                  f"mean_step_time_s {step_s:.5f} = {TRAIN_BATCH / step_s:.1f} images/s (epoch 1 "
                  f"{hist[0]['mean_step_time_s']:.5f} s per step, the first step's set-up included)")
            moved = float((model.modelFunction.module.bn_init.running_var.float() - initial_var).abs().max())
            check(moved > 0, f"training {arm}: the BatchNorm statistics did not move")
            # one more epoch under the profiler, warm, from the trained weights
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                again = _train_estimator(model.modelFunction, epochs=1).fit(df)
                torch.cuda.synchronize()
            kernels = device_kernels(prof)
            busy = sum(sec for sec, _ in kernels.values())
            check(busy > 0, "the profiler saw no device time")
            epoch_s = again.history[0]["epoch_time_s"]
            nccl = [(sec, n) for key, (sec, n) in kernels.items() if "nccl" in key.lower()]
            rate = 6 * macs * TRAIN_IMAGES / busy
            print(f"training {arm} profiled epoch: {epoch_s:.3f} s wall ({again.history[0]['mean_step_time_s']:.5f} s "
                  f"per step), device busy {busy:.3f} s (share {busy / epoch_s:.3f}; {busy / steps * 1e3:.2f} ms "
                  f"per step = {busy / steps / step_s:.3f} of the unprofiled epoch {TRAIN_EPOCHS} step); training work "
                  f"{rate / 1e12:.2f} TFLOP/s over busy = {rate / PEAK_FLOP_PER_S[peak]:.3f} of the {peak} peak "
                  f"({PEAK_FLOP_PER_S[peak] / 1e12:.0f} TFLOP/s); NCCL all-reduce "
                  f"{sum(sec for sec, _ in nccl) / steps * 1e3:.4f} ms per step ({sum(n for _, n in nccl)} kernels "
                  f"in {steps} steps); BatchNorm running_var of the stem moved by up to {moved:.3e}")
            for name, (sec, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:5]:
                print(f"  device {sec:.4f} s  x{n}  {name[:90]}")
            fitted[arm] = model
            del mf, again
            torch.cuda.empty_cache()
        # the step's one all-reduce (every gradient and the loss), alone
        numel = sum(t.numel() for t in fitted["f32"].modelFunction.named_params().values()) + 1
        buf = torch.ones(numel, device=cuda)
        allreduce_ms = time_ms(lambda: torch.distributed.all_reduce(buf, group=mesh.group), TRAIN_ALLREDUCE_ITERS)
        print(f"training: the step's all_reduce of {numel} float32 ({numel * 4 / 2**20:.1f} MiB), NCCL world size "
              f"{mesh.size}: {allreduce_ms:.4f} ms per call (CUDA events, {TRAIN_ALLREDUCE_ITERS} calls)")
        del buf
        # the streamed feed: one more f32 epoch, partitions decoded on a
        # producer thread through a shuffle buffer
        metrics.reset()
        streamed = _train_estimator(fitted["f32"].modelFunction, epochs=1, streaming=True,
                                    shuffleBufferRows=TRAIN_SHUFFLE_ROWS).fit(df)
        wait = metrics.snapshot()["timers"]["train.data_wait"]
        h = streamed.history[0]
        check(h["steps"] == steps and np.isfinite(h["loss"]), f"training streamed: {h}")
        print(f"training f32 streamed (shuffle buffer {TRAIN_SHUFFLE_ROWS} rows): loss {h['loss']:.4f}, "
              f"mean_step_time_s {h['mean_step_time_s']:.5f} = {TRAIN_BATCH / h['mean_step_time_s']:.1f} images/s; "
              f"train.data_wait {wait['total_s']:.3f} s over {wait['count']} steps "
              f"(mean {wait['total_s'] / max(wait['count'], 1) * 1e3:.2f} ms)")
        del streamed
        # scoring: the trained f32 model through the executor and the
        # shared feeder against the module called directly
        model = fitted["f32"]
        few = DataFrame.fromColumns({"image": structs[:TRAIN_SCORE_ROWS]}, numPartitions=TRAIN_PARTITIONS)
        metrics.reset()
        scored = np.stack([r.logits for r in model.transform(few).collect()])
        coalesced = int(metrics.counter("feeder.coalesced_batches"))
        batch, _ = image_structs_to_batch(structs[:TRAIN_SCORE_ROWS], TRAIN_SIDE, TRAIN_SIDE)
        direct = model.modelFunction(torch.from_numpy(batch).to(cuda)).cpu().numpy()
        score_err = _relative_error(scored, direct)
        print(f"training: DataParallelModel.transform over {TRAIN_SCORE_ROWS} rows in {TRAIN_PARTITIONS} "
              f"partitions ({coalesced} coalesced batches) vs the trained module called directly: relative "
              f"error {score_err:.3e} (limit {IMAGE_F32_REL})")
        check(coalesced > 0, "training: the trained model's scoring did not go through the shared feeder")
        check(score_err <= IMAGE_F32_REL, f"training: scored rows off the direct module by {score_err:.3e}")
        del fitted
        torch.cuda.empty_cache()
        # two SGD steps on the card against the same two on the CPU
        x, _ = image_structs_to_batch(structs[: 2 * TRAIN_SGD_ROWS], TRAIN_SIDE, TRAIN_SIDE)
        y = np.asarray(labels[: 2 * TRAIN_SGD_ROWS], np.int32)
        t0 = time.perf_counter()
        card = _sgd_two_steps(_train_model(torch.float32, seed, cuda), mesh, x, y)
        t_card = time.perf_counter() - t0
        cpu = _sgd_two_steps(_train_model(torch.float32, seed, "cpu"), Mesh({"dp": 1}), x, y)
        t_cpu = time.perf_counter() - t0 - t_card
        ref = _sgd_reference_f64(seed, cuda, x, y)

        def rel(a, n):
            return float((a[n].double() - ref[n]).abs().max() / ref[n].abs().max().clamp(min=1e-300))

        errs = {n: (rel(card, n), rel(cpu, n)) for n in ref}
        card_vs_cpu = max(
            float((card[n] - cpu[n]).abs().max() / cpu[n].abs().max().clamp(min=1e-30)) for n in cpu
        )
        over = [n for n, (c, p) in errs.items() if c > TRAIN_SGD_REL + TRAIN_SGD_NOISE * p]
        worst_card = max((c, n) for n, (c, _) in errs.items())
        worst_cpu = max((p, n) for n, (_, p) in errs.items())
        print(f"training: two f32 SGD steps (lr {TRAIN_SGD_LR}, {TRAIN_SGD_ROWS} rows each; card {t_card:.2f} s, "
              f"CPU {t_cpu:.2f} s) against float64 on the card, each tensor relative to its own max: card worst "
              f"{worst_card[0]:.3e} ({worst_card[1]}), CPU worst {worst_cpu[0]:.3e} ({worst_cpu[1]}); over 1e-4: "
              f"card {sum(c > 1e-4 for c, _ in errs.values())}, CPU {sum(p > 1e-4 for _, p in errs.values())} of "
              f"{len(errs)} tensors; card vs CPU worst {card_vs_cpu:.3e}; tensors where the card exceeds "
              f"{TRAIN_SGD_REL} + {TRAIN_SGD_NOISE} x the CPU's error: {len(over)}")
        check(not over, f"training: card SGD steps off float64 beyond the CPU's float32 error in {over[:5]}")
        # checkpoint and resume: a run stopped after one epoch resumes there
        model_dir = os.path.join(tmp, "train_ckpt")
        first = _train_estimator(_train_model(torch.float32, seed, cuda), epochs=1, modelDir=model_dir)
        first.fit(df)
        saved = first._latest_step(model_dir)
        second = _train_estimator(_train_model(torch.float32, seed, cuda), epochs=1, modelDir=model_dir)
        resumed = second.fit(df)
        check(saved == steps and second._latest_step(model_dir) == 2 * steps,
              f"training resume: saved step {saved}, then {second._latest_step(model_dir)}")
        print(f"training: modelDir run stopped after epoch 1 at step {saved}; the next fit resumed there and "
              f"saved step {second._latest_step(model_dir)} (loss {resumed.history[0]['loss']:.4f})")
    finally:
        distributed.shutdown()


def phase_sql(seed: int, device_name: str) -> None:
    """Phase 13, BASELINE config[2]: a model UDF over an image view,
    scored through sql() on the card."""
    spec = get_image_model(SQL_MODEL)
    t0 = time.perf_counter()
    structs, _ = _colour_structs(seed, SQL_IMAGES, spec.height)
    structs.insert(SQL_NULL_ROW, None)
    labels = [str(x) for x in np.random.default_rng(seed + 13).choice(["a", "b"], size=len(structs))]
    n = len(structs)
    valid = [i for i, s in enumerate(structs) if s is not None]
    a_rows = [i for i, lab in enumerate(labels) if lab == "a"]
    spans = partition_row_spans(n, SQL_PARTITIONS)
    print(f"sql: {SQL_IMAGES} synthetic {spec.height}x{spec.width} structs and a null image (row "
          f"{SQL_NULL_ROW}) in {time.perf_counter() - t0:.2f} s (host); 'a' rows per partition "
          f"{[sum(labels[i] == 'a' for i in range(a, b)) for a, b in spans]} of {[b - a for a, b in spans]}")
    for name in ("SPARKDL_FEEDER_IDLE_S", "SPARKDL_MAX_FEEDERS"):
        os.environ.pop(name, None)  # phase 11's serving keepalive: offline here
    shutdown_feeders()
    spark = SparkSession.builder.appName("chip_smoke").getOrCreate()
    DataFrame.fromColumns({"image": structs, "label": labels}, numPartitions=SQL_PARTITIONS) \
        .createOrReplaceTempView("images")
    DataFrame.fromColumns(
        {"image": structs[:SQL_WARM_ROWS], "label": labels[:SQL_WARM_ROWS]}, numPartitions=SQL_PARTITIONS
    ).createOrReplaceTempView("images_warm")
    t0 = time.perf_counter()
    udf_catalog.registerKerasImageUDF(SQL_UDF, SQL_MODEL, batch_size=SQL_BATCH)
    print(f"sql: registerKerasImageUDF({SQL_UDF!r}, {SQL_MODEL!r}, batch_size={SQL_BATCH}) on "
          f"{device_name} in {time.perf_counter() - t0:.2f} s")

    def plain(table):
        return spark.sql(SQL_QUERY.format(table=table))

    arms = (
        ("apply_udf", {}, lambda t: udf_catalog.apply_udf(SQL_UDF, spark.table(t), "image", "probs")),
        ("sql", {}, plain),
        ("sql WHERE label = 'a'", {}, lambda t: spark.sql(SQL_FILTER_QUERY.format(table=t))),
        ("sql SPARKDL_SQL_VECTORIZE=0", {"SPARKDL_SQL_VECTORIZE": "0"}, plain),
        ("sql SPARKDL_SHARED_FEEDER=0", {"SPARKDL_SHARED_FEEDER": "0"}, plain),
    )
    counter_names = ("sql.udf.batches", "sql.udf.batch_rows", "sql.pushdown.pruned_cols",
                     "sql.pushdown.skipped_rows", "feeder.coalesced_batches", "transform.batches")
    results = {}
    flash_attention.launches = 0
    for name, env, run in arms:
        os.environ.update(env)
        try:
            run("images_warm").collect()  # cuDNN and allocator warm-up: not counted
            torch.cuda.synchronize()
            metrics.reset()
            t0 = time.perf_counter()
            rows = run("images").collect()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {c: int(metrics.counter(c)) for c in counter_names}
        finally:
            for key in env:
                os.environ.pop(key)
        results[name] = (rows, dt, counts)
    check(flash_attention.launches == 0, f"sql: {flash_attention.launches} flash launches on a CNN path")

    def probs(name, expected_rows):
        rows = results[name][0]
        check(len(rows) == len(expected_rows), f"sql {name}: {len(rows)} rows, not {len(expected_rows)}")
        out = {}
        for i, r in zip(expected_rows, rows):
            p = r["probs"]
            if structs[i] is None:
                check(p is None, f"sql {name}: the null image gave {type(p).__name__}, not null")
                continue
            check(p is not None and p.shape == (1000,) and bool(np.isfinite(p).all()),
                  f"sql {name}: row {i} is not a finite 1000-vector")
            check(abs(float(p.astype(np.float64).sum()) - 1.0) <= SQL_SUM_ATOL,
                  f"sql {name}: row {i} sums to {float(p.sum())}")
            out[i] = p
        return out

    base = probs("sql", range(n))
    base_rows = np.stack([base[i] for i in valid])
    filtered = results["sql WHERE label = 'a'"]
    check(all(r["label"] == "a" for r in filtered[0]), "sql WHERE: a row that is not 'a'")
    a_valid = [i for i in a_rows if structs[i] is not None]
    arm_errs = {}
    for name, _, _ in arms:
        if name == "sql":
            continue
        got = probs(name, a_rows if name.startswith("sql WHERE") else range(n))
        keys = a_valid if name.startswith("sql WHERE") else valid
        arm_errs[name] = _relative_error(np.stack([got[i] for i in keys]), np.stack([base[i] for i in keys]))
        check(arm_errs[name] <= IMAGE_F32_REL, f"sql {name}: rows off the plain query's by {arm_errs[name]:.3e}")
    # the card against the port on the CPU, same registry weights
    sample = [i for i in _sample_rows(n) if structs[i] is not None]
    udf_catalog.registerKerasImageUDF("mnv2_cpu", SQL_MODEL, batch_size=SQL_BATCH, device="cpu")
    t0 = time.perf_counter()
    cpu = udf_catalog.apply_udf(
        "mnv2_cpu", DataFrame.fromColumns({"image": [structs[i] for i in sample]}), "image", "probs"
    ).collect()
    cpu_s = time.perf_counter() - t0
    udf_catalog.unregister("mnv2_cpu")
    cpu_err = _relative_error(np.stack([base[i] for i in sample]), np.stack([r.probs for r in cpu]))
    check(cpu_err <= IMAGE_F32_REL, f"sql: card vs CPU probabilities relative error {cpu_err:.3e}")
    # what the pushdown and the feeder did
    where_counts = filtered[2]
    n_b = n - len(a_rows)
    check(where_counts["sql.udf.batch_rows"] == len(a_valid),
          f"sql WHERE: the model scored {where_counts['sql.udf.batch_rows']} rows, not the {len(a_valid)} 'a' rows")
    check(where_counts["sql.pushdown.skipped_rows"] == n_b,
          f"sql WHERE: the pushdown skipped {where_counts['sql.pushdown.skipped_rows']} rows, not the {n_b} 'b' rows")
    shared_batches = results["sql"][2]["sql.udf.batches"]
    own_batches = results["sql SPARKDL_SHARED_FEEDER=0"][2]["sql.udf.batches"]
    check(0 < shared_batches <= own_batches,
          f"sql: the shared feeder dispatched {shared_batches} batches, the partitions' own pipelines {own_batches}")
    card = f"{device_name} ({_smi()})"
    # the SQL arm and apply_udf once more each, in the other order (ABBA),
    # so that the overhead is not the order the arms ran in
    again = {}
    for name, _, run in (arms[1], arms[0]):
        t0 = time.perf_counter()
        run("images").collect()
        torch.cuda.synchronize()
        again[name] = time.perf_counter() - t0
    for name, _, _ in arms:
        _, dt, counts = results[name]
        scored = len(a_valid) if name.startswith("sql WHERE") else len(valid)
        print(f"sql {name} on {card}: {scored} images scored in {dt:.3f} s = {scored / dt:.1f} images/s; "
              + ", ".join(f"{c} {v}" for c, v in counts.items())
              + (f"; rows vs the plain query: relative error {arm_errs[name]:.3e} (limit {IMAGE_F32_REL})"
                 if name in arm_errs else ""))
    sql_s = (results["sql"][1], again["sql"])
    apply_s = (results["apply_udf"][1], again["apply_udf"])
    print(f"sql: the SQL arm's overhead over apply_udf {100 * (sum(sql_s) / sum(apply_s) - 1):+.1f} % over two "
          f"passes each, run apply, sql, sql, apply (sql {sql_s[0]:.3f} + {sql_s[1]:.3f} s, apply_udf "
          f"{apply_s[0]:.3f} + {apply_s[1]:.3f} s; the JAX bench expected about 10 %); sql.udf.batches shared "
          f"feeder {shared_batches}, SPARKDL_SHARED_FEEDER=0 {own_batches}; WHERE label = 'a': batch_rows "
          f"{where_counts['sql.udf.batch_rows']} = the {len(a_valid)} non-null 'a' rows, skipped_rows "
          f"{where_counts['sql.pushdown.skipped_rows']} = the {n_b} 'b' rows; card vs CPU over {len(sample)} "
          f"rows (CPU {cpu_s:.2f} s) relative error {cpu_err:.3e} (limit {IMAGE_F32_REL}); flash launches 0")
    wall, busy, by_kernel = _profiled(lambda: plain("images").collect())
    print(f"sql profiled pass of {SQL_QUERY.format(table='images')!r}: wall {wall:.3f} s, device busy "
          f"{busy:.3f} s (share {busy / wall:.3f})")
    for name, sec in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]:
        print(f"  device {sec:.4f} s  {name[:90]}")
    udf_catalog.unregister(SQL_UDF)
    shutdown_feeders()


def _seeded_keras_weights(config: dict, seed: int) -> dict:
    """Weights for every layer of a Keras config, drawn from ``seed``:
    conv kernels He-scaled, BatchNorm gamma in ``KERAS_BN_GAMMA`` and
    positive variance, Dense Glorot-scaled; shapes from each layer's
    ``build_config``."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, _, layer, _ in walk_layers(config):
        cfg, cls = layer["config"], layer["class_name"]
        cin = int(layer["build_config"]["input_shape"][-1])
        if cls == "Conv2D":
            kh, kw = cfg["kernel_size"]
            shape = (kh, kw, cin, cfg["filters"])
            w = [rng.standard_normal(shape, dtype=np.float32) * np.float32(np.sqrt(2.0 / (kh * kw * cin)))]
            if cfg.get("use_bias", True):
                w.append(rng.normal(0.0, 0.01, cfg["filters"]).astype(np.float32))
        elif cls == "BatchNormalization":
            w = [rng.uniform(*KERAS_BN_GAMMA, cin), rng.normal(0.0, 0.05, cin),
                 rng.normal(0.0, 0.05, cin), rng.uniform(0.5, 1.5, cin)]
            w = [a.astype(np.float32) for a in w]
        elif cls == "Dense":
            units = cfg["units"]
            w = [(rng.standard_normal((cin, units)) * np.sqrt(2.0 / (cin + units))).astype(np.float32),
                 rng.normal(0.0, 0.01, units).astype(np.float32)]
        else:
            raise PhaseError(f"keras: no seeded weights for {cls}")
        out[path] = w
    return out


def _keras_head(seed: int) -> KerasModelSpec:
    """Phase 14's KerasTransformer model, a Sequential Dense head given as
    a config dict: 1000 -> 64 relu -> 10."""
    layers = [{"class_name": "InputLayer", "config": {"name": "probs", "batch_shape": [None, 1000]}}]
    weights, width, rng = {}, 1000, np.random.default_rng(seed + 14)
    for i, units in enumerate(KERAS_HEAD):
        name = f"head_{i}"
        layers.append({"class_name": "Dense", "config": {
            "name": name, "units": units, "activation": "relu" if i < len(KERAS_HEAD) - 1 else "linear"}})
        weights[name] = [(rng.standard_normal((width, units)) * np.sqrt(2.0 / width)).astype(np.float32),
                         rng.normal(0.0, 0.1, units).astype(np.float32)]
        width = units
    return KerasModelSpec({"name": "head", "layers": layers}, weights)


def _keras_files(seed: int, root: str):
    """Phase 14's URIs in a seeded order: JPEGs of random pixels at
    224x224 (quality 90, as bench.py writes them), PNGs at 224x224 and at
    KERAS_PNG_RESIZED, a corrupt file, a missing path and None; and each
    row's kind."""
    from PIL import Image

    rng = np.random.default_rng(seed + 140)
    entries = []
    for i in range(KERAS_JPEGS):
        path = os.path.join(root, f"img_{i}.jpg")
        Image.fromarray(rng.integers(0, 256, size=(KERAS_SIDE, KERAS_SIDE, 3), dtype=np.uint8)).save(
            path, quality=KERAS_JPEG_QUALITY)
        entries.append((path, "jpeg"))
    for kind, (h, w) in (("png", (KERAS_SIDE, KERAS_SIDE)), ("png resized", KERAS_PNG_RESIZED)):
        for i in range(KERAS_PNGS):
            path = os.path.join(root, f"{kind.replace(' ', '_')}_{i}.png")
            Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)).save(path)
            entries.append((path, kind))
    corrupt = os.path.join(root, "corrupt.jpg")
    with open(corrupt, "wb") as f:
        f.write(b"\xff\xd8 not a jpeg")
    entries += [(corrupt, "null"), (os.path.join(root, "missing.jpg"), "null"), (None, "null")]
    order = rng.permutation(len(entries))
    return [entries[i][0] for i in order], [entries[i][1] for i in order]


def _caffe_loader(uri: str) -> np.ndarray:
    """Arm (c)'s imageLoader: the fused host stage without the bridge in
    numpy and PIL (PIL decode, RGB, PIL bilinear resize), then 'caffe'."""
    with open(uri, "rb") as f:
        bgr = imageIO.PIL_decode(f.read())
    if bgr is None:
        raise ValueError(f"{uri}: not an image")
    rgb = host_resize_uint8(np.ascontiguousarray(bgr[:, :, ::-1]), KERAS_SIDE, KERAS_SIDE)
    return rgb[:, :, ::-1].astype(np.float32) - CAFFE_MEAN_BGR


def phase_keras_image(seed: int, device_name: str, tmp: str) -> None:
    """Phase 14, BASELINE config[1]: KerasImageFileTransformer over Keras
    ResNet50 at 224x224 on the card, and KerasTransformer after it."""
    headers = all(os.path.exists(h) for h in BRIDGE_HEADERS)
    status = native.status()
    print(f"keras: native image bridge {status}; libjpeg and libpng headers "
          f"{'present' if headers else 'absent'} ({', '.join(BRIDGE_HEADERS)})")
    if headers:
        check(native.available(), f"keras: the bridge did not build where its headers exist: {status}")
    t0 = time.perf_counter()
    root = os.path.join(tmp, "keras_images")
    os.makedirs(root)
    uris, kinds = _keras_files(seed, root)
    n = len(uris)
    with open(KERAS_CONFIG) as f:
        config = json.load(f)
    spec = KerasModelSpec(config, _seeded_keras_weights(config, seed))
    spans = partition_row_spans(n, KERAS_PARTITIONS)
    print(f"keras: {KERAS_JPEGS} JPEGs (q{KERAS_JPEG_QUALITY}) and {KERAS_PNGS} PNGs at {KERAS_SIDE}x{KERAS_SIDE}, "
          f"{KERAS_PNGS} PNGs at {KERAS_PNG_RESIZED[0]}x{KERAS_PNG_RESIZED[1]}, a corrupt file, a missing path and "
          f"None ({n} rows, {[b - a for a, b in spans]} per partition) and {spec.name}'s seeded weights in "
          f"{time.perf_counter() - t0:.2f} s (host)")
    for name in ("SPARKDL_FEEDER_IDLE_S", "SPARKDL_MAX_FEEDERS"):
        os.environ.pop(name, None)
    shutdown_feeders()
    df = DataFrame.fromColumns({"uri": uris}, numPartitions=KERAS_PARTITIONS)
    warm = DataFrame.fromColumns({"uri": uris[:KERAS_BATCH]}, numPartitions=KERAS_PARTITIONS)
    t0 = time.perf_counter()
    fused = KerasImageFileTransformer(inputCol="uri", outputCol="probs", model=spec, batchSize=KERAS_BATCH,
                                      preprocessing="caffe")
    loader = KerasImageFileTransformer(inputCol="uri", outputCol="probs", model=spec, batchSize=KERAS_BATCH,
                                       imageLoader=_caffe_loader)
    fused._model_function()
    print(f"keras: {spec.name} translated to torch and put on {device_name} in {time.perf_counter() - t0:.2f} s")
    arms = (
        ("(a) fused, bridge", fused, {}),
        ("(b) fused, SPARKDL_TPU_NO_NATIVE=1", fused, {"SPARKDL_TPU_NO_NATIVE": "1"}),
        ("(c) imageLoader (numpy/PIL, caffe)", loader, {}),
        ("(d) fused, SPARKDL_SHARED_FEEDER=0", fused, {"SPARKDL_SHARED_FEEDER": "0"}),
    )
    flash_attention.launches = 0
    results = {}
    for name, stage, env in arms:
        os.environ.update(env)
        try:
            stage.transform(warm).collect()  # cuDNN and allocator warm-up: not counted
            torch.cuda.synchronize()
            metrics.reset()
            t0 = time.perf_counter()
            rows = [r["probs"] for r in stage.transform(df).collect()]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            snap = metrics.snapshot()
        finally:
            for key in env:
                os.environ.pop(key)
        results[name] = (rows, dt, snap)
    valid = [i for i, k in enumerate(kinds) if k != "null"]
    for name, (rows, _, _) in results.items():
        check(len(rows) == n, f"keras {name}: {len(rows)} rows, not {n}")
        for i, (p, kind) in enumerate(zip(rows, kinds)):
            if kind == "null":
                check(p is None, f"keras {name}: row {i} ({uris[i]}) is not null")
                continue
            check(p is not None and p.shape == (1000,) and bool(np.isfinite(p).all()),
                  f"keras {name}: row {i} is not a finite 1000-vector")
            check(abs(float(p.astype(np.float64).sum()) - 1.0) <= SQL_SUM_ATOL,
                  f"keras {name}: row {i} sums to {float(p.sum())}")

    def stack(name, rows_at):
        return np.stack([results[name][0][i] for i in rows_at])

    a, b, c, d = (name for name, _, _ in arms)
    err_ad = _relative_error(stack(d, valid), stack(a, valid))
    check(err_ad <= KERAS_ARM_REL, f"keras: (a) vs (d) relative error {err_ad:.3e}")
    err_bc = float(np.abs(stack(b, valid) - stack(c, valid)).max())
    check(err_bc <= KERAS_LOADER_ATOL, f"keras: (b) vs (c) max abs difference {err_bc:.3e}")
    by_kind = {k: [i for i in valid if kinds[i] == k] for k in ("jpeg", "png", "png resized")}
    err_png = _relative_error(stack(b, by_kind["png"]), stack(a, by_kind["png"]))
    check(err_png <= IMAGE_F32_REL, f"keras: (a) vs (b) on the {KERAS_SIDE}x{KERAS_SIDE} PNG rows {err_png:.3e}")
    ab_max = {k: float(np.abs(stack(b, by_kind[k]) - stack(a, by_kind[k])).max()) for k in ("jpeg", "png resized")}
    # the card against the port on the CPU: the PNG rows and rows spread
    # over every partition
    png_rows = by_kind["png"] + by_kind["png resized"]
    per_part = (KERAS_CPU_ROWS - len(png_rows)) // KERAS_PARTITIONS
    sample = list(png_rows)
    for lo, hi in spans:
        inside = [i for i in by_kind["jpeg"] if lo <= i < hi]
        sample += [inside[j] for j in np.linspace(0, len(inside) - 1, per_part).round().astype(int)]
    sample = sorted(sample)
    cpu_stage = KerasImageFileTransformer(inputCol="uri", outputCol="probs", model=spec, batchSize=KERAS_BATCH,
                                          preprocessing="caffe", device="cpu")
    t0 = time.perf_counter()
    cpu = [r["probs"] for r in cpu_stage.transform(
        DataFrame.fromColumns({"uri": [uris[i] for i in sample]})).collect()]
    cpu_s = time.perf_counter() - t0
    cpu_err = _relative_error(stack(a, sample), np.stack(cpu))
    check(cpu_err <= IMAGE_F32_REL, f"keras: card vs CPU relative error {cpu_err:.3e} over {len(sample)} rows")
    # (e): KerasTransformer over (a)'s output column
    head = _keras_head(seed)
    head_stage = KerasTransformer(inputCol="probs", outputCol="logits", model=head, batchSize=KERAS_BATCH)
    probs_df = DataFrame.fromColumns({"probs": results[a][0]}, numPartitions=KERAS_PARTITIONS)
    head_stage.transform(DataFrame.fromColumns({"probs": results[a][0][:KERAS_BATCH]})).collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = [r["logits"] for r in head_stage.transform(probs_df).collect()]
    torch.cuda.synchronize()
    head_s = time.perf_counter() - t0
    check(all((lg is None) == (k == "null") for lg, k in zip(logits, kinds)), "keras (e): null rows do not match")
    x = stack(a, valid).astype(np.float64)
    (w1, b1), (w2, b2) = (head.get_layer(f"head_{i}").get_weights() for i in range(2))
    ref = np.maximum(x @ w1 + b1, 0.0) @ w2 + b2
    head_err = _relative_error(np.stack([logits[i] for i in valid]), ref)
    check(head_err <= IMAGE_F32_REL, f"keras (e): head vs its float64 reference relative error {head_err:.3e}")
    check(flash_attention.launches == 0, f"keras: {flash_attention.launches} flash launches on a CNN path")
    card = f"{device_name} ({_smi()})"
    for name, (rows, dt, snap) in results.items():
        host = snap["timers"].get("transform.host_batch", {"count": 0, "total_s": 0.0})
        per_batch = 1e3 * host["total_s"] / max(1, host["count"])
        print(f"keras {name} on {card}: {len(valid)} images in {dt:.3f} s = {len(valid) / dt:.1f} images/s; "
              f"host batch stage {per_batch:.1f} ms per batch over {host['count']} batches; "
              f"image.pil_decodes {int(snap['counters'].get('image.pil_decodes', 0))}")
    print(f"keras (e) KerasTransformer({KERAS_HEAD}) over (a)'s column on {card}: {len(valid)} rows in "
          f"{head_s:.3f} s = {len(valid) / head_s:.1f} rows/s; vs its float64 reference relative error "
          f"{head_err:.3e} (limit {IMAGE_F32_REL})")
    row_max = stack(a, valid).max(axis=1)
    print(f"keras: median row-max probability {float(np.median(row_max)):.5f} (min {float(row_max.min()):.5f}, "
          f"max {float(row_max.max()):.5f}; 1.0 would be a saturated softmax, 0.001 a flat one); card vs CPU over "
          f"{len(sample)} rows ({len(png_rows)} PNG, CPU {cpu_s:.2f} s) relative error {cpu_err:.3e} (limit "
          f"{IMAGE_F32_REL}); (a) vs (d) {err_ad:.3e} (limit {KERAS_ARM_REL}); (b) vs (c) max abs {err_bc:.3e} "
          f"(limit {KERAS_LOADER_ATOL}); (a) vs (b) on the {KERAS_SIDE}x{KERAS_SIDE} PNG rows {err_png:.3e} "
          f"(limit {IMAGE_F32_REL}), not gated: JPEG rows max abs {ab_max['jpeg']:.3e}, resized PNG rows "
          f"{ab_max['png resized']:.3e}; null rows null; flash launches 0")
    metrics.reset()
    wall, busy, by_kernel = _profiled(lambda: fused.transform(df).collect())
    host = metrics.snapshot()["timers"].get("transform.host_batch", {"count": 0, "total_s": 0.0})
    print(f"keras profiled pass of (a): wall {wall:.3f} s, device busy {busy:.3f} s (share {busy / wall:.3f}); "
          f"host batch stage {1e3 * host['total_s'] / max(1, host['count']):.1f} ms per batch")
    for name, sec in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]:
        print(f"  device {sec:.4f} s  {name[:90]}")
    shutdown_feeders()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _resnet50_config(head: int = None, headless: bool = False) -> dict:
    """The committed Keras ResNet50 config; ``head`` re-sizes the softmax,
    ``headless`` ends the model at ``avg_pool`` (the pooled features)."""
    with open(KERAS_CONFIG) as f:
        config = json.load(f)
    if headless:
        config["layers"] = [l for l in config["layers"] if l["name"] != "predictions"]
        config["output_layers"] = ["avg_pool", 0, 0]
    elif head is not None:
        config["layers"][-1]["config"]["units"] = head
    return config


def phase_keras_files(device) -> None:
    """15(a): the committed fixtures through the port's HDF5 reader."""
    import importlib.util

    have = {name: importlib.util.find_spec(name) is not None for name in ("h5py", "keras")}
    t0 = time.perf_counter()
    archive = read_keras_file(os.path.join(FIXTURES, f"{FIXTURE_MODEL}.keras"))
    legacy = read_keras_file(os.path.join(FIXTURES, f"{FIXTURE_MODEL}.h5"))
    config = archive.get_config()
    layers = [(layer["class_name"], path) for path, _, layer, _ in walk_layers(config)]
    weights = read_keras_weights(os.path.join(FIXTURES, f"{FIXTURE_MODEL}.weights.h5"), layers)
    read_s = time.perf_counter() - t0
    stored = np.load(os.path.join(FIXTURES, f"{FIXTURE_MODEL}_io.npz"))
    x, y = stored["x"], stored["y"]
    errs = {}
    for layout, spec in (("keras", archive), ("h5", legacy), ("weights.h5", KerasModelSpec(config, weights))):
        mf = ModelIngest.from_keras(spec, device=device)
        out = mf(torch.from_numpy(x).permute(0, 3, 1, 2).to(device)).cpu().numpy()
        check(out.shape == y.shape, f"keras files {layout}: output {out.shape}, stored {y.shape}")
        errs[layout] = _relative_error(out, y)
        check(errs[layout] <= IMAGE_F32_REL, f"keras files {layout}: {errs[layout]:.3e} off the stored Keras output")
    print(f"keras files (15a): h5py importable {have['h5py']}, keras importable {have['keras']}; the three "
          f"fixtures read by the port's HDF5 reader in {read_s:.3f} s; each model built on {device} against the "
          f"stored Keras output, relative error " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (limit {IMAGE_F32_REL})")


def phase_registry_weights(seed: int, device, tmp: str, structs) -> str:
    """15(b): a seeded Keras ResNet50 through load_keras_weights into the
    registry ResNet50; returns the written weights file."""
    config = _resnet50_config()
    spec = KerasModelSpec(config, _seeded_keras_weights(config, seed))
    t0 = time.perf_counter()
    tree = load_keras_weights("ResNet50", spec)
    path = os.path.join(tmp, "resnet50_from_keras.npz")
    save_flax_weights(tree, path)
    map_s = time.perf_counter() - t0
    feat = _featurizer("ResNet50", "float32", path, device=device)
    ours, _ = _featurize(feat, DataFrame.fromColumns({"image": structs}, numPartitions=IMAGE_PARTITIONS))
    headless = _resnet50_config(headless=True)
    graph = ModelIngest.from_keras(KerasModelSpec(headless, collect_weights(spec)), device=device)
    keras_stage = ImageModelTransformer(inputCol="image", outputCol="features", modelFunction=graph,
                                        preprocessing="caffe", batchSize=IMAGE_BATCH)
    theirs = [r["features"] for r in keras_stage.transform(
        DataFrame.fromColumns({"image": structs}, numPartitions=IMAGE_PARTITIONS)).collect()]
    _sync(device)
    a, b = np.stack(ours), np.stack(theirs)
    check(a.shape == b.shape == (len(structs), 2048), f"registry weights: shapes {a.shape} {b.shape}")
    err = _relative_error(a, b)
    check(err <= IMAGE_F32_REL, f"registry weights: featurizer vs the Keras graph {err:.3e}")
    print(f"registry weights (15b): Keras ResNet50 spec -> load_keras_weights -> {len(tree['params'])} flax "
          f"modules in {map_s:.2f} s; DeepImageFeaturizer(ResNet50, weightsFile) vs the translated Keras graph's "
          f"avg_pool over {len(structs)} rows on {device}: relative error {err:.3e} (limit {IMAGE_F32_REL})")
    del feat, graph, keras_stage
    return path


def _palette_images(seed: int, n: int, side: int):
    """``n`` caffe-normalized (BGR minus the mean) float32 NHWC images in
    FT_CLASSES colour classes with noise, by URI; and their labels."""
    rng = np.random.default_rng(seed + 15)
    palette = rng.integers(30, 226, size=(FT_CLASSES, 3))
    images, labels = {}, []
    for i in range(n):
        label = i % FT_CLASSES
        noise = rng.integers(-NOISE, NOISE + 1, size=(side, side, 3))
        bgr = np.clip(palette[label] + noise, 0, 255).astype(np.float32)
        images[f"synthetic/{i}"] = bgr - CAFFE_MEAN_BGR
        labels.append(label)
    return images, labels


def _fit_steps(spec, device, dtype, x, y, seed):
    """The estimator's first steps, alone: a fresh module of ``spec`` on
    ``device`` in ``dtype``, one epoch over ``x``; its weights after, by
    (layer path, index), in ``dtype``."""
    module = KerasModule(spec.get_config(), spec).to(device=device, dtype=dtype)
    keras_fit.fit(module, x.astype(np.float64) if dtype == torch.float64 else x,
                  y.astype(np.float64) if dtype == torch.float64 else y, optimizer="adam",
                  loss="categorical_crossentropy", params={"epochs": 1, "batch_size": FT_BATCH, "shuffle": False},
                  seed=seed)
    out = spec_from_module(module)
    return {(path, i): a for path, arrays in collect_weights(out).items() for i, a in enumerate(arrays)}


def phase_keras_training(seed: int, device_name: str, device="cuda") -> None:
    """15(c): ImageFileEstimator fine-tunes the Keras ResNet50."""
    from torch.profiler import ProfilerActivity, profile

    config = _resnet50_config(head=FT_CLASSES)
    spec = KerasModelSpec(config, _seeded_keras_weights(config, seed))
    t0 = time.perf_counter()
    images, labels = _palette_images(seed, FT_IMAGES, KERAS_SIDE)
    df = DataFrame.fromColumns({"uri": list(images), "label": labels}, numPartitions=FT_PARTITIONS)
    print(f"keras training (15c): {FT_IMAGES} synthetic {KERAS_SIDE}x{KERAS_SIDE} images in {FT_CLASSES} colour "
          f"classes in {time.perf_counter() - t0:.2f} s (host); Keras ResNet50 with a {FT_CLASSES}-way head, "
          f"seeded; kerasFitParams {FT_FIT}, adam, categorical_crossentropy")
    est = ImageFileEstimator(inputCol="uri", outputCol="probs", labelCol="label", model=spec,
                             imageLoader=images.__getitem__, kerasOptimizer="adam",
                             kerasLoss="categorical_crossentropy", kerasFitParams=FT_FIT, batchSize=FT_BATCH,
                             device=device, seed=seed)
    t0 = time.perf_counter()
    model = est.fit(df)
    fit_s = time.perf_counter() - t0
    hist = model.history
    steps = -(-FT_IMAGES // FT_BATCH)
    check(hist["steps"] == [steps] * FT_FIT["epochs"], f"keras training: steps {hist['steps']}")
    check(all(np.isfinite(hist["loss"])), f"keras training: losses {hist['loss']}")
    step_ms = hist["epoch_time_s"][-1] / steps * 1e3
    few = DataFrame.fromColumns({"uri": list(images)[:FT_BATCH * 2]}, numPartitions=2)
    probs = [r["probs"] for r in model.transform(few).collect()]
    check(all(p is not None and p.shape == (FT_CLASSES,) and abs(float(p.astype(np.float64).sum()) - 1) <= 1e-5
              for p in probs), "keras training: the trained transformer's rows are not 10-way probabilities")
    print(f"keras training on {device_name} ({_smi()}): fit {fit_s:.2f} s (features materialized and the model "
          f"built included); losses {[round(v, 4) for v in hist['loss']]}; epoch {FT_FIT['epochs']} "
          f"{hist['epoch_time_s'][-1]:.3f} s = {step_ms:.2f} ms per step = {FT_IMAGES / hist['epoch_time_s'][-1]:.1f} "
          f"images/s (epoch 1 {hist['epoch_time_s'][0]:.3f} s, the first step's set-up included)")
    x = np.stack([images[u] for u in list(images)[:FT_PROFILE_ROWS]])
    y = np.eye(FT_CLASSES, dtype=np.float32)[labels[:FT_PROFILE_ROWS]]
    module = KerasModule(spec.get_config(), spec).to(device, memory_format=torch.channels_last)
    keras_fit.fit(module, x[:FT_BATCH], y[:FT_BATCH], params={"epochs": 1, "batch_size": FT_BATCH}, seed=seed)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        keras_fit.fit(module, x, y, params={"epochs": 1, "batch_size": FT_BATCH, "shuffle": False}, seed=seed)
        _sync(device)
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy = sum(sec for sec, _ in kernels.values())
    check(busy > 0, "the profiler saw no device time")
    n_steps = -(-FT_PROFILE_ROWS // FT_BATCH)
    print(f"keras training profiled 1-epoch fit over {FT_PROFILE_ROWS} rows: wall {wall:.3f} s, device busy "
          f"{busy:.3f} s (share {busy / wall:.3f}; {busy / n_steps * 1e3:.2f} ms per step)")
    for name, (sec, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:5]:
        print(f"  device {sec:.4f} s  x{n}  {name[:90]}")
    del module, model, est
    torch.cuda.empty_cache()
    # the first steps on the card, on the CPU and in float64 on the card
    rows = FT_CHECK_STEPS * FT_BATCH
    x, y = x[:rows], y[:rows]
    t0 = time.perf_counter()
    card = _fit_steps(spec, device, torch.float32, x, y, seed)
    t_card = time.perf_counter() - t0
    cpu = _fit_steps(spec, "cpu", torch.float32, x, y, seed)
    t_cpu = time.perf_counter() - t0 - t_card
    ref = _fit_steps(spec, device, torch.float64, x, y, seed)
    torch.cuda.empty_cache()

    def rel(a, key):
        return float(np.abs(a[key].astype(np.float64) - ref[key]).max() / max(np.abs(ref[key]).max(), 1e-300))

    errs = {k: (rel(card, k), rel(cpu, k)) for k in ref}
    over = [k for k, (c, p) in errs.items() if c > FT_REL + FT_NOISE * p]
    worst_card = max((c, k) for k, (c, _) in errs.items())
    worst_cpu = max((p, k) for k, (_, p) in errs.items())
    card_vs_cpu = max(float(np.abs(card[k] - cpu[k]).max() / max(np.abs(cpu[k]).max(), 1e-30)) for k in cpu)
    print(f"keras training: the first {FT_CHECK_STEPS} steps ({rows} rows; card {t_card:.2f} s, CPU {t_cpu:.2f} s) "
          f"against float64 on the card, each of {len(errs)} tensors (weights and moving statistics) relative to "
          f"its max: card worst {worst_card[0]:.3e} ({worst_card[1]}), CPU worst {worst_cpu[0]:.3e} "
          f"({worst_cpu[1]}); card vs CPU worst {card_vs_cpu:.3e}; tensors where the card exceeds {FT_REL} + "
          f"{FT_NOISE} x the CPU's error: {len(over)}")
    check(not over, f"keras training: card steps off float64 beyond the CPU's float32 error in {over[:5]}")


def phase_device_preproc(seed: int, device_name: str, weights: str, device="cuda") -> None:
    """15(d): DeepImageFeaturizer over 320x320 sources, the resize on the
    card (SPARKDL_DEVICE_PREPROC=1) and on the host (0)."""
    structs, _ = _colour_structs(seed, PREPROC_IMAGES, PREPROC_SIDE)
    df = DataFrame.fromColumns({"image": structs}, numPartitions=IMAGE_PARTITIONS)
    warm = DataFrame.fromColumns({"image": structs[:IMAGE_BATCH]}, numPartitions=1)
    feat = _featurizer("ResNet50", "float32", weights, device=device)
    rows, rate, share = {}, {}, {}
    for arm in ("1", "0"):
        os.environ["SPARKDL_DEVICE_PREPROC"] = arm
        try:
            _featurize(feat, warm)
            rows[arm], dt = _featurize(feat, df)
            rate[arm] = len(structs) / dt
            wall, busy, _ = _profiled_pass(feat, df)
            share[arm] = busy / wall
        finally:
            os.environ.pop("SPARKDL_DEVICE_PREPROC")
    built = [k[-1] for k in feat._inner().__dict__.get("_device_fn_cache", {})]
    check((PREPROC_SIDE, PREPROC_SIDE) in built, f"device preproc: no device fn for the 320x320 source: {built}")
    for arm, out in rows.items():
        check(all(r is not None and r.shape == (2048,) and np.isfinite(r).all() for r in out),
              f"device preproc arm {arm}: rows are not finite 2048-vectors")
    sample = np.linspace(0, len(structs) - 1, PREPROC_CPU_ROWS).round().astype(int).tolist()
    os.environ["SPARKDL_DEVICE_PREPROC"] = "1"
    try:
        cpu, _ = _featurize(_featurizer("ResNet50", "float32", weights, device="cpu"),
                            DataFrame.fromColumns({"image": [structs[i] for i in sample]}))
    finally:
        os.environ.pop("SPARKDL_DEVICE_PREPROC")
    err = _relative_error(np.stack([rows["1"][i] for i in sample]), np.stack(cpu))
    check(err <= IMAGE_F32_REL, f"device preproc: the card's arm vs the CPU's {err:.3e}")
    arms = _relative_error(np.stack(rows["1"]), np.stack(rows["0"]))
    print(f"device preproc (15d) DeepImageFeaturizer(ResNet50) f32 over {len(structs)} structs at "
          f"{PREPROC_SIDE}x{PREPROC_SIDE} on {device_name} ({_smi()}): SPARKDL_DEVICE_PREPROC=1 (uint8 rows "
          f"shipped at the source geometry, resized on the card) {rate['1']:.1f} images/s, busy share {share['1']:.3f}; =0 (PIL "
          f"resize on the host) {rate['0']:.1f} images/s, busy share {share['0']:.3f}; device arm vs the CPU over "
          f"{len(sample)} rows relative error {err:.3e} (limit {IMAGE_F32_REL}); device vs host arm {arms:.3e} "
          f"(not gated: jax's antialiased bilinear against PIL's)")
    shutdown_feeders()


def phase_text_weights(seed: int, device_name: str, tmp: str, device="cuda") -> int:
    """15(e): bert-base from a flax .npz through weights_file; returns
    the flash launches of that run."""
    spec = get_model("bert-base")
    t0 = time.perf_counter()
    tree = bert_params_to_flax(spec.model_function(seed=seed, device="cpu").module)
    path = os.path.join(tmp, "bert_base.npz")
    save_flax_weights(tree, path)
    write_s = time.perf_counter() - t0
    texts = _texts(seed + 15, TEXT_WEIGHT_TEXTS)
    df = DataFrame.fromColumns({"text": texts}, numPartitions=4)
    from_file = spec.model_function(weights_file=path, device=device)
    flash_attention.launches = 0
    rows, dt, batches, _ = _embed(from_file, df)
    launches = flash_attention.launches
    del from_file
    from_params = spec.model_function(params=tree, device=device)
    ref, _, _, _ = _embed(from_params, df)
    del from_params
    torch.cuda.empty_cache()
    err = max(float(np.abs(a - b).max()) for a, b in zip(rows, ref))
    check(launches > 0 and launches == BERT_BASE_LAYERS * batches,
          f"text weights: {launches} flash launches for {batches} batches")
    check(err <= TEXT_WEIGHT_ATOL, f"text weights: weights_file rows off the params rows by {err:.3e}")
    print(f"text weights (15e): seeded bert-base written as a flax .npz in {write_s:.2f} s; TextEmbedder over "
          f"{len(texts)} texts on {device_name} from weights_file: {batches} batches, {launches} flash launches, "
          f"{dt:.3f} s; vs the model built from the same params max |diff| {err:.3e} (atol {TEXT_WEIGHT_ATOL})")
    return launches


def phase_keras_rest(seed: int, device_name: str, tmp: str) -> int:
    """Phase 15; returns 15(e)'s flash launches."""
    cuda = torch.device("cuda", torch.cuda.current_device())
    phase_keras_files(cuda)
    structs, _ = _colour_structs(seed, REGISTRY_ROWS, KERAS_SIDE)
    weights = phase_registry_weights(seed, cuda, tmp, structs)
    shutdown_feeders()
    phase_keras_training(seed, device_name, cuda)
    phase_device_preproc(seed, device_name, weights, cuda)
    return phase_text_weights(seed, device_name, tmp, cuda)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _hold_to_oracle(gen, prompt, served, tag: str) -> int:
    """Hold ``served`` tokens to the cacheless greedy oracle on ``gen``.
    A token that differs from the oracle's fails, unless it is a near-tie:
    the served token's oracle logit within ``GEN_TIE_REL`` x max |logit|
    of the oracle's top logit (so the oracle's top two are that close
    too). A near-tie is printed and the sequence compared up to it.
    Returns the tokens compared."""
    ids = [int(t) for t in prompt]
    for step, tok in enumerate(served):
        logits = _host(gen.oracle_logits(ids))
        want = int(np.argmax(logits))
        if tok != want:
            top2 = np.sort(logits)[-2:]
            limit = GEN_TIE_REL * float(np.abs(logits).max())
            behind = float(logits[want] - logits[tok])
            check(behind < limit,
                  f"{tag}: token {step} is {tok}, the oracle's is {want} ({behind:.3e} behind, "
                  f"near-tie limit {limit:.3e})")
            print(f"{tag}: near-tie at step {step}: oracle top-two gap {top2[1] - top2[0]:.3e} "
                  f"(limit {limit:.3e}), tokens {want} (oracle) and {tok} (served); compared up to it")
            return step
        ids.append(tok)
    return len(served)


def _wait_for(cond, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def phase_generator(seed: int, card: str):
    """16(a): ``BertGenerator`` over bert-base on the card, called
    directly: prefill and K/V against the CPU, decode against the
    cacheless recompute, greedy tokens against the oracle. Returns the
    generator (phase 16(b)'s oracle)."""
    from sparkdl_tpu_torch.text.bucketing import next_bucket

    spec = get_model(GEN_MODEL)
    t0 = time.perf_counter()
    gen = spec.generate_function(seed=seed, device=SERVE_DEVICE)
    cpu = spec.generate_function(params=bert_params_to_flax(gen.encoder), device="cpu")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 16)
    prompts = [rng.integers(4, spec.vocab_size, size=n).tolist() for n in GEN_PROMPTS]
    k_cache, v_cache = gen.new_cache(GEN_SLOTS)
    seqs, first_logits, worst = [], [], {"logits": 0.0, "k": 0.0, "v": 0.0}
    for slot, prompt in enumerate(prompts):
        width = min(next_bucket(len(prompt)), gen.max_length)
        ids = np.zeros((1, width), np.int64)
        ids[0, :len(prompt)] = prompt
        k, v, logits = gen.prefill(ids, len(prompt))
        ck, cv, clogits = cpu.prefill(ids, len(prompt))
        for name, a, b in (("logits", logits, clogits), ("k", k, ck), ("v", v, cv)):
            worst[name] = max(worst[name], _relative_error(_host(a), b.numpy()))
        gen.write_prefill(k_cache, v_cache, slot, k, v)
        first_logits.append(_host(logits[0]))
        seqs.append(list(prompt) + [int(torch.argmax(logits[0]))])
    del cpu
    for name, err in worst.items():
        check(err <= GEN_REL, f"generator: prefill {name} on the card off the CPU's by {err:.3e} (limit {GEN_REL})")
    step_err, step_ms = 0.0, []
    live = len(prompts)
    for _ in range(GEN_STEPS):
        tokens = np.zeros(GEN_SLOTS, np.int64)
        positions = np.zeros(GEN_SLOTS, np.int64)
        for slot, ids in enumerate(seqs):
            tokens[slot], positions[slot] = ids[-1], len(ids) - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, logits = gen.decode_step(k_cache, v_cache, tokens, positions)
        logits = _host(logits)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        for slot in range(live):
            step_err = max(step_err, _relative_error(logits[slot], _host(gen.oracle_logits(seqs[slot]))))
            seqs[slot].append(int(np.argmax(logits[slot])))
    check(step_err <= GEN_REL,
          f"generator: decode logits off the cacheless recompute by {step_err:.3e} (limit {GEN_REL})")
    compared = sum(
        _hold_to_oracle(gen, p, ids[len(p):], f"generator slot {slot} ({len(p)} tokens)")
        for slot, (p, ids) in enumerate(zip(prompts, seqs))
    )
    spread = np.mean([float(l.max() - l.min()) for l in first_logits])
    print(f"generator (16a): {GEN_MODEL} f32 built on the card and copied to the CPU in {build_s:.2f} s; prompts "
          f"{list(GEN_PROMPTS)} in slots 0-{live - 1} of a cache of {GEN_SLOTS} slots, {GEN_STEPS} batched decode steps "
          f"({np.mean(step_ms):.2f} ms mean per step, called directly, logits read back); prefill vs CPU relative "
          f"logits {worst['logits']:.3e} K {worst['k']:.3e} V {worst['v']:.3e}, decode vs cacheless recompute "
          f"{step_err:.3e} (limit {GEN_REL}); {compared} of {live * (GEN_STEPS + 1)} greedy tokens compared "
          f"equal to the oracle; prefill logits spread {spread:.3f} (mean max - min) on {card}")
    return gen


def _gen_flood(seed: int, spec, n: int):
    """``n`` seeded prompts, lengths in ``GEN_FLOOD_LENGTHS``."""
    rng = np.random.default_rng(seed + 17)
    lo, hi = GEN_FLOOD_LENGTHS
    return [rng.integers(4, spec.vocab_size, size=int(rng.integers(lo, hi + 1))).tolist() for _ in range(n)]


def _stream_generate(base: str, prompt, max_new: int):
    """One streamed ``POST /v1/predict`` (``"stream": true``): the tokens
    of the per-token records and the terminal record."""
    body = {"model": GEN_MODEL, "inputs": prompt, "mode": "generate", "max_new_tokens": max_new,
            "stream": True, "dtype": "int32"}
    req = urllib.request.Request(base + "/v1/predict", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        check(resp.headers.get("Transfer-Encoding") == "chunked", "generation: the stream is not chunked")
        records = [json.loads(line) for line in resp if line.strip()]
    check(records and records[-1].get("done") and "error" not in records[-1],
          f"generation: streamed reply ended with {records[-1] if records else None}")
    return [r["token"] for r in records[:-1]], records[-1]["tokens"][0]


def _timer_ms(name: str) -> str:
    t = metrics.timing(name)
    if t is None or not t.count:
        return "none"
    return f"mean {t.total_s / t.count:.2f} ms, p95 {t.percentile(95):.2f} ms (n={t.count})"


def phase_generation(seed: int, device_name: str) -> None:
    """Phase 16: generation on the card, (a) the generator, (b) a flood
    through the router and the HTTP server, (c) refusals."""
    from sparkdl_tpu_torch.serving import Router, ServingServer

    card = f"{device_name} ({_smi()})"
    shutdown_feeders()
    os.environ["SPARKDL_GEN_MAX_SEQS"] = str(GEN_SLOTS)
    for name in ("SPARKDL_SERVE_HBM_BUDGET_MB", "SPARKDL_GEN_MAX_NEW_TOKENS",
                 "SPARKDL_SERVE_PRECISION_BATCH"):
        os.environ.pop(name, None)
    flash_attention.launches = 0
    oracle = phase_generator(seed, card)
    check(flash_attention.launches == 0, f"generator: {flash_attention.launches} flash launches")

    # (b) the flood: warm up (the generator loads), then GEN_FLOOD greedy
    # requests at once, GEN_FLOOD_HTTP of them streamed over HTTP
    spec = get_model(GEN_MODEL)
    router = Router(seed=seed, device=SERVE_DEVICE)
    server = ServingServer(router, port=0)
    base = f"http://127.0.0.1:{server.port}"
    t0 = time.perf_counter()
    warm = router.submit(GEN_MODEL, np.arange(4, 20)[None], mode="generate",
                         gen_params={"max_new_tokens": GEN_FLOOD_NEW})
    warm.result(timeout=300)

    def idle():
        st = router.stats()["generation"]
        return st["active_seqs"] == 0 and st["pending_seqs"] == 0

    check(_wait_for(idle, GEN_IDLE_S), "generation: the stream did not go idle after the warm-up")
    torch.cuda.synchronize()
    allocated0 = torch.cuda.memory_allocated()
    warm_s = time.perf_counter() - t0
    prompts = _gen_flood(seed, spec, GEN_FLOOD)
    metrics.reset()
    flash_attention.launches = 0
    streamed = {}

    def over_http(i):
        streamed[i] = _stream_generate(base, prompts[i], GEN_FLOOD_NEW)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(GEN_FLOOD_HTTP) as pool:
        http = [pool.submit(over_http, i) for i in range(GEN_FLOOD_HTTP)]
        reqs = {
            i: router.submit(GEN_MODEL, np.asarray(prompts[i])[None], mode="generate",
                             gen_params={"max_new_tokens": GEN_FLOOD_NEW})
            for i in range(GEN_FLOOD_HTTP, GEN_FLOOD)
        }
        results = {i: np.asarray(r.result(timeout=300)).ravel().tolist() for i, r in reqs.items()}
        for f in http:
            f.result()
    wall = time.perf_counter() - t0
    for i, req in reqs.items():
        streamed[i] = ([tok for tok, _ in req.iter_tokens(timeout=1)], results[i])
    launches = flash_attention.launches
    counters = metrics.snapshot()["counters"]
    kv_peak = (metrics.gauge_stats("gen.kv_bytes") or {}).get("max", 0)
    prefill_ms, decode_ms = _timer_ms("gen.prefill_ms"), _timer_ms("gen.decode_step_ms")
    new_tokens = sum(len(done) for _, done in streamed.values())
    check(all(tokens == done for tokens, done in streamed.values()),
          "generation: streamed tokens differ from the request's result")
    check(all(len(done) == GEN_FLOOD_NEW for _, done in streamed.values()),
          "generation: a sequence ended early")
    check(counters.get("gen.joins", 0) > 0 and counters.get("gen.slot_reuse", 0) > 0,
          f"generation: joins {counters.get('gen.joins', 0)}, slot reuse {counters.get('gen.slot_reuse', 0)}")
    check(launches == 0, f"generation: {launches} flash launches")
    check(_wait_for(idle, GEN_IDLE_S), "generation: the stream did not go idle after the flood")
    check(router.residency.kv_reserved_bytes() == 0,
          f"generation: {router.residency.kv_reserved_bytes()} KV bytes still reserved")
    settled = _wait_for(lambda: torch.cuda.memory_allocated() == allocated0, GEN_IDLE_S)
    allocated1 = torch.cuda.memory_allocated()
    check(settled, f"generation: memory_allocated {allocated1} after the flood, {allocated0} before")
    t1 = time.perf_counter()
    compared = sum(
        _hold_to_oracle(oracle, prompts[i], streamed[i][1], f"generation request {i}") for i in range(GEN_FLOOD)
    )
    oracle_s = time.perf_counter() - t1
    print(f"generation (16b): Router + ServingServer on {router.device}, {GEN_MODEL} f32 from --seed, "
          f"SPARKDL_GEN_MAX_SEQS={GEN_SLOTS}; warm-up (load + one request) {warm_s:.2f} s; {GEN_FLOOD} greedy "
          f"requests at once (prompts {GEN_FLOOD_LENGTHS[0]}-{GEN_FLOOD_LENGTHS[1]} tokens, "
          f"max_new_tokens {GEN_FLOOD_NEW}, {GEN_FLOOD_HTTP} streamed over HTTP): {new_tokens} new tokens in "
          f"{wall:.3f} s = {new_tokens / wall:.1f} new tokens/s; prefill {prefill_ms}; decode step {decode_ms}; "
          f"decode steps {int(counters.get('gen.decode_steps', 0))}, joins {int(counters.get('gen.joins', 0))}, "
          f"slot reuse {int(counters.get('gen.slot_reuse', 0))}; gen.kv_bytes peak {int(kv_peak)} B; "
          f"memory_allocated {allocated0} B before and {allocated1} B after, idle; flash launches {launches}; "
          f"{compared} of {new_tokens} tokens compared equal to the cacheless oracle ({oracle_s:.2f} s) on {card}")

    # a profiled burst: every slot busy, then the decode steps to the end
    def burst():
        rs = [router.submit(GEN_MODEL, np.asarray(p)[None], mode="generate",
                            gen_params={"max_new_tokens": GEN_FLOOD_NEW}) for p in prompts[:GEN_PROFILED]]
        for r in rs:
            r.result(timeout=300)

    metrics.reset()
    wall_p, busy, by_kernel = _profiled(burst)
    steps = metrics.timing("gen.decode_step_ms")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    print(f"generation profiled burst: {GEN_PROFILED} requests x {GEN_FLOOD_NEW} tokens, "
          f"{steps.count if steps else 0} decode steps ({_timer_ms('gen.decode_step_ms')}), wall {wall_p:.3f} s, "
          f"device busy {busy:.4f} s = share {busy / wall_p:.3f}; top kernels: "
          + "; ".join(f"{k[:70]} {sec:.4f} s" for k, sec in top))

    # (c) refusals: an overlong prompt, then a KV budget that holds the
    # parameters and not one more reservation
    status, _, reply, _ = _post(base, {"model": GEN_MODEL, "inputs": list(range(4, 504)), "mode": "generate",
                                       "max_new_tokens": GEN_FLOOD_NEW, "dtype": "int32"})
    check(status == 400 and "position table" in reply.get("error", ""),
          f"generation: an overlong prompt got {status} {reply}")
    params = oracle.param_bytes
    one = spec.kv_bytes_per_token() * (16 + GEN_FLOOD_NEW)
    os.environ["SPARKDL_SERVE_HBM_BUDGET_MB"] = repr((params + one // 2) / 2**20)
    rejected0 = metrics.counter("gen.kv_rejected")
    try:
        status, headers, reply, _ = _post(base, {"model": GEN_MODEL, "inputs": list(range(4, 20)),
                                                 "mode": "generate", "max_new_tokens": GEN_FLOOD_NEW,
                                                 "dtype": "int32"})
    finally:
        os.environ.pop("SPARKDL_SERVE_HBM_BUDGET_MB")
    check(status == 429 and headers.get("Retry-After"), f"generation: over the KV budget got {status} {reply}")
    check(metrics.counter("gen.kv_rejected") == rejected0 + 1, "generation: the refusal was not counted")
    check(router.residency.kv_reserved_bytes() == 0,
          f"generation: {router.residency.kv_reserved_bytes()} KV bytes reserved after the refusal")
    stats = router.stats()["generation"]
    server.stop(close_router=True)
    print(f"generation (16c): {len(range(4, 504))} + {GEN_FLOOD_NEW} tokens > {spec.max_length}: HTTP 400; a budget "
          f"of {params} parameter bytes + {one // 2} (half of one {one}-byte reservation): HTTP 429, reserved KV "
          f"bytes back at 0; engine status {stats}; after close memory_allocated {torch.cuda.memory_allocated()} B")


def _events(path: str, kind: str) -> list:
    """The ``kind`` records of a JSONL event log."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [e for e in map(json.loads, f) if e.get("kind") == kind]


def _get(base: str, path: str):
    with urllib.request.urlopen(base + path, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _post_json(base: str, path: str, body: dict):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _text_spec_builder(size: str, offset: int = None):
    """A builder of the BERT preset ``size`` whose weights come from the
    router's seed + ``offset``; without an offset, one whose load fails."""
    base = _bert_text_builder(size)

    def build(spec, mode, dtype, seed, params, device):
        if offset is None:
            raise RuntimeError(f"{spec.name}: the canary's weights failed to load")
        return base(spec, mode=mode, dtype=dtype, seed=seed + offset, params=params, device=device)

    return build


def _small_vocab_builder(size: str, vocab: int, offset: int = 2):
    """A builder of the BERT preset ``size`` with an embedding table of
    ``vocab`` rows, weights from the router's seed + ``offset``."""
    from dataclasses import replace

    from sparkdl_tpu_torch.models.bert import BERT_CONFIGS

    def build(spec, mode, dtype, seed, params, device):
        name = f"{size}-v{vocab}"
        BERT_CONFIGS[name] = replace(BERT_CONFIGS[size], vocab_size=vocab)
        try:
            return _bert_text_builder(name)(spec, mode=mode, dtype=dtype, seed=seed + offset, params=params,
                                            device=device)
        finally:
            BERT_CONFIGS.pop(name, None)

    return build


def phase_control_plane(seed: int, device_name: str) -> None:
    """Phase 17: the serving control plane on the card: (a) the
    utilization and memory ledgers under a flood, (b) KV churn and an OOM
    record, (c) the SLO engine, (d) the canary, (e) out-of-vocabulary ids,
    then every byte back after the router closes."""
    from torch.profiler import ProfilerActivity, profile

    from sparkdl_tpu_torch.serving import Router, ServingClient, ServingServer
    from sparkdl_tpu_torch.serving.__main__ import serving_env_defaults

    card = f"{device_name} ({_smi()})"
    text_spec, image_spec = get_model(SERVE_TEXT_MODEL), get_model(SERVE_IMAGE_MODEL)
    for name in ("SPARKDL_SERVE_PRECISION_BATCH", "SPARKDL_SERVE_HBM_BUDGET_MB", "SPARKDL_OBS_JSONL",
                 *CP_SLO, "SPARKDL_SERVE_CANARY_MODEL", "SPARKDL_SERVE_CANARY_VERSION"):
        os.environ.pop(name, None)
    shutdown_feeders()
    serving_env_defaults()
    texts = _text_requests(seed + 17, text_spec, CP_TEXT_REQUESTS)
    images = _image_requests(seed + 17, image_spec, CP_IMAGE_REQUESTS)

    def text_body(ids, cls="interactive"):
        return {"model": SERVE_TEXT_MODEL, "inputs": ids.tolist(), "dtype": "int32", "mode": "embed",
                "priority": cls}

    # the leak records so far: the routers of phases 11 and 16 (phase 11
    # clears the cuBLAS workspaces between two of its routers) left none,
    # and no router of this phase may add one, the warm-up router's first
    # evicts included
    leaks0 = (mem_ledger.memory_status() or {}).get("leak_events", 0)
    check(leaks0 == 0, f"control plane: {leaks0} leak records from the earlier phases' routers: "
                       f"{[e for e in mem_ledger.get_ledger().events_tail(mem_ledger.mem_ring_capacity()) if e['op'] == 'leak']}")
    # the baseline: after a warm-up dispatch of each model (the launch
    # thread's cuBLAS workspace exists) and with nothing resident
    warm = Router(seed=seed, device=SERVE_DEVICE)
    warm.submit(SERVE_TEXT_MODEL, texts[0][0], mode="embed").result(timeout=300)
    warm.submit(SERVE_IMAGE_MODEL, images[0]).result(timeout=300)
    warm.close()
    shutdown_feeders()
    gc.collect()
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()
    jsonl = os.path.join(tempfile.mkdtemp(prefix="sparkdl_obs_"), "events.jsonl")
    os.environ["SPARKDL_OBS_JSONL"] = jsonl

    metrics.reset()
    router = Router(seed=seed, device=SERVE_DEVICE)
    server = ServingServer(router, port=0)
    client = ServingClient(router)
    base = f"http://127.0.0.1:{server.port}"
    t0 = time.perf_counter()
    for ids, cls in texts[:2]:
        status, _, reply, _ = _post(base, text_body(ids, cls))
        check(status == 200, f"control plane warm-up: HTTP {status} {reply}")
    client.predict(SERVE_IMAGE_MODEL, images[0], priority="interactive", timeout=300)
    print(f"control plane: router on {router.device}, {SERVE_TEXT_MODEL} and {SERVE_IMAGE_MODEL} f32 loaded in "
          f"{time.perf_counter() - t0:.2f} s, baseline memory_allocated {baseline} B")

    # (a) the flood: text over HTTP and images through the client, at once
    utilization.reset()
    flash_attention.launches_by_dtype = dict.fromkeys(flash_attention.launches_by_dtype, 0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with ThreadPoolExecutor(SERVE_CLIENT_THREADS) as pool:
            t_start = time.monotonic()
            text_f, image_f = [], []
            for i, (ids, cls) in enumerate(texts):  # two text requests, then an image one
                text_f.append(pool.submit(_post, base, text_body(ids, cls)))
                if i % 2:
                    image_f.append(pool.submit(
                        lambda x: client.predict(SERVE_IMAGE_MODEL, x, priority="batch", timeout=300),
                        images[i // 2]))
            replies = [f.result() for f in text_f]
            outs = [f.result() for f in image_f]
            t_end = time.monotonic()
        torch.cuda.synchronize()
    wall = t_end - t_start
    util = utilization.utilization_status(now=t_end)
    for (ids, _), (status, _, reply, _) in zip(texts, replies):
        rows = np.asarray(reply.get("outputs"), np.float32)
        check(status == 200 and rows.shape == (len(ids), text_spec.feature_dim) and np.isfinite(rows).all(),
              f"control plane flood: HTTP {status}, rows {rows.shape}")
    for x, out in zip(images, outs):
        check(out.shape == (len(x), image_spec.feature_dim) and np.isfinite(out).all(),
              f"control plane flood: image rows {out.shape}")
    launched = flash_attention.launches_by_dtype[torch.float32]
    recorded = _flash_kernel_counts(prof)[torch.float32]
    check(launched > 0 and launched == recorded,
          f"control plane: flash f32 launches counted {launched}, recorded by the profiler {recorded}")
    busy_prof = sum(sec for sec, _ in device_kernels(prof).values())
    dev = util["devices"]["0"]
    ledger_wall = (dev["busy_ms"] + dev["idle_ms"]) / 1e3
    tol = max(CP_CONSERVATION_ABS_S, CP_CONSERVATION_REL * wall)
    check(abs(ledger_wall - dev["wall_ms"] / 1e3) <= 5e-6, f"control plane: busy + idle != the ledger's wall: {dev}")
    check(dev["busy_ms"] > 0 and abs(ledger_wall - wall) <= tol,
          f"control plane: the ledger's busy + idle {ledger_wall:.4f} s against the flood's wall {wall:.4f} s "
          f"(tolerance {tol:.4f} s)")
    # the gauge is published unclamped: a FLOP count off by more than the
    # peak fails here
    mfu = metrics.gauge_stats("serve.mfu")
    check(mfu is not None and 0 < mfu["last"] <= 1, f"control plane: serve.mfu {mfu}")
    check(util["busy_source"] == utilization.BUSY_SOURCE, f"control plane: busy_source {util.get('busy_source')}")
    busy_frac = metrics.gauge_stats("util.busy_frac")["last"]
    status, mem = _get(base, "/v1/memory")
    charged = {}
    for m in router.stats()["models"]:
        charged[m["name"]] = charged.get(m["name"], 0) + m["param_bytes"]
    check(status == 200 and mem["models"] == charged,
          f"control plane: /v1/memory models {mem.get('models')} against residency's charges {charged}")
    check(mem["ground_truth_source"] == "memory_allocated" and mem["ground_truth_bytes"] > 0,
          f"control plane: ground truth {mem['ground_truth_bytes']} from {mem['ground_truth_source']}")
    estimate_error = {n: metrics.gauge_stats(f"mem.estimate_error.{n}") for n in charged}
    print(
        f"control plane (a) on {card}: {len(texts)} {SERVE_TEXT_MODEL} requests over HTTP and {len(images)} "
        f"{SERVE_IMAGE_MODEL} "
        f"through the client at once, f32, in {wall:.3f} s = {(len(texts) + len(images)) / wall:.1f} requests/s; "
        f"flash f32 launches {launched} (profiler {recorded}); utilization ledger busy {dev['busy_ms']:.3f} ms + idle "
        f"{dev['idle_ms']:.3f} ms = {ledger_wall:.4f} s against the flood's {wall:.4f} s (tolerance {tol:.4f} s), "
        f"h2d {dev['h2d_ms']:.3f} ms, d2h {dev['d2h_ms']:.3f} ms; util.busy_frac {busy_frac:.4f} (busy_source "
        f"{util['busy_source']}), the profiler's device busy {busy_prof:.4f} s = share {busy_prof / wall:.4f}; "
        f"serve.mfu {mfu['last']:.6f} (bf16 dense peak {PEAK_FLOP_PER_S['bf16']:.4g} FLOP/s; against the f32 peak "
        f"{PEAK_FLOP_PER_S['f32']:.4g} FLOP/s {mfu['last'] * PEAK_FLOP_PER_S['bf16'] / PEAK_FLOP_PER_S['f32']:.6f}); "
        f"/v1/memory: models {mem['models']} equal residency's charges, "
        f"tracked {mem['tracked_bytes']} B, watermark {mem['watermark_bytes']} B, ground truth "
        f"{mem['ground_truth_bytes']} B, mem.unattributed_bytes {mem['unattributed_bytes']} B, estimate errors "
        f"{ {n: (e['last'] if e else None) for n, e in estimate_error.items()} }"
    )

    # (b) KV churn, then an allocation refused under the budget
    kv0 = {k: metrics.counter(f"mem.{k}_bytes_total.kv_cache") for k in ("alloc", "free")}
    prompts = [np.arange(4 + i, 20 + i, dtype=np.int32)[None] for i in range(CP_GEN)]
    gens = [router.submit(SERVE_TEXT_MODEL, p, mode="generate", gen_params={"max_new_tokens": CP_GEN_NEW})
            for p in prompts]
    tokens = [g.result(timeout=300) for g in gens]
    check(all(t.shape == (1, CP_GEN_NEW) for t in tokens), "control plane: a generate request fell short")

    def kv_idle():
        st = mem_ledger.memory_status()
        return st["devices"]["0"]["kv_bytes"] == 0 and router.residency.kv_reserved_bytes() == 0

    check(_wait_for(kv_idle, GEN_IDLE_S), "control plane: kv_cache bytes still held once idle")
    kv = {k: metrics.counter(f"mem.{k}_bytes_total.kv_cache") - v for k, v in kv0.items()}
    check(kv["alloc"] == kv["free"] > 0, f"control plane: kv_cache allocated {kv['alloc']} B, freed {kv['free']} B")
    resident = sorted({m["name"] for m in router.stats()["models"]})
    os.environ["SPARKDL_SERVE_HBM_BUDGET_MB"] = "1"
    try:
        status, headers, reply, _ = _post(base, {"model": SERVE_TEXT_MODEL, "inputs": list(range(4, 20)),
                                                 "mode": "generate", "max_new_tokens": CP_GEN_NEW,
                                                 "dtype": "int32"})
    finally:
        os.environ.pop("SPARKDL_SERVE_HBM_BUDGET_MB")
    ooms = _events(jsonl, "oom")
    check(status == 429 and len(ooms) == 1 and sorted(ooms[0]["models"]) == resident,
          f"control plane: under a 1 MB budget HTTP {status} {reply}; oom events {ooms} (resident {resident})")
    print(f"control plane (b): {CP_GEN} generate requests x {CP_GEN_NEW} tokens: kv_cache allocated {kv['alloc']:.0f} B "
          f"and freed {kv['free']:.0f} B, 0 held once idle; under SPARKDL_SERVE_HBM_BUDGET_MB=1 a generate request got "
          f"HTTP 429 and one oom event (phase {ooms[0]['phase']}) naming {sorted(ooms[0]['models'])}, "
          f"watermark {ooms[0]['watermark_bytes']} B, {len(ooms[0]['recent_allocations'])} ring events")

    # (c) the SLO engine: a healthy batch flood trips nothing, an
    # impossible interactive p95 trips, the drained fast window recovers
    os.environ.update(CP_SLO)
    slo.reset()
    trips0 = metrics.counter("slo.trips.interactive")
    small = [(ids[:, :64], cls) for ids, cls in texts]
    with ThreadPoolExecutor(SERVE_CLIENT_THREADS) as pool:
        healthy = list(pool.map(lambda r: _post(base, text_body(r[0], "batch")), small[:CP_SLO_BATCH]))
    check(all(r[0] == 200 for r in healthy), "control plane: the healthy batch flood failed")
    _, st = _get(base, "/v1/slo")
    check(st["armed"] and "batch" in st["classes"] and not any(c["tripped"] for c in st["classes"].values())
          and st["windows"]["batch"]["ok_slow"] == CP_SLO_BATCH,
          f"control plane: after the healthy flood /v1/slo reads {st}")
    for ids, _ in small[:CP_SLO_INTERACTIVE]:
        check(_post(base, text_body(ids, "interactive"))[0] == 200, "control plane: an interactive request failed")
    _, tripped = _get(base, "/v1/slo")
    alerts = _events(jsonl, "slo_alert")
    check(tripped["classes"]["interactive"]["tripped"] and metrics.counter("slo.trips.interactive") - trips0 == 1
          and [a["cls"] for a in alerts] == ["interactive"],
          f"control plane: interactive did not trip: {tripped}, alerts {alerts}")
    time.sleep(float(CP_SLO["SPARKDL_SLO_FAST_S"]) * 1.25)
    _, recovered = _get(base, "/v1/slo")
    recoveries = _events(jsonl, "slo_recovery")
    check(not recovered["classes"]["interactive"]["tripped"] and [r["cls"] for r in recoveries] == ["interactive"],
          f"control plane: no recovery after the fast window drained: {recovered}, {recoveries}")
    hot = next(o for o in tripped["classes"]["interactive"]["objectives"] if o["objective"] == "latency_p95")
    print(f"control plane (c): {CP_SLO_BATCH} healthy batch requests tripped nothing; {CP_SLO_INTERACTIVE} "
          f"interactive requests against a {CP_SLO['SPARKDL_SLO_P95_MS_INTERACTIVE']} ms p95 tripped interactive "
          f"(burn fast {hot['burn_fast']}, slow {hot['burn_slow']}, observed p95 {hot.get('observed_p95_ms')} ms); "
          f"slo_alert {alerts[0]['objective']}, then slo_recovery after {CP_SLO['SPARKDL_SLO_FAST_S']} s")
    for name in CP_SLO:
        os.environ.pop(name)
    slo.reset()

    # (d) the canary: bert-base with other weights takes a quarter of the
    # traffic, then half; a canary that fails to load rolls back
    register_model(NamedTextModel(CP_CANARY, text_spec.max_length, text_spec.feature_dim,
                                  _text_spec_builder(text_spec.size, 1), vocab_size=text_spec.vocab_size,
                                  size=text_spec.size))
    register_model(NamedTextModel(CP_CANARY_BROKEN, text_spec.max_length, text_spec.feature_dim,
                                  _text_spec_builder(text_spec.size), vocab_size=text_spec.vocab_size,
                                  size=text_spec.size))
    os.environ.update({"SPARKDL_SERVE_CANARY_MODEL": SERVE_TEXT_MODEL, "SPARKDL_SERVE_CANARY_VERSION": CP_CANARY,
                       "SPARKDL_SERVE_CANARY_WEIGHT": str(CP_CANARY_WEIGHT)})
    canary_texts = _text_requests(seed + 18, text_spec, CP_CANARY_N + CP_CANARY_N2)
    # the canary version loads alone, named directly (a load measured
    # beside requests in flight would be charged their activations too)
    status, _, reply, _ = _post(base, {**text_body(canary_texts[0][0]), "model": CP_CANARY})
    check(status == 200, f"control plane: {CP_CANARY} named directly got {status} {reply}")

    def canary_burst(reqs):
        with ThreadPoolExecutor(SERVE_CLIENT_THREADS) as pool:
            out = list(pool.map(lambda r: _post(base, text_body(*r)), reqs))
        check(all(r[0] == 200 for r in out), f"control plane: a canary burst failed: {[r[0] for r in out]}")
        return out

    first = canary_burst(canary_texts[:CP_CANARY_N])
    status, widened = _post_json(base, "/admin/canary", {"weight": CP_CANARY_WIDENED})
    check(status == 200 and widened == {"weight": CP_CANARY_WIDENED, "tripped": False},
          f"control plane: POST /admin/canary replied {status} {widened}")
    second = canary_burst(canary_texts[CP_CANARY_N:])
    taken = [sum(r[2]["model"] == CP_CANARY for r in burst) for burst in (first, second)]
    check(abs(taken[0] - CP_CANARY_N * CP_CANARY_WEIGHT) <= 1 and abs(taken[1] - CP_CANARY_N2 * CP_CANARY_WIDENED) <= 1,
          f"control plane: the canary took {taken[0]} of {CP_CANARY_N} and {taken[1]} of {CP_CANARY_N2}")
    direct = {SERVE_TEXT_MODEL: _direct_fn(text_spec, "embed", torch.float32, seed),
              CP_CANARY: _direct_fn(get_model(CP_CANARY), "embed", torch.float32, seed)}
    worst = {name: 0.0 for name in direct}
    for (ids, _), (_, _, reply, _) in zip(canary_texts, first + second):
        want = _direct(direct[reply["model"]], ids, nhwc=False)
        worst[reply["model"]] = max(worst[reply["model"]],
                                    _relative_error(np.asarray(reply["outputs"], np.float32), want))
    primary_vs_canary = _relative_error(_direct(direct[CP_CANARY], canary_texts[0][0], nhwc=False),
                                        _direct(direct[SERVE_TEXT_MODEL], canary_texts[0][0], nhwc=False))
    del direct
    check(max(worst.values()) <= CP_CANARY_REL and primary_vs_canary > 1e-2,
          f"control plane: arms against their own models {worst} (limit {CP_CANARY_REL}), the two models differ "
          f"by {primary_vs_canary:.3e}")
    stats = router.stats()["canary"]
    # a canary with a smaller vocabulary, its table that size: a request
    # holding an id only the primary knows stays on the primary (in the
    # canary's gather it would be a device-side assert, the end of the
    # CUDA context), and the canary's share holds over the rest
    register_model(NamedTextModel(CP_CANARY_SMALL, text_spec.max_length, text_spec.feature_dim,
                                  _small_vocab_builder(text_spec.size, CP_SMALL_VOCAB),
                                  vocab_size=CP_SMALL_VOCAB, size=text_spec.size))
    os.environ["SPARKDL_SERVE_CANARY_VERSION"] = CP_CANARY_SMALL
    ineligible0 = metrics.counter("serve.canary.ineligible")
    routed = []
    for i, (ids, _) in enumerate(small[: 2 * CP_SMALL_N]):  # one at a time: the split's order is the list's
        ids = np.minimum(ids, CP_SMALL_VOCAB - 1)
        if i % 2 == 0:
            ids[0, 1] = CP_SMALL_VOCAB + 100
        status, _, reply, _ = _post(base, text_body(ids))
        rows = np.asarray(reply.get("outputs"), np.float32)
        routed.append((i % 2 == 0, status, reply.get("model"), bool(np.isfinite(rows).all())))
    small_taken = sum(m == CP_CANARY_SMALL for high, _, m, _ in routed if not high)
    ineligible = metrics.counter("serve.canary.ineligible") - ineligible0
    check(all(st == 200 and ok for _, st, _, ok in routed)
          and all(m == SERVE_TEXT_MODEL for high, _, m, _ in routed if high)
          and abs(small_taken - CP_SMALL_N * CP_CANARY_WIDENED) <= 1 and ineligible == CP_SMALL_N,
          f"control plane: the {CP_CANARY_SMALL} canary: {routed}, serve.canary.ineligible +{ineligible}")
    # the rollback arm: a router of its own, whose canary cannot load
    os.environ.update({"SPARKDL_SERVE_CANARY_VERSION": CP_CANARY_BROKEN,
                       "SPARKDL_SERVE_CANARY_WEIGHT": str(CP_CANARY_WIDENED),
                       "SPARKDL_SERVE_CANARY_MIN_REQUESTS": str(CP_CANARY_MIN)})
    rolled = Router(seed=seed, device=SERVE_DEVICE)
    rolled_server = ServingServer(rolled, port=0)
    rolled_base = f"http://127.0.0.1:{rolled_server.port}"
    rollbacks0 = metrics.counter("serve.canary.rollbacks")
    answers = []
    for ids, _ in small[: 4 * CP_CANARY_MIN]:  # one at a time: each failure lands before the next admission
        status, _, reply, _ = _post(rolled_base, text_body(ids))
        answers.append((status, reply.get("model")))
    rollback_events = _events(jsonl, "canary_rollback")
    rolled_server.stop(close_router=True)
    failed = [i for i, (status, _) in enumerate(answers) if status != 200]
    check(len(failed) == CP_CANARY_MIN and all(a == (200, SERVE_TEXT_MODEL) for a in answers[failed[-1] + 1:])
          and metrics.counter("serve.canary.rollbacks") - rollbacks0 == 1
          and [(e["version"], e["failures"]) for e in rollback_events] == [(CP_CANARY_BROKEN, CP_CANARY_MIN)],
          f"control plane: the broken canary's rollback: answers {answers}, events {rollback_events}")
    for name in ("SPARKDL_SERVE_CANARY_MODEL", "SPARKDL_SERVE_CANARY_VERSION", "SPARKDL_SERVE_CANARY_WEIGHT",
                 "SPARKDL_SERVE_CANARY_MIN_REQUESTS"):
        os.environ.pop(name)
    print(f"control plane (d): the canary took {taken[0]} of {CP_CANARY_N} at weight {CP_CANARY_WEIGHT} and "
          f"{taken[1]} of {CP_CANARY_N2} after POST /admin/canary {CP_CANARY_WIDENED}; each arm against its own "
          f"model, relative {worst} (limit {CP_CANARY_REL}; the models differ by {primary_vs_canary:.3e}); "
          f"router canary stats {stats}; a canary of {CP_SMALL_VOCAB} ids took {small_taken} of the {CP_SMALL_N} "
          f"requests it could serve and none of the {CP_SMALL_N} holding id {CP_SMALL_VOCAB + 100} "
          f"(serve.canary.ineligible +{ineligible:.0f}); the broken canary failed {len(failed)} requests (admissions {failed}), "
          f"rolled back once ({rollback_events[0]}) and the rest went to the primary")

    # (e) an out-of-vocabulary id (the vocabulary's size: 30522 for
    # bert-base): 400 on both paths, nothing reserved, and the CUDA
    # context still serves the same rows
    oov = text_spec.vocab_size
    probe = texts[3][0]
    _, _, before, _ = _post(base, text_body(probe))
    bad = probe.copy()
    bad[0, 1] = oov
    loads0 = metrics.counter("serve.model_loads")
    codes = []
    for body in (text_body(bad), {"model": SERVE_TEXT_MODEL, "inputs": [5, oov, 7], "mode": "generate",
                                  "max_new_tokens": 4, "dtype": "int32"}):
        status, _, reply, _ = _post(base, body)
        codes.append(status)
        check(status == 400 and str(oov) in reply["error"], f"control plane: id {oov} got {status} {reply}")
    check(router.residency.kv_reserved_bytes() == 0 and metrics.counter("serve.model_loads") == loads0,
          "control plane: a refused request reserved or loaded something")
    status, _, after, _ = _post(base, text_body(probe))
    gap = float(np.abs(np.asarray(after["outputs"]) - np.asarray(before["outputs"])).max())
    check(status == 200 and gap <= 1e-6 * float(np.abs(np.asarray(before["outputs"])).max()),
          f"control plane: after the refused ids HTTP {status}, rows moved by {gap}")
    print(f"control plane (e): id {oov} (vocabulary {text_spec.vocab_size}) embed and generate got HTTP "
          f"{codes}, no KV bytes or model loads; the next request served, max |diff| to its rows before {gap:.3e}")

    # every byte back: the ledger at 0, the allocator at the baseline, no leak
    server.stop(close_router=True)
    shutdown_feeders()
    gc.collect()
    torch.cuda.synchronize()
    final = mem_ledger.memory_status()
    truth = torch.cuda.memory_allocated()
    leaks = _events(jsonl, "mem_leak")
    leak_ring = [e for e in mem_ledger.get_ledger().events_tail(mem_ledger.mem_ring_capacity()) if e["op"] == "leak"]
    tol_bytes = mem_ledger.leak_tolerance_bytes()
    check(final["tracked_bytes"] == 0 and final["models"] == {} and abs(truth - baseline) <= tol_bytes
          and not leaks and final["leak_events"] == leaks0,
          f"control plane: after unload_all tracked {final['tracked_bytes']} B, models {final['models']}, "
          f"memory_allocated {truth} B against the baseline {baseline} B (tolerance {tol_bytes} B), leaks {leaks}, "
          f"leak records {leaks0} before this phase's routers and {final['leak_events']} after ({leak_ring})")
    print(f"control plane: after unload_all tracked 0 B, memory_allocated {truth} B against the baseline {baseline} B "
          f"(tolerance {tol_bytes} B), leak records {leaks0} before this phase's routers and {final['leak_events']} "
          f"after {leak_ring}, {final['oom_events']} oom events, watermark {final['watermark_bytes']} B")
    for name in ("SPARKDL_OBS_JSONL", "SPARKDL_FEEDER_IDLE_S", "SPARKDL_MAX_FEEDERS"):
        os.environ.pop(name, None)


def _direct_fn(spec, mode: str, dtype, seed: int):
    """The registry's ModelFunction of ``spec`` at ``dtype``, seeded as
    the serving loader seeds it."""
    return spec.model_function(mode=mode, dtype=dtype, seed=seed, device=SERVE_DEVICE)


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
    done("phase 10")
    phase_serving(args.seed, device_name)
    done("phase 11")
    with tempfile.TemporaryDirectory() as tmp:
        phase_training(args.seed, device_name, tmp)
    done("phase 12")
    phase_sql(args.seed, device_name)
    done("phase 13")
    with tempfile.TemporaryDirectory() as tmp:
        phase_keras_image(args.seed, device_name, tmp)
    done("phase 14")
    with tempfile.TemporaryDirectory() as tmp:
        text_weight_launches = phase_keras_rest(args.seed, device_name, tmp)
    done("phase 15")
    phase_generation(args.seed, device_name)
    done("phase 16")
    phase_control_plane(args.seed, device_name)
    done("phase 17")
    print(f"flash launches in 15(e) (bert-base from weights_file): {text_weight_launches}")
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
