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
    ``serve.mfu`` in (0, 1]; ``util.busy_frac`` read from NVML
    (``busy_source`` ``nvml``) over the ledger's window run on 2 s past the
    flood (NVML's reading trails it), within 0.15 of the profiler's busy
    share of that window, its busy seconds 0.5-1.5 times the profiler's;
    ``GET /v1/memory``'s per-model bytes equal to
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
    tracked bytes back to the launch thread's cuBLAS workspace (the ledger's
    ``workspace`` class; no model), memory_allocated back at the baseline within
    ``SPARKDL_MEM_LEAK_TOL_MB``, no ``mem_leak`` event, and no leak record
    in the ledger from any router of the run (phases 11, 16 and 17). ``serve.mfu``
    is checked as published, unclamped. About 25 s.
18. the supervised serving gang: an in-process ``ServingGateway`` over 2
    ``python -m sparkdl_tpu_torch.serving worker`` processes sharing the
    card (compute mode ``Default`` required, printed in phase 1), each with
    its own CUDA context, ``--seed`` and ``--budget-mb`` for every model of
    the flood, ``SPARKDL_SERVE_PRECISION_BATCH=bf16``,
    ``SPARKDL_LOCK_SANITIZER=1``, a canary ``bert-base-canary`` (weights
    from ``--seed`` + 1, through ``--loader
    sparkdl_tpu_torch.serving.canary_loader:loader``) at weight 0.25, and
    the fault plan ``site=serve.request:rank=0:request=<k>:crash`` with its
    claim in a temp dir, ``k`` rank 0's admission ordinal 24 requests into
    the flood. After each model and rung warmed once on each rank through
    the gateway: 96 bert-base ``embed`` requests (1-4 rows, widths 8-512,
    half interactive, half batch) and 32 ResNet50 f32 requests (1-2 NHWC
    224x224 rows), all over HTTP to the gateway from 8 threads, then a
    post-restart burst. Checks: (a) every request 200; (b) exactly one
    supervisor restart, then generation 1 with both ranks ready; (c) every
    row against the same model called directly in this process (bert-base
    f32 atol 1e-4, the bf16 rung against its own build atol 3e-2, ResNet50
    relative 1e-5; canary rows against the canary's model); (d) the
    canary's share of the bert-base replies within 0.25 +- 0.12; (e) both
    flash kernels launched in the workers, read from the gateway's
    federated ``/metrics`` (``kernel.flash_attention.launches.<dtype>``);
    (f) no ``locks.cycles`` in any worker; (g) ``POST /admin/drain
    {"rank": 1}``: rank 1 reads draining, a direct submit to it gets 503
    with ``Retry-After``, the gateway keeps answering 200, rank 1 exits 0
    and the gang reaches generation 2 with both ranks ready; (h) after
    ``stop()`` no worker process is alive and no thread of the phase is
    left. Prints requests/s beside phase 11's single process, p50/p95 per
    class, the crash-to-ready relaunch window (from the JSONL events)
    against ``SPARKDL_GATEWAY_PENDING_S``, each rank's ``util.busy_frac``
    (from NVML, ``busy_source`` ``nvml`` on every worker: the whole card's
    share; read at both ends of a 5 s window of steady bert-base load
    after the flood, above 0, within 0.15 of ``nvidia-smi``'s mean
    utilization sampled every 100 ms across it and 0.5-1.5 times it) and
    the fleet's verdict, and each fresh
    worker's ``GET /v1/memory`` beside ``nvidia-smi --query-compute-apps``.
    About 90 s.
19. the batch gang: ``python -m sparkdl_tpu_torch.worker`` ranks under
    ``python -m sparkdl_tpu_torch.resilience supervise --job`` on the
    card. (a) ``tests/fixtures/pyarrow_defaults.parquet`` (written by
    pyarrow with its defaults: Snappy, dictionary pages, 4 row groups, a
    null in every column kind, an image struct, a list and a
    FixedShapeTensor column) read by the port's reader equal to the values
    its seed regenerates with numpy (this machine has no pyarrow). (b)
    512 synthetic texts (phase 4's generator) written by the port's
    ``writeParquet`` in 8 partitions; a ``TextEmbedder`` (maxLength 512,
    batchSize 32) saved with ``persistence.save_stage``, whose bert-base
    f32 each rank builds from a seeded flax ``.npz`` (the job's ``model``
    builder); 2 ranks with ``heartbeat_dir`` and
    ``SPARKDL_FAULT_PLAN=site=worker.partition:rank=0:step=1:crash``.
    Checks: exactly one restart; generation 1 resumed rank 0's published
    partition 0; ``gather_results(out, 2)`` equal to this process's
    single-process transform row for row in global order (f32 atol
    1e-4); both ranks' ``obs.rank.<r>.json`` with
    ``kernel.flash_attention.launches.float32`` > 0. (c) the fitted
    ``DeepImageFeaturizer(ResNet50, f32) -> LogisticRegression``
    ``PipelineModel`` as a fault-free 2-rank job over 512 synthetic 224x224
    structs (about 77 MB of Parquet) in 8 partitions: predictions equal,
    features within relative 1e-5 of the single process. (d) a ``"type":
    "train"`` job at one rank (NCCL world 1): phase 12's ResNet50 from the
    ``chip_smoke:train_builder`` builder, 128 structs, 2 epochs of Adam at
    1e-4; its loss finite and lower at the last epoch's end than at the
    first's, and its ``trained_params.pkl`` equal to the same fit in this
    process (cuDNN deterministic in both) within atol 1e-5. Prints rows/s through the
    gang beside the single process, the crash-to-``_SUCCESS`` wall,
    partitions per rank and resumed partitions. About 150 s.
    Phases 6 and 8 also save the fitted featurizer -> LogisticRegression
    ``PipelineModel`` and load it back on the card: its predictions on the
    40 sampled rows equal the fitted one's. The text job's rank drops are
    kept for phase 20(d).
20. the int8-dynamic rung, on-demand profiling and the flight recorder.
    Phase 17 runs with ``SPARKDL_OBS_DUMP_DIR`` set, so its OOM (b) and its
    canary rollback (d) leave dumps. (a) One ``Router`` on the card behind
    ``ServingServer``, random weights from ``--seed``, with
    ``SPARKDL_SERVE_PRECISION_BACKGROUND=int8-dynamic`` (interactive stays
    f32): after a warm-up of each model at both rungs, 32 bert-base
    ``embed`` requests (1-4 rows, widths 8-512) and 16 ResNet50
    ``features`` requests (1-2 rows), half interactive and half
    background, over HTTP from 8 threads. Checks: every reply names its
    rung (``"precision"``); every row equal to that rung's own build
    called directly on the card (``serving.residency._default_loader``;
    bert-base atol 1e-4, ResNet50 relative 1e-5); the f32 flash kernel
    launched 12 times per bert-base dispatch of either rung, the bf16
    kernel never; the card's int8 values and scales of both models equal
    to the CPU port's quantizing the same f32 weights, exactly;
    ``/v1/models``' int8 entries under their f32 entries' bytes / 3.5 and
    ``/v1/memory`` equal to residency's charges; one direct int8 call on
    a [4, 512] batch raises ``max_memory_allocated`` by less than half the
    f32 parameter bytes (no whole-model f32 copy), with 12 flash launches
    by the wrapper's count and the profiler's (over ``counted_profile``,
    as phases 11 and 17 count theirs). Prints rows/s of the direct
    int8 and f32 builds on a [32, 128] batch and the int8 rows'
    row-relative error against f32 (random weights at bert-base width: not
    gated). (b) ``POST /admin/profile {"seconds": 2}`` while 4 threads send
    32 f32 bert-base requests: 200 with a run directory under
    ``SPARKDL_PROFILE_DIR`` whose ``trace.json`` parses and holds
    ``flash_f32_tf32x3_kernel`` kernel events; a second POST during the
    capture 409, ``{"seconds": -1}`` 400; one ``{"kind": "profile"}``
    event; every flood reply 200 and equal to the direct model (atol
    1e-4). (c) With ``SPARKDL_TRACE_SAMPLE=1`` and phase 17(c)'s SLO knobs,
    32 batch and 20 interactive requests trip ``interactive``: ``GET
    /v1/slo`` names its exemplars, each resolved by
    ``obs.trace.collect_trace`` with a waterfall whose segments sum to at
    most e2e + 1 ms; one new ``obs-slo_burn-*.json`` dump whose context
    names the class, whose exemplars equal the ``slo_alert`` event's
    ``exemplar_trace_ids`` (each resolving in the dump) and whose span ring
    holds the flood's dispatches; phase 17's ``obs-oom-*`` and
    ``obs-canary_rollback-*`` dumps exist; ``python -m
    sparkdl_tpu_torch.obs report``, ``trace <id>`` and ``chrome --out`` on
    the dump exit 0 and the Chrome file loads. (d) ``python -m
    sparkdl_tpu_torch.obs merge`` over phase 19's rank drops gives one
    Chrome trace with a lane per rank (2), and ``obs.serve.start_server(port=0)``
    answers 200 on ``/metrics``, ``/snapshot``, ``/series``, ``/slo`` and
    ``/healthz``. About 60 s.

21. TF model ingestion (``TFInputGraph``), without tensorflow or protobuf
    in the process. The frozen GraphDef of phase 14's Keras ResNet50 config
    (224x224, 1000 classes) with weights from ``--seed`` is written by
    ``tests/fixtures/tf_graph_writer.py`` (the nodes
    ``convert_variables_to_constants_v2`` gives: Conv2D, BiasAdd,
    FusedBatchNormV3, Relu, Pad, MaxPool, AddV2, Mean, MatMul, Softmax).
    (a) ``TFInputGraph.from_graph_def(bytes, ...)`` on the card, then
    ``TFImageTransformer(outputMode="vector", preprocessing="caffe")`` over
    phase 6's 1024 synthetic 224x224 BGR structs, 4 partitions, batch 32,
    f32, after a warm-up pass: images/s and NVML's busy share over the
    pass. (b) Every row against the port's ``KerasModule`` of the same
    config and weights on the card through ``ImageModelTransformer``, and
    16 rows against the translated graph on the CPU, both at relative 1e-5
    (TF32 off in both forwards). (c) One warm batch of 32 under
    torch.profiler: no device-to-host copy and no ``aten::_local_scalar_dense``
    inside the translated forward; its peak ``max_memory_allocated`` over
    the batch within ``TF_PEAK_RATIO`` of ``KerasModule``'s (the walk drops
    each value after its last use); the flash kernel launched 0 times in
    (a). (d) The committed small fixture (``tests/fixtures/tf_model``) as a
    frozen GraphDef, a SavedModel and a TF1 checkpoint through
    ``TFTransformer`` on the card: each equal to TF's stored outputs at
    relative 1e-5, and to each other. (e) ``tensorflow`` and
    ``google.protobuf`` absent from ``sys.modules``. About 5 s.

22. the rest of model ingestion: exported programs (``torch.export``, the
    flash kernel as the registered op ``sparkdl_tpu_torch::flash_attention``)
    and orbax checkpoints read without orbax. First the op's dispatch
    cost: host microseconds per call, warm, over 2000 calls at B=1 H=1
    L=64 Dh=64 bf16 (the kernel shorter than the call), of the registered
    op against the bare ctypes launch it wraps, and of the public
    ``flash_attention`` (its checks and mask reshape beside). (a) The bert-base text
    composite (``ids -> (ids, ids != 0)`` then the bf16 rung's model,
    weights from ``--seed``), L=128: ``ModelFunction.export`` with a
    symbolic batch, then ``ModelFunction.load`` in a child process (a fresh
    interpreter, which has not imported the op's module before ``load``)
    over the same 32 rows of ids: its rows against the direct composite in
    this process (max |diff|, limit the bf16 atol 3e-2, expected 0: the
    same ops and kernel), the loaded program's flash launches per dispatch
    from the child's counters (exactly 12), loaded and direct rows/s over
    20 warm dispatches each, export and load seconds, the artifact's MB.
    (b) The ModelFunction ``DeepImageFeaturizer("ResNet50")`` applies
    (f32, 224x224, seeded weights), exported and loaded here: rows against
    the direct function over one batch of 32 (relative 1e-6), its conv
    weights ``channels_last`` on the card, loaded and direct images/s over
    20 batches, seconds and MB. (c) The committed orbax fixture
    (``tests/fixtures/orbax_model``: a 2-layer BERT, hidden 32, one head of
    32, saved by orbax's ``StandardCheckpointer``) read on the card through
    ``ModelIngest.from_orbax_checkpoint`` with the flash kernel: rows
    against the JAX outputs stored beside it (1e-5 of their largest
    magnitude), 2 f32 flash launches per call, read seconds and the zstd
    decoder's rate over the fixture's compressed values. (d) The bf16
    GraphDef fixture (``tests/fixtures/tf_bf16``: ``BiasAdd(MatMul(x, W),
    b)``, W and b bfloat16 constants) on the card: a bfloat16 result,
    within one bf16 step of its largest magnitude of the JAX outputs
    stored beside it. (e) A bert-base checkpoint at full width, written in
    orbax's ``use_ocdbt=False`` layout with arrays uncompressed
    (``tests/fixtures/orbax_writer.py``, held against orbax's ``restore``
    in the CPU tests) from the seeded registry model, read back and bound
    through ``from_orbax_checkpoint`` on the card: read seconds and MB/s,
    hidden states equal to the model it was written from (max |diff| 0),
    12 f32 flash launches. Before (a), the registered op's host cost per
    warm call against the bare ctypes launch, in interleaved rounds. About
    70 s.
23. stages saved by the JAX package, and the row-expression dialect over
    model scores. (a) ``tests/fixtures/jax_stages/resnet50_lr`` (a
    ``PipelineModel`` of ``DeepImageFeaturizer(modelName="ResNet50")`` and
    a ``LogisticRegressionModel`` with ``w [2048, 2]``, saved by the JAX
    package; the card's machine has no JAX) loaded with
    ``persistence.load(path, device="cuda")``, its featurizer's
    ``weightsFile`` set to phase 6's seeded flax ``.npz`` and f32, over
    1024 synthetic 224x224 structs at batch 32: its rows equal to the
    port's own ``PipelineModel`` built with the same weights, ``w`` and
    ``b`` (max |diff| 0; one pipeline per partition, so both see the same
    batches), ``w``/``b`` bit-equal to the fixture's ``model.npz``,
    images/s beside phase 6's f32 rate; then ``keras_cnn/`` (a
    ``KerasImageFileTransformer`` whose model the JAX package embedded as
    ``model.keras``) over a few PNGs, equal to the port's transformer over
    ``tests/fixtures/keras_cnn.keras``. (b) ``TextEmbedder`` over
    ``get_model("bert-base")`` f32 (768 wide, 12 layers, seeded weights),
    maxLength 512, phase 4's synthetic texts (256), then one query through
    ``select``/``withColumn``/``where`` with Columns (``when``/
    ``otherwise``, ``cast``, ``coalesce`` over null tags, ``concat_ws``,
    ``round``/``sqrt``, ``aggregate`` and ``transform`` over the
    embedding array, ``eqNullSafe``, ``rlike``, ``isin``) and the same
    query through ``spark.sql`` (CASE, CAST, ``||``, IS DISTINCT FROM,
    RLIKE, IN): the two surfaces' rows equal, every numeric cell within
    1e-6 relative of numpy over the collected embeddings, exactly 12
    flash launches per bert-base dispatch. (c) Phase 13's MobileNetV2
    image UDF inside ``CASE WHEN label = 'a' THEN udf(image) END`` and
    inside ``coalesce(udf(image), array(-1.0))`` over 256 images and a
    null one: rows equal to the bare UDF's (relative 1e-5),
    ``sql.udf.batches`` printed. No builtin that reads the clock, the
    time zone, the locale or the user runs here. About 40 s.
24. the relational core of the SQL/DataFrame surface. (a)
    ``TextEmbedder`` over ``get_model("bert-base")`` f32 (768 wide, 12
    layers, seeded weights), maxLength 512, 256 of phase 4's texts with a
    seeded ``topic`` (five values and NULLs) and ``source``; a score per
    row computed from the embedding (the sum of its first 16 squares, in
    float64); a ``topics`` table with a key the texts lack and without one
    they have. Fifteen queries through ``spark.sql`` (over a CTE) and
    through the DataFrame/Column API: GROUP BY topic with ``count(*)``,
    ``avg``, ``min``, ``max``, ``stddev``, ``percentile_approx``,
    ``count(DISTINCT source)`` and ``FILTER (WHERE score > (SELECT
    avg(score) ...))``, HAVING and ORDER BY an aggregate; ROLLUP(topic,
    source); INNER, LEFT and FULL OUTER JOIN to ``topics``; a self-join
    under aliases; a scalar subquery, ``IN (SELECT ...)`` and EXISTS;
    UNION ALL, UNION, INTERSECT and EXCEPT of a top and a bottom slice;
    SELECT DISTINCT; LIMIT ... OFFSET. The two surfaces' rows equal, every
    aggregate within 1e-6 relative of numpy over the collected
    embeddings, join and set-operation row counts equal to numpy's,
    exactly 12 flash launches per bert-base dispatch; host seconds per
    query and surface, rows in and out. (b) Phase 13's MobileNetV2 UDF
    (batches of up to 32) over 256 images and a null one: ``GROUP BY label``
    with ``avg(element_at(udf(image), 1))``, the UDF's output joined to a
    labels table, and an ``IN (SELECT ...)`` filtering on the UDF's
    score: aggregates and scores within 1e-5 relative of the bare UDF
    query's rows, ``sql.udf.batches`` beside the bare query's, every query
    batched (at least ceil(rows / 32) batches, fewer than rows). About 20 s.
25. windows and generators of the SQL/DataFrame surface. (a)
    ``TextEmbedder`` over ``get_model("bert-base")`` f32, maxLength 512,
    phase 24's 256 texts on 4 partitions with its seeded ``topic`` and
    ``source``, its score (the sum of the first 16 squares of the
    embedding, in float64) and its ``topics`` table, plus a list column
    with NULL and empty cells; the same bert-base registered as the catalog
    UDF ``bert25`` (text in, tokenized and padded to 512, batches of 32).
    Fifteen queries through ``spark.sql`` (over a CTE) and through the
    Column API (``Window.partitionBy(...).orderBy(...)``,
    ``F.*().over(w)``): top-3 per topic by ``row_number()``; ``rank``,
    ``dense_rank``, ``percent_rank``, ``cume_dist`` and ``ntile(4)`` by
    source over ``round(score, 2)`` (ties on purpose); ``lag``/``lead`` by
    1 and 2 with defaults; ``first_value``/``last_value``/``nth_value``
    under the default frame and the whole partition; a running ``avg`` over
    ``ROWS BETWEEN 2 PRECEDING AND CURRENT ROW``; ``count``/``avg`` over
    ``RANGE BETWEEN 10 PRECEDING AND 10 FOLLOWING`` of id; ``score -
    avg(score) OVER (PARTITION BY topic)``; a window over the join to
    ``topics`` (``sql.pushdown.pruned_cols`` printed); ``rank() OVER
    (PARTITION BY topic ORDER BY <score of bert25(text)> DESC)``, the model
    running on the card inside the window's materialization;
    ``explode(split(text, ' '))`` grouped by word per topic, top 10, and
    its exploded row count; ``LATERAL VIEW OUTER posexplode`` chained with a
    second LATERAL VIEW, with ``e.*``; ``stack(2, ...)``; ``json_tuple`` over
    ``to_json(named_struct(id, topic, score))``. The two surfaces' rows
    equal; ranks, offsets, values, exploded rows and JSON cells equal to a
    Python computation over the collected scores (ties broken by id),
    window aggregates within 1e-6 relative of numpy, the engine's scores
    within 1e-12 of numpy's float64 sum, the UDF's scores within 1e-4 of
    the TextEmbedder's; the UDF batched (at least ceil(rows / 32) batches,
    fewer than rows, ``sql.udf.batches``) and exactly 12 flash launches per
    bert-base dispatch; host seconds per query and surface, rows in and
    out. (b) On the Column API: ``rand(7)``, ``randn(7)``,
    ``monotonically_increasing_id()`` and ``spark_partition_id()`` over the
    4-partition frame, equal to numpy's ``default_rng(SeedSequence([7,
    index]))`` draws per partition and to a second run. Host code but for
    bert-base. About 20 s.
26. the frame's statistics, NA, partitioning and file methods and the
    session's readers, writers, catalog and conf. (a) Phase 24's 256 texts
    with its seeded ``topic`` and ``source`` written with
    ``df.write.mode("overwrite").csv(path, header=True)`` and read back
    with ``spark.read.option("header", "true").csv`` on 4 partitions: the
    rows equal the written ones (ints as ints, NULL topics as None); then
    ``TextEmbedder`` over ``get_model("bert-base")`` f32, maxLength 512,
    on the frame read back, exactly 12 flash launches per dispatch, and
    phase 25's score (the sum of the first 16 squares of the embedding)
    with ``e0``, the embedding's first feature. (b) ``describe``,
    ``summary`` (the default statistics and ``10%``/``90%``),
    ``approxQuantile``, ``corr`` and ``cov`` of score and ``e0`` against
    numpy over the collected columns (summary and quantiles exactly, the
    moments within 1e-9 relative); ``crosstab(topic, source)`` and
    ``freqItems`` against a Python count; ``sample(0.3, 11)`` and
    ``sampleBy(topic, ..., 11)`` against numpy's draws (one stream in
    partition order, and ``default_rng(SeedSequence([11, index]))`` per
    partition); each ``df.stat`` call equal to its frame method. (c)
    ``dropna``, ``fillna``, ``na.replace`` and ``melt`` against Python over
    the rows; ``repartition(3)``, ``coalesce(2)`` and
    ``repartitionByRange(4, "score")`` keep the multiset of rows (the
    ranges in order), a seeded ``rand`` column equal through ``coalesce``,
    and no model dispatch from a lazy ``coalesce`` or one over the cached
    frame. (d) The scores and embeddings written with ``df.write`` as JSON
    lines and as Parquet (a second write in the default mode refused) and
    read back with ``spark.read.json``/``parquet``: rows equal, the float32
    embeddings bit-equal; ``createGlobalTempView("scores26")``, a ``GROUP
    BY topic`` on ``global_temp.scores26`` equal to the DataFrame surface's
    and to numpy; ``spark.catalog`` ``listTables("global_temp")``,
    ``listColumns``, ``tableExists``, then ``dropGlobalTempView``;
    ``spark.range(256)`` joined on ``id`` keeps 256 rows; ``spark.conf``
    set, then get. (e) bert-base as the catalog UDF ``bert26`` (padded to
    512, batches of 32) over the frame read back from JSON: its scores
    within 1e-4 of (a)'s, 12 flash launches per UDF batch. Prints host
    seconds per group, rows in and out and the bytes of each file. Host
    code but for bert-base. About 15 s.
27. sequence parallelism, the periodic rank snapshot and pandas. (a) A
    ``Heartbeat`` (beat 0.2 s, ``SPARKDL_OBS_SNAP_S=1``) around 4.5 s of
    bert-base f32 ``TextEmbedder`` passes over 64 texts: the
    writes of ``obs.rank.0.json`` (each write recorded with the file's
    mtime) number 4 to 8, the forced exit drop included, and ``python -m
    sparkdl_tpu_torch.obs merge`` gives rank 0's lane. (b) Without pandas
    (the card's machine): prints that item 8.1 is held on the CPU only,
    applying an ``F.pandas_udf`` raises ModuleNotFoundError naming pandas,
    and ``createDataFrame`` from a list and ``toDF`` run; with pandas,
    ``pandas_udf``, ``applyInPandas`` and ``toPandas`` over (a)'s scores
    equal numpy. (c) ``bert_model_function_sequence_parallel`` over an
    ``{"sp": 1}`` mesh at L=512, B=32, f32 and bf16: ring, and Ulysses
    over the flash kernel (12 launches per call), each within f32 1e-3 /
    bf16 3e-2 of the dense build on the same seeded weights, ms per call
    by CUDA events; ``ulysses_attention_sharded``
    with the flash inner at B=32 H=12 L=512 Dh=64 with a fully masked row
    (which comes out 0), against ``flash_attention_reference`` (f32 1e-4,
    bf16 3e-2), one launch per call counted and recorded by torch.profiler
    inside ``counted_profile``; ``TextEmbedder`` over the ring model and
    phase 4's 512 texts: no bucketing, ceil(rows / 32) batches per
    partition, rows equal to the direct calls (1e-4), rows/s. About 40 s.
28. tensor, pipeline and expert parallelism and gradients through
    sequence parallelism, each over a mesh axis of one process (one H100
    is one rank: NCCL refuses two ranks on one GPU; world sizes 2 and 4 run
    in the CPU tests over gloo). (a) ``tp_block_sharded`` over
    ``{"tp": 1}`` and ``{"dp": 1, "tp": 1}`` (``dp_axis="dp"``):
    bert-base's layer-0 FFN from ``--seed`` (768->3072->768, biases,
    BERT's GELU), x [16384, 768], f32 and bf16, the output and the grads
    of x, w1, w2, b1 and b2 within f32 1e-4 / bf16 3e-2 of the tensor's
    max of the plain two products; ms per call forward and
    forward+backward, the plain products' beside them. (b)
    ``pipeline_apply`` over ``{"pp": 1}``, one stage of bert-base's 12
    ``BertLayer``s over ``make_flash_attention_fn()``, no padding mask,
    x [32, 512, 768], 4 microbatches, f32 and bf16: equal to the layers
    called directly (f32 1e-4, bf16 3e-2), exactly 12 x 4 flash launches
    per call counted and recorded by torch.profiler inside
    ``counted_profile``; then ``backward()`` through the dense-attention
    build of the same layers, f32, the stage parameters' and x's grads
    within 1e-4 of the layers' own (relative to the largest); ms per
    call. (c) ``moe_apply`` over ``{"ep": 1}``: 8 experts of bert-base
    FFN width from ``--seed``, 8192 tokens of width 768, f32,
    ``capacity_factor`` 2.0 (C = 2048) within 1e-4 (relative) of a
    per-token oracle (each token through its routed expert times its
    gate); ``capacity`` 256: every dropped token exactly 0, their count
    printed, the kept ones on the oracle; ``backward()`` gives a finite,
    non-zero router gradient; ms per call. (d)
    ``bert_model_function_sequence_parallel`` (bert-base, f32, B=8,
    L=512) over ``{"sp": 1}``, ring and Ulysses with the dense inner:
    the gradients of every parameter of a weighted sum of the pooled
    embeddings within 1e-4 (relative to the largest) of the dense build's
    on the same seeded weights; the Ulysses-over-flash model's backward
    raises (the kernel has no backward); ms per forward+backward. About
    30 s.
29. StableHLO without JAX (``graph/mlir_bytecode.py``, ``stablehlo.py``,
    ``jax_exported.py``). (a) the committed keras-3 export of the 224x224
    ResNet50 (``tests/fixtures/keras3_resnet50``: one ``XlaCallModule``),
    its data shard rebuilt into a temp dir from the seeded weights its
    ``shard.json`` names (every entry's CRC-32C read back), ingested by
    ``ModelIngest.from_saved_model`` on the card and run through
    ``TFImageTransformer`` over phase 21's 1024 images at batch 64 (f32):
    images/s, NVML busy over the pass, zero flash launches, torch ops
    dispatched per batch (torch.profiler's top-level ``aten::`` ops) and
    the interpreter's ops per call; the rows within 1e-4 (relative) of
    ``ModelIngest.from_keras`` on the same weights, whose images/s is
    printed beside phase 21's translated GraphDef's. (b) the committed
    JAX ``ModelFunction.export`` of bert-tiny
    (``tests/fixtures/jax_bert_tiny``) through ``ModelFunction.load`` on
    the card at two batch sizes: within 1e-5 of the JAX outputs stored
    beside it and 1e-4 of the port's bert-tiny built from its
    ``params.pkl``, ms per call of each by CUDA events; zero flash
    launches from the loaded program. About 30 s.
30. the rest of ``keras.applications`` through the Keras translator
    (``graph/keras_graph.py``), at full width (224x224, 299x299 for
    InceptionResNetV2) from the configs committed in
    ``tests/fixtures/keras_apps/`` (no keras on the card's machine), under
    ``_keras_app_weights`` (seeded, the BatchNorm statistics those of the
    checked rows in a float64 pass, stored beside the configs). (a) EfficientNetB0
    (Rescaling and an adapted Normalization in the model) through
    ``KerasImageFileTransformer(preprocessing="none")`` over phase 14's
    kind of files (JPEGs, PNGs at 224x224 and resized, a corrupt file, a
    missing path, None), batch 64, f32: images/s of a warm pass,
    dispatches, null rows null, each row a probability vector. (b)
    EfficientNetV2B0, MobileNetV3Large, ConvNeXtTiny, NASNetMobile and
    InceptionResNetV2 by ``ModelIngest.from_keras`` on the card: each
    family's translate time and warm images/s at batch 32. For (a) and
    (b), the pooled features and logits (the classifier made linear) of
    the rows stored beside the configs against Keras's stored outputs,
    relative 1e-4. (c) a fine-tune of EfficientNetB0 with a 10-way head
    through ``estimators/keras_fit.py`` on the card (adam, batch 16, 4
    steps, its noise-shaped Dropouts drawing on the card): finite losses,
    the SE convs, BatchNorm gammas and moving statistics and the head
    changed, the Normalization's statistics not. Zero flash launches.
    About 60 s.
31. Keras sequence models through the translator
    (``graph/keras_graph.py``, ``graph/keras_seq.py``) from the configs
    committed in ``tests/fixtures/keras_seq/`` under
    ``_seeded_seq_weights``, each through ``KerasTransformer`` over a
    column of token ids (the default float32 input, cast back to ids as
    Keras casts it) in 4 partitions with a None cell, f32. (a) the keras-io
    "Bidirectional LSTM on IMDB" model at its published widths
    (``Embedding(20000, 128)``, two ``Bidirectional(LSTM(64))``,
    ``Dense(1, "sigmoid")``, maxlen 200) as published, with
    ``mask_zero=True``, and its GRU copy with the mask, over 1024 rows
    padded at the front (lengths 20-200), batch 64: rows/s, dispatches,
    every recurrent call of the pass on cuDNN's fused recurrence (the
    stored rows, one with a 0 inside its tokens, run the step loop under
    the mask), the masked LSTM's ms per batch by each route, and the
    first LSTM's gates off saturation. (b) an encoder at bert-base's
    published widths from core layers (``Embedding(30522, 768,
    mask_zero=True)``, 12 blocks of ``MultiHeadAttention(12, 64,
    dropout=0.1)``, Dropout, Add, ``LayerNormalization(1e-12)``,
    ``Dense(3072, "gelu")``, ``Dense(768)``, Dropout, Add,
    LayerNormalization; masked ``GlobalAveragePooling1D`` and
    ``Dense(2)``; no position embeddings) over 256 rows of 512 ids padded
    at the back, batch 32: rows/s, every MultiHeadAttention on the flash
    route (the first with the key mask; Keras's attention takes the masks
    off its inputs, so the later blocks run unmasked, as in Keras), 12
    flash launches per dispatch (the wrapper's count and the registry's),
    the kernel against its plain version on the q/k/v the model gives it
    (atol 1e-4) and timed there beside the plain version,
    ``F.scaled_dot_product_attention`` and the bound, and the first
    layer's attention off uniform. For (a) and (b), the outputs of the
    rows stored beside the configs (the IMDB logit; the encoder's sequence
    at 8 steps, padded query steps among them, and its logits) against
    Keras's stored outputs, relative 1e-4. About 30 s.

The line before the last is the ``kernels`` JSON record (the f32 and the
bf16 kernel at bert-base L=512, launches from each dtype's main-path run,
``launches_phase20``, phase 20(a)'s flood, and ``launches_phase22``,
phase 22(a)'s loaded program (bf16) and 22(c)'s and 22(e)'s orbax models
(f32), ``launches_phase23``, phase 23(b)'s bert-base pass (f32), and
``launches_phase24``, phase 24(a)'s (f32), ``launches_phase25``, phase
25(a)'s TextEmbedder and UDF dispatches (f32), ``launches_phase26``,
phase 26(a)'s and 26(e)'s (f32), ``launches_phase27``, phase 27(a)'s
TextEmbedder (f32) and 27(c)'s Ulysses models over the flash kernel (f32
and bf16), and ``launches_phase28``, phase 28(b)'s pipeline calls (f32 and
bf16), and ``launches_phase30``, phase 30's Keras applications (0), and
``launches_phase31``, phase 31(b)'s encoder (f32 and bf16, the latter 0)); the last line is ``{"ok":
true, "device": {...}}``. Phase 17's first check names each leak record
(model, bytes) from an events log (``SPARKDL_OBS_JSONL``) armed before
phase 11, which does not roll over as the ledger's ring does.
"""

from __future__ import annotations

import argparse
import gc
import gzip
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from dataclasses import replace

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
from sparkdl_tpu_torch.graph.ingest import ModelIngest, TFInputGraph
from sparkdl_tpu_torch.graph import keras_seq
from sparkdl_tpu_torch.graph.keras_file import read_keras_file, read_keras_weights
from sparkdl_tpu_torch.graph.keras_graph import (
    KerasModelSpec,
    KerasModule,
    collect_weights,
    layer_module,
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
from sparkdl_tpu_torch.models.registry import (
    BERT_CONFIGS, NamedTextModel, _bert_encoder, _bert_text_builder, register_model, save_flax_weights,
)
from sparkdl_tpu_torch.models.resnet import ResNet50
from sparkdl_tpu_torch.ops.flash_attention import (
    LAUNCH_COUNTERS,
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
from sparkdl_tpu_torch.runtime.device import clear_workspaces
from sparkdl_tpu_torch.runtime.feeder import shutdown_feeders
from sparkdl_tpu_torch.session import SparkSession
from sparkdl_tpu_torch.transformers.named_image import (
    DeepImageFeaturizer,
    DeepImagePredictor,
)
from sparkdl_tpu_torch.transformers.image_model import ImageModelTransformer, TFImageTransformer
from sparkdl_tpu_torch.transformers.keras_image import KerasImageFileTransformer
from sparkdl_tpu_torch.transformers.tensor import KerasTransformer, TFTransformer
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
KERAS_LN_GAMMA = (0.5, 1.5)
KERAS_LAYER_SCALE = (0.1, 0.5)  # LayerScale's gamma, far from its 1e-6 init
KERAS_NORM_MEAN = (0.4, 0.5)  # an adapted Normalization over [0, 1] pixels (EfficientNet's Rescaling(1/255))
KERAS_NORM_VAR = (0.04, 0.07)
KERAS_APPS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "keras_apps")
#: phase 30's families: (default side, input range). The first four carry
#: their preprocessing (Rescaling, Normalization) and take [0, 255] pixels;
#: NASNet and InceptionResNetV2 take 'tf'-preprocessed [-1, 1]
KERAS_APPS = {
    "EfficientNetB0": (224, (0.0, 255.0)),
    "EfficientNetV2B0": (224, (0.0, 255.0)),
    "MobileNetV3Large": (224, (0.0, 255.0)),
    "ConvNeXtTiny": (224, (0.0, 255.0)),
    "NASNetMobile": (224, (-1.0, 1.0)),
    "InceptionResNetV2": (299, (-1.0, 1.0)),
}
KERAS_APPS_SEED = 0  # the weights of the stored Keras outputs: _keras_app_weights(name, config)
#: each family's BatchNorm statistics (make_keras_apps_fixtures.bn_stats), by "<name>/<layer path>/mean" and ".../var"
KERAS_APPS_BN_STATS = os.path.join(KERAS_APPS_DIR, "bn_stats.npz")
KERAS_APPS_BN_GAMMA = (0.5, 1.5)
KERAS_APPS_INPUT_SEED = 0
KERAS_APPS_ROWS = 4  # rows of stored Keras outputs per family
KERAS_APPS_REL = 1e-4  # the card against the stored Keras outputs, relative: test_torch_keras_graph's APP_REL
KERAS_APPS_JPEGS = 256  # 30(a)'s JPEGs, beside phase 14's PNGs and null rows
KERAS_APPS_BATCH = 32  # 30(b)'s batch
KERAS_APPS_ITERS = 10  # 30(b)'s timed calls per family
KERAS_APPS_FT_ROWS = 64  # 30(c): 4 steps of 16
KERAS_APPS_FT_BATCH = 16
KERAS_ARM_REL = 1e-6  # the shared feeder's rows against the partitions' own
KERAS_LOADER_ATOL = 1e-5  # the fused path without the bridge against the numpy/PIL loader
KERAS_HEAD = (64, 10)
CAFFE_MEAN_BGR = np.array([103.939, 116.779, 123.68], np.float32)
# the headers the C++ image bridge includes; where both exist, it must build
BRIDGE_HEADERS = ("/usr/include/jpeglib.h", "/usr/include/png.h")

# phase 31: Keras sequence models through the translator (graph/keras_seq.py),
# from the configs committed in tests/fixtures/keras_seq/
# (make_keras_seq_fixtures.py): the keras-io "Bidirectional LSTM on IMDB"
# model as published, with mask_zero=True, its GRU copy, and an encoder at
# bert-base's published widths built from core Keras layers
KERAS_SEQ_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "keras_seq")
SEQ_IMDB_MODELS = ("imdb_bilstm", "imdb_bilstm_masked", "imdb_bigru_masked")
SEQ_BERT_MODEL = "bert_encoder"
#: keras.io/examples/nlp/bidirectional_lstm_imdb: max_features, the
#: Embedding's width, the LSTMs' units and maxlen
SEQ_IMDB = {"vocab": 20000, "width": 128, "units": 64, "maxlen": 200}
SEQ_IMDB_LENGTHS = (20, 200)  # pad_sequences' rows: padded at the front
#: uncased_L-12_H-768_A-12's bert_config.json (Devlin et al. 2018); no
#: position embeddings (core Keras has no such layer)
SEQ_BERT = {"vocab": 30522, "hidden": 768, "heads": 12, "head_dim": 64, "intermediate": 3072, "blocks": 12,
            "length": 512, "ln_eps": 1e-12, "dropout": 0.1}
SEQ_BERT_LENGTHS = (64, 512)  # BERT's rows: padded at the back (one stored row at the front)
SEQ_BERT_POSITIONS = (0, 1, 63, 64, 255, 256, 510, 511)  # the stored sequence outputs' steps
KERAS_SEQ_SEED = 0  # the weights of the stored Keras outputs: _seeded_seq_weights(config, 0)
KERAS_SEQ_INPUT_SEED = 0
KERAS_SEQ_ROWS = 4  # rows of stored Keras outputs per model
KERAS_SEQ_REL = 1e-4  # the card against the stored Keras outputs, relative: phase 30's limit
SEQ_EMB_STD = 1.0  # the tables' entries: N(0, 1)
SEQ_IMDB_ROWS, SEQ_IMDB_BATCH = 1024, 64  # 31(a): rows through KerasTransformer, its batch
SEQ_BERT_ROWS, SEQ_BERT_BATCH = 256, 32  # 31(b)
SEQ_PARTITIONS = 4
#: the seeded weights keep the gates and the attention away from their
#: saturated and uniform ends: the share of LSTM gate values in (0.01,
#: 0.99) at least, of those in (0.45, 0.55) at most, and the attention's
#: mean largest probability over valid keys between these multiples of
#: uniform and below one
SEQ_GATES_OPEN, SEQ_GATES_MID = 0.9, 0.5
SEQ_ATTN_PEAK = (2.0, 0.95)

# phase 21: TF model ingestion, ResNet50 as a frozen GraphDef
TF_IMAGES = 1024
TF_CPU_ROWS = 16
TF_PEAK_RATIO = 1.5  # the translated walk's peak memory over KerasModule's, one batch
TF_PARITY_REL = 1e-5  # the small fixture's three formats against TF's stored outputs
TF_MODEL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "tf_model")
# phase 22
EXPORT_TEXT_MODEL = "bert-base"
EXPORT_TEXT_LEN = 128
EXPORT_BATCH = 32
EXPORT_ITERS = 20
EXPORT_IMAGE_MODEL = "ResNet50"
EXPORT_IMAGE_REL = 1e-6
ORBAX_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "orbax_model")
ORBAX_ROW_TOL = 1e-5
TF_BF16_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "tf_bf16")
BF16_STEP = 2.0 ** -7
# phase 23: stages saved by the JAX package, and row expressions over scores
JAX_STAGES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "jax_stages")
X_IMAGES = 1024
X_TEXT_MODEL = "bert-base"
X_TEXTS = 256
X_MAX_LENGTH = 512
X_UDF_IMAGES = 256
X_UDF_REL = 1e-5
X_NUMPY_REL = 1e-6
X_KERAS_PNGS = 6
X_SQL = """
SELECT id,
  CASE WHEN aggregate(emb, 0.0, (acc, x) -> acc + x) / 768 > 0 THEN 'pos' ELSE 'neg' END AS sign,
  CAST(id AS STRING) || ':' || coalesce(tag, 'none') AS key,
  concat_ws('-', tag, CAST(id AS STRING)) AS label,
  round(sqrt(aggregate(emb, 0.0, (acc, x) -> acc + x * x)), 6) AS norm6,
  aggregate(emb, 0.0, (acc, x) -> acc + x) / 768 AS mean,
  element_at(transform(emb, x -> x * 2.0), 1) AS first2,
  CAST(id AS DOUBLE) / 3 AS third
FROM bert_scores
WHERE tag IS DISTINCT FROM 't3' AND text RLIKE '^w[0-9]' AND id % 4 IN (0, 1, 3)
ORDER BY id
"""
#: phase 6's images/s by (model, dtype), its shared-feeder arm
IMAGE_RATES: dict = {}

# phase 24: the relational core over bert-base scores and a model UDF
R_TEXT_MODEL = "bert-base"
R_TEXTS = 256
R_MAX_LENGTH = 512
R_NUMPY_REL = 1e-6
R_UDF_IMAGES = 256
R_UDF_BATCH = 32
R_UDF_REL = 1e-5

# phase 25: windows and generators over bert-base scores and a model UDF
W_TEXT_MODEL = "bert-base"
W_TEXTS = 256
W_MAX_LENGTH = 512
W_UDF_BATCH = 32
W_UDF_REL = 1e-4
W_NUMPY_REL = 1e-6
W_SEED = 7
# phase 26: the frame's statistics, NA, partitioning and files, the session
F_TEXT_MODEL = "bert-base"
F_TEXTS = 256
F_MAX_LENGTH = 512
F_UDF_BATCH = 32
F_UDF_REL = 1e-4  # the UDF's scores (every row padded to 512) against the TextEmbedder's
F_NUMPY_REL = 1e-9  # describe, corr, cov and group means against numpy: summation order only
F_SEED = 11
# phase 27: the periodic rank snapshot, the pandas surfaces, sequence parallelism
S_TEXT_MODEL = "bert-base"
S_MAX_LENGTH = 512
S_BATCH = 32
S_TEXTS = 512  # phase 4's texts
S_SNAP_S = 1.0  # SPARKDL_OBS_SNAP_S under the heartbeat
S_BEAT_S = 0.2
S_BEAT_RUN_S = 4.5  # embed passes under the heartbeat until this much has passed
S_BEAT_TEXTS = 64
S_DROPS = (4, 8)  # the drops that run makes, the forced exit drop included
S_ITERS = 5
# phase 28: tensor, pipeline and expert parallelism, gradients through sequence parallelism
M_TEXT_MODEL = "bert-base"
M_TP_ROWS = 16384  # B=32 x L=512 tokens through layer 0's FFN
M_BATCH = 32
M_MAX_LENGTH = 512
M_MICRO = 4  # the pipeline's microbatches
M_EXPERTS = 8
M_EP_TOKENS = 8192
M_EP_FACTOR = 2.0  # capacity_factor: C = 8192 / 8 * 2 = 2048
M_EP_DROP_CAPACITY = 256
M_SP_BATCH = 8
M_INIT_STD = 0.02  # BERT's init, for the router and the experts
M_REL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # of the reference tensor's max |value|

# phase 29: StableHLO without JAX
X_IMAGES = 1024
X_BATCH = 64
X_REL = 1e-4  # relative, against KerasModule on the same weights
X_JAX_ATOL = 1e-5  # the loaded JAX program against the JAX outputs stored beside it
X_PORT_REL = 1e-4  # against the port's own bert-tiny (its flash kernel) from params.pkl

DISPATCH_CALLS = 2000
DISPATCH_ROUNDS = 5

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
# phase 18: the supervised serving gang, 2 worker processes on the card
GANG_WORKERS = 2
GANG_DEVICE = "cuda"  # every worker's --device
GANG_TEXT_REQUESTS = 96
GANG_IMAGE_REQUESTS = 32
GANG_AFTER = (8, 4)  # the post-restart burst: text, image requests
GANG_LOADER = "sparkdl_tpu_torch.serving.canary_loader:loader"
GANG_CANARY_WEIGHT, GANG_CANARY_TOL = 0.25, 0.12
#: warm-ups each rank admits before the flood: bert-base at both rungs, the
#: canary by name at both rungs, ResNet50
GANG_WARMUPS = 5
#: rank 0's admission ordinal of the crash: 24 flood requests into its share
GANG_CRASH_AT = GANG_WARMUPS + 24
#: each worker's budget: every model of the flood at once (bert-base and the
#: canary at both rungs, ResNet50: about 1.4 GiB), so nothing evicts
GANG_BUDGET_MB = 8192
#: util.busy_frac against nvidia-smi: a steady text load from
#: SERVE_CLIENT_THREADS threads, GANG_BUSY_SETTLE_S for it (and then for
#: nvidia-smi) to settle, then each rank's ledger read at both ends of a
#: GANG_BUSY_WINDOW_S window
GANG_BUSY_SETTLE_S = 1.0
GANG_BUSY_WINDOW_S = 5.0
GANG_READY_TIMEOUT_S = 300
GANG_SCRAPE_S = "0.25"  # SPARKDL_FLEET_SCRAPE_S of the gateway in this process
#: util.busy_frac (NVML) against the profiler's busy share (17) or
#: nvidia-smi's mean utilization (18) over the same window
BUSY_NVML_TOL = 0.15
#: ... and the NVML busy seconds over the other's, over the same window
#: (a dead probe reads 0 and fails here, where it could pass the absolute
#: tolerance on a mostly idle window)
BUSY_NVML_RATIO = (0.5, 1.5)
#: how long phase 17's window runs past the flood for NVML's trailing samples
NVML_SETTLE_S = 2.0
# phase 19: the batch gang (python -m sparkdl_tpu_torch.worker)
BATCH_RANKS = 2
BATCH_TEXTS = 512
BATCH_PARTITIONS = 8
BATCH_TEXT_CRASH = "site=worker.partition:rank=0:step=1:crash"
BATCH_IMAGES = 512
BATCH_IMAGE_SIDE = 224
BATCH_TRAIN_IMAGES = 128
BATCH_TRAIN_EPOCHS = 2
#: Adam's rate for 19(d) (the saved estimator's stepSize): phase 12's
#: TRAIN_STEP_SIZE diverges on these unnormalized pixels
BATCH_TRAIN_STEP_SIZE = 1e-4
BATCH_TRAIN_ATOL = 1e-5
BATCH_TIMEOUT_S = 600
MODEL_BUILDER = "sparkdl_tpu_torch.models.registry:build_model_function"
# phase 20: the int8-dynamic rung, POST /admin/profile and the flight recorder
INT8 = "int8-dynamic"
INT8_CLASSES = ("interactive", "background")  # f32, and the int8 rung
INT8_TEXT_REQUESTS = 32
INT8_IMAGE_REQUESTS = 16
#: the int8 entry's parameter bytes under the f32 entry's over this
#: (the JAX package's bound for its rung, tests/test_mesh_serving.py)
INT8_BYTES_RATIO = 3.5
INT8_MEM_BATCH = (4, 512)  # the direct call whose peak is held under half the f32 bytes
INT8_RATE_BATCH = (32, 128)  # rows/s of the direct int8 and f32 builds
INT8_RATE_ITERS = 5
PROFILE_S = 2.0  # POST /admin/profile {"seconds": 2} ...
PROFILE_FLOOD, PROFILE_THREADS = 32, 4  # ... during f32 bert-base requests from 4 threads
#: a waterfall's seven segments against the record's e2e
WATERFALL_SLACK_S = 1e-3
OBS_PATHS = ("/metrics", "/snapshot", "/series", "/slo", "/healthz")


# a window whose kernel launches are counted (phases 11, 17 and 20) opens on
# warm-up kernels and a quiet margin and closes on another margin: in a
# process minutes old, torch.profiler loses a window's first kernel records
# (12 of 40 in each plain window of tools/torch_profiler_window_probe.py)
PROFILE_WARM_KERNELS, PROFILE_WARM_GAP_S = 64, 0.002
PROFILE_SETTLE_S = 1.0


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


@contextmanager
def counted_profile():
    """torch.profiler over the CUDA activity, for a window whose kernel
    launches are counted: the window opens on PROFILE_WARM_KERNELS finished
    warm-up kernels and a PROFILE_SETTLE_S margin, and closes on a finished
    device and another margin, so that no kernel of the body is among the
    records whose timestamps the profiler gets wrong."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        warm = torch.zeros(1, device="cuda")
        for _ in range(PROFILE_WARM_KERNELS):
            warm.add_(1)
            time.sleep(PROFILE_WARM_GAP_S)
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)


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
    print(f"nvidia-smi compute_mode: {_smi_query('--query-gpu=compute_mode')}")
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
        evicted = int(metrics.counter("feeder.evicted"))
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
            f"{batches} batches (feeder.evicted {evicted}), {launches} flash launches, {tokens} real tokens; "
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
            if arm == "shared feeder":
                IMAGE_RATES[(model, dtype_name)] = n_images / dt
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


def phase_serving(seed: int, device_name: str) -> dict:
    """Phase 11: the online serving path on the card. Returns the warm
    passes' requests/s (``text_rps``, ``image_rps``)."""
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
    rates = {}
    for name in SERVE_PASSES:
        metrics.reset()
        flash_attention.launches = 0
        flash_attention.launches_by_dtype = dict.fromkeys(flash_attention.launches_by_dtype, 0)
        with counted_profile() if name == "warm" else nullcontext() as prof:
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
        rates["text_rps"] = len(texts) / wall

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
        rates["image_rps"] = len(images) / wall

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
    workspace = (mem_ledger.memory_status() or {}).get("devices", {}).get("0", {}).get("workspace_bytes")
    clear_workspaces()  # the ledger's workspace class returns with them
    print(
        f"serving router closed: memory_allocated {allocated_before / 2**20:.1f} MiB before the router, "
        f"{left / 2**20:.1f} MiB after it closed with no model resident (the launch thread's cuBLAS workspace "
        f"in the memory ledger: {workspace} B), {torch.cuda.memory_allocated() / 2**20:.1f} MiB after clearing "
        f"the cuBLAS workspaces"
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
    return rates


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


def _seeded_keras_weights(config: dict, seed: int, bn_gamma=None) -> dict:
    """Weights for every layer of a Keras config, drawn from ``seed``:
    conv kernels He-scaled (a depthwise kernel by its window), BatchNorm
    gamma in ``bn_gamma`` (``KERAS_BN_GAMMA``) and positive variance, Dense
    Glorot-scaled, LayerNormalization gamma in ``KERAS_LN_GAMMA``,
    LayerScale gamma in ``KERAS_LAYER_SCALE`` (not its 1e-6 init, under
    which the residual branches would vanish), an adapted Normalization's
    mean and positive variance in ``KERAS_NORM_MEAN`` and
    ``KERAS_NORM_VAR``; shapes from each layer's ``build_config``. Any
    other weighted class raises PhaseError."""
    rng = np.random.default_rng(seed)
    out = {}

    def he(shape, fan_in):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(np.sqrt(2.0 / fan_in))

    def bias(cfg, n):
        return [rng.normal(0.0, 0.01, n).astype(np.float32)] if cfg.get("use_bias", True) else []

    for path, _, layer, _ in walk_layers(config):
        cfg, cls = layer["config"], layer["class_name"]
        in_shape = layer["build_config"]["input_shape"]
        cin = int(in_shape[-1])
        if cls == "Conv2D":
            kh, kw = cfg["kernel_size"]
            cin //= int(cfg.get("groups", 1))
            w = [he((kh, kw, cin, cfg["filters"]), kh * kw * cin)] + bias(cfg, cfg["filters"])
        elif cls == "DepthwiseConv2D":
            kh, kw = cfg["kernel_size"]
            mult = int(cfg.get("depth_multiplier", 1))
            w = [he((kh, kw, cin, mult), kh * kw)] + bias(cfg, cin * mult)
        elif cls == "SeparableConv2D":
            kh, kw = cfg["kernel_size"]
            mult = int(cfg.get("depth_multiplier", 1))
            w = [he((kh, kw, cin, mult), kh * kw), he((1, 1, cin * mult, cfg["filters"]), cin * mult)]
            w += bias(cfg, cfg["filters"])
        elif cls == "BatchNormalization":
            w = [rng.uniform(*(bn_gamma or KERAS_BN_GAMMA), cin)] if cfg.get("scale", True) else []
            w += [rng.normal(0.0, 0.05, cin)] if cfg.get("center", True) else []
            w += [rng.normal(0.0, 0.05, cin), rng.uniform(0.5, 1.5, cin)]
            w = [a.astype(np.float32) for a in w]
        elif cls == "Dense":
            units = cfg["units"]
            w = [(rng.standard_normal((cin, units)) * np.sqrt(2.0 / (cin + units))).astype(np.float32),
                 rng.normal(0.0, 0.01, units).astype(np.float32)]
        elif cls == "LayerNormalization":
            axes = cfg.get("axis", -1)
            shape = tuple(int(in_shape[a]) for a in (axes if isinstance(axes, list) else [axes]))
            w = [rng.uniform(*KERAS_LN_GAMMA, shape)] if cfg.get("scale", True) else []
            w += [rng.normal(0.0, 0.05, shape)] if cfg.get("center", True) else []
            w = [a.astype(np.float32) for a in w]
        elif cls == "LayerScale":
            w = [rng.uniform(*KERAS_LAYER_SCALE, int(cfg["projection_dim"])).astype(np.float32)]
        elif cls == "Normalization":  # adapted: mean, variance, count
            axes = cfg.get("axis", -1)
            axes = [] if axes is None else (list(axes) if isinstance(axes, (list, tuple)) else [axes])
            shape = tuple(int(in_shape[a]) for a in axes)
            w = [rng.uniform(*KERAS_NORM_MEAN, shape).astype(np.float32),
                 rng.uniform(*KERAS_NORM_VAR, shape).astype(np.float32), np.array(0, np.int32)]
        else:
            raise PhaseError(f"keras: no seeded weights for {cls}")
        out[path] = w
    return out


def _keras_app_config(name: str) -> dict:
    """A ``keras.applications`` family's committed config
    (``tests/fixtures/keras_apps/<name>.json.gz``, written by
    ``make_keras_apps_fixtures.py``)."""
    with gzip.open(os.path.join(KERAS_APPS_DIR, f"{name}.json.gz"), "rt") as f:
        return json.load(f)


def _keras_app_heads(config: dict) -> dict:
    """A copy of an application's config with two outputs: its last
    GlobalAveragePooling2D (the pooled features) and its classifier made
    linear (the logits). Under random weights the 1000-way softmax is near
    uniform and would hide an error, so the check reads the logits."""
    config = json.loads(json.dumps(config))
    out_name = config["output_layers"][0]
    for layer in config["layers"]:
        if layer["name"] == out_name:
            check(layer["class_name"] in ("Dense", "Activation"), f"keras apps: classifier {out_name!r} is a "
                  f"{layer['class_name']}")
            layer["config"]["activation"] = "linear"
    pooled = [l["name"] for l in config["layers"] if l["class_name"] == "GlobalAveragePooling2D"][-1]
    config["output_layers"] = [[pooled, 0, 0], [out_name, 0, 0]]
    return config


def _keras_app_inputs(name: str, n: int) -> np.ndarray:
    """``n`` NHWC rows for a family at its default size, drawn from
    ``KERAS_APPS_INPUT_SEED`` in its input range."""
    side, (lo, hi) = KERAS_APPS[name]
    rng = np.random.default_rng(KERAS_APPS_INPUT_SEED)
    return rng.uniform(lo, hi, (n, side, side, 3)).astype(np.float32)


def _keras_app_weights(name: str, config: dict) -> dict:
    """Phase 30's weights of a family: :func:`_seeded_keras_weights` from
    ``KERAS_APPS_SEED`` with BatchNorm gamma in ``KERAS_APPS_BN_GAMMA``,
    and each BatchNorm's moving mean and variance stored beside the configs
    (``KERAS_APPS_BN_STATS``: a float64 pass of the port on the CPU over
    the checked rows, by ``tests/fixtures/make_keras_apps_fixtures.py``;
    a CPU test recomputes them)."""
    weights = _seeded_keras_weights(config, KERAS_APPS_SEED, bn_gamma=KERAS_APPS_BN_GAMMA)
    with np.load(KERAS_APPS_BN_STATS) as f:
        for path, _, layer, _ in walk_layers(config):
            if layer["class_name"] == "BatchNormalization":
                weights[path][-2:] = [f[f"{name}/{path}/mean"], f[f"{name}/{path}/var"]]
    return weights


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


def _keras_files(seed: int, root: str, n_jpegs: int = KERAS_JPEGS):
    """Phase 14's URIs in a seeded order: ``n_jpegs`` JPEGs of random
    pixels at 224x224 (quality 90, as bench.py writes them), PNGs at
    224x224 and at KERAS_PNG_RESIZED, a corrupt file, a missing path and
    None; and each row's kind."""
    from PIL import Image

    rng = np.random.default_rng(seed + 140)
    entries = []
    for i in range(n_jpegs):
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


def phase_control_plane(seed: int, device_name: str, leak_log: str = None) -> None:
    """Phase 17: the serving control plane on the card: (a) the
    utilization and memory ledgers under a flood, (b) KV churn and an OOM
    record, (c) the SLO engine, (d) the canary, (e) out-of-vocabulary ids,
    then every byte back after the router closes. ``leak_log``: the
    events log armed before phase 11, which names the earlier phases'
    leak records (the ledger's event ring rolls over in a whole run)."""

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
    status0 = mem_ledger.memory_status() or {}
    leaks0 = status0.get("leak_events", 0)
    named = ([(e["model"], e["leaked_bytes"], e["tolerance_bytes"]) for e in _events(leak_log, "mem_leak")]
             if leak_log else "no events log armed")
    check(leaks0 == 0, f"control plane: {leaks0} leak records from the earlier phases' routers "
                       f"({status0.get('leaked_bytes')} B in all); (model, bytes, tolerance) from the "
                       f"events log: {named}; the ledger ring's tail: "
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
    flash_attention.launches_by_dtype = dict.fromkeys(flash_attention.launches_by_dtype, 0)
    with counted_profile() as prof:
        with ThreadPoolExecutor(SERVE_CLIENT_THREADS) as pool:
            utilization.reset()
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
    # util.busy_frac is the card's own kernel-busy share from NVML, held to
    # the profiler's share of the same window. NVML's reading averages over
    # its own sample period and so trails the flood: the window runs on
    # NVML_SETTLE_S past the flood's end (the card idle) so that the trailing
    # samples fall inside it, and both shares are over that window.
    check(util["busy_source"] == utilization.NVML_SOURCE, f"control plane: busy_source {util.get('busy_source')}")
    busy_frac = metrics.gauge_stats("util.busy_frac")["last"]
    time.sleep(max(0.0, t_end + NVML_SETTLE_S - time.monotonic()))
    settled = utilization.utilization_status(now=t_end + NVML_SETTLE_S)
    settled_wall = settled["devices"]["0"]["wall_ms"] / 1e3
    nvml_busy = settled["devices"]["0"]["busy_ms"] / 1e3
    nvml_ratio = nvml_busy / busy_prof
    check(abs(settled["busy_frac"] - busy_prof / settled_wall) <= BUSY_NVML_TOL
          and nvml_busy > 0 and BUSY_NVML_RATIO[0] <= nvml_ratio <= BUSY_NVML_RATIO[1],
          f"control plane: util.busy_frac {settled['busy_frac']:.4f} (NVML, {nvml_busy:.4f} s busy) against the "
          f"profiler's busy share {busy_prof / settled_wall:.4f} ({busy_prof:.4f} s) over the ledger's "
          f"{settled_wall:.3f} s window")
    nvml_poll = utilization.get_ledger()._probe.poll_s
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
        f"h2d {dev['h2d_ms']:.3f} ms, d2h {dev['d2h_ms']:.3f} ms; util.busy_frac {util['busy_frac']:.4f} at the "
        f"flood's end (gauge at the last note {busy_frac:.4f}; busy_source {util['busy_source']}, "
        f"nvmlDeviceGetUtilizationRates polled every {nvml_poll} s), the profiler's device busy "
        f"{busy_prof:.4f} s = share {busy_prof / wall:.4f}; over the window run on {NVML_SETTLE_S} s past the "
        f"flood ({settled_wall:.3f} s) util.busy_frac {settled['busy_frac']:.4f} against the profiler's share "
        f"{busy_prof / settled_wall:.4f} (|diff| <= {BUSY_NVML_TOL}), NVML busy {nvml_busy:.4f} s = "
        f"{nvml_ratio:.4f} x the profiler's (within {BUSY_NVML_RATIO}); "
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
    # what stays tracked is the launch thread's cuBLAS workspace, a class
    # of its own that outlives every model
    workspace = final["devices"]["0"]["workspace_bytes"]
    check(final["tracked_bytes"] == workspace and final["models"] == {} and abs(truth - baseline) <= tol_bytes
          and not leaks and final["leak_events"] == leaks0,
          f"control plane: after unload_all tracked {final['tracked_bytes']} B (workspace {workspace} B), "
          f"models {final['models']}, "
          f"memory_allocated {truth} B against the baseline {baseline} B (tolerance {tol_bytes} B), leaks {leaks}, "
          f"leak records {leaks0} before this phase's routers and {final['leak_events']} after ({leak_ring})")
    print(f"control plane: after unload_all tracked {final['tracked_bytes']} B (the launch thread's cuBLAS workspace; "
          f"no model), memory_allocated {truth} B against the baseline {baseline} B "
          f"(tolerance {tol_bytes} B), leak records {leaks0} before this phase's routers and {final['leak_events']} "
          f"after {leak_ring}, {final['oom_events']} oom events, watermark {final['watermark_bytes']} B")
    for name in ("SPARKDL_OBS_JSONL", "SPARKDL_FEEDER_IDLE_S", "SPARKDL_MAX_FEEDERS"):
        os.environ.pop(name, None)


def _smi_query(*args: str) -> str:
    return subprocess.run(["nvidia-smi", *args, "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def _gang_metric(text: str, name: str) -> dict:
    """``{rank: value}`` of one counter family in a federated exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith(f"{name}{{") and 'rank="' in line:
            rank = int(line.split('rank="', 1)[1].split('"', 1)[0])
            out[rank] = float(line.rsplit(" ", 1)[1])
    return out


def _utilization_sampler() -> subprocess.Popen:
    """``nvidia-smi`` printing the card's utilization.gpu every 100 ms
    until terminated."""
    return subprocess.Popen(["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
                             "-lms", "100"], stdout=subprocess.PIPE, text=True)


def phase_gang(seed: int, device_name: str, phase11: dict) -> dict:
    """Phase 18: the supervised serving gang on the card, through a worker
    crash mid-flood and a rolling drain. Returns the flash launches the
    workers counted, per dtype."""
    import threading

    from sparkdl_tpu_torch.serving import canary_loader
    from sparkdl_tpu_torch.serving.gateway import ServingGateway

    card = f"{device_name} ({_smi()})"
    mode = _smi_query("--query-gpu=compute_mode")
    check(mode == "Default", f"gang: compute mode {mode!r}: two worker contexts and this one need 'Default'")
    text_spec, image_spec = get_model(SERVE_TEXT_MODEL), get_model(SERVE_IMAGE_MODEL)
    canary_loader.register_canary()  # this process's registry: the same canary the workers load
    canary_spec = get_model(canary_loader.CANARY_NAME)
    shutdown_feeders()
    tmp = tempfile.mkdtemp(prefix="sparkdl_gang_")
    jsonl = os.path.join(tmp, "events.jsonl")
    os.environ["SPARKDL_OBS_JSONL"] = jsonl  # the gateway's and the workers' events
    os.environ["SPARKDL_FLEET_SCRAPE_S"] = GANG_SCRAPE_S
    threads_before = {t.ident for t in threading.enumerate()}
    gw = ServingGateway(
        num_workers=GANG_WORKERS, device=GANG_DEVICE, seed=seed, loader_spec=GANG_LOADER,
        budget_mb=GANG_BUDGET_MB, gang_dir=os.path.join(tmp, "gang"),
        extra_env={
            "SPARKDL_SERVE_PRECISION_BATCH": "bf16",
            "SPARKDL_LOCK_SANITIZER": "1",
            "SPARKDL_FAULT_PLAN": f"site=serve.request:rank=0:request={GANG_CRASH_AT}:crash",
            "SPARKDL_FAULT_STATE": os.path.join(tmp, "faults"),
            "SPARKDL_SERVE_CANARY_MODEL": SERVE_TEXT_MODEL,
            "SPARKDL_SERVE_CANARY_VERSION": canary_loader.CANARY_NAME,
            "SPARKDL_SERVE_CANARY_WEIGHT": str(GANG_CANARY_WEIGHT),
        },
    )
    pids = set()

    def workers():
        table = json.loads(urllib.request.urlopen(base + "/v1/workers", timeout=30).read())
        pids.update(w["pid"] for w in table["workers"] if w["pid"])
        return table

    def ready(generation):
        table = workers()
        return (table["generation"] == generation and len(table["workers"]) == GANG_WORKERS
                and all(w["status"] == "ready" for w in table["workers"]))

    def logs_tail():
        out = []
        for r in range(GANG_WORKERS):
            path = os.path.join(gw.gang_dir, f"worker.{r}.log")
            if os.path.exists(path):
                out.append(f"worker.{r}.log: " + open(path).read()[-3000:])
        return "\n".join(out)

    def body(x, model, cls):
        if x.dtype == np.int32:
            return {"model": model, "inputs": x.tolist(), "dtype": "int32", "mode": "embed", "priority": cls}
        return {"model": model, "inputs": x.tolist(), "priority": cls}

    t_start = time.perf_counter()
    gw.start()
    base = f"http://127.0.0.1:{gw.port}"
    try:
        if not _wait_for(lambda: ready(0), GANG_READY_TIMEOUT_S):
            raise PhaseError(f"gang: generation 0 never ready: {workers()}\n{logs_tail()}")
        t_ready = time.perf_counter() - t_start
        texts = _text_requests(seed + 18, text_spec, GANG_TEXT_REQUESTS + GANG_AFTER[0])
        images = _image_requests(seed + 18, image_spec, GANG_IMAGE_REQUESTS + GANG_AFTER[1])
        # warm-up: each model and rung once on each rank, in pairs (the
        # gateway's round-robin gives one of each pair to each rank)
        t0 = time.perf_counter()
        warm = [(texts[0][0], SERVE_TEXT_MODEL, "interactive"), (texts[0][0], SERVE_TEXT_MODEL, "batch"),
                (texts[0][0], canary_spec.name, "interactive"), (texts[0][0], canary_spec.name, "batch"),
                (images[0], SERVE_IMAGE_MODEL, "interactive")]
        assert len(warm) == GANG_WARMUPS
        for x, model, cls in warm:
            for _ in range(GANG_WORKERS):
                status, _, reply, _ = _post(base, body(x, model, cls))
                check(status == 200, f"gang warm-up {model} {cls}: HTTP {status} {reply}")
        table = workers()
        fresh_mem = {}
        for w in table["workers"]:
            wbase = f"http://127.0.0.1:{w['port']}"
            stats = json.loads(urllib.request.urlopen(wbase + "/v1/models", timeout=60).read())
            check(stats["admitted"] == GANG_WARMUPS,
                  f"gang: rank {w['rank']} admitted {stats['admitted']} warm-ups, not {GANG_WARMUPS}")
            fresh_mem[w["rank"]] = json.loads(urllib.request.urlopen(wbase + "/v1/memory", timeout=60).read())
        apps = _smi_query("--query-compute-apps=pid,used_memory")
        print(f"gang on {card}: {GANG_WORKERS} workers (pids {sorted(pids)}) ready in {t_ready:.2f} s after "
              f"start, warm-ups ({GANG_WARMUPS} per rank) in {time.perf_counter() - t0:.2f} s")
        for rank, mem in sorted(fresh_mem.items()):
            dev = mem["devices"]["0"]
            print(f"gang fresh worker rank {rank} GET /v1/memory: models {mem['models']}, tracked "
                  f"{mem['tracked_bytes']} B (workspace {dev['workspace_bytes']} B, staged {dev['staged_bytes']} B, "
                  f"readback {dev['readback_bytes']} B), ground truth {mem['ground_truth_bytes']} B "
                  f"({mem['ground_truth_source']}), mem.unattributed_bytes {mem['unattributed_bytes']} B "
                  f"= {(mem['unattributed_bytes'] or 0) / 2**20:.2f} MiB, budget {mem['budget_bytes']} B")
        print(f"gang nvidia-smi --query-compute-apps=pid,used_memory: {apps!r}")

        # the flood: 3 text requests, then an image one, from 8 threads,
        # while nvidia-smi samples the card's utilization and a poller
        # reads the fleet's per-rank view
        flood = []
        for i in range(GANG_TEXT_REQUESTS):
            flood.append(("text", i))
            if i % 3 == 2 and i // 3 < GANG_IMAGE_REQUESTS:
                flood.append(("image", i // 3))
        assert len(flood) == GANG_TEXT_REQUESTS + GANG_IMAGE_REQUESTS

        def send(item):
            kind, i = item
            if kind == "text":
                ids, cls = texts[i]
                return _post(base, body(ids, SERVE_TEXT_MODEL, cls))
            return _post(base, body(images[i], SERVE_IMAGE_MODEL, "interactive"))

        smi = _utilization_sampler()
        seen_busy, verdicts, cycles = {}, set(), []
        stop_poll = threading.Event()

        def poll():
            while not stop_poll.wait(0.25):
                for w in gw.fleet.status()["workers"]:
                    if w["busy_frac"] is not None:
                        seen_busy.setdefault(w["rank"], []).append(w["busy_frac"])
                rec = gw.fleet.recommendation()
                if rec:
                    verdicts.add(rec["action"])
                found = _gang_metric(gw.federated_metrics_text(), "sparkdl_locks_cycles_total")
                if found:
                    cycles.append(found)

        poller = threading.Thread(target=poll, name="gang-poll", daemon=True)
        poller.start()
        t0 = time.perf_counter()
        try:
            with ThreadPoolExecutor(SERVE_CLIENT_THREADS) as pool:
                replies = list(pool.map(send, flood))
            wall = time.perf_counter() - t0
        finally:
            smi.terminate()
            smi_out = smi.communicate(timeout=30)[0]
        util_samples = [float(v) for v in smi_out.split() if v.strip().replace(".", "", 1).isdigit()]
        codes = [r[0] for r in replies]
        check(codes == [200] * len(flood),
              f"gang: not every request was answered 200: {sorted(set(codes))} "
              f"{[r[2] for r in replies if r[0] != 200][:3]}\n{logs_tail()}")
        # (b) one restart, then generation 1 with both ranks ready
        if not _wait_for(lambda: ready(1), GANG_READY_TIMEOUT_S):
            raise PhaseError(f"gang: generation 1 never ready: {workers()}\n{logs_tail()}")
        check(gw.restarts() == 1, f"gang: {gw.restarts()} supervisor restarts, not 1")
        events = _events(jsonl, "fault")
        check(len(events) == 1 and events[0]["coords"]["request"] == GANG_CRASH_AT and events[0]["coords"]["rank"] == "0",
              f"gang: fault events {events}")
        crash_ts = events[0]["ts"]
        ready1 = [e["ts"] for e in _events(jsonl, "gateway")
                  if e.get("event") == "worker_ready" and e.get("generation") == 1]
        restart = [e for e in _events(jsonl, "supervisor") if e.get("event") == "gang_restart"]
        window = max(ready1) - crash_ts if len(ready1) >= GANG_WORKERS else None
        stats = gw.stats()

        # the post-restart burst: each rung and ResNet50 on each rank
        after = []
        for j in range(GANG_AFTER[0]):
            after.append(("text", GANG_TEXT_REQUESTS + j))
        for j in range(GANG_AFTER[1]):
            after.append(("image", GANG_IMAGE_REQUESTS + j))
        after_replies = [send(item) for item in after]
        check([r[0] for r in after_replies] == [200] * len(after), "gang: the post-restart burst failed")
        stop_poll.set()
        poller.join(timeout=10)

        # (c) every row against the same model called directly on the card
        rungs = {"f32": torch.float32, "bf16": torch.bfloat16}
        direct = {}
        for spec in (text_spec, canary_spec):
            for rung, dtype in rungs.items():
                mf = _direct_fn(spec, "embed", dtype, seed)
                direct[(spec.name, rung)] = bf16_rung(mf) if rung == "bf16" else mf
        image_mf = _direct_fn(image_spec, "features", torch.float32, seed)
        worst = {"f32": 0.0, "bf16": 0.0}
        image_err = 0.0
        served = {"primary": 0, "canary": 0}
        for (kind, i), (status, _, reply, _) in list(zip(flood, replies)) + list(zip(after, after_replies)):
            got = np.asarray(reply["outputs"], np.float32)
            if kind == "image":
                image_err = max(image_err, _relative_error(got, _direct(image_mf, images[i], nhwc=True)))
                continue
            ids, cls = texts[i]
            rung = reply["precision"]
            check(rung == ("bf16" if cls == "batch" else "f32"), f"gang: {cls} served at {rung}")
            check(reply["model"] in (SERVE_TEXT_MODEL, canary_spec.name), f"gang: served by {reply['model']}")
            served["canary" if reply["model"] == canary_spec.name else "primary"] += 1
            want = _direct(direct[(reply["model"], rung)], ids, nhwc=False)
            check(got.shape == want.shape and np.isfinite(got).all(), f"gang text {i}: {got.shape} for {want.shape}")
            worst[rung] = max(worst[rung], float(np.abs(got - want).max()))
        del direct, image_mf
        share = served["canary"] / max(1, sum(served.values()))
        for rung, dtype in rungs.items():
            check(worst[rung] <= ATOL[dtype], f"gang: {rung} rows off the direct model by {worst[rung]}")
        check(image_err <= IMAGE_F32_REL, f"gang: ResNet50 rows off the direct model by {image_err:.3e}")
        check(abs(share - GANG_CANARY_WEIGHT) <= GANG_CANARY_TOL,
              f"gang: the canary served {served['canary']} of {sum(served.values())} bert-base replies")

        # (e) both flash kernels in the workers, from the federated /metrics
        def fed():
            return urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()

        def launched():
            text = fed()
            return {dtype: _gang_metric(text, f"sparkdl_kernel_flash_attention_launches_{dtype}_total")
                    for dtype in ("float32", "bfloat16")}

        _wait_for(lambda: all(len(v) == GANG_WORKERS for v in launched().values()), 10)
        launches = launched()
        text = fed()
        check(all(len(v) == GANG_WORKERS and min(v.values()) > 0 for v in launches.values()),
              f"gang: flash launches per rank in the federated /metrics {launches}")
        # (f) no lock cycle in any worker, during the flood or after
        cycles.append(_gang_metric(text, "sparkdl_locks_cycles_total"))
        check(not any(c for c in cycles), f"gang: lock cycles reported {cycles}")
        edges = _gang_metric(text, "sparkdl_locks_edges_observed")
        check(edges and all(v > 0 for v in edges.values()), f"gang: the lock sanitizer saw no edges {edges}")
        fleet = gw.fleet_status()
        busy_now = {w["rank"]: w["busy_frac"] for w in fleet["workers"]}
        sources = {}
        for w in workers()["workers"]:
            _, models = _get(f"http://127.0.0.1:{w['port']}", "/v1/models")
            sources[w["rank"]] = (models.get("utilization") or {}).get("busy_source")
        check(set(sources.values()) == {utilization.NVML_SOURCE},
              f"gang: the workers' util.busy_frac sources {sources}")

        # each rank's util.busy_frac against nvidia-smi over one window of
        # steady load: every rank's ledger (NVML: the whole card, which the
        # two processes share) read at both ends, nvidia-smi sampling the
        # same card across it
        def rank_devices():
            out = {}
            for w in workers()["workers"]:
                _, models = _get(f"http://127.0.0.1:{w['port']}", "/v1/models")
                out[w["rank"]] = models["utilization"]["devices"]["0"]
            return out

        stop_load, load_codes = threading.Event(), []

        def load(k):
            while not stop_load.is_set():
                load_codes.append(_post(base, body(texts[k % len(texts)][0], SERVE_TEXT_MODEL, "interactive"))[0])
                k += SERVE_CLIENT_THREADS

        loaders = [threading.Thread(target=load, args=(k,), name="gang-load", daemon=True)
                   for k in range(SERVE_CLIENT_THREADS)]
        for t in loaders:
            t.start()
        smi_w = None
        try:
            time.sleep(GANG_BUSY_SETTLE_S)
            smi_w = _utilization_sampler()
            time.sleep(GANG_BUSY_SETTLE_S)
            dev_a, t_a = rank_devices(), time.perf_counter()
            time.sleep(GANG_BUSY_WINDOW_S)
            dev_b, t_b = rank_devices(), time.perf_counter()
        finally:
            if smi_w is not None:
                smi_w.terminate()
            stop_load.set()
            for t in loaders:
                t.join(timeout=120)
        smi_w_out = smi_w.communicate(timeout=30)[0]
        win_samples = [float(v) for v in smi_w_out.split() if v.strip().replace(".", "", 1).isdigit()]
        check(load_codes and set(load_codes) == {200}, f"gang: the steady load answered {sorted(set(load_codes))}")
        win_smi = sum(win_samples) / len(win_samples) / 100 if win_samples else float("nan")
        win_busy = {r: (dev_b[r]["busy_ms"] - dev_a[r]["busy_ms"]) / (dev_b[r]["wall_ms"] - dev_a[r]["wall_ms"])
                    for r in dev_a}
        check(win_smi > 0 and all(
            v > 0 and abs(v - win_smi) <= BUSY_NVML_TOL and BUSY_NVML_RATIO[0] <= v / win_smi <= BUSY_NVML_RATIO[1]
            for v in win_busy.values()),
            f"gang: util.busy_frac per rank {win_busy} against nvidia-smi's mean {win_smi:.4f} over the window")

        # (g) a rolling drain of rank 1
        table = workers()
        rank1 = f"http://127.0.0.1:{table['workers'][1]['port']}"
        req = urllib.request.Request(base + "/admin/drain", data=json.dumps({"rank": 1}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            drain_reply = json.loads(resp.read())
        check(drain_reply.get("status") == "draining", f"gang: /admin/drain replied {drain_reply}")
        health = json.loads(urllib.request.urlopen(rank1 + "/healthz", timeout=30).read())
        check(health["status"] == "draining", f"gang: rank 1 reads {health}")
        status, headers, reply, _ = _post(rank1, body(texts[0][0], SERVE_TEXT_MODEL, "interactive"))
        check(status == 503 and headers.get("Retry-After"), f"gang: direct submit to draining rank 1: HTTP {status}")
        during = [_post(base, body(texts[1][0], SERVE_TEXT_MODEL, "interactive"))[0] for _ in range(4)]
        check(during == [200] * 4, f"gang: the gateway during the drain answered {during}")
        if not _wait_for(lambda: ready(2), GANG_READY_TIMEOUT_S):
            raise PhaseError(f"gang: generation 2 never ready after the drain: {workers()}\n{logs_tail()}")
        exits = [e for e in gw._sup._events if e["event"] == "rank_dead" and e["generation"] == 1]
        check([(e["rank"], e["returncode"]) for e in exits] == [(1, 0)], f"gang: generation 1 ended with {exits}")
        check(gw.restarts() == 2, f"gang: {gw.restarts()} restarts after the drain, not 2")
        workers()
    finally:
        gw.stop()
        for name in ("SPARKDL_OBS_JSONL", "SPARKDL_FLEET_SCRAPE_S"):
            os.environ.pop(name, None)
    # (h) nothing left: no worker process, no thread of this phase
    alive = []
    for pid in sorted(pids):
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    left = [t.name for t in threading.enumerate()
            if t.ident not in threads_before and (t.name.startswith("sparkdl-") or t.name == "gang-poll")]
    check(not alive and not left, f"gang: after stop() workers alive {alive}, threads left {left}")

    n = len(flood)
    rps = n / wall
    lat = {("text", "interactive"): [], ("text", "batch"): [], ("image", "interactive"): []}
    for (kind, i), rep in zip(flood, replies):
        cls = texts[i][1] if kind == "text" else "interactive"
        lat[(kind, cls)].append(rep[3])
    print(f"gang flood on {card}: {GANG_TEXT_REQUESTS} {SERVE_TEXT_MODEL} embed + {GANG_IMAGE_REQUESTS} "
          f"{SERVE_IMAGE_MODEL} requests over HTTP to the gateway from {SERVE_CLIENT_THREADS} threads, every one 200, "
          f"across the crash of rank 0 at its admission {GANG_CRASH_AT}, in {wall:.3f} s = {rps:.2f} requests/s "
          f"(phase 11's single process, warm: text {phase11['text_rps']:.1f} requests/s, image "
          f"{phase11['image_rps']:.1f} requests/s); rerouted {stats['rerouted']}, retries "
          f"{int(metrics.counter('gateway.retries'))}, unroutable {stats['unroutable']}")
    for (kind, cls), secs in lat.items():
        print(f"gang latency {kind} {cls} through the gateway: {_percentiles_ms(secs)}")
    print(f"gang relaunch window: crash (fault event) to generation 1 with both ranks ready "
          + (f"{window:.3f} s" if window is not None else "not measured")
          + f" against SPARKDL_GATEWAY_PENDING_S = {knobs.get_float('SPARKDL_GATEWAY_PENDING_S')} s; supervisor "
          f"backoff {[e['backoff_s'] for e in restart]} s; restarts {stats['restarts']}, then 1 more by the drain")
    print(f"gang checks: {SERVE_TEXT_MODEL} rows vs the direct model max |diff| f32 {worst['f32']:.3e} "
          f"(atol {ATOL[torch.float32]}), bf16 rung {worst['bf16']:.3e} (atol {ATOL[torch.bfloat16]}); "
          f"{SERVE_IMAGE_MODEL} relative {image_err:.3e} (limit {IMAGE_F32_REL}); the canary served "
          f"{served['canary']} of {sum(served.values())} {SERVE_TEXT_MODEL} replies = {share:.3f} "
          f"({GANG_CANARY_WEIGHT} +- {GANG_CANARY_TOL}); no lock cycle, sanitizer edges per rank {edges}")
    print(f"gang flash launches per rank in the federated /metrics (generation 1's processes): {launches}")
    mean_util = sum(util_samples) / len(util_samples) if util_samples else float("nan")
    print(f"gang utilization (busy_source {sources}): util.busy_frac per rank sampled by the fleet scrape during the flood "
          f"{ {r: (min(v), max(v)) for r, v in sorted(seen_busy.items())} } (min, max), after it {busy_now}; "
          f"fleet verdicts seen {sorted(verdicts)}; nvidia-smi utilization.gpu every 100 ms over the flood: "
          f"{len(util_samples)} samples, mean {mean_util:.1f} %, max {max(util_samples, default=float('nan')):.0f} %")
    print(f"gang utilization over one window of steady load ({SERVE_CLIENT_THREADS} threads of {SERVE_TEXT_MODEL} "
          f"f32 requests, {len(load_codes)} answered 200 in all): each rank's util.busy_frac (NVML) between two reads "
          f"{t_b - t_a:.3f} s apart { {r: round(v, 4) for r, v in sorted(win_busy.items())} } against nvidia-smi's "
          f"mean {win_smi:.4f} ({len(win_samples)} samples every 100 ms across it); |diff| <= {BUSY_NVML_TOL}, "
          f"ratio within {BUSY_NVML_RATIO}")
    print(f"gang drain: rank 1 draining, its direct submit HTTP 503 Retry-After {headers.get('Retry-After')} s, "
          f"the gateway answered {during}, rank 1 exited 0, generation 2 ready; after stop() no worker alive, "
          f"no thread left; {time.perf_counter() - t_start:.1f} s in all")
    return {torch.float32: int(sum(launches["float32"].values())),
            torch.bfloat16: int(sum(launches["bfloat16"].values()))}


def _direct_fn(spec, mode: str, dtype, seed: int):
    """The registry's ModelFunction of ``spec`` at ``dtype``, seeded as
    the serving loader seeds it."""
    return spec.model_function(mode=mode, dtype=dtype, seed=seed, device=SERVE_DEVICE)


def train_builder(seed: int = 0, device: str = "cuda") -> ModelFunction:
    """Phase 19(d)'s model builder (``chip_smoke:train_builder``): phase
    12's ResNet50 with a 10-way head from ``seed``. cuDNN runs its
    deterministic algorithms, in the worker and in this process alike, so
    the two fits can agree to f32 rounding."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return _train_model(torch.float32, seed, device)


def _supervise(job: dict, path: str, env_extra: dict, *extra_args, ranks: int = BATCH_RANKS):
    """``python -m sparkdl_tpu_torch.resilience supervise --job`` over
    ``ranks`` workers on the card: (verdict, seconds)."""
    with open(path, "w") as f:
        json.dump(job, f)
    env = {**os.environ, **env_extra}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sparkdl_tpu_torch.resilience", "supervise", "--num-ranks",
         str(ranks), "--job", path, "--device", "cuda", "--poll-interval", "0.2",
         *extra_args],
        capture_output=True, text=True, timeout=BATCH_TIMEOUT_S, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    dt = time.perf_counter() - t0
    check(proc.returncode == 0, f"batch gang: supervise exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                                f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), dt


def _success(out: str, rank: int) -> dict:
    with open(os.path.join(out, f"_SUCCESS.{rank}")) as f:
        return json.load(f)


def phase_batch_gang(seed: int, device_name: str, drops_dir: str) -> None:
    """Phase 19: the batch gang worker on the card (see the docstring). The
    text job's rank drops are copied to ``drops_dir`` for phase 20(d)."""
    import importlib.util
    import pickle
    import shutil

    from sparkdl_tpu_torch.dataframe.parquet import ParquetFile
    from sparkdl_tpu_torch.obs.aggregate import load_rank_snapshots
    from sparkdl_tpu_torch.worker import gather_results

    t_phase = time.perf_counter()
    card = f"{device_name} ({_smi_query('--query-gpu=name,power.limit')})"
    # (a) the reader on a file pyarrow wrote
    spec = importlib.util.spec_from_file_location(
        "make_parquet_fixture", os.path.join(FIXTURES, "make_parquet_fixture.py"))
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    pf = ParquetFile(fixture.PATH)
    got, want = pf.read(), fixture.fixture_columns()
    for c, values in want.items():
        same = np.array_equal(got[c], values) if c == "t" else got[c] == values
        check(same, f"batch gang (a): the pyarrow fixture's column {c!r} read differently")
    print(f"batch gang (a): {os.path.basename(fixture.PATH)} ({pf.key_value.get('ARROW:schema') is not None and 'ARROW:schema'}, "
          f"{len(pf.row_groups)} row groups of {pf.row_group_rows()} rows, written by pyarrow with its defaults) "
          f"read exactly against the values its seed regenerates: {sorted(want)}")

    with tempfile.TemporaryDirectory() as tmp:
        # (b) text: bert-base over 512 texts in 8 partitions, a crash of rank 0
        texts = _texts(seed + 19, BATCH_TEXTS)
        inp = os.path.join(tmp, "texts.parquet")
        t0 = time.perf_counter()
        DataFrame.fromColumns({"text": texts}, numPartitions=BATCH_PARTITIONS).writeParquet(inp)
        write_s = time.perf_counter() - t0
        text_spec = get_model("bert-base")
        weights = os.path.join(tmp, "bert_base.npz")
        save_flax_weights(bert_params_to_flax(text_spec.model_function(seed=seed, device="cpu").module), weights)
        stage = os.path.join(tmp, "text_stage")
        persistence.save_stage(TextEmbedder(inputCol="text", outputCol="emb", maxLength=512, batchSize=32), stage)
        hb = os.path.join(tmp, "hb_text")
        out = os.path.join(tmp, "out_text")
        events = os.path.join(tmp, "events.jsonl")
        job = {"stage_path": stage, "input_parquet": inp, "num_partitions": BATCH_PARTITIONS,
               "output_dir": out, "heartbeat_dir": hb, "heartbeat_interval": 1.0,
               "model": {"builder": MODEL_BUILDER,
                         "kwargs": {"name": "bert-base", "weights_file": weights, "dtype": "float32"}}}
        verdict, gang_s = _supervise(job, os.path.join(tmp, "text_job.json"), {
            "SPARKDL_FAULT_PLAN": BATCH_TEXT_CRASH, "SPARKDL_FAULT_STATE": os.path.join(tmp, "faults"),
            "SPARKDL_OBS_JSONL": events, "SPARKDL_SUPERVISOR_RETRY_BASE_MS": "100"})
        check(verdict["supervise"] == "OK" and verdict["restarts"] == 1,
              f"batch gang (b): expected exactly one restart, got {verdict}")
        done = [_success(out, r) for r in range(BATCH_RANKS)]
        resumed = {r: d["resumed"] for r, d in enumerate(done)}
        check(all(d["generation"] == 1 for d in done) and 0 in resumed[0],
              f"batch gang (b): generation 1 did not resume rank 0's published partition 0: {done}")
        with open(events) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        crash_ts = [e["ts"] for e in recs if e.get("kind") == "fault"]
        check(len(crash_ts) == 1, f"batch gang (b): {len(crash_ts)} fault events")
        finish = max(os.path.getmtime(os.path.join(out, f"_SUCCESS.{r}")) for r in range(BATCH_RANKS))
        t0 = time.perf_counter()
        gathered = gather_results(out, BATCH_RANKS).collectColumns()
        gather_s = time.perf_counter() - t0
        mf = text_spec.model_function(weights_file=weights, device="cuda")
        embedder = TextEmbedder(inputCol="text", outputCol="emb", modelFunction=mf, maxLength=512, batchSize=32)
        embedder.transform(DataFrame.fromColumns({"text": texts[:32]}, 1)).collect()  # warm-up
        t0 = time.perf_counter()
        ref = embedder.transform(DataFrame.readParquet(inp, BATCH_PARTITIONS)).collectColumns()
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        del mf, embedder
        torch.cuda.empty_cache()
        check(list(gathered["text"]) == texts, "batch gang (b): the gathered rows are not in global order")
        err = float(np.abs(np.stack(gathered["emb"]) - np.stack(ref["emb"])).max())
        check(err <= ATOL[torch.float32], f"batch gang (b): rows off the single process by {err:.3e}")
        snaps = load_rank_snapshots(hb)
        for r in snaps:
            shutil.copy(os.path.join(hb, f"obs.rank.{r}.json"), drops_dir)
        launches = {r: snaps.get(r, {}).get("metrics", {}).get("counters", {}).get(
            "kernel.flash_attention.launches.float32", 0) for r in range(BATCH_RANKS)}
        check(all(v > 0 for v in launches.values()), f"batch gang (b): flash f32 launches per rank {launches}")
        print(f"batch gang (b) on {card}: {BATCH_TEXTS} texts (8-500 words) written by the port's writeParquet in "
              f"{BATCH_PARTITIONS} row groups in {write_s:.2f} s; supervise --job over {BATCH_RANKS} workers with "
              f"{BATCH_TEXT_CRASH}: {verdict}; {gang_s:.2f} s in all = {BATCH_TEXTS / gang_s:.1f} rows/s through the "
              f"gang (worker start-up and the restart included) against this process's single-process transform "
              f"{single_s:.2f} s = {BATCH_TEXTS / single_s:.1f} rows/s; crash to the last _SUCCESS "
              f"{finish - crash_ts[0]:.3f} s; partitions per rank {[d['partitions'] for d in done]}, resumed "
              f"{resumed}; gathered in {gather_s:.2f} s, max |diff| {err:.3e} (atol {ATOL[torch.float32]}); flash "
              f"f32 launches per rank (generation 1's snapshots) {launches}")

        # (c) images: the fitted ResNet50 f32 -> LogisticRegression pipeline
        structs, labels = _colour_structs(seed + 19, BATCH_IMAGES, BATCH_IMAGE_SIDE)
        iw = os.path.join(tmp, "resnet50.npz")
        _write_seeded_weights("ResNet50", seed, iw)
        feat = _featurizer("ResNet50", "float32", iw)
        img_df = DataFrame.fromColumns({"image": structs}, numPartitions=BATCH_PARTITIONS)
        feats, _ = _featurize(feat, img_df)
        head = LogisticRegression().fit(DataFrame.fromColumns({"features": feats, "label": labels}, 4))
        pipeline = PipelineModel([feat, head])
        ipath = os.path.join(tmp, "images.parquet")
        t0 = time.perf_counter()
        img_df.writeParquet(ipath)
        img_write_s = time.perf_counter() - t0
        pdir = os.path.join(tmp, "pipeline")
        pipeline.save(pdir)
        del structs, feats, img_df
        iout = os.path.join(tmp, "out_images")
        ijob = {"stage_path": pdir, "input_parquet": ipath, "num_partitions": BATCH_PARTITIONS, "output_dir": iout}
        iverdict, igang_s = _supervise(ijob, os.path.join(tmp, "image_job.json"), {})
        check(iverdict["supervise"] == "OK" and iverdict["restarts"] == 0, f"batch gang (c): {iverdict}")
        igot = gather_results(iout, BATCH_RANKS).collectColumns()
        t0 = time.perf_counter()
        iref = pipeline.transform(DataFrame.readParquet(ipath, BATCH_PARTITIONS)).collectColumns()
        torch.cuda.synchronize()
        isingle_s = time.perf_counter() - t0
        check(list(igot["prediction"]) == list(iref["prediction"]),
              "batch gang (c): the gang's predictions differ from the single process's")
        irel = _relative_error(np.stack(igot["features"]), np.stack(iref["features"]))
        check(irel <= IMAGE_F32_REL, f"batch gang (c): features relative error {irel:.3e}")
        print(f"batch gang (c) on {card}: PipelineModel(DeepImageFeaturizer ResNet50 f32, LogisticRegression) over "
              f"{BATCH_IMAGES} {BATCH_IMAGE_SIDE}x{BATCH_IMAGE_SIDE} structs ({os.path.getsize(ipath) / 2**20:.1f} MiB "
              f"of Parquet, written in {img_write_s:.2f} s) in {BATCH_PARTITIONS} partitions, {BATCH_RANKS} ranks "
              f"fault-free: {iverdict}, {igang_s:.2f} s in all = {BATCH_IMAGES / igang_s:.1f} images/s through the "
              f"gang (start-up included) against the single process {isingle_s:.2f} s = "
              f"{BATCH_IMAGES / isingle_s:.1f} images/s; {len(igot['prediction'])} predictions equal, features "
              f"relative {irel:.3e} (limit {IMAGE_F32_REL})")
        del pipeline, feat, head, igot, iref
        torch.cuda.empty_cache()

        # (d) training: phase 12's model from a module:function builder, one rank
        tstructs, tlabels = _colour_structs(seed + 20, BATCH_TRAIN_IMAGES, TRAIN_SIDE)
        tpath = os.path.join(tmp, "train.parquet")
        DataFrame.fromColumns({"image": tstructs, "label": tlabels}, TRAIN_PARTITIONS).writeParquet(tpath)
        del tstructs
        est_kw = dict(inputCol="image", labelCol="label", outputCol="logits", batchSize=TRAIN_BATCH,
                      epochs=BATCH_TRAIN_EPOCHS, stepSize=BATCH_TRAIN_STEP_SIZE, targetHeight=TRAIN_SIDE,
                      targetWidth=TRAIN_SIDE)
        epath = os.path.join(tmp, "estimator")
        persistence.save_stage(DataParallelEstimator(**est_kw), epath)
        tout = os.path.join(tmp, "out_train")
        tjob = {"type": "train", "estimator_path": epath, "input_parquet": tpath,
                "num_partitions": TRAIN_PARTITIONS, "output_dir": tout,
                "model": {"builder": "chip_smoke:train_builder", "kwargs": {"seed": seed}}}
        import socket

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        tverdict, tgang_s = _supervise(tjob, os.path.join(tmp, "train_job.json"), {},
                                       "--distributed", "--coordinator", f"localhost:{port}", ranks=1)
        check(tverdict["supervise"] == "OK", f"batch gang (d): {tverdict}")
        with open(os.path.join(tout, "trained_params.pkl"), "rb") as f:
            theirs = pickle.load(f)
        with open(os.path.join(tout, "history.json")) as f:
            thist = json.load(f)
        deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        try:
            model = train_builder(seed, torch.device("cuda", torch.cuda.current_device()))
            t0 = time.perf_counter()
            fitted = DataParallelEstimator(model=model, **est_kw).fit(DataFrame.readParquet(tpath, TRAIN_PARTITIONS))
            tsingle_s = time.perf_counter() - t0
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
        ours = cnn_params_to_flax(fitted.modelFunction.module)
        terr = 0.0
        for coll, tree in ours.items():
            for key, value in _flat_tree(tree):
                other = theirs[coll]
                for part in key:
                    other = other[part]
                terr = max(terr, float(np.abs(np.asarray(other) - value).max()))
        check(terr <= BATCH_TRAIN_ATOL, f"batch gang (d): trained params off the in-process fit by {terr:.3e}")
        tlosses = [h["loss"] for h in thist]
        check(len(tlosses) == BATCH_TRAIN_EPOCHS and np.isfinite(tlosses).all() and tlosses[-1] < tlosses[0],
              f"batch gang (d): the job's loss at each epoch's end {tlosses} is not finite and falling")
        print(f"batch gang (d) on {card}: a train job at 1 rank (NCCL world 1) of ResNet50(num_classes="
              f"{TRAIN_CLASSES}) from chip_smoke:train_builder over {BATCH_TRAIN_IMAGES} structs, "
              f"{BATCH_TRAIN_EPOCHS} epochs, Adam at {BATCH_TRAIN_STEP_SIZE}: {tverdict}, {tgang_s:.2f} s in all (the fit in this process "
              f"{tsingle_s:.2f} s); losses {[round(h['loss'], 5) for h in thist]} (in process "
              f"{[round(h['loss'], 5) for h in fitted.history]}); trained_params.pkl max |diff| {terr:.3e} "
              f"(atol {BATCH_TRAIN_ATOL})")
        del fitted, model
        torch.cuda.empty_cache()
    print(f"batch gang: {time.perf_counter() - t_phase:.1f} s in all")


def _post_any(base: str, path: str, body: dict, timeout: float = 300.0):
    """(status, reply) of one POST, an error status included."""
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _obs_cli(*args: str):
    """``python -m sparkdl_tpu_torch.obs <args>``: (exit code, stdout, stderr)."""
    r = subprocess.run([sys.executable, "-m", "sparkdl_tpu_torch.obs", *args], capture_output=True,
                       text=True, timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    return r.returncode, r.stdout, r.stderr


def _int8_buffers(module) -> dict:
    return {n: b for n, b in module.named_buffers() if n.endswith(("_int8", "_scale"))}


def phase_int8_obs(seed: int, device_name: str, dump_dir: str, drops_dir: str) -> int:
    """Phase 20: (a) the int8-dynamic rung served beside f32, (b) POST
    /admin/profile during a flood, (c) the flight recorder on an SLO trip
    and phase 17's dumps, (d) phase 19's rank drops merged and the pull
    exporter. Returns the f32 flash launches of (a)'s flood."""

    from sparkdl_tpu_torch.graph.precision import quantize_module
    from sparkdl_tpu_torch.models.registry import param_bytes
    from sparkdl_tpu_torch.obs import export, serve as obs_serve, trace as obs_trace
    from sparkdl_tpu_torch.serving import Router, ServingServer
    from sparkdl_tpu_torch.serving.__main__ import serving_env_defaults
    from sparkdl_tpu_torch.serving.residency import _default_loader
    from sparkdl_tpu_torch.utils.profiler import TRACE_FILE

    t_phase = time.perf_counter()
    card = f"{device_name} ({_smi()})"
    text_spec, image_spec = get_model(SERVE_TEXT_MODEL), get_model(SERVE_IMAGE_MODEL)
    tmp = tempfile.mkdtemp(prefix="sparkdl_p20_")
    jsonl = os.path.join(tmp, "events.jsonl")
    for name in ("SPARKDL_SERVE_PRECISION_BATCH", "SPARKDL_SERVE_HBM_BUDGET_MB", *CP_SLO,
                 "SPARKDL_SERVE_CANARY_MODEL", "SPARKDL_SERVE_CANARY_VERSION"):
        os.environ.pop(name, None)
    env = {"SPARKDL_SERVE_PRECISION_BACKGROUND": INT8, "SPARKDL_OBS_JSONL": jsonl,
           "SPARKDL_PROFILE_DIR": os.path.join(tmp, "profiles"), "SPARKDL_TRACE_SAMPLE": "1",
           "SPARKDL_OBS_DUMP_DIR": dump_dir}
    os.environ.update(env)
    shutdown_feeders()
    serving_env_defaults()
    obs_trace.reset()
    slo.reset()
    specs = {SERVE_TEXT_MODEL: (text_spec, "embed"), SERVE_IMAGE_MODEL: (image_spec, "features")}
    texts = [(ids, INT8_CLASSES[i % 2]) for i, (ids, _) in
             enumerate(_text_requests(seed + 20, text_spec, INT8_TEXT_REQUESTS))]
    images = [(x, INT8_CLASSES[i % 2]) for i, x in enumerate(_image_requests(seed + 20, image_spec, INT8_IMAGE_REQUESTS))]

    def body(model, x, cls):
        out = {"model": model, "inputs": x.tolist(), "priority": cls}
        return {**out, "dtype": "int32", "mode": "embed"} if model == SERVE_TEXT_MODEL else out

    router = Router(seed=seed, device=SERVE_DEVICE)
    server = ServingServer(router, port=0)
    base = f"http://127.0.0.1:{server.port}"
    try:
        # (a) the int8 rung: every model at both rungs, warmed, then the flood
        t0 = time.perf_counter()
        for model, reqs in ((SERVE_TEXT_MODEL, texts), (SERVE_IMAGE_MODEL, images)):
            for x, cls in reqs[:2]:
                status, _, reply, _ = _post(base, body(model, x, cls))
                check(status == 200 and reply["precision"] == ("f32" if cls == "interactive" else INT8),
                      f"int8 (a) warm-up {model} {cls}: HTTP {status} {reply.get('precision', reply)}")
        print(f"int8 (a): {SERVE_TEXT_MODEL} and {SERVE_IMAGE_MODEL} loaded at f32 and {INT8} in "
              f"{time.perf_counter() - t0:.2f} s")
        metrics.reset()
        flash_attention.launches_by_dtype = dict.fromkeys(flash_attention.launches_by_dtype, 0)
        with ThreadPoolExecutor(SERVE_CLIENT_THREADS) as pool:
            t0 = time.perf_counter()
            futs = [(model, x, cls, pool.submit(_post, base, body(model, x, cls)))
                    for model, reqs in ((SERVE_TEXT_MODEL, texts), (SERVE_IMAGE_MODEL, images)) for x, cls in reqs]
            replies = [(model, x, cls, f.result()) for model, x, cls, f in futs]
            flood_s = time.perf_counter() - t0
        launched = dict(flash_attention.launches_by_dtype)
        counters = metrics.snapshot()["counters"]
        bert_dispatches = sum(counters.get(f"serve.dispatches.{SERVE_TEXT_MODEL}.{p}", 0) for p in ("f32", INT8))
        check(launched[torch.float32] == 12 * bert_dispatches > 0 and launched[torch.bfloat16] == 0,
              f"int8 (a): flash launches {launched} against 12 x {bert_dispatches} bert-base dispatches")
        direct = {(m, p): _default_loader(m, mode, p, device="cuda", seed=seed)
                  for m, (_, mode) in specs.items() for p in ("f32", INT8)}
        worst = {}
        for model, x, cls, (status, _, reply, _) in replies:
            rung = "f32" if cls == "interactive" else INT8
            check(status == 200 and reply.get("precision") == rung,
                  f"int8 (a): {model} {cls} got HTTP {status}, precision {reply.get('precision')}")
            got = np.asarray(reply["outputs"], np.float32)
            want = _direct(direct[(model, rung)], x, nhwc=model == SERVE_IMAGE_MODEL)
            err = (float(np.abs(got - want).max()) if model == SERVE_TEXT_MODEL
                   else _relative_error(got, want))
            worst[(model, rung)] = max(worst.get((model, rung), 0.0), err)
        for (model, rung), err in worst.items():
            limit = ATOL[torch.float32] if model == SERVE_TEXT_MODEL else IMAGE_F32_REL
            check(err <= limit, f"int8 (a): {model} at {rung} off its direct build by {err:.3e} (limit {limit})")
        # the card's int8 values and scales against the CPU port's, from the same f32 weights
        same = 0
        for model, (spec, mode) in specs.items():
            card_f32 = direct[(model, "f32")].module
            cpu = spec.model_function(mode=mode, device="cpu").module
            cpu.load_state_dict({k: v.cpu() for k, v in card_f32.state_dict().items()})
            want = _int8_buffers(quantize_module(cpu))
            got = _int8_buffers(direct[(model, INT8)].module)
            check(sorted(got) == sorted(want) and all(torch.equal(got[n].cpu(), want[n]) for n in want),
                  f"int8 (a): {model}'s q and s on the card differ from the CPU's")
            same += len(want)
            del cpu, want, got
        stats = router.stats()
        held = {(m["name"], m["precision"]): m["param_bytes"] for m in stats["models"]}
        for model in specs:
            check(held[(model, INT8)] < held[(model, "f32")] / INT8_BYTES_RATIO,
                  f"int8 (a): {model} holds {held[(model, INT8)]} B at {INT8} against {held[(model, 'f32')]} B at f32")
        _, mem = _get(base, "/v1/memory")
        charged = {}
        for m in stats["models"]:
            charged[m["name"]] = charged.get(m["name"], 0) + m["param_bytes"]
        check(mem["models"] == charged, f"int8 (a): /v1/memory {mem['models']} against residency {charged}")
        # one direct int8 call: its peak stays under half the f32 parameters,
        # and the flash kernel runs 12 times, by the wrapper and the profiler
        int8_text, f32_text = direct[(SERVE_TEXT_MODEL, INT8)], direct[(SERVE_TEXT_MODEL, "f32")]
        f32_bytes = param_bytes(f32_text)
        rng = np.random.default_rng(seed + 20)
        ids = torch.from_numpy(rng.integers(4, text_spec.vocab_size, size=INT8_MEM_BATCH).astype(np.int32)).cuda()
        peaks = {}
        for rung, mf in (("f32", f32_text), (INT8, int8_text)):
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            flash_attention.launches_by_dtype = dict.fromkeys(flash_attention.launches_by_dtype, 0)
            with counted_profile() as prof:
                mf(ids)
            peaks[rung] = (torch.cuda.max_memory_allocated() - before, flash_attention.launches_by_dtype[torch.float32],
                           _flash_kernel_counts(prof)[torch.float32])
        peak, by_wrapper, by_profiler = peaks[INT8]
        check(peak < f32_bytes / 2 and by_wrapper == by_profiler == BERT_BASE_LAYERS,
              f"int8 (a): a direct {INT8_MEM_BATCH} call raised the peak by {peak} B (f32 parameters {f32_bytes} B); "
              f"flash f32 launches {by_wrapper} (profiler {by_profiler})")
        x = torch.from_numpy(rng.integers(4, text_spec.vocab_size, size=INT8_RATE_BATCH).astype(np.int32)).cuda()
        rate = {rung: INT8_RATE_BATCH[0] / (time_ms(lambda mf=mf: mf(x), INT8_RATE_ITERS) / 1e3)
                for rung, mf in (("f32", f32_text), (INT8, int8_text))}
        rung_err = _row_relative_error(int8_text(x).cpu().numpy(), f32_text(x).cpu().numpy())
        del direct, int8_text, f32_text
        torch.cuda.empty_cache()
        print(f"int8 (a) on {card}: {len(texts)} {SERVE_TEXT_MODEL} and {len(images)} {SERVE_IMAGE_MODEL} requests "
              f"over HTTP, half interactive (f32), half background ({INT8}), in {flood_s:.2f} s = "
              f"{len(replies) / flood_s:.1f} requests/s; every reply names its rung; worst error against each "
              f"rung's direct build { {f'{m}@{r}': f'{e:.3e}' for (m, r), e in worst.items()} }; flash f32 launches "
              f"{launched[torch.float32]} = 12 x {bert_dispatches} bert-base dispatches; {same} int8/scale tensors "
              f"equal to the CPU's exactly; resident bytes {held}; /v1/memory equals residency; a direct "
              f"{INT8_MEM_BATCH} call raised max_memory_allocated by {peaks[INT8][0]} B at {INT8} and "
              f"{peaks['f32'][0]} B at f32 (f32 parameters {f32_bytes} B), flash f32 launches {by_wrapper} (profiler "
              f"{by_profiler}); direct {INT8_RATE_BATCH} batches: {rate[INT8]:.1f} rows/s at {INT8} against "
              f"{rate['f32']:.1f} at f32; {INT8} rows against f32, row-relative {rung_err:.3e} (random weights, "
              f"not gated)")

        # (b) POST /admin/profile during an f32 flood
        f32_direct = _default_loader(SERVE_TEXT_MODEL, "embed", "f32", device="cuda", seed=seed)
        flood = [(ids, "interactive") for ids, _ in
                 _text_requests(seed + 21, text_spec, PROFILE_FLOOD)]
        with ThreadPoolExecutor(PROFILE_THREADS + 1) as pool:
            capture = pool.submit(_post_any, base, "/admin/profile", {"seconds": PROFILE_S})
            time.sleep(0.3)
            busy = _post_any(base, "/admin/profile", {"seconds": 1})
            futs = [pool.submit(_post, base, body(SERVE_TEXT_MODEL, ids, cls)) for ids, cls in flood]
            bad = _post_any(base, "/admin/profile", {"seconds": -1})
            flood_replies = [f.result() for f in futs]
            status, reply = capture.result()
        check(status == 200 and reply["path"].startswith(env["SPARKDL_PROFILE_DIR"]),
              f"profile (b): HTTP {status} {reply}")
        check(busy[0] == 409 and bad[0] == 400, f"profile (b): a second capture got {busy}, seconds -1 got {bad}")
        worst_b = 0.0
        for (ids, _), (st, _, rep, _) in zip(flood, flood_replies):
            check(st == 200, f"profile (b): a flood request got HTTP {st}")
            worst_b = max(worst_b, float(np.abs(np.asarray(rep["outputs"], np.float32)
                                                - _direct(f32_direct, ids, nhwc=False)).max()))
        check(worst_b <= ATOL[torch.float32], f"profile (b): flood rows off the direct model by {worst_b:.3e}")
        del f32_direct
        trace_path = os.path.join(reply["path"], TRACE_FILE)
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        flash_in_trace = sum(FLASH_KERNEL_NAMES[1] in e.get("name", "") for e in kernels)
        check(flash_in_trace > 0, f"profile (b): no {FLASH_KERNEL_NAMES[1]} among {len(kernels)} kernel events")
        profiles = _events(jsonl, "profile")
        check(len(profiles) == 1 and profiles[0]["path"] == reply["path"], f"profile (b): profile events {profiles}")
        print(f"profile (b) on {card}: POST /admin/profile {{\"seconds\": {PROFILE_S}}} during {PROFILE_FLOOD} f32 "
              f"{SERVE_TEXT_MODEL} requests from {PROFILE_THREADS} threads: HTTP 200, {trace_path} "
              f"({os.path.getsize(trace_path)} B, {len(events)} events, {len(kernels)} kernel events, "
              f"{flash_in_trace} of {FLASH_KERNEL_NAMES[1]}); a second POST during it got {busy[0]}, seconds -1 "
              f"got {bad[0]}; one profile event; flood rows within {worst_b:.3e} of the direct model")

        # (c) the flight recorder: an SLO trip names its exemplars and dumps
        os.environ.update(CP_SLO)
        slo.reset()
        obs_trace.reset()
        burns0 = {n for n in os.listdir(dump_dir) if n.startswith("obs-slo_burn-")}
        small = [(ids[:, :64], cls) for ids, cls in _text_requests(seed + 22, text_spec, CP_SLO_BATCH)]
        t_flood = time.time()
        with ThreadPoolExecutor(SERVE_CLIENT_THREADS) as pool:
            healthy = list(pool.map(lambda r: _post(base, body(SERVE_TEXT_MODEL, r[0], "batch")), small))
        check(all(r[0] == 200 for r in healthy), "recorder (c): the healthy batch flood failed")
        for ids, _ in small[:CP_SLO_INTERACTIVE]:
            check(_post(base, body(SERVE_TEXT_MODEL, ids, "interactive"))[0] == 200,
                  "recorder (c): an interactive request failed")
        _, st = _get(base, "/v1/slo")
        check(st["classes"]["interactive"]["tripped"], f"recorder (c): interactive did not trip: {st}")
        exemplar_ids = st["exemplars"]["interactive"]
        check(len(exemplar_ids) > 0, f"recorder (c): /v1/slo exemplars {st['exemplars']}")
        live = {0: export.snapshot()}
        sums = []
        for tid in exemplar_ids:
            records = obs_trace.collect_trace(tid, live)
            check(len(records) >= 1, f"recorder (c): exemplar {tid} does not resolve")
            text = obs_trace.render_waterfall(tid, records)
            for rec in records:
                seg = sum(rec["segments"].values())
                check(seg <= rec["e2e_s"] + WATERFALL_SLACK_S and "segments sum" in text,
                      f"recorder (c): {tid}'s segments sum to {seg:.6f} s against e2e {rec['e2e_s']:.6f} s")
                sums.append((seg, rec["e2e_s"]))
        alerts = _events(jsonl, "slo_alert")
        burns = sorted({n for n in os.listdir(dump_dir) if n.startswith("obs-slo_burn-")} - burns0)
        check(len(alerts) == 1 and len(burns) == 1, f"recorder (c): alerts {alerts}, new slo_burn dumps {burns}")
        with open(os.path.join(dump_dir, burns[0])) as f:
            dump = json.load(f)
        alert_ids = alerts[0]["exemplar_trace_ids"]
        dumped_ids = [e["trace_id"] for e in dump["exemplars"].get("serve.latency.interactive", [])]
        check(dump["context"]["cls"] == "interactive" and alert_ids and alert_ids == dumped_ids
              and alert_ids == dump["context"]["exemplar_trace_ids"]
              and all(obs_trace.collect_trace(t, {0: dump}) for t in alert_ids),
              f"recorder (c): the alert's exemplars {alert_ids}, the dump's {dumped_ids}, context {dump['context']}")
        flood_spans = [sp for sp in dump["spans"] if sp["name"] == "serve.dispatch"
                       and sp["attrs"].get("model") == SERVE_TEXT_MODEL and sp["start_unix"] >= t_flood]
        check(flood_spans, f"recorder (c): the dump's span ring ({len(dump['spans'])} spans) holds no flood dispatch")
        earlier = {kind: [n for n in os.listdir(dump_dir) if n.startswith(f"obs-{kind}-")]
                   for kind in ("oom", "canary_rollback")}
        check(all(earlier.values()), f"recorder (c): phase 17's dumps {earlier}")
        dump_path = os.path.join(dump_dir, burns[0])
        chrome = os.path.join(tmp, "dump_chrome.json")
        merged = os.path.join(tmp, "merged.json")
        with ThreadPoolExecutor(4) as pool:
            cli = dict(zip(("report", "trace", "chrome", "merge"), pool.map(lambda a: _obs_cli(*a), (
                ("report", "--snapshot", dump_path), ("trace", alert_ids[0], "--snapshot", dump_path),
                ("chrome", "--snapshot", dump_path, "--out", chrome), ("merge", drops_dir, "--out", merged)))))
        for name, (rc, out, err) in cli.items():
            check(rc == 0, f"recorder: python -m sparkdl_tpu_torch.obs {name} exited {rc}: {err[-2000:]}")
        check("serve.dispatch" in cli["report"][1] and alert_ids[0] in cli["trace"][1],
              f"recorder (c): report or trace printed neither the stage nor the id: {cli['trace'][1][:500]}")
        with open(chrome) as f:
            chrome_events = json.load(f)["traceEvents"]
        check(any(e["ph"] == "X" for e in chrome_events), "recorder (c): the dump's Chrome trace has no span")
        for name in CP_SLO:
            os.environ.pop(name)
        slo.reset()
        print(f"recorder (c): {CP_SLO_BATCH} batch then {CP_SLO_INTERACTIVE} interactive requests tripped interactive; "
              f"/v1/slo names {len(exemplar_ids)} exemplars, each resolved by collect_trace with segments summing "
              f"to {[f'{a * 1e3:.3f}/{b * 1e3:.3f} ms' for a, b in sums]} of e2e; the slo_alert's "
              f"{len(alert_ids)} exemplar ids equal the dump's and resolve in it; {burns[0]} "
              f"({os.path.getsize(dump_path)} B, {len(dump['spans'])} spans, {len(flood_spans)} flood dispatches); "
              f"phase 17 left {earlier}; obs report / trace / chrome on the dump exited 0 "
              f"({len(chrome_events)} Chrome events)")

        # (d) phase 19's rank drops merged; the pull exporter
        with open(merged) as f:
            merged_events = json.load(f)["traceEvents"]
        lanes = {e["pid"] for e in merged_events if e["ph"] == "X"}
        labels = [e["args"]["name"] for e in merged_events if e.get("name") == "process_name"]
        check(lanes == set(range(BATCH_RANKS)) and len(labels) == BATCH_RANKS,
              f"merge (d): lanes {lanes}, labels {labels}")
        exporter = obs_serve.start_server(port=0)
        try:
            codes = {}
            for path in OBS_PATHS:
                with urllib.request.urlopen(f"http://127.0.0.1:{exporter.port}{path}", timeout=60) as resp:
                    codes[path] = resp.status
        finally:
            obs_serve.stop_server()
        check(all(c == 200 for c in codes.values()), f"exporter (d): {codes}")
        print(f"merge (d): python -m sparkdl_tpu_torch.obs merge over phase 19's drops: {len(merged_events)} events "
              f"in lanes {sorted(lanes)} ({labels}); the exporter on port 0 answered {codes}")
    finally:
        server.stop(close_router=True)
        shutdown_feeders()
        for name in env:
            os.environ.pop(name, None)
        for name in CP_SLO:
            os.environ.pop(name, None)
        slo.reset()
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s in all")
    return launched[torch.float32]


def _tf_graph(seed: int):
    """Phase 21's ResNet50 as a frozen GraphDef: (bytes, input name, output
    name, the Keras spec of the same config and weights)."""
    sys.path.insert(0, FIXTURES)
    try:
        from tf_graph_writer import frozen_graph_def
    finally:
        sys.path.remove(FIXTURES)
    config = _resnet50_config()
    spec = KerasModelSpec(config, _seeded_keras_weights(config, seed))
    raw, feed, fetch = frozen_graph_def(spec)
    return raw, feed, fetch, spec


def _forward_peak(mf, x) -> int:
    """Bytes allocated at the peak of one forward above the allocation
    before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = mf(x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del y
    return peak


def phase_tf_ingest(seed: int, device_name: str, device="cuda") -> None:
    """Phase 21: TF model ingestion on the card (``device="cpu"``: a
    rehearsal without NVML, the profiler's device side and the memory
    check)."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    on_card = device.type == "cuda"

    t0 = time.perf_counter()
    raw, feed, fetch, spec = _tf_graph(seed)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mf = TFInputGraph.from_graph_def(raw, [feed], [fetch], input_shape=(KERAS_SIDE, KERAS_SIDE, 3), device=device)
    _sync(device)
    ingest_s = time.perf_counter() - t0
    check(mf.takes_nhwc and mf.device == device, f"tf ingest: {mf.name} on {mf.device}")
    print(f"tf ingest (21a): frozen GraphDef of Keras ResNet50 written without TF in {write_s:.2f} s "
          f"({len(raw)} bytes), ingested on {mf.device} in {ingest_s:.2f} s "
          f"({len(mf.module.tf_names)} lifted weights)")
    structs, _ = _colour_structs(seed, TF_IMAGES, KERAS_SIDE)
    df = DataFrame.fromColumns({"image": structs}, numPartitions=IMAGE_PARTITIONS)
    warm = DataFrame.fromColumns({"image": structs[:64]}, numPartitions=1)
    kw = dict(inputCol="image", outputCol="out", outputMode="vector", preprocessing="caffe",
              batchSize=IMAGE_BATCH)
    stage = TFImageTransformer(modelFunction=mf, **kw)
    _featurize(stage, warm, "out")
    flash_attention.launches = 0
    flash_attention.launches_by_dtype = dict.fromkeys(flash_attention.launches_by_dtype, 0)
    probe = utilization.NvmlBusyProbe(torch.cuda.current_device()) if on_card else None
    try:
        busy0 = probe() if on_card else 0.0
        rows, dt = _featurize(stage, df, "out")
        if on_card:
            time.sleep(2 * probe.poll_s)  # NVML's last sample of the pass
        busy = probe() - busy0 if on_card else float("nan")
    finally:
        if on_card:
            probe.close()
    flash_launches = flash_attention.launches
    for i, r in enumerate(rows):
        check(r is not None and r.shape == (1000,) and bool(np.isfinite(r).all()),
              f"tf ingest: row {i} is not a finite 1000-d vector")
    card = np.stack(rows)
    print(f"tf ingest (21a) TFImageTransformer over the translated ResNet50 {KERAS_SIDE}x{KERAS_SIDE} float32 on "
          f"{device_name}: {TF_IMAGES} images, {IMAGE_PARTITIONS} partitions, batch {IMAGE_BATCH}, {dt:.3f} s = "
          f"{TF_IMAGES / dt:.1f} images/s; NVML busy {busy:.3f} s = share {busy / dt:.3f} of the pass "
          f"(polled every {probe.poll_s if on_card else 'never'} s); flash launches {flash_launches}")
    check(flash_launches == 0, f"tf ingest: the translated graph launched the flash kernel {flash_launches} times")
    # (b) the same config and weights as a KerasModule on the card; the
    # translated graph on the CPU for a sample of rows
    keras_mf = ModelIngest.from_keras(spec, device=device)
    keras_rows, keras_dt = _featurize(ImageModelTransformer(modelFunction=keras_mf, **kw), df, "out")
    keras_err = _relative_error(card, np.stack(keras_rows))
    spread_rows = _sample_rows(TF_IMAGES)
    sample = [spread_rows[i] for i in np.linspace(0, len(spread_rows) - 1, TF_CPU_ROWS).round().astype(int)]
    cpu_mf = TFInputGraph.from_graph_def(raw, [feed], [fetch], input_shape=(KERAS_SIDE, KERAS_SIDE, 3), device="cpu")
    few = DataFrame.fromColumns({"image": [structs[i] for i in sample]}, numPartitions=1)
    cpu_rows, cpu_dt = _featurize(TFImageTransformer(modelFunction=cpu_mf, **kw), few, "out")
    cpu_err = _relative_error(card[sample], np.stack(cpu_rows))
    print(f"tf ingest (21b): card rows against KerasModule on the card ({keras_dt:.3f} s = "
          f"{TF_IMAGES / keras_dt:.1f} images/s) relative error {keras_err:.3e}, {len(sample)} rows against the "
          f"translated graph on the CPU ({cpu_dt:.2f} s) {cpu_err:.3e} (limit {IMAGE_F32_REL}); max |prob| "
          f"{card.max():.4f}, least row max {card.max(axis=1).min():.4f}")
    check(keras_err <= IMAGE_F32_REL, f"tf ingest: card vs KerasModule relative error {keras_err:.3e}")
    check(cpu_err <= IMAGE_F32_REL, f"tf ingest: card vs CPU relative error {cpu_err:.3e}")
    # (c) one warm batch: no read back inside the forward, and the walk's
    # peak memory against KerasModule's
    batch = image_structs_to_batch(structs[:IMAGE_BATCH], height=KERAS_SIDE, width=KERAS_SIDE, chw=False)[0]
    # BGR minus the caffe mean, NHWC: what the converter hands the graph
    x = torch.from_numpy(batch).to(device).float() - torch.from_numpy(CAFFE_MEAN_BGR).to(device)
    x_nchw = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    for _ in range(2):
        mf(x)
        keras_mf(x_nchw)
    _sync(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        y = mf(x)
        _sync(device)
    names = [e.name for e in prof.events()]
    d2h = [n for n in names if "DtoH" in n or "Memcpy D2H" in n]
    syncs = [n for n in names if n in ("aten::_local_scalar_dense", "aten::item")]
    kernels = device_kernels(prof) if on_card else {"(cpu)": (0.0, 0)}
    tf_peak = _forward_peak(mf, x) if on_card else 0
    keras_peak = _forward_peak(keras_mf, x_nchw) if on_card else 1
    batch_err = _relative_error(y.cpu().numpy(), keras_mf(x_nchw).cpu().numpy())
    print(f"tf ingest (21c): one warm batch of {IMAGE_BATCH} under torch.profiler: {len(kernels)} device kernels, "
          f"{sum(sec for sec, _ in kernels.values()) * 1e3:.3f} ms of device time, {len(d2h)} device-to-host "
          f"copies, {len(syncs)} scalar reads; peak memory over the batch {tf_peak} B translated against {keras_peak} B "
          f"KerasModule = {tf_peak / keras_peak:.3f} (limit {TF_PEAK_RATIO}); batch vs KerasModule {batch_err:.3e}")
    check(kernels, "tf ingest: the profiler saw no device kernel")
    check(not d2h and not syncs, f"tf ingest: the translated forward reads the device back: {d2h + syncs}")
    check(batch_err <= IMAGE_F32_REL, f"tf ingest: one batch vs KerasModule relative error {batch_err:.3e}")
    check(tf_peak <= TF_PEAK_RATIO * keras_peak,
          f"tf ingest: peak {tf_peak} B over {TF_PEAK_RATIO} x KerasModule's {keras_peak} B")
    del mf, keras_mf, cpu_mf, x, x_nchw, y
    shutdown_feeders()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    # (d) the parity matrix over the small fixture, through TFTransformer
    io = np.load(os.path.join(TF_MODEL_DIR, "io.npz"))
    probs_out = str(io["gd_outputs"][1])  # dict outputs in sorted-key order: features, probs
    doors = {
        "GraphDef": TFInputGraph.from_graph_def(os.path.join(TF_MODEL_DIR, "frozen.pb"), [str(io["gd_inputs"][0])],
                                                [probs_out], device=device),
        "SavedModel": TFInputGraph.from_saved_model(os.path.join(TF_MODEL_DIR, "saved_model"), outputs=["probs"],
                                                    device=device),
        "checkpoint": TFInputGraph.from_tf_checkpoint(os.path.join(TF_MODEL_DIR, "ckpt", "model"), ["image"],
                                                      ["probs"], device=device),
    }
    arrays = DataFrame.fromColumns({"x": list(io["x"])}, numPartitions=2)
    outs = {}
    for door, door_mf in doors.items():
        rows = TFTransformer(inputCol="x", outputCol="probs", modelFunction=door_mf).transform(arrays).collect()
        outs[door] = np.stack([r.probs for r in rows])
    errs = {door: _relative_error(o, io["probs"]) for door, o in outs.items()}
    spread = max(_relative_error(o, outs["GraphDef"]) for o in outs.values())
    print("tf ingest (21d): TFTransformer on the card over the small fixture's " + ", ".join(
        f"{door} {err:.3e}" for door, err in errs.items()) + f" off TF's stored outputs (limit {TF_PARITY_REL}); "
          f"formats against each other {spread:.3e}")
    check(all(err <= TF_PARITY_REL for err in errs.values()), f"tf ingest: a format is off TF's outputs: {errs}")
    check(spread <= TF_PARITY_REL, f"tf ingest: the formats disagree by {spread:.3e}")
    # (e) nothing of TF in the process
    present = [m for m in ("tensorflow", "google.protobuf") if m in sys.modules]
    print(f"tf ingest (21e): tensorflow in sys.modules {'tensorflow' in sys.modules}, google.protobuf "
          f"{'google.protobuf' in sys.modules}")
    check(not present, f"tf ingest: {present} imported")


#: the child process of phase 22(a): loads the exported program in a fresh
#: interpreter, then times it and reads the flash counters
_LOAD_CHILD = r"""
import json, sys, time
import numpy as np, torch
from sparkdl_tpu_torch.graph.function import ModelFunction
path, ids_file, out_file, iters, device = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]), sys.argv[5]
fresh = "sparkdl_tpu_torch.ops.flash_attention" not in sys.modules
t0 = time.perf_counter()
mf = ModelFunction.load(path, device=device)
load_s = time.perf_counter() - t0
from sparkdl_tpu_torch.ops.flash_attention import flash_attention
ids = torch.from_numpy(np.load(ids_file)).to(device)
sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
for _ in range(3):
    out = mf(ids)
sync()
flash_attention.launches = 0
t0 = time.perf_counter()
for _ in range(iters):
    out = mf(ids)
sync()
dt = time.perf_counter() - t0
np.save(out_file, out.float().cpu().numpy())
print(json.dumps({"fresh": fresh, "load_s": load_s, "launches": flash_attention.launches,
                  "rows_per_s": iters * ids.shape[0] / dt}))
"""


def _dir_mb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(r, n)) for r, _, names in os.walk(path) for n in names) / 1e6


def _timed_calls(mf, x, iters: int, device) -> float:
    """Seconds for ``iters`` warm calls of ``mf`` on ``x``."""
    for _ in range(3):
        mf(x)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        mf(x)
    _sync(device)
    return time.perf_counter() - t0


def phase_export_ingest(seed: int, device_name: str, tmp: str, device="cuda") -> dict:
    """Phase 22: exported programs and orbax checkpoints (``device="cpu"``:
    a rehearsal, with the models cut by the caller). Returns the flash
    launches by dtype."""
    from sparkdl_tpu_torch.graph.function import piece
    from sparkdl_tpu_torch.graph.orbax_ckpt import OcdbtStore, read_orbax_checkpoint
    from sparkdl_tpu_torch.models.bert import BertConfig, BertEncoder
    from sparkdl_tpu_torch.ops.flash_attention import make_flash_attention_fn
    from sparkdl_tpu_torch.utils import zstd

    from sparkdl_tpu_torch.ops import flash_attention as fa

    device = torch.device(device)
    on_card = device.type == "cuda"
    launches = {}
    if on_card:
        q, k, v = (torch.randn(1, 1, 64, 64, device=device, dtype=torch.bfloat16) for _ in range(3))
        m = torch.zeros(1, 64, device=device)
        calls = {"bare": fa._launch, "op": fa.flash_attention_op, "public": fa.flash_attention}
        per_call = {name: [] for name in list(calls) + ["op_grad_mode"]}
        # interleaved rounds, under inference_mode as the main path calls it;
        # the op once more outside it, where its autograd formula is passed
        for _ in range(DISPATCH_ROUNDS):
            for name in per_call:
                call = calls.get(name, fa.flash_attention_op)
                with torch.inference_mode(name != "op_grad_mode"):
                    for _ in range(50):
                        call(q, k, v, m)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(DISPATCH_CALLS):
                        call(q, k, v, m)
                    per_call[name].append((time.perf_counter() - t0) / DISPATCH_CALLS * 1e6)
                    torch.cuda.synchronize()
        med = {name: statistics.median(v) for name, v in per_call.items()}
        extra = [o - b for o, b in zip(per_call["op"], per_call["bare"])]
        print(f"export (22): flash dispatch, host us per warm call, median (min-max) of {DISPATCH_ROUNDS} interleaved "
              f"rounds of {DISPATCH_CALLS} calls under inference_mode: bare ctypes launch {med['bare']:.2f} "
              f"({min(per_call['bare']):.2f}-{max(per_call['bare']):.2f}), registered op {med['op']:.2f} "
              f"({min(per_call['op']):.2f}-{max(per_call['op']):.2f}), op minus bare per round median "
              f"{statistics.median(extra):+.2f} ({min(extra):+.2f} to {max(extra):+.2f}), public flash_attention "
              f"{med['public']:.2f}; the op in grad mode {med['op_grad_mode']:.2f}")
    # (a) the bert-base text composite, bf16 rung, through a child process
    mf = bf16_rung(get_model(EXPORT_TEXT_MODEL).model_function(dtype=torch.bfloat16, seed=seed, device=device))
    comp = piece(lambda ids: (ids, (ids != 0).to(torch.int32)), name="mask").and_then(mf)
    comp = replace(comp, input_shape=(EXPORT_TEXT_LEN,), input_dtype=torch.int32)
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, mf.vocab_size, size=(EXPORT_BATCH, EXPORT_TEXT_LEN)).astype(np.int32)
    for i, n in enumerate(rng.integers(8, EXPORT_TEXT_LEN + 1, size=EXPORT_BATCH)):
        ids[i, n:] = 0
    path = os.path.join(tmp, "bert_export")
    t0 = time.perf_counter()
    comp.export(path)
    export_s = time.perf_counter() - t0
    x = torch.from_numpy(ids).to(device)
    direct_dt = _timed_calls(comp, x, EXPORT_ITERS, device)
    direct = comp(x).float().cpu().numpy()
    ids_file, out_file = os.path.join(tmp, "ids.npy"), os.path.join(tmp, "loaded_rows.npy")
    np.save(ids_file, ids)
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", _LOAD_CHILD, path, ids_file, out_file, str(EXPORT_ITERS), device.type],
        cwd=root, env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"export (22a): the child's load failed: {proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    loaded = np.load(out_file)
    diff = float(np.abs(loaded - direct).max())
    per_dispatch = child["launches"] / EXPORT_ITERS
    direct_rps = EXPORT_ITERS * EXPORT_BATCH / direct_dt
    layers = mf.module.config.num_layers
    print(f"export (22a): {EXPORT_TEXT_MODEL} text composite, bf16 rung, L={EXPORT_TEXT_LEN}, batch {EXPORT_BATCH} on "
          f"{device_name}: exported in {export_s:.2f} s ({_dir_mb(path):.1f} MB: program.pt2 "
          f"{os.path.getsize(os.path.join(path, 'program.pt2')) / 1e6:.1f} MB), loaded in a fresh process in "
          f"{child['load_s']:.2f} s (op module not imported before load: {child['fresh']}); loaded rows vs direct "
          f"max |diff| {diff:.3e} (limit {ATOL[torch.bfloat16]}); flash launches per loaded dispatch "
          f"{per_dispatch:g} (expected {layers}); loaded {child['rows_per_s']:.1f} rows/s, direct "
          f"{direct_rps:.1f} rows/s, ratio {child['rows_per_s'] / direct_rps:.3f}")
    check(child["fresh"], "export (22a): the child imported the op's module before load")
    check(np.isfinite(loaded).all() and loaded.shape == direct.shape, "export (22a): loaded rows malformed")
    check(diff <= ATOL[torch.bfloat16], f"export (22a): loaded rows off the direct ones by {diff:.3e}")
    # the CPU runs the kernel's plain version, which counts no launch
    check(per_dispatch == (layers if on_card else 0), f"export (22a): {per_dispatch} flash launches per dispatch")
    launches[torch.bfloat16] = child["launches"]
    del mf, comp, x
    shutil.rmtree(path)
    # (b) the featurizer's ResNet50, f32
    weights = os.path.join(tmp, f"{EXPORT_IMAGE_MODEL}.npz")
    _write_seeded_weights(EXPORT_IMAGE_MODEL, seed, weights)
    img_mf = _featurizer(EXPORT_IMAGE_MODEL, "float32", weights, device=device)._inner().getModelFunction()
    side = img_mf.input_shape[0]
    path = os.path.join(tmp, "resnet_export")
    t0 = time.perf_counter()
    img_mf.export(path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    img_loaded = ModelFunction.load(path, device=device)
    load_s = time.perf_counter() - t0
    convs = [m.weight for m in img_loaded.module.modules() if isinstance(m, torch.nn.Conv2d)]
    convs = convs or [t for n, t in img_loaded.module.named_parameters() if t.dim() == 4]
    cl = all(w.is_contiguous(memory_format=torch.channels_last) for w in convs)
    nhwc = torch.from_numpy(rng.random((EXPORT_BATCH, side, side, 3), dtype=np.float32) * 255 - 120).to(device)
    xi = nhwc.permute(0, 3, 1, 2)  # the view model_device_fn hands the model
    direct_dt = _timed_calls(img_mf, xi, EXPORT_ITERS, device)
    loaded_dt = _timed_calls(img_loaded, xi, EXPORT_ITERS, device)
    err = _relative_error(img_loaded(xi).cpu().numpy(), img_mf(xi).cpu().numpy())
    ratio = direct_dt / loaded_dt
    print(f"export (22b): {EXPORT_IMAGE_MODEL} features (DeepImageFeaturizer's ModelFunction), f32 {side}x{side}: "
          f"exported in {export_s:.2f} s, loaded in {load_s:.2f} s ({_dir_mb(path):.1f} MB); rows vs direct relative "
          f"{err:.3e} (limit {EXPORT_IMAGE_REL}); {len(convs)} conv weights channels_last: {cl}; loaded "
          f"{EXPORT_ITERS * EXPORT_BATCH / loaded_dt:.1f} images/s, direct "
          f"{EXPORT_ITERS * EXPORT_BATCH / direct_dt:.1f}, ratio {ratio:.3f}")
    check(err <= EXPORT_IMAGE_REL, f"export (22b): loaded rows off by {err:.3e}")
    check(not on_card or (convs and cl), "export (22b): the loaded convs lost channels_last")
    del img_mf, img_loaded, nhwc, xi
    shutil.rmtree(path)
    os.remove(weights)
    shutdown_feeders()
    gc.collect()
    # (c) the committed orbax fixture
    io = np.load(os.path.join(ORBAX_DIR, "io.npz"))
    ckpt = os.path.join(ORBAX_DIR, "ckpt")
    t0 = time.perf_counter()
    read_orbax_checkpoint(ckpt)
    read_s = time.perf_counter() - t0
    store = OcdbtStore(ckpt)
    frames = [v for v in (store.get(k.decode()) for k in store.entries if not k.endswith(b".zarray"))
              if v[:4] == b"\x28\xb5\x2f\xfd"]
    t0 = time.perf_counter()
    out_bytes = sum(len(zstd.decompress(v)) for v in frames)
    zstd_s = time.perf_counter() - t0
    config = BertConfig(**json.loads(str(io["config"])))
    t0 = time.perf_counter()
    omf = ModelIngest.from_orbax_checkpoint(ckpt, BertEncoder(config, make_flash_attention_fn()), device=device)
    ingest_s = time.perf_counter() - t0
    flash_attention.launches = 0
    rows = omf(torch.from_numpy(io["ids"]).to(device)).cpu().numpy()
    launches[torch.float32] = flash_attention.launches
    err = float(np.abs(rows - io["y_jax"]).max())
    limit = ORBAX_ROW_TOL * max(1.0, float(np.abs(io["y_jax"]).max()))
    print(f"orbax (22c): the committed fixture ({config.num_layers} layers, hidden {config.hidden_size}) read in "
          f"{read_s:.3f} s, ingested on {omf.device} in {ingest_s:.3f} s; zstd decoded {len(frames)} frames, "
          f"{sum(len(v) for v in frames)} -> {out_bytes} bytes in {zstd_s:.3f} s = {out_bytes / zstd_s / 1e6:.2f} MB/s; "
          f"rows vs the JAX outputs max |diff| {err:.3e} (limit {limit:.1e}); f32 flash launches "
          f"{launches[torch.float32]} (expected {config.num_layers})")
    check(rows.shape == io["y_jax"].shape and err <= limit, f"orbax (22c): rows off the JAX outputs by {err:.3e}")
    check(launches[torch.float32] == (config.num_layers if on_card else 0),
          f"orbax (22c): {launches[torch.float32]} flash launches")
    # (d) the bf16 GraphDef
    tio = np.load(os.path.join(TF_BF16_DIR, "io.npz"))
    gmf = TFInputGraph.from_graph_def(os.path.join(TF_BF16_DIR, "graph.pb"), [str(n) for n in tio["inputs"]],
                                      [str(n) for n in tio["outputs"]], device=device)
    y = gmf(torch.from_numpy(tio["x"]).to(device, torch.bfloat16))
    want = tio["y_jax"]
    err = float(np.abs(y.float().cpu().numpy() - want).max())
    limit = BF16_STEP * float(np.abs(want).max())
    print(f"tf bf16 (22d): MatMul + BiasAdd over bfloat16 constants on {gmf.device}: result {y.dtype} "
          f"{tuple(y.shape)}, max |diff| to the JAX outputs {err:.3e} (one bf16 step of the largest: {limit:.3e}); "
          f"lifted weights {[str(t.dtype) for t in gmf.module.tf_state_dict().values()]}")
    check(y.dtype == torch.bfloat16, f"tf bf16 (22d): the result is {y.dtype}")
    check(err <= limit, f"tf bf16 (22d): off the JAX outputs by {err:.3e}")
    # (e) a bert-base checkpoint in orbax's use_ocdbt=False layout,
    # uncompressed (no zstd compressor on this machine), bound and run
    # against the seeded model it was written from
    from sparkdl_tpu_torch.models.convert import bert_params_to_flax

    sys.path.insert(0, FIXTURES)
    try:
        from orbax_writer import write_plain_checkpoint
    finally:
        sys.path.remove(FIXTURES)
    direct = get_model(EXPORT_TEXT_MODEL).model_function(dtype=torch.float32, seed=seed, device=device)
    path = os.path.join(tmp, "bert_orbax")
    t0 = time.perf_counter()
    nbytes = write_plain_checkpoint(path, bert_params_to_flax(direct.module))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = read_orbax_checkpoint(path)
    read_s = time.perf_counter() - t0
    leaves = len(list(_flat_tree(tree)))
    del tree
    t0 = time.perf_counter()
    bmf = ModelIngest.from_orbax_checkpoint(path, BertEncoder(direct.module.config, make_flash_attention_fn()),
                                            device=device)
    ingest_s = time.perf_counter() - t0
    x = torch.from_numpy(ids).to(device)
    flash_attention.launches = 0
    rows = bmf(x).float().cpu().numpy()
    orbax_launches = flash_attention.launches
    launches[torch.float32] += orbax_launches
    with torch.inference_mode():
        want = direct.module(x).float().cpu().numpy()
    err = float(np.abs(rows - want).max())
    print(f"orbax (22e): {EXPORT_TEXT_MODEL} flax variables ({leaves} leaves, {nbytes / 1e6:.1f} MB f32) written in "
          f"orbax's use_ocdbt=False layout, uncompressed, in {write_s:.2f} s; read in {read_s:.2f} s = "
          f"{nbytes / read_s / 1e6:.1f} MB/s; from_orbax_checkpoint on {bmf.device} in {ingest_s:.2f} s; hidden "
          f"states [{', '.join(map(str, rows.shape))}] vs the model it was written from max |diff| {err:.3e} "
          f"(limit 0); f32 flash launches {orbax_launches}")
    check(rows.shape == want.shape and np.isfinite(rows).all(), "orbax (22e): rows malformed")
    check(err == 0.0, f"orbax (22e): rows off the direct build by {err:.3e}")
    check(orbax_launches == (direct.module.config.num_layers if on_card else 0),
          f"orbax (22e): {orbax_launches} flash launches")
    del direct, bmf, x
    shutil.rmtree(path)
    return launches


def _jax_lr_pipeline(weights: str, device) -> tuple:
    """Phase 23(a)'s stage saved by the JAX package, loaded and bound to
    ``weights`` in f32; and the port's own PipelineModel with the same
    weights, ``w`` and ``b``."""
    from sparkdl_tpu_torch.estimators.logistic_regression import LogisticRegressionModel

    loaded = persistence.load(os.path.join(JAX_STAGES, "resnet50_lr"), device=device)
    check(type(loaded) is PipelineModel and [type(st).__name__ for st in loaded.stages]
          == ["DeepImageFeaturizer", "LogisticRegressionModel"],
          f"jax stages (23a): loaded {type(loaded).__name__} of {[type(st).__name__ for st in getattr(loaded, 'stages', [])]}")
    featurizer, head = loaded.stages
    featurizer._set(weightsFile=weights, computeDtype="float32", batchSize=IMAGE_BATCH)
    with np.load(os.path.join(JAX_STAGES, "resnet50_lr", "stages", "1_LogisticRegressionModel_fixture",
                              "model.npz")) as z:
        w, b = z["w"], z["b"]
    own = PipelineModel([
        _featurizer("ResNet50", "float32", weights, device=device),
        LogisticRegressionModel(w=w, b=b, featuresCol="features", predictionCol="prediction",
                                probabilityCol="probability", device=device),
    ])
    return loaded, own, head, w, b


def _pipeline_rows(stage, df) -> tuple:
    """One pass: ((prediction, probability, features) per row, seconds)."""
    t0 = time.perf_counter()
    rows = stage.transform(df).collect()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return [(r["prediction"], r["probability"], r["features"]) for r in rows], dt


def _max_row_diff(a, b) -> float:
    worst = 0.0
    for (pa, qa, fa), (pb, qb, fb) in zip(a, b):
        check(pa == pb, f"jax stages (23a): predictions differ ({pa} vs {pb})")
        worst = max(worst, float(np.abs(np.asarray(qa) - np.asarray(qb)).max()),
                    float(np.abs(np.asarray(fa) - np.asarray(fb)).max()))
    return worst


def _expression_columns(scored):
    """Phase 23(b)'s query on the Column surface (``X_SQL`` on the text one)."""
    from sparkdl_tpu_torch import functions as sf

    total = sf.aggregate("emb", sf.lit(0.0), lambda acc, x: acc + x)
    squares = sf.aggregate("emb", sf.lit(0.0), lambda acc, x: acc + x * x)
    mean = total / 768
    id_s = sf.col("id").cast("string")
    return (
        scored
        .withColumn("tag2", sf.coalesce(sf.col("tag"), sf.lit("none")))
        .where(~sf.col("tag").eqNullSafe("t3") & sf.col("text").rlike("^w[0-9]")
               & (sf.col("id") % 4).isin(0, 1, 3))
        .select(
            "id",
            sf.when(mean > 0, "pos").otherwise("neg").alias("sign"),
            sf.concat(id_s, sf.lit(":"), sf.col("tag2")).alias("key"),
            sf.concat_ws("-", sf.col("tag"), id_s).alias("label"),
            sf.round(sf.sqrt(squares), 6).alias("norm6"),
            mean.alias("mean"),
            sf.element_at(sf.transform("emb", lambda x: x * 2.0), 1).alias("first2"),
            (sf.col("id").cast("double") / 3).alias("third"),
        )
        .orderBy("id")
    )


def _expected_expression_rows(ids, tags, texts, embs) -> list:
    """Phase 23(b)'s rows computed in numpy from the collected embeddings."""
    import re as _re

    out = []
    for i, tag, text, e in zip(ids, tags, texts, embs):
        if tag == "t3" or not _re.search("^w[0-9]", text) or i % 4 not in (0, 1, 3):
            continue
        e64 = np.asarray(e, np.float64)
        mean = float(e64.sum()) / 768
        out.append({
            "id": i, "sign": "pos" if mean > 0 else "neg",
            "key": f"{i}:{tag if tag is not None else 'none'}",
            "label": f"{tag}-{i}" if tag is not None else f"{i}",
            # round() is HALF_UP to 6 places, as Spark's
            "norm6": math.floor(float(np.sqrt((e64 * e64).sum())) * 1e6 + 0.5) / 1e6, "mean": mean,
            "first2": 2.0 * float(e64[0]), "third": i / 3,
        })
    return out


def phase_jax_stages_expressions(seed: int, device_name: str, tmp: str, device="cuda") -> int:
    """Phase 23: stages saved by the JAX package, and row expressions over
    bert-base scores and inside a model UDF (``device="cpu"``: a rehearsal,
    with the sizes cut by the caller). Returns 23(b)'s flash launches."""
    from PIL import Image

    from sparkdl_tpu_torch.sql import dropTempTable

    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = f"{device_name} ({_smi()})" if on_card else device_name
    # (a) the JAX-saved ResNet50 + LR pipeline at full width, f32
    t0 = time.perf_counter()
    weights = os.path.join(tmp, "ResNet50.npz")
    _write_seeded_weights("ResNet50", seed, weights)
    structs, _ = _colour_structs(seed, X_IMAGES, 224)
    print(f"jax stages (23a): seeded ResNet50 weights and {len(structs)} 224x224 structs in "
          f"{time.perf_counter() - t0:.2f} s (host)")
    loaded, own, head, w, b = _jax_lr_pipeline(weights, device)
    check(np.array_equal(head.w.cpu().numpy(), w) and np.array_equal(head.b.cpu().numpy(), b)
          and head.w.device.type == device.type,
          "jax stages (23a): the loaded w/b are not the fixture's model.npz bit for bit")
    df = DataFrame.fromColumns({"image": structs}, numPartitions=IMAGE_PARTITIONS)
    warm = DataFrame.fromColumns({"image": structs[:64]}, numPartitions=1)
    for stage in (loaded, own):
        _pipeline_rows(stage, warm)  # model build, cuDNN and allocator warm-up: not counted
    loaded_rows, loaded_dt = _pipeline_rows(loaded, df)
    os.environ["SPARKDL_SHARED_FEEDER"] = "0"  # the same batches on both sides
    try:
        loaded_own_batches, _ = _pipeline_rows(loaded, df)
        own_rows, own_dt = _pipeline_rows(own, df)
    finally:
        os.environ.pop("SPARKDL_SHARED_FEEDER")
    check(len(loaded_rows) == len(structs) and all(
        r[2] is not None and r[2].shape == (2048,) and bool(np.isfinite(r[2]).all())
        and r[1] is not None and bool(np.isfinite(np.asarray(r[1])).all()) for r in loaded_rows),
        "jax stages (23a): a row without finite features or probabilities")
    diff = _max_row_diff(loaded_own_batches, own_rows)
    check(diff == 0.0, f"jax stages (23a): the JAX-saved pipeline's rows differ from the port's own by {diff:.3e}")
    shared_diff = _max_row_diff(loaded_rows, own_rows)
    check(shared_diff <= IMAGE_F32_REL * max(float(np.abs(np.stack([r[2] for r in own_rows])).max()), 1.0),
          f"jax stages (23a): the shared feeder's rows differ from the per-partition rows by {shared_diff:.3e}")
    phase6 = IMAGE_RATES.get(("ResNet50", "float32"))
    print(f"jax stages (23a) on {card}: JAX-saved PipelineModel(DeepImageFeaturizer ResNet50 f32 -> "
          f"LogisticRegressionModel [2048, 2]) over {len(structs)} images: {loaded_dt:.3f} s = "
          f"{len(structs) / loaded_dt:.1f} images/s (phase 6's f32 featurizer alone in this run: "
          f"{'not run' if phase6 is None else f'{phase6:.1f} images/s'}); the port's own pipeline, one "
          f"pipeline per partition: {own_dt:.3f} s = {len(structs) / own_dt:.1f} images/s; rows vs the "
          f"port's own max |diff| {diff:.1e} (limit 0), shared feeder vs per partition {shared_diff:.3e}; "
          f"w/b bit-equal to model.npz")
    del loaded, own, structs, df
    # the JAX-saved Keras stage against the port's own over the same .keras file
    rng = np.random.default_rng(seed + 23)
    uris = []
    for i in range(X_KERAS_PNGS):
        path = os.path.join(tmp, f"cnn_{i}.png")
        Image.fromarray(rng.integers(0, 256, size=(16 + 3 * i, 20, 3), dtype=np.uint8), "RGB").save(path)
        uris.append(path)
    uris.append(None)
    kdf = DataFrame.fromColumns({"uri": uris}, numPartitions=2)
    kstage = persistence.load(os.path.join(JAX_STAGES, "keras_cnn"), device=device)
    check(type(kstage) is KerasImageFileTransformer, f"jax stages (23a): keras_cnn loaded as {type(kstage).__name__}")
    kown = KerasImageFileTransformer(
        inputCol="uri", outputCol="scores", modelFile=os.path.join(FIXTURES, f"{FIXTURE_MODEL}.keras"),
        batchSize=kstage.getOrDefault("batchSize"), preprocessing=kstage.getOrDefault("preprocessing"),
        device=device,
    )
    k_rows = [r["scores"] for r in kstage.transform(kdf).collect()]
    k_own = [r["scores"] for r in kown.transform(kdf).collect()]
    check(k_rows[-1] is None and k_own[-1] is None, "jax stages (23a): the None URI did not give a null row")
    k_diff = max(float(np.abs(np.asarray(a) - np.asarray(c)).max()) for a, c in zip(k_rows[:-1], k_own[:-1]))
    check(k_diff == 0.0, f"jax stages (23a): keras_cnn rows differ from the port's own by {k_diff:.3e}")
    print(f"jax stages (23a): JAX-saved KerasImageFileTransformer (embedded model.keras) over {X_KERAS_PNGS} PNGs "
          f"and a None URI: equal to the port's over keras_cnn.keras (max |diff| {k_diff:.1e})")
    # (b) row expressions over bert-base scores; the flash kernel runs
    spec = get_model(X_TEXT_MODEL)
    layers = BERT_CONFIGS[spec.size].num_layers
    mf = spec.model_function(dtype=torch.float32, seed=seed, device=device)
    texts = _texts(seed, X_TEXTS)
    tags = [None if i % 17 == 0 else f"t{i % 5}" for i in range(len(texts))]
    table = DataFrame.fromColumns({"id": list(range(len(texts))), "text": texts, "tag": tags}, numPartitions=4)
    embed = TextEmbedder(inputCol="text", outputCol="emb", modelFunction=mf, maxLength=X_MAX_LENGTH, batchSize=32)
    embed.transform(table.limit(32)).collect()  # cuBLAS and allocator warm-up: not counted
    sync()
    metrics.reset()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    scored = embed.transform(table).cache()
    sync()
    embed_s = time.perf_counter() - t0
    launches, batches = flash_attention.launches, _dispatches()
    check(batches > 0 and launches == (layers * batches if on_card else 0),
          f"expressions (23b): {launches} flash launches for {batches} bert-base dispatches "
          f"(expected {layers} per dispatch)")
    base = scored.collectColumns()
    embs = base["emb"]
    width = BERT_CONFIGS[spec.size].hidden_size
    check(all(e is not None and e.shape == (width,) and bool(np.isfinite(e).all()) for e in embs),
          f"expressions (23b): a row without a finite {width}-d embedding")
    scored.createOrReplaceTempView("bert_scores")
    spark = SparkSession.builder.appName("chip_smoke").getOrCreate()
    t0 = time.perf_counter()
    col_rows = [dict(r) for r in _expression_columns(scored).collect()]
    col_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sql_rows = [dict(r) for r in spark.sql(X_SQL).collect()]
    sql_s = time.perf_counter() - t0
    check(col_rows == sql_rows, "expressions (23b): the Column and SQL surfaces' rows differ")
    expected = _expected_expression_rows(base["id"], base["tag"], base["text"], embs)
    check(len(col_rows) == len(expected) > 0,
          f"expressions (23b): {len(col_rows)} rows, numpy keeps {len(expected)}")
    worst = 0.0
    for got, want in zip(col_rows, expected):
        check(set(got) == set(want), f"expressions (23b): columns {sorted(got)}")
        for k, v in want.items():
            if isinstance(v, str) or k == "id":
                check(got[k] == v, f"expressions (23b): row {want['id']} {k} = {got[k]!r}, numpy {v!r}")
                continue
            rel = abs(got[k] - v) / max(abs(v), np.finfo(np.float64).tiny)
            worst = max(worst, rel)
            check(rel <= X_NUMPY_REL, f"expressions (23b): row {want['id']} {k} = {got[k]!r}, numpy {v!r}")
    dropTempTable("bert_scores")
    print(f"expressions (23b) on {card}: TextEmbedder {X_TEXT_MODEL} f32 over {len(texts)} texts in "
          f"{embed_s:.3f} s = {len(texts) / embed_s:.1f} rows/s, {batches} dispatches, {launches} flash launches "
          f"({layers} per dispatch); the query kept {len(col_rows)} rows: Column surface {col_s:.3f} s, "
          f"spark.sql {sql_s:.3f} s (host), rows equal; worst numeric cell vs numpy relative {worst:.2e} "
          f"(limit {X_NUMPY_REL})")
    del mf, scored
    shutdown_feeders()
    # (c) a model UDF inside CASE and coalesce
    mspec = get_image_model(SQL_MODEL)
    ustructs, _ = _colour_structs(seed + 23, X_UDF_IMAGES, mspec.height)
    ustructs.append(None)
    labels = [("a", "b")[i % 3 == 0] for i in range(len(ustructs))]
    DataFrame.fromColumns({"image": ustructs, "label": labels}, numPartitions=4).createOrReplaceTempView("images23")
    udf_catalog.registerKerasImageUDF("mnv2_23", SQL_MODEL, batch_size=SQL_BATCH, device=device)
    try:
        queries = {
            "bare": "SELECT mnv2_23(image) AS p FROM images23",
            "case": "SELECT CASE WHEN label = 'a' THEN mnv2_23(image) END AS p FROM images23",
            "coalesce": "SELECT coalesce(mnv2_23(image), array(-1.0)) AS p FROM images23",
        }
        spark.sql(queries["bare"]).limit(8).collect()  # warm-up: not counted
        got, batches_by = {}, {}
        for name, q in queries.items():
            metrics.reset()
            t0 = time.perf_counter()
            got[name] = [r["p"] for r in spark.sql(q).collect()]
            sync()
            batches_by[name] = (int(metrics.counter("sql.udf.batches")), int(metrics.counter("sql.udf.batch_rows")),
                                time.perf_counter() - t0)
    finally:
        udf_catalog.unregister("mnv2_23")
    bare = got["bare"]
    check(bare[-1] is None and all(p is not None and np.isfinite(p).all() for p in bare[:-1]),
          "expressions (23c): the bare UDF's rows")
    ref = np.stack(bare[:-1])
    for name in ("case", "coalesce"):
        rows = got[name]
        check(len(rows) == len(bare), f"expressions (23c) {name}: {len(rows)} rows")
        if name == "case":
            check(all(rows[i] is None for i, lab in enumerate(labels) if lab != "a"),
                  "expressions (23c) case: a value where no WHEN holds")
            keep = [i for i, lab in enumerate(labels[:-1]) if lab == "a"]
        else:
            check(list(rows[-1]) == [-1.0], f"expressions (23c) coalesce: the null image gave {rows[-1]!r}")
            keep = list(range(len(bare) - 1))
        err = _relative_error(np.stack([np.asarray(rows[i], np.float32) for i in keep]), ref[keep])
        check(err <= X_UDF_REL, f"expressions (23c) {name}: rows off the bare UDF's by {err:.3e}")
        print(f"expressions (23c) {name}: {len(keep)} rows vs the bare UDF relative error {err:.3e} "
              f"(limit {X_UDF_REL}); sql.udf.batches {batches_by[name][0]}, batch_rows {batches_by[name][1]}, "
              f"{batches_by[name][2]:.3f} s")
    print(f"expressions (23c) bare: sql.udf.batches {batches_by['bare'][0]}, batch_rows {batches_by['bare'][1]}, "
          f"{batches_by['bare'][2]:.3f} s")
    shutdown_feeders()
    return launches


def _relational_queries(sf, scored, topics):
    """Phase 24(a)'s queries: name -> (SQL over the ``scored`` CTE, the same
    computation on the Column surface)."""
    mean = scored.agg(sf.avg("score").alias("m")).first()["m"]
    pct = scored.agg(sf.percentile_approx("score", 0.4).alias("p40"),
                     sf.percentile_approx("score", 0.6).alias("p60")).first()
    top = scored.filter(sf.col("score") >= pct["p40"]).select("id")
    bottom = scored.filter(sf.col("score") <= pct["p60"]).select("id")
    hi = "SELECT id FROM scored WHERE score >= (SELECT percentile_approx(score, 0.4) FROM scored)"
    lo = "SELECT id FROM scored WHERE score <= (SELECT percentile_approx(score, 0.6) FROM scored)"
    has_t9 = topics.filter(sf.col("topic") == "t9").count() > 0
    return {
        "group": (
            "SELECT topic, count(*) AS n, avg(score) AS mean, min(score) AS lo, max(score) AS hi, "
            "stddev(score) AS sd, percentile_approx(score, 0.5) AS med, count(DISTINCT source) AS sources, "
            "count(*) FILTER (WHERE score > (SELECT avg(score) FROM scored)) AS high "
            "FROM scored GROUP BY topic HAVING count(*) > 10 ORDER BY mean DESC",
            lambda: scored.groupBy("topic").agg(
                sf.count("*").alias("n"), sf.avg("score").alias("mean"), sf.min("score").alias("lo"),
                sf.max("score").alias("hi"), sf.stddev("score").alias("sd"),
                sf.percentile_approx("score", 0.5).alias("med"), sf.countDistinct("source").alias("sources"),
                sf.count(sf.when(sf.col("score") > mean, 1)).alias("high"),
            ).filter(sf.col("n") > 10).orderBy(sf.col("mean").desc()),
        ),
        "rollup": (
            "SELECT topic, source, count(*) AS n, avg(score) AS mean FROM scored GROUP BY ROLLUP(topic, source)",
            lambda: scored.rollup("topic", "source").agg(sf.count("*").alias("n"), sf.avg("score").alias("mean")),
        ),
        "inner join": (
            "SELECT s.id, s.topic, t.name FROM scored s JOIN topics t ON s.topic = t.topic",
            lambda: scored.join(topics, "topic").select("id", "topic", "name"),
        ),
        "left join": (
            "SELECT s.id, s.topic, t.name FROM scored s LEFT JOIN topics t ON s.topic = t.topic",
            lambda: scored.join(topics, "topic", "left").select("id", "topic", "name"),
        ),
        "full join": (
            "SELECT s.id, s.topic, t.name FROM scored s FULL OUTER JOIN topics t ON s.topic = t.topic",
            lambda: scored.join(topics, "topic", "outer").select("id", "topic", "name"),
        ),
        "self join": (
            "SELECT a.id AS i, b.id AS j FROM scored a JOIN scored b ON a.source = b.source WHERE a.id < b.id",
            lambda: scored.alias("a").join(scored.alias("b"), "source")
            .filter(sf.col("a.id") < sf.col("b.id")).select(sf.col("a.id").alias("i"), sf.col("b.id").alias("j")),
        ),
        "scalar subquery": (
            "SELECT id, score FROM scored WHERE score > (SELECT avg(score) FROM scored) ORDER BY id",
            lambda: scored.filter(sf.col("score") > mean).select("id", "score").orderBy("id"),
        ),
        "in subquery": (
            "SELECT id FROM scored WHERE topic IN (SELECT topic FROM topics WHERE name <> 'two')",
            lambda: scored.join(topics.filter(sf.col("name") != "two").select("topic"), "topic", "left_semi")
            .select("id"),
        ),
        "exists": (
            "SELECT count(*) AS n FROM scored WHERE EXISTS (SELECT topic FROM topics WHERE topic = 't9')",
            lambda: (scored if has_t9 else scored.limit(0)).agg(sf.count("*").alias("n")),
        ),
        "union all": (f"{hi} UNION ALL {lo}", lambda: top.unionAll(bottom)),
        "union": (f"{hi} UNION {lo}", lambda: top.union(bottom).distinct()),
        "intersect": (f"{hi} INTERSECT {lo}", lambda: top.intersect(bottom)),
        "except": (f"{hi} EXCEPT {lo}", lambda: top.subtract(bottom)),
        "distinct": ("SELECT DISTINCT source, topic FROM scored", lambda: scored.select("source", "topic").distinct()),
        "limit offset": (
            "SELECT id, score FROM scored ORDER BY score DESC LIMIT 10 OFFSET 5",
            lambda: scored.orderBy(sf.col("score").desc()).limit(15).offset(5).select("id", "score"),
        ),
    }


def _discrete_percentile(values, p: float) -> float:
    """``percentile_approx``'s element: the sorted values' ceil(p*n)-th."""
    s = sorted(values)
    return s[max(0, min(len(s) - 1, math.ceil(p * len(s)) - 1))]


def _check_relational_rows(name: str, rows: list, ids, topics, sources, scores, dim: dict) -> float:
    """Phase 24(a)'s rows against numpy over the collected embeddings' scores;
    returns the worst relative error of an aggregate cell."""
    n = len(ids)
    mean = float(np.mean(scores))
    worst = 0.0

    def close(got, want, what):
        nonlocal worst
        rel = abs(got - want) / max(abs(want), np.finfo(np.float64).tiny)
        worst = max(worst, rel)
        check(rel <= R_NUMPY_REL, f"relational (24a) {name}: {what} = {got!r}, numpy {want!r}")

    def count(want):
        check(len(rows) == want, f"relational (24a) {name}: {len(rows)} rows, numpy {want}")

    by_topic: dict = {}
    for i in range(n):
        by_topic.setdefault(topics[i], []).append(i)
    if name == "group":
        want = []
        for t, idx in by_topic.items():
            v = scores[idx]
            if len(idx) > 10:
                want.append((t, idx, v))
        want.sort(key=lambda w: -float(np.mean(w[2])))
        count(len(want))
        for r, (t, idx, v) in zip(rows, want):
            check(r["topic"] == t and r["n"] == len(idx), f"relational (24a) group: {r['topic']}/{r['n']}")
            close(r["mean"], float(np.mean(v)), f"avg over {t}")
            close(r["lo"], float(v.min()), f"min over {t}")
            close(r["hi"], float(v.max()), f"max over {t}")
            close(r["sd"], float(np.std(v, ddof=1)), f"stddev over {t}")
            close(r["med"], float(_discrete_percentile(v, 0.5)), f"percentile_approx over {t}")
            check(r["sources"] == len({sources[i] for i in idx}), f"relational (24a) group: sources of {t}")
            check(r["high"] == int((v > mean).sum()), f"relational (24a) group: FILTER count of {t}")
    elif name == "rollup":
        pairs = {(topics[i], sources[i]) for i in range(n)}
        count(len(pairs) + len(by_topic) + 1)
        total = rows[-1]
        check(total["topic"] is None and total["source"] is None and total["n"] == n,
              f"relational (24a) rollup: the grand total row {total}")
        close(total["mean"], mean, "the grand total's avg")
    elif name == "inner join":
        count(sum(1 for t in topics if t is not None and t in dim))
    elif name == "left join":
        count(n)
    elif name == "full join":
        count(n + sum(1 for t in dim if t not in by_topic))
    elif name == "self join":
        count(sum(len(v) * (len(v) - 1) // 2 for v in _group_sizes(sources)))
    elif name == "scalar subquery":
        count(int((scores > mean).sum()))
        for r in rows:
            close(r["score"], float(scores[r["id"]]), f"score of row {r['id']}")
    elif name == "in subquery":
        count(sum(1 for t in topics if t is not None and t in dim and dim[t] != "two"))
    elif name == "exists":
        check(rows == [{"n": n if "t9" in dim else 0}], f"relational (24a) exists: {rows}")
    elif name in ("union all", "union", "intersect", "except"):
        top = set(np.flatnonzero(scores >= _discrete_percentile(scores, 0.4)).tolist())
        bottom = set(np.flatnonzero(scores <= _discrete_percentile(scores, 0.6)).tolist())
        want = {"union all": len(top) + len(bottom), "union": len(top | bottom),
                "intersect": len(top & bottom), "except": len(top - bottom)}[name]
        count(want)
    elif name == "distinct":
        count(len({(sources[i], topics[i]) for i in range(n)}))
    elif name == "limit offset":
        order = np.argsort(-scores, kind="stable")[5:15]
        check([r["id"] for r in rows] == [int(ids[i]) for i in order], "relational (24a) limit offset: ids")
    return worst


def _group_sizes(keys) -> list:
    sizes: dict = {}
    for k in keys:
        sizes.setdefault(k, []).append(k)
    return list(sizes.values())


def phase_relational(seed: int, device_name: str, device="cuda") -> int:
    """Phase 24: the relational core over bert-base scores and inside a
    model UDF (``device="cpu"``: a rehearsal, with the sizes cut by the
    caller). Returns 24(a)'s flash launches."""
    from sparkdl_tpu_torch import functions as sf
    from sparkdl_tpu_torch.sql import dropTempTable

    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = f"{device_name} ({_smi()})" if on_card else device_name
    spark = SparkSession.builder.appName("chip_smoke").getOrCreate()
    # (a) relational analytics over bert-base scores
    spec = get_model(R_TEXT_MODEL)
    layers = BERT_CONFIGS[spec.size].num_layers
    mf = spec.model_function(dtype=torch.float32, seed=seed, device=device)
    texts = _texts(seed, R_TEXTS)
    rng = np.random.default_rng(seed + 24)
    topics = [None if rng.random() < 0.08 else f"t{int(rng.integers(0, 5))}" for _ in texts]
    sources = [("news", "wiki", "forum", "mail", "chat", "code")[int(rng.integers(0, 6))] for _ in texts]
    table = DataFrame.fromColumns({"id": list(range(len(texts))), "text": texts, "topic": topics,
                                   "source": sources}, numPartitions=4)
    dim = {"t0": "zero", "t1": "one", "t2": "two", "t3": "three", "t9": "nine"}  # no t4; t9 has no text
    topic_df = DataFrame.fromColumns({"topic": list(dim), "name": list(dim.values())}, numPartitions=2)
    embed = TextEmbedder(inputCol="text", outputCol="emb", modelFunction=mf, maxLength=R_MAX_LENGTH, batchSize=32)
    embed.transform(table.limit(32)).collect()  # cuBLAS and allocator warm-up: not counted
    sync()
    metrics.reset()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    bert = embed.transform(table).cache()
    sync()
    embed_s = time.perf_counter() - t0
    launches, batches = flash_attention.launches, _dispatches()
    check(batches > 0 and launches == (layers * batches if on_card else 0),
          f"relational (24a): {launches} flash launches for {batches} bert-base dispatches "
          f"(expected {layers} per dispatch)")
    base = bert.collectColumns()
    width = BERT_CONFIGS[spec.size].hidden_size
    check(all(e is not None and e.shape == (width,) and bool(np.isfinite(e).all()) for e in base["emb"]),
          f"relational (24a): a row without a finite {width}-d embedding")
    # the score in float64, in the SQL's order: sum of the first 16 squares
    scores = np.array([sum(float(x) * float(x) for x in e[:16]) for e in base["emb"]])
    bert.createOrReplaceTempView("bert24")
    topic_df.createOrReplaceTempView("topics")
    scored = bert.select("id", "topic", "source", sf.aggregate(
        sf.slice("emb", 1, 16), sf.lit(0.0).cast("double"),
        lambda a, x: a + x.cast("double") * x.cast("double")).alias("score"))
    cte = ("WITH scored AS (SELECT id, topic, source, aggregate(slice(emb, 1, 16), CAST(0 AS DOUBLE), "
           "(a, x) -> a + CAST(x AS DOUBLE) * CAST(x AS DOUBLE)) AS score FROM bert24) ")
    worst, lines = 0.0, []
    for name, (text, build) in _relational_queries(sf, scored, topic_df).items():
        t0 = time.perf_counter()
        sql_rows = [dict(r) for r in spark.sql(cte + text).collect()]
        sql_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        col_rows = [dict(r) for r in build().collect()]
        col_s = time.perf_counter() - t0
        check(sql_rows == col_rows, f"relational (24a) {name}: the SQL and Column surfaces' rows differ")
        worst = max(worst, _check_relational_rows(name, sql_rows, base["id"], base["topic"], base["source"],
                                                  scores, dim))
        lines.append(f"{name} {len(sql_rows)} rows (sql {sql_s:.3f} s, columns {col_s:.3f} s)")
    dropTempTable("bert24")
    dropTempTable("topics")
    print(f"relational (24a) on {card}: TextEmbedder {R_TEXT_MODEL} f32 over {len(texts)} texts in "
          f"{embed_s:.3f} s = {len(texts) / embed_s:.1f} rows/s, {batches} dispatches, {launches} flash launches "
          f"({layers} per dispatch); {len(texts)} scored rows in, {len(dim)} topics; per query rows out and host "
          f"seconds per surface: {'; '.join(lines)}; both surfaces equal, worst aggregate vs numpy relative "
          f"{worst:.2e} (limit {R_NUMPY_REL})")
    del mf, bert, scored
    shutdown_feeders()
    # (b) the config[2] UDF inside relational queries
    mspec = get_image_model(SQL_MODEL)
    ustructs, _ = _colour_structs(seed + 24, R_UDF_IMAGES, mspec.height)
    ustructs.append(None)
    labels = [("a", "b", "c")[i % 3] for i in range(len(ustructs))]
    DataFrame.fromColumns({"id": list(range(len(ustructs))), "image": ustructs, "label": labels},
                          numPartitions=4).createOrReplaceTempView("images24")
    DataFrame.fromColumns({"label": ["a", "b", "z"], "name": ["ay", "bee", "zed"]}).createOrReplaceTempView(
        "labels24")
    udf_catalog.registerKerasImageUDF("mnv2_24", SQL_MODEL, batch_size=R_UDF_BATCH, device=device)
    try:
        queries = {
            "bare": "SELECT id, label, mnv2_24(image) AS p FROM images24",
            "group": "SELECT label, count(*) AS n, avg(element_at(mnv2_24(image), 1)) AS a FROM images24 "
                     "GROUP BY label",
            "join": "SELECT s.id, s.p, l.name FROM (SELECT id, label, element_at(mnv2_24(image), 1) AS p "
                    "FROM images24) s JOIN labels24 l ON s.label = l.label",
            "in": "SELECT id FROM images24 WHERE id IN (SELECT id FROM images24 "
                  "WHERE element_at(mnv2_24(image), 1) > {cut})",
        }
        spark.sql(queries["bare"]).limit(8).collect()  # warm-up: not counted
        got, counts = {}, {}
        for name, q in queries.items():
            if name == "in":
                q = q.format(cut=repr(float(np.median(first))))
            metrics.reset()
            t0 = time.perf_counter()
            got[name] = [dict(r) for r in spark.sql(q).collect()]
            sync()
            counts[name] = (int(metrics.counter("sql.udf.batches")), int(metrics.counter("sql.udf.batch_rows")),
                            time.perf_counter() - t0)
            if name == "bare":
                bare = got["bare"]
                check(bare[-1]["p"] is None and all(r["p"] is not None and np.isfinite(r["p"]).all()
                                                   for r in bare[:-1]), "relational (24b): the bare UDF's rows")
                first = np.array([float(r["p"][0]) for r in bare[:-1]])
    finally:
        udf_catalog.unregister("mnv2_24")
        dropTempTable("images24")
        dropTempTable("labels24")
    for name, (b, rows_in, _s) in counts.items():
        check(b > 0 and b >= math.ceil(rows_in / R_UDF_BATCH) and b < rows_in,
              f"relational (24b) {name}: {b} UDF batches for {rows_in} rows (batches of up to {R_UDF_BATCH})")
    worst = 0.0
    for r in got["group"]:
        idx = [i for i, lab in enumerate(labels[:-1]) if lab == r["label"]]
        check(r["n"] == len(idx) + (labels[-1] == r["label"]), f"relational (24b) group: count of {r['label']}")
        want = float(np.mean(first[idx]))
        worst = max(worst, abs(r["a"] - want) / abs(want))
    check(worst <= R_UDF_REL, f"relational (24b) group: avg off the bare UDF's rows by {worst:.3e}")
    joined = got["join"]
    want_ids = [i for i, lab in enumerate(labels) if lab in ("a", "b")]
    check([r["id"] for r in joined] == want_ids, "relational (24b) join: ids")
    jerr = max(abs(r["p"] - first[r["id"]]) / max(abs(first[r["id"]]), 1e-30) for r in joined if r["p"] is not None)
    check(jerr <= R_UDF_REL, f"relational (24b) join: UDF scores off the bare UDF's by {jerr:.3e}")
    cut = float(np.median(first))
    check([r["id"] for r in got["in"]] == [int(i) for i in np.flatnonzero(first > cut)],
          "relational (24b) in: ids")
    print(f"relational (24b) on {card}: {SQL_MODEL} UDF over {R_UDF_IMAGES} images and a null one, batches of up "
          f"to {R_UDF_BATCH}; GROUP BY label avg within {worst:.2e} of the bare UDF's rows (limit {R_UDF_REL}), "
          f"join {len(joined)} rows within {jerr:.2e}, IN subquery {len(got['in'])} ids; sql.udf.batches / "
          f"batch_rows / host s: " + ", ".join(f"{k} {b} / {n} / {s:.3f}" for k, (b, n, s) in counts.items()))
    shutdown_feeders()
    return launches


def _window_queries(sf, Window, scored, topic_df, texts_df, score_of_udf: str):
    """Phase 25(a)'s queries: name -> (SQL after the ``scored`` CTE, the same
    computation on the Column surface)."""
    by_topic_id = Window.partitionBy("topic").orderBy("id")
    by_source_id = Window.partitionBy("source").orderBy("id")
    whole = by_topic_id.rowsBetween(Window.unboundedPreceding, Window.unboundedFollowing)
    by_s2 = Window.partitionBy("source").orderBy(sf.round("score", 2))
    return {
        "top3": (
            ", ranked AS (SELECT id, topic, score, row_number() OVER (PARTITION BY topic ORDER BY score DESC, id) "
            "AS r FROM scored) SELECT id, topic, score, r FROM ranked WHERE r <= 3",
            lambda: scored.withColumn("r", sf.row_number().over(
                Window.partitionBy("topic").orderBy(sf.col("score").desc(), "id")))
            .filter(sf.col("r") <= 3).select("id", "topic", "score", "r"),
        ),
        "ranks": (
            " SELECT id, source, round(score, 2) AS s2, "
            "rank() OVER (PARTITION BY source ORDER BY round(score, 2)) AS rk, "
            "dense_rank() OVER (PARTITION BY source ORDER BY round(score, 2)) AS dr, "
            "percent_rank() OVER (PARTITION BY source ORDER BY round(score, 2)) AS pr, "
            "cume_dist() OVER (PARTITION BY source ORDER BY round(score, 2)) AS cd, "
            "ntile(4) OVER (PARTITION BY source ORDER BY round(score, 2)) AS nt FROM scored",
            lambda: scored.select(
                "id", "source", sf.round("score", 2).alias("s2"), sf.rank().over(by_s2).alias("rk"),
                sf.dense_rank().over(by_s2).alias("dr"), sf.percent_rank().over(by_s2).alias("pr"),
                sf.cume_dist().over(by_s2).alias("cd"), sf.ntile(4).over(by_s2).alias("nt")),
        ),
        "offsets": (
            " SELECT id, lag(id) OVER (ORDER BY id) AS p1, lead(id) OVER (ORDER BY id) AS n1, "
            "lag(score, 2, -1.0) OVER (PARTITION BY source ORDER BY id) AS p2, "
            "lead(topic, 2, 'none') OVER (PARTITION BY source ORDER BY id) AS n2 FROM scored",
            lambda: scored.select(
                "id", sf.lag("id").over(Window.orderBy("id")).alias("p1"),
                sf.lead("id").over(Window.orderBy("id")).alias("n1"),
                sf.lag("score", 2, -1.0).over(by_source_id).alias("p2"),
                sf.lead("topic", 2, "none").over(by_source_id).alias("n2")),
        ),
        "values": (
            " SELECT id, topic, first_value(score) OVER (PARTITION BY topic ORDER BY id) AS f, "
            "last_value(score) OVER (PARTITION BY topic ORDER BY id) AS l, "
            "nth_value(score, 2) OVER (PARTITION BY topic ORDER BY id) AS n, "
            "first_value(score) OVER (PARTITION BY topic ORDER BY id ROWS BETWEEN UNBOUNDED PRECEDING AND "
            "UNBOUNDED FOLLOWING) AS fw, "
            "last_value(score) OVER (PARTITION BY topic ORDER BY id ROWS BETWEEN UNBOUNDED PRECEDING AND "
            "UNBOUNDED FOLLOWING) AS lw, "
            "nth_value(score, 2) OVER (PARTITION BY topic ORDER BY id ROWS BETWEEN UNBOUNDED PRECEDING AND "
            "UNBOUNDED FOLLOWING) AS nw FROM scored",
            lambda: scored.select(
                "id", "topic", sf.first_value("score").over(by_topic_id).alias("f"),
                sf.last_value("score").over(by_topic_id).alias("l"),
                sf.nth_value("score", 2).over(by_topic_id).alias("n"),
                sf.first_value("score").over(whole).alias("fw"), sf.last_value("score").over(whole).alias("lw"),
                sf.nth_value("score", 2).over(whole).alias("nw")),
        ),
        "running avg": (
            " SELECT id, source, avg(score) OVER (PARTITION BY source ORDER BY id ROWS BETWEEN 2 PRECEDING AND "
            "CURRENT ROW) AS run FROM scored",
            lambda: scored.select("id", "source", sf.avg("score").over(by_source_id.rowsBetween(-2, 0)).alias("run")),
        ),
        "range": (
            " SELECT id, topic, count(*) OVER (PARTITION BY topic ORDER BY id RANGE BETWEEN 10 PRECEDING AND "
            "10 FOLLOWING) AS c, avg(score) OVER (PARTITION BY topic ORDER BY id RANGE BETWEEN 10 PRECEDING AND "
            "10 FOLLOWING) AS a FROM scored",
            lambda: scored.select(
                "id", "topic", sf.count("*").over(by_topic_id.rangeBetween(-10, 10)).alias("c"),
                sf.avg("score").over(by_topic_id.rangeBetween(-10, 10)).alias("a")),
        ),
        "deviation": (
            " SELECT id, topic, score - avg(score) OVER (PARTITION BY topic) AS dev FROM scored",
            lambda: scored.select(
                "id", "topic", (sf.col("score") - sf.avg("score").over(Window.partitionBy("topic"))).alias("dev")),
        ),
        "join": (
            " SELECT s.id, t.name, rank() OVER (PARTITION BY t.name ORDER BY s.score DESC) AS r "
            "FROM scored s JOIN topics25 t ON s.topic = t.topic",
            lambda: scored.join(topic_df, "topic").select(
                "id", "name", sf.rank().over(Window.partitionBy("name").orderBy(sf.col("score").desc())).alias("r")),
        ),
        "udf rank": (
            f" SELECT id, topic, rank() OVER (PARTITION BY topic ORDER BY {score_of_udf} DESC) AS r FROM texts25",
            lambda: texts_df.select("id", "topic", sf.rank().over(
                Window.partitionBy("topic").orderBy(sf.expr(score_of_udf).desc())).alias("r")),
        ),
        "words": (
            " , w AS (SELECT topic, explode(split(text, ' ')) AS word FROM texts25) "
            "SELECT topic, word, count(*) AS n FROM w GROUP BY topic, word ORDER BY n DESC, topic, word LIMIT 10",
            lambda: texts_df.select("topic", sf.explode(sf.split("text", " ")).alias("word"))
            .groupBy("topic", "word").agg(sf.count("*").alias("n"))
            .orderBy(sf.col("n").desc(), "topic", "word").limit(10),
        ),
        "exploded": (
            " SELECT explode(split(text, ' ')) AS word FROM texts25",
            lambda: texts_df.select(sf.explode(sf.split("text", " ")).alias("word")),
        ),
        "lateral": (
            " SELECT id, e.*, v FROM texts25 LATERAL VIEW OUTER posexplode(parts) e AS pos, part "
            "LATERAL VIEW explode(array(pos, length(part))) f AS v",
            lambda: texts_df.select("id", sf.posexplode_outer("parts").alias("pos", "part"))
            .select("id", "pos", "part", sf.explode(sf.array("pos", sf.length("part"))).alias("v")),
        ),
        "stack": (
            " SELECT id, stack(2, 'topic', topic, 'source', source) FROM texts25",
            lambda: texts_df.select("id", sf.stack(2, sf.lit("topic"), "topic", sf.lit("source"), "source")),
        ),
        "json_tuple": (
            " SELECT id, json_tuple(to_json(named_struct('id', id, 'topic', topic, 'score', score)), "
            "'id', 'topic', 'score') FROM scored",
            lambda: scored.select("id", sf.json_tuple(sf.to_json(sf.named_struct(
                sf.lit("id"), "id", sf.lit("topic"), "topic", sf.lit("score"), "score")), "id", "topic", "score")),
        ),
    }


def _check_window_rows(name: str, rows: list, base: dict, scores, udf_scores, dim: dict) -> float:
    """Phase 25(a)'s rows against a numpy/Python computation over the
    collected scores (ties broken by id): ranks, offsets and values exactly,
    window aggregates within ``W_NUMPY_REL``. Returns the worst relative
    error of an aggregate."""
    ids, topics, sources, texts, parts = (base[k] for k in ("id", "topic", "source", "text", "parts"))
    n = len(ids)
    worst = 0.0

    def close(got, want, what):
        nonlocal worst
        rel = abs(got - want) / max(abs(want), np.finfo(np.float64).tiny)
        worst = max(worst, rel)
        check(rel <= W_NUMPY_REL, f"windows (25a) {name}: {what} = {got!r}, numpy {want!r}")

    def groups(keys):
        out: dict = {}
        for i in range(n):
            out.setdefault(keys[i], []).append(i)
        return out

    def count(want):
        check(len(rows) == want, f"windows (25a) {name}: {len(rows)} rows, expected {want}")

    if name == "top3":
        want = {}
        for idx in groups(topics).values():
            for r, i in enumerate(sorted(idx, key=lambda i: (-scores[i], ids[i]))[:3]):
                want[ids[i]] = r + 1
        count(len(want))
        check({r["id"]: r["r"] for r in rows} == want and [r["id"] for r in rows] == sorted(want),
              "windows (25a) top3: row numbers or row order")
    elif name == "ranks":
        count(n)
        s2 = {r["id"]: r["s2"] for r in rows}
        check(all(abs(s2[ids[i]] - scores[i]) <= 0.005 + 1e-9 for i in range(n)), "windows (25a) ranks: round")
        got = {r["id"]: r for r in rows}
        for idx in groups(sources).values():
            m = len(idx)
            keys = [s2[ids[i]] for i in idx]
            order = sorted(range(m), key=lambda j: (keys[j], ids[idx[j]]))
            base_size, extra = divmod(m, 4)
            bounds, start = [], 0
            for b in range(4):
                size = base_size + (1 if b < extra else 0)
                bounds.append((start, start + size))
                start += size
            for pos, j in enumerate(order):
                r = got[ids[idx[j]]]
                rank = 1 + sum(1 for k in keys if k < keys[j])
                dense = 1 + len({k for k in keys if k < keys[j]})
                tile = next(b + 1 for b, (lo, hi) in enumerate(bounds) if lo <= pos < hi)
                check((r["rk"], r["dr"], r["nt"]) == (rank, dense, tile),
                      f"windows (25a) ranks: row {r['id']} rank/dense_rank/ntile {(r['rk'], r['dr'], r['nt'])}, "
                      f"expected {(rank, dense, tile)}")
                check(r["pr"] == ((rank - 1) / (m - 1) if m > 1 else 0.0)
                      and r["cd"] == sum(1 for k in keys if k <= keys[j]) / m,
                      f"windows (25a) ranks: row {r['id']} percent_rank/cume_dist")
    elif name == "offsets":
        count(n)
        by_src = groups(sources)
        pos_in = {i: (src, p) for src, idx in by_src.items() for p, i in enumerate(idx)}
        for r in rows:
            i = r["id"]
            src, p = pos_in[i]
            idx = by_src[src]
            want = (i - 1 if i > 0 else None, i + 1 if i < n - 1 else None,
                    float(scores[idx[p - 2]]) if p >= 2 else -1.0,
                    topics[idx[p + 2]] if p + 2 < len(idx) else "none")
            got = (r["p1"], r["n1"], r["p2"], r["n2"])
            check(got == want, f"windows (25a) offsets: row {i} {got}, expected {want}")
    elif name == "values":
        count(n)
        by_t = groups(topics)
        for r in rows:
            idx = by_t[r["topic"]]
            p = idx.index(r["id"])
            want = (scores[idx[0]], scores[r["id"]], scores[idx[1]] if p >= 1 else None,
                    scores[idx[0]], scores[idx[-1]], scores[idx[1]] if len(idx) > 1 else None)
            check((r["f"], r["l"], r["n"], r["fw"], r["lw"], r["nw"]) == tuple(
                None if w is None else float(w) for w in want), f"windows (25a) values: row {r['id']}")
    elif name == "running avg":
        count(n)
        by_src = groups(sources)
        for r in rows:
            idx = by_src[r["source"]]
            p = idx.index(r["id"])
            close(r["run"], float(np.mean(scores[idx[max(0, p - 2):p + 1]])), f"running avg of row {r['id']}")
    elif name == "range":
        count(n)
        by_t = groups(topics)
        for r in rows:
            frame = [j for j in by_t[r["topic"]] if abs(ids[j] - r["id"]) <= 10]
            check(r["c"] == len(frame), f"windows (25a) range: count of row {r['id']}")
            close(r["a"], float(np.mean(scores[frame])), f"range avg of row {r['id']}")
    elif name == "deviation":
        count(n)
        by_t = groups(topics)
        for r in rows:
            close(r["dev"] + float(np.mean(scores[by_t[r["topic"]]])), float(scores[r["id"]]),
                  f"score - avg(score) of row {r['id']}")
    elif name == "join":
        kept = [i for i in range(n) if topics[i] in dim]
        count(len(kept))
        for r in rows:
            peers = [j for j in kept if dim[topics[j]] == r["name"]]
            check(r["r"] == 1 + sum(1 for j in peers if scores[j] > scores[r["id"]]),
                  f"windows (25a) join: rank of row {r['id']}")
    elif name == "udf rank":
        count(n)
        by_t = groups(topics)
        for r in rows:
            peers = by_t[r["topic"]]
            check(r["r"] == 1 + sum(1 for j in peers if udf_scores[j] > udf_scores[r["id"]]),
                  f"windows (25a) udf rank: rank of row {r['id']}")
    elif name == "words":
        from collections import Counter

        counts = Counter((topics[i], w) for i in range(n) for w in texts[i].split(" "))
        want = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0][0] is not None, kv[0][0] or "", kv[0][1]))[:10]
        check([(r["topic"], r["word"], r["n"]) for r in rows] == [(t, w, c) for (t, w), c in want],
              "windows (25a) words: the top 10")
    elif name == "exploded":
        count(sum(len(t.split(" ")) for t in texts))
    elif name == "lateral":
        want = []
        for i in range(n):
            cells = list(enumerate(parts[i])) if parts[i] else [(None, None)]
            for p, part in cells:
                for v in (p, None if part is None else len(part)):
                    want.append((ids[i], p, part, v))
        count(len(want))
        check([(r["id"], r["pos"], r["part"], r["v"]) for r in rows] == want, "windows (25a) lateral: rows")
    elif name == "stack":
        count(2 * n)
        want = [t for i in range(n) for t in ((ids[i], "topic", topics[i]), (ids[i], "source", sources[i]))]
        check([(r["id"], r["col0"], r["col1"]) for r in rows] == want, "windows (25a) stack: rows")
    elif name == "json_tuple":
        count(n)
        for r, i in zip(rows, range(n)):
            check((r["id"], r["c0"], r["c1"]) == (ids[i], str(ids[i]), topics[i]), f"windows (25a) json_tuple: row {i}")
            close(float(r["c2"]), float(scores[i]), f"json_tuple score of row {i}")
    return worst


def _udf_to_batch(tok, max_len: int):
    """A text UDF's host stage: every row tokenized and padded to
    ``max_len`` (one batch geometry for every dispatch)."""

    def to_batch(chunk):
        ids = np.zeros((len(chunk), max_len), np.int32)
        mask = np.zeros((len(chunk),), bool)
        for i, text in enumerate(chunk):
            if text is not None:
                words = tok(text)[:max_len]
                ids[i, :len(words)] = words
                mask[i] = True
        return ids, mask

    return to_batch


def phase_windows(seed: int, device_name: str, device="cuda") -> int:
    """Phase 25: windows and generators over bert-base scores, a model UDF
    inside a window (``device="cpu"``: a rehearsal, with the sizes cut by
    the caller). Returns the flash launches of its bert-base dispatches."""
    from sparkdl_tpu_torch import functions as sf
    from sparkdl_tpu_torch.dataframe import Window
    from sparkdl_tpu_torch.sql import dropTempTable

    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = f"{device_name} ({_smi()})" if on_card else device_name
    spark = SparkSession.builder.appName("chip_smoke").getOrCreate()
    spec = get_model(W_TEXT_MODEL)
    layers = BERT_CONFIGS[spec.size].num_layers
    mf = spec.model_function(dtype=torch.float32, seed=seed, device=device)
    texts = _texts(seed, W_TEXTS)
    rng = np.random.default_rng(seed + 24)  # phase 24's topics and sources
    topics = [None if rng.random() < 0.08 else f"t{int(rng.integers(0, 5))}" for _ in texts]
    sources = [("news", "wiki", "forum", "mail", "chat", "code")[int(rng.integers(0, 6))] for _ in texts]
    parts = [None if i % 9 == 0 else ([] if i % 9 == 1 else t.split(" ")[: 1 + i % 4]) for i, t in enumerate(texts)]
    cols = {"id": list(range(len(texts))), "text": texts, "topic": topics, "source": sources, "parts": parts}
    table = DataFrame.fromColumns(cols, numPartitions=4)
    dim = {"t0": "zero", "t1": "one", "t2": "two", "t3": "three", "t9": "nine"}
    topic_df = DataFrame.fromColumns({"topic": list(dim), "name": list(dim.values())}, numPartitions=2)
    embed = TextEmbedder(inputCol="text", outputCol="emb", modelFunction=mf, maxLength=W_MAX_LENGTH, batchSize=32)
    embed.transform(table.limit(32)).collect()  # cuBLAS and allocator warm-up: not counted
    sync()
    metrics.reset()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    bert = embed.transform(table).cache()
    sync()
    embed_s = time.perf_counter() - t0
    launches, batches = flash_attention.launches, _dispatches()
    check(batches > 0 and launches == (layers * batches if on_card else 0),
          f"windows (25a): {launches} flash launches for {batches} bert-base dispatches (expected {layers} each)")
    base = bert.collectColumns()
    width = BERT_CONFIGS[spec.size].hidden_size
    check(all(e is not None and e.shape == (width,) and bool(np.isfinite(e).all()) for e in base["emb"]),
          f"windows (25a): a row without a finite {width}-d embedding")
    scores = np.array([sum(float(x) * float(x) for x in e[:16]) for e in base["emb"]])
    bert.createOrReplaceTempView("bert25")
    table.createOrReplaceTempView("texts25")
    topic_df.createOrReplaceTempView("topics25")
    udf_catalog.registerModelUDF("bert25", mf, to_batch=_udf_to_batch(embed._tokenizer(), W_MAX_LENGTH),
                                 batch_size=W_UDF_BATCH, device=device)
    score_sql = "aggregate(slice({}, 1, 16), CAST(0 AS DOUBLE), (a, x) -> a + CAST(x AS DOUBLE) * CAST(x AS DOUBLE))"
    scored = bert.select("id", "topic", "source", sf.expr(score_sql.format("emb")).alias("score"))
    # the scores as the engine computed them: ranks, offsets and values are
    # held to these exactly, and these to numpy's float64 sum
    collected = np.array([r["score"] for r in scored.collect()])
    score_rel = float(np.max(np.abs(collected - scores) / np.abs(scores)))
    check(score_rel <= 1e-12, f"windows (25a): the SQL scores off numpy's by {score_rel:.3e}")
    cte = f"WITH scored AS (SELECT id, topic, source, {score_sql.format('emb')} AS score FROM bert25)"
    worst, lines, udf_counts = 0.0, [], {}
    try:
        # the UDF alone: its scores, against which the window's ranks are held
        metrics.reset()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        bare = spark.sql(f"SELECT id, {score_sql.format('bert25(text)')} AS s FROM texts25").collect()
        sync()
        udf_counts["bare"] = (int(metrics.counter("sql.udf.batches")), flash_attention.launches,
                              time.perf_counter() - t0)
        udf_scores = np.array([r["s"] for r in bare])
        udf_rel = float(np.max(np.abs(udf_scores - scores) / np.abs(scores)))
        check(udf_rel <= W_UDF_REL, f"windows (25a): the bert25 UDF's scores off the TextEmbedder's by {udf_rel:.3e}")
        for name, (text, build) in _window_queries(sf, Window, scored, topic_df, table,
                                                   score_sql.format("bert25(text)")).items():
            got = {}
            for surface, run in (("sql", lambda: spark.sql(cte + text)), ("columns", build)):
                metrics.reset()
                flash_attention.launches = 0
                t0 = time.perf_counter()
                got[surface] = [dict(r) for r in run().collect()]
                sync()
                seconds = time.perf_counter() - t0
                if name == "udf rank":
                    udf_counts[surface] = (int(metrics.counter("sql.udf.batches")), flash_attention.launches, seconds)
                if name == "join" and surface == "sql":
                    pruned = int(metrics.counter("sql.pushdown.pruned_cols"))
                got[surface + "_s"] = seconds
            check(got["sql"] == got["columns"], f"windows (25a) {name}: the SQL and Column surfaces' rows differ")
            worst = max(worst, _check_window_rows(name, got["sql"], base, collected, udf_scores, dim))
            rows_in = len(texts) if name not in ("join",) else len(texts) + len(dim)
            lines.append(f"{name} {rows_in} -> {len(got['sql'])} rows (sql {got['sql_s']:.3f} s, "
                         f"columns {got['columns_s']:.3f} s)")
    finally:
        udf_catalog.unregister("bert25")
        for view in ("bert25", "texts25", "topics25"):
            dropTempTable(view)
    n = len(texts)
    for surface, (b, flashes, _s) in udf_counts.items():
        check(math.ceil(n / W_UDF_BATCH) <= b < n,
              f"windows (25a) udf {surface}: {b} UDF batches for {n} rows (batches of up to {W_UDF_BATCH})")
        check(flashes == (layers * b if on_card else 0),
              f"windows (25a) udf {surface}: {flashes} flash launches for {b} bert-base dispatches")
    launches += sum(f for _b, f, _s in udf_counts.values())
    # (b) partition-seeded columns on the Column surface
    t0 = time.perf_counter()
    seeded = bert.select("id", sf.rand(W_SEED).alias("u"), sf.randn(W_SEED).alias("z"),
                         sf.monotonically_increasing_id().alias("mid"), sf.spark_partition_id().alias("pid"))
    first = [dict(r) for r in seeded.collect()]
    seeded_s = time.perf_counter() - t0
    check(first == [dict(r) for r in seeded.collect()], "windows (25b): a second run drew other values")
    want = {"u": [], "z": [], "mid": [], "pid": []}
    for index, rows_n in enumerate(bert.partitionRowCounts()):
        draws = np.random.default_rng(np.random.SeedSequence([W_SEED, index]))
        want["u"] += draws.random(rows_n).tolist()
        want["z"] += np.random.default_rng(np.random.SeedSequence([W_SEED, index])).standard_normal(rows_n).tolist()
        want["mid"] += [(index << 33) + j for j in range(rows_n)]
        want["pid"] += [index] * rows_n
    for key, values in want.items():
        check([r[key] for r in first] == values, f"windows (25b): {key} differs from numpy's per-partition draws")
    print(f"windows (25a) on {card}: TextEmbedder {W_TEXT_MODEL} f32 over {n} texts in {embed_s:.3f} s, "
          f"{batches} dispatches, {layers} flash launches each; the bert25 UDF (batches of {W_UDF_BATCH} at "
          f"L={W_MAX_LENGTH}) within {udf_rel:.2e} of the TextEmbedder's scores (limit {W_UDF_REL}); "
          f"sql.udf.batches / flash launches / host s: "
          + ", ".join(f"{k} {b} / {f} / {s:.3f}" for k, (b, f, s) in udf_counts.items())
          + f"; join sql.pushdown.pruned_cols {pruned}; per query rows in -> out and host seconds per surface: "
          f"{'; '.join(lines)}; both surfaces equal, ranks, offsets and values equal to Python's, worst window "
          f"aggregate vs numpy relative {worst:.2e} (limit {W_NUMPY_REL})")
    print(f"windows (25b) on {card}: rand/randn({W_SEED}), monotonically_increasing_id, spark_partition_id over "
          f"{bert.numPartitions} partitions ({n} rows) in {seeded_s:.3f} s: equal to numpy's "
          f"default_rng(SeedSequence([{W_SEED}, index])) per partition and to a second run")
    del mf, bert, scored
    shutdown_feeders()
    return launches


def _partition_draws(counts, draw) -> list:
    """Row indices (in frame order) that a partition-seeded draw keeps:
    ``draw(index, n)`` gives each partition's kept row offsets."""
    kept, start = [], 0
    for index, n in enumerate(counts):
        kept += [start + j for j in draw(index, n)]
        start += n
    return kept


def phase_frame_io(seed: int, device_name: str, tmp: str, device="cuda") -> int:
    """Phase 26: the frame's statistics, NA, partitioning and file methods
    and the session's readers, writers, catalog and conf around bert-base
    scores (``device="cpu"``: a rehearsal, with the sizes cut by the
    caller). Returns the flash launches of its bert-base dispatches."""
    from collections import Counter

    from sparkdl_tpu_torch import functions as sf
    from sparkdl_tpu_torch.sql import dropTempTable

    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = f"{device_name} ({_smi()})" if on_card else device_name
    spark = SparkSession.builder.appName("chip_smoke").getOrCreate()
    spec = get_model(F_TEXT_MODEL)
    layers = BERT_CONFIGS[spec.size].num_layers
    width = BERT_CONFIGS[spec.size].hidden_size
    mf = spec.model_function(dtype=torch.float32, seed=seed, device=device)
    texts = _texts(seed, F_TEXTS)
    n = len(texts)
    rng = np.random.default_rng(seed + 24)  # phase 24's topics and sources
    topics = [None if rng.random() < 0.08 else f"t{int(rng.integers(0, 5))}" for _ in texts]
    sources = [("news", "wiki", "forum", "mail", "chat", "code")[int(rng.integers(0, 6))] for _ in texts]
    table = DataFrame.fromColumns({"id": list(range(n)), "text": texts, "topic": topics, "source": sources},
                                  numPartitions=4)
    seconds, sizes = {}, {}
    # (a) CSV in, then embed
    t0 = time.perf_counter()
    csv_path = os.path.join(tmp, "texts26.csv")
    table.write.mode("overwrite").csv(csv_path, header=True)
    back = spark.read.option("header", "true").option("numPartitions", 4).csv(csv_path)
    written = [dict(r) for r in table.collect()]
    check(back.columns == table.columns and [dict(r) for r in back.collect()] == written,
          "frame io (26a): the CSV rows read back differ from the written ones")
    check(all(type(r["id"]) is int for r in back.collect()), "frame io (26a): an id came back as no int")
    sizes["csv"] = os.path.getsize(csv_path)
    seconds["a: csv"] = time.perf_counter() - t0
    embed = TextEmbedder(inputCol="text", outputCol="emb", modelFunction=mf, maxLength=F_MAX_LENGTH, batchSize=32)
    embed.transform(back.limit(32)).collect()  # cuBLAS and allocator warm-up: not counted
    sync()
    metrics.reset()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    bert = embed.transform(back).cache()
    sync()
    seconds["a: embed"] = time.perf_counter() - t0
    launches, batches = flash_attention.launches, _dispatches()
    check(batches > 0 and launches == (layers * batches if on_card else 0),
          f"frame io (26a): {launches} flash launches for {batches} bert-base dispatches (expected {layers} each)")
    base = bert.collectColumns()
    check(all(e is not None and e.shape == (width,) and bool(np.isfinite(e).all()) for e in base["emb"]),
          f"frame io (26a): a row without a finite {width}-d embedding")
    scores = np.array([sum(float(x) * float(x) for x in e[:16]) for e in base["emb"]])
    e0 = np.array([float(e[0]) for e in base["emb"]])
    score_sql = "aggregate(slice({}, 1, 16), CAST(0 AS DOUBLE), (a, x) -> a + CAST(x AS DOUBLE) * CAST(x AS DOUBLE))"
    scored = bert.select("id", "text", "topic", "source", "emb", sf.expr(score_sql.format("emb")).alias("score"),
                         sf.expr("CAST(element_at(emb, 1) AS DOUBLE)").alias("e0")).cache()
    st = scored.select("id", "topic", "source", "score", "e0").cache()
    cols = st.collectColumns()
    check(cols["id"] == list(range(n)) and float(np.max(np.abs(np.array(cols["score"]) - scores) / scores)) <= 1e-12
          and cols["e0"] == e0.tolist(), "frame io (26a): the scores differ from numpy's")
    # the scores as the engine computed them: what is exact below is held
    # to these, and these to numpy's float64 sum
    scores = np.array(cols["score"])
    counts = st.partitionRowCounts()
    # (b) statistics, held to numpy and Python over the collected columns
    t0 = time.perf_counter()
    worst = 0.0

    def close(got, want, what: str, scale: float = None) -> None:
        nonlocal worst
        err = abs(got - want) / (scale if scale is not None else abs(want))
        worst = max(worst, err)
        check(err <= F_NUMPY_REL, f"frame io (26b) {what}: {got!r} against numpy's {want!r} ({err:.3e})")

    numeric = {"id": np.arange(n, dtype=float), "score": scores, "e0": e0}
    described = {r["summary"]: r for r in st.describe().collect()}
    check(list(described) == ["count", "mean", "stddev", "min", "max"] and
          st.describe().columns == ["summary", "id", "score", "e0"], "frame io (26b) describe: its layout")
    for c, v in numeric.items():
        check(described["count"][c] == n and described["min"][c] == v.min() and described["max"][c] == v.max(),
              f"frame io (26b) describe {c}: count, min or max")
        close(described["mean"][c], float(np.mean(v)), f"describe mean of {c}", float(np.std(v)))
        close(described["stddev"][c], float(np.std(v, ddof=1)), f"describe stddev of {c}")
    stats = ["count", "mean", "stddev", "min", "10%", "25%", "50%", "75%", "90%", "max"]
    for r in st.summary(*stats).collect():
        for c, v in numeric.items():
            s = r["summary"]
            want = {"count": n, "mean": float(v.mean()), "stddev": float(v.std(ddof=1)), "min": float(v.min()),
                    "max": float(v.max())}.get(s)
            if want is None:
                want = float(np.percentile(v, float(s[:-1])))
            check(r[c] == want, f"frame io (26b) summary {s} of {c}: {r[c]!r} against numpy's {want!r}")
    probs = [0.1, 0.5, 0.9]
    ranked = sorted(scores)
    want_q = [float(ranked[min(n - 1, max(0, math.ceil(p * n) - 1))]) for p in probs]
    check(st.approxQuantile("score", probs, 0.0) == want_q, "frame io (26b) approxQuantile: not the exact ranks")
    check(st.approxQuantile(["score", "id"], probs, 0.1)[1] == [float(math.ceil(p * n) - 1) for p in probs],
          "frame io (26b) approxQuantile: the list form")
    corr, cov = st.corr("score", "e0"), st.cov("score", "e0")
    close(corr, float(np.corrcoef(scores, e0)[0, 1]), "corr(score, e0)", 1.0)
    close(cov, float(np.cov(scores, e0, ddof=1)[0, 1]), "cov(score, e0)", float(np.std(scores) * np.std(e0)))
    pairs = Counter((str(t), s) for t, s in zip(topics, sources))
    xt = st.crosstab("topic", "source")
    want_cols = ["topic_source"] + sorted({s for s in sources})
    check(xt.columns == want_cols and [dict(r) for r in xt.collect()] == [
        {"topic_source": t, **{s: pairs.get((t, s), 0) for s in want_cols[1:]}} for t in sorted({str(t) for t in topics})
    ], "frame io (26b) crosstab: not Python's count")
    freq = st.freqItems(["topic", "source"], 0.1).collect()[0]
    for c, vals in (("topic", topics), ("source", sources)):
        tally = Counter(v for v in vals if v is not None)
        want = [v for v in dict.fromkeys(v for v in vals if v is not None) if tally[v] > 0.1 * n]
        check(freq[f"{c}_freqItems"] == want, f"frame io (26b) freqItems {c}: not Python's count")
    sampled = [r["id"] for r in st.sample(0.3, F_SEED).collect()]
    draws = np.random.default_rng(F_SEED)
    bounds = np.cumsum([0.3, 0.7])
    check(sampled == _partition_draws(counts, lambda i, m: np.flatnonzero(
        np.minimum(np.searchsorted(bounds, draws.random(m), side="left"), 1) == 0).tolist()),
        "frame io (26b) sample: not numpy's draws")
    fractions = {"t0": 0.5, "t1": 0.2, "t3": 1.0}
    strata = [r["id"] for r in st.sampleBy("topic", fractions, F_SEED).collect()]
    starts = np.cumsum([0] + counts)
    check(strata == _partition_draws(counts, lambda i, m: [
        j for j, u in enumerate(np.random.default_rng(np.random.SeedSequence([F_SEED, i])).random(m))
        if fractions.get(topics[starts[i] + j], 0.0) > u]), "frame io (26b) sampleBy: not numpy's per-partition draws")
    check(st.stat.corr("score", "e0") == corr and st.stat.cov("score", "e0") == cov
          and st.stat.approxQuantile("score", probs, 0.0) == want_q
          and st.stat.crosstab("topic", "source").collect() == xt.collect()
          and st.stat.freqItems(["topic", "source"], 0.1).collect()[0] == freq
          and [r["id"] for r in st.stat.sampleBy("topic", fractions, F_SEED).collect()] == strata,
          "frame io (26b): a df.stat call differs from its frame method")
    seconds["b: statistics"] = time.perf_counter() - t0
    # (c) NA handling, unpivot and partitioning
    t0 = time.perf_counter()
    rows = [dict(r) for r in st.collect()]
    check([r["id"] for r in st.dropna(subset=["topic"]).collect()] == [r["id"] for r in rows if r["topic"]]
          and st.dropna().count() == st.dropna(thresh=5).count() == sum(t is not None for t in topics)
          and st.na.drop(how="all", subset=["topic"]).count() == sum(t is not None for t in topics),
          "frame io (26c) dropna: not Python's rows")
    check([r["topic"] for r in st.fillna("none", subset=["topic"]).collect()] == [t or "none" for t in topics]
          and [r["topic"] for r in st.na.fill({"topic": "tx"}).collect()] == [t or "tx" for t in topics],
          "frame io (26c) fillna: not Python's rows")
    renamed = {"t0": "zero", "t1": "one"}
    check([r["topic"] for r in st.na.replace(list(renamed), list(renamed.values()), ["topic"]).collect()]
          == [renamed.get(t, t) for t in topics], "frame io (26c) na.replace: not Python's rows")
    melted = [dict(r) for r in st.melt("id", ["topic", "source"], "var", "val").collect()]
    check(melted == [{"id": r["id"], "var": v, "val": r[v]} for r in rows for v in ("topic", "source")],
          "frame io (26c) melt: not Python's rows")
    key = lambda r: r["id"]  # noqa: E731 — ids are unique
    for name, frame, parts in (("repartition(3)", st.repartition(3), 3), ("coalesce(2)", st.coalesce(2), 2),
                               ("repartitionByRange(4, score)", st.repartitionByRange(4, "score"), 4)):
        got = [dict(r) for r in frame.collect()]
        check(frame.numPartitions == parts and sorted(got, key=key) == rows,
              f"frame io (26c) {name}: the multiset of rows changed")
    ranged = [[r["score"] for r in DataFrame([p], st.columns).collect()] for p in
              st.repartitionByRange(4, "score")._source]
    check(all(max(a) <= min(b) for a, b in zip(ranged, ranged[1:])), "frame io (26c) repartitionByRange: ranges overlap")
    seeded = st.select("id", sf.rand(F_SEED).alias("u"))
    check(seeded.coalesce(2).collect() == seeded.collect(),
          "frame io (26c) coalesce: a seeded column drew other values (the children's own indices)")
    metrics.reset()
    flash_attention.launches = 0
    lazy = embed.transform(back).coalesce(2)
    coalesced = bert.coalesce(2).select("id", "emb").collect()
    check(_dispatches() == 0 and flash_attention.launches == 0 and lazy.numPartitions == 2,
          f"frame io (26c) coalesce: {_dispatches()} model dispatches ({flash_attention.launches} flash launches) "
          "for a lazy coalesce and one over the cached frame")
    check(all(np.array_equal(r["emb"], e) for r, e in zip(coalesced, base["emb"])),
          "frame io (26c) coalesce: the embeddings changed")
    seconds["c: frame methods"] = time.perf_counter() - t0
    # (d) JSON and Parquet out and back, the catalog, range and conf
    t0 = time.perf_counter()
    out = scored.select("id", "text", "topic", "source", "score", "emb")
    json_path, pq_path = os.path.join(tmp, "scores26.json"), os.path.join(tmp, "scores26.parquet")
    out.write.mode("overwrite").json(json_path)
    out.write.parquet(pq_path)
    try:
        out.write.parquet(pq_path)
        check(False, "frame io (26d): the writer's default mode overwrote a file")
    except FileExistsError:
        pass
    sizes["json"], sizes["parquet"] = os.path.getsize(json_path), os.path.getsize(pq_path)
    json_back = spark.read.option("numPartitions", 4).json(json_path)
    pq_back = spark.read.parquet(pq_path)
    for fmt, frame in (("json", json_back), ("parquet", pq_back)):
        got = frame.collectColumns()
        check(frame.columns == out.columns and [int(i) for i in got["id"]] == list(range(n))
              and list(got["topic"]) == topics and list(got["text"]) == texts
              and [float(s) for s in got["score"]] == cols["score"],
              f"frame io (26d) {fmt}: the rows read back differ from the written ones")
        check(all(np.asarray(a, np.float32).tobytes() == b.astype(np.float32).tobytes()
                  for a, b in zip(got["emb"], base["emb"])), f"frame io (26d) {fmt}: the embeddings are not bit-equal")
    pq_back.createGlobalTempView("scores26")
    try:
        pq_back.createGlobalTempView("scores26")
        check(False, "frame io (26d): createGlobalTempView replaced a view")
    except ValueError:
        pass
    via_sql = [dict(r) for r in spark.sql(
        "SELECT topic, count(*) AS n, avg(score) AS a, max(score) AS m FROM global_temp.scores26 "
        "GROUP BY topic ORDER BY topic").collect()]
    via_cols = [dict(r) for r in pq_back.groupBy("topic").agg(
        sf.count("*").alias("n"), sf.avg("score").alias("a"), sf.max("score").alias("m")).orderBy("topic").collect()]
    check(via_sql == via_cols, "frame io (26d): the global_temp query and the DataFrame surface differ")
    for r in via_sql:
        mine = scores[[i for i, t in enumerate(topics) if t == r["topic"]]]
        check(r["n"] == len(mine) and r["m"] == mine.max(), f"frame io (26d) group {r['topic']}: count or max")
        close(r["a"], float(mine.mean()), f"group {r['topic']} avg")
    catalog = spark.catalog
    check(("scores26", "global_temp") in [(t.name, t.database) for t in catalog.listTables("global_temp")]
          and [c.name for c in catalog.listColumns("scores26", "global_temp")] == out.columns
          and catalog.tableExists("scores26", "global_temp") and catalog.tableExists("global_temp.scores26"),
          "frame io (26d): the catalog does not show global_temp.scores26")
    check(catalog.dropGlobalTempView("scores26") and not catalog.tableExists("scores26", "global_temp"),
          "frame io (26d): global_temp.scores26 outlived dropGlobalTempView")
    joined = spark.range(n).join(pq_back.select("id", "score"), "id")
    check(joined.count() == n and sorted(int(r["id"]) for r in joined.collect()) == list(range(n)),
          f"frame io (26d): spark.range({n}) joined on id did not keep {n} rows")
    spark.conf.set("spark.sql.shuffle.partitions", "4")
    check(spark.conf.get("spark.sql.shuffle.partitions") == "4" and spark.conf.get("missing.key", "d") == "d",
          "frame io (26d): spark.conf set, then get")
    spark.conf.unset("spark.sql.shuffle.partitions")
    seconds["d: files and catalog"] = time.perf_counter() - t0
    # (e) bert-base as a catalog UDF over the frame read back from JSON
    udf_catalog.registerModelUDF("bert26", mf, to_batch=_udf_to_batch(embed._tokenizer(), F_MAX_LENGTH),
                                 batch_size=F_UDF_BATCH, device=device)
    json_back.createOrReplaceTempView("back26")
    try:
        metrics.reset()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        udf_rows = spark.sql(f"SELECT id, {score_sql.format('bert26(text)')} AS s FROM back26").collect()
        sync()
        seconds["e: bert26"] = time.perf_counter() - t0
        udf_batches, udf_launches = int(metrics.counter("sql.udf.batches")), flash_attention.launches
    finally:
        udf_catalog.unregister("bert26")
        dropTempTable("back26")
    check([int(r["id"]) for r in udf_rows] == list(range(n)), "frame io (26e): the UDF's rows")
    udf_rel = float(np.max(np.abs(np.array([r["s"] for r in udf_rows]) - scores) / scores))
    check(udf_rel <= F_UDF_REL, f"frame io (26e): the bert26 UDF's scores off (a)'s by {udf_rel:.3e}")
    check(math.ceil(n / F_UDF_BATCH) <= udf_batches < n,
          f"frame io (26e): {udf_batches} UDF batches for {n} rows (batches of up to {F_UDF_BATCH})")
    check(udf_launches == (layers * udf_batches if on_card else 0),
          f"frame io (26e): {udf_launches} flash launches for {udf_batches} bert-base dispatches")
    print(f"frame io (26) on {card}: {F_TEXT_MODEL} f32 over {n} texts read back from CSV ({n} rows in, "
          f"{len(written)} out, ints as ints, {topics.count(None)} NULL topics), {batches} TextEmbedder dispatches, "
          f"{launches} flash launches ({layers} per dispatch); statistics, NA, melt and partitioning over "
          f"{n} scored rows equal to numpy and Python (worst relative {worst:.2e}, limit {F_NUMPY_REL}; summary "
          f"and quantiles exact); sample(0.3) {len(sampled)} rows, sampleBy {len(strata)}, melt {len(melted)}, "
          f"crosstab {len(xt.collect())} x {len(want_cols) - 1}; files (bytes): "
          + ", ".join(f"{k} {v}" for k, v in sizes.items())
          + f"; JSON and Parquet rows and float32 embeddings bit-equal; global_temp.scores26 GROUP BY topic "
          f"{len(via_sql)} rows on both surfaces; spark.range({n}) join {n} rows; the bert26 UDF over the JSON "
          f"frame: {udf_batches} batches of up to {F_UDF_BATCH} at L={F_MAX_LENGTH}, {udf_launches} flash "
          f"launches, within {udf_rel:.2e} of (a)'s scores (limit {F_UDF_REL}); host seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    del mf, bert, scored, st
    shutdown_feeders()
    return launches + udf_launches


def _pandas_version() -> str | None:
    """The installed pandas' version, or None without pandas; loads none."""
    import importlib.metadata
    import importlib.util

    return importlib.metadata.version("pandas") if importlib.util.find_spec("pandas") else None


def phase_sequence_parallel(seed: int, device_name: str, tmp: str, device="cuda") -> int:
    """Phase 27: the periodic rank snapshot under a heartbeat, the pandas
    surfaces (or their absence), and sequence-parallel bert-base with ring
    and Ulysses attention over an ``sp`` mesh axis of one process
    (``device="cpu"``: a rehearsal, with the sizes cut by the caller).
    Returns the flash launches of its model dispatches, by dtype."""
    from sparkdl_tpu_torch import functions as sf
    from sparkdl_tpu_torch.models import bert_model_function_sequence_parallel
    from sparkdl_tpu_torch.obs import aggregate
    from sparkdl_tpu_torch.obs.aggregate import load_rank_snapshots
    from sparkdl_tpu_torch.ops import ulysses_attention_sharded
    from sparkdl_tpu_torch.ops.flash_attention import make_flash_attention_fn
    from sparkdl_tpu_torch.runtime.heartbeat import Heartbeat

    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = f"{device_name} ({_smi()})" if on_card else device_name
    spec = get_model(S_TEXT_MODEL)
    config = BERT_CONFIGS[spec.size]
    layers, width = config.num_layers, config.hidden_size
    texts = _texts(seed, S_TEXTS)
    df = DataFrame.fromColumns({"text": texts}, numPartitions=4)
    launches = {torch.float32: 0, torch.bfloat16: 0}
    # (a) the periodic, time-gated rank snapshot beside a heartbeat
    mf = spec.model_function(dtype=torch.float32, seed=seed, device=device)
    embed = TextEmbedder(inputCol="text", outputCol="emb", modelFunction=mf, maxLength=S_MAX_LENGTH,
                         batchSize=S_BATCH)
    few = DataFrame.fromColumns({"text": texts[:S_BEAT_TEXTS]}, numPartitions=2)
    embed.transform(few).collect()  # warm-up, not counted
    sync()
    hb_dir = os.path.join(tmp, "hb27")
    prev = os.environ.get("SPARKDL_OBS_SNAP_S")
    os.environ["SPARKDL_OBS_SNAP_S"] = str(S_SNAP_S)
    # every write of a rank's drop, by its path and the file's mtime after it
    writes = []
    write = aggregate.write_rank_snapshot

    def recorded(directory, rank, snap=None):
        path = write(directory, rank, snap)
        writes.append((path, os.stat(path).st_mtime_ns))
        return path

    aggregate.write_rank_snapshot = recorded
    flash_attention.launches = 0
    passes = 0
    try:
        t0 = time.perf_counter()
        with Heartbeat(hb_dir, 0, interval=S_BEAT_S) as hb:
            while time.perf_counter() - t0 < S_BEAT_RUN_S:
                rows = embed.transform(few).collect()
                sync()
                passes += 1
        beat_s = time.perf_counter() - t0
    finally:
        aggregate.write_rank_snapshot = write
        if prev is None:
            os.environ.pop("SPARKDL_OBS_SNAP_S")
        else:
            os.environ["SPARKDL_OBS_SNAP_S"] = prev
    check(all(r.emb is not None and r.emb.shape == (width,) for r in rows), "snapshot (27a): a row without an embedding")
    launches[torch.float32] += flash_attention.launches
    drops = len(writes)
    check({p for p, _ in writes} == {os.path.join(hb_dir, "obs.rank.0.json")}
          and [t for _, t in writes] == sorted(t for _, t in writes),
          f"snapshot (27a): the drops went to {sorted({p for p, _ in writes})}, or their mtimes went back")
    check(S_DROPS[0] <= drops <= S_DROPS[1],
          f"snapshot (27a): {drops} writes of obs.rank.0.json in {beat_s:.2f} s under "
          f"SPARKDL_OBS_SNAP_S={S_SNAP_S} and a {S_BEAT_S} s beat (expected {S_DROPS[0]} to {S_DROPS[1]})")
    snaps = load_rank_snapshots(hb_dir)
    check(list(snaps) == [0] and snaps[0]["rank"] == 0, f"snapshot (27a): the drops read back are {list(snaps)}")
    merged = os.path.join(tmp, "merged27.json")
    rc, _, err = _obs_cli("merge", hb_dir, "--out", merged)
    check(rc == 0, f"snapshot (27a): python -m sparkdl_tpu_torch.obs merge exited {rc}: {err[-2000:]}")
    with open(merged) as f:
        events = json.load(f)["traceEvents"]
    lanes = {e["pid"] for e in events if e.get("ph") == "X"}
    labels = [e["args"]["name"] for e in events if e.get("name") == "process_name"]
    check(lanes == {0} and len(labels) == 1, f"snapshot (27a): merged lanes {lanes}, labels {labels}")
    print(f"snapshot (27a) on {card}: {passes} TextEmbedder passes over {S_BEAT_TEXTS} texts in {beat_s:.2f} s under "
          f"a Heartbeat (beat {S_BEAT_S} s, {hb._beats} beats, SPARKDL_OBS_SNAP_S={S_SNAP_S}): {drops} "
          f"obs.rank.0.json drops (limits {S_DROPS[0]}-{S_DROPS[1]}, the forced exit drop included); obs merge: "
          f"{len(events)} Chrome events, lane {sorted(lanes)} ({labels[0]})")
    # (b) the pandas surfaces
    pandas_version = _pandas_version()
    scores = np.array([sum(float(x) * float(x) for x in r.emb[:16]) for r in rows])
    frame = DataFrame.fromColumns({"id": list(range(len(rows))), "g": [i % 3 for i in range(len(rows))],
                                   "score": scores.tolist()}, numPartitions=2)
    if pandas_version is None:
        print("pandas: absent on this machine; item 8.1 held on the CPU only")
        udf = sf.pandas_udf(lambda c: c * 2)
        try:
            udf("score")
            check(False, "pandas (27b): a pandas UDF applied without pandas raised nothing")
        except ModuleNotFoundError as e:
            check("pandas" in str(e), f"pandas (27b): the ModuleNotFoundError names no pandas: {e}")
        spark = SparkSession.builder.appName("chip_smoke").getOrCreate()
        made = spark.createDataFrame([(1, "a"), (2, None)], ["id", "s"]).toDF("i", "t")
        check([dict(r) for r in made.collect()] == [{"i": 1, "t": "a"}, {"i": 2, "t": None}],
              "pandas (27b): createDataFrame from a list and toDF")
        print("pandas (27b): F.pandas_udf builds; applying it raises ModuleNotFoundError naming pandas; "
              "createDataFrame from a list and toDF give their rows")
    else:
        doubled = frame.select(sf.pandas_udf(lambda c: c * 2)("score").alias("d")).collect()
        check([r["d"] for r in doubled] == (scores * 2).tolist(), "pandas (27b): pandas_udf against numpy")
        means = frame.groupBy("g").applyInPandas(
            lambda pdf: pdf.head(1)[["g"]].assign(m=pdf["score"].mean()), "g, m").collect()
        for r in means:
            mine = scores[[i for i in range(len(scores)) if i % 3 == r["g"]]]
            check(abs(r["m"] - mine.mean()) <= 1e-12 * abs(mine.mean()), f"pandas (27b): group {r['g']}'s mean")
        pdf = frame.toPandas()
        check(pdf["score"].tolist() == scores.tolist() and str(pdf["id"].dtype) == "int64",
              "pandas (27b): toPandas against numpy")
        print(f"pandas (27b): present (pandas {pandas_version}); pandas_udf, applyInPandas ({len(means)} groups) "
              f"and toPandas over {len(scores)} bert scores equal to numpy")
    del mf, embed
    shutdown_feeders()
    # (c) sequence-parallel bert-base on an sp axis of one process
    mesh = make_mesh({"sp": 1})
    tok = HashingTokenizer(vocab_size=spec.vocab_size)
    ids_np, _ = _udf_to_batch(tok, S_MAX_LENGTH)(texts[:S_BATCH])
    ids = torch.from_numpy(ids_np).to(device)
    attn = (ids != 0).to(torch.int32)
    errs, times, dense_times = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        dense_mf = _bert_text_builder(spec.size, attention="dense")(
            spec, mode="embed", dtype=dtype, seed=seed, params=None, device=device)
        dense = dense_mf((ids, attn)).float()
        sync()
        dense_times[tag] = _call_ms(lambda: dense_mf((ids, attn)), on_card)
        del dense_mf
        for strategy, inner in (("ring", None), ("ulysses+flash", make_flash_attention_fn())):
            sp_mf = bert_model_function_sequence_parallel(
                spec.size, mesh=mesh, strategy=strategy.split("+")[0], dtype=dtype, seed=seed,
                max_length=S_MAX_LENGTH, device=device, inner=inner)
            check(sp_mf.single_stream and sp_mf.name == f"bert_{spec.size}[embed,{strategy.split('+')[0]}/spx1]",
                  f"sequence parallel (27c): {sp_mf.name}")
            flash_attention.launches = 0
            out = sp_mf((ids, attn)).float()
            sync()
            times[strategy, tag] = _call_ms(lambda: sp_mf((ids, attn)), on_card)
            calls = 1 + 2 + S_ITERS  # the checked call, time_ms's warm-up and its timed calls
            want = layers * calls if (inner is not None and on_card) else 0
            check(flash_attention.launches == want,
                  f"sequence parallel (27c) {strategy} {tag}: {flash_attention.launches} flash launches "
                  f"for {calls} calls (expected {want})")
            launches[dtype] += flash_attention.launches
            check(tuple(out.shape) == (S_BATCH, width) and bool(torch.isfinite(out).all()),
                  f"sequence parallel (27c) {strategy} {tag}: not a finite [{S_BATCH}, {width}] output")
            err = float((out - dense).abs().max())
            errs[strategy, tag] = err
            check(err <= DENSE_ATOL[dtype], f"sequence parallel (27c) {strategy} {tag}: max |sp - dense| {err:.3e} "
                  f"> {DENSE_ATOL[dtype]}")
            del sp_mf
        if on_card:
            torch.cuda.empty_cache()
    # the attention alone: Ulysses over the flash kernel against its plain version
    inner = make_flash_attention_fn()
    att = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        q, k, v, mask = _attention_inputs(S_BATCH, config.num_heads, S_MAX_LENGTH, width // config.num_heads,
                                          dtype, seed, fully_masked_row=True) if on_card else \
            _cpu_attention_inputs(S_BATCH, config.num_heads, S_MAX_LENGTH, width // config.num_heads, dtype, seed)
        ref = flash_attention_reference(q, k, v, mask).float()
        calls = 3
        flash_attention.launches = 0
        with (counted_profile() if on_card else nullcontext()) as prof:
            for _ in range(calls):
                got = ulysses_attention_sharded(q, k, v, mask[:, None, None, :], mesh, dtype=dtype, inner=inner)
        counted = flash_attention.launches
        recorded = _flash_kernel_counts(prof)[dtype] if on_card else 0
        check(counted == (calls if on_card else 0) and recorded == counted,
              f"ulysses (27c) {tag}: {counted} flash launches counted, {recorded} recorded by the profiler "
              f"for {calls} calls (expected 1 each)")
        err = float((got.float() - ref).abs().max())
        check(err <= ATOL[dtype] and not got[0].any(),
              f"ulysses (27c) {tag}: max |ulysses(flash) - reference| {err:.3e} > {ATOL[dtype]}, or the fully "
              "masked row is not 0")
        att[tag] = (err, counted, recorded)
    # TextEmbedder over the ring model: equal to its direct calls, never bucketed
    ring = bert_model_function_sequence_parallel(spec.size, mesh=mesh, strategy="ring", dtype=torch.float32,
                                                 seed=seed, max_length=S_MAX_LENGTH, device=device)
    emb = TextEmbedder(inputCol="text", outputCol="emb", modelFunction=ring, maxLength=S_MAX_LENGTH,
                       batchSize=S_BATCH)
    check(emb._device_fn().single_stream, "sequence parallel (27c): the TextEmbedder's device fn is not single_stream")
    metrics.reset()
    t0 = time.perf_counter()
    got = [r.emb for r in emb.transform(df).collect()]
    sync()
    embed_s = time.perf_counter() - t0
    counters = metrics.snapshot()["counters"]
    bucketed = {k: v for k, v in counters.items() if k.startswith("text.bucket_rows") or k == "text.tokens"}
    batches = _dispatches()
    check(not bucketed and batches == sum(math.ceil(c / S_BATCH) for c in df.partitionRowCounts()),
          f"sequence parallel (27c): the TextEmbedder bucketed ({bucketed}) or dispatched {batches} batches")
    direct = ring((ids, attn)).float().cpu().numpy()
    embed_err = max(float(np.abs(got[i] - direct[i]).max()) for i in range(S_BATCH))
    check(embed_err <= ATOL[torch.float32],
          f"sequence parallel (27c): TextEmbedder rows off the direct calls by {embed_err:.3e}")
    del ring, emb
    shutdown_feeders()
    print(f"sequence parallel (27c) on {card}: {S_TEXT_MODEL} over an sp axis of 1 at L={S_MAX_LENGTH}, "
          f"B={S_BATCH}, against the dense build on the same seeded weights: "
          + "; ".join(f"{st} {tag} max |sp - dense| {errs[st, tag]:.3e} (atol {DENSE_ATOL[d]}), "
                      f"{_fmt(times[st, tag])} ms per call" for d in (torch.float32, torch.bfloat16)
                      for tag in [str(d)[6:]] for st in ("ring", "ulysses+flash"))
          + "; dense " + ", ".join(f"{tag} {_fmt(ms)} ms per call" for tag, ms in dense_times.items())
          + "; ulysses_attention_sharded(inner=flash) at B={} H={} L={} Dh={} with a fully masked row: ".format(
              S_BATCH, config.num_heads, S_MAX_LENGTH, width // config.num_heads)
          + ", ".join(f"{tag} max |err| {e:.3e} vs flash_attention_reference, {c} launches counted, {r} "
                      f"recorded for 3 calls" for tag, (e, c, r) in att.items())
          + f"; TextEmbedder over the ring model: {len(texts)} texts, {batches} batches at {S_MAX_LENGTH} (no "
          f"bucketing), {embed_s:.3f} s = {len(texts) / embed_s:.1f} rows/s, rows within {embed_err:.3e} of the "
          f"direct calls")
    return launches


class _LayerStack(torch.nn.Module):
    """A pipeline stage: BERT layers in turn, without a padding mask."""

    def __init__(self, layers):
        super().__init__()
        self.layers = layers

    def forward(self, h):
        for layer in self.layers:
            h = layer(h, None)
        return h


def _rel(got, ref) -> float:
    """max |got - ref| over max |ref|, over tensors or lists of tensors."""
    pairs = list(zip(got, ref)) if isinstance(got, (list, tuple)) else [(got, ref)]
    err = max(float((g.detach().float() - r.detach().float()).abs().max()) for g, r in pairs)
    return err / max(max(float(r.detach().float().abs().max()) for _, r in pairs), 1e-30)


def phase_model_parallel(seed: int, device_name: str, device="cuda") -> dict:
    """Phase 28: tensor, pipeline and expert parallelism at bert-base width,
    and gradients through sequence parallelism, over mesh axes of one
    process (one H100 is one rank; ``device="cpu"``: a rehearsal, with the
    sizes cut by the caller). Returns the flash launches of 28(b)'s
    pipeline calls, by dtype."""
    from torch.func import functional_call

    from sparkdl_tpu_torch.models import bert_model_function_sequence_parallel
    from sparkdl_tpu_torch.models.bert import dense_attention
    from sparkdl_tpu_torch.ops.flash_attention import make_flash_attention_fn
    from sparkdl_tpu_torch.parallel import moe_apply, pipeline_apply, stack_stage_params, tp_block_sharded

    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = f"{device_name} ({_smi()})" if on_card else device_name
    spec = get_model(M_TEXT_MODEL)
    config = BERT_CONFIGS[spec.size]
    width, layers = config.hidden_size, config.num_layers
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    def gelu(h):
        return F.gelu(h, approximate="none")  # BERT's

    dtypes = (torch.float32, torch.bfloat16)
    launches = dict.fromkeys(dtypes, 0)
    # (a) tensor parallelism: layer 0's FFN, 16384 tokens
    enc = _bert_encoder(config, dense_attention, seed, None, device)
    ffn = enc.layers[0]
    weights = [t.detach() for t in (ffn.intermediate.weight.t(), ffn.mlp_output.weight.t(),
                                    ffn.intermediate.bias, ffn.mlp_output.bias)]
    del enc, ffn
    x0, gy0 = randn(M_TP_ROWS, width), randn(M_TP_ROWS, width)
    tp_lines = []
    for dtype in dtypes:
        tag = str(dtype)[6:]
        w1, w2, b1, b2 = (t.to(dtype).contiguous() for t in weights)
        x, gy = x0.to(dtype), gy0.to(dtype)

        def plain(x_, w1_, w2_, b1_, b2_):
            return gelu(x_ @ w1_ + b1_) @ w2_ + b2_

        leaves = [t.clone().requires_grad_(True) for t in (x, w1, w2, b1, b2)]
        ref = plain(*leaves)
        ref_grads = torch.autograd.grad(ref, leaves, gy)
        plain_ms = (_call_ms(lambda: plain(x, w1, w2, b1, b2), on_card),
                    _call_ms(lambda: torch.autograd.grad(plain(*leaves), leaves, gy), on_card))
        for name, axes, dp_axis in (("tp", {"tp": 1}, None), ("dp x tp", {"dp": 1, "tp": 1}, "dp")):
            mesh = make_mesh(axes)

            def block(x_, w1_, w2_, b1_, b2_):
                return tp_block_sharded(x_, w1_, w2_, mesh, activation=gelu, b1=b1_, b2=b2_, dp_axis=dp_axis)

            out = block(*leaves)
            grads = torch.autograd.grad(out, leaves, gy)
            sync()
            errs = [_rel(out, ref)] + [_rel(g, r) for g, r in zip(grads, ref_grads)]
            check(tuple(out.shape) == (M_TP_ROWS, width) and bool(torch.isfinite(out).all()),
                  f"tensor parallel (28a) {name} {tag}: not a finite [{M_TP_ROWS}, {width}] output")
            check(max(errs) <= M_REL[dtype],
                  f"tensor parallel (28a) {name} {tag}: relative errors (out, dx, dw1, dw2, db1, db2) "
                  f"{['%.3e' % e for e in errs]} against the plain products, limit {M_REL[dtype]}")
            fwd = _call_ms(lambda: block(x, w1, w2, b1, b2), on_card)
            both = _call_ms(lambda: torch.autograd.grad(block(*leaves), leaves, gy), on_card)
            tp_lines.append(f"{name} {tag} worst relative error {max(errs):.3e} (limit {M_REL[dtype]}), "
                            f"{_fmt(fwd)} ms forward, {_fmt(both)} ms forward+backward (plain products "
                            f"{_fmt(plain_ms[0])} / {_fmt(plain_ms[1])})")
        del leaves, ref, ref_grads, out, grads
    print(f"tensor parallel (28a) on {card}: tp_block_sharded over {M_TEXT_MODEL} layer 0's FFN ({width}->"
          f"{config.intermediate_size}->{width}, biases, GELU), x [{M_TP_ROWS}, {width}], output and the grads of x, "
          f"w1, w2, b1, b2 against the plain two products: " + "; ".join(tp_lines))
    del x0, gy0, weights
    # (b) pipeline parallelism: the 12 layers as one stage, over the flash kernel
    pp = make_mesh({"pp": 1})
    x0 = randn(M_BATCH, M_MAX_LENGTH, width)
    calls = 1 + 2 + S_ITERS  # the checked call, time_ms's warm-up and its timed calls
    pp_lines = []
    for dtype in dtypes:
        tag = str(dtype)[6:]
        stack = _LayerStack(_bert_encoder(replace(config, dtype=dtype), make_flash_attention_fn(), seed, None,
                                          device).layers)
        stacked = stack_stage_params([{n: p.detach() for n, p in stack.named_parameters()}])

        def stage(params, h, stack=stack):
            return functional_call(stack, params, (h,))

        x = x0.to(dtype)
        with torch.no_grad():
            direct = stack(x).float()
            sync()
            flash_attention.launches = 0
            with (counted_profile() if on_card else nullcontext()) as prof:
                out = pipeline_apply(stage, stacked, x, pp, n_microbatches=M_MICRO)
            sync()
            counted = flash_attention.launches
            recorded = _flash_kernel_counts(prof)[dtype] if on_card else 0
            want = layers * M_MICRO if on_card else 0
            check(counted == want and recorded == counted,
                  f"pipeline (28b) {tag}: {counted} flash launches counted, {recorded} recorded by the profiler for "
                  f"one call (expected {want}: {layers} layers x {M_MICRO} microbatches)")
            err = float((out.float() - direct).abs().max())
            check(tuple(out.shape) == tuple(x.shape) and bool(torch.isfinite(out).all()) and err <= ATOL[dtype],
                  f"pipeline (28b) {tag}: max |pipeline - direct layers| {err:.3e} > {ATOL[dtype]}, or not finite")
            ms = _call_ms(lambda: pipeline_apply(stage, stacked, x, pp, n_microbatches=M_MICRO), on_card)
            total = flash_attention.launches  # the checked call's and the timed calls'
            check(total == want * calls if on_card else total == 0,
                  f"pipeline (28b) {tag}: {total} flash launches for {calls} calls (expected {want * calls})")
            launches[dtype] += total
            direct_ms = _call_ms(lambda: stack(x), on_card)
        pp_lines.append(f"{tag} max |pipeline - direct| {err:.3e} (atol {ATOL[dtype]}), {counted} flash launches "
                        f"counted and {recorded} recorded per call, {_fmt(ms)} ms per call (the layers called "
                        f"directly {_fmt(direct_ms)})")
        del stack, stacked, out, direct
        if on_card:
            torch.cuda.empty_cache()
    # backward through the dense-attention build of the same layers, f32
    stack = _LayerStack(_bert_encoder(config, dense_attention, seed, None, device).layers)
    names = [n for n, _ in stack.named_parameters()]
    stacked = {n: t.requires_grad_(True) for n, t in
               stack_stage_params([{n: p.detach() for n, p in stack.named_parameters()}]).items()}

    def dense_stage(params, h):
        return functional_call(stack, params, (h,))

    gy = randn(M_BATCH, M_MAX_LENGTH, width)
    xg = x0.clone().requires_grad_(True)
    leaves = [stacked[n] for n in names] + [xg]
    got = torch.autograd.grad(pipeline_apply(dense_stage, stacked, xg, pp, n_microbatches=M_MICRO), leaves, gy)
    ref_leaves = [p for _, p in stack.named_parameters()] + [x0.clone().requires_grad_(True)]
    ref = torch.autograd.grad(stack(ref_leaves[-1]), ref_leaves, gy)
    sync()
    param_err, x_err = _rel([g[0] for g in got[:-1]], ref[:-1]), _rel(got[-1], ref[-1])
    del got, ref
    check(max(param_err, x_err) <= M_REL[torch.float32],
          f"pipeline (28b) backward: relative errors {param_err:.3e} (every stage parameter) and {x_err:.3e} (x) "
          f"against the layers' own gradients, limit {M_REL[torch.float32]}")
    bwd_ms = _call_ms(lambda: torch.autograd.grad(
        pipeline_apply(dense_stage, stacked, xg, pp, n_microbatches=M_MICRO), leaves, gy), on_card)
    del stack, stacked, leaves, ref_leaves, xg, gy
    if on_card:
        torch.cuda.empty_cache()
    print(f"pipeline (28b) on {card}: pipeline_apply over {{'pp': 1}}, one stage of {M_TEXT_MODEL}'s {layers} "
          f"BertLayers over make_flash_attention_fn(), x [{M_BATCH}, {M_MAX_LENGTH}, {width}], {M_MICRO} "
          f"microbatches, against the layers called directly: " + "; ".join(pp_lines)
          + f"; backward through the dense-attention build, f32: relative errors {param_err:.3e} (stage parameters) "
          f"and {x_err:.3e} (x), {_fmt(bwd_ms)} ms per forward+backward")
    del x0
    # (c) expert parallelism: 8 experts of bert-base FFN width, 8192 tokens
    ep = make_mesh({"ep": 1})
    d_ff, E, T = config.intermediate_size, M_EXPERTS, M_EP_TOKENS
    router = randn(width, E, scale=M_INIT_STD)
    experts = {"w1": randn(E, width, d_ff, scale=M_INIT_STD), "b1": randn(E, d_ff, scale=M_INIT_STD),
               "w2": randn(E, d_ff, width, scale=M_INIT_STD), "b2": randn(E, width, scale=M_INIT_STD)}

    def expert_fn(p, h):
        return gelu(h @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    x, gy = randn(T, width), randn(T, width)
    capacity = max(1, math.ceil(T / E * M_EP_FACTOR))
    with torch.no_grad():
        probs = torch.softmax(x @ router, dim=-1)
        chosen = probs.argmax(dim=-1)
        counts = torch.bincount(chosen, minlength=E)
        oracle = torch.zeros_like(x)
        for e in range(E):
            rows = chosen == e
            oracle[rows] = probs[rows, e, None] * expert_fn({k: v[e] for k, v in experts.items()}, x[rows])
        check(int(counts.max()) <= capacity, f"moe (28c): an expert got {int(counts.max())} tokens, past the "
              f"capacity {capacity}, so the oracle without drops does not hold")
        out = moe_apply(expert_fn, router, experts, x, ep, capacity_factor=M_EP_FACTOR)
        sync()
        err = _rel(out, oracle)
        check(bool(torch.isfinite(out).all()) and err <= M_REL[torch.float32],
              f"moe (28c): relative error {err:.3e} against the per-token oracle, limit {M_REL[torch.float32]}")
        ms = _call_ms(lambda: moe_apply(expert_fn, router, experts, x, ep, capacity_factor=M_EP_FACTOR), on_card)
        # capacity 256: each expert keeps its first 256 tokens in arrival order
        small = moe_apply(expert_fn, router, experts, x, ep, capacity=M_EP_DROP_CAPACITY)
        onehot = F.one_hot(chosen, E)
        slot = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
        dropped = slot >= M_EP_DROP_CAPACITY
        n_dropped = int(dropped.sum())
        check(n_dropped == T - int(torch.clamp(counts, max=M_EP_DROP_CAPACITY).sum()) and n_dropped > 0
              and not bool(small[dropped].any()),
              f"moe (28c): capacity {M_EP_DROP_CAPACITY}: {n_dropped} dropped tokens, not all exactly 0")
        kept_err = _rel(small[~dropped], oracle[~dropped])
        check(kept_err <= M_REL[torch.float32],
              f"moe (28c): capacity {M_EP_DROP_CAPACITY}: the kept tokens off the oracle by {kept_err:.3e}")
    router_leaf = router.clone().requires_grad_(True)
    (g_router,) = torch.autograd.grad(moe_apply(expert_fn, router_leaf, experts, x, ep, capacity_factor=M_EP_FACTOR),
                                      [router_leaf], gy)
    check(bool(torch.isfinite(g_router).all()) and bool(g_router.abs().max() > 0),
          "moe (28c): the router's gradient is not finite, or all 0")
    both_ms = _call_ms(lambda: torch.autograd.grad(
        moe_apply(expert_fn, router_leaf, experts, x, ep, capacity_factor=M_EP_FACTOR), [router_leaf], gy), on_card)
    print(f"moe (28c) on {card}: moe_apply over {{'ep': 1}}, {E} experts of {M_TEXT_MODEL} FFN width ({width}->"
          f"{d_ff}->{width}, GELU), {T} tokens, f32, capacity_factor {M_EP_FACTOR} (C = {capacity}): relative "
          f"error {err:.3e} against the per-token oracle, tokens per expert {counts.tolist()}, {_fmt(ms)} ms per "
          f"call, {_fmt(both_ms)} ms forward+backward (the router's grad max |g| {float(g_router.abs().max()):.3e}); "
          f"capacity {M_EP_DROP_CAPACITY}: {n_dropped} tokens dropped, each exactly 0, the kept within "
          f"{kept_err:.3e}")
    del router, experts, x, gy, oracle, out, small, router_leaf, g_router
    if on_card:
        torch.cuda.empty_cache()
    # (d) gradients through sequence-parallel bert-base
    tok = HashingTokenizer(vocab_size=spec.vocab_size)
    ids_np, _ = _udf_to_batch(tok, M_MAX_LENGTH)(_texts(seed, M_SP_BATCH))
    ids = torch.from_numpy(ids_np).to(device)
    attn = (ids != 0).to(torch.int32)
    weight = torch.arange(M_SP_BATCH * width, dtype=torch.float32, device=device).reshape(M_SP_BATCH, width)
    weight /= weight.numel()

    def param_grads(mf):
        named = {n: t.requires_grad_(True) for n, t in mf.named_params().items()}
        out = mf.apply(named, (ids, attn))
        return dict(zip(named, torch.autograd.grad((out * weight).sum(), list(named.values()))))

    dense_mf = _bert_text_builder(spec.size, attention="dense")(
        spec, mode="embed", dtype=torch.float32, seed=seed, params=None, device=device)
    ref = param_grads(dense_mf)
    sp = make_mesh({"sp": 1})
    sp_lines = []
    for strategy in ("ring", "ulysses"):
        mf = bert_model_function_sequence_parallel(spec.size, mesh=sp, strategy=strategy, dtype=torch.float32,
                                                   seed=seed, max_length=M_MAX_LENGTH, device=device)
        got = param_grads(mf)
        sync()
        check(set(got) == set(ref), f"sequence parallel (28d) {strategy}: parameters {sorted(set(got) ^ set(ref))}")
        err = _rel([got[n] for n in ref], list(ref.values()))
        check(err <= M_REL[torch.float32],
              f"sequence parallel (28d) {strategy}: parameter gradients off the dense build's by {err:.3e} "
              f"relative, limit {M_REL[torch.float32]}")
        ms = _call_ms(lambda: param_grads(mf), on_card)
        sp_lines.append(f"{strategy} relative error {err:.3e}, {_fmt(ms)} ms forward+backward")
        del mf, got
    dense_ms = _call_ms(lambda: param_grads(dense_mf), on_card)
    del dense_mf, ref
    flash_mf = bert_model_function_sequence_parallel(spec.size, mesh=sp, strategy="ulysses", dtype=torch.float32,
                                                     seed=seed, max_length=M_MAX_LENGTH, device=device,
                                                     inner=make_flash_attention_fn())
    raised = None
    try:
        param_grads(flash_mf)
    except RuntimeError as e:  # the flash op's backward on CUDA
        raised = str(e)
    check((raised is not None and "no backward" in raised) if on_card else raised is None,
          f"sequence parallel (28d): the Ulysses-over-flash model's backward on {device} raised {raised!r} "
          "(expected: the kernel's 'no backward' on CUDA, the plain version's gradient on the CPU)")
    del flash_mf
    if on_card:
        torch.cuda.empty_cache()
    print(f"sequence parallel (28d) on {card}: {M_TEXT_MODEL} f32 B={M_SP_BATCH} L={M_MAX_LENGTH} over {{'sp': 1}}, "
          f"the gradients of every parameter of a weighted sum of the pooled embeddings against the dense build's "
          f"on the same seeded weights (limit {M_REL[torch.float32]}): " + "; ".join(sp_lines)
          + f"; dense {_fmt(dense_ms)} ms forward+backward; the Ulysses-over-flash model's backward raised: "
          f"{raised!r}")
    return launches


def _call_ms(fn, on_card: bool):
    """ms per call by CUDA events over S_ITERS calls (after two warm-up
    calls); None on the CPU."""
    return time_ms(fn, S_ITERS) if on_card else None


def _cpu_attention_inputs(B, H, L, Dh, dtype, seed):
    """Inputs like ``_attention_inputs``' on the CPU (the rehearsal): row 0
    fully masked, the others keeping their first half."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, L, Dh)).astype(np.float32)).to(dtype) for _ in range(3))
    mask = torch.zeros(B, L)
    mask[0] = MASK_MIN
    mask[1:, L // 2:] = MASK_MIN
    return q, k, v, mask


def _flat_tree(tree, prefix=()):
    for key, sub in tree.items():
        if isinstance(sub, dict):
            yield from _flat_tree(sub, prefix + (key,))
        else:
            yield prefix + (key,), sub


def _top_level_ops(prof) -> int:
    """Top-level ``aten::`` ops in a finished torch.profiler run: the torch
    ops a forward dispatched."""
    return sum(1 for e in prof.events() if e.name.startswith("aten::") and e.cpu_parent is None)


def phase_stablehlo(seed: int, device_name: str, device="cuda") -> int:
    """Phase 29: StableHLO without JAX: (a) a keras-3 ``XlaCallModule``
    SavedModel of ResNet50 at full width, (b) a JAX ``ModelFunction.export``
    artifact (``device="cpu"``: a rehearsal, with ``X_IMAGES`` cut by the
    caller). Returns the flash launches of the phase's main path (0)."""
    from torch.profiler import ProfilerActivity, profile

    from sparkdl_tpu_torch.graph import tf_bundle
    from sparkdl_tpu_torch.graph.function import StableHLOModule, piece

    sys.path.insert(0, FIXTURES)
    try:
        from keras3_shard import shard_spec, write_saved_model
    finally:
        sys.path.remove(FIXTURES)
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = f"{device_name} ({_smi()})" if on_card else device_name
    t_phase = time.perf_counter()
    # (a) the keras-3 export, its shard rebuilt from the seeded weights
    spec = shard_spec()
    config = _resnet50_config()
    weights = _seeded_keras_weights(config, spec["seed"])
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_saved_model(tmp, weights)
        reader = tf_bundle.BundleReader(os.path.join(tmp, "variables", "variables"))
        for key in reader.keys():
            reader.get_tensor(key)  # raises on a CRC-32C mismatch
        n_crc = len(reader.keys())
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mf = ModelIngest.from_saved_model(tmp, device=device)
        sync()
        ingest_s = time.perf_counter() - t0
    check(mf.takes_nhwc and mf.device == device and mf.input_shape == (KERAS_SIDE, KERAS_SIDE, 3),
          f"stablehlo: {mf.name} on {mf.device}, input {mf.input_shape}")
    print(f"stablehlo (29a): keras-3 ResNet50 export's shard rebuilt ({spec['size']} bytes) and all {n_crc} "
          f"CRC-32C checks passed in {write_s:.2f} s; ingested on {mf.device} in {ingest_s:.2f} s ({card})")
    structs, _ = _colour_structs(seed, X_IMAGES, KERAS_SIDE)
    df = DataFrame.fromColumns({"image": structs}, numPartitions=IMAGE_PARTITIONS)
    warm = DataFrame.fromColumns({"image": structs[:X_BATCH]}, numPartitions=1)
    kw = dict(inputCol="image", outputCol="out", outputMode="vector", preprocessing="caffe", batchSize=X_BATCH)
    stage = TFImageTransformer(modelFunction=mf, **kw)
    _featurize(stage, warm, "out")
    flash_attention.launches = 0
    flash_attention.launches_by_dtype = dict.fromkeys(flash_attention.launches_by_dtype, 0)
    probe = utilization.NvmlBusyProbe(torch.cuda.current_device()) if on_card else None
    try:
        busy0 = probe() if on_card else 0.0
        rows, dt = _featurize(stage, df, "out")
        if on_card:
            time.sleep(2 * probe.poll_s)  # NVML's last sample of the pass
        busy = probe() - busy0 if on_card else float("nan")
    finally:
        if on_card:
            probe.close()
    launches = flash_attention.launches
    for i, r in enumerate(rows):
        check(r is not None and r.shape == (1000,) and bool(np.isfinite(r).all()),
              f"stablehlo: row {i} is not a finite 1000-d vector")
    card_rows = np.stack(rows)
    check(launches == 0, f"stablehlo: the XlaCallModule program launched the flash kernel {launches} times")
    # one batch under the profiler: the torch ops it dispatched
    batch = image_structs_to_batch(structs[:X_BATCH], height=KERAS_SIDE, width=KERAS_SIDE, chw=False)[0]
    x = torch.from_numpy(batch).to(device).float() - torch.from_numpy(CAFFE_MEAN_BGR).to(device)
    mf(x)
    sync()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mf(x)
        sync()
    xcm_ops = _top_level_ops(prof)
    from sparkdl_tpu_torch.graph import tf_import
    programs = list(tf_import._XCM_CACHE.values())
    interp_ops = programs[-1].ops_per_call if programs else -1
    print(f"stablehlo (29a) TFImageTransformer over the XlaCallModule ResNet50 {KERAS_SIDE}x{KERAS_SIDE} float32 on "
          f"{card}: {X_IMAGES} images, {IMAGE_PARTITIONS} partitions, batch {X_BATCH}, {dt:.3f} s = "
          f"{X_IMAGES / dt:.1f} images/s; NVML busy {busy:.3f} s = share {busy / dt:.3f} of the pass; flash "
          f"launches {launches}; {xcm_ops} torch ops dispatched per batch, {interp_ops} StableHLO ops per call")
    # the same weights as a KerasModule, and phase 21's translated GraphDef
    kspec = KerasModelSpec(config, weights)
    keras_mf = ModelIngest.from_keras(kspec, device=device)
    keras_stage = ImageModelTransformer(modelFunction=keras_mf, **kw)
    _featurize(keras_stage, warm, "out")
    keras_rows, keras_dt = _featurize(keras_stage, df, "out")
    err = _relative_error(card_rows, np.stack(keras_rows))
    raw, feed, fetch, _ = _tf_graph(seed)
    gd_mf = TFInputGraph.from_graph_def(raw, [feed], [fetch], input_shape=(KERAS_SIDE, KERAS_SIDE, 3), device=device)
    gd_stage = TFImageTransformer(modelFunction=gd_mf, **kw)
    _featurize(gd_stage, warm, "out")
    _, gd_dt = _featurize(gd_stage, df, "out")
    gd_mf(x)
    sync()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gd_mf(x)
        sync()
    gd_ops = _top_level_ops(prof)
    print(f"stablehlo (29a) against KerasModule on the same weights: relative error {err:.3e} (limit {X_REL}); "
          f"KerasModule {X_IMAGES / keras_dt:.1f} images/s, phase 21's translated GraphDef {X_IMAGES / gd_dt:.1f} "
          f"images/s ({gd_ops} torch ops per batch) on {card}; max |prob| {card_rows.max():.4f}")
    check(err <= X_REL, f"stablehlo: XlaCallModule vs KerasModule relative error {err:.3e}")
    del mf, keras_mf, gd_mf, stage, keras_stage, gd_stage, x
    shutdown_feeders()
    # (b) the JAX package's exported bert-tiny, loaded on the card
    path = os.path.join(FIXTURES, "jax_bert_tiny")
    t0 = time.perf_counter()
    loaded = ModelFunction.load(path, device=device)
    load_s = time.perf_counter() - t0
    check(isinstance(loaded.module, StableHLOModule) and loaded.device == device,
          f"stablehlo: {path} loaded as {type(loaded.module).__name__} on {loaded.device}")
    io = np.load(os.path.join(path, "io.npz"))
    port = piece(lambda ids: (ids, (ids != 0).to(torch.int32)), name="mask").and_then(
        get_model("bert-tiny").model_function(params=loaded.raw_params, device=device))
    flash_attention.launches = 0
    outs = {}
    for n in (len(io["ids"]), 2 * len(io["ids"]) + 1):
        ids = np.concatenate([io["ids"]] * 3)[:n]
        outs[n] = loaded(torch.from_numpy(ids).to(device)).float().cpu().numpy()
    sync()
    loaded_launches = flash_attention.launches
    check(loaded_launches == 0, f"stablehlo: the loaded program launched the flash kernel {loaded_launches} times")
    n0 = len(io["ids"])
    jax_err = float(np.abs(outs[n0] - io["y"]).max())
    big = max(outs)
    ids_big = torch.from_numpy(np.concatenate([io["ids"]] * 3)[:big]).to(device)
    port_y = port(ids_big).float().cpu().numpy()
    port_err = _relative_error(outs[big], port_y)
    ms = time_ms(lambda: loaded(ids_big), 20) if on_card else float("nan")
    port_ms = time_ms(lambda: port(ids_big), 20) if on_card else float("nan")
    print(f"stablehlo (29b) JAX export of bert-tiny loaded by ModelFunction.load on {card} in {load_s:.2f} s: "
          f"batch {n0} against the JAX outputs max |diff| {jax_err:.3e} (limit {X_JAX_ATOL}); batch {big} against "
          f"the port's bert-tiny from params.pkl relative {port_err:.3e} (limit {X_PORT_REL}); {ms:.3f} ms per "
          f"call of {big} rows, the port's bert-tiny {port_ms:.3f} ms; {loaded.module.program.ops_per_call} "
          f"StableHLO ops per call; flash launches 0")
    check(jax_err <= X_JAX_ATOL, f"stablehlo: loaded program vs JAX outputs {jax_err:.3e}")
    check(port_err <= X_PORT_REL, f"stablehlo: loaded program vs the port's bert-tiny {port_err:.3e}")
    print(f"phase 29: {time.perf_counter() - t_phase:.1f} s in all on {card}")
    return launches + loaded_launches


def _keras_app_check(name: str, config: dict, weights: dict, stored, device) -> tuple:
    """A family's pooled features and logits on ``device`` for the rows
    stored beside its config, against Keras's stored outputs: the two
    relative errors, each checked against KERAS_APPS_REL."""
    x = _keras_app_inputs(name, KERAS_APPS_ROWS)
    check(float(x.astype(np.float64).sum()) == float(stored[f"{name}/x_sum"]),
          f"keras apps: {name}'s rows are not the draw its stored outputs were made from")
    mf = ModelIngest.from_keras(KerasModelSpec(_keras_app_heads(config), weights), device=device)
    pooled, logits = (t.float().cpu().numpy() for t in mf(torch.from_numpy(x).permute(0, 3, 1, 2).to(device)))
    errs = (_relative_error(pooled, stored[f"{name}/pooled"]), _relative_error(logits, stored[f"{name}/logits"]))
    check(max(errs) <= KERAS_APPS_REL, f"keras apps: {name} pooled/logits relative error {errs} against Keras's "
          f"stored outputs (limit {KERAS_APPS_REL})")
    return errs


def phase_keras_apps(seed: int, device_name: str, tmp: str, device="cuda") -> int:
    """Phase 30: EfficientNet, EfficientNetV2, MobileNetV3, ConvNeXt,
    NASNet and InceptionResNetV2 from their committed configs through the
    Keras translator at full width (``device="cpu"``: a rehearsal, with
    the counts cut by the caller). Returns the flash launches (0)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = f"{device_name} ({_smi()})" if on_card else device_name
    t_phase = time.perf_counter()
    with np.load(os.path.join(KERAS_APPS_DIR, "outputs.npz")) as f:
        stored = {k: f[k] for k in f.files}
    apps = {}
    for name in KERAS_APPS:
        t0 = time.perf_counter()
        config = _keras_app_config(name)
        apps[name] = (config, _keras_app_weights(name, config))
        print(f"keras apps: {name} config read and weights seeded (BatchNorm statistics stored beside the config) "
              f"in {time.perf_counter() - t0:.2f} s")
    flash_attention.launches = 0
    # (a) EfficientNetB0 through KerasImageFileTransformer
    name = "EfficientNetB0"
    config, weights = apps[name]
    spec = KerasModelSpec(config, weights)
    root = os.path.join(tmp, "keras_apps_images")
    os.makedirs(root)
    uris, kinds = _keras_files(seed, root, KERAS_APPS_JPEGS)
    n = len(uris)
    shutdown_feeders()
    df = DataFrame.fromColumns({"uri": uris}, numPartitions=KERAS_PARTITIONS)
    t0 = time.perf_counter()
    stage = KerasImageFileTransformer(inputCol="uri", outputCol="probs", model=spec, batchSize=KERAS_BATCH,
                                      preprocessing="none", device=device)
    stage._model_function()
    sync()
    translate_s = time.perf_counter() - t0
    stage.transform(DataFrame.fromColumns({"uri": uris[:KERAS_BATCH]}, numPartitions=1)).collect()  # warm-up
    sync()
    metrics.reset()
    t0 = time.perf_counter()
    rows = [r["probs"] for r in stage.transform(df).collect()]
    sync()
    dt = time.perf_counter() - t0
    dispatches = _dispatches()
    valid = [i for i, k in enumerate(kinds) if k != "null"]
    check(len(rows) == n, f"keras apps (a): {len(rows)} rows, not {n}")
    for i, (p, kind) in enumerate(zip(rows, kinds)):
        if kind == "null":
            check(p is None, f"keras apps (a): row {i} ({uris[i]}) is not null")
            continue
        check(p is not None and p.shape == (1000,) and bool(np.isfinite(p).all())
              and abs(float(p.astype(np.float64).sum()) - 1.0) <= SQL_SUM_ATOL,
              f"keras apps (a): row {i} is not a probability vector")
    errs = {name: _keras_app_check(name, config, weights, stored, device)}
    print(f"keras apps (30a) {name} through KerasImageFileTransformer(preprocessing='none') on {card}: translated "
          f"and put on {device} in {translate_s:.2f} s; {len(valid)} images ({KERAS_APPS_JPEGS} JPEGs, "
          f"{2 * KERAS_PNGS} PNGs) and {n - len(valid)} null rows, {KERAS_PARTITIONS} partitions, batch "
          f"{KERAS_BATCH}, f32 warm: {dt:.3f} s = {len(valid) / dt:.1f} images/s, {dispatches} dispatches; "
          f"against Keras's stored outputs ({KERAS_APPS_ROWS} rows): pooled {errs[name][0]:.3e}, logits "
          f"{errs[name][1]:.3e} (limit {KERAS_APPS_REL})")
    del stage
    shutdown_feeders()
    # (b) the other families by ModelIngest.from_keras
    for name in [k for k in KERAS_APPS if k != "EfficientNetB0"]:
        config, weights = apps[name]
        side, (lo, hi) = KERAS_APPS[name]
        t0 = time.perf_counter()
        mf = ModelIngest.from_keras(KerasModelSpec(config, weights), device=device)
        sync()
        translate_s = time.perf_counter() - t0
        x = torch.from_numpy(np.random.default_rng(seed + 30).uniform(
            lo, hi, (KERAS_APPS_BATCH, 3, side, side)).astype(np.float32)).to(device)
        y = mf(x)
        check(tuple(y.shape) == (KERAS_APPS_BATCH, 1000) and bool(torch.isfinite(y).all()),
              f"keras apps: {name} gave {tuple(y.shape)}")
        sync()
        t0 = time.perf_counter()
        for _ in range(KERAS_APPS_ITERS):
            mf(x)
        sync()
        rate = KERAS_APPS_ITERS * KERAS_APPS_BATCH / (time.perf_counter() - t0)
        errs[name] = _keras_app_check(name, config, weights, stored, device)
        print(f"keras apps (30b) {name} {side}x{side} on {card}: translated and put on {device} in "
              f"{translate_s:.2f} s; warm {rate:.1f} images/s (f32, batch {KERAS_APPS_BATCH}, "
              f"{KERAS_APPS_ITERS} calls); against Keras's stored outputs: pooled {errs[name][0]:.3e}, logits "
              f"{errs[name][1]:.3e} (limit {KERAS_APPS_REL})")
        del mf, x, y
    if on_card:
        torch.cuda.empty_cache()
    # (c) fine-tuning EfficientNetB0 with a 10-way head
    config, weights = apps["EfficientNetB0"]
    config = json.loads(json.dumps(config))
    head = config["output_layers"][0]
    for layer in config["layers"]:
        if layer["name"] == head:
            layer["config"]["units"] = FT_CLASSES
    weights = dict(weights)
    rng = np.random.default_rng(seed + 300)
    cin = weights[head][0].shape[0]
    weights[head] = [(rng.standard_normal((cin, FT_CLASSES)) * np.sqrt(2.0 / (cin + FT_CLASSES))).astype(np.float32),
                     np.zeros(FT_CLASSES, np.float32)]
    spec = KerasModelSpec(config, weights)
    labels = rng.integers(0, FT_CLASSES, KERAS_APPS_FT_ROWS)
    palette = rng.integers(30, 226, size=(FT_CLASSES, 3))
    noise = rng.integers(-NOISE, NOISE + 1, size=(KERAS_APPS_FT_ROWS, KERAS_SIDE, KERAS_SIDE, 3))
    x = np.clip(palette[labels][:, None, None, :] + noise, 0, 255).astype(np.float32)
    y = np.eye(FT_CLASSES, dtype=np.float32)[labels]
    module = KerasModule(config, spec).to(device)
    if on_card:
        module = module.to(memory_format=torch.channels_last)
    t0 = time.perf_counter()
    hist = keras_fit.fit(module, x, y, optimizer="adam", loss="categorical_crossentropy",
                         params={"epochs": 1, "batch_size": KERAS_APPS_FT_BATCH, "shuffle": False}, seed=seed)
    sync()
    fit_s = time.perf_counter() - t0
    after = spec_from_module(module)._weights
    check(all(np.isfinite(hist["loss"])), f"keras apps (c): losses {hist['loss']}")
    moved = {path: [not np.array_equal(a, b) for a, b in zip(after[path], weights[path])]
             for path in ("block1a_se_reduce", "block6d_se_expand", "stem_bn", "top_bn", head)}
    check(all(all(m) for m in moved.values()), f"keras apps (c): weights that did not change: {moved}")
    kept = [np.array_equal(a, b) for a, b in zip(after["normalization"][:2], weights["normalization"][:2])]
    check(all(kept), "keras apps (c): the Normalization's statistics changed in training")
    steps = hist["steps"][0]
    print(f"keras apps (30c) EfficientNetB0 fine-tune with a {FT_CLASSES}-way head through keras_fit on {card}: "
          f"{KERAS_APPS_FT_ROWS} images, {steps} steps of {KERAS_APPS_FT_BATCH} (adam, noise-shaped Dropouts "
          f"drawing on {device}) in {fit_s:.2f} s ({1e3 * fit_s / steps:.1f} ms per step, the first step's "
          f"set-up included); loss {hist['loss'][0]:.4f}; the SE convs, BatchNorm gammas and moving statistics "
          f"and the head changed, the Normalization's statistics did not")
    del module
    launches = flash_attention.launches
    check(launches == 0, f"keras apps: {launches} flash launches on a CNN path")
    print(f"phase 30: {time.perf_counter() - t_phase:.1f} s in all on {card}; flash launches {launches}")
    return launches


def _keras_seq_config(name: str) -> dict:
    """A phase 31 model's committed config
    (``tests/fixtures/keras_seq/<name>.json.gz``)."""
    with gzip.open(os.path.join(KERAS_SEQ_DIR, f"{name}.json.gz"), "rt") as f:
        return json.load(f)


def _seeded_seq_weights(config: dict, seed: int = KERAS_SEQ_SEED) -> dict:
    """Weights for every layer of a phase 31 config, drawn from ``seed``:
    tables N(0, SEQ_EMB_STD); recurrent kernels N(0, 1/in) and N(0, 1/units)
    with biases N(0, 0.1) (GRU's input and recurrent biases alike);
    MultiHeadAttention's projections N(0, 1/fan-in) with biases N(0,
    0.02); Dense Glorot-scaled; LayerNormalization gamma in
    ``KERAS_LN_GAMMA``. Shapes from each layer's config and
    ``build_config``; another weighted class raises PhaseError."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(std)).astype(np.float32)

    def recurrent(layer, cin):
        cfg = layer["config"]
        units, gates = int(cfg["units"]), {"SimpleRNN": 1, "LSTM": 4, "GRU": 3}[layer["class_name"]]
        w = [normal((cin, gates * units), 1 / np.sqrt(cin)), normal((units, gates * units), 1 / np.sqrt(units))]
        if cfg.get("use_bias", True):
            two = layer["class_name"] == "GRU" and cfg.get("reset_after", True)
            w.append(normal((2, gates * units) if two else (gates * units,), 0.1))
        return w

    out = {}
    for path, _, layer, _ in walk_layers(config):
        cfg, cls = layer["config"], layer["class_name"]
        build = layer["build_config"]
        in_shape = build["shapes_dict"]["query_shape"] if "shapes_dict" in build else build["input_shape"]
        cin = None if in_shape[-1] is None else int(in_shape[-1])  # an Embedding's ids: no width
        if cls == "Embedding":
            w = [normal((int(cfg["input_dim"]), int(cfg["output_dim"])), SEQ_EMB_STD)]
        elif cls in ("SimpleRNN", "LSTM", "GRU"):
            w = recurrent(layer, cin)
        elif cls == "Bidirectional":
            w = recurrent(cfg["layer"], cin) + recurrent(cfg.get("backward_layer") or cfg["layer"], cin)
        elif cls == "MultiHeadAttention":
            heads, key_dim = int(cfg["num_heads"]), int(cfg["key_dim"])
            value_dim = int(cfg.get("value_dim") or key_dim)
            w = []
            for dim in (key_dim, key_dim, value_dim):
                w += [normal((cin, heads, dim), 1 / np.sqrt(cin)), normal((heads, dim), 0.02)]
            w += [normal((heads, value_dim, cin), 1 / np.sqrt(heads * value_dim)), normal((cin,), 0.02)]
        elif cls == "Dense":
            units = int(cfg["units"])
            w = [normal((cin, units), np.sqrt(2.0 / (cin + units))), normal((units,), 0.01)]
        elif cls == "LayerNormalization":
            w = [rng.uniform(*KERAS_LN_GAMMA, cin).astype(np.float32), normal((cin,), 0.05)]
        else:
            raise PhaseError(f"keras seq: no seeded weights for {cls}")
        out[path] = w
    return out


def _keras_seq_heads(name: str, config: dict) -> dict:
    """A copy of a phase 31 config whose outputs the check reads: the
    IMDB models' logit (their sigmoid made linear: a sigmoid near 0.5 would
    hide an error), the encoder's last LayerNormalization (the sequence,
    padded query rows included) and its logits."""
    config = json.loads(json.dumps(config))
    out_name = config["output_layers"][0]
    if name == SEQ_BERT_MODEL:
        last_ln = [l["name"] for l in config["layers"] if l["class_name"] == "LayerNormalization"][-1]
        config["output_layers"] = [[last_ln, 0, 0], [out_name, 0, 0]]
        return config
    for layer in config["layers"]:
        if layer["name"] == out_name:
            layer["config"]["activation"] = "linear"
    return config


def _keras_seq_rows(name: str, n: int, seed: int = KERAS_SEQ_INPUT_SEED, stored: bool = False) -> np.ndarray:
    """``n`` rows of token ids for a phase 31 model, drawn from ``seed``:
    the IMDB models' padded at the front to maxlen (``pad_sequences``),
    lengths in ``SEQ_IMDB_LENGTHS``; the encoder's padded at the back to
    512, lengths in ``SEQ_BERT_LENGTHS``. The stored rows (``stored``)
    also hold, for the encoder, one row padded at the front, and for
    every model one row with a 0 id inside its tokens (a mask with a hole,
    which the recurrent layers run step by step)."""
    bert = name == SEQ_BERT_MODEL
    vocab, length = (SEQ_BERT["vocab"], SEQ_BERT["length"]) if bert else (SEQ_IMDB["vocab"], SEQ_IMDB["maxlen"])
    lo, hi = SEQ_BERT_LENGTHS if bert else SEQ_IMDB_LENGTHS
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, size=n)
    rows = np.zeros((n, length), np.int32)
    for i, k in enumerate(lengths):
        ids = rng.integers(1, vocab, size=k)
        front = bert and not (stored and i == 1)
        rows[i, :k] = ids if front else 0
        if not front:
            rows[i, length - k:] = ids
    if stored:
        k = int(lengths[-1])
        start = 0 if bert else length - k
        rows[-1, start + k // 2] = 0
    return rows


def _keras_seq_check(name: str, config: dict, weights: dict, stored: dict, device) -> tuple:
    """A model's checked outputs on ``device`` for its stored rows against
    Keras's stored outputs: the relative errors (the IMDB logit; the
    encoder's sequence at ``SEQ_BERT_POSITIONS``, padded query steps
    included, and its logits), each checked against KERAS_SEQ_REL; and the
    ModelFunction."""
    x = _keras_seq_rows(name, KERAS_SEQ_ROWS, stored=True)
    check(int(x.astype(np.int64).sum()) == int(stored[f"{name}/x_sum"]),
          f"keras seq: {name}'s rows are not the draw its stored outputs were made from")
    mf = ModelIngest.from_keras(KerasModelSpec(_keras_seq_heads(name, config), weights), device=device)
    y = mf(torch.from_numpy(x).to(device))
    if name == SEQ_BERT_MODEL:
        seq, logits = (t.float().cpu().numpy() for t in y)
        seq = seq[:, list(SEQ_BERT_POSITIONS)]
        errs = (_relative_error(seq, stored[f"{name}/sequence"]), _relative_error(logits, stored[f"{name}/logits"]))
    else:
        errs = (_relative_error(y.float().cpu().numpy(), stored[f"{name}/logits"]),)
    check(max(errs) <= KERAS_SEQ_REL, f"keras seq: {name} relative errors {errs} against Keras's stored outputs "
          f"(limit {KERAS_SEQ_REL})")
    return errs, mf


def _seq_stage_pass(stage, rows: list, batch: int, sync, counts: list, captured: dict = None) -> tuple:
    """A warm-up pass over one batch, then a timed pass over ``rows`` (and
    a None cell) in SEQ_PARTITIONS partitions, with the metrics registry,
    the flash wrapper's counts, each of ``counts`` (a module's
    ``route_calls``) and ``captured`` (what a recorder keeps of the
    pass) set to 0 or emptied just before it: (outputs, seconds,
    dispatches)."""
    stage.transform(DataFrame.fromColumns({"ids": rows[:batch]}, numPartitions=1)).collect()
    sync()
    df = DataFrame.fromColumns({"ids": rows + [None]}, numPartitions=SEQ_PARTITIONS)
    metrics.reset()
    flash_attention.launches = 0
    flash_attention.launches_by_dtype = dict.fromkeys(flash_attention.launches_by_dtype, 0)
    for c in counts:
        c.update(dict.fromkeys(c, 0))
    if captured is not None:
        captured.clear()
    t0 = time.perf_counter()
    out = [r["p"] for r in stage.transform(df).collect()]
    sync()
    dt = time.perf_counter() - t0
    check(len(out) == len(rows) + 1 and out[-1] is None, "keras seq: the None cell is not a null row")
    return out[:-1], dt, _dispatches()


def _lstm_gate_shares(module, config: dict, x: torch.Tensor) -> tuple:
    """The forward LSTM of the first Bidirectional of an unmasked IMDB
    model over ids ``x``: the shares of its input, forget and output gate
    values in (0.01, 0.99) and in (0.45, 0.55), from its own output
    sequence (each step's gates are a product of the step's input and the
    previous step's output)."""
    names = {l["class_name"]: l["name"] for l in reversed(config["layers"])}
    emb = layer_module(module, names["Embedding"])
    rnn = layer_module(module, names["Bidirectional"]).forward_layer
    with torch.no_grad():
        e = emb(x)
        h = rnn(e)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        i, f, _, o = (F.linear(e, rnn.weight_ih, rnn.bias_ih) + F.linear(h_prev, rnn.weight_hh)).chunk(4, dim=-1)
        g = torch.sigmoid(torch.cat([i, f, o], dim=-1))
    return float(((g > 0.01) & (g < 0.99)).float().mean()), float(((g > 0.45) & (g < 0.55)).float().mean())


def phase_keras_seq(seed: int, device_name: str, device="cuda") -> int:
    """Phase 31: Keras sequence models through the translator at their
    published widths, from their committed configs, through
    ``KerasTransformer`` over a column of token ids (``device="cpu"``: a
    rehearsal, with the counts cut by the caller). Returns the flash
    launches of 31(b)'s timed pass by dtype."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = f"{device_name} ({_smi()})" if on_card else device_name
    t_phase = time.perf_counter()
    with np.load(os.path.join(KERAS_SEQ_DIR, "outputs.npz")) as f:
        stored = {k: f[k] for k in f.files}
    # (a) the IMDB models
    for name in SEQ_IMDB_MODELS:
        t0 = time.perf_counter()
        config = _keras_seq_config(name)
        weights = _seeded_seq_weights(config)
        spec = KerasModelSpec(config, weights)
        shutdown_feeders()
        stage = KerasTransformer(inputCol="ids", outputCol="p", model=spec, batchSize=SEQ_IMDB_BATCH, device=device)
        sync()
        translate_s = time.perf_counter() - t0
        module = stage.getModelFunction().module
        rnns = [m for m in module.modules() if type(m).__name__ == "_Recurrent"]
        rows = list(_keras_seq_rows(name, SEQ_IMDB_ROWS, seed + 31))
        out, dt, dispatches = _seq_stage_pass(stage, rows, SEQ_IMDB_BATCH, sync, [m.route_calls for m in rnns])
        check(all(p is not None and p.shape == (1,) and 0.0 < float(p[0]) < 1.0 for p in out),
              f"keras seq (31a) {name}: a row is not one probability")
        routes = {r: sum(m.route_calls[r] for m in rnns) for r in ("fused", "steps")}
        check(routes == {"fused": len(rnns) * dispatches, "steps": 0},
              f"keras seq (31a) {name}: recurrent calls by route {routes} over {dispatches} dispatches")
        errs, mf = _keras_seq_check(name, config, weights, stored, device)
        stored_routes = {r: sum(m.route_calls[r] for m in mf.module.modules() if type(m).__name__ == "_Recurrent")
                         for r in ("fused", "steps")}
        # the stored rows hold one with a 0 inside its tokens: with the mask, the batch runs step by step
        check(stored_routes == {"fused": 0, "steps": len(rnns)} if name.endswith("_masked")
              else stored_routes == {"fused": len(rnns), "steps": 0},
              f"keras seq (31a) {name}: the stored rows' recurrent calls by route {stored_routes}")
        gates = ""
        if name.endswith("_masked"):
            # one batch of the pass's pre-padded rows by each route: as it is (fused), and with a 0 inside
            # one row's tokens (the step loop); the other rows' logits must agree
            x = torch.from_numpy(np.stack(rows[:SEQ_IMDB_BATCH])).to(device)
            holed = x.clone()
            holed[0, -2] = 0
            checked = [m for m in mf.module.modules() if type(m).__name__ == "_Recurrent"]
            with torch.no_grad():
                by_route = []
                for ids in (x, holed):
                    for m in checked:
                        m.route_calls.update(dict.fromkeys(m.route_calls, 0))
                    by_route.append((mf.module(ids).float().cpu().numpy(),
                                     {r: sum(m.route_calls[r] for m in checked) for r in ("fused", "steps")}))
            (fused, fused_routes), (steps, steps_routes) = by_route
            check(fused_routes == {"fused": len(rnns), "steps": 0} and steps_routes == {"fused": 0, "steps": len(rnns)},
                  f"keras seq (31a) {name}: recurrent calls by route {fused_routes}, with a hole {steps_routes}")
            route_err = _relative_error(fused[1:], steps[1:])
            check(route_err <= KERAS_SEQ_REL, f"keras seq (31a) {name}: the fused route's logits {route_err:.3e} "
                  f"from the step loop's on the same pre-padded rows (limit {KERAS_SEQ_REL})")
            gates = (f"; a batch of {SEQ_IMDB_BATCH} pre-padded rows, the fused route against the step loop on "
                     f"rows 1-{SEQ_IMDB_BATCH - 1}: {route_err:.3e} (limit {KERAS_SEQ_REL})")
            if on_card and name == "imdb_bilstm_masked":
                with torch.no_grad():
                    fused_ms, steps_ms = time_ms(lambda: module(x), 10), time_ms(lambda: module(holed), 3)
                gates += (f"; the batch by the fused route {fused_ms:.3f} ms, with a 0 inside one row's tokens "
                          f"(the step loop) {steps_ms:.3f} ms")
        if name == "imdb_bilstm":
            x = torch.from_numpy(np.stack(rows[:SEQ_IMDB_BATCH])).to(device)
            open_share, mid_share = _lstm_gate_shares(module, config, x)
            check(open_share >= SEQ_GATES_OPEN and mid_share <= SEQ_GATES_MID,
                  f"keras seq: the seeded LSTM gates saturate: {open_share:.3f} in (0.01, 0.99), {mid_share:.3f} "
                  "in (0.45, 0.55)")
            gates = (f"; first LSTM's i/f/o gates over a batch: {open_share:.3f} in (0.01, 0.99), "
                     f"{mid_share:.3f} in (0.45, 0.55)")
        print(f"keras seq (31a) {name} through KerasTransformer on {card}: translated and put on {device} in "
              f"{translate_s:.2f} s; {len(rows)} rows of {SEQ_IMDB['maxlen']} ids (padded at the front, lengths "
              f"{SEQ_IMDB_LENGTHS[0]}-{SEQ_IMDB_LENGTHS[1]}) and a None cell, {SEQ_PARTITIONS} partitions, batch "
              f"{SEQ_IMDB_BATCH}, f32 warm: {dt:.3f} s = {len(rows) / dt:.1f} rows/s, {dispatches} dispatches; "
              f"recurrent calls by route {routes} (the stored rows' {stored_routes}); against Keras's stored "
              f"logits ({KERAS_SEQ_ROWS} rows, one with a 0 inside): {errs[0]:.3e} (limit {KERAS_SEQ_REL}){gates}")
        del stage, module, mf, rnns
    # (b) the encoder at bert-base's widths
    t0 = time.perf_counter()
    config = _keras_seq_config(SEQ_BERT_MODEL)
    weights = _seeded_seq_weights(config)
    seeded_s = time.perf_counter() - t0
    shutdown_feeders()
    t0 = time.perf_counter()
    stage = KerasTransformer(inputCol="ids", outputCol="p", model=KerasModelSpec(config, weights),
                             batchSize=SEQ_BERT_BATCH, device=device)
    sync()
    translate_s = time.perf_counter() - t0
    routes = stage.getModelFunction().module.attention_routes()
    check(routes == {"flash": SEQ_BERT["blocks"], "plain": 0}, f"keras seq (31b): attention routes {routes}")
    rows = list(_keras_seq_rows(SEQ_BERT_MODEL, SEQ_BERT_ROWS, seed + 31))
    counter = LAUNCH_COUNTERS[torch.float32]
    # the flash op's inputs at this call site: the first and the last call of the timed pass, then of the
    # stored rows' check (the recorder adds no launch: it hands each call on to the op)
    captured = {}
    real = keras_seq.flash_attention

    def record(q, k, v, mask):
        captured.setdefault("first", (q, k, v, mask))
        captured["last"] = (q, k, v, mask)
        captured["calls"] = captured.get("calls", 0) + 1
        return real(q, k, v, mask)

    keras_seq.flash_attention = record
    try:
        out, dt, dispatches = _seq_stage_pass(stage, rows, SEQ_BERT_BATCH, sync, [], captured)
        launched, registry = dict(flash_attention.launches_by_dtype), int(metrics.counter(counter))
        launches = flash_attention.launches
        main_path = dict(captured)
        captured.clear()
        errs, mf = _keras_seq_check(SEQ_BERT_MODEL, config, weights, stored, device)
    finally:
        keras_seq.flash_attention = real
    check(all(p is not None and p.shape == (2,) and bool(np.isfinite(p).all()) for p in out),
          "keras seq (31b): a row is not two finite logits")
    check(launched[torch.float32] == launches == SEQ_BERT["blocks"] * dispatches * on_card == registry
          and launched[torch.bfloat16] == 0,
          f"keras seq (31b): flash launches {launched} (all {launches}, registry {registry}) for {dispatches} "
          "dispatches")
    check(main_path.get("calls") == SEQ_BERT["blocks"] * dispatches and captured.get("calls") == SEQ_BERT["blocks"],
          f"keras seq (31b): {main_path.get('calls')} flash calls in the timed pass, {captured.get('calls')} in the "
          "checked run")
    n_tokens = int(sum(int((r != 0).sum()) for r in rows))
    del stage
    q, k, v, mask = main_path["first"]
    check(q.shape[0] == SEQ_BERT_BATCH, f"keras seq (31b): the timed pass's first flash call has {q.shape}")
    kernel_errs = []
    for cq, ck, cv, cmask in (main_path["first"], main_path["last"], captured["first"], captured["last"]):
        kernel_errs.append(float((real(cq, ck, cv, cmask).float()
                                  - flash_attention_reference(cq, ck, cv, cmask).float()).abs().max()))
    check(max(kernel_errs) <= ATOL[torch.float32], f"keras seq (31b): kernel vs plain at the call site {kernel_errs}")
    valid = mask[0] == 0
    n_valid = int(valid.sum())
    with torch.no_grad():
        scores = torch.einsum("hqd,hkd->hqk", q[0][:, valid], k[0][:, valid]) / math.sqrt(q.shape[-1])
        peak = float(torch.softmax(scores, dim=-1).amax(dim=-1).mean())
    check(SEQ_ATTN_PEAK[0] / n_valid <= peak <= SEQ_ATTN_PEAK[1],
          f"keras seq (31b): the first layer's mean largest attention probability {peak:.4f} over {n_valid} keys")
    timing = ""
    if on_card:
        B, H, Lq, Dh = q.shape
        ms = time_ms(lambda: real(q, k, v, mask), 20)
        plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, mask), 5)
        keep = (mask == 0)[:, None, None, :]
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep), 20)
        bound_ms, bound_by = flash_attention_bound_ms(B, H, Lq, Dh, q.dtype, masked=True)
        timing = (f"; at this call site (B={B} H={H} L={Lq} Dh={Dh} f32, the timed pass's first call): kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, F.scaled_dot_product_attention {library_ms:.4f} ms, "
                  f"bound {bound_ms:.5f} ms ({bound_by})")
    del main_path, captured, q, k, v, mask, mf
    if on_card:
        torch.cuda.empty_cache()
    print(f"keras seq (31b) bert-base-width encoder ({SEQ_BERT['blocks']} blocks, {SEQ_BERT['hidden']} wide, "
          f"{SEQ_BERT['heads']} heads of {SEQ_BERT['head_dim']}, no position embeddings) through KerasTransformer "
          f"on {card}: weights seeded in {seeded_s:.2f} s, translated and put on {device} in {translate_s:.2f} s; "
          f"attention routes {routes}; {len(rows)} rows of {SEQ_BERT['length']} ids ({n_tokens} real tokens) and "
          f"a None cell, {SEQ_PARTITIONS} partitions, batch {SEQ_BERT_BATCH}, f32 warm: {dt:.3f} s = "
          f"{len(rows) / dt:.1f} rows/s, {dispatches} dispatches, {launches} flash launches (registry {registry}); "
          f"against Keras's stored outputs ({KERAS_SEQ_ROWS} rows): sequence at steps {SEQ_BERT_POSITIONS} "
          f"{errs[0]:.3e}, logits {errs[1]:.3e} (limit {KERAS_SEQ_REL}); kernel vs plain at the call site (the "
          f"timed pass's first and last call, B={SEQ_BERT_BATCH}, and the stored rows' first and last, "
          f"B={KERAS_SEQ_ROWS}) {max(kernel_errs):.3e} (atol {ATOL[torch.float32]}); the timed pass's first call's "
          "row 0: mean largest attention probability "
          f"{peak:.4f} over {n_valid} valid keys{timing}")
    print(f"phase 31: {time.perf_counter() - t_phase:.1f} s in all on {card}; flash launches f32 "
          f"{launched[torch.float32]}, bf16 {launched[torch.bfloat16]}")
    return launched


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
    # every leak record from phase 11 on lands in an events log that does
    # not roll over; phase 17 names them from it (and unsets the variable)
    leak_log = os.path.join(tempfile.mkdtemp(prefix="sparkdl_leaks_"), "events.jsonl")
    os.environ["SPARKDL_OBS_JSONL"] = leak_log
    phase11 = phase_serving(args.seed, device_name)
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
    # phase 17's failure edges (its OOM, its canary rollback) leave flight
    # recorder dumps that phase 20 reads
    dump_dir = tempfile.mkdtemp(prefix="sparkdl_dumps_")
    drops_dir = tempfile.mkdtemp(prefix="sparkdl_drops_")
    os.environ["SPARKDL_OBS_DUMP_DIR"] = dump_dir
    try:
        phase_control_plane(args.seed, device_name, leak_log)
    finally:
        os.environ.pop("SPARKDL_OBS_DUMP_DIR")
    done("phase 17")
    gang_launches = phase_gang(args.seed, device_name, phase11)
    done("phase 18")
    phase_batch_gang(args.seed, device_name, drops_dir)
    done("phase 19")
    int8_launches = phase_int8_obs(args.seed, device_name, dump_dir, drops_dir)
    done("phase 20")
    records[torch.float32]["launches_phase20"] = int8_launches
    phase_tf_ingest(args.seed, device_name)
    done("phase 21")
    with tempfile.TemporaryDirectory() as tmp:
        phase22 = phase_export_ingest(args.seed, device_name, tmp)
    done("phase 22")
    with tempfile.TemporaryDirectory() as tmp:
        phase23 = phase_jax_stages_expressions(args.seed, device_name, tmp)
    done("phase 23")
    records[torch.float32]["launches_phase23"] = phase23
    records[torch.bfloat16]["launches_phase23"] = 0
    phase24 = phase_relational(args.seed, device_name)
    done("phase 24")
    records[torch.float32]["launches_phase24"] = phase24
    records[torch.bfloat16]["launches_phase24"] = 0
    phase25 = phase_windows(args.seed, device_name)
    done("phase 25")
    records[torch.float32]["launches_phase25"] = phase25
    records[torch.bfloat16]["launches_phase25"] = 0
    with tempfile.TemporaryDirectory() as tmp:
        phase26 = phase_frame_io(args.seed, device_name, tmp)
    done("phase 26")
    records[torch.float32]["launches_phase26"] = phase26
    records[torch.bfloat16]["launches_phase26"] = 0
    with tempfile.TemporaryDirectory() as tmp:
        phase27 = phase_sequence_parallel(args.seed, device_name, tmp)
    done("phase 27")
    for dtype, n in phase27.items():
        records[dtype]["launches_phase27"] = n
    phase28 = phase_model_parallel(args.seed, device_name)
    done("phase 28")
    for dtype, n in phase28.items():
        records[dtype]["launches_phase28"] = n
    phase29 = phase_stablehlo(args.seed, device_name)
    done("phase 29")
    with tempfile.TemporaryDirectory() as tmp:
        phase30 = phase_keras_apps(args.seed, device_name, tmp)
    done("phase 30")
    for dtype in records:
        records[dtype]["launches_phase30"] = phase30
    phase31 = phase_keras_seq(args.seed, device_name)
    done("phase 31")
    for dtype, n in phase31.items():
        records[dtype]["launches_phase31"] = n
    records[torch.bfloat16]["launches_phase20"] = 0
    for dtype, n in phase22.items():
        records[dtype]["launches_phase22"] = n
    print(f"flash launches in 15(e) (bert-base from weights_file): {text_weight_launches}")
    print(f"flash launches in phase 18's workers (generation 1, from the federated /metrics): "
          f"f32 {gang_launches[torch.float32]}, bf16 {gang_launches[torch.bfloat16]}")
    print(f"flash launches in phase 20(a)'s flood (f32 and int8 bert-base): f32 {int8_launches}")
    print("flash launches in phase 21(a) (the translated ResNet50 GraphDef): 0")
    print(f"flash launches in phase 22: bf16 {phase22[torch.bfloat16]} (22a's loaded program, in its process), "
          f"f32 {phase22[torch.float32]} (22c's and 22e's orbax models)")
    print(f"flash launches in phase 23(b) (bert-base f32 under the expressions): {phase23}")
    print(f"flash launches in phase 24(a) (bert-base f32 under the relational queries): {phase24}")
    print(f"flash launches in phase 25(a) (bert-base f32 under the windows, TextEmbedder and UDF): {phase25}")
    print(f"flash launches in phase 26 (bert-base f32, 26(a)'s TextEmbedder and 26(e)'s UDF): {phase26}")
    print(f"flash launches in phase 27 (bert-base, 27(a)'s TextEmbedder f32 and 27(c)'s Ulysses models over the "
          f"flash kernel): f32 {phase27[torch.float32]}, bf16 {phase27[torch.bfloat16]}")
    print(f"flash launches in phase 28 (28(b)'s pipeline over bert-base's 12 layers, {M_MICRO} microbatches a call): "
          f"f32 {phase28[torch.float32]}, bf16 {phase28[torch.bfloat16]}")
    print(f"flash launches in phase 29 (the XlaCallModule ResNet50 and the loaded JAX program): {phase29}")
    print(f"flash launches in phase 30 (the Keras applications): {phase30}")
    print(f"flash launches in phase 31(b) (the Keras encoder's MultiHeadAttention): f32 {phase31[torch.float32]}, "
          f"bf16 {phase31[torch.bfloat16]}")
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
