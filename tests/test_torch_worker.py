"""The port's batch gang worker (``sparkdl_tpu_torch/worker.py``) against a
single-process transform and against the JAX package's worker, on the
CPU.

Two in-process ranks, two ``python -m sparkdl_tpu_torch.worker --device
cpu`` subprocesses (without and with the gloo rendezvous) gather to the
single-process transform row for row. The files cross packages: the JAX
package's ``gather_results`` reads the port's outputs and the port's
reads the JAX worker's, for a ``LogisticRegressionModel`` with the same
weights (exactly), and for a bert-tiny ``TextEmbedder`` whose weights the
JAX package saved (``save_flax_weights``), built by each port rank from
the job's ``model`` builder, against the JAX package's own transform at
f32 atol 1e-4 (the JAX package cannot save a TextEmbedder with its model,
so the JAX arm runs in this process). An incomplete gang is named by
``_diagnose_missing_rank``; a restart with resume armed skips published
partitions and recomputes torn ones; heartbeats carry the generation and
the rank's terminal snapshot lands beside them. Mirrors
``tests/test_worker.py``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.estimators.logistic_regression import LogisticRegressionModel as JaxLRModel
from sparkdl_tpu.persistence import save_stage as jax_save_stage
from sparkdl_tpu.worker import gather_results as jax_gather_results
from sparkdl_tpu.worker import run_worker as jax_run_worker
from sparkdl_tpu_torch import worker as worker_mod
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.estimators.logistic_regression import LogisticRegressionModel
from sparkdl_tpu_torch.persistence import save_stage
from sparkdl_tpu_torch.transformers.text import TextEmbedder
from sparkdl_tpu_torch.worker import gather_results, run_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = 6
TEXT_ATOL = 1e-4


@pytest.fixture(scope="module")
def lr_job(tmp_path_factory):
    """An LR stage saved by each package with the same weights, an input
    file written by the JAX package, and the port's single-process output."""
    d = tmp_path_factory.mktemp("torch_worker")
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    stage = LogisticRegressionModel(w=w, b=b, featuresCol="features", predictionCol="pred",
                                    probabilityCol=None, device="cpu")
    save_stage(stage, str(d / "stage"))
    jax_save_stage(JaxLRModel(w=w, b=b, featuresCol="features", predictionCol="pred",
                              probabilityCol=None), str(d / "jax_stage"))
    inp = str(d / "input.parquet")
    JaxDataFrame.fromColumns({"features": list(rng.normal(0, 2, (30, 4)).astype(np.float32))},
                             1).writeParquet(inp)
    expected = stage.transform(DataFrame.readParquet(inp, PARTS)).collectColumns()
    job = {"stage_path": str(d / "stage"), "input_parquet": inp, "num_partitions": PARTS,
           "output_dir": None}
    return {"dir": d, "job": job, "expected": expected, "stage": stage}


def _job(lr_job, out_name, **extra):
    return {**lr_job["job"], "output_dir": str(lr_job["dir"] / out_name), **extra}


def _check(lr_job, out_dir, gather=gather_results):
    got = gather(out_dir, 2).collectColumns()
    want = lr_job["expected"]
    assert list(got["pred"]) == want["pred"]
    np.testing.assert_array_equal(np.stack(got["features"]), np.stack(want["features"]))


def test_two_workers_in_process_match_single_process(lr_job):
    job = _job(lr_job, "out_inproc")
    owned0 = run_worker(job, 0, 2, distributed=False, device="cpu")
    owned1 = run_worker(job, 1, 2, distributed=False, device="cpu")
    assert sorted(owned0 + owned1) == list(range(PARTS)) and not set(owned0) & set(owned1)
    _check(lr_job, job["output_dir"])
    names = sorted(os.listdir(job["output_dir"]))
    assert [n for n in names if n.endswith(".arrow")] == [f"part-{i:05d}.arrow" for i in range(PARTS)]
    started = json.loads(open(os.path.join(job["output_dir"], "_STARTED.1")).read())
    assert set(started) == {"process_id", "pid", "generation", "partitions"}
    assert started["partitions"] == [1, 3, 5]


def _spawn(lr_job, job, name, extra_args):
    from _gang import run_gang

    path = str(lr_job["dir"] / f"{name}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    run_gang(lambda pid: [sys.executable, "-m", "sparkdl_tpu_torch.worker", "--job", path,
                          "--process-id", str(pid), "--num-processes", "2", "--device", "cpu",
                          *extra_args],
             2, {**os.environ, "PYTHONPATH": REPO}, timeout=240)


def test_two_worker_subprocesses_match_single_process(lr_job):
    job = _job(lr_job, "out_subproc")
    _spawn(lr_job, job, "job_subproc", ["--no-distributed"])
    _check(lr_job, job["output_dir"])


def test_two_worker_subprocesses_with_the_gloo_rendezvous(lr_job):
    from _gang import free_port

    job = _job(lr_job, "out_rendezvous")
    _spawn(lr_job, job, "job_rdv", ["--coordinator", f"localhost:{free_port()}"])
    _check(lr_job, job["output_dir"])


def test_gathers_cross_packages_for_logistic_regression(lr_job):
    ours = _job(lr_job, "out_port")
    for r in (0, 1):
        run_worker(ours, r, 2, distributed=False, device="cpu")
    ref = {**ours, "stage_path": str(lr_job["dir"] / "jax_stage"),
           "output_dir": str(lr_job["dir"] / "out_jax")}
    for r in (0, 1):
        jax_run_worker(ref, r, 2, distributed=False)
    # the JAX gather over the port's files, the port's over the JAX files
    _check(lr_job, ours["output_dir"], jax_gather_results)
    _check(lr_job, ref["output_dir"], gather_results)
    a = gather_results(ours["output_dir"], 2).collectColumns()
    b = jax_gather_results(ref["output_dir"], 2).collectColumns()
    assert list(a["pred"]) == list(b["pred"])


def test_one_job_file_runs_under_both_workers(lr_job):
    """One job file over the stage saved by the JAX package: the port's
    worker loads it (class paths mapped), and both workers publish the
    same rows."""
    path = str(lr_job["dir"] / "job_both.json")
    with open(path, "w") as f:
        json.dump({**lr_job["job"], "stage_path": str(lr_job["dir"] / "jax_stage")}, f)
    with open(path) as f:
        job = json.load(f)
    ours = {**job, "output_dir": str(lr_job["dir"] / "out_both_port")}
    ref = {**job, "output_dir": str(lr_job["dir"] / "out_both_jax")}
    for r in (0, 1):
        run_worker(ours, r, 2, distributed=False, device="cpu")
        jax_run_worker(ref, r, 2, distributed=False)
    _check(lr_job, ours["output_dir"])
    a = gather_results(ours["output_dir"], 2).collectColumns()
    b = jax_gather_results(ref["output_dir"], 2).collectColumns()
    assert list(a["pred"]) == list(b["pred"])
    np.testing.assert_array_equal(np.stack(a["features"]), np.stack(b["features"]))


def test_bert_tiny_text_gang_matches_the_jax_transform(tmp_path):
    import jax.numpy as jnp

    from sparkdl_tpu.models import bert as jax_bert
    from sparkdl_tpu.models import registry as jax_registry
    from sparkdl_tpu.transformers.text import TextEmbedder as JaxTextEmbedder

    params = jax_bert.bert_tiny().init(jax.random.PRNGKey(7), jnp.zeros((1, 16), jnp.int32))
    weights = str(tmp_path / "tiny.npz")
    jax_registry.save_flax_weights(jax.tree_util.tree_map(np.asarray, params), weights)
    rng = np.random.default_rng(1)
    vocab = ["gang", "worker", "parquet", "arrow", "card", "rank", "row", "group"]
    texts = [" ".join(rng.choice(vocab, int(rng.integers(1, 40)))) for _ in range(22)]
    texts[5] = ""
    inp = str(tmp_path / "texts.parquet")
    DataFrame.fromColumns({"text": texts}, 3).writeParquet(inp)
    save_stage(TextEmbedder(inputCol="text", outputCol="emb", maxLength=48, batchSize=4),
               str(tmp_path / "stage"))
    job = {"stage_path": str(tmp_path / "stage"), "input_parquet": inp, "num_partitions": 5,
           "output_dir": str(tmp_path / "out"),
           "model": {"builder": "sparkdl_tpu_torch.models.registry:build_model_function",
                     "kwargs": {"name": "bert-tiny", "weights_file": weights}}}
    for r in (0, 1):
        run_worker(job, r, 2, distributed=False, device="cpu")
    got = gather_results(job["output_dir"], 2).collectColumns()
    ref_mf = jax_registry.get_model("bert-tiny").model_function(weights_file=weights)
    ref = JaxTextEmbedder(inputCol="text", outputCol="emb", modelFunction=ref_mf, maxLength=48,
                          batchSize=4).transform(JaxDataFrame.readParquet(inp, 5)).collectColumns()
    assert list(got["text"]) == texts == list(ref["text"])
    ours, want = np.stack(got["emb"]), np.stack([np.asarray(v) for v in ref["emb"]])
    assert ours.shape == want.shape == (22, 128)
    assert float(np.abs(ours - want).max()) <= TEXT_ATOL
    # the JAX package's gather reads the port's text outputs as a tensor column
    back = jax_gather_results(job["output_dir"], 2).collectColumns()
    np.testing.assert_array_equal(np.stack([np.asarray(v) for v in back["emb"]]), ours)


def test_gather_names_the_missing_ranks(lr_job, tmp_path):
    job = _job(lr_job, "partial")
    job["output_dir"] = str(tmp_path / "partial")
    run_worker(job, 0, 2, distributed=False, device="cpu")
    with pytest.raises(RuntimeError, match=r"Workers \[1\].*rank 1 never started"):
        gather_results(job["output_dir"], num_processes=2)
    # a rank that started and died mid-write reads differently
    with open(os.path.join(job["output_dir"], "_STARTED.1"), "w") as f:
        json.dump({"process_id": 1, "pid": 1, "generation": 2, "partitions": [1, 3, 5]}, f)
    run_worker(job, 0, 2, distributed=False, device="cpu")
    open(os.path.join(job["output_dir"], "part-00001.arrow.tmp"), "wb").close()
    msg = worker_mod._diagnose_missing_rank(job["output_dir"], 1)
    assert msg == ("rank 1 started (generation 2, owns partitions [1, 3, 5]) but died before "
                   "finishing: 0/3 partition outputs published, tmp write debris present "
                   "(part-00001.arrow.tmp)")
    from sparkdl_tpu.worker import _diagnose_missing_rank as jax_diagnose

    assert msg == jax_diagnose(job["output_dir"], 1)


def test_a_crashed_rank_restarts_over_its_debris(lr_job, tmp_path, monkeypatch):
    job = _job(lr_job, "restart")
    job["output_dir"] = str(tmp_path / "restart")
    run_worker(job, 0, 2, distributed=False, device="cpu")
    orig = worker_mod._write_partition_arrow
    calls = {"n": 0}

    def crash_on_second_write(columns, path):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated worker crash")
        orig(columns, path)

    monkeypatch.setattr(worker_mod, "_write_partition_arrow", crash_on_second_write)
    with pytest.raises(RuntimeError, match="simulated worker crash"):
        run_worker(job, 1, 2, distributed=False, device="cpu")
    monkeypatch.setattr(worker_mod, "_write_partition_arrow", orig)
    with pytest.raises(RuntimeError, match=r"Workers \[1\]"):
        gather_results(job["output_dir"], num_processes=2)
    with open(os.path.join(job["output_dir"], "part-00003.arrow"), "wb") as f:
        f.write(b"garbage")  # crash debris at a final path is recomputed
    run_worker(job, 1, 2, distributed=False, device="cpu")
    _check(lr_job, job["output_dir"])


def test_resume_skips_published_partitions(lr_job, tmp_path, monkeypatch):
    job = _job(lr_job, "resume")
    job["output_dir"] = str(tmp_path / "resume")
    run_worker(job, 0, 1, distributed=False, device="cpu")
    with open(os.path.join(job["output_dir"], "part-00002.arrow"), "wb") as f:
        f.write(b"garbage")
    monkeypatch.setenv("SPARKDL_GANG_RESUME", "1")
    monkeypatch.setenv("SPARKDL_GANG_GENERATION", "1")
    run_worker(job, 0, 1, distributed=False, device="cpu")
    marker = json.loads(open(os.path.join(job["output_dir"], "_SUCCESS.0")).read())
    assert marker["generation"] == 1 and sorted(marker["resumed"]) == [0, 1, 3, 4, 5]
    got = gather_results(job["output_dir"], 1).collectColumns()
    assert list(got["pred"]) == lr_job["expected"]["pred"]
    assert worker_mod._resume_enabled({}) and worker_mod._gang_generation({}) == 1
    monkeypatch.delenv("SPARKDL_GANG_RESUME")
    monkeypatch.delenv("SPARKDL_GANG_GENERATION")
    assert not worker_mod._resume_enabled({}) and worker_mod._resume_enabled({"resume": True})
    assert worker_mod._gang_generation({"generation": 4}) == 4


def test_heartbeats_carry_the_generation_and_a_snapshot_drops(lr_job, tmp_path, monkeypatch):
    from sparkdl_tpu.obs.aggregate import load_rank_snapshots as jax_load
    from sparkdl_tpu.runtime.heartbeat import stale_ranks

    job = _job(lr_job, "hb")
    job.update(output_dir=str(tmp_path / "out"), heartbeat_dir=str(tmp_path / "hb"),
               heartbeat_interval=0.05)
    monkeypatch.setenv("SPARKDL_GANG_GENERATION", "2")
    run_worker(job, 0, 1, distributed=False, device="cpu")
    final = json.loads(open(os.path.join(job["heartbeat_dir"], "hb.0")).read())
    assert final["generation"] == 2 and final["done"] is True
    assert stale_ranks(job["heartbeat_dir"], 1, 30.0, generation=2) == []
    assert stale_ranks(job["heartbeat_dir"], 1, 30.0, generation=3) == [0]
    snaps = jax_load(job["heartbeat_dir"])  # the JAX package reads the port's drop
    assert snaps[0]["rank"] == 0
    assert snaps[0]["metrics"]["counters"]["worker.partitions.published"] >= PARTS
    assert "SPARKDL_OBS_RANK" not in os.environ


def test_the_cli_without_a_card_exits_2(lr_job, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    path = tmp_path / "job.json"
    path.write_text(json.dumps(_job(lr_job, "nocard")))
    proc = subprocess.run([sys.executable, "-m", "sparkdl_tpu_torch.worker", "--job", str(path),
                           "--process-id", "0", "--num-processes", "1", "--no-distributed"],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr and "--device cpu" in proc.stderr
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_worker(_job(lr_job, "nocard2"), 0, 1, distributed=False)


def test_a_model_for_a_stage_without_one_is_refused(lr_job):
    job = _job(lr_job, "badmodel", model={"builder": "sparkdl_tpu_torch.models.registry:"
                                                     "build_model_function",
                                          "kwargs": {"name": "bert-tiny"}})
    with pytest.raises(ValueError, match="no modelFunction Param"):
        run_worker(job, 0, 1, distributed=False, device="cpu")
