"""The port's train job (``sparkdl_tpu_torch/worker.py``, ``"type":
"train"``) against the JAX package's estimator, on the CPU.

Every rank builds the model from a ``module:function`` builder (written
into the test's directory and put on the workers' ``PYTHONPATH``); the
JAX oracle builds the same weights from the same numpy seed. World 1 (in
process, no rendezvous) and world 2 (two ``python -m
sparkdl_tpu_torch.worker --device cpu`` processes over gloo) publish
``trained_params.pkl`` in the flax layout, ``history.json`` and
``_SUCCESS.train``; their losses equal the JAX fit's within relative
1e-4 and their parameters within 1e-4, and world 2 equals world 1 within
1e-5. ``modelDir`` resumes a second run from the first one's checkpoint,
and ``streaming=True`` trains over the port's lazy ``scanParquet``.
Mirrors ``tests/test_worker_train.py``.
"""

import json
import os
import pickle
import sys

import numpy as np
import pytest

from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.estimators import DataParallelEstimator as JaxEstimator
from sparkdl_tpu_torch.estimators import DataParallelEstimator
from sparkdl_tpu_torch.persistence import save_stage
from sparkdl_tpu_torch.worker import run_train_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
JAX_PARAM_ATOL = 1e-4
WORLD_ATOL = 1e-5

BUILDER_SRC = '''
import numpy as np
import torch
from torch import nn

from sparkdl_tpu_torch.graph.function import ModelFunction


class MLP(nn.Module):
    def __init__(self, f, h, c):
        super().__init__()
        self.Dense_0 = nn.Linear(f, h)
        self.Dense_1 = nn.Linear(h, c)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def weights(num_features=4, num_classes=3, hidden=8, seed=0):
    rng = np.random.default_rng(seed)
    w1 = rng.normal(0, 0.1, (num_features, hidden)).astype(np.float32)
    w2 = rng.normal(0, 0.1, (hidden, num_classes)).astype(np.float32)
    return w1, np.zeros(hidden, np.float32), w2, np.zeros(num_classes, np.float32)


def build(num_features=4, num_classes=3, hidden=8, seed=0, device="cpu"):
    w1, b1, w2, b2 = weights(num_features, num_classes, hidden, seed)
    m = MLP(num_features, hidden, num_classes)
    with torch.no_grad():
        for lin, w, b in ((m.Dense_0, w1, b1), (m.Dense_1, w2, b2)):
            lin.weight.copy_(torch.from_numpy(w.T.copy()))
            lin.bias.copy_(torch.from_numpy(b))
    return ModelFunction.from_module(m, input_shape=(num_features,), device=device)


def build_jax():
    import jax
    import jax.numpy as jnp

    from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction

    w1, b1, w2, b2 = weights()
    params = {"w1": jnp.asarray(w1), "b1": jnp.asarray(b1), "w2": jnp.asarray(w2),
              "b2": jnp.asarray(b2)}

    def fn(p, x):
        return jax.nn.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    return JaxModelFunction(fn, params, input_shape=(4,), name="mlp")
'''


@pytest.fixture(scope="module")
def train_fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_worker_train")
    (d / "torch_gang_models.py").write_text(BUILDER_SRC)
    rng = np.random.default_rng(3)
    n = 96
    x = rng.normal(0, 1, (n, 4)).astype(np.float32)
    y = np.argmax(x @ rng.normal(0, 1, (4, 3)) + rng.normal(0, 0.1, (n, 3)), axis=1).astype(np.int32)
    inp = str(d / "train.parquet")
    JaxDataFrame.fromColumns({"features": list(x), "label": list(y)}, 4).writeParquet(inp)
    sys.path.insert(0, str(d))
    try:
        import torch_gang_models
    finally:
        sys.path.pop(0)
    return {"dir": d, "input_parquet": inp, "models": torch_gang_models}


def _kw(**overrides):
    kw = dict(inputCol="features", labelCol="label", outputCol="logits", batchSize=32, epochs=3,
              stepSize=0.1)
    kw.update(overrides)
    return kw


def _train_job(fx, name, **est_kw):
    est_path = str(fx["dir"] / f"est_{name}")
    save_stage(DataParallelEstimator(**_kw(**est_kw)), est_path, overwrite=True)
    return {"type": "train", "estimator_path": est_path,
            "model": {"builder": "torch_gang_models:build", "kwargs": {}},
            "input_parquet": fx["input_parquet"], "num_partitions": 4,
            "output_dir": str(fx["dir"] / name)}


def _outputs(job):
    out = job["output_dir"]
    assert json.loads(open(os.path.join(out, "_SUCCESS.train")).read())["epochs"] >= 1
    with open(os.path.join(out, "history.json")) as f:
        history = json.load(f)
    with open(os.path.join(out, "trained_params.pkl"), "rb") as f:
        params = pickle.load(f)
    return history, params


def _oracle(fx, **est_kw):
    est = JaxEstimator(**_kw(**est_kw))
    est.model = fx["models"].build_jax()
    fitted = est.fit(JaxDataFrame.readParquet(fx["input_parquet"], numPartitions=4))
    p = {k: np.asarray(v) for k, v in fitted.modelFunction.params.items()}
    return fitted.history, p


def _as_jax_names(params):
    p = params["params"]
    return {"w1": p["Dense_0"]["kernel"], "b1": p["Dense_0"]["bias"],
            "w2": p["Dense_1"]["kernel"], "b2": p["Dense_1"]["bias"]}


def _against_oracle(history, params, oracle):
    ref_history, ref_params = oracle
    assert [h["steps"] for h in history] == [h["steps"] for h in ref_history]
    np.testing.assert_allclose([h["loss"] for h in history], [h["loss"] for h in ref_history],
                               rtol=LOSS_RTOL)
    ours = _as_jax_names(params)
    for k, v in ref_params.items():
        np.testing.assert_allclose(ours[k], v, atol=JAX_PARAM_ATOL, err_msg=k)
    assert history[-1]["loss"] < history[0]["loss"]


def _in_process(fx, job, **kw):
    sys.path.insert(0, str(fx["dir"]))
    try:
        return run_train_worker(job, process_id=0, num_processes=1, distributed=False,
                                device="cpu", **kw)
    finally:
        sys.path.pop(0)


def test_world_one_matches_the_jax_oracle(train_fixture):
    job = _train_job(train_fixture, "out_solo")
    fitted = _in_process(train_fixture, job)
    history, params = _outputs(job)
    assert len(history) == len(fitted.history) == 3
    assert sorted(params) == ["params"]
    _against_oracle(history, params, _oracle(train_fixture))
    with pytest.raises(ValueError, match="single-process"):
        run_train_worker(job, process_id=0, num_processes=2, distributed=False, device="cpu")


def test_world_two_over_gloo_matches_world_one_and_jax(train_fixture):
    from _gang import free_port, run_gang

    solo = _train_job(train_fixture, "out_solo2")
    _in_process(train_fixture, solo)
    job = _train_job(train_fixture, "out_gang")
    path = str(train_fixture["dir"] / "job_gang.json")
    with open(path, "w") as f:
        json.dump(job, f)
    port = free_port()
    env = {**os.environ, "PYTHONPATH": f"{train_fixture['dir']}:{REPO}"}
    run_gang(lambda i: [sys.executable, "-m", "sparkdl_tpu_torch.worker", "--job", path,
                        "--process-id", str(i), "--num-processes", "2", "--device", "cpu",
                        "--coordinator", f"localhost:{port}"], 2, env, timeout=240)
    history, params = _outputs(job)
    solo_history, solo_params = _outputs(solo)
    np.testing.assert_allclose([h["loss"] for h in history], [h["loss"] for h in solo_history],
                               rtol=WORLD_ATOL)
    for k, v in _as_jax_names(solo_params).items():
        np.testing.assert_allclose(_as_jax_names(params)[k], v, atol=WORLD_ATOL, err_msg=k)
    _against_oracle(history, params, _oracle(train_fixture))


def test_a_second_run_resumes_from_the_checkpoint(train_fixture):
    model_dir = str(train_fixture["dir"] / "ckpt")
    est_kw = dict(epochs=1, modelDir=model_dir, checkpointEvery=100)
    job1 = _train_job(train_fixture, "out_resume1", **est_kw)
    _in_process(train_fixture, job1)
    steps = lambda: DataParallelEstimator(**_kw())._latest_step(model_dir)  # noqa: E731
    assert steps() == 3  # 96 rows / batch 32
    job2 = _train_job(train_fixture, "out_resume2", **est_kw)
    _in_process(train_fixture, job2)
    assert steps() == 6
    h1, _ = _outputs(job1)
    h2, _ = _outputs(job2)
    assert h2[0]["loss"] < h1[0]["loss"]  # continued descent, not a restart


def test_streaming_trains_over_the_lazy_scan(train_fixture, monkeypatch):
    from sparkdl_tpu_torch.dataframe import DataFrame

    scans = []
    orig = DataFrame.scanParquet

    def scan(path, numPartitions=1):
        scans.append(numPartitions)
        return orig(path, numPartitions)

    monkeypatch.setattr(DataFrame, "scanParquet", staticmethod(scan))
    est_kw = dict(epochs=3, streaming=True, shuffleBufferRows=48)
    job = _train_job(train_fixture, "out_stream", **est_kw)
    _in_process(train_fixture, job)
    assert scans == [4]
    history, params = _outputs(job)
    assert all(h["steps"] == 3 for h in history)
    _against_oracle(history, params, _oracle(train_fixture, **est_kw))


def test_builder_spec_validation():
    from sparkdl_tpu_torch.worker import _resolve_model_builder

    for bad in ("no_colon_here", ":build", "mod:"):
        with pytest.raises(ValueError, match="module:function"):
            _resolve_model_builder({"builder": bad})
