"""The port's DataParallelEstimator against the JAX package's, on the CPU.

The semantics of the JAX package's ``tests/test_estimators.py`` and
``tests/test_streaming_train.py``: the same MLP (weights carried from the
flax init), the same rows, the same shuffle seeds. The JAX estimator runs
on conftest's 8 virtual devices (``dp=8``, which its ``make_mesh`` holds
to), the port in one process: the loss is a mean per shard averaged over
the shards, so every case uses row counts that are multiples of the
global batch and a global batch that is a multiple of 8, and every shard
is full. SGD runs are held element by element at atol 1e-5; Adam runs on
the loss history at rtol 1e-4 (tests/test_torch_train_step.py says why
Adam cannot be held element by element).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.estimators import DataParallelEstimator as JaxEstimator
from sparkdl_tpu.graph.ingest import ModelIngest
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.estimators import DataParallelEstimator, DataParallelModel, HorovodEstimator
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.utils.metrics import metrics

SGD_ATOL = 1e-5
ADAM_LOSS_RTOL = 1e-4
ROWS = 64
BATCH = 16


class _FlaxMLP:
    """flax ``Dense(16) -> relu -> Dense(2)``, built lazily."""

    @staticmethod
    def build():
        import flax.linen as fnn

        class MLP(fnn.Module):
            @fnn.compact
            def __call__(self, x):
                h = fnn.relu(fnn.Dense(16)(x))  # Dense_0
                return fnn.Dense(2)(h)  # Dense_1

        return MLP()


@pytest.fixture(scope="module")
def mlp():
    """(JAX ModelFunction, a factory of port ModelFunctions with the same
    weights on the CPU)."""
    module = _FlaxMLP.build()
    params = module.init(jax.random.PRNGKey(0), jnp.ones((1, 5)))
    jax_mf = ModelIngest.from_flax(module, params, input_shape=(5,))
    p = jax.tree_util.tree_map(np.asarray, params["params"])

    def port():
        seq = nn.Sequential(nn.Linear(5, 16), nn.ReLU(), nn.Linear(16, 2))
        with torch.no_grad():
            for lin, name in ((seq[0], "Dense_0"), (seq[2], "Dense_1")):
                lin.weight.copy_(torch.from_numpy(np.array(p[name]["kernel"].T)))
                lin.bias.copy_(torch.from_numpy(np.array(p[name]["bias"])))
        return ModelFunction.from_module(seq, input_shape=(5,), device="cpu")

    return jax_mf, port


def _blobs(n=ROWS, d=5, seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.normal(size=(n // 2, d)).astype(np.float32) + 1.0,
        rng.normal(size=(n // 2, d)).astype(np.float32) - 1.0,
    ])
    return [x[i] for i in range(n)], [0] * (n // 2) + [1] * (n // 2)


def _frames(partitions=4, **kw):
    feats, labels = _blobs(**kw)
    cols = {"features": feats, "label": labels}
    return JaxDataFrame.fromColumns(cols, numPartitions=partitions), DataFrame.fromColumns(cols, numPartitions=partitions)


def _dense_params(mf):
    seq = mf.module
    return [seq[0].weight.detach().numpy().T, seq[0].bias.detach().numpy(),
            seq[2].weight.detach().numpy().T, seq[2].bias.detach().numpy()]


def _jax_params(mf):
    p = mf.params["params"]
    return [np.asarray(p[n][k]) for n in ("Dense_0", "Dense_1") for k in ("kernel", "bias")]


def _fit_both(mlp, jax_df, df, sgd=True, **kw):
    jax_mf, port = mlp
    common = dict(inputCol="features", labelCol="label", outputCol="logits", batchSize=BATCH, **kw)
    jax_opt = dict(optimizer=optax.sgd(kw.get("stepSize", 0.05))) if sgd else {}
    port_opt = dict(optimizer=functools.partial(torch.optim.SGD, lr=kw.get("stepSize", 0.05))) if sgd else {}
    ref = JaxEstimator(model=jax_mf, **jax_opt, **common).fit(jax_df)
    ours = DataParallelEstimator(model=port(), **port_opt, device="cpu", **common).fit(df)
    return ref, ours


def test_fit_on_a_tensor_column_matches_jax(mlp):
    jax_df, df = _frames()
    ref, ours = _fit_both(mlp, jax_df, df, epochs=2, stepSize=0.05)
    assert [h["steps"] for h in ours.history] == [h["steps"] for h in ref.history] == [ROWS // BATCH] * 2
    np.testing.assert_allclose([h["loss"] for h in ours.history], [h["loss"] for h in ref.history], rtol=1e-5)
    for a, b in zip(_jax_params(ref.modelFunction), _dense_params(ours.modelFunction)):
        np.testing.assert_allclose(b, a, atol=SGD_ATOL)
    assert all(h["mean_step_time_s"] > 0 and h["timing"] == "epoch_wall_over_steps" for h in ours.history)


def test_default_adam_fit_matches_the_jax_loss_history(mlp):
    jax_df, df = _frames(seed=1)
    ref, ours = _fit_both(mlp, jax_df, df, sgd=False, epochs=3, stepSize=0.01)
    np.testing.assert_allclose([h["loss"] for h in ours.history], [h["loss"] for h in ref.history],
                               rtol=ADAM_LOSS_RTOL)
    assert ours.history[-1]["loss"] < ours.history[0]["loss"]


def test_streamed_fit_matches_the_jax_streamed_fit(mlp):
    jax_df, df = _frames(seed=2)
    metrics.reset()
    ref, ours = _fit_both(mlp, jax_df, df, epochs=2, stepSize=0.05, streaming=True, shuffleBufferRows=32)
    np.testing.assert_allclose([h["loss"] for h in ours.history], [h["loss"] for h in ref.history], rtol=1e-5)
    for a, b in zip(_jax_params(ref.modelFunction), _dense_params(ours.modelFunction)):
        np.testing.assert_allclose(b, a, atol=SGD_ATOL)
    assert metrics.snapshot()["timers"]["train.data_wait"]["count"] == 2 * ROWS // BATCH
    # and the streamed order is not the in-memory one
    _, in_memory = _fit_both(mlp, jax_df, df, epochs=2, stepSize=0.05)
    assert [h["loss"] for h in in_memory.history] != [h["loss"] for h in ours.history]


def test_trained_model_transform_matches_jax_through_the_shared_feeder(mlp, monkeypatch):
    jax_df, df = _frames(seed=3)
    ref, ours = _fit_both(mlp, jax_df, df, epochs=1, stepSize=0.05)
    assert isinstance(ours, DataParallelModel)
    ref_rows = [r.logits for r in ref.transform(jax_df).collect()]
    metrics.reset()
    rows = [r.logits for r in ours.transform(df).collect()]
    assert metrics.counter("feeder.coalesced_batches") > 0  # 4 partitions at once
    np.testing.assert_allclose(np.stack(rows), np.stack(ref_rows), rtol=1e-5, atol=1e-6)
    monkeypatch.setenv("SPARKDL_SHARED_FEEDER", "0")
    np.testing.assert_array_equal(np.stack([r.logits for r in ours.transform(df).collect()]), np.stack(rows))


def test_zero1_estimator_matches_the_plain_estimator(mlp):
    _, df = _frames(seed=4)
    _, port = mlp
    common = dict(model=None, inputCol="features", labelCol="label", outputCol="logits",
                  batchSize=BATCH, epochs=2, stepSize=0.01, device="cpu")
    fits = []
    for extra in ({}, {"shardOptimizerState": True}):
        est = DataParallelEstimator(**{**common, **extra})
        est.model = port()
        fits.append(est.fit(df))
    plain, zero1 = fits
    for a, b in zip(_dense_params(plain.modelFunction), _dense_params(zero1.modelFunction)):
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-5)


def test_checkpoint_and_resume(mlp, tmp_path):
    _, df = _frames(seed=5)
    _, port = mlp
    ckpt = str(tmp_path / "ckpts")
    common = dict(inputCol="features", labelCol="label", outputCol="logits", batchSize=BATCH,
                  stepSize=0.01, modelDir=ckpt, device="cpu")
    est = DataParallelEstimator(model=port(), epochs=3, checkpointEvery=2, **common)
    fitted = est.fit(df)
    saved = est._latest_step(ckpt)
    assert saved == 3 * ROWS // BATCH and fitted.history[-1]["loss"] < fitted.history[0]["loss"]
    # a fresh estimator on the same modelDir starts from the saved state
    est2 = DataParallelEstimator(model=port(), epochs=1, checkpointEvery=100, **common)
    resumed = est2.fit(df)
    assert est2._latest_step(ckpt) == saved + ROWS // BATCH
    # ... which a run from scratch does not reproduce
    fresh = DataParallelEstimator(model=port(), epochs=1, **{**common, "modelDir": str(tmp_path / "other")}).fit(df)
    assert resumed.history[0]["loss"] < fresh.history[0]["loss"]


def test_entry_point_defaults_to_cuda_and_refuses_a_model_elsewhere(mlp, monkeypatch):
    _, df = _frames()
    _, port = mlp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DataParallelEstimator(model=port(), inputCol="features").fit(df)
    assert HorovodEstimator is DataParallelEstimator
    with pytest.raises(ValueError, match="must be provided"):
        DataParallelEstimator(inputCol="features", device="cpu").fit(df)
