"""The port's text path against the JAX package's: tokenizer ids, bucket
ladders, and TextEmbedder end to end on a partitioned DataFrame, with the
JAX bert-tiny weights carried across. Embeddings at f32 atol 1e-4."""

import jax
import numpy as np
import pytest

from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.models import get_model as jax_get_model
from sparkdl_tpu.text import bucketing as jax_bucketing
from sparkdl_tpu.transformers.text import HashingTokenizer as JaxTokenizer
from sparkdl_tpu.transformers.text import TextEmbedder as JaxTextEmbedder
from sparkdl_tpu.utils.metrics import metrics as jax_metrics
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.models import get_model
from sparkdl_tpu_torch.runtime.executor import PartitionTaskError
from sparkdl_tpu_torch.text import bucketing
from sparkdl_tpu_torch.transformers.execution import run_batched
from sparkdl_tpu_torch.transformers.text import HashingTokenizer, TextEmbedder
from sparkdl_tpu_torch.utils.metrics import metrics

CORPUS = [
    "Hello, world!",
    "It's a TEST of the hashing tokenizer's word split",
    "unicode: café naïve Ωmega 東京",
    "numbers 123 4.56 and under_scores",
    "",
    "   spaces   everywhere   ",
]


@pytest.mark.parametrize("vocab", [1000, 8192, 30522])
def test_hashing_tokenizer_ids_match_jax(vocab):
    for add_special in (True, False):
        ours = HashingTokenizer(vocab_size=vocab, add_special=add_special)
        ref = JaxTokenizer(vocab_size=vocab, add_special=add_special)
        for text in CORPUS:
            assert ours(text) == ref(text)


@pytest.mark.parametrize("spec", ["pow2", "half", "32,48,64", "8,32,48,600"])
def test_bucket_ladders_match_jax(spec, monkeypatch):
    monkeypatch.setenv("SPARKDL_TEXT_BUCKETS", spec)
    for max_length in (8, 16, 64, 100, 300, 512, 2048):
        ladder = bucketing.bucket_ladder(max_length)
        assert ladder == jax_bucketing.bucket_ladder(max_length)
        assert ladder == bucketing.bucket_ladder(max_length, spec)
        for length in range(1, max_length + 40, 7):
            assert bucketing.bucket_for(length, ladder) == (
                jax_bucketing.bucket_for(length, ladder)
            )
    for length in (1, 15, 16, 17, 25, 97, 600, 1400, 1800, 2048, 5000):
        assert bucketing.next_bucket(length) == jax_bucketing.next_bucket(length)


def _texts():
    rng = np.random.default_rng(11)
    words = [int(n) for n in rng.integers(1, 40, size=22)]
    texts = [" ".join(f"w{i}x{j}" for j in range(n)) for i, n in enumerate(words)]
    texts[5] = None
    texts[13] = " ".join(f"long{j}" for j in range(100))  # > maxLength 64
    return texts


def _text_metrics(snapshot, kind):
    return {k: v for k, v in snapshot[kind].items() if k.startswith("text.")}


@pytest.fixture(scope="module")
def tiny_models():
    jax_mf = jax_get_model("bert-tiny").model_function()
    params = jax.tree_util.tree_map(np.asarray, jax_mf.params)
    port_mf = get_model("bert-tiny").model_function(params=params, device="cpu")
    return jax_mf, port_mf


@pytest.mark.parametrize("bucketed", ["1", "0"])
def test_text_embedder_matches_jax(tiny_models, bucketed, monkeypatch):
    monkeypatch.setenv("SPARKDL_TEXT_BUCKETING", bucketed)
    jax_mf, port_mf = tiny_models
    texts = _texts()
    kw = dict(inputCol="t", outputCol="e", maxLength=64, batchSize=4)

    jax_metrics.reset()
    ref = JaxTextEmbedder(modelFunction=jax_mf, **kw).transform(
        JaxDataFrame.fromColumns({"t": texts}, numPartitions=3)
    ).collect()
    metrics.reset()
    ours = TextEmbedder(modelFunction=port_mf, **kw).transform(
        DataFrame.fromColumns({"t": texts}, numPartitions=3)
    ).collect()

    assert [r.t for r in ours] == texts
    assert len(ours) == len(ref) == len(texts)
    for i, (o, r) in enumerate(zip(ours, ref)):
        if r.e is None:
            assert o.e is None, f"row {i}"
            continue
        assert o.e.shape == (128,) and np.isfinite(o.e).all()
        np.testing.assert_allclose(o.e, r.e, atol=1e-4, rtol=0, err_msg=f"row {i}")
    assert ours[5].e is None
    snap, jax_snap = metrics.snapshot(), jax_metrics.snapshot()
    counters = _text_metrics(snap, "counters")
    assert counters == _text_metrics(jax_snap, "counters")
    assert counters["text.truncated_rows"] == 1
    # the gauge holds the last partition's pad fraction; JAX runs its
    # partitions concurrently, so which one is last differs
    gauges = _text_metrics(snap, "gauges")
    assert gauges.keys() == _text_metrics(jax_snap, "gauges").keys()
    if bucketed == "1":
        assert counters["text.pad_tokens"] > 0
        assert 0 < gauges["text.pad_ratio"] < 1


def test_dataframe_checks_row_counts():
    with pytest.raises(ValueError, match="same length"):
        DataFrame.fromColumns({"a": [1, 2], "b": [1]})
    df = DataFrame.fromColumns({"a": list(range(7))}, numPartitions=3)
    assert df.count() == 7
    bad = df.withColumnPartition("b", lambda part: {"b": [0]})
    # the executor retries the partition, then raises as the JAX
    # package's does, naming the cause
    with pytest.raises(PartitionTaskError, match="ValueError: .*expected"):
        bad.collect()
    good = df.withColumnPartition("b", lambda part: {"b": [x * 2 for x in part["a"]]})
    assert good.collectColumns() == {
        "a": list(range(7)), "b": [2 * x for x in range(7)]
    }


def _int_batch(chunk):
    ids = np.array([[c or 0] for c in chunk], np.int32)
    return ids, np.array([c is not None for c in chunk])


def test_run_batched_pads_the_tail_and_scatters_rows_back():
    shapes = []

    def device_fn(x):
        shapes.append(tuple(x.shape))
        return x.float() * 2

    device_fn.device = "cpu"
    cells = [1, None, 3, 4, 5]
    out = run_batched(cells, _int_batch, device_fn, batch_size=2, prefetch=1)
    assert shapes == [(2, 1)] * 3  # the tail batch is zero-padded to 2 rows
    assert out[1] is None
    assert [o[0] for i, o in enumerate(out) if i != 1] == [2.0, 6.0, 8.0, 10.0]
    assert run_batched([None, None], _int_batch, device_fn, 2) == [None, None]


def test_run_batched_relays_host_errors():
    def device_fn(x):
        return x

    device_fn.device = "cpu"

    def bad_batch(chunk):
        raise KeyError("bad row")

    with pytest.raises(KeyError, match="bad row"):
        run_batched([1, 2, 3], bad_batch, device_fn, batch_size=2)


def test_text_embedder_params_follow_spark_ml_semantics():
    with pytest.raises(TypeError, match="keyword"):
        TextEmbedder("t")
    with pytest.raises(TypeError, match="maxLength"):
        TextEmbedder(maxLength="long")
    emb = TextEmbedder(inputCol="t", outputCol="e")
    assert emb.getOrDefault("maxLength") == 128 and emb.getBatchSize() == 32
    other = emb.copy({emb.maxLength: 16, "batchSize": 4})
    assert (other.getOrDefault("maxLength"), other.getBatchSize()) == (16, 4)
    assert emb.getOrDefault("maxLength") == 128  # the original is untouched
    with pytest.raises(ValueError, match="modelFunction"):
        emb.transform(DataFrame.fromColumns({"t": ["a"]}))
