"""The frame's statistics methods (``sparkdl_tpu_torch/dataframe/frame.py``:
``corr``, ``cov``, ``describe``, ``summary``, ``approxQuantile``,
``crosstab``, ``freqItems``, ``sampleBy``, ``sample`` and the ``df.stat``
namespace) against the JAX package's on the CPU.

Both packages get the same seeded numpy columns on three partitions:
ints, floats and numpy scalars with NULLs, a pair of columns with a mean
of 1e9 (the shifted one-pass sums), string keys with NULLs, booleans and
tensor cells. Tolerances: the moments (``corr``, ``cov``, ``describe``'s
mean and stddev) relative 1e-12; everything else exactly (the code is a
copy over the same numpy calls: ``summary``'s ``np.percentile``,
``approxQuantile``'s ranks, ``crosstab``/``freqItems`` counts, the draws of
``sample``/``sampleBy``). A call the JAX package refuses, the port refuses
with the same error type and message. Cases are drawn from the JAX
package's ``test_dataframe.py`` and ``test_parity_round5b.py``.
"""

import math

import numpy as np
import pytest

from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu_torch.dataframe import DataFrame

REL = 1e-12  # the moments; every other result compares exactly


def columns(seed: int = 3, n: int = 40) -> dict:
    rng = np.random.default_rng(seed)
    big = [1e9 + float(v) for v in rng.normal(0.0, 1.0, n)]
    return {
        "id": list(range(n)),
        "i": [None if rng.random() < 0.1 else int(v) for v in rng.integers(-50, 50, n)],
        "f": [None if rng.random() < 0.1 else float(v) for v in rng.normal(3.0, 2.0, n)],
        "big": big,
        "big2": [2.0 * b + float(e) for b, e in zip(big, rng.normal(0.0, 0.5, n))],
        "npf": [np.float32(v) for v in rng.normal(size=n)],
        "k": [None if rng.random() < 0.1 else "abcd"[int(v)] for v in rng.integers(0, 4, n)],
        "tag": ["xyz"[int(v)] for v in rng.integers(0, 3, n)],
        "flag": [bool(v) for v in rng.integers(0, 2, n)],
        "vec": [rng.normal(size=3).astype(np.float32) for _ in range(n)],
    }


@pytest.fixture(scope="module")
def frames():
    cols = columns()
    return DataFrame.fromColumns(cols, numPartitions=3), JaxDataFrame.fromColumns(cols, numPartitions=3)


def _norm(v):
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if isinstance(v, np.ndarray):
        return [_norm(x) for x in v.tolist()]
    if isinstance(v, np.generic):
        return _norm(v.item())
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    return v


def outcome(call):
    """A frame's rows, a value, or the failure (type and message)."""
    try:
        got = call()
    except Exception as e:  # noqa: BLE001 — compared below
        return ("raises", type(e).__name__, str(e))
    if hasattr(got, "collect"):
        return ("rows", got.columns, [{k: _norm(v) for k, v in r.items()} for r in got.collect()])
    return ("value", _norm(got))


def same(frames, build):
    ours, ref = frames
    got, want = outcome(lambda: build(ours)), outcome(lambda: build(ref))
    assert got == want
    return got


def close(frames, build):
    """Values (or rows of values) equal to the JAX package's within REL."""
    ours, ref = frames
    got, want = outcome(lambda: build(ours)), outcome(lambda: build(ref))
    assert got[0] == want[0]
    if got[0] == "raises":
        assert got == want
        return got

    def walk(a, b):
        if isinstance(a, float) and isinstance(b, float):
            assert a == pytest.approx(b, rel=REL)
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                walk(x, y)
        elif isinstance(a, dict):
            assert list(a) == list(b)
            for key in a:
                walk(a[key], b[key])
        else:
            assert a == b

    walk(got, want)
    return got


PAIRS = [("i", "f"), ("big", "big2"), ("f", "npf"), ("i", "i"), ("id", "big"), ("npf", "big2")]


@pytest.mark.parametrize("method", ["corr", "cov"])
@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_corr_and_cov_equal_the_jax_package(frames, method, pair):
    got = close(frames, lambda df: getattr(df, method)(*pair))
    assert got[0] == "value" and got[1] is not None


def test_the_shifted_sums_keep_a_large_mean(frames):
    """A mean of 1e9 cancels the plain sum of squares; the shifted sums
    keep corr within numpy's."""
    ours, _ = frames
    cols = columns()
    want = np.corrcoef(cols["big"], cols["big2"])[0, 1]
    assert ours.corr("big", "big2") == pytest.approx(want, rel=1e-9)
    assert ours.cov("big", "big2") == pytest.approx(np.cov(cols["big"], cols["big2"])[0, 1], rel=1e-9)


@pytest.mark.parametrize("data", [
    {"x": [1.0, 2.0], "y": [3.0, 3.0]},  # no variance
    {"x": [1.0, None], "y": [2.0, 5.0]},  # one pair
    {"x": [None, None], "y": [1.0, 2.0]},  # no pair
    {"x": [1, 2, 4, None], "y": [2, None, 8, 9]},
], ids=["constant", "one-pair", "no-pair", "null-pairs"])
@pytest.mark.parametrize("method", ["corr", "cov"])
def test_corr_and_cov_of_degenerate_columns(method, data):
    frames = (DataFrame.fromColumns(data, numPartitions=2), JaxDataFrame.fromColumns(data, numPartitions=2))
    close(frames, lambda df: getattr(df, method)("x", "y"))
    close(frames, lambda df: getattr(df, method)("x", "nope"))


DESCRIBE = [(), ("i", "k"), ("flag",), ("f", "npf", "big"), ("nope",), ("vec",)]


@pytest.mark.parametrize("cols", DESCRIBE, ids=[",".join(c) or "default" for c in DESCRIBE])
def test_describe_equals_the_jax_package(frames, cols):
    close(frames, lambda df: df.describe(*cols))


SUMMARY = [(), ("count", "10%", "90%"), ("min", "max", "99.5%", "0%", "100%"), ("stddev", "mean"), ("bogus",)]


@pytest.mark.parametrize("stats", SUMMARY, ids=[",".join(s) or "default" for s in SUMMARY])
def test_summary_equals_the_jax_package(frames, stats):
    same(frames, lambda df: df.summary(*stats))


def test_summary_and_describe_on_an_empty_and_a_planned_frame():
    data = {"x": [1.0, None, 3.0], "s": ["a", None, "b"]}
    frames = (DataFrame.fromColumns(data), JaxDataFrame.fromColumns(data))
    same(frames, lambda df: df.filter(lambda r: False).summary())
    same(frames, lambda df: df.filter(lambda r: r["x"] is not None).describe("x", "s"))
    same(frames, lambda df: df.filter(lambda r: r["x"] == 1.0).summary("stddev", "50%"))


QUANTILES = [
    ("i", [0.0, 0.25, 0.5, 0.75, 1.0], 0.0),
    (["i", "f", "big"], [0.5], 0.1),
    ("f", [0.1, 0.9], 0.25),
    ("npf", [0.33], 0.0),
    ("i", [1.5], 0.0),
    ("i", [0.5], -0.1),
    ("nope", [0.5], 0.0),
]


@pytest.mark.parametrize("col,probs,err", QUANTILES, ids=[str(i) for i in range(len(QUANTILES))])
def test_approx_quantile_equals_the_jax_package(frames, col, probs, err):
    same(frames, lambda df: df.approxQuantile(col, probs, err))


def test_approx_quantile_gives_exact_ranks():
    """rank ceil(p * n) - 1: p=0.5 over 4 values is the second, as in
    Spark with relativeError 0 (the JAX package's
    ``test_parity_round5b``); an all-null column gives []."""
    data = {"v": [4.0, 1.0, 3.0, 2.0], "z": [None] * 4}
    for frame in (DataFrame.fromColumns(data, numPartitions=2), JaxDataFrame.fromColumns(data, numPartitions=2)):
        assert frame.approxQuantile("v", [0.0, 0.5, 1.0], 0.0) == [1.0, 2.0, 4.0]
        assert frame.approxQuantile(["v", "z"], [0.5], 0.0) == [[2.0], []]


CROSSTABS = [("k", "tag"), ("tag", "flag"), ("flag", "k"), ("i", "tag"), ("k", "nope")]


@pytest.mark.parametrize("pair", CROSSTABS, ids=["-".join(p) for p in CROSSTABS])
def test_crosstab_equals_the_jax_package(frames, pair):
    same(frames, lambda df: df.crosstab(*pair))


def test_crosstab_refuses_a_value_named_as_its_label():
    data = {"a": ["x", "y"], "b": ["a_b", "z"]}
    frames = (DataFrame.fromColumns(data), JaxDataFrame.fromColumns(data))
    assert same(frames, lambda df: df.crosstab("a", "b"))[0] == "raises"


FREQ = [(["k", "tag"], 0.01), (["k"], 0.3), (["vec"], 0.01), (["i", "flag"], 0.05), (["k"], 0.0), (["nope"], 0.5)]


@pytest.mark.parametrize("cols,support", FREQ, ids=[str(i) for i in range(len(FREQ))])
def test_freq_items_equals_the_jax_package(frames, cols, support):
    same(frames, lambda df: df.freqItems(cols, support))


SAMPLE_BY = [
    ("k", {"a": 0.5, "b": 1.0}, 0),
    ("k", {"a": 0.3, "c": 0.7, None: 1.0}, 7),
    ("tag", {"x": 0.5, "y": 0.5, "z": 0.5}, -3),  # a negative seed is masked, as a hash seed
    ("tag", {"x": 1.0}, None),
    ("flag", {True: 0.4}, 2 ** 70),
    ("k", {"a": 1.5}, 0),
    ("nope", {"a": 0.5}, 0),
]


@pytest.mark.parametrize("col,fractions,seed", SAMPLE_BY, ids=[str(i) for i in range(len(SAMPLE_BY))])
def test_sample_by_equals_the_jax_package_bit_for_bit(frames, col, fractions, seed):
    same(frames, lambda df: df.sampleBy(col, fractions, seed))


def test_sample_by_draws_numpy_per_partition(frames):
    """Each partition draws from ``SeedSequence([seed, partition index])``,
    through a later op too (the op is indexed)."""
    ours, _ = frames
    cols = columns()
    fractions = {"a": 0.5, "b": 0.25}
    kept, start = [], 0
    for index, n in enumerate(ours.partitionRowCounts()):
        u = np.random.default_rng(np.random.SeedSequence([5, index])).random(n)
        kept += [start + j for j in range(n) if fractions.get(cols["k"][start + j], 0.0) > u[j]]
        start += n
    assert [r["id"] for r in ours.sampleBy("k", fractions, 5).select("id").collect()] == kept
    assert [r["id"] for r in ours.select("id", "k").sampleBy("k", fractions, 5).collect()] == kept


SAMPLE = [
    ((0.3,), {}), ((0.3, 11), {}), ((0.5,), {"seed": 4}), ((False, 0.4, 9), {}), ((), {"fraction": 0.2, "seed": 1}),
    ((0.0,), {}), ((1.0, 3), {}), ((True, 0.5), {}), ((1.5,), {}), ((0.5, 1, 2), {}), ((), {}), ((0.2,), {"bogus": 1}),
]


@pytest.mark.parametrize("args,kwargs", SAMPLE, ids=[str(i) for i in range(len(SAMPLE))])
def test_sample_equals_the_jax_package_bit_for_bit(frames, args, kwargs):
    same(frames, lambda df: df.sample(*args, **kwargs))


def test_sample_keeps_the_first_bucket_of_random_split(frames):
    """``sample(f, seed)`` is ``randomSplit([f, 1 - f], seed)[0]``: one
    numpy stream in (partition, row) order (the JAX package's
    ``test_dataframe.test_sample``)."""
    ours, _ = frames
    draws = np.random.default_rng(11)
    want = [i for i, d in enumerate(np.concatenate([draws.random(n) for n in ours.partitionRowCounts()]))
            if np.searchsorted(np.cumsum([0.3, 0.7]), d) == 0]
    assert [r["id"] for r in ours.sample(0.3, 11).collect()] == want


STAT_CALLS = {
    "approxQuantile": lambda s: s.approxQuantile(["i", "f"], [0.25, 0.75], 0.0),
    "corr": lambda s: s.corr("i", "f"),
    "corr-spearman": lambda s: s.corr("i", "f", method="spearman"),
    "cov": lambda s: s.cov("big", "big2"),
    "crosstab": lambda s: s.crosstab("k", "tag"),
    "freqItems": lambda s: s.freqItems(["k", "tag"], 0.2),
    "sampleBy": lambda s: s.sampleBy("k", {"a": 0.5, "d": 1.0}, 3),
}


@pytest.mark.parametrize("name", list(STAT_CALLS))
def test_the_stat_namespace_equals_the_jax_package_and_its_frame_method(frames, name):
    got = same(frames, lambda df: STAT_CALLS[name](df.stat))
    ours, _ = frames
    method = name.split("-")[0]
    if got[0] != "raises":
        assert outcome(lambda: STAT_CALLS[name](ours.stat)) == outcome(lambda: STAT_CALLS[name](ours))
    else:
        assert method == "corr"


@pytest.mark.parametrize("action", [
    lambda df: df.approxQuantile("i", [0.5]),
    lambda df: df.crosstab("k", "tag"),
    lambda df: df.freqItems(["k"]),
], ids=["approxQuantile", "crosstab", "freqItems"])
def test_the_collect_guard_stops_the_collecting_statistics(frames, monkeypatch, action):
    monkeypatch.setenv("SPARKDL_DRIVER_COLLECT_MAX_ROWS", "10")
    for frame in frames:
        with pytest.raises(ValueError, match="SPARKDL_DRIVER_COLLECT_MAX_ROWS=10"):
            action(frame)
        # a planned frame passes: its size after the plan is unknown
        action(frame.filter(lambda r: True))
