"""The port's Parquet reader and writer (``sparkdl_tpu_torch/dataframe/
parquet.py``, with ``thrift_compact.py`` and ``snappy.py``) against the JAX
package and ``pyarrow``, on the CPU.

``pyarrow`` appears only on the reference side, as the writer and reader
the JAX package uses. Files that ``pyarrow`` writes with Snappy, gzip or
no compression, dictionary pages on and off, data pages v1 and v2,
several row-group sizes and a null in every column kind, and files the
JAX package's ``writeParquet`` writes, read in the port equal to JAX
``readParquet``. The port's files read in JAX ``readParquet`` and in
``pyarrow`` equal to the source, tensor columns as FixedShapeTensor. An
owned-span read decodes only the row groups that meet the span, and every
refusal names ROADMAP Queue A item 11. The committed fixture
``tests/fixtures/pyarrow_defaults.parquet`` reads equal to the values its
seed regenerates.
"""

import itertools
import os
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.dataframe import parquet, snappy
from sparkdl_tpu_torch.dataframe import thrift_compact as tc
from sparkdl_tpu_torch.worker import _read_owned_partitions

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
ITEM = "ROADMAP Queue A item 11"
ROWS = 41


def _norm(values):
    """A column as plain Python values (tensor rows as nested lists)."""
    out = []
    for v in values:
        out.append(v.tolist() if isinstance(v, np.ndarray) else v)
    return out


def _columns(seed=0, n=ROWS):
    rng = np.random.default_rng(seed)

    def img(i):
        if i % 7 == 3:
            return None
        return {"origin": f"f{i}", "height": 2, "width": 3, "nChannels": 3, "mode": 16,
                "data": rng.integers(0, 256, 18, dtype=np.uint8).tobytes()}

    return {
        "i": [None if i % 5 == 0 else int(i * 7 - 50) for i in range(n)],
        "f": [None if i % 4 == 1 else float(rng.normal()) for i in range(n)],
        "s": [None if i % 6 == 2 else "w" * (i % 5) for i in range(n)],
        "b": [None if i % 8 == 0 else bytes([i, i]) for i in range(n)],
        "flag": [None if i % 9 == 0 else i % 2 == 0 for i in range(n)],
        "image": [img(i) for i in range(n)],
        "l": [None if i % 10 == 0 else [float(j) if j != 1 else None for j in range(i % 4)]
              for i in range(n)],
    }


def _pyarrow_table(seed=0):
    cols = _columns(seed)
    t = pa.table(cols)
    t = t.append_column("i32", pa.array([None if i % 3 == 0 else i for i in range(ROWS)], pa.int32()))
    t = t.append_column("u8", pa.array([i % 256 for i in range(ROWS)], pa.uint8()))
    block = np.random.default_rng(seed + 1).normal(size=(ROWS, 2, 3)).astype(np.float32)
    return t.append_column("t", pa.FixedShapeTensorArray.from_numpy_ndarray(block)), block


def _same_frames(ours, ref):
    assert ours.columns == ref.columns
    assert ours.partitionRowCounts() == ref.partitionRowCounts()
    a, b = ours.collectColumns(), ref.collectColumns()
    for c in ref.columns:
        assert _norm(a[c]) == _norm(b[c]), c


@pytest.mark.parametrize(
    "compression, dictionary, version, group",
    list(itertools.product(["snappy", "gzip", "none"], [True, False], ["1.0", "2.0"], [5, 16]))
    + [("snappy", True, "1.0", 1000)],
)
def test_pyarrow_files_read_like_jax(compression, dictionary, version, group, tmp_path):
    table, block = _pyarrow_table()
    path = str(tmp_path / "x.parquet")
    pq.write_table(table, path, compression=compression, use_dictionary=dictionary,
                   data_page_version=version, row_group_size=group)
    ours = DataFrame.readParquet(path, numPartitions=3)
    _same_frames(ours, JaxDataFrame.readParquet(path, numPartitions=3))
    # a tensor column is one contiguous block per partition, float32
    first = ours._source[0]["t"]
    assert isinstance(first, np.ndarray) and first.dtype == np.float32
    np.testing.assert_array_equal(np.concatenate([p["t"] for p in ours._source]), block)


def test_jax_writeparquet_files_read_like_jax(tmp_path):
    rng = np.random.default_rng(4)
    cols = _columns(4)
    cols["features"] = list(rng.normal(size=(ROWS, 5)).astype(np.float32))
    cols["tokens"] = [rng.integers(0, 9, size=(3,)).astype(np.int64) for _ in range(ROWS)]
    path = str(tmp_path / "jax.parquet")
    JaxDataFrame.fromColumns(cols, numPartitions=4).writeParquet(path)
    for k in (1, 4, 7):
        _same_frames(DataFrame.readParquet(path, k), JaxDataFrame.readParquet(path, k))
        _same_frames(DataFrame.scanParquet(path, k), JaxDataFrame.scanParquet(path, k))


@pytest.mark.parametrize("compression", ["snappy", "none"])
def test_port_files_read_in_jax_and_pyarrow_equal_to_the_source(compression, tmp_path):
    rng = np.random.default_rng(5)
    cols = _columns(5)
    cols["features"] = list(rng.normal(size=(ROWS, 4)).astype(np.float32))
    path = str(tmp_path / "port.parquet")
    DataFrame.fromColumns(cols, numPartitions=3).writeParquet(path, compression=compression)
    meta = pq.ParquetFile(path).metadata
    assert meta.num_row_groups == 3 and meta.num_rows == ROWS
    table = pq.read_table(path)
    assert isinstance(table.schema.field("features").type, pa.FixedShapeTensorType)
    ref = JaxDataFrame.readParquet(path, 2).collectColumns()
    for c, want in cols.items():
        assert _norm(ref[c]) == _norm(want), c
        assert _norm(table.column(c).to_pylist()) == _norm(want) or c == "features"
    np.testing.assert_array_equal(table.column("features").combine_chunks().to_numpy_ndarray(),
                                  np.stack(cols["features"]))
    # and the port reads its own file back
    _same_frames(DataFrame.readParquet(path, 2), JaxDataFrame.readParquet(path, 2))


def test_an_empty_frame_writes_a_valid_file(tmp_path):
    path = str(tmp_path / "empty.parquet")
    DataFrame([], ["a", "b"]).writeParquet(path)
    assert pq.read_table(path).num_rows == 0
    assert DataFrame.readParquet(path).count() == 0


def test_diverging_partitions_refuse_to_write(tmp_path):
    df = DataFrame([{"x": [1, 2]}, {"x": ["a", "b"]}], ["x"])
    with pytest.raises(ValueError, match="partition schema diverged"):
        df.writeParquet(str(tmp_path / "bad.parquet"))
    # a null-typed chunk takes the first partition's type
    DataFrame([{"x": [1, 2]}, {"x": [None, None]}], ["x"]).writeParquet(str(tmp_path / "ok.parquet"))
    assert pq.read_table(str(tmp_path / "ok.parquet")).column("x").to_pylist() == [1, 2, None, None]


def test_owned_span_reads_decode_only_their_row_groups(tmp_path):
    path = str(tmp_path / "rg.parquet")
    pq.write_table(pa.table({"v": list(range(40))}), path, row_group_size=5)  # 8 groups
    got = dict(_read_owned_partitions(path, num_partitions=8, owned=[1, 4]))
    assert sorted(got) == [1, 4]
    assert got[1].collectColumns()["v"] == list(range(5, 10))
    assert got[4].collectColumns()["v"] == list(range(20, 25))
    reads = []
    dict(_read_owned_partitions(path, num_partitions=8, owned=[2], on_group=reads.append))
    assert reads == [2]
    # spans that straddle groups read exactly the groups they meet
    reads = []
    spans = dict(_read_owned_partitions(path, num_partitions=3, owned=[1], on_group=reads.append))
    assert reads == [2, 3, 4, 5] and spans[1].collectColumns()["v"] == list(range(14, 27))
    pf = parquet.ParquetFile(path)
    reads = []
    assert pf.read_rows(12, 16, on_group=reads.append)["v"] == [12, 13, 14, 15]
    assert reads == [2, 3]


def test_scan_parquet_is_lazy(tmp_path):
    path = str(tmp_path / "scan.parquet")
    pq.write_table(pa.table({"v": list(range(30)), "w": [str(i) for i in range(30)]}), path,
                   row_group_size=4)
    df = DataFrame.scanParquet(path, numPartitions=4)
    assert df.partitionRowCounts() == [8, 8, 7, 7]
    assert all(not p._data for p in df._source)  # only the footer was read
    assert df.select("w").collectColumns()["w"] == [str(i) for i in range(30)]
    assert list(df.iterPartitions())[1]["v"] == list(range(8, 16))


def _refused(path):
    with pytest.raises(NotImplementedError, match=ITEM):
        DataFrame.readParquet(path).collect()


@pytest.mark.parametrize("codec", ["lz4", "brotli"])
def test_other_codecs_are_refused(codec, tmp_path):
    path = str(tmp_path / f"{codec}.parquet")
    pq.write_table(pa.table({"v": [1, 2, 3]}), path, compression=codec)
    _refused(path)


@pytest.mark.parametrize("use_dictionary", [True, False])
def test_zstd_pages_read_equal_to_pyarrow(use_dictionary, tmp_path):
    """ZSTD pages (pyarrow's level, several row groups, with and without
    dictionary pages) read through the port's zstd decoder, equal to
    ``pq.read_table``; writing ZSTD stays refused."""
    rng = np.random.default_rng(11)
    n = 3000
    table = pa.table({
        "v": pa.array(rng.integers(0, 50, n), pa.int64()),
        "x": pa.array(rng.normal(size=n).astype(np.float32)),
        "s": pa.array([f"row-{i % 37}" for i in range(n)]),
        "n": pa.array([None if i % 5 == 0 else float(i) for i in range(n)], pa.float64()),
    })
    path = str(tmp_path / "zstd.parquet")
    pq.write_table(table, path, compression="zstd", row_group_size=700, use_dictionary=use_dictionary)
    meta = pq.ParquetFile(path).metadata
    assert meta.num_row_groups == 5
    assert {meta.row_group(0).column(i).compression for i in range(4)} == {"ZSTD"}
    got = DataFrame.readParquet(path, 3).collectColumns()
    want = pq.read_table(path).to_pydict()
    assert set(got) == set(want)
    for c in want:
        assert _norm(got[c]) == _norm(want[c]), c
    with pytest.raises(NotImplementedError, match=ITEM):
        snappy.compress(snappy.ZSTD, b"abc")


@pytest.mark.parametrize("encoding", ["DELTA_BINARY_PACKED", "BYTE_STREAM_SPLIT"])
def test_other_encodings_are_refused(encoding, tmp_path):
    path = str(tmp_path / "enc.parquet")
    pq.write_table(pa.table({"v": pa.array([1, 2, 3], pa.int32())}), path, use_dictionary=False,
                   column_encoding={"v": encoding})
    _refused(path)


def test_int96_temporal_and_deep_nesting_are_refused(tmp_path):
    ts = pa.array([0, 1], pa.timestamp("ns"))
    for name, table, kw in [
        ("int96", pa.table({"t": ts}), {"use_deprecated_int96_timestamps": True}),
        ("temporal", pa.table({"t": ts}), {}),
        ("nested_list", pa.table({"x": [[[1], [2]], [[3]]]}), {}),
        ("struct_in_struct", pa.table({"x": [{"a": {"b": 1}}]}), {}),
        ("map", pa.table({"x": pa.array([[("k", 1)]], pa.map_(pa.string(), pa.int64()))}), {}),
    ]:
        path = str(tmp_path / f"{name}.parquet")
        pq.write_table(table, path, **kw)
        _refused(path)
    with pytest.raises(NotImplementedError, match=ITEM):
        DataFrame.fromColumns({"x": [[[1.0]], [[2.0]]]}).writeParquet(str(tmp_path / "w.parquet"))
    with pytest.raises(NotImplementedError, match=ITEM):
        DataFrame.fromColumns({"x": [1]}).writeParquet(str(tmp_path / "z.parquet"), compression="zstd")


def test_the_committed_pyarrow_fixture_reads_exactly():
    sys.path.insert(0, FIXTURES)
    try:
        from make_parquet_fixture import PATH, ROW_GROUP, ROWS as FROWS, fixture_columns
    finally:
        sys.path.pop(0)
    pf = parquet.ParquetFile(PATH)
    assert len(pf.row_groups) >= 2 and pf.num_rows == FROWS
    assert max(pf.row_group_rows()) == ROW_GROUP
    got, want = pf.read(), fixture_columns()
    for c, values in want.items():
        if c == "t":
            np.testing.assert_array_equal(got[c], values)
        else:
            assert got[c] == values, c
    # every column kind holds a null, and the file has dictionary pages
    assert all(None in v for c, v in want.items() if c != "t")
    meta = pq.ParquetFile(PATH).metadata
    assert meta.row_group(0).column(0).has_dictionary_page
    assert meta.row_group(0).column(0).compression == "SNAPPY"
    _same_frames(DataFrame.readParquet(PATH, 3), JaxDataFrame.readParquet(PATH, 3))


@pytest.mark.parametrize("size", [0, 1, 4, 100, 70000, 200000])
def test_snappy_round_trips_against_pyarrow(size):
    rng = np.random.default_rng(size)
    for data in (rng.integers(0, 256, size, dtype=np.uint8).tobytes(),
                 np.repeat(rng.integers(0, 3, size // 3 + 1, dtype=np.uint8), 3)[:size].tobytes()):
        ref = pa.compress(data, codec="snappy", asbytes=True) if size else b"\x00"
        assert snappy.snappy_decompress(ref) == data
        ours = snappy.snappy_compress(data)
        assert snappy.snappy_decompress(ours) == data
        if size:
            assert pa.decompress(ours, decompressed_size=size, codec="snappy", asbytes=True) == data


def test_thrift_compact_round_trip():
    fields = [
        (1, tc.I32, -7), (2, tc.LIST, (tc.STRUCT, [[(1, tc.BINARY, "a")], [(4, tc.I64, 2 ** 40)]])),
        (3, tc.BOOL, True), (4, tc.BOOL, False), (20, tc.DOUBLE, 1.5),
        (21, tc.LIST, (tc.I32, list(range(20)))), (22, tc.STRUCT, []), (23, tc.BYTE, -3),
    ]
    decoded, end = tc.read_struct(tc.write_struct(fields))
    assert decoded == {1: -7, 2: [{1: b"a"}, {4: 2 ** 40}], 3: True, 4: False, 20: 1.5,
                       21: list(range(20)), 22: {}, 23: -3}
    with pytest.raises(tc.ThriftError):
        tc.read_struct(tc.write_struct(fields)[:-3])


def test_hybrid_levels_round_trip():
    rng = np.random.default_rng(0)
    for width in (1, 2, 3, 7):
        levels = rng.integers(0, 1 << width, 1000)
        enc = parquet.encode_rle(levels, width)
        np.testing.assert_array_equal(parquet.decode_hybrid(enc, 0, len(enc), width, 1000), levels)
