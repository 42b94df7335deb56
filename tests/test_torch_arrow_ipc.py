"""The port's Arrow IPC files (``sparkdl_tpu_torch/dataframe/arrow_ipc.py``)
against ``pyarrow.ipc`` and the JAX package's readers, on the CPU.

Round trips go both ways: what the port writes, ``pyarrow`` and the JAX
package's ``DataFrame.fromArrowFiles`` read equal to the source, with a
tensor column's FixedShapeTensor metadata intact; what ``pyarrow``
writes (one batch or several), the port reads equal to ``to_pylist``,
a tensor column as one block. A torn or garbage file is judged invalid
by the resume check. ``pyarrow`` appears only on the reference side.
"""

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc
import pytest

from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu_torch.dataframe import DataFrame, arrow_ipc


def _source(seed=0, n=9):
    rng = np.random.default_rng(seed)
    return {
        "i": [None if k % 4 == 1 else int(k) - 3 for k in range(n)],
        "f": [None if k % 3 == 2 else float(rng.normal()) for k in range(n)],
        "s": [None if k == 4 else "é" * k for k in range(n)],
        "b": [None if k == 0 else bytes(range(k)) for k in range(n)],
        "flag": [None if k == 5 else bool(k % 2) for k in range(n)],
        "image": [None if k == 2 else {"origin": f"o{k}", "height": k, "width": 1, "nChannels": 3,
                                        "mode": 16, "data": bytes([k] * 3)} for k in range(n)],
        "l": [None if k == 1 else [float(j) for j in range(k % 3)] for k in range(n)],
        "t": rng.normal(size=(n, 2, 2)).astype(np.float32),
        "u8": np.arange(n, dtype=np.uint8),
        "nothing": [None] * n,
    }


def _norm(v):
    return v.tolist() if isinstance(v, np.ndarray) else v


def test_port_files_read_in_pyarrow_and_jax(tmp_path):
    src = _source()
    path = str(tmp_path / "part-00000.arrow")
    arrow_ipc.write_partition(src, path)
    table = ipc.open_file(pa.OSFile(path, "rb")).read_all()
    ttype = table.schema.field("t").type
    assert isinstance(ttype, pa.FixedShapeTensorType) and list(ttype.shape) == [2, 2]
    assert ttype.value_type == pa.float32()
    assert table.schema.field("u8").type == pa.uint8()
    assert table.schema.field("i").type == pa.int64() and table.schema.field("f").type == pa.float64()
    for c, want in src.items():
        if c == "t":
            np.testing.assert_array_equal(table.column(c).combine_chunks().to_numpy_ndarray(), want)
        else:
            assert table.column(c).to_pylist() == _norm(want), c
    got = JaxDataFrame.fromArrowFiles([path]).collectColumns()
    for c, want in src.items():
        assert [_norm(v) for v in got[c]] == [_norm(v) for v in want], c


def test_pyarrow_files_read_in_the_port(tmp_path):
    src = _source(1)
    arrays = {c: pa.array(_norm(v) if c != "nothing" else v) for c, v in src.items() if c != "t"}
    arrays["u8"] = pa.array(src["u8"])
    arrays["t"] = pa.FixedShapeTensorArray.from_numpy_ndarray(src["t"])
    table = pa.table(arrays)
    path = str(tmp_path / "py.arrow")
    with ipc.new_file(pa.OSFile(path, "wb"), table.schema) as w:
        w.write_table(table.slice(0, 4))
        w.write_table(table.slice(4))
    fields, cols = arrow_ipc.read_file(path)
    assert [f.name for f in fields] == table.column_names
    assert fields[[f.name for f in fields].index("t")].tensor_shape() == (2, 2)
    for c in table.column_names:
        if c == "t":
            assert isinstance(cols[c], np.ndarray) and cols[c].dtype == np.float32
            np.testing.assert_array_equal(cols[c], src["t"])
        else:
            assert cols[c] == table.column(c).to_pylist(), c
    frame = DataFrame.fromArrowFiles([path, path])
    assert frame.partitionRowCounts() == [9, 9]
    assert frame.select("s").collectColumns()["s"] == table.column("s").to_pylist() * 2


def test_round_trip_keeps_an_empty_partition(tmp_path):
    path = str(tmp_path / "empty.arrow")
    arrow_ipc.write_partition({"a": [], "t": np.zeros((0, 3), np.float32)}, path)
    table = ipc.open_file(pa.OSFile(path, "rb")).read_all()
    assert table.num_rows == 0 and isinstance(table.schema.field("t").type, pa.FixedShapeTensorType)
    _, cols = arrow_ipc.read_file(path)
    assert cols["a"] == [] and cols["t"].shape == (0, 3)


def test_torn_and_garbage_files_are_invalid(tmp_path):
    path = str(tmp_path / "ok.arrow")
    arrow_ipc.write_partition(_source(2), path)
    assert arrow_ipc.valid_output(path)
    data = open(path, "rb").read()
    for name, blob in [("torn", data[: len(data) // 2]), ("tail", data[:-7]),
                       ("garbage", b"garbage"), ("empty", b""),
                       ("bad_footer", data[:-10] + b"\x7f\x7f\x7f\x7f" + data[-6:])]:
        bad = tmp_path / f"{name}.arrow"
        bad.write_bytes(blob)
        assert not arrow_ipc.valid_output(str(bad)), name
    assert not arrow_ipc.valid_output(str(tmp_path / "missing.arrow"))
    # the write is atomic: no .tmp is left behind
    assert not (tmp_path / "ok.arrow.tmp").exists()


def test_inferred_types_match_the_jax_package(tmp_path):
    """The same cells through the JAX package's writer and the port's give
    the same Arrow schema."""
    import pyarrow.parquet as pq

    rng = np.random.default_rng(3)
    cols = {"x": list(rng.normal(size=(5, 3)).astype(np.float32)), "n": [1, 2, 3, 4, 5],
            "v": [1.0, 2, None, 4, 5], "s": ["a", "b", None, "d", "e"],
            "img": [{"h": 1, "d": b"x"}] * 5, "ragged": [np.zeros(k) for k in range(5)]}
    JaxDataFrame.fromColumns(cols).writeParquet(str(tmp_path / "jax.parquet"))
    DataFrame.fromColumns(cols).writeParquet(str(tmp_path / "port.parquet"))
    assert pq.read_schema(str(tmp_path / "port.parquet")).remove_metadata() == \
        pq.read_schema(str(tmp_path / "jax.parquet")).remove_metadata()


def test_refusals_name_the_roadmap_item(tmp_path):
    table = pa.table({"d": pa.array(["a", "b"]).dictionary_encode()})
    path = str(tmp_path / "dict.arrow")
    with ipc.new_file(pa.OSFile(path, "wb"), table.schema) as w:
        w.write_table(table)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 11"):
        arrow_ipc.read_file(path)
    table = pa.table({"x": [1, 2, 3]})
    path = str(tmp_path / "lz4.arrow")
    with ipc.new_file(pa.OSFile(path, "wb"), table.schema,
                      options=ipc.IpcWriteOptions(compression="lz4")) as w:
        w.write_table(table)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 11"):
        arrow_ipc.read_file(path)
