"""The port's own HDF5 reader (``sparkdl_tpu_torch/graph/hdf5.py``, numpy
only) against h5py, which writes every file here.

- A file of h5py's default layout with what the reader covers: nested
  groups, a group of 700 members (its B-tree splits into many symbol
  nodes under an inner node), contiguous and compact datasets, a dataset
  never written, every datatype in scope (integers of 1 to 8 bytes signed
  and not, floats of 2, 4 and 8 bytes, both byte orders, fixed- and
  variable-length strings, opaque bfloat16), scalar and simple
  attributes, empty ones, a 100 kB variable-length string, a user block.
  Every group's member list, every attribute and every dataset must read
  as h5py reads it: the same types, dtypes, shapes and bytes.
- Files that keras writes (``.keras``'s weight store, a legacy ``.h5``
  model, ``.weights.h5``, a legacy weight file) and the committed
  fixtures read the same way.
- Outside the scope, the read raises NotImplementedError naming the
  feature and the ROADMAP item: chunked, compressed, superblock 3.
- The committed fixtures (``tests/fixtures/make_keras_cnn_fixtures.py``)
  build, through the port, a model whose output is the stored Keras
  output (relative 1e-5) in each of their three layouts.
"""

import io
import os
import sys
import zipfile

import h5py
import keras
import numpy as np
import pytest
import torch

from sparkdl_tpu_torch.graph import hdf5
from sparkdl_tpu_torch.graph.ingest import ModelIngest
from sparkdl_tpu_torch.graph.keras_file import read_keras_file, read_keras_weights
from sparkdl_tpu_torch.graph.keras_graph import KerasModelSpec, walk_layers

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
REL = 1e-5


def _same_value(a, b, where):
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype == object:
            assert a.tolist() == b.tolist(), where
        else:
            assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, np.generic):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), where
    else:
        assert a == b, where


def _same_tree(ours, ref, where="/"):
    """Every member, attribute and dataset of ``ref`` (h5py) as ``ours``
    (the port) reads it."""
    assert sorted(ours.attrs) == sorted(ref.attrs), where
    for key in ref.attrs:
        _same_value(ours.attrs[key], ref.attrs[key], f"{where}@{key}")
    if isinstance(ref, h5py.Dataset):
        assert isinstance(ours, hdf5.Dataset), where
        assert ours.shape == ref.shape and ours.dtype == ref.dtype, where
        _same_value(ours[()], ref[()], where)
        return
    assert isinstance(ours, hdf5.Group), where
    assert list(ours) == list(ref) and len(ours) == len(ref), where
    for key in ref:
        _same_tree(ours[key], ref[key], f"{where}{key}/")


def _write_scope(path, userblock=0):
    rng = np.random.default_rng(0)
    with h5py.File(path, "w", userblock_size=userblock) as f:
        f.attrs["text"] = "a variable-length string"
        f.attrs["big_text"] = "x" * 100_000
        f.attrs["fixed"] = np.bytes_(b"fixed")
        f.attrs["int"] = np.int64(-7)
        f.attrs["float"] = 1.5
        f.attrs["be"] = np.arange(5, dtype=">i2")
        f.attrs["names"] = [b"ab", b"cde"]
        f.attrs["vnames"] = ["x", "yy", "zzz"]
        f.attrs["empty"] = np.array([])
        f.attrs["matrix"] = rng.standard_normal((2, 3)).astype(np.float32)
        many = f.create_group("many")
        for i in range(700):
            many.create_group(f"g{i:04d}")
        many["g0005"].attrs["deep"] = 5
        dtypes = ["i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "<f2", "<f4", "<f8", ">f4", ">f8", ">i4", ">u8"]
        data = f.create_group("data")
        for dt in dtypes:
            data[dt.replace("<", "le_").replace(">", "be_")] = (rng.standard_normal((3, 4)) * 100).astype(dt)
        data["scalar"] = 3.25
        data["fixed_strings"] = np.array([b"a", b"bcd", b""], dtype="S3")
        data.create_dataset("vlen_strings", data=["one", "two two", ""], dtype=h5py.string_dtype())
        data.create_dataset("unwritten", shape=(3, 2), dtype="f4")
        data.create_dataset("compact", data=np.arange(6, dtype=np.int32))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple((2, 3))
        h5py.h5d.create(data.id, b"compact_layout", h5py.h5t.NATIVE_FLOAT, space, dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, np.arange(6, dtype=np.float32).reshape(2, 3))
        data["bfloat16"] = np.arange(4, dtype=np.uint16).view(h5py.opaque_dtype(np.dtype("V2")))
        data["empty"] = np.zeros((0, 3), np.float32)
        data["scalar"].attrs["unit"] = "m"


@pytest.mark.parametrize("userblock", [0, 512], ids=["plain", "user-block"])
def test_reads_what_h5py_writes(tmp_path, userblock):
    path = str(tmp_path / "scope.h5")
    _write_scope(path, userblock)
    with h5py.File(path, "r") as ref, hdf5.File(path) as ours:
        _same_tree(ours, ref)
        assert "data/compact_layout" in ours and "data/nothing" not in ours
        assert ours.get("nothing") is None
    with open(path, "rb") as f:  # from bytes and from a file object too
        blob = f.read()
    with h5py.File(path, "r") as ref:
        _same_tree(hdf5.File(blob), ref)
        _same_tree(hdf5.File(io.BytesIO(blob)), ref)


def test_large_group_has_an_inner_btree_node(tmp_path):
    """700 members need more symbol nodes than one leaf B-tree node
    holds, so the group's B-tree root is an inner node."""
    path = str(tmp_path / "scope.h5")
    _write_scope(path)
    with hdf5.File(path) as f:
        group = f["many"]
        (pos, _), = group._h.find(0x11)
        root = f._r.at(f._r.addr(pos))
        assert f._r.buf[root + 5] >= 1  # the node level
        assert group.keys() == [f"g{i:04d}" for i in range(700)]


@pytest.mark.parametrize("case", ["chunked", "gzip", "latest"])
def test_outside_the_scope_raises(tmp_path, case):
    path = str(tmp_path / f"{case}.h5")
    with h5py.File(path, "w", libver="latest" if case == "latest" else "earliest") as f:
        if case == "chunked":
            f.create_dataset("d", data=np.zeros((4, 4)), chunks=(2, 2))
        elif case == "gzip":
            f.create_dataset("d", data=np.zeros(10), compression="gzip")
        else:
            f["d"] = np.zeros(3)
    match = {"chunked": "chunked datasets", "gzip": "filtered datasets", "latest": "superblock version 3"}[case]
    with pytest.raises(NotImplementedError, match=match) as err:
        with hdf5.File(path) as f:
            f["d"][()]
    assert "ROADMAP Queue A item 9" in str(err.value)


def _small_model():
    L = keras.layers
    return keras.Sequential([L.Input((8, 8, 3)), L.Conv2D(4, 3, name="c1"), L.BatchNormalization(),
                             L.GlobalAveragePooling2D(), L.Dense(3, activation="softmax")], name="small")


def test_keras_written_files_read_as_h5py_reads_them(tmp_path):
    from keras.src.legacy.saving import legacy_h5_format

    model = _small_model()
    paths = {ext: str(tmp_path / f"m.{ext}") for ext in ("keras", "h5", "weights.h5")}
    for path in paths.values():
        (model.save_weights if path.endswith(".weights.h5") else model.save)(path)
    legacy = str(tmp_path / "legacy_weights.h5")
    with h5py.File(legacy, "w") as f:
        legacy_h5_format.save_weights_to_hdf5_group(f, model)
    with zipfile.ZipFile(paths["keras"]) as z:
        store = z.read("model.weights.h5")
    with h5py.File(io.BytesIO(store), "r") as ref:
        _same_tree(hdf5.File(store), ref)
    for path in (paths["h5"], paths["weights.h5"], legacy):
        with h5py.File(path, "r") as ref, hdf5.File(path) as ours:
            _same_tree(ours, ref)


@pytest.mark.parametrize("name", ["keras_cnn.keras", "keras_cnn.h5", "keras_cnn.weights.h5"])
def test_fixtures_read_as_h5py_reads_them(name):
    path = os.path.join(FIXTURES, name)
    if name.endswith(".keras"):
        with zipfile.ZipFile(path) as z:
            path = io.BytesIO(z.read("model.weights.h5"))
    with h5py.File(path, "r") as ref:
        if isinstance(path, io.BytesIO):
            path.seek(0)
        _same_tree(hdf5.File(path), ref)


def fixture_specs():
    """The committed fixture model in its three layouts, read by the port:
    (layout, KerasModelSpec), and the stored input and Keras output."""
    archive = read_keras_file(os.path.join(FIXTURES, "keras_cnn.keras"))
    legacy = read_keras_file(os.path.join(FIXTURES, "keras_cnn.h5"))
    config = archive.get_config()
    layers = [(layer["class_name"], path) for path, _, layer, _ in walk_layers(config)]
    weights = read_keras_weights(os.path.join(FIXTURES, "keras_cnn.weights.h5"), layers)
    io_ = np.load(os.path.join(FIXTURES, "keras_cnn_io.npz"))
    return [("keras", archive), ("h5", legacy), ("weights.h5", KerasModelSpec(config, weights))], io_["x"], io_["y"]


def test_fixtures_build_the_stored_model(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)  # the port never needs it
    specs, x, y = fixture_specs()
    for layout, spec in specs:
        mf = ModelIngest.from_keras(spec, device="cpu")
        out = mf(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        assert out.shape == y.shape == (4, 5), layout
        assert float(np.abs(out - y).max() / np.abs(y).max()) <= REL, layout
