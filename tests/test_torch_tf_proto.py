"""The port's protobuf decoder and tensor-bundle reader against TF's own,
on the same bytes.

``graph/tf_proto.py`` against TF's generated classes (``graph_pb2``,
``meta_graph_pb2``, ``saved_model_pb2``, ``tensor_bundle_pb2``): every
field of the port's schema, on the committed fixtures (a frozen GraphDef,
a SavedModel, a TF1 MetaGraphDef, Keras's frozen CNN) and on hand-made
messages (splat and partial ``*_val`` lists, packed and unpacked repeated
fields, unknown fields). ``graph/tf_bundle.py`` against
``tf.train.load_checkpoint`` on the fixtures' checkpoints and on bundles
written here with many dtypes, a string tensor and a tensor large enough
for the lane-parallel CRC-32C; corrupt bytes and a Snappy-compressed
table.
"""

import os
import shutil
import struct

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from tensorflow.core.framework import graph_pb2, node_def_pb2, tensor_pb2  # noqa: E402
from tensorflow.core.protobuf import (  # noqa: E402
    meta_graph_pb2,
    saved_model_pb2,
    tensor_bundle_pb2,
    trackable_object_graph_pb2,
)
from tensorflow.python.framework import tensor_util  # noqa: E402

from sparkdl_tpu_torch.dataframe.snappy import snappy_compress  # noqa: E402
from sparkdl_tpu_torch.graph import tf_bundle, tf_proto  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TF_MODEL = os.path.join(FIXTURES, "tf_model")

FILES = {
    "frozen.pb": ("GraphDef", graph_pb2.GraphDef, os.path.join(TF_MODEL, "frozen.pb")),
    "keras_cnn_frozen.pb": ("GraphDef", graph_pb2.GraphDef, os.path.join(FIXTURES, "keras_cnn_frozen.pb")),
    "saved_model.pb": ("SavedModel", saved_model_pb2.SavedModel,
                       os.path.join(TF_MODEL, "saved_model", "saved_model.pb")),
    "model.meta": ("MetaGraphDef", meta_graph_pb2.MetaGraphDef, os.path.join(TF_MODEL, "ckpt", "model.meta")),
}


def _same(ours, ref, path="") -> int:
    """Every field of the port's schema equal to TF's; returns how many
    fields were held."""
    held = 0
    for name, (kind, label) in tf_proto._BY_NAME[ours.type_name].items():
        mine, theirs = getattr(ours, name), getattr(ref, name)
        where = f"{path}.{name}"
        message = kind not in tf_proto._SCALAR_KINDS
        if label == "map":
            assert set(mine) == set(theirs), where
            for key in theirs:
                held += _same(mine[key], theirs[key], f"{where}[{key}]") if message else 1
                if not message:
                    assert mine[key] == theirs[key], where
        elif label == "rep":
            assert len(mine) == len(theirs), where
            if message:
                held += sum(_same(a, b, f"{where}[{i}]") for i, (a, b) in enumerate(zip(mine, theirs)))
            else:
                assert list(mine) == list(theirs), where
                held += 1
        elif message:
            assert ours.HasField(name) == ref.HasField(name), where
            held += _same(mine, theirs, where)
        else:
            assert mine == theirs, (where, mine, theirs)
            held += 1
    return held


@pytest.mark.parametrize("name", sorted(FILES))
def test_decoder_equals_tf_on_the_fixtures(name):
    type_name, cls, path = FILES[name]
    with open(path, "rb") as f:
        data = f.read()
    ours, ref = tf_proto.parse(type_name, data), cls.FromString(data)
    assert _same(ours, ref) > 50


@pytest.mark.parametrize("name", ["frozen.pb", "keras_cnn_frozen.pb", "saved_model.pb"])
def test_every_constant_equals_make_ndarray(name):
    type_name, cls, path = FILES[name]
    with open(path, "rb") as f:
        data = f.read()
    ours, ref = tf_proto.parse(type_name, data), cls.FromString(data)
    if type_name == "SavedModel":
        ours, ref = ours.meta_graphs[0].graph_def, ref.meta_graphs[0].graph_def
    n = 0
    pairs = list(zip(ours.node, ref.node))
    for f_mine, f_theirs in zip(ours.library.function, ref.library.function):
        pairs += list(zip(f_mine.node_def, f_theirs.node_def))
    for mine, theirs in pairs:
        if theirs.op == "Const":
            a, b = tf_proto.make_ndarray(mine.attr["value"].tensor), tensor_util.MakeNdarray(theirs.attr["value"].tensor)
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), theirs.name
            n += 1
    assert n >= 2


def _protos():
    cases = {
        "float-content": tf.make_tensor_proto(np.arange(12, dtype=np.float32).reshape(3, 4)),
        "float-splat": tf.make_tensor_proto(2.5, shape=[3, 4]),
        "int32-partial": tf.make_tensor_proto([1, 2], dtype=tf.int32, shape=[5]),
        "int64-splat": tf.make_tensor_proto(-7, dtype=tf.int64, shape=[2, 2]),
        "bool": tf.make_tensor_proto(True, shape=[3]),
        "string": tf.make_tensor_proto([b"ab", b"", b"xyz"]),
        "string-splat": tf.make_tensor_proto(b"q", shape=[2]),
        "half": tf.make_tensor_proto(np.array([1.5, -2.0, 65504.0], np.float16)),
        "half-splat": tf.make_tensor_proto(np.float16(0.25), shape=[4]),
        "uint8": tf.make_tensor_proto(np.array([[0, 255], [7, 8]], np.uint8)),
        "int8": tf.make_tensor_proto(np.array([-128, 127], np.int8)),
        "double": tf.make_tensor_proto(np.array([1e300, -2.5])),
        "complex64": tf.make_tensor_proto(np.array([1 + 2j, -3j], np.complex64)),
        "scalar": tf.make_tensor_proto(np.float32(3.25)),
        "empty": tf.make_tensor_proto(np.zeros((0, 3), np.float32)),
    }
    # typed lists (not tensor_content), as TF writes small constants
    listed = tensor_pb2.TensorProto(dtype=1)
    listed.tensor_shape.dim.add(size=2)
    listed.tensor_shape.dim.add(size=3)
    listed.float_val.extend([1.0, -2.0, 3.5])
    cases["float-val-partial"] = listed
    ints = tensor_pb2.TensorProto(dtype=3)
    ints.tensor_shape.dim.add(size=4)
    ints.int_val.extend([-1, 2**31 - 1, -(2**31), 5])
    cases["int-val"] = ints
    return cases


PROTOS = _protos()


@pytest.mark.parametrize("name", sorted(PROTOS))
def test_make_ndarray_equals_tf(name):
    proto = PROTOS[name]
    ours = tf_proto.make_ndarray(tf_proto.parse("TensorProto", proto.SerializeToString()))
    ref = tensor_util.MakeNdarray(proto)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    assert np.array_equal(ours, ref)


def test_bfloat16_widens_to_float32_exactly():
    values = np.array([1.0, -2.5, 3.140625, 0.0], np.float32)
    proto = tf.make_tensor_proto(tf.constant(values, tf.bfloat16))
    ours = tf_proto.make_ndarray(tf_proto.parse("TensorProto", proto.SerializeToString()))
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, tensor_util.MakeNdarray(proto).astype(np.float32))
    splat = tf.make_tensor_proto(tf.constant([1.5], tf.bfloat16).numpy().repeat(1), shape=[3])
    assert np.array_equal(tf_proto.make_ndarray(tf_proto.parse("TensorProto", splat.SerializeToString())),
                          np.full(3, 1.5, np.float32))


def _varint(v):
    v &= (1 << 64) - 1
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def test_unpacked_repeated_fields_read_as_packed_ones():
    """A reader must take a repeated scalar field packed or unpacked: the
    same values written both ways (and mixed) give the same message, as
    TF's parser does."""
    shape = b"\x12\x04\x12\x02\x08\x04"  # tensor_shape { dim { size: 4 } }
    unpacked_f = b"".join(b"\x2d" + struct.pack("<f", v) for v in (1.0, -2.0, 0.5, 8.0))
    unpacked_i = b"".join(b"\x38" + _varint(v) for v in (1, -5, 300, -(2**31)))
    for dtype, body in ((1, unpacked_f), (3, unpacked_i)):
        data = b"\x08" + bytes([dtype]) + shape + body
        ref = tensor_pb2.TensorProto.FromString(data)
        ours = tf_proto.make_ndarray(tf_proto.parse("TensorProto", data))
        assert np.array_equal(ours, tensor_util.MakeNdarray(ref))
        # packed, as TF writes it, gives the same values
        packed = ref.SerializeToString()
        assert packed != data
        assert np.array_equal(tf_proto.make_ndarray(tf_proto.parse("TensorProto", packed)), ours)
    # list(i) in an attr: half packed, half not
    def ld(field, payload):
        return _varint(field << 3 | 2) + _varint(len(payload)) + payload

    list_value = ld(3, b"\x01\x02") + b"\x18\x03" + b"\x18\x04"
    data = ld(5, ld(1, b"a") + ld(2, ld(1, list_value)))  # NodeDef.attr {key: "a", value {list {i}}}
    ref = node_def_pb2.NodeDef.FromString(data)
    ours = tf_proto.parse("NodeDef", data)
    assert list(ours.attr["a"].list.i) == list(ref.attr["a"].list.i) == [1, 2, 3, 4]


def test_unknown_fields_are_skipped_and_defaults_read_as_tf_does():
    node = node_def_pb2.NodeDef(name="n", op="Conv2D", input=["x", "^dep"])
    node.attr["padding"].s = b"SAME"
    node.attr["strides"].list.i.extend([1, 2, 2, 1])
    extra = b"\xf8\x06\x07" + b"\x82\x07\x03abc" + b"\x8d\x07\x00\x00\x00\x00"  # fields 111, 112, 113
    ours = tf_proto.parse("NodeDef", node.SerializeToString() + extra)
    assert ours.name == "n" and list(ours.input) == ["x", "^dep"]
    assert ours.attr["padding"].s == b"SAME" and list(ours.attr["strides"].list.i) == [1, 2, 2, 1]
    # absent attrs read as TF's defaults, without being inserted
    assert ours.attr["transpose_a"].b is False and ours.attr["epsilon"].f == 0.0
    assert ours.attr["f"].func.name == "" and "epsilon" not in ours.attr
    with pytest.raises(AttributeError):
        ours.no_such_field


@pytest.mark.parametrize("data", [b"\x0a\x05ab", b"\x08\xff", b"\x0b\x00", b"\x12\x0a\x02\x08"])
def test_malformed_bytes_raise(data):
    with pytest.raises(tf_proto.ProtoError):
        tf_proto.parse("NodeDef", data)


# -- CRC-32C and the bundle -----------------------------------------------------


def test_crc32c_known_answers_and_the_lane_path():
    assert tf_bundle.crc32c(b"") == 0
    assert tf_bundle.crc32c(b"123456789") == 0xE3069283
    assert tf_bundle.crc32c(b"\x00" * 32) == 0x8A9136AA
    rng = np.random.default_rng(0)
    for n in (64 * 4096 - 1, 64 * 4096, 64 * 4096 + 4099, 1_000_003):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        bytewise = tf_bundle._crc_bytes(0xFFFFFFFF, data) ^ 0xFFFFFFFF
        assert tf_bundle.crc32c(data) == bytewise
        assert tf_bundle.crc32c(data[n // 3:], tf_bundle.crc32c(data[:n // 3])) == bytewise
    for v in (0, 1, 0xE3069283, 0xFFFFFFFF):
        assert tf_bundle.unmask(tf_bundle.mask(v)) == v


def _assert_reads_as_tf(prefix):
    ref = tf.train.load_checkpoint(prefix)
    ours = tf_bundle.BundleReader(prefix)
    shapes = ref.get_variable_to_shape_map()
    assert ours.get_variable_to_shape_map() == shapes
    for key in shapes:
        want, got = ref.get_tensor(key), ours.get_tensor(key)
        if isinstance(want, bytes):  # a scalar string
            assert got.shape == () and got.item() == want
        else:
            assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want), key
    return ours


@pytest.mark.parametrize("prefix", ["saved_model/variables/variables", "ckpt/model"])
def test_bundle_reader_equals_load_checkpoint_on_the_fixtures(prefix):
    ours = _assert_reads_as_tf(os.path.join(TF_MODEL, prefix))
    for key, entry in ours.entries.items():
        ref = tensor_bundle_pb2.BundleEntryProto()
        ref.ParseFromString(tf_bundle.read_table(ours.prefix + ".index")[key.encode()])
        assert _same(entry, ref) >= 5


@pytest.fixture(scope="module")
def written_bundle(tmp_path_factory):
    rng = np.random.default_rng(5)
    tensors = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "big": rng.normal(size=(300, 300)).astype(np.float32),  # past the lane-parallel CRC's threshold
        "f64": rng.normal(size=(5,)),
        "f16": rng.normal(size=(2, 3)).astype(np.float16),
        "i8": rng.integers(-128, 128, (7,)).astype(np.int8),
        "u8": rng.integers(0, 256, (2, 2)).astype(np.uint8),
        "i32": rng.integers(-1000, 1000, (4,)).astype(np.int32),
        "i64": rng.integers(-(2**40), 2**40, (3,)),
        "b": rng.integers(0, 2, (5,)).astype(bool),
        "scalar": np.float32(2.5),
        "strings": np.array([b"alpha", b"", b"\x00\xff" * 40], dtype=object),
        "a/nested/name": np.arange(6, dtype=np.int32).reshape(2, 3),
    }
    prefix = str(tmp_path_factory.mktemp("bundle") / "ckpt")
    names = sorted(tensors)
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names, shape_and_slices=[""] * len(names),
                      tensors=[tf.constant(tensors[n]) for n in names])
    return prefix, tensors


def test_bundle_reader_equals_load_checkpoint_on_every_dtype(written_bundle):
    prefix, tensors = written_bundle
    ours = _assert_reads_as_tf(prefix)
    assert set(ours.keys()) == set(tensors)
    assert list(ours.get_tensor("strings")) == list(tensors["strings"])
    with pytest.raises(KeyError):
        ours.get_tensor("missing")


def test_corrupt_bytes_fail_their_checksums(written_bundle, tmp_path):
    prefix, _ = written_bundle
    for suffix, what in ((".data-00000-of-00001", "data"), (".index", "block")):
        copy = str(tmp_path / f"copy{suffix.replace('.', '_')}")
        for ext in (".index", ".data-00000-of-00001"):
            shutil.copy(prefix + ext, copy + ext)
        with open(copy + suffix, "r+b") as f:
            f.seek(20)
            byte = f.read(1)
            f.seek(20)
            f.write(bytes([byte[0] ^ 0x40]))
        with pytest.raises(tf_bundle.BundleError, match="CRC-32C"):
            reader = tf_bundle.BundleReader(copy)
            for key in reader.keys():
                reader.get_tensor(key)


def _block(entries, compress: bool) -> bytes:
    """An SSTable block (every entry a restart point) with its trailer."""
    body = b"".join(_varint(0) + _varint(len(k)) + _varint(len(v)) + k + v for k, v in entries)
    offsets, pos = [], 0
    for k, v in entries:
        offsets.append(pos)
        pos += len(_varint(0) + _varint(len(k)) + _varint(len(v))) + len(k) + len(v)
    body += b"".join(struct.pack("<I", o) for o in offsets) + struct.pack("<I", len(offsets))
    kind = 1 if compress else 0
    if compress:
        body = snappy_compress(body)
    return body + bytes([kind]) + struct.pack("<I", tf_bundle.mask(tf_bundle.crc32c(body + bytes([kind]))))


def test_a_snappy_compressed_table_reads_as_the_plain_one(written_bundle, tmp_path):
    prefix, _ = written_bundle
    entries = sorted(tf_bundle.read_table(prefix + ".index").items())
    data = _block(entries, compress=True)
    handle = _varint(0) + _varint(len(data) - 5)
    index = _block([(entries[-1][0], handle)], compress=False)
    meta = _block([], compress=False)
    meta_handle = _varint(len(data)) + _varint(len(meta) - 5)
    index_handle = _varint(len(data) + len(meta)) + _varint(len(index) - 5)
    footer = (meta_handle + index_handle).ljust(40, b"\x00") + struct.pack("<Q", tf_bundle.TABLE_MAGIC)
    path = str(tmp_path / "snappy.index")
    with open(path, "wb") as f:
        f.write(data + meta + index + footer)
    assert tf_bundle.read_table(path) == dict(entries)
    with open(path, "r+b") as f:
        f.seek(len(data) - 1)
        f.write(b"\x00")  # the stored CRC no longer matches
    with pytest.raises(tf_bundle.BundleError, match="CRC-32C"):
        tf_bundle.read_table(path)


def test_the_object_graph_maps_variables_to_checkpoint_keys():
    prefix = os.path.join(TF_MODEL, "saved_model", "variables", "variables")
    ours = tf_bundle.BundleReader(prefix).object_graph()
    ref = trackable_object_graph_pb2.TrackableObjectGraph.FromString(
        tf.train.load_checkpoint(prefix).get_tensor(tf_bundle.OBJECT_GRAPH_KEY))
    assert _same(ours, ref) >= 6
    keys = {a.checkpoint_key for n in ours.nodes for a in n.attributes if a.name == "VARIABLE_VALUE"}
    assert keys == {"kernel/.ATTRIBUTES/VARIABLE_VALUE", "bias/.ATTRIBUTES/VARIABLE_VALUE",
                    "dense/.ATTRIBUTES/VARIABLE_VALUE"}
