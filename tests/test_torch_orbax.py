"""The port's orbax reader (``graph/orbax_ckpt.py``, no orbax, tensorstore
or zstd library) against orbax itself, on the CPU.

Checkpoints written here by ``ocp.StandardCheckpointer`` (its defaults:
OCDBT and zarr v2; and ``use_ocdbt=False``) and by
``PyTreeCheckpointHandler`` (``use_zarr3=True``, ``use_compression=False``),
over nested dicts and lists
with float32, bfloat16, int32, uint8, bool, float64, scalar and None
leaves, empty dicts, lists and tuples, and
leaves of several chunks (edge chunks included), read back equal to
``restore(path)`` bit for bit; an OCDBT B-tree of several levels
(tensorstore with a small node size) read key for key;
``ModelIngest.from_orbax_checkpoint`` against the JAX package's on flax
ResNet and bert-tiny variables (rows within 1e-5 of the JAX rows'
largest magnitude), and on the committed fixture.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ocp = pytest.importorskip("orbax.checkpoint")

from sparkdl_tpu.graph.ingest import ModelIngest as JaxModelIngest  # noqa: E402
from sparkdl_tpu.models import bert as jax_bert  # noqa: E402
from sparkdl_tpu.models import resnet as jax_resnet  # noqa: E402
from sparkdl_tpu_torch.graph import ModelIngest, read_orbax_checkpoint  # noqa: E402
from sparkdl_tpu_torch.graph.orbax_ckpt import OcdbtStore, OrbaxFormatError, read_zarr3  # noqa: E402
from sparkdl_tpu_torch.models.bert import BERT_CONFIGS, BertConfig, BertEncoder  # noqa: E402
from sparkdl_tpu_torch.models.resnet import ResNet  # noqa: E402
from sparkdl_tpu_torch.ops.flash_attention import make_flash_attention_fn  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "orbax_model")
sys.path.insert(0, os.path.dirname(FIXTURE))
from orbax_writer import write_plain_checkpoint  # noqa: E402
ROW_TOL = 1e-5


def _tree():
    rng = np.random.default_rng(16)
    return {
        "params": {
            "dense": {"kernel": jnp.asarray(rng.normal(size=(50, 37)), jnp.float32),
                      "bias": jnp.asarray(rng.normal(size=(37,)), jnp.float32)},
            "emb": jnp.asarray(rng.normal(size=(10, 16)), jnp.bfloat16),
        },
        "ints": np.arange(7, dtype=np.int32),
        "stack": [np.linspace(0, 1, 3, dtype=np.float32),
                  {"x": jnp.asarray([[1, -2], [3, 4]], jnp.int32), "u": np.arange(5, dtype=np.uint8)}],
        "mask": np.array([True, False, True]),
        "f64": np.array([1.5, -2.25, 1e300]),
        "lr": 0.5,
        "step": 7,
        "none": None,
        "empty": {"d": {}, "l": [], "t": (), "n": None},
    }


def _save_args(tree):
    args = jax.tree_util.tree_map(lambda _: ocp.SaveArgs(), tree)
    args["params"]["dense"]["kernel"] = ocp.SaveArgs(chunk_byte_size=1024)
    return args


def _save(path, kind):
    tree = _tree()
    if kind == "default":
        ck = ocp.StandardCheckpointer()
        ck.save(path, tree, save_args=_save_args(tree))
    elif kind == "no-ocdbt":
        ck = ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False))
        ck.save(path, args=ocp.args.StandardSave(tree, save_args=_save_args(tree)))
        return
    elif kind == "uncompressed":
        ck = ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_compression=False))
        ck.save(path, args=ocp.args.PyTreeSave(tree, save_args=_save_args(tree)))
        return
    else:
        ck = ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True))
        ck.save(path, args=ocp.args.PyTreeSave(tree, save_args=_save_args(tree)))
        return
    ck.wait_until_finished()


def _save_tree(path, tree):
    ck = ocp.StandardCheckpointer()
    ck.save(path, tree)
    ck.wait_until_finished()


def _assert_bitwise(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_bitwise(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_bitwise(g, w, f"{path}[{i}]")
    elif want is None or isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, path
    else:
        w = np.asarray(want)
        if str(w.dtype) == "bfloat16":
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
            assert tuple(got.shape) == w.shape
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), w.view(np.int16))
        else:
            assert isinstance(got, np.ndarray) and got.dtype == w.dtype and got.shape == w.shape, path
            assert got.tobytes() == w.tobytes(), path


@pytest.mark.parametrize("kind", ["default", "no-ocdbt", "uncompressed", "zarr3"])
def test_the_tree_equals_orbax_restore_bit_for_bit(kind, tmp_path):
    path = str(tmp_path / "ckpt")
    _save(path, kind)
    meta = json.load(open(os.path.join(path, "_METADATA")))
    assert meta["use_ocdbt"] == (kind != "no-ocdbt") and meta["use_zarr3"] == (kind == "zarr3")
    if kind == "no-ocdbt":
        assert not os.path.exists(os.path.join(path, "manifest.ocdbt"))
        chunks = [n for n in os.listdir(os.path.join(path, "params.dense.kernel")) if n != ".zarray"]
        assert len(chunks) > 1  # several chunks, the last ones at the edge
    want = ocp.StandardCheckpointer().restore(path)
    _assert_bitwise(read_orbax_checkpoint(path), want)


@pytest.mark.parametrize("what", ["resnet", "bert-tiny", "mixed"])
def test_the_plain_writer_restores_in_orbax(what, tmp_path):
    """``tests/fixtures/orbax_writer.py`` (phase 22(e)'s bert-base
    checkpoint on the card) writes what orbax's ``restore`` reads: the
    tree back bit for bit, and the port's reader gives the same."""
    rng = np.random.default_rng(22)
    if what == "resnet":
        model = jax_resnet.ResNet(stage_sizes=[1, 1], num_classes=10)
        tree = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3))))
    elif what == "bert-tiny":
        tree = jax.tree_util.tree_map(
            np.asarray, jax_bert.bert_tiny().init(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32)))
    else:
        tree = {"a": rng.normal(size=(5, 3)).astype(np.float32), "i": np.arange(4, dtype=np.int64),
                "s": [np.array([2.5, -1e300]), {"b": np.array([True, False]), "u": np.arange(3, dtype=np.uint8)}]}
    tree = jax.tree_util.tree_map(np.asarray, dict(tree))
    path = str(tmp_path / "ckpt")
    n = write_plain_checkpoint(path, tree)
    assert n == sum(a.nbytes for a in jax.tree_util.tree_leaves(tree))
    restored = ocp.StandardCheckpointer().restore(path)
    _assert_bitwise(restored, tree)
    _assert_bitwise(read_orbax_checkpoint(path), tree)


class _DictStore(dict):
    def get(self, key):  # noqa: D102
        return dict.get(self, key)


@pytest.mark.parametrize("layout", ["unsharded", "index_at_start", "v2_chunk_keys"])
def test_other_zarr3_layouts_are_refused(layout, tmp_path):
    """Orbax's ``use_zarr3=True`` writes shards under ``sharding_indexed``
    with the index at the end and the default chunk keys; any other zarr
    v3 layout raises, naming its ROADMAP item."""
    path = str(tmp_path / "ckpt")
    _save(path, "zarr3")
    store = OcdbtStore(path)
    meta = json.loads(store.get("params.emb/zarr.json"))
    assert meta["codecs"][0]["name"] == "sharding_indexed"
    if layout == "unsharded":
        meta["codecs"] = meta["codecs"][0]["configuration"]["codecs"]
    elif layout == "index_at_start":
        meta["codecs"][0]["configuration"]["index_location"] = "start"
    else:
        meta["chunk_key_encoding"] = {"name": "v2", "configuration": {"separator": "."}}
    with pytest.raises(NotImplementedError, match="item 14"):
        read_zarr3(_DictStore({"params.emb/zarr.json": json.dumps(meta).encode()}), "params.emb")


def test_a_b_tree_of_several_levels_reads_key_for_key(tmp_path):
    """tensorstore's OCDBT with a small node size: interior nodes (with
    their subtree prefixes), inline and out-of-line values."""
    ts = pytest.importorskip("tensorstore")
    root = str(tmp_path / "db")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": {"max_decoded_node_bytes": 600, "max_inline_value_bytes": 40}}).result()
    rng = np.random.default_rng(3)
    values = {f"arr{i % 7}.w{i:04d}/{i % 3}.0": rng.bytes(int(rng.integers(0, 100))) for i in range(400)}
    txn = ts.Transaction()
    for k, v in values.items():
        kv.with_transaction(txn).write(k, v)
    txn.commit_async().result()
    store = OcdbtStore(root)
    heights = []
    original = OcdbtStore._node

    def spy(self, file, offset, length, height, prefix):
        heights.append(height)
        return original(self, file, offset, length, height, prefix)

    OcdbtStore._node = spy
    try:
        store = OcdbtStore(root)
    finally:
        OcdbtStore._node = original
    assert max(heights) >= 2
    assert len(store.entries) == len(values)
    for k, v in values.items():
        assert store.get(k) == v, k
    assert store.get("absent") is None


def test_a_corrupted_node_is_refused(tmp_path):
    path = str(tmp_path / "ckpt")
    _save(path, "default")
    node = os.path.join(path, "d", os.listdir(os.path.join(path, "d"))[0])
    data = bytearray(open(node, "rb").read())
    data[20] ^= 1
    open(node, "wb").write(bytes(data))
    with pytest.raises(OrbaxFormatError, match="CRC-32C"):
        read_orbax_checkpoint(path)


def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32),
                                  variables)


def _assert_rows(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ROW_TOL * max(1.0, float(np.abs(want).max()))


def test_resnet_variables_bind_like_the_jax_package(tmp_path):
    x = (np.random.default_rng(1).random((2, 32, 32, 3)) * 2 - 1).astype(np.float32)
    model = jax_resnet.ResNet(stage_sizes=[1, 1], num_classes=10)
    variables = _perturbed(model.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3))), 4)
    path = str(tmp_path / "ckpt")
    _save_tree(path, variables)
    want = np.asarray(JaxModelIngest.from_orbax_checkpoint(path, lambda p, b: model.apply(p, b))(x))
    mf = ModelIngest.from_orbax_checkpoint(path, ResNet([1, 1], num_classes=10), input_shape=(32, 32, 3),
                                           device="cpu")
    assert mf.name == "orbax_restored" and mf.takes_nhwc
    _assert_rows(mf(torch.from_numpy(x)).numpy(), want)


def test_bert_tiny_variables_bind_like_the_jax_package(tmp_path):
    ids = np.random.default_rng(2).integers(1, 1000, size=(3, 20)).astype(np.int32)
    module = jax_bert.bert_tiny()
    variables = _perturbed(module.init(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32)), 5)
    path = str(tmp_path / "ckpt")
    _save_tree(path, variables)
    want = np.asarray(JaxModelIngest.from_orbax_checkpoint(path, lambda p, b: module.apply(p, b))(ids))
    encoder = BertEncoder(BERT_CONFIGS["tiny"], make_flash_attention_fn())
    mf = ModelIngest.from_orbax_checkpoint(path, encoder, device="cpu", name="bert")
    _assert_rows(mf(torch.from_numpy(ids)).numpy(), want)
    # a custom mapping, and a module with no default one
    calls = []

    def convert(tree, mod):
        calls.append(sorted(tree))
        from sparkdl_tpu_torch.models.convert import bert_params_from_flax

        return bert_params_from_flax(tree, mod.config)

    ModelIngest.from_orbax_checkpoint(path, BertEncoder(BERT_CONFIGS["tiny"]), convert=convert, device="cpu")
    assert calls == [["params"]]
    with pytest.raises(TypeError, match="convert"):
        ModelIngest.from_orbax_checkpoint(path, torch.nn.Linear(2, 2), device="cpu")


def test_the_committed_fixture_gives_the_jax_rows():
    io = np.load(os.path.join(FIXTURE, "io.npz"))
    config = BertConfig(**json.loads(str(io["config"])))
    mf = ModelIngest.from_orbax_checkpoint(os.path.join(FIXTURE, "ckpt"),
                                           BertEncoder(config, make_flash_attention_fn()), device="cpu")
    _assert_rows(mf(torch.from_numpy(io["ids"])).numpy(), io["y_jax"])
    # and the tree is orbax's own
    _assert_bitwise(read_orbax_checkpoint(os.path.join(FIXTURE, "ckpt")),
                    ocp.StandardCheckpointer().restore(os.path.join(FIXTURE, "ckpt")))
