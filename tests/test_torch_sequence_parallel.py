"""The port's sequence parallelism (``parallel/mesh.py``'s ``sp`` axis,
``ops/ring_attention.py``, ``ops/ulysses.py`` and
``models/bert.bert_model_function_sequence_parallel``) against the JAX
package's, on the CPU.

World sizes 2 and 4 run as gloo process gangs (this file is their worker
script): every rank gets the same numpy inputs, runs ring and Ulysses
attention over its ``L/n`` shard, and the bert-tiny sequence-parallel
model over the JAX package's weights; each writes what it got. The JAX
package runs the same inputs on a mesh over the first n of conftest's 8
CPU devices. Attention agrees at 1e-5 (the JAX package's own ring and
Ulysses tolerance), fully masked rows included; embeddings at 1e-4.
World size 1 runs in process.
"""

import argparse
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch import udf as udf_catalog
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.graph.function import piece
from sparkdl_tpu_torch.models import bert_model_function_sequence_parallel, get_model
from sparkdl_tpu_torch.models.bert import dense_attention
from sparkdl_tpu_torch.ops import (
    make_ring_attention,
    make_ulysses_attention,
    ring_attention_sharded,
    ulysses_attention_sharded,
)
from sparkdl_tpu_torch.ops.flash_attention import make_flash_attention_fn
from sparkdl_tpu_torch.parallel import Mesh, distributed, make_mesh
from sparkdl_tpu_torch.transformers import execution
from sparkdl_tpu_torch.transformers.text import TextEmbedder, pad_or_truncate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
EMBED_ATOL = 1e-4
B, H, L, DH = 2, 8, 16, 32
MAX_LEN = 32
NEG = np.finfo(np.float32).min


def _inputs(heads=H, seed=0):
    """q, k, v [B, heads, L, DH] and an additive [B, 1, 1, L] mask: row 0
    keeps its first 11 keys, row 1 drops every key (a fully masked row)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, heads, L, DH)).astype(np.float32) for _ in range(3))
    mask = np.zeros((B, 1, 1, L), np.float32)
    mask[0, ..., 11:] = NEG
    mask[1] = NEG
    return q, k, v, mask


def _ids():
    """[3, MAX_LEN] token ids with a padded tail, a short row and a fully
    padded row, and the matching 0/1 mask."""
    rng = np.random.default_rng(1)
    ids = rng.integers(4, 1000, (3, MAX_LEN)).astype(np.int32)
    ids[0, 27:] = 0
    ids[1, 5:] = 0
    ids[2] = 0
    return ids, (ids != 0).astype(np.int32)


TEXTS = [
    "sequence parallelism makes long context first class",
    "short",
    None,
    "the quick brown fox jumps over the lazy dog " * 3,
]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# -- the gang's worker --------------------------------------------------------


def _worker(rank: int, world: int, port: int, weights: str, out_path: str) -> None:
    from sparkdl_tpu_torch.models.registry import load_flax_npz

    distributed.initialize(f"tcp://localhost:{port}", world_size=world, rank=rank, device="cpu")
    try:
        out = {}
        mesh = make_mesh({"sp": world})
        assert (mesh.axis_size("sp"), mesh.axis_index("sp")) == (world, rank)
        q, k, v, mask = (_t(a) for a in _inputs())
        flash = make_flash_attention_fn()
        out["ring/mask"] = ring_attention_sharded(q, k, v, _t(mask), mesh)
        out["ring/nomask"] = ring_attention_sharded(q, k, v, None, mesh)
        out["ulysses/mask"] = ulysses_attention_sharded(q, k, v, _t(mask), mesh)
        out["ulysses/nomask"] = ulysses_attention_sharded(q, k, v, None, mesh)
        out["ulysses/flash"] = ulysses_attention_sharded(q, k, v, _t(mask), mesh, inner=flash)
        bad = _inputs(heads=3 if world == 2 else 6)
        try:
            ulysses_attention_sharded(*(_t(a) for a in bad), mesh)
            out["ulysses/heads_error"] = np.array("")
        except ValueError as e:
            out["ulysses/heads_error"] = np.array(str(e))
        # dp x sp: ring and Ulysses over a 2-process sp axis in each dp replica
        grid = make_mesh({"dp": world // 2, "sp": 2})
        out["grid/coords"] = np.array([grid.axis_index("dp"), grid.axis_index("sp")])
        for axis in ("dp", "sp"):
            g = grid.axis_group(axis)
            out[f"grid/{axis}_ranks"] = np.array(
                torch.distributed.get_process_group_ranks(g) if g is not None else [rank]
            )
        out["grid/ring"] = ring_attention_sharded(q, k, v, _t(mask), grid)
        out["grid/ulysses"] = ulysses_attention_sharded(q, k, v, _t(mask), grid)
        # bert-tiny over the JAX package's weights
        params = load_flax_npz(weights)
        ids, attn = (_t(a) for a in _ids())
        for strategy in ("ring", "ulysses"):
            mf = bert_model_function_sequence_parallel(
                "tiny", mesh=mesh, strategy=strategy, params=params, max_length=MAX_LEN, device="cpu",
            )
            out[f"bert/{strategy}"] = mf((ids, attn))
            out[f"bert/{strategy}/name"] = np.array(mf.name)
        mf = bert_model_function_sequence_parallel(
            "tiny", mesh=mesh, strategy="ulysses", params=params, max_length=MAX_LEN, device="cpu",
            inner=flash,
        )
        out["bert/ulysses_flash"] = mf((ids, attn))
        # TextEmbedder and a catalog UDF over the ring model, on one
        # partition and on two: a single_stream column runs its partitions
        # in index order on every rank, so the ranks' batches pair up
        mf = bert_model_function_sequence_parallel(
            "tiny", mesh=mesh, strategy="ring", params=params, max_length=MAX_LEN, device="cpu",
        )
        emb = TextEmbedder(inputCol="text", outputCol="e", modelFunction=mf, maxLength=MAX_LEN, batchSize=2)
        tok = emb._tokenizer()

        def to_batch(chunk):
            ids = np.zeros((len(chunk), MAX_LEN), np.int32)
            ok = np.array([t is not None for t in chunk])
            for i in np.flatnonzero(ok):
                ids[i] = pad_or_truncate(tok(chunk[i]), MAX_LEN)
            return ids, ok

        with_mask = piece(lambda ids: (ids, (ids != 0).to(torch.int32)), name="mask").and_then(mf)
        udf_catalog.registerModelUDF("sp_ring", with_mask, to_batch=to_batch, batch_size=2, device="cpu")
        for parts in (1, 2):
            frame = DataFrame.fromColumns({"text": TEXTS}, numPartitions=parts)
            for path, result in (("embedder", emb.transform(frame)),
                                 ("udf", udf_catalog.apply_udf("sp_ring", frame, "text", "e"))):
                rows = [r["e"] for r in result.collect()]
                out[f"{path}{parts}/null"] = np.array([r is None for r in rows])
                out[f"{path}{parts}/rows"] = np.stack([r for r in rows if r is not None])
        np.savez(out_path, **{key: np.asarray(val) for key, val in out.items()})
    finally:
        distributed.shutdown()


# -- the JAX side -------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """bert-tiny's flax params from the JAX package, and the ``.npz`` the
    gang loads them from."""
    import jax
    import jax.numpy as jnp

    from sparkdl_tpu.models.bert import bert_tiny
    from sparkdl_tpu_torch.models.registry import save_flax_weights

    params = bert_tiny().init(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    path = str(tmp_path_factory.mktemp("weights") / "bert_tiny.npz")
    save_flax_weights(params, path)
    return params, path


def _jax_mesh(n):
    import jax

    from sparkdl_tpu.parallel import make_mesh as jax_make_mesh

    return jax_make_mesh({"sp": n}, devices=jax.devices()[:n])


def _jax_attention(strategy, n, masked=True, inner=None):
    import jax.numpy as jnp

    from sparkdl_tpu.ops import ring_attention_sharded as jax_ring
    from sparkdl_tpu.ops import ulysses_attention_sharded as jax_ulysses

    q, k, v, mask = (jnp.asarray(a) for a in _inputs())
    mask = mask if masked else None
    if strategy == "ring":
        return np.asarray(jax_ring(q, k, v, mask, _jax_mesh(n), axis="sp"))
    return np.asarray(jax_ulysses(q, k, v, mask, _jax_mesh(n), axis="sp", inner=inner))


_JAX_BERT = {}


def _jax_bert(params, strategy, n):
    """The JAX package's sequence-parallel bert-tiny on ``_ids()``, jitted,
    once per (strategy, n)."""
    if (strategy, n) not in _JAX_BERT:
        _JAX_BERT[strategy, n] = _run_jax_bert(params, strategy, n)
    return _JAX_BERT[strategy, n]


def _run_jax_bert(params, strategy, n):
    import jax
    import jax.numpy as jnp

    from sparkdl_tpu.models.bert import bert_model_function_sequence_parallel as jax_sp

    mf = jax_sp("tiny", mesh=_jax_mesh(n), strategy=strategy, params=params, max_length=MAX_LEN)
    ids, attn = _ids()
    return np.asarray(jax.jit(mf.fn)(mf.params, (jnp.asarray(ids), jnp.asarray(attn)))), mf.name


@pytest.fixture(scope="module", params=[2, 4])
def gang(request, jax_weights, tmp_path_factory):
    """Run the worker at world size ``request.param``; every rank's outputs."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"gang{world}")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(r), str(world), str(port),
             jax_weights[1], str(tmp / f"rank{r}.npz")],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    for p in procs:
        log, _ = p.communicate(timeout=240)
        assert p.returncode == 0, log
    outs = []
    for r in range(world):
        with np.load(str(tmp / f"rank{r}.npz")) as blob:
            outs.append({key: blob[key] for key in blob.files})
    return world, outs


# -- the gangs against the JAX package ------------------------------------------


@pytest.mark.parametrize("strategy,masked", [("ring", True), ("ring", False), ("ulysses", True),
                                             ("ulysses", False)])
def test_gang_attention_matches_jax(gang, strategy, masked):
    world, outs = gang
    ref = _jax_attention(strategy, world, masked)
    for r, out in enumerate(outs):
        got = out[f"{strategy}/{'mask' if masked else 'nomask'}"]
        np.testing.assert_allclose(got, ref, rtol=ATOL, atol=ATOL, err_msg=f"rank {r}")


def test_gang_ulysses_with_the_flash_inner_matches_jax(gang):
    """The flash kernel's plain version inside Ulysses against the Pallas
    kernel (interpreted) inside the JAX package's: a fully masked row comes
    out as 0 in both, where dense attention averages every value."""
    from sparkdl_tpu.ops.flash_attention import make_flash_attention_fn as jax_flash

    world, outs = gang
    ref = _jax_attention("ulysses", world, inner=jax_flash(interpret=True))
    assert not ref[1].any()
    for out in outs:
        np.testing.assert_allclose(out["ulysses/flash"], ref, rtol=ATOL, atol=ATOL)


def test_gang_attention_matches_dense(gang):
    """The fully masked row too: both strategies give dense attention's
    answer on every rank."""
    _, outs = gang
    q, k, v, mask = (_t(a) for a in _inputs())
    dense = dense_attention(q, k, v, mask, torch.float32).numpy()
    for out in outs:
        for key in ("ring/mask", "ulysses/mask", "grid/ring", "grid/ulysses"):
            np.testing.assert_allclose(out[key], dense, rtol=ATOL, atol=ATOL, err_msg=key)


def test_gang_refuses_indivisible_heads(gang):
    import jax.numpy as jnp

    from sparkdl_tpu.ops import ulysses_attention_sharded as jax_ulysses

    world, outs = gang
    bad = [jnp.asarray(a) for a in _inputs(heads=3 if world == 2 else 6)]
    with pytest.raises(ValueError) as jax_err:
        jax_ulysses(*bad, _jax_mesh(world), axis="sp")
    for out in outs:
        assert str(out["ulysses/heads_error"]) == str(jax_err.value)
        assert "heads % axis_size" in str(out["ulysses/heads_error"])


def test_gang_dp_by_sp_groups(gang):
    """``{"dp": n/2, "sp": 2}`` puts rank r at (r // 2, r % 2), as the JAX
    mesh orders its devices; each axis's group holds the ranks along it."""
    import jax

    from sparkdl_tpu.parallel import make_mesh as jax_make_mesh

    world, outs = gang
    jmesh = jax_make_mesh({"dp": world // 2, "sp": 2}, devices=jax.devices()[:world])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r, out in enumerate(outs):
        dp, sp = (int(c) for c in out["grid/coords"])
        assert (dp, sp) == (r // 2, r % 2)
        assert ids[dp, sp] == r
        assert sorted(out["grid/sp_ranks"].tolist()) == sorted(ids[dp, :].tolist())
        assert sorted(out["grid/dp_ranks"].tolist()) == sorted(ids[:, sp].tolist())


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_gang_bert_tiny_matches_jax(gang, jax_weights, strategy):
    world, outs = gang
    ref, name = _jax_bert(jax_weights[0], strategy, world)
    for out in outs:
        np.testing.assert_allclose(out[f"bert/{strategy}"], ref, rtol=EMBED_ATOL, atol=EMBED_ATOL)
        assert str(out[f"bert/{strategy}/name"]) == name == f"bert_tiny[embed,{strategy}/spx{world}]"
    np.testing.assert_allclose(outs[0]["bert/ulysses_flash"], ref, rtol=EMBED_ATOL, atol=EMBED_ATOL)


def test_gang_bert_tiny_matches_the_dense_port(gang, jax_weights):
    _, outs = gang
    dense = get_model("bert-tiny").model_function(params=jax_weights[0], device="cpu")
    ids, attn = (_t(a) for a in _ids())
    ref = dense((ids, attn)).numpy()
    for out in outs:
        for key in ("bert/ring", "bert/ulysses", "bert/ulysses_flash"):
            np.testing.assert_allclose(out[key], ref, rtol=EMBED_ATOL, atol=EMBED_ATOL, err_msg=key)


@pytest.mark.parametrize("path,parts", [("embedder", 1), ("embedder", 2), ("udf", 1), ("udf", 2)])
def test_gang_text_embedder_matches_direct_calls(gang, jax_weights, path, parts):
    """TextEmbedder and a catalog UDF over the ring model on every rank,
    over one partition and over two: the same rows as the model called
    directly on the padded ids, and as the JAX package's dense bert-tiny
    TextEmbedder over as many partitions."""
    from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
    from sparkdl_tpu.models.bert import bert_model_function as jax_bert_mf
    from sparkdl_tpu.transformers.text import TextEmbedder as JaxTextEmbedder
    from sparkdl_tpu_torch.transformers.text import HashingTokenizer

    _, outs = gang
    jax_mf = jax_bert_mf("tiny", params=jax_weights[0], max_length=MAX_LEN)
    jax_rows = [r.e for r in JaxTextEmbedder(inputCol="text", outputCol="e", modelFunction=jax_mf,
                                             maxLength=MAX_LEN, batchSize=2)
                .transform(JaxDataFrame.fromColumns({"text": TEXTS}, numPartitions=parts)).collect()]
    dense = get_model("bert-tiny").model_function(params=jax_weights[0], device="cpu")
    tok = HashingTokenizer(vocab_size=1000)
    ids = np.stack([pad_or_truncate(tok(t), MAX_LEN) for t in TEXTS if t is not None]).astype(np.int32)
    direct = dense((_t(ids), _t((ids != 0).astype(np.int32)))).numpy()
    for out in outs:
        assert out[f"{path}{parts}/null"].tolist() == [r is None for r in jax_rows]
        rows = out[f"{path}{parts}/rows"]
        np.testing.assert_allclose(rows, direct, rtol=EMBED_ATOL, atol=EMBED_ATOL)
        np.testing.assert_allclose(rows, np.stack([r for r in jax_rows if r is not None]),
                                   rtol=EMBED_ATOL, atol=EMBED_ATOL)


# -- world size 1, in process ---------------------------------------------------


@pytest.mark.parametrize("axes", [None, {"sp": 1}, {"sp": -1}, {"dp": 1, "sp": 1}, {"sp": 1, "dp": -1}])
def test_single_process_meshes(axes):
    mesh = make_mesh(axes)
    assert mesh.size == 1 and mesh.rank == 0 and mesh.group is None
    for name in mesh.axes:
        assert (mesh.axis_size(name), mesh.axis_index(name), mesh.axis_group(name)) == (1, 0, None)


@pytest.mark.parametrize("axis", ["tp", "pp", "ep"])
def test_mesh_takes_every_axis(axis):
    """The tensor, pipeline and expert axes make a mesh of one process, alone
    and beside ``dp``, in the order given, as the JAX package's
    ``make_mesh`` takes any axis name."""
    for axes in ({axis: 1}, {axis: -1}, {"dp": 1, axis: 1}, {axis: 1, "dp": -1}):
        mesh = make_mesh(axes)
        assert list(mesh.axes) == list(axes) and mesh.size == 1 and mesh.group is None
        for name in mesh.axes:
            assert (mesh.axis_size(name), mesh.axis_index(name), mesh.axis_group(name)) == (1, 0, None)
    with pytest.raises(ValueError, match="need 2 processes, have 1"):
        make_mesh({"dp": 1, axis: 2})


def test_mesh_size_errors():
    with pytest.raises(ValueError, match="need 2 processes, have 1"):
        make_mesh({"sp": 2})
    with pytest.raises(ValueError, match="At most one axis"):
        make_mesh({"dp": -1, "sp": -1})
    with pytest.raises(ValueError, match="no axis 'sp'"):
        make_mesh({"dp": 1}).axis_size("sp")


@pytest.mark.parametrize("strategy,masked", [("ring", True), ("ring", False), ("ulysses", True),
                                             ("ulysses", False)])
def test_single_process_attention_matches_jax(strategy, masked):
    q, k, v, mask = (_t(a) for a in _inputs())
    fn = ring_attention_sharded if strategy == "ring" else ulysses_attention_sharded
    got = fn(q, k, v, mask if masked else None, make_mesh({"sp": 1})).numpy()
    np.testing.assert_allclose(got, _jax_attention(strategy, 1, masked), rtol=ATOL, atol=ATOL)
    dense = dense_attention(q, k, v, mask if masked else None, torch.float32).numpy()
    np.testing.assert_allclose(got, dense, rtol=ATOL, atol=ATOL)


def test_local_attention_fns_take_dense_attention_signature():
    """At one process the local fns are whole-sequence attentions; in bf16
    they return bf16, with the score math in f32."""
    from sparkdl_tpu_torch.ops.flash_attention import flash_attention_reference

    q, k, v, mask = (_t(a) for a in _inputs())
    dense = dense_attention(q, k, v, mask, torch.float32).numpy()
    flash = flash_attention_reference(q, k, v, mask).numpy()  # the fully masked row is 0
    for fn, ref in ((make_ring_attention(), dense), (make_ulysses_attention(), dense),
                    (make_ulysses_attention(inner=make_flash_attention_fn()), flash)):
        np.testing.assert_allclose(fn(q, k, v, mask, torch.float32).numpy(), ref, rtol=ATOL, atol=ATOL)
        out = fn(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask, torch.bfloat16)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), ref, atol=3e-2)


def test_online_block_update_guards_fully_masked_blocks():
    """A block whose every key is -inf leaves m at -inf and adds nothing,
    where an unguarded update would write nan."""
    from sparkdl_tpu_torch.ops.ring_attention import _online_block_update

    q, k, v, _ = (_t(a) for a in _inputs())
    m = torch.full(q.shape[:-1], float("-inf"))
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    dead = torch.full((B, 1, 1, L), float("-inf"))
    m, l, o = _online_block_update(q, k, v, dead, m, l, o, 1.0 / np.sqrt(DH))
    assert torch.isneginf(m).all() and (l == 0).all() and (o == 0).all()
    m, l, o = _online_block_update(q, k, v, None, m, l, o, 1.0 / np.sqrt(DH))
    out = o / l[..., None]
    np.testing.assert_allclose(out.numpy(), dense_attention(q, k, v, None, torch.float32).numpy(),
                               rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_single_process_bert_tiny_matches_jax_and_dense(jax_weights, strategy):
    params = jax_weights[0]
    mf = bert_model_function_sequence_parallel(
        "tiny", mesh=make_mesh({"sp": 1}), strategy=strategy, params=params, max_length=MAX_LEN, device="cpu",
    )
    assert mf.single_stream and mf.name == f"bert_tiny[embed,{strategy}/spx1]"
    assert mf.vocab_size == 1000
    ids, attn = (_t(a) for a in _ids())
    got = mf((ids, attn)).numpy()
    ref, _ = _jax_bert(params, strategy, 1)
    np.testing.assert_allclose(got, ref, rtol=EMBED_ATOL, atol=EMBED_ATOL)
    dense = get_model("bert-tiny").model_function(params=params, device="cpu")
    np.testing.assert_allclose(got, dense((ids, attn)).numpy(), rtol=EMBED_ATOL, atol=EMBED_ATOL)
    # bare ids: the mask is all ones, as in the JAX package
    bare = mf(ids).numpy()
    ref_bare = dense((ids, torch.ones_like(attn))).numpy()
    np.testing.assert_allclose(bare, ref_bare, rtol=EMBED_ATOL, atol=EMBED_ATOL)


def test_seeded_weights_are_the_registry_s():
    """Without params the weights are drawn as ``get_model(...)`` draws
    them from the same seed, so the dense model is the reference."""
    ids, attn = (_t(a) for a in _ids())
    mf = bert_model_function_sequence_parallel("tiny", strategy="ring", seed=3, max_length=MAX_LEN, device="cpu")
    dense = get_model("bert-tiny").model_function(seed=3, device="cpu")
    np.testing.assert_allclose(mf((ids, attn)).numpy(), dense((ids, attn)).numpy(),
                               rtol=EMBED_ATOL, atol=EMBED_ATOL)


def test_validations_match_jax():
    """The JAX package's refusals, on a mesh record of a 4-process axis
    (each check runs before any collective)."""
    four = Mesh({"sp": 4})
    cases = [
        (dict(max_length=30), "divisible by the 'sp' axis size"),
        (dict(max_length=256), "position table"),
        (dict(strategy="nope"), "Unknown strategy"),
        (dict(size="huge"), "Unknown BERT size"),
        (dict(strategy="ring", inner=make_flash_attention_fn()), "ring attention takes none"),
    ]
    for kwargs, match in cases:
        kwargs = {"size": "tiny", "max_length": MAX_LEN, **kwargs}
        with pytest.raises(ValueError, match=match):
            bert_model_function_sequence_parallel(mesh=four, device="cpu", **kwargs)
    with pytest.raises(ValueError, match="heads"):
        bert_model_function_sequence_parallel("tiny", mesh=Mesh({"sp": 8}), strategy="ulysses",
                                              max_length=MAX_LEN, device="cpu")
    mf = bert_model_function_sequence_parallel("tiny", strategy="ring", max_length=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="sequence length 16 != max_length 32"):
        mf(torch.ones((1, 16), dtype=torch.int64))


def test_execution_carries_single_stream():
    seq = bert_model_function_sequence_parallel("tiny", max_length=MAX_LEN, device="cpu")
    dense = get_model("bert-tiny").model_function(device="cpu")
    assert execution.model_device_fn(seq).single_stream is True
    assert execution.model_device_fn(dense).single_stream is False
    composed = seq.before(lambda ids: ids)
    assert composed.single_stream and execution.model_device_fn(composed).single_stream


def test_single_process_text_embedder_skips_bucketing(jax_weights, monkeypatch):
    """A single_stream fn runs at exactly maxLength: the bucketed path is
    never taken, and its rows equal the model's direct calls, over two
    partitions."""
    from sparkdl_tpu_torch.transformers.text import pad_or_truncate
    from sparkdl_tpu_torch.transformers import text as text_mod

    monkeypatch.setenv("SPARKDL_TEXT_BUCKETING", "1")

    def refuse(*_a, **_k):
        raise AssertionError("a single_stream fn was bucketed")

    monkeypatch.setattr(text_mod, "run_bucketed", refuse)
    mf = bert_model_function_sequence_parallel("tiny", strategy="ring", params=jax_weights[0],
                                               max_length=MAX_LEN, device="cpu")
    emb = TextEmbedder(inputCol="text", outputCol="e", modelFunction=mf, maxLength=MAX_LEN, batchSize=2)
    rows = [r["e"] for r in emb.transform(DataFrame.fromColumns({"text": TEXTS}, numPartitions=2)).collect()]
    assert [r is None for r in rows] == [t is None for t in TEXTS]
    tok = emb._tokenizer()
    for text, row in zip(TEXTS, rows):
        if text is None:
            continue
        ids = torch.from_numpy(pad_or_truncate(tok(text), MAX_LEN).astype(np.int64))[None]
        np.testing.assert_allclose(row, mf((ids, (ids != 0).to(torch.int32))).numpy()[0], rtol=1e-6, atol=1e-6)


def test_single_stream_columns_run_their_partitions_in_order(monkeypatch):
    """A single_stream model's column (TextEmbedder, a catalog UDF) runs
    its partitions one at a time in index order, where the same frame's
    other columns run theirs at once."""
    from sparkdl_tpu_torch.runtime.executor import (
        Executor,
        current_task_context,
        default_executor,
        set_default_executor,
    )

    mf = bert_model_function_sequence_parallel("tiny", strategy="ring", max_length=MAX_LEN, device="cpu")
    seen = []
    fn = execution.model_device_fn(mf)

    def spy(batch):
        ctx = current_task_context()
        seen.append((ctx.partition_index, ctx.concurrency))
        return fn(batch)

    for name in ("device", "stream", "stage_put", "launcher", "n_devices", "batch_multiplier", "single_stream"):
        setattr(spy, name, getattr(fn, name))
    monkeypatch.setattr("sparkdl_tpu_torch.transformers.text.model_device_fn", lambda _mf: spy)
    prev = default_executor()
    set_default_executor(Executor(max_workers=4))
    try:
        frame = DataFrame.fromColumns({"text": TEXTS * 2}, numPartitions=4)
        emb = TextEmbedder(inputCol="text", outputCol="e", modelFunction=mf, maxLength=MAX_LEN, batchSize=1)
        assert len(emb.transform(frame).collect()) == 2 * len(TEXTS)
        assert seen == sorted(seen) and {c for _, c in seen} == {1} and len({i for i, _ in seen}) == 4
        udf_catalog.registerModelUDF("sp_order", mf, batch_size=1, device="cpu")
        try:
            assert udf_catalog.get("sp_order").single_stream
        finally:
            udf_catalog.unregister("sp_order")
        for serial, concurrency in ((False, 4), (True, 1)):
            got = frame.withColumnPartition(
                "c", lambda part: {"c": [current_task_context().concurrency] * len(part["text"])}, serial=serial,
            ).collect()
            assert {r["c"] for r in got} == {concurrency}
    finally:
        set_default_executor(prev)


@pytest.mark.parametrize("pandas_installed", [True, False])
def test_chip_smoke_phase_27_rehearses_on_the_cpu(monkeypatch, tmp_path, pandas_installed):
    """``chip_smoke.py``'s phase 27 at cut sizes on the CPU: bert-tiny at
    L=64 over 24 texts, every check of the card's run (no flash launch on
    the CPU), with pandas and without it, as on the card's machine."""
    import chip_smoke

    for name, value in (("S_TEXT_MODEL", "bert-tiny"), ("S_MAX_LENGTH", 64), ("S_BATCH", 8), ("S_TEXTS", 24),
                        ("S_BEAT_TEXTS", 8), ("S_ITERS", 1)):
        monkeypatch.setattr(chip_smoke, name, value)
    if not pandas_installed:
        monkeypatch.setitem(sys.modules, "pandas", None)
    assert chip_smoke.phase_sequence_parallel(0, "cpu", str(tmp_path), device="cpu") == {
        torch.float32: 0, torch.bfloat16: 0}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", nargs=5, required=True, metavar=("RANK", "WORLD", "PORT", "WEIGHTS", "OUT"))
    rank, world, port, weights, out_path = parser.parse_args().worker
    _worker(int(rank), int(world), int(port), weights, out_path)
