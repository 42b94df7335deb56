"""``ModelFunction.export``/``load`` and ``ModelIngest.from_exported`` of the
port against the JAX package's (``jax.export`` StableHLO), on the CPU.

The same seeded weights and inputs go through the JAX package's
export-then-load and the port's (``torch.export``, the flash kernel as
the registered op ``sparkdl_tpu_torch::flash_attention``, whose CPU
implementation is the kernel's plain version): the linear function of
``tests/test_graph.py`` (1e-6), the bert-tiny text composite at f32 (1e-4,
as ``test_torch_bert.py``) and at the bf16 rung (3e-2, as
``test_torch_rung.py``), ResNet50 features at 32x32 (relative 1e-4, as
``test_torch_int8.py``). Beside them: a symbolic batch taken at 2 then 8
(and 1), a pinned ``batch_size``, ``raw_params``, a load in a fresh
process, the int8 rung's round trip, and a JAX-written artifact loaded
on the port's StableHLO interpreter (one lowered for two platforms
refused).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
from sparkdl_tpu.graph.precision import apply_precision as jax_apply_precision
from sparkdl_tpu.models import bert as jax_bert
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.models import resnet as jax_resnet
from sparkdl_tpu_torch.graph import ModelIngest, piece
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.graph.precision import bf16_rung, int8_rung
from sparkdl_tpu_torch.models import get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 24
FLASH = "sparkdl_tpu_torch.flash_attention.default"


def _ids(seed=0, batch=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 1000, size=(batch, L)).astype(np.int32)
    ids[min(1, batch - 1), 15:] = 0
    ids[-1, 5:] = 0
    return ids


@pytest.fixture(scope="module")
def bert_params():
    params = jax_bert.bert_tiny().init(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def bert_npz(bert_params, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "bert_tiny.npz")
    jax_registry.save_flax_weights(bert_params, path)
    return path


def _jax_round_trip(mf: JaxModelFunction, path: str, x) -> np.ndarray:
    mf.export(path)
    return np.asarray(JaxModelFunction.load(path)(x))


def _text_composite(mf: ModelFunction) -> ModelFunction:
    """The TextEmbedder's composite: ids -> (ids, ids != 0) -> the model,
    one [b, L] int32 input."""
    comp = piece(lambda ids: (ids, (ids != 0).to(torch.int32)), name="mask").and_then(mf)
    return dataclasses.replace(comp, input_shape=(L,), input_dtype=torch.int32)


def _flash_nodes(path: str) -> int:
    program = torch.export.load(os.path.join(path, "program.pt2"))
    return sum(1 for n in program.graph.nodes if str(n.target) == FLASH)


class _Linear(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))
        self.b = torch.nn.Parameter(torch.from_numpy(b))


def test_linear_fn_round_trips_like_the_jax_export(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    x = rng.normal(size=(2, 4)).astype(np.float32)
    jax_mf = JaxModelFunction(lambda p, v: v @ p["w"] + p["b"], {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                              input_shape=(4,), input_dtype=jnp.float32, name="linear")
    want = _jax_round_trip(jax_mf, str(tmp_path / "jax"), x)
    mf = ModelIngest.from_callable(lambda m, v: v @ m.w + m.b, _Linear(w, b), input_shape=(4,),
                                   input_dtype=torch.float32, name="linear", device="cpu")
    mf.export(str(tmp_path / "port"))
    loaded = ModelIngest.from_exported(str(tmp_path / "port"), device="cpu")
    np.testing.assert_allclose(loaded(torch.from_numpy(x)).numpy(), want, rtol=1e-6, atol=1e-6)
    # the symbolic batch takes other sizes; params survive beside the program
    x8 = np.tile(x, (4, 1))
    assert tuple(loaded(torch.from_numpy(x8)).shape) == (8, 3)
    np.testing.assert_array_equal(loaded.raw_params["w"], w)
    assert loaded.name == "linear" and loaded.input_shape == (4,) and loaded.input_dtype == torch.float32


def test_bert_tiny_composite_round_trips_like_the_jax_export(bert_params, bert_npz, tmp_path):
    ids = _ids()
    jax_mf = dataclasses.replace(jax_registry.get_model("bert-tiny").model_function(weights_file=bert_npz),
                                 input_shape=(L,), input_dtype=jnp.int32)
    want = _jax_round_trip(jax_mf, str(tmp_path / "jax"), ids)
    mf = get_model("bert-tiny").model_function(params=bert_params, device="cpu")
    comp = _text_composite(mf)
    path = str(tmp_path / "port")
    comp.export(path)
    assert _flash_nodes(path) == mf.module.config.num_layers == 4
    loaded = ModelFunction.load(path, device="cpu")
    got = loaded(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the same ops as the direct composite, row for row
    np.testing.assert_array_equal(got, comp(torch.from_numpy(ids)).numpy())
    assert loaded.vocab_size == 1000 and loaded.input_dtype == torch.int32
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["format"] == 1 and meta["batch_size"] is None and meta["input_shape"] == [L]
    state = mf.module.state_dict()
    assert set(loaded.raw_params) == {f"1.{k}" for k in state}
    np.testing.assert_array_equal(loaded.raw_params["1.embeddings.word_embeddings.weight"],
                                  bert_params["params"]["embeddings"]["word_embeddings"]["embedding"])


def test_bert_tiny_bf16_rung_round_trips_like_the_jax_rung(bert_params, bert_npz, tmp_path):
    ids = _ids(1)
    jax_mf = jax_apply_precision(jax_registry.get_model("bert-tiny").model_function(
        dtype=jnp.bfloat16, weights_file=bert_npz), "bf16")
    want = _jax_round_trip(dataclasses.replace(jax_mf, input_shape=(L,), input_dtype=jnp.int32),
                           str(tmp_path / "jax"), ids)
    mf = bf16_rung(get_model("bert-tiny").model_function(dtype=torch.bfloat16, params=bert_params,
                                                         device="cpu"))
    comp = _text_composite(mf)
    comp.export(str(tmp_path / "port"))
    loaded = ModelFunction.load(str(tmp_path / "port"), device="cpu")
    got = loaded(torch.from_numpy(ids)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 3e-2
    np.testing.assert_array_equal(got, comp(torch.from_numpy(ids)).numpy())
    # the master values of a bf16 module are float32
    assert all(a.dtype in (np.float32, np.int64) for a in loaded.raw_params.values())


def test_resnet50_at_32_round_trips_like_the_jax_export(tmp_path):
    from test_torch_image import _perturbed

    x = (np.random.default_rng(1).random((2, 32, 32, 3)) * 255 - 120).astype(np.float32)
    model = jax_resnet.ResNet50()
    variables = jax.tree_util.tree_map(np.asarray, _perturbed(
        jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3))), 5))
    path = str(tmp_path / "resnet50.npz")
    jax_registry.save_flax_weights(variables, path)
    jax_mf = JaxModelFunction(lambda p, b: model.apply(p, b, features_only=True), variables,
                              input_shape=(32, 32, 3), input_dtype=jnp.float32)
    want = _jax_round_trip(jax_mf, str(tmp_path / "jax"), x)
    mf = dataclasses.replace(get_model("ResNet50").model_function(mode="features", weights_file=path,
                                                                  device="cpu"),
                             input_shape=(32, 32, 3))
    mf.export(str(tmp_path / "port"))
    loaded = ModelFunction.load(str(tmp_path / "port"), device="cpu")
    assert loaded.input_shape == (32, 32, 3) and not loaded.takes_nhwc
    got = loaded(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4
    np.testing.assert_array_equal(got, mf(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy())


def test_symbolic_batch_pinned_batch_and_int8(bert_params, tmp_path):
    mf = get_model("bert-tiny").model_function(params=bert_params, device="cpu")
    comp = _text_composite(mf)
    comp.export(str(tmp_path / "sym"))
    loaded = ModelFunction.load(str(tmp_path / "sym"), device="cpu")
    for batch in (2, 8, 1):
        ids = torch.from_numpy(_ids(batch, batch))
        np.testing.assert_array_equal(loaded(ids).numpy(), comp(ids).numpy())
    comp.export(str(tmp_path / "pinned"), batch_size=3)
    pinned = ModelFunction.load(str(tmp_path / "pinned"), device="cpu")
    assert pinned(torch.from_numpy(_ids(3, 3))).shape == (3, 128)
    with pytest.raises(Exception):
        pinned(torch.from_numpy(_ids(4, 4)))
    # the int8-dynamic rung round-trips too: its dequantizing reads trace
    q = _text_composite(int8_rung(get_model("bert-tiny").model_function(params=bert_params, device="cpu")))
    q.export(str(tmp_path / "int8"))
    qload = ModelFunction.load(str(tmp_path / "int8"), device="cpu")
    ids = torch.from_numpy(_ids(5))
    np.testing.assert_array_equal(qload(ids).numpy(), q(ids).numpy())
    assert any(a.dtype == np.int8 for a in qload.raw_params.values())


def test_a_fresh_process_loads_and_runs_the_program(bert_params, tmp_path):
    """``load`` registers the flash op itself: a new interpreter that
    imports nothing else of the port runs the program at two batch sizes."""
    mf = get_model("bert-tiny").model_function(params=bert_params, device="cpu")
    comp = _text_composite(mf)
    path = str(tmp_path / "port")
    comp.export(path)
    ids2, ids8 = _ids(2, 2), _ids(8, 8)
    np.save(str(tmp_path / "ids2.npy"), ids2)
    np.save(str(tmp_path / "ids8.npy"), ids8)
    code = (
        "import sys, numpy as np, torch\n"
        "from sparkdl_tpu_torch.graph.function import ModelFunction\n"
        "assert 'sparkdl_tpu_torch.ops.flash_attention' not in sys.modules\n"
        f"mf = ModelFunction.load({path!r}, device='cpu')\n"
        f"for n in (2, 8):\n"
        f"    ids = torch.from_numpy(np.load({str(tmp_path)!r} + f'/ids{{n}}.npy'))\n"
        f"    np.save({str(tmp_path)!r} + f'/out{{n}}.npy', mf(ids).numpy())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for n, ids in ((2, ids2), (8, ids8)):
        np.testing.assert_array_equal(np.load(str(tmp_path / f"out{n}.npy")),
                                      comp(torch.from_numpy(ids)).numpy())


def test_a_jax_artifact_is_refused_naming_its_roadmap_item(tmp_path):
    """A JAX-written artifact (``program.stablehlo``) loads on the port's
    StableHLO interpreter and matches the JAX ``load``; one lowered for two
    platforms stays refused, naming ROADMAP Queue A item 13."""
    jax_mf = JaxModelFunction(lambda p, v: v * 2.0, None, input_shape=(3,), input_dtype=jnp.float32)
    jax_mf.export(str(tmp_path))
    loaded = ModelIngest.from_exported(str(tmp_path), device="cpu")
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(loaded(torch.from_numpy(x)).numpy(),
                                  np.asarray(JaxModelFunction.load(str(tmp_path))(x)))
    assert loaded.input_shape == (3,) and loaded.input_dtype == torch.float32 and loaded.raw_params is None
    exp = jax.export.export(jax.jit(lambda v: v * 2.0), platforms=("cpu", "cuda"))(
        jax.ShapeDtypeStruct((2, 3), jnp.float32))
    with open(tmp_path / "program.stablehlo", "wb") as f:
        f.write(exp.serialize())
    with pytest.raises(NotImplementedError, match="Queue A item 13"):
        ModelIngest.from_exported(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        ModelFunction.load(str(tmp_path / "nothing"), device="cpu")


def test_export_needs_an_input_shape_and_load_defaults_to_cuda(tmp_path):
    mf = piece(lambda v: v + 1.0)
    with pytest.raises(ValueError, match="input_shape"):
        mf.export(str(tmp_path / "x"))
    dataclasses.replace(mf, input_shape=(2,)).export(str(tmp_path / "ok"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ModelFunction.load(str(tmp_path / "ok"))
