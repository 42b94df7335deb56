"""The port's int8-dynamic serving rung against the JAX package's, on the CPU.

The JAX rung (``graph/precision._quantize_params``) stores every floating
leaf of 256 or more elements as int8 with one symmetric per-tensor scale.
The port (``graph/precision.int8_rung``) must give the same int8 values and
the same scales, exactly, leaf by leaf: for bert-tiny, and for ResNet50 at
32x32 in the unrolled layout and in the flax ``scan_blocks`` layout, where
a stage's stacked identity blocks share one scale. Its outputs then match
the JAX int8 rung at the tolerances of the same models' f32 parity tests
(bert-tiny atol 1e-4, ``test_torch_bert.py``; ResNet50 features relative
1e-4, ``test_torch_image.py``). The small-model checks mirror
``tests/test_mesh_serving.py``'s ``TestApplyPrecision``; the router serves
the rung per SLA class and names it in the reply.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.graph import precision as jax_precision
from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
from sparkdl_tpu.models import bert as jax_bert
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.models import resnet as jax_resnet
from sparkdl_tpu import serving as jax_serving
from sparkdl_tpu_torch import serving
from sparkdl_tpu_torch.graph import precision
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.models import get_model
from sparkdl_tpu_torch.models.convert import bert_params_to_flax, cnn_params_from_flax, cnn_params_to_flax
from sparkdl_tpu_torch.models.registry import param_bytes
from sparkdl_tpu_torch.models.resnet import ResNet50
from sparkdl_tpu_torch.serving import residency
from sparkdl_tpu_torch.utils.metrics import metrics
from test_resnet_scan import _stack_identity_params

BERT_ATOL = 1e-4
RESNET_REL = 1e-4
RESNET_STAGES = [3, 4, 6, 3]


@pytest.fixture(scope="module")
def bert_weights(tmp_path_factory):
    params = jax_bert.bert_tiny().init(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    path = str(tmp_path_factory.mktemp("int8") / "bert_tiny.npz")
    jax_registry.save_flax_weights(params, path)
    return path, params


@pytest.fixture(scope="module")
def resnet_weights(tmp_path_factory):
    """(npz path, unrolled variables, scanned variables) of one seeded
    ResNet50 with non-trivial BatchNorm statistics."""
    from test_torch_image import _perturbed

    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    unrolled = _perturbed(jax.jit(jax_resnet.ResNet50().init)(jax.random.PRNGKey(1), x), 5)
    unrolled = jax.tree_util.tree_map(np.asarray, unrolled)
    scanned = jax.tree_util.tree_map(np.asarray, _stack_identity_params(unrolled, RESNET_STAGES))
    path = str(tmp_path_factory.mktemp("int8") / "resnet50.npz")
    jax_registry.save_flax_weights(unrolled, path)
    return path, unrolled, scanned


def _flat(tree, prefix=()):
    for key, sub in tree.items():
        if hasattr(sub, "items") and not {"q", "raw"} & set(sub):
            yield from _flat(sub, prefix + (key,))
        else:
            yield prefix + (key,), sub


def _jax_packed(variables):
    """The JAX rung's ``{"q", "s"}`` / ``{"raw"}`` leaves, by flax path."""
    packed, treedef = jax_precision._quantize_params(variables)
    return dict(_flat(jax.tree_util.tree_unflatten(treedef, packed)))


def _port_views(module, to_flax):
    """The port's int8 values and scales, each laid out as the flax tree
    (through the converters): a copy of ``module`` holding ``q`` (as
    float) where the rung holds int8, and one holding each tensor's scale
    broadcast, both mapped by ``to_flax``. Unquantized leaves come back as
    their float32 values and NaN scales."""
    q_mod, s_mod = copy.deepcopy(module), copy.deepcopy(module)
    for mod_q, mod_s, mod in zip(q_mod.modules(), s_mod.modules(), module.modules()):
        held = mod.__dict__.get("_int8_held", set())
        for m in (mod_q, mod_s):
            m.__dict__.pop("_int8_held", None)
            m.__class__ = next(c for c in type(m).__mro__ if not issubclass(c, precision._Int8Held))
        for attr in held:
            q, s = mod._buffers[f"{attr}_int8"], mod._buffers[f"{attr}_scale"]
            for m in (mod_q, mod_s):
                m._buffers.pop(f"{attr}_int8")
                m._buffers.pop(f"{attr}_scale")
            mod_q.register_buffer(attr, q.float())
            mod_s.register_buffer(attr, torch.full(q.shape, float(s)))
        for name, t in list(mod._parameters.items()) + [
            (n, b) for n, b in mod._buffers.items() if not n.endswith(("_int8", "_scale"))
        ]:
            if t is not None and t.is_floating_point() and name not in held:
                mod_s._parameters.pop(name, None)
                mod_s._buffers.pop(name, None)
                mod_s.register_buffer(name, torch.full(t.shape, float("nan")))
    return dict(_flat(to_flax(q_mod))), dict(_flat(to_flax(s_mod)))


def _assert_same_quantization(ref, q_tree, s_tree):
    assert set(ref) == set(q_tree) == set(s_tree)
    quantized = 0
    for path, leaf in ref.items():
        if "q" in leaf:
            quantized += 1
            q = np.asarray(leaf["q"])
            assert q.dtype == np.int8
            np.testing.assert_array_equal(q_tree[path].astype(np.int8), q, err_msg=str(path))
            assert np.all(q_tree[path] == q_tree[path].astype(np.int8))
            scales = np.unique(s_tree[path])
            assert scales.tolist() == [np.float32(leaf["s"])], path
        else:
            assert np.isnan(s_tree[path]).all(), path
            np.testing.assert_array_equal(q_tree[path], np.asarray(leaf["raw"]), err_msg=str(path))
    assert quantized


def test_bert_tiny_q_and_s_equal_the_jax_rungs(bert_weights):
    _, params = bert_weights
    mf = precision.int8_rung(get_model("bert-tiny").model_function(mode="embed", params=params, device="cpu"))
    q_tree, s_tree = _port_views(mf.module, bert_params_to_flax)
    ref = _jax_packed(params)
    _assert_same_quantization(ref, q_tree, s_tree)
    # bert-tiny's LayerNorms and biases (128 wide) stay float32
    assert any("raw" in leaf for leaf in ref.values())


@pytest.mark.parametrize("scan_blocks", [False, True], ids=["unrolled", "scan_blocks"])
def test_resnet50_q_and_s_equal_the_jax_rungs(resnet_weights, scan_blocks):
    _, unrolled, scanned = resnet_weights
    module = ResNet50(num_classes=1000)
    module.load_state_dict(cnn_params_from_flax(unrolled, module))
    precision.quantize_module(module.eval(), scan_blocks=scan_blocks)
    q_tree, s_tree = _port_views(module, lambda m: cnn_params_to_flax(m, scan_blocks=scan_blocks))
    ref = _jax_packed(scanned if scan_blocks else unrolled)
    _assert_same_quantization(ref, q_tree, s_tree)
    if scan_blocks:  # one scale per stacked leaf: fewer scales than tensors
        scales = {id(b) for n, b in module.named_buffers(remove_duplicate=False) if n.endswith("_scale")}
        assert len(scales) == sum("q" in leaf for leaf in ref.values())


def test_leaf_groups_stack_a_stages_identity_blocks():
    with torch.device("meta"):
        module = ResNet50()
    flat = precision.leaf_groups(module)
    stacked = precision.leaf_groups(module, scan_blocks=True)
    assert all(len(g) == 1 for g in flat)
    assert sorted(n for g in stacked for n in g) == sorted(n for g in flat for n in g)
    groups = {tuple(g) for g in stacked}
    assert ("stage3_block2.conv1.weight", "stage3_block3.conv1.weight", "stage3_block4.conv1.weight",
            "stage3_block5.conv1.weight", "stage3_block6.conv1.weight") in groups
    assert ("stage1_block1.bn1.running_var",) in groups


def test_bert_tiny_outputs_match_the_jax_int8_rung(bert_weights):
    path, params = bert_weights
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 1000, size=(4, 40)).astype(np.int32)
    ids[1, 20:] = 0
    ids[3, 7:] = 0
    ref = np.asarray(jax_precision.apply_precision(
        jax_registry.get_model("bert-tiny").model_function(mode="embed", weights_file=path),
        "int8-dynamic")(ids))
    mf = precision.int8_rung(get_model("bert-tiny").model_function(mode="embed", params=params, device="cpu"))
    assert mf.name == "bert-tiny[embed]@int8-dynamic" and mf.precision == "int8-dynamic"
    ours = mf(torch.from_numpy(ids)).numpy()
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=BERT_ATOL, rtol=0)


@pytest.mark.parametrize("scan_blocks", [False, True], ids=["unrolled", "scan_blocks"])
def test_resnet50_outputs_match_the_jax_int8_rung(resnet_weights, scan_blocks):
    path, unrolled, scanned = resnet_weights
    x = (np.random.default_rng(1).random((2, 32, 32, 3)) * 255 - 120).astype(np.float32)
    model = jax_resnet.ResNet50(scan_blocks=scan_blocks)
    jax_mf = JaxModelFunction(
        lambda p, b: model.apply(p, b, features_only=True), scanned if scan_blocks else unrolled,
        name="resnet50",
    )
    ref = np.asarray(jax_precision.apply_precision(jax_mf, "int8-dynamic")(x))
    mf = precision.int8_rung(
        get_model("ResNet50").model_function(mode="features", weights_file=path, device="cpu"),
        scan_blocks=scan_blocks,
    )
    ours = mf(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert ours.shape == ref.shape == (2, 2048)
    assert np.abs(ours - ref).max() / np.abs(ref).max() <= RESNET_REL


@pytest.mark.parametrize("name,mode", [("bert-tiny", "embed"), ("ResNet50", "features")])
def test_resident_bytes_equal_the_jax_rungs(name, mode, bert_weights, resnet_weights):
    """The default loader's int8 build holds what the JAX rung's packed
    tree holds (int8 values, 4 bytes per scale, the small leaves in f32),
    and its build is reserved at the float32 estimate."""
    path = bert_weights[0] if name == "bert-tiny" else resnet_weights[0]
    jax_mf = jax_precision.apply_precision(
        jax_registry.get_model(name).model_function(mode=mode, weights_file=path), "int8-dynamic")
    mf = residency._default_loader(name, mode, "int8-dynamic", device="cpu")
    assert mf.precision == "int8-dynamic"
    assert param_bytes(mf) == jax_registry.param_bytes(jax_mf)
    f32 = param_bytes(get_model(name).model_function(mode=mode, device="cpu"))
    assert param_bytes(mf) < f32 / 3.5
    mgr = residency.ResidencyManager(budget_bytes=2**40, device="cpu")
    assert mgr._estimate_bytes(name, "int8-dynamic") == mgr._estimate_bytes(name, "f32")


def test_int8_dequantizes_one_layer_at_a_time():
    """No float32 copy of a weight outlives its layer: the module holds
    only int8 values and scales, and an embedding gathers int8 rows."""
    mf = precision.int8_rung(get_model("bert-tiny").model_function(mode="embed", device="cpu"))
    floating = [n for n, t in mf.module.named_parameters()] + [
        n for n, t in mf.module.named_buffers() if t.is_floating_point() and not n.endswith("_scale")]
    assert all(t.numel() < 256 for n, t in mf.module.named_parameters())
    assert floating  # bert-tiny's 128-wide norms and biases stay f32
    emb = mf.module.embeddings.word_embeddings
    ids = torch.tensor([[5, 7, 0]])
    np.testing.assert_array_equal(emb(ids).numpy(), emb.weight[ids].numpy())
    assert emb.weight.dtype == torch.float32 and "weight" not in emb._parameters


# -- the JAX test's small models (tests/test_mesh_serving.py) -----------------


ROW = 8


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, ROW)).astype(np.float32)


class _Weight(torch.nn.Module):
    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, torch.nn.Parameter(torch.from_numpy(t)))


def test_int8_quarters_params_within_tolerance():
    w = (np.random.default_rng(2).normal(size=(ROW, 64)).astype(np.float32) / 4)
    mf = ModelFunction(lambda m, x: torch.tanh(x @ m.w), _Weight(w=w), torch.device("cpu"),
                       input_shape=(ROW,), name="big")
    wrapped = precision.apply_precision(mf, "int8-dynamic")
    assert wrapped.name == "big@int8-dynamic" and wrapped.precision == "int8-dynamic"
    assert mf.module.w.dtype == torch.float32  # the caller's module is kept
    assert param_bytes(wrapped) < param_bytes(mf) / 3.5
    jax_mf = JaxModelFunction(lambda p, x: jnp.tanh(x @ p), jnp.asarray(w), input_shape=(ROW,), name="big")
    assert param_bytes(wrapped) == jax_registry.param_bytes(jax_precision.apply_precision(jax_mf, "int8-dynamic"))
    x = _rows(16)
    ours = wrapped(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, mf(torch.from_numpy(x)).numpy(), rtol=5e-2, atol=5e-2)
    ref = np.asarray(jax_precision.apply_precision(jax_mf, "int8-dynamic")(x))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_int8_small_leaves_stay_f32():
    small = ModelFunction(lambda m, x: x + m.b, _Weight(b=np.ones(4, np.float32)), torch.device("cpu"), name="bias")
    wrapped = precision.apply_precision(small, "int8-dynamic")
    assert param_bytes(wrapped) == param_bytes(small)
    x = torch.from_numpy(_rows(2, seed=1)[:, :4].copy())
    np.testing.assert_array_equal(wrapped(x).numpy(), small(x).numpy())


def test_int8_rung_keeps_integer_inputs_and_is_idempotent():
    ids = torch.arange(6, dtype=torch.int32).view(2, 3)
    ident = precision.apply_precision(
        ModelFunction(lambda m, x: x, torch.nn.Module(), torch.device("cpu"), name="id"), "int8-dynamic")
    assert ident(ids).dtype == torch.int32  # inputs are never cast
    assert precision.apply_precision(ident, "int8-dynamic") is ident
    with pytest.raises(ValueError, match="precision"):
        precision.apply_precision(ident, "int4")


@pytest.mark.parametrize("env", [
    {"SPARKDL_SERVE_PRECISION": "int8-dynamic"},
    {"SPARKDL_SERVE_PRECISION_BACKGROUND": "int8-dynamic"},
    {"SPARKDL_SERVE_PRECISION": "int8-dynamic", "SPARKDL_SERVE_PRECISION_INTERACTIVE": "f32"},
], ids=["global", "background", "override"])
def test_serve_precision_selects_int8_as_jax_does(env, monkeypatch):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for cls in (None, "interactive", "batch", "background"):
        assert precision.serve_precision(cls) == jax_precision.serve_precision(cls)
    assert precision.PRECISIONS == jax_precision.PRECISIONS


# -- the router ---------------------------------------------------------------


def test_router_serves_int8_per_class_and_names_the_rung(bert_weights, monkeypatch):
    """Background requests ride the int8 rung, interactive ones f32, in
    both packages; rows equal the JAX router's and the rung's own build,
    and the per-rung metrics count them."""
    path, params = bert_weights
    metrics.reset()
    monkeypatch.setenv("SPARKDL_SERVE_PRECISION_BACKGROUND", "int8-dynamic")
    rng = np.random.default_rng(4)
    requests = []
    for i in range(6):
        ids = rng.integers(4, 1000, size=(1 + i % 3, 8 + 4 * i)).astype(np.int32)
        requests.append((ids, ("interactive", "background")[i % 2]))
    loaders = {
        "torch": lambda name, mode: get_model(name).model_function(mode=mode, params=params, device="cpu"),
        "jax": lambda name, mode: jax_registry.get_model(name).model_function(mode=mode, weights_file=path),
    }

    def run(mod, loader, **kwargs):
        router = mod.Router(loader=loader, **kwargs)
        try:
            reqs = [router.submit("bert-tiny", ids, priority=cls, mode="embed") for ids, cls in requests]
            return [(r.precision, r.result(timeout=300)) for r in reqs], router.stats()
        finally:
            router.close()

    (ours, stats) = run(serving, loaders["torch"], device="cpu")
    (ref, _) = run(jax_serving, loaders["jax"])
    int8 = precision.int8_rung(loaders["torch"]("bert-tiny", "embed"))
    for (ids, cls), (rung, a), (rung_ref, b) in zip(requests, ours, ref):
        assert rung == rung_ref == ("int8-dynamic" if cls == "background" else "f32")
        np.testing.assert_allclose(a, b, atol=BERT_ATOL, rtol=0)
        if cls == "background":
            np.testing.assert_allclose(a, int8(torch.from_numpy(ids)).numpy(), atol=BERT_ATOL, rtol=0)
    assert stats["precision"]["int8-dynamic"]["requests"] == 3
