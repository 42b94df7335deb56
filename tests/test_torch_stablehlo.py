"""The port's StableHLO reader and interpreter against jaxlib and
``jax.export``, on the CPU.

- **The bytecode reader** (``graph/mlir_bytecode.py``): for every
  committed artifact and a tiny ``jax.export`` program per op family
  (convolution dimension numbers and a shape assertion among them), the
  functions, their visibility and signatures, and every function's ops in
  order equal those of jaxlib's ``deserialize_portable_artifact`` text;
  every op's attribute names, and its integer, string, boolean, enum and
  integer-tensor values, equal jaxlib's generic print of the same VHLO
  bytes.
- **The interpreter** (``graph/stablehlo.py``): the same seeded numpy
  inputs through ``Exported.call`` and ``Program``, f32 ``rtol=1e-5,
  atol=1e-6`` (exact for integers and booleans), at two batch sizes.
- **The JAX package's exports** (``graph/jax_exported.py``): ResNet50 at
  32x32 exported here and the committed bert-tiny, loaded by the port's
  ``ModelFunction.load(device="cpu")`` against the JAX ``load`` at two
  and three batch sizes (relative 1e-5); an empty batch raises the shape
  assertion's message, as JAX does.
- **Refusals**, each naming ROADMAP item 13: a VHLO version outside the
  range read, another bytecode version, ``tpu_custom_call``, a program
  lowered for two platforms, a region body that is not one reduction, an
  op outside the table.
"""

import collections
import gc
import os
import re
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax._src.interpreters import mlir as jmlir
from jax._src.lib import _jax
from jax._src.lib.mlir import ir

from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
from sparkdl_tpu.models import resnet as jax_resnet
from sparkdl_tpu_torch.graph import tf_proto
from sparkdl_tpu_torch.graph.function import ModelFunction, StableHLOModule
from sparkdl_tpu_torch.graph.jax_exported import UnsupportedExportError, read_exported, read_params
from sparkdl_tpu_torch.graph.mlir_bytecode import UnsupportedBytecodeError, read_module
from sparkdl_tpu_torch.graph.stablehlo import Program, ShapeAssertionError, UnsupportedStableHLOError

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
ITEM = "ROADMAP Queue A item 13"
B = jax.export.symbolic_shape("b")[0]


def _conv(dn, strides=(1, 1), padding=((1, 1), (0, 2)), lhs_dil=(1, 1), rhs_dil=(1, 1), groups=1):
    def f(x):
        lhs_spec, rhs_spec, _ = dn
        x4 = jnp.concatenate([x, x], axis=-1).reshape(x.shape[0], 3, 4, 2)  # [b, 3, 4, 2] "NHWC"
        if lhs_spec == "NCHW":
            x4 = jnp.transpose(x4, (0, 3, 1, 2))
        shape = (3, 2, 2 // groups, 6) if rhs_spec == "HWIO" else (6, 2 // groups, 3, 2)
        k = (jnp.arange(np.prod(shape), dtype=jnp.float32) % 7).reshape(shape) / 10.0 - 0.3
        return [lax.conv_general_dilated(x4, k, strides, padding, lhs_dilation=lhs_dil, rhs_dilation=rhs_dil,
                                         dimension_numbers=dn, feature_group_count=groups)]
    return f


PROGRAMS = {
    "unary": lambda x: [jnp.abs(x), -x, jnp.exp(x), jnp.log(jnp.abs(x) + 1), jnp.log1p(jnp.abs(x)),
                        jnp.expm1(x), jnp.tanh(x), jax.nn.sigmoid(x), jnp.sqrt(jnp.abs(x)), lax.rsqrt(jnp.abs(x) + 1),
                        jnp.sin(x), jnp.cos(x), jnp.floor(x), jnp.ceil(x), jnp.round(x), jnp.sign(x), lax.erf(x),
                        jnp.isfinite(x), jnp.cbrt(x), jax.nn.gelu(x, approximate=False)],
    "binary": lambda x: [x + x, x - 1, x * x, x / 2, jnp.maximum(x, 0), jnp.minimum(x, 0),
                         jnp.power(jnp.abs(x), 1.5), jnp.remainder(x, 2.0), jnp.arctan2(x, x + 1),
                         lax.clamp(-0.5, x, 0.5)],
    "int_bool": lambda x: [(x > 0) & (x < 1), (x > 0) | (x < 1), (x > 0) ^ (x < 1), ~(x > 0), jnp.where(x > 0, x, 0),
                           (x * 10).astype(jnp.int32) % 3, (x * 10).astype(jnp.int32) // 3,
                           (x * 10).astype(jnp.int32).astype(jnp.float32), x.astype(jnp.bfloat16).astype(jnp.float32)],
    "shape": lambda x: [x.reshape(x.shape[0], -1), jnp.transpose(x, (0, 2, 1)), jnp.concatenate([x, x], 1),
                        x[:, 1:3, ::2], jnp.pad(x, ((0, 0), (1, 2), (0, 1))),
                        lax.pad(x, 0.5, ((0, 0, 0), (1, -1, 1), (0, 0, 0))), jnp.flip(x, 1),
                        lax.broadcasted_iota(jnp.int32, (3, 4), 1), jnp.broadcast_to(x[:, :1], x.shape)],
    "dot": lambda x: [x @ jnp.ones((4, 5)), jnp.einsum("bij,bkj->bik", x, x), jnp.einsum("bij,j->bi", x, jnp.arange(4.0))],
    "reduce": lambda x: [x.sum(1), x.max((1, 2)), x.min(2), x.prod(1), jnp.all(x > 0, 1), jnp.any(x > 0, 2),
                         x.mean(), jax.nn.softmax(x, axis=-1)],
    "window": lambda x: [lax.reduce_window(x, -jnp.inf, lax.max, (1, 2, 2), (1, 1, 2), "SAME"),
                         lax.reduce_window(x, 0.0, lax.add, (1, 3, 1), (1, 1, 1), ((0, 0), (1, 1), (0, 0))),
                         lax.reduce_window(x, jnp.inf, lax.min, (1, 2, 3), (1, 1, 1), "VALID", window_dilation=(1, 2, 1))],
    "gather": lambda x: [jnp.take(x, jnp.array([2, 0]), axis=1), x[:, jnp.array([1, 2])],
                         lax.dynamic_slice(x, (0, 1, 1), (1, 2, 2)),
                         lax.dynamic_update_slice(x, jnp.ones((1, 2, 2)), (0, 1, 1)),
                         jnp.take(jnp.arange(40.0).reshape(10, 4), (jnp.abs(x) * 3).astype(jnp.int32)[:, 0, :], axis=0)],
    "conv_nhwc": _conv(("NHWC", "HWIO", "NHWC")),
    "conv_nchw_strided": _conv(("NCHW", "OIHW", "NCHW"), strides=(2, 1), padding=((0, 1), (2, 0))),
    "conv_dilated_grouped": _conv(("NHWC", "HWIO", "NHWC"), lhs_dil=(2, 1), rhs_dil=(1, 2), groups=2,
                                  padding=((2, 1), (1, 1))),
    "conv_to_nchw_out": _conv(("NHWC", "HWIO", "NCHW"), padding="SAME"),
}


@pytest.fixture(scope="module")
def exported():
    """``{family: jax.export.Exported}`` over a symbolic batch of [b, 3, 4] f32."""
    spec = jax.ShapeDtypeStruct((B, 3, 4), jnp.float32)
    return {name: jax.export.export(jax.jit(f))(spec) for name, f in PROGRAMS.items()}


@pytest.fixture(scope="module")
def keras3_module():
    saved = tf_proto.parse("SavedModel", open(os.path.join(FIXTURES, "keras3_resnet50", "saved_model.pb"), "rb").read())
    for fd in saved.meta_graphs[0].graph_def.library.function:
        for node in fd.node_def:
            if node.op == "XlaCallModule":
                return node.attr["module"].s
    raise AssertionError("the keras-3 fixture holds no XlaCallModule")


@pytest.fixture(scope="module")
def bert_module():
    with open(os.path.join(FIXTURES, "jax_bert_tiny", "program.stablehlo"), "rb") as f:
        return read_exported(f.read()).mlir_module_serialized


# -- the reader against jaxlib ------------------------------------------------------


def _walk(op, out):
    for region in op.regions:
        for block in region.blocks:
            for o in block.operations:
                out.append(o.operation)
                _walk(o.operation, out)
    return out


def _jaxlib_funcs(module_bytes):
    """``{name: (visibility, input types, result types, [op names in order])}``
    from jaxlib's upgraded text of the artifact."""
    text = _jax.mlir.deserialize_portable_artifact(module_bytes)
    out = {}
    with jmlir.make_ir_context():
        m = ir.Module.parse(text)
        for f in m.body.operations:
            f = f.operation
            name = ir.StringAttr(f.attributes["sym_name"]).value
            vis = ir.StringAttr(f.attributes["sym_visibility"]).value if "sym_visibility" in f.attributes else "public"
            ftype = ir.FunctionType(ir.TypeAttr(f.attributes["function_type"]).value)
            out[name] = (vis, [str(t) for t in ftype.inputs], [str(t) for t in ftype.results],
                         [o.name for o in _walk(f, [])])
    return out


def _vhlo_ops(module_bytes):
    """Every op of the raw VHLO bytes in order, as jaxlib prints it:
    ``[(name, {attribute: text})]``."""
    out = []
    with jmlir.make_ir_context():
        m = ir.Module.parse(module_bytes)
        for f in m.body.operations:
            for o in [f.operation] + _walk(f.operation, []):
                attrs = {}
                for a in o.attributes:
                    name = a if isinstance(a, str) else a.name
                    attrs[name] = str(o.attributes[name])
                out.append((o.name, attrs))
    return out


def _mine(module):
    return [op for fn in module.funcs.values() for op in [_func_op(fn)] + list(_ops_of(fn.body))]


def _func_op(fn):
    return ("vhlo.func_v1", {"sym_name": fn.name, "sym_visibility": fn.visibility, "arg_attrs": fn.arg_attrs,
                             "res_attrs": fn.res_attrs, "function_type": fn.type})


def _ops_of(region):
    for block in region.blocks:
        for op in block.ops:
            yield (op.vhlo, op.attrs)
            for r in op.regions:
                yield from _ops_of(r)


_INT = re.compile(r"^#vhlo\.integer_v1<(-?\d+) : !vhlo\.\w+>$")
_STR = re.compile(r'^#vhlo\.string_v1<"(.*)">$', re.S)
_BOOL = re.compile(r"^#vhlo\.bool_v1<(true|false)>$")
_ENUM = re.compile(r"^#vhlo<\w+_v1 (\w+)>$")
_DENSE_INT = re.compile(r"^#vhlo\.tensor_v1<dense<(.*)> : tensor<([\dx]*)i(?:64|32|1)>>$", re.S)


def _check_value(mine, text: str) -> bool:
    """``mine`` against jaxlib's text of the same attribute, where the
    text's kind is one these tests read; True where unchecked."""
    if m := _INT.match(text):
        return mine == int(m.group(1))
    if m := _STR.match(text):
        return "\\" in m.group(1) or mine == m.group(1)
    if m := _BOOL.match(text):
        return mine is (m.group(1) == "true")
    if m := _ENUM.match(text):
        return mine == m.group(1)
    if m := _DENSE_INT.match(text):
        body = m.group(1).replace("true", "1").replace("false", "0")
        values = [int(v) for v in re.findall(r"-?\d+", body)]
        flat = np.asarray(mine).astype(np.int64).reshape(-1)
        return list(flat) == values if len(values) == flat.size or not flat.size else set(flat) == set(values)
    return True


def _hold_against_jaxlib(module_bytes):
    module = read_module(module_bytes)
    want = _jaxlib_funcs(module_bytes)
    assert list(module.funcs) == list(want)
    for name, fn in module.funcs.items():
        vis, ins, outs, ops = want[name]
        assert fn.visibility == vis
        assert [str(t) for t in fn.type.inputs] == ins and [str(t) for t in fn.type.results] == outs
        assert [op.name for op in _walk_mine(fn.body)] == ops
    raw = [(n, a) for n, a in _vhlo_ops(module_bytes) if n != "builtin.module"]
    mine = _mine(module)
    assert [n for n, _ in mine] == [n for n, _ in raw]
    checked = 0
    for (name, attrs), (_, texts) in zip(mine, raw):
        assert set(attrs) == set(texts), name
        for key, text in texts.items():
            assert _check_value(attrs[key], text), (name, key, attrs[key], text)
            checked += 1
    return module, checked


def _walk_mine(region):
    for block in region.blocks:
        for op in block.ops:
            yield op
            for r in op.regions:
                yield from _walk_mine(r)


@pytest.mark.parametrize("target", ["jax", "1.0.0"])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_reader_matches_jaxlib_on_each_op_family(exported, name, target):
    """At the VHLO version ``jax.export`` writes, and at 1.0.0 (the ops'
    older forms: ``tanh_v1``, ``dot_general_v1``, ``gather_v1``)."""
    data = exported[name].mlir_module_serialized
    if target != "jax":
        data = _jax.mlir.serialize_portable_artifact(_jax.mlir.deserialize_portable_artifact(data), target)
    module, checked = _hold_against_jaxlib(data)
    assert module.producer.startswith("StableHLO_v1.") and module.bytecode_version == 6
    assert checked > 0
    if target != "jax":  # and the older forms run
        x = np.random.default_rng(0).standard_normal((2, 3, 4)).astype(np.float32)
        for w, g in zip(exported[name].call(x), Program(module, "cpu")(torch.from_numpy(x))):
            g = g.float() if g.dtype == torch.bfloat16 else g
            np.testing.assert_allclose(g.numpy().astype(np.float64), np.asarray(w).astype(np.float64),
                                       rtol=1e-5, atol=1e-6)


def test_reader_matches_jaxlib_on_the_committed_artifacts(keras3_module, bert_module):
    module, _ = _hold_against_jaxlib(keras3_module)
    counts = collections.Counter(op.name for op in module.walk())
    # the keras-3 export: 320 weights then the image, 107 outputs, 53 convs
    main = module.funcs["main"]
    assert len(main.type.inputs) == 321 and str(main.type.inputs[-1]) == "tensor<?x224x224x3xf32>"
    assert len(main.type.results) == 107
    assert counts["stablehlo.convolution"] == 53 and counts["stablehlo.dynamic_broadcast_in_dim"] == 175
    assert module.attrs["jax.uses_shape_polymorphism"] is True
    module, _ = _hold_against_jaxlib(bert_module)
    assert [str(t) for t in module.funcs["main"].type.inputs] == ["tensor<?x32xi32>"]


def test_dense_values_bf16_and_i1(exported):
    module = read_module(exported["int_bool"].mlir_module_serialized)
    text = _jax.mlir.deserialize_portable_artifact(exported["int_bool"].mlir_module_serialized)
    assert "bf16" in text
    src = "module { func.func public @main() -> (tensor<9xi1>, tensor<2xbf16>, tensor<2x3xf32>) {\n" \
          "%a = stablehlo.constant dense<[true, false, true, true, false, false, true, true, true]> : tensor<9xi1>\n" \
          "%b = stablehlo.constant dense<[1.5, -2.0]> : tensor<2xbf16>\n" \
          "%c = stablehlo.constant dense<1.25> : tensor<2x3xf32>\n" \
          "return %a, %b, %c : tensor<9xi1>, tensor<2xbf16>, tensor<2x3xf32> } }"
    m = read_module(_jax.mlir.serialize_portable_artifact(src, "1.13.4"))
    consts = [op.attrs["value"] for op in m.walk() if op.name == "stablehlo.constant"]
    np.testing.assert_array_equal(consts[0], [1, 0, 1, 1, 0, 0, 1, 1, 1])
    np.testing.assert_array_equal(consts[1], [1.5, -2.0])
    np.testing.assert_array_equal(consts[2], np.full((2, 3), 1.25, np.float32))
    out = Program(m, "cpu")()
    assert out[0].dtype == torch.bool and out[1].dtype == torch.bfloat16 and out[2].shape == (2, 3)
    assert module.funcs


# -- the interpreter against jax.export ---------------------------------------------------


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_interpreter_matches_jax_export(exported, name):
    exp = exported[name]
    program = Program(read_module(exp.mlir_module_serialized), "cpu")
    for n in (2, 5):
        x = np.random.default_rng(n).standard_normal((n, 3, 4)).astype(np.float32)
        want = exp.call(x)
        got = program(torch.from_numpy(x))
        assert len(got) == len(want)
        for w, g in zip(want, got):
            w = np.asarray(w)
            g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
            assert g.shape == w.shape
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w.astype(np.float32), rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("padding, reducer, init", [
    ("SAME", lax.max, -jnp.inf), ("VALID", lax.max, -jnp.inf), (((0, 0), (1, 2), (0, 1), (0, 0)), lax.min, jnp.inf),
], ids=["max_same", "max_valid", "min_padded"])
def test_select_and_scatter_matches_jax_export(padding, reducer, init):
    """The gradient of a max or min pool: ``select_and_scatter`` with a GE or
    LE select body and an add scatter body; a tie picks the first."""
    def f(x):
        return jax.grad(lambda y: (lax.reduce_window(y, init, reducer, (1, 3, 2, 1), (1, 2, 2, 1), padding) ** 2).sum())(x)

    exp = jax.export.export(jax.jit(f))(jax.ShapeDtypeStruct((2, 7, 6, 3), jnp.float32))
    module = read_module(exp.mlir_module_serialized)
    assert any(op.name == "stablehlo.select_and_scatter" for op in module.walk())
    x = np.random.default_rng(0).standard_normal((2, 7, 6, 3)).astype(np.float32)
    x[0, 0, 0, 0] = x[0, 0, 1, 0]
    got = Program(module, "cpu")(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, np.asarray(exp.call(x)), rtol=1e-5, atol=1e-6)


def test_a_ragged_batch_raises_the_shape_assertion():
    exp = jax.export.export(jax.jit(lambda x, y: x * 2 + y))(
        jax.ShapeDtypeStruct((B, 4), jnp.float32), jax.ShapeDtypeStruct((B, 4), jnp.float32))
    program = Program(read_module(exp.mlir_module_serialized), "cpu")
    x, y = np.ones((2, 4), np.float32), np.ones((3, 4), np.float32)
    with pytest.raises(ValueError) as jax_err:
        exp.call(x, y)
    with pytest.raises(ShapeAssertionError) as err:
        program(torch.from_numpy(x), torch.from_numpy(y))
    assert str(err.value) in str(jax_err.value)
    assert "args[1].shape[0] (= 3)" in str(err.value) or "= 3" in str(err.value)
    np.testing.assert_array_equal(program(torch.from_numpy(x), torch.from_numpy(x))[0].numpy(), x * 3)


def test_values_of_unchanged_weights_are_kept_and_a_change_recomputes_them():
    """A static-shaped argument (a keras-3 export's weight) is call-invariant
    while the same tensor comes unchanged: its BatchNorm-style scale is
    computed once; writing the tensor in place, or passing another,
    recomputes it."""
    def f(w, g, x):
        scale = lax.rsqrt(w + 1.0) * g
        return [x * scale[None, :]]

    exp = jax.export.export(jax.jit(f))(jax.ShapeDtypeStruct((4,), jnp.float32), jax.ShapeDtypeStruct((4,), jnp.float32),
                                        jax.ShapeDtypeStruct((B, 4), jnp.float32))
    program = Program(read_module(exp.mlir_module_serialized), "cpu")
    rng = np.random.default_rng(0)
    w, g = torch.from_numpy(rng.random(4).astype(np.float32)), torch.from_numpy(rng.random(4).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))

    def check():
        want = np.asarray(exp.call(w.numpy(), g.numpy(), x.numpy())[0])
        np.testing.assert_allclose(program(w, g, x)[0].numpy(), want, rtol=1e-6)

    check()
    plans = [p for p in program._plans.values() if p.static]
    assert plans and all(p._cache is not None for p in plans)
    check()  # a hit
    w.mul_(2.0)  # in place: the version moves
    check()
    g = g + 1.0  # another tensor
    check()
    x = torch.ones(5, 4)  # the varying argument never keys the cache
    check()
    with torch.inference_mode():  # an inference tensor written in place is read again
        w = w.clone()
        check()
        w.mul_(3.0)
        check()
    ref = weakref.ref(g)
    del g  # the kept values hold no argument: a dropped weight is freed
    gc.collect()
    assert ref() is None


def test_threads_sharing_a_program_never_mix_kept_values():
    """Sixteen threads call one program at batch sizes 1 to 4 at once, with
    a short switch interval: each result is its own batch's, so no thread
    pairs its key with another's kept values."""
    import sys
    import threading

    def f(w, x):
        return [x * lax.rsqrt(w + 1.0)[None, :] + jnp.float32(x.shape[0])]

    exp = jax.export.export(jax.jit(f))(jax.ShapeDtypeStruct((4,), jnp.float32), jax.ShapeDtypeStruct((B, 4), jnp.float32))
    program = Program(read_module(exp.mlir_module_serialized), "cpu")
    w = torch.from_numpy(np.random.default_rng(1).random(4).astype(np.float32))
    xs = {n: torch.from_numpy(np.random.default_rng(n).standard_normal((n, 4)).astype(np.float32)) for n in range(1, 5)}
    want = {n: np.asarray(exp.call(w.numpy(), x.numpy())[0]) for n, x in xs.items()}
    bad = []

    def worker(i):
        for j in range(60):
            n = 1 + (i + j) % 4
            got = program(w, xs[n])[0].numpy()
            if got.shape != want[n].shape or not np.allclose(got, want[n], rtol=1e-6):
                bad.append((i, j, n))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad, bad[:5]


# -- the JAX package's exported programs --------------------------------------------------


@pytest.fixture(scope="module")
def resnet_export(tmp_path_factory):
    model = jax_resnet.ResNet50()
    variables = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    mf = JaxModelFunction(lambda p, b: model.apply(p, b, features_only=True), variables,
                          input_shape=(32, 32, 3), input_dtype=jnp.float32)
    path = str(tmp_path_factory.mktemp("r50") / "export")
    mf.export(path)
    return path


@pytest.mark.parametrize("which", ["resnet50_32", "bert_tiny"])
def test_jax_exports_load_and_match_the_jax_load(resnet_export, which):
    if which == "resnet50_32":
        path = resnet_export
        make = lambda n: (np.random.default_rng(n).random((n, 32, 32, 3)) * 255 - 120).astype(np.float32)  # noqa: E731
    else:
        path = os.path.join(FIXTURES, "jax_bert_tiny")
        make = lambda n: np.random.default_rng(n).integers(0, 1000, (n, 32)).astype(np.int32)  # noqa: E731
    jax_mf = JaxModelFunction.load(path)
    mf = ModelFunction.load(path, device="cpu")
    assert isinstance(mf.module, StableHLOModule) and mf.device == torch.device("cpu")
    assert mf.input_shape == jax_mf.input_shape and mf.name == jax_mf.name
    assert mf.takes_nhwc == (which == "resnet50_32")
    assert str(mf.input_dtype).replace("torch.", "") == str(jax_mf.input_dtype)
    # the batch is symbolic; each new batch size costs JAX a compile of the
    # program and its baked-in weights, so ResNet50 takes two
    for n in {"resnet50_32": (2, 5), "bert_tiny": (1, 3, 6)}[which]:
        x = make(n)
        want = np.asarray(jax_mf(x))
        got = mf(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError) as jax_err:
        jax_mf(make(0))
    with pytest.raises(ShapeAssertionError) as err:
        mf(torch.from_numpy(make(0)))
    assert str(err.value) in str(jax_err.value) and "Expected value >= 1 for dimension variable 'b'" in str(err.value)
    # raw_params as the JAX load fills them
    assert jax.tree_util.tree_structure(mf.raw_params) == jax.tree_util.tree_structure(jax_mf.raw_params)
    for a, b in zip(jax.tree_util.tree_leaves(mf.raw_params), jax.tree_util.tree_leaves(jax_mf.raw_params)):
        np.testing.assert_array_equal(a, b)


def test_the_committed_bert_tiny_matches_its_stored_jax_outputs():
    path = os.path.join(FIXTURES, "jax_bert_tiny")
    io = np.load(os.path.join(path, "io.npz"))
    mf = ModelFunction.load(path, device="cpu")
    np.testing.assert_allclose(mf(torch.from_numpy(io["ids"])).numpy(), io["y"], rtol=0, atol=1e-5)
    meta = read_params(os.path.join(path, "params.pkl"))
    assert meta["input_shape"] == (32,) and meta["input_dtype"] == "int32"


def test_params_pkl_unpickles_numpy_only(tmp_path):
    import pickle

    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump({"params": {"w": np.ones(2)}, "input_shape": (2,), "input_dtype": "float32", "name": "x",
                     "evil": Evil()}, f)
    with pytest.raises(pickle.UnpicklingError, match="posix.system|os.system|only numpy"):
        read_params(str(tmp_path / "params.pkl"))


# -- refusals -------------------------------------------------------------------------------

_TANH = "module { func.func public @main(%a: tensor<2xf32>) -> tensor<2xf32> {\n" \
        "%b = stablehlo.tanh %a : tensor<2xf32>\n return %b : tensor<2xf32> } }"


def test_refuses_an_unknown_vhlo_version():
    b = _jax.mlir.serialize_portable_artifact(_TANH, "0.9.0")
    with pytest.raises(UnsupportedBytecodeError, match=r"VHLO version 0\.9\.0.*" + ITEM):
        read_module(b)
    assert read_module(_jax.mlir.serialize_portable_artifact(_TANH, "1.0.0")).vhlo_version == (1, 0, 0)


def test_refuses_another_bytecode_version():
    b = bytearray(_jax.mlir.serialize_portable_artifact(_TANH, "1.13.4"))
    assert b[4] == (6 << 1) | 1
    b[4] = (5 << 1) | 1
    with pytest.raises(UnsupportedBytecodeError, match="bytecode version 5.*" + ITEM):
        read_module(bytes(b))


def test_refuses_a_tpu_custom_call():
    src = "module { func.func public @main(%a: tensor<2xf32>) -> tensor<2xf32> {\n" \
          "%b = stablehlo.custom_call @tpu_custom_call(%a) {backend_config = \"\"} : (tensor<2xf32>) -> tensor<2xf32>\n" \
          "return %b : tensor<2xf32> } }"
    module = read_module(_jax.mlir.serialize_portable_artifact(src, "1.13.4"))
    with pytest.raises(UnsupportedStableHLOError, match="custom_call @tpu_custom_call.*" + ITEM):
        Program(module, "cpu")


def test_refuses_a_multi_platform_export(tmp_path):
    exp = jax.export.export(jax.jit(lambda x: x * 2), platforms=("cpu", "cuda"))(jax.ShapeDtypeStruct((B, 3), jnp.float32))
    with pytest.raises(UnsupportedExportError, match="several platforms.*" + ITEM):
        read_exported(exp.serialize())
    main = read_module(exp.mlir_module_serialized).funcs["main"]
    assert len(main.type.inputs) == 2  # the platform index, then x


def test_refuses_a_region_body_that_is_not_one_reduction():
    exp = jax.export.export(jax.jit(lambda x: lax.reduce(x, 0.0, lambda a, b: a * 2.0 + b, (1,))))(
        jax.ShapeDtypeStruct((2, 3), jnp.float32))
    with pytest.raises(UnsupportedStableHLOError, match=r"a stablehlo\.reduce body of .*" + ITEM):
        Program(read_module(exp.mlir_module_serialized), "cpu")
    exp = jax.export.export(jax.jit(lambda x: jnp.argmax(x, axis=1)))(jax.ShapeDtypeStruct((2, 3), jnp.float32))
    with pytest.raises(UnsupportedStableHLOError, match="reduce.*" + ITEM):
        Program(read_module(exp.mlir_module_serialized), "cpu")


def test_refuses_an_op_outside_the_table():
    exp = jax.export.export(jax.jit(lambda x: jnp.sort(x, axis=1)))(jax.ShapeDtypeStruct((2, 3), jnp.float32))
    with pytest.raises(UnsupportedBytecodeError, match=r"op vhlo\.sort_v1.*" + ITEM):
        read_module(exp.mlir_module_serialized)
