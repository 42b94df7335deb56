"""The port's TF GraphDef translator against the JAX package's, on the CPU.

One case per op of the JAX translator's table (JAX
``sparkdl_tpu/graph/tf_import.py`` ``_make_table``; ``XlaCallModule``,
which the port refuses, has its own test), each a graph traced by TF from
``tf.raw_ops`` with seeded numpy inputs: the same GraphDef bytes go through
the JAX ``translate_graph_def`` (over TF's proto) and the port's (over its
own decoder), and the outputs must agree, float32 within 1e-5 and integers
and booleans exactly. Beside them: NCHW layouts, ``If``/``While``,
``PartitionedCall`` with named outputs, the registry hooks, the refusals
and their text, host-value semantics, liveness, the lifted weights' names
and layouts.
"""

from typing import Callable, NamedTuple, Tuple

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from sparkdl_tpu.graph import tf_import as jax_tf_import  # noqa: E402
from sparkdl_tpu_torch.graph import tf_import, tf_proto  # noqa: E402
from sparkdl_tpu_torch.graph.tf_import import (  # noqa: E402
    UnsupportedTFOpError,
    load_translated_params,
    register_tf_op,
    translate_graph_def,
    unregister_tf_op,
)

raw = tf.raw_ops
F32, I32, I64, BOOL = tf.float32, tf.int32, tf.int64, tf.bool


class In(NamedTuple):
    shape: Tuple[int, ...]
    dtype: object = F32
    kind: str = "normal"  # normal | pos | unit | int | bool | half


class Case(NamedTuple):
    id: str
    op: str
    fn: Callable
    inputs: Tuple[In, ...]


def _value(rng, spec: In) -> np.ndarray:
    if spec.kind == "bool":
        return rng.integers(0, 2, spec.shape).astype(bool)
    if spec.kind == "int":
        return rng.integers(-7, 8, spec.shape).astype(spec.dtype.as_numpy_dtype)
    if spec.kind == "nonzero":
        v = rng.integers(1, 5, spec.shape) * rng.choice([-1, 1], spec.shape)
        return v.astype(spec.dtype.as_numpy_dtype)
    if spec.kind == "pos":
        return rng.uniform(0.5, 2.0, spec.shape).astype(np.float32)
    if spec.kind == "unit":
        return rng.uniform(-0.9, 0.9, spec.shape).astype(np.float32)
    if spec.kind == "half":  # values on and between halves, for rounding
        return (rng.integers(-8, 9, spec.shape) / 2.0 + rng.choice([0.0, 0.1], spec.shape)).astype(np.float32)
    if spec.kind == "special":
        v = rng.normal(size=spec.shape).astype(np.float32)
        v.reshape(-1)[:3] = [np.inf, -np.inf, np.nan]
        return v
    return rng.normal(size=spec.shape).astype(np.float32)


def _c(value, dtype=np.float32):
    return tf.constant(np.asarray(value, dtype))


_RNG = np.random.default_rng(123)
K33 = (_RNG.normal(size=(3, 3, 3, 4)) * 0.3).astype(np.float32)
KDW = (_RNG.normal(size=(3, 3, 3, 2)) * 0.3).astype(np.float32)
BN = [np.abs(_RNG.normal(1, 0.2, 4)).astype(np.float32) for _ in range(4)]
IMG = In((2, 8, 8, 3))
IMG4 = In((2, 8, 8, 4))
V = In((3, 4))


def _bn(op, fmt="NHWC"):
    # constants made while tracing are Const nodes (made outside, captures)
    return lambda x: getattr(raw, op)(x=x, scale=_c(BN[0]), offset=_c(BN[1]), mean=_c(BN[2]),
                                       variance=_c(BN[3]), epsilon=1e-3, is_training=False, data_format=fmt)[0]


def _pool(op, ksize, strides, padding, fmt="NHWC"):
    if op == "AvgPool":
        return lambda x: raw.AvgPool(value=x, ksize=ksize, strides=strides, padding=padding, data_format=fmt)
    return lambda x: raw.MaxPool(input=x, ksize=ksize, strides=strides, padding=padding, data_format=fmt)


def _binary(op, kind="normal", dtype=F32):
    return Case(op, op, lambda a, b: getattr(raw, op)(x=a, y=b), (In((3, 4), dtype, kind), In((4,), dtype, kind)))


def _unary(op, kind="normal", arg="x", dtype=F32):
    return Case(op, op, lambda a: getattr(raw, op)(**{arg: a}), (In((3, 4), dtype, kind),))


def _reduction(op, kind="normal", dtype=F32, keep=False):
    return Case(op + ("-keep" if keep else ""), op,
                lambda a: getattr(raw, op)(input=a, axis=_c([1, 2], np.int32), keep_dims=keep),
                (In((2, 3, 4), dtype, kind),))


CASES = [
    # linear algebra
    Case("MatMul", "MatMul", lambda a, b: raw.MatMul(a=a, b=b, transpose_b=True), (In((3, 4)), In((5, 4)))),
    Case("MatMul-transpose_a", "MatMul", lambda a, b: raw.MatMul(a=a, b=b, transpose_a=True), (In((4, 3)), In((4, 5)))),
    Case("BatchMatMul", "BatchMatMul", lambda a, b: raw.BatchMatMul(x=a, y=b, adj_y=True), (In((2, 3, 4)), In((2, 5, 4)))),
    Case("BatchMatMulV2", "BatchMatMulV2", lambda a, b: raw.BatchMatMulV2(x=a, y=b, adj_x=True), (In((2, 4, 3)), In((4, 5)))),
    Case("BatchMatMulV3", "BatchMatMulV3", lambda a, b: raw.BatchMatMulV3(x=a, y=b, Tout=F32), (In((2, 3, 4)), In((2, 4, 5)))),
    Case("BiasAdd", "BiasAdd", lambda x, b: raw.BiasAdd(value=x, bias=b), (In((2, 3, 3, 5)), In((5,)))),
    Case("BiasAdd-NCHW", "BiasAdd", lambda x, b: raw.BiasAdd(value=x, bias=b, data_format="NCHW"), (In((2, 5, 3, 3)), In((5,)))),
    Case("Conv2D-SAME-stride2", "Conv2D",
         lambda x: raw.Conv2D(input=x, filter=_c(K33), strides=[1, 2, 2, 1], padding="SAME"), (IMG,)),
    Case("Conv2D-VALID-dilated", "Conv2D",
         lambda x: raw.Conv2D(input=x, filter=_c(K33), strides=[1, 1, 1, 1], padding="VALID",
                              dilations=[1, 2, 2, 1]), (IMG,)),
    Case("Conv2D-EXPLICIT", "Conv2D",
         lambda x: raw.Conv2D(input=x, filter=_c(K33), strides=[1, 2, 1, 1], padding="EXPLICIT",
                              explicit_paddings=[0, 0, 2, 1, 0, 3, 0, 0]), (IMG,)),
    Case("Conv2D-filter-input", "Conv2D",
         lambda x, k: raw.Conv2D(input=x, filter=k, strides=[1, 1, 1, 1], padding="SAME"), (IMG, In((3, 3, 3, 4)))),
    Case("DepthwiseConv2dNative", "DepthwiseConv2dNative",
         lambda x: raw.DepthwiseConv2dNative(input=x, filter=_c(KDW), strides=[1, 1, 1, 1], padding="SAME"), (IMG,)),
    Case("DepthwiseConv2dNative-stride2", "DepthwiseConv2dNative",
         lambda x: raw.DepthwiseConv2dNative(input=x, filter=_c(KDW), strides=[1, 2, 2, 1], padding="SAME"), (IMG,)),
    Case("FusedBatchNorm", "FusedBatchNorm", _bn("FusedBatchNorm"), (IMG4,)),
    Case("FusedBatchNormV2", "FusedBatchNormV2", _bn("FusedBatchNormV2"), (IMG4,)),
    Case("FusedBatchNormV3", "FusedBatchNormV3", _bn("FusedBatchNormV3"), (IMG4,)),
    Case("MaxPool-SAME", "MaxPool", _pool("MaxPool", [1, 3, 3, 1], [1, 2, 2, 1], "SAME"), (IMG,)),
    Case("MaxPool-VALID", "MaxPool", _pool("MaxPool", [1, 2, 2, 1], [1, 2, 2, 1], "VALID"), (IMG,)),
    Case("AvgPool-SAME-uneven", "AvgPool", _pool("AvgPool", [1, 3, 3, 1], [1, 2, 2, 1], "SAME"), (IMG,)),
    Case("AvgPool-SAME-even", "AvgPool", _pool("AvgPool", [1, 3, 3, 1], [1, 1, 1, 1], "SAME"), (IMG,)),
    Case("AvgPool-VALID", "AvgPool", _pool("AvgPool", [1, 2, 2, 1], [1, 2, 2, 1], "VALID"), (IMG,)),
    # binary elementwise
    _binary("Add"), _binary("AddV2"), _binary("Sub"), _binary("Mul"), _binary("RealDiv", "pos"),
    _binary("Div", "pos"), _binary("Maximum"), _binary("Minimum"), _binary("Pow", "pos"),
    _binary("SquaredDifference"), _binary("Greater"), _binary("GreaterEqual"), _binary("Less"),
    _binary("LessEqual"), _binary("Equal", "int", I32), _binary("NotEqual", "int", I32),
    _binary("LogicalAnd", "bool", BOOL), _binary("LogicalOr", "bool", BOOL),
    Case("FloorDiv-float", "FloorDiv", lambda a, b: raw.FloorDiv(x=a, y=b), (In((3, 4)), In((4,), F32, "pos"))),
    Case("FloorDiv-int", "FloorDiv", lambda a, b: raw.FloorDiv(x=a, y=b), (In((3, 4), I32, "int"), In((4,), I32, "nonzero"))),
    Case("AddN", "AddN", lambda a, b, c: raw.AddN(inputs=[a, b, c]), (V, V, V)),
    # unary elementwise
    _unary("Relu", arg="features"), _unary("Relu6", arg="features"), _unary("Elu", arg="features"),
    _unary("Selu", arg="features"), _unary("Sigmoid"), _unary("Tanh"), _unary("Softplus", arg="features"),
    _unary("Exp"), _unary("Log", "pos"), _unary("Log1p", "pos"), _unary("Sqrt", "pos"), _unary("Rsqrt", "pos"),
    _unary("Square"), _unary("Neg"), _unary("Abs"), _unary("Floor"), _unary("Ceil"), _unary("Round", "half"),
    _unary("Erf"), _unary("LogicalNot", "bool", dtype=BOOL),
    Case("LeakyRelu", "LeakyRelu", lambda x: raw.LeakyRelu(features=x, alpha=0.1), (V,)),
    _unary("Softmax", arg="logits"), _unary("LogSoftmax", arg="logits"),
    Case("ClipByValue", "ClipByValue",
         lambda x: raw.ClipByValue(t=x, clip_value_min=_c(-0.5), clip_value_max=_c(0.5)), (V,)),
    # reductions
    _reduction("Mean"), _reduction("Mean", keep=True), _reduction("Sum"), _reduction("Max"), _reduction("Min"),
    _reduction("Prod"), _reduction("All", "bool", BOOL), _reduction("Any", "bool", BOOL),
    Case("ArgMax", "ArgMax", lambda x: raw.ArgMax(input=x, dimension=_c(1, np.int32)), (V,)),
    Case("ArgMin-int32", "ArgMin", lambda x: raw.ArgMin(input=x, dimension=_c(0, np.int32), output_type=I32), (V,)),
    # shape / layout
    Case("Reshape-from-Shape", "Reshape",
         lambda x: raw.Reshape(tensor=x, shape=raw.Pack(values=[raw.StridedSlice(
             input=raw.Shape(input=x), begin=_c([0], np.int32), end=_c([1], np.int32),
             strides=_c([1], np.int32), shrink_axis_mask=1), _c(-1, np.int32)], axis=0)), (In((2, 3, 4)),)),
    Case("Squeeze", "Squeeze", lambda x: raw.Squeeze(input=x, axis=[1]), (In((3, 1, 4)),)),
    Case("Squeeze-all", "Squeeze", lambda x: raw.Squeeze(input=x), (In((3, 1, 4, 1)),)),
    Case("ExpandDims", "ExpandDims", lambda x: raw.ExpandDims(input=x, axis=_c(-1, np.int32)), (V,)),
    Case("Transpose", "Transpose", lambda x: raw.Transpose(x=x, perm=_c([2, 0, 1], np.int32)), (In((2, 3, 4)),)),
    Case("ConcatV2", "ConcatV2", lambda a, b: raw.ConcatV2(values=[a, b], axis=_c(-1, np.int32)), (V, In((3, 2)))),
    Case("Concat", "Concat", lambda a, b: raw.Concat(concat_dim=_c(0, np.int32), values=[a, b]), (V, In((2, 4)))),
    Case("Pack", "Pack", lambda a, b: raw.Pack(values=[a, b], axis=1), (V, V)),
    Case("Unpack", "Unpack", lambda x: raw.Unpack(value=x, num=3, axis=0), (V,)),
    Case("Pad", "Pad", lambda x: raw.Pad(input=x, paddings=_c([[1, 2], [0, 3]], np.int32)), (V,)),
    Case("PadV2", "PadV2",
         lambda x: raw.PadV2(input=x, paddings=_c([[1, 0], [2, 1]], np.int32), constant_values=_c(-2.5)), (V,)),
    Case("MirrorPad-REFLECT", "MirrorPad",
         lambda x: raw.MirrorPad(input=x, paddings=_c([[2, 1], [1, 3]], np.int32), mode="REFLECT"), (V,)),
    Case("MirrorPad-SYMMETRIC", "MirrorPad",
         lambda x: raw.MirrorPad(input=x, paddings=_c([[2, 3], [1, 0]], np.int32), mode="SYMMETRIC"), (V,)),
    Case("Shape", "Shape", lambda x: raw.Shape(input=x), (In((2, 3, 4)),)),
    Case("Size", "Size", lambda x: raw.Size(input=x), (In((2, 3, 4)),)),
    Case("Rank", "Rank", lambda x: raw.Rank(input=x), (In((2, 3, 4)),)),
    Case("StridedSlice-masks", "StridedSlice",
         lambda x: raw.StridedSlice(input=x, begin=_c([1, 0, 1], np.int32), end=_c([3, 0, 4], np.int32),
                                    strides=_c([1, 1, 2], np.int32), begin_mask=2, end_mask=2), (In((4, 3, 5)),)),
    Case("StridedSlice-shrink-newaxis", "StridedSlice",
         lambda x: raw.StridedSlice(input=x, begin=_c([1, 0, 0], np.int32), end=_c([2, 0, 3], np.int32),
                                    strides=_c([1, 1, 1], np.int32), shrink_axis_mask=1, new_axis_mask=2),
         (In((4, 3, 5)),)),
    Case("StridedSlice-ellipsis", "StridedSlice",
         lambda x: raw.StridedSlice(input=x, begin=_c([0, 1], np.int32), end=_c([0, 3], np.int32),
                                    strides=_c([1, 1], np.int32), ellipsis_mask=1), (In((4, 3, 5)),)),
    Case("StridedSlice-negative-stride", "StridedSlice",
         lambda x: raw.StridedSlice(input=x, begin=_c([-1, 4], np.int32), end=_c([0, 0], np.int32),
                                    strides=_c([-1, -2], np.int32), end_mask=1), (In((4, 5)),)),
    Case("Slice", "Slice", lambda x: raw.Slice(input=x, begin=_c([1, 0, 2], np.int32),
                                               size=_c([2, -1, 2], np.int32)), (In((4, 3, 5)),)),
    Case("Split", "Split", lambda x: raw.Split(axis=_c(1, np.int32), value=x, num_split=2), (V,)),
    Case("Cast-to-int32", "Cast", lambda x: raw.Cast(x=x * 3.0, DstT=I32), (V,)),
    Case("Cast-to-float", "Cast", lambda x: raw.Cast(x=x, DstT=F32), (In((3, 4), I32, "int"),)),
    Case("Cast-to-bool", "Cast", lambda x: raw.Cast(x=x, DstT=BOOL), (In((3, 4), I32, "int"),)),
    Case("GatherV2", "GatherV2",
         lambda x: raw.GatherV2(params=x, indices=_c([[2, 0], [1, 2]], np.int32), axis=_c(1, np.int32)), (In((2, 3, 4)),)),
    Case("GatherV2-indices-input", "GatherV2",
         lambda x, i: raw.GatherV2(params=x, indices=i, axis=_c(0, np.int32)), (V, In((5,), I32, "idx3"))),
    Case("Fill", "Fill", lambda v: raw.Fill(dims=_c([2, 3], np.int32), value=v), (In(()),)),
    Case("Tile", "Tile", lambda x: raw.Tile(input=x, multiples=_c([2, 3], np.int32)), (V,)),
    Case("Range", "Range", lambda x: x + raw.Cast(x=raw.Range(start=_c(1, np.int32), limit=_c(9, np.int32),
                                                                  delta=_c(2, np.int32)), DstT=F32), (In((4,)),)),
    Case("Select", "Select", lambda c, a, b: raw.Select(condition=c, x=a, y=b), (In((3, 4), BOOL, "bool"), V, V)),
    Case("SelectV2", "SelectV2", lambda c, a, b: raw.SelectV2(condition=c, t=a, e=b), (In((4,), BOOL, "bool"), V, V)),
    _unary("ZerosLike"), _unary("OnesLike"), _unary("Reciprocal", "pos"), _unary("Inv", "pos"),
    # image resize
    Case("ResizeBilinear-legacy", "ResizeBilinear",
         lambda x: raw.ResizeBilinear(images=x, size=_c([5, 11], np.int32)), (IMG,)),
    Case("ResizeBilinear-align_corners", "ResizeBilinear",
         lambda x: raw.ResizeBilinear(images=x, size=_c([13, 5], np.int32), align_corners=True), (IMG,)),
    Case("ResizeBilinear-half_pixel", "ResizeBilinear",
         lambda x: raw.ResizeBilinear(images=x, size=_c([12, 12], np.int32), half_pixel_centers=True), (IMG,)),
    Case("ResizeNearestNeighbor-legacy", "ResizeNearestNeighbor",
         lambda x: raw.ResizeNearestNeighbor(images=x, size=_c([5, 11], np.int32)), (IMG,)),
    Case("ResizeNearestNeighbor-half_pixel", "ResizeNearestNeighbor",
         lambda x: raw.ResizeNearestNeighbor(images=x, size=_c([12, 3], np.int32), half_pixel_centers=True), (IMG,)),
    Case("ResizeNearestNeighbor-align_corners", "ResizeNearestNeighbor",
         lambda x: raw.ResizeNearestNeighbor(images=x, size=_c([15, 4], np.int32), align_corners=True), (IMG,)),
    # block / space layout
    Case("SpaceToBatchND", "SpaceToBatchND",
         lambda x: raw.SpaceToBatchND(input=x, block_shape=_c([2, 2], np.int32),
                                      paddings=_c([[1, 1], [0, 2]], np.int32)), (In((2, 6, 6, 3)),)),
    Case("BatchToSpaceND", "BatchToSpaceND",
         lambda x: raw.BatchToSpaceND(input=x, block_shape=_c([2, 2], np.int32),
                                      crops=_c([[1, 0], [0, 1]], np.int32)), (In((8, 3, 3, 2)),)),
    Case("DepthToSpace", "DepthToSpace", lambda x: raw.DepthToSpace(input=x, block_size=2), (In((2, 3, 3, 8)),)),
    Case("SpaceToDepth", "SpaceToDepth", lambda x: raw.SpaceToDepth(input=x, block_size=2), (In((2, 4, 6, 3)),)),
    # trig / misc
    _unary("Sin"), _unary("Cos"), _unary("Tan", "unit"), _unary("Atan"), _binary("Atan2"), _unary("Sign"),
    _unary("Softsign", arg="features"), _unary("Expm1"), _unary("IsFinite", "special"), _unary("IsNan", "special"),
    # contraction / gather / scan
    Case("Einsum", "Einsum", lambda a, b: raw.Einsum(inputs=[a, b], equation="bij,bjk->bik"),
         (In((2, 3, 4)), In((2, 4, 5)))),
    Case("GatherNd", "GatherNd", lambda x: raw.GatherNd(params=x, indices=_c([[0, 2], [1, 0], [1, 3]], np.int32)),
         (In((2, 4, 3)),)),
    Case("TopKV2", "TopKV2", lambda x: raw.TopKV2(input=x, k=_c(2, np.int32)), (In((3, 6)),)),
    Case("Cumsum", "Cumsum", lambda x: raw.Cumsum(x=x, axis=_c(1, np.int32)), (V,)),
    Case("Cumsum-exclusive-reverse", "Cumsum",
         lambda x: raw.Cumsum(x=x, axis=_c(0, np.int32), exclusive=True, reverse=True), (V,)),
    Case("Cumprod-exclusive", "Cumprod", lambda x: raw.Cumprod(x=x, axis=_c(-1, np.int32), exclusive=True), (V,)),
]


def _feeds(case: Case):
    rng = np.random.default_rng(abs(hash(case.id)) % (1 << 32))
    out = []
    for spec in case.inputs:
        if spec.kind == "idx3":
            out.append(rng.integers(0, 3, spec.shape).astype(np.int32))
        else:
            out.append(_value(rng, spec))
    return out


def _trace(fn, specs):
    sig = [tf.TensorSpec(s.shape, s.dtype, name=f"in{i}") for i, s in enumerate(specs)]
    cf = tf.function(fn, input_signature=sig).get_concrete_function()
    return cf.graph.as_graph_def(), [t.name for t in cf.inputs], [t.name for t in cf.outputs]


def _port(gd, ins, outs, variables=None):
    return translate_graph_def(tf_proto.parse("GraphDef", gd.SerializeToString()), ins, outs, variables)


def _listed(v):
    return [np.asarray(o) for o in v] if isinstance(v, (tuple, list)) else [np.asarray(v)]


def _assert_same(got, want):
    got = [t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in
           (got if isinstance(got, tuple) else (got,))]
    want = _listed(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.dtype.kind == "f":
            assert g.dtype.kind == "f"
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * max(1.0, float(np.nanmax(np.abs(w), initial=0))))
        else:
            assert g.dtype.kind == w.dtype.kind or {g.dtype.kind, w.dtype.kind} <= {"i", "u"}
            np.testing.assert_array_equal(g, w)


def test_the_cases_cover_every_op_of_the_jax_table():
    covered = {c.op for c in CASES}
    # XlaCallModule is held in tests/test_torch_xla_call_module.py
    assert set(jax_tf_import._OP_TABLE) - covered == {"XlaCallModule"}
    assert len(jax_tf_import._OP_TABLE) == 115
    # the port translates every op the JAX package does, XlaCallModule
    # included (on its own StableHLO interpreter); and it adds FloorMod
    assert set(tf_import._OP_TABLE) == set(jax_tf_import._OP_TABLE) | {"FloorMod"}


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_op_against_the_jax_translator(case):
    gd, ins, outs = _trace(case.fn, case.inputs)
    assert case.op in {n.op for n in gd.node}
    feeds = _feeds(case)
    jax_fn, jax_params = jax_tf_import.translate_graph_def(gd, ins, outs)
    want = jax_fn(jax_params, tuple(feeds) if len(feeds) > 1 else feeds[0])
    module, fn = _port(gd, ins, outs)
    got = fn(module, tuple(torch.from_numpy(f) for f in feeds) if len(feeds) > 1 else torch.from_numpy(feeds[0]))
    _assert_same(got, want)


def test_floor_mod_against_tf():
    """FloorMod (the port's table only) rounds toward -inf as TF does, on
    integers and floats."""
    for dtype, kind in ((I32, "int"), (F32, "normal")):
        case = Case("FloorMod", "FloorMod", lambda a, b: raw.FloorMod(x=a, y=b),
                    (In((3, 4), dtype, kind), In((4,), dtype, "nonzero" if dtype == I32 else "pos")))
        gd, ins, outs = _trace(case.fn, case.inputs)
        a, b = _feeds(case)
        b = b if dtype == I32 else -b  # negative divisors on the float arm
        module, fn = _port(gd, ins, outs)
        got = fn(module, (torch.from_numpy(a), torch.from_numpy(b))).numpy()
        want = raw.FloorMod(x=tf.constant(a), y=tf.constant(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- layouts, control flow, calls ---------------------------------------------


def _both(cf, feeds):
    gd = cf.graph.as_graph_def()
    ins = [t.name for t in cf.inputs if t.dtype != tf.resource]
    outs = [t.name for t in cf.outputs]
    jax_fn, params = jax_tf_import.translate_graph_def(gd, ins, outs)
    module, fn = _port(gd, ins, outs)
    x = tuple(feeds) if len(feeds) > 1 else feeds[0]
    tx = tuple(torch.from_numpy(np.asarray(f)) for f in feeds) if len(feeds) > 1 else torch.from_numpy(feeds[0])
    return gd, fn(module, tx), jax_fn(params, x)


def test_nchw_conv_batch_norm_and_pools():
    rng = np.random.default_rng(0)
    k = rng.normal(0, 0.2, (3, 3, 2, 4)).astype(np.float32)
    scale, offset, mean, var = (np.abs(rng.normal(1, 0.1, 4)).astype(np.float32) for _ in range(4))

    @tf.function
    def f(x):
        y = raw.Conv2D(input=x, filter=_c(k), strides=[1, 1, 2, 2], padding="SAME", data_format="NCHW")
        y = raw.FusedBatchNormV3(x=y, scale=_c(scale), offset=_c(offset), mean=_c(mean), variance=_c(var),
                                 epsilon=1e-3, is_training=False, data_format="NCHW")[0]
        a = raw.MaxPool(input=y, ksize=[1, 1, 2, 2], strides=[1, 1, 2, 2], padding="VALID", data_format="NCHW")
        b = raw.AvgPool(value=y, ksize=[1, 1, 3, 3], strides=[1, 1, 2, 2], padding="SAME", data_format="NCHW")
        return a, b

    x = rng.normal(size=(2, 2, 8, 8)).astype(np.float32)
    gd, got, want = _both(f.get_concrete_function(tf.TensorSpec((2, 2, 8, 8), F32)), [x])
    _assert_same(got, want)
    # the same math in NHWC, by TF
    xn = np.transpose(x, (0, 2, 3, 1))
    y = tf.nn.conv2d(xn, k, strides=[1, 2, 2, 1], padding="SAME")
    y = raw.FusedBatchNormV3(x=y, scale=scale, offset=offset, mean=mean, variance=var, epsilon=1e-3,
                             is_training=False)[0]
    a = tf.nn.max_pool2d(y, 2, 2, "VALID")
    np.testing.assert_allclose(got[0].numpy(), np.transpose(a.numpy(), (0, 3, 1, 2)), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("p", [1.0, -1.0])
def test_if_takes_either_branch(p):
    @tf.function
    def f(p, x):
        return tf.cond(p > 0.0, lambda: x * 2.0 + 1.0, lambda: x - 3.0)

    cf = f.get_concrete_function(tf.TensorSpec((), F32), tf.TensorSpec((4,), F32))
    x = np.arange(4, dtype=np.float32)
    gd, got, want = _both(cf, [np.float32(p), x])
    assert {n.op for n in gd.node} & {"If", "StatelessIf"}
    _assert_same(got, want)
    np.testing.assert_allclose(got.numpy(), f(tf.constant(p), tf.constant(x)).numpy())


def test_while_loop():
    @tf.function
    def f(x):
        i = tf.constant(0)
        i, x = tf.while_loop(lambda i, x: i < 3, lambda i, x: (i + 1, x * 2.0), (i, x))
        return x + tf.cast(i, F32)

    x = np.array([1.0, 2.0, 3.0], np.float32)
    gd, got, want = _both(f.get_concrete_function(tf.TensorSpec((3,), F32)), [x])
    assert {n.op for n in gd.node} & {"While", "StatelessWhile"}
    _assert_same(got, want)
    np.testing.assert_allclose(got.numpy(), f(tf.constant(x)).numpy())


def test_partitioned_call_with_a_named_output():
    """A function body that reads FusedBatchNormV3's batch_variance (its
    third named output) through PartitionedCall."""
    mean = np.array([0.1, 0.2], np.float32)
    var = np.array([1.5, 2.5], np.float32)

    @tf.function
    def inner(x):
        _, _, v = tf.compat.v1.nn.fused_batch_norm(x, np.ones(2, np.float32), np.zeros(2, np.float32),
                                                   mean=mean, variance=var, is_training=False)
        return v + 0.0

    @tf.function
    def f(x):
        return inner(x) * 2.0 + tf.nn.relu(x)[0, 0, 0]

    x = np.random.default_rng(0).normal(size=(2, 2, 2, 2)).astype(np.float32)
    gd, got, want = _both(f.get_concrete_function(tf.TensorSpec((2, 2, 2, 2), F32)), [x])
    refs = [r for fn in gd.library.function for n in fn.node_def for r in n.input] + \
        [r for fn in gd.library.function for r in fn.ret.values()]
    assert any("batch_variance" in r for r in refs)
    assert {n.op for n in gd.node} & {"PartitionedCall", "StatefulPartitionedCall"}
    _assert_same(got, want)
    np.testing.assert_allclose(got.numpy(), f(tf.constant(x)).numpy(), rtol=1e-6)


def test_feeding_an_internal_tensor_skips_the_dead_upstream():
    @tf.function(input_signature=[tf.TensorSpec([6], F32, name="x")])
    def f(x):
        mid = raw.Unique(x=x)[0] * 2.0  # Unique is not translatable
        return tf.nn.relu(mid) + 1.0

    cf = f.get_concrete_function()
    gd = cf.graph.as_graph_def()
    mul = next(n.name for n in gd.node if n.op == "Mul")
    module, fn = _port(gd, [f"{mul}:0"], [t.name for t in cf.outputs])
    fed = np.array([-1.0, 2.0, -3.0], np.float32)
    np.testing.assert_allclose(fn(module, fed).numpy(), np.maximum(fed, 0) + 1.0)


def test_deep_chain_translates_without_recursion():
    @tf.function(input_signature=[tf.TensorSpec([4], F32, name="x")])
    def f(x):
        for _ in range(1200):
            x = x + 0.001
        return x

    cf = f.get_concrete_function()
    module, fn = _port(cf.graph.as_graph_def(), [t.name for t in cf.inputs], [t.name for t in cf.outputs])
    np.testing.assert_allclose(fn(module, np.zeros(4, np.float32)).numpy(), np.full(4, 1.2), rtol=1e-4)


# -- refusals and the registry --------------------------------------------------


def _unique_graph():
    @tf.function(input_signature=[tf.TensorSpec([4], F32, name="x")])
    def f(x):
        return raw.Unique(x=x)[0] + 1.0

    cf = f.get_concrete_function()
    return cf.graph.as_graph_def(), [t.name for t in cf.inputs], [t.name for t in cf.outputs]


def test_unsupported_op_fails_at_ingestion_naming_torch():
    gd, ins, outs = _unique_graph()
    with pytest.raises(UnsupportedTFOpError) as err:
        _port(gd, ins, outs)
    text = str(err.value)
    assert "Unique" in text and "no torch translation" in text and "jax" not in text.lower()
    assert "sparkdl_tpu_torch.graph.tf_import.register_tf_op" in text
    assert "Supported ops: Abs, Add, AddN" in text and "XlaCallModule" in text and "Refused" not in text
    assert isinstance(err.value, NotImplementedError) and err.value.ops == ["Unique"]


def test_unsupported_op_in_a_branch_fails_at_ingestion():
    @tf.function
    def f(p, x):
        return tf.cond(p > 0.0, lambda: raw.Cholesky(input=x), lambda: x)

    cf = f.get_concrete_function(tf.TensorSpec((), F32), tf.TensorSpec((3, 3), F32))
    with pytest.raises(UnsupportedTFOpError, match="Cholesky"):
        _port(cf.graph.as_graph_def(), [t.name for t in cf.inputs], [t.name for t in cf.outputs])


def test_xla_call_module_is_refused_naming_its_roadmap_item():
    """XlaCallModule runs on the port's StableHLO interpreter; what it does
    not run (here a TPU's Mosaic kernel, ``tpu_custom_call``) is refused at
    the first call, naming ROADMAP Queue A item 13."""
    from jax._src.lib import _jax
    from tensorflow.core.framework import graph_pb2

    src = ("module { func.func public @main(%a: tensor<2xf32>) -> tensor<2xf32> {\n"
           "%b = stablehlo.custom_call @tpu_custom_call(%a) {backend_config = \"\"} : (tensor<2xf32>) -> tensor<2xf32>\n"
           "return %b : tensor<2xf32> } }")
    gd = graph_pb2.GraphDef()
    x = gd.node.add(name="x", op="Placeholder")
    x.attr["dtype"].type = 1
    call = gd.node.add(name="call", op="XlaCallModule", input=["x"])
    call.attr["module"].s = _jax.mlir.serialize_portable_artifact(src, "1.13.4")
    call.attr["Tout"].list.type.append(1)
    call.attr["Sout"].list.shape.add().dim.add().size = 2
    mod, fn = translate_graph_def(tf_proto.parse("GraphDef", gd.SerializeToString()), ["x:0"], ["call:0"])
    with pytest.raises(NotImplementedError) as err:
        fn(mod, torch.ones(2))
    assert "custom_call @tpu_custom_call" in str(err.value) and "ROADMAP Queue A item 13" in str(err.value)
    assert "XlaCallModule" in tf_import._OP_TABLE and "XlaCallModule" not in tf_import.REFUSED


def test_register_and_unregister_a_translation():
    gd, ins, outs = _unique_graph()

    def unique(node, args):
        x = args[0]
        assert isinstance(x, torch.Tensor) and node.op == "Unique"
        values, index = torch.unique(x, sorted=False, return_inverse=True)
        return [values, index.to(torch.int32)]

    register_tf_op("Unique", unique)
    try:
        module, fn = _port(gd, ins, outs)
        got = fn(module, np.array([3.0, 3.0, 3.0, 3.0], np.float32)).numpy()
        np.testing.assert_array_equal(got, [4.0])
        with pytest.raises(TypeError):
            register_tf_op("Unique", "not callable")
    finally:
        unregister_tf_op("Unique")
    assert "Unique" not in tf_import._OP_TABLE
    # overriding a built-in, then restoring it
    register_tf_op("Relu", lambda node, args: args[0] * 0.0)
    unregister_tf_op("Relu")
    assert tf_import._OP_TABLE["Relu"] is not None
    case = next(c for c in CASES if c.id == "Relu")
    gd, ins, outs = _trace(case.fn, case.inputs)
    module, fn = _port(gd, ins, outs)
    x = np.array([[-1.0, 2.0, -3.0, 4.0]], np.float32)
    np.testing.assert_array_equal(fn(module, x).numpy(), np.maximum(x, 0))


def test_a_data_dependent_shape_is_refused_at_the_first_batch():
    """A Reshape whose shape derives from the input's VALUES would need a
    read back of the device on every batch: refused (the JAX package
    refuses it under jit)."""

    @tf.function(input_signature=[tf.TensorSpec([2], I32, name="dims"), tf.TensorSpec([6], F32, name="x")])
    def f(dims, x):
        return raw.Reshape(tensor=x, shape=dims)

    cf = f.get_concrete_function()
    module, fn = _port(cf.graph.as_graph_def(), [t.name for t in cf.inputs], [t.name for t in cf.outputs])
    with pytest.raises(ValueError, match="known on the host"):
        fn(module, (np.array([2, 3], np.int32), np.zeros(6, np.float32)))


# -- host values, weights and liveness ----------------------------------------


def test_shape_chains_stay_on_the_host_and_constants_are_copied_once():
    case = next(c for c in CASES if c.id == "Reshape-from-Shape")
    gd, ins, outs = _trace(case.fn, case.inputs)
    tr = tf_import._Translator(tf_proto.parse("GraphDef", gd.SerializeToString()), ins, outs)
    seen = {}

    def record(node, args):
        seen[node.name] = [type(a) for a in args]
        return tf_import._reshape(node, args)

    register_tf_op("Reshape", record)
    try:
        tr.run([torch.zeros(2, 3, 4)], {})
    finally:
        unregister_tf_op("Reshape")
    (types,) = seen.values()
    assert types[0] is torch.Tensor and issubclass(types[1], np.ndarray)
    # a host constant meeting a tensor is copied to its device once
    const = tf_import._host_const(np.arange(3, dtype=np.float32))
    first = tf_import._tensor(const, torch.device("cpu"))
    assert tf_import._tensor(const, torch.device("cpu")) is first


def test_values_die_after_their_last_consumer():
    @tf.function(input_signature=[tf.TensorSpec([4], F32, name="x")])
    def f(x):
        a = raw.Relu(features=x)
        b = raw.Exp(x=a)
        c = raw.AddV2(x=a, y=b)
        return raw.Neg(x=c), b

    cf = f.get_concrete_function()
    gd = cf.graph.as_graph_def()
    outs = [t.name for t in cf.outputs]
    tr = tf_import._Translator(tf_proto.parse("GraphDef", gd.SerializeToString()), ["x:0"], outs)
    order = [name for name, _, _ in tr._plan]
    op_of = {n.name: n.op for n in gd.node}
    freed = {op_of.get(v, v): op_of[order[i]] for i, names in enumerate(tr._free_after) for v in names}
    # x dies after Relu reads it and Relu's value after AddV2; Exp's is an
    # output (via Identity), so only the Identity that reads it may drop it
    assert freed["Placeholder"] == "Relu" and freed["Relu"] == "AddV2" and freed["AddV2"] == "Neg"
    kept = {n for n, _ in tr.outputs}
    assert not kept & {v for names in tr._free_after for v in names}
    got = tr.run([torch.tensor([-1.0, 0.0, 1.0, 2.0])], {})
    x = np.maximum([-1.0, 0.0, 1.0, 2.0], 0)
    np.testing.assert_allclose(got[0].numpy(), -(x + np.exp(x)), rtol=1e-6)


def test_lifted_weights_by_tf_name_in_the_conv_layout():
    case = next(c for c in CASES if c.id == "Conv2D-SAME-stride2")
    gd, ins, outs = _trace(case.fn, case.inputs)
    module, _ = _port(gd, ins, outs)
    (name,) = module.tf_names
    weight = module.tf_state_dict()[name]
    assert tuple(weight.shape) == K33.shape and np.array_equal(weight.numpy(), K33)
    assert weight.permute(3, 2, 0, 1).is_contiguous(memory_format=torch.channels_last)
    assert all("." not in k for k in module.state_dict())


def test_jax_params_load_into_the_port_module_bit_for_bit():
    """The JAX package's translated params (by TF node name) load into the
    port's module and give its own lifted weights exactly."""
    case = next(c for c in CASES if c.id == "DepthwiseConv2dNative")
    gd, ins, outs = _trace(lambda x: raw.Conv2D(input=case.fn(x), filter=_c(K33[:, :, :, :].repeat(2, axis=2)),
                                                strides=[1, 1, 1, 1], padding="SAME"), case.inputs)
    _, jax_params = jax_tf_import.translate_graph_def(gd, ins, outs)
    module, fn = _port(gd, ins, outs)
    own = {k: v.clone() for k, v in module.tf_state_dict().items()}
    assert set(own) == set(jax_params) and len(own) == 2
    for buf in module.tf_state_dict().values():
        buf.zero_()
    load_translated_params(module, {k: np.asarray(v) for k, v in jax_params.items()})
    for k, v in module.tf_state_dict().items():
        assert torch.equal(v, own[k])
    with pytest.raises(KeyError):
        load_translated_params(module, {})
    with pytest.raises(ValueError, match="shape"):
        load_translated_params(module, {k: np.zeros(3, np.float32) for k in own})


# -- bfloat16 constants --------------------------------------------------------

BF = tf.bfloat16
_B_RNG = np.random.default_rng(77)
W_BF = (_B_RNG.normal(size=(8, 6)) * 0.3).astype(np.float32)
K_BF = (_B_RNG.normal(size=(3, 3, 3, 4)) * 0.3).astype(np.float32)
B6, B4 = _B_RNG.normal(size=(6,)).astype(np.float32), _B_RNG.normal(size=(4,)).astype(np.float32)
B_BIG = _B_RNG.normal(size=(20,)).astype(np.float32)  # lifted: 16 elements or more
BF16_CASES = {
    "MatMul": (lambda x: raw.MatMul(a=x, b=tf.constant(W_BF, dtype=BF)), (4, 8)),
    "MatMul-BiasAdd": (lambda x: raw.BiasAdd(value=raw.MatMul(a=x, b=tf.constant(W_BF, dtype=BF)),
                                             bias=tf.constant(B6, dtype=BF)), (4, 8)),
    "Conv2D": (lambda x: raw.Conv2D(input=x, filter=tf.constant(K_BF, dtype=BF), strides=[1, 1, 1, 1],
                                    padding="SAME"), (2, 5, 5, 3)),
    "BiasAdd": (lambda x: raw.BiasAdd(value=x, bias=tf.constant(B4, dtype=BF)), (2, 3, 3, 4)),
    "AddV2": (lambda x: raw.AddV2(x=x, y=tf.constant(B4, dtype=BF)), (3, 4)),
    "AddV2-lifted": (lambda x: raw.AddV2(x=x, y=tf.constant(B_BIG, dtype=BF)), (3, 20)),
    "Cast-on-the-host": (lambda x: raw.AddV2(x=x, y=raw.Cast(x=tf.constant(B4), DstT=BF)), (3, 4)),
}


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bfloat16_constants_stay_bfloat16_as_in_the_jax_translator(name):
    """A DT_BFLOAT16 constant, host value or lifted weight, stays bfloat16:
    a bf16 graph's result is bf16, as the JAX translator's is, and equal
    to it within one bf16 step of its largest magnitude (both sides round
    the same f32 accumulation to bf16; the port's f32 sums run in another
    order)."""
    import jax.numpy as jnp

    fn, shape = BF16_CASES[name]
    cf = tf.function(fn, input_signature=[tf.TensorSpec(shape, BF, name="x")]).get_concrete_function()
    gd, ins, outs = cf.graph.as_graph_def(), [t.name for t in cf.inputs], [t.name for t in cf.outputs]
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    jax_fn, jax_params = jax_tf_import.translate_graph_def(gd, ins, outs)
    want = jax_fn(jax_params, jnp.asarray(x, jnp.bfloat16))
    module, port_fn = _port(gd, ins, outs)
    got = port_fn(module, torch.from_numpy(x).to(torch.bfloat16))
    assert str(want.dtype) == "bfloat16" and got.dtype == torch.bfloat16
    want32 = np.asarray(want, np.float32)
    step = 2.0 ** -7 * float(np.abs(want32).max())
    np.testing.assert_allclose(got.float().numpy(), want32, rtol=0, atol=step)
    # the port lifts a bf16 weight into a bf16 buffer; the JAX translator
    # keeps it a graph constant (its lift test is numpy's float kind)
    consts = {n.name: tf.make_ndarray(n.attr["value"].tensor) for n in gd.node if n.op == "Const"}
    assert set(module.tf_names) == ({"Const"} if name in ("MatMul", "MatMul-BiasAdd", "Conv2D", "AddV2-lifted")
                                    else set())
    for tf_name, w in module.tf_state_dict().items():
        assert w.dtype == torch.bfloat16 and tf_name not in jax_params
        np.testing.assert_array_equal(w.float().numpy(), consts[tf_name].astype(np.float32))
    load_translated_params(module, {k: np.asarray(v) for k, v in jax_params.items()})
