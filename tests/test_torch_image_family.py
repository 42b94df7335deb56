"""The port's InceptionV3, Xception, MobileNetV2 and VGG16/19 against the
JAX package's flax modules, with the flax variables carried across by
``cnn_params_from_flax``: here InceptionV3 and Xception, "SAME" padding,
every family's geometry, MACs and TF32 switches. The other families'
parity and the converter are in ``test_torch_image_family_224.py``, the
registry and the transformers in ``test_torch_image_predictor.py``; both
take their helpers from this file.

The flax variables have the tree of ``module.init`` (taken by
``jax.eval_shape``, which compiles nothing) with every leaf drawn from a
seed: kernels at variance 1/fan_in, biases, BatchNorm scales and
statistics away from their init, so a mix-up of leaves shows. The input
sizes hit each family's padding traps: InceptionV3 at 75x75 (its least
legal input); Xception at 96x96, where block 3's stride-2 "SAME" max-pool
sees an even width and pads (0, 1), and at 71x71; MobileNetV2 at 32x32 and
33x33 (its stride-2 convs pad (0, 1) at either parity); VGG at 32x32 and
64x64 (``fc1`` takes 512 and 2048 inputs).

Tolerances: f32 at a relative max error (max |port - jax| / max |jax|) of
1e-4, the ResNet tests' bound; bf16 at ``BF16_REL``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import inception as jax_inception
from sparkdl_tpu.models import mobilenet as jax_mobilenet
from sparkdl_tpu.models import vgg as jax_vgg
from sparkdl_tpu.models import xception as jax_xception
from sparkdl_tpu_torch.bench_bounds import model_macs
from sparkdl_tpu_torch.models import get_image_model
from sparkdl_tpu_torch.models.convert import cnn_params_from_flax
from sparkdl_tpu_torch.models.inception import NUM_CONV_BN, InceptionV3
from sparkdl_tpu_torch.models.layers import BatchNorm, pad_same, same_pads
from sparkdl_tpu_torch.models.mobilenet import MobileNetV2
from sparkdl_tpu_torch.models.vgg import VGG16, VGG19
from sparkdl_tpu_torch.models.xception import Xception

F32_REL = 1e-4
#: (against the JAX package's bf16, against its f32): about twice the
#: largest gap measured on these inputs (0.87 % and 0.79 %; the JAX
#: package's own bf16-to-f32 gap is 0.29-0.76 %)
BF16_REL = (2e-2, 2e-2)

#: family -> (flax module factory, port module factory), both taking
#: ``dtype`` and the input size
FAMILIES = {
    "InceptionV3": (lambda dt, s: jax_inception.InceptionV3(dtype=dt),
                    lambda dt, s: InceptionV3(dtype=dt)),
    "Xception": (lambda dt, s: jax_xception.Xception(dtype=dt),
                 lambda dt, s: Xception(dtype=dt)),
    "MobileNetV2": (lambda dt, s: jax_mobilenet.MobileNetV2(dtype=dt),
                    lambda dt, s: MobileNetV2(dtype=dt)),
    "VGG16": (lambda dt, s: jax_vgg.VGG16(dtype=dt),
              lambda dt, s: VGG16(dtype=dt, input_size=(s, s))),
    "VGG19": (lambda dt, s: jax_vgg.VGG19(dtype=dt),
              lambda dt, s: VGG19(dtype=dt, input_size=(s, s))),
}
PREPROCESSING = {"InceptionV3": "tf", "Xception": "tf", "MobileNetV2": "tf",
                 "VGG16": "caffe", "VGG19": "caffe"}
#: the small input each family's converter and switch tests use
SMALL = {"InceptionV3": 75, "Xception": 71, "MobileNetV2": 32, "VGG16": 32, "VGG19": 32}
CASES = [("InceptionV3", 75), ("Xception", 96), ("Xception", 71)]
MODES = pytest.mark.parametrize("features_only", [True, False], ids=["features", "logits"])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@functools.lru_cache(maxsize=None)
def _flax_shapes(name, size):
    """The tree of the flax module's ``init`` at ``size``, as shapes."""
    module = FAMILIES[name][0](jnp.float32, size)
    return jax.eval_shape(
        module.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32)
    )


def _flax_variables(name, size, seed):
    """Variables with the tree of the flax module's ``init`` at ``size``,
    every leaf drawn from ``seed``."""
    shapes = _flax_shapes(name, size)
    rng = np.random.default_rng(seed)
    draw = {
        "kernel": lambda s: rng.normal(0.0, 1.0, s) / np.sqrt(np.prod(s[:-1])),
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "bias": lambda s: rng.normal(0.0, 0.1, s),
        "mean": lambda s: rng.normal(0.0, 0.1, s),
        "var": lambda s: rng.uniform(0.5, 1.5, s),
    }

    def fill(node):
        return {
            k: fill(v) if isinstance(v, dict) else draw[k](v.shape).astype(np.float32)
            for k, v in node.items()
        }

    return fill(shapes)


def _inputs(name, size, seed, n=2):
    rng = np.random.default_rng(seed)
    if PREPROCESSING[name] == "tf":  # pixels scaled to [-1, 1]
        x = rng.uniform(-1.0, 1.0, size=(n, size, size, 3))
    else:  # caffe: about +-128 around the mean
        x = rng.normal(0.0, 60.0, size=(n, size, size, 3))
    return x.astype(np.float32)


def _port(name, size, variables, dtype):
    module = FAMILIES[name][1](dtype, size)
    module.load_state_dict(cnn_params_from_flax(variables, module))
    return module.cast_compute().eval()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def parity_outputs():
    """A getter ``(name, size)`` -> ``{(dtype, features_only): (port,
    jax)}`` that computes each case once: one compile per dtype on the
    JAX side."""
    cache = {}

    def get(name, size):
        if (name, size) not in cache:
            variables = _flax_variables(name, size, seed=size)
            x = _inputs(name, size, seed=size + 1)
            result = {}
            for dtype_name in ("float32", "bfloat16"):
                jmod = FAMILIES[name][0](getattr(jnp, dtype_name), size)
                both = jax.jit(lambda v, x: (jmod.apply(v, x, features_only=True), jmod.apply(v, x)))
                refs = [np.asarray(r) for r in both(variables, x)]
                port = _port(name, size, variables, getattr(torch, dtype_name))
                with torch.inference_mode():
                    outs = [port(_nchw(x), features_only=f) for f in (True, False)]
                for features_only, out, ref in zip((True, False), outs, refs):
                    assert out.dtype == torch.float32
                    result[dtype_name, features_only] = (out.numpy(), ref)
            cache[name, size] = result
        return cache[name, size]

    return get


def check_f32(got, name, features_only):
    out, ref = got["float32", features_only]
    dim = get_image_model(name).feature_dim if features_only else 1000
    assert out.shape == ref.shape == (2, dim)
    assert _rel(out, ref) <= F32_REL


def check_bf16(got, features_only):
    out, ref_bf16 = got["bfloat16", features_only]
    _, ref_f32 = got["float32", features_only]
    assert np.isfinite(out).all()
    assert _rel(out, ref_bf16) <= BF16_REL[0]
    assert _rel(out, ref_f32) <= BF16_REL[1]
    assert _rel(out, ref_f32) > 1e-4  # the port really computed in bf16


@pytest.fixture(scope="module")
def outputs():
    return parity_outputs()


# -- parity ------------------------------------------------------------------


@MODES
@pytest.mark.parametrize("name, size", CASES, ids=[f"{n}-{s}" for n, s in CASES])
def test_family_matches_jax_f32(outputs, name, size, features_only):
    check_f32(outputs(name, size), name, features_only)


@MODES
@pytest.mark.parametrize("name, size", CASES, ids=[f"{n}-{s}" for n, s in CASES])
def test_family_bf16_within_measured_bound(outputs, name, size, features_only):
    check_bf16(outputs(name, size), features_only)


# -- padding -----------------------------------------------------------------


@pytest.mark.parametrize(
    "size, k, stride, pads",
    [(74, 3, 2, (0, 1)), (147, 3, 2, (1, 1)), (12, 3, 2, (0, 1)), (37, 3, 2, (1, 1)),
     (74, 1, 2, (0, 0)), (75, 1, 2, (0, 0)), (35, 3, 1, (1, 1)), (17, 7, 1, (3, 3)),
     (8, 2, 1, (0, 1)), (5, 5, 3, (1, 2))],
)
def test_same_pads_follow_xla(size, k, stride, pads):
    assert same_pads(size, k, stride) == pads
    # XLA's own output size and padding for the same window
    want = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
    assert pads == tuple(want)


def test_xception_pool_pads_the_far_edge_with_minus_inf():
    """At an even width the stride-2 "SAME" pool's windows start at 0; a
    symmetric pad of 1 would shift them by one."""
    x = -torch.arange(16.0).view(1, 1, 4, 4) - 1.0  # all negative
    padded = pad_same(x, 3, 2, value=float("-inf"))
    assert padded.shape == (1, 1, 5, 5)
    assert torch.isinf(padded[0, 0, 4]).all() and torch.isinf(padded[0, 0, :, 4]).all()
    out = Xception._pool(x)
    ref = jax.lax.reduce_window(
        jnp.asarray(x.numpy()), -jnp.inf, jax.lax.max, (1, 1, 3, 3), (1, 1, 2, 2), "SAME"
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# -- geometry ------------------------------------------------------------------


def test_inception_has_94_scaleless_conv_bn_pairs_in_flax_order():
    net = InceptionV3()
    variables = _flax_variables("InceptionV3", 75, seed=0)
    convs = [k for k in variables["params"] if k.startswith("conv_")]
    assert NUM_CONV_BN == net.num_conv_bn == len(convs) == 94
    for i in range(NUM_CONV_BN):
        conv, bn = getattr(net, f"conv_{i}"), getattr(net, f"bn_{i}")
        kernel = variables["params"][f"conv_{i}"]["kernel"]
        assert tuple(conv.weight.shape) == kernel.shape[::-1][:2] + kernel.shape[:2]
        assert conv.bias is None and bn.weight is None and bn.eps == 1e-3
        assert "scale" not in variables["params"][f"bn_{i}"]
        assert conv.stride == (1, 1) or conv.padding == (0, 0)  # stride 2 is VALID
    assert net.conv_0.stride == (2, 2)
    assert net.conv_5.kernel_size == (1, 1)  # mixed 0's first branch
    assert "weight" not in dict(net.bn_0.named_parameters())


def test_xception_names_and_projections():
    net = Xception()
    projections = sorted(n[: -len("_conv")] for n, _ in net.named_children() if n.endswith("_conv") and n.startswith("res"))
    assert projections == ["res13", "res2", "res3", "res4"]
    for name in projections:
        conv = getattr(net, f"{name}_conv")
        assert conv.kernel_size == (1, 1) and conv.stride == (2, 2) and conv.padding == (0, 0)
    dw = net.block5_sepconv1_dw
    assert dw.groups == 728 and dw.weight.shape == (728, 1, 3, 3) and dw.padding == (1, 1)
    assert all(m.eps == 1e-3 and m.weight is not None for m in net.modules() if isinstance(m, BatchNorm))
    assert all(c.bias is None for c in net.modules() if isinstance(c, torch.nn.Conv2d))


def test_mobilenet_blocks_and_residuals():
    net = MobileNetV2()
    assert net.num_blocks == 17 and hasattr(net, "block_16") and not hasattr(net, "block_17")
    assert not net.block_0.expanded and net.block_1.expanded
    assert [net.get_submodule(f"block_{i}").residual for i in range(17)] == [
        False, False, True, False, True, True, False, True, True, True,
        False, True, True, False, True, True, False,
    ]
    strides = [net.get_submodule(f"block_{i}").stride for i in range(17)]
    assert [i for i, s in enumerate(strides) if s == 2] == [1, 3, 6, 13]
    assert net.stem.padding == (0, 0) and net.block_1.depthwise.padding == (0, 0)
    assert net.block_2.depthwise.padding == (1, 1)
    assert net.head.out_channels == 1280 and net.classifier.in_features == 1280


def test_vgg_convs_have_biases_and_fc1_follows_the_input():
    for factory, n_convs in ((VGG16, 13), (VGG19, 16)):
        with torch.device("meta"):
            net = factory()
        convs = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
        assert len(convs) == n_convs and all(c.bias is not None for c in convs)
        assert net.fc1.in_features == 7 * 7 * 512 == 25_088
        with torch.device("meta"):
            assert factory(input_size=(64, 64)).fc1.in_features == 2048


def _layer_macs_from_flax(name, size, features_only):
    """MACs of the flax module's convs and dense layers, layer by layer,
    from the output shapes its ``apply`` records (no arithmetic)."""
    module = FAMILIES[name][0](jnp.float32, size)
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    variables = _flax_shapes(name, size)
    _, state = jax.eval_shape(
        lambda v: module.apply(v, x, features_only=features_only,
                               capture_intermediates=True, mutable=["intermediates"]),
        variables,
    )
    kernels = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    total = 0
    for path, out in jax.tree_util.tree_leaves_with_path(state["intermediates"]):
        mods = tuple(p.key for p in path[:-2])  # drop "__call__" and the tuple index
        if not mods:
            continue  # the module's own output
        key = tuple(jax.tree_util.DictKey(m) for m in mods) + (jax.tree_util.DictKey("kernel"),)
        kernel = kernels.get(key)
        if kernel is None:
            continue  # BatchNorm, or a block
        # a conv kernel [kh, kw, in/groups, out], a dense one [in, out]
        total += int(np.prod(out.shape[1:])) * int(np.prod(kernel.shape[:-1]))
    return total


#: the pinned counts at each registry geometry (features, logits)
MACS = {
    "InceptionV3": (5_711_168_096, 5_713_216_096),
    "Xception": (8_355_355_496, 8_357_403_496),
    "MobileNetV2": (299_494_272, 300_774_272),
    "VGG16": (15_346_630_656, 15_470_264_320),
    "VGG19": (19_508_428_800, 19_632_062_464),
}


@MODES
@pytest.mark.parametrize("name", list(FAMILIES))
def test_model_macs_follow_the_flax_layers(name, features_only):
    spec = get_image_model(name)
    with torch.device("meta"):
        module = FAMILIES[name][1](torch.float32, spec.height)
    macs = model_macs(module, (3, spec.height, spec.width), features_only=features_only)
    assert macs == _layer_macs_from_flax(name, spec.height, features_only)
    assert macs == MACS[name][0 if features_only else 1]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_f32_family_turns_tf32_off_in_its_own_forward(name):
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    size = SMALL[name]
    seen = []
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        for dtype in (torch.float32, torch.bfloat16):
            net = FAMILIES[name][1](dtype, size).cast_compute().eval()
            last = [m for m in net.modules() if isinstance(m, torch.nn.Linear)][-1]
            last.register_forward_hook(
                lambda *_: seen.append((cudnn.allow_tf32, matmul.allow_tf32))
            )
            with torch.inference_mode():
                net(torch.zeros(1, 3, size, size))
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    assert seen == [(False, False), (True, True)]
