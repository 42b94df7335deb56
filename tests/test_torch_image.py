"""The port's image path against the JAX package's: image structs, the
host batch stage, the converter, ResNet with the JAX weights carried
across by ``cnn_params_from_flax``, and DeepImageFeaturizer end to end.

The same numpy-seeded inputs go to both packages. Tolerances: uint8
batches exact; the converter at f32 atol 1e-5; ResNet f32 at a relative
max error (max |port - jax| / max |jax|) of 1e-4; ResNet bf16 at the
bounds in ``BF16_REL`` (measured on these inputs: the port's bf16 against
the JAX package's bf16 0.9-1.3 %, against its f32 0.9-1.0 %; the JAX
package's own bf16-to-f32 gap is 0.5-1.1 %).

The JAX package resizes with its C++ bridge where that is built, and the
bridge's bilinear resize is not PIL's; tests of a real resize turn the
bridge off so the JAX side takes its PIL branch, as the port always does.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.graph import pieces as jax_pieces
from sparkdl_tpu.image import imageIO as jax_imageIO
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.models import resnet as jax_resnet
from sparkdl_tpu.runtime import native as jax_native
from sparkdl_tpu.transformers import DeepImageFeaturizer as JaxFeaturizer
from sparkdl_tpu_torch.bench_bounds import model_macs
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.graph import pieces
from sparkdl_tpu_torch.graph.function import ModelFunction, piece
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.models import get_image_model, get_model, supported_models
from sparkdl_tpu_torch.models.convert import cnn_params_from_flax, cnn_params_to_flax
from sparkdl_tpu_torch.models.layers import BatchNorm, init_cnn_params
from sparkdl_tpu_torch.models.registry import load_flax_npz, save_flax_weights
from sparkdl_tpu_torch.models.resnet import ResNet, ResNet50
from sparkdl_tpu_torch.transformers.image_model import ImageModelTransformer
from sparkdl_tpu_torch.transformers.named_image import DeepImageFeaturizer

F32_REL = 1e-4
#: (against the JAX package's bf16, against its f32): about twice the
#: largest gap measured on these inputs (1.3 % and 1.0 %)
BF16_REL = (2.5e-2, 2e-2)
SMALL_STAGES = (1, 1, 1, 1)
#: the JAX registry's own image entries (tests may register more there)
IMAGE_MODELS = ["InceptionV3", "MobileNetV2", "ResNet50", "VGG16", "VGG19", "Xception"]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture
def no_bridge(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)


def _image(rng, h, w, c):
    return rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)


# -- imageIO -------------------------------------------------------------


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 6, 1), (3, 2, 4), (6, 5)])
def test_image_struct_round_trip_matches_jax(shape):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, size=shape, dtype=np.uint8)
    ours = imageIO.imageArrayToStruct(arr, origin="x.png")
    assert ours == jax_imageIO.imageArrayToStruct(arr, origin="x.png")
    back = imageIO.imageStructToArray(ours)
    np.testing.assert_array_equal(back, jax_imageIO.imageStructToArray(ours))
    np.testing.assert_array_equal(back.reshape(shape), arr)
    # floats in [0, 1] scale to [0, 255], others clip, as in the JAX package
    for floats in (arr / 255.0, arr * 2.0 - 100.0):
        assert imageIO.imageArrayToStruct(floats) == jax_imageIO.imageArrayToStruct(floats)
    assert imageIO.imageSchema == jax_imageIO.imageSchema
    assert imageIO.ocvTypes == jax_imageIO.ocvTypes


def test_struct_errors_match_jax():
    good = imageIO.imageArrayToStruct(np.zeros((2, 2, 3), np.uint8))
    for bad in (dict(good, mode=99), dict(good, data=b"\0" * 5)):
        with pytest.raises(ValueError):
            imageIO.imageStructToArray(bad)
        with pytest.raises(ValueError):
            jax_imageIO.imageStructToArray(bad)
    with pytest.raises(ValueError):
        imageIO.imageArrayToStruct(np.zeros((2, 2, 2), np.uint8))


def test_read_images_matches_jax(tmp_path, no_bridge):
    rng = np.random.default_rng(1)
    for i, (h, w) in enumerate([(8, 9), (16, 5), (7, 7)]):
        Image.fromarray(_image(rng, h, w, 3), "RGB").save(tmp_path / f"img{i}.png")
    Image.fromarray(_image(rng, 6, 4, 1)[:, :, 0], "L").save(tmp_path / "gray.png")
    (tmp_path / "corrupt.png").write_bytes(b"not an image")
    ours = imageIO.readImages(str(tmp_path), numPartitions=2)
    ref = jax_imageIO.readImages(str(tmp_path), numPartitions=2)
    assert ours.columns == ref.columns == ["image"]
    got, want = ours.collect(), ref.collect()
    assert len(got) == len(want) == 5
    assert [r.image for r in got] == [r.image for r in want]
    assert sum(r.image is None for r in got) == 1
    assert ours.count() == 5


# -- DataFrame -----------------------------------------------------------


def test_dataframe_ops_match_jax():
    cols = {"a": list(range(23)), "b": [f"r{i}" for i in range(23)]}
    ours = DataFrame.fromColumns(cols, numPartitions=3)
    ref = JaxDataFrame.fromColumns(cols, numPartitions=3)
    assert ours.columns == ref.columns == ["a", "b"]
    assert ours.select("b").collect() == ref.select("b").collect()
    assert ours.select(["b", "a"]).columns == ["b", "a"]
    with pytest.raises(KeyError):
        ours.select("c")
    twice = ours.withColumn("c", lambda r: r.a * 2)
    assert [r.c for r in twice.collect()] == [2 * i for i in range(23)]
    assert twice.columns == ["a", "b", "c"]
    mapped = ours.mapPartitions(lambda p: {"n": [len(p["a"])]}, ["n"])
    assert [r.n for r in mapped.collect()] == [8, 8, 7]
    for seed in (0, 7):
        for weights in ([0.7, 0.3], [1, 1, 2]):
            splits = ours.randomSplit(weights, seed=seed)
            ref_splits = ref.randomSplit(weights, seed=seed)
            assert [s.collect() for s in splits] == [s.collect() for s in ref_splits]
    with pytest.raises(ValueError):
        ours.randomSplit([-1, 2])


# -- host stage ------------------------------------------------------------


def _mixed_structs(rng):
    """Nulls, an undecodable struct, 1- and 4-channel images and sizes
    that need a real resize, beside one at the target size."""
    structs = [
        imageIO.imageArrayToStruct(_image(rng, 12, 10, 3)),
        None,
        imageIO.imageArrayToStruct(_image(rng, 30, 17, 3)),
        imageIO.imageArrayToStruct(_image(rng, 9, 14, 1)),
        imageIO.imageArrayToStruct(_image(rng, 5, 8, 4)),
        dict(imageIO.imageArrayToStruct(_image(rng, 4, 4, 3)), data=b"\1" * 7),
        imageIO.imageArrayToStruct(_image(rng, 12, 10, 1)),
    ]
    return structs


@pytest.mark.parametrize("n_channels", [3, 1])
@pytest.mark.parametrize("chw", [False, True])
def test_image_structs_to_batch_matches_jax(chw, n_channels, no_bridge):
    structs = _mixed_structs(np.random.default_rng(2))
    batch, mask = pieces.image_structs_to_batch(structs, 12, 10, n_channels, chw=chw)
    ref_batch, ref_mask = jax_pieces.image_structs_to_batch(
        structs, 12, 10, n_channels, chw=chw
    )
    assert batch.dtype == np.uint8
    assert batch.shape == ((7, n_channels, 12, 10) if chw else (7, 12, 10, n_channels))
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(batch, ref_batch)
    assert not mask[1] and not mask[5] and mask[0]
    assert not batch[1].any()


def test_host_resize_matches_jax_pil_branch(no_bridge):
    rng = np.random.default_rng(3)
    for shape in [(30, 17, 3), (9, 14, 1), (224, 224, 3)]:
        arr = _image(rng, *shape)
        np.testing.assert_array_equal(
            pieces.host_resize_uint8(arr, 224, 224),
            jax_pieces.host_resize_uint8(arr, 224, 224),
        )


# -- converter and flattener ---------------------------------------------


@pytest.mark.parametrize("order", ["BGR", "RGB"])
@pytest.mark.parametrize("mode", ["tf", "caffe", "torch", "none"])
def test_converter_matches_jax(mode, order):
    rng = np.random.default_rng(4)
    nhwc = _image(rng, 2 * 6, 5, 3).reshape(2, 6, 5, 3)
    ref = np.asarray(
        jax_pieces.build_image_converter(order, mode)(jnp.asarray(nhwc))
    )
    conv = pieces.build_image_converter(order, mode)
    out = conv(torch.from_numpy(np.ascontiguousarray(nhwc.transpose(0, 3, 1, 2))))
    assert out.dtype == torch.float32
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-5)


def test_caffe_round_trip_is_bgr_minus_bgr_mean():
    """Structs hold BGR; the converter flips to RGB and caffe flips back:
    what the model sees is the stored BGR minus the BGR ImageNet mean, cast
    to the model dtype only after the float32 arithmetic."""
    bgr = torch.tensor([[10, 120, 250]], dtype=torch.uint8).view(1, 3, 1, 1)
    for dtype in (torch.float32, torch.bfloat16):
        out = pieces.build_image_converter("BGR", "caffe", out_dtype=dtype)(bgr)
        want = torch.tensor([10 - 103.939, 120 - 116.779, 250 - 123.68])
        assert out.dtype == dtype
        torch.testing.assert_close(out.view(3).float(), want.to(dtype).float())
    with pytest.raises(ValueError, match="preprocessing"):
        pieces.normalize_fn("yuv")


def test_flattener_matches_jax():
    y = np.random.default_rng(5).normal(size=(3, 2, 4)).astype(np.float32)
    ours = pieces.build_flattener()(torch.from_numpy(y).to(torch.bfloat16))
    ref = jax_pieces.build_flattener()(jnp.asarray(y, jnp.bfloat16))
    assert ours.dtype == torch.float32 and ours.shape == (3, 8)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# -- composition -----------------------------------------------------------


def test_model_functions_compose_on_one_device():
    lin = torch.nn.Linear(3, 2)
    mf = ModelFunction(lambda m, x: m(x), lin, torch.device("cpu"), name="lin",
                       input_shape=(1, 1, 3))
    double = piece(lambda x: 2 * x, name="double")
    both = mf.and_then(double).before(lambda x: x + 1)
    assert both.name == "<lambda>>>lin>>double"
    assert both.device == torch.device("cpu")
    assert both.input_shape is None  # the first part's: a bare piece has none
    assert mf.and_then(double).input_shape == (1, 1, 3)
    assert sum(p.numel() for p in both.module.parameters()) == 8
    x = torch.randn(4, 3)
    with torch.no_grad():
        torch.testing.assert_close(both(x), 2 * lin(x + 1))
    assert not both(x).requires_grad  # calls run under inference_mode
    other = ModelFunction(lambda m, x: x, torch.nn.Module(), torch.device("meta"))
    with pytest.raises(ValueError, match="share a device"):
        mf.and_then(other)


# -- ResNet ------------------------------------------------------------------


def _perturbed(variables, seed):
    """JAX init gives BatchNorm scale 1, bias 0, mean 0, var 1 and a zero
    head bias, under which a mix-up of those leaves would pass unseen:
    draw them from a seed instead."""
    rng = np.random.default_rng(seed)
    out = copy.deepcopy(jax.tree_util.tree_map(np.asarray, variables))
    draw = {
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "bias": lambda s: rng.normal(0.0, 0.1, s),
        "mean": lambda s: rng.normal(0.0, 0.1, s),
        "var": lambda s: rng.uniform(0.5, 1.5, s),
    }

    def walk(node):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value)
            elif key in draw:
                node[key] = draw[key](value.shape).astype(np.float32)

    walk(out)
    return out


def _jax_variables(stages):
    module = jax_resnet.ResNet(stage_sizes=stages)
    # jit: eager init of ResNet50 takes about 12 s on the CPU
    variables = jax.jit(module.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32)
    )
    return _perturbed(variables, seed=1)


@pytest.fixture(scope="module")
def small_variables():
    return _jax_variables(SMALL_STAGES)


@pytest.fixture(scope="module")
def resnet50_variables():
    return _jax_variables((3, 4, 6, 3))


def _port_resnet(stages, variables, dtype):
    module = ResNet(stages, dtype=dtype)
    module.load_state_dict(cnn_params_from_flax(variables, module))
    return module.cast_compute().eval()


def _both(stages, variables, dtype_name, features_only, x):
    jmod = jax_resnet.ResNet(stage_sizes=stages, dtype=getattr(jnp, dtype_name))
    ref = np.asarray(
        jax.jit(lambda v, x: jmod.apply(v, x, features_only=features_only))(
            variables, x
        )
    )
    port = _port_resnet(stages, variables, getattr(torch, dtype_name))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last
    )
    with torch.inference_mode():
        out = port(xt, features_only=features_only)
    assert out.dtype == torch.float32
    return out.numpy(), ref


def _inputs(seed, n=2, size=32):
    # caffe-normalized pixels are about +-128 around the mean
    return np.random.default_rng(seed).normal(0, 60, size=(n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("features_only", [True, False], ids=["features", "logits"])
def test_small_resnet_matches_jax_f32(small_variables, features_only):
    out, ref = _both(SMALL_STAGES, small_variables, "float32", features_only, _inputs(6))
    assert out.shape == ref.shape == ((2, 2048) if features_only else (2, 1000))
    assert _rel(out, ref) <= F32_REL


@pytest.mark.parametrize("features_only", [True, False], ids=["features", "logits"])
def test_small_resnet_bf16_within_measured_bound(small_variables, features_only):
    x = _inputs(7)
    out, ref_bf16 = _both(SMALL_STAGES, small_variables, "bfloat16", features_only, x)
    _, ref_f32 = _both(SMALL_STAGES, small_variables, "float32", features_only, x)
    assert np.isfinite(out).all()
    assert _rel(out, ref_bf16) <= BF16_REL[0]
    assert _rel(out, ref_f32) <= BF16_REL[1]
    assert _rel(out, ref_f32) > 1e-4  # the port really computed in bf16


def test_resnet50_matches_jax_f32(resnet50_variables):
    out, ref = _both((3, 4, 6, 3), resnet50_variables, "float32", True, _inputs(8))
    assert out.shape == (2, 2048)
    assert _rel(out, ref) <= F32_REL


def test_resnet50_geometry_is_keras_v1():
    """The stride sits on the 1x1 conv1 (ResNet v1 as keras builds it; the
    v1.5 of torchvision puts it on the 3x3); every stage opens with a
    projection, stage 1 included; explicit pads; no conv bias."""
    net = ResNet50()
    assert net.conv_init.kernel_size == (7, 7)
    assert net.conv_init.stride == (2, 2) and net.conv_init.padding == (3, 3)
    assert len(net.block_names) == 16
    for stage, blocks in enumerate((3, 4, 6, 3), start=1):
        first = getattr(net, f"stage{stage}_block1")
        stride = (1, 1) if stage == 1 else (2, 2)
        assert first.projection and first.conv_proj.stride == stride
        assert first.conv1.stride == stride and first.conv1.kernel_size == (1, 1)
        assert first.conv2.stride == (1, 1) and first.conv2.padding == (1, 1)
        for j in range(2, blocks + 1):
            assert not getattr(net, f"stage{stage}_block{j}").projection
    convs = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    assert all(c.bias is None for c in convs) and net.head.bias is not None
    assert all(m.eps == 1e-5 for m in net.modules() if isinstance(m, BatchNorm))
    x = torch.zeros(1, 3, 65, 65)
    with torch.inference_mode():
        assert net(x, features_only=True).shape == (1, 2048)


def _keras_v1_resnet50_macs(size: int) -> int:
    """ResNet50's conv and head MACs at ``size``x``size``, summed layer by
    layer from the keras v1 geometry (stride on conv1 and the projection)."""
    side = size // 2
    macs = side * side * 64 * 3 * 7 * 7  # stem
    side //= 2  # max-pool
    channels = 64
    for i, blocks in enumerate((3, 4, 6, 3)):
        f = 64 * 2**i
        for j in range(blocks):
            if j == 0 and i > 0:
                side //= 2
            pix = side * side
            macs += pix * (channels * f + f * f * 9 + f * 4 * f)
            if j == 0:
                macs += pix * channels * 4 * f  # projection
            channels = 4 * f
    return macs + channels * 1000  # head


@pytest.mark.parametrize("features_only", [True, False], ids=["features", "logits"])
def test_model_macs_of_resnet50_follow_keras_v1(features_only):
    macs = model_macs(ResNet50(), (3, 224, 224), features_only=features_only)
    expected = _keras_v1_resnet50_macs(224) - (2048 * 1000 if features_only else 0)
    assert macs == expected
    assert macs == (3_855_925_248 if features_only else 3_857_973_248)


def test_f32_resnet_turns_tf32_off_in_its_own_forward():
    """cuDNN's TF32 default would round an f32 model's conv inputs; the f32
    ResNet turns both switches off around its forward and puts them back,
    and the bf16 one leaves them alone."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    seen = []
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        for dtype in (torch.float32, torch.bfloat16):
            net = ResNet(SMALL_STAGES, dtype=dtype).cast_compute().eval()
            net.head.register_forward_hook(
                lambda *_: seen.append((cudnn.allow_tf32, matmul.allow_tf32))
            )
            with torch.inference_mode():
                net(torch.zeros(1, 3, 32, 32))
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    assert seen == [(False, False), (True, True)]


def test_resnet50_state_dict_matches_jax_variables(resnet50_variables):
    state = cnn_params_from_flax(resnet50_variables, ResNet50())
    n_leaves = len(jax.tree_util.tree_leaves(resnet50_variables))
    assert len(state) == n_leaves == len(ResNet50().state_dict())
    k = resnet50_variables["params"]["stage2_block1"]["conv2"]["kernel"]
    np.testing.assert_array_equal(
        state["stage2_block1.conv2.weight"].numpy(), k.transpose(3, 2, 0, 1)
    )
    stats = resnet50_variables["batch_stats"]["bn_init"]
    np.testing.assert_array_equal(state["bn_init.running_var"].numpy(), stats["var"])
    head = resnet50_variables["params"]["head"]["kernel"]
    np.testing.assert_array_equal(state["head.weight"].numpy(), head.T)


def test_port_weights_round_trip_through_a_flax_npz(small_variables, tmp_path):
    """The port writes what the JAX package reads: a ResNet's weights as
    flax variables, saved in ``save_flax_weights``' layout."""
    port = ResNet(SMALL_STAGES)
    port.load_state_dict(cnn_params_from_flax(small_variables, port))
    back = cnn_params_to_flax(port)
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(small_variables)]
    for (_, a), (_, b) in zip(flat(back), flat(small_variables)):
        np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "w.npz")
    save_flax_weights(back, path)
    loaded = jax_registry._load_flax_weights(path)
    for (_, a), (_, b) in zip(flat(loaded), flat(small_variables)):
        np.testing.assert_array_equal(np.asarray(a), b)
    again = ResNet(SMALL_STAGES)
    again.load_state_dict(cnn_params_from_flax(load_flax_npz(path), again))
    torch.testing.assert_close(again.state_dict(), port.state_dict(), rtol=0, atol=0)


def _missing(v):
    del v["params"]["stage1_block1"]["conv1"]["kernel"]


def _extra(v):
    v["params"]["stage1_block1"]["conv9"] = {"kernel": np.zeros((1, 1, 64, 64), np.float32)}


def _extra_collection(v):
    v["intermediates"] = {}


def _unknown_leaf(v):
    v["batch_stats"]["bn_init"]["count"] = np.zeros(64, np.float32)


def _scanned(v):
    # a stage<i>_rest entry whose leaves are not stacked on one leading axis
    v["params"]["stage1_rest"] = {"block": copy.deepcopy(v["params"]["stage1_block1"])}


@pytest.mark.parametrize(
    "mutate, error",
    [
        (_missing, r"missing \['stage1_block1.conv1.weight'\]"),
        (_extra, r"unexpected \['stage1_block1.conv9.weight'\]"),
        (_extra_collection, "unexpected flax collections"),
        (_unknown_leaf, "unexpected flax leaf batch_stats/bn_init/count"),
        (_scanned, "scan_blocks"),
    ],
    ids=["missing", "extra", "collection", "leaf", "scan_blocks"],
)
def test_converter_refuses_a_mismatched_tree(small_variables, mutate, error):
    variables = copy.deepcopy(small_variables)
    mutate(variables)
    with pytest.raises(ValueError, match=error):
        cnn_params_from_flax(variables, ResNet(SMALL_STAGES))


def test_seeded_init_follows_flax_distributions():
    gen = torch.Generator().manual_seed(0)
    net = ResNet(SMALL_STAGES, num_classes=10)
    init_cnn_params(net, gen)
    w = net.stage4_block1.conv2.weight.detach()  # fan_in 512 * 9
    std = (1.0 / (512 * 9)) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert not net.head.bias.any()
    bn = net.stage1_block1.bn1
    assert bn.weight.eq(1).all() and not bn.bias.any()
    assert not bn.running_mean.any() and bn.running_var.eq(1).all()
    again = ResNet(SMALL_STAGES, num_classes=10)
    init_cnn_params(again, torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.state_dict(), net.state_dict(), rtol=0, atol=0)
    init_cnn_params(again, torch.Generator().manual_seed(1))
    assert not torch.equal(again.conv_init.weight, net.conv_init.weight)


# -- registry ------------------------------------------------------------------


def test_registry_image_entry_matches_jax(tmp_path):
    assert supported_models(kind="image") == IMAGE_MODELS
    assert set(IMAGE_MODELS) <= set(jax_registry.supported_models(kind="image"))
    ours, ref = get_image_model("resnet50"), jax_registry.get_model("ResNet50")
    for field in ("name", "height", "width", "preprocessing", "feature_dim", "num_classes"):
        assert getattr(ours, field) == getattr(ref, field)
    assert get_model("ResNet50") is ours
    with pytest.raises(ValueError, match="text model"):
        get_image_model("bert-tiny")
    with pytest.raises(ValueError, match="mode"):
        ours.model_function(mode="embed", device="cpu")
    # a Keras file is read now (a missing one is not found); pickles and
    # the 'imagenet' artifact are still refused
    with pytest.raises(FileNotFoundError):
        ours.model_function(weights_file=str(tmp_path / "weights.h5"), device="cpu")
    for weights in ("weights.pkl", "imagenet"):
        with pytest.raises(NotImplementedError, match="need a download"):
            ours.model_function(weights_file=weights, device="cpu")


def test_registry_weights_come_from_the_seed():
    """Both dtypes draw the same weights from a seed; bf16 stores the conv
    and head weights rounded, BatchNorm in f32."""
    spec = get_image_model("ResNet50")
    a = spec.model_function(seed=3, device="cpu")
    bf = spec.model_function(dtype=torch.bfloat16, seed=3, device="cpu")
    assert a.input_shape == (224, 224, 3) and a.input_dtype == torch.float32
    assert bf.input_dtype == torch.bfloat16
    assert a.module.conv_init.weight.is_contiguous(memory_format=torch.channels_last)
    for key, value in a.module.state_dict().items():
        got = bf.module.state_dict()[key]
        if "bn" in key:
            assert got.dtype == torch.float32 and torch.equal(got, value), key
        else:
            assert got.dtype == torch.bfloat16, key
            assert torch.equal(got, value.to(torch.bfloat16)), key


# -- transformers ----------------------------------------------------------


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory, resnet50_variables):
    path = str(tmp_path_factory.mktemp("weights") / "resnet50.npz")
    jax_registry.save_flax_weights(resnet50_variables, path)
    return path


def test_deep_image_featurizer_matches_jax(weights_npz, no_bridge):
    """224x224 ResNet50 f32 from the same .npz in both packages, over two
    partitions at batch 4 (a padded tail batch) with a null row and images
    that need a real resize."""
    rng = np.random.default_rng(9)
    shapes = [(224, 224, 3), (100, 150, 3), None, (300, 260, 1), (50, 60, 4)]
    structs = [
        None if s is None else imageIO.imageArrayToStruct(_image(rng, *s))
        for s in shapes
    ]
    kwargs = dict(
        inputCol="image", outputCol="features", modelName="ResNet50",
        weightsFile=weights_npz, computeDtype="float32", batchSize=4,
    )
    ours = DeepImageFeaturizer(device="cpu", **kwargs).transform(
        DataFrame.fromColumns({"image": structs}, numPartitions=2)
    ).collect()
    ref = JaxFeaturizer(**kwargs).transform(
        JaxDataFrame.fromColumns({"image": structs}, numPartitions=2)
    ).collect()
    assert [r.features is None for r in ours] == [s is None for s in shapes]
    assert [r.features is None for r in ref] == [s is None for s in shapes]
    for got, want in zip(ours, ref):
        if want.features is not None:
            assert got.features.shape == (2048,) and got.features.dtype == np.float32
            assert _rel(got.features, want.features) <= F32_REL


def test_featurizer_params_and_cache():
    feat = DeepImageFeaturizer(inputCol="image", outputCol="f", modelName="ResNet50",
                               device="cpu")
    assert feat.getOrDefault("computeDtype") == "bfloat16"
    assert feat.getBatchSize() == 32
    assert DeepImageFeaturizer.supportedModels() == IMAGE_MODELS
    assert set(IMAGE_MODELS) <= set(JaxFeaturizer.supportedModels())
    with pytest.raises(TypeError):
        DeepImageFeaturizer(computeDtype="float16")
    with pytest.raises(TypeError, match="keyword"):
        DeepImageFeaturizer("image")
    inner = feat._inner()
    assert feat._inner() is inner
    mf = inner.getModelFunction()
    assert mf.input_dtype == torch.bfloat16 and mf.device == torch.device("cpu")
    assert inner.getOrDefault("preprocessing") == "caffe"
    feat.setModelName("resnet50")
    assert feat._inner() is not inner


def test_image_model_transformer_image_mode_and_nulls():
    """outputMode='image' re-wraps (C, H, W) rows as structs; an all-null
    batch is skipped and its rows stay None."""
    identity = ModelFunction(lambda m, x: x, torch.nn.Module(), torch.device("cpu"),
                             input_shape=(6, 4, 3))
    rng = np.random.default_rng(10)
    arrays = [_image(rng, 6, 4, 3) for _ in range(3)]
    structs = [None, None, imageIO.imageArrayToStruct(arrays[0]),
               imageIO.imageArrayToStruct(arrays[1]), None]
    t = ImageModelTransformer(inputCol="image", outputCol="out", modelFunction=identity,
                              outputMode="image", channelOrder="RGB", batchSize=2)
    rows = t.transform(DataFrame.fromColumns({"image": structs})).collect()
    assert [r.out is None for r in rows] == [True, True, False, False, True]
    for r, arr in zip(rows[2:4], arrays):
        np.testing.assert_array_equal(imageIO.imageStructToArray(r.out), arr)
    vec = t.copy({t.outputMode: "vector"}).transform(
        DataFrame.fromColumns({"image": structs})
    ).collect()
    np.testing.assert_array_equal(vec[2].out, arrays[0].transpose(2, 0, 1).ravel())
    with pytest.raises(ValueError, match="targetHeight"):
        ImageModelTransformer(
            inputCol="image", outputCol="out",
            modelFunction=piece(lambda x: x),
        )._geometry()
