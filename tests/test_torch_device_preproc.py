"""The on-device resize arm (``SPARKDL_DEVICE_PREPROC``) of the port's
``ImageModelTransformer`` (``transformers/image_model.py``,
``graph/pieces.build_device_preproc``) against the JAX package's arm, on
the CPU.

- The knob is declared as in the JAX package: a flag, off by default.
- At identity geometry (source = model input) the arm skips the resize
  and is bit-identical to the host arm.
- A real resize (320 -> 224, 150 -> 224, 250x300 -> 224) is
  ``jax.image.resize(method="bilinear")``'s, antialiased when it shrinks:
  within 1e-3 on the 0-255 scale of jax evaluating it in float64. (Jax's
  float32 run computes its sample positions in float32; on random pixels
  that moves an output by up to 4e-3 between two float32 evaluations.)
- The arm's features through a small ResNet (stages [1, 1, 1, 1], the
  same weights in both packages) at 40x40 -> 32x32 and 24x24 -> 32x32
  match the JAX arm's within relative 1e-4.
- A row of another size than its partition's first is host-resized to
  that geometry, then resized on the device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
from sparkdl_tpu.image import imageIO as jax_imageIO
from sparkdl_tpu.models import resnet as jax_resnet
from sparkdl_tpu.runtime import knobs as jax_knobs
from sparkdl_tpu.transformers.image_model import ImageModelTransformer as JaxImageModelTransformer
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.graph.ingest import ModelIngest
from sparkdl_tpu_torch.graph.pieces import build_device_preproc, host_resize_uint8, image_structs_to_batch
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.models.convert import cnn_params_from_flax
from sparkdl_tpu_torch.models.resnet import ResNet
from sparkdl_tpu_torch.runtime import knobs
from sparkdl_tpu_torch.transformers.execution import device_preproc_enabled
from sparkdl_tpu_torch.transformers.image_model import ImageModelTransformer
from test_torch_image import SMALL_STAGES, _perturbed

RESIZE_ATOL = 1e-3  # on the 0-255 scale
FEATURE_REL = 1e-4
SIDE = 32


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def models():
    """A small ResNet in both packages, with the same seeded weights."""
    module = jax_resnet.ResNet(stage_sizes=SMALL_STAGES)
    variables = _perturbed(jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3))), seed=2)
    ref = JaxModelFunction(fn=lambda p, x: module.apply(p, x, features_only=True), params=variables,
                           input_shape=(SIDE, SIDE, 3), name="small_resnet")
    port = ResNet(SMALL_STAGES)
    port.load_state_dict(cnn_params_from_flax(variables, port))
    ours = ModelIngest.from_callable(lambda m, x: m(x, features_only=True), module=port,
                                     input_shape=(SIDE, SIDE, 3), name="small_resnet", device="cpu")
    return ours, ref


def _transformers(models):
    ours, ref = models
    kw = dict(inputCol="image", outputCol="f", targetHeight=SIDE, targetWidth=SIDE, preprocessing="caffe",
              batchSize=4)
    return ImageModelTransformer(modelFunction=ours, **kw), JaxImageModelTransformer(modelFunction=ref, **kw)


def _structs(module, sizes, seed=0):
    rng = np.random.default_rng(seed)
    out = [module.imageArrayToStruct(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)) for h, w in sizes]
    out[1] = None
    return out


def _run(stage, frame_cls, structs, monkeypatch, on: bool, partitions: int = 3):
    monkeypatch.setenv("SPARKDL_DEVICE_PREPROC", "1" if on else "0")
    frame = frame_cls.fromColumns({"image": structs}, numPartitions=partitions)
    rows = [r.f for r in stage.transform(frame).collect()]
    monkeypatch.delenv("SPARKDL_DEVICE_PREPROC")
    return rows


def test_knob_is_the_jax_one(monkeypatch):
    monkeypatch.delenv("SPARKDL_DEVICE_PREPROC", raising=False)
    assert device_preproc_enabled() is False
    assert knobs.get_flag("SPARKDL_DEVICE_PREPROC") == jax_knobs.get_flag("SPARKDL_DEVICE_PREPROC") is False
    monkeypatch.setenv("SPARKDL_DEVICE_PREPROC", "1")
    assert device_preproc_enabled() is True


def test_identity_geometry_is_bit_identical(models, monkeypatch):
    ours, _ = _transformers(models)
    structs = _structs(imageIO, [(SIDE, SIDE)] * 12)
    host = _run(ours, DataFrame, structs, monkeypatch, on=False)
    device = _run(ours, DataFrame, structs, monkeypatch, on=True)
    assert host[1] is None and device[1] is None
    for a, b in zip(device, host):
        if b is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("src, dst", [((320, 320), (224, 224)), ((150, 150), (224, 224)),
                                      ((250, 300), (224, 224))])
def test_resize_is_jax_image_resize(src, dst):
    x = np.random.default_rng(1).integers(0, 256, (2, 3) + src, dtype=np.uint8)
    ours = build_device_preproc(src, dst)(torch.from_numpy(x)).numpy()
    with jax.enable_x64(True):
        ref = jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1), jnp.float64), (2,) + dst + (3,),
                               method="bilinear")
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    assert ours.shape == ref.shape and ours.dtype == np.float32
    assert float(np.abs(ours - ref).max()) <= RESIZE_ATOL


@pytest.mark.parametrize("source", [40, 24])
def test_arm_features_match_the_jax_arm(models, monkeypatch, source):
    ours, ref = _transformers(models)
    sizes = [(source, source)] * 10
    got = _run(ours, DataFrame, _structs(imageIO, sizes), monkeypatch, on=True)
    want = _run(ref, JaxDataFrame, _structs(jax_imageIO, sizes), monkeypatch, on=True)
    assert got[1] is None and want[1] is None
    got = np.stack([g for g in got if g is not None])
    want = np.stack([np.asarray(w) for w in want if w is not None])
    assert got.shape == want.shape == (9, 2048)
    assert _rel(got, want) <= FEATURE_REL


def test_other_sizes_are_host_resized_to_the_partition_geometry(models, monkeypatch):
    ours, _ = _transformers(models)
    structs = _structs(imageIO, [(40, 40), (40, 40), (20, 30), (40, 40)])
    got = _run(ours, DataFrame, structs, monkeypatch, on=True, partitions=1)
    mf = models[0]
    batch, _ = image_structs_to_batch(structs[:1] + structs[2:], height=40, width=40, chw=True)
    arr = imageIO.imageStructToArray(structs[2])
    np.testing.assert_array_equal(batch[1], host_resize_uint8(arr, 40, 40).transpose(2, 0, 1))
    pre = build_device_preproc((40, 40), (SIDE, SIDE))(torch.from_numpy(batch))
    # BGR storage: the converter flips to RGB and caffe flips back, then
    # subtracts the BGR mean
    mean = torch.tensor([103.939, 116.779, 123.68]).view(1, 3, 1, 1)
    want = mf(pre - mean).numpy()
    assert _rel(np.stack([got[0], got[2], got[3]]), want) <= 1e-6
