"""Keras weights onto the port's registry models
(``sparkdl_tpu_torch/models/keras_weights.py``), against the JAX
package's ``load_keras_weights``.

Each ``keras.applications`` architecture is built here with
``weights=None`` at the smallest input it takes, given seeded weights
(every BatchNorm statistic and conv bias drawn, so the bias fold and the
depthwise transposition show), and saved in one of the file layouts the
port reads without keras:

- ResNet50: a ``.keras`` archive;
- MobileNetV2: a Keras 3 ``.weights.h5`` (no config: the layer list);
- InceptionV3: a legacy ``.h5`` weight file (no config, by topology);
- Xception: a headless ``.weights.h5``;
- VGG16: a headless legacy ``.h5`` model file;
- VGG19: a headless ``.keras`` archive.

The port's tree from the file must equal the JAX tree from the model
leaf for leaf (exactly); registry features from the ``weights_file``
must match the JAX registry model on the same file at relative 1e-5
(ResNet50 at 224x224 from the ``.keras`` file, Xception at 299x299 from
the headless ``.weights.h5``, one image each); the layer list
(``models/keras_app_layers.py``) must be keras's.

Keras draws its initial weights with one compiled random op per weight
shape (seconds per model); the tests overwrite every weight anyway, so
the models are built with numpy zeros in their place (``fast_init``).
"""

import contextlib
import importlib.util
import os

import jax
import keras
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import keras_weights as jax_keras_weights
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu_torch.models import get_image_model
from sparkdl_tpu_torch.models.keras_app_layers import KERAS_APP_LAYERS
from sparkdl_tpu_torch.models.keras_weights import load_keras_weights
from test_torch_keras_graph import randomize

REL = 1e-5
MIN_INPUT = {"InceptionV3": (75, 75, 3), "Xception": (71, 71, 3)}
#: arch -> (file layout, include_top)
LAYOUTS = {
    "ResNet50": ("keras", True),
    "MobileNetV2": ("weights.h5", True),
    "InceptionV3": ("legacy weights", True),
    "Xception": ("weights.h5", False),
    "VGG16": ("legacy model", False),
    "VGG19": ("keras", False),
}


def _tool():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "keras_app_layers.py")
    spec = importlib.util.spec_from_file_location("keras_app_layers_tool", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def fast_init():
    """Keras's random initializers return numpy zeros while open."""
    import keras.src.initializers.random_initializers as initializers

    def zeros(shape, *args, dtype=None, **kwargs):
        return np.zeros(shape, dtype or "float32")

    with pytest.MonkeyPatch.context() as mp:
        for name in ("normal", "truncated_normal", "uniform"):
            mp.setattr(initializers.random, name, zeros)
        yield


def _save(model, layout: str, path_stem: str) -> str:
    if layout == "keras":
        path = path_stem + ".keras"
        model.save(path)
    elif layout == "weights.h5":
        path = path_stem + ".weights.h5"
        model.save_weights(path)
    elif layout == "legacy model":
        path = path_stem + ".h5"
        model.save(path)
    else:
        import h5py
        from keras.src.legacy.saving import legacy_h5_format

        path = path_stem + ".h5"
        with h5py.File(path, "w") as f:
            legacy_h5_format.save_weights_to_hdf5_group(f, model)
    return path


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """arch -> (keras model, saved file)."""
    d = tmp_path_factory.mktemp("keras_apps")
    out = {}
    with fast_init():
        for i, (arch, (layout, top)) in enumerate(LAYOUTS.items()):
            keras.backend.clear_session()  # fresh auto-numbered names, as the layer list has them
            kw = {"input_shape": MIN_INPUT.get(arch, (32, 32, 3))}
            # BatchNorm variances near 1: a variance near 0 multiplies float32
            # rounding layer after layer
            model = randomize(getattr(keras.applications, arch)(weights=None, include_top=top, **kw), seed=i,
                              bn_var=(0.5, 1.5))
            out[arch] = (model, _save(model, layout, str(d / arch)))
    return out


def _flat(tree, prefix=()):
    for key, sub in tree.items():
        if hasattr(sub, "items"):
            yield from _flat(sub, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(sub)


@pytest.mark.parametrize("arch", list(LAYOUTS))
def test_tree_equals_jax_leaf_for_leaf(apps, arch):
    model, path = apps[arch]
    want = dict(_flat(jax_keras_weights.load_keras_weights(arch, model)))
    for source in (path, model):
        got = dict(_flat(load_keras_weights(arch, source)))
        assert sorted(got) == sorted(want), (arch, source)
        for key, value in want.items():
            assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
            np.testing.assert_array_equal(got[key], value, err_msg=str(key))


@pytest.mark.parametrize("arch", list(LAYOUTS))
def test_tree_fits_the_port_module(apps, arch):
    """The tree carries into the registry module; a headless file is
    refused where the head is needed."""
    _, path = apps[arch]
    spec = get_image_model(arch)
    with torch.device("meta"):
        module = spec.module_factory(dtype=torch.float32, num_classes=1000, input_size=(spec.height, spec.width))
    top = LAYOUTS[arch][1]
    load_keras_weights(arch, path, module=module, allow_missing_head=not top)
    if not top:
        with pytest.raises(ValueError, match="no classification head"):
            load_keras_weights(arch, path, module=module, allow_missing_head=False)
        with pytest.raises(ValueError, match="no classification head"):
            spec.model_function(mode="logits", weights_file=path, device="cpu")


@pytest.mark.parametrize("arch", ["ResNet50", "Xception"])
def test_registry_features_match_jax(apps, arch):
    _, path = apps[arch]
    spec = get_image_model(arch)
    x = np.random.default_rng(3).uniform(-1.0, 1.0, (1, spec.height, spec.width, 3)).astype(np.float32)
    ours = spec.model_function(mode="features", weights_file=path, device="cpu")
    got = ours(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))).numpy()
    with fast_init():  # the JAX package builds the Keras model, then loads the file into it
        ref = jax_registry.get_model(arch).model_function(mode="features", weights_file=path)
    want = np.asarray(jax.jit(ref.fn)(ref.params, x))
    assert got.shape == want.shape == (1, spec.feature_dim)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= REL, err


def test_layer_list_is_keras(apps):
    """The committed layer list is what keras.applications builds, with
    and without the top (the fixture's models, built after
    ``clear_session``, carry keras's fresh names)."""
    tool = _tool()
    for arch, (model, _) in apps.items():
        entry = KERAS_APP_LAYERS[arch]
        layers = tool.weighted_layers(model)
        if LAYOUTS[arch][1]:
            assert tuple(layers) == entry["layers"], arch
        else:
            assert tuple(layers) == entry["layers"][: len(entry["layers"]) - entry["head"]], arch


def test_weights_only_file_of_another_architecture_is_refused(apps):
    _, path = apps["MobileNetV2"]
    with pytest.raises(ValueError, match="stock ResNet50"):
        load_keras_weights("ResNet50", path)
    with pytest.raises(ValueError, match="No keras converter"):
        load_keras_weights("EfficientNetB0", path)
