"""``keras.applications`` models (``weights=None``, seeded weights) through
the port's Keras-to-torch translator against Keras itself, at their
minimum input sizes: ResNet50 (BatchNorm epsilon 1.001e-5, 7x7 stem,
ZeroPadding2D), MobileNetV2 (ReLU(6.), depthwise convs, asymmetric
ZeroPadding2D, epsilon 1e-3) and VGG16 (Flatten and its dense top); the
logits (``classifier_activation=None``) agree at relative 1e-4.
InceptionV3 and Xception are in ``test_torch_keras_apps_inception.py``.

Also the committed ResNet50 config
(``tests/fixtures/keras_resnet50_224_config.json``, what ``chip_smoke.py``
phase 14 builds its model from) equals the installed keras's
``keras.applications.ResNet50(weights=None, input_shape=(224, 224, 3))``,
and a ``KerasModelSpec`` over it with the real model's weights gives the
real model's outputs through the port, and Keras's at relative 1e-4.
"""

import json
import os

import keras
import numpy as np
import pytest

from sparkdl_tpu_torch.graph.keras_graph import KerasModelSpec, collect_weights
from test_torch_keras_graph import APP_REL, inputs, port, randomize, rel

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "keras_resnet50_224_config.json")

APPS = {
    "ResNet50": (32, 32, 3),
    "MobileNetV2": (32, 32, 3),
    "VGG16": (32, 32, 3),
}


def check_application(name, shape):
    model = getattr(keras.applications, name)(weights=None, input_shape=shape, classifier_activation=None)
    randomize(model, seed=7, bn_var=(0.5, 1.5))
    x = inputs(shape, lo=-1.0, hi=1.0)
    ours, ref = port(model, x), model.predict(x, verbose=0)
    assert ours.shape == ref.shape == (2, 1000)
    assert rel(ours, ref) <= APP_REL, name


@pytest.mark.parametrize("name", sorted(APPS))
def test_application_against_keras(name):
    check_application(name, APPS[name])


# -- the committed ResNet50 config and the stand-in -----------------------------------


@pytest.fixture(scope="module")
def resnet50_224():
    return randomize(keras.applications.ResNet50(weights=None, input_shape=(224, 224, 3)), seed=3,
                     bn_var=(0.5, 1.5))


def _renamed_input(config: dict, name: str) -> dict:
    return json.loads(json.dumps(config).replace(f'"{config["layers"][0]["name"]}"', f'"{name}"'))


def test_fixture_is_this_keras_resnet50_config(resnet50_224):
    with open(FIXTURE) as f:
        fixture = json.load(f)
    # the InputLayer's name is counted per process; everything else is fixed
    assert _renamed_input(resnet50_224.get_config(), fixture["layers"][0]["name"]) == fixture
    assert fixture["layers"][-1]["config"]["units"] == 1000
    assert fixture["layers"][-1]["config"]["activation"] == "softmax"


def test_the_stand_in_is_the_real_model(resnet50_224):
    with open(FIXTURE) as f:
        spec = KerasModelSpec(json.load(f), collect_weights(resnet50_224))
    assert spec.input_shape == (None, 224, 224, 3) and spec.name == "resnet50"
    x = inputs((224, 224, 3), lo=-100, hi=100, n=1)
    ours = port(spec, x)
    np.testing.assert_array_equal(ours, port(resnet50_224, x))
    assert rel(ours, resnet50_224.predict(x, verbose=0)) <= APP_REL
