"""MobileNetV3Small (Rescaling with an offset, hard_silu, the hard-sigmoid
op nodes ``x + 3.0`` and ``* (1 / 6)`` around ReLU(6.), SE Multiply),
MobileNet (its Reshape head) and ResNet50V2 (pre-activation blocks) from
``keras.applications`` (``weights=None``) at 32x32 under ``randomize``'s seeded weights, through the port's
Keras-to-torch translator against Keras itself: the logits agree at
relative 1e-4."""

import pytest

from test_torch_keras_apps import check_seeded_application, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

APPS = {
    "MobileNetV3Small": ((32, 32, 3), (0.0, 255.0)),
    "MobileNet": ((32, 32, 3), (-1.0, 1.0)),
    "ResNet50V2": ((32, 32, 3), (-1.0, 1.0)),
}


@pytest.mark.parametrize("name", sorted(APPS))
def test_application_against_keras(name):
    shape, (lo, hi) = APPS[name]
    check_seeded_application(name, shape, lo, hi)
