"""NASNetMobile (Cropping2D, separable convs, "same" pooling) at 32x32 and
InceptionResNetV2 (CustomScaleLayer, BatchNorm without gamma) at 75x75
from ``keras.applications`` (``weights=None``) under ``randomize``'s seeded weights, through the port's
Keras-to-torch translator against Keras itself: the logits agree at
relative 1e-4."""

import pytest

from test_torch_keras_apps import check_seeded_application, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

APPS = {
    "NASNetMobile": ((32, 32, 3), (-1.0, 1.0)),
    "InceptionResNetV2": ((75, 75, 3), (-1.0, 1.0)),
}


@pytest.mark.parametrize("name", sorted(APPS))
def test_application_against_keras(name):
    shape, (lo, hi) = APPS[name]
    check_seeded_application(name, shape, lo, hi)
