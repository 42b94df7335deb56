"""InceptionV3 (average pooling "same" without the padding in its count,
Concatenate on channels, convs without bias and BatchNorm without gamma,
epsilon 1e-3) and Xception (SeparableConv2D, max pooling "same" at stride
2) from ``keras.applications`` (``weights=None``, seeded weights) at their
minimum input sizes, through the port's Keras-to-torch translator against
Keras itself: the logits agree at relative 1e-4."""

import pytest

from test_torch_keras_apps import check_application

APPS = {"InceptionV3": (75, 75, 3), "Xception": (71, 71, 3)}


@pytest.mark.parametrize("name", sorted(APPS))
def test_application_against_keras(name):
    check_application(name, APPS[name])
