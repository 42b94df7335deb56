"""``test_torch_keras_apps_full.py``'s checks for ConvNeXtTiny,
NASNetMobile and InceptionResNetV2: the committed config equals the
installed keras's, the stored BatchNorm statistics are the float64
pass's, and the port at full width on the CPU matches the stored Keras
outputs at relative 1e-4."""

import pytest

from test_torch_keras_apps import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_keras_apps_full import check_bn_stats, check_config, check_full_width

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FAMILIES = ("ConvNeXtTiny", "NASNetMobile", "InceptionResNetV2")


@pytest.mark.parametrize("name", FAMILIES)
def test_committed_config_is_this_keras(name):
    check_config(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_stored_batchnorm_statistics_are_the_float64_pass(name):
    check_bn_stats(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_full_width_against_the_stored_keras_outputs(name):
    check_full_width(name)
