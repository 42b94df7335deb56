"""The ``keras.applications`` fixtures of ``chip_smoke.py`` phase 30
(``tests/fixtures/keras_apps/``, written by
``tests/fixtures/make_keras_apps_fixtures.py``), for EfficientNetB0,
EfficientNetV2B0 and MobileNetV3Large; ConvNeXtTiny, NASNetMobile and
InceptionResNetV2 are in ``test_torch_keras_apps_full_large.py``.

- each committed config equals the installed keras's
  ``keras.applications.<name>(weights=None)`` at its default size, built
  right after ``keras.backend.clear_session()`` as the fixture was;
- the BatchNorm statistics stored beside the configs
  (``chip_smoke.KERAS_APPS_BN_STATS``) are those a float64 pass of the port
  gives under the seeded weights (``make_keras_apps_fixtures.bn_stats``), to
  a unit in float32's last place (``BN_STATS_REL``: another machine's
  float64 sums may round the other way);
- the port on the CPU at full width (224x224, 299x299 for
  InceptionResNetV2), under ``chip_smoke._keras_app_weights`` (the seeded
  weights and stored statistics phase 30 builds on the card), against the
  Keras outputs stored beside the configs: the pooled features and the
  logits of two of the stored rows, relative 1e-4 (``APP_REL``).
"""

import json
import os
import sys

import keras
import numpy as np
import pytest

from sparkdl_tpu_torch.graph.ingest import ModelIngest
from sparkdl_tpu_torch.graph.keras_graph import KerasModelSpec, walk_layers
from test_torch_keras_apps import chip_smoke, fast_init, one_torch_thread  # noqa: F401 (a fixture)
from test_torch_keras_graph import APP_REL, rel, to_torch

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FAMILIES = ("EfficientNetB0", "EfficientNetV2B0", "MobileNetV3Large")
ROWS = 2  # of the stored rows
BN_STATS_REL = 2.0 ** -23
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def fixture_maker():
    """``tests/fixtures/make_keras_apps_fixtures.py``, for its float64
    BatchNorm pass."""
    chip_smoke()  # the repo root on the path, for the maker's own import
    sys.path.insert(0, FIXTURES)
    try:
        import make_keras_apps_fixtures as make
    finally:
        sys.path.remove(FIXTURES)
    return make


def check_config(name):
    cs = chip_smoke()
    side = cs.KERAS_APPS[name][0]
    keras.backend.clear_session()
    with fast_init():
        model = getattr(keras.applications, name)(weights=None, input_shape=(side, side, 3))
    assert json.loads(json.dumps(model.get_config())) == cs._keras_app_config(name)


def check_bn_stats(name):
    cs = chip_smoke()
    config = cs._keras_app_config(name)
    stats = fixture_maker().seeded_bn_stats(name, config)
    weights = cs._keras_app_weights(name, config)
    assert set(stats) == {p for p, _, layer, _ in walk_layers(config) if layer["class_name"] == "BatchNormalization"}
    for path, (mean, var) in stats.items():
        np.testing.assert_allclose(weights[path][-2], mean, rtol=BN_STATS_REL, atol=0)
        np.testing.assert_allclose(weights[path][-1], var, rtol=BN_STATS_REL, atol=0)
    with np.load(cs.KERAS_APPS_BN_STATS) as f:
        assert {k for k in f.files if k.startswith(f"{name}/")} == {
            f"{name}/{p}/{s}" for p in stats for s in ("mean", "var")}


def check_full_width(name):
    cs = chip_smoke()
    config = cs._keras_app_config(name)
    weights = cs._keras_app_weights(name, config)
    x = cs._keras_app_inputs(name, cs.KERAS_APPS_ROWS)
    with np.load(os.path.join(cs.KERAS_APPS_DIR, "outputs.npz")) as f:
        stored = {k: f[f"{name}/{k}"] for k in ("pooled", "logits", "x_sum")}
    assert float(x.astype(np.float64).sum()) == float(stored["x_sum"])  # the same draw as the fixture's
    mf = ModelIngest.from_keras(KerasModelSpec(cs._keras_app_heads(config), weights), device="cpu")
    pooled, logits = (t.numpy() for t in mf(to_torch(x[:ROWS])))
    assert logits.shape == (ROWS, 1000) and np.abs(stored["logits"]).max() > 0.1  # not vanished
    assert rel(pooled, stored["pooled"][:ROWS]) <= APP_REL, rel(pooled, stored["pooled"][:ROWS])
    assert rel(logits, stored["logits"][:ROWS]) <= APP_REL, rel(logits, stored["logits"][:ROWS])


@pytest.mark.parametrize("name", FAMILIES)
def test_committed_config_is_this_keras(name):
    check_config(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_stored_batchnorm_statistics_are_the_float64_pass(name):
    check_bn_stats(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_full_width_against_the_stored_keras_outputs(name):
    check_full_width(name)
