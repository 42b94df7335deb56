"""EfficientNetB0 (Rescaling, an adapted Normalization, SE blocks of
Reshape and Multiply, Dropout with ``noise_shape=(None, 1, 1, 1)``) and
EfficientNetV2B0 (a fixed Normalization) from ``keras.applications``
(``weights=None``) at 32x32 under ``randomize``'s seeded weights,
through the port's Keras-to-torch translator against Keras itself: the
logits agree at relative 1e-4. EfficientNetB0 is also held against the
JAX package's ``ModelIngest.from_keras`` (``model.stateless_call``) on
the same inputs, at the same limit.
"""

import numpy as np
import pytest

from sparkdl_tpu.graph.ingest import ModelIngest as JaxModelIngest
from test_torch_keras_apps import check_seeded_application, one_torch_thread  # noqa: F401 (a fixture)
from test_torch_keras_graph import APP_REL, port, rel

pytestmark = pytest.mark.usefixtures("one_torch_thread")

APPS = {
    "EfficientNetB0": ((32, 32, 3), (0.0, 255.0)),
    "EfficientNetV2B0": ((32, 32, 3), (0.0, 255.0)),
}


@pytest.mark.parametrize("name", sorted(APPS))
def test_application_against_keras(name):
    shape, (lo, hi) = APPS[name]
    model, x = check_seeded_application(name, shape, lo, hi)
    if name == "EfficientNetB0":
        jax_out = np.asarray(JaxModelIngest.from_keras(model)(x))
        assert jax_out.shape == (2, 1000)
        assert rel(port(model, x), jax_out) <= APP_REL
