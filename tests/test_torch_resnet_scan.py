"""The flax ResNet's ``scan_blocks`` layout carried into the port's
unrolled ResNet (``sparkdl_tpu_torch/models/convert.py``), against the
JAX package on the CPU.

The scanned variables are built as ``tests/test_resnet_scan.py`` builds
them: an unrolled ResNet's (stages [2, 3], 7 classes), each stage's
identity blocks stacked under ``stage<i>_rest/block``. The port loads them
(``cnn_params_from_flax`` unstacks them), and its logits and features
must match the unrolled JAX model's within relative 1e-4; the reverse
mapping with ``scan_blocks=True`` must give the scanned tree back
exactly, leaf for leaf, and through a flax ``.npz`` too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models.resnet import ResNet as JaxResNet
from sparkdl_tpu_torch.models.convert import cnn_params_from_flax, cnn_params_to_flax
from sparkdl_tpu_torch.models.registry import load_flax_npz, save_flax_weights
from sparkdl_tpu_torch.models.resnet import ResNet
from test_resnet_scan import _stack_identity_params
from test_torch_image import _perturbed

STAGES = [2, 3]
REL = 1e-4


@pytest.fixture(scope="module")
def variables():
    """(unrolled, scanned) variables of one seeded model."""
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    unrolled = _perturbed(jax.jit(JaxResNet(stage_sizes=STAGES, num_classes=7).init)(jax.random.PRNGKey(0), x), 3)
    scanned = _stack_identity_params(unrolled, STAGES)
    # the layout is the scanned model's own
    ref = jax.eval_shape(lambda: JaxResNet(stage_sizes=STAGES, num_classes=7, scan_blocks=True).init(
        jax.random.PRNGKey(1), x))
    assert jax.tree_util.tree_map(jnp.shape, ref) == jax.tree_util.tree_map(jnp.shape, scanned)
    return unrolled, jax.tree_util.tree_map(np.asarray, scanned)


def _flat(tree, prefix=()):
    for key, sub in tree.items():
        if hasattr(sub, "items"):
            yield from _flat(sub, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(sub)


def _port(scanned) -> ResNet:
    module = ResNet(STAGES, num_classes=7)
    module.load_state_dict(cnn_params_from_flax(scanned, module))
    return module.eval()


@pytest.mark.parametrize("features_only", [True, False], ids=["features", "logits"])
def test_scanned_weights_match_the_unrolled_jax_model(variables, features_only):
    unrolled, scanned = variables
    x = np.random.default_rng(4).normal(0, 60, size=(2, 32, 32, 3)).astype(np.float32)
    jmod = JaxResNet(stage_sizes=STAGES, num_classes=7)
    want = np.asarray(jax.jit(lambda v, x: jmod.apply(v, x, features_only=features_only))(unrolled, x))
    with torch.inference_mode():
        got = _port(scanned)(torch.from_numpy(x).permute(0, 3, 1, 2), features_only=features_only).numpy()
    assert got.shape == want.shape == ((2, 512) if features_only else (2, 7))
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= REL


def test_round_trip_to_the_scan_layout_is_exact(variables, tmp_path):
    _, scanned = variables
    port = _port(scanned)
    back = cnn_params_to_flax(port, scan_blocks=True)
    want = dict(_flat(scanned))
    got = dict(_flat(back))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].shape == value.shape and got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=str(key))
    # and through the .npz the registry reads
    path = str(tmp_path / "scanned.npz")
    save_flax_weights(back, path)
    again = _port(load_flax_npz(path))
    torch.testing.assert_close(again.state_dict(), port.state_dict(), rtol=0, atol=0)
    # the unrolled layout is the default
    assert "stage1_block2" in cnn_params_to_flax(port)["params"]
