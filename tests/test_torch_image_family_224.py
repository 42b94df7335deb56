"""The port's MobileNetV2, VGG16 and VGG19 against the JAX package's flax
modules, and the converter of every family: the helpers, inputs and
tolerances of ``test_torch_image_family.py``."""

import copy

import jax
import numpy as np
import pytest
import torch

import test_torch_image_family as family
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu_torch.models.convert import cnn_params_from_flax, cnn_params_to_flax
from sparkdl_tpu_torch.models.registry import load_flax_npz, save_flax_weights

FAMILIES, SMALL, MODES = family.FAMILIES, family.SMALL, family.MODES
CASES = [("MobileNetV2", 32), ("MobileNetV2", 33), ("VGG16", 32), ("VGG16", 64), ("VGG19", 32)]


@pytest.fixture(scope="module")
def outputs():
    return family.parity_outputs()


@pytest.fixture(scope="module")
def small_trees():
    """``small_trees(name)``: flax variables of the family at its small
    input, drawn once; callers that change them take a copy."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = family._flax_variables(name, SMALL[name], seed=3)
        return cache[name]

    return get


def _meta_module(name):
    """The port module at the family's small input, without storage: the
    converter reads only its state_dict's keys."""
    with torch.device("meta"):
        return FAMILIES[name][1](torch.float32, SMALL[name])


# -- parity ------------------------------------------------------------------


@MODES
@pytest.mark.parametrize("name, size", CASES, ids=[f"{n}-{s}" for n, s in CASES])
def test_family_matches_jax_f32(outputs, name, size, features_only):
    family.check_f32(outputs(name, size), name, features_only)


@MODES
@pytest.mark.parametrize("name, size", CASES, ids=[f"{n}-{s}" for n, s in CASES])
def test_family_bf16_within_measured_bound(outputs, name, size, features_only):
    family.check_bf16(outputs(name, size), features_only)


# -- converter ------------------------------------------------------------------


@pytest.mark.parametrize("name", list(FAMILIES))
def test_state_dict_matches_the_flax_tree(name, small_trees):
    variables = small_trees(name)
    port = _meta_module(name)
    state = cnn_params_from_flax(variables, port)
    assert len(state) == len(jax.tree_util.tree_leaves(variables)) == len(port.state_dict())


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_weights_round_trip_through_a_flax_npz(name, tmp_path, small_trees):
    size = SMALL[name]
    variables = small_trees(name)
    port = FAMILIES[name][1](torch.float32, size)
    port.load_state_dict(cnn_params_from_flax(variables, port))
    back = cnn_params_to_flax(port)
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(variables)]
    for (_, a), (_, b) in zip(flat(back), flat(variables)):
        np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "w.npz")
    save_flax_weights(back, path)
    loaded = jax_registry._load_flax_weights(path)
    for (_, a), (_, b) in zip(flat(loaded), flat(variables)):
        np.testing.assert_array_equal(np.asarray(a), b)
    again = FAMILIES[name][1](torch.float32, size)
    again.load_state_dict(cnn_params_from_flax(load_flax_npz(path), again))
    torch.testing.assert_close(again.state_dict(), port.state_dict(), rtol=0, atol=0)


def _drop(path):
    def mutate(v):
        node = v
        for key in path[:-1]:
            node = node[key]
        del node[path[-1]]
    return mutate


def _add(path, leaf):
    def mutate(v):
        node = v
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return mutate


MISMATCHES = [
    ("InceptionV3", _drop(("params", "conv_93", "kernel")), r"missing \['conv_93.weight'\]"),
    ("InceptionV3", _add(("params", "bn_0", "scale"), np.ones(32, np.float32)),
     r"unexpected \['bn_0.weight'\]"),
    ("InceptionV3", _add(("batch_stats", "bn_0", "count"), np.ones(32, np.float32)),
     "unexpected flax leaf batch_stats/bn_0/count"),
    ("Xception", _drop(("batch_stats", "res13_bn", "var")), r"missing \['res13_bn.running_var'\]"),
    ("Xception", _add(("params", "res5_conv", "kernel"), np.ones((1, 1, 728, 728), np.float32)),
     r"unexpected \['res5_conv.weight'\]"),
    ("MobileNetV2", _drop(("params", "block_16", "project", "kernel")),
     r"missing \['block_16.project.weight'\]"),
    ("MobileNetV2", _add(("params", "block_0", "expand", "kernel"), np.ones((1, 1, 32, 32), np.float32)),
     r"unexpected \['block_0.expand.weight'\]"),
    ("VGG16", _drop(("params", "fc1", "bias")), r"missing \['fc1.bias'\]"),
    ("VGG16", _add(("params", "block1_conv3", "kernel"), np.ones((3, 3, 64, 64), np.float32)),
     r"unexpected \['block1_conv3.weight'\]"),
    ("VGG19", _add(("intermediates",), {}), "unexpected flax collections"),
]


@pytest.mark.parametrize(
    "name, mutate, error", MISMATCHES, ids=[f"{m[0]}-{i}" for i, m in enumerate(MISMATCHES)]
)
def test_converter_refuses_a_mismatched_family_tree(name, mutate, error, small_trees):
    variables = copy.deepcopy(small_trees(name))
    mutate(variables)
    with pytest.raises(ValueError, match=error):
        cnn_params_from_flax(variables, _meta_module(name))
