"""The port's bf16 serving rung against the JAX package's, on the CPU.

The JAX rung (``graph/precision.apply_precision``) casts every floating
leaf of the model to bfloat16, norms and embeddings included; the port's
(``graph/precision.bf16_rung``, the default serving loader's bf16 build)
must hold the same bytes, to the byte, and the residency manager's
estimate must equal what it builds. Outputs from one flax tree agree
within bf16's own gap: the port upcasts its norms to float32 where the JAX
rung computes BatchNorm in bf16, a difference of the size of the rung
itself (bf16 against f32 is 1.6e-02 for bert-tiny, 1.3e-02 for ResNet50
here), so the limits are about twice that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.graph.precision import apply_precision as jax_apply_precision
from sparkdl_tpu.models import bert as jax_bert
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.models import resnet as jax_resnet
from sparkdl_tpu_torch.graph.precision import bf16_rung
from sparkdl_tpu_torch.models import get_model
from sparkdl_tpu_torch.models.registry import param_bytes
from sparkdl_tpu_torch.serving import residency

#: bert-tiny embeddings, port rung against JAX rung (max |a - b|)
BERT_RUNG_ATOL = 3e-2
#: ResNet50 features, max |a - b| over max |JAX|
RESNET_RUNG_REL = 2e-2

RUNG_MODELS = (("bert-tiny", "embed"), ("MobileNetV2", "features"), ("ResNet50", "features"))


def _jax_rung_bytes(name, mode):
    """The JAX rung's resident bytes: its params tree after
    ``apply_precision`` (shapes only, through ``jax.eval_shape``)."""
    tree = jax.eval_shape(
        lambda: jax_apply_precision(
            jax_registry.get_model(name).model_function(mode=mode, dtype=jnp.bfloat16), "bf16"
        ).params
    )
    return sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize for leaf in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("name,mode", RUNG_MODELS)
def test_rung_holds_the_jax_rungs_bytes_and_the_estimate_is_exact(name, mode):
    mf = residency._default_loader(name, mode, "bf16", device="cpu")
    built = param_bytes(mf)
    assert built == _jax_rung_bytes(name, mode)
    floating = [t for t in list(mf.module.parameters()) + list(mf.module.buffers()) if t.is_floating_point()]
    assert floating and all(t.dtype == torch.bfloat16 for t in floating)
    mgr = residency.ResidencyManager(budget_bytes=2**40, device="cpu")
    assert mgr._estimate_bytes(name, "bf16") == built


@pytest.mark.parametrize("name", ["bert-tiny", "ResNet50"])
def test_native_bf16_build_outside_the_rung_keeps_f32_norms(name):
    """The featurizer's bf16 path builds the same native module without the
    rung: its norms stay float32, as flax's ``param_dtype`` does."""
    mf = get_model(name).model_function(dtype=torch.bfloat16, device="cpu")
    norms = [
        t for m in mf.module.modules()
        if type(m).__name__ in ("BatchNorm", "LayerNorm")
        for t in list(m.parameters()) + list(m.buffers())
    ]
    assert norms and all(t.dtype == torch.float32 for t in norms)


def test_bert_tiny_rung_matches_the_jax_rung(tmp_path):
    params = jax_bert.bert_tiny().init(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
    path = str(tmp_path / "bert_tiny.npz")
    jax_registry.save_flax_weights(params, path)
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 1000, size=(4, 40)).astype(np.int32)
    ids[1, 20:] = 0
    ids[3, 7:] = 0
    ref = np.asarray(jax_apply_precision(
        jax_registry.get_model("bert-tiny").model_function(
            mode="embed", dtype=jnp.bfloat16, weights_file=path), "bf16")(ids))
    mf = bf16_rung(get_model("bert-tiny").model_function(
        mode="embed", dtype=torch.bfloat16, params=params, device="cpu"))
    ours = mf(torch.from_numpy(ids)).numpy()
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= BERT_RUNG_ATOL


def test_resnet50_rung_matches_the_jax_rung(tmp_path):
    variables = jax_resnet.ResNet50().init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    path = str(tmp_path / "resnet50.npz")
    jax_registry.save_flax_weights(variables, path)
    rng = np.random.default_rng(1)
    x = (rng.random((2, 32, 32, 3)) * 255 - 120).astype(np.float32)
    ref = np.asarray(jax_apply_precision(
        jax_registry.get_model("ResNet50").model_function(
            mode="features", dtype=jnp.bfloat16, weights_file=path), "bf16")(x))
    mf = bf16_rung(get_model("ResNet50").model_function(
        mode="features", dtype=torch.bfloat16, weights_file=path, device="cpu"))
    ours = mf(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert np.abs(ours - ref).max() / np.abs(ref).max() <= RESNET_RUNG_REL
