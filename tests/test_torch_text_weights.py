"""Text weight files for the port's registry (``weights_file`` on the text
entries) and ``load_hf_bert_params`` (``sparkdl_tpu_torch/models/bert.py``),
against the JAX package on the CPU.

- A bert-tiny flax tree saved by the JAX package's ``save_flax_weights``
  loads through the port's ``weights_file``: its embeddings equal the
  model built from the same tree as ``params`` exactly, and the JAX
  registry's on the same file within 1e-4 (f32; the port's attention is
  the flash kernel's plain version on the CPU, the JAX one its dense
  einsum).
- ``bert_params_to_flax`` is the inverse of ``bert_params_from_flax``.
- A Hugging Face ``FlaxBertModel`` params dict, built in-test from the
  same tree (with the HF pooler the port does not use), maps through the
  port's ``load_hf_bert_params`` to the JAX package's tree leaf for leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import bert as jax_bert
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu_torch.models import get_model
from sparkdl_tpu_torch.models.bert import BERT_CONFIGS, load_hf_bert_params
from sparkdl_tpu_torch.models.convert import bert_params_from_flax, bert_params_to_flax

ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    params = jax_bert.bert_tiny().init(jax.random.PRNGKey(3), jnp.zeros((1, 16), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    path = str(tmp_path_factory.mktemp("bert") / "tiny.npz")
    jax_registry.save_flax_weights(params, path)
    return params, path


def _ids(seed=0, n=3, length=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 1000, size=(n, length)).astype(np.int32)
    for b, keep in enumerate((length, 17, 5)[:n]):
        ids[b, keep:] = 0
    return ids


def _flat(tree, prefix=()):
    for key, sub in tree.items():
        if hasattr(sub, "items"):
            yield from _flat(sub, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(sub)


def test_weights_file_matches_params_and_jax(tiny):
    params, path = tiny
    ids = _ids()
    spec = get_model("bert-tiny")
    from_file = spec.model_function(weights_file=path, device="cpu")(torch.from_numpy(ids)).numpy()
    from_params = spec.model_function(params=params, device="cpu")(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(from_file, from_params)
    ref = jax_registry.get_model("bert-tiny").model_function(weights_file=path)
    want = np.asarray(jax.jit(ref.fn)(ref.params, ids))
    assert from_file.shape == want.shape == (3, 128)
    assert float(np.abs(from_file - want).max()) <= ATOL
    with pytest.raises(ValueError, match="params or weights_file"):
        spec.model_function(params=params, weights_file=path, device="cpu")


def test_params_to_flax_is_the_inverse(tiny):
    params, _ = tiny
    mf = get_model("bert-tiny").model_function(params=params, device="cpu")
    back = dict(_flat(bert_params_to_flax(mf.module)))
    want = dict(_flat(params))
    assert sorted(back) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(back[key], value, err_msg=str(key))


def _to_hf(params) -> dict:
    """The FlaxBertModel layout of a flax BertEncoder tree (the inverse of
    the JAX ``load_hf_bert_params``), plus an HF pooler."""
    p = params["params"]
    emb = p["embeddings"]
    hf = {
        "embeddings": {
            "word_embeddings": emb["word_embeddings"],
            "position_embeddings": emb["position_embeddings"],
            "token_type_embeddings": emb["token_type_embeddings"],
            "LayerNorm": emb["layer_norm"],
        },
        "encoder": {"layer": {}},
        "pooler": {"dense": {"kernel": np.ones((128, 128), np.float32), "bias": np.zeros(128, np.float32)}},
    }
    for i in range(BERT_CONFIGS["tiny"].num_layers):
        layer = p[f"layer_{i}"]
        att = layer["attention"]
        hf["encoder"]["layer"][str(i)] = {
            "attention": {
                "self": {"query": att["query"], "key": att["key"], "value": att["value"]},
                "output": {"dense": att["output"], "LayerNorm": layer["attention_norm"]},
            },
            "intermediate": {"dense": layer["intermediate"]},
            "output": {"dense": layer["mlp_output"], "LayerNorm": layer["output_norm"]},
        }
    return hf


def test_load_hf_bert_params_matches_jax(tiny):
    params, _ = tiny
    hf = _to_hf(params)
    ours = load_hf_bert_params(hf, BERT_CONFIGS["tiny"])
    ref = jax_bert.load_hf_bert_params(hf, jax_bert.bert_tiny().config)
    got, want = dict(_flat(ours)), dict(_flat(ref))
    assert sorted(got) == sorted(want) == sorted(dict(_flat(params)))
    for key, value in want.items():
        assert got[key].dtype == value.dtype
        np.testing.assert_array_equal(got[key], value, err_msg=str(key))
    state = bert_params_from_flax(ours, BERT_CONFIGS["tiny"])
    mf = get_model("bert-tiny").model_function(params=params, device="cpu")
    for key, value in mf.module.state_dict().items():
        assert torch.equal(state[key], value), key
