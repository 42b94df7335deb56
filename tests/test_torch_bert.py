"""The port's BERT encoder against the JAX package's flax encoder, with the
JAX weights carried across by ``bert_params_from_flax``.

Same ids from a numpy seed on both sides. f32 at atol 1e-4 (matmul and
LayerNorm sum in another order over 4 layers); bf16 at atol 3e-2 (bf16
rounds at slightly different places in the two frameworks)."""

import re
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import bert as jax_bert
from sparkdl_tpu.models import registry as jax_registry
from sparkdl_tpu.ops.flash_attention import (
    make_flash_attention_fn as jax_make_flash,
)
from sparkdl_tpu_torch.models import get_model, param_bytes, supported_models
from sparkdl_tpu_torch.models.bert import (
    BERT_CONFIGS,
    BertConfig,
    BertEncoder,
    bert_base,
    dense_attention,
)
from sparkdl_tpu_torch.models.convert import bert_params_from_flax, expected_keys
from sparkdl_tpu_torch.ops.flash_attention import make_flash_attention_fn

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _hidden_atol(dtype, ref):
    """bf16 hidden states reach |x| ~ 4, where one bf16 step is 3.1e-2:
    3e-2 is below the type's resolution there, and the two frameworks
    round at different places in every layer. They are held to two bf16
    steps at the tensor's largest magnitude; the pooled mean averages the
    rounding away and is held to 3e-2."""
    atol = _DTYPES[dtype][2]
    if dtype == "bfloat16":
        atol = max(atol, 2 * 2.0**-7 * float(np.abs(ref).max()))
    return atol


def _ids(seed, B, L, vocab, lengths):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, size=(B, L)).astype(np.int32)
    for b, n in enumerate(lengths):
        ids[b, n:] = 0
    return ids


def _port_encoder(config, params, attention_fn):
    enc = BertEncoder(config, attention_fn)
    enc.load_state_dict(bert_params_from_flax(params, config))
    return enc.cast_projections().eval()


def _jax_config(cfg: BertConfig, dtype) -> "jax_bert.BertConfig":
    return jax_bert.BertConfig(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        num_layers=cfg.num_layers,
        num_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings,
        dtype=dtype,
    )


@pytest.fixture(scope="module")
def tiny_params():
    module = jax_bert.bert_tiny()
    return module.init(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))


def test_bert_params_from_flax_covers_every_leaf(tiny_params):
    config = BERT_CONFIGS["tiny"]
    state = bert_params_from_flax(tiny_params, config)
    assert set(state) == expected_keys(config)
    enc = _port_encoder(config, tiny_params, None)
    loaded = enc.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(tiny_params["params"])[0]
    assert len(leaves) == len(loaded)
    seen = set()
    for path, leaf in leaves:
        names = [p.key for p in path]
        mods = [re.sub(r"^layer_(\d+)$", r"layers.\1", n) for n in names[:-1]]
        key = ".".join(
            mods + ["bias" if names[-1] == "bias" else "weight"]
        )
        arr = np.asarray(leaf)
        if names[-1] == "kernel":
            arr = arr.T
        np.testing.assert_array_equal(loaded[key].numpy(), arr)
        seen.add(key)
    assert seen == set(loaded)


def test_bert_params_from_flax_refuses_a_mismatched_tree(tiny_params):
    tree = jax.tree_util.tree_map(np.asarray, tiny_params["params"])
    tree = dict(tree)
    del tree["layer_3"]
    with pytest.raises(ValueError, match="missing"):
        bert_params_from_flax({"params": tree}, BERT_CONFIGS["tiny"])
    with pytest.raises(ValueError, match="unexpected"):
        bert_params_from_flax(tiny_params, replace(BERT_CONFIGS["tiny"], num_layers=3))


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_tiny_encoder_matches_jax_dense(tiny_params, dtype, attention):
    dt_j, dt_t, atol = _DTYPES[dtype]
    config = replace(BERT_CONFIGS["tiny"], dtype=dt_t)
    ids = _ids(6, B=3, L=48, vocab=config.vocab_size, lengths=[48, 30, 9])
    mask = (ids != 0).astype(np.int32)
    jax_enc = jax_bert.BertEncoder(
        _jax_config(config, dt_j), attention_fn=jax_bert.dense_attention
    )
    ref_hidden = np.asarray(jax_enc.apply(tiny_params, ids, mask))
    ref_pooled = np.asarray(jax_enc.apply(tiny_params, ids, mask, pooled=True))
    attention_fn = (
        dense_attention if attention == "dense" else make_flash_attention_fn()
    )
    enc = _port_encoder(config, tiny_params, attention_fn)
    with torch.inference_mode():
        t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
        hidden = enc(t_ids, t_mask)
        pooled = enc.embed(t_ids, t_mask)
    assert hidden.dtype == pooled.dtype == torch.float32
    np.testing.assert_allclose(
        hidden.numpy(), ref_hidden, atol=_hidden_atol(dtype, ref_hidden), rtol=0
    )
    np.testing.assert_allclose(pooled.numpy(), ref_pooled, atol=atol, rtol=0)


def test_two_layer_encoder_matches_jax_flash_kernel():
    config = BertConfig(
        vocab_size=64,
        hidden_size=64,
        num_layers=2,
        num_heads=2,
        intermediate_size=128,
        max_position_embeddings=32,
    )
    ids = _ids(7, B=2, L=20, vocab=64, lengths=[20, 13])
    mask = (ids != 0).astype(np.int32)
    jax_enc = jax_bert.BertEncoder(
        _jax_config(config, jnp.float32),
        attention_fn=jax_make_flash(block_q=8, block_k=8, interpret=True),
    )
    params = jax_enc.init(jax.random.PRNGKey(1), jnp.asarray(ids))
    ref = np.asarray(jax_enc.apply(params, ids, mask))
    enc = _port_encoder(config, params, make_flash_attention_fn())
    with torch.inference_mode():
        ours = enc(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=0)


def test_sequence_longer_than_position_table_is_refused():
    mf = get_model("bert-tiny").model_function(device="cpu")
    ids = torch.ones((1, 129), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds bert-tiny's position table"):
        mf(ids)
    assert mf(ids[:, :128]).shape == (1, 128)


def test_mask_is_derived_from_ids_and_padding_never_changes_a_row():
    """ids != 0 is the mask; a row zero-padded to a longer length embeds
    the same, which is what makes bucketing row-identical."""
    mf = get_model("bert-tiny").model_function(device="cpu", seed=3)
    ids = torch.from_numpy(_ids(8, B=2, L=24, vocab=1000, lengths=[24, 10]))
    bare = mf(ids)
    tupled = mf((ids, (ids != 0).to(torch.int32)))
    padded = mf(torch.nn.functional.pad(ids, (0, 40)))
    torch.testing.assert_close(bare, tupled, atol=0, rtol=0)
    torch.testing.assert_close(bare, padded, atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", sorted(BERT_CONFIGS))
def test_configs_match_jax_presets(size):
    ours = BERT_CONFIGS[size]
    ref = jax_bert._SIZES[size]().config
    for field in (
        "vocab_size", "hidden_size", "num_layers", "num_heads",
        "intermediate_size", "max_position_embeddings", "type_vocab_size",
        "layer_norm_eps",
    ):
        assert getattr(ours, field) == getattr(ref, field), field


def test_registry_matches_jax_text_entries(tiny_params):
    names = supported_models(kind="text")
    assert names == jax_registry.supported_models(kind="text")
    # the image slices register every image model of the JAX registry
    # (other tests may register more there)
    images = supported_models(kind="image")
    assert images == ["InceptionV3", "MobileNetV2", "ResNet50", "VGG16", "VGG19", "Xception"]
    assert set(images) <= set(jax_registry.supported_models(kind="image"))
    assert supported_models() == sorted(names + images)
    for name in names:
        ours, ref = get_model(name), jax_registry.get_model(name)
        assert (ours.max_length, ours.feature_dim, ours.vocab_size) == (
            ref.max_length, ref.feature_dim, ref.vocab_size
        )
    # f32 parameter bytes: the port's module and the flax tree agree
    mf = get_model("bert-tiny").model_function(params=tiny_params, device="cpu")
    assert param_bytes(mf) == jax_registry.param_bytes(tiny_params)
    with torch.device("meta"):
        base = bert_base()
    assert param_bytes(base) == jax_registry.get_model("bert-base").param_bytes_estimate()
