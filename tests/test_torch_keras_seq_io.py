"""The Keras sequence layers of the port (``graph/keras_seq.py``) from
files and through ``KerasTransformer``, on the CPU:

- a ``.keras`` archive and a legacy ``.h5`` file of a model whose weights
  sit below the layer's own group (an LSTM's and a GRU's under their
  cells, a Bidirectional's under its two layers, a MultiHeadAttention's
  under four EinsumDense sublayers), one of them in a nested model with a
  frozen Bidirectional (the legacy file lists its trainable variables
  first): each layer's arrays are the saved model's, and the port's
  output is the JAX package's ``from_keras_file``'s;
- ``KerasTransformer`` over a column of token ids (the default float32
  input, a None cell, two partitions) for a recurrent model and an
  attention encoder (the flash route): each row the JAX package's
  ``KerasTransformer`` gives;
- ``chip_smoke.py`` phase 31's fixtures (``tests/fixtures/keras_seq/``):
  each committed config is the installed keras's build, the port at the
  IMDB models' full width matches the Keras outputs stored beside them
  (relative 1e-4, phase 31's limit), and the seeded LSTM gates stay off
  saturation.

Tolerance: relative 1e-5 of the largest output (``REL``) but where
stated.
"""

import os
import sys

import keras
import numpy as np
import pytest
import torch

from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.graph.ingest import ModelIngest as JaxModelIngest
from sparkdl_tpu.transformers import KerasTransformer as JaxKerasTransformer
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.graph.ingest import ModelIngest
from sparkdl_tpu_torch.graph.keras_file import read_keras_file
from sparkdl_tpu_torch.graph.keras_graph import walk_layers
from sparkdl_tpu_torch.transformers import KerasTransformer
from test_torch_keras_apps import chip_smoke
from test_torch_keras_graph import REL, randomize, rel
from test_torch_keras_seq import IDS, T, VOCAB, port_module
from test_torch_keras_weights import fast_init

L = keras.layers
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(autouse=True)
def _fast_keras_init():
    with fast_init():
        yield


def _filed_model():
    inp = L.Input((T,), dtype="int32")
    x = L.Embedding(VOCAB, 6, mask_zero=True)(inp)
    x = L.Conv1D(6, 3, padding="causal")(x)
    x = L.Bidirectional(L.GRU(4, return_sequences=True), merge_mode="sum")(x)
    inner = keras.Sequential([L.Input((T, 4)), L.Bidirectional(L.LSTM(3, return_sequences=True), name="frozen_bi"),
                              L.Dense(8)], name="inner")
    x = inner(x)
    x = L.MultiHeadAttention(2, 4)(x, x)
    x = L.SimpleRNN(5)(x)
    model = randomize(keras.Model(inp, L.Dense(2)(x), name="seq_filed"), seed=7)
    inner.get_layer("frozen_bi").trainable = False
    return model


@pytest.mark.parametrize("ext", ["keras", "h5"])
def test_a_sequence_model_file(tmp_path, ext):
    model = _filed_model()
    path = str(tmp_path / f"m.{ext}")
    model.save(path)
    spec = read_keras_file(path)
    for layer_path, _, _, _ in walk_layers(model.get_config()):
        got, real = spec, model
        for name in layer_path.split("/"):
            got, real = got.get_layer(name), real.get_layer(name)
        want = real.get_weights()
        assert len(got.get_weights()) == len(want), layer_path
        for a, b in zip(got.get_weights(), want):
            np.testing.assert_array_equal(a, b)
    mf = ModelIngest.from_keras_file(path, device="cpu")
    ours = mf(torch.from_numpy(IDS)).numpy()
    assert rel(ours, np.asarray(JaxModelIngest.from_keras_file(path)(IDS))) <= REL


def _recurrent_model():
    inp = L.Input((T,), dtype="int32")
    x = L.Embedding(VOCAB, 6, mask_zero=True)(inp)
    x = L.Bidirectional(L.LSTM(4, return_sequences=True))(x)
    return keras.Model(inp, L.Dense(1, activation="sigmoid")(L.Bidirectional(L.GRU(3))(x)))


def _attention_model():
    inp = L.Input((T,), dtype="int32")
    x = L.Embedding(VOCAB, 16, mask_zero=True)(inp)
    a = L.MultiHeadAttention(2, 32, dropout=0.1)(x, x)
    x = L.LayerNormalization()(L.Add()([x, a]))
    return keras.Model(inp, L.Dense(3)(L.GlobalAveragePooling1D()(x)))


@pytest.mark.parametrize("kind", ["recurrent", "attention"])
def test_keras_transformer_over_token_ids(kind):
    model = randomize(_recurrent_model() if kind == "recurrent" else _attention_model(), seed=8)
    cells = [row for row in IDS[[0, 1, 2, 4]]] + [None, IDS[4][::-1].copy()]
    ours = KerasTransformer(inputCol="ids", outputCol="p", model=model, batchSize=2, device="cpu")
    routes = ours.getModelFunction().module.attention_routes()
    assert routes == {"flash": int(kind == "attention"), "plain": 0}
    got = [r["p"] for r in ours.transform(DataFrame.fromColumns({"ids": cells}, numPartitions=2)).collect()]
    ref = JaxKerasTransformer(inputCol="ids", outputCol="p", model=model, batchSize=2)
    want = [r["p"] for r in ref.transform(JaxDataFrame.fromColumns({"ids": cells}, numPartitions=2)).collect()]
    assert len(got) == len(want) == len(cells)
    for g, w, cell in zip(got, want, cells):
        if cell is None:
            assert g is None and w is None
            continue
        assert np.asarray(g).shape == np.asarray(w).shape == ((1,) if kind == "recurrent" else (3,))
        assert rel(np.asarray(g), np.asarray(w)) <= REL


# -- chip_smoke.py phase 31's fixtures -----------------------------------------------------------


def _fixture_maker():
    chip_smoke()  # the repo root on the path, for the maker's own import
    sys.path.insert(0, FIXTURES)
    try:
        import make_keras_seq_fixtures as make
    finally:
        sys.path.remove(FIXTURES)
    return make


@pytest.mark.parametrize("name", ["imdb_bilstm", "imdb_bilstm_masked", "imdb_bigru_masked", "bert_encoder"])
def test_committed_config_is_this_keras(name):
    assert _fixture_maker().config_of(name) == chip_smoke()._keras_seq_config(name)


@pytest.mark.parametrize("name", ["imdb_bilstm", "imdb_bilstm_masked", "imdb_bigru_masked"])
def test_imdb_models_at_full_width_against_the_stored_keras_outputs(name):
    cs = chip_smoke()
    config = cs._keras_seq_config(name)
    with np.load(os.path.join(cs.KERAS_SEQ_DIR, "outputs.npz")) as f:
        stored = {k: f[k] for k in f.files}
    errs, mf = cs._keras_seq_check(name, config, cs._seeded_seq_weights(config), stored, "cpu")
    assert max(errs) <= cs.KERAS_SEQ_REL, errs
    rnns = [m for m in mf.module.modules() if type(m).__name__ == "_Recurrent"]
    # without a mask the four recurrences run fused; with it the stored
    # rows, one with a 0 inside its tokens, run step by step
    routes = {r: sum(m.route_calls[r] for m in rnns) for r in ("fused", "steps")}
    assert routes == ({"fused": 0, "steps": 4} if name.endswith("_masked") else {"fused": 4, "steps": 0})


def test_the_seeded_lstm_gates_do_not_saturate():
    cs = chip_smoke()
    config = cs._keras_seq_config("imdb_bilstm")
    module = port_module(cs.KerasModelSpec(config, cs._seeded_seq_weights(config)))
    x = torch.from_numpy(cs._keras_seq_rows("imdb_bilstm", 8, seed=31))
    open_share, mid_share = cs._lstm_gate_shares(module, config, x)
    assert open_share >= cs.SEQ_GATES_OPEN and mid_share <= cs.SEQ_GATES_MID, (open_share, mid_share)
