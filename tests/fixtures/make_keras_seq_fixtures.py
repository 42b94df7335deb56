"""Write the Keras sequence-model fixtures of ``chip_smoke.py`` phase 31
and ``tests/test_torch_keras_seq_io.py``.

Run from the repo root (needs keras 3 on its JAX backend)::

    KERAS_BACKEND=jax JAX_PLATFORMS=cpu python3 tests/fixtures/make_keras_seq_fixtures.py

- ``keras_seq/<name>.json.gz``: the config of each model of
  :func:`build` (``chip_smoke.SEQ_IMDB_MODELS`` and
  ``chip_smoke.SEQ_BERT_MODEL``), built right after
  ``keras.backend.clear_session()`` so that its automatic layer names do
  not depend on what was built before;
- ``keras_seq/outputs.npz``: Keras's own outputs for
  ``chip_smoke.KERAS_SEQ_ROWS`` rows of ``chip_smoke._keras_seq_rows(name,
  n, stored=True)`` under ``chip_smoke._seeded_seq_weights(config)``, from
  ``chip_smoke._keras_seq_heads(name, config)``: the IMDB models' logit
  (``<name>/logits``), the encoder's sequence output at
  ``chip_smoke.SEQ_BERT_POSITIONS`` (``<name>/sequence``) and its logits,
  with the ids' sum (``<name>/x_sum``) to show the same draw later.

No weights are committed: the seed rebuilds them.
"""

from __future__ import annotations

import gzip
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "keras_seq")


def build(name: str):
    """The Keras model ``name``, built from code: the keras-io
    "Bidirectional LSTM on IMDB" model (keras.io/examples/nlp/
    bidirectional_lstm_imdb) as published, with ``mask_zero=True``, and
    its GRU copy; an encoder at bert-base's published widths
    (``uncased_L-12_H-768_A-12/bert_config.json``) from core layers."""
    import keras

    import chip_smoke as cs

    L = keras.layers
    keras.backend.clear_session()
    if name == cs.SEQ_BERT_MODEL:
        c = cs.SEQ_BERT
        inp = keras.Input((c["length"],), dtype="int32")
        x = L.Embedding(c["vocab"], c["hidden"], mask_zero=True)(inp)
        for _ in range(c["blocks"]):
            a = L.MultiHeadAttention(c["heads"], c["head_dim"], dropout=c["dropout"])(x, x)
            x = L.LayerNormalization(epsilon=c["ln_eps"])(L.Add()([x, L.Dropout(c["dropout"])(a)]))
            f = L.Dense(c["hidden"])(L.Dense(c["intermediate"], activation="gelu")(x))
            x = L.LayerNormalization(epsilon=c["ln_eps"])(L.Add()([x, L.Dropout(c["dropout"])(f)]))
        return keras.Model(inp, L.Dense(2)(L.GlobalAveragePooling1D()(x)))
    c = cs.SEQ_IMDB
    cell = L.GRU if "gru" in name else L.LSTM
    inp = keras.Input((None,), dtype="int32")
    x = L.Embedding(c["vocab"], c["width"], mask_zero=name.endswith("_masked"))(inp)
    x = L.Bidirectional(cell(c["units"], return_sequences=True))(x)
    x = L.Bidirectional(cell(c["units"]))(x)
    return keras.Model(inp, L.Dense(1, activation="sigmoid")(x))


def config_of(name: str) -> dict:
    """``build(name)``'s config as JSON gives it back."""
    return json.loads(json.dumps(build(name).get_config()))


def write() -> None:
    import chip_smoke as cs
    from make_keras_apps_fixtures import keras_model

    os.makedirs(OUT, exist_ok=True)
    stored = {}
    for name in (*cs.SEQ_IMDB_MODELS, cs.SEQ_BERT_MODEL):
        config = config_of(name)
        path = os.path.join(OUT, f"{name}.json.gz")
        with open(path, "wb") as raw:
            with gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as f:
                f.write(json.dumps(config, sort_keys=True).encode())
        weights = cs._seeded_seq_weights(config)
        model = keras_model(cs._keras_seq_heads(name, config), weights)
        x = cs._keras_seq_rows(name, cs.KERAS_SEQ_ROWS, stored=True)
        y = model.predict(x, verbose=0)
        if name == cs.SEQ_BERT_MODEL:
            seq, logits = y
            stored[f"{name}/sequence"] = np.asarray(seq, np.float32)[:, list(cs.SEQ_BERT_POSITIONS)]
        else:
            logits = y
        stored[f"{name}/logits"] = np.asarray(logits, np.float32)
        stored[f"{name}/x_sum"] = np.int64(x.astype(np.int64).sum())
        print(f"{name}: config {os.path.getsize(path)} bytes gzipped; logits {np.asarray(logits).ravel()[:8]}")
    np.savez_compressed(os.path.join(OUT, "outputs.npz"), **stored)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.path.insert(0, HERE)
    write()
