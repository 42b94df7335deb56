"""The port's Keras sequence layers (``sparkdl_tpu_torch/graph/keras_seq.py``
through ``graph/keras_graph.py``) against the JAX package's
``ModelIngest.from_keras`` (Keras 3 on its JAX backend through
``stateless_call``) on the CPU, with the same seeded weights
(``test_torch_keras_graph.randomize``) and the same ids:

- masks: rows of ids with 0 at the front (``pad_sequences``' default), at
  the back, in the middle, everywhere and nowhere; each rule of the
  carriage (made by ``Embedding(mask_zero)`` and ``Masking``; kept by
  Dense, Activation, Dropout, SpatialDropout1D, LayerNormalization,
  BatchNormalization and Rescaling; merged by Add, Multiply and
  Concatenate; dropped by Conv1D, the pools and op nodes; carried into
  and out of a nested model; read by the recurrent layers,
  GlobalAveragePooling1D and MultiHeadAttention);
- Embedding's ids outside the table (``input_dim`` gives a NaN row, -1
  the last row) and float ids;
- Conv1D (valid, same and causal padding, strides, dilation, groups), the
  1-D pools and the global pools;
- SimpleRNN, LSTM and GRU (``reset_after`` both ways, a hard-sigmoid
  recurrent activation, relu, no bias, ``unroll``) with
  ``return_sequences`` on and off, ``go_backwards``, each mask, and both
  routes (``fused``: torch's fused recurrence, ``steps``: the step loop);
- Bidirectional in every merge mode;
- MultiHeadAttention, self and cross, causal, with and without dropout
  (Keras's two paths), the padded query rows, both routes (the flash
  op's plain version on the CPU), the shapes that keep it off the flash
  route, and the masks it takes off its inputs;
- the refusals, naming ROADMAP Queue A item 9.

Tolerance: relative 1e-5 of the largest output (``REL``); NaN where the
JAX package gives NaN. ``.keras``/``.h5`` files and ``KerasTransformer``
are in ``test_torch_keras_seq_io.py``.
"""

import jax
import keras
import numpy as np
import pytest
import torch

from sparkdl_tpu.graph.ingest import ModelIngest as JaxModelIngest
from sparkdl_tpu_torch.graph.ingest import ModelIngest
from sparkdl_tpu_torch.graph.keras_graph import SEQUENCE_CLASSES, KerasModule, layer_module
from sparkdl_tpu_torch.graph.keras_seq import SEQUENCE_MODULES
from test_torch_keras_graph import REL, randomize
from test_torch_keras_weights import fast_init

L = keras.layers
T, VOCAB = 8, 11

#: rows of ids: 0s at the front, at the back, in the middle, every id 0,
#: none 0
IDS = np.array([
    [0, 0, 0, 3, 4, 5, 6, 7],
    [1, 2, 3, 4, 5, 0, 0, 0],
    [1, 2, 0, 4, 5, 0, 7, 8],
    [0, 0, 0, 0, 0, 0, 0, 0],
    [9, 3, 10, 2, 1, 4, 4, 6],
], np.int32)
#: the same without the all-0 row (no NaN from a mean over no steps)
SOME = IDS[[0, 1, 2, 4]]
#: rows whose 0s are one block at the front or the back (the fused route)
RUNS = IDS[[0, 1, 3, 4]]


@pytest.fixture(autouse=True)
def _fast_keras_init():
    """Keras's initializers compile one JAX program per weight shape; the
    tests draw every weight with ``randomize`` anyway."""
    with fast_init():
        yield


def jax_out(model, x):
    """The JAX package's ModelFunction of ``model`` over ``x`` (its fn
    under one ``jax.jit``: one compile, not one per op)."""
    mf = JaxModelIngest.from_keras(model)
    y = jax.jit(mf.fn)(mf.params, x)
    return [np.asarray(t) for t in y] if isinstance(y, (list, tuple)) else np.asarray(y)


def port_module(model) -> KerasModule:
    return ModelIngest.from_keras(model, device="cpu").module


def run(module, x):
    """``module`` over numpy ``x``, outputs as numpy."""
    with torch.no_grad():
        y = module(torch.from_numpy(x))
    return [t.numpy() for t in y] if isinstance(y, list) else y.numpy()


def port_out(model, x):
    y = ModelIngest.from_keras(model, device="cpu")(torch.from_numpy(x))
    return [t.numpy() for t in y] if isinstance(y, list) else y.numpy()


def assert_close(ours, ref, rel=REL):
    if isinstance(ref, list):
        assert isinstance(ours, list) and len(ours) == len(ref)
        for a, b in zip(ours, ref):
            assert_close(a, b, rel)
        return
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    scale = np.nanmax(np.abs(ref))
    assert scale > 0
    err = np.nanmax(np.abs(ours - ref)) / scale
    assert err <= rel, err


def check(model, x=IDS, seed=3):
    randomize(model, seed=seed)
    assert_close(port_out(model, x), jax_out(model, x))


def ids_model(*layers, mask_zero=True, width=6):
    return keras.Sequential([L.Input((T,), dtype="int32"), L.Embedding(VOCAB, width, mask_zero=mask_zero),
                             *layers])


def test_the_sequence_modules_are_the_listed_classes():
    assert set(SEQUENCE_MODULES) == set(SEQUENCE_CLASSES)


# -- the mask carriage ------------------------------------------------------------------

MASK_CASES = {
    # made, and read by the masked mean
    "embedding": lambda: ids_model(L.GlobalAveragePooling1D()),
    # kept by the layers Keras marks supports_masking
    "kept": lambda: ids_model(L.Dense(5, activation="tanh"), L.Activation("relu"), L.Dropout(0.3),
                              L.SpatialDropout1D(0.3), L.LayerNormalization(), L.BatchNormalization(),
                              L.Rescaling(2.0, 0.5), L.GlobalAveragePooling1D()),
    # dropped by layers that do not support masking
    "conv1d-drops": lambda: ids_model(L.Conv1D(4, 3, padding="same"), L.GlobalAveragePooling1D()),
    "pool-drops": lambda: ids_model(L.MaxPooling1D(1), L.GlobalAveragePooling1D()),
    "keepdims": lambda: ids_model(L.GlobalAveragePooling1D(keepdims=True)),
    # a nested model takes the mask in and gives its output's back
    "nested": lambda: ids_model(keras.Sequential([L.Dense(4), L.LSTM(3, return_sequences=True)]),
                                L.GlobalAveragePooling1D()),
}


def _merge_model(kind: str, both: bool):
    """Two masked branches (or one and an unmasked one) merged, then the
    sequence and the masked mean."""
    inp = L.Input((T,), dtype="int32")
    a = L.Embedding(VOCAB, 4, mask_zero=True)(inp)
    if both:
        b = L.LSTM(4, return_sequences=True)(L.Embedding(VOCAB, 4, mask_zero=True)(inp))
    else:
        b = L.Conv1D(4, 1)(a)
    merged = {"add": L.Add, "multiply": L.Multiply}[kind]()([a, b]) if kind != "concatenate" else \
        L.Concatenate()([a, b])
    return keras.Model(inp, [merged, L.GlobalAveragePooling1D()(merged)])


@pytest.mark.parametrize("case", sorted(MASK_CASES) + ["op-node-drops", "masking-layer", "merge-add-both",
                                                       "merge-add-one", "merge-multiply-both",
                                                       "merge-multiply-one", "merge-concatenate-both",
                                                       "merge-concatenate-one", "concatenate-time-axis"])
def test_mask_rules(case):
    if case in MASK_CASES:
        check(MASK_CASES[case]())
        return
    if case.startswith("merge-"):
        _, kind, both = case.split("-")
        check(_merge_model(kind, both == "both"), SOME)
        return
    if case == "op-node-drops":
        inp = L.Input((T,), dtype="int32")
        x = L.Embedding(VOCAB, 4, mask_zero=True)(inp)
        model = keras.Model(inp, L.GlobalAveragePooling1D()(x * 2.0 + 1.0))
    elif case == "concatenate-time-axis":
        inp = L.Input((T,), dtype="int32")
        a = L.Embedding(VOCAB, 4, mask_zero=True)(inp)
        model = keras.Model(inp, L.LSTM(3)(L.Concatenate(axis=1)([a, L.Dense(4)(a), L.Conv1D(4, 1)(a)])))
    else:  # Masking over float steps, some all 0
        model = keras.Sequential([L.Input((T, 3)), L.Masking(0.0), L.LSTM(4, return_sequences=True)])
        x = np.random.default_rng(2).normal(size=(4, T, 3)).astype(np.float32)
        x[0, :3] = 0.0
        x[1, 5:] = 0.0
        x[2, 2] = 0.0
        x[3, 4, 1] = 0.0  # one feature 0 does not mask the step
        check(model, x)
        return
    check(model, SOME)


# -- Embedding ---------------------------------------------------------------------------


def test_embedding_ids_outside_the_table():
    """``input_dim`` and beyond give NaN rows, ``-1`` the last row and
    ``-input_dim`` the first, as ``jnp.take`` on Keras's JAX backend; the
    port never indexes outside the table."""
    model = randomize(ids_model(mask_zero=False))
    x = np.array([[0, VOCAB - 1, VOCAB, VOCAB + 5, -1, -VOCAB, -VOCAB - 1, 3]], np.int32)
    ours, ref = port_out(model, x), jax_out(model, x)
    assert np.isnan(ref[0, [2, 3, 6]]).all() and not np.isnan(ref[0, [0, 1, 4, 5, 7]]).any()
    np.testing.assert_array_equal(ours, ref)
    table = model.layers[0].get_weights()[0]
    np.testing.assert_array_equal(ours[0, 4], table[-1])


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_embedding_takes_float_ids_as_keras_casts_them(dtype):
    """A float batch into an integer Input, or float ids into a float
    Input: both truncate as Keras does; the mask reads the ids as given."""
    model = keras.Sequential([L.Input((T,), dtype=dtype), L.Embedding(VOCAB, 4, mask_zero=True),
                              L.GlobalAveragePooling1D()])
    randomize(model)
    x = SOME.astype(np.float32) + np.float32(0.25)
    x[0, 0] = 0.0
    module = port_module(model)
    assert module.integer_input == (dtype == "int32")
    ours = run(module, x)
    assert_close(ours, jax_out(model, x if dtype == "float32" else x.astype(np.int32)))


# -- convolutions and pools ----------------------------------------------------------------

CONV_CASES = {
    "valid": lambda: L.Conv1D(4, 3),
    "same-odd": lambda: L.Conv1D(4, 3, strides=2, padding="same"),
    "same-even": lambda: L.Conv1D(4, 2, padding="same", activation="relu"),
    "causal-dilated": lambda: L.Conv1D(4, 3, padding="causal", dilation_rate=2),
    "groups-nobias": lambda: L.Conv1D(4, 3, groups=2, use_bias=False),
    "max-same": lambda: L.MaxPooling1D(3, strides=2, padding="same"),
    "avg-same": lambda: L.AveragePooling1D(3, strides=2, padding="same"),
    "avg-valid": lambda: L.AveragePooling1D(2),
    "global-max": lambda: L.GlobalMaxPooling1D(),
    "global-max-keepdims": lambda: L.GlobalMaxPooling1D(keepdims=True),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_and_pools(case):
    check(ids_model(CONV_CASES[case](), mask_zero=False), IDS)


# -- recurrences ------------------------------------------------------------------------------

CELLS = {
    "lstm": lambda **kw: L.LSTM(5, **kw),
    "gru": lambda **kw: L.GRU(5, **kw),
    "gru-reset-before": lambda **kw: L.GRU(5, reset_after=False, **kw),
    "simple-rnn": lambda **kw: L.SimpleRNN(5, **kw),
    "simple-rnn-relu": lambda **kw: L.SimpleRNN(5, activation="relu", **kw),
    "lstm-hard-sigmoid": lambda **kw: L.LSTM(5, recurrent_activation="hard_sigmoid", **kw),
    "lstm-nobias-unrolled": lambda **kw: L.LSTM(5, use_bias=False, unroll=True, **kw),
}
#: cells with a fused form
FUSED = {"lstm", "gru", "simple-rnn", "simple-rnn-relu", "lstm-nobias-unrolled"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_recurrent_layers(cell):
    """The cell with ``return_sequences`` off and on, each forwards and
    backwards (four branches of one model), over rows whose masks are one
    run of steps each and then over rows with a hole."""
    inp = L.Input((T,), dtype="int32")
    x = L.Embedding(VOCAB, 6, mask_zero=True)(inp)
    layers = [CELLS[cell](return_sequences=seq, go_backwards=back) for seq in (False, True) for back in (False, True)]
    model = randomize(keras.Model(inp, [layer(x) for layer in layers]), seed=4)
    ref = jax_out(model, IDS)
    module = port_module(model)
    for rows in (RUNS, IDS):
        picked = [list(map(list, IDS)).index(list(r)) for r in rows]
        assert_close(run(module, rows), [r[picked] for r in ref])
    fused = 1 if cell in FUSED else 0
    for layer in layers:
        assert layer_module(module, layer.name).route_calls == {"fused": fused, "steps": 2 - fused}


def test_zero_output_for_mask():
    check(ids_model(L.LSTM(4, return_sequences=True, zero_output_for_mask=True)))
    check(ids_model(L.GRU(4, zero_output_for_mask=True)), SOME)


@pytest.mark.parametrize("merge_mode", ["concat", "sum", "mul", "ave"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bidirectional(cell, merge_mode):
    layer = CELLS[cell]
    model = ids_model(L.Bidirectional(layer(return_sequences=True), merge_mode=merge_mode),
                      L.Bidirectional(layer(), merge_mode=merge_mode))
    check(model)


def test_bidirectional_with_its_own_backward_layer():
    model = ids_model(L.Bidirectional(L.LSTM(4, return_sequences=True),
                                      backward_layer=L.GRU(3, return_sequences=True, go_backwards=True)))
    check(model)


# -- attention --------------------------------------------------------------------------------


def _attention_model(kind: str, heads: int, key_dim: int, dropout: float, width: int, **kw):
    inp = L.Input((T,), dtype="int32")
    x = L.Embedding(VOCAB, width, mask_zero=True)(inp)
    mha = L.MultiHeadAttention(heads, key_dim, dropout=dropout, **kw)
    if kind == "self":
        y = mha(x, x)
    elif kind == "causal":
        y = mha(x, x, use_causal_mask=True)
    elif kind == "cross-key":
        y = mha(x, L.Dense(width)(x), key=L.Conv1D(width, 1)(x))  # the key carries no mask
    else:  # cross: the value another masked tensor
        y = mha(x, L.LSTM(width, return_sequences=True)(x))
    return keras.Model(inp, [y, L.GlobalAveragePooling1D()(L.LayerNormalization()(y))])


ATTENTION_CASES = {
    # name: (kind, heads, key_dim, dropout, width, kw, route)
    "self-flash": ("self", 2, 32, 0.0, 24, {}, "flash"),
    "self-flash-dropout": ("self", 2, 64, 0.1, 16, {}, "flash"),
    "self-flash-nobias": ("self", 3, 32, 0.0, 8, {"use_bias": False}, "flash"),
    "self-head-dim-16": ("self", 2, 16, 0.1, 8, {}, "plain"),
    # (Keras's dot-product attention takes no value_dim of its own: dropout)
    "self-value-dim": ("self", 2, 32, 0.1, 8, {"value_dim": 16}, "plain"),
    "self-output-shape": ("self", 2, 32, 0.0, 8, {"output_shape": 5}, "flash"),
    "causal": ("causal", 2, 32, 0.0, 8, {}, "plain"),
    "causal-dropout": ("causal", 2, 8, 0.1, 8, {}, "plain"),
    "cross": ("cross", 2, 32, 0.0, 8, {}, "plain"),
    "cross-dropout": ("cross", 2, 4, 0.1, 8, {}, "plain"),
    "cross-key": ("cross-key", 2, 32, 0.0, 8, {}, "plain"),
}


@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_multi_head_attention(case):
    kind, heads, key_dim, dropout, width, kw, route = ATTENTION_CASES[case]
    model = randomize(_attention_model(kind, heads, key_dim, dropout, width, **kw), seed=6)
    ref = jax_out(model, IDS)
    module = port_module(model)
    assert module.attention_routes() == {"flash": int(route == "flash"), "plain": int(route == "plain")}
    ours = run(module, IDS)
    assert_close(ours, ref)
    if kind != "self":
        return
    # a row's padded queries attend to nothing under Keras's masked
    # softmax (dropout): the output projection's bias; under its
    # dot-product attention to every key alike: the mean of V, projected
    bias = [layer for layer in model.layers if isinstance(layer, L.MultiHeadAttention)][0].get_weights()[-1]
    for row, seq in zip(IDS, ours[0]):
        padded = seq[row == 0]
        if len(padded):
            np.testing.assert_allclose(padded, np.broadcast_to(padded[:1], padded.shape), rtol=0, atol=1e-5)
        if len(padded) and dropout > 0 and kw.get("use_bias", True):
            np.testing.assert_allclose(padded, np.broadcast_to(bias, padded.shape), rtol=0, atol=1e-6)


def test_attention_takes_the_masks_off_its_inputs():
    """Keras's MultiHeadAttention clears the masks its inputs carry when it
    runs, so in residual blocks (``Add([x, mha(x, x)])``) the mask dies
    after the first: the second attention runs unmasked, while the masked
    mean at the end, whose ``mask`` argument the model recorded when it
    was built, still reads the ids' mask."""
    inp = L.Input((T,), dtype="int32")
    x = L.Embedding(VOCAB, 16, mask_zero=True)(inp)
    for _ in range(2):
        x = L.LayerNormalization()(L.Add()([x, L.MultiHeadAttention(2, 32, dropout=0.1)(x, x)]))
    model = randomize(keras.Model(inp, [x, L.GlobalAveragePooling1D()(x)]), seed=6)
    module = port_module(model)
    seen = []
    for layer in model.layers:
        if isinstance(layer, L.MultiHeadAttention):
            layer_module(module, layer.name).register_forward_hook(lambda m, args, y: seen.append(args[1]))
    assert_close(run(module, IDS), jax_out(model, IDS))
    assert seen[0][0] is not None and seen[0][1] is not None
    assert seen[1] is None or all(m is None for m in seen[1])


def test_the_seeded_attention_is_not_uniform():
    """Under ``randomize``'s weights the softmax of the self-attention case
    is far from uniform, so a wrong mask or scale would show."""
    model = randomize(_attention_model("self", 2, 32, 0.0, 24), seed=6)
    module = port_module(model)
    emb, mha = (layer_module(module, layer.name) for layer in model.layers[1:3])
    with torch.no_grad():
        x = emb(torch.from_numpy(IDS[4:]))
        q, k = mha._heads(x, "query", 32), mha._heads(x, "key", 32)
    p = torch.softmax(torch.einsum("btnh,bsnh->bnts", q, k) / np.sqrt(32), dim=-1)
    assert float(p.max()) > 2.0 / T and float(p.min()) < 0.5 / T


# -- refusals --------------------------------------------------------------------------------

REFUSALS = {
    "return-state": (lambda: keras.Model(*_return_state()), "return_state=True"),
    "stateful": (lambda: keras.Sequential([L.Input(batch_shape=(2, T, 3)), L.LSTM(3, stateful=True)]),
                 "stateful=True"),
    "recurrent-activation": (lambda: keras.Sequential([L.Input((T, 3)), L.GRU(3, recurrent_activation="elu")]),
                             "activation 'elu'"),
    "bidirectional-merge-none": (lambda: keras.Model(*_merge_none()), "merge_mode=None"),
    "attention-scores": (lambda: keras.Model(*_attention_scores()), "return_attention_scores"),
}


def _return_state():
    inp = L.Input((T, 3))
    out, _, _ = L.LSTM(3, return_state=True)(inp)
    return inp, out


def _merge_none():
    inp = L.Input((T, 3))
    fwd, bwd = L.Bidirectional(L.LSTM(3), merge_mode=None)(inp)
    return inp, L.Add()([fwd, bwd])


def _attention_scores():
    inp = L.Input((T, 6))
    out, _ = L.MultiHeadAttention(2, 3)(inp, inp, return_attention_scores=True)
    return inp, out


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_sequence_refusals(case):
    build, match = REFUSALS[case]
    with pytest.raises(NotImplementedError, match=match) as err:
        ModelIngest.from_keras(build(), device="cpu")
    assert "ROADMAP Queue A item 9" in str(err.value)


def test_attention_axes_other_than_the_sequence_are_refused():
    inp = L.Input((4, T, 6))
    model = keras.Model(inp, L.MultiHeadAttention(2, 3, attention_axes=(2,))(inp, inp))
    with pytest.raises(NotImplementedError, match="attention_axes") as err:
        ModelIngest.from_keras(model, device="cpu")
    assert "ROADMAP Queue A item 9" in str(err.value)
