#!/usr/bin/env python3
"""Write the small Keras CNN fixtures that the port reads without keras or
h5py (``chip_smoke.py`` phase 15(a), on a machine that has neither, and
``tests/test_torch_hdf5.py``):

- ``keras_cnn.keras``: the model as a ``.keras`` archive;
- ``keras_cnn.h5``: the same model as a legacy ``.h5`` model file;
- ``keras_cnn.weights.h5``: its weights alone, as ``save_weights`` writes
  them (no config: they map onto ``keras_cnn.keras``'s layers);
- ``keras_cnn_io.npz``: a seeded input batch ``x`` (NHWC float32) and the
  model's output ``y`` from ``model.predict``.

The model (16x16x3 in, 5 softmax classes) holds a Conv2D with a bias,
BatchNormalization with drawn statistics, DepthwiseConv2D,
SeparableConv2D, pooling and a Dense head; its weights are drawn from a
seed. A few KB in all. Needs keras and h5py; run from the repository
root:

    KERAS_BACKEND=jax python3 tests/fixtures/make_keras_cnn_fixtures.py
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 15


def build():
    import keras

    L = keras.layers
    inp = L.Input((16, 16, 3), name="image")
    x = L.Conv2D(8, 3, strides=2, padding="same", name="stem")(inp)
    x = L.BatchNormalization(epsilon=1.001e-5, name="stem_bn")(x)
    x = L.ReLU(6.0, name="stem_relu")(x)
    x = L.DepthwiseConv2D(3, padding="same", use_bias=False, name="dw")(x)
    x = L.BatchNormalization(name="dw_bn")(x)
    x = L.Activation("relu")(x)
    x = L.SeparableConv2D(12, 3, padding="same", name="sep")(x)
    x = L.MaxPooling2D(2, name="pool")(x)
    x = L.GlobalAveragePooling2D(name="gap")(x)
    out = L.Dense(5, activation="softmax", name="head")(x)
    model = keras.Model(inp, out, name="keras_cnn")
    rng = np.random.default_rng(SEED)
    for layer in model.layers:
        weights = layer.get_weights()
        if not weights:
            continue
        if isinstance(layer, L.BatchNormalization):
            new = [rng.uniform(0.5, 1.5, weights[0].shape), rng.normal(0, 0.2, weights[1].shape),
                   rng.normal(0, 0.2, weights[2].shape), rng.uniform(0.5, 1.5, weights[3].shape)]
        else:
            new = [rng.normal(0, np.sqrt(2.0 / max(1, int(np.prod(w.shape[:-1])))) if w.ndim > 1 else 0.1, w.shape)
                   for w in weights]
        layer.set_weights([np.asarray(w, np.float32) for w in new])
    return model


def main() -> None:
    model = build()
    model.save(os.path.join(HERE, "keras_cnn.keras"))
    model.save(os.path.join(HERE, "keras_cnn.h5"))
    model.save_weights(os.path.join(HERE, "keras_cnn.weights.h5"))
    x = np.random.default_rng(SEED + 1).uniform(-1.0, 1.0, (4, 16, 16, 3)).astype(np.float32)
    np.savez(os.path.join(HERE, "keras_cnn_io.npz"), x=x, y=model.predict(x, verbose=0))
    print("wrote keras_cnn.keras, keras_cnn.h5, keras_cnn.weights.h5, keras_cnn_io.npz")


if __name__ == "__main__":
    main()
