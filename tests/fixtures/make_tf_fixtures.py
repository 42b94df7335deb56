#!/usr/bin/env python3
"""Write the TF fixtures that the port reads without TensorFlow or protobuf
(``tests/test_torch_tf_*.py`` and ``chip_smoke.py`` phase 21(d), on a
machine that has neither).

One small model (8x8x3 in: a 3x3 stride-2 SAME Conv2D with a bias, ReLU,
a 2x2 SAME average pool, the spatial mean as an 8-d ``features`` output,
and a Dense softmax over 4 classes as ``probs``), its weights drawn from a
seed, serialized three ways with the same math and weights:

- ``tf_model/saved_model/``: a TF2 SavedModel of a ``tf.Module`` whose
  ``serving_default`` signature returns the dict ``{"probs", "features"}``
  (TF orders its outputs by sorted key: ``features`` first);
- ``tf_model/ckpt/model.{meta,index,data-00000-of-00001}``: a TF1
  checkpoint with its MetaGraphDef, variables ``conv/kernel``,
  ``conv/bias``, ``dense/kernel``, input ``image``, outputs ``probs`` and
  ``features``;
- ``tf_model/frozen.pb``: the frozen GraphDef of the signature's concrete
  function;
- ``tf_model/io.npz``: a seeded input batch ``x`` and TF's ``probs`` and
  ``features`` for it, and the frozen graph's tensor names
  (``gd_inputs``, ``gd_outputs``).

And ``keras_cnn_frozen.pb`` with ``keras_cnn_frozen_io.npz``: the
committed ``keras_cnn.keras`` loaded by Keras on its TensorFlow backend
and frozen by TF (``convert_variables_to_constants_v2``), with TF's output
for ``keras_cnn_io.npz``'s ``x`` and the graph's tensor names: what the
GraphDef writer (``tf_graph_writer.py``) is held against.

And ``tf_bf16/graph.pb`` with ``tf_bf16/io.npz``: a bfloat16 graph, ``y =
BiasAdd(MatMul(x, W), b)`` with ``W`` and ``b`` bfloat16 constants (the
graph that once came out float32 from the port), with a seeded input ``x``
(float32 values that bfloat16 holds exactly) and the JAX package's output
``y_jax`` for it (bfloat16, stored widened to float32; the JAX translator
runs through TF's own proto). About 70 KB in all. Needs tensorflow, keras
and the JAX package; run from the repository root:

    KERAS_BACKEND=tensorflow CUDA_VISIBLE_DEVICES=-1 python3 tests/fixtures/make_tf_fixtures.py
"""

import json
import os
import shutil

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "tf_model")
SEED = 21
BATCH = 5


def _weights():
    rng = np.random.default_rng(SEED)
    kernel = (rng.normal(size=(3, 3, 3, 8)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=(8,)) * 0.1).astype(np.float32)
    dense = (rng.normal(size=(8, 4)) * 0.5).astype(np.float32)
    x = rng.normal(size=(BATCH, 8, 8, 3)).astype(np.float32)
    return kernel, bias, dense, x


def _forward(tf, image, kernel, bias, dense):
    h = tf.nn.relu(tf.nn.bias_add(tf.nn.conv2d(image, kernel, strides=2, padding="SAME"), bias))
    h = tf.nn.avg_pool2d(h, ksize=2, strides=2, padding="SAME")
    features = tf.reduce_mean(h, axis=[1, 2])
    return features, tf.nn.softmax(tf.matmul(features, dense))


def write_tf_model(tf) -> None:
    from tensorflow.python.framework.convert_to_constants import convert_variables_to_constants_v2

    kernel, bias, dense, x = _weights()
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)

    class Model(tf.Module):
        def __init__(self):
            super().__init__()
            self.kernel = tf.Variable(kernel, name="conv/kernel")
            self.bias = tf.Variable(bias, name="conv/bias")
            self.dense = tf.Variable(dense, name="dense/kernel")

        @tf.function(input_signature=[tf.TensorSpec([None, 8, 8, 3], tf.float32, name="image")])
        def __call__(self, image):
            features, probs = _forward(tf, image, self.kernel, self.bias, self.dense)
            return {"probs": probs, "features": features}

    model = Model()
    tf.saved_model.save(model, os.path.join(OUT, "saved_model"))
    out = model(tf.constant(x))

    frozen = convert_variables_to_constants_v2(model.__call__.get_concrete_function())
    with open(os.path.join(OUT, "frozen.pb"), "wb") as f:
        f.write(frozen.graph.as_graph_def().SerializeToString())

    graph = tf.compat.v1.Graph()
    with graph.as_default():
        image = tf.compat.v1.placeholder(tf.float32, [None, 8, 8, 3], name="image")
        with tf.compat.v1.variable_scope("conv"):
            k = tf.compat.v1.get_variable("kernel", initializer=tf.constant(kernel))
            b = tf.compat.v1.get_variable("bias", initializer=tf.constant(bias))
        with tf.compat.v1.variable_scope("dense"):
            d = tf.compat.v1.get_variable("kernel", initializer=tf.constant(dense))
        features, probs = _forward(tf, image, k, b, d)
        tf.identity(features, name="features")
        tf.identity(probs, name="probs")
        saver = tf.compat.v1.train.Saver()
        with tf.compat.v1.Session(graph=graph) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, os.path.join(OUT, "ckpt", "model"))
    for name in os.listdir(os.path.join(OUT, "ckpt")):
        if name == "checkpoint":  # the state file: the port reads by prefix
            os.remove(os.path.join(OUT, "ckpt", name))

    np.savez(
        os.path.join(OUT, "io.npz"), x=x, probs=out["probs"].numpy(), features=out["features"].numpy(),
        gd_inputs=np.array([t.name for t in frozen.inputs]),
        gd_outputs=np.array([t.name for t in frozen.outputs]),
    )


def write_keras_cnn_frozen(tf) -> None:
    import keras
    from tensorflow.python.framework.convert_to_constants import convert_variables_to_constants_v2

    model = keras.models.load_model(os.path.join(HERE, "keras_cnn.keras"), compile=False)
    x = np.load(os.path.join(HERE, "keras_cnn_io.npz"))["x"]
    fn = tf.function(lambda t: model(t, training=False))
    frozen = convert_variables_to_constants_v2(fn.get_concrete_function(tf.TensorSpec((None,) + x.shape[1:], tf.float32)))
    with open(os.path.join(HERE, "keras_cnn_frozen.pb"), "wb") as f:
        f.write(frozen.graph.as_graph_def().SerializeToString())
    np.savez(
        os.path.join(HERE, "keras_cnn_frozen_io.npz"), y=frozen(tf.constant(x))[0].numpy(),
        inputs=np.array([t.name for t in frozen.inputs]), outputs=np.array([t.name for t in frozen.outputs]),
    )


BF16_IN, BF16_OUT, BF16_BATCH = 128, 64, 8


def write_bf16_graph(tf) -> None:
    import jax.numpy as jnp

    from sparkdl_tpu.graph.tf_import import translate_graph_def

    rng = np.random.default_rng(SEED + 1)
    w = (rng.normal(size=(BF16_IN, BF16_OUT)) * 0.1).astype(np.float32)
    b = rng.normal(size=(BF16_OUT,)).astype(np.float32)
    x = np.asarray(jnp.asarray(rng.normal(size=(BF16_BATCH, BF16_IN)), jnp.bfloat16), np.float32)

    def fn(v):
        y = tf.raw_ops.MatMul(a=v, b=tf.constant(w, dtype=tf.bfloat16))
        return tf.raw_ops.BiasAdd(value=y, bias=tf.constant(b, dtype=tf.bfloat16), name="y")

    cf = tf.function(fn, input_signature=[tf.TensorSpec((None, BF16_IN), tf.bfloat16, name="x")])
    cf = cf.get_concrete_function()
    gd = cf.graph.as_graph_def()
    inputs, outputs = [t.name for t in cf.inputs], [t.name for t in cf.outputs]
    jax_fn, params = translate_graph_def(gd, inputs, outputs)
    y = jax_fn(params, jnp.asarray(x, jnp.bfloat16))
    assert str(y.dtype) == "bfloat16"
    out = os.path.join(HERE, "tf_bf16")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "graph.pb"), "wb") as f:
        f.write(gd.SerializeToString())
    np.savez(os.path.join(out, "io.npz"), x=x, y_jax=np.asarray(y, np.float32), inputs=np.array(inputs),
             outputs=np.array(outputs))


def main() -> None:
    if os.environ.get("KERAS_BACKEND") != "tensorflow":
        raise SystemExit("run with KERAS_BACKEND=tensorflow")
    import tensorflow as tf

    write_tf_model(tf)
    write_keras_cnn_frozen(tf)
    write_bf16_graph(tf)
    sizes = {}
    for root, _, names in os.walk(OUT):
        for n in names:
            sizes[os.path.relpath(os.path.join(root, n), HERE)] = os.path.getsize(os.path.join(root, n))
    for n in ("keras_cnn_frozen.pb", "keras_cnn_frozen_io.npz", "tf_bf16/graph.pb", "tf_bf16/io.npz"):
        sizes[n] = os.path.getsize(os.path.join(HERE, n))
    print(json.dumps(sizes, indent=1), f"\ntotal {sum(sizes.values())} bytes")


if __name__ == "__main__":
    main()
