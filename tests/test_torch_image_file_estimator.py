"""The port's ``ImageFileEstimator`` (``KerasImageFileEstimator``) and its
Keras ``compile``/``fit`` rules (``sparkdl_tpu_torch/estimators/``)
against the JAX package's estimator, which runs ``model.fit`` on keras's
JAX backend, on the CPU.

A small Keras CNN (two convs, the first without a bias, a trained
BatchNormalization with momentum 0.9, a frozen one, ReLU, Dropout(0), global pooling, a softmax head) is
saved as ``.keras``; both estimators train it from that file over the
same 40 images (an ``imageLoader``), 2 epochs, batch 16 (a partial last
batch), ``shuffle=False``, with each optimizer (by name and as a Keras
serialized config) and each loss in scope. Every weight and moving
statistic of the trained model, and the returned transformers' outputs,
must agree within relative 1e-4 of each tensor's own max |value|.
``fitMultiple`` runs under both packages' ``CrossValidator``, whose
metrics must agree within 1e-4.
"""

import keras
import numpy as np
import pytest

from sparkdl_tpu.dataframe import DataFrame as JaxDataFrame
from sparkdl_tpu.estimators import ImageFileEstimator as JaxImageFileEstimator
from sparkdl_tpu.evaluation import BinaryClassificationEvaluator as JaxBinary
from sparkdl_tpu.tuning import CrossValidator as JaxCrossValidator
from sparkdl_tpu.tuning import ParamGridBuilder as JaxParamGridBuilder
from sparkdl_tpu_torch.dataframe import DataFrame
from sparkdl_tpu_torch.estimators import ImageFileEstimator, KerasImageFileEstimator
from sparkdl_tpu_torch.estimators import keras_fit
from sparkdl_tpu_torch.evaluation import BinaryClassificationEvaluator
from sparkdl_tpu_torch.graph.keras_graph import walk_layers
from sparkdl_tpu_torch.tuning import CrossValidator, ParamGridBuilder
from test_torch_keras_graph import randomize

L = keras.layers
REL = 1e-4
ROWS, SIDE, CLASSES = 40, 8, 3
FIT = {"epochs": 2, "batch_size": 16, "shuffle": False}


def _cnn(classes=CLASSES, seed=0):
    inp = L.Input((SIDE, SIDE, 3))
    # no bias before the trained BatchNorm: its gradient there is pure
    # rounding noise, which Adam and RMSprop scale into learning-rate steps
    x = L.Conv2D(6, 3, padding="same", use_bias=False, name="conv_a")(inp)
    x = L.BatchNormalization(momentum=0.9, name="bn_a")(x)
    x = L.Activation("relu")(x)
    x = L.BatchNormalization(name="bn_frozen", trainable=False)(x)
    x = L.Dropout(0.0)(x)
    x = L.Conv2D(4, 3, strides=2, name="conv_b")(x)
    x = L.GlobalAveragePooling2D()(x)
    out = L.Dense(classes, activation="softmax", name="head")(x)
    return randomize(keras.Model(inp, out, name="small_cnn"), seed=seed, bn_var=(0.5, 1.5))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The model file, the images by URI, their labels."""
    d = tmp_path_factory.mktemp("ife")
    rng = np.random.default_rng(7)
    images = {f"img/{i}": rng.uniform(-1.0, 1.0, (SIDE, SIDE, 3)).astype(np.float32) for i in range(ROWS)}
    labels = [i % CLASSES for i in range(ROWS)]
    path = str(d / "cnn.keras")
    _cnn().save(path)
    binary = str(d / "binary.keras")
    _cnn(classes=2, seed=1).save(binary)
    return path, binary, images, labels


def _columns(images, labels):
    return {"uri": list(images), "label": labels}


def _estimators(path, images, optimizer, loss, labels):
    loader = images.__getitem__
    cols = _columns(images, labels)
    kw = dict(inputCol="uri", outputCol="out", labelCol="label", modelFile=path, imageLoader=loader,
              kerasOptimizer=optimizer, kerasLoss=loss, kerasFitParams=FIT, batchSize=16)
    ours = ImageFileEstimator(device="cpu", **kw)
    ref = JaxImageFileEstimator(**kw)
    return (ours, DataFrame.fromColumns(cols, numPartitions=2)), (ref, JaxDataFrame.fromColumns(cols, numPartitions=2))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


CASES = {
    "adam-cce": ("adam", "categorical_crossentropy"),
    "sgd-cce": ("sgd", "categorical_crossentropy"),
    "rmsprop-cce": ("rmsprop", "categorical_crossentropy"),
    "sgd-nesterov-mse": (keras.optimizers.SGD(learning_rate=0.05, momentum=0.9, nesterov=True),
                         "mean_squared_error"),
    "rmsprop-centered-bce": (keras.optimizers.RMSprop(learning_rate=0.01, momentum=0.5, centered=True),
                             "binary_crossentropy"),
    "adam-amsgrad-sparse": (keras.optimizers.Adam(learning_rate=0.01, amsgrad=True),
                            "sparse_categorical_crossentropy"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fit_matches_the_jax_estimator(data, case):
    path, _, images, labels = data
    optimizer, loss = CASES[case]
    if not isinstance(optimizer, str):
        optimizer = keras.optimizers.serialize(optimizer)
    if loss == "sparse_categorical_crossentropy":  # float class ids: not one-hot
        labels = [float(v) for v in labels]
    (ours, df), (ref, jdf) = _estimators(path, images, optimizer, loss, labels)
    model, jax_model = ours.fit(df), ref.fit(jdf)
    assert model.history["steps"] == [3, 3] and all(np.isfinite(model.history["loss"]))
    trained, keras_model = model._model_obj, jax_model._model_obj
    for layer_path, _, _, _ in walk_layers(keras_model.get_config()):
        got = trained.get_layer(layer_path).get_weights()
        want = keras_model.get_layer(layer_path).get_weights()
        assert len(got) == len(want), layer_path
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape, (layer_path, i)
            assert _rel(a, b) <= REL, (layer_path, i, _rel(a, b))
    # the frozen BatchNorm kept its statistics; the trained one moved
    start = keras.saving.load_model(path, compile=False)
    for name, moved in (("bn_frozen", False), ("bn_a", True)):
        before, after = start.get_layer(name).get_weights(), trained.get_layer(name).get_weights()
        assert (not np.array_equal(before[-1], after[-1])) == moved, name
    out = np.stack([r.out for r in model.transform(df).collect()])
    jax_out = np.stack([np.asarray(r.out) for r in jax_model.transform(jdf).collect()])
    assert out.shape == (ROWS, CLASSES) and _rel(out, jax_out) <= REL


def test_alias_defaults_and_default_device(data):
    path, _, images, labels = data
    assert KerasImageFileEstimator is ImageFileEstimator
    est = ImageFileEstimator(inputCol="uri", labelCol="label", modelFile=path, imageLoader=images.__getitem__)
    ref = JaxImageFileEstimator()
    for name in ("kerasOptimizer", "kerasLoss", "kerasFitParams", "batchSize"):
        assert est.getOrDefault(name) == ref.getOrDefault(name), name
    x, y = est._numpy_features_and_labels(DataFrame.fromColumns(_columns(images, labels)))
    assert x.shape == (ROWS, SIDE, SIDE, 3) and y.shape == (ROWS, CLASSES)
    with pytest.raises(RuntimeError, match="CUDA"):  # cuda by default, none here
        est._fit_on_arrays(x, y)


@pytest.mark.parametrize("bad", [
    ({"kerasOptimizer": "adagrad"}, "optimizer 'adagrad'"),
    ({"kerasLoss": "hinge"}, "loss 'hinge'"),
    ({"kerasFitParams": {"epochs": 1, "validation_split": 0.2}}, "validation_split"),
    ({"kerasOptimizer": {"class_name": "SGD", "config": {"learning_rate": 0.1, "clipnorm": 1.0}}}, "clipnorm"),
])
def test_refusals_name_the_roadmap(data, bad):
    path, _, images, labels = data
    params, match = bad
    est = ImageFileEstimator(inputCol="uri", outputCol="out", labelCol="label", modelFile=path,
                             imageLoader=images.__getitem__, device="cpu", **params)
    with pytest.raises(NotImplementedError, match=match) as err:
        est.fit(DataFrame.fromColumns(_columns(images, labels)))
    assert "ROADMAP Queue A item 9" in str(err.value)


def test_fit_multiple_under_cross_validator(data):
    """Both packages' CrossValidator over their ImageFileEstimator: two
    ParamMaps (1 and 2 epochs), 2 folds, AUC of the 2-way softmax."""
    _, binary, images, _ = data
    labels = [int(i % 5 < 2) for i in range(ROWS)]
    (ours, df), (ref, jdf) = _estimators(binary, images, "adam", "categorical_crossentropy", labels)

    def run(est, frame, grid_cls, cv_cls, ev_cls):
        grid = grid_cls().addGrid(est.kerasFitParams, [dict(FIT, epochs=1), FIT]).build()
        cv = cv_cls(estimator=est, estimatorParamMaps=grid, evaluator=ev_cls(rawPredictionCol="out"),
                    numFolds=2, seed=3)
        return cv.fit(frame).avgMetrics

    got = run(ours, df, ParamGridBuilder, CrossValidator, BinaryClassificationEvaluator)
    want = run(ref, jdf, JaxParamGridBuilder, JaxCrossValidator, JaxBinary)
    assert len(got) == 2 and np.allclose(got, want, atol=REL, rtol=0), (got, want)


def test_shuffle_draws_from_the_seed(data):
    """shuffle=True: the order comes from a torch.Generator seeded with
    the estimator's seed; the same seed trains the same weights."""
    path, _, images, labels = data
    x = np.stack(list(images.values()))
    y = np.eye(CLASSES, dtype=np.float32)[labels]
    from sparkdl_tpu_torch.graph.keras_file import read_keras_file
    from sparkdl_tpu_torch.graph.keras_graph import KerasModule, spec_from_module

    def train(seed):
        spec = read_keras_file(path)
        module = KerasModule(spec.get_config(), spec)
        keras_fit.fit(module, x, y, params={"epochs": 1, "batch_size": 16, "shuffle": True}, seed=seed)
        return spec_from_module(module).get_layer("head").get_weights()[0]

    a, b, c = train(0), train(0), train(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_trained_transformer_persists(data, tmp_path):
    """The returned transformer holds the trained weights as a
    KerasModelSpec and saves them with itself: the loaded stage scores
    the rows as the trained one does (exactly, on the CPU)."""
    from sparkdl_tpu_torch import persistence

    path, _, images, labels = data
    (ours, df), _ = _estimators(path, images, "sgd", "categorical_crossentropy", labels)
    model = ours.fit(df)
    out = np.stack([r.out for r in model.transform(df).collect()])
    # a callable does not persist: the stage is saved without it and the
    # caller passes it again
    model.copy({model.imageLoader: None}).save(str(tmp_path / "trained"))
    loaded = persistence.load(str(tmp_path / "trained"), device="cpu")
    loaded.setImageLoader(images.__getitem__)
    again = np.stack([r.out for r in loaded.transform(df).collect()])
    np.testing.assert_array_equal(again, out)
    start = np.stack([r.out for r in ours.copy()._fit_on_arrays(*ours._numpy_features_and_labels(df))
                      .transform(df).collect()])
    np.testing.assert_array_equal(start, out)  # the same fit twice: deterministic on the CPU
