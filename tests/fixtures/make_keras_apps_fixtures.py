"""Write the ``keras.applications`` fixtures of ``chip_smoke.py`` phase 30
and ``tests/test_torch_keras_apps_full.py``.

Run from the repo root (needs keras 3 on its JAX backend)::

    KERAS_BACKEND=jax JAX_PLATFORMS=cpu python3 tests/fixtures/make_keras_apps_fixtures.py

For each family of ``chip_smoke.KERAS_APPS`` (EfficientNetB0,
EfficientNetV2B0, MobileNetV3Large, ConvNeXtTiny, NASNetMobile,
InceptionResNetV2):

- ``keras_apps/<name>.json.gz``: ``keras.applications.<name>(weights=None)``'s
  config at the family's default input size, built right after
  ``keras.backend.clear_session()`` so that its automatic layer names do
  not depend on what was built before;
- ``keras_apps/bn_stats.npz``: each BatchNorm's moving mean and variance
  (``<name>/<layer path>/mean`` and ``.../var``) from :func:`bn_stats`, a
  float64 pass of the port on the CPU under the seeded weights, so that
  phase 30 reads them and does not make that pass on the card's host;
- ``keras_apps/outputs.npz``: Keras's own outputs for
  ``chip_smoke.KERAS_APPS_ROWS`` rows drawn by
  ``chip_smoke._keras_app_inputs`` under the weights of
  ``chip_smoke._keras_app_weights(name, config)`` (seeded, with those
  BatchNorm statistics): the
  pooled features (``<name>/pooled``) and the logits (``<name>/logits``) of
  ``chip_smoke._keras_app_heads(config)``, with the inputs' sum
  (``<name>/x_sum``) to show the same draw later.

No weights are committed: the seed rebuilds them.

``--gates`` prints, instead, how far the seeded weights keep the
squeeze-and-excitation gates and the logits from saturation, from the
port on the CPU (one row per family).
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "keras_apps")
MIN_VAR = 1e-2  # a calibrated variance's floor ...
MIN_SPREAD = 0.1  # ... and its standard deviation's, as a share of |mean|


def application_config(name: str) -> dict:
    """The installed keras's config of ``name`` at its default size, as
    JSON gives it back."""
    import keras

    import chip_smoke

    side = chip_smoke.KERAS_APPS[name][0]
    keras.backend.clear_session()
    model = getattr(keras.applications, name)(weights=None, input_shape=(side, side, 3))
    return json.loads(json.dumps(model.get_config()))


def keras_model(config: dict, weights: dict):
    """A Keras model from ``config`` holding ``weights`` (by layer path)."""
    import keras

    from sparkdl_tpu_torch.graph.keras_graph import walk_layers

    model = keras.Model.from_config(json.loads(json.dumps(config)))  # from_config empties what it is given
    for path, _, _, _ in walk_layers(config):
        layer = model
        for part in path.split("/"):
            layer = layer.get_layer(part)
        layer.set_weights(weights[path])
        if isinstance(layer, keras.layers.Normalization):
            layer.finalize_state()  # as a file's load does: the call reads the new statistics
    return model


def bn_stats(name: str, config: dict, weights: dict) -> dict:
    """Each BatchNorm's moving mean and variance for phase 30, by layer
    path: the statistics of its own input in a float64 pass of the port on
    the CPU under ``weights`` over the rows the check feeds the family
    (``chip_smoke._keras_app_inputs``; in layer order, each BatchNorm after
    those before it set), as float32; the standard deviation is floored at
    ``MIN_SPREAD`` of the mean's size and the variance at ``MIN_VAR``, so
    that a channel nearly constant over the rows is not blown up into
    float32 cancellation. Random moving statistics leave deep nets without
    shortcuts (EfficientNet, MobileNetV3, NASNet) vanishing or exploding
    within a few blocks, where every activation and gate sits in one
    regime (a sigmoid gate stuck at 0.5, or flipping between 0 and 1 on
    rounding) and a wrong layer would pass unseen or a right one fail;
    statistics matched to the checked rows keep each layer's output over
    them near gamma's scale. A machine's float64 sums round to the same
    float32 value but for a unit in the last place now and then, far below
    any limit of the check."""
    import torch

    import chip_smoke
    from sparkdl_tpu_torch.graph.keras_graph import KerasModelSpec, KerasModule, layer_module, walk_layers

    weights = {k: list(v) for k, v in weights.items()}
    module = KerasModule(config, KerasModelSpec(config, weights)).double().eval()
    stats = {}

    def calibrate(path):
        def hook(mod, args):
            t = args[0]
            dims = [d for d in range(t.dim()) if d != 1]
            mean = t.mean(dim=dims).numpy()
            var = np.maximum(t.var(dim=dims, unbiased=False).numpy(),
                             np.maximum(MIN_VAR, (MIN_SPREAD * mean) ** 2))
            mean, var = mean.astype(np.float32), var.astype(np.float32)
            mod.running_mean.copy_(torch.from_numpy(mean))
            mod.running_var.copy_(torch.from_numpy(var))
            stats[path] = (mean, var)
        return hook

    for path, _, layer, _ in walk_layers(config):
        if layer["class_name"] == "BatchNormalization":
            layer_module(module, path).register_forward_pre_hook(calibrate(path))
    x = torch.from_numpy(chip_smoke._keras_app_inputs(name, chip_smoke.KERAS_APPS_ROWS).astype(np.float64))
    with torch.no_grad():
        module(x.permute(0, 3, 1, 2))
    return stats


def seeded_bn_stats(name: str, config: dict) -> dict:
    """:func:`bn_stats` under the family's seeded weights."""
    import chip_smoke

    weights = chip_smoke._seeded_keras_weights(config, chip_smoke.KERAS_APPS_SEED,
                                               bn_gamma=chip_smoke.KERAS_APPS_BN_GAMMA)
    return bn_stats(name, config, weights)


def write_bn_stats() -> None:
    import chip_smoke

    stats = {}
    for name in chip_smoke.KERAS_APPS:
        for path, (mean, var) in seeded_bn_stats(name, chip_smoke._keras_app_config(name)).items():
            stats[f"{name}/{path}/mean"], stats[f"{name}/{path}/var"] = mean, var
    np.savez_compressed(chip_smoke.KERAS_APPS_BN_STATS, **stats)


def write() -> None:
    import chip_smoke

    os.makedirs(OUT, exist_ok=True)
    for name in chip_smoke.KERAS_APPS:
        with open(os.path.join(OUT, f"{name}.json.gz"), "wb") as raw:
            with gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as f:
                f.write(json.dumps(application_config(name), sort_keys=True).encode())
    write_bn_stats()
    stored = {}
    for name in chip_smoke.KERAS_APPS:
        config = chip_smoke._keras_app_config(name)
        weights = chip_smoke._keras_app_weights(name, config)
        model = keras_model(chip_smoke._keras_app_heads(config), weights)
        x = chip_smoke._keras_app_inputs(name, chip_smoke.KERAS_APPS_ROWS)
        pooled, logits = model.predict(x, verbose=0)
        stored[f"{name}/pooled"] = np.asarray(pooled, np.float32)
        stored[f"{name}/logits"] = np.asarray(logits, np.float32)
        stored[f"{name}/x_sum"] = np.float64(x.astype(np.float64).sum())
        print(f"{name}: config {os.path.getsize(os.path.join(OUT, f'{name}.json.gz'))} bytes gzipped; "
              f"pooled {pooled.shape} max |v| {np.abs(pooled).max():.4g}; logits {logits.shape} "
              f"max |v| {np.abs(logits).max():.4g}, std {logits.std():.4g}")
    np.savez_compressed(os.path.join(OUT, "outputs.npz"), **stored)


def gates() -> None:
    """SE gates (EfficientNet's sigmoid ``se_expand`` convs, MobileNetV3's
    hard sigmoid ``multiply`` op nodes) and logits under the seeded
    weights, on the port on the CPU."""
    import torch

    import chip_smoke
    from sparkdl_tpu_torch.graph.keras_graph import KerasModelSpec, KerasModule, _Conv, _OpNode

    for name in chip_smoke.KERAS_APPS:
        config = chip_smoke._keras_app_config(name)
        heads = chip_smoke._keras_app_heads(config)
        module = KerasModule(heads, KerasModelSpec(heads, chip_smoke._keras_app_weights(name, config))).eval()
        seen = []
        for key, mod in module.graph.mods.items():
            if (isinstance(mod, _Conv) and key.endswith("se_expand")) or (
                    isinstance(mod, _OpNode) and key.startswith("multiply")):
                mod.register_forward_hook(lambda m, i, o: seen.append(o.detach().flatten()))
        x = torch.from_numpy(chip_smoke._keras_app_inputs(name, 1)).permute(0, 3, 1, 2)
        with torch.no_grad():
            _, logits = module(x)
        if seen:
            g = torch.cat(seen)
            print(f"{name}: {len(seen)} gates, {g.numel()} values, share in (0.01, 0.99) "
                  f"{float(((g > 0.01) & (g < 0.99)).float().mean()):.3f}, in (0.45, 0.55) "
                  f"{float(((g > 0.45) & (g < 0.55)).float().mean()):.3f}, mean {float(g.mean()):.3f}, "
                  f"std {float(g.std()):.3f}")
        top = torch.softmax(logits.double(), -1).max()
        print(f"{name}: logits std {float(logits.std()):.4g}, max softmax {float(top):.4g}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gates", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    (gates if args.gates else write)()


if __name__ == "__main__":
    main()
