"""Write the StableHLO fixtures: a keras-3 ``XlaCallModule`` SavedModel of
ResNet50 and a JAX ``ModelFunction.export`` of bert-tiny.

Run from the repo root (needs keras 3, tensorflow, jax and flax)::

    KERAS_BACKEND=jax JAX_PLATFORMS=cpu CUDA_VISIBLE_DEVICES=-1 \\
        python3 tests/fixtures/make_stablehlo_fixtures.py

- ``keras3_resnet50/``: ``keras.Model.from_config`` of
  ``keras_resnet50_224_config.json`` with the weights of
  ``chip_smoke._seeded_keras_weights(config, SEED)``, exported with
  ``model.export(..., format="tf_saved_model", jax2tf_kwargs={"with_gradient":
  False})`` (keras 3.13.1, jax 0.9.0): one ``XlaCallModule`` of 71,519
  bytes (321 inputs: 320 weights, then the ``?x224x224x3`` image).
  Committed: ``saved_model.pb`` (959,477 bytes; without the gradient
  function it would hold another module of 141,285 bytes),
  ``fingerprint.pb``, ``variables/variables.index`` (18,093 bytes) and
  ``shard.json``, which maps each index key to its offset, layer path and
  weight slot and holds the object graph's raw bytes. The 102,579,941-byte
  data shard is not committed: ``keras3_shard.write_saved_model`` rebuilds
  it from the same seeded weights.
- ``jax_bert_tiny/``: ``sparkdl_tpu``'s bert-tiny ``model_function`` (its
  weights ``BertEncoder.init(PRNGKey(SEED))``) over ``[b, 32]`` int32 ids,
  written by its ``ModelFunction.export``: ``program.stablehlo`` (2,720,972
  bytes, the weights baked in as constants, the batch symbolic) and
  ``params.pkl`` (2,703,325 bytes); beside them ``io.npz``, four rows of
  ids (two padded) and the JAX ``load``'s outputs for them. No model of
  the registry fits the 2 MB such a fixture should stay under: bert-tiny's
  4 layers and its 1000-token vocabulary hold 669,440 float32 weights,
  which both files carry.
"""

from __future__ import annotations

import base64
import copy
import dataclasses
import json
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
SEED = 0
TEXT_LEN = 32


def make_keras3_resnet50(out: str) -> None:
    import keras

    sys.path.insert(0, REPO)
    import chip_smoke
    from sparkdl_tpu_torch.graph import tf_bundle
    from sparkdl_tpu_torch.graph.keras_graph import walk_layers

    config = chip_smoke._resnet50_config()
    weights = chip_smoke._seeded_keras_weights(config, SEED)
    model = keras.Model.from_config(copy.deepcopy(config))  # from_config consumes its dict
    layers = {layer.name: layer for layer in model.layers}
    for path, _, _, _ in walk_layers(config):
        layers[path].set_weights(weights[path])
    with tempfile.TemporaryDirectory() as tmp:
        sm = os.path.join(tmp, "sm")
        model.export(sm, format="tf_saved_model", verbose=False, jax2tf_kwargs={"with_gradient": False})
        reader = tf_bundle.BundleReader(os.path.join(sm, "variables", "variables"))
        by_bytes = {np.ascontiguousarray(a, "<f4").tobytes(): (path, slot)
                    for path, ws in weights.items() for slot, a in enumerate(ws)}
        spec = {"seed": SEED, "config": "keras_resnet50_224_config.json", "weights": {}, "raw": {}}
        size = 0
        for key, entry in sorted(reader.entries.items()):
            size = max(size, entry.offset + entry.size)
            if key == tf_bundle.OBJECT_GRAPH_KEY:
                with open(os.path.join(sm, "variables", "variables.data-00000-of-00001"), "rb") as f:
                    f.seek(entry.offset)
                    spec["raw"][key] = [entry.offset, base64.b64encode(f.read(entry.size)).decode()]
                continue
            where = by_bytes.get(reader.get_tensor(key).astype("<f4").tobytes())
            if where is None:
                raise SystemExit(f"{key}: no seeded weight holds its bytes")
            spec["weights"][key] = [entry.offset, list(where)]
        spec["size"] = size
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(os.path.join(out, "variables"))
        for name in ("saved_model.pb", "fingerprint.pb"):
            shutil.copyfile(os.path.join(sm, name), os.path.join(out, name))
        shutil.copyfile(os.path.join(sm, "variables", "variables.index"),
                        os.path.join(out, "variables", "variables.index"))
        with open(os.path.join(out, "shard.json"), "w") as f:
            json.dump(spec, f, indent=0, sort_keys=True)
    print(f"{out}: {len(spec['weights'])} weights, shard of {size} bytes")


def make_jax_bert_tiny(out: str) -> None:
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    from sparkdl_tpu.models import bert as jax_bert
    from sparkdl_tpu.models import registry as jax_registry

    params = jax_bert.bert_tiny().init(jax.random.PRNGKey(SEED), jnp.zeros((1, 16), jnp.int32))
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "bert_tiny.npz")
        jax_registry.save_flax_weights(jax.tree_util.tree_map(np.asarray, params), weights)
        mf = jax_registry.get_model("bert-tiny").model_function(weights_file=weights)
        mf = dataclasses.replace(mf, input_shape=(TEXT_LEN,), input_dtype=jnp.int32)
        shutil.rmtree(out, ignore_errors=True)
        mf.export(out)
    ids = np.random.default_rng(SEED).integers(4, 1000, size=(4, TEXT_LEN)).astype(np.int32)
    ids[1, 20:] = 0
    ids[3, 6:] = 0
    y = np.asarray(_jax_load(out)(ids))
    np.savez(os.path.join(out, "io.npz"), ids=ids, y=y)
    print(f"{out}: " + ", ".join(f"{n} {os.path.getsize(os.path.join(out, n))} bytes" for n in sorted(os.listdir(out))))


def _jax_load(path: str):
    from sparkdl_tpu.graph.function import ModelFunction

    return ModelFunction.load(path)


if __name__ == "__main__":
    make_keras3_resnet50(os.path.join(HERE, "keras3_resnet50"))
    make_jax_bert_tiny(os.path.join(HERE, "jax_bert_tiny"))
