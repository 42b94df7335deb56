#!/usr/bin/env python3
"""Write the orbax fixture that the port reads without orbax, tensorstore
or zstd libraries (``tests/test_torch_orbax.py`` and ``chip_smoke.py``
phase 22(c), on a machine that has none of them).

``orbax_model/ckpt/``: the flax variables of a small BERT encoder (the
config in ``io.npz``: 2 layers, hidden 32, one head of 32, vocabulary
256, 32 positions), drawn from a seed and saved by
``orbax.checkpoint.StandardCheckpointer`` with its defaults (OCDBT, zarr
v2, zstd). ``orbax_model/io.npz``: ``config`` (JSON), seeded token ids
``ids`` and the JAX package's output ``y_jax`` for them: the last hidden
state of ``ModelIngest.from_orbax_checkpoint(ckpt, apply_fn)``. About
120 KB in all. Needs jax, flax and orbax; run from the repository root:

    JAX_PLATFORMS=cpu python3 tests/fixtures/make_orbax_fixtures.py
"""

import dataclasses
import json
import os
import shutil

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "orbax_model")
SEED = 16
CONFIG = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=1, intermediate_size=64,
              max_position_embeddings=32)


def main() -> None:
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    from sparkdl_tpu.graph.ingest import ModelIngest
    from sparkdl_tpu.models.bert import BertConfig, BertEncoder

    module = BertEncoder(BertConfig(**CONFIG))
    rng = np.random.default_rng(SEED)
    ids = rng.integers(1, CONFIG["vocab_size"], size=(4, CONFIG["max_position_embeddings"])).astype(np.int32)
    variables = module.init(jax.random.PRNGKey(SEED), jnp.asarray(ids))
    # non-trivial LayerNorm scales and biases, so a mix-up of them shows
    variables = jax.tree_util.tree_map(lambda a: a + jnp.asarray(rng.normal(0, 0.05, a.shape), a.dtype), variables)
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    ckpt = os.path.join(OUT, "ckpt")
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(ckpt, variables)
    checkpointer.wait_until_finished()
    mf = ModelIngest.from_orbax_checkpoint(ckpt, lambda p, x: module.apply(p, x))
    y = np.asarray(mf(jnp.asarray(ids)), np.float32)
    config = dataclasses.asdict(BertConfig(**CONFIG))
    config.pop("dtype")
    np.savez(os.path.join(OUT, "io.npz"), config=np.array(json.dumps(config)), ids=ids, y_jax=y)
    sizes = {os.path.relpath(os.path.join(r, n), OUT): os.path.getsize(os.path.join(r, n))
             for r, _, names in os.walk(OUT) for n in names}
    print(json.dumps(sizes, indent=1), f"\ntotal {sum(sizes.values())} bytes")


if __name__ == "__main__":
    main()
