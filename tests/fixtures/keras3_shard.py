"""Rebuild the data shard of the committed keras-3 ResNet50 export.

``tests/fixtures/keras3_resnet50/`` holds a keras-3 (JAX backend)
``model.export()`` of the 224x224 ResNet50 of
``keras_resnet50_224_config.json``, without its 102.6 MB data shard:
``saved_model.pb``, ``variables/variables.index`` and ``shard.json``,
which names the seed of the weights (``chip_smoke._seeded_keras_weights``)
and maps each index key to its layer path and weight slot, and holds the
raw bytes of the one entry that is not a weight (the object graph).
:func:`write_saved_model` writes the whole SavedModel into a directory:
the committed files, and the shard with each tensor at the offset its
index entry gives. A reader checks every entry's CRC-32C, so a weight
that differs from the exported one fails there. numpy and the standard
library only: the card's machine runs it.
"""

from __future__ import annotations

import base64
import json
import os
import shutil
from typing import Dict, List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "keras3_resnet50")
SHARD = "variables.data-00000-of-00001"


def shard_spec(fixture: str = FIXTURE) -> dict:
    with open(os.path.join(fixture, "shard.json")) as f:
        return json.load(f)


def write_saved_model(out: str, weights: Dict[str, List[np.ndarray]], fixture: str = FIXTURE) -> str:
    """Write the SavedModel into ``out`` from ``weights`` (``{layer path:
    [arrays in Keras's order]}``); returns ``out``."""
    spec = shard_spec(fixture)
    os.makedirs(os.path.join(out, "variables"), exist_ok=True)
    for name in ("saved_model.pb", "fingerprint.pb"):
        shutil.copyfile(os.path.join(fixture, name), os.path.join(out, name))
    shutil.copyfile(os.path.join(fixture, "variables", "variables.index"),
                    os.path.join(out, "variables", "variables.index"))
    data = bytearray(spec["size"])
    for key, (offset, (path, slot)) in spec["weights"].items():
        raw = np.ascontiguousarray(weights[path][slot], dtype="<f4").tobytes()
        data[offset:offset + len(raw)] = raw
    for key, (offset, b64) in spec["raw"].items():
        raw = base64.b64decode(b64)
        data[offset:offset + len(raw)] = raw
    with open(os.path.join(out, "variables", SHARD), "wb") as f:
        f.write(bytes(data))
    return out
