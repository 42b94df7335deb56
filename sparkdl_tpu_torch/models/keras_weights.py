"""The ImageNet class labels of keras' ``imagenet_class_index.json``, for
``DeepImagePredictor``'s decoded predictions.

The port's copy of the labels helper of the JAX package's
``models/keras_weights.py``; the keras ``.h5``/``.keras`` weight
converters of that module are not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional


def imagenet_labels(class_index_json: Optional[str] = None) -> Dict[int, str]:
    """``{idx: label}`` from keras' ``imagenet_class_index.json``
    (``{"0": ["n01440764", "tench"], ...}``), read from ``class_index_json``
    or from ``$KERAS_HOME/models/`` (``~/.keras/models/`` without
    ``KERAS_HOME``). An explicit path that does not exist raises rather
    than fall back to the keras cache, which would label predictions from
    another file; so does a cache without the file."""
    if class_index_json:
        if not os.path.exists(class_index_json):
            raise FileNotFoundError(
                f"imagenet_class_index file not found: {class_index_json!r}"
            )
        path = class_index_json
    else:
        keras_home = os.environ.get(
            "KERAS_HOME", os.path.join(os.path.expanduser("~"), ".keras")
        )
        path = os.path.join(keras_home, "models", "imagenet_class_index.json")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"No imagenet_class_index.json found (searched: {[path]}). "
                "Pass its path explicitly: offline environments must ship "
                "the index file with their weights."
            )
    with open(path) as f:
        blob = json.load(f)
    return {int(k): v[1] for k, v in blob.items()}
