"""Write an orbax checkpoint without orbax: the layout of
``StandardCheckpointer`` with ``use_ocdbt=False``, arrays uncompressed.

:func:`write_plain_checkpoint` writes a tree of nested dicts and lists of
numpy arrays as orbax lays it out on disk: ``_METADATA`` (the tree, one
entry per leaf, ``value_type`` ``np.ndarray``), ``_CHECKPOINT_METADATA``,
and per leaf a zarr v2 array ``<key.key...>/.zarray`` with its one chunk
``0.0...`` and ``"compressor": null``. Orbax's ``restore`` reads it (held
so in ``tests/test_torch_orbax.py``), and so does the port's
``graph/orbax_ckpt.read_orbax_checkpoint``. ``chip_smoke.py`` phase 22(e)
writes a bert-base checkpoint with it, on a machine with neither orbax nor
a zstd library. Needs only numpy.
"""

import json
import os
import time

import numpy as np


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, path + ((key, 2),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, path + ((i, 1),))
    else:
        yield path, np.asarray(tree)


def write_plain_checkpoint(path: str, tree) -> int:
    """Write ``tree`` (nested dicts and lists of numpy arrays of one or more
    dimensions) at ``path``; returns the bytes of array data written."""
    os.makedirs(path)
    entries, nbytes = {}, 0
    for keys, arr in _leaves(tree):
        arr = np.ascontiguousarray(arr)
        if not arr.shape:
            raise ValueError("0-d leaves are not written (orbax restores them as shape (1,))")
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        name = ".".join(str(k) for k, _ in keys)
        entries[repr(tuple(str(k) if t == 2 else k for k, t in keys))] = {
            "key_metadata": [{"key": str(k), "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False},
        }
        os.makedirs(os.path.join(path, name))
        zarray = {"zarr_format": 2, "shape": list(arr.shape), "chunks": list(arr.shape),
                  "dtype": arr.dtype.str, "compressor": None, "fill_value": None, "order": "C",
                  "filters": None, "dimension_separator": "."}
        with open(os.path.join(path, name, ".zarray"), "w") as f:
            json.dump(zarray, f)
        with open(os.path.join(path, name, ".".join("0" * arr.ndim) or "0"), "wb") as f:
            f.write(arr.tobytes())
        nbytes += arr.nbytes
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": entries, "use_ocdbt": False, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    now = time.time_ns()
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": "orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                   "StandardCheckpointHandler", "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": now, "commit_timestamp_nsecs": now, "custom_metadata": {}}, f)
    return nbytes
