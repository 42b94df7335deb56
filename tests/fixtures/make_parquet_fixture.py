"""The Parquet fixture ``pyarrow_defaults.parquet``, written by ``pyarrow``
with its default settings, and the numpy function that regenerates its
values from the seed.

The file holds what the port's reader must cover when ``pyarrow`` writes
with its defaults (Snappy, dictionary pages, data pages v1): 50 rows in
four row groups of at most 16 rows, a null in every column kind, an int,
a float, a bool, a string and a binary column, an image struct column
(``origin, height, width, nChannels, mode, data``), a list column and a
FixedShapeTensor column (float32, shape 2x3). :func:`fixture_columns`
needs numpy alone, so a machine without ``pyarrow`` regenerates the
values and checks the port's reader against them.

Regenerate the file (needs pyarrow)::

    python tests/fixtures/make_parquet_fixture.py
"""

import os

import numpy as np

SEED = 13
ROWS = 50
ROW_GROUP = 16
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pyarrow_defaults.parquet")


def fixture_columns(seed: int = SEED, rows: int = ROWS) -> dict:
    """The fixture's columns as the port reads them: Python values, with
    None for a null, and one float32 block for the tensor column."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(-1000, 1000, rows).tolist()
    floats = rng.normal(size=rows).tolist()
    words = ["alpha", "beta", "gamma", "delta", "", "zeta"]
    strings = [words[i] for i in rng.integers(0, len(words), rows)]
    blobs = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes() for k in rng.integers(0, 9, rows)]
    bools = (rng.random(rows) < 0.5).tolist()
    images = []
    for i in range(rows):
        h, w = int(rng.integers(1, 5)), int(rng.integers(1, 5))
        images.append({"origin": f"file:/img/{i}.png", "height": h, "width": w, "nChannels": 3,
                       "mode": 16, "data": rng.integers(0, 256, h * w * 3, dtype=np.uint8).tobytes()})
    lists = [rng.normal(size=int(k)).tolist() for k in rng.integers(0, 4, rows)]
    tensor = rng.normal(size=(rows, 2, 3)).astype(np.float32)
    cols = {"i": ints, "f": floats, "s": strings, "b": blobs, "flag": bools, "image": images,
            "l": lists}
    for k, (name, col) in enumerate(cols.items()):
        for r in range(k % 5, rows, 7):  # a null in every column kind
            col[r] = None
    for r in range(3, rows, 11):
        if lists[r] is not None:
            lists[r] = []
    cols["t"] = tensor
    return cols


def main() -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq

    cols = fixture_columns()
    arrays = {c: pa.array(v) for c, v in cols.items() if c != "t"}
    arrays["t"] = pa.FixedShapeTensorArray.from_numpy_ndarray(cols["t"])
    pq.write_table(pa.table(arrays), PATH, row_group_size=ROW_GROUP)
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes, pyarrow {pa.__version__})")


if __name__ == "__main__":
    main()
