"""Image schema and IO, a copy of the JAX package's ``image/imageIO.py``.

The image representation is the 6-field struct of the Spark ImageSchema:

    {origin: str, height: int, width: int, nChannels: int,
     mode: int (OpenCV type code), data: bytes (row-major HWC, BGR order)}

Channel order in ``data`` is **BGR** (the OpenCV convention the Spark
ImageSchema inherited); the image converter (``graph/pieces.py``) flips
it to RGB for the model.

``readImages`` decodes with PIL; :func:`default_decode` goes through the
C++ image bridge (``runtime/native.py``) first. A file that fails to read
or decode gives a ``None`` cell (a null row).
"""

from __future__ import annotations

import glob as _glob
import io
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from sparkdl_tpu_torch.dataframe import DataFrame


class ImageType:
    def __init__(self, name: str, ocv_type: int, n_channels: int, dtype: str):
        self.name = name
        self.ocv_type = ocv_type
        self.n_channels = n_channels
        self.dtype = dtype


_SUPPORTED_TYPES = [
    ImageType("Undefined", -1, -1, "uint8"),
    ImageType("CV_8U", 0, 1, "uint8"),
    ImageType("CV_8UC1", 0, 1, "uint8"),
    ImageType("CV_8UC3", 16, 3, "uint8"),
    ImageType("CV_8UC4", 24, 4, "uint8"),
]

#: OpenCV type codes of the Spark ImageSchema ocvTypes table
ocvTypes: Dict[str, int] = {t.name: t.ocv_type for t in _SUPPORTED_TYPES}

_OCV_BY_CHANNELS = {1: 0, 3: 16, 4: 24}
_CHANNELS_BY_OCV = {0: 1, 16: 3, 24: 4}

imageSchema = ("origin", "height", "width", "nChannels", "mode", "data")


def imageArrayToStruct(array: np.ndarray, origin: str = "") -> Dict[str, object]:
    """HWC (or HW) array -> image struct. Data is stored as given (callers
    holding RGB flip to BGR first); floats in [0, 1] scale to [0, 255],
    other values clip to it."""
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError(f"Expected 2-D or 3-D image array, got shape {arr.shape}")
    if arr.dtype != np.uint8:
        if np.issubdtype(arr.dtype, np.floating) and arr.max(initial=0.0) <= 1.0:
            arr = (arr * 255.0).round()
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    h, w, c = arr.shape
    if c not in _OCV_BY_CHANNELS:
        raise ValueError(f"Unsupported channel count {c}")
    return {
        "origin": origin,
        "height": int(h),
        "width": int(w),
        "nChannels": int(c),
        "mode": _OCV_BY_CHANNELS[c],
        "data": np.ascontiguousarray(arr).tobytes(),
    }


def imageStructToArray(image_row: Dict[str, object]) -> np.ndarray:
    """Image struct -> HWC uint8 array (a zero-copy view of ``data``)."""
    mode = int(image_row["mode"])
    if mode not in _CHANNELS_BY_OCV:
        raise ValueError(f"Unsupported OpenCV type code {mode}")
    h = int(image_row["height"])
    w = int(image_row["width"])
    c = int(image_row["nChannels"])
    arr = np.frombuffer(image_row["data"], dtype=np.uint8)
    if arr.size != h * w * c:
        raise ValueError(f"Image data size {arr.size} != h*w*c = {h}*{w}*{c}")
    return arr.reshape(h, w, c)


def PIL_decode(raw_bytes: bytes) -> Optional[np.ndarray]:
    """bytes -> HWC uint8 **BGR** array, or None when PIL cannot decode."""
    from PIL import Image, UnidentifiedImageError

    try:
        img = Image.open(io.BytesIO(raw_bytes)).convert("RGB")
    except (UnidentifiedImageError, Image.DecompressionBombError, OSError, ValueError):
        return None
    return np.asarray(img, dtype=np.uint8)[:, :, ::-1]  # RGB -> BGR


def default_decode(raw_bytes: bytes) -> Optional[np.ndarray]:
    """bytes -> HWC uint8 **BGR** array through the C++ bridge (JPEG and
    PNG), else PIL: for the formats the bridge does not decode (GIF, BMP,
    ...) and where the bridge is off or not built."""
    from sparkdl_tpu_torch.runtime import native

    if native.available():
        arr = native.decode(raw_bytes)
        if arr is not None:
            if arr.shape[2] == 1:
                arr = np.repeat(arr, 3, axis=2)
            return np.ascontiguousarray(arr[:, :, ::-1])  # RGB -> BGR
    return PIL_decode(raw_bytes)


def _list_files(path: str) -> List[str]:
    if os.path.isdir(path):
        return sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if os.path.isfile(os.path.join(path, f))
        )
    return sorted(f for f in _glob.glob(path) if os.path.isfile(f))


def filesToDF(path: str, numPartitions: int = 4) -> DataFrame:
    """Directory or glob -> DataFrame[filePath: str, fileData: bytes]. Files
    are read lazily, partition by partition; an unreadable file gives a
    None cell."""
    df = DataFrame.fromColumns(
        {"filePath": _list_files(path)}, numPartitions=max(1, numPartitions)
    )

    def read_partition(part):
        out: List[Optional[bytes]] = []
        for p in part["filePath"]:
            try:
                with open(p, "rb") as f:
                    out.append(f.read())
            except OSError:
                out.append(None)
        return {"fileData": out}

    return df.withColumnPartition("fileData", read_partition)


def readImagesWithCustomFn(
    path: str,
    decode_f: Callable[[bytes], Optional[np.ndarray]],
    numPartitions: int = 4,
) -> DataFrame:
    """Files -> DataFrame[image: struct] through ``decode_f`` (bytes -> HWC
    uint8 BGR array or None); failures become null cells."""
    files_df = filesToDF(path, numPartitions=numPartitions)

    def decode_row(row):
        raw = row["fileData"]
        if raw is None:
            return None
        try:
            arr = decode_f(raw)
        except Exception:  # noqa: BLE001 — any decoder failure is a null row
            return None
        if arr is None:
            return None
        return imageArrayToStruct(np.asarray(arr), origin=row["filePath"])

    return files_df.withColumn("image", decode_row).select("image")


def readImages(path: str, numPartitions: int = 4) -> DataFrame:
    """Files -> DataFrame[image: struct], decoded with PIL."""
    return readImagesWithCustomFn(path, PIL_decode, numPartitions=numPartitions)
