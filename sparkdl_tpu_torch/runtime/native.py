"""ctypes bindings of the C++ image bridge (``native/imagebridge.cc``).

The port's copy of the JAX package's ``runtime/native.py``, over the same
source and the same C interface: JPEG/PNG decode (libjpeg, libpng),
bilinear resize with half-pixel centres, and batch assembly on a C++
thread pool, optionally packed channel-major (``chw=True``: the NCHW the
port's models take).

The library is compiled at first use, never at import, with
``g++ -O3 -fPIC -shared -std=c++17 ... -ljpeg -lpng`` from the source
where it stands, into ``sparkdl_tpu_torch/_build/imagebridge-<hash>/``,
keyed by a hash of the source and the flags. ``available()`` says whether
the bridge can be used: not when ``SPARKDL_TPU_NO_NATIVE`` is set (read at
every call, so a caller can switch it per transform), nor when the build
or the load failed, which is recorded once with its reason
(:func:`status`) and reported by a warning. Callers then decode with PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sparkdl_tpu_torch.runtime import knobs
from sparkdl_tpu_torch.runtime.cuda_build import BUILD_DIR

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO_ROOT, "native", "imagebridge.cc")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-ljpeg", "-lpng")
#: the C interface version the bindings below declare
ABI_VERSION = 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failure: Optional[str] = None


def library_path() -> str:
    h = hashlib.sha256(repr((CXX_FLAGS, LIBS)).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"imagebridge-{h.hexdigest()[:16]}", "libimagebridge.so")


def _build() -> str:
    """Compile the bridge unless its current build exists; its path."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, SOURCE, *LIBS],
        capture_output=True, text=True, timeout=300, check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ exit {proc.returncode}: {(proc.stdout + proc.stderr).strip()}")
    os.replace(tmp, lib)  # a concurrent loader sees no half-written file
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int)
    c_int = ctypes.c_int
    lib.ib_version.restype = c_int
    lib.ib_version.argtypes = []
    lib.ib_free.restype = None
    lib.ib_free.argtypes = [u8p]
    lib.ib_decode.restype = u8p
    lib.ib_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, i32p, i32p, i32p]
    lib.ib_resize_bilinear.restype = None
    lib.ib_resize_bilinear.argtypes = [u8p, c_int, c_int, c_int, u8p, c_int, c_int]
    lib.ib_assemble_batch.restype = None
    lib.ib_assemble_batch.argtypes = [
        ctypes.POINTER(u8p), i32p, i32p, i32p, c_int, u8p, c_int, c_int, c_int, u8p, c_int, c_int,
    ]
    lib.ib_decode_resize_batch.restype = None
    lib.ib_decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t), c_int,
        u8p, c_int, c_int, c_int, u8p, c_int, c_int,
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failure
    if _lib is not None or _failure is not None:
        return _lib
    with _lock:
        if _lib is not None or _failure is not None:
            return _lib
        try:
            lib = ctypes.CDLL(_build())
            _declare(lib)
            version = lib.ib_version()
            if version != ABI_VERSION:
                raise RuntimeError(f"ib_version() is {version}, the bindings are for {ABI_VERSION}")
            _lib = lib
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _failure = f"{type(e).__name__}: {e}"
            warnings.warn(
                f"the native image bridge is unavailable ({_failure}); images decode with PIL",
                RuntimeWarning, stacklevel=3,
            )
    return _lib


def available() -> bool:
    """The bridge is on (``SPARKDL_TPU_NO_NATIVE`` unset) and built."""
    return not knobs.get_flag("SPARKDL_TPU_NO_NATIVE") and _load() is not None


def status() -> str:
    """One line: the library in use, or why there is none."""
    if knobs.get_flag("SPARKDL_TPU_NO_NATIVE"):
        return "off (SPARKDL_TPU_NO_NATIVE is set)"
    if _load() is not None:
        return f"built: {library_path()}"
    return f"unavailable: {_failure}"


def _lib_or_raise() -> ctypes.CDLL:
    if not available():
        raise RuntimeError(f"native image bridge {status()}")
    return _lib


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode(raw: bytes) -> Optional[np.ndarray]:
    """JPEG/PNG bytes -> HWC uint8 RGB (or 1-channel gray), or None when
    the bridge cannot decode them."""
    lib = _lib_or_raise()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    ptr = lib.ib_decode(raw, len(raw), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if not ptr:
        return None
    try:
        n = h.value * w.value * c.value
        return np.ctypeslib.as_array(ptr, shape=(n,)).copy().reshape(h.value, w.value, c.value)
    finally:
        lib.ib_free(ptr)


def resize_bilinear(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    """HWC uint8 -> (height, width, C) uint8, bilinear, half-pixel
    centres."""
    lib = _lib_or_raise()
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim != 3:
        raise ValueError(f"expected an HWC array, got shape {arr.shape}")
    h, w, c = arr.shape
    out = np.empty((height, width, c), dtype=np.uint8)
    lib.ib_resize_bilinear(_as_u8p(arr), h, w, c, _as_u8p(out), height, width)
    return out


def _batch_buffers(n: int, height: int, width: int, n_channels: int, chw: bool):
    shape = (n, n_channels, height, width) if chw else (n, height, width, n_channels)
    return np.zeros(shape, dtype=np.uint8), np.zeros((n,), dtype=np.uint8)


def assemble_batch(
    arrays: Sequence[Optional[np.ndarray]],
    height: int,
    width: int,
    n_channels: int = 3,
    max_threads: int = 0,
    chw: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """HWC uint8 arrays (or None) -> (uint8 batch, bool mask), resized and
    channel-adapted (gray -> 3, RGBA -> 3, RGB -> 1) on the C++ thread
    pool; ``chw=True`` packs (n, C, H, W)."""
    lib = _lib_or_raise()
    n = len(arrays)
    batch, ok = _batch_buffers(n, height, width, n_channels, chw)
    if n == 0:
        return batch, ok.astype(bool)
    srcs = (ctypes.POINTER(ctypes.c_uint8) * n)()
    hs, ws, cs = (ctypes.c_int * n)(), (ctypes.c_int * n)(), (ctypes.c_int * n)()
    keep: List[np.ndarray] = []  # the buffers outlive the call
    for i, a in enumerate(arrays):
        if a is None:
            continue
        a = np.ascontiguousarray(a, dtype=np.uint8)
        if a.ndim == 2:
            a = a[:, :, None]
        if a.ndim != 3:
            continue
        keep.append(a)
        srcs[i] = _as_u8p(a)
        hs[i], ws[i], cs[i] = a.shape
    lib.ib_assemble_batch(
        srcs, hs, ws, cs, n, _as_u8p(batch), height, width, n_channels,
        _as_u8p(ok), max_threads, int(chw),
    )
    return batch, ok.astype(bool)


def decode_resize_batch(
    blobs: Sequence[Optional[bytes]],
    height: int,
    width: int,
    n_channels: int = 3,
    max_threads: int = 0,
    chw: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Image file bytes (or None) -> (uint8 batch, bool mask): decode,
    channel adaptation, resize and packing in one pass on the C++ thread
    pool; ``chw=True`` packs (n, C, H, W). A blob the bridge cannot decode
    leaves a zero slot with mask False."""
    lib = _lib_or_raise()
    n = len(blobs)
    batch, ok = _batch_buffers(n, height, width, n_channels, chw)
    if n == 0:
        return batch, ok.astype(bool)
    ptrs = (ctypes.c_char_p * n)()
    lens = (ctypes.c_size_t * n)()
    for i, b in enumerate(blobs):
        if b:
            ptrs[i] = b
            lens[i] = len(b)
    lib.ib_decode_resize_batch(
        ptrs, lens, n, _as_u8p(batch), height, width, n_channels,
        _as_u8p(ok), max_threads, int(chw),
    )
    return batch, ok.astype(bool)
