"""The JAX package's C++ image bridge for the port's tests, built once
across test processes.

``sparkdl_tpu/runtime/native.py`` builds ``native/build/libimagebridge.so``
with ``make`` in place at first use and, on any failure, latches
``_load_failed`` for the rest of the process. Test processes running at
once can all start that build: one of them may then load a half-written
file, and its JAX bridge stays off for good while the port's bridge
(built atomically) is on. :func:`ensure_built` runs the build under a
file lock beside ``native/build/``, waits until the library loads, and
clears the latch, so a test that holds the port against the JAX bridge
sees the bridge that the toolchain can build.
"""

import ctypes
import fcntl
import os
import time

from sparkdl_tpu.runtime import native as jax_native

#: how long a build started outside the lock may take to finish writing
LOAD_WAIT_S = 120.0


def ensure_built(monkeypatch) -> bool:
    """Whether the JAX bridge is built and loads; when it is, its
    first-use latch is cleared (through ``monkeypatch``, for the test)."""
    so_path = jax_native._SO_PATH
    build_dir = os.path.dirname(so_path)
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            ok = jax_native._build()  # make: a no-op when up to date
            deadline = time.monotonic() + LOAD_WAIT_S
            while ok:
                try:
                    ctypes.CDLL(so_path)
                    break
                except OSError:  # still being written by a build outside the lock
                    if time.monotonic() > deadline:
                        ok = False
                    else:
                        time.sleep(0.5)
                        ok = jax_native._build()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if ok and jax_native._lib is None:
        monkeypatch.setattr(jax_native, "_load_failed", False)
    return ok and jax_native.available()
