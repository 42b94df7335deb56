"""Build the package's CUDA sources (``csrc/``) into shared libraries.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``. The
output lands in ``sparkdl_tpu_torch/_build/<name>-<hash>/``, keyed by a
hash of every file under ``csrc/`` and the flags, so an edited source is
always rebuilt and a stale library is never loaded. The build runs at
first use, never at import.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # ptxas reports registers, shared memory and spills per kernel into
    # the build log
    "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    install location."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin); the CUDA kernels "
        "of sparkdl_tpu_torch are built at first use and need the CUDA "
        "toolkit"
    )


def _sources_digest() -> str:
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        h.update(fname.encode())
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    out_dir = os.path.join(BUILD_DIR, f"{name}-{_sources_digest()}")
    return os.path.join(out_dir, f"lib{name}.so")


def build_library(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its current build exists; return
    the library's path. Raises with nvcc's output when the build fails."""
    lib = library_path(name)
    if os.path.exists(lib):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True,
        text=True,
        check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    with open(os.path.join(os.path.dirname(lib), "build.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    # atomic publish: a concurrent loader sees the old state or the
    # whole library, never a half-written file
    os.replace(tmp, lib)
    return lib


def build_log(name: str) -> str:
    """nvcc's output (ptxas resource usage) from the current build."""
    path = os.path.join(os.path.dirname(library_path(name)), "build.log")
    with open(path) as f:
        return f.read()
