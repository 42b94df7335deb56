"""The JAX package's exported programs (``program.stablehlo`` and
``params.pkl``), read without JAX.

``sparkdl_tpu.graph.function.ModelFunction.export`` writes
``program.stablehlo``, which is ``jax.export.Exported.serialize()``: a
flatbuffer (the schema of ``jax/_src/export/serialization.fbs``) around a
StableHLO portable artifact with the weights baked in as constants and
the batch symbolic; and ``params.pkl``, a pickle of the params pytree as
numpy arrays with ``input_shape``, ``input_dtype`` and ``name``.

:func:`read_exported` decodes the flatbuffer's fields that loading needs:
``mlir_module_serialized``, the in/out avals with their symbolic dims,
``nr_devices``, ``calling_convention_version``, ``module_kept_var_idx``,
the platforms, the shardings and the effects. A program with effects,
with ``nr_devices`` > 1, with a sharding other than unspecified, or
lowered for several platforms (its ``main`` then takes a platform index)
is refused, naming ROADMAP item 13. The table layouts, from the
generated ``serialization_generated.py``: ``Exported`` fields 0
serialization_version (u16), 1 function_name, 2 in_tree, 3 in_avals, 4
out_tree, 5 out_avals, 6 nr_devices_short (i16), 7 in_shardings, 8
out_shardings, 9 platforms, 10 ordered_effects, 11 unordered_effects, 12
disabled_checks, 13 mlir_module_serialized, 14 calling_convention_version
(u16), 15 module_kept_var_idx (u16 vector), 16 uses_global_constants, 17
vjp, 18 nr_devices (u32); ``AbstractValue`` 0 kind, 1 shape (strings), 2
dtype, 3 memory_space; ``Sharding`` 0 kind (0 unspecified), 1
hlo_sharding_proto, 2 named_sharding.

:func:`read_params` reads ``params.pkl`` through a ``pickle.Unpickler``
whose ``find_class`` gives only numpy's array reconstructor, ``ndarray``
and ``dtype`` and refuses anything else by name, so a pickle cannot run
code on load.
"""

from __future__ import annotations

import pickle
import struct
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from sparkdl_tpu_torch.graph.mlir_bytecode import ITEM

#: ``DType`` of the flatbuffer schema -> numpy (and the StableHLO name)
_DTYPES = {
    0: ("bool", "i1"), 1: ("int8", "i8"), 2: ("int16", "i16"), 3: ("int32", "i32"), 4: ("int64", "i64"),
    5: ("uint8", "ui8"), 6: ("uint16", "ui16"), 7: ("uint32", "ui32"), 8: ("uint64", "ui64"),
    9: ("float16", "f16"), 10: ("float32", "f32"), 11: ("float64", "f64"), 14: ("bfloat16", "bf16"),
}


class UnsupportedExportError(NotImplementedError):
    def __init__(self, what: str):
        super().__init__(f"JAX exported program: {what} is not supported ({ITEM})")


@dataclass(frozen=True)
class Aval:
    """An abstract value: ``shape`` holds ints and symbolic dims (``"b"``)."""

    shape: Tuple[Any, ...]
    dtype: str  # numpy's name; "bfloat16" for bf16
    mlir_dtype: str


@dataclass
class Exported:
    function_name: str
    in_avals: Tuple[Aval, ...]
    out_avals: Tuple[Aval, ...]
    nr_devices: int
    platforms: Tuple[str, ...]
    calling_convention_version: int
    module_kept_var_idx: Tuple[int, ...]
    uses_global_constants: bool
    mlir_module_serialized: bytes


class _Table:
    """A flatbuffer table at ``pos`` of ``buf``."""

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt, self.vt_size = vt, struct.unpack_from("<H", buf, vt)[0]

    def _field(self, i: int) -> int:
        off = 4 + 2 * i
        if off >= self.vt_size:
            return 0
        o = struct.unpack_from("<H", self.buf, self.vt + off)[0]
        return self.pos + o if o else 0

    def scalar(self, i: int, fmt: str, default=0):
        at = self._field(i)
        return struct.unpack_from(fmt, self.buf, at)[0] if at else default

    def table(self, i: int) -> Optional["_Table"]:
        at = self._field(i)
        return _Table(self.buf, at + struct.unpack_from("<I", self.buf, at)[0]) if at else None

    def _vector(self, i: int) -> Tuple[int, int]:
        at = self._field(i)
        if not at:
            return 0, 0
        start = at + struct.unpack_from("<I", self.buf, at)[0]
        return start + 4, struct.unpack_from("<I", self.buf, start)[0]

    def bytes(self, i: int) -> bytes:
        start, n = self._vector(i)
        return bytes(self.buf[start:start + n])

    def string(self, i: int) -> str:
        return self.bytes(i).decode()

    def tables(self, i: int) -> List["_Table"]:
        start, n = self._vector(i)
        out = []
        for j in range(n):
            at = start + 4 * j
            out.append(_Table(self.buf, at + struct.unpack_from("<I", self.buf, at)[0]))
        return out

    def strings(self, i: int) -> List[str]:
        start, n = self._vector(i)
        out = []
        for j in range(n):
            at = start + 4 * j
            s = at + struct.unpack_from("<I", self.buf, at)[0]
            ln = struct.unpack_from("<I", self.buf, s)[0]
            out.append(bytes(self.buf[s + 4:s + 4 + ln]).decode())
        return out

    def u16s(self, i: int) -> List[int]:
        start, n = self._vector(i)
        return list(struct.unpack_from(f"<{n}H", self.buf, start)) if n else []


def _aval(t: _Table) -> Aval:
    if t.scalar(0, "<b") != 0:
        raise UnsupportedExportError("an abstract token argument (an effect)")
    code = t.scalar(2, "<b")
    if code not in _DTYPES:
        raise UnsupportedExportError(f"an argument of flatbuffer dtype {code}")
    dims = tuple(int(d) if d.lstrip("-").isdigit() else d for d in t.strings(1))
    np_name, mlir_name = _DTYPES[code]
    return Aval(dims, np_name, mlir_name)


def read_exported(data: bytes) -> Exported:
    """Decode ``Exported.serialize()``'s flatbuffer; refuse what the
    port does not run."""
    data = bytes(data)
    root = _Table(data, struct.unpack_from("<I", data, 0)[0])
    nr_devices = root.scalar(18, "<I") or root.scalar(6, "<h")
    if nr_devices > 1:
        raise UnsupportedExportError(f"a program over {nr_devices} devices")
    for i, what in ((10, "ordered"), (11, "unordered")):
        effects = [e.string(0) for e in root.tables(i)]
        if effects:
            raise UnsupportedExportError(f"{what} effects {effects}")
    for i in (7, 8):
        for s in root.tables(i):
            if s.scalar(0, "<b") != 0 or s.bytes(1) or s.table(2) is not None:
                raise UnsupportedExportError("a sharded argument or result")
    platforms = tuple(root.strings(9))
    if len(platforms) > 1:
        raise UnsupportedExportError(f"a program lowered for several platforms {list(platforms)}")
    return Exported(
        function_name=root.string(1),
        in_avals=tuple(_aval(t) for t in root.tables(3)),
        out_avals=tuple(_aval(t) for t in root.tables(5)),
        nr_devices=max(nr_devices, 1),
        platforms=platforms,
        calling_convention_version=root.scalar(14, "<H"),
        module_kept_var_idx=tuple(root.u16s(15)),
        uses_global_constants=bool(root.scalar(16, "<?")),
        mlir_module_serialized=root.bytes(13),
    )


# -- params.pkl --------------------------------------------------------------------

_RECONSTRUCT = np.zeros(1).__reduce__()[0]  # numpy's array reconstructor, whatever its module path
_ALLOWED = {
    ("numpy.core.multiarray", "_reconstruct"): _RECONSTRUCT,
    ("numpy._core.multiarray", "_reconstruct"): _RECONSTRUCT,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
}


class _NumpyOnly(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        found = _ALLOWED.get((module, name))
        if found is None:
            raise pickle.UnpicklingError(
                f"params.pkl refers to {module}.{name}: only numpy arrays are read from a JAX export")
        return found


def read_params(path: str) -> Dict[str, Any]:
    """``params.pkl`` as the JAX package wrote it: ``params`` (the pytree
    of numpy arrays), ``input_shape``, ``input_dtype``, ``name``."""
    with open(path, "rb") as f:
        meta = _NumpyOnly(f).load()
    if not isinstance(meta, dict) or "params" not in meta:
        raise ValueError(f"{path!r} is not the params of a JAX export")
    return meta


__all__ = ["Aval", "Exported", "UnsupportedExportError", "read_exported", "read_params"]
