"""Core Param / Params / TypeConverters / keyword_only machinery.

Semantics follow pyspark.ml.param, as in the JAX package: a ``Param`` is
a typed, documented slot declared as a class attribute on a ``Params``
stage; values live in per-instance maps (explicitly set vs. defaults);
``copy(extra)`` gives ParamMap overrides. Only what the ported slices
use is kept here.
"""

from __future__ import annotations

import copy as _copy
import functools
import numbers
import threading
from typing import Any, Callable, Dict, List, Optional


class Param:
    """A typed parameter slot with self-contained documentation."""

    def __init__(
        self,
        parent: Optional["Params"],
        name: str,
        doc: str,
        typeConverter: Optional[Callable[[Any], Any]] = None,
    ):
        self.parent = parent.uid if isinstance(parent, Params) else parent
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter or TypeConverters.identity

    def _copy_new_parent(self, parent: "Params") -> "Param":
        p = _copy.copy(self)
        p.parent = parent.uid
        return p

    def __repr__(self) -> str:
        return f"Param(parent={self.parent!r}, name={self.name!r})"

    def __hash__(self) -> int:
        return hash(str(self))

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, Param)
            and self.parent == other.parent
            and self.name == other.name
        )

    def __str__(self) -> str:
        return f"{self.parent}__{self.name}"


class TypeConverters:
    """Converters applied when a Param is set; raise TypeError on mismatch."""

    @staticmethod
    def identity(value: Any) -> Any:
        return value

    @staticmethod
    def toInt(value: Any) -> int:
        if isinstance(value, bool):
            raise TypeError(f"Could not convert {value!r} to int")
        if isinstance(value, numbers.Integral):
            return int(value)
        if isinstance(value, numbers.Real) and float(value).is_integer():
            return int(value)
        raise TypeError(f"Could not convert {value!r} to int")

    @staticmethod
    def toFloat(value: Any) -> float:
        if isinstance(value, bool):
            raise TypeError(f"Could not convert {value!r} to float")
        if isinstance(value, numbers.Real):
            return float(value)
        raise TypeError(f"Could not convert {value!r} to float")

    @staticmethod
    def toString(value: Any) -> str:
        if isinstance(value, str):
            return value
        raise TypeError(f"Could not convert {value!r} to string")

    @staticmethod
    def toChoice(*allowed: str) -> Callable[[Any], str]:
        """Converter factory: a string restricted to ``allowed``."""

        def convert(value: Any) -> str:
            v = TypeConverters.toString(value)
            if v not in allowed:
                raise TypeError(f"Expected one of {allowed}, got {v!r}")
            return v

        return convert

    @staticmethod
    def toBoolean(value: Any) -> bool:
        if isinstance(value, bool):
            return value
        raise TypeError(f"Could not convert {value!r} to bool")

    @staticmethod
    def toList(value: Any) -> list:
        if isinstance(value, (list, tuple)):
            return list(value)
        raise TypeError(f"Could not convert {value!r} to list")

    @staticmethod
    def toDict(value: Any) -> dict:
        if isinstance(value, dict):
            return value
        raise TypeError(f"Could not convert {value!r} to dict")


def keyword_only(func: Callable) -> Callable:
    """Force keyword-only calls and stash the kwargs in ``_input_kwargs``
    (pyspark.ml.util.keyword_only)."""

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        if args:
            raise TypeError(
                f"Method {func.__name__} only takes keyword arguments."
            )
        self._input_kwargs = kwargs
        return func(self, **kwargs)

    return wrapper


_uid_counters: Dict[str, int] = {}
_uid_lock = threading.Lock()


def _gen_uid(cls_name: str) -> str:
    # Param identity is (parent uid, name), so uids must never collide.
    with _uid_lock:
        n = _uid_counters.get(cls_name, 0)
        _uid_counters[cls_name] = n + 1
    return f"{cls_name}_{n:04x}"


class Params:
    """Base class for anything parameterized.

    Params are declared as class attributes (``Param`` instances with
    ``parent=None``); at construction each is re-bound to this instance's
    uid so ParamMaps keyed by ``Param`` resolve per stage.
    """

    def __init__(self):
        self.uid = _gen_uid(type(self).__name__)
        self._paramMap: Dict[Param, Any] = {}
        self._defaultParamMap: Dict[Param, Any] = {}
        for name in dir(type(self)):
            attr = getattr(type(self), name, None)
            if isinstance(attr, Param):
                setattr(self, name, attr._copy_new_parent(self))

    def getParam(self, name: str) -> Param:
        p = getattr(self, name, None)
        if isinstance(p, Param):
            return p
        raise ValueError(f"{type(self).__name__} has no param {name!r}")

    def hasParam(self, name: str) -> bool:
        return isinstance(getattr(self, name, None), Param)

    def _resolveParam(self, param) -> Param:
        if isinstance(param, Param):
            if param.parent != self.uid or not self.hasParam(param.name):
                raise ValueError(
                    f"Param {param} does not belong to {self.uid}"
                )
            return param
        if isinstance(param, str):
            return self.getParam(param)
        raise TypeError(f"Cannot resolve {param!r} as a param")

    def isSet(self, param) -> bool:
        return self._resolveParam(param) in self._paramMap

    def hasDefault(self, param) -> bool:
        return self._resolveParam(param) in self._defaultParamMap

    def isDefined(self, param) -> bool:
        return self.isSet(param) or self.hasDefault(param)

    def getOrDefault(self, param):
        param = self._resolveParam(param)
        if param in self._paramMap:
            return self._paramMap[param]
        if param in self._defaultParamMap:
            return self._defaultParamMap[param]
        raise KeyError(
            f"Param {param.name!r} is not set and has no default on {self.uid}"
        )

    def set(self, param, value) -> "Params":
        param = self._resolveParam(param)
        self._paramMap[param] = param.typeConverter(value)
        return self

    def _set(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            if value is None:
                continue
            p = self.getParam(name)
            try:
                self._paramMap[p] = p.typeConverter(value)
            except TypeError as e:
                raise TypeError(f"Invalid param value for {name!r}: {e}") from e
        return self

    def _setDefault(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            p = self.getParam(name)
            self._defaultParamMap[p] = (
                p.typeConverter(value) if value is not None else None
            )
        return self

    def copy(self, extra: Optional[dict] = None) -> "Params":
        """Copy with ParamMap overrides; Param-keyed entries of another
        stage are skipped (pyspark parity)."""
        that = _copy.copy(self)
        that._paramMap = dict(self._paramMap)
        that._defaultParamMap = dict(self._defaultParamMap)
        for k, v in (extra or {}).items():
            if isinstance(k, Param):
                if k.parent != that.uid or not that.hasParam(k.name):
                    continue
                p = getattr(that, k.name)
            else:
                p = that._resolveParam(k)
            that._paramMap[p] = p.typeConverter(v)
        return that

    # -- persistence (``persistence.py``) -----------------------------------

    def _reset_uid(self, uid: str) -> "Params":
        """Rebind this instance and its Params to a restored uid, so
        ParamMaps keyed on the saved stage resolve after a round trip; the
        class's uid counter moves past the restored suffix."""
        self.uid = uid
        cls_name, _, suffix = uid.rpartition("_")
        try:
            n = int(suffix, 16)
        except ValueError:
            cls_name, n = "", -1
        if cls_name:
            with _uid_lock:
                _uid_counters[cls_name] = max(_uid_counters.get(cls_name, 0), n + 1)
        remap = {}
        for name in dir(type(self)):
            attr = getattr(self, name, None)
            if isinstance(attr, Param):
                remap[attr] = attr._copy_new_parent(self)
                setattr(self, name, remap[attr])
        self._paramMap = {remap.get(p, p): v for p, v in self._paramMap.items()}
        self._defaultParamMap = {remap.get(p, p): v for p, v in self._defaultParamMap.items()}
        return self

    def _non_json_params(self) -> List[str]:
        """Param names whose values ``_save_extra`` persists itself."""
        return []

    def _save_extra(self, path: str) -> Optional[dict]:
        """Persist what is not a Param (weights, nested stages) under
        ``path``; an optional JSON-able dict is stored as metadata
        'extra'."""
        return None

    def _load_extra(self, path: str, meta: dict) -> None:
        """Inverse of ``_save_extra``."""

    def save(self, path: str, overwrite: bool = False) -> None:
        """Save this stage to a directory (MLlib ``stage.save``)."""
        from sparkdl_tpu_torch import persistence

        persistence.save_stage(self, path, overwrite=overwrite)

    @classmethod
    def load(cls, path: str, device=None) -> "Params":
        """Load a saved stage, checked against this class; tensors land on
        ``device`` (``cuda`` by default)."""
        from sparkdl_tpu_torch import persistence

        return persistence.load_stage(path, expected_class=cls, device=device)
