"""Core Param / Params / TypeConverters / keyword_only machinery.

Semantics follow pyspark.ml.param, as in the JAX package: a ``Param`` is
a typed, documented slot declared as a class attribute on a ``Params``
stage; values live in per-instance maps (explicitly set vs. defaults);
``copy(extra)`` gives ParamMap overrides; ``params``,
``extractParamMap``, ``explainParam(s)``, ``clear`` and ``saveParams``
are the JAX package's public surface, with its strings and ordering.
"""

from __future__ import annotations

import copy as _copy
import functools
import json
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
    def toListString(value: Any) -> List[str]:
        lst = TypeConverters.toList(value)
        if all(isinstance(v, str) for v in lst):
            return lst
        raise TypeError(f"Could not convert {value!r} to list of strings")

    @staticmethod
    def toListInt(value: Any) -> List[int]:
        return [TypeConverters.toInt(v) for v in TypeConverters.toList(value)]

    @staticmethod
    def toListFloat(value: Any) -> List[float]:
        return [TypeConverters.toFloat(v) for v in TypeConverters.toList(value)]

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

    @property
    def params(self) -> List[Param]:
        """Every Param of this stage, sorted by name."""
        # declared on the class, bound per instance; no property runs
        return sorted(
            (
                getattr(self, name)
                for name in dir(type(self))
                if isinstance(getattr(type(self), name, None), Param)
            ),
            key=lambda p: p.name,
        )

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

    def clear(self, param) -> "Params":
        """Unset ``param``; its default, if any, applies again."""
        self._paramMap.pop(self._resolveParam(param), None)
        return self

    def extractParamMap(self, extra: Optional[dict] = None) -> Dict[Param, Any]:
        """Defaults, overlaid by set values, overlaid by ``extra`` (whose
        keys must be this stage's params or their names)."""
        pm = dict(self._defaultParamMap)
        pm.update(self._paramMap)
        for k, v in (extra or {}).items():
            pm[self._resolveParam(k)] = v
        return pm

    def explainParam(self, param) -> str:
        """``name: doc (current: v | default: v | undefined)``."""
        param = self._resolveParam(param)
        if self.isSet(param):
            state = f"current: {self.getOrDefault(param)!r}"
        elif self.hasDefault(param):
            state = f"default: {self._defaultParamMap[param]!r}"
        else:
            state = "undefined"
        return f"{param.name}: {param.doc} ({state})"

    def explainParams(self) -> str:
        """One :meth:`explainParam` line per param, sorted by name."""
        return "\n".join(self.explainParam(p) for p in self.params)

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

    def _params_to_json(self) -> str:
        def enc(v):
            try:
                json.dumps(v)
                return v
            except (TypeError, ValueError):
                return f"<non-serializable:{type(v).__name__}>"

        return json.dumps(
            {
                "class": f"{type(self).__module__}.{type(self).__name__}",
                "uid": self.uid,
                "paramMap": {p.name: enc(v) for p, v in self._paramMap.items()},
                "defaultParamMap": {p.name: enc(v) for p, v in self._defaultParamMap.items()},
            },
            indent=2,
            sort_keys=True,
        )

    def saveParams(self, path: str) -> None:
        """Write this stage's params as one JSON file (values that JSON
        cannot hold are written as ``<non-serializable:Type>``)."""
        with open(path, "w") as f:
            f.write(self._params_to_json())

    def _load_params_json(self, path: str) -> None:
        """Set the params a :meth:`saveParams` file holds (its explicitly
        set values, not its defaults)."""
        with open(path) as f:
            blob = json.load(f)
        for name, value in blob.get("paramMap", {}).items():
            if self.hasParam(name) and not (
                isinstance(value, str) and value.startswith("<non-serializable:")
            ):
                self._set(**{name: value})

    @classmethod
    def load(cls, path: str, device=None) -> "Params":
        """Load a saved stage, checked against this class; tensors land on
        ``device`` (``cuda`` by default)."""
        from sparkdl_tpu_torch import persistence

        return persistence.load_stage(path, expected_class=cls, device=device)
