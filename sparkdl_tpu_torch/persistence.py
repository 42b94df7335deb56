"""Stage persistence: save/load for Transformers, Estimators, Pipelines.

A copy of the JAX package's ``persistence.py`` (MLlib's layout): a
``<path>/metadata.json`` per stage (class path, uid, version, JSON-able
params), subclass hooks ``_save_extra(path)`` / ``_load_extra(path, meta)``
for what is not JSON (weights as ``.npz``, nested stages), and
:func:`load`, which dispatches on the recorded class path, so
``sparkdl_tpu_torch.persistence.load(path)`` round-trips any stage of this
package. A stage saved by the JAX package loads too: its
``sparkdl_tpu.<module>.<Class>`` class paths, nested ones included, map by
name to ``sparkdl_tpu_torch.<module>.<Class>`` (nothing of ``sparkdl_tpu``
is imported), and each stage's ``_load_extra`` reads the JAX package's
payloads. A JAX class with no counterpart here, and any other class
path, is refused. ``load(path, device)``
puts the tensors of a stage that holds any (a fitted model) on ``device``,
``cuda`` by default. Training-state checkpoints are the estimator's job
(``torch.save`` in ``estimators/data_parallel_estimator.py``).
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

METADATA_FILE = "metadata.json"

# Instance attributes every Params object owns; anything beyond these (minus
# the class's declared _persist_ignore caches) is stage state that MUST be
# handled by _save_extra/_load_extra — otherwise save() refuses rather than
# writing a checkpoint that loads hollow.
_PARAMS_BASE_ATTRS = frozenset(
    {"uid", "_paramMap", "_defaultParamMap", "_params", "_input_kwargs"}
)


def _class_path(obj: Any) -> str:
    return f"{type(obj).__module__}.{type(obj).__name__}"


_PORT = "sparkdl_tpu_torch"
_JAX = "sparkdl_tpu"


def _in_package(module: str, package: str) -> bool:
    return module == package or module.startswith(package + ".")


def _locate(class_path: str):
    """The class a saved stage names: a port class as it is, a JAX class
    as the port class of the same module path and name."""
    module, _, name = class_path.rpartition(".")
    if _in_package(module, _JAX):
        port_module = _PORT + module[len(_JAX):]
        try:
            cls = getattr(importlib.import_module(port_module), name, None)
        except ModuleNotFoundError as e:
            # only the port module itself being absent is a missing
            # counterpart; a module that fails to import raises as it is
            if e.name is None or not _in_package(port_module, e.name):
                raise
            cls = None
        if cls is None:
            raise ValueError(
                f"Refusing to load class {class_path!r}: the JAX package's "
                f"{name} has no counterpart {port_module}.{name} in the port"
            )
        return cls
    if not _in_package(module, _PORT):
        raise ValueError(
            f"Refusing to load class {class_path!r}: persistence only "
            f"instantiates sparkdl_tpu_torch classes and the JAX package's "
            f"sparkdl_tpu classes"
        )
    return getattr(importlib.import_module(module), name)


def _jsonable(value: Any) -> bool:
    try:
        json.dumps(value)
        return True
    except (TypeError, ValueError):
        return False


def save_metadata(
    instance,
    path: str,
    extra: Optional[Dict[str, Any]] = None,
    skip_params: Optional[List[str]] = None,
) -> None:
    """Write ``metadata.json`` for a Params instance. Params whose values are
    not JSON-serializable must either be listed in ``skip_params`` (the
    subclass's ``_save_extra`` persists them) or saving fails loudly —
    silently dropping state would corrupt round-trips."""
    from sparkdl_tpu_torch import __version__

    skip = set(skip_params or [])
    param_map, default_map, bad = {}, {}, []
    for p, v in instance._paramMap.items():
        if p.name in skip:
            continue
        (param_map.__setitem__(p.name, v) if _jsonable(v) else bad.append(p.name))
    for p, v in instance._defaultParamMap.items():
        if p.name in skip:
            continue
        # The subclass ctor does NOT run on load, so defaults must persist
        # too — a non-JSON default is as fatal as a non-JSON set value.
        (default_map.__setitem__(p.name, v) if _jsonable(v) else bad.append(p.name))
    if bad:
        raise ValueError(
            f"Cannot save {type(instance).__name__}: params {bad} hold "
            f"non-serializable values. Persist them via _save_extra or clear "
            f"them before saving."
        )
    meta = {
        "class": _class_path(instance),
        "uid": instance.uid,
        "sparkdl_version": __version__,
        "timestamp": time.time(),
        "paramMap": param_map,
        "defaultParamMap": default_map,
    }
    if extra:
        meta["extra"] = extra
    with open(os.path.join(path, METADATA_FILE), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)


def read_metadata(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, METADATA_FILE)) as f:
        return json.load(f)


def _unhandled_state_attrs(instance) -> List[str]:
    ignore = set()
    for klass in type(instance).__mro__:
        ignore.update(getattr(klass, "_persist_ignore", ()))
    from sparkdl_tpu_torch.params.base import Param

    return [
        k
        for k, v in vars(instance).items()
        if k not in _PARAMS_BASE_ATTRS
        and k not in ignore
        and not isinstance(v, Param)  # instance-rebound Param declarations
    ]


def save_stage(instance, path: str, overwrite: bool = False) -> None:
    """Save a stage atomically: everything is written to a temp sibling
    directory first and renamed into place, so a failed save never leaves a
    half-written (and hence unloadable) checkpoint at ``path``, and
    re-saving replaces stale payloads wholesale."""
    from sparkdl_tpu_torch.params.base import Params

    if (
        type(instance)._save_extra is Params._save_extra
        and (state := _unhandled_state_attrs(instance))
    ):
        raise NotImplementedError(
            f"{type(instance).__name__} holds instance state {state} but "
            f"defines no _save_extra/_load_extra hooks; saving it would "
            f"produce a checkpoint that loads without that state."
        )
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(
                f"Path {path!r} already exists; pass overwrite=True"
            )
        if not os.path.isdir(path) or (
            os.listdir(path)
            and not os.path.exists(os.path.join(path, METADATA_FILE))
        ):
            raise FileExistsError(
                f"Refusing to overwrite {path!r}: not a saved-stage directory"
            )
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        save_metadata(
            instance,
            tmp,
            extra=instance._save_extra(tmp),
            skip_params=instance._non_json_params(),
        )
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def load_stage(path: str, expected_class=None, device=None):
    """Instantiate the stage recorded at ``path``. The instance is created
    without running the subclass ctor (mirrors MLlib: params come from
    metadata, payloads from _load_extra), preserving the saved uid; a
    stage that holds tensors places them on ``device`` (its ``_device``,
    ``cuda`` by default)."""
    from sparkdl_tpu_torch.runtime.device import resolve_device

    from sparkdl_tpu_torch.params.base import Params

    meta = read_metadata(path)
    cls = _locate(meta["class"])
    if expected_class is not None and not issubclass(cls, expected_class):
        raise TypeError(
            f"Saved stage at {path!r} is {cls.__name__}, expected "
            f"{expected_class.__name__}"
        )
    inst = cls.__new__(cls)
    Params.__init__(inst)
    inst._reset_uid(meta["uid"])
    for name, value in meta.get("defaultParamMap", {}).items():
        if inst.hasParam(name):
            inst._setDefault(**{name: value})
    for name, value in meta.get("paramMap", {}).items():
        if inst.hasParam(name):
            inst._set(**{name: value})
    if device is not None:
        inst._device = resolve_device(device)
    inst._load_extra(path, meta)
    return inst


def load(path: str, device=None):
    """Generic entry point: load any saved sparkdl_tpu_torch stage."""
    return load_stage(path, device=device)
