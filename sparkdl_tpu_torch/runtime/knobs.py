"""The ``SPARKDL_*`` env knobs this package reads, each declared once.

A copy of the part of the JAX package's knob registry that the text
slice reads, with the same names, defaults and accessor semantics:

- an unset (or, for numeric knobs, empty) value falls back to the
  declared default;
- a flag is on unless its value is empty, ``0`` or ``off``;
- a malformed number raises ``ValueError`` naming the knob;
- reading an undeclared ``SPARKDL_*`` name raises ``KeyError``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

#: name -> (kind, default as the raw string an unset variable behaves as)
_KNOBS: Dict[str, Tuple[str, Optional[str]]] = {
    # transformers/execution.py
    "SPARKDL_PREFETCH_PER_DEVICE": ("int", "2"),
    # text/bucketing.py
    "SPARKDL_TEXT_BUCKETING": ("flag", "1"),
    "SPARKDL_TEXT_BUCKETS": ("str", "half"),
    "SPARKDL_TEXT_MIN_BUCKET": ("int", "16"),
}


def _default(name: str) -> Optional[str]:
    if name not in _KNOBS:
        raise KeyError(f"{name} is not a declared knob of sparkdl_tpu_torch")
    return _KNOBS[name][1]


def get_str(name: str) -> Optional[str]:
    """String value with the declared default applied."""
    default = _default(name)
    v = os.environ.get(name)
    return default if v is None else v


def get_int(name: str) -> Optional[int]:
    default = _default(name)
    raw = os.environ.get(name)
    if raw is None or raw == "":
        raw = default
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        f = float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not numeric") from None
    if not f.is_integer():
        raise ValueError(f"{name}={raw!r} is not an integer")
    return int(f)


def get_flag(name: str) -> bool:
    """True unless the effective value is unset, empty, ``0`` or ``off``."""
    v = get_str(name)
    return v is not None and v not in ("", "0", "off")
