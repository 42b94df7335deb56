"""A gang worker's loader with a seeded canary version of bert-base.

``python -m sparkdl_tpu_torch.serving gateway --loader
sparkdl_tpu_torch.serving.canary_loader:loader`` (or ``worker
--loader ...``): importing this module in a worker registers
``bert-base-canary``, bert-base whose random weights come from the
worker's ``--seed`` + 1, and :func:`loader` builds every model as the
registry's default loader does, on the worker's device and seed. With
``SPARKDL_SERVE_CANARY_MODEL=bert-base`` and
``SPARKDL_SERVE_CANARY_VERSION=bert-base-canary`` in the workers'
environment, each worker's router splits bert-base traffic onto a
model that answers differently, so a reply says which arm served it.
"""

from __future__ import annotations

from sparkdl_tpu_torch.models.registry import (
    NamedTextModel,
    _bert_text_builder,
    get_model,
    register_model,
)
from sparkdl_tpu_torch.serving.residency import _default_loader

CANARY_NAME = "bert-base-canary"
#: the canary's weights come from the worker's seed + this
SEED_OFFSET = 1


def _canary_builder():
    base = _bert_text_builder("base")

    def build(spec, mode, dtype, seed, params, device):
        return base(spec, mode=mode, dtype=dtype, seed=seed + SEED_OFFSET,
                    params=params, device=device)

    return build


def register_canary() -> None:
    """Register :data:`CANARY_NAME` beside bert-base, with its geometry."""
    primary = get_model("bert-base")
    register_model(NamedTextModel(
        CANARY_NAME, primary.max_length, primary.feature_dim, _canary_builder(),
        vocab_size=primary.vocab_size, size=primary.size,
    ))


register_canary()


def loader(name: str, mode: str, precision: str = "f32", *, device=None, seed: int = 0):
    """The registry's default loader on the worker's device and seed."""
    return _default_loader(name, mode, precision, device=device, seed=seed)


__all__ = ["CANARY_NAME", "SEED_OFFSET", "loader", "register_canary"]
