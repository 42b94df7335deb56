"""Models and the named-model registry."""

from sparkdl_tpu_torch.models.registry import (
    NamedTextModel,
    get_model,
    param_bytes,
    supported_models,
)

__all__ = ["NamedTextModel", "get_model", "param_bytes", "supported_models"]
