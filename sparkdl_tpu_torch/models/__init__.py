"""Models and the named-model registry."""

from sparkdl_tpu_torch.models.registry import (
    NamedImageModel,
    NamedTextModel,
    get_image_model,
    get_model,
    param_bytes,
    register_model,
    save_flax_weights,
    supported_models,
)

__all__ = [
    "NamedImageModel",
    "NamedTextModel",
    "get_image_model",
    "get_model",
    "param_bytes",
    "register_model",
    "save_flax_weights",
    "supported_models",
]
