"""Models and the named-model registry."""

from sparkdl_tpu_torch.models.bert import bert_model_function_sequence_parallel
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
    "bert_model_function_sequence_parallel",
    "get_image_model",
    "get_model",
    "param_bytes",
    "register_model",
    "save_flax_weights",
    "supported_models",
]
