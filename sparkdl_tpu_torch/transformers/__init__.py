"""Pipeline transformers and the batched execution engine under them.

The transformers below are exported lazily: importing this package
imports none of its modules.
"""

_EXPORTS = {
    "ImageModelTransformer": "sparkdl_tpu_torch.transformers.image_model",
    "TFImageTransformer": "sparkdl_tpu_torch.transformers.image_model",
    "KerasImageFileTransformer": "sparkdl_tpu_torch.transformers.keras_image",
    "DeepImageFeaturizer": "sparkdl_tpu_torch.transformers.named_image",
    "DeepImagePredictor": "sparkdl_tpu_torch.transformers.named_image",
    "KerasTransformer": "sparkdl_tpu_torch.transformers.tensor",
    "ModelTransformer": "sparkdl_tpu_torch.transformers.tensor",
    "TFTransformer": "sparkdl_tpu_torch.transformers.tensor",
    "HashingTokenizer": "sparkdl_tpu_torch.transformers.text",
    "TextEmbedder": "sparkdl_tpu_torch.transformers.text",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module 'sparkdl_tpu_torch.transformers' has no attribute {name!r}")
    from importlib import import_module

    return getattr(import_module(_EXPORTS[name]), name)
