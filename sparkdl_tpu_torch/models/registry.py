"""Named model registry (the text half): ``bert-base``, ``bert-tiny``,
``bert-long-2048``.

Each entry builds a :class:`~sparkdl_tpu_torch.graph.function.ModelFunction`
over int32 token-id batches ``[B, L]`` producing ``[B, feature_dim]``
masked mean-pooled embeddings. The attention mask is derived on the
device as ``ids != 0`` when the caller passes bare ids, so zero-padding a
row to any length never changes its embedding.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.models.bert import (
    BERT_CONFIGS,
    BertEncoder,
    dense_attention,
    init_bert_params,
)
from sparkdl_tpu_torch.models.convert import bert_params_from_flax
from sparkdl_tpu_torch.ops.flash_attention import make_flash_attention_fn
from sparkdl_tpu_torch.runtime.device import resolve_device


@dataclass(frozen=True)
class NamedTextModel:
    """A registered text model."""

    name: str
    max_length: int  # position-table capacity == the hard length ceiling
    feature_dim: int
    builder: Callable[..., ModelFunction]
    vocab_size: int = 30522

    def model_function(
        self,
        mode: str = "embed",
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        params: Any = None,
        device=None,
    ) -> ModelFunction:
        """mode: 'embed' (masked-mean pooled embedding; 'features' is an
        alias). ``params``: the JAX package's flax ``{"params": ...}`` tree
        to carry across; without it the weights come from a
        ``torch.Generator`` seeded with ``seed``. ``device``: ``cuda`` by
        default (raises when there is none); pass ``"cpu"`` for the CPU."""
        if mode not in ("embed", "features"):
            raise ValueError(
                f"Unknown text-model mode {mode!r}; supported: embed "
                "(alias: features)"
            )
        return self.builder(
            self, mode=mode, dtype=dtype, seed=seed, params=params,
            device=resolve_device(device),
        )


def _bert_text_builder(size: str, attention: str = "flash"):
    """Builder over the BERT presets. ``attention``: 'flash' (the CUDA
    kernel on the card, its plain version on the CPU) or 'dense'."""
    if attention not in ("flash", "dense"):
        raise ValueError(f"attention must be 'flash' or 'dense', got {attention!r}")

    def build(
        spec: NamedTextModel, mode: str, dtype, seed, params, device
    ) -> ModelFunction:
        config = replace(BERT_CONFIGS[size], dtype=dtype)
        attention_fn = (
            dense_attention if attention == "dense" else make_flash_attention_fn()
        )
        with torch.device("meta"):
            module = BertEncoder(config, attention_fn)
        module = module.to_empty(device=device)
        if params is None:
            init_bert_params(
                module, torch.Generator(device=device).manual_seed(seed)
            )
        else:
            module.load_state_dict(bert_params_from_flax(params, config))
        module.cast_projections().eval()
        max_pos = config.max_position_embeddings

        def fn(mod, x):
            # TextEmbedder feeds (ids, mask); bare ids derive the mask as
            # ids != 0, so pad id 0 never attends and never pools.
            ids, mask = x if isinstance(x, (tuple, list)) else (x, None)
            if ids.shape[1] > max_pos:
                raise ValueError(
                    f"sequence length {ids.shape[1]} exceeds "
                    f"{spec.name}'s position table ({max_pos})"
                )
            if mask is None:
                mask = (ids != 0).to(torch.int32)
            return mod(ids, mask, pooled=True)

        return ModelFunction(
            fn,
            module,
            device,
            name=f"{spec.name}[{mode}]",
            vocab_size=config.vocab_size,
        )

    return build


def param_bytes(tree: Any) -> int:
    """Total bytes of a model's parameters: a ModelFunction, an
    ``nn.Module``, or a (nested) mapping of tensors/arrays."""
    if isinstance(tree, ModelFunction):
        tree = tree.module
    if isinstance(tree, nn.Module):
        return sum(p.nbytes for p in tree.parameters())
    if hasattr(tree, "items"):
        return sum(param_bytes(v) for v in tree.values())
    return int(getattr(tree, "nbytes", 0))


_REGISTRY: Dict[str, NamedTextModel] = {}


def _register(spec: NamedTextModel) -> None:
    _REGISTRY[spec.name.lower()] = spec


_register(
    NamedTextModel(
        "bert-base", 512, 768, _bert_text_builder("base"),
        vocab_size=30522,
    )
)
_register(
    NamedTextModel(
        "bert-tiny", 128, 128, _bert_text_builder("tiny"),
        vocab_size=1000,
    )
)
_register(
    NamedTextModel(
        "bert-long-2048", 2048, 128, _bert_text_builder("long"),
        vocab_size=8192,
    )
)


def get_model(name: str) -> NamedTextModel:
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(
            f"Unknown model {name!r}; supported: {supported_models()}"
        )
    return _REGISTRY[key]


def supported_models(kind: Optional[str] = None) -> list:
    """Registered model names, sorted; ``kind='text'`` filters (every
    entry of this slice is a text model)."""
    if kind not in (None, "text", "image"):
        raise ValueError(f"kind must be 'text' or 'image', got {kind!r}")
    if kind == "image":
        return []
    return sorted(m.name for m in _REGISTRY.values())
