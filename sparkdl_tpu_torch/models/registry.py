"""Named model registry: text models ``bert-base``, ``bert-tiny``,
``bert-long-2048`` and the image models ``InceptionV3``, ``MobileNetV2``,
``ResNet50``, ``VGG16``, ``VGG19`` and ``Xception``, in one namespace as in
the JAX package, at its geometries.

A text entry builds a :class:`~sparkdl_tpu_torch.graph.function.ModelFunction`
over int32 token-id batches ``[B, L]`` producing ``[B, feature_dim]``
masked mean-pooled embeddings. The attention mask is derived on the
device as ``ids != 0`` when the caller passes bare ids, so zero-padding a
row to any length never changes its embedding.

An image entry builds one over preprocessed NCHW float batches at the
entry's geometry, producing pooled features, logits or probabilities.
Its weights come from a ``torch.Generator`` seeded with ``seed``, from a
flax ``.npz`` that the JAX package's ``save_flax_weights`` wrote, or from
a Keras file of the ``keras.applications`` architecture (``.keras``,
``.h5``/``.hdf5``, ``.weights.h5``; ``models/keras_weights.py``). A text
entry takes a flax ``.npz`` too.
ResNet101 and ResNet152 are modules of both packages but, as in the JAX
registry, not registered models.

What serving residency and ``GET /v1/models`` read off a spec:
``param_bytes_estimate()`` (the float32 parameter bytes of a module built
on the ``meta`` device: shapes only, no storage), ``input_dtype`` (the
wire dtype) and the analytic forward FLOPs the ``serve.mfu`` gauge counts:
``flops_per_item()`` and, for text, ``flops_fn(seq_len)`` (the JAX
package's formula, ``utils/flops.py``); an image entry's FLOPs are 2 x
``bench_bounds.model_macs`` of its module at the registry geometry, so
the port has one source of MACs.

:func:`register_model` adds a user entry: an image entry needs only a
torch module factory (``module_factory(dtype=, num_classes=,
input_size=)`` returning a ``models.layers.ImageCNN``), from which the
builder is made. :func:`save_flax_weights` writes the flax ``.npz`` that
``weights_file`` reads.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.models.bert import (
    BERT_CONFIGS,
    BertEncoder,
    BertGenerator,
    dense_attention,
    init_bert_params,
)
from sparkdl_tpu_torch.models.convert import (
    bert_params_from_flax,
    cnn_params_from_flax,
)
from sparkdl_tpu_torch.models.inception import InceptionV3
from sparkdl_tpu_torch.models.layers import init_cnn_params
from sparkdl_tpu_torch.models.mobilenet import MobileNetV2
from sparkdl_tpu_torch.models.resnet import ResNet50
from sparkdl_tpu_torch.models.vgg import VGG16, VGG19
from sparkdl_tpu_torch.models.xception import Xception
from sparkdl_tpu_torch.ops.flash_attention import make_flash_attention_fn
from sparkdl_tpu_torch.runtime.device import resolve_device

#: name -> parameter-byte estimate (building a module, even on meta,
#: takes a few hundred ms; GET /v1/models asks for every entry)
_ESTIMATE_CACHE: Dict[str, int] = {}
#: name -> forward FLOPs of one image at the registry geometry
_FLOPS_CACHE: Dict[str, float] = {}


def _meta_param_bytes(name: str, factory: Callable[[], nn.Module]) -> int:
    if name not in _ESTIMATE_CACHE:
        with torch.device("meta"):
            _ESTIMATE_CACHE[name] = param_bytes(factory())
    return _ESTIMATE_CACHE[name]


@dataclass(frozen=True)
class NamedTextModel:
    """A registered text model."""

    name: str
    max_length: int  # position-table capacity == the hard length ceiling
    feature_dim: int
    builder: Callable[..., ModelFunction]
    vocab_size: int = 30522
    #: the BERT_CONFIGS preset the builder builds
    size: str = "base"

    @property
    def input_dtype(self) -> str:
        return "int32"

    def param_bytes_estimate(self) -> int:
        """float32 parameter bytes, from a module built on ``meta``."""
        config = BERT_CONFIGS[self.size]
        return _meta_param_bytes(self.name, lambda: BertEncoder(config, dense_attention))

    def flops_fn(self, seq_len: int) -> float:
        """Analytic forward FLOPs of one sequence of ``seq_len`` tokens
        (``utils/flops.bert_flops_per_example`` at this entry's geometry)."""
        from sparkdl_tpu_torch.utils.flops import bert_flops_per_example

        c = BERT_CONFIGS[self.size]
        return bert_flops_per_example(
            seq_len, hidden=c.hidden_size, num_layers=c.num_layers,
            intermediate=c.intermediate_size,
        )

    def flops_per_item(self, seq_len: Optional[int] = None) -> float:
        """Forward FLOPs of one example at ``seq_len`` (default: the full
        ``max_length``)."""
        return self.flops_fn(seq_len if seq_len else self.max_length)

    def model_function(
        self,
        mode: str = "embed",
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        params: Any = None,
        device=None,
        weights_file: Optional[str] = None,
    ) -> ModelFunction:
        """mode: 'embed' (masked-mean pooled embedding; 'features' is an
        alias). ``params``: the JAX package's flax ``{"params": ...}`` tree
        to carry across; ``weights_file``: the same tree as a flax ``.npz``
        (keys joined by '/', as the JAX package's ``save_flax_weights``
        writes it); without either the weights come from a
        ``torch.Generator`` seeded with ``seed``. ``device``: ``cuda`` by
        default (raises when there is none); pass ``"cpu"`` for the CPU."""
        if mode not in ("embed", "features"):
            raise ValueError(
                f"Unknown text-model mode {mode!r}; supported: embed "
                "(alias: features)"
            )
        return self.builder(
            self, mode=mode, dtype=dtype, seed=seed,
            params=_text_params(params, weights_file), device=resolve_device(device),
        )

    def supports_generate(self) -> bool:
        """Every registered text entry is a BERT encoder, whose modules the
        generator runs over."""
        return True

    def kv_bytes_per_token(self) -> int:
        """Per-token K/V cache bytes (float32 cache): 2 x layers x hidden
        x 4, what the admission-time KV reservation charges per position
        and ``/v1/models`` advertises."""
        c = BERT_CONFIGS[self.size]
        return 2 * c.num_layers * c.hidden_size * 4

    def generate_function(
        self,
        dtype: torch.dtype = torch.float32,
        weights_file: Optional[str] = None,
        seed: int = 0,
        params: Any = None,
        device=None,
    ) -> BertGenerator:
        """The ``mode='generate'`` surface: a
        :class:`~sparkdl_tpu_torch.models.bert.BertGenerator` over the
        encoder that :meth:`model_function` builds from the same ``seed``,
        ``params`` or ``weights_file`` (the same weights). Generation runs
        float32 only; another ``dtype`` raises."""
        if dtype != torch.float32:
            raise ValueError(f"generation runs float32 only; got dtype {dtype}")
        encoder = _bert_encoder(
            BERT_CONFIGS[self.size], dense_attention, seed,
            _text_params(params, weights_file), resolve_device(device),
        )
        return BertGenerator(encoder, max_length=self.max_length)


def _text_params(params: Any, weights_file: Optional[str]) -> Any:
    if weights_file:
        if params is not None:
            raise ValueError("pass params or weights_file, not both")
        return load_flax_npz(weights_file)
    return params


def _bert_encoder(config, attention_fn, seed: int, params: Any, device) -> BertEncoder:
    """A BERT encoder on ``device``: weights from ``params`` (a flax tree)
    or drawn from a ``torch.Generator`` on ``device`` seeded with
    ``seed``; projections stored in ``config.dtype``."""
    with torch.device("meta"):
        module = BertEncoder(config, attention_fn)
    module = module.to_empty(device=device)
    if params is None:
        init_bert_params(module, torch.Generator(device=device).manual_seed(seed))
    else:
        module.load_state_dict(bert_params_from_flax(params, config))
    return module.cast_projections().eval()


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
        module = _bert_encoder(config, attention_fn, seed, params, device)
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


@dataclass(frozen=True)
class NamedImageModel:
    """A registered image model: its input geometry, its preprocessing
    convention ('tf' | 'caffe' | 'torch') and its feature width. Without a
    ``builder``, the registry's own is made from ``module_factory``."""

    name: str
    height: int
    width: int
    preprocessing: str
    feature_dim: int
    builder: Optional[Callable[..., ModelFunction]] = None
    num_classes: int = 1000
    #: (dtype=, num_classes=, input_size=) -> the module the builder builds
    module_factory: Optional[Callable[..., nn.Module]] = None

    def __post_init__(self):
        if self.builder is None:
            if self.module_factory is None:
                raise ValueError(f"image model {self.name!r} needs a builder or a module_factory")
            object.__setattr__(self, "builder", _cnn_builder(self.module_factory))

    def flops_per_item(self) -> Optional[float]:
        """Forward FLOPs of one image at the registry geometry: 2 x the
        MACs of the module's convolutions and dense layers, head included
        (``bench_bounds.model_macs`` on a ``meta`` module), computed once."""
        if self.module_factory is None:
            return None
        if self.name not in _FLOPS_CACHE:
            from sparkdl_tpu_torch.bench_bounds import model_macs

            with torch.device("meta"):
                module = self.module_factory(
                    dtype=torch.float32, num_classes=self.num_classes,
                    input_size=(self.height, self.width),
                )
            _FLOPS_CACHE[self.name] = 2.0 * model_macs(module, (3, self.height, self.width))
        return _FLOPS_CACHE[self.name]

    @property
    def input_shape(self) -> Tuple[int, int, int]:
        return (self.height, self.width, 3)

    @property
    def input_dtype(self) -> str:
        """The wire dtype of a row: preprocessed NHWC float32."""
        return "float32"

    def param_bytes_estimate(self) -> Optional[int]:
        """float32 parameter bytes, from a module built on ``meta``."""
        if self.module_factory is None:
            return None
        return _meta_param_bytes(self.name, lambda: self.module_factory(
            dtype=torch.float32, num_classes=self.num_classes,
            input_size=(self.height, self.width),
        ))

    def model_function(
        self,
        mode: str = "features",
        dtype: torch.dtype = torch.float32,
        weights_file: Optional[str] = None,
        seed: int = 0,
        device=None,
    ) -> ModelFunction:
        """mode: 'features' (the pooled bottleneck vector), 'logits', or
        'probabilities' (softmax over the head). ``weights_file``: a flax
        ``.npz`` (``{"params", "batch_stats"}`` keys joined by '/', a
        ResNet's in either block layout) or a Keras file of the
        architecture (``.keras``, ``.h5``/``.hdf5``, ``.weights.h5``; a
        headless one serves 'features' only); without one the weights come
        from a CPU ``torch.Generator`` seeded with ``seed``, the same on
        every device. ``device``: ``cuda`` by default (raises when there
        is none); pass ``"cpu"`` for the CPU."""
        if mode not in ("features", "logits", "probabilities"):
            raise ValueError(
                f"Unknown image-model mode {mode!r}; supported: features, "
                "logits, probabilities"
            )
        return self.builder(
            self, mode=mode, dtype=dtype, weights_file=weights_file,
            seed=seed, device=resolve_device(device),
        )


def load_flax_npz(weights_file: str, spec: Optional["NamedImageModel"] = None,
                  module: Optional[nn.Module] = None,
                  allow_missing_head: bool = True) -> Dict[str, Any]:
    """A weights file -> flax variables as a nested dict of numpy arrays,
    as the JAX package's ``_load_flax_weights``: a flat ``.npz`` (keys
    joined by '/'), or a Keras file (``.keras``, ``.h5``/``.hdf5``,
    ``.weights.h5``) of ``spec``'s architecture, converted by
    ``keras_weights.load_keras_weights`` and checked against ``module``.
    Pickled trees are not read (unpickling runs code), and the
    'imagenet' artifact needs a download."""
    from sparkdl_tpu_torch.models import keras_weights

    if keras_weights.is_keras_weights_file(weights_file):
        if spec is None:
            raise ValueError("Keras weight files need a registry spec for conversion")
        return keras_weights.load_keras_weights(
            spec.name, weights_file, module=module, allow_missing_head=allow_missing_head,
        )
    if not weights_file.endswith(".npz"):
        raise NotImplementedError(
            f"weights file {weights_file!r}: the port loads flax .npz and "
            "Keras .keras/.h5/.hdf5/.weights.h5 files; pickled trees are "
            "not read, and 'imagenet' weights need a download (not queued)"
        )
    tree: Dict[str, Any] = {}
    with np.load(weights_file, allow_pickle=False) as blob:
        for flat_key in blob.files:
            node = tree
            *parents, leaf = flat_key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = blob[flat_key]
    return tree


def save_flax_weights(tree: Any, path: str) -> None:
    """Write a flax variable tree (a nested dict of arrays or tensors) as a
    flat ``.npz``, keys joined by '/': the JAX package's
    ``save_flax_weights`` layout, which :func:`load_flax_npz` and every
    ``weights_file`` read."""
    flat: Dict[str, np.ndarray] = {}

    def visit(node, prefix):
        if hasattr(node, "items"):
            for key, sub in node.items():
                visit(sub, f"{prefix}/{key}" if prefix else str(key))
        else:
            flat[prefix] = np.asarray(node)

    visit(tree, "")
    np.savez(path, **flat)


def _cnn_builder(module_factory: Callable[..., nn.Module]):
    """Builder over an image-model factory (``ResNet50``, ``InceptionV3``,
    ...) that takes ``dtype``, ``num_classes`` and ``input_size``."""

    def build(spec: NamedImageModel, mode: str, dtype, weights_file, seed,
              device) -> ModelFunction:
        # built without storage: every tensor is loaded or drawn below
        with torch.device("meta"):
            module = module_factory(
                dtype=dtype, num_classes=spec.num_classes,
                input_size=(spec.height, spec.width),
            )
        if weights_file:
            # logits and probabilities need the head: a headless Keras
            # file is refused here, at load time, as the JAX package does
            headless_ok = mode == "features"
            state = cnn_params_from_flax(
                load_flax_npz(weights_file, spec, module, allow_missing_head=headless_ok),
                module, allow_missing_head=headless_ok,
            )
            missing = set(module.state_dict()) - set(state)
            if missing:  # a headless source: the unused head is zeros
                module = module.to_empty(device="cpu")
                for name in missing:
                    state[name] = torch.zeros_like(module.state_dict()[name])
            module.load_state_dict(state, assign=True)
        else:
            module = module.to_empty(device="cpu")
            init_cnn_params(module, torch.Generator().manual_seed(seed))
        module = module.cast_compute().to(
            device, memory_format=torch.channels_last
        ).eval()

        if mode == "features":
            fn = lambda mod, x: mod(x, features_only=True)  # noqa: E731
        elif mode == "logits":
            fn = lambda mod, x: mod(x)  # noqa: E731
        else:
            fn = lambda mod, x: torch.softmax(mod(x), dim=-1)  # noqa: E731
        return ModelFunction(
            fn,
            module,
            device,
            name=f"{spec.name}[{mode}]",
            input_shape=spec.input_shape,
            input_dtype=dtype,
        )

    return build


def _fixed_size(factory: Callable[..., nn.Module]) -> Callable[..., nn.Module]:
    """A factory whose module takes any input size: drops ``input_size``."""
    return lambda dtype, num_classes, input_size: factory(
        dtype=dtype, num_classes=num_classes
    )


def param_bytes(tree: Any) -> int:
    """Total bytes of a model's parameters: a ModelFunction, an
    ``nn.Module`` (its parameters and buffers, the BatchNorm statistics:
    what the JAX package's variable tree holds), or a (nested) mapping of
    tensors/arrays."""
    if isinstance(tree, ModelFunction):
        tree = tree.module
    if isinstance(tree, nn.Module):
        return sum(p.nbytes for p in tree.parameters()) + sum(
            b.nbytes for b in tree.buffers()
        )
    if hasattr(tree, "items"):
        return sum(param_bytes(v) for v in tree.values())
    return int(getattr(tree, "nbytes", 0))


_REGISTRY: Dict[str, Union[NamedTextModel, NamedImageModel]] = {}


def _register(spec: Union[NamedTextModel, NamedImageModel]) -> None:
    _REGISTRY[spec.name.lower()] = spec


def _image(name, height, width, preprocessing, feature_dim, factory):
    _register(NamedImageModel(
        name, height, width, preprocessing, feature_dim, module_factory=factory,
    ))


# the JAX registry's image entries, at its geometries: name, H, W,
# preprocessing, feature width
_image("ResNet50", 224, 224, "caffe", 2048, _fixed_size(ResNet50))
_image("InceptionV3", 299, 299, "tf", 2048, _fixed_size(InceptionV3))
_image("Xception", 299, 299, "tf", 2048, _fixed_size(Xception))
_image("VGG16", 224, 224, "caffe", 512, VGG16)
_image("VGG19", 224, 224, "caffe", 512, VGG19)
_image("MobileNetV2", 224, 224, "tf", 1280, _fixed_size(MobileNetV2))

for _name, _size, _max_length, _dim, _vocab in (
    ("bert-base", "base", 512, 768, 30522),
    ("bert-tiny", "tiny", 128, 128, 1000),
    ("bert-long-2048", "long", 2048, 128, 8192),
):
    _register(NamedTextModel(
        _name, _max_length, _dim, _bert_text_builder(_size),
        vocab_size=_vocab, size=_size,
    ))


def register_model(spec: Union[NamedTextModel, NamedImageModel]) -> None:
    """Add a user entry to the registry (or replace one of that name, whose
    cached estimates are dropped: the new spec may be another
    architecture)."""
    _ESTIMATE_CACHE.pop(spec.name, None)
    _FLOPS_CACHE.pop(spec.name, None)
    _register(spec)


def get_model(name: str) -> Union[NamedTextModel, NamedImageModel]:
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(
            f"Unknown model {name!r}; supported: {supported_models()}"
        )
    return _REGISTRY[key]


def build_model_function(name: str, mode: Optional[str] = None, dtype: str = "float32",
                         weights_file: Optional[str] = None, seed: int = 0,
                         device=None) -> ModelFunction:
    """``get_model(name).model_function(...)`` from JSON-able arguments:
    the model builder a gang job spec names
    (``"sparkdl_tpu_torch.models.registry:build_model_function"``), so
    every rank builds the same weights (``weights_file``, else ``seed``)
    on its own device."""
    spec = get_model(name)
    kwargs = dict(dtype=getattr(torch, dtype), weights_file=weights_file,
                  seed=seed, device=device)
    if mode is not None:
        kwargs["mode"] = mode
    return spec.model_function(**kwargs)


def get_image_model(name: str) -> NamedImageModel:
    """``get_model`` restricted to image models: a text name fails here
    with a pointer to the text surface."""
    spec = get_model(name)
    if not isinstance(spec, NamedImageModel):
        raise ValueError(
            f"{spec.name!r} is a text model; this API needs an image model "
            f"— embed text with TextEmbedder. Image models: "
            f"{supported_models(kind='image')}"
        )
    return spec


def supported_models(kind: Optional[str] = None, with_memory: bool = False) -> list:
    """Registered model names, sorted; ``kind`` ('text' or 'image')
    filters. ``with_memory=True`` returns one dict per model instead, with
    its kind, geometry, wire dtype, modes and float32 parameter-byte
    estimate: what ``GET /v1/models`` advertises."""
    if kind not in (None, "text", "image"):
        raise ValueError(f"kind must be 'text' or 'image', got {kind!r}")
    cls = {"text": NamedTextModel, "image": NamedImageModel}.get(kind, object)
    specs = sorted(
        (m for m in _REGISTRY.values() if isinstance(m, cls)), key=lambda m: m.name
    )
    if not with_memory:
        return [m.name for m in specs]
    out = []
    for spec in specs:
        est = spec.param_bytes_estimate()
        row = {
            "name": spec.name,
            "feature_dim": spec.feature_dim,
            "input_dtype": spec.input_dtype,
            "param_bytes": est,
            "param_mb": None if est is None else round(est / 2**20, 2),
        }
        if isinstance(spec, NamedTextModel):
            row.update(
                kind="text", max_length=spec.max_length, modes=["embed", "generate"],
                kv_bytes_per_token=spec.kv_bytes_per_token(),
            )
        else:
            row.update(
                kind="image", input_shape=list(spec.input_shape),
                modes=["features", "logits", "probabilities"],
            )
        out.append(row)
    return out
