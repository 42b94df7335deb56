"""``ModelFunction``: the unit a transformer applies to each batch.

The PyTorch counterpart of the JAX package's ``ModelFunction`` (a pure
``fn(params, x)`` with its param pytree). Here it is ``fn(module, x)``
with an ``nn.Module`` that already lives on ``device``; calls run under
``torch.inference_mode``. There is no jit: PyTorch runs eagerly.

Functions compose (``and_then``/``before``, as in the JAX package's
``graph/function.py``): the composed function holds the modules of its
parts in one ``nn.ModuleList``, all on one device. A :func:`piece` is a
parameter-free function with an empty module and no device of its own.

Training goes around ``__call__`` (which runs under ``inference_mode``):
:meth:`ModelFunction.named_params` gives float32 master copies of the
module's floating parameters AND buffers (the JAX package trains its
whole variable tree, BatchNorm statistics included),
:meth:`ModelFunction.apply` runs ``fn`` over a given set of them with
autograd on (``torch.func.functional_call``), each cast to the dtype the
module stores it in, and :meth:`ModelFunction.with_params` gives a new
function over a copy of the module that holds them.
:meth:`ModelFunction.from_module` is the counterpart of the JAX package's
``ModelIngest.from_flax``.

:meth:`ModelFunction.export` and :meth:`ModelFunction.load` are the
counterparts of the JAX package's StableHLO artifact, on ``torch.export``
(its program and its params in the port's own files, no pickle):

- ``program.pt2``: ``torch.export.save`` of the program ``fn(module, x)``,
  over a symbolic batch dimension ``b`` unless ``batch_size`` pins it;
  the flash kernel is one ``sparkdl_tpu_torch::flash_attention`` node per
  attention (``ops/flash_attention.py``);
- ``params.npz``: the float32 master values (:meth:`named_params`) and the
  other state by ``state_dict`` name, for re-freezing or fine-tuning;
- ``meta.json``: the function's attributes and the format version.
"""

from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

#: version of the ``export`` artifact's layout (``meta.json``'s ``format``)
EXPORT_FORMAT = 1


@dataclass
class ModelFunction:
    """A model with its parameters and its device.

    Attributes:
        fn: ``fn(module, x) -> y`` over batches already on ``device``.
        module: the ``nn.Module`` holding the parameters.
        device: where the module lives and batches must be sent; None for
            a parameter-free piece, which runs wherever its input is.
        name: diagnostic name.
        vocab_size: token-id bound for text models (tokenizers hash into
            ``[0, vocab_size)``), else None.
        input_shape: per-row input geometry the model was built for
            (``(height, width, channels)`` for image models), else None.
        input_dtype: dtype the model takes its input in (image models: the
            compute dtype, so the converter casts once), else None.
        precision: the serving precision rung the function was built at
            (``graph/precision.py``), or None for a plain build.
        takes_nhwc: ``fn`` takes image rows as NHWC itself (the JAX
            layout), so the device fn hands them over as they are.
        params: float32 master values of the module's floating tensors
            where they hold more than the module stores (a module built in
            bf16: :meth:`from_module`), else None (read from the module).
        single_stream: a batch runs on a whole mesh axis at one fixed
            sequence length (the sequence-parallel BERT), so the text path
            neither buckets it by length nor shares a feeder across
            partitions.
    """

    fn: Callable[[nn.Module, Any], torch.Tensor]
    module: nn.Module
    device: Optional[torch.device]
    name: str = "model_fn"
    vocab_size: Optional[int] = None
    input_shape: Optional[tuple] = None
    input_dtype: Optional[torch.dtype] = None
    precision: Optional[str] = None
    takes_nhwc: bool = False
    params: Optional[Dict[str, torch.Tensor]] = None
    single_stream: bool = False

    def __call__(self, x):
        with torch.inference_mode():
            return self.fn(self.module, x)

    # -- training -----------------------------------------------------------

    def _floating(self) -> Dict[str, torch.Tensor]:
        named = list(self.module.named_parameters()) + list(self.module.named_buffers())
        return {n: t for n, t in named if t.is_floating_point()}

    def named_params(self) -> Dict[str, torch.Tensor]:
        """``{name: float32 tensor}`` over the module's floating parameters
        and buffers, detached copies on the module's device: the master
        values a trainer updates."""
        if self.params is not None:
            return {n: t.detach().clone() for n, t in self.params.items()}
        return {n: t.detach().float().clone() for n, t in self._floating().items()}

    def apply(self, params: Dict[str, torch.Tensor], x) -> torch.Tensor:
        """``fn`` over ``params`` in place of the module's own tensors, with
        autograd on: each is cast to the dtype the module stores it in
        (differentiably, so a bf16 conv weight's gradient comes back in
        float32, as flax promotes an f32 param at use)."""
        stored = self._floating()
        missing = set(stored) - set(params)
        if missing:
            raise KeyError(f"params lack {sorted(missing)[:4]}")
        view = {
            f"inner.{n}": params[n].to(t.dtype) if params[n].dtype != t.dtype else params[n]
            for n, t in stored.items()
        }
        wrapper = self.__dict__.get("_apply_wrapper")
        if wrapper is None:
            wrapper = self.__dict__["_apply_wrapper"] = _Apply(self.fn, self.module)
        return torch.func.functional_call(wrapper, view, (x,))

    def with_params(self, params: Dict[str, torch.Tensor]) -> "ModelFunction":
        """A new ModelFunction over a copy of the module that holds
        ``params`` (cast to its storage dtypes); ``params`` are kept as the
        new function's float32 master values."""
        module = copy.deepcopy(self.module)
        tensors = dict(module.named_parameters())
        tensors.update(module.named_buffers())
        with torch.no_grad():
            for n, v in params.items():
                tensors[n].copy_(v)
        return ModelFunction(
            self.fn, module, self.device, name=self.name,
            vocab_size=self.vocab_size, input_shape=self.input_shape,
            input_dtype=self.input_dtype, precision=self.precision,
            takes_nhwc=self.takes_nhwc,
            params={n: v.detach().clone() for n, v in params.items()},
            single_stream=self.single_stream,
        )

    @staticmethod
    def from_module(
        module: nn.Module,
        input_shape: Optional[tuple] = None,
        device=None,
        name: Optional[str] = None,
    ) -> "ModelFunction":
        """An ``nn.Module`` -> ModelFunction, the counterpart of the JAX
        package's ``ModelIngest.from_flax``. ``fn(module, x)`` is
        ``module(x)``, except for an image model of the registry
        (``models/layers.ImageCNN``) with a ``(height, width, channels)``
        ``input_shape``: its fn takes NHWC rows, as the flax module does,
        and permutes them (a view; on the card the module and its input are
        ``channels_last``), and its conv and dense weights are stored in
        its compute dtype (``cast_compute``) with their float32 values kept
        as the master copy. ``device``: ``cuda`` by default (raises when
        there is none); ``"cpu"`` for the CPU."""
        from sparkdl_tpu_torch.models.layers import ImageCNN
        from sparkdl_tpu_torch.runtime.device import resolve_device

        device = resolve_device(device)
        image = isinstance(module, ImageCNN) and input_shape is not None and len(input_shape) == 3
        fmt = torch.channels_last if image and device.type == "cuda" else torch.preserve_format
        module = module.to(device, memory_format=fmt).eval()
        master = None
        if image:
            master = {
                n: t.detach().float().clone()
                for n, t in list(module.named_parameters()) + list(module.named_buffers())
                if t.is_floating_point()
            }
            module.cast_compute()
            fn = lambda mod, x: mod(x.permute(0, 3, 1, 2))  # noqa: E731
        else:
            fn = lambda mod, x: mod(x)  # noqa: E731
        return ModelFunction(
            fn, module, device, name=name or type(module).__name__,
            input_shape=tuple(input_shape) if input_shape is not None else None,
            takes_nhwc=image, params=master,
        )

    # -- serialization --------------------------------------------------------

    def example_input(self, batch_size: int = 1) -> torch.Tensor:
        """Zeros of one batch as ``fn`` takes it, on the device: ``[B,
        *input_shape]``, except for an image model that takes NCHW (a 3-d
        ``input_shape`` without ``takes_nhwc``): NHWC rows permuted, the
        view ``transformers/execution.model_device_fn`` hands it."""
        if self.input_shape is None:
            raise ValueError(
                f"ModelFunction {self.name!r} has no input_shape recorded; set "
                "input_shape (and input_dtype) to export it"
            )
        device = self.device if self.device is not None else torch.device("cpu")
        x = torch.zeros((batch_size, *self.input_shape), dtype=self.input_dtype or torch.float32,
                        device=device)
        if len(self.input_shape) == 3 and not self.takes_nhwc:
            x = x.permute(0, 3, 1, 2)
        return x

    def export(self, path: str, batch_size: Optional[int] = None) -> None:
        """Write the program and its params under ``path``. The batch
        dimension is symbolic by default, so the loaded program takes any
        batch size; ``batch_size`` pins it. The program is traced under
        ``torch.no_grad`` over the module as it stands (on its device),
        at every precision rung (an ``int8-dynamic`` module's dequantizing
        reads are traced into the program)."""
        from torch.export import Dim

        import sparkdl_tpu_torch.ops.flash_attention  # noqa: F401  (the op)

        os.makedirs(path, exist_ok=True)
        x = self.example_input(2 if batch_size is None else batch_size)
        dynamic = None if batch_size is not None else ({0: Dim.DYNAMIC},)
        with torch.no_grad():
            program = torch.export.export(_Apply(self.fn, self.module), (x,), dynamic_shapes=dynamic)
        torch.export.save(program, os.path.join(path, "program.pt2"))
        least = batch_size or _least_batch(program)
        np.savez(os.path.join(path, "params.npz"), **_host_params(self))
        meta = {
            "format": EXPORT_FORMAT,
            "name": self.name,
            "input_shape": list(self.input_shape),
            "input_dtype": str(self.input_dtype or torch.float32).replace("torch.", ""),
            "precision": self.precision,
            "takes_nhwc": self.takes_nhwc,
            "vocab_size": self.vocab_size,
            "batch_size": batch_size,
            "least_batch": least,
            "device": str(x.device.type),
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)

    @staticmethod
    def load(path: str, device=None) -> "ModelFunction":
        """Load what :meth:`export` wrote. ``fn`` runs the loaded program
        (its parameters baked in) under ``runtime/device.exact_float32``,
        as the port's float32 models run their own forwards (the TF32
        switches are process state, which a traced program does not keep);
        ``raw_params`` holds ``params.npz``'s arrays. ``device``: ``cuda``
        by default (raises when there is none), ``"cpu"`` for the CPU; a
        program exported on another device is moved there, and an image
        program's weights on the card are ``channels_last``, as
        :meth:`from_module` keeps them. A JAX package artifact
        (``program.stablehlo`` and ``params.pkl``) runs on the port's
        StableHLO interpreter: see :func:`_load_stablehlo`."""
        from sparkdl_tpu_torch.runtime.device import exact_float32, resolve_device

        program_file = os.path.join(path, "program.pt2")
        if not os.path.exists(program_file):
            if os.path.exists(os.path.join(path, "program.stablehlo")):
                return _load_stablehlo(path, resolve_device(device))
            raise FileNotFoundError(f"no exported program at {program_file!r}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format") != EXPORT_FORMAT:
            raise ValueError(f"{path!r}: export format {meta.get('format')!r}, this reader reads {EXPORT_FORMAT}")
        import sparkdl_tpu_torch.ops.flash_attention  # noqa: F401  (registers the op)

        device = resolve_device(device)
        program = torch.export.load(program_file)
        if torch.device(meta["device"]).type != device.type or device.type == "cuda":
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, device)
        module = program.module()
        if device.type == "cuda" and len(meta["input_shape"]) == 3:
            module = module.to(memory_format=torch.channels_last)
        with np.load(os.path.join(path, "params.npz")) as npz:
            raw = {n: npz[n] for n in npz.files}
        least = meta["least_batch"] if meta["batch_size"] is None else 1

        def fn(mod, x):
            n = x.shape[0]
            if n < least:  # below the traced range: padded with copies of row 0
                x = torch.cat([x, x[:1].expand(least - n, *x.shape[1:])])
            with exact_float32():
                y = mod(x)
            if n < least:
                y = tuple(t[:n] for t in y) if isinstance(y, tuple) else y[:n]
            return y

        mf = ModelFunction(
            fn, module, device, name=meta["name"],
            vocab_size=meta["vocab_size"], input_shape=tuple(meta["input_shape"]),
            input_dtype=getattr(torch, meta["input_dtype"]), precision=meta["precision"],
            takes_nhwc=meta["takes_nhwc"],
        )
        mf.raw_params = raw
        return mf

    def and_then(self, g: Union["ModelFunction", Callable]) -> "ModelFunction":
        """self, then g: the output of self feeds g."""
        g_mf = g if isinstance(g, ModelFunction) else piece(
            g, name=getattr(g, "__name__", "fn")
        )
        if None not in (self.device, g_mf.device) and torch.device(
            self.device
        ) != torch.device(g_mf.device):
            raise ValueError(
                f"cannot compose {self.name!r} on {self.device} with "
                f"{g_mf.name!r} on {g_mf.device}: parts must share a device"
            )
        f_fn, g_fn = self.fn, g_mf.fn

        def composed(mods, x):
            return g_fn(mods[1], f_fn(mods[0], x))

        return ModelFunction(
            fn=composed,
            module=nn.ModuleList([self.module, g_mf.module]),
            device=self.device if self.device is not None else g_mf.device,
            name=f"{self.name}>>{g_mf.name}",
            # a parameter-free piece in front keeps the model's token bound
            vocab_size=self.vocab_size if self.vocab_size is not None else g_mf.vocab_size,
            input_shape=self.input_shape,
            input_dtype=self.input_dtype,
            precision=self.precision or g_mf.precision,
            takes_nhwc=self.takes_nhwc,
            single_stream=self.single_stream or g_mf.single_stream,
        )

    def before(self, pre: Union["ModelFunction", Callable]) -> "ModelFunction":
        """pre, then self."""
        pre_mf = pre if isinstance(pre, ModelFunction) else piece(
            pre, name=getattr(pre, "__name__", "fn")
        )
        return pre_mf.and_then(self)


class _Apply(nn.Module):
    """``fn(module, x)`` as a module's forward, so ``functional_call`` can
    swap the inner module's tensors."""

    def __init__(self, fn, inner: nn.Module):
        super().__init__()
        self.fn = fn
        self.inner = inner

    def forward(self, x):
        return self.fn(self.inner, x)


class StableHLOModule(nn.Module):
    """A JAX export's program (``graph/stablehlo.Program``) as a module:
    its baked-in constants on the device are its buffers."""

    def __init__(self, program):
        super().__init__()
        self.program = program
        for i, t in enumerate(program.constants):
            self.register_buffer(f"c{i}", t, persistent=False)

    def forward(self, *args):
        return self.program(*args)


def _load_stablehlo(path: str, device: torch.device) -> ModelFunction:
    """Load the JAX package's ``ModelFunction.export`` artifact without JAX:
    ``program.stablehlo`` through ``graph/jax_exported.read_exported`` and
    the StableHLO interpreter on ``device``, ``params.pkl`` through the
    numpy-only unpickler (``raw_params``, ``input_shape``,
    ``input_dtype`` and ``name``, as the JAX ``load`` fills them). An image
    program takes NHWC rows, as the JAX function does; an input is cast to
    the program's dtype."""
    from sparkdl_tpu_torch.graph.jax_exported import read_exported, read_params
    from sparkdl_tpu_torch.graph.mlir_bytecode import read_module
    from sparkdl_tpu_torch.graph.stablehlo import Program

    with open(os.path.join(path, "program.stablehlo"), "rb") as f:
        exported = read_exported(f.read())
    meta = read_params(os.path.join(path, "params.pkl"))
    program = Program(read_module(exported.mlir_module_serialized), device)
    kept = exported.module_kept_var_idx
    if len(program.signature.inputs) != len(kept):
        raise NotImplementedError(
            f"{path!r}: main takes {len(program.signature.inputs)} arguments where the export keeps "
            f"{len(kept)} (a platform index or token argument; ROADMAP Queue A item 13)")
    avals = exported.in_avals
    dtypes = [getattr(torch, a.dtype) for a in avals]
    single = len(exported.out_avals) == 1

    def fn(mod, x):
        xs = list(x) if isinstance(x, (tuple, list)) else [x]
        if len(xs) != len(avals):
            raise ValueError(f"{path!r} takes {len(avals)} inputs, got {len(xs)}")
        xs = [t if t.dtype == dt else t.to(dt) for t, dt in zip(xs, dtypes)]
        ys = mod(*[xs[i] for i in kept])
        return ys[0] if single else tuple(ys)

    input_shape = tuple(meta["input_shape"]) if meta.get("input_shape") else None
    mf = ModelFunction(
        fn, StableHLOModule(program), device, name=meta.get("name", "loaded"),
        input_shape=input_shape,
        input_dtype=getattr(torch, meta["input_dtype"]) if meta.get("input_dtype") else None,
        takes_nhwc=input_shape is not None and len(input_shape) == 3,
    )
    mf.raw_params = meta["params"]
    return mf


def _least_batch(program) -> int:
    """The least batch size the exported program takes: the lower bound
    export proved for the symbolic batch dimension (2 where tracing
    specialized sizes 0 and 1 away, as a ``channels_last`` convolution's
    layout checks do on the card)."""
    name = program.graph_signature.user_inputs[0]
    node = next(n for n in program.graph.nodes if n.name == name)
    b = node.meta["val"].shape[0]
    if isinstance(b, int):
        return b
    return int(program.range_constraints[b.node.expr].lower)


def _host_params(mf: ModelFunction) -> Dict[str, np.ndarray]:
    """``params.npz``'s arrays by ``state_dict`` name: the float32 master
    values (:meth:`ModelFunction.named_params`, every floating tensor, so
    no bfloat16 reaches numpy), then the rest of the module's state
    (integer buffers, an int8 rung's values)."""
    state = dict(mf.module.state_dict())
    state.update(mf.named_params())
    return {n: t.detach().cpu().numpy() for n, t in state.items()}


def piece(fn: Callable[[Any], Any], name: str = "piece") -> ModelFunction:
    """Wrap a parameter-free tensor function as a ModelFunction."""
    return ModelFunction(lambda _module, x: fn(x), nn.Module(), None, name=name)
