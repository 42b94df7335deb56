"""ModelIngest: model sources -> :class:`~sparkdl_tpu_torch.graph.function.ModelFunction`.

The counterpart of the JAX package's ``graph/ingest.py``: a Python
callable, a Keras model and a Keras model file, TF's three serialization
formats (``TFInputGraph``: a frozen GraphDef, a SavedModel, a TF1
checkpoint with its ``.meta`` graph), an exported program
(``from_exported``: what :meth:`ModelFunction.export` wrote, on
``torch.export``; a JAX package StableHLO artifact is refused) and an
orbax checkpoint (``from_orbax_checkpoint``, read without orbax by
``graph/orbax_ckpt.py``). The JAX package runs a Keras model through keras on its jax
backend; the port reads the model's config and weights and translates the
model into torch (``graph/keras_graph.py``), so it never imports keras.
A Keras model here is anything with ``get_config()``,
``get_layer(name).get_weights()``, ``name`` and ``input_shape``: a Keras
model object, or a :class:`~sparkdl_tpu_torch.graph.keras_graph.KerasModelSpec`
(a config and weights held as data, as ``from_keras_file`` reads them).

The TF formats are read without TensorFlow or protobuf: the port decodes
the protobuf wire format (``graph/tf_proto.py``) and the tensor-bundle
checkpoint (``graph/tf_bundle.py``) itself, then translates the graph once
into torch ops (``graph/tf_import.py``).

Every constructor puts the model on ``device``: ``cuda`` by default
(raising when there is none), ``"cpu"`` for the CPU.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sparkdl_tpu_torch.graph import tf_proto
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.runtime.device import resolve_device


def _coerce_graph_def(graph_def) -> tf_proto.Message:
    """A decoded GraphDef from serialized bytes, a ``.pb`` file path, a
    decoded message, or any object with ``SerializeToString()`` (a TF
    proto, which the port reads through its bytes, never through TF)."""
    if isinstance(graph_def, tf_proto.Message):
        return graph_def
    if isinstance(graph_def, (str, os.PathLike)):
        with open(graph_def, "rb") as f:
            return tf_proto.parse("GraphDef", f.read())
    if isinstance(graph_def, (bytes, bytearray, memoryview)):
        return tf_proto.parse("GraphDef", graph_def)
    if hasattr(graph_def, "SerializeToString"):
        return tf_proto.parse("GraphDef", graph_def.SerializeToString())
    raise TypeError(f"expected a GraphDef (bytes, a path or a proto), got {type(graph_def).__name__}")


def _placeholder_rank(graph_def: tf_proto.Message, name: str) -> Optional[int]:
    for node in graph_def.node:
        if node.name == name and node.op in ("Placeholder", "PlaceholderWithDefault"):
            shape = tf_proto.shape_of(node.attr["shape"].shape) if "shape" in node.attr else None
            return None if shape is None else len(shape)
    return None


class ModelIngest:
    """Namespace of ingestion constructors (all static)."""

    @staticmethod
    def from_callable(
        fn: Callable,
        module: Optional[nn.Module] = None,
        input_shape: Optional[Tuple[int, ...]] = None,
        input_dtype: Optional[torch.dtype] = None,
        name: str = "callable",
        device=None,
    ) -> ModelFunction:
        """``fn(module, x)`` over ``module`` (moved to ``device``), or
        ``fn(x)`` when there is no module (the JAX package's ``fn(params,
        x)`` or ``fn(x)``)."""
        device = resolve_device(device)
        if module is None:
            module, wrapped = nn.Module(), (lambda _module, x: fn(x))
        else:
            module, wrapped = module.to(device).eval(), fn
        return ModelFunction(
            wrapped, module, device, name=name,
            input_shape=tuple(input_shape) if input_shape is not None else None,
            input_dtype=input_dtype,
        )

    @staticmethod
    def from_keras(model, input_shape=None, input_dtype=None, device=None) -> ModelFunction:
        """A Keras model -> ModelFunction over its torch translation, at
        inference (BatchNorm uses its moving statistics, Dropout is the
        identity), as the JAX package's ``stateless_call(...,
        training=False)``. ``input_shape`` defaults to the model's own
        (``(H, W, C)`` for an image model, whose fn then takes NCHW
        batches, as the registry's image models do)."""
        from sparkdl_tpu_torch.graph.keras_graph import KerasModule

        config = model.get_config()
        if input_shape is None:
            shape = getattr(model, "input_shape", None)
            input_shape = tuple(shape[1:]) if shape else None
        device = resolve_device(device)
        image = input_shape is not None and len(input_shape) == 3
        fmt = torch.channels_last if image and device.type == "cuda" else torch.preserve_format
        module = KerasModule(config, model).to(device, memory_format=fmt).eval()
        return ModelFunction(
            lambda mod, x: mod(x), module, device,
            name=getattr(model, "name", None) or "keras_model",
            input_shape=tuple(input_shape) if input_shape is not None else None,
            input_dtype=input_dtype,
        )

    @staticmethod
    def from_keras_file(path: str, device=None, **kwargs) -> ModelFunction:
        """A ``.keras`` or ``.h5`` model file -> ModelFunction
        (``graph/keras_file.py`` reads it; its weights need h5py)."""
        from sparkdl_tpu_torch.graph.keras_file import read_keras_file

        return ModelIngest.from_keras(read_keras_file(path), device=device, **kwargs)

    # -- tensorflow serialization formats -------------------------------------
    # The reference's primary currency (TFInputGraph.fromGraphDef /
    # fromSavedModel / fromCheckpoint). The graph is translated once into
    # torch ops (graph/tf_import.py); no TF runs, at ingestion or after.

    @staticmethod
    def from_graph_def(
        graph_def,
        inputs: Sequence[str],
        outputs: Sequence[str],
        variables: Optional[Dict[str, np.ndarray]] = None,
        input_shape: Optional[Tuple[int, ...]] = None,
        input_dtype: Any = None,
        name: str = "graph_def",
        device=None,
    ) -> ModelFunction:
        """Frozen TF GraphDef -> ModelFunction (TFInputGraph.fromGraphDef).

        ``graph_def``: serialized bytes, a path to a ``.pb`` file, a
        decoded ``tf_proto`` message, or a TF proto object (read through
        its ``SerializeToString()``). ``inputs``/``outputs``: tensor names
        (``"x"`` or ``"x:0"``); the order of ``inputs`` is the positional
        order of the fn's inputs, the order of ``outputs`` that of its
        results. ``variables``: values of the graph's variable nodes by
        name. The fn takes the graph's input as the graph declares it: an
        image graph takes NHWC rows itself (``takes_nhwc``), which the
        image transformers hand it as such. ``device``: ``cuda`` by
        default (raising when there is none), ``"cpu"`` for the CPU."""
        from sparkdl_tpu_torch.graph.tf_import import torch_dtype_of, translate_graph_def

        graph_def = _coerce_graph_def(graph_def)
        module, fn = translate_graph_def(graph_def, inputs, outputs, variables)
        device = resolve_device(device)
        rank = _placeholder_rank(graph_def, inputs[0].split(":")[0]) if len(inputs) == 1 else None
        image = len(inputs) == 1 and (rank == 4 or (input_shape is not None and len(input_shape) == 3))
        return ModelFunction(
            fn, module.to(device).eval(), device, name=name,
            input_shape=tuple(input_shape) if input_shape is not None else None,
            input_dtype=torch_dtype_of(input_dtype), takes_nhwc=image,
        )

    @staticmethod
    def from_saved_model(
        path: str,
        signature: str = "serving_default",
        tag_set: Optional[str] = None,
        inputs: Optional[Sequence[str]] = None,
        outputs: Optional[Sequence[str]] = None,
        input_shape: Optional[Tuple[int, ...]] = None,
        input_dtype: Any = None,
        device=None,
    ) -> ModelFunction:
        """TF SavedModel -> ModelFunction (TFInputGraph.fromSavedModel
        [WithSignature]), without TF.

        Reads ``saved_model.pb``, takes the signature's feeds and fetches
        from its ``SignatureDef``, and resolves each variable the
        signature's call captures: the call node's captured inputs are the
        concrete function's ``bound_inputs`` (object-graph node ids) in
        order, and each node's ``VARIABLE_VALUE`` attribute in the
        checkpoint's object graph names its key in ``variables/``.
        ``inputs``/``outputs`` may be signature KEYS or raw tensor names;
        omitted means every input and every output, in sorted-key order
        (how TF flattens a signature's dict). ``tag_set``: a comma-joined
        set of tags picking the MetaGraphDef (``"serve"`` by default, or
        the only one)."""
        from sparkdl_tpu_torch.graph import tf_bundle

        with open(os.path.join(path, "saved_model.pb"), "rb") as f:
            saved = tf_proto.parse("SavedModel", f.read())
        meta = _pick_meta_graph(saved, path, tag_set)
        if signature not in meta.signature_def:
            raise KeyError(f"SavedModel at {path!r} has no signature {signature!r}; "
                           f"available: {sorted(meta.signature_def)}")
        sig = meta.signature_def[signature]
        in_by_key = {key: info.name for key, info in sig.inputs.items()}
        out_by_key = {key: info.name for key, info in sig.outputs.items()}

        def _resolve(names, table):
            if names is None:
                return [table[key] for key in sorted(table)]
            return [table[n] if n in table else (n if ":" in n else f"{n}:0") for n in names]

        feed_names = _resolve(inputs, in_by_key)
        fetch_names = _resolve(outputs, out_by_key)
        graph_def = meta.graph_def
        variables = _saved_model_variables(graph_def, meta.object_graph_def, fetch_names,
                                           tf_bundle.BundleReader(os.path.join(path, "variables", "variables")))
        if input_shape is None and len(feed_names) == 1:
            info = next((i for i in sig.inputs.values() if i.name == feed_names[0]), None)
            dims = tf_proto.shape_of(info.tensor_shape) if info is not None else None
            if dims and len(dims) >= 2 and all(d >= 0 for d in dims[1:]):
                input_shape = tuple(dims[1:])
        return ModelIngest.from_graph_def(
            graph_def, feed_names, fetch_names, variables=variables, input_shape=input_shape,
            input_dtype=input_dtype, name=f"saved_model:{signature}", device=device,
        )

    @staticmethod
    def from_tf_checkpoint(
        prefix: str,
        inputs: Sequence[str],
        outputs: Sequence[str],
        meta_graph: Optional[str] = None,
        input_shape: Optional[Tuple[int, ...]] = None,
        input_dtype: Any = None,
        device=None,
    ) -> ModelFunction:
        """TF checkpoint (+ ``.meta`` MetaGraphDef) -> ModelFunction
        (TFInputGraph.fromCheckpoint[WithSignature]).

        Variable values come from the checkpoint's bundle files
        (``graph/tf_bundle.py``), the graph from ``<prefix>.meta`` (or
        ``meta_graph``); variable nodes are resolved by name."""
        from sparkdl_tpu_torch.graph import tf_bundle

        reader = tf_bundle.BundleReader(prefix)
        variables = {key: reader.get_tensor(key) for key in reader.keys()
                     if key != tf_bundle.OBJECT_GRAPH_KEY}
        with open(meta_graph or prefix + ".meta", "rb") as f:
            meta = tf_proto.parse("MetaGraphDef", f.read())
        return ModelIngest.from_graph_def(
            meta.graph_def, inputs, outputs, variables=variables, input_shape=input_shape,
            input_dtype=input_dtype, name="tf_checkpoint", device=device,
        )


    # -- serialized artifacts -------------------------------------------------

    @staticmethod
    def from_exported(path: str, device=None) -> ModelFunction:
        """Load a program directory written by :meth:`ModelFunction.export`
        (the frozen-GraphDef analogue), or by the JAX package's
        ``ModelFunction.export`` (``program.stablehlo``):
        :meth:`ModelFunction.load`."""
        return ModelFunction.load(path, device=device)

    @staticmethod
    def from_orbax_checkpoint(
        path: str,
        module: nn.Module,
        input_shape: Optional[Tuple[int, ...]] = None,
        convert: Optional[Callable[[Any, nn.Module], Dict[str, torch.Tensor]]] = None,
        device=None,
        name: str = "orbax_restored",
    ) -> ModelFunction:
        """Restore a flax variable tree from an orbax checkpoint (read by
        ``graph/orbax_ckpt.py``, without orbax) and bind it to ``module``
        (the TF-checkpoint ingestion analogue; the JAX package binds it to
        an ``apply_fn``). ``convert(tree, module)`` gives ``module``'s
        ``state_dict``; by default a ``BertEncoder`` takes the tree through
        ``models/convert.bert_params_from_flax`` and an image model of the
        registry (``ImageCNN``) through ``cnn_params_from_flax``. Returns
        :meth:`ModelFunction.from_module` over it."""
        from sparkdl_tpu_torch.graph.orbax_ckpt import read_orbax_checkpoint
        from sparkdl_tpu_torch.models.bert import BertEncoder
        from sparkdl_tpu_torch.models.convert import bert_params_from_flax, cnn_params_from_flax
        from sparkdl_tpu_torch.models.layers import ImageCNN

        tree = _widened(read_orbax_checkpoint(path))
        if convert is not None:
            state = convert(tree, module)
        elif isinstance(module, BertEncoder):
            state = bert_params_from_flax(tree, module.config)
        elif isinstance(module, ImageCNN):
            state = cnn_params_from_flax(tree, module)
        else:
            raise TypeError(
                f"no default mapping of a flax tree onto a {type(module).__name__}; pass "
                "convert(tree, module) -> state_dict"
            )
        module.load_state_dict(state)
        return ModelFunction.from_module(module, input_shape=input_shape, device=device, name=name)


def _widened(tree):
    """A restored tree with its bfloat16 leaves (torch tensors) widened to
    float32 numpy, exactly, for the converters' ``np.asarray``."""
    if isinstance(tree, dict):
        return {k: _widened(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_widened(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def _pick_meta_graph(saved: tf_proto.Message, path: str, tag_set: Optional[str]) -> tf_proto.Message:
    graphs = list(saved.meta_graphs)
    if not graphs:
        raise ValueError(f"SavedModel at {path!r} holds no MetaGraphDef")
    want = set(tag_set.split(",")) if tag_set else {"serve"}
    for meta in graphs:
        if set(meta.meta_info_def.tags) == want:
            return meta
    if tag_set is None and len(graphs) == 1:
        return graphs[0]
    raise KeyError(f"SavedModel at {path!r} has no MetaGraphDef tagged {sorted(want)}; "
                   f"available: {[sorted(m.meta_info_def.tags) for m in graphs]}")


def _saved_model_variables(graph_def, object_graph, fetch_names, reader) -> Dict[str, np.ndarray]:
    """Values of the variable handles that the fetched call nodes capture,
    by handle node name: a call's inputs past the function's own arguments
    are its captures, which line up with the concrete function's
    ``bound_inputs``; the checkpoint's object graph maps each bound node
    to its ``VARIABLE_VALUE`` key."""
    nodes = {n.name: n for n in graph_def.node}
    keys = {}
    for i, obj in enumerate(reader.object_graph().nodes):
        for attr in obj.attributes:
            if attr.name == "VARIABLE_VALUE":
                keys[i] = attr.checkpoint_key
    functions = {f.signature.name: f for f in graph_def.library.function}
    variables: Dict[str, np.ndarray] = {}
    for ref in fetch_names:
        call = nodes.get(ref.split(":")[0])
        if call is None or call.op not in ("StatefulPartitionedCall", "PartitionedCall"):
            continue
        fname = call.attr["f"].func.name
        bound = list(object_graph.concrete_functions[fname].bound_inputs) if fname in object_graph.concrete_functions else []
        data_inputs = [r for r in call.input if not r.startswith("^")]
        n_args = len(functions[fname].signature.input_arg) - len(bound) if fname in functions else 0
        for handle_ref, node_id in zip(data_inputs[n_args:], bound):
            handle = handle_ref.split(":")[0]
            if handle not in nodes or nodes[handle].op != "VarHandleOp":
                continue  # a captured constant: the graph holds its value
            if node_id not in keys:
                raise KeyError(f"captured variable {handle!r} (object {node_id}) has no VARIABLE_VALUE "
                               "in the SavedModel's checkpoint")
            variables[handle] = reader.get_tensor(keys[node_id])
    return variables


# Reference-compatible alias: sparkdl.TFInputGraph
TFInputGraph = ModelIngest
