"""Model functions: a model and the device it runs on, as one callable.

The names below are exported lazily (importing this package imports none
of its modules): ``ModelFunction`` and its upstream name ``GraphFunction``
(the serializable graph-function unit of ``sparkdl.graph.builder``),
``ModelIngest`` and its upstream name ``TFInputGraph``,
``read_orbax_checkpoint`` (an orbax checkpoint's tree, without orbax),
``ImageInputSpec``/``imageInputPlaceholder``, ``piece`` and
``IsolatedSession``, whose constructor raises with the migration mapping.
"""

_EXPORTS = {
    "ModelFunction": "sparkdl_tpu_torch.graph.function",
    "GraphFunction": "sparkdl_tpu_torch.graph.function",
    "piece": "sparkdl_tpu_torch.graph.function",
    "ModelIngest": "sparkdl_tpu_torch.graph.ingest",
    "TFInputGraph": "sparkdl_tpu_torch.graph.ingest",
    "read_orbax_checkpoint": "sparkdl_tpu_torch.graph.orbax_ckpt",
    "ImageInputSpec": "sparkdl_tpu_torch.graph.pieces",
    "imageInputPlaceholder": "sparkdl_tpu_torch.graph.pieces",
}

__all__ = sorted(_EXPORTS) + ["IsolatedSession"]


class IsolatedSession:
    """Upstream compat shim (``sparkdl.graph.builder.IsolatedSession``).

    The reference used an isolated TF graph and session to BUILD graph
    functions; the port has no sessions: models are functions from the
    start. The constructor raises with the migration mapping, so ported
    code fails with instructions, not an AttributeError."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "IsolatedSession has no counterpart in the port: there are no "
            "TF sessions here. Build ModelFunctions directly — "
            "ModelIngest.from_graph_def/from_saved_model/from_tf_checkpoint/"
            "from_keras for serialized models, sparkdl_tpu_torch.graph.piece "
            "for inline functions, ModelFunction.and_then to compose "
            "(the asGraphFunction/importGraphFunction workflow)."
        )


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module 'sparkdl_tpu_torch.graph' has no attribute {name!r}")
    from importlib import import_module

    module = import_module(_EXPORTS[name])
    return getattr(module, "ModelFunction" if name == "GraphFunction" else name)
