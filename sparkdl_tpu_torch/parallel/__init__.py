"""Parallelism over a ``torch.distributed`` process group: the mesh and its
named axes, the process group, the data-parallel train steps, and tensor
(``tp``), pipeline (``pp``) and expert (``ep``) parallelism, each
differentiable through ``collectives.py``. Sequence parallelism runs
through ``ops/ring_attention.py`` and ``ops/ulysses.py`` over an ``sp``
axis."""

from sparkdl_tpu_torch.parallel import distributed
from sparkdl_tpu_torch.parallel.data_parallel import (
    TrainState,
    create_train_state,
    make_data_parallel_step,
    make_eval_step,
    make_zero1_data_parallel_step,
)
from sparkdl_tpu_torch.parallel.expert_parallel import moe_apply, switch_route
from sparkdl_tpu_torch.parallel.mesh import Mesh, make_mesh, pad_batch_to_multiple
from sparkdl_tpu_torch.parallel.pipeline_parallel import pipeline_apply, stack_stage_params
from sparkdl_tpu_torch.parallel.tensor_parallel import shard_dense_params, tp_block_sharded, tp_mlp

__all__ = [
    "Mesh",
    "TrainState",
    "create_train_state",
    "distributed",
    "make_data_parallel_step",
    "make_eval_step",
    "make_mesh",
    "make_zero1_data_parallel_step",
    "moe_apply",
    "pad_batch_to_multiple",
    "pipeline_apply",
    "shard_dense_params",
    "stack_stage_params",
    "switch_route",
    "tp_block_sharded",
    "tp_mlp",
]
