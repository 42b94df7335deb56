"""Data parallelism over a ``torch.distributed`` process group: the mesh,
the process group, and the train steps. Tensor, pipeline and expert
parallelism are not ported."""

from sparkdl_tpu_torch.parallel import distributed
from sparkdl_tpu_torch.parallel.data_parallel import (
    TrainState,
    create_train_state,
    make_data_parallel_step,
    make_eval_step,
    make_zero1_data_parallel_step,
)
from sparkdl_tpu_torch.parallel.mesh import Mesh, make_mesh, pad_batch_to_multiple

__all__ = [
    "Mesh",
    "TrainState",
    "create_train_state",
    "distributed",
    "make_data_parallel_step",
    "make_eval_step",
    "make_mesh",
    "make_zero1_data_parallel_step",
    "pad_batch_to_multiple",
]
