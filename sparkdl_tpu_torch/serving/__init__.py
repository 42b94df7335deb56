"""Online serving on the port: the request path over the shared feeder.

- :mod:`~sparkdl_tpu_torch.serving.request`: :class:`Request` with an SLA
  class and a deadline, admitted through a bounded
  strict-priority-with-aging queue;
- :mod:`~sparkdl_tpu_torch.serving.router`: groups admitted requests by
  (model, geometry, precision rung) and dispatches them through feeder
  streams (``runtime/feeder.py``) with adaptive batch sizing;
- :mod:`~sparkdl_tpu_torch.serving.residency`: load on first request,
  budget by parameter bytes and KV-cache reservations, LRU-evict idle
  models;
- :mod:`~sparkdl_tpu_torch.serving.generation`: ``mode="generate"``,
  token-level continuous batching over one K/V slab per model;
- :mod:`~sparkdl_tpu_torch.serving.server`: the stdlib HTTP front end and
  the in-process :class:`ServingClient`;
- :mod:`~sparkdl_tpu_torch.serving.gateway`: the supervised serving
  gang, one routing door over N worker processes under the
  ``GangSupervisor``, with re-dispatch across a worker's death;
- the control plane beside them (``obs/``): the SLO engine, the memory
  and utilization ledgers, the router's canary rollout and the gateway's
  fleet plane.

``python -m sparkdl_tpu_torch.serving serve`` runs the registry-backed
server on ``cuda`` (``--device cpu`` on request); ``... gateway`` the
supervised gang, ``... worker`` one of its members.
"""

from sparkdl_tpu_torch.serving.request import (
    PRIORITY_CLASSES,
    AdmissionQueue,
    AdmissionRejected,
    DeadlineExceeded,
    Draining,
    Request,
)
from sparkdl_tpu_torch.serving.gateway import ServingGateway
from sparkdl_tpu_torch.serving.generation import GenerationEngine
from sparkdl_tpu_torch.serving.residency import ResidencyManager, ResidentModel
from sparkdl_tpu_torch.serving.router import Router, canary_config, choose_rung, choose_seq_bucket
from sparkdl_tpu_torch.serving.server import ServingClient, ServingServer, start_server

__all__ = [
    "AdmissionQueue",
    "AdmissionRejected",
    "DeadlineExceeded",
    "Draining",
    "GenerationEngine",
    "PRIORITY_CLASSES",
    "Request",
    "ResidencyManager",
    "ResidentModel",
    "Router",
    "ServingClient",
    "ServingGateway",
    "ServingServer",
    "canary_config",
    "choose_rung",
    "choose_seq_bucket",
    "start_server",
]
