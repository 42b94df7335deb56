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
- the control plane beside them (``obs/``): the SLO engine, the memory
  and utilization ledgers, and the router's canary rollout.

``python -m sparkdl_tpu_torch.serving serve`` runs the registry-backed
server on ``cuda`` (``--device cpu`` on request).
"""

from sparkdl_tpu_torch.serving.request import (
    PRIORITY_CLASSES,
    AdmissionQueue,
    AdmissionRejected,
    DeadlineExceeded,
    Draining,
    Request,
)
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
    "ServingServer",
    "canary_config",
    "choose_rung",
    "choose_seq_bucket",
    "start_server",
]
