"""Resilience: the retry policy shared by the port's retrying call sites
(``policy.py``), deterministic env-gated fault injection (``faults.py``,
``SPARKDL_FAULT_PLAN``) and the gang supervisor (``supervisor.py``).

CLI: ``python -m sparkdl_tpu_torch.resilience supervise|plan``.
"""

from sparkdl_tpu_torch.resilience.faults import (
    CRASH_EXIT_CODE,
    FaultPlanError,
    FaultRule,
    maybe_fault,
    parse_plan,
)
from sparkdl_tpu_torch.resilience.policy import (
    FatalError,
    RetryBudgetExceeded,
    RetryPolicy,
    policy_from_env,
)
from sparkdl_tpu_torch.resilience.supervisor import (
    GangFailedError,
    GangSupervisor,
    SupervisorResult,
    worker_launcher,
)

__all__ = [
    "CRASH_EXIT_CODE",
    "FatalError",
    "FaultPlanError",
    "FaultRule",
    "GangFailedError",
    "GangSupervisor",
    "RetryBudgetExceeded",
    "RetryPolicy",
    "SupervisorResult",
    "maybe_fault",
    "parse_plan",
    "policy_from_env",
    "worker_launcher",
]
