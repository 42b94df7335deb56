"""Retry policy shared by the port's retrying call sites."""

from sparkdl_tpu_torch.resilience.policy import (
    FatalError,
    RetryBudgetExceeded,
    RetryPolicy,
    policy_from_env,
)

__all__ = ["FatalError", "RetryBudgetExceeded", "RetryPolicy", "policy_from_env"]
