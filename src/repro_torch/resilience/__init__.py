"""Fault injection, retry/fallback, and graceful degradation.

The port of the reference's ``repro/resilience`` (DESIGN.md section 12).
Three pieces:

* :mod:`repro_torch.resilience.inject` -- deterministic, seeded fault
  injection with named sites threaded through the stack (off by default,
  no-op fast path like ``obs.trace``).
* :mod:`repro_torch.resilience.retry` -- retry/backoff policies and the
  backend demotion ladder used by ``runtime.dispatch``.  Only injected
  faults are retried or demoted, a real failure raises, and on a CUDA
  lane an injected fault is retried on the kernel and then raises: only
  CPU lanes demote (two rungs of the plain version, then the host).
* Typed failure exceptions re-exported here for callers.
"""

from .inject import ENV_FAULT_PLAN, SITES, FaultInjected, FaultPlan
from .inject import configure as configure_faults
from .inject import enabled as faults_enabled
from .retry import DEFAULT_POLICY, RetryPolicy, backoff_delay, demote

__all__ = [
    "ENV_FAULT_PLAN",
    "SITES",
    "FaultInjected",
    "FaultPlan",
    "configure_faults",
    "faults_enabled",
    "DEFAULT_POLICY",
    "RetryPolicy",
    "backoff_delay",
    "demote",
]
