"""Retry/backoff policies and the backend demotion ladder.

Used by ``runtime.dispatch``: a failed tile batch is retried with capped
exponential backoff + deterministic jitter, then, on a CPU lane, demoted
down the backend ladder: ``"cuda"`` (the kernel wrapper, which on a CPU
tensor runs the plain version), ``"torch"`` (the plain version), then the
host recursion.  Because EBBkC
tiles are independently recomputable (Eq. 2 exact-once attribution),
every rung of the ladder reproduces the lost batch exactly -- retries
re-enter the same FIFO position, so results stay byte-identical to a
fault-free run (see DESIGN.md section 12).

The port of the reference's ``repro/resilience/retry.py``, with the
port's ladders.  Two deliberate differences.  The reference's dispatchers
retry and demote on any ``Exception``; the port's retry and demote only
on :class:`~repro_torch.resilience.inject.FaultInjected` (``call``'s
default ``retry_on``).  A real failure -- an nvcc build error, a refused
CUDA launch, a sticky device fault -- still raises out of the query.  And
on a CUDA lane an injected fault is only retried, and raises once the
policy is used up: the card's work never moves to a plain version or to
the host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple, Type

from . import inject


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with deterministic jitter.

    ``max_attempts`` bounds total tries (first call included); delays
    grow as ``base_delay_s * 2**(attempt-1)`` capped at ``max_delay_s``,
    scaled down by up to ``jitter`` using the same seeded hash stream as
    the fault injector, so chaos runs reproduce their timing decisions.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.0005
    max_delay_s: float = 0.02
    jitter: float = 0.5
    seed: int = 0


#: Policy for device-batch launches: a couple of quick retries, then the
#: caller demotes down the backend ladder (a CPU lane) or raises (a CUDA
#: lane).
DEFAULT_POLICY = RetryPolicy()

#: Policy for pure host stages (pack, decode, sink writes): the work has
#: no side effects until it succeeds, so the only cost of another attempt
#: is a tiny sleep -- retry hard enough that injected-fault schedules at
#: chaos rates (<= 0.5) never spuriously exhaust it (0.5**24 ~ 6e-8),
#: while a rate-1.0 site still surfaces after bounded work.
CONSUME_POLICY = RetryPolicy(max_attempts=24, base_delay_s=1e-4,
                             max_delay_s=2e-3)


def backoff_delay(policy: RetryPolicy, attempt: int, token: str = "") -> float:
    """Delay in seconds before retry ``attempt`` (1-based), jittered.

    The jitter draw is a pure function of (policy.seed, token, attempt),
    so two runs with the same failure pattern sleep identically.
    """
    base = min(policy.max_delay_s,
               policy.base_delay_s * (2.0 ** max(0, attempt - 1)))
    u = inject._u01(policy.seed, f"backoff:{token}", attempt)
    return base * (1.0 - policy.jitter * u)


def call(
    fn: Callable,
    *,
    policy: RetryPolicy = DEFAULT_POLICY,
    retry_on: Tuple[Type[BaseException], ...] = (inject.FaultInjected,),
    token: str = "",
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """Invoke ``fn()`` under the policy; re-raise once attempts exhaust.

    ``on_retry(attempt, exc)`` is called before each re-attempt (the
    dispatchers hook per-batch attempt accounting here).  Exceptions not
    in ``retry_on`` propagate immediately.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as exc:
            attempt += 1
            if attempt >= policy.max_attempts:
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            delay = backoff_delay(policy, attempt, token)
            if delay > 0:
                time.sleep(delay)


def consume(
    site: str,
    policy: RetryPolicy = CONSUME_POLICY,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> None:
    """Fire an injection site, absorbing injected faults by retrying.

    The hook for pure host stages (pack, decode, sink write): the stage
    body runs only after the site stops firing, so an injected fault
    costs a bounded number of scheduled draws and a few microseconds of
    backoff -- never a lost result.  A rate-1.0 site still exhausts the
    policy and raises (pathological plans stay observable).
    """
    if not inject.enabled():
        return
    call(lambda: inject.fire(site), policy=policy, token=site,
         on_retry=on_retry)


#: Backend ladders of a CPU lane, best rung first: the kernel wrapper (the
#: plain version on a CPU tensor), then the plain torch version.  Both end
#: at the host recursion (rung ``None``): ``count_rec_C`` partials for
#: counting, the kernel-order ``listing.host_list_triple`` for listing.
COUNT_LADDER = ("cuda", "torch")
LIST_LADDER = ("cuda", "torch")


def demote(mode: str, backend: Optional[str]) -> Optional[str]:
    """Next rung below ``backend`` for ``mode`` ('count' or 'list').

    Returns ``None`` when the ladder is exhausted -- the caller then
    falls back to the host recursion (exact partials for counting, the
    kernel-order host triple for listing).
    """
    ladder = COUNT_LADDER if mode == "count" else LIST_LADDER
    try:
        i = ladder.index(backend)
    except ValueError:
        return None
    return ladder[i + 1] if i + 1 < len(ladder) else None
