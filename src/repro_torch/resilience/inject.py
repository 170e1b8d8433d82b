"""Deterministic, seeded fault injection with named sites.

The chaos-engineering seam of the stack: every stage that can fail in
production -- artifact loads, extraction, packing, device staging, kernel
launches, harvests, decodes, sink writes -- calls :func:`fire` with its
site name.  With no plan configured that call is a single module-global
flag check (the same no-op discipline as ``obs.trace``, budget-tested in
``tests/test_resilience.py``).  With a plan, each site raises, delays, or
corrupts on a schedule that is a pure function of ``(seed, site, call#)``,
so a fault pattern reproduces exactly across runs with the same call
sequence.

Plan grammar (env ``REPRO_TORCH_FAULT_PLAN`` or CLI ``--fault-plan``)::

    seed=7;*=0.1;kernel.launch=0.25;device.stage=0.1:delay:0.002

Semicolon-separated clauses.  ``seed=<int>`` seeds the schedule; every
other clause is ``<site>=<rate>[:<kind>[:<param>]]`` where ``site`` is one
of :data:`SITES` (or ``*`` as a default for all of them), ``rate`` is the
per-call firing probability in [0, 1], and ``kind`` is one of:

* ``raise`` (default) -- raise :class:`FaultInjected` at the site,
* ``delay`` -- sleep ``param`` seconds (default 0.001) and continue,
* ``corrupt`` -- flip bytes in the artifact being read; only artifact
  sites consult this via :func:`corrupt_bytes` (``plan.load``,
  ``tune.read``), elsewhere the clause is inert.

Injected-fault counts are tracked per site (:func:`fired`) and published
to the ``obs.metrics`` registry as ``repro_faults_injected_total{site=}``.

The port's copy of the reference's ``repro/resilience/inject.py``: the
same sites, plan grammar and schedule, so one plan fires at the same
calls in both packages.  One difference: the port arms a plan from an
environment variable of its own, ``REPRO_TORCH_FAULT_PLAN``, so an
environment set up for the reference's chaos runs leaves the port
unarmed.  The sites ``plan.load`` and ``tune.read`` have no caller in
the port yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from typing import Dict, Optional, Tuple, Union

#: Named fault sites, in stack order (plan load through sink write).
SITES = (
    "plan.load",
    "extract",
    "pack",
    "device.stage",
    "kernel.launch",
    "device.harvest",
    "decode",
    "sink.write",
    "tune.read",
)

#: Environment variable read at import time (the CLI ``--fault-plan``
#: flag sets it so worker threads and subprocesses agree).
ENV_FAULT_PLAN = "REPRO_TORCH_FAULT_PLAN"

_KINDS = ("raise", "delay", "corrupt")


class FaultInjected(RuntimeError):
    """An injected fault (never raised by real failures).

    Carries the ``site`` and the 0-based ``call`` index at which the
    schedule fired, so logs identify the exact scheduled event.
    """

    def __init__(self, site: str, call: int):
        super().__init__(f"injected fault at site {site!r} (call #{call})")
        self.site = site
        self.call = call


@dataclasses.dataclass(frozen=True)
class SiteRule:
    """Per-site firing rule: probability, fault kind, kind parameter."""

    rate: float
    kind: str = "raise"
    param: float = 0.0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A parsed fault plan: per-site rules plus the schedule seed."""

    rules: Dict[str, SiteRule]
    seed: int = 0

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse the ``seed=7;*=0.1;site=rate[:kind[:param]]`` grammar."""
        seed = 0
        rules: Dict[str, SiteRule] = {}
        default: Optional[SiteRule] = None
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            key, eq, val = clause.partition("=")
            if not eq:
                raise ValueError(f"bad fault-plan clause {clause!r} "
                                 f"(expected key=value)")
            key = key.strip()
            if key == "seed":
                seed = int(val)
                continue
            parts = val.split(":")
            rate = float(parts[0])
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"fault rate out of [0, 1]: {clause!r}")
            kind = parts[1].strip() if len(parts) > 1 and parts[1].strip() \
                else "raise"
            if kind not in _KINDS:
                raise ValueError(f"unknown fault kind {kind!r} "
                                 f"(one of {_KINDS})")
            param = float(parts[2]) if len(parts) > 2 else 0.0
            rule = SiteRule(rate, kind, param)
            if key == "*":
                default = rule
            elif key in SITES:
                rules[key] = rule
            else:
                raise ValueError(f"unknown fault site {key!r} "
                                 f"(sites: {', '.join(SITES)})")
        if default is not None:
            for site in SITES:
                rules.setdefault(site, default)
        return cls(rules, seed)


# module state: _ENABLED is the single-flag fast path checked by fire()
_ENABLED = False
_PLAN: Optional[FaultPlan] = None
_LOCK = threading.Lock()
_CALLS: Dict[str, int] = {}
_FIRED: Dict[str, int] = {}


def enabled() -> bool:
    """True when a fault plan is active."""
    return _ENABLED


def configure(plan: Union[None, str, FaultPlan]) -> Optional[FaultPlan]:
    """Install (or with ``None`` clear) the process-wide fault plan.

    Accepts a spec string (parsed with :meth:`FaultPlan.parse`) or a
    prebuilt plan; resets the per-site call/fired counters.  Returns the
    active plan.
    """
    global _ENABLED, _PLAN
    if plan is None:
        _ENABLED = False
        _PLAN = None
        reset_counts()
        return None
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    _PLAN = plan
    reset_counts()
    _ENABLED = True
    return plan


def reset_counts() -> None:
    """Zero the per-site call and fired counters (new schedule epoch)."""
    with _LOCK:
        _CALLS.clear()
        _FIRED.clear()


def calls(site: Optional[str] = None):
    """Per-site call counts (all sites as a dict when ``site`` is None)."""
    with _LOCK:
        if site is not None:
            return _CALLS.get(site, 0)
        return dict(_CALLS)


def fired(site: Optional[str] = None):
    """Per-site injected-fault counts (dict of all sites when None)."""
    with _LOCK:
        if site is not None:
            return _FIRED.get(site, 0)
        return dict(_FIRED)


def _u01(seed: int, site: str, call: int) -> float:
    """Deterministic uniform in [0, 1) from (seed, site, call#)."""
    h = hashlib.blake2b(f"{seed}:{site}:{call}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0**64


def _draw(site: str, kind: str) -> Optional[Tuple[SiteRule, int]]:
    """Advance the site's schedule one call; return (rule, call#) when it
    fires for a rule of the given kind class ('fire' or 'corrupt')."""
    plan = _PLAN
    if plan is None:
        return None
    rule = plan.rules.get(site)
    if rule is None or rule.rate <= 0.0:
        return None
    wants_corrupt = rule.kind == "corrupt"
    if wants_corrupt != (kind == "corrupt"):
        return None
    with _LOCK:
        n = _CALLS.get(site, 0)
        _CALLS[site] = n + 1
    if _u01(plan.seed, site, n) >= rule.rate:
        return None
    with _LOCK:
        _FIRED[site] = _FIRED.get(site, 0) + 1
    _publish(site)
    return rule, n


def _publish(site: str) -> None:
    """Count one injected fault in the obs.metrics registry."""
    try:
        from ..obs import metrics as obs_metrics

        obs_metrics.get_registry().counter(
            "repro_faults_injected_total",
            help="faults injected by repro.resilience.inject",
            site=site,
        ).inc()
    except Exception:  # metrics must never break injection
        pass


def fire(site: str) -> None:
    """Fault-injection hook: no-op unless a plan schedules this call.

    The disabled path is a single global-flag check (overhead budget
    shared with ``obs.trace``).  ``raise`` rules raise
    :class:`FaultInjected`; ``delay`` rules sleep; ``corrupt`` rules are
    inert here (they act through :func:`corrupt_bytes`).
    """
    if not _ENABLED:
        return
    hit = _draw(site, "fire")
    if hit is None:
        return
    rule, n = hit
    if rule.kind == "delay":
        time.sleep(rule.param if rule.param > 0 else 0.001)
        return
    raise FaultInjected(site, n)


def corrupt_bytes(site: str, data: bytes) -> bytes:
    """Apply a scheduled ``corrupt`` rule to an artifact's raw bytes.

    Flips a deterministic byte (and truncates when ``param`` rounds to 1)
    so downstream integrity checks must catch it; a no-op unless the
    site's rule has ``kind=corrupt`` and the schedule fires this call.
    """
    if not _ENABLED:
        return data
    hit = _draw(site, "corrupt")
    if hit is None or not data:
        return data
    rule, n = hit
    if int(rule.param) == 1:  # param 1 = truncate instead of bit-flip
        return data[: len(data) // 2]
    pos = int(_u01(_PLAN.seed, site + "#pos", n) * len(data))
    mutated = bytearray(data)
    mutated[pos] ^= 0xFF
    return bytes(mutated)


# honor the environment at import time so every entry point (CLI, tests,
# worker threads) sees one consistent plan
_spec = os.environ.get(ENV_FAULT_PLAN)
if _spec:
    configure(_spec)
del _spec
