"""Unified observability layer: tracing, metrics, logging, profiling.

``repro_torch.obs`` sits at the bottom of the port's import graph (stdlib
only; torch is imported lazily inside :mod:`repro_torch.obs.profile`), so
the pipeline, the engines, the dispatchers and the launcher instrument
themselves without new dependencies or cycles.

Quickstart::

    from repro_torch.obs import trace, metrics

    trace.configure(enabled=True)
    with trace.span("pack", T=64):
        ...
    trace.export("trace.json")          # open in https://ui.perfetto.dev

    metrics.REGISTRY.counter("repro_batches_total").inc()

The port of the reference's ``repro/obs`` (DESIGN.md section 11 has the
span taxonomy, metric naming convention and overhead budget).
"""

from . import export, logging, metrics, profile, trace
from .logging import get_logger, setup_logging
from .metrics import REGISTRY, get_registry

__all__ = [
    "trace",
    "metrics",
    "export",
    "profile",
    "logging",
    "setup_logging",
    "get_logger",
    "REGISTRY",
    "get_registry",
]
