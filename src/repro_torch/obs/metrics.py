"""Process-wide metrics registry: counters, gauges, pow2-bucket histograms.

This unifies the ad-hoc ``Stats`` / ``ServeStats`` accounting behind one
API.  The dataclasses remain the per-run/per-request *snapshot views*;
this module is the cumulative, scrapeable view.  Two publication styles
are supported:

* **Direct instruments** -- hot-path code grabs a counter once and bumps
  it (``REGISTRY.counter("repro_batches_total").inc()``).
* **Snapshot publication** -- ``observe_stats(stats)`` folds a finished
  stats dataclass into the registry, classifying each field via the
  dataclass's ``_METRIC_KINDS`` table (the same table that drives
  ``Stats.merge``), so new fields cannot silently diverge between the
  merge path and the metrics path.

Naming convention (see DESIGN.md section 11): ``repro_<area>_<what>``,
snake_case, with Prometheus unit/``_total`` suffixes.  Exposition lives in
:mod:`repro_torch.obs.export`.  Standard library only; no repro imports.

The port's copy of the reference's ``repro/obs/metrics.py``, unchanged.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "REGISTRY",
    "get_registry",
    "pow2_edges",
    "observe_stats",
    "publish_totals",
]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing counter (rendered as TYPE counter)."""

    kind = "counter"

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (must be >= 0) to the counter."""
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        with self._lock:
            self._value += n

    def set_total(self, v: float) -> None:
        """Publish an externally-maintained monotonic total (scrape-time)."""
        with self._lock:
            self._value = max(self._value, float(v))

    @property
    def value(self) -> float:
        """Current accumulated total."""
        with self._lock:
            return self._value


class Gauge:
    """Last-written value (rendered as TYPE gauge)."""

    kind = "gauge"

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        """Set the gauge to ``v``."""
        with self._lock:
            self._value = float(v)

    def set_max(self, v: float) -> None:
        """Raise the gauge to ``v`` if larger (peak-style gauges)."""
        with self._lock:
            self._value = max(self._value, float(v))

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` to the gauge."""
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        """Current gauge value."""
        with self._lock:
            return self._value


def pow2_edges(lo_exp: int, hi_exp: int) -> List[float]:
    """Power-of-two bucket upper bounds: ``2**lo_exp .. 2**hi_exp``."""
    if hi_exp < lo_exp:
        raise ValueError("hi_exp must be >= lo_exp")
    return [float(2.0**e) for e in range(lo_exp, hi_exp + 1)]


# Default histogram edges: ~1 microsecond to 64 seconds, pow2 steps.
_DEFAULT_EDGES = pow2_edges(-20, 6)


class Histogram:
    """Cumulative histogram over power-of-two buckets."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        labels: LabelKey = (),
        edges: Optional[Iterable[float]] = None,
    ):
        self.name = name
        self.labels = labels
        self.edges = sorted(set(float(e) for e in (edges or _DEFAULT_EDGES)))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.edges) + 1)  # last = +Inf
        self._sum = 0.0
        self._n = 0

    def observe(self, v: float) -> None:
        """Record one observation."""
        v = float(v)
        with self._lock:
            self._sum += v
            self._n += 1
            for i, edge in enumerate(self.edges):
                if v <= edge:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(per-bucket counts, sum, count) under the lock."""
        with self._lock:
            return list(self._counts), self._sum, self._n

    @property
    def value(self) -> float:
        """Observation count (for quick assertions in tests)."""
        with self._lock:
            return float(self._n)


class Registry:
    """Thread-safe get-or-create store of metric instruments."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelKey], Any] = {}
        self._help: Dict[str, str] = {}
        self._collectors: List[Callable[[], None]] = []

    def _get(self, cls, name: str, help: str, labels: Dict[str, str], **kw):
        key = (name, _label_key(labels or {}))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1], **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name} already registered as {m.kind}"
                )
            if help:
                self._help.setdefault(name, help)
            return m

    def counter(self, name: str, help: str = "", **labels: str) -> Counter:
        """Get or create a counter for ``name`` + ``labels``."""
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels: str) -> Gauge:
        """Get or create a gauge for ``name`` + ``labels``."""
        return self._get(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        edges: Optional[Iterable[float]] = None,
        **labels: str,
    ) -> Histogram:
        """Get or create a pow2-bucket histogram for ``name`` + ``labels``."""
        return self._get(Histogram, name, help, labels, edges=edges)

    def add_collector(self, fn: Callable[[], None]) -> None:
        """Register a scrape-time callback that refreshes instruments."""
        with self._lock:
            self._collectors.append(fn)

    def remove_collector(self, fn: Callable[[], None]) -> None:
        """Remove a previously registered scrape-time callback."""
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def collect(self) -> List[Any]:
        """Run collectors, then return instruments grouped by family name."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn()
        with self._lock:
            return sorted(
                self._metrics.values(), key=lambda m: (m.name, m.labels)
            )

    def help_text(self, name: str) -> str:
        """HELP string registered for a metric family (may be empty)."""
        with self._lock:
            return self._help.get(name, "")

    def reset(self) -> None:
        """Drop all instruments and collectors (test isolation)."""
        with self._lock:
            self._metrics.clear()
            self._help.clear()
            self._collectors.clear()


REGISTRY = Registry()


def get_registry() -> Registry:
    """The process-wide default registry."""
    return REGISTRY


def observe_stats(
    stats: Any,
    prefix: str = "repro_engine",
    registry: Optional[Registry] = None,
) -> None:
    """Fold a finished stats dataclass into the registry.

    Field handling follows the dataclass's ``_METRIC_KINDS`` table
    (``sum`` -> counter add, ``max`` -> peak gauge, ``flag`` -> hit
    counter, ``dict`` -> per-key labelled counter, ``list`` -> histogram
    observations, ``info`` -> skipped).  Unclassified numeric fields are
    treated as ``sum`` so new accounting shows up by default.
    """
    reg = registry or REGISTRY
    kinds = getattr(type(stats), "_METRIC_KINDS", {})
    for f in dataclasses.fields(stats):
        val = getattr(stats, f.name)
        kind = kinds.get(f.name)
        if kind is None:
            kind = "sum" if isinstance(val, (int, float)) else "info"
        name = f"{prefix}_{f.name}"
        if kind == "sum":
            if isinstance(val, bool):
                val = int(val)
            if val:
                reg.counter(name + "_total").inc(val)
            else:
                reg.counter(name + "_total")
        elif kind == "max":
            reg.gauge(name, help="peak value").set_max(val)
        elif kind == "flag":
            reg.counter(name + "s_total").inc(1 if val else 0)
        elif kind == "dict":
            for k, v in (val or {}).items():
                reg.counter(name + "_total", key=str(k)).inc(v)
        elif kind == "list":
            h = reg.histogram(name)
            for v in val or ():
                h.observe(v)
        # "info" fields (e.g. backend strings) are identity, not metrics.


def publish_totals(
    stats: Any,
    prefix: str,
    registry: Optional[Registry] = None,
) -> None:
    """Publish a *cumulative* stats object as current totals (scrape-time).

    Unlike :func:`observe_stats` (which adds a finished per-run snapshot
    into the registry once), this sets counters to the stats object's
    absolute values -- the right shape for long-lived accumulators like a
    service's ``ServeStats``/engine ``Stats`` that already hold lifetime
    totals.  Counters only move forward (``set_total`` keeps the max), so
    concurrent in-place resets never violate counter monotonicity.
    """
    reg = registry or REGISTRY
    kinds = getattr(type(stats), "_METRIC_KINDS", {})
    for f in dataclasses.fields(stats):
        val = getattr(stats, f.name)
        kind = kinds.get(f.name)
        if kind is None:
            kind = "sum" if isinstance(val, (int, float)) else "info"
        name = f"{prefix}_{f.name}"
        if kind == "sum":
            reg.counter(name + "_total").set_total(
                int(val) if isinstance(val, bool) else val
            )
        elif kind in ("max", "mean"):
            reg.gauge(name).set_max(val)
        elif kind == "flag":
            reg.gauge(name).set(1 if val else 0)
        elif kind == "dict":
            for k, v in (val or {}).items():
                reg.counter(name + "_total", key=str(k)).set_total(v)
        elif kind == "list":
            reg.gauge(name + "_count").set(len(val or ()))
        # "info" fields are identity, not metrics.
