"""Low-overhead structured span tracer with Chrome/Perfetto export.

The tracer records *spans* -- named intervals with attributes -- into a
bounded in-process ring buffer.  Spans nest per-thread (a well-formed tree
per thread, tracked via a thread-local stack), carry a monotonic
``perf_counter_ns`` clock, and export as Chrome ``trace_event`` JSON that
Perfetto (https://ui.perfetto.dev) loads directly.

Design constraints (see DESIGN.md section 11):

* **Disabled is (almost) free.**  ``span(...)`` with tracing off returns a
  shared no-op context manager without allocating; the only cost is one
  global flag check plus the caller's keyword packing.  The overhead budget
  (<= 1% on the bench-smoke workload) is asserted by
  ``tests/test_obs.py``.
* **Thread-safe.**  Finished events append to a lock-protected
  ``collections.deque(maxlen=...)``; per-thread nesting state lives in a
  ``threading.local`` so concurrent producers never contend on the stack.
* **Cross-thread request trees.**  A request's lifecycle hops threads
  (client -> scheduler -> decode worker), so it cannot be a sync span.
  ``async_begin`` / ``async_instant`` / ``async_end`` emit Chrome async
  events (``ph`` = ``b``/``n``/``e``) keyed by an explicit id (the serving
  tier uses the ticket id), which Perfetto renders as one track per id.

Only the standard library is used; this module must not import jax or any
``repro`` sibling (it sits below everything else in the import DAG).

The port's copy of the reference's ``repro/obs/trace.py``, unchanged.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "span",
    "instant",
    "complete",
    "async_begin",
    "async_instant",
    "async_end",
    "enabled",
    "configure",
    "reset",
    "events",
    "dropped",
    "span_records",
    "chrome_trace",
    "export",
    "validate_chrome_trace",
    "stage_durations",
]

# Category assigned to synchronous spans in the chrome export.
_CAT_SYNC = "repro"
# Category assigned to async (per-request) events.  Chrome async events are
# matched on (cat, id), so this must be stable.
_CAT_ASYNC = "request"

_DEFAULT_CAPACITY = 262_144


class _NoopSpan:
    """Shared do-nothing context manager returned when tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False

    def set(self, **args: Any) -> None:
        """Ignore attribute updates (tracing disabled)."""


_NOOP = _NoopSpan()


class _Span:
    """An open span; records itself into the tracer on ``__exit__``."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_parent", "_tid")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args

    def set(self, **args: Any) -> None:
        """Attach or update span attributes while the span is open."""
        self.args.update(args)

    def __enter__(self) -> "_Span":
        tls = self._tracer._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        self._parent = stack[-1].name if stack else None
        self._tid = threading.get_ident()
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: object) -> bool:
        t1 = time.perf_counter_ns()
        tr = self._tracer
        stack = tr._tls.stack
        # Tolerate exits out of order (shouldn't happen with `with`): pop
        # back to this span rather than corrupting the stack.
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        tr._record(
            {
                "ph": "X",
                "name": self.name,
                "ts": self._t0,
                "dur": t1 - self._t0,
                "tid": self._tid,
                "parent": self._parent,
                "args": self.args,
            }
        )
        return False


class Tracer:
    """Ring-buffered span recorder.  One process-wide instance is the norm."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._tls = threading.local()
        self._dropped = 0

    # -- recording ---------------------------------------------------------

    def _record(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(ev)

    def span(self, name: str, **args: Any) -> _Span:
        """Open a nested span; use as ``with tracer.span("pack", T=64):``."""
        return _Span(self, name, args)

    def instant(self, name: str, **args: Any) -> None:
        """Record a zero-duration point event on the current thread."""
        self._record(
            {
                "ph": "i",
                "name": name,
                "ts": time.perf_counter_ns(),
                "tid": threading.get_ident(),
                "parent": self._current_name(),
                "args": args,
            }
        )

    def complete(self, name: str, t0_ns: int, dur_ns: int, **args: Any) -> None:
        """Record a span retroactively from explicit start/duration.

        Used where the interval is only known after the fact (e.g. how long
        a listing payload sat parked in the reorder buffer).
        """
        self._record(
            {
                "ph": "X",
                "name": name,
                "ts": int(t0_ns),
                "dur": max(0, int(dur_ns)),
                "tid": threading.get_ident(),
                "parent": None,
                "args": args,
            }
        )

    def _current_name(self) -> Optional[str]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1].name if stack else None

    # -- async (cross-thread) events --------------------------------------

    def async_begin(self, name: str, id: Any, **args: Any) -> None:
        """Open an async track keyed by ``id`` (e.g. a serve ticket id)."""
        self._async(name, "b", id, args)

    def async_instant(self, name: str, id: Any, **args: Any) -> None:
        """Record a point event on the async track keyed by ``id``."""
        self._async(name, "n", id, args)

    def async_end(self, name: str, id: Any, **args: Any) -> None:
        """Close the async track keyed by ``id``."""
        self._async(name, "e", id, args)

    def _async(self, name: str, ph: str, id: Any, args: Dict[str, Any]) -> None:
        self._record(
            {
                "ph": ph,
                "name": name,
                "ts": time.perf_counter_ns(),
                "tid": threading.get_ident(),
                "id": str(id),
                "args": args,
            }
        )

    # -- inspection / export -----------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot the raw ring buffer (oldest first)."""
        with self._lock:
            return list(self._events)

    def span_records(self) -> List[Tuple[str, Optional[str]]]:
        """(name, parent_name) pairs for finished sync spans, oldest first.

        This is the structural view the determinism tests compare: it is
        independent of wall-clock timing but captures the nesting tree.
        """
        return [
            (ev["name"], ev.get("parent"))
            for ev in self.events()
            if ev["ph"] == "X"
        ]

    @property
    def dropped(self) -> int:
        """Number of events evicted from the ring buffer since reset."""
        with self._lock:
            return self._dropped

    def reset(self) -> None:
        """Drop all recorded events (keeps the enabled flag as-is)."""
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def chrome_trace(self) -> Dict[str, Any]:
        """Render the buffer as a Chrome ``trace_event`` JSON object."""
        pid = os.getpid()
        out: List[Dict[str, Any]] = []
        tids: Dict[int, int] = {}
        tid_names: Dict[int, str] = {}
        for th in threading.enumerate():
            tid_names[th.ident] = th.name
        for ev in self.events():
            tid = tids.setdefault(ev["tid"], len(tids) + 1)
            rec: Dict[str, Any] = {
                "name": ev["name"],
                "ph": ev["ph"],
                "ts": ev["ts"] / 1000.0,  # ns -> us
                "pid": pid,
                "tid": tid,
                "args": {k: _jsonable(v) for k, v in ev["args"].items()},
            }
            if ev["ph"] == "X":
                rec["cat"] = _CAT_SYNC
                rec["dur"] = ev["dur"] / 1000.0
            elif ev["ph"] in ("b", "n", "e"):
                rec["cat"] = _CAT_ASYNC
                rec["id"] = ev["id"]
            else:  # instant
                rec["cat"] = _CAT_SYNC
                rec["s"] = "t"
            out.append(rec)
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": small,
                "args": {"name": tid_names.get(raw, f"thread-{small}")},
            }
            for raw, small in sorted(tids.items(), key=lambda kv: kv[1])
        ]
        return {"traceEvents": meta + out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        """Write the Chrome trace JSON to ``path``."""
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)


def _jsonable(v: Any) -> Any:
    """Coerce span attribute values to JSON-safe scalars."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    try:
        return int(v)
    except (TypeError, ValueError):
        pass
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


# -- module-level API (the form the hot path uses) ---------------------------

_ENABLED = False
_TRACER = Tracer()


def enabled() -> bool:
    """Whether span recording is currently on."""
    return _ENABLED


def configure(enabled: bool = True, capacity: Optional[int] = None) -> Tracer:
    """Turn tracing on/off; optionally resize (and clear) the ring buffer."""
    global _ENABLED, _TRACER
    if capacity is not None and capacity != _TRACER._events.maxlen:
        _TRACER = Tracer(capacity=capacity)
    _ENABLED = bool(enabled)
    return _TRACER


def reset() -> None:
    """Clear recorded events on the process tracer."""
    _TRACER.reset()


def span(name: str, **args: Any):
    """Open a span on the process tracer; no-op when tracing is disabled."""
    if not _ENABLED:
        return _NOOP
    return _TRACER.span(name, **args)


def instant(name: str, **args: Any) -> None:
    """Record a point event; no-op when tracing is disabled."""
    if _ENABLED:
        _TRACER.instant(name, **args)


def complete(name: str, t0_ns: int, dur_ns: int, **args: Any) -> None:
    """Record a retroactive span; no-op when tracing is disabled."""
    if _ENABLED:
        _TRACER.complete(name, t0_ns, dur_ns, **args)


def async_begin(name: str, id: Any, **args: Any) -> None:
    """Open an async per-id track; no-op when tracing is disabled."""
    if _ENABLED:
        _TRACER.async_begin(name, id, **args)


def async_instant(name: str, id: Any, **args: Any) -> None:
    """Point event on an async per-id track; no-op when disabled."""
    if _ENABLED:
        _TRACER.async_instant(name, id, **args)


def async_end(name: str, id: Any, **args: Any) -> None:
    """Close an async per-id track; no-op when tracing is disabled."""
    if _ENABLED:
        _TRACER.async_end(name, id, **args)


def events() -> List[Dict[str, Any]]:
    """Snapshot raw events from the process tracer."""
    return _TRACER.events()


def dropped() -> int:
    """Events lost to the ring-buffer capacity bound so far."""
    return _TRACER.dropped


def span_records() -> List[Tuple[str, Optional[str]]]:
    """Structural (name, parent) pairs for finished sync spans."""
    return _TRACER.span_records()


def chrome_trace() -> Dict[str, Any]:
    """Chrome ``trace_event`` JSON object for the process tracer."""
    return _TRACER.chrome_trace()


def export(path: str) -> None:
    """Write the process tracer's Chrome trace JSON to ``path``."""
    _TRACER.export(path)


def validate_chrome_trace(doc: Dict[str, Any]) -> List[str]:
    """Shape-check a trace document; returns a list of problems (empty = ok).

    Checks the subset of the ``trace_event`` spec Perfetto requires to load
    the file: a ``traceEvents`` list, per-event ``name``/``ph``/``ts``/
    ``pid``/``tid``, ``dur`` on complete events, and matched ``b``/``e``
    pairs per async id.
    """
    problems: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    open_async: Dict[Tuple[str, str], int] = {}
    for i, ev in enumerate(evs):
        ph = ev.get("ph")
        if ph == "M":
            continue
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i} missing {key}")
        if ph == "X" and "dur" not in ev:
            problems.append(f"complete event {i} missing dur")
        if ph in ("b", "n", "e"):
            if "id" not in ev or "cat" not in ev:
                problems.append(f"async event {i} missing id/cat")
                continue
            k = (ev["cat"], ev["id"])
            if ph == "b":
                open_async[k] = open_async.get(k, 0) + 1
            elif ph == "e":
                open_async[k] = open_async.get(k, 0) - 1
                if open_async[k] < 0:
                    problems.append(f"async end without begin for id {k}")
    for k, n in open_async.items():
        if n > 0:
            problems.append(f"async begin without end for id {k}")
    return problems


def stage_durations(
    doc: Dict[str, Any], prefixes: Iterable[str] = ()
) -> Dict[str, float]:
    """Sum complete-event durations (seconds) by name, from a trace doc.

    With ``prefixes``, names are bucketed under the first matching prefix
    (e.g. ``device/stage`` and ``device/harvest`` both land in ``device``).
    """
    out: Dict[str, float] = {}
    pref = tuple(prefixes)
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        name = ev["name"]
        for p in pref:
            if name == p or name.startswith(p + "/"):
                name = p
                break
        out[name] = out.get(name, 0.0) + ev.get("dur", 0.0) / 1e6
    return out
