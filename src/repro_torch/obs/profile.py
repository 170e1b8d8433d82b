"""Profiling hooks: torch.profiler capture + per-kernel-signature attribution.

Two facilities:

* :func:`profile_span` -- a context manager that opens a tracer span and,
  when given an output directory, additionally captures a
  ``torch.profiler`` trace (CPU and, where there is one, CUDA activity)
  scoped to that span, exported as a Chrome trace file into the directory
  (viewable in Perfetto).  torch is imported lazily so this module stays
  at the bottom of the import graph.
* Kernel attribution -- the dispatchers report the kernel library's build
  time and per-batch harvest waits here, keyed by kernel signature (op,
  l, T, B, backend).  ``kernel_records()`` returns the aggregate table;
  the same numbers flow to the metrics registry as labelled counters.
  ``execute_s`` is the host's blocked seconds at harvest, not device time:
  the device time of each kernel is in the :func:`profile_span` capture.

The port of the reference's ``repro/obs/profile.py``: ``profile_span``
captures with ``torch.profiler`` where the reference starts
``jax.profiler``; the attribution functions are copied unchanged.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, List, Optional

from . import trace
from .metrics import REGISTRY, Registry

__all__ = [
    "profile_span",
    "note_kernel",
    "kernel_records",
    "reset_kernels",
    "aggregate_device_spans",
]

_lock = threading.Lock()
_kernels: Dict[str, Dict[str, float]] = {}
_exports = 0  # profiler captures written by this process


@contextlib.contextmanager
def profile_span(name: str, out_dir: Optional[str] = None, **args: Any):
    """Span that optionally wraps a ``torch.profiler`` capture.

    With ``out_dir=None`` this is exactly ``trace.span``.  With a
    directory, a profiler session (CPU activity, and CUDA activity when a
    CUDA device is available) runs around the span body; the device is
    synchronized before it stops, and the capture is written into
    ``out_dir`` as ``<name>.<pid>.<n>.pt.trace.json`` (Chrome trace
    format).  Failures to import or start the profiler degrade to a plain
    span (the span records ``profiler="unavailable"``).
    """
    prof = None
    if out_dir is not None:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        except Exception:
            prof = None
            args = dict(args, profiler="unavailable")
    try:
        with trace.span(name, **args) as sp:
            yield sp
    finally:
        if prof is not None:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(out_dir, exist_ok=True)
            stem = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in name)
            prof.export_chrome_trace(os.path.join(
                out_dir, f"{stem}.{os.getpid()}.{_next_export()}"
                         f".pt.trace.json"))


def _next_export() -> int:
    """Number the profiler captures this process writes."""
    global _exports
    with _lock:
        _exports += 1
        return _exports


def note_kernel(
    sig: str,
    compile_s: float = 0.0,
    execute_s: float = 0.0,
    calls: int = 0,
    flops: float = 0.0,
    nbytes: float = 0.0,
    registry: Optional[Registry] = None,
) -> None:
    """Accumulate compile/execute time for one kernel signature."""
    with _lock:
        rec = _kernels.setdefault(
            sig,
            {
                "compile_s": 0.0,
                "execute_s": 0.0,
                "calls": 0,
                "flops": 0.0,
                "bytes": 0.0,
            },
        )
        rec["compile_s"] += compile_s
        rec["execute_s"] += execute_s
        rec["calls"] += calls
        rec["flops"] += flops
        rec["bytes"] += nbytes
    reg = registry or REGISTRY
    if compile_s:
        reg.counter(
            "repro_kernel_compile_seconds_total",
            help="first-call compile time per kernel signature",
            sig=sig,
        ).inc(compile_s)
    if execute_s:
        reg.counter(
            "repro_kernel_execute_seconds_total",
            help="device execute/wait time per kernel signature",
            sig=sig,
        ).inc(execute_s)


def kernel_records() -> List[Dict[str, Any]]:
    """Per-signature attribution rows, sorted by execute time (desc)."""
    with _lock:
        rows = [dict(rec, sig=sig) for sig, rec in _kernels.items()]
    rows.sort(key=lambda r: -r["execute_s"])
    return rows


def reset_kernels() -> None:
    """Clear the attribution table (test isolation)."""
    with _lock:
        _kernels.clear()


def aggregate_device_spans(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Fold a Chrome trace doc into per-signature device rows.

    Groups complete events that carry a ``sig`` arg (the dispatcher's
    device spans) and sums duration/flops/bytes, yielding the same row
    shape as :func:`kernel_records` so ``roofline_report.py`` can render a
    roofline from an exported trace file alone.
    """
    by_sig: Dict[str, Dict[str, Any]] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        sig = args.get("sig")
        if not sig:
            continue
        rec = by_sig.setdefault(
            sig,
            {
                "sig": sig,
                "compile_s": 0.0,
                "execute_s": 0.0,
                "calls": 0,
                "flops": 0.0,
                "bytes": 0.0,
            },
        )
        dur_s = ev.get("dur", 0.0) / 1e6
        if ev.get("name") == "kernel/compile":
            rec["compile_s"] += dur_s
        else:
            rec["execute_s"] += dur_s
            rec["calls"] += 1
        rec["flops"] += float(args.get("flops", 0) or 0)
        rec["bytes"] += float(args.get("bytes", 0) or 0)
    rows = list(by_sig.values())
    rows.sort(key=lambda r: -r["execute_s"])
    return rows
