"""The traced run's device profile, reduced to aggregates in memory.

``torch.profiler`` (CPU and CUDA activity) runs over the whole measured
window.  A ``record_function`` marker around the window ties the
profiler's clock to the host's ``perf_counter``, so each idle gap of the
device can be billed to the host span (``repro_torch.obs.trace``) that was
open on the querying thread at the time.  No trace file is written.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

MARK = "bench/window"


@dataclasses.dataclass
class DeviceProfile:
    window_s: float
    busy_s: float
    #: device seconds and events by operation name (argument lists cut)
    op_s: Dict[str, float]
    op_n: Dict[str, int]
    #: idle seconds of the device by the host span open at the time
    idle_s: Dict[str, float]

    def device_s(self, names) -> Tuple[float, int]:
        """Summed device seconds and events of ops whose name is in
        ``names``."""
        return (sum(s for op, s in self.op_s.items() if op in names),
                sum(c for op, c in self.op_n.items() if op in names))

    def breakdown(self) -> dict:
        top = collections.Counter(self.op_s).most_common(10)
        gaps = collections.Counter(self.idle_s).most_common(10)
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


def op_name(name: str) -> str:
    """The operation's own name, without return type, namespaces, template
    and argument lists: ``void ns::(anonymous namespace)::branch_kernel<3,
    5>(unsigned const*, int)`` -> ``branch_kernel``; ``Memcpy HtoD
    (Pageable -> Device)`` -> ``Memcpy HtoD``."""
    name = name.replace("(anonymous namespace)", "")
    name = name.split("(")[0].split("<")[0].strip()
    if name.startswith("void "):
        name = name[5:]
    return name.rsplit("::", 1)[-1].strip() or name


def union(intervals: np.ndarray) -> np.ndarray:
    """Merge (N, 2) [start, end) intervals into disjoint sorted ones."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    group = np.cumsum(new) - 1
    stops = np.zeros(len(starts))
    np.maximum.at(stops, group, ends)
    return np.stack([starts, stops], axis=1)


def bill_gaps(gaps: np.ndarray, spans: List[dict], main_tid: int
              ) -> Dict[str, float]:
    """Idle seconds by the innermost span open at each gap's midpoint on
    ``main_tid`` (else on any thread); gaps in perf_counter nanoseconds."""
    out: Dict[str, float] = collections.defaultdict(float)
    if len(gaps) == 0:
        return dict(out)
    mids = (gaps[:, 0] + gaps[:, 1]) / 2
    dur = (gaps[:, 1] - gaps[:, 0]) / 1e9
    named = np.full(len(gaps), "(no span)", dtype=object)
    for pick in (lambda ev: ev["tid"] != main_tid,
                 lambda ev: ev["tid"] == main_tid):  # main thread wins
        sel = [ev for ev in spans if pick(ev)]
        if not sel:
            continue
        s0 = np.array([ev["ts"] for ev in sel], dtype=np.float64)
        s1 = s0 + np.array([ev["dur"] for ev in sel], dtype=np.float64)
        names = np.array([ev["name"] for ev in sel], dtype=object)
        for c0 in range(0, len(mids), 512):
            m = mids[c0:c0 + 512, None]
            inside = (s0[None, :] <= m) & (m < s1[None, :])
            latest = np.where(inside, s0[None, :], -np.inf)
            best = latest.argmax(axis=1)
            hit = inside[np.arange(len(best)), best]
            named[c0:c0 + 512][hit] = names[best[hit]]
    for name, d in zip(named, dur):
        out[name] += float(d)
    return dict(out)


class Profiler:
    """``torch.profiler`` over the window (CUDA activity on the card)."""

    def __init__(self, on_card: bool):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        self.on_card = on_card
        self._prof = profile(activities=acts)
        self.mark_ns = 0

    def start(self) -> None:
        self._prof.start()

    def summary(self, spans: List[dict], main_tid: int) -> DeviceProfile:
        import torch
        # the raw events: building the profiler's event tree would take
        # minutes for a window of host ops
        events = self._prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        on_dev = [e.device_type() == cuda for e in events]
        marks = [e for e, d in zip(events, on_dev) if e.name() == MARK and not d]
        if len(marks) != 1:
            raise RuntimeError(f"{len(marks)} window markers in the profile")
        # times in ns from the window's start (epoch ns would lose digits)
        t0 = marks[0].start_ns()
        w0, w1 = 0, marks[0].duration_ns()
        # the marker's own annotation on the device timeline is no work
        dev = [(e.start_ns() - t0, e.start_ns() - t0 + e.duration_ns(),
                e.name())
               for e, d in zip(events, on_dev) if d and e.name() != MARK]
        iv = np.array([(max(a, w0), min(b, w1)) for a, b, _ in dev],
                      dtype=np.float64).reshape(-1, 2)
        iv = iv[iv[:, 1] > iv[:, 0]]
        busy = union(iv)
        op_s: Dict[str, float] = collections.defaultdict(float)
        op_n: Dict[str, int] = collections.defaultdict(int)
        for a, b, name in dev:
            op_s[op_name(name)] += (b - a) / 1e9
            op_n[op_name(name)] += 1
        edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        idle = bill_gaps(gaps + self.mark_ns, spans, main_tid)
        return DeviceProfile(window_s=(w1 - w0) / 1e9,
                             busy_s=float((busy[:, 1] - busy[:, 0]).sum()) / 1e9,
                             op_s=dict(op_s), op_n=dict(op_n), idle_s=idle)


@contextlib.contextmanager
def window(prof: Optional[Profiler]):
    """Mark the body as the profiled window of ``prof`` (started before,
    so that its start-up stays out of the window), if given."""
    if prof is None:
        yield
        return
    import torch
    from torch.profiler import record_function
    try:
        prof.mark_ns = time.perf_counter_ns()
        with record_function(MARK):
            yield
            if prof.on_card:
                torch.cuda.synchronize()
    finally:
        prof._prof.stop()
