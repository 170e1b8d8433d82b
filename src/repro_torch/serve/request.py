"""Request, ticket, and admission-queue primitives of the serving tier.

The port's copy of ``repro/serve/request.py``, unchanged apart from its
imports.  DESIGN.md section 10.  A :class:`Request` is one admitted ``(graph, k,
mode)`` query plus its delivery state: a per-request sequence space (one
sequence number per pulled tile chunk) and a reorder buffer that releases
decoded rows to the request's sink strictly in pull order.  That sequencer
is what lets the :class:`~repro_torch.serve.scheduler.BatchScheduler` fuse
chunks from *different* requests into shared device batches -- and even
complete them out of order across size bins -- while every individual
request still observes exactly the row order of a serial
``stream_cliques`` run (the per-request determinism invariant).

Thread model: sequence numbers are assigned by the scheduler thread at
pull time; deliveries arrive from the scheduler thread (host-spilled
tiles, counts harvested inline) and from the dispatcher decode worker
(listing triples).  A per-request lock serializes them; the waiting
client thread only ever blocks on the resolution event.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np

from ..core import listing
from ..core.engine_np import Stats
from ..obs import trace
from ..resilience import retry as fault_retry

#: process-wide ticket-id source; the id keys the request's async span
#: tree in exported traces and is stable for the request's lifetime
_RID = itertools.count(1)

#: early-termination threshold baked into the serving tier (the engines'
#: default); per-request et knobs would forbid cross-request batch fusion
ET_T = 3


class ServiceOverloaded(RuntimeError):
    """Admission rejected: the request queue is full (backpressure)."""


class ServiceClosed(RuntimeError):
    """Submitted to (or queued on) a service that has been closed."""


class DeadlineExceeded(RuntimeError):
    """A deadline-*enforced* request was cancelled at its deadline.

    Raised out of :meth:`Ticket.result` for requests submitted with
    ``enforce_deadline=True`` whose deadline expired before completion.
    Carries whatever had already been delivered in pull order:
    ``partial_rows`` (listing mode with the default in-memory sink; None
    otherwise), ``emitted`` (rows the sink accepted), and
    ``partial_count`` (count mode's running sum).  Requests *without*
    enforcement keep the accounting-only contract (late but exact,
    ``deadline_missed=True``).
    """

    def __init__(self, msg: str, *, partial_rows=None, emitted: int = 0,
                 partial_count: Optional[int] = None) -> None:
        super().__init__(msg)
        self.partial_rows = partial_rows
        self.emitted = emitted
        self.partial_count = partial_count


def apply_vertex_filter(rows: np.ndarray, vertex: int) -> np.ndarray:
    """Keep only clique rows containing ``vertex``.

    The single definition of vertex-filter semantics, shared by the
    service delivery path, the load generator's oracle, and the tests --
    so "byte-identical to serial" is checkable against one function.
    """
    if rows.shape[0] == 0:
        return rows
    return rows[(rows == vertex).any(axis=1)]


@dataclasses.dataclass
class RequestResult:
    """Terminal state of one request, returned by :meth:`Ticket.result`.

    ``count`` is the exact clique count (count mode; None for listing),
    ``rows`` the ``(n, k)`` int64 clique array (listing mode with the
    default in-memory sink; None when the caller supplied its own sink),
    ``emitted`` the rows accepted by the sink, ``latency_s`` the
    admission-to-resolution wall clock, and ``deadline_missed`` whether
    that exceeded the request's deadline (deadlines are accounting, not
    cancellation: a late request still completes exactly).  ``stats``
    carries the per-request engine accounting (spills, overflows, ...).
    """

    kind: str
    count: Optional[int] = None
    rows: Optional[np.ndarray] = None
    emitted: int = 0
    latency_s: float = 0.0
    deadline_s: Optional[float] = None
    deadline_missed: bool = False
    stats: Optional[Stats] = None
    # per-stage latency breakdown: "queue" (wait before admission),
    # "fuse" (buffer wait), "device" (flush-to-delivery, overlapping
    # across fused requests), "reorder" (sequencer park time)
    stage_s: Dict[str, float] = dataclasses.field(default_factory=dict)


class Request:
    """One admitted query plus its sequencer/delivery state.

    Built by :meth:`CliqueService.submit`; client code holds the
    :class:`Ticket`, the scheduler and decode worker call
    :meth:`next_seq` / :meth:`deliver` / :meth:`finish_feeding`.

    ``mode`` is ``"count"``, ``"list"``, or ``"delta"``.  Listing and
    delta requests deliver into ``sink`` (default: an in-memory
    ``ArraySink`` honoring ``max_out``) after ``vertex_filter`` (keep
    rows containing that vertex) is applied; ``max_out`` truncation
    happens *after* filtering.  A delta request ("cliques gained since
    version N") carries ``since_version`` and is answered from the
    graph's :class:`~repro_torch.delta.PlanIndex` lineage on the scheduler
    thread, streaming through the same sequencer/sink machinery.
    ``enforce_deadline=True`` arms cooperative cancellation: the
    scheduler stops feeding the request at ``deadline_s`` and resolves it
    with :class:`DeadlineExceeded` instead of finishing late.
    """

    def __init__(
        self,
        g,
        k: int,
        mode: str = "count",
        *,
        order: str = "hybrid",
        use_rule2: bool = True,
        vertex_filter: Optional[int] = None,
        max_out: Optional[int] = None,
        deadline_s: Optional[float] = None,
        enforce_deadline: bool = False,
        sink: Optional[listing.CliqueSink] = None,
        since_version: Optional[int] = None,
    ) -> None:
        if mode not in ("count", "list", "delta"):
            raise ValueError(
                f"mode must be 'count', 'list', or 'delta', got {mode!r}")
        if order not in ("truss", "hybrid", "color"):
            raise ValueError(f"unknown edge-tile mode: {order}")
        if mode in ("list", "delta") and k < 3:
            raise ValueError(f"{mode} mode requires k >= 3")
        if mode == "delta" and since_version is None:
            raise ValueError("delta mode requires since_version")
        if since_version is not None and since_version < 0:
            raise ValueError("since_version must be >= 0")
        if k < 1:
            raise ValueError("k must be >= 1")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        if enforce_deadline and deadline_s is None:
            raise ValueError("enforce_deadline requires deadline_s")
        self.g = g
        self.k = int(k)
        self.l = self.k - 2
        self.mode = mode
        self.order = order
        self.use_rule2 = use_rule2
        self.vertex_filter = vertex_filter
        self.max_out = max_out
        self.deadline_s = deadline_s
        self.enforce_deadline = bool(enforce_deadline)
        self.since_version = since_version
        self.stats = Stats()
        self.rid = next(_RID)  # ticket id; keys the request's trace tree
        self.stage_s: Dict[str, float] = {}
        self._stage_lock = threading.Lock()
        self.submit_t: Optional[float] = None  # monotonic, set at admission
        self.deadline_t: Optional[float] = None  # absolute monotonic
        self._external_sink = sink is not None
        if mode != "count":
            self._sink = sink if sink is not None else listing.ArraySink(
                self.k, max_out=max_out)
        else:
            self._sink = None
        self._count = 0
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._seq_next = 0      # next sequence number to assign (scheduler)
        self._release_next = 0  # next sequence number to release to the sink
        self._parked: dict = {}  # seq -> rows awaiting in-order release
        self._delivered = 0
        self._feeding_done = False
        self._result: Optional[RequestResult] = None
        self._error: Optional[BaseException] = None
        self._on_done = None  # service hook, set at admission
        self._on_isolated = None  # scheduler hook: count contained failures
        self._delta_entry = None  # service graph-registry entry (delta mode)

    # -- scheduler-side API -------------------------------------------------

    def mark_submitted(self, now: Optional[float] = None) -> None:
        """Stamp admission time; deadlines become absolute from here."""
        self.submit_t = time.monotonic() if now is None else now
        if self.deadline_s is not None:
            self.deadline_t = self.submit_t + self.deadline_s
        trace.async_begin("request", id=self.rid, k=self.k, mode=self.mode)

    def mark_admitted(self, now: Optional[float] = None) -> None:
        """Stamp scheduler pickup; the queue wait becomes attributable."""
        now = time.monotonic() if now is None else now
        if self.submit_t is not None:
            self.add_stage("queue", now - self.submit_t)
        trace.async_instant("request/admit", id=self.rid)

    def add_stage(self, stage: str, dt: float) -> None:
        """Accrue ``dt`` seconds to one lifecycle stage (thread-safe)."""
        with self._stage_lock:
            self.stage_s[stage] = self.stage_s.get(stage, 0.0) + dt

    def next_seq(self) -> int:
        """Assign the next chunk sequence number (scheduler thread only)."""
        s = self._seq_next
        self._seq_next += 1
        return s

    @property
    def full(self) -> bool:
        """True once the sink stopped accepting (listing early stop)."""
        return self._sink is not None and self._sink.full

    def deliver(self, seq: int, payload) -> None:
        """Deliver one completed chunk (count int or decoded row array).

        Thread-safe; called from the scheduler thread (spills, routed
        counts) and the decode worker (routed listing chunks).  Listing
        payloads park in the reorder buffer until every earlier sequence
        number has been released, so the sink observes strict pull order
        no matter which fused batch finished first.
        """
        with self._lock:
            if self._event.is_set():
                return  # already resolved (failed/cancelled): drop late work
            if self.mode == "count":
                self._count += int(payload)
                self._delivered += 1
            else:
                self._parked[seq] = (payload, time.perf_counter_ns())
                while self._release_next in self._parked:
                    rows, t_park = self._parked.pop(self._release_next)
                    dur_ns = time.perf_counter_ns() - t_park
                    with self._stage_lock:
                        self.stage_s["reorder"] = (
                            self.stage_s.get("reorder", 0.0) + dur_ns / 1e9
                        )
                    trace.complete(
                        "reorder/park", t_park, dur_ns,
                        rid=self.rid, seq=self._release_next,
                    )
                    self._release_next += 1
                    self._delivered += 1
                    try:
                        self._emit_locked(rows)
                    except Exception as exc:
                        # a raising sink fails only this request -- the
                        # scheduler and every other in-flight request
                        # keep running (per-request isolation)
                        self._fail_locked(exc)
                        if self._on_isolated is not None:
                            self._on_isolated(self, exc)
                        return
            self._maybe_resolve_locked()

    def finish_feeding(self) -> None:
        """Signal that no further sequence numbers will be assigned."""
        with self._lock:
            self._feeding_done = True
            self._maybe_resolve_locked()

    def fail(self, exc: BaseException) -> None:
        """Resolve the request exceptionally (admission/scheduler error)."""
        with self._lock:
            self._fail_locked(exc)

    def cancel_deadline(self, now: Optional[float] = None) -> bool:
        """Cancel a deadline-enforced request that blew its deadline.

        Called by the scheduler once ``deadline_t`` has passed for a
        request with ``enforce_deadline=True``.  Resolves the ticket with
        :class:`DeadlineExceeded` carrying whatever was already released
        in pull order (partial rows / running count).  Returns False when
        the request had already resolved (benign race with completion).
        """
        with self._lock:
            if self._event.is_set():
                return False
            partial = None
            emitted = 0
            pcount = None
            if self.mode == "count":
                pcount = self._count
            elif self._sink is not None:
                try:
                    self._sink.close()
                except Exception:
                    pass  # a failing sink must not block cancellation
                emitted = self._sink.accepted
                if not self._external_sink:
                    partial = self._sink.result()
            self._fail_locked(DeadlineExceeded(
                f"deadline {self.deadline_s}s exceeded",
                partial_rows=partial, emitted=emitted, partial_count=pcount))
            return True

    # -- internals ----------------------------------------------------------

    def _fail_locked(self, exc: BaseException) -> None:
        if self._event.is_set():
            return
        self._error = exc
        trace.async_end("request", id=self.rid, error=repr(exc))
        self._event.set()

    def _emit_locked(self, rows: np.ndarray) -> None:
        fault_retry.consume("sink.write")  # chaos site: delivery-side emit
        if self.vertex_filter is not None:
            rows = apply_vertex_filter(rows, self.vertex_filter)
        accepted = self._sink.emit(rows)
        self.stats.emitted_cliques += accepted

    def _maybe_resolve_locked(self) -> None:
        if self._event.is_set():
            return
        if not (self._feeding_done and self._delivered == self._seq_next):
            return
        now = time.monotonic()
        latency = now - self.submit_t if self.submit_t is not None else 0.0
        missed = self.deadline_t is not None and now > self.deadline_t
        rows = None
        emitted = 0
        if self.mode != "count":
            self._sink.close()
            emitted = self._sink.accepted
            self.stats.sink_bytes += self._sink.bytes_written
            if not self._external_sink:
                rows = self._sink.result()
        with self._stage_lock:
            stage_s = dict(self.stage_s)
        self._result = RequestResult(
            kind=self.mode,
            count=self._count if self.mode == "count" else None,
            rows=rows,
            emitted=emitted,
            latency_s=latency,
            deadline_s=self.deadline_s,
            deadline_missed=missed,
            stats=self.stats,
            stage_s=stage_s,
        )
        trace.async_end(
            "request", id=self.rid,
            latency_ms=round(latency * 1e3, 3),
            deadline_missed=missed,
        )
        self._event.set()
        if self._on_done is not None:
            self._on_done(self._result)


class Ticket:
    """Client-side handle of a submitted request (future-like).

    Returned by :meth:`CliqueService.submit`; safe to wait on from any
    thread.  By default deadlines never cancel work -- a late request
    resolves with ``deadline_missed=True`` and exact results.  With
    ``enforce_deadline=True`` an expired request instead resolves with
    :class:`DeadlineExceeded` (carrying any partial results) while the
    service keeps serving everyone else.
    """

    def __init__(self, request: Request) -> None:
        self._request = request

    def done(self) -> bool:
        """True once the request has resolved (result or error)."""
        return self._request._event.is_set()

    def result(self, timeout: Optional[float] = None) -> RequestResult:
        """Block for the terminal :class:`RequestResult`.

        Raises ``TimeoutError`` if the request does not resolve within
        ``timeout`` seconds, or re-raises the failure that resolved it
        exceptionally.
        """
        if not self._request._event.wait(timeout):
            raise TimeoutError("request not resolved within timeout")
        if self._request._error is not None:
            raise self._request._error
        return self._request._result


class RequestQueue:
    """Thread-safe bounded FIFO admission queue (the backpressure seam).

    ``put`` from any number of client threads; ``get`` from the
    scheduler thread.  A full queue makes non-blocking ``put`` raise
    :class:`ServiceOverloaded` (shed at the front door, before any
    per-request work), while ``block=True`` waits for capacity.  After
    :meth:`close`, ``put`` raises :class:`ServiceClosed` but queued
    requests still drain through ``get``.
    """

    def __init__(self, max_pending: int = 256) -> None:
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.max_pending = int(max_pending)
        self._dq: deque = deque()
        self._cond = threading.Condition()
        self._closed = False

    def __len__(self) -> int:
        """Number of queued (admitted but not yet scheduled) requests."""
        with self._cond:
            return len(self._dq)

    def put(self, req: Request, block: bool = True,
            timeout: Optional[float] = None) -> None:
        """Enqueue one request; overload behavior depends on ``block``.

        Raises :class:`ServiceOverloaded` immediately (``block=False``)
        or after ``timeout`` seconds without capacity; raises
        :class:`ServiceClosed` once the queue is closed.
        """
        with self._cond:
            if self._closed:
                raise ServiceClosed("service is closed")
            if len(self._dq) >= self.max_pending:
                if not block:
                    raise ServiceOverloaded(
                        f"queue full ({self.max_pending} pending)")
                ok = self._cond.wait_for(
                    lambda: self._closed or len(self._dq) < self.max_pending,
                    timeout)
                if self._closed:
                    raise ServiceClosed("service is closed")
                if not ok:
                    raise ServiceOverloaded(
                        f"queue full ({self.max_pending} pending) after "
                        f"{timeout}s")
            self._dq.append(req)
            self._cond.notify_all()

    def get(self, timeout: Optional[float] = None) -> Optional[Request]:
        """Dequeue the oldest request, blocking up to ``timeout`` seconds.

        Returns None on timeout or when the queue is closed and empty.
        """
        with self._cond:
            self._cond.wait_for(lambda: self._closed or self._dq, timeout)
            if not self._dq:
                return None
            req = self._dq.popleft()
            self._cond.notify_all()
            return req

    def get_nowait(self) -> Optional[Request]:
        """Dequeue the oldest request without blocking (None when empty)."""
        with self._cond:
            if not self._dq:
                return None
            req = self._dq.popleft()
            self._cond.notify_all()
            return req

    def close(self) -> None:
        """Stop admissions (``put`` raises); queued requests still drain."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
