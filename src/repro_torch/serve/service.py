"""CliqueService: the long-lived multi-tenant serving front door.

The port's copy of ``repro/serve/service.py`` over the torch engines.
Its lanes are the port's dispatcher lanes: ``devices=None`` means every
visible CUDA device and raises without one, ``devices=["cpu"]`` runs
the plain torch versions on the CPU.  A graph's
:class:`~repro_torch.delta.PlanIndex` carries the service's lanes, so
``mode="delta"`` reads list on them too (the reference's read its host
recursion).  DESIGN.md section 10.  One service owns a graph registry, a bounded
:class:`~repro_torch.serve.request.RequestQueue`, a
:class:`~repro_torch.serve.scheduler.BatchScheduler`, and a single scheduler
thread that drives admission -> pull -> coalesce -> dispatch.  Client
threads call :meth:`CliqueService.submit` and block on the returned
:class:`~repro_torch.serve.request.Ticket`; everything device-side is shared:
plans via the keyed plan cache, the kernel library built once per
process, dispatchers (and their CUDA streams) across all requests.

Request lifecycle::

    submit() -> RequestQueue -> admit (plan lookup, open tile stream)
      -> EDF/LPT chunk pulls -> fuse buffers -> shared Dispatcher /
      ListDispatcher -> route callbacks -> per-request sequencer ->
      sink -> Ticket.result()

Overload behavior: a full queue rejects non-blocking submits with
:class:`~repro_torch.serve.request.ServiceOverloaded` (counted in
``ServeStats.rejected``); with ``shed_on_projected_miss=True`` the
scheduler additionally sheds deadline-bearing requests whose projected
completion already misses (``ServeStats.shed``).  Deadlines are
accounting only by default -- admitted work completes exactly, late or
not -- unless a request opts into ``enforce_deadline=True``, in which
case expiry cooperatively cancels that request (and only it) with
:class:`~repro_torch.serve.request.DeadlineExceeded`.

Failure containment (DESIGN.md section 12): one request's engine,
sink, or stream exception resolves *that* ticket exceptionally while
the scheduler thread and every cotenant request keep running.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Union

import numpy as np

from ..core.engine_np import Stats
from ..core.graph import Graph
from ..delta import PlanIndex
from ..obs import metrics as obs_metrics
from ..obs import trace
from ..obs.export import MetricsServer
from .request import (Request, RequestQueue, ServiceClosed, Ticket)
from .scheduler import BatchScheduler, ServeStats

#: rows per delivered chunk when streaming a delta subscription read
#: through the sequencer (keeps individual sink emits bounded)
_DELTA_CHUNK_ROWS = 4096


class _GraphEntry:
    """One registered graph: current snapshot, version, delta lineage.

    ``index`` (a :class:`~repro_torch.delta.PlanIndex`) is created lazily on
    the first :meth:`CliqueService.update_graph` call -- a never-mutated
    graph pays nothing for the dynamic-graph machinery.  ``lock``
    serializes updates and delta reads per entry (PlanIndex is not
    thread-safe by itself).
    """

    __slots__ = ("graph", "index", "lock")

    def __init__(self, g: Graph) -> None:
        self.graph = g
        self.index: Optional[PlanIndex] = None
        self.lock = threading.Lock()

    @property
    def version(self) -> int:
        return 0 if self.index is None else self.index.version


class CliqueService:
    """Continuous-batching k-clique serving tier over the torch engines.

    Typical use::

        svc = CliqueService(devices="all", plan_cache_dir="/tmp/plans")
        svc.register_graph("social", g)
        t1 = svc.submit("social", k=5, mode="count")
        t2 = svc.submit("social", k=5, mode="list", max_out=100,
                        deadline_s=0.2)
        print(t1.result().count, t2.result().rows)
        svc.close()

    Construction knobs: ``devices`` / ``backend`` / ``async_staging`` /
    ``max_inflight`` mirror the single-query engines; ``chunk_tiles`` is
    the per-request pull granularity (smaller = finer interleaving,
    more fusion), ``fuse_rows`` the target fused-batch rows (matches the
    single-query default batch size so fused batches reuse the same warm
    executables), ``flush_slack_s`` how close to a deadline a partial
    buffer is flushed early, ``max_buffer_wait_s`` the age bound on a
    partial fuse buffer (caps fusion-induced latency when no mergeable
    chunk shows up), ``max_pending`` the admission-queue bound
    (backpressure), and ``max_active`` how many requests are pulled from
    concurrently.

    Thread safety: ``submit`` / ``register_graph`` / ``stats`` are safe
    from any thread; one internal scheduler thread does all engine work.
    Results are exact and per-request byte-identical to serial execution
    (see DESIGN.md section 10 for the invariant and its mechanism).
    """

    def __init__(
        self,
        *,
        devices=None,
        backend: Optional[str] = None,
        max_pending: int = 256,
        max_active: int = 16,
        chunk_tiles: int = 64,
        fuse_rows: int = 256,
        flush_slack_s: float = 0.02,
        max_buffer_wait_s: float = 0.01,
        capacity=None,
        max_capacity: Optional[int] = None,
        plan_cache_dir: Optional[str] = None,
        async_staging: bool = True,
        max_inflight: int = 2,
        shed_on_projected_miss: bool = False,
        metrics_port: Optional[int] = None,
        start: bool = True,
    ) -> None:
        self.stats = ServeStats()
        self.engine_stats = Stats()
        # service-level rollup of completed requests' per-request Stats
        # (folded in via Stats.merge at completion; the dispatcher-shared
        # engine_stats tracks device-side work, this tracks request-side)
        self.request_stats = Stats()
        self._sched = BatchScheduler(
            devices=devices,
            backend=backend,
            chunk_tiles=chunk_tiles,
            fuse_rows=fuse_rows,
            flush_slack_s=flush_slack_s,
            max_buffer_wait_s=max_buffer_wait_s,
            capacity=capacity,
            max_capacity=max_capacity,
            plan_cache_dir=plan_cache_dir,
            async_staging=async_staging,
            max_inflight=max_inflight,
            shed_on_projected_miss=shed_on_projected_miss,
            stats=self.stats,
            engine_stats=self.engine_stats,
        )
        self.max_active = max(1, int(max_active))
        self._queue = RequestQueue(max_pending)
        self._graphs: dict = {}
        self._graphs_lock = threading.Lock()
        self._resume = threading.Event()
        self._resume.set()
        self._closing = threading.Event()
        self._abort = threading.Event()  # close(drain=False): shed, don't finish
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        # /metrics exposition (off by default; metrics_port=0 = ephemeral)
        self._metrics_server: Optional[MetricsServer] = None
        self._registry = obs_metrics.get_registry()
        if metrics_port is not None:
            self._registry.add_collector(self._collect_metrics)
            self._metrics_server = MetricsServer(
                port=metrics_port, registry=self._registry)
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Start the scheduler thread (idempotent)."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="clique-serve", daemon=True)
        self._thread.start()

    def pause(self) -> None:
        """Halt admission+scheduling; queued submits accumulate.

        A test/ops hook: pause, submit a burst, :meth:`resume` -- the
        whole burst is then admitted together, maximizing cross-request
        fusion determinism in tests.
        """
        self._resume.clear()

    def resume(self) -> None:
        """Resume the scheduler after :meth:`pause`."""
        self._resume.set()

    def close(self, timeout: Optional[float] = None,
              drain: bool = True) -> None:
        """Drain queued+active requests, then shut the tier down.

        Blocks until the scheduler thread exits (up to ``timeout``) and
        the dispatchers are finished.  Idempotent.  With ``drain=False``
        in-flight and queued requests are not completed: every
        unresolved ticket resolves with
        :class:`~repro_torch.serve.request.ServiceClosed` (no hang) and the
        tier shuts down as fast as device teardown allows.
        """
        if not drain:
            self._abort.set()
        self._closing.set()
        self._resume.set()
        self._queue.close()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self._sched.finish()
        if self._metrics_server is not None:
            self._registry.remove_collector(self._collect_metrics)
            self._metrics_server.close()
            self._metrics_server = None

    def __enter__(self) -> "CliqueService":
        """Context-manager entry: the started service itself."""
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        """Context-manager exit: full drain + shutdown."""
        self.close()

    # -- client API ---------------------------------------------------------

    @property
    def metrics_address(self) -> Optional[str]:
        """``host:port`` of the /metrics endpoint, or None when disabled."""
        if self._metrics_server is None:
            return None
        return self._metrics_server.address

    def register_graph(self, name: str, g: Graph) -> None:
        """Register ``g`` under ``name`` for by-name submission.

        Safe from any thread.  Re-registering a name replaces the graph
        (at version 0, with no delta lineage) for *future* submissions
        only.
        """
        with self._graphs_lock:
            self._graphs[name] = _GraphEntry(g)

    def graph_version(self, name: str) -> int:
        """Current version of a registered graph (0 until first update)."""
        return self._entry(name).version

    def update_graph(self, name: str, insert=None, delete=None,
                     *, order: str = "hybrid") -> int:
        """Apply one edge batch to a registered graph; returns the version.

        Runs :meth:`~repro_torch.delta.PlanIndex.apply_batch`: the mutated
        graph's plan is locally repaired (or rebuilt past the churn
        threshold) and published into the keyed plan cache, so the next
        submission against ``name`` admits against a warm plan --
        post-mutation queries pay O(touched neighborhood), not
        O(delta*m).  The new snapshot is swapped in atomically under the
        scheduler's stats lock; in-flight requests keep streaming their
        admitted snapshot (exactly the re-registration semantics).

        ``order`` fixes the maintained plan family on the *first* update
        of this graph; later updates reuse the entry's index.  Safe from
        any thread; updates to one graph serialize, different graphs
        proceed concurrently.
        """
        entry = self._entry(name)
        with entry.lock:
            if entry.index is None:
                entry.index = PlanIndex(
                    entry.graph, order,
                    cache_dir=self._sched.plan_cache_dir,
                    stats=self.engine_stats,
                    devices=self._sched.devices,
                    engine_kwargs={"backend": self._sched.backend})
            version = entry.index.apply_batch(insert=insert, delete=delete)
            with self._sched.stats_lock:
                entry.graph = entry.index.graph
                self.stats.graph_updates += 1
        trace.instant("serve/graph_update", graph=name, version=version)
        return version

    def _entry(self, name: str) -> _GraphEntry:
        with self._graphs_lock:
            entry = self._graphs.get(name)
        if entry is None:
            raise KeyError(f"unknown graph {name!r}; register_graph first")
        return entry

    def submit(
        self,
        graph: Union[str, Graph],
        k: int,
        mode: str = "count",
        *,
        order: str = "hybrid",
        use_rule2: bool = True,
        vertex_filter: Optional[int] = None,
        max_out: Optional[int] = None,
        deadline_s: Optional[float] = None,
        enforce_deadline: bool = False,
        sink=None,
        since_version: Optional[int] = None,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> Ticket:
        """Submit one query; returns immediately with a :class:`Ticket`.

        ``graph`` is a registered name or a ``Graph`` instance.  ``mode``
        is ``"count"``, ``"list"``, or ``"delta"``; listing honors
        ``vertex_filter`` (keep cliques containing that vertex),
        ``max_out`` (truncate after filtering, with early stop), and a
        custom ``sink``.  ``mode="delta"`` is the subscription read --
        rows of k-cliques *gained* since ``since_version`` of a
        registered (by-name only) graph, answered from the delta lineage
        maintained by :meth:`update_graph` and streamed through the same
        sequencer/sink path as listing (so ``vertex_filter`` /
        ``max_out`` / ``sink`` compose); ``since_version`` equal to the
        current version yields an empty result, one ahead of it or
        behind the retained history resolves the ticket with
        ``ValueError``.  ``deadline_s`` is a relative latency target used
        for EDF
        scheduling and miss accounting; with ``enforce_deadline=True``
        it becomes real: at expiry the scheduler cancels this request
        cooperatively and the ticket raises
        :class:`~repro_torch.serve.request.DeadlineExceeded` carrying any
        partial results.

        Backpressure: with ``block=False`` a full admission queue raises
        :class:`~repro_torch.serve.request.ServiceOverloaded` instead of
        waiting (``timeout`` bounds the blocking wait).  Raises
        :class:`~repro_torch.serve.request.ServiceClosed` after :meth:`close`.

        Thread-safe; callable from any number of client threads.
        """
        if self._closing.is_set():
            raise ServiceClosed("service is closed")
        entry = None
        if isinstance(graph, str):
            entry = self._entry(graph)
            g = entry.graph
        else:
            if mode == "delta":
                raise ValueError(
                    "delta mode requires a registered graph name (the "
                    "version lineage lives in the registry)")
            g = graph
        req = Request(
            g, k, mode, order=order, use_rule2=use_rule2,
            vertex_filter=vertex_filter, max_out=max_out,
            deadline_s=deadline_s, enforce_deadline=enforce_deadline,
            sink=sink, since_version=since_version,
        )
        req._delta_entry = entry
        req._on_done = self._record_done
        req.mark_submitted()
        if mode == "count" and k < 3:
            # closed forms; answered at admission, never scheduled
            with self._sched.stats_lock:
                self.stats.admitted += 1
            req.deliver(req.next_seq(), g.n if k == 1 else g.m)
            req.finish_feeding()
            return Ticket(req)
        try:
            self._queue.put(req, block=block, timeout=timeout)
        except Exception:
            with self._sched.stats_lock:
                self.stats.rejected += 1
            trace.async_end("request", id=req.rid, rejected=True)
            raise
        with self._sched.stats_lock:
            self.stats.admitted += 1
        return Ticket(req)

    # -- internals ----------------------------------------------------------

    def _record_done(self, result) -> None:
        with self._sched.stats_lock:
            self.stats.completed += 1
            if result.deadline_missed:
                self.stats.deadline_missed += 1
            if result.stats is not None:
                self.request_stats.merge(result.stats)
        self._registry.histogram(
            "repro_request_latency_seconds",
            help="end-to-end request latency (submit to resolve)",
        ).observe(result.latency_s)
        for stage, dt in (result.stage_s or {}).items():
            self._registry.counter(
                "repro_request_stage_seconds_total",
                help="wall seconds per request lifecycle stage",
                stage=stage,
            ).inc(dt)

    def _collect_metrics(self) -> None:
        # scrape-time publication of the lifetime accumulators; counters
        # only move forward (set_total keeps the max) so this is safe to
        # call concurrently with the scheduler thread mutating the stats
        with self._sched.stats_lock:
            obs_metrics.publish_totals(
                self.stats, "repro_serve", self._registry)
            obs_metrics.publish_totals(
                self.engine_stats, "repro_engine", self._registry)
            obs_metrics.publish_totals(
                self.request_stats, "repro_request", self._registry)
        self._registry.gauge(
            "repro_serve_queue_depth",
            help="requests waiting for admission",
        ).set(len(self._queue))
        self._registry.gauge(
            "repro_serve_active_requests",
            help="requests currently being pulled from",
        ).set(self._sched.n_active)

    def _admit_safe(self, req: Request) -> None:
        try:
            if req.mode == "delta":
                self._serve_delta(req)
            else:
                self._sched.admit(req)
        except Exception as exc:  # bad request: resolve it, keep serving
            req.fail(exc)

    def _serve_delta(self, req: Request) -> None:
        """Answer a subscription read from the graph's delta lineage.

        Runs on the scheduler thread at admission (delta reads are
        in-memory set algebra over retained per-batch deltas -- no tile
        stream to schedule).  Rows are delivered in bounded chunks
        through the request's sequencer, so vertex filtering, max_out
        truncation, custom sinks, and failure isolation all behave
        exactly as in listing mode.
        """
        req.mark_admitted()
        entry = req._delta_entry
        with self._sched.stats_lock:
            self.stats.delta_requests += 1
        with trace.span("serve/delta", rid=req.rid, k=req.k,
                        since=req.since_version):
            with entry.lock:
                if entry.index is None:
                    if req.since_version != 0:
                        raise ValueError(
                            f"since={req.since_version} outside [0, 0]")
                    rows = np.zeros((0, req.k), dtype=np.int64)
                else:
                    rows = entry.index.delta(req.k, req.since_version).gained
        for start in range(0, rows.shape[0], _DELTA_CHUNK_ROWS):
            if req.full:
                break
            req.deliver(req.next_seq(),
                        rows[start:start + _DELTA_CHUNK_ROWS])
        req.finish_feeding()

    def _shed_all(self, exc: BaseException) -> None:
        """Resolve every active and queued request with ``exc``."""
        self._sched.fail_active(exc)
        while True:
            req = self._queue.get_nowait()
            if req is None:
                break
            req.fail(exc)

    def _run(self) -> None:
        sched, queue = self._sched, self._queue
        try:
            while True:
                if self._abort.is_set():
                    # close(drain=False): resolve everything, skip the work
                    self._shed_all(ServiceClosed(
                        "service closed (drain=False)"))
                    break
                if not self._resume.is_set():
                    if self._closing.is_set():
                        self._resume.set()
                        continue
                    self._resume.wait(0.05)
                    continue
                while sched.n_active < self.max_active:
                    req = queue.get_nowait()
                    if req is None:
                        break
                    self._admit_safe(req)
                if sched.step():
                    continue
                # no pullable stream: push pending + in-flight work out so
                # every delivered request resolves before we block
                sched.flush_all()
                sched.drain()
                if self._closing.is_set() and len(queue) == 0 \
                        and sched.n_active == 0:
                    break
                req = queue.get(timeout=0.05)
                if req is not None:
                    self._admit_safe(req)
        except (KeyboardInterrupt, SystemExit):  # never swallow these
            raise
        except Exception as exc:
            # the scheduler *infrastructure* died (per-request failures
            # are contained upstream and never reach here): fail every
            # waiter with the real error so no ticket hangs, then re-raise
            self._error = exc
            self._shed_all(exc)
            raise
