"""Cross-request batch coalescing and EDF/LPT scheduling.

The port's copy of ``repro/serve/scheduler.py`` over the torch engines:
``engine_torch.count_spilled`` / ``combine_counts`` where the reference
calls its JAX engine, and the port's :class:`Dispatcher` /
:class:`ListDispatcher`, whose lanes are CUDA streams (``devices=None``
means every visible CUDA device and raises without one; CPU lanes,
``devices=["cpu"]``, run the plain torch versions).  DESIGN.md section 10.  The :class:`BatchScheduler` is the heart of the
serving tier: it pulls small per-request tile chunks (the regular
``pipeline.stream_batches`` output, just with a small ``batch_size``)
from whichever active request EDF/LPT picks next, accumulates them in
per-``(mode, l, T)`` fuse buffers, and flushes each buffer as **one**
fused ``TileBatch`` through the shared multi-device dispatchers (the
port's CUDA-stream lanes; a fused batch goes to the card unpadded, as
every batch of the port does, so it needs no ``bucket_rows``).

Coalescing rules (what may share a device batch):

* same ``mode`` (count vs list: different kernels),
* same ``l = k - 2`` (the kernels are specialized on l),
* same tile width ``T`` (fixed-shape batches).

Ordering/exactness: each pulled chunk carries its request's next
sequence number; counting segments are combined per-segment with the
exact int64 ``combine_counts`` (commutative -- no ordering needed), and
listing segments decode on the dispatcher's single FIFO decode worker
and release through the request's reorder buffer
(:meth:`~repro_torch.serve.request.Request.deliver`), so per-request results
are byte-identical to a serial run regardless of how requests interleave.

All methods run on the service's scheduler thread; only the listing
route callbacks execute elsewhere (the dispatcher decode worker).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import engine_torch, listing, pipeline
from ..core import tiles as tiles_mod
from ..core.engine_np import Stats
from ..obs import trace
from ..runtime.dispatch import Dispatcher, ListDispatcher, resolve_devices
from .request import ET_T, Request, ServiceOverloaded


@dataclasses.dataclass
class ServeStats:
    """Service-level accounting (all requests), updated under a lock.

    ``cross_request_batches`` counts fused device batches containing
    chunks from more than one request -- the direct evidence that
    continuous batching is happening; ``deadline_flushes`` counts fuse
    buffers flushed early because an owner's deadline drew near.

    Resilience counters: ``isolated_failures`` is requests resolved
    exceptionally while the service kept serving everyone else,
    ``deadline_cancels`` is deadline-*enforced* requests cooperatively
    cancelled at expiry, and ``shed`` is admissions rejected by the
    projected-deadline-miss load shedder.

    Dynamic-graph counters: ``graph_updates`` is applied edge batches
    (:meth:`~repro_torch.serve.service.CliqueService.update_graph`) and
    ``delta_requests`` is admitted ``mode="delta"`` subscription reads.
    """

    admitted: int = 0
    rejected: int = 0
    completed: int = 0
    deadline_missed: int = 0
    fused_batches: int = 0
    cross_request_batches: int = 0
    fused_rows: int = 0
    fused_chunks: int = 0
    deadline_flushes: int = 0
    spill_tiles: int = 0
    isolated_failures: int = 0
    deadline_cancels: int = 0
    shed: int = 0
    graph_updates: int = 0
    delta_requests: int = 0

    # every field is a monotonic total (repro_torch.obs.metrics publication)
    _METRIC_KINDS = {f: "sum" for f in (
        "admitted", "rejected", "completed", "deadline_missed",
        "fused_batches", "cross_request_batches", "fused_rows",
        "fused_chunks", "deadline_flushes", "spill_tiles",
        "isolated_failures", "deadline_cancels", "shed",
        "graph_updates", "delta_requests",
    )}


def edf_pick(entries: List[Tuple[Optional[float], float, int]]
             ) -> Optional[int]:
    """Pick the next request to pull from: EDF with LPT fallback.

    ``entries`` holds ``(deadline_t, remaining_work, arrival_idx)`` per
    pullable request.  Earliest absolute deadline wins (requests without
    a deadline sort last, as infinitely patient); among equal deadlines
    the *largest* remaining work wins (LPT -- finishing long requests
    first maximizes batch-fusion opportunities for the stragglers and
    minimizes makespan), with arrival order as the final tie-break.
    Returns the index into ``entries`` or None when empty.
    """
    best = None
    best_key = None
    for i, (deadline, remaining, idx) in enumerate(entries):
        key = (deadline if deadline is not None else math.inf,
               -float(remaining), idx)
        if best_key is None or key < best_key:
            best, best_key = i, key
    return best


def fuse_chunks(chunks: List[Tuple[Request, int, pipeline.TileBatch]]
                ) -> Tuple[pipeline.TileBatch, List[tuple]]:
    """Concatenate same-(T) chunks into one fused batch plus segments.

    Returns ``(fused, segments)`` where each segment is
    ``(request, seq, row_start, row_stop, chunk_batch)`` -- the slice of
    the fused batch axis owned by that request's chunk.  A single chunk
    passes through unconcatenated.
    """
    if len(chunks) == 1:
        req, seq, b = chunks[0]
        return b, [(req, seq, 0, b.B, b)]
    T = chunks[0][2].T
    segments = []
    start = 0
    for req, seq, b in chunks:
        segments.append((req, seq, start, start + b.B, b))
        start += b.B
    fused = pipeline.TileBatch(
        T,
        np.concatenate([b.A for _, _, b in chunks]),
        np.concatenate([b.cand for _, _, b in chunks]),
        np.concatenate([b.sizes for _, _, b in chunks]),
        np.concatenate([b.nedges for _, _, b in chunks]),
        np.concatenate([b.anchors for _, _, b in chunks]),
        np.concatenate([b.verts for _, _, b in chunks]),
    )
    return fused, segments


@dataclasses.dataclass
class _ActiveStream:
    """One admitted request currently being pulled from."""

    req: Request
    stream: object  # pipeline.stream_batches generator
    remaining: int  # tiles not yet pulled (the LPT work estimate)
    idx: int        # arrival order (final tie-break)


class _FuseBuffer:
    """Accumulates same-(mode, l, T) chunks until flush."""

    def __init__(self, now: float) -> None:
        self.chunks: List[Tuple[Request, int, pipeline.TileBatch]] = []
        self.pull_ts: List[float] = []  # per-chunk buffer-entry times
        self.rows = 0
        self.created_t = now  # first-chunk time: bounds buffering latency

    def min_deadline(self) -> float:
        """Earliest absolute deadline among the buffered chunk owners."""
        ds = [r.deadline_t for r, _, _ in self.chunks
              if r.deadline_t is not None]
        return min(ds) if ds else math.inf


class BatchScheduler:
    """Coalesces per-request tile chunks into shared device batches.

    Owns one counting :class:`Dispatcher` and one :class:`ListDispatcher`
    per ``l`` (lazily created, sharing one resolved device list), the
    EDF/LPT pull policy, and the per-``(mode, l, T)`` fuse buffers.
    Driven synchronously by the service's scheduler thread:
    :meth:`admit` new requests, :meth:`step` until False (no pullable
    stream), then :meth:`flush_all` + :meth:`drain` to push everything
    in flight out to the sinks.
    """

    def __init__(
        self,
        *,
        devices=None,
        backend: Optional[str] = None,
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
        stats: Optional[ServeStats] = None,
        engine_stats: Optional[Stats] = None,
    ) -> None:
        self.devices = resolve_devices(devices)
        self.backend = backend
        self.chunk_tiles = max(1, int(chunk_tiles))
        self.fuse_rows = max(1, int(fuse_rows))
        self.flush_slack_s = float(flush_slack_s)
        self.max_buffer_wait_s = float(max_buffer_wait_s)
        # a long-lived service defaults to the speculative capacity
        # ratchet: unlike a one-shot query, its per-tile-width guesses
        # converge once and then stay warm across every later request,
        # so steady-state listing costs one device pass per batch instead
        # of sized mode's two -- with identical emitted triples (a short
        # guess is retried on the device at the exact size, never dropped)
        self.capacity = "speculative" if capacity is None else capacity
        self.max_capacity = max_capacity
        self.plan_cache_dir = plan_cache_dir
        self.async_staging = async_staging
        self.max_inflight = max_inflight
        self.shed_on_projected_miss = bool(shed_on_projected_miss)
        self.stats = stats if stats is not None else ServeStats()
        self.engine_stats = engine_stats if engine_stats is not None \
            else Stats()
        self.stats_lock = threading.Lock()
        self._active: List[_ActiveStream] = []
        self._buffers: Dict[Tuple[str, int, int], _FuseBuffer] = {}
        self._cdisps: Dict[int, Dispatcher] = {}
        self._ldisps: Dict[int, ListDispatcher] = {}
        self._arrivals = 0
        # load-shedding throughput estimate: recent (time, tiles) pull
        # samples over a sliding window.  The window (rather than a
        # lifetime tiles/elapsed ratio anchored at the first-ever pull)
        # keeps the rate honest across idle gaps: a service that sat
        # quiet for a minute would otherwise see its apparent throughput
        # decay toward zero and shed the first requests of the next burst
        self._rate_samples: "deque" = deque()
        self._rate_window_s = 30.0

    # -- dispatcher pools ---------------------------------------------------

    def _count_disp(self, l: int) -> Dispatcher:
        disp = self._cdisps.get(l)
        if disp is None:
            disp = Dispatcher(
                l, self.devices, et=True, backend=self.backend,
                async_staging=self.async_staging,
                max_inflight=self.max_inflight, stats=self.engine_stats,
            )
            self._cdisps[l] = disp
        return disp

    def _list_disp(self, l: int) -> ListDispatcher:
        disp = self._ldisps.get(l)
        if disp is None:
            disp = ListDispatcher(
                l, self.devices, sink=None, stats=self.engine_stats,
                capacity=self.capacity, max_capacity=self.max_capacity,
                backend=self.backend, async_staging=self.async_staging,
                max_inflight=self.max_inflight, et_t=ET_T,
            )
            self._ldisps[l] = disp
        return disp

    # -- lifecycle ----------------------------------------------------------

    @property
    def n_active(self) -> int:
        """Requests currently being pulled from (admitted, not exhausted)."""
        return len(self._active)

    def admit(self, req: Request) -> None:
        """Open a request's tile stream off the (cached) plan.

        The plan lookup is the only potentially heavy admission work
        (O(delta*m) on a cold graph); warm graphs hit the keyed plan
        cache and admission is O(selected tiles) index work.

        With ``shed_on_projected_miss`` enabled, a deadline-bearing
        request whose projected completion (backlog / observed tile
        throughput) already exceeds its deadline is rejected here with
        :class:`ServiceOverloaded` instead of admitted-to-miss.
        """
        req.mark_admitted()
        with trace.span("serve/admit", rid=req.rid, k=req.k, mode=req.mode):
            plan = pipeline.cached_plan(
                req.g, req.order, cache_dir=self.plan_cache_dir,
                stats=req.stats)
            table = plan.table(req.order)
            ids = table.select(req.k, use_rule2=req.use_rule2)
        self._maybe_shed(req, int(ids.size))
        req._on_isolated = self._count_isolated
        stream = pipeline.stream_batches(
            plan, req.k, order=req.order, use_rule2=req.use_rule2,
            batch_size=self.chunk_tiles, pack_workers=0, stats=req.stats)
        self._active.append(
            _ActiveStream(req, stream, int(ids.size), self._arrivals))
        self._arrivals += 1

    # -- scheduling ---------------------------------------------------------

    def _observe_tiles(self, n: int, now: Optional[float] = None) -> None:
        """Record ``n`` pulled tiles into the sliding rate window."""
        if now is None:
            now = time.monotonic()
        self._rate_samples.append((now, n))
        horizon = now - self._rate_window_s
        while self._rate_samples and self._rate_samples[0][0] < horizon:
            self._rate_samples.popleft()

    def _observed_rate(self, now: Optional[float] = None
                       ) -> Optional[float]:
        """Recent tile throughput (tiles/s), or None when untrustworthy.

        None -- and therefore permissive admission -- until the window
        holds at least ``fuse_rows`` tiles over a measurable span.  A
        cold service, or one whose last work fell out of the window
        during an idle stretch, admits rather than shedding on a stale
        or nonexistent estimate.
        """
        if now is None:
            now = time.monotonic()
        horizon = now - self._rate_window_s
        while self._rate_samples and self._rate_samples[0][0] < horizon:
            self._rate_samples.popleft()
        if not self._rate_samples:
            return None
        tiles = sum(n for _, n in self._rate_samples)
        if tiles < self.fuse_rows:
            return None
        elapsed = now - self._rate_samples[0][0]
        if elapsed <= 0:
            return None
        return tiles / elapsed

    def _maybe_shed(self, req: Request, new_tiles: int) -> None:
        """Reject a deadline-bearing request projected to miss (knob-gated).

        Uses the scheduler's own cost model: observed tile throughput
        over the sliding window against the backlog (active remaining
        tiles + this request's selected tiles).  Conservative by design:
        permissive until the window holds enough recent pulls to trust
        the rate -- a cold start or post-idle burst is never shed on a
        missing or stale estimate.
        """
        if not self.shed_on_projected_miss or req.deadline_t is None:
            return
        rate = self._observed_rate()
        if rate is None:
            return  # no trustworthy throughput estimate yet
        backlog = sum(a.remaining for a in self._active) + new_tiles
        projected = time.monotonic() + backlog / max(rate, 1e-9)
        if projected > req.deadline_t:
            with self.stats_lock:
                self.stats.shed += 1
                self.stats.rejected += 1
            trace.instant("serve/shed", rid=req.rid,
                          backlog=backlog, rate=round(rate, 1))
            raise ServiceOverloaded(
                f"projected completion {projected - req.deadline_t:.3f}s "
                f"past deadline (backlog {backlog} tiles at "
                f"{rate:.0f} tiles/s): request shed at admission")

    def _isolate(self, a: _ActiveStream, exc: BaseException) -> None:
        """Fail one active request in place; the scheduler keeps running."""
        try:
            a.stream.close()
        except Exception:
            pass
        if a in self._active:
            self._active.remove(a)
        self._note_isolated(a.req, exc)

    def _note_isolated(self, req: Request, exc: BaseException) -> None:
        req.fail(exc)
        self._count_isolated(req, exc)

    def _count_isolated(self, req: Request, exc: BaseException) -> None:
        with self.stats_lock:
            self.stats.isolated_failures += 1
        trace.instant("serve/isolate", rid=req.rid, error=repr(exc))

    def _cancel_expired(self, now: Optional[float] = None) -> None:
        """Cooperatively cancel deadline-enforced requests past expiry.

        The stream is closed (no further pulls), the request leaves the
        active set, and its ticket resolves with
        :class:`~repro_torch.serve.request.DeadlineExceeded` carrying partial
        results.  In-flight fused chunks it still owns are dropped by the
        sequencer's resolved-request guard.
        """
        if now is None:
            now = time.monotonic()
        for a in list(self._active):
            req = a.req
            if not req.enforce_deadline or req.deadline_t is None:
                continue
            if now < req.deadline_t:
                continue
            try:
                a.stream.close()
            except Exception:
                pass
            self._active.remove(a)
            if req.cancel_deadline(now):
                with self.stats_lock:
                    self.stats.deadline_cancels += 1
                trace.instant("serve/deadline_cancel", rid=req.rid)

    def _finish_stream(self, a: _ActiveStream) -> None:
        a.stream.close()
        self._active.remove(a)
        a.req.finish_feeding()

    def _pick(self) -> Optional[_ActiveStream]:
        # listing early stop: a full sink retires its request's stream
        for a in list(self._active):
            if a.req.full:
                self._finish_stream(a)
        if not self._active:
            return None
        i = edf_pick([(a.req.deadline_t, a.remaining, a.idx)
                      for a in self._active])
        return self._active[i]

    def step(self, now: Optional[float] = None) -> bool:
        """Pull one chunk from the EDF/LPT pick; True if progress was made.

        Oversize spill tiles are computed inline on the host and
        delivered immediately (through the owner's sequencer, so order
        holds); packed chunks accumulate in fuse buffers, flushed at
        ``fuse_rows`` or under deadline pressure.

        Failure containment: an exception out of one request's tile
        stream or spill compute isolates *that* request (its ticket
        resolves exceptionally) and scheduling continues -- one bad
        request never takes down its cotenants.
        """
        self._cancel_expired(now)
        self._flush_expiring(now)
        a = self._pick()
        if a is None:
            return False
        req = a.req
        try:
            item = next(a.stream)
        except StopIteration:
            self._finish_stream(a)
            return True
        except Exception as exc:  # per-request containment (stream died)
            self._isolate(a, exc)
            return True
        seq = req.next_seq()
        if isinstance(item, tiles_mod.Tile):
            a.remaining -= 1
            self._observe_tiles(1)
            with self.stats_lock:
                self.stats.spill_tiles += 1
            t0 = time.monotonic()
            try:
                if req.mode == "count":
                    with trace.span("spill/count", s=item.s, rid=req.rid):
                        payload = engine_torch.count_spilled(
                            item, req.order, req.l, req.stats, ET_T,
                            req.use_rule2)
                else:
                    payload = listing.list_spilled(
                        item, req.l, req.stats, et_t=ET_T)
            except Exception as exc:  # containment (host spill died)
                self._isolate(a, exc)
                return True
            req.add_stage("device", time.monotonic() - t0)
            req.deliver(seq, payload)
            return True
        a.remaining -= item.B
        self._observe_tiles(item.B)
        key = (req.mode, req.l, item.T)
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = _FuseBuffer(time.monotonic())
        buf.chunks.append((req, seq, item))
        buf.pull_ts.append(time.monotonic())
        buf.rows += item.B
        if buf.rows >= self.fuse_rows:
            self._flush(key)
        return True

    def _flush_expiring(self, now: Optional[float] = None) -> None:
        """Flush buffers under deadline pressure or past the age bound.

        A buffer flushes early when the earliest owner deadline is within
        ``flush_slack_s``, or when its first chunk has waited
        ``max_buffer_wait_s`` -- the bound on fusion-induced latency when
        no same-key chunk shows up to complete the batch.
        """
        if now is None:
            now = time.monotonic()
        for key in list(self._buffers):
            buf = self._buffers[key]
            if now + self.flush_slack_s >= buf.min_deadline():
                with self.stats_lock:
                    self.stats.deadline_flushes += 1
                self._flush(key)
            elif now - buf.created_t >= self.max_buffer_wait_s:
                self._flush(key)

    def _flush(self, key: Tuple[str, int, int]) -> None:
        buf = self._buffers.pop(key, None)
        if buf is None or not buf.chunks:
            return
        mode, l, _T = key
        flush_t = time.monotonic()
        for (req, _seq, _b), t_pull in zip(buf.chunks, buf.pull_ts):
            req.add_stage("fuse", flush_t - t_pull)
        fused, segments = fuse_chunks(buf.chunks)
        n_owners = len({id(r) for r, _, _, _, _ in segments})
        with self.stats_lock:
            self.stats.fused_batches += 1
            self.stats.fused_rows += fused.B
            self.stats.fused_chunks += len(segments)
            if n_owners > 1:
                self.stats.cross_request_batches += 1
        trace.instant(
            "serve/fuse_flush", mode=mode, l=l, T=fused.T,
            rows=fused.B, chunks=len(segments), owners=n_owners,
        )
        if mode == "count":

            def route(hard, nv, t, f, segments=segments, l=l,
                      flush_t=flush_t):
                dt = time.monotonic() - flush_t
                for req, seq, s0, s1, _ in segments:
                    # per-segment containment: one request's combine /
                    # delivery failure never poisons its batchmates
                    try:
                        payload = engine_torch.combine_counts(
                            hard[s0:s1], nv[s0:s1], t[s0:s1], f[s0:s1],
                            l, True)
                        req.add_stage("device", dt)
                        trace.async_instant(
                            "request/device", id=req.rid, seq=seq,
                            rows=s1 - s0)
                        req.deliver(seq, payload)
                    except Exception as exc:
                        self._note_isolated(req, exc)

            disp, token = self._count_disp(l), "count"
        else:

            def route(_batch, bufs, cnt, ovf, segments=segments, l=l,
                      flush_t=flush_t):
                dt = time.monotonic() - flush_t
                total = 0
                for req, seq, s0, s1, chunk in segments:
                    # per-segment containment (see the count route)
                    try:
                        rows = listing.decode_batch(
                            chunk, bufs[s0:s1], cnt[s0:s1], ovf[s0:s1], l,
                            req.stats, et_t=ET_T)
                        req.add_stage("device", dt)
                        trace.async_instant(
                            "request/device", id=req.rid, seq=seq,
                            rows=rows.shape[0])
                        req.deliver(seq, rows)
                        total += rows.shape[0]
                    except Exception as exc:
                        self._note_isolated(req, exc)
                return total

            disp, token = self._list_disp(l), "list"
        try:
            disp.submit(fused, route=route)
        except Exception as exc:
            # the dispatcher itself rejected the batch (past its own
            # retry/demotion ladder): fail the owners, keep the service up
            trace.instant("serve/submit_failed", mode=token, error=repr(exc))
            for req in {id(r): r for r, _, _, _, _ in segments}.values():
                self._note_isolated(req, exc)

    def flush_all(self) -> None:
        """Flush every fuse buffer (stream exhaustion / idle / shutdown)."""
        for key in list(self._buffers):
            self._flush(key)

    def drain(self) -> None:
        """Block until all in-flight device work has routed to requests."""
        for disp in self._cdisps.values():
            disp.drain()
        for disp in self._ldisps.values():
            disp.drain()

    def finish(self) -> None:
        """Tear the dispatchers down (decode workers, compile accounting)."""
        self.flush_all()
        for disp in self._cdisps.values():
            disp.finish()
        for disp in self._ldisps.values():
            disp.finish()

    def fail_active(self, exc: BaseException) -> None:
        """Resolve every active request exceptionally (scheduler error)."""
        for a in list(self._active):
            try:
                a.stream.close()
            except Exception:
                pass
            a.req.fail(exc)
        self._active.clear()
        self._buffers.clear()
