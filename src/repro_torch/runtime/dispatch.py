"""Multi-lane dispatch for the streaming tile pipeline.

The port of ``repro/runtime/dispatch.py``.  The edge-oriented branching of
EBBkC makes the tile stream embarrassingly parallel: every packed
``TileBatch`` is an independent device call, so running past one device
queue is a placement and staging problem.  A **lane** is one (device,
``torch.cuda.Stream``) pair; the reference's devices become lanes:

* **Per-lane dispatch** (default): each batch is staged on one lane
  (pinned host memory, a non-blocking copy on the lane's stream) and
  counted there by ``engine_torch.count_packed``, whose kernels launch on
  the lane's stream.  Placement is *online LPT* -- each arriving batch
  goes to the least-loaded lane under the scheduler cost model -- or
  *offline LPT* via :func:`dispatch_scheduled`, which maps precomputed
  scheduler bins one-to-one onto lanes.  A device may appear more than
  once in the lane list: ``["cuda:0", "cuda:0"]`` is two concurrent
  streams on one card, ``["cpu"] * 4`` four CPU lanes (they run inline,
  one after another, as the reference's virtual CPU devices do).
* **Row-sharded path** (``mesh=``): the reference's ``shard_map`` step
  has no torch counterpart, so ``mesh`` is a sequence of lanes: each
  batch is zero-padded to a multiple of the lane count, split by rows,
  one shard a lane, and the host concatenates the partials and combines
  them exactly.  Counting only, as in the reference.
* **Double-buffered staging**: with ``async_staging=True`` (default) up to
  ``max_inflight`` batches per lane stay un-harvested, so the host packs
  batch i+1 while the card runs batch i.  Each launch copies its partials
  back with a non-blocking copy on its stream and records a CUDA event
  behind it; the harvest waits on that event.  The overlapped seconds go
  to ``Stats.staging_overlap_s``.

Counts are exact and invariant to lane count, placement and staging mode:
every step returns (hard, nv, t, f) partials and the host reduces them in
int64 (including the Section 5.1 early-termination closed form).

Observability, as in the reference: the ``kernel/compile`` span around
the CUDA library's build at first use (``Stats.kernel_compile_s``),
``device/stage``, ``device/harvest`` (with the batch's kernel signature,
flops and bytes) and ``combine`` on the counting side; ``device/stage``,
``device/sizing``, ``device/wait``, ``device/relist`` and ``decode`` on
the listing side; ``obs.profile.note_kernel`` for the build and for every
harvest (``execute_s`` is the host's blocked seconds, not device time).

Resilience, as in the reference, with two deliberate differences.  The
``device.stage`` and ``kernel.launch`` fault sites fire before every
launch, ``device.harvest``, ``decode`` and ``sink.write`` are absorbed in
place (``fault_retry.consume``), and a launch that meets an injected fault
is retried under ``fault_retry.DEFAULT_POLICY``, keeping its batch's FIFO
position (``Stats.retries``).  What happens once the policy is used up
depends on the lane (:meth:`_Lanes._run`).  On a CUDA lane the fault
raises out of ``submit`` / ``finish``: the card's work never moves to a
plain version or to the host.  On a CPU lane, where the kernel wrapper
is the plain version anyway, the batch goes down the reference's ladder
(``fault_retry.COUNT_LADDER`` / ``LIST_LADDER``, each rung retried in
turn) to the host recursion -- ``count_rec_C`` partials for counting,
``listing.host_list_triple`` for listing -- so counts and rows never
change (``Stats.demotions``).  And unlike the reference, which retries
and demotes on any ``Exception``, only ``inject.FaultInjected`` is
retried or demoted here: a real failure -- a failed build, a refused
launch, a device fault -- raises at once.

Left out of this port: ``engine_jax.bucket_rows``, deliberately (an eager
CUDA launch compiles nothing per shape), and ``kops.consume_compile_s`` /
``drain_tune_events`` (A6).
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Deque, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..convert import batch_to_torch
from ..core import engine_torch, listing, pipeline
from ..core.engine_np import Stats
from ..core.engine_np import count_rec_C
from ..kernels import _build
from ..kernels import ops as kops
from ..obs import profile as obs_profile
from ..obs import trace
from ..resilience import inject
from ..resilience import retry as fault_retry
from .clique_scheduler import schedule_batches, tile_costs

DeviceSpec = Union[None, int, str, Sequence]


def resolve_devices(devices: DeviceSpec = None) -> List[torch.device]:
    """Normalize a ``devices=`` knob to a concrete lane device list.

    ``None`` / ``"all"`` -> every visible CUDA device; an int n -> the
    first min(n, available) CUDA devices; both raise without CUDA.  A
    sequence is passed through entry by entry as ``torch.device``s,
    repeats allowed (each entry is a lane with its own stream).  A CUDA
    entry raises without CUDA: no lane falls back to the CPU.
    """
    if devices is None or devices == "all" or isinstance(devices, int):
        if isinstance(devices, int) and devices < 1:
            raise ValueError("devices must be >= 1")
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                f"devices={devices!r} asks for CUDA devices and none is "
                "available; pass CPU lanes (e.g. devices=[\"cpu\"] * 2) to "
                "run the plain torch versions")
        avail = [torch.device("cuda", i) for i in range(n)]
        return avail if not isinstance(devices, int) else avail[:devices]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("empty device list")
    if any(d.type == "cuda" for d in devs) and not torch.cuda.is_available():
        raise RuntimeError("a CUDA lane was asked for and no CUDA device is "
                           "available")
    return devs


def batch_flops(n_tiles: int, T: int) -> int:
    """The reference's MXU-equivalent flop model of one packed batch
    (dense-tile matmul); kept so ``Stats.device_flops`` reads the same."""
    return int(n_tiles) * 2 * int(T) ** 3


def batch_bytes(n_tiles: int, T: int) -> int:
    """Bytes staged to a lane per packed tile: the (T, W) uint32 adjacency
    bitset plus the (W,) candidate mask (W = T/32)."""
    W = int(T) // 32
    return int(n_tiles) * (int(T) * W + W) * 4


def _account_devices(stats: Stats, per_device_tiles, T: int) -> None:
    """Fold one batch's per-lane tile counts into ``stats`` through
    ``Stats.merge`` (the single accounting path of both dispatchers)."""
    delta = Stats()
    for d, c in enumerate(per_device_tiles):
        if not c:
            continue
        delta.device_tiles[d] = int(c)
        delta.device_flops[d] = batch_flops(int(c), T)
        delta.device_bytes[d] = batch_bytes(int(c), T)
    stats.merge(delta)


def _pad_rows(x: np.ndarray, multiple: int) -> np.ndarray:
    """Zero-pad axis 0 of ``x`` up to a multiple of ``multiple``.

    Padding rows have ``cand == 0`` (no candidate vertices), which
    contributes exactly 0 to both the kernel and the closed-form count for
    every l >= 1, so padded and unpadded batches agree.
    """
    pad = (-x.shape[0]) % multiple
    if not pad:
        return x
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])


class Lane:
    """One (device, stream) pair: the unit a batch is placed on.

    A CUDA lane owns a ``torch.cuda.Stream`` of its own, so two lanes on
    one card run concurrently; a CPU lane has none, and its work runs
    inline when it is launched.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def context(self):
        """Make this lane's device and stream current for the calling
        thread (both are thread-local in torch): every staging copy,
        kernel and copy back inside it is enqueued on the lane's stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def to_host(self, tensors) -> Tuple[Optional[torch.cuda.Event], tuple]:
        """Copy ``tensors`` back to the host without blocking, on this
        lane's stream, and record an event behind the copies.

        Returns (event, host tensors); the host tensors (pinned) hold the
        values once the event has completed.  On the CPU the tensors are
        returned as they are, with no event.  The event is a blocking-sync
        one, so a thread that waits on it sleeps instead of spinning a
        core the pack threads need.
        """
        if self.stream is None:
            return None, tuple(tensors)
        with self.context():
            host = tuple(x.to("cpu", non_blocking=True) for x in tensors)
            event = torch.cuda.Event(blocking=True)
            event.record(self.stream)
        return event, host


def _is_ready(event) -> bool:
    """Non-blocking readiness probe of a launch: True when the event
    recorded behind it (on its lane's stream) has completed, or when
    there is none (a CPU lane ran it inline)."""
    return event is None or event.query()


def _wait(event) -> None:
    """Block until ``event`` has completed (no-op for a CPU lane)."""
    if event is not None:
        event.synchronize()


@dataclasses.dataclass
class Routed:
    """One item of a multi-request stream: a pipeline item plus its route.

    Wrap ``pipeline.TileBatch`` / oversize ``Tile`` items in ``Routed``
    to interleave several logical requests through one dispatcher
    ``consume`` call.  ``route`` is forwarded verbatim: for a
    ``TileBatch`` it becomes the ``route=`` callback of ``submit`` (so
    this batch's results bypass the dispatcher-global accumulator/sink
    and are delivered to the owning request instead); for a spill tile it
    is passed as a second argument to ``on_spill``.  Bare (unwrapped)
    items keep the single-request behavior, so the two styles can mix in
    one stream.
    """

    item: object
    route: object = None


def _consume_stream(disp, stream, on_spill, stop=None) -> Tuple[int, int]:
    """Shared stream-consumption loop of both dispatchers' ``consume``.

    Submits packed batches, routes oversize spill tiles to ``on_spill``,
    and stops early when ``stop()`` turns true (the listing sink's
    ``full``).  Items may be wrapped in :class:`Routed`.  Returns (tiles
    consumed, max tile width).
    """
    ntiles = 0
    max_tile = 0
    for item in stream:
        if stop is not None and stop():
            break
        route = None
        if isinstance(item, Routed):
            item, route = item.item, item.route
        if isinstance(item, pipeline.TileBatch):
            ntiles += item.B
            max_tile = max(max_tile, item.T)
            disp.submit(item, route=route)
            continue
        if on_spill is None:
            raise ValueError("oversize tile in stream but no on_spill "
                             "handler given")
        ntiles += 1
        max_tile = max(max_tile, item.s)
        if route is None:
            on_spill(item)
        else:
            on_spill(item, route)
    return ntiles, max_tile


class _Lanes:
    """What both dispatchers share: the lanes, the online-LPT loads, the
    one-time build of the CUDA kernel library, and the fault policy with
    its accounting."""

    #: the kernel family in this dispatcher's signatures ("count"/"list")
    _op = ""

    def __init__(self, l: int, devices: List[torch.device], stats: Stats):
        if l < 1:
            raise ValueError("dispatch requires l >= 1 (k >= 3)")
        self.l = l
        self.devices = devices
        self.lanes = [Lane(d) for d in devices]
        self.stats = stats
        self.stats.backend = "torch:" + "+".join(
            sorted({d.type for d in devices}))
        self.tiles = 0
        self.placements: List[int] = []
        self._loads = np.zeros(len(devices))
        self._built = False
        # stats are written by the submitting thread and, in listing, by
        # the decode worker
        self._acct_lock = threading.Lock()

    @property
    def n_devices(self) -> int:
        """Number of lanes this dispatcher places batches on."""
        return len(self.lanes)

    def _sig(self, B: int, T: int) -> str:
        """Kernel-signature label for profiling attribution (the
        reference's ``count[l=..,T=..,B=..,backend=..]``)."""
        return (f"{self._op}[l={self.l},T={T},B={B},"
                f"backend={self.stats.backend}]")

    def _build_once(self, batch: pipeline.TileBatch) -> None:
        """Build (or load) the CUDA kernel library before the first CUDA
        launch, billing the seconds to ``Stats.kernel_compile_s`` and to
        the first batch's kernel signature; a failed build raises here,
        out of ``submit``."""
        if self._built or all(ln.stream is None for ln in self.lanes):
            return
        sig = self._sig(batch.B, batch.T)
        t0 = time.perf_counter()
        with trace.span("kernel/compile", sig=sig):
            _build.lib()
        dt = time.perf_counter() - t0
        self.stats.kernel_compile_s += dt
        obs_profile.note_kernel(sig, compile_s=dt)
        self._built = True

    def _note_retry(self, attempt: int, exc: BaseException) -> None:
        """Per-batch attempt accounting (``fault_retry.call`` on_retry),
        from the submitting thread or the decode worker."""
        with self._acct_lock:
            self.stats.retries += 1
        trace.instant("resilience/retry", attempt=attempt,
                      error=type(exc).__name__)

    def _note_demotion(self, frm: str, to: Optional[str],
                       exc: BaseException) -> None:
        """Count one rung of the backend ladder given up."""
        with self._acct_lock:
            self.stats.demotions += 1
        trace.instant("resilience/demote", frm=frm, to=to or "host",
                      error=type(exc).__name__)

    def _run(self, on_card: bool, mode: str, launch, host, token: str):
        """``launch()`` under the fault policy; returns its result or, on
        CPU lanes whose ladder gave up, ``host()``'s.

        An injected fault is retried under ``fault_retry.DEFAULT_POLICY``.
        With ``on_card`` the fault raises once the policy is used up.
        Otherwise each rung of the ``mode`` ladder ("count" or "list") is
        retried in turn -- on a CPU lane every rung runs the same plain
        version -- and then ``host()`` finishes the batch.  Any other
        exception propagates at once."""
        if on_card:
            return fault_retry.call(launch, token=token,
                                    on_retry=self._note_retry)
        rung: Optional[str] = (fault_retry.COUNT_LADDER if mode == "count"
                               else fault_retry.LIST_LADDER)[0]
        while rung is not None:
            try:
                return fault_retry.call(launch, token=token,
                                        on_retry=self._note_retry)
            except inject.FaultInjected as exc:
                nxt = fault_retry.demote(mode, rung)
                self._note_demotion(rung, nxt, exc)
                rung = nxt
        return host()

    def _place(self, batch: pipeline.TileBatch, device: Optional[int]) -> int:
        """Online LPT (least-loaded lane under the scheduler cost model),
        or the forced ``device``; adds the batch's cost to that lane."""
        d = int(np.argmin(self._loads)) if device is None else int(device)
        self._loads[d] += float(tile_costs(batch.sizes, batch.nedges,
                                           self.l).sum())
        return d


@dataclasses.dataclass
class _InFlight:
    """One staged batch awaiting harvest: its host partials (one tuple a
    shard) and the events behind their copies back."""

    device: int  # lane index; -1 for the row-sharded path
    events: list
    parts: list
    rows: int = 0  # un-padded batch rows (slice bound for routed harvest)
    route: object = None  # per-request delivery callback, or None
    T: int = 0  # tile width (kernel-signature attribution)


class Dispatcher(_Lanes):
    """Streams packed tile batches across lanes and counts them.

    See the module docstring for the execution model.  Typical use::

        disp = Dispatcher(l, devices=["cuda:0", "cuda:0"], stats=stats)
        for item in pipeline.stream_batches(plan, k):
            if isinstance(item, pipeline.TileBatch):
                disp.submit(item)
            else:
                ...  # spill to host recursion
        total = disp.finish()
    """

    _op = "count"

    def __init__(
        self,
        l: int,
        devices: DeviceSpec = None,
        *,
        mesh: Optional[Sequence] = None,
        et: bool = True,
        method: str = "auto",
        async_staging: bool = True,
        max_inflight: int = 2,
        stats: Optional[Stats] = None,
        stage_times: Optional[dict] = None,
    ):
        super().__init__(l, resolve_devices(devices if mesh is None
                                            else mesh),
                         stats if stats is not None else Stats())
        self.et = et
        self.method = method
        self.mesh = mesh
        self._n_shards = self.n_devices if mesh is not None else 1
        self.async_staging = async_staging
        self.max_inflight = max(1, int(max_inflight))
        self.stage_times = stage_times
        self.total = 0
        self._inflight: Deque[_InFlight] = collections.deque()
        self._overlap_mark = 0.0

    def _launch(self, A: np.ndarray, cand: np.ndarray, lane: Lane):
        """Stage one (shard of a) batch on ``lane``, launch its count step
        and its copy back; returns (event, host partials).  Fires the
        ``device.stage`` and ``kernel.launch`` fault sites."""
        with lane.context():
            inject.fire("device.stage")
            tA, tc = batch_to_torch(A, cand, lane.device)
            inject.fire("kernel.launch")
            out = engine_torch.count_packed(tA, tc, self.l,
                                            method=self.method, et=self.et)
            return lane.to_host(out)

    def _host_partials(self, batch: pipeline.TileBatch):
        """Count ``batch`` on the host recursion (a CPU lane's last rung).

        Returns numpy ``(hard, nv, t, f)`` partials that
        ``engine_torch.combine_counts`` finishes to the exact same totals
        as a device step: ``hard`` carries the true per-tile count and
        ``t`` is pinned above the 2-plex threshold, so the
        early-termination closed form adds nothing.
        """
        hard = np.zeros(batch.B, dtype=np.int64)
        for b in range(batch.B):
            s = int(batch.sizes[b])
            rows = listing._rows_from_packed(batch.A[b], s)
            hard[b] = count_rec_C(rows, (1 << s) - 1, self.l, self.stats)
        zeros = np.zeros(batch.B, dtype=np.int64)
        return hard, zeros, np.full(batch.B, 3, dtype=np.int64), zeros

    def submit(
        self,
        batch: pipeline.TileBatch,
        device: Optional[int] = None,
        route=None,
    ) -> None:
        """Stage one packed batch and launch its count step (non-blocking).

        ``device`` forces a placement on that lane index (offline
        scheduling); otherwise the batch goes to the least-loaded lane
        under the scheduler cost model (online LPT).

        ``route``, when given, redirects this batch's results: at harvest
        the per-tile partials, sliced back to the batch's un-padded ``B``
        rows, are passed to ``route(hard, nv, t, f)`` as int64 numpy
        arrays instead of being folded into ``self.total`` (use
        ``engine_torch.combine_counts`` on any row segment to finish them
        exactly).  Routes run on the thread that triggers the harvest.

        Thread safety: all ``submit``/``drain``/``finish`` calls must come
        from one thread.

        Resilience: a stage or launch that meets an injected fault is
        retried in place (:meth:`_Lanes._run`; a row-sharded batch as a
        whole), so the batch keeps its FIFO position.
        """
        with trace.span("device/stage", B=batch.B, T=batch.T):
            self._build_once(batch)
            if self.mesh is not None:
                d = -1
                n = self._n_shards
                A = _pad_rows(batch.A, n)
                cand = _pad_rows(batch.cand, n)
                shard_rows = A.shape[0] // n

                def launch():
                    events, parts = [], []
                    for i, lane in enumerate(self.lanes):
                        rows = slice(i * shard_rows, (i + 1) * shard_rows)
                        event, host = self._launch(A[rows], cand[rows], lane)
                        events.append(event)
                        parts.append(host)
                    return events, parts

                events, parts = self._run(
                    any(ln.stream is not None for ln in self.lanes), "count",
                    launch, lambda: ([None], [self._host_partials(batch)]),
                    "count.mesh")
                per_dev = np.bincount(
                    np.minimum(np.arange(batch.B) // shard_rows, n - 1),
                    minlength=n,
                )
            else:
                d = self._place(batch, device)
                lane = self.lanes[d]
                event, host = self._run(
                    lane.stream is not None, "count",
                    lambda: self._launch(batch.A, batch.cand, lane),
                    lambda: (None, self._host_partials(batch)),
                    "count.launch")
                events, parts = [event], [host]
                per_dev = np.zeros(self.n_devices, dtype=np.int64)
                per_dev[d] = batch.B
        self.placements.append(d)
        self.tiles += batch.B
        _account_devices(self.stats, per_dev, batch.T)
        if not self._inflight:
            # in-flight window (re)opens now; overlap accrues from here
            self._overlap_mark = time.perf_counter()
        self._inflight.append(_InFlight(d, events, parts, batch.B, route,
                                        batch.T))
        if not self.async_staging:
            self._drain()
        else:
            while len(self._inflight) > self.max_inflight * self.n_devices:
                self._harvest_one()

    def _harvest_one(self) -> None:
        p = self._inflight.popleft()
        t0 = time.perf_counter()
        # wall time since the last accounting mark during which work was in
        # flight and the host was free (packing / combining, not blocked):
        # an upper bound on the device execution hidden behind host work.
        # Synchronous staging hides nothing by construction.
        if self.async_staging:
            self.stats.staging_overlap_s += max(0.0, t0 - self._overlap_mark)
        sig = self._sig(p.rows, p.T)
        flops, nbytes = batch_flops(p.rows, p.T), batch_bytes(p.rows, p.T)
        with trace.span("device/harvest", device=p.device, sig=sig,
                        flops=flops, bytes=nbytes):
            # an injected harvest fault is pure (the staged result still
            # exists) and is absorbed in place; a real wait failure raises
            fault_retry.consume("device.harvest", on_retry=self._note_retry)
            for event in p.events:
                _wait(event)
            out = [np.concatenate([np.asarray(part[i]) for part in p.parts])
                   for i in range(4)]
        t1 = time.perf_counter()
        obs_profile.note_kernel(sig, execute_s=t1 - t0, calls=1, flops=flops,
                                nbytes=nbytes)
        self._overlap_mark = t1  # blocked interval [t0, t1] is not overlap
        with trace.span("combine", routed=p.route is not None):
            if p.route is None:
                self.total += engine_torch.combine_counts(*out, self.l,
                                                          self.et)
            else:
                # padding appends rows, so a head slice removes it
                p.route(*(x[: p.rows].astype(np.int64) for x in out))
        t2 = time.perf_counter()
        if self.stage_times is not None:
            st = self.stage_times
            st["device"] = st.get("device", 0.0) + (t1 - t0)
            st["combine"] = st.get("combine", 0.0) + (t2 - t1)

    def _drain(self) -> None:
        while self._inflight:
            self._harvest_one()

    def consume(self, stream, on_spill=None) -> Tuple[int, int]:
        """Drive this dispatcher from a ``pipeline.stream_batches`` iterator.

        Submits packed batches and routes oversize spill tiles to
        ``on_spill`` (routed spills call ``on_spill(tile, route)``).
        Returns (tiles consumed, max tile width); call :meth:`finish`
        (one-shot) or :meth:`drain` (long-lived service) afterwards.
        """
        return _consume_stream(self, stream, on_spill)

    def drain(self) -> None:
        """Block until every submitted batch is harvested (routes
        included); the dispatcher stays usable."""
        self._drain()

    def finish(self) -> int:
        """Drain all in-flight work; returns the accumulated exact count
        (routed batches are not part of it)."""
        self._drain()
        return self.total


#: initial emit-buffer rows for the speculative capacity ratchet (pow2;
#: small enough that a wrong first guess wastes little, large enough that
#: sparse tile batches never retry)
SPECULATIVE_CAP0 = 64


class ListDispatcher(_Lanes):
    """Emit-mode twin of :class:`Dispatcher` for the listing subsystem.

    Streams packed tile batches across lanes and harvests (buffer, count,
    overflow) triples.  Three capacity modes size the per-tile emit
    buffer:

    * ``capacity=None`` / ``"sized"`` (default) -- exact per-batch sizing
      by a pipelined count pass: ``submit`` launches the count pass (and
      the copy of its counts back) on the lane and queues the batch as
      *pending*; the list kernel is launched as soon as that batch's
      counts land on the host (probed non-blockingly by :func:`_is_ready`
      on the event behind the copy, each submit, or forced when the
      in-flight window fills).  Minimal buffer memory, two device passes.
    * ``capacity="speculative"`` -- the list kernel launches immediately
      at a per-tile-width capacity ratchet (the pow2 ceiling of every true
      count seen so far for that T, starting at ``SPECULATIVE_CAP0``).
      The kernel always returns true counts, so a guess that proves too
      small is listed once more on the device at the exact pow2 size
      (``Stats.emit_retries``) -- the rows are identical, only the work
      moves.
    * ``capacity=<int>`` -- pinned buffer; overflowed tiles are relisted
      on the host (never truncated), as always.

    Ordering guarantee: pending batches are promoted strictly FIFO,
    harvested strictly FIFO, and decoded/emitted by **one** decode-worker
    thread consuming a FIFO queue, so decoded rows reach the sink in
    batch order no matter how many lanes ran them or how staging
    overlapped.  The decode worker also owns the blocking wait for each
    triple (on the event behind its copy back, which was enqueued on the
    lane's stream at launch), so decode, overflow relists and sink writes
    overlap both device execution and the consumer thread's work.  The
    speculative retry is the one launch the worker makes, inside its
    batch's lane context.  The decode backlog is bounded
    (``max_inflight * n_devices`` jobs) because each job pins its device
    buffers.

    Resilience: staging and every launch (the sizing count pass, the list
    kernel, the speculative retry) meet the fault sites and are retried in
    place (:meth:`_Lanes._run`).  On a CPU lane a batch whose staging,
    sizing or list launch gave up is listed by
    ``listing.host_list_triple`` in its FIFO slot, so the decoded rows are
    byte-identical to a fault-free run; on a CUDA lane the fault raises.
    """

    _op = "list"

    def __init__(
        self,
        l: int,
        devices: DeviceSpec = None,
        *,
        sink=None,
        stats: Optional[Stats] = None,
        capacity=None,
        max_capacity: Optional[int] = None,
        et_t: int = 3,
        async_staging: bool = True,
        max_inflight: int = 2,
        stage_times: Optional[dict] = None,
    ):
        if isinstance(capacity, str) and capacity not in ("sized",
                                                          "speculative"):
            raise ValueError(f"capacity must be None, 'sized', "
                             f"'speculative', or an int, got {capacity!r}")
        super().__init__(l, resolve_devices(devices),
                         stats if stats is not None else Stats())
        self.sink = sink
        self.capacity = capacity
        self.max_capacity = (listing.MAX_CAPACITY if max_capacity is None
                             else int(max_capacity))
        # speculative mode: pow2 capacity ratchet per tile width.  Written
        # by the decode worker (true counts), read by submit; a stale read
        # is harmless -- it only costs one device retry.
        self._cap_ratchet: dict = {}
        self.et_t = et_t
        self.async_staging = async_staging
        self.max_inflight = max(1, int(max_inflight))
        self.stage_times = stage_times
        # count pass in flight, list kernel not yet launched (FIFO)
        self._pending: Deque[tuple] = collections.deque()
        # list kernel in flight, not yet harvested (FIFO)
        self._inflight: Deque[tuple] = collections.deque()
        # ONE decode worker: a single worker consuming a FIFO queue keeps
        # the sink order deterministic by construction
        self._decode_ex = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="emit-decode"
        )
        self._decoding: Deque[concurrent.futures.Future] = collections.deque()
        self._decode_depth = max(2, self.max_inflight * self.n_devices)

    def _add_time(self, key: str, amount) -> None:
        """Add to ``stage_times[key]`` (seconds, or bytes for
        ``"d2h_bytes"``) from either thread."""
        if self.stage_times is not None:
            with self._acct_lock:
                st = self.stage_times
                st[key] = st.get(key, 0) + amount

    def _stage(self, batch: pipeline.TileBatch, lane: Lane):
        """Fire the stage site and copy the batch onto ``lane``."""
        inject.fire("device.stage")
        with lane.context():
            return batch_to_torch(batch.A, batch.cand, lane.device)

    def _count_pass(self, lane: Lane, A: torch.Tensor, cand: torch.Tensor):
        """Fire the launch site and start the sizing count pass, with the
        copy of its counts back; returns (event, (host counts,))."""
        inject.fire("kernel.launch")
        with lane.context():
            return lane.to_host((kops.count_tiles(A, cand, self.l),))

    def _list(self, lane: Lane, A: torch.Tensor, cand: torch.Tensor,
              cap: int):
        """Fire the launch site, launch one list kernel at capacity ``cap``
        on ``lane`` and the copy of its triple back; returns (event, host
        triple).  Called by the consumer thread and, for the speculative
        retry, the decode worker: either way inside the lane's device and
        stream."""
        inject.fire("kernel.launch")
        with lane.context():
            return lane.to_host(kops.list_tiles(A, cand, self.l, cap))

    def _host_list(self, batch: pipeline.TileBatch):
        """A CPU lane's host rung: (no event, the batch's triple from
        ``listing.host_list_triple``, the host recursion in the kernel's
        emission order), so it decodes byte-identically."""
        return None, listing.host_list_triple(batch, self.l)

    def _launch_list(self, batch: pipeline.TileBatch, lane: Lane,
                     acand: tuple, cap: int):
        """One list launch on the staged (A, cand) ``acand``; returns
        (event, triple)."""
        return self._run(lane.stream is not None, "list",
                         lambda: self._list(lane, *acand, cap),
                         lambda: self._host_list(batch), "list.launch")

    def submit(
        self,
        batch: pipeline.TileBatch,
        device: Optional[int] = None,
        route=None,
    ) -> None:
        """Stage one batch and launch its (first) device pass.

        ``device`` forces a placement on that lane index (offline
        scheduling); otherwise online LPT picks the least-loaded lane.

        ``route``, when given, replaces the default decode-and-emit for
        this batch: on the decode worker, ``route(batch, bufs, cnt, ovf)``
        receives the raw listing triple as numpy arrays and must return
        the number of rows it emitted (use ``listing.decode_batch`` to
        materialize them).  Routed batches never touch ``self.sink``
        (which may then be None).  Routes run on the single decode worker
        in strict FIFO batch order.

        Thread safety: all ``submit``/``drain``/``finish`` calls must
        come from one thread; routes run on the decode worker thread.
        """
        if route is None and self.sink is None:
            raise ValueError("emit mode requires a CliqueSink (or per-"
                             "batch route callbacks)")
        with trace.span("device/stage", B=batch.B, T=batch.T):
            self._build_once(batch)
            d = self._place(batch, device)
            self.placements.append(d)
            self.tiles += batch.B
            per_dev = np.zeros(self.n_devices, dtype=np.int64)
            per_dev[d] = batch.B
            with self._acct_lock:
                _account_devices(self.stats, per_dev, batch.T)
            lane = self.lanes[d]
            on_card = lane.stream is not None
            # None: a CPU lane's staging (or sizing) gave up, and the host
            # lists the batch in its FIFO slot
            acand = self._run(on_card, "list",
                              lambda: self._stage(batch, lane), lambda: None,
                              "list.stage")
            if self.capacity is None or self.capacity == "sized":
                # async count pass; readiness is probed at promotion time
                staged = None
                if acand is not None:
                    staged = self._run(
                        on_card, "count",
                        lambda: (acand, self._count_pass(lane, *acand)),
                        lambda: None, "list.sizing")
                self._pending.append((d, batch, staged, route))
            else:
                if self.capacity == "speculative":  # ratchet guess
                    cap = min(self._cap_ratchet.get(batch.T,
                                                    SPECULATIVE_CAP0),
                              self.max_capacity)
                else:
                    cap = max(1, int(self.capacity))
                out = (self._host_list(batch) if acand is None
                       else self._launch_list(batch, lane, acand, cap))
                self._inflight.append((d, batch, acand, out, route))
        self._promote(block=False)
        if not self.async_staging:
            self._drain()
        else:
            while (
                len(self._pending) + len(self._inflight)
                > self.max_inflight * self.n_devices
            ):
                self._harvest_one()

    def _promote(self, block: bool) -> None:
        """Launch list kernels for pending count-sized batches, strictly
        FIFO (``capacity="sized"`` mode only; the other modes launch in
        ``submit``).

        With ``block=False`` only batches whose count pass already landed
        are promoted; ``block=True`` forces at least the queue head
        through (used when the harvest side runs dry).
        """
        while self._pending:
            d, batch, staged, route = self._pending[0]
            if staged is None:
                self._pending.popleft()
                self._inflight.append((d, batch, None,
                                       self._host_list(batch), route))
                block = False
                continue
            acand, (event, (hard,)) = staged
            if not block and not _is_ready(event):
                break
            t0 = time.perf_counter()
            with trace.span("device/sizing", B=batch.B, T=batch.T):
                _wait(event)  # blocks only until THIS batch's counts land
                counts = np.asarray(hard)
            self._add_time("device", time.perf_counter() - t0)
            self._pending.popleft()
            cap = listing.capacity_for(counts, self.max_capacity)
            out = self._launch_list(batch, self.lanes[d], acand, cap)
            self._inflight.append((d, batch, acand, out, route))
            block = False  # only the head is ever forced

    def _decode_job(self, d: int, batch: pipeline.TileBatch, acand: tuple,
                    out: tuple, route=None) -> None:
        """Run one decode job on the decode worker.

        Waits for the triple's copy back, retries a too-small speculative
        guess on the batch's lane, then either decodes to global rows
        (overflow relists included) and feeds the sink, or hands the
        triple to the batch's ``route``.  Only this thread touches the
        sink, ``overflowed_tiles`` and ``emitted_cliques``' rows, so FIFO
        submission is deterministic sink order with no further
        synchronization."""
        t0 = time.perf_counter()
        sig = self._sig(batch.B, batch.T)
        flops = batch_flops(batch.B, batch.T)
        nbytes = batch_bytes(batch.B, batch.T)
        event, triple = out
        with trace.span("device/wait", sig=sig, flops=flops, bytes=nbytes):
            # an injected harvest fault is pure and absorbed in place; a
            # real wait failure raises
            fault_retry.consume("device.harvest", on_retry=self._note_retry)
            _wait(event)
            bufs, cnt, ovf = (np.asarray(x) for x in triple)
        if self.capacity == "speculative":
            # the kernel reported true counts, so a too-small guess is
            # listed once more on the device at the exact rounded size --
            # identical triples, never a host relist unless the true count
            # exceeds max_capacity (as in every mode)
            true_cap = listing.capacity_for(cnt, self.max_capacity)
            self._cap_ratchet[batch.T] = max(
                self._cap_ratchet.get(batch.T, 1), true_cap
            )
            if ovf.any() and true_cap > bufs.shape[1]:
                with trace.span("device/relist", B=batch.B, T=batch.T,
                                capacity=true_cap):
                    event, triple = self._launch_list(
                        batch, self.lanes[d], acand, true_cap)
                    _wait(event)
                    bufs, cnt, ovf = (np.asarray(x) for x in triple)
                with self._acct_lock:
                    self.stats.emit_retries += 1
        t1 = time.perf_counter()
        obs_profile.note_kernel(sig, execute_s=t1 - t0, calls=1, flops=flops,
                                nbytes=nbytes)
        relist: dict = {}
        fault_retry.consume("decode", on_retry=self._note_retry)
        with trace.span("decode", B=batch.B, T=batch.T,
                        routed=route is not None):
            if route is not None:
                emitted = int(route(batch, bufs, cnt, ovf))
                t2 = time.perf_counter()
            else:
                arr = listing.decode_batch(batch, bufs, cnt, ovf, self.l,
                                           self.stats, et_t=self.et_t,
                                           stage_times=relist)
                t2 = time.perf_counter()
                fault_retry.consume("sink.write", on_retry=self._note_retry)
                emitted = self.sink.emit(arr)
        t3 = time.perf_counter()
        with self._acct_lock:
            self.stats.emitted_cliques += emitted
        self._add_time("device", t1 - t0)
        self._add_time("decode", t2 - t1)
        if relist:
            self._add_time("relist", relist["relist"])
        self._add_time("emit", t3 - t2)
        self._add_time("d2h_bytes", bufs.nbytes + cnt.nbytes + ovf.nbytes)

    def emit_rows(self, arr: np.ndarray) -> None:
        """Enqueue host-produced rows (spill tiles) through the decode
        worker, keeping their FIFO position relative to batch decodes."""

        def job() -> None:
            fault_retry.consume("sink.write", on_retry=self._note_retry)
            emitted = self.sink.emit(arr)
            with self._acct_lock:
                self.stats.emitted_cliques += emitted

        self._decoding.append(self._decode_ex.submit(job))

    def _harvest_one(self) -> None:
        if not self._inflight:
            self._promote(block=True)
        d, batch, acand, out, route = self._inflight.popleft()
        # decode + emit run on the decode worker, overlapping device
        # execution AND this thread's submit/promote work
        self._decoding.append(
            self._decode_ex.submit(self._decode_job, d, batch, acand, out,
                                   route)
        )
        # promote any counts that landed meanwhile, then bound the decode
        # backlog (it holds references to device buffers)
        self._promote(block=False)
        while len(self._decoding) > self._decode_depth:
            self._decoding.popleft().result()

    def _drain(self) -> None:
        while self._pending or self._inflight:
            self._harvest_one()
        while self._decoding:
            self._decoding.popleft().result()

    def consume(self, stream, on_spill=None) -> Tuple[int, int]:
        """Emit-mode twin of :meth:`Dispatcher.consume`.

        ``on_spill`` must route its rows through :meth:`emit_rows` so
        stream order is preserved.  Stops early once the dispatcher-global
        sink reports ``full``.  Returns (tiles consumed, max tile width).
        """
        stop = None
        if self.sink is not None:
            stop = lambda: self.sink.full  # noqa: E731
        return _consume_stream(self, stream, on_spill, stop=stop)

    def drain(self) -> None:
        """Block until every submitted batch is decoded and delivered,
        keeping the decode worker alive for further ``submit`` calls."""
        self._drain()

    def finish(self) -> int:
        """Drain all in-flight batches; returns rows accepted by the sink
        (0 when running sink-less).  Shuts down the decode worker."""
        self._drain()
        self._decode_ex.shutdown(wait=True)
        return 0 if self.sink is None else self.sink.accepted

    def close(self) -> None:
        """Teardown for error paths: cancel queued decode jobs and stop the
        worker without draining the lanes, so the sink stops receiving
        rows once the caller is handling a failure.

        The one job the worker may be running is waited for to its row
        boundary (draining the future deque is the barrier), so the caller
        never tears the sink down under a concurrent write.  A job's own
        exception is dropped here: this runs in a ``finally`` while the
        primary failure propagates.  Idempotent; a no-op after a clean
        :meth:`finish`."""
        self._decode_ex.shutdown(wait=False, cancel_futures=True)
        while self._decoding:
            fut = self._decoding.popleft()
            try:
                fut.result()
            except concurrent.futures.CancelledError:
                continue
            except Exception:  # noqa: BLE001 -- the caller's error wins
                pass


def dispatch_scheduled(
    batches: Sequence[pipeline.TileBatch],
    l: int,
    devices: DeviceSpec = None,
    *,
    mesh: Optional[Sequence] = None,
    et: bool = True,
    method: str = "auto",
    async_staging: bool = True,
    max_inflight: int = 2,
    stats: Optional[Stats] = None,
    stage_times: Optional[dict] = None,
) -> Tuple[int, dict]:
    """Offline-LPT dispatch of a materialized batch list.

    ``schedule_batches`` LPT-assigns whole batches to ``n_devices`` bins;
    each bin becomes one lane, and bins are drained round-robin so every
    lane receives work from the first wave of submissions.  Returns
    (total, info) where info carries the scheduler stats plus the realized
    per-batch ``placements`` and ``tiles``.
    """
    disp = Dispatcher(
        l,
        devices,
        mesh=mesh,
        et=et,
        method=method,
        async_staging=async_staging,
        max_inflight=max_inflight,
        stats=stats,
        stage_times=stage_times,
    )
    if mesh is not None:
        for b in batches:
            disp.submit(b)
        info = {"n_devices": disp.n_devices, "mesh": True}
    else:
        device_bins, sched = schedule_batches(batches, l, disp.n_devices)
        for wave in itertools.zip_longest(*device_bins):
            for d, bi in enumerate(wave):
                if bi is not None:
                    disp.submit(batches[bi], device=d)
        info = dict(sched)
        info["n_devices"] = disp.n_devices
        info["device_bins"] = device_bins
    total = disp.finish()
    info["placements"] = disp.placements
    info["tiles"] = disp.tiles
    return total, info
