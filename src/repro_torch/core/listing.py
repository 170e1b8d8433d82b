"""Clique listing: device list kernel -> global ids -> sinks.

The port of ``repro/core/listing.py`` (single-device path), the output
twin of the counting engine (:mod:`repro_torch.core.engine_torch`).  The
same streaming tile pipeline feeds the list kernel
(:mod:`repro_torch.kernels.clique_list`), which writes each completed
l-clique's local vertex ids into a fixed-capacity per-tile buffer; the host
decodes tile-local ids through the batch's ``verts`` table back to global
vertex ids and streams the rows into a pluggable :class:`CliqueSink`.

Exactness invariants (as in the reference):

* **exact-once** -- each k-clique is produced by exactly one anchor edge
  (the paper's Eq. 2 attribution), so no de-duplication is ever needed;
* **never truncated** -- emit buffers are sized by a first count pass
  (rounded up under ``cap_policy``, a power of two by default, capped at
  ``max_capacity``); a tile whose
  true count exceeds its buffer raises the kernel's overflow flag and is
  relisted by the host bitset recursion (``Stats.overflowed_tiles``), as
  oversize tiles spill (``Stats.spilled_tiles``);
* **deterministic order** -- rows arrive in stream order (spill tiles,
  then packed batches per size bin; tiles in batch order inside each
  batch; each row sorted ascending), the same rows in the same order as
  the reference's ``stream_cliques``.

``devices=`` routes the batches through the multi-lane
:class:`repro_torch.runtime.dispatch.ListDispatcher`, which adds the
``capacity="speculative"`` mode.  The reference's ``trace`` spans sit
where it has them (``spill/list``, ``overflow/relist``, ``device/sizing``,
``device/wait``, ``decode``), and the ``device.harvest``, ``decode`` and
``sink.write`` fault sites absorb an injected fault in place before the
stage's work.  Geometry knobs left ``None`` resolve through the
persistent autotuner (:func:`repro_torch.tune.search.resolve_geometry`),
and a Graph source takes its plan off the keyed plan cache, optionally
backed by an on-disk store.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .bitops import unpack_mask
from .engine_np import Stats, list_rec_C
from .graph import ragged_expand
from . import pipeline
from . import tiles as tiles_mod
from ..convert import batch_to_torch
from ..kernels import ops as kops
from ..obs import trace
from ..resilience import retry as fault_retry
from ..tune import search as tune_search

#: default cap on the per-tile emit buffer (rows); tiles whose true count
#: exceeds it overflow to the host relist instead of growing the buffer
MAX_CAPACITY = 1 << 14


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------


class CliqueSink:
    """Pluggable consumer of decoded clique rows.

    ``emit`` receives an ``(n, k) int64`` array of global vertex ids (rows
    sorted ascending) and returns how many rows it accepted; ``full`` lets
    bounded sinks stop the producer early.  ``bytes_written`` accounts the
    payload bytes of accepted rows (surfaced as ``Stats.sink_bytes``).
    """

    def __init__(self) -> None:
        self.accepted = 0
        self.bytes_written = 0

    @property
    def full(self) -> bool:
        """True when the sink wants no more rows (stops the producer)."""
        return False

    def emit(self, cliques: np.ndarray) -> int:
        """Consume an ``(n, k)`` rows chunk; return rows accepted."""
        raise NotImplementedError

    def close(self) -> None:
        """Flush/finalize; called once after the stream ends."""
        pass

    def _account(self, arr: np.ndarray) -> int:
        self.accepted += arr.shape[0]
        self.bytes_written += arr.nbytes
        return arr.shape[0]


class CallbackSink(CliqueSink):
    """Invoke ``fn(rows)`` for every emitted chunk (streaming consumers)."""

    def __init__(self, fn: Callable[[np.ndarray], None]) -> None:
        super().__init__()
        self.fn = fn

    def emit(self, cliques: np.ndarray) -> int:
        """Forward a non-empty chunk to the callback; accept all rows."""
        if cliques.shape[0]:
            self.fn(cliques)
        return self._account(cliques)


class ArraySink(CliqueSink):
    """Bounded in-memory buffer; backs ``list_cliques(max_out=...)``."""

    def __init__(self, k: int, max_out: Optional[int] = None) -> None:
        super().__init__()
        self.k = int(k)
        self.max_out = max_out
        self._chunks: List[np.ndarray] = []

    @property
    def full(self) -> bool:
        """True once ``max_out`` rows have been accepted."""
        return self.max_out is not None and self.accepted >= self.max_out

    def emit(self, cliques: np.ndarray) -> int:
        """Buffer rows, truncating at ``max_out``; return rows kept."""
        if self.max_out is not None:
            cliques = cliques[: max(self.max_out - self.accepted, 0)]
        if cliques.shape[0]:
            self._chunks.append(cliques)
        return self._account(cliques)

    def result(self) -> np.ndarray:
        """All accepted rows as one ``(n, k) int64`` array."""
        if not self._chunks:
            return np.zeros((0, self.k), dtype=np.int64)
        return np.concatenate(self._chunks)


class NpzSink(CliqueSink):
    """Accumulate rows and write one NPZ (key ``cliques``) on ``close``."""

    def __init__(self, path: str, k: int, max_out: Optional[int] = None) -> None:
        super().__init__()
        self.path = path
        self._inner = ArraySink(k, max_out=max_out)

    @property
    def full(self) -> bool:
        """Delegates to the buffering inner sink."""
        return self._inner.full

    def emit(self, cliques: np.ndarray) -> int:
        """Buffer rows (via an inner :class:`ArraySink`); return kept."""
        n = self._inner.emit(cliques)
        self.accepted = self._inner.accepted
        self.bytes_written = self._inner.bytes_written
        return n

    def close(self) -> None:
        """Write the buffered rows to ``path`` (NPZ key ``cliques``)."""
        np.savez_compressed(self.path, cliques=self._inner.result())


# ---------------------------------------------------------------------------
# decode: tile-local kernel output -> sorted global id rows
# ---------------------------------------------------------------------------


def _rows_from_packed(A_tile: np.ndarray, s: int) -> List[int]:
    """(T, W) uint32 packed adjacency -> python-int bitset rows [0..s)."""
    return [unpack_mask(A_tile[i]) for i in range(s)]


def _decode_local(
    anchor: np.ndarray, verts: np.ndarray, local: np.ndarray
) -> np.ndarray:
    """One tile: (n, l) local ids -> (n, 2+l) sorted global rows."""
    if local.shape[0] == 0:
        return np.zeros((0, 2 + local.shape[1]), dtype=np.int64)
    glob = verts[local]
    out = np.concatenate(
        [np.broadcast_to(anchor, (local.shape[0], 2)), glob],
        axis=1,
    )
    return np.sort(out, axis=1)


def _list_tile_host(
    rows: Sequence[int],
    s: int,
    anchor: np.ndarray,
    verts: np.ndarray,
    l: int,
    et_t: int = 3,
) -> np.ndarray:
    """Host bitset recursion listing for one tile (spill/overflow path)."""
    local: List[tuple] = []
    list_rec_C(rows, (1 << s) - 1, l, (), local, et_t=et_t)
    loc = np.asarray(local, dtype=np.int64).reshape(-1, l)
    return _decode_local(np.asarray(anchor, dtype=np.int64), verts, loc)


def list_spilled(
    tile: tiles_mod.Tile, l: int, stats: Stats, et_t: int = 3
) -> np.ndarray:
    """List one oversize tile on the host (mirrors ``count_spilled``)."""
    stats.spilled_tiles += 1
    stats.spill_sizes.append(tile.s)
    with trace.span("spill/list", s=tile.s):
        return _list_tile_host(
            tile.rows,
            tile.s,
            np.asarray(tile.anchor, dtype=np.int64),
            tile.verts,
            l,
            et_t=et_t,
        )


def decode_batch(
    batch: pipeline.TileBatch,
    bufs: np.ndarray,
    counts: np.ndarray,
    overflow: np.ndarray,
    l: int,
    stats: Stats,
    et_t: int = 3,
    stage_times: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """Decode one harvested (buffer, count, overflow) triple to global rows.

    Non-overflowed tiles decode vectorized straight from the kernel buffer;
    overflowed tiles are relisted by the host recursion from the packed
    adjacency (never truncated) and spliced back in tile order.  With
    ``stage_times`` given, the relists' seconds accumulate under
    ``"relist"``.
    """
    counts = np.asarray(counts, dtype=np.int64)
    overflow = np.asarray(overflow)
    counts_eff = np.where(overflow > 0, 0, counts)
    owner, pos = ragged_expand(counts_eff)
    local = bufs[owner, pos]  # (n, l) local ids
    glob = batch.verts[owner[:, None], local]
    decoded = np.concatenate([batch.anchors[owner], glob], axis=1)
    decoded = np.sort(decoded, axis=1) if decoded.shape[0] else decoded
    if not overflow.any():
        return decoded
    t0 = time.perf_counter()
    parts = np.split(decoded, np.cumsum(counts_eff)[:-1])
    for b in np.nonzero(overflow)[0]:
        stats.overflowed_tiles += 1
        s = int(batch.sizes[b])
        rows = _rows_from_packed(batch.A[b], s)
        with trace.span("overflow/relist", s=s):
            parts[b] = _list_tile_host(
                rows, s, batch.anchors[b], batch.verts[b], l, et_t=et_t
            )
    out = np.concatenate(parts)
    if stage_times is not None:
        stage_times["relist"] = stage_times.get("relist", 0.0) \
            + time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# capacity sizing
# ---------------------------------------------------------------------------


def capacity_for(counts: np.ndarray, max_capacity: int = MAX_CAPACITY,
                 policy: str = "pow2") -> int:
    """Emit-buffer rows for a batch, its largest count rounded up under
    ``policy``.

    ``"pow2"`` (default) rounds to the next power of two; ``"mult64"`` to
    the next multiple of 64, up to 2x less buffer (and zero fill) for more
    distinct capacities.  Which wins is hardware-dependent, so the geometry
    tuner (:mod:`repro_torch.tune.search`) owns the choice.
    ``max_capacity`` bounds the buffer either way, overflowing the rare
    monster tile to the host relist instead.
    """
    m = int(np.asarray(counts).max(initial=1))
    if policy == "mult64":
        cap = -(-m // 64) * 64
    elif policy == "pow2":
        cap = 1
        while cap < m:
            cap *= 2
    else:
        raise ValueError(
            f"unknown capacity policy {policy!r}; expected 'pow2' or 'mult64'"
        )
    return max(1, min(cap, int(max_capacity)))


# ---------------------------------------------------------------------------
# streaming engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ListResult:
    """What ``stream_cliques`` hands back (the sink holds the rows)."""

    stats: Stats
    tiles: int = 0
    max_tile: int = 0


def host_list_triple(batch: pipeline.TileBatch, l: int):
    """List an entire batch on the host, as a kernel-shaped triple.

    Each tile is listed by the ``et_t=0`` bitset recursion -- which emits
    local cliques in the same order as the list kernel -- and packed into
    ``(bufs, counts, overflow)`` exactly as a device harvest would return
    them (local int32 indices, ``overflow == 0``), so any decode of it is
    byte-identical to the kernel's.
    """
    per: List[np.ndarray] = []
    for b in range(batch.B):
        s = int(batch.sizes[b])
        rows = _rows_from_packed(batch.A[b], s)
        local: List[tuple] = []
        list_rec_C(rows, (1 << s) - 1, l, (), local, et_t=0)
        per.append(np.asarray(local, dtype=np.int32).reshape(-1, l))
    cap = max(1, max((p.shape[0] for p in per), default=1))
    bufs = np.zeros((batch.B, cap, l), dtype=np.int32)
    counts = np.zeros(batch.B, dtype=np.int64)
    for b, p in enumerate(per):
        bufs[b, : p.shape[0]] = p
        counts[b] = p.shape[0]
    return bufs, counts, np.zeros(batch.B, dtype=np.uint32)


def list_batch(
    batch: pipeline.TileBatch,
    l: int,
    stats: Stats,
    *,
    device,
    capacity: Optional[int] = None,
    max_capacity: int = MAX_CAPACITY,
    cap_policy: str = "pow2",
    et_t: int = 3,
    stage_times: Optional[Dict[str, float]] = None,
    backend: Optional[str] = None,
) -> np.ndarray:
    """Single-device emit step: count pass -> sized list kernel -> decode.

    The count pass sizes the buffer by :func:`capacity_for` under
    ``cap_policy``; ``backend`` selects the kernel implementation
    (:mod:`repro_torch.kernels.ops` registry).

    With ``stage_times`` given, the device step (H2D, count pass, list
    kernel, D2H; it synchronizes on the count pass and the copy back)
    accumulates under ``"device"``, the bytes copied back under
    ``"d2h_bytes"``, and the decode under ``"decode"`` (overflow relists
    also under ``"relist"``).
    """
    t0 = time.perf_counter()
    B = batch.B
    A, cand = batch_to_torch(batch.A, batch.cand, device)
    if capacity is None:
        with trace.span("device/sizing", B=B, T=batch.T):
            counts = kops.count_tiles(A, cand, l,
                                      backend=backend).cpu().numpy()
        cap = capacity_for(counts, max_capacity, policy=cap_policy)
    else:
        cap = max(1, int(capacity))
    with trace.span("device/wait", B=B, T=batch.T, capacity=cap):
        bufs, cnt, ovf = kops.list_tiles(A, cand, l, cap, backend=backend)
        fault_retry.consume("device.harvest")
        bufs, cnt, ovf = (bufs.cpu().numpy(), cnt.cpu().numpy(),
                          ovf.cpu().numpy())
    t1 = time.perf_counter()
    fault_retry.consume("decode")
    with trace.span("decode", B=B, T=batch.T):
        out = decode_batch(batch, bufs, cnt, ovf, l, stats, et_t=et_t,
                           stage_times=stage_times)
    if stage_times is not None:
        stage_times["device"] = stage_times.get("device", 0.0) + t1 - t0
        stage_times["d2h_bytes"] = stage_times.get("d2h_bytes", 0) \
            + bufs.nbytes + 2 * 8 * batch.B
        stage_times["decode"] = stage_times.get("decode", 0.0) \
            + time.perf_counter() - t1
    return out


def stream_cliques(
    source,
    k: int,
    sink: CliqueSink,
    *,
    order: str = "hybrid",
    use_rule2: bool = True,
    et_t: int = 3,
    batch_size: Optional[int] = None,
    bins: Optional[Sequence[int]] = None,
    capacity=None,
    max_capacity: Optional[int] = None,
    cap_policy: Optional[str] = None,
    devices=None,
    async_staging: bool = True,
    max_inflight: int = 2,
    stage_times: Optional[dict] = None,
    pack_workers: Optional[int] = None,
    prefetch: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
    plan_cache: bool = True,
    plan_cache_dir: Optional[str] = None,
) -> ListResult:
    """List all k-cliques of ``source`` (Graph or PipelinePlan) into ``sink``.

    The device twin of ``ebbkc.list_cliques(backend="host")``: streams
    capacity-batched packed tiles, runs the list kernel on ``device`` (the
    CUDA device by default, the CPU only when asked), sized by a first
    count pass unless ``capacity`` pins the buffer, decodes on the host,
    and feeds the sink in deterministic stream order -- rows identical, in
    content and order, to the reference's ``stream_cliques``.  Requires
    k >= 3 (the k <= 2 cases have closed forms; see
    ``ebbkc.list_cliques``).

    Geometry knobs left ``None`` (``batch_size``, ``bins``,
    ``max_capacity``, ``cap_policy``, ``pack_workers``, ``prefetch``)
    resolve through the persistent autotuner
    (:func:`repro_torch.tune.search.resolve_geometry`): explicit argument >
    persisted geometry record > the historical defaults (256, bins
    ``(32, 64, 128, 256)``, :data:`MAX_CAPACITY`, ``"pow2"``, auto pack
    workers).  The emitted row stream is identical under every geometry.
    A Graph ``source`` goes through the keyed plan cache
    (``plan_cache=False`` opts out; ``plan_cache_dir`` adds the on-disk
    store).  ``backend`` selects the kernel implementation
    (:mod:`repro_torch.kernels.ops` registry).  ``stage_times``
    accumulates the stages of :func:`list_batch` plus the front end's
    ``"extract"`` / ``"pack"`` and the sink's ``"emit"``.

    ``devices`` routes batches through
    :class:`repro_torch.runtime.dispatch.ListDispatcher` instead of
    ``device`` (lane placement, double-buffered staging up to
    ``max_inflight`` batches a lane, FIFO harvest and one decode worker),
    whose capacity modes are ``None`` / ``"sized"`` (exact, by a count
    pass), ``"speculative"`` (a per-width capacity ratchet with one device
    retry) or an int.  On the inline path both string modes fall back to
    the exact count-pass sizing.  Exact and speculative sizing give the
    same rows in the same order; a pinned int capacity relists the tiles
    that overflow it on the host, in the host recursion's order, the same
    on both paths.
    """
    from .engine_torch import resolve_device
    if k < 3:
        raise ValueError("stream_cliques requires k >= 3")
    if isinstance(capacity, str):
        if capacity not in ("sized", "speculative"):
            raise ValueError(f"capacity must be None, 'sized', "
                             f"'speculative', or an int, got {capacity!r}")
        if devices is None:
            # dispatcher modes; the inline path's exact count-pass sizing
            # covers both aliases
            capacity = None
    stats = Stats()
    res = ListResult(stats)
    l = k - 2
    geom = tune_search.resolve_geometry(
        "list", l, batch_size=batch_size, bins=bins, cap_policy=cap_policy,
        max_capacity=max_capacity, pack_workers=pack_workers,
        prefetch=prefetch)
    if devices is None:
        dev = resolve_device(device)
        stats.backend = f"torch:{dev.type}"
    else:
        # lanes resolve (and raise without CUDA) before the plan is built
        from ..runtime.dispatch import ListDispatcher
        disp = ListDispatcher(
            l, devices, sink=sink, stats=stats, capacity=capacity,
            max_capacity=geom.max_capacity, cap_policy=geom.cap_policy,
            et_t=et_t, async_staging=async_staging,
            max_inflight=max_inflight, stage_times=stage_times,
            backend=backend)
    if not isinstance(source, pipeline.PipelinePlan) and plan_cache:
        source = pipeline.cached_plan(source, order=order,
                                      cache_dir=plan_cache_dir, stats=stats)
    stream = pipeline.stream_batches(
        source, k, order=order, use_rule2=use_rule2,
        batch_size=geom.batch_size, bins=geom.bins, timings=stage_times,
        pack_workers=geom.pack_workers, prefetch=geom.prefetch, stats=stats)
    if devices is not None:

        def on_spill(tile: tiles_mod.Tile) -> None:
            # host listing runs here (consumer thread); the emit goes
            # through the dispatcher's decode worker so the rows keep
            # their FIFO position relative to batch decodes
            disp.emit_rows(list_spilled(tile, l, stats, et_t=et_t))

        try:
            res.tiles, res.max_tile = disp.consume(stream, on_spill=on_spill)
            disp.finish()
        finally:
            # error path: stop the decode worker from emitting into the
            # caller's sink and cancel queued pack work; both are no-ops
            # after a clean finish
            disp.close()
            stream.close()
        stats.sink_bytes += sink.bytes_written
        stats.kernel_compile_s += kops.consume_compile_s()
        kops.drain_tune_events(stats)
        return res
    try:
        for item in stream:
            if sink.full:
                break
            if isinstance(item, tiles_mod.Tile):
                res.tiles += 1
                res.max_tile = max(res.max_tile, item.s)
                arr = list_spilled(item, l, stats, et_t=et_t)
            else:
                res.tiles += item.B
                res.max_tile = max(res.max_tile, item.T)
                arr = list_batch(item, l, stats, device=dev,
                                 capacity=capacity,
                                 max_capacity=geom.max_capacity,
                                 cap_policy=geom.cap_policy, et_t=et_t,
                                 stage_times=stage_times, backend=backend)
            t0 = time.perf_counter()
            fault_retry.consume("sink.write")
            stats.emitted_cliques += sink.emit(arr)
            if stage_times is not None:
                stage_times["emit"] = stage_times.get("emit", 0.0) \
                    + time.perf_counter() - t0
    finally:
        stream.close()  # stops the pack workers on error too
    stats.sink_bytes += sink.bytes_written
    stats.kernel_compile_s += kops.consume_compile_s()
    kops.drain_tune_events(stats)
    return res
