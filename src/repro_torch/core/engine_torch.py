"""Device counting engine: tiles -> packed bitset batches -> CUDA kernels.

The port of ``repro/core/engine_jax.py`` (single-device path):

1. vectorized tile extraction and capacity-batched packing
   (:mod:`repro_torch.core.pipeline`), fixed-shape (B, T, T/32) uint32
   batches streamed off the host and carried as int32 views;
2. oversize routing: tiles wider than the largest bin spill to the host
   bitset recursion (``Stats.spilled_tiles``);
3. early-termination routing (paper Section 5): per-tile plexity is a
   popcount reduction on the device; tiles with t <= 2 get a zero
   candidate mask before the kernel and are answered on the host by the
   closed-form 2-plex count (exact int64 Pascal-table arithmetic);
4. everything else goes to :func:`repro_torch.kernels.ops.count_tiles`:
   the triangle kernel for l == 3, the bitset DFS kernel for l >= 4.

Unlike the reference, batches are not padded to a power of two
(``bucket_rows``): that padding exists so XLA reuses compiled executables,
and an eager CUDA launch gains nothing from it.  The entry point runs on
the CUDA device unless the caller passes ``device="cpu"``; there is no
silent fallback.  ``devices=`` routes the batches through the multi-lane
dispatcher (:mod:`repro_torch.runtime.dispatch`).  Still to be ported: the
tuned geometry of ``repro.tune`` (this engine takes the historical
defaults: ``batch_size=256``, bins ``(32, 64, 128, 256)``,
``pack_workers`` from ``default_pack_workers()``).
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .bitops import popcount_words, unpack_bits, widen
from .engine_np import Stats, count_rec_C, count_rec_T
from .graph import Graph
from . import pipeline
from . import tiles as tiles_mod
from ..convert import batch_to_torch
from ..kernels import ops as kops
from ..kernels.common import pascal_table
from ..kernels.ref import edges_within_ref


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; raise if CUDA is asked for (or
    implied) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run "
            "the port's plain torch versions on the CPU")
    return dev


# ---------------------------------------------------------------------------
# early termination (closed-form 2-plex counting)
# ---------------------------------------------------------------------------

def plex_stats(A: torch.Tensor, cand: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per tile: (nv, t, f) = size, plexity, #universal vertices (int32)."""
    T = A.shape[1]
    A64, c64 = widen(A), widen(cand)
    vbit = unpack_bits(c64, T)                           # (B, T)
    deg = popcount_words(A64 & c64[:, None, :]).sum(-1)  # (B, T)
    nv = popcount_words(c64).sum(-1)                     # (B,)
    deg_v = torch.where(vbit > 0, deg, torch.full_like(deg, 1 << 30))
    mind = deg_v.min(-1).values
    mind = torch.where(nv > 0, mind, torch.zeros_like(mind))
    t = nv - mind
    f = ((deg == nv[:, None] - 1) & (vbit > 0)).sum(-1)
    return nv.to(torch.int32), t.to(torch.int32), f.to(torch.int32)


def count_2plex_closed_np(nv: np.ndarray, f: np.ndarray, l: int) -> np.ndarray:
    """Closed-form Section 5.1 count; exact int64 on host (cheap, O(B*l))."""
    table = pascal_table(int(max(nv.max(initial=0), 1)))
    p = (nv - f) // 2
    total = np.zeros(nv.shape, dtype=np.int64)
    for c in range(0, l + 1):
        j = l - c
        cf = np.where(c <= f, table[f, np.minimum(c, f)], 0)
        cp = np.where(j <= p, table[p, np.minimum(j, p)], 0)
        total += cf * cp * (1 << j)
    return total


# ---------------------------------------------------------------------------
# public engine
# ---------------------------------------------------------------------------

def count_packed(A: torch.Tensor, cand: torch.Tensor, l: int,
                 method: str = "auto", et: bool = True,
                 stage_times: Optional[Dict[str, float]] = None):
    """Device step over one packed batch of int32 word views.

    Returns (hard (B,) int64 kernel counts holding uint32 values, with the
    2-plex tiles masked to 0; nv, t, f (B,) int32) -- the host combines
    them with the exact int64 closed form.  With ``stage_times`` given and
    ``A`` on a CUDA device, CUDA events bracket the ``count_tiles`` call
    and its span (host enqueue included, so not the kernel's device time)
    accumulates in seconds under ``"count_tiles_T<T>"``.
    """
    B = A.shape[0]
    z = torch.zeros(B, dtype=torch.int32, device=A.device)
    if l == 0:
        return torch.ones(B, dtype=torch.int64, device=A.device), z, z, z
    if l == 1:
        return popcount_words(widen(cand)).sum(-1), z, z, z
    if l == 2:
        return edges_within_ref(A, cand), z, z, z
    nv, t, f = plex_stats(A, cand)
    if et:
        cand = torch.where((t <= 2)[:, None], torch.zeros_like(cand), cand)
    if stage_times is None or not A.is_cuda:
        return kops.count_tiles(A, cand, l, method=method), nv, t, f
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    hard = kops.count_tiles(A, cand, l, method=method)
    end.record()
    end.synchronize()
    key = f"count_tiles_T{A.shape[1]}"
    stage_times[key] = stage_times.get(key, 0.) \
        + start.elapsed_time(end) / 1e3
    return hard, nv, t, f


def combine_counts(hard, nv, t, f, l: int, et: bool) -> int:
    """Host-exact combination of the device step outputs (numpy or CPU
    tensors)."""
    hard = np.asarray(hard).astype(np.int64)
    if not et or l <= 2:
        return int(hard.sum())
    nv = np.asarray(nv)
    t = np.asarray(t)
    f = np.asarray(f)
    is2 = t <= 2
    closed = count_2plex_closed_np(nv[is2], f[is2], l)
    return int(hard.sum() + closed.sum())


def count_spilled(tile: tiles_mod.Tile, order: str, l: int, stats: Stats,
                  et_t: int, use_rule2: bool) -> int:
    """Host bitset recursion for one oversize tile (mirrors the host path).

    Each spill is recorded once: ``spilled_tiles`` counts it and
    ``spill_sizes`` keeps its width.
    """
    stats.spilled_tiles += 1
    stats.spill_sizes.append(tile.s)
    cand = (1 << tile.s) - 1
    if order == "truss":
        return count_rec_T(tile.edges_ranked, cand, tile.s, l, stats,
                           et_t=et_t)
    return count_rec_C(tile.rows, cand, l, stats, colors=tile.colors,
                       et_t=et_t, use_rule2=use_rule2)


def count(g: Graph, k: int, order: str = "hybrid", et_t: int = 3,
          use_rule2: bool = True, method: str = "auto",
          et_route: bool = True,
          plan: Optional[pipeline.PipelinePlan] = None,
          batch_size: Optional[int] = None,
          bins: Optional[Sequence[int]] = None,
          stage_times: Optional[Dict[str, float]] = None,
          pack_workers: Optional[int] = None,
          device=None,
          devices=None,
          async_staging: bool = True,
          max_inflight: int = 2):
    """Full-graph k-clique count on ``device`` (default: the CUDA device).

    Streams capacity-batched packed tiles from
    :mod:`repro_torch.core.pipeline`; pass a prebuilt ``plan`` to amortize
    preprocessing across queries, or leave ``plan=None`` to use the keyed
    in-process plan cache.  Oversize tiles are counted on the host
    (``stats.spilled_tiles``).  ``pack_workers=None`` sizes the pack pool
    with ``pipeline.default_pack_workers()``.
    ``stage_times`` (optional dict) accumulates extract/pack/device/combine
    wall-clock seconds, and on a CUDA device the ``count_tiles`` device
    seconds per bin (see :func:`count_packed`); with it given, each batch
    synchronizes the device so its time is billed to "device".

    ``devices`` routes the packed batches through the multi-lane
    dispatcher (:class:`repro_torch.runtime.dispatch.Dispatcher`) instead
    of ``device``: an int n / ``"all"`` / a lane list (repeats allowed,
    ``["cpu"] * n`` included), with double-buffered staging up to
    ``max_inflight`` batches a lane (``async_staging=False`` forces
    synchronous staging).  ``devices=None`` keeps the single-device inline
    path.  Counts are identical either way -- partials are combined
    exactly on the host.
    """
    from .ebbkc import Result
    stats = Stats()
    if devices is None:
        dev = resolve_device(device)
        stats.backend = f"torch:{dev.type}"
    if k == 1:
        return Result(g.n, stats)
    if k == 2:
        return Result(g.m, stats)
    total = 0
    ntiles = 0
    max_tile = 0
    l = k - 2
    et = et_route and et_t >= 2
    if devices is not None:
        # lanes resolve (and raise without CUDA) before the plan is built
        from ..runtime.dispatch import Dispatcher
        disp = Dispatcher(l, devices, et=et, method=method,
                          async_staging=async_staging,
                          max_inflight=max_inflight, stats=stats,
                          stage_times=stage_times)
    if plan is None:
        plan = pipeline.cached_plan(g, order=order, stats=stats)
    stream = pipeline.stream_batches(
        plan, k, order=order, use_rule2=use_rule2,
        batch_size=batch_size, bins=bins, timings=stage_times,
        pack_workers=pack_workers, stats=stats)
    if devices is not None:
        spill_total = 0

        def on_spill(tile: tiles_mod.Tile) -> None:
            nonlocal spill_total
            spill_total += count_spilled(tile, order, l, stats, et_t,
                                         use_rule2)

        try:
            ntiles, max_tile = disp.consume(stream, on_spill=on_spill)
            total = spill_total + disp.finish()
        finally:
            stream.close()  # stops the pack workers on error too
        return Result(total, stats, ntiles, max_tile)
    try:
        for item in stream:
            if isinstance(item, tiles_mod.Tile):
                ntiles += 1
                max_tile = max(max_tile, item.s)
                total += count_spilled(item, order, l, stats, et_t,
                                       use_rule2)
                continue
            ntiles += item.B
            max_tile = max(max_tile, item.T)
            t0 = time.perf_counter()
            A, cand = batch_to_torch(item.A, item.cand, dev)
            out = count_packed(A, cand, l, method=method, et=et,
                               stage_times=stage_times)
            if stage_times is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            total += combine_counts(*(x.cpu() for x in out), l, et)
            if stage_times is not None:
                stage_times["device"] = stage_times.get("device", 0.) \
                    + t1 - t0
                stage_times["combine"] = stage_times.get("combine", 0.) \
                    + time.perf_counter() - t1
    finally:
        stream.close()  # stops the pack workers on error too
    return Result(total, stats, ntiles, max_tile)
