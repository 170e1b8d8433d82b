"""EBBkC public API of the port: edge-oriented branch-and-bound k-clique
counting and listing.

``count`` runs the paper's Algorithms 2-7 over the tile dataflow of
:mod:`repro_torch.core.pipeline`.  ``backend="torch"`` (the default)
streams packed batches through the device engine
(:mod:`repro_torch.core.engine_torch`) on ``device`` -- the CUDA device by
default, the CPU only when asked; ``backend="host"``, only when asked,
executes the paper-faithful python-int bitset recursion.  Pass a prebuilt
:class:`~repro_torch.core.pipeline.PipelinePlan` as ``plan`` to amortize
preprocessing across queries on one graph.  ``list_cliques`` returns the
cliques themselves, through the listing engine
(:mod:`repro_torch.core.listing`) on the same devices, or through the host
recursion.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .engine_np import Stats, count_rec_C, count_rec_T, list_rec_C
from .graph import Graph
from . import pipeline

BACKENDS = ("host", "torch")


@dataclasses.dataclass
class Result:
    count: int
    stats: Stats
    tiles: int = 0
    max_tile: int = 0


def count(g: Graph, k: int, order: str = "hybrid", et_t: int = 3,
          use_rule2: bool = True, backend: str = "torch", device=None,
          engine_kwargs: Optional[dict] = None,
          plan: Optional[pipeline.PipelinePlan] = None) -> Result:
    """Count k-cliques with edge-oriented branching (EBBkC-T/C/H).

    ``device`` applies to ``backend="torch"``: ``None`` means the CUDA
    device (and raises without one); pass ``"cpu"`` to run there.
    ``engine_kwargs`` forwards knobs to ``engine_torch.count``, among them
    ``devices=`` (lanes of the multi-lane dispatcher, in place of
    ``device``), ``async_staging=`` and ``max_inflight=``.
    ``backend="host"`` runs the python-int recursion and takes no device.
    """
    if k < 1:
        raise ValueError("k >= 1 required")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "torch":
        from . import engine_torch
        return engine_torch.count(g, k, order=order, et_t=et_t,
                                  use_rule2=use_rule2, plan=plan,
                                  device=device, **(engine_kwargs or {}))
    stats = Stats()
    stats.backend = "host"
    if k == 1:
        return Result(g.n, stats)
    if k == 2:
        return Result(g.m, stats)
    total = 0
    ntiles = 0
    max_tile = 0
    l = k - 2
    for tile in pipeline.iter_tiles(plan or g, k, mode=order,
                                    use_rule2=use_rule2):
        ntiles += 1
        max_tile = max(max_tile, tile.s)
        cand = (1 << tile.s) - 1
        if order == "truss":
            total += count_rec_T(tile.edges_ranked, cand, tile.s, l, stats,
                                 et_t=et_t)
        else:
            total += count_rec_C(tile.rows, cand, l, stats,
                                 colors=tile.colors, et_t=et_t,
                                 use_rule2=use_rule2)
    return Result(total, stats, ntiles, max_tile)


def list_cliques(g: Graph, k: int, order: str = "hybrid", et_t: int = 3,
                 max_out: Optional[int] = None,
                 plan: Optional[pipeline.PipelinePlan] = None,
                 backend: str = "torch", device=None,
                 engine_kwargs: Optional[dict] = None
                 ) -> Tuple[np.ndarray, Stats]:
    """List k-cliques; returns ((count, k) int64 global vertex ids, stats).

    Each row is sorted ascending; rows come in the reference's order.  With
    ``max_out`` set, exactly ``min(max_out, total)`` cliques are returned.
    ``backend="torch"`` (the default) streams packed batches through the
    list kernel on ``device`` -- the CUDA device by default (raising
    without one), the CPU only when asked -- and never truncates on
    emit-buffer overflow (overflowed tiles relist on the host,
    ``stats.overflowed_tiles``); ``engine_kwargs`` forwards knobs such as
    ``capacity=``, ``bins=``, ``devices=``, ``async_staging=`` or
    ``max_inflight=`` to ``listing.stream_cliques``.
    ``backend="host"`` runs the python-int recursion and takes no device.
    """
    if k < 1:
        raise ValueError("k >= 1 required")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    stats = Stats()
    stats.backend = "host"
    if k == 1:
        out = np.arange(g.n, dtype=np.int64)[:, None]
        return out[:max_out], stats
    if k == 2:
        return g.edges[:max_out].copy(), stats
    if backend == "torch":
        from . import listing
        sink = listing.ArraySink(k, max_out=max_out)
        res = listing.stream_cliques(plan or g, k, sink, order=order,
                                     et_t=et_t, device=device,
                                     **(engine_kwargs or {}))
        return sink.result(), res.stats
    out_all: List[Tuple[int, ...]] = []
    for tile in pipeline.iter_tiles(plan or g, k, mode=order):
        cand = (1 << tile.s) - 1
        local: List[Tuple[int, ...]] = []
        list_rec_C(tile.rows, cand, k - 2, (), local, et_t=et_t)
        for tup in local:
            out_all.append(tile.anchor + tuple(int(tile.verts[i])
                                               for i in tup))
        if max_out is not None and len(out_all) >= max_out:
            arr = np.asarray(out_all[:max_out], dtype=np.int64).reshape(-1, k)
            return np.sort(arr, axis=1), stats
    if not out_all:
        return np.zeros((0, k), dtype=np.int64), stats
    arr = np.asarray(out_all, dtype=np.int64)
    return np.sort(arr, axis=1), stats
