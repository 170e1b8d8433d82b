"""EBBkC public API of the port: edge-oriented branch-and-bound k-clique
counting.

``count`` runs the paper's Algorithms 2-7 over the tile dataflow of
:mod:`repro_torch.core.pipeline`.  ``backend="torch"`` (the default)
streams packed batches through the device engine
(:mod:`repro_torch.core.engine_torch`) on ``device`` -- the CUDA device by
default, the CPU only when asked; ``backend="host"``, only when asked,
executes the paper-faithful python-int bitset recursion.  Pass a prebuilt
:class:`~repro_torch.core.pipeline.PipelinePlan` as ``plan`` to amortize
preprocessing across queries on one graph.  Still to be ported with the
listing slice: ``list_cliques``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .engine_np import Stats, count_rec_C, count_rec_T
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
