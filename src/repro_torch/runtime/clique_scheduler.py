"""Straggler-aware scheduling of clique tiles onto devices.

The truss-based edge ordering is also a *load balancer*: every tile's cost
is bounded by tau, and the tile's work is predictable from its size before
dispatch (cost model below).  We over-decompose into ``overdecompose x
n_devices`` bins, assign greedily by Longest-Processing-Time (LPT), and
lay bins out round-robin so a slow device can shed whole bins on requeue.

Cost model (per tile, DFS kernel): branches ~ nedges * (s/4)^(l-3) for
l >= 3 capped crudely; calibrated against measured host-engine branch
counts in benchmarks/bench_parallel (see EXPERIMENTS.md).

The port's copy of ``repro/runtime/clique_scheduler.py``, numpy code
unchanged, so bins and placements equal the reference's.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def tile_cost(s: int, nedges: int, l: int) -> float:
    return float(tile_costs(np.asarray([s]), np.asarray([nedges]), l)[0])


def tile_costs(s: np.ndarray, nedges: np.ndarray, l: int) -> np.ndarray:
    """Vectorized :func:`tile_cost` over the per-tile metadata arrays that
    :class:`repro_torch.core.pipeline.TileBatch` carries
    (``sizes``/``nedges``)."""
    s = np.asarray(s, dtype=np.float64)
    e = np.asarray(nedges, dtype=np.float64)
    if l <= 1:
        return 1.0 + s
    if l == 2:
        return 1.0 + e
    expo = l - 3 if l > 3 else 0.5
    return 1.0 + e * np.maximum(1.0, s / 4.0) ** expo


def balanced_bins(costs: Sequence[float], n_bins: int
                  ) -> Tuple[List[List[int]], np.ndarray]:
    """LPT greedy: returns (bin -> tile indices, per-bin total cost)."""
    costs = np.asarray(costs, dtype=np.float64)
    order = np.argsort(-costs)
    loads = np.zeros(n_bins)
    bins: List[List[int]] = [[] for _ in range(n_bins)]
    for i in order:
        b = int(np.argmin(loads))
        bins[b].append(int(i))
        loads[b] += costs[i]
    return bins, loads


def schedule_tiles(tiles, l: int, n_devices: int, overdecompose: int = 16):
    """Returns (device -> tile ids, stats).

    ``tiles`` is either a list of objects with ``.s``/``.nedges`` or a
    :class:`repro_torch.core.pipeline.TileBatch` (its ``sizes``/``nedges``
    metadata arrays are the cost-model inputs -- the batcher and the
    scheduler share one cost vocabulary).  Over-decomposition bounds the
    requeue unit for straggler mitigation while LPT keeps static balance
    tight (max/mean load reported).
    """
    if hasattr(tiles, "sizes") and hasattr(tiles, "nedges"):
        costs = tile_costs(tiles.sizes, tiles.nedges, l)
    else:
        costs = [tile_cost(t.s, t.nedges, l) for t in tiles]
    n_bins = max(1, min(len(costs), n_devices * overdecompose))
    bins, loads = balanced_bins(costs, n_bins)
    device_bins: List[List[int]] = [[] for _ in range(n_devices)]
    order = np.argsort(-loads)
    dev_loads = np.zeros(n_devices)
    for b in order:
        d = int(np.argmin(dev_loads))
        device_bins[d].extend(bins[b])
        dev_loads[d] += loads[b]
    stats = {
        "max_over_mean": float(dev_loads.max() / max(dev_loads.mean(), 1e-9)),
        "device_loads": dev_loads,
    }
    return device_bins, stats


def schedule_batches(batches: Sequence, l: int, n_devices: int
                     ) -> Tuple[List[List[int]], dict]:
    """LPT-assign whole packed batches to devices.

    ``batches``: sequence of :class:`repro_torch.core.pipeline.TileBatch`.
    Each batch is one dispatch unit (one fixed-shape device call), so device
    bins map one-to-one onto packed batches; a batch's cost is the sum of
    its per-tile cost-model terms.  Returns (device -> batch indices,
    stats with per-device loads and max/mean balance).
    """
    costs = [float(tile_costs(b.sizes, b.nedges, l).sum()) for b in batches]
    device_bins, loads = balanced_bins(costs, n_devices)
    stats = {
        "max_over_mean": float(loads.max() / max(loads.mean(), 1e-9)),
        "device_loads": loads,
        "batch_costs": np.asarray(costs),
    }
    return device_bins, stats
