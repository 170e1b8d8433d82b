"""VBBkC baseline (paper Algorithm 1 / Section 3): vertex-oriented BB.

Variants reproduce the paper's comparison set:
  * ``degen``     -- Degen: degeneracy ordering only.
  * ``ddegcol``   -- DDegCol: degeneracy top level + per-branch color order
                     with Rule (1) pruning.
  * ``ddegcol+``  -- DDegCol plus the paper's new Rule (2) (ablation, Fig. 6).

As in the reference, the baseline runs on the host: a python-int bitset
recursion over vertex tiles, with no device and no kernel.  It returns the
port's :class:`~repro_torch.core.ebbkc.Result`.
"""
from __future__ import annotations

from .ebbkc import Result
from .engine_np import Stats, count_rec_V
from .graph import Graph
from . import tiles as tiles_mod


def count(g: Graph, k: int, variant: str = "ddegcol", et_t: int = 0) -> Result:
    if k == 1:
        return Result(g.n, Stats())
    if k == 2:
        return Result(g.m, Stats())
    colored = variant in ("ddegcol", "ddegcol+")
    use_rule2 = variant == "ddegcol+"
    stats = Stats()
    total = 0
    ntiles = 0
    max_tile = 0
    for tile in tiles_mod.vertex_tiles(g, k, colored=colored):
        ntiles += 1
        max_tile = max(max_tile, tile.s)
        cand = (1 << tile.s) - 1
        total += count_rec_V(tile.rows, cand, k - 1, stats,
                             colors=tile.colors, et_t=et_t,
                             use_rule2=use_rule2)
    return Result(total, stats, ntiles, max_tile)
