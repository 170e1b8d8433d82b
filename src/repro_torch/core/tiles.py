"""Top-level branch extraction: edges -> tau-bounded dense tiles.

NOTE: this module is the pure-Python *reference oracle*.  Production
consumers (the host and torch engines, the launcher) go through the
vectorized :mod:`repro_torch.core.pipeline`, whose parity tests assert it
reproduces these tiles exactly (same order, members, rows, colors, ranks).

This is the heart of the TPU adaptation: the first (and only data-dependent)
level of EBBkC branching is materialized as a batch of small dense subgraph
"tiles", one per edge.  With the truss-based ordering every tile has at most
tau vertices (Lemma 4.1), giving tight, similar-sized work units -- exactly
what a lockstep SPMD accelerator wants (the paper observes the same property
for its EdgeParallel scheme in Section 6.2(7)).

Extraction runs the pi_tau ordering *in reverse*, inserting edges into a
live adjacency structure: when edge e_r is visited, the structure contains
exactly the edges ranked after r, so the Alg. 3 ESet filter is free.

Modes
-----
truss  : pi_tau ordering; tile = common nbrs via edges ranked after e;
         tile edges keep their pi_tau ranks (Alg. 3 ESet semantics).
color  : global greedy coloring; DAG by color order; tile = common
         out-neighbors; Rules (1)/(2) prune whole tiles (Alg. 4).
hybrid : truss extraction + per-tile local coloring for inner pruning
         (Alg. 5) -- the paper's default EBBkC.

The vertex-tile extractor (VBBkC baseline) waits for a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .graph import Graph, greedy_coloring, color_vertex_order
from .truss import truss_decomposition


@dataclasses.dataclass
class Tile:
    anchor: Tuple[int, ...]          # global vertices already in S (edge or vertex)
    verts: np.ndarray                # (s,) global vertex ids, local order
    rows: List[int]                  # local adjacency bitsets (python ints)
    nedges: int
    edges_ranked: Optional[List[Tuple[int, int]]] = None  # truss-mode inner order
    colors: Optional[List[int]] = None                    # local color values

    @property
    def s(self) -> int:
        return int(len(self.verts))


def _local_color(rows: List[int], s: int) -> Tuple[List[int], List[int]]:
    """Greedy color a tile; return colors + order (color desc, id asc)."""
    from .bitops import bits
    deg = [(r.bit_count(), i) for i, r in enumerate(rows)]
    colors = [0] * s
    for _, v in sorted(deg, reverse=True):
        used = {colors[w] for w in bits(rows[v])}
        c = 1
        while c in used:
            c += 1
        colors[v] = c
    order = sorted(range(s), key=lambda v: (-colors[v], v))
    return colors, order


def _relabel(rows: List[int], order: List[int]) -> List[int]:
    """rows under permutation new_local = position in order."""
    from .bitops import bits
    s = len(rows)
    inv = [0] * s
    for new_i, old_i in enumerate(order):
        inv[old_i] = new_i
    out = [0] * s
    for new_i, old_i in enumerate(order):
        r = 0
        for old_j in bits(rows[old_i]):
            r |= 1 << inv[old_j]
        out[new_i] = r
    return out


def edge_tiles(g: Graph, k: int, mode: str = "hybrid",
               use_rule2: bool = True) -> Iterator[Tile]:
    """Yield one tile per top-level edge branch (EBBkC Eq. 2).

    Tiles are yielded in *reverse* pi_tau order for truss/hybrid modes (the
    attribution argument makes top-level order irrelevant for correctness).
    """
    if mode in ("truss", "hybrid"):
        td = truss_decomposition(g)
        alive: List[set] = [set() for _ in range(g.n)]
        rank_d = {}
        if mode == "truss":
            for r, eid in enumerate(td.order.tolist()):
                a, b = int(g.edges[eid, 0]), int(g.edges[eid, 1])
                rank_d[a * g.n + b] = r
                rank_d[b * g.n + a] = r
        for r in range(g.m - 1, -1, -1):
            eid = int(td.order[r])
            u, v = int(g.edges[eid, 0]), int(g.edges[eid, 1])
            au, av = alive[u], alive[v]
            if len(au) > len(av):
                au, av = av, au
            common = [w for w in au if w in av]
            if len(common) >= max(k - 2, 1):
                common.sort()
                s = len(common)
                rows = [0] * s
                pairs = []
                for i in range(s):
                    ai = alive[common[i]]
                    for j in range(i + 1, s):
                        if common[j] in ai:
                            rows[i] |= 1 << j
                            rows[j] |= 1 << i
                            pairs.append((i, j))
                verts = np.asarray(common, dtype=np.int64)
                if mode == "hybrid":
                    colors, order = _local_color(rows, s)
                    rows = _relabel(rows, order)
                    verts = verts[np.asarray(order)]
                    colors = [colors[i] for i in order]
                    yield Tile((u, v), verts, rows, len(pairs), colors=colors)
                else:
                    pr = sorted(pairs, key=lambda p: rank_d[
                        int(verts[p[0]]) * g.n + int(verts[p[1]])])
                    yield Tile((u, v), verts, rows, len(pairs),
                               edges_ranked=pr)
            alive[u].add(v)
            alive[v].add(u)
    elif mode == "color":
        colors, _ = greedy_coloring(g)
        vorder = color_vertex_order(colors)
        vid = np.empty(g.n, dtype=np.int64)
        vid[vorder] = np.arange(g.n)
        adjset = [set(g.neighbors(x).tolist()) for x in range(g.n)]
        outset = [set(w for w in adjset[x] if vid[w] > vid[x])
                  for x in range(g.n)]
        for eid in range(g.m):
            a, b = int(g.edges[eid, 0]), int(g.edges[eid, 1])
            u, v = (a, b) if vid[a] < vid[b] else (b, a)
            # Rule (1): col(u) >= k and col(v) >= k-1 required
            if colors[u] < k or colors[v] < k - 1:
                continue
            ou, ov = outset[u], outset[v]
            if len(ou) > len(ov):
                ou, ov = ov, ou
            common = [w for w in ou if w in ov]
            if len(common) < k - 2:
                continue
            common.sort(key=lambda w: int(vid[w]))
            tile_colors = [int(colors[w]) for w in common]
            if use_rule2 and len(set(tile_colors)) < k - 2:  # Rule (2)
                continue
            s = len(common)
            rows = [0] * s
            ne = 0
            for i in range(s):
                ai = adjset[common[i]]
                for j in range(i + 1, s):
                    if common[j] in ai:
                        rows[i] |= 1 << j
                        rows[j] |= 1 << i
                        ne += 1
            yield Tile((u, v), np.asarray(common, dtype=np.int64), rows, ne,
                       colors=tile_colors)
    else:
        raise ValueError(f"unknown edge-tile mode: {mode}")
