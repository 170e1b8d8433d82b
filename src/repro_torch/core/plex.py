"""Early-termination on dense branches (paper Section 5).

A branch graph g that is a t-plex (every vertex has at most t non-neighbors
including itself) can be finished without further BB branching:

* t <= 2: closed-form / combinatorial (kC2Plex, Alg. 6).  The vertex set
  partitions into F (universal vertices) and a perfect matching of
  non-adjacent pairs L+R.  An l-clique takes any c vertices from F and any
  j = l-c vertices from the p pairs, at most one per pair:

      count(l) = sum_c C(|F|, c) * C(p, l-c) * 2^(l-c)

  TPU adaptation: the whole ET becomes branch-free arithmetic.

* t >= 3: kCtPlex (Alg. 7) branches on the sparse inverse graph.  The
  count-only adaptation keeps its key ingredient -- factoring out the
  universal set I combinatorially -- and finishes the (small) non-universal
  remainder with the generic engine.

The listing enumerators (``list_2plex``, ``list_tplex``) finish the host
relist of overflowed and spilled tiles in the listing engine.
"""
from __future__ import annotations

from math import comb
from typing import Iterator, List, Sequence, Tuple

from .bitops import bits, mask_gt, popcount


def plexity(rows: Sequence[int], cand: int) -> Tuple[int, int]:
    """Return (nv, t) where the candidate-induced graph is a t-plex.

    t = nv - min_degree_within (counting the vertex itself as a non-neighbor).
    """
    nv = popcount(cand)
    if nv == 0:
        return 0, 0
    mind = min(popcount(rows[v] & cand) for v in bits(cand))
    return nv, nv - mind


def split_universal(rows: Sequence[int], cand: int) -> Tuple[int, int]:
    """(F, rest): F = vertices adjacent to all other cand vertices."""
    nv = popcount(cand)
    F = 0
    for v in bits(cand):
        if popcount(rows[v] & cand) == nv - 1:
            F |= 1 << v
    return F, cand & ~F


def count_2plex(f: int, p: int, l: int) -> int:
    """l-cliques in (f universal vertices) + (p disjoint non-adjacent pairs)."""
    total = 0
    for c in range(max(0, l - p), min(l, f) + 1):
        j = l - c
        total += comb(f, c) * comb(p, j) * (1 << j)
    return total


def count_in_2plex(rows: Sequence[int], cand: int, l: int) -> int:
    F, rest = split_universal(rows, cand)
    p, r = divmod(popcount(rest), 2)
    assert r == 0, "2-plex non-universal part must pair up"
    return count_2plex(popcount(F), p, l)


def match_pairs(rows: Sequence[int], rest: int) -> List[Tuple[int, int]]:
    """Pair each non-universal 2-plex vertex with its unique non-neighbor."""
    pairs = []
    seen = 0
    for v in bits(rest):
        if (seen >> v) & 1:
            continue
        non = rest & ~rows[v] & ~(1 << v)
        w = next(bits(non))
        pairs.append((v, w))
        seen |= (1 << v) | (1 << w)
    return pairs


def list_2plex(rows: Sequence[int], cand: int, l: int) -> Iterator[Tuple[int, ...]]:
    """kC2Plex (Alg. 6): enumerate l-cliques combinatorially.

    Yields tuples of local vertex ids.
    """
    from itertools import combinations

    F, rest = split_universal(rows, cand)
    Fl = list(bits(F))
    pairs = match_pairs(rows, rest)
    p = len(pairs)
    if len(Fl) + p < l:  # |F| + |L| < l -> nothing (Alg. 6 line 2)
        return
    for c1 in range(max(0, l - p), min(l, len(Fl)) + 1):
        for fsub in combinations(Fl, c1):
            j = l - c1
            for psub in combinations(range(p), j):
                # each chosen pair contributes one of its two endpoints
                for sel in range(1 << j):
                    out = list(fsub)
                    for t, pi in enumerate(psub):
                        out.append(pairs[pi][(sel >> t) & 1])
                    yield tuple(out)


def list_tplex(rows: Sequence[int], cand: int, l: int) -> Iterator[Tuple[int, ...]]:
    """kCtPlex (Alg. 7): branch on the inverse graph; I factored via combos."""
    from itertools import combinations

    inv = {v: cand & ~rows[v] & ~(1 << v) for v in bits(cand)}
    I = 0
    for v in bits(cand):
        if inv[v] == 0:
            I |= 1 << v
    Il = list(bits(I))
    C0 = cand & ~I

    def rec(S: Tuple[int, ...], C: int, lp: int) -> Iterator[Tuple[int, ...]]:
        if lp == 0:
            yield S
            return
        if len(Il) >= lp:
            for isub in combinations(Il, lp):
                yield S + isub
        # choose at least one vertex from C
        for v in bits(C):
            Ci = C & mask_gt(v) & ~inv[v]
            if popcount(Ci) + len(Il) >= lp - 1:
                yield from rec(S + (v,), Ci, lp - 1)

    yield from rec((), C0, l)
