"""Plain k-clique counting and row checking, for the benchmark's verdict.

This module imports numpy and torch only: nothing of the program under
test, so its answers are worked out again from the edge list both sides
were handed.  The algorithm is deliberately not the program's: vertices
are ranked by a degeneracy (core) order, every edge points from the lower
to the higher rank, and each vertex's out-neighbourhood (at most the
degeneracy many vertices, here 64-88) becomes a bitset adjacency.  A
frontier of (vertex, candidate bitset) items then grows one clique vertex
a level, in blocks of bounded size, and at the last level each item adds
the popcount of its candidates.  Every k-clique is enumerated once, in
increasing rank order.  Counts are summed in int64; the ``accumulate``
switch exists only for the control, which sums the same partial counts in
float32 to show that a lower precision fails the verdict.
"""
from __future__ import annotations

import heapq
from typing import Dict, Optional

import numpy as np
import torch

#: pairs (item, candidate) a block of the frontier may expand at once
DEFAULT_BUDGET = 1 << 24

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_BYTE_BITS = torch.tensor([[(b >> i) & 1 for i in range(8)] for b in range(256)],
                          dtype=torch.bool)


def canonical_edges(n: int, pairs: np.ndarray) -> np.ndarray:
    """(m, 2) int64 edges u < v, sorted and unique, self loops dropped."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    lo = np.minimum(pairs[:, 0], pairs[:, 1])
    hi = np.maximum(pairs[:, 0], pairs[:, 1])
    keep = lo != hi
    if keep.any() and (lo[keep].min() < 0 or hi[keep].max() >= n):
        raise ValueError(f"edge endpoints outside [0, {n})")
    keys = np.unique(lo[keep] * np.int64(n) + hi[keep])
    return np.stack([keys // n, keys % n], axis=1)


def degeneracy_rank(n: int, edges: np.ndarray) -> np.ndarray:
    """rank[v]: position of v in a smallest-degree-first peeling order."""
    deg = np.bincount(edges.ravel(), minlength=n).astype(np.int64)
    order = np.argsort(np.concatenate([edges[:, 0], edges[:, 1]]),
                       kind="stable")
    nbrs = np.concatenate([edges[:, 1], edges[:, 0]])[order]
    ptr = np.concatenate([[0], np.cumsum(deg)])
    cur = deg.copy()
    gone = np.zeros(n, dtype=bool)
    heap = [(int(cur[v]), v) for v in range(n)]
    heapq.heapify(heap)
    rank = np.empty(n, dtype=np.int64)
    pos = 0
    while heap:
        d, v = heapq.heappop(heap)
        if gone[v] or d != cur[v]:
            continue
        gone[v] = True
        rank[v] = pos
        pos += 1
        for w in nbrs[ptr[v]:ptr[v + 1]].tolist():
            if not gone[w]:
                cur[w] -= 1
                heapq.heappush(heap, (int(cur[w]), w))
    return rank


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each row of an (N, W) int64 tensor, as (N,) int64."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return (x & 0x7F).sum(dim=1)


def _unpack(x: torch.Tensor, width: int) -> torch.Tensor:
    """(N, W) int64 bitsets -> (N, width) bool, bit j of word j // 64."""
    lut = _BYTE_BITS.to(x.device)
    raw = x.contiguous().view(torch.uint8)
    return lut[raw.long()].reshape(x.shape[0], -1)[:, :width]


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., W * 64) bool -> (..., W) int64; distinct powers of two add as OR."""
    shape = bits.shape[:-1]
    w = bits.shape[-1] // 64
    pow2 = torch.ones(64, dtype=torch.int64, device=bits.device) \
        << torch.arange(64, device=bits.device)
    return (bits.reshape(*shape, w, 64).long() * pow2).sum(-1)


def local_bitsets(n: int, edges: np.ndarray, device):
    """Every vertex's out-neighbourhood as bitset rows.

    Vertices are numbered by rank.  Returns ``(rows, deg, D, out, label)``:
    ``rows[a, i]`` holds, for the i-th out-neighbour x of a (in rank
    order), the bits j > i whose out-neighbour y is adjacent to x;
    ``deg[a]`` is a's out-degree and ``D`` the largest; ``out[a, i]`` is
    the rank of that i-th out-neighbour (-1 past ``deg[a]``) and
    ``label[r]`` the vertex of rank r.
    """
    rank = degeneracy_rank(n, edges)
    ra, rb = rank[edges[:, 0]], rank[edges[:, 1]]
    lo, hi = np.minimum(ra, rb), np.maximum(ra, rb)
    keys = np.sort(lo * np.int64(n) + hi)
    lo, hi = keys // n, keys % n
    deg = np.bincount(lo, minlength=n)
    D = int(deg.max()) if len(keys) else 0
    W = max(1, (D + 63) // 64)
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    col = np.arange(len(keys)) - np.repeat(start, deg)
    out = torch.full((n, max(D, 1)), -1, dtype=torch.int64, device=device)
    out[torch.as_tensor(lo, device=device), torch.as_tensor(col, device=device)] \
        = torch.as_tensor(hi, device=device)
    keys_t = torch.as_tensor(keys, device=device)
    adj = torch.zeros((n, max(D, 1), W * 64), dtype=torch.bool, device=device)
    if D >= 2:
        ii, jj = torch.triu_indices(D, D, offset=1, device=device)
        for c0 in range(0, ii.numel(), 1 << 12):  # bounded (n, pairs) blocks
            i, j = ii[c0:c0 + (1 << 12)], jj[c0:c0 + (1 << 12)]
            x, y = out[:, i], out[:, j]
            q = x * n + y
            pos = torch.searchsorted(keys_t, q).clamp_(max=max(len(keys) - 1, 0))
            hit = (keys_t[pos] == q) & (x >= 0) & (y >= 0)
            a, p = hit.nonzero(as_tuple=True)
            adj[a, i[p], j[p]] = True
    label = torch.as_tensor(np.argsort(rank), device=device)
    return _pack(adj), torch.as_tensor(deg, device=device), D, out, label


def count_kcliques(n: int, edges: np.ndarray, k: int, device="cpu",
                   accumulate: str = "int64",
                   budget: int = DEFAULT_BUDGET) -> int:
    """The number of k-cliques of the graph on ``edges`` (canonical, u < v).

    ``accumulate="float32"`` sums the same partial counts in float32 (the
    control); the default sums exactly in int64.
    """
    if k < 1:
        raise ValueError("k >= 1 required")
    if k == 1:
        return n
    if k == 2:
        return len(edges)
    rows, deg, D, _, _ = local_bitsets(n, edges, device)
    valid = torch.arange(rows.shape[1], device=device)[None, :] < deg[:, None]
    a, i = valid.nonzero(as_tuple=True)
    exact = accumulate == "int64"
    if not exact and accumulate != "float32":
        raise ValueError(f"unknown accumulate {accumulate!r}")
    total = [0 if exact else torch.zeros((), dtype=torch.float32,
                                         device=device)]

    def add(pc: torch.Tensor) -> None:
        if exact:
            total[0] += int(pc.sum())
        else:
            total[0] = total[0] + pc.to(torch.float32).sum()

    def grow(a: torch.Tensor, cand: torch.Tensor, r: int) -> None:
        pc = popcount(cand)
        if r == 1:
            add(pc)
            return
        keep = pc >= r  # fewer candidates than vertices still needed
        a, cand, pc = a[keep], cand[keep], pc[keep]
        if a.numel() == 0:
            return
        for lo, hi in _blocks(pc, budget):
            blk_a, blk_c = a[lo:hi], cand[lo:hi]
            it, j = _unpack(blk_c, D).nonzero(as_tuple=True)
            grow(blk_a[it], blk_c[it] & rows[blk_a[it], j], r - 1)

    grow(a, rows[a, i], k - 2)
    return total[0] if exact else int(round(float(total[0].item())))


def _blocks(pc: torch.Tensor, budget: int):
    """(lo, hi) item ranges whose popcounts sum to about ``budget``."""
    ends = torch.cumsum(pc, 0)
    cuts = torch.searchsorted(
        ends, torch.arange(budget, int(ends[-1]) + budget, budget,
                           device=pc.device), right=True).tolist()
    lo = 0
    for hi in cuts:
        hi = max(hi, lo + 1)
        if lo >= pc.numel():
            return
        yield lo, hi
        lo = hi


def list_kcliques(n: int, edges: np.ndarray, k: int, device="cpu",
                  cap: Optional[int] = None,
                  budget: int = DEFAULT_BUDGET) -> np.ndarray:
    """Every k-clique (k >= 3) as an (R, k) int64 array, each row ascending.

    Rows are grouped by their anchor, the clique's two lowest-ranked
    vertices.  ``cap`` keeps only the first ``cap`` rows of each anchor,
    as a fixed emit buffer that truncates on overflow would: the control
    of a listing cell, never the reference.
    """
    if k < 3:
        raise ValueError("k >= 3 required")
    rows, deg, D, out, label = local_bitsets(n, edges, device)
    valid = torch.arange(rows.shape[1], device=device)[None, :] < deg[:, None]
    a, i = valid.nonzero(as_tuple=True)
    found = []

    def grow(anchor, a, prefix, cand, r):
        pc = popcount(cand)
        keep = pc >= r
        anchor, a, prefix, cand, pc = (anchor[keep], a[keep], prefix[keep],
                                       cand[keep], pc[keep])
        if a.numel() == 0:
            return
        for lo, hi in _blocks(pc, budget):
            it, j = _unpack(cand[lo:hi], D).nonzero(as_tuple=True)
            b_a = a[lo:hi][it]
            grown = torch.cat([prefix[lo:hi][it], out[b_a, j][:, None]], 1)
            if r == 1:
                found.append((anchor[lo:hi][it], grown))
            else:
                grow(anchor[lo:hi][it], b_a, grown,
                     cand[lo:hi][it] & rows[b_a, j], r - 1)

    grow(torch.arange(a.numel(), device=device), a,
         torch.stack([a, out[a, i]], 1), rows[a, i], k - 2)
    if not found:
        return np.zeros((0, k), dtype=np.int64)
    anchor = torch.cat([f[0] for f in found])
    ranks = torch.cat([f[1] for f in found])
    if cap is not None:
        anchor, order = torch.sort(anchor, stable=True)
        ranks = ranks[order]
        first = torch.searchsorted(anchor, anchor)
        ranks = ranks[torch.arange(anchor.numel(), device=device) - first < cap]
    return torch.sort(label[ranks], dim=1).values.cpu().numpy()


def edge_keys(n: int, edges: np.ndarray, device) -> torch.Tensor:
    """Sorted int64 keys u * n + v of canonical edges, on ``device``."""
    return torch.as_tensor(edges[:, 0] * np.int64(n) + edges[:, 1],
                           device=device)


def check_rows(n: int, keys: torch.Tensor, rows: np.ndarray,
               block: int = 1 << 22) -> Dict[str, int]:
    """Check listed clique rows against the edge list.

    ``keys`` are :func:`edge_keys`.  A row is invalid unless its ids lie in
    ``[0, n)``, increase strictly along the row and are pairwise adjacent;
    ``duplicates`` counts rows equal to an earlier row.  With every row
    valid and distinct, a row count equal to the exact k-clique count means
    the rows are exactly the graph's k-cliques.
    """
    device = keys.device
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    R, k = rows.shape
    invalid = 0
    bits = max(1, int(n - 1).bit_length())
    one_key = bits * k <= 63
    row_keys = []
    for r0 in range(0, R, block):
        r = torch.as_tensor(rows[r0:r0 + block], device=device)
        ok = ((r >= 0) & (r < n)).all(dim=1)
        if k > 1:
            ok &= (r[:, 1:] > r[:, :-1]).all(dim=1)
        for p in range(k):
            for q in range(p + 1, k):
                key = r[:, p] * n + r[:, q]
                pos = torch.searchsorted(keys, key).clamp_(max=keys.numel() - 1)
                ok &= keys[pos] == key
        invalid += int((~ok).sum())
        if one_key:
            rk = torch.zeros(r.shape[0], dtype=torch.int64, device=device)
            for p in range(k):
                rk = (rk << bits) | r[:, p].clamp(0, n - 1)
            row_keys.append(rk)
        else:
            row_keys.append(r)
    if not row_keys:
        return {"rows": 0, "invalid": 0, "duplicates": 0}
    allk = torch.cat(row_keys)
    if one_key:
        distinct = int(torch.unique(allk).numel())
    else:
        distinct = int(torch.unique(allk, dim=0).shape[0])
    return {"rows": R, "invalid": invalid, "duplicates": R - distinct}
