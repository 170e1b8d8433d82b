"""Localized truss-order and tile-table repair after an edge batch.

The port's copy of ``repro/delta/repair.py``: the same numpy code, so a
repaired plan's arrays are the reference's byte for byte.  It runs on the
host and takes no device; the queries over its tiles
(:mod:`repro_torch.delta.query`) run on the card.

The load-bearing facts (DESIGN.md section 13):

* **Any total edge order is correct.**  Exact-once attribution (paper
  Eq. 2) assigns each k-clique to the tile of its minimum-rank edge; the
  truss order pi_tau only controls tile-size *bounds* (Lemma 4.1).  A
  repaired order that merely approximates pi_tau near the batch is
  therefore exact, just possibly a little less tight.
* **Survivor order is preserved.**  Edges present before and after the
  batch keep their relative rank order; inserted edges receive fractional
  sort keys placed by a local support estimate.  Every rank comparison
  between two surviving edges -- which is all the untouched tiles ever
  consume -- is unchanged.
* **The touched set is closed over cliques.**  For each batch pair
  (u, v), taken against both the old and new graphs: the pair itself,
  every edge of a triangle containing it, and every edge with both
  endpoints in N(u) & N(v).  Any clique containing a batch pair consists
  entirely of such edges, so clique deltas live entirely in the
  retired-vs-replaced tiles (see :mod:`repro_torch.delta.query`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from ..core import pipeline
from ..core.graph import Graph, ragged_expand
from ..core.truss import (TrussDecomposition, edge_subset_supports)
from ..obs import trace

#: default churn threshold: when a batch touches more than this fraction
#: of the (new) edge set, local repair stops paying for itself -- the
#: spliced table approaches a full rebuild's size while the repaired
#: order drifts from pi_tau -- so repair_plan falls back to build_plan
#: and records the decision in Stats.plan_rebuilds
CHURN_THRESHOLD = 0.15

# pair-expansion budget for the common-neighborhood scan (caps peak
# index memory, mirroring pipeline._PAIR_BUDGET)
_PAIR_BUDGET = 4_000_000


@dataclasses.dataclass(frozen=True)
class RepairInfo:
    """Outcome record of one :func:`repair_plan` call.

    ``touched_old`` / ``touched_new`` are the sorted edge ids (in the old
    and new graphs respectively) whose tiles were retired / replaced --
    exactly the tile sets :func:`repro_torch.delta.query.delta_cliques` runs the
    clique delta over.  ``rebuilt`` marks the churn-threshold (or
    unsupported-family) full-rebuild fallback.
    """

    rebuilt: bool
    churn: float
    n_insert: int
    n_delete: int
    touched_old: np.ndarray
    touched_new: np.ndarray
    repair_s: float


def touched_edge_ids(g: Graph, batch_keys: np.ndarray) -> np.ndarray:
    """Sorted ids of every edge of ``g`` whose tile a batch may change.

    ``batch_keys`` are canonical u*n+v keys of the inserted+deleted pairs
    (present in ``g`` or not).  Cost is bounded by the batch pairs'
    neighborhoods: one ragged expansion finds each pair's common
    neighbors, a second (budget-sliced) expansion probes the pairs inside
    each common neighborhood.
    """
    batch_keys = np.asarray(batch_keys, dtype=np.int64)
    if batch_keys.size == 0 or g.m == 0:
        return np.zeros(0, dtype=np.int64)
    n = np.int64(g.n)
    bu, bv = batch_keys // n, batch_keys % n
    ek = g.edge_keys()
    parts: List[np.ndarray] = []
    # (1) the batch pairs that are edges of g
    hit, p = pipeline._edge_lookup(ek, g.m, g.n, bu, bv)
    parts.append(p[hit])
    # common neighborhood of each batch pair: expand the smaller
    # endpoint's adjacency, keep vertices adjacent to the other endpoint
    deg = g.degrees()
    a = np.where(deg[bu] <= deg[bv], bu, bv)
    b = np.where(deg[bu] <= deg[bv], bv, bu)
    owner, pos = ragged_expand(deg[a])
    idx = g.indptr[a][owner] + pos
    w = g.indices[idx]
    common = g.has_edges(b[owner], w) & (w != b[owner])
    ow, cw = owner[common], w[common]
    if ow.size == 0:
        return np.unique(np.concatenate(parts))
    # (2) triangle edges (u, w) and (v, w), w in N(u) & N(v)
    parts.append(g.edge_ids(bu[ow], cw))
    parts.append(g.edge_ids(bv[ow], cw))
    # (3) edges with both endpoints inside one common neighborhood: the
    # batch pair flips an internal adjacency bit of their tiles
    counts = np.bincount(ow, minlength=batch_keys.size).astype(np.int64)
    starts = np.cumsum(counts) - counts
    quad = counts ** 2
    cum = np.cumsum(quad)
    npairs = batch_keys.size
    start = 0
    while start < npairs:
        stop = int(np.searchsorted(
            cum, (cum[start - 1] if start else 0) + _PAIR_BUDGET) + 1)
        stop = max(start + 1, min(stop, npairs))
        so = counts[start:stop]
        powner, ppos = ragged_expand(so * so)
        c_rep = so[powner]
        i = ppos // c_rep
        j = ppos % c_rep
        keep = i < j
        powner, i, j = powner[keep], i[keep], j[keep]
        base = starts[start:stop][powner]
        w1 = cw[base + i]
        w2 = cw[base + j]
        hit3 = g.has_edges(w1, w2)
        parts.append(g.edge_ids(w1[hit3], w2[hit3]))
        start = stop
    return np.unique(np.concatenate(parts))


def repair_truss(g_old: Graph, td_old: TrussDecomposition, g_new: Graph,
                 recompute: Optional[np.ndarray] = None
                 ) -> TrussDecomposition:
    """Survivor-order-preserving truss order for ``g_new``.

    Surviving edges keep their relative pi_tau order from ``td_old``;
    inserted edges get fractional sort keys placed where their locally
    recomputed support first fits the survivors' (non-decreasing)
    trussness profile, with canonical edge order as the deterministic
    tie-break.  The dense argsort of those keys is the repaired order.

    ``support0`` is patched exactly for ``recompute`` ids (the touched
    set) plus all inserted edges; ``trussness`` / ``peel_support`` /
    ``tau`` are *estimates* on a repaired decomposition -- they feed only
    the next repair's placement heuristic and diagnostics, never tile
    content (the table builders consume ``rank`` alone).
    """
    ok, nk = g_old.edge_keys(), g_new.edge_keys()
    m_new = g_new.m
    if m_new == 0:
        z = np.zeros(0, dtype=np.int64)
        return TrussDecomposition(z, z, z, z, z, 0)
    pos = np.searchsorted(ok, nk)
    pos = np.clip(pos, 0, max(ok.size - 1, 0))
    surv = (ok[pos] == nk) if ok.size else np.zeros(m_new, dtype=bool)
    old_id = pos[surv]
    sortkey = np.empty(m_new, dtype=np.float64)
    sortkey[surv] = td_old.rank[old_id].astype(np.float64)
    ins_ids = np.nonzero(~surv)[0]
    if ins_ids.size:
        sup = edge_subset_supports(g_new, ins_ids)
        surv_rank = td_old.rank[old_id]
        o = np.argsort(surv_rank)
        # trussness is a running max along pi_tau, so the survivor
        # subsequence stays non-decreasing -- searchsorted is well-defined
        tr_sorted = td_old.trussness[old_id][o]
        rank_sorted = surv_rank[o].astype(np.float64)
        if rank_sorted.size == 0:
            key_ins = np.zeros(ins_ids.size, dtype=np.float64)
        else:
            at = np.searchsorted(tr_sorted, sup, side="left")
            key_ins = np.where(
                at < rank_sorted.size,
                rank_sorted[np.minimum(at, rank_sorted.size - 1)] - 0.5,
                rank_sorted[-1] + 1.0)
        sortkey[ins_ids] = key_ins
    order = np.lexsort((np.arange(m_new, dtype=np.int64), sortkey))
    rank = np.empty(m_new, dtype=np.int64)
    rank[order] = np.arange(m_new, dtype=np.int64)
    # patch support0 locally; inherit the rest from the survivors
    support0 = np.zeros(m_new, dtype=np.int64)
    support0[surv] = td_old.support0[old_id]
    redo = ins_ids if recompute is None else np.unique(
        np.concatenate([np.asarray(recompute, dtype=np.int64), ins_ids]))
    if redo.size:
        support0[redo] = edge_subset_supports(g_new, redo)
    trussness = np.zeros(m_new, dtype=np.int64)
    trussness[surv] = td_old.trussness[old_id]
    if ins_ids.size:
        trussness[ins_ids] = support0[ins_ids]
    # re-impose the running-max invariant along the repaired order (the
    # placement heuristic of the *next* repair searchsorts over this)
    trussness[order] = np.maximum.accumulate(trussness[order])
    peel = np.minimum(trussness, support0)
    tau = int(peel.max(initial=0))
    return TrussDecomposition(order=order, rank=rank, support0=support0,
                              peel_support=peel, trussness=trussness,
                              tau=tau)


def splice_truss_table(old_table: pipeline.TileTable, g_old: Graph,
                       g_new: Graph, td_new: TrussDecomposition,
                       touched_old: np.ndarray, touched_new: np.ndarray
                       ) -> pipeline.TileTable:
    """Retire touched tiles, rebuild their replacements, splice in place.

    Kept rows (tiles of untouched edges) are byte-identical member lists
    from ``old_table``; replacement rows come from the localized
    :func:`~repro_torch.core.pipeline._build_truss_table` subset build.  The
    merged table is re-sorted to the canonical tile order (descending
    owner rank), so the result is array-identical to a full table build
    under ``td_new`` -- the splice is pure bookkeeping, never semantics.
    """
    ok, nk = g_old.edge_keys(), g_new.edge_keys()
    keep = ~np.isin(old_table.edge_id, touched_old)
    kept_rows = np.nonzero(keep)[0]
    # untouched tiles belong to surviving edges by construction; their
    # ids shift because the canonical edge list re-sorts
    kept_eid_new = np.searchsorted(nk, ok[old_table.edge_id[kept_rows]])
    ksz = (old_table.offsets[kept_rows + 1]
           - old_table.offsets[kept_rows]).astype(np.int64)
    kowner, kpos = ragged_expand(ksz)
    kverts = old_table.verts[old_table.offsets[kept_rows][kowner] + kpos]
    sub = pipeline._build_truss_table(
        g_new, td_new, eids=np.asarray(touched_new, dtype=np.int64))
    edge_id = np.concatenate([kept_eid_new, sub.edge_id])
    anchors = np.concatenate(
        [old_table.anchors[kept_rows], sub.anchors], axis=0)
    sizes = np.concatenate([ksz, np.diff(sub.offsets)])
    verts_all = np.concatenate([kverts, sub.verts])
    # per-tile segment starts inside verts_all: kept segments are packed
    # contiguously into kverts, sub segments follow at a kverts offset
    kept_starts = (np.cumsum(ksz) - ksz) if ksz.size else ksz
    seg_starts = np.concatenate(
        [kept_starts, kverts.size + sub.offsets[:-1].astype(np.int64)])
    # canonical tile order: descending owner rank (ranks are unique)
    order = np.argsort(-td_new.rank[edge_id], kind="stable")
    sz_o = sizes[order]
    offsets = np.concatenate(
        [np.zeros(1, np.int64), np.cumsum(sz_o)]).astype(np.int64)
    nowner, npos = ragged_expand(sz_o)
    verts = verts_all[seg_starts[order][nowner] + npos] \
        if verts_all.size else verts_all
    eid_o = edge_id[order]
    return pipeline.TileTable(
        "truss", eid_o, anchors[order], offsets, verts,
        td_new.rank[eid_o], nk, td_new.rank)


def repair_plan(plan: pipeline.PipelinePlan, g_new: Graph,
                order: str = "hybrid", *,
                churn_threshold: float = CHURN_THRESHOLD,
                stats=None) -> "tuple[pipeline.PipelinePlan, RepairInfo]":
    """Repair ``plan`` (built on its old graph) into a plan for ``g_new``.

    Returns ``(new_plan, info)``.  The decision -- local repair vs full
    rebuild -- is recorded in ``stats`` (``plan_repairs`` /
    ``plan_rebuilds`` / ``plan_repair_s`` / ``delta_touched_edges``; a
    rebuild's cost lands in ``plan_build_s`` as usual).  Falls back to a
    rebuild when the batch touches more than ``churn_threshold`` of the
    new edge set, for the color family (its global greedy coloring has no
    local repair), or when the plan lacks a built truss decomposition.
    The repaired plan's counts and listing rows are byte-identical to a
    from-scratch plan of ``g_new`` (the mutation differential fuzz family
    asserts exactly this).
    """
    if order not in ("truss", "hybrid", "color"):
        raise ValueError(f"unknown edge-tile mode: {order}")
    g_old = plan.g
    if g_new.n != g_old.n:
        raise ValueError("apply_edge_batch preserves the vertex set; "
                         f"got n={g_old.n} -> {g_new.n}")
    t0 = time.perf_counter()
    ok, nk = g_old.edge_keys(), g_new.edge_keys()
    ins_keys = np.setdiff1d(nk, ok, assume_unique=True)
    del_keys = np.setdiff1d(ok, nk, assume_unique=True)
    batch = np.union1d(ins_keys, del_keys)
    touched_old = touched_edge_ids(g_old, batch)
    touched_new = touched_edge_ids(g_new, batch)
    # close the two sets over surviving edges: a survivor flagged on one
    # side must be retired AND rebuilt, never one without the other --
    # e.g. two deleted edges sharing a neighborhood can make w a common
    # neighbor in g_old only, so (u, w) lands in touched_old alone; an
    # unmatched retire would silently drop that tile from the splice
    # (and the mirror case would duplicate one).  The survivor maps are
    # bijective, so a single symmetric pass reaches the fixed point.
    so = np.isin(ok[touched_old], nk, assume_unique=True)
    sn = np.isin(nk[touched_new], ok, assume_unique=True)
    touched_old, touched_new = (
        np.union1d(touched_old,
                   np.searchsorted(ok, nk[touched_new][sn])),
        np.union1d(touched_new,
                   np.searchsorted(nk, ok[touched_old][so])),
    )
    churn = touched_new.size / max(g_new.m, g_old.m, 1)
    family = "color" if order == "color" else "truss"
    repairable = (family == "truss" and plan._td is not None
                  and family in plan._tables and churn <= churn_threshold)
    if not repairable:
        new_plan = pipeline.build_plan(g_new, order=order)
        dt = time.perf_counter() - t0
        if stats is not None:
            stats.plan_rebuilds += 1
            stats.plan_build_s += dt
        trace.instant("delta/rebuild", churn=round(churn, 4),
                      touched=int(touched_new.size), order=order)
        return new_plan, RepairInfo(
            True, churn, int(ins_keys.size), int(del_keys.size),
            touched_old, touched_new, dt)
    td_new = repair_truss(g_old, plan._td, g_new, recompute=touched_new)
    table = splice_truss_table(plan._tables[family], g_old, g_new, td_new,
                               touched_old, touched_new)
    new_plan = pipeline.PipelinePlan(
        g=g_new, _td=td_new, _tables={family: table})
    dt = time.perf_counter() - t0
    if stats is not None:
        stats.plan_repairs += 1
        stats.plan_repair_s += dt
        stats.delta_touched_edges += int(touched_new.size)
    trace.instant("delta/repair", churn=round(churn, 4),
                  touched=int(touched_new.size),
                  tiles=int(table.ntiles), ms=round(dt * 1e3, 3))
    return new_plan, RepairInfo(
        False, churn, int(ins_keys.size), int(del_keys.size),
        touched_old, touched_new, dt)
