"""Clique deltas from retired-vs-replaced tile sets (DESIGN.md 13).

The port's copy of ``repro/delta/query.py``.  Untouched tiles produce
bit-identical cliques before and after a batch (their member lists,
internal adjacency, and relative ranks are all preserved by the repair),
and every clique containing a batch pair lives entirely inside touched
tiles.  So the clique delta of a batch is exactly

    lost   = cliques(retired tiles of the old plan)  \\ cliques(replaced)
    gained = cliques(replaced tiles of the new plan) \\ cliques(retired)

Both subsets run through the *standard* listing machinery -- a subset
:class:`~repro_torch.core.pipeline.TileTable` wrapped in a shim plan is
indistinguishable from a full plan to ``iter_tiles``/``stream_batches``
-- so delta queries inherit every engine path (packed device batches,
spill handling, the host recursion) without new kernels.

One deliberate difference from the reference: :func:`delta_cliques` and
:func:`delta_net_count` default to the port's device engines
(``backend="torch"``, ``device=None``: the CUDA device, raising without
one, as ``ebbkc.count`` / ``list_cliques`` do), so a delta lists through
the list kernel (and its count-pass kernels) and a net count runs the
count kernels; the reference defaults to its host recursion.
``backend="host"`` runs the recursion when asked, and ``device="cpu"``
the plain torch versions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..core import ebbkc, pipeline
from ..core.graph import ragged_expand
from ..obs import trace
from .repair import RepairInfo


def rows_sorted(rows: np.ndarray) -> np.ndarray:
    """Canonical presentation: rows (already sorted within) lexsorted."""
    if rows.shape[0] == 0:
        return rows
    return rows[np.lexsort(rows.T[::-1])]


def _row_keys(a: np.ndarray, b: np.ndarray):
    """Each row of ``a`` and ``b`` as one int64, its vertex ids the digits
    of a number in base ``max id + 1`` (so key order is the rows' lexical
    order), with that base; or None when a side is empty, an id is negative
    or a key would not fit in 63 bits.  Equal rows get equal keys."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return None
    base = int(max(a.max(), b.max())) + 1
    if min(a.min(), b.min()) < 0 or base ** a.shape[1] >= 1 << 63:
        return None
    w = base ** np.arange(a.shape[1] - 1, -1, -1, dtype=np.int64)
    return a.astype(np.int64) @ w, b.astype(np.int64) @ w, base


def _in_sorted(keys: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Boolean mask over ``keys``: present in the sorted, non-empty
    ``ref``: one binary search a key (numpy starts each at the last one's
    result when ``keys`` is sorted too)."""
    at = np.minimum(np.searchsorted(ref, keys), ref.size - 1)
    return ref[at] == keys


def _membership(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Boolean mask over ``a``'s rows: present in ``b`` (rows canonical).

    Rows that pack into one int64 each are matched on those keys by sorts
    and binary searches; others by the reference's ``np.unique`` over the
    rows.  Both give the same mask.  (``np.isin`` on the keys runs numpy's
    hash-based unique on both sides in recent numpy releases, seconds a
    million rows: PERF.md, Findings of the delta port.)"""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros(a.shape[0], dtype=bool)
    keys = _row_keys(a, b)
    if keys is not None:
        ka, kb, _ = keys
        order = np.argsort(ka)
        hit = np.empty(ka.size, dtype=bool)
        hit[order] = _in_sorted(ka[order], np.sort(kb))
        return hit
    both = np.concatenate([a, b], axis=0)
    _, inv = np.unique(both, axis=0, return_inverse=True)
    inv_a, inv_b = inv[: a.shape[0]], inv[a.shape[0]:]
    hit = np.zeros(int(inv.max()) + 1, dtype=bool)
    hit[inv_b] = True
    return hit[inv_a]


def rows_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Set difference a \\ b over clique rows (each row vertex-sorted)."""
    return a[~_membership(a, b)]


def _sorted_diffs(a: np.ndarray, b: np.ndarray):
    """``(rows_sorted(rows_diff(a, b)), rows_sorted(rows_diff(b, a)))``.

    Where rows pack into int64 keys, both sides' keys are sorted once and
    the rows left over are decoded from their keys, already in lexical
    order: no argsort back to listing order and no lexsort after."""
    keys = _row_keys(a, b)
    if keys is None:
        return rows_sorted(rows_diff(a, b)), rows_sorted(rows_diff(b, a))
    ka, kb, base = np.sort(keys[0]), np.sort(keys[1]), keys[2]
    w = base ** np.arange(a.shape[1] - 1, -1, -1, dtype=np.int64)

    def rows(k):
        return (k[:, None] // w) % base
    return rows(ka[~_in_sorted(ka, kb)]), rows(kb[~_in_sorted(kb, ka)])


def rows_union(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Set union over clique rows, deduplicated, canonically sorted."""
    if a.shape[0] == 0:
        return rows_sorted(b.copy())
    if b.shape[0] == 0:
        return rows_sorted(a.copy())
    return np.unique(np.concatenate([a, b], axis=0), axis=0)


def subset_table(table: pipeline.TileTable, eids: np.ndarray
                 ) -> pipeline.TileTable:
    """A TileTable holding only the tiles owned by edges in ``eids``.

    Row order, member order, thresholds, and the shared ``ekeys`` /
    ``erank`` arrays are preserved, so packing a subset tile is
    byte-identical to packing the same tile out of the full table.
    """
    keep = np.isin(table.edge_id, np.asarray(eids, dtype=np.int64))
    rows = np.nonzero(keep)[0]
    sz = (table.offsets[rows + 1] - table.offsets[rows]).astype(np.int64)
    owner, pos = ragged_expand(sz)
    verts = table.verts[table.offsets[rows][owner] + pos] \
        if rows.size else table.verts[:0]
    offsets = np.concatenate(
        [np.zeros(1, np.int64), np.cumsum(sz)]).astype(np.int64)
    kw = {}
    for opt in ("member_colors", "ncolors", "rule1"):
        val = getattr(table, opt)
        if val is not None:
            kw[opt] = val[table.offsets[rows][owner] + pos] \
                if opt == "member_colors" else val[rows]
    return pipeline.TileTable(
        table.family, table.edge_id[rows], table.anchors[rows], offsets,
        verts, table.thresh[rows], table.ekeys, table.erank, **kw)


def subset_plan(plan: pipeline.PipelinePlan, order: str,
                eids: np.ndarray) -> pipeline.PipelinePlan:
    """Shim plan restricted to the tiles of ``eids`` (standard machinery).

    The table is pre-populated, so consumers never trigger a lazy
    rebuild; the graph rides along for adjacency probes at pack time.
    """
    family = "color" if order == "color" else "truss"
    return pipeline.PipelinePlan(
        g=plan.g, _td=plan._td, _colors=plan._colors,
        _tables={family: subset_table(plan.table(order), eids)})


@dataclasses.dataclass(frozen=True)
class DeltaResult:
    """Cliques gained/lost by one batch (or a composed version range)."""

    k: int
    gained: np.ndarray  # (ng, k) int64, rows vertex-sorted, lexsorted
    lost: np.ndarray    # (nl, k) int64

    @property
    def net(self) -> int:
        """Net clique-count change (gained minus lost)."""
        return int(self.gained.shape[0] - self.lost.shape[0])


def _sides(old_plan, new_plan, info: RepairInfo, order: str):
    """The (old, new) plans a delta query runs over: the retired and
    replaced tiles after a local repair, the whole plans after a rebuild
    (its ranks moved arbitrarily, so there is no touched subset to
    exploit for the new side's attribution)."""
    if info.rebuilt:
        return old_plan, new_plan
    return (subset_plan(old_plan, order, info.touched_old),
            subset_plan(new_plan, order, info.touched_new))


def delta_cliques(old_plan: pipeline.PipelinePlan,
                  new_plan: pipeline.PipelinePlan, info: RepairInfo,
                  k: int, order: str = "hybrid", *,
                  backend: str = "torch", device=None,
                  engine_kwargs: Optional[dict] = None) -> DeltaResult:
    """Exact per-batch clique delta from the touched tile sets.

    Lists the retired tiles against the old plan and the replaced tiles
    against the new plan (``backend`` / ``device`` / ``engine_kwargs``
    forward to :func:`repro_torch.core.ebbkc.list_cliques`: the list
    kernel on the CUDA device by default), then set-differences the two
    row sets.  After a churn-fallback rebuild both sides list in full --
    still exact, just not localized.
    """
    if k < 3:
        raise ValueError("delta queries require k >= 3")
    side_old, side_new = _sides(old_plan, new_plan, info, order)
    with trace.span("delta/list", side="old", rebuilt=info.rebuilt):
        rows_old, _ = ebbkc.list_cliques(
            side_old.g, k, order=order, plan=side_old, backend=backend,
            device=device, engine_kwargs=engine_kwargs)
    with trace.span("delta/list", side="new", rebuilt=info.rebuilt):
        rows_new, _ = ebbkc.list_cliques(
            side_new.g, k, order=order, plan=side_new, backend=backend,
            device=device, engine_kwargs=engine_kwargs)
    with trace.span("delta/diff", old=rows_old.shape[0],
                    new=rows_new.shape[0]):
        gained, lost = _sorted_diffs(rows_new, rows_old)
    return DeltaResult(k=k, gained=gained, lost=lost)


def delta_net_count(old_plan: pipeline.PipelinePlan,
                    new_plan: pipeline.PipelinePlan, info: RepairInfo,
                    k: int, order: str = "hybrid", *,
                    backend: str = "torch", device=None,
                    engine_kwargs: Optional[dict] = None
                    ) -> Tuple[int, int, int]:
    """(count_retired, count_replaced, net) via the counting engines.

    The cheap consistency probe paired with :func:`delta_cliques`:
    ``net == replaced - retired`` must equal ``gained - lost`` of the
    listing-based delta, and serves as the device path when only the net
    change is needed (the count kernels on the CUDA device by default).
    """
    if k < 3:
        raise ValueError("delta queries require k >= 3")
    side_old, side_new = _sides(old_plan, new_plan, info, order)
    c_old = ebbkc.count(side_old.g, k, order=order, plan=side_old,
                        backend=backend, device=device,
                        engine_kwargs=engine_kwargs).count
    c_new = ebbkc.count(side_new.g, k, order=order, plan=side_new,
                        backend=backend, device=device,
                        engine_kwargs=engine_kwargs).count
    return int(c_old), int(c_new), int(c_new - c_old)
