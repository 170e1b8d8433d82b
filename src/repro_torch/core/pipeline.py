"""Unified streaming tile pipeline: CSR -> tau-bounded tiles -> packed batches.

The PyTorch port's copy of the reference front end.  The paper's top-level
edge branching produces one tau-bounded tile per edge (Lemma 4.1);
producing those tiles is the only data-dependent part of the dataflow, and
it runs vectorized in numpy on the host:

1. **Membership table** (the :class:`TileTable` build functions): one bulk ragged CSR
   expansion enumerates, for every edge at once, the common neighbors that
   survive the ordering filter (pi_tau rank for truss/hybrid, color-DAG
   position for color mode).  The table is *k-independent*, so a
   :class:`PipelinePlan` amortizes all preprocessing across queries on one
   graph.
2. **Capacity-based streaming batcher** (:func:`stream_batches`): tiles are
   routed to size bins (multiples of 32; powers of two by default) and
   packed ``batch_size`` at a time
   into fixed-shape ``(B, T, W)`` uint32 bitset batches, optionally on a
   pool of pack threads.  Tiles wider than the largest bin are yielded as
   plain :class:`~repro_torch.core.tiles.Tile` objects so the engine can
   spill them to the host recursion.

The numpy code is kept identical to the reference so both packages pack
byte-identical batches; the pure-Python extractor in
:mod:`repro_torch.core.tiles` is the oracle.

The reference's ``trace`` spans (``plan/build``, ``plan/build_wait``,
``plan/load``, ``extract``, ``pack``, ``pack/wait``, the
``plan/cache_hit`` instant) and its fault sites (``plan.load``; ``extract``
and ``pack``, whose injected faults are retried in place before the
stage's work) sit where the reference has them.  Plans persist through
:mod:`repro_torch.checkpoint.store` (:func:`save_plan`, :func:`load_plan`,
``cached_plan(cache_dir=...)``) in the reference's store format, so a plan
store written by either package loads in the other.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import hashlib
import itertools
import os
import threading
import time
from typing import Deque, Dict, Iterator, List, Optional, Sequence, Tuple, \
    Union

import numpy as np

from .bitops import pack_bits as _pack_bits
from .graph import Graph, greedy_coloring, color_vertex_order, ragged_expand
from .tiles import Tile
from .truss import TrussDecomposition, truss_decomposition
from ..obs import trace
from ..resilience import inject
from ..resilience import retry as fault_retry

#: power-of-two tile-size bins; tiles wider than the last bin spill to host
BINS = (32, 64, 128, 256)


def _edge_lookup(ekeys: np.ndarray, m: int, n: int, lo: np.ndarray,
                 hi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Membership probe for canonical pairs (lo < hi) against the sorted
    edge keys ``u * n + v``.

    Returns (hit mask, position in the sorted key array) -- position is
    only meaningful where ``hit``; callers needing the edge id (e.g. for a
    pi_tau rank lookup) index with it.  This is the single home of the
    searchsorted/clip/equality idiom; keep the key encoding in sync with
    :meth:`repro_torch.core.graph.Graph.edge_keys`.
    """
    keys = lo * np.int64(n) + hi
    p = np.searchsorted(ekeys, keys)
    p = np.clip(p, 0, max(m - 1, 0))
    hit = (ekeys[p] == keys) if m else np.zeros(0, dtype=bool)
    return hit, p


def _group_offsets(E: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Segment boundaries of a value-sorted owner array.

    Returns (offsets (nt+1,), first index of each segment) -- the ragged
    tile layout shared by both membership-table build functions.
    """
    if E.size:
        starts = np.concatenate(
            [[0], np.nonzero(np.diff(E) != 0)[0] + 1]).astype(np.int64)
        offsets = np.concatenate([starts, [E.size]]).astype(np.int64)
        return offsets, starts
    return np.zeros(1, dtype=np.int64), np.zeros(0, dtype=np.int64)


# ---------------------------------------------------------------------------
# k-independent membership tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TileTable:
    """Per-edge candidate-tile membership under one ordering family.

    ``family`` is "truss" (shared by truss and hybrid modes: members are the
    common neighbors reachable via edges ranked after e in pi_tau) or
    "color" (members are common out-neighbors in the color DAG).  Everything
    here is independent of k; :meth:`select` applies the k-dependent
    filters.
    """
    family: str
    edge_id: np.ndarray           # (nt,) source edge id per candidate tile
    anchors: np.ndarray           # (nt, 2) anchor vertices (S of Eq. 2)
    offsets: np.ndarray           # (nt+1,) ragged offsets into ``verts``
    verts: np.ndarray             # flat member vertices, canonical inner order
    thresh: np.ndarray            # (nt,) truss: rank(e); color: 0
    ekeys: np.ndarray             # sorted canonical edge keys (adjacency test)
    erank: Optional[np.ndarray]   # truss: pi_tau rank per edge id
    member_colors: Optional[np.ndarray] = None  # color: flat member colors
    ncolors: Optional[np.ndarray] = None        # color: distinct per tile
    rule1: Optional[np.ndarray] = None          # color: (nt,2) endpoint colors

    @property
    def ntiles(self) -> int:
        """Number of tiles in the table."""
        return int(self.edge_id.shape[0])

    def sizes(self) -> np.ndarray:
        """Per-tile candidate counts (``offsets`` diffs)."""
        return np.diff(self.offsets)

    def select(self, k: int, use_rule2: bool = True) -> np.ndarray:
        """Candidate tile ids surviving the k filters, canonical order."""
        keep = self.sizes() >= max(k - 2, 1)
        if self.family == "color":
            keep &= (self.rule1[:, 0] >= k) & (self.rule1[:, 1] >= k - 1)
            if use_rule2:
                keep &= self.ncolors >= k - 2
        return np.nonzero(keep)[0]


def _build_truss_table(g: Graph, td: TrussDecomposition,
                       eids: Optional[np.ndarray] = None) -> TileTable:
    """Truss-family membership table; ``eids`` restricts to a sorted
    subset of owner edges (the localized rebuild :mod:`repro_torch.delta`
    splices into a repaired plan -- cost bounded by those edges'
    neighborhoods instead of m)."""
    ek = g.edge_keys()
    m = g.m
    sub = np.arange(m, dtype=np.int64) if eids is None \
        else np.asarray(eids, dtype=np.int64)
    if m == 0 or sub.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return TileTable("truss", z, np.zeros((0, 2), np.int64),
                         np.zeros(1, np.int64), z, z, ek, td.rank)
    deg = np.diff(g.indptr)
    u, v = g.edges[sub, 0], g.edges[sub, 1]
    swap = deg[u] > deg[v]
    a = np.where(swap, v, u)
    b = np.where(swap, u, v)
    r_e = td.rank
    owner, pos = ragged_expand(deg[a])
    idx = g.indptr[a][owner] + pos
    w = g.indices[idx]
    own_e = sub[owner]
    # pi_tau rank of the CSR edge (a, w) at each expanded slot: one bulk
    # 2m-key probe when building the whole table, per-slot probes (cost
    # bounded by the subset's neighborhoods) for a localized rebuild
    if eids is None:
        src = np.repeat(np.arange(g.n, dtype=np.int64), deg)
        rank_aw = td.rank[g.edge_ids(src, g.indices)][idx]
    else:
        rank_aw = r_e[g.edge_ids(a[owner], w)]
    keep = (rank_aw > r_e[own_e]) & (w != b[owner])
    own_e, w, bb = own_e[keep], w[keep], b[owner][keep]
    hit, p = _edge_lookup(ek, m, g.n, np.minimum(bb, w), np.maximum(bb, w))
    hit &= r_e[p] > r_e[own_e]
    E, W = own_e[hit], w[hit]
    # canonical order: reverse pi_tau over tiles, ascending vertex id inside
    order = np.lexsort((W, -r_e[E]))
    E, W = E[order], W[order]
    offsets, starts = _group_offsets(E)
    tile_edge = E[starts]
    return TileTable("truss", tile_edge, g.edges[tile_edge],
                     offsets, W, r_e[tile_edge], ek, td.rank)


def _build_color_table(g: Graph, colors: np.ndarray) -> TileTable:
    ek = g.edge_keys()
    m = g.m
    if m == 0:
        z = np.zeros(0, dtype=np.int64)
        return TileTable("color", z, np.zeros((0, 2), np.int64),
                         np.zeros(1, np.int64), z, z, ek, None,
                         member_colors=z, ncolors=z,
                         rule1=np.zeros((0, 2), np.int64))
    vorder = color_vertex_order(colors)
    vid = np.empty(g.n, dtype=np.int64)
    vid[vorder] = np.arange(g.n)
    u0, v0 = g.edges[:, 0], g.edges[:, 1]
    swapc = vid[u0] > vid[v0]
    ulo = np.where(swapc, v0, u0)
    vhi = np.where(swapc, u0, v0)
    deg = np.diff(g.indptr)
    a = np.where(deg[ulo] <= deg[vhi], ulo, vhi)
    b = np.where(deg[ulo] <= deg[vhi], vhi, ulo)
    owner, pos = ragged_expand(deg[a])
    idx = g.indptr[a][owner] + pos
    w = g.indices[idx]
    # member iff vid[w] beyond both endpoints (DAG out-neighbor of each)
    keep = (vid[w] > vid[vhi][owner]) & (w != b[owner])
    owner, w = owner[keep], w[keep]
    bb = b[owner]
    hit, _ = _edge_lookup(ek, m, g.n, np.minimum(bb, w), np.maximum(bb, w))
    E, W = owner[hit], w[hit]
    # canonical order: edge id ascending, members by color-DAG position
    order = np.lexsort((vid[W], E))
    E, W = E[order], W[order]
    offsets, starts = _group_offsets(E)
    tile_edge = E[starts]
    mcol = colors[W]
    nt = tile_edge.size
    sizes = np.diff(offsets)
    tid_rep, _ = ragged_expand(sizes)
    if E.size:
        o2 = np.lexsort((mcol, tid_rep))
        c2, t2 = mcol[o2], tid_rep[o2]
        new = np.concatenate([[True], (t2[1:] != t2[:-1]) |
                              (c2[1:] != c2[:-1])])
        ncolors = np.bincount(t2[new], minlength=nt)
    else:
        ncolors = np.zeros(0, dtype=np.int64)
    rule1 = np.stack([colors[ulo[tile_edge]], colors[vhi[tile_edge]]], axis=1)
    return TileTable("color", tile_edge,
                     np.stack([ulo[tile_edge], vhi[tile_edge]], axis=1),
                     offsets, W, np.zeros(nt, dtype=np.int64), ek, None,
                     member_colors=mcol, ncolors=ncolors, rule1=rule1)


# ---------------------------------------------------------------------------
# PipelinePlan: cached preprocessing for repeated queries on one graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PipelinePlan:
    """Per-graph preprocessing cache (truss order, coloring, tables).

    Build once, query many times: ``stream_batches(plan, k)`` for any k
    reuses the decomposition and the membership table, so a serving process
    pays preprocessing once per graph snapshot.
    """
    g: Graph
    _td: Optional[TrussDecomposition] = None
    _colors: Optional[np.ndarray] = None
    _tables: Dict[str, TileTable] = dataclasses.field(default_factory=dict)

    @property
    def td(self) -> TrussDecomposition:
        """The graph's truss decomposition (computed lazily, cached)."""
        if self._td is None:
            self._td = truss_decomposition(self.g)
        return self._td

    @property
    def colors(self) -> np.ndarray:
        """Greedy vertex coloring (computed lazily, cached)."""
        if self._colors is None:
            self._colors, _ = greedy_coloring(self.g)
        return self._colors

    def table(self, mode: str) -> TileTable:
        """The (lazily built, cached) tile table for ``mode``'s family."""
        family = "color" if mode == "color" else "truss"
        if family not in self._tables:
            if family == "truss":
                self._tables[family] = _build_truss_table(self.g, self.td)
            else:
                self._tables[family] = _build_color_table(self.g, self.colors)
        return self._tables[family]


def build_plan(g: Graph, order: str = "hybrid") -> PipelinePlan:
    """Eagerly preprocess ``g`` for ``order`` (truss/hybrid/color)."""
    if order not in ("truss", "hybrid", "color"):
        raise ValueError(f"unknown edge-tile mode: {order}")
    plan = PipelinePlan(g=g)
    plan.table(order)
    return plan


def _as_plan(source: Union[Graph, PipelinePlan]) -> PipelinePlan:
    return source if isinstance(source, PipelinePlan) else PipelinePlan(source)


# ---------------------------------------------------------------------------
# keyed in-process plan cache
# ---------------------------------------------------------------------------

#: plan-key and plan-store layout version (the reference's PLAN_FORMAT:
#: both packages read and write one store format)
PLAN_FORMAT = 1

#: in-process plan cache capacity (plans, LRU-evicted); a plan holds the
#: graph plus O(sum tile sizes) table arrays, so keep the window small
PLAN_CACHE_CAPACITY = 8

#: canonicalization contract baked into every plan key: two graphs share
#: a key only when their *canonical* forms (self-loops dropped, edges
#: dedup'd and lexsorted u < v) match under the same contract version
PLAN_CANON = "dedup-lexsorted-v1"

_PLAN_CACHE: "collections.OrderedDict[str, PipelinePlan]" = \
    collections.OrderedDict()
_PLAN_CACHE_LOCK = threading.Lock()
# per-key single-flight build latches (cached_plan): key -> Event set
# when the thread that won the build has published (or abandoned) its plan
_PLAN_BUILDS: Dict[str, threading.Event] = {}


def plan_key(g: Graph, order: str = "hybrid") -> str:
    """Content-addressed cache key over the *whole* graph identity.

    Hashes the vertex count, edge count, canonicalization contract
    (:data:`PLAN_CANON`), ordering family, and the canonical edge list.
    ``n`` matters even with identical edges: edge keys are ``u * n + v``,
    so a plan built for a smaller vertex set mis-probes adjacency on a
    graph with trailing isolated vertices (the aliasing regression in
    ``test_pipeline.py``).  Truss and hybrid modes share one key (both
    consume the "truss" membership table); color mode keys separately.
    O(m) to compute -- negligible next to the O(delta*m) decomposition it
    lets a warm query skip.
    """
    family = "color" if order == "color" else "truss"
    h = hashlib.sha256()
    h.update(
        f"plan-v{PLAN_FORMAT}:{PLAN_CANON}:{family}:{g.n}:{g.m}:".encode())
    h.update(np.ascontiguousarray(g.edges).tobytes())
    return h.hexdigest()[:24]


def save_plan(plan: PipelinePlan, directory: str,
              lineage: Optional[Dict] = None) -> str:
    """Persist a plan's built structures via
    :mod:`repro_torch.checkpoint.store`.

    Saves the graph plus whatever is already built (truss decomposition,
    coloring, membership tables) -- load never recomputes what was saved.
    Atomic like every checkpoint (tmp dir + os.replace + COMMITTED).
    ``lineage`` is an optional JSON dict recording how the plan came to be;
    it rides in the metadata and is readable without deserializing arrays
    via :func:`repro_torch.checkpoint.store.read_metadata`.
    """
    from ..checkpoint import store

    tree: Dict[str, object] = {
        "graph": {"n": np.asarray(plan.g.n, np.int64),
                  "edges": plan.g.edges, "indptr": plan.g.indptr,
                  "indices": plan.g.indices}}
    if plan._td is not None:
        td = plan._td
        tree["truss_dec"] = {
            "order": td.order, "rank": td.rank, "support0": td.support0,
            "peel_support": td.peel_support, "trussness": td.trussness,
            "tau": np.asarray(td.tau, np.int64)}
    if plan._colors is not None:
        tree["colors"] = plan._colors
    tables: Dict[str, Dict[str, np.ndarray]] = {}
    for family, tb in plan._tables.items():
        d = {"edge_id": tb.edge_id, "anchors": tb.anchors,
             "offsets": tb.offsets, "verts": tb.verts,
             "thresh": tb.thresh, "ekeys": tb.ekeys}
        for opt in ("erank", "member_colors", "ncolors", "rule1"):
            val = getattr(tb, opt)
            if val is not None:
                d[opt] = val
        tables[family] = d
    if tables:
        tree["tables"] = tables
    metadata: Dict[str, object] = {
        "format": PLAN_FORMAT, "families": sorted(plan._tables)}
    if lineage is not None:
        metadata["lineage"] = lineage
    return store.save_checkpoint(directory, 0, tree, metadata=metadata)


def plan_from_arrays(arrays: Dict[str, np.ndarray],
                     families: Optional[Sequence[str]] = None
                     ) -> PipelinePlan:
    """Rebuild a :class:`PipelinePlan` from the flat array names that
    :func:`save_plan` (and the reference's) writes:
    ``graph/{n,edges,indptr,indices}``,
    ``truss_dec/{order,rank,support0,peel_support,trussness,tau}``,
    ``colors`` and ``tables/<family>/<field>``.  ``families`` names the
    tables to take (default: every one present).  Absent parts stay
    unbuilt and are computed on demand."""
    g = Graph(n=int(arrays["graph/n"]), edges=arrays["graph/edges"],
              indptr=arrays["graph/indptr"], indices=arrays["graph/indices"])
    plan = PipelinePlan(g=g)
    if "truss_dec/rank" in arrays:
        plan._td = TrussDecomposition(
            order=arrays["truss_dec/order"], rank=arrays["truss_dec/rank"],
            support0=arrays["truss_dec/support0"],
            peel_support=arrays["truss_dec/peel_support"],
            trussness=arrays["truss_dec/trussness"],
            tau=int(arrays["truss_dec/tau"]))
    if "colors" in arrays:
        plan._colors = arrays["colors"]
    if families is None:
        families = sorted({name.split("/")[1] for name in arrays
                           if name.startswith("tables/")})
    for family in families:
        p = f"tables/{family}/"
        plan._tables[family] = TileTable(
            family, arrays[p + "edge_id"], arrays[p + "anchors"],
            arrays[p + "offsets"], arrays[p + "verts"], arrays[p + "thresh"],
            arrays[p + "ekeys"], arrays.get(p + "erank"),
            member_colors=arrays.get(p + "member_colors"),
            ncolors=arrays.get(p + "ncolors"), rule1=arrays.get(p + "rule1"))
    return plan


def load_plan(directory: str) -> Optional[PipelinePlan]:
    """Restore a :func:`save_plan` plan; None if absent/stale-format.

    Corrupt or truncated stores (failed length+digest check, unreadable
    npz/meta, or a tree that no longer parses) also read as absent: the
    bad step is quarantined -- moved aside under ``<dir>/quarantine/``
    with a warning log -- so the caller rebuilds and re-saves instead of
    propagating a deserialization traceback (the same fall-back-to-absent
    contract as the tune records).
    """
    from ..checkpoint import store

    got = store.restore_checkpoint_safe(directory, _corrupt_site="plan.load")
    if got is None or got["metadata"].get("format") != PLAN_FORMAT:
        return None
    try:
        plan = plan_from_arrays(got["tree"],
                                got["metadata"].get("families", []))
    except Exception as exc:
        store.quarantine(directory, reason=f"plan parse failed: {exc!r}")
        return None
    return plan


def _plan_cache_insert(key: str, plan: PipelinePlan) -> None:
    with _PLAN_CACHE_LOCK:
        _PLAN_CACHE[key] = plan
        _PLAN_CACHE.move_to_end(key)
        while len(_PLAN_CACHE) > PLAN_CACHE_CAPACITY:
            _PLAN_CACHE.popitem(last=False)


def clear_plan_cache() -> None:
    """Drop every in-process cached plan (tests / memory pressure)."""
    with _PLAN_CACHE_LOCK:
        _PLAN_CACHE.clear()


def cached_plan(g: Graph, order: str = "hybrid", *,
                cache_dir: Optional[str] = None,
                stats=None) -> PipelinePlan:
    """Plan for ``g``/``order`` off the keyed cache; build only on a miss.

    Lookup order: in-process LRU (keyed by :func:`plan_key`) -> on-disk
    plan store under ``cache_dir`` (persisted across processes via
    :func:`save_plan`) -> build (and save when ``cache_dir`` is given).
    A warm hit skips the O(delta*m) truss/coloring preprocessing entirely;
    ``stats`` (a :class:`~repro_torch.core.engine_np.Stats`) records
    ``plan_cache_hit`` and the cold-path ``plan_build_s``.  An injected
    ``plan.load`` fault, or a corrupt store (quarantined), reads as a miss.

    Thread-safe with per-key single-flight building: concurrent misses on
    one key elect exactly one building thread; the others block on its latch and
    then take the published plan as a cache hit, so the build runs once no
    matter how many threads race a cold key.  If the building thread dies, a
    blocked thread takes over.  Plans are read-only after their table is
    built.
    """
    if order not in ("truss", "hybrid", "color"):
        raise ValueError(f"unknown edge-tile mode: {order}")
    key = plan_key(g, order)
    family = "color" if order == "color" else "truss"
    while True:
        latch = None
        with _PLAN_CACHE_LOCK:
            plan = _PLAN_CACHE.get(key)
            if plan is not None and family in plan._tables:
                _PLAN_CACHE.move_to_end(key)
            else:
                plan = None
                latch = _PLAN_BUILDS.get(key)
                if latch is None:
                    # no build in flight: this thread takes it
                    _PLAN_BUILDS[key] = threading.Event()
        if plan is not None:
            if stats is not None:
                stats.plan_cache_hit = True
            trace.instant("plan/cache_hit", source="memory", order=order)
            return plan
        if latch is None:
            break
        # single-flight: another thread owns the build; wait for its
        # latch, then loop to take the published plan as a hit (or, if
        # the build failed without publishing, take the build over)
        with trace.span("plan/build_wait", order=order):
            latch.wait()
    try:
        if cache_dir is not None:
            with trace.span("plan/load", order=order):
                try:
                    inject.fire("plan.load")
                    plan = load_plan(os.path.join(cache_dir, key))
                except inject.FaultInjected:
                    plan = None  # injected load fault -> a cache miss
            if plan is not None and family in plan._tables:
                if stats is not None:
                    stats.plan_cache_hit = True
                trace.instant("plan/cache_hit", source="disk", order=order)
                _plan_cache_insert(key, plan)
                return plan
        t0 = time.perf_counter()
        with trace.span("plan/build", order=order, n=g.n, m=g.m):
            plan = build_plan(g, order=order)
        if stats is not None:
            stats.plan_build_s += time.perf_counter() - t0
        if cache_dir is not None:
            save_plan(plan, os.path.join(cache_dir, key))
        _plan_cache_insert(key, plan)
        return plan
    finally:
        with _PLAN_CACHE_LOCK:
            latch = _PLAN_BUILDS.pop(key, None)
        if latch is not None:
            latch.set()


# ---------------------------------------------------------------------------
# vectorized chunk packing
# ---------------------------------------------------------------------------

# pairwise-expansion budget per internal slice (caps peak index memory)
_PAIR_BUDGET = 4_000_000


def _chunk_dense(g: Graph, table: TileTable, ids: np.ndarray, T: int):
    """Dense bool adjacency for one chunk of candidate tiles.

    Returns (D (B,T,T) bool, V (B,T) padded member ids, sizes, nedges,
    pairs) with ``pairs = (tile, i, j, pair_rank)`` for i<j adjacent pairs
    (pair_rank is the pi_tau rank of the pair edge for the truss family).
    """
    ids = np.asarray(ids, dtype=np.int64)
    B = ids.size
    sz = (table.offsets[ids + 1] - table.offsets[ids]).astype(np.int64)
    owner, pos = ragged_expand(sz)
    V = np.zeros((B, T), dtype=np.int64)
    V[owner, pos] = table.verts[table.offsets[ids][owner] + pos]
    D = np.zeros((B, T, T), dtype=bool)
    po_l: List[np.ndarray] = []
    pi_l: List[np.ndarray] = []
    pj_l: List[np.ndarray] = []
    pr_l: List[np.ndarray] = []
    # slice the chunk so the i x j pair expansion stays within budget
    start = 0
    quad = sz.astype(np.int64) ** 2
    cum = np.cumsum(quad)
    while start < B:
        stop = int(np.searchsorted(
            cum, (cum[start - 1] if start else 0) + _PAIR_BUDGET) + 1)
        stop = max(start + 1, min(stop, B))
        sl = slice(start, stop)
        so = sz[sl]
        powner, ppos = ragged_expand(so * so)
        s_rep = so[powner]
        i = ppos // s_rep
        j = ppos % s_rep
        keep = i < j
        powner, i, j = powner[keep], i[keep], j[keep]
        powner_g = powner + start
        gu = V[powner_g, i]
        gv = V[powner_g, j]
        hit, p = _edge_lookup(table.ekeys, g.m, g.n,
                              np.minimum(gu, gv), np.maximum(gu, gv))
        if table.family == "truss":
            hit &= table.erank[p] > table.thresh[ids[powner_g]]
        powner_g, i, j, p = powner_g[hit], i[hit], j[hit], p[hit]
        D[powner_g, i, j] = True
        D[powner_g, j, i] = True
        po_l.append(powner_g)
        pi_l.append(i)
        pj_l.append(j)
        if table.family == "truss":
            pr_l.append(table.erank[p])
        start = stop
    po = np.concatenate(po_l) if po_l else np.zeros(0, np.int64)
    pi = np.concatenate(pi_l) if pi_l else np.zeros(0, np.int64)
    pj = np.concatenate(pj_l) if pj_l else np.zeros(0, np.int64)
    pr = (np.concatenate(pr_l) if pr_l else np.zeros(0, np.int64)) \
        if table.family == "truss" else None
    nedges = np.bincount(po, minlength=B).astype(np.int64)
    return D, V, sz, nedges, (po, pi, pj, pr)


def _greedy_color_chunk(D: np.ndarray, sz: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized-across-tiles greedy coloring, replicating ``_local_color``.

    Processing order per tile: degree descending, local id descending (the
    reference's ``sorted(..., reverse=True)`` tie-break); color = smallest
    positive value unused by any tile-neighbor.  Returns (colors (B,T) with
    0 on padding, perm (B,T) = relabel order: color desc, id asc, padding
    last).
    """
    B, T, _ = D.shape
    ids = np.broadcast_to(np.arange(T, dtype=np.int64), (B, T))
    deg = D.sum(-1).astype(np.int64)
    real = ids < sz[:, None]
    degk = np.where(real, deg, -1)
    order = np.lexsort((-ids, -degk), axis=1)
    colors = np.zeros((B, T), dtype=np.int64)
    for t in range(int(sz.max(initial=0))):
        # step t touches only tiles with a t-th vertex; indexing the active
        # subset keeps per-step work O(#active * T), not O(B * T) -- the
        # dominant win on mixed-size bins (bench_pipeline_stages)
        act = np.nonzero(t < sz)[0]
        v = order[act, t]
        nb = D[act, v]                                    # (A, T)
        ncol = np.where(nb, colors[act], 0)
        present = np.zeros((act.size, T + 2), dtype=bool)
        present[np.arange(act.size)[:, None], ncol] = True
        mex = np.argmin(present[:, 1:], axis=1) + 1       # first free >= 1
        colors[act, v] = mex
    perm = np.lexsort((ids, -colors), axis=1)
    return colors, perm


def _relabel_chunk(D, V, colors, perm):
    # one flat gather for the (B, T, T) permute (measurably faster than
    # both a chained take_along_axis and the triple-broadcast fancy index)
    B, T = V.shape
    idx = (perm[:, :, None] * T + perm[:, None, :]).reshape(B, T * T)
    D2 = np.take_along_axis(D.reshape(B, T * T), idx, axis=1) \
        .reshape(B, T, T)
    V2 = np.take_along_axis(V, perm, axis=1)
    C2 = np.take_along_axis(colors, perm, axis=1)
    return D2, V2, C2


@dataclasses.dataclass
class TileBatch:
    """One fixed-shape packed batch plus per-tile scheduler metadata.

    ``verts`` is the decode table of the emission subsystem
    (the listing slice): local slot i of tile b is global vertex
    ``verts[b, i]`` (post-relabel for hybrid mode; slots >= ``sizes[b]``
    are padding).  Together with ``anchors`` it is everything needed to
    translate kernel-emitted local clique ids back to global ids.
    """
    T: int
    A: np.ndarray        # (B, T, W) uint32 adjacency bitsets
    cand: np.ndarray     # (B, W) uint32 candidate masks
    sizes: np.ndarray    # (B,) int32 member counts
    nedges: np.ndarray   # (B,) int32 tile edge counts (cost-model input)
    anchors: np.ndarray  # (B, 2) int64 anchor vertices
    verts: np.ndarray    # (B, T) int64 local slot -> global vertex id

    @property
    def B(self) -> int:
        """Batch size: number of packed tiles (rows) in this batch."""
        return int(self.A.shape[0])


def _pack_batch(g: Graph, table: TileTable, ids: np.ndarray, T: int,
                mode: str) -> TileBatch:
    # pure function of (table, ids): an injected pack fault is absorbed
    # by in-place retry before any work happens, so results never change
    fault_retry.consume("pack")
    D, V, sz, nedges, _ = _chunk_dense(g, table, ids, T)
    if mode == "hybrid":
        colors, perm = _greedy_color_chunk(D, sz)
        D, V, _ = _relabel_chunk(D, V, colors, perm)
    A = _pack_bits(D)
    cand = _pack_bits(np.arange(T)[None, :] < sz[:, None])
    return TileBatch(T, A, cand, sz.astype(np.int32),
                     nedges.astype(np.int32), table.anchors[ids].copy(), V)


def _tiles_from_ids(g: Graph, table: TileTable, ids: np.ndarray,
                    mode: str) -> Iterator[Tile]:
    """Materialize reference-identical :class:`Tile` objects for ``ids``."""
    ids = np.asarray(ids, dtype=np.int64)
    chunk = 512
    for c0 in range(0, ids.size, chunk):
        sub = ids[c0:c0 + chunk]
        sz = (table.offsets[sub + 1] - table.offsets[sub]).astype(np.int64)
        T = max(8, int(-(-int(sz.max(initial=1)) // 8) * 8))
        D, V, _, nedges, (po, pi, pj, pr) = _chunk_dense(g, table, sub, T)
        colors_out: Optional[np.ndarray] = None
        if mode == "hybrid":
            colors, perm = _greedy_color_chunk(D, sz)
            D, V, colors_out = _relabel_chunk(D, V, colors, perm)
        elif mode == "color":
            mowner, mpos = ragged_expand(sz)
            colors_out = np.zeros((sub.size, T), dtype=np.int64)
            colors_out[mowner, mpos] = table.member_colors[
                table.offsets[sub][mowner] + mpos]
        edges_ranked: Optional[List[List[Tuple[int, int]]]] = None
        if mode == "truss":
            o = np.lexsort((pr, po))
            po_s, pi_s, pj_s = po[o], pi[o], pj[o]
            bounds = np.concatenate(
                [[0], np.cumsum(np.bincount(po_s, minlength=sub.size))])
            edges_ranked = [
                list(zip(pi_s[bounds[b]:bounds[b + 1]].tolist(),
                         pj_s[bounds[b]:bounds[b + 1]].tolist()))
                for b in range(sub.size)]
        row_bytes = np.packbits(D, axis=-1, bitorder="little")
        for b in range(sub.size):
            s = int(sz[b])
            rows = [int.from_bytes(row_bytes[b, r].tobytes(), "little")
                    for r in range(s)]
            anchor = (int(table.anchors[sub[b], 0]),
                      int(table.anchors[sub[b], 1]))
            verts = V[b, :s].copy()
            if mode == "truss":
                yield Tile(anchor, verts, rows, int(nedges[b]),
                           edges_ranked=edges_ranked[b])
            else:
                yield Tile(anchor, verts, rows, int(nedges[b]),
                           colors=[int(c) for c in colors_out[b, :s]])


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def iter_tiles(source: Union[Graph, PipelinePlan], k: int,
               mode: str = "hybrid", use_rule2: bool = True
               ) -> Iterator[Tile]:
    """Vectorized replacement for :func:`repro_torch.core.tiles.edge_tiles`.

    Yields tiles identical (same order, members, rows, colors/ranks) to the
    Python reference extractor, built from the plan's membership table.
    """
    if mode not in ("truss", "hybrid", "color"):
        raise ValueError(f"unknown edge-tile mode: {mode}")
    plan = _as_plan(source)
    table = plan.table(mode)
    ids = table.select(k, use_rule2=use_rule2)
    yield from _tiles_from_ids(plan.g, table, ids, mode)


def default_pack_workers() -> int:
    """Auto worker count for the parallel pack producer: a small pool,
    leaving one core for the consumer/device side (packing is numpy-bound
    and releases the GIL, but past a few threads the front-end saturates
    host memory bandwidth -- and on CPU-device hosts the packers share
    cores with the kernels themselves)."""
    return max(1, min(4, (os.cpu_count() or 2) - 1))


def stream_batches(source: Union[Graph, PipelinePlan], k: int,
                   order: str = "hybrid", use_rule2: bool = True,
                   batch_size: Optional[int] = None,
                   bins: Optional[Sequence[int]] = None,
                   timings: Optional[Dict[str, float]] = None,
                   pack_workers: Optional[int] = 0,
                   prefetch: Optional[int] = None,
                   stats=None) -> Iterator[Union[TileBatch, Tile]]:
    """Stream fixed-shape packed batches (plus oversize spill tiles).

    Tiles are routed to the smallest bin T >= size and packed
    ``batch_size`` at a time, so peak host memory is one chunk per bin.
    Tiles wider than ``bins[-1]`` are yielded as :class:`Tile` objects for
    the caller to spill to the host recursion.  When ``timings`` is given,
    "extract" (table build + select) and "pack" seconds are accumulated
    into it.

    ``pack_workers`` turns the serial packer into a producer/consumer
    pipeline: a thread pool packs up to ``prefetch`` chunks ahead of the
    consumer (default ``2 * workers``), so host packing of batch i+N
    overlaps whatever the consumer does with batch i (device dispatch, in
    the engines).  ``0`` = pack inline (the serial reference behavior);
    ``None`` = :func:`default_pack_workers`.  The yielded sequence is
    **identical** in content and order either way -- work items are
    submitted and harvested strictly FIFO -- and peak host memory grows
    only by the prefetch window.  With ``stats`` given (a
    :class:`~repro_torch.core.engine_np.Stats`), ``pack_workers``,
    ``frontend_s`` (extract + pack seconds; worker CPU-seconds when
    parallel), and the prefetch-queue occupancy fields are recorded.
    """
    if order not in ("truss", "hybrid", "color"):
        raise ValueError(f"unknown edge-tile mode: {order}")
    # None = the historical default (the autotuner waits for a later slice)
    if batch_size is None:
        batch_size = 256
    bins = tuple(sorted(int(b) for b in (BINS if bins is None else bins)))
    if any(b % 32 for b in bins):
        raise ValueError("bins must be multiples of 32")
    plan = _as_plan(source)
    t0 = time.perf_counter()
    with trace.span("extract", order=order, k=k) as _sp:
        fault_retry.consume("extract")  # pure stage: retry-in-place
        table = plan.table(order)
        ids = table.select(k, use_rule2=use_rule2)
        sizes = (table.offsets[ids + 1] - table.offsets[ids]).astype(np.int64)
        binidx = np.searchsorted(np.asarray(bins), sizes)
        _sp.set(tiles=int(ids.size))
    extract_s = time.perf_counter() - t0
    if timings is not None:
        timings["extract"] = timings.get("extract", 0.0) + extract_s
    if stats is not None:
        stats.frontend_s += extract_s
    for tid in ids[binidx == len(bins)]:
        yield from _tiles_from_ids(plan.g, table, np.asarray([tid]), order)

    def bill_pack(dt: float) -> None:
        if timings is not None:
            timings["pack"] = timings.get("pack", 0.0) + dt
        if stats is not None:
            stats.frontend_s += dt

    # the work list (bin, chunk) is cheap to materialize -- only index
    # arrays -- and fixes the deterministic yield order up front
    work: List[Tuple[int, np.ndarray]] = []
    for bi, T in enumerate(bins):
        sel = ids[binidx == bi]
        for c0 in range(0, sel.size, batch_size):
            work.append((T, sel[c0:c0 + batch_size]))
    workers = default_pack_workers() if pack_workers is None \
        else max(0, int(pack_workers))
    serial = workers == 0 or len(work) <= 1
    if stats is not None:
        # report what actually ran: the <=1-work-item fallback is serial
        stats.pack_workers = 0 if serial else workers
    if serial:
        for T, chunk in work:
            t1 = time.perf_counter()
            with trace.span("pack", T=T, tiles=len(chunk)):
                batch = _pack_batch(plan.g, table, chunk, T, order)
            bill_pack(time.perf_counter() - t1)
            yield batch
        return

    def pack_job(T: int, chunk: np.ndarray) -> Tuple[TileBatch, float]:
        t1 = time.perf_counter()
        with trace.span("pack", T=T, tiles=len(chunk)):
            batch = _pack_batch(plan.g, table, chunk, T, order)
        return batch, time.perf_counter() - t1

    depth = max(2, 2 * workers) if prefetch is None else max(1, int(prefetch))
    occ_sum, occ_n, occ_peak = 0.0, 0, 0
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
    try:
        it = iter(work)
        futs: Deque = collections.deque(
            ex.submit(pack_job, T, chunk)
            for T, chunk in itertools.islice(it, depth))
        while futs:
            occ_peak = max(occ_peak, len(futs))
            occ_sum += len(futs) / depth
            occ_n += 1
            fut = futs.popleft()
            if fut.done():
                batch, dt = fut.result()
            else:
                with trace.span("pack/wait", depth=len(futs) + 1):
                    batch, dt = fut.result()
            nxt = next(it, None)
            if nxt is not None:
                futs.append(ex.submit(pack_job, *nxt))
            bill_pack(dt)
            yield batch
    finally:
        ex.shutdown(wait=False, cancel_futures=True)
        if stats is not None and occ_n:
            stats.pack_queue_occupancy = occ_sum / occ_n
            stats.pack_queue_peak = occ_peak
