"""Host branch-and-bound engines over python-int bitset tiles.

The port's copy of the reference host engine: the paper-faithful
recursions (Algorithms 2-5) over python-int bitsets.  The torch engine
(:mod:`repro_torch.core.engine_torch`) spills tiles wider than its largest
bin here, and the launcher's ``--verify`` checks against it.

* ``count_rec_T`` -- truss-ordered edge-oriented branching with the
                     explicit E(g)-filtered sub-branch construction of
                     Algorithm 3 (ESet semantics).
* ``count_rec_C`` -- color-ordered edge-oriented branching on a DAG
                     (Algorithm 4), with pruning Rules (1) and (2).
* ``count_rec_V`` -- vertex-oriented branching (Algorithm 1 = VBBkC) with
                     optional color pruning (DDegCol+ ablation); the
                     paper's baseline, :mod:`repro_torch.core.vbbkc`.

* ``list_rec_C``  -- the listing twin of ``count_rec_C``: emits local-id
                     tuples; the listing engine relists overflowed and
                     spilled tiles with it.

All support early termination into :mod:`repro_torch.core.plex`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .bitops import bits, mask_gt, popcount
from . import plex


@dataclasses.dataclass
class Stats:
    branches: int = 0        # BB branches formed
    et_hits: int = 0         # branches finished by early termination
    pruned_size: int = 0     # pruned by |V(g)| < l
    pruned_color: int = 0    # pruned by Rules (1)/(2)
    peak_graph: int = 0      # largest branch graph seen
    spilled_tiles: int = 0   # oversize tiles routed device -> host recursion
    # sizes of the spilled tiles (one entry per spill)
    spill_sizes: List[int] = dataclasses.field(default_factory=list)
    # multi-lane dispatch (repro_torch.runtime.dispatch): lane index ->
    # tiles counted there / the reference's dense-matmul flop model of
    # them / packed bytes staged there ((B,T,W) adjacency plus (B,W)
    # candidate masks)
    device_tiles: Dict[int, int] = dataclasses.field(default_factory=dict)
    device_flops: Dict[int, int] = dataclasses.field(default_factory=dict)
    device_bytes: Dict[int, int] = dataclasses.field(default_factory=dict)
    # device seconds of each counted batch's lane interval (its staging
    # copy to its copy back, timed by CUDA events) that fell outside the
    # consumer's harvest waits: device work hidden behind host work; 0.0
    # on CPU lanes, which run inline
    staging_overlap_s: float = 0.0
    # device seconds between the pair of CUDA timing events that the
    # kernel library records around each kernel call of the dispatchers
    # (count steps, sizing passes, list kernels); 0.0 on CPU lanes
    kernel_device_s: float = 0.0
    # seconds the listing consumer blocked on the decode worker's backlog
    # (and on its final drain)
    decode_backlog_s: float = 0.0
    # speculative emit capacity (ListDispatcher, capacity="speculative"):
    # batches whose capacity guess proved too small and were listed once
    # more on the device at the exact size
    emit_retries: int = 0
    # resilience layer (repro_torch.resilience + runtime.dispatch): device
    # batch attempts re-run after an injected fault, and rungs of a CPU
    # lane's backend ladder given up (cuda -> torch -> host)
    retries: int = 0
    demotions: int = 0
    # wall seconds the dispatchers spent building the CUDA kernel library
    # at first use (0.0 once it is loaded in this process)
    kernel_compile_s: float = 0.0
    # which engine served the query: "host", or "torch:<device type>"
    backend: str = ""
    # front end (repro_torch.core.pipeline.stream_batches): pack-pool size
    # (0 = inline serial packing), extract + pack seconds (worker
    # CPU-seconds when parallel), and the prefetch queue's mean occupancy
    # (0..1 of the window) / peak depth observed at consumer harvest
    pack_workers: int = 0
    frontend_s: float = 0.0
    pack_queue_occupancy: float = 0.0
    pack_queue_peak: int = 0
    # listing (repro_torch.core.listing): cliques accepted by the sink,
    # tiles whose device emit buffer overflowed (re-listed on the host --
    # never truncated), and bytes the sink wrote
    emitted_cliques: int = 0
    overflowed_tiles: int = 0
    sink_bytes: int = 0
    # plan cache (repro_torch.core.pipeline.cached_plan): True when the
    # preprocessing came from the in-process cache; plan_build_s is the
    # cold-path build time (0.0 on warm queries)
    plan_cache_hit: bool = False
    plan_build_s: float = 0.0
    # incremental plan maintenance (repro_torch.delta.repair): batches
    # repaired in place vs rebuilt from scratch (churn past the threshold,
    # or a family with no local-repair path), wall seconds spent splicing,
    # and edges whose tiles were re-extracted across all repairs
    plan_repairs: int = 0
    plan_rebuilds: int = 0
    plan_repair_s: float = 0.0
    delta_touched_edges: int = 0
    # persistent autotuner (repro_torch.tune): wall seconds spent in live
    # tuning measurements, and True when every tuning lookup of the query
    # was answered from a cache layer (record or in-process)
    tune_s: float = 0.0
    tune_cache_hit: bool = False

    # How each field combines across Stats objects (Stats.merge) and how it
    # publishes to the metrics registry (obs.metrics.observe_stats), as in
    # the reference:
    #   sum  -- additive accumulator (counter)
    #   max  -- peak/high-water value
    #   or   -- sticky boolean flag
    #   dict -- per-key additive map (lane index -> amount)
    #   list -- concatenated observations
    #   mean -- occupancy-style ratio; merge keeps the max as the
    #           conservative summary
    #   info -- identity metadata, kept from self (or taken from other
    #           when self is unset)
    _MERGE_KINDS = {
        "branches": "sum",
        "et_hits": "sum",
        "pruned_size": "sum",
        "pruned_color": "sum",
        "peak_graph": "max",
        "spilled_tiles": "sum",
        "spill_sizes": "list",
        "device_tiles": "dict",
        "device_flops": "dict",
        "device_bytes": "dict",
        "staging_overlap_s": "sum",
        "kernel_device_s": "sum",
        "decode_backlog_s": "sum",
        "emit_retries": "sum",
        "retries": "sum",
        "demotions": "sum",
        "kernel_compile_s": "sum",
        "backend": "info",
        "pack_workers": "max",
        "frontend_s": "sum",
        "pack_queue_occupancy": "mean",
        "pack_queue_peak": "max",
        "emitted_cliques": "sum",
        "overflowed_tiles": "sum",
        "sink_bytes": "sum",
        "plan_cache_hit": "or",
        "plan_build_s": "sum",
        "plan_repairs": "sum",
        "plan_rebuilds": "sum",
        "plan_repair_s": "sum",
        "delta_touched_edges": "sum",
        "tune_s": "sum",
        "tune_cache_hit": "or",
    }
    # Metric-publication view of the same table
    # (repro_torch.obs.metrics.observe_stats reads this), as the
    # reference builds it.
    _METRIC_KINDS = dict(
        _MERGE_KINDS,
        pack_workers="max",
        pack_queue_occupancy="max",
        plan_cache_hit="flag",
        tune_cache_hit="flag",
    )

    def merge(self, other: "Stats") -> "Stats":
        """Fold ``other`` into ``self`` (in place) and return ``self``.

        The single merge path for combining per-lane / per-request
        ``Stats`` (the dispatchers' accounting goes through it).  Every
        dataclass field must be classified in ``_MERGE_KINDS``: a field
        without a rule raises here.
        """
        for f in dataclasses.fields(self):
            kind = self._MERGE_KINDS.get(f.name)
            if kind is None:
                raise TypeError(
                    f"Stats.{f.name} has no merge rule; add it to "
                    "Stats._MERGE_KINDS")
            mine = getattr(self, f.name)
            theirs = getattr(other, f.name)
            if kind == "sum":
                setattr(self, f.name, mine + theirs)
            elif kind in ("max", "mean"):
                setattr(self, f.name, max(mine, theirs))
            elif kind == "or":
                setattr(self, f.name, bool(mine or theirs))
            elif kind == "dict":
                for k, v in theirs.items():
                    mine[k] = mine.get(k, 0) + v
            elif kind == "list":
                mine.extend(theirs)
            elif kind == "info":
                if not mine and theirs:
                    setattr(self, f.name, theirs)
        return self


def _count_edges(rows: Sequence[int], cand: int) -> int:
    s = 0
    for v in bits(cand):
        s += popcount(rows[v] & cand & mask_gt(v))
    return s


def _try_et(rows: Sequence[int], cand: int, l: int, et_t: int,
            stats: Stats, rec: Callable[[Sequence[int], int, int], int]
            ) -> Optional[int]:
    """Early termination (Section 5). Returns a count or None."""
    if et_t < 2:
        return None
    nv, t = plex.plexity(rows, cand)
    if nv == 0:
        return 1 if l == 0 else 0
    if t <= 2:
        stats.et_hits += 1
        return plex.count_in_2plex(rows, cand, l)
    if t <= et_t:
        # factor universal vertices combinatorially (Alg. 7 lines 8-10),
        # finish the remainder with the generic recursion
        stats.et_hits += 1
        from math import comb
        F, rest = plex.split_universal(rows, cand)
        f = popcount(F)
        total = 0
        for c in range(0, min(l, f) + 1):
            total += comb(f, c) * rec(rows, rest, l - c)
        return total
    return None


# ---------------------------------------------------------------------------
# EBBkC-C inner recursion (fixed tile adjacency, DAG by local index)
# ---------------------------------------------------------------------------

def count_rec_C(rows: Sequence[int], cand: int, l: int, stats: Stats,
                colors: Optional[Sequence[int]] = None, et_t: int = 0,
                use_rule2: bool = True) -> int:
    nv = popcount(cand)
    if nv < l:
        stats.pruned_size += 1
        return 0
    if l == 0:
        return 1
    if l == 1:
        return nv
    if l == 2:
        return _count_edges(rows, cand)
    stats.peak_graph = max(stats.peak_graph, nv)
    et = _try_et(rows, cand, l, et_t,
                 stats, lambda r, c, ll: count_rec_C(r, c, ll, stats, colors,
                                                     0, use_rule2))
    if et is not None:
        return et
    total = 0
    for u in bits(cand):
        row_u = rows[u] & cand & mask_gt(u)
        if colors is not None and colors[u] < l:  # Rule (1) part 1
            stats.pruned_color += 1
            continue
        for v in bits(row_u):
            if colors is not None and colors[v] < l - 1:  # Rule (1) part 2
                stats.pruned_color += 1
                continue
            sub = cand & rows[u] & rows[v] & mask_gt(v)
            stats.branches += 1
            if colors is not None and use_rule2:
                distinct = len({colors[w] for w in bits(sub)})
                if distinct < l - 2:  # Rule (2)
                    stats.pruned_color += 1
                    continue
            total += count_rec_C(rows, sub, l - 2, stats, colors, et_t,
                                 use_rule2)
    return total


# ---------------------------------------------------------------------------
# EBBkC-T inner recursion (edge-list filtered sub-branches, Alg. 3 semantics)
# ---------------------------------------------------------------------------

def count_rec_T(edges: List[Tuple[int, int]], cand: int, num_local: int,
                l: int, stats: Stats, et_t: int = 0) -> int:
    """edges: local pairs sorted by global pi_tau rank; cand: vertex bitset."""
    nv = popcount(cand)
    if nv < l:
        stats.pruned_size += 1
        return 0
    if l == 0:
        return 1
    if l == 1:
        return nv
    if l == 2:
        return len(edges)
    stats.peak_graph = max(stats.peak_graph, nv)
    rows = [0] * num_local
    for a, b in edges:
        rows[a] |= 1 << b
        rows[b] |= 1 << a
    if et_t >= 2:
        def rec(r, c, ll):
            sub_edges = [(a, b) for (a, b) in edges
                         if (c >> a) & 1 and (c >> b) & 1]
            return count_rec_T(sub_edges, c, num_local, ll, stats, 0)
        et = _try_et(rows, cand, l, et_t, stats, rec)
        if et is not None:
            return et
    total = 0
    for i, (a, b) in enumerate(edges):
        rows[a] &= ~(1 << b)
        rows[b] &= ~(1 << a)
        sub = rows[a] & rows[b]          # common nbrs among edges ranked > i
        stats.branches += 1
        if popcount(sub) < l - 2:
            stats.pruned_size += 1
            continue
        sub_edges = [(x, y) for (x, y) in edges[i + 1:]
                     if (sub >> x) & 1 and (sub >> y) & 1]
        total += count_rec_T(sub_edges, sub, num_local, l - 2, stats, et_t)
    return total


# ---------------------------------------------------------------------------
# VBBkC baseline inner recursion (Algorithm 1; optional color pruning)
# ---------------------------------------------------------------------------

def count_rec_V(rows: Sequence[int], cand: int, l: int, stats: Stats,
                colors: Optional[Sequence[int]] = None, et_t: int = 0,
                use_rule2: bool = False) -> int:
    nv = popcount(cand)
    if nv < l:
        stats.pruned_size += 1
        return 0
    if l == 0:
        return 1
    if l == 1:
        return nv
    if l == 2:
        return _count_edges(rows, cand)
    stats.peak_graph = max(stats.peak_graph, nv)
    et = _try_et(rows, cand, l, et_t,
                 stats, lambda r, c, ll: count_rec_V(r, c, ll, stats, colors,
                                                     0, use_rule2))
    if et is not None:
        return et
    total = 0
    for v in bits(cand):
        if colors is not None and colors[v] < l:  # VBBkC color Rule (1)
            stats.pruned_color += 1
            continue
        sub = cand & rows[v] & mask_gt(v)
        stats.branches += 1
        if colors is not None and use_rule2:
            distinct = len({colors[w] for w in bits(sub)})
            if distinct < l - 1:  # Rule (2) adapted to VBBkC (Sec. 4.3)
                stats.pruned_color += 1
                continue
        total += count_rec_V(rows, sub, l - 1, stats, colors, et_t, use_rule2)
    return total


# ---------------------------------------------------------------------------
# Listing variant (emits local-id tuples); used by the listing engine
# ---------------------------------------------------------------------------

def list_rec_C(rows: Sequence[int], cand: int, l: int, prefix: Tuple[int, ...],
               out: List[Tuple[int, ...]], colors=None, et_t: int = 0) -> None:
    nv = popcount(cand)
    if nv < l:
        return
    if l == 0:
        out.append(prefix)
        return
    if l == 1:
        for v in bits(cand):
            out.append(prefix + (v,))
        return
    if l == 2:
        for v in bits(cand):
            for w in bits(rows[v] & cand & mask_gt(v)):
                out.append(prefix + (v, w))
        return
    if et_t >= 2:
        _, t = plex.plexity(rows, cand)
        if t <= 2:
            for tup in plex.list_2plex(rows, cand, l):
                out.append(prefix + tup)
            return
        if t <= et_t:
            for tup in plex.list_tplex(rows, cand, l):
                out.append(prefix + tup)
            return
    for u in bits(cand):
        for v in bits(rows[u] & cand & mask_gt(u)):
            sub = cand & rows[u] & rows[v] & mask_gt(v)
            list_rec_C(rows, sub, l - 2, prefix + (u, v), out, colors, et_t)
