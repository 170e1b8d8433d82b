"""Incrementally-maintained plan index for dynamic graphs (DESIGN.md 13).

The port's copy of ``repro/delta``.  EBBkC's preprocessing -- truss order
+ per-edge membership tables -- is the amortized O(delta*m) cost a
:class:`~repro_torch.core.pipeline.PipelinePlan` spreads over repeated
queries.  This package keeps that amortization alive under edge churn:
:func:`repair_plan` repairs a cached plan after a
:func:`~repro_torch.core.graph.apply_edge_batch` mutation by re-deriving
only the tiles the batch could have changed (cost bounded by the touched
neighborhood, with a full-rebuild fallback past a churn threshold), and
:class:`PlanIndex` wraps that into a versioned graph lineage with
per-batch clique deltas (:func:`delta_cliques`) computed from the
retired-vs-replaced tile sets via the paper's exact-once attribution.

The repair runs on the host, in the reference's numpy code; the delta
queries run the port's device engines, on the CUDA device unless the
caller asks for the CPU (``device="cpu"``) or the host recursion
(``backend="host"``).

Soundness in one line: Eq. 2 attributes every k-clique to exactly one
edge tile for ANY total edge order, so a repair that preserves surviving
edges' relative rank order and rebuilds exactly the content-changed
tiles produces identical counts and listings to a from-scratch plan.
"""
from .repair import (CHURN_THRESHOLD, RepairInfo, repair_plan,
                     repair_truss, splice_truss_table, touched_edge_ids)
from .query import DeltaResult, delta_cliques, rows_diff, rows_union
from .index import PlanIndex

__all__ = [
    "CHURN_THRESHOLD", "RepairInfo", "repair_plan", "repair_truss",
    "splice_truss_table", "touched_edge_ids", "DeltaResult",
    "delta_cliques", "rows_diff", "rows_union", "PlanIndex",
]
