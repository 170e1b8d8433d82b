"""PlanIndex: a versioned, incrementally-maintained plan over one graph.

The port's copy of ``repro/delta/index.py``.  The stateful front of
:mod:`repro_torch.delta`: holds the current graph
snapshot, its (repaired or rebuilt) plan, a monotonically increasing
version number, and a bounded lineage of recent batches.  Each
:meth:`PlanIndex.apply_batch` runs :func:`~repro_torch.delta.repair.repair_plan`,
publishes the new plan into the process-wide keyed plan cache (so a
serving tier's next ``cached_plan`` lookup on the mutated graph is a
warm hit, never an O(delta*m) rebuild), optionally persists it with a
version-lineage metadata record, and retains the old/new plan pair so
clique deltas against any retained version remain answerable
(:meth:`PlanIndex.delta` composes per-batch gains/losses with exact set
algebra).

One deliberate difference from the reference, whose batch records list
their deltas through the host recursion: a :class:`PlanIndex` takes the
``device`` (or the dispatcher lanes ``devices``) and ``backend`` its
records list on, by default the port's device engines on the CUDA device
(raising without one), so a subscription read runs the list kernel.
"""
from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import Deque, Dict, Optional, Sequence

import numpy as np

from ..core import pipeline
from ..core.engine_np import Stats
from ..core.engine_torch import resolve_device
from ..core.graph import Graph, apply_edge_batch
from ..runtime.dispatch import resolve_devices
from .query import DeltaResult, delta_cliques, rows_diff, rows_sorted, \
    rows_union
from .repair import CHURN_THRESHOLD, RepairInfo, repair_plan


@dataclasses.dataclass
class _BatchRecord:
    """One applied batch: the plans on either side plus the repair info."""

    version: int                      # version this batch produced
    old_plan: pipeline.PipelinePlan
    new_plan: pipeline.PipelinePlan
    info: RepairInfo
    deltas: Dict[int, DeltaResult] = dataclasses.field(default_factory=dict)

    def delta(self, k: int, order: str, **query) -> DeltaResult:
        """The batch's k-clique delta, listed once (``query`` forwards to
        :func:`~repro_torch.delta.query.delta_cliques`) and kept."""
        d = self.deltas.get(k)
        if d is None:
            d = delta_cliques(self.old_plan, self.new_plan, self.info, k,
                              order=order, **query)
            self.deltas[k] = d
        return d


class PlanIndex:
    """Incrementally-maintained plan + delta lineage for a dynamic graph.

    Typical use::

        idx = PlanIndex(g)                       # version 0, plan built
        v1 = idx.apply_batch(insert=[(0, 9)])    # local repair (or rebuild)
        d = idx.delta(k=4, since=0)              # cliques gained/lost
        ebbkc.count(idx.graph, 4, plan=idx.plan) # warm exact queries

    ``history`` bounds how many batch records (old/new plan pairs) are
    retained; deltas spanning further back raise.  ``stats`` (default: an
    internal :class:`~repro_torch.core.engine_np.Stats`) accumulates the
    repair/rebuild decisions and timings.  ``device`` / ``devices`` /
    ``backend`` / ``engine_kwargs`` are where the delta queries list:
    the CUDA device by default, ``device="cpu"`` (or ``devices=["cpu"]``)
    for the plain torch versions, ``backend="host"`` for the recursion.
    Not thread-safe by itself -- the serving tier serializes updates per
    graph entry.
    """

    def __init__(self, g: Graph, order: str = "hybrid", *,
                 churn_threshold: float = CHURN_THRESHOLD,
                 cache_dir: Optional[str] = None, history: int = 16,
                 stats: Optional[Stats] = None, backend: str = "torch",
                 device=None, devices: Optional[Sequence] = None,
                 engine_kwargs: Optional[dict] = None) -> None:
        if order not in ("truss", "hybrid", "color"):
            raise ValueError(f"unknown edge-tile mode: {order}")
        self.order = order
        kw = dict(engine_kwargs or {})
        if devices is not None:
            kw["devices"] = list(devices)
        self.query = dict(backend=backend, device=device,
                          engine_kwargs=kw or None)
        if backend == "torch":  # no card and no CPU asked for: raise now
            if devices is not None:
                resolve_devices(devices)
            else:
                resolve_device(device)
        self.churn_threshold = float(churn_threshold)
        self.cache_dir = cache_dir
        self.stats = stats if stats is not None else Stats()
        self.graph = g
        self.version = 0
        self.plan = pipeline.cached_plan(
            g, order, cache_dir=cache_dir, stats=self.stats)
        self._records: Deque[_BatchRecord] = deque(maxlen=max(1, history))

    @property
    def plan_key(self) -> str:
        """Content-addressed key of the current plan (cache identity)."""
        return pipeline.plan_key(self.graph, self.order)

    def apply_batch(self, insert=None, delete=None) -> int:
        """Apply one edge batch; returns the new version number.

        Mutates the index to the new graph snapshot and repaired plan,
        publishes the plan into the keyed in-process cache under the new
        graph's key, and (when ``cache_dir`` is set) persists it with a
        lineage metadata record ``{version, parent_key, repaired, churn,
        inserted, deleted}`` readable via
        :func:`repro_torch.checkpoint.store.read_metadata`.
        """
        parent_key = self.plan_key
        g_new = apply_edge_batch(self.graph, insert=insert, delete=delete)
        new_plan, info = repair_plan(
            self.plan, g_new, self.order,
            churn_threshold=self.churn_threshold, stats=self.stats)
        self._records.append(_BatchRecord(
            self.version + 1, self.plan, new_plan, info))
        self.graph = g_new
        self.plan = new_plan
        self.version += 1
        key = pipeline.plan_key(g_new, self.order)
        pipeline._plan_cache_insert(key, new_plan)
        if self.cache_dir is not None:
            pipeline.save_plan(
                new_plan, os.path.join(self.cache_dir, key),
                lineage={"version": self.version, "parent_key": parent_key,
                         "repaired": not info.rebuilt,
                         "churn": round(info.churn, 6),
                         "inserted": info.n_insert,
                         "deleted": info.n_delete})
        return self.version

    def oldest_version(self) -> int:
        """Oldest version delta queries can still reach back to."""
        if not self._records:
            return self.version
        return self._records[0].version - 1

    def delta(self, k: int, since: int) -> DeltaResult:
        """Cliques gained/lost between version ``since`` and now.

        Composes the retained per-batch deltas with exact set algebra
        (a clique gained in one batch and lost in a later one cancels),
        so the result equals a from-scratch diff of the two snapshots.
        Raises when ``since`` is ahead of the index or behind the
        retained history window.
        """
        if since > self.version or since < 0:
            raise ValueError(
                f"since={since} outside [0, {self.version}]")
        if since < self.oldest_version():
            raise ValueError(
                f"delta history starts at version {self.oldest_version()}"
                f" (got since={since}; raise history=)")
        gained = np.zeros((0, k), dtype=np.int64)
        lost = np.zeros((0, k), dtype=np.int64)
        for rec in self._records:
            if rec.version <= since:
                continue
            d = rec.delta(k, self.order, **self.query)
            # S_since is fixed; step the running diff through this batch
            gained, lost = (
                rows_union(rows_diff(gained, d.lost),
                           rows_diff(d.gained, lost)),
                rows_union(rows_diff(lost, d.gained),
                           rows_diff(d.lost, gained)),
            )
        return DeltaResult(k=k, gained=rows_sorted(gained),
                           lost=rows_sorted(lost))

    def gained_since(self, k: int, since: int,
                     vertex: Optional[int] = None) -> np.ndarray:
        """Rows of cliques gained since ``since`` (the subscription read).

        ``vertex`` restricts to cliques containing that vertex -- the
        same semantics as the serving tier's ``vertex_filter``.
        """
        rows = self.delta(k, since).gained
        if vertex is not None and rows.shape[0]:
            rows = rows[(rows == vertex).any(axis=1)]
        return rows
