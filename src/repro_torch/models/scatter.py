"""Segment sums and row gathers that add in a fixed order.

The reference scatters with ``jax.ops.segment_sum`` / ``segment_max`` and
gathers with ``x[idx]``, whose gradient is again a segment sum.  In torch
the direct forms (``index_add_``, the backward of ``x[idx]``) add in
atomic order on the card, so two runs of one training step could differ
in their last bits.  Here every sum goes through ``torch.segment_reduce``
over rows grouped by their id: each segment is added in one thread, in
the rows' order, and the result is the same every run.

:class:`Segments` holds one grouping (a stable sort of the ids, built
once and reused); :func:`segment_sum` sums rows by it,
:func:`gather_rows` gathers rows with a backward that sums by it, and
:func:`propagate` fuses gather, weight and sum for a sum aggregator
without keeping the (E, d) messages (GIN's layer).  Ids outside
``[0, num)`` are dropped, as ``jax.ops.segment_sum`` drops them; an
empty segment sums to 0 and its ``max`` is -inf, as in the reference.

The models' SPMD hooks sit where the reference applies its sharding
constraints: ``shard`` is ``None`` (every hook the identity) or a
:class:`repro_torch.sharding.spmd.Rows` splitting node and edge rows in
blocks over the mesh.  A layer then gathers the node rows its edges read
(:func:`full_rows`), works on its own edge block, sums into a full-size
partial and reduce-scatters it back to its node block (:func:`own_rows`);
a graph readout sums the ranks' partials (:func:`total`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Segments:
    """Rows grouped by an id in ``[0, num)``.

    ``order`` lists the row indices id by id, rows of one id in their
    own order, rows whose id lies outside ``[0, num)`` last; ``None``
    when the rows already come grouped (sorted ids, all in range).
    Segment ``i`` is ``order[offsets[i]:offsets[i + 1]]``.
    """
    order: Optional[torch.Tensor]
    offsets: torch.Tensor        # (num + 1,) int64

    def counts(self) -> torch.Tensor:
        """Rows in each segment, (num,) int64."""
        return self.offsets[1:] - self.offsets[:-1]


def _offsets(sorted_keys: torch.Tensor, num: int) -> torch.Tensor:
    return torch.searchsorted(
        sorted_keys, torch.arange(num + 1, device=sorted_keys.device))


def segments(ids: torch.Tensor, num: int) -> Segments:
    """Group the rows of ``ids`` (any integer dtype, 1-D) by id."""
    ids = ids.long()
    key = torch.where((ids >= 0) & (ids < num), ids, num)
    key, order = torch.sort(key, stable=True)
    return Segments(order, _offsets(key, num))


def sorted_segments(ids: torch.Tensor, num: int) -> Segments:
    """:func:`segments` of ids already sorted and in ``[0, num)``."""
    return Segments(None, _offsets(ids.long(), num))


def _reduce(x: torch.Tensor, seg: Segments, reduce: str) -> torch.Tensor:
    if seg.order is not None:
        # a permutation: its backward adds each row once
        x = x.index_select(0, seg.order)
    return torch.segment_reduce(x, reduce, offsets=seg.offsets, axis=0,
                                unsafe=True)


def segment_sum(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """(num, ...) sums of the rows of ``x`` (one a row of ``ids``)."""
    return _reduce(x, seg, "sum")


def segment_max(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """(num, ...) maxima; an empty segment gives -inf."""
    return _reduce(x, seg, "max")


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index, seg_order, seg_offsets):
        ctx.save_for_backward(seg_order, seg_offsets)
        ctx.has_order = seg_order is not None
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        order, offsets = ctx.saved_tensors
        seg = Segments(order if ctx.has_order else None, offsets)
        return segment_sum(grad.contiguous(), seg), None, None, None


def gather_rows(x: torch.Tensor, index: torch.Tensor,
                seg: Optional[Segments] = None) -> torch.Tensor:
    """``x[index]``; its gradient sums the rows of each ``index`` value in
    a fixed order.  ``seg`` is ``segments(index, x.shape[0])`` (built
    here when not given and a gradient is needed)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x.index_select(0, index)
    if seg is None:
        seg = segments(index, x.shape[0])
    return _Gather.apply(x, index, seg.order, seg.offsets)


@dataclasses.dataclass(frozen=True)
class EdgeIndex:
    """A batch's edges sorted by ``dst`` (stable), with both groupings.

    ``perm`` is the sort: per-edge inputs (masks, edge features) are
    taken through it so that they line up with ``src`` and ``dst``.
    The models' outputs are per node or per graph, so the order of the
    edges changes only the order in which each segment adds.
    """
    src: torch.Tensor            # (E,) int64, in dst order
    dst: torch.Tensor            # (E,) int64, sorted
    perm: torch.Tensor           # (E,) the stable sort by dst
    by_dst: Segments             # rows already grouped
    by_src: Segments


def edge_index(edges: torch.Tensor, num_nodes: int) -> EdgeIndex:
    """Index the (2, E) ``edges`` of a graph of ``num_nodes`` nodes.

    Raises ``ValueError`` for an id outside ``[0, num_nodes)``: the
    reference would clamp such a gather, and no pipeline makes one.
    ``meta`` edges (the dry run's) hold no ids to check."""
    edges = edges.long()
    if edges.numel() and not edges.is_meta and (int(edges.min()) < 0
                          or int(edges.max()) >= num_nodes):
        raise ValueError(f"edge ids must lie in [0, {num_nodes})")
    dst, perm = torch.sort(edges[1], stable=True)
    src = edges[0].index_select(0, perm)
    return EdgeIndex(src, dst, perm, sorted_segments(dst, num_nodes),
                     segments(src, num_nodes))


def _weighted_sum(h, w, index, offsets):
    m = h.index_select(0, index)
    m.mul_(w.view(-1, *([1] * (h.dim() - 1))))
    return torch.segment_reduce(m, "sum", offsets=offsets, axis=0,
                                unsafe=True)


class _Propagate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, src, dst_offsets, src_order, src_offsets, dst):
        ctx.save_for_backward(w, src_order, src_offsets, dst)
        return _weighted_sum(h, w, src, dst_offsets)

    @staticmethod
    def backward(ctx, grad):
        w, src_order, src_offsets, dst = ctx.saved_tensors
        # the transpose: each edge carries grad[dst] * w back to its src
        gh = _weighted_sum(grad.contiguous(), w.index_select(0, src_order),
                           dst.index_select(0, src_order), src_offsets)
        return gh, None, None, None, None, None, None


def propagate(h: torch.Tensor, w: torch.Tensor, ei: EdgeIndex
              ) -> torch.Tensor:
    """``segment_sum(h[src] * w[:, None], dst)`` over ``ei``'s edges (``w``
    in ``ei``'s edge order, no gradient), holding one (E, d) buffer at a
    time in each direction.  Its gradient is the same sum over the
    reversed edges, grouped by ``src``."""
    if not (torch.is_grad_enabled() and h.requires_grad):
        return _weighted_sum(h, w, ei.src, ei.by_dst.offsets)
    return _Propagate.apply(h, w.detach(), ei.src, ei.by_dst.offsets,
                            ei.by_src.order, ei.by_src.offsets, ei.dst)


def full_rows(x: torch.Tensor, shard) -> torch.Tensor:
    """Every rank's block of rows, in block order (``x`` without a
    shard)."""
    return x if shard is None else shard.gather(x)


def own_rows(x: torch.Tensor, shard) -> torch.Tensor:
    """This rank's block of the sum over ranks of the full-size partial
    ``x`` (``x`` without a shard)."""
    return x if shard is None else shard.scatter(x)


def total(x: torch.Tensor, shard) -> torch.Tensor:
    """The sum over ranks of the partial ``x`` (``x`` without a
    shard)."""
    return x if shard is None else shard.psum_partials(x)


def num_rows(x: torch.Tensor, shard) -> int:
    """The global row count of ``x``'s rows."""
    return x.shape[0] if shard is None else x.shape[0] * shard.size
