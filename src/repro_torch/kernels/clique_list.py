"""Per-tile l-clique listing: the kernel of the listing path.

Port of the Pallas kernel ``repro/kernels/clique_list.py``
(``clique_list_tiles``): every l-clique of each tile goes, as local vertex
ids in lexicographic (DFS) order, into a fixed-capacity ``(capacity, l)``
int32 buffer.  The count returned is the TRUE per-tile total (uint32,
wrapping as the reference wraps), only ranks ``< capacity`` are written,
rows at and past ``min(count, capacity)`` are zero, and
``overflow = count > capacity``: the host relists an overflowed tile, it
never truncates.

l <= 3 is one whole-tile close (``emit_frontier`` / ``emit_edges`` /
``emit_triangles``); l >= 4 walks the todo-stack DFS of
``repro/kernels/lax_backend.py`` (``_list_tile_dfs``): take the lowest set
bit v of the frontier, ``sub = after & A[v]``, close at depth ``l - 3`` by
scattering the edge frontier of ``sub`` behind the prefix of branch
vertices, push when ``popcount(sub) >= l - depth - 1``, pop on an empty
frontier.  On Hopper the kernel is hand-written CUDA
(``csrc/clique_list.cu``): one call runs four device passes over the
tiles' second-level branches (tile b, v, x) -- list them, count each
one's rows, scan the counts into first ranks per tile in (v, x) order, and
write each one's rows from its rank -- so the rows come out in the same
order.

:func:`clique_list_tiles` is the wrapper: a CUDA tensor goes to the
kernel, a CPU tensor to the plain version :func:`clique_list_tiles_torch`.
It takes every l >= 1 and any number of tiles, as the reference does: for
l > T no tile holds an l-clique and it returns the empty triple without a
launch, and a large batch goes to the card in several launches, each of at
most :data:`~repro_torch.kernels.clique_count.LAUNCH_TILES` tiles and of a
per-item count buffer within :data:`PER_X_BYTES`.  Tiles wider than
:data:`~repro_torch.kernels.clique_count.NATIVE_T` take the kernel's wide
path, as the count kernels do.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build
from .clique_count import LAUNCH_TILES, dfs_scratch, launch_chunks
from .common import (MASK32, WORD, Timing, check_tiles, count_call,
                     emit_edges, emit_frontier, emit_triangles, gt_masks,
                     launch_events, member_rows, popcount_words, unpack_bits,
                     widen)

#: most bytes of one launch's per-item count buffer (B * T * T int64):
#: the wrapper splits a batch into launches of at most
#: ``PER_X_BYTES // (8 * T * T)`` tiles (2,048 at T = 256)
PER_X_BYTES = 1 << 30

#: kernel launches so far (the wrapper adds one per launch, nowhere else)
launches = 0
#: calls of the plain version so far
plain_calls = 0

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(l: int, capacity: int) -> None:
    if l < 1:
        raise ValueError(f"clique_list_tiles takes l >= 1, got {l}")
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")


def clique_list_tiles_torch(A: torch.Tensor, cand: torch.Tensor, l: int,
                            capacity: int,
                            work: Optional[Dict[str, torch.Tensor]] = None
                            ) -> Triple:
    """Plain torch version: (B,T,W), (B,W) int32 -> (buf (B,capacity,l)
    int32, count (B,) int64 holding uint32 values, overflow (B,) int64).

    A lane-batched DFS: every lane (tile) keeps its own depth, todo stack
    and prefix, and each turn of the Python ``while`` loop takes one masked
    push / close / pop step on all lanes still running -- the torch twin of
    ``lax_backend._list_batch``.  With ``work`` given, it receives per tile
    the DFS steps (``"steps"``), the vertices of every edge-frontier close
    (``"close_verts"``) and the induced edges the triangle close examined
    (``"close_edges"``): the data-dependent work the kernel does.
    """
    count_call(__name__, "plain_calls")
    B, T, W = check_tiles(A, cand)
    _check(l, capacity)
    dev = A.device
    A64, c64 = widen(A), widen(cand)
    gt = gt_masks(T, dev)
    buf = torch.zeros((B, capacity, l), dtype=torch.int32, device=dev)
    count = torch.zeros(B, dtype=torch.int64, device=dev)
    if work is not None:
        for key in ("steps", "close_verts", "close_edges"):
            work[key] = torch.zeros(B, dtype=torch.int64, device=dev)
    zpfx = torch.zeros((B, l), dtype=torch.int64, device=dev)
    kw = dict(l=l, T=T, capacity=capacity)
    if l == 1:
        emit_frontier(buf, count, c64, zpfx, **kw)
    elif l == 2:
        emit_edges(buf, count, A64, c64, gt, zpfx, **kw)
        if work is not None:
            work["close_verts"] += popcount_words(c64).sum(-1)
    elif l == 3:
        emit_triangles(buf, count, A64, c64, gt, zpfx, **kw)
        if work is not None:
            rows = member_rows(A64, c64) & gt
            work["close_edges"] += unpack_bits(rows, T).sum((-2, -1))
    else:
        _list_dfs(A64, c64, gt, l, capacity, buf, count, work)
    count &= MASK32
    return buf, count, (count > capacity).to(torch.int64)


def _list_dfs(A64, c64, gt, l, capacity, buf, count, work) -> None:
    """The l >= 4 DFS of :func:`clique_list_tiles_torch`, filling ``buf``
    and ``count`` in place."""
    B, T, W = A64.shape
    dev = A64.device
    stack = torch.zeros((B, l - 2, W), dtype=torch.int64, device=dev)
    stack[:, 0] = c64
    prefix = torch.zeros((B, l - 2), dtype=torch.int64, device=dev)
    depth = torch.zeros(B, dtype=torch.int64, device=dev)
    lanes = torch.arange(B, device=dev)
    while True:
        a = lanes[depth >= 0]
        if a.numel() == 0:
            break
        d = depth[a]
        todo = stack[a, d]                                   # (n, W)
        nz = todo != 0
        any_bit = nz.any(-1)
        w_idx = nz.to(torch.int64).argmax(-1)                # first nonzero
        word = todo.gather(-1, w_idx[:, None])[:, 0]
        lsb = word & -word
        tz = popcount_words(torch.where(any_bit, lsb - 1, 0))
        v = torch.where(any_bit, w_idx * WORD + tz, 0)
        after = todo.scatter(-1, w_idx[:, None], (word & (word - 1))[:, None])
        sub = after & A64[a, v]                              # cand & N(v) & gt(v)
        prefix[a, d] = v
        closing = d == l - 3
        c = (any_bit & closing).nonzero()[:, 0]
        if c.numel():
            ac = a[c]
            emit_edges(buf, count, A64[ac], sub[c], gt, prefix[ac], l=l, T=T,
                       capacity=capacity, lanes=ac)
            if work is not None:
                work["close_verts"][ac] += popcount_words(sub[c]).sum(-1)
        nsub = popcount_words(sub).sum(-1)
        push = any_bit & ~closing & (nsub >= l - d - 1)
        nxt = d + push.to(torch.int64)
        stack[a, d] = after
        stack[a, nxt] = torch.where(push[:, None], sub, after)
        depth[a] = torch.where(any_bit, nxt, d - 1)
        if work is not None:
            work["steps"][a] += any_bit.to(torch.int64)


def launch_tiles(T: int) -> int:
    """Most tiles of width T one launch of the list kernel takes: fewer
    than 2**16, and few enough that the (B, T, T) int64 per-item buffer
    stays within :data:`PER_X_BYTES`."""
    return max(1, min(LAUNCH_TILES, PER_X_BYTES // (8 * T * T)))


def clique_list_tiles(A: torch.Tensor, cand: torch.Tensor, l: int,
                      capacity: int, timing: Optional[Timing] = None) -> Triple:
    """(B, T, W) int32, (B, W) int32 -> (buf (B, capacity, l) int32 local
    ids, count (B,) int64 holding the true uint32 totals, overflow (B,)
    int64 flags).

    On a CUDA tensor the buffer is allocated with ``torch.empty``: the
    kernel writes every row, zeros past ``min(count, capacity)`` included.
    ``launches`` counts one per launch of the C entry point (one a call,
    unless the batch is split into several), though each runs four device
    passes.  On a CUDA tensor, ``timing``
    (:func:`~repro_torch.kernels.common.timing_events`) is recorded around
    the launches.
    """
    B, T, _ = check_tiles(A, cand)
    _check(l, capacity)
    if A.device.type == "cpu":
        return clique_list_tiles_torch(A, cand, l, capacity)
    if A.device.type != "cuda":
        raise ValueError(f"no list kernel for device {A.device}")
    if l > T:  # no tile of T vertices holds an l-clique
        launch_events(timing, 0, A.device)
        zeros = torch.zeros(B, dtype=torch.int64, device=A.device)
        return (torch.zeros((B, capacity, l), dtype=torch.int32,
                            device=A.device), zeros, zeros.clone())
    buf = torch.empty((B, capacity, l), dtype=torch.int32, device=A.device)
    cnt = torch.empty(B, dtype=torch.int32, device=A.device)
    ovf = torch.empty(B, dtype=torch.int32, device=A.device)
    chunks = launch_chunks(B, launch_tiles(T))
    events = launch_events(timing, len(chunks), A.device)
    if B:
        n = chunks[0][1]
        # each item's count, then first rank, at [b, v, x]; the list of
        # items; per launch the list's length and the two passes' counters
        per_x = torch.zeros((n, T, T), dtype=torch.int64, device=A.device)
        items, scratch_args, _scratch = dfs_scratch(n, T, l, A.device)
        counters = torch.zeros(3 * len(chunks), dtype=torch.int32,
                               device=A.device)
        so = _build.lib()
        for i, ((lo, hi), ev) in enumerate(zip(chunks, events)):
            with torch.cuda.device(A.device):
                if i:  # the scan pass left first ranks in per_x
                    per_x.zero_()
                stream = torch.cuda.current_stream().cuda_stream
                rc = so.clique_list_tiles_launch(
                    A[lo:hi].data_ptr(), cand[lo:hi].data_ptr(),
                    buf[lo:hi].data_ptr(), cnt[lo:hi].data_ptr(),
                    ovf[lo:hi].data_ptr(), per_x.data_ptr(), items.data_ptr(),
                    counters[3 * i:].data_ptr(), *scratch_args, hi - lo, T, l,
                    capacity, stream, *ev)
            if rc:
                raise RuntimeError(f"clique_list_tiles launch failed: CUDA "
                                   f"error {rc}")
            count_call(__name__, "launches")
    return buf, cnt.to(torch.int64) & MASK32, ovf.to(torch.int64)
