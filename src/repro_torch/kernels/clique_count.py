"""Per-tile l-clique counting: the k >= 6 (l >= 4) kernel of the main path.

Port of the Pallas kernel ``repro/kernels/clique_count.py``
(``clique_count_tiles``): an explicit-stack bitset DFS per tile that
descends until three levels remain and closes there with the triangle count
of the candidate-induced subgraph.  On Hopper the kernel is hand-written
CUDA (``csrc/clique_count.cu``).  It walks the DFS in the todo-stack form
of ``repro/kernels/lax_backend.py`` (``_count_tile_dfs``): take the lowest
set bit v of the frontier, ``sub = after & A[v]``, close at depth ``l - 4``,
push when ``popcount(sub) >= l - depth - 1``, pop on an empty frontier.  The
kernel splits each tile's DFS into its second-level branches, the items
(tile b, v, x) with x in ``sub = cand & A[v] & gt(v)``: item (b, v, x)
counts the (l-2)-cliques of ``sub & A[x] & gt(x)``, and a tile's count is
the sum of its items'.

:func:`clique_count_tiles` is the wrapper: a CUDA tensor goes to the
kernel, a CPU tensor to the plain version :func:`clique_count_tiles_torch`,
which takes the role ``lax_backend`` plays for counting in the reference.
:func:`clique_count_items` gives the count per first-level branch
(tile b, v), the items' counts summed over x, with its plain version
:func:`clique_count_items_torch`.

Both take every l >= 1, any number of tiles B and every tile width
T = 32 * W, as the reference does: for l > T no tile holds an l-clique and
the wrappers return zeros without a launch, and a batch of
:data:`LAUNCH_TILES` tiles or more goes to the card in several launches
(an item packs its tile index into 16 bits).  Tiles up to
:data:`NATIVE_T` run the kernel's instantiation for their W; wider ones
its wide path (``csrc/dfs_wide.cuh``, chosen by the same C entry
points), which takes 64-bit items and a per-warp scratch that the wrapper
allocates, in launches whose item list stays within
:data:`WIDE_ITEM_BYTES`.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build
from .common import (MASK32, WORD, Timing, check_tiles, count_call,
                     edges_within, gt_masks, launch_events, popcount_words,
                     triangles_within_chunked, unpack_bits, widen)

#: most tiles one launch of a DFS kernel takes (an item packs its tile
#: index into 16 bits); the wrappers split a larger batch into launches
LAUNCH_TILES = (1 << 16) - 1

#: widest tile with an instantiation of its own (W = T/32 <= 8) in every
#: kernel; wider tiles take the kernels' wide path, W a runtime argument
NATIVE_T = 256
#: most bytes of one wide launch's item list (B * T * (T + 1) / 2 uint64)
WIDE_ITEM_BYTES = 1 << 30
#: most bytes of one wide launch's per-warp DFS scratch
WIDE_SCRATCH_BYTES = 256 << 20
#: warps an SM holds at once (2,048 threads): the wide path's largest grid
_WARPS_PER_SM = 64
#: warps of one block of the wide kernels (``dfs_wide.cuh`` kWarps)
_WIDE_BLOCK_WARPS = 8

#: kernel launches so far (the wrapper adds one per launch, nowhere else)
launches = 0
#: calls of the plain version so far
plain_calls = 0
#: launches of the per-branch count (:func:`clique_count_items`) so far
item_launches = 0

#: items the plain item version runs through one DFS at most
_ITEM_CHUNK = 4096


def clique_count_tiles_torch(A: torch.Tensor, cand: torch.Tensor, l: int,
                             work: Optional[Dict[str, torch.Tensor]] = None
                             ) -> torch.Tensor:
    """Plain torch version: (B,T,W), (B,W) int32 -> (B,) int64 counts.

    A lane-batched DFS: every lane (tile) keeps its own depth and todo
    stack, and each turn of the Python ``while`` loop takes one masked
    push / close / pop step on all lanes still running -- the torch twin of
    ``lax_backend._count_batch``.  With ``work`` given, it receives the
    per-tile DFS steps (``"steps"``) and the induced edges the closes
    examined (``"close_edges"``): the data-dependent work the kernel does.
    """
    count_call(__name__, "plain_calls")
    B, T, W = check_tiles(A, cand)
    _check_l(l)
    return _count(widen(A), widen(cand), l, work) & MASK32


def _count(A64: torch.Tensor, c64: torch.Tensor, l: int,
           work: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """The DFS of :func:`clique_count_tiles_torch` on widened words, exact
    in int64 (each close's triangle count is below 2**32)."""
    B, T, W = A64.shape
    gt = gt_masks(T, A64.device)
    if work is not None:
        work["steps"] = torch.zeros(B, dtype=torch.int64, device=A64.device)
        work["close_edges"] = torch.zeros(B, dtype=torch.int64,
                                          device=A64.device)
    if l == 1:
        return popcount_words(c64).sum(-1)
    if l == 2:
        return edges_within(A64, c64, gt)
    if l == 3:
        if work is not None:
            work["close_edges"] += edges_within(A64, c64, gt)
        return triangles_within_chunked(A64, c64, gt)
    dev = A64.device
    stack = torch.zeros((B, l - 3, W), dtype=torch.int64, device=dev)
    stack[:, 0] = c64
    depth = torch.zeros(B, dtype=torch.int64, device=dev)
    count = torch.zeros(B, dtype=torch.int64, device=dev)
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
        nsub = popcount_words(sub).sum(-1)
        closing = d == l - 4
        c = (any_bit & closing & (nsub >= 3)).nonzero()[:, 0]
        if c.numel():
            count[a[c]] += triangles_within_chunked(A64[a[c]], sub[c], gt)
            if work is not None:
                work["close_edges"][a[c]] += edges_within(A64[a[c]], sub[c],
                                                          gt)
        push = any_bit & ~closing & (nsub >= l - d - 1)
        nxt = d + push.to(torch.int64)
        stack[a, d] = after
        stack[a, nxt] = torch.where(push[:, None], sub, after)
        depth[a] = torch.where(any_bit, nxt, d - 1)
        if work is not None:
            work["steps"][a] += any_bit.to(torch.int64)
    return count


def clique_count_items_torch(A: torch.Tensor, cand: torch.Tensor,
                             l: int) -> torch.Tensor:
    """Plain version of the per-branch count: (B,T,W), (B,W) int32 ->
    (B, T) int64.

    Entry (b, v) is the number of l-cliques of tile b whose lowest vertex is
    v: the (l-1)-cliques of ``sub = cand & A[v] & gt(v)``, exact in int64.
    It is 0 where v is not in cand or ``popcount(sub) < l - 1`` (the
    kernels drop those branches).  Row sums mod 2**32 are
    :func:`clique_count_tiles_torch`.
    """
    B, T, W = check_tiles(A, cand)
    _check_l(l)
    A64, c64 = widen(A), widen(cand)
    sub = c64[:, None, :] & A64 & gt_masks(T, A.device)        # (B, T, W)
    kept = ((unpack_bits(c64, T) > 0)
            & (popcount_words(sub).sum(-1) >= l - 1)).nonzero()
    out = torch.zeros((B, T), dtype=torch.int64, device=A.device)
    for lo in range(0, kept.shape[0], _ITEM_CHUNK):
        b, v = kept[lo:lo + _ITEM_CHUNK].unbind(1)
        if l == 1:
            out[b, v] = 1
        else:
            out[b, v] = _count(A64[b], sub[b, v], l - 1)
    return out


def _check_l(l: int) -> None:
    if l < 1:
        raise ValueError(f"clique_count_tiles takes l >= 1, got {l}")


def launch_chunks(B: int, limit: int = LAUNCH_TILES):
    """The (lo, hi) tile ranges of the launches that cover a batch of B
    tiles, at most ``limit`` tiles each."""
    return [(lo, min(B, lo + limit)) for lo in range(0, B, limit)]


def count_launch_tiles(T: int) -> int:
    """Most tiles of width T one launch of the count kernels takes: fewer
    than 2**16, and at T > :data:`NATIVE_T` few enough that the item list
    stays within :data:`WIDE_ITEM_BYTES` (63 tiles at T = 2048)."""
    if T <= NATIVE_T:
        return LAUNCH_TILES
    return max(1, min(LAUNCH_TILES, WIDE_ITEM_BYTES // (4 * T * (T + 1))))


def wide_scratch(T: int, l: int, device: torch.device) -> torch.Tensor:
    """The wide path's per-warp DFS scratch on ``device``: a slot of
    ``dfs_slot_words(T, l)`` words (``csrc/clique_count.cu``) for every
    warp the card holds at once, within :data:`WIDE_SCRATCH_BYTES` (at
    least one block's worth)."""
    slot = _build.lib().dfs_slot_words(T, l)
    warps = torch.cuda.get_device_properties(device).multi_processor_count \
        * _WARPS_PER_SM
    slots = max(_WIDE_BLOCK_WARPS,
                min(warps, WIDE_SCRATCH_BYTES // (4 * slot)))
    return torch.empty(slots * slot, dtype=torch.int32, device=device)


def dfs_scratch(B: int, T: int, l: int, device: torch.device):
    """One DFS launch's scratch for B tiles of width T: the item list, and
    the scratch arguments of the C entry points (the wide path's scratch
    pointer and words; null and 0 at T <= :data:`NATIVE_T`) with the
    tensor that holds them.  Returns ``(items, (ptr, words), scratch)``."""
    if T <= NATIVE_T:
        return item_list(B, T, device), (None, 0), None
    scratch = wide_scratch(T, l, device)
    items = torch.empty(B * T * (T + 1) // 2, dtype=torch.int64,
                        device=device)
    return items, (scratch.data_ptr(), scratch.numel()), scratch


def clique_count_tiles(A: torch.Tensor, cand: torch.Tensor, l: int,
                       timing: Optional[Timing] = None) -> torch.Tensor:
    """(B, T, W) int32, (B, W) int32 -> (B,) int64 per-tile l-clique counts
    (uint32 values, wrapping mod 2**32 as the reference does).  On a CUDA
    tensor, ``timing`` (:func:`~repro_torch.kernels.common.timing_events`)
    is recorded around the launches."""
    B, T, _ = check_tiles(A, cand)
    _check_l(l)
    if A.device.type == "cpu":
        return clique_count_tiles_torch(A, cand, l)
    if A.device.type != "cuda":
        raise ValueError(f"no clique kernel for device {A.device}")
    if l > T:  # no tile of T vertices holds an l-clique
        launch_events(timing, 0, A.device)
        return torch.zeros(B, dtype=torch.int64, device=A.device)
    chunks = launch_chunks(B, count_launch_tiles(T))
    # out[:B] the counts, then each launch's two item counters, all 0
    out = torch.zeros(B + 2 * len(chunks), dtype=torch.int32, device=A.device)
    events = launch_events(timing, len(chunks), A.device)
    if B:
        items, scratch_args, _scratch = dfs_scratch(chunks[0][1], T, l, A.device)
        so = _build.lib()
        for i, ((lo, hi), ev) in enumerate(zip(chunks, events)):
            with torch.cuda.device(A.device):
                stream = torch.cuda.current_stream().cuda_stream
                rc = so.clique_count_tiles_launch(
                    A[lo:hi].data_ptr(), cand[lo:hi].data_ptr(),
                    out[lo:hi].data_ptr(), items.data_ptr(),
                    out[B + 2 * i:].data_ptr(), *scratch_args, hi - lo, T, l, stream,
                    *ev)
            if rc:
                raise RuntimeError(f"clique_count_tiles launch failed: CUDA "
                                   f"error {rc}")
            count_call(__name__, "launches")
    return out[:B].to(torch.int64) & MASK32


def item_list(B: int, T: int, device: torch.device) -> torch.Tensor:
    """Scratch for one launch's list of items (tile, v, x): room for every
    pair v <= x of every tile, packed into 32 bits (so B < 2**16; the
    wrappers split a larger batch into launches)."""
    if B > LAUNCH_TILES:
        raise ValueError(f"one launch of the DFS kernels takes at most "
                         f"{LAUNCH_TILES} tiles, got {B}")
    return torch.empty(B * T * (T + 1) // 2, dtype=torch.int32, device=device)


def clique_count_items(A: torch.Tensor, cand: torch.Tensor,
                       l: int) -> torch.Tensor:
    """(B, T, W) int32, (B, W) int32 -> (B, T) int64: the l-cliques of each
    tile per lowest vertex (see :func:`clique_count_items_torch`)."""
    B, T, _ = check_tiles(A, cand)
    _check_l(l)
    if A.device.type == "cpu":
        return clique_count_items_torch(A, cand, l)
    if A.device.type != "cuda":
        raise ValueError(f"no clique kernel for device {A.device}")
    per_v = torch.zeros((B, T), dtype=torch.int64, device=A.device)
    if B and l <= T:
        chunks = launch_chunks(B, count_launch_tiles(T))
        items, scratch_args, _scratch = dfs_scratch(chunks[0][1], T, l, A.device)
        counters = torch.zeros(2 * len(chunks), dtype=torch.int32,
                               device=A.device)
        so = _build.lib()
        for i, (lo, hi) in enumerate(chunks):
            with torch.cuda.device(A.device):
                stream = torch.cuda.current_stream().cuda_stream
                rc = so.clique_count_items_launch(
                    A[lo:hi].data_ptr(), cand[lo:hi].data_ptr(),
                    per_v[lo:hi].data_ptr(), items.data_ptr(),
                    counters[2 * i:].data_ptr(), *scratch_args, hi - lo, T, l,
                    stream, None, None)
            if rc:
                raise RuntimeError(f"clique_count_items launch failed: CUDA "
                                   f"error {rc}")
            count_call(__name__, "item_launches")
    return per_v
