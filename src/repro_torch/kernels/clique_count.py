"""Per-tile l-clique counting: the k >= 6 (l >= 4) kernel of the main path.

Port of the Pallas kernel ``repro/kernels/clique_count.py``
(``clique_count_tiles``): an explicit-stack bitset DFS per tile that
descends until three levels remain and closes there with the triangle count
of the candidate-induced subgraph.  On Hopper the kernel is hand-written
CUDA (``csrc/clique_count.cu``), one warp per tile.  It walks the DFS in the
todo-stack form of ``repro/kernels/lax_backend.py`` (``_count_tile_dfs``):
take the lowest set bit v of the frontier, ``sub = after & A[v]``, close at
depth ``l - 4``, push when ``popcount(sub) >= l - depth - 1``, pop on an
empty frontier.  l <= 3 is closed inline, as in the Pallas kernel.

:func:`clique_count_tiles` is the wrapper: a CUDA tensor goes to the
kernel, a CPU tensor to the plain version :func:`clique_count_tiles_torch`,
which takes the role ``lax_backend`` plays for counting in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build
from .common import (MASK32, WORD, check_tiles, edges_within, gt_masks,
                     popcount_words, triangles_within_chunked, widen)

#: largest l the CUDA kernel's stack holds (its kLMax)
L_MAX = 16

#: kernel launches so far (the wrapper adds one per launch, nowhere else)
launches = 0
#: calls of the plain version so far
plain_calls = 0


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
    global plain_calls
    plain_calls += 1
    B, T, W = check_tiles(A, cand)
    _check_l(l)
    A64, c64 = widen(A), widen(cand)
    gt = gt_masks(T, A.device)
    if work is not None:
        work["steps"] = torch.zeros(B, dtype=torch.int64, device=A.device)
        work["close_edges"] = torch.zeros(B, dtype=torch.int64,
                                          device=A.device)
    if l == 1:
        return popcount_words(c64).sum(-1) & MASK32
    if l == 2:
        return edges_within(A64, c64, gt)
    if l == 3:
        if work is not None:
            work["close_edges"] += edges_within(A64, c64, gt)
        return triangles_within_chunked(A64, c64, gt)
    dev = A.device
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
    return count & MASK32


def _check_l(l: int) -> None:
    if not 1 <= l <= L_MAX:
        raise ValueError(f"clique_count_tiles takes 1 <= l <= {L_MAX}, got {l}")


def clique_count_tiles(A: torch.Tensor, cand: torch.Tensor,
                       l: int) -> torch.Tensor:
    """(B, T, W) int32, (B, W) int32 -> (B,) int64 per-tile l-clique counts
    (uint32 values, wrapping mod 2**32 as the reference does)."""
    global launches
    B, T, _ = check_tiles(A, cand)
    _check_l(l)
    if A.device.type == "cpu":
        return clique_count_tiles_torch(A, cand, l)
    if A.device.type != "cuda":
        raise ValueError(f"no clique kernel for device {A.device}")
    out = torch.empty(B, dtype=torch.int32, device=A.device)
    if B:
        so = _build.lib()
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = so.clique_count_tiles_launch(
                A.data_ptr(), cand.data_ptr(), out.data_ptr(), B, T, l, stream)
        if rc:
            raise RuntimeError(f"clique_count_tiles launch failed: CUDA "
                               f"error {rc}")
        launches += 1
    return out.to(torch.int64) & MASK32
