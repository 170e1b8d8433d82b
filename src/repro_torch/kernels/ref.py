"""Plain torch oracles for the counting kernels (the port's twins of
``repro/kernels/ref.py``).

They take the int32 word views the kernels take and return per-tile counts
as int64 holding the reference's uint32 values (wrap mod 2**32).  The
expansion recursion of :func:`clique_count_tiles_ref` needs memory
O(B * T**(l-2)): tests and small cross-checks only.  The twin of
``edge_candidates_ref`` is ``intersect.edge_candidates_torch``, the plain
version beside its kernel.
"""
from __future__ import annotations

import torch

from .common import (MASK32, edges_within, gt_masks, popcount_words,
                     unpack_bits, widen)


def edges_within_ref(A: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """(B,T,W),(B,W) int32 -> (B,) int64 edge count of the cand-induced
    subgraph."""
    T = A.shape[1]
    return edges_within(widen(A), widen(cand), gt_masks(T, A.device))


def triangle_count_tiles_ref(A: torch.Tensor,
                             cand: torch.Tensor) -> torch.Tensor:
    """sum((M @ M) * M) / 6 on the unpacked, cand-masked adjacency M, in
    float64 (exact at every bin)."""
    T = A.shape[1]
    M = unpack_bits(widen(A), T).to(torch.float64)
    c = unpack_bits(widen(cand), T).to(torch.float64)
    M = M * c[:, :, None] * c[:, None, :]
    tri = torch.einsum("bij,bjk,bik->b", M, M, M) / 6.0
    return tri.round().to(torch.int64) & MASK32


def clique_count_tiles_ref(A: torch.Tensor, cand: torch.Tensor,
                           l: int) -> torch.Tensor:
    """Per-tile l-clique count by vectorized expansion recursion."""
    return _expand(widen(A), widen(cand), l)


def _expand(A: torch.Tensor, cand: torch.Tensor, l: int) -> torch.Tensor:
    B, T, W = A.shape
    gt = gt_masks(T, A.device)
    if l == 1:
        return popcount_words(cand).sum(-1) & MASK32
    if l == 2:
        return edges_within(A, cand, gt)
    subs = cand[:, None, :] & A & gt                    # (B, T, W)
    vbit = unpack_bits(cand, T)                         # (B, T)
    inner = _expand(A.repeat_interleave(T, dim=0), subs.reshape(B * T, W),
                    l - 1)
    return (inner.reshape(B, T) * vbit).sum(-1) & MASK32
