"""Shared helpers for the clique kernels of the PyTorch port.

Plain torch forms of the reference's base-case set math
(``repro/kernels/common.py``): the edge and triangle counts of a
candidate-induced subgraph, on packed words widened to int64 (see
:mod:`repro_torch.core.bitops`).  They are batched over any leading
dimensions, and they are the arithmetic that the CUDA kernels in ``csrc/``
reproduce.  Also here: the input checks every kernel wrapper shares, and
the host Pascal table of the closed-form 2-plex count.

Still to be ported with the listing slice: the emit scatters
(``emit_frontier``, ``emit_edges``, ``emit_triangles``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.bitops import (  # noqa: F401  (re-exported kernel API)
    MASK32,
    WORD,
    gt_masks,
    gt_masks_np,
    num_words,
    popcount_words,
    unpack_bits,
    widen,
)

#: tile widths the kernels take (the pipeline's bins)
TILE_WIDTHS = (32, 64, 128, 256)


def member_rows(A: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Rows of the cand-induced subgraph: A[v] & cand, zeroed for v not in
    cand.  A: (..., T, W) int64 words, cand: (..., W).  Returns (..., T, W)."""
    T = A.shape[-2]
    vbit = unpack_bits(cand, T)                          # (..., T)
    rows = A & cand[..., None, :]
    return torch.where(vbit[..., None] > 0, rows, torch.zeros_like(rows))


def edges_within(A: torch.Tensor, cand: torch.Tensor,
                 gt: torch.Tensor) -> torch.Tensor:
    """Edge count of the cand-induced subgraph (each pair once), mod 2**32.

    A: (..., T, W) int64 words, cand: (..., W), gt: (T, W).  Returns (...,).
    """
    T = A.shape[-2]
    rows = A & cand[..., None, :] & gt                   # neighbors > v in cand
    per_v = popcount_words(rows).sum(-1)                 # (..., T)
    vbit = unpack_bits(cand, T)
    return (per_v * vbit).sum(-1) & MASK32


def triangles_within(A: torch.Tensor, cand: torch.Tensor,
                     gt: torch.Tensor) -> torch.Tensor:
    """Triangle count of the cand-induced subgraph (each once), mod 2**32.

    Every triangle v<u<w is attributed to its edge (v, u) and counted as
    |N(v) & N(u) & cand & gt(u)|: one (..., T, T, W) word AND + popcount.
    A: (..., T, W) int64 words, cand: (..., W), gt: (T, W).  Returns (...,).
    """
    T = A.shape[-2]
    rows = member_rows(A, cand)                          # (..., T, W)
    pair = rows[..., :, None, :] & rows[..., None, :, :] & gt
    cnt = popcount_words(pair).sum(-1)                   # (..., T, T)
    adj = unpack_bits(rows & gt, T)                      # edge v<u in cand
    return (adj * cnt).sum((-2, -1)) & MASK32


def triangles_within_chunked(A: torch.Tensor, cand: torch.Tensor,
                             gt: torch.Tensor,
                             budget: int = 256 << 20) -> torch.Tensor:
    """:func:`triangles_within` over a (B, T, W) batch, chunked over B so
    the (b, T, T, W) int64 pair intersection stays under ``budget`` bytes."""
    B, T, W = A.shape
    step = max(1, budget // (T * T * W * 8))
    out = torch.empty(B, dtype=torch.int64, device=A.device)
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        out[sl] = triangles_within(A[sl], cand[sl], gt)
    return out


def check_tiles(A: torch.Tensor, cand: torch.Tensor) -> Tuple[int, int, int]:
    """Validate a packed batch for the kernels; returns (B, T, W).

    A must be a contiguous (B, T, T//32) int32 word view with T one of
    :data:`TILE_WIDTHS`, and cand a contiguous (B, T//32) int32 view on
    the same device.
    """
    if A.dtype != torch.int32 or cand.dtype != torch.int32:
        raise TypeError(
            f"packed words must be int32 views, got {A.dtype} / {cand.dtype}")
    if A.dim() != 3:
        raise ValueError(f"A must be (B, T, W), got shape {tuple(A.shape)}")
    B, T, W = A.shape
    if T not in TILE_WIDTHS or W != T // WORD:
        raise ValueError(
            f"tile shape (T={T}, W={W}) must have T in {TILE_WIDTHS} and "
            f"W == T // 32")
    if tuple(cand.shape) != (B, W):
        raise ValueError(
            f"cand must be ({B}, {W}), got shape {tuple(cand.shape)}")
    if A.device != cand.device:
        raise ValueError(f"A on {A.device} but cand on {cand.device}")
    if not (A.is_contiguous() and cand.is_contiguous()):
        raise ValueError("A and cand must be contiguous")
    return B, T, W


def pascal_table(nmax: int) -> np.ndarray:
    """C(n, r) table, int64, (nmax+1, nmax+1); entries that overflow clamp."""
    t = np.zeros((nmax + 1, nmax + 1), dtype=np.int64)
    t[:, 0] = 1
    for n in range(1, nmax + 1):
        for r in range(1, n + 1):
            v = t[n - 1, r - 1] + t[n - 1, r]
            t[n, r] = v
    return t
