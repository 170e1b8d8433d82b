"""Edge-branch candidate construction (EBBkC Eq. 2), per tile.

Port of the Pallas kernel ``repro/kernels/intersect.py``
(``edge_candidates``): for each tile's pair (a, b) of local vertices, the
sub-branch candidate set ``cand = A[a] & A[b] & gt(b)`` -- N(a) & N(b)
restricted to vertices above b -- and its size.  On Hopper the kernel is
hand-written CUDA (``csrc/edge_candidates.cu``), one thread per tile,
which writes the sizes as int64 itself, so a call is one launch after the
checks.

:func:`edge_candidates` is the wrapper: a CUDA tensor goes to the kernel,
a CPU tensor to the plain version :func:`edge_candidates_torch`, the torch
twin of ``repro/kernels/ref.py`` ``edge_candidates_ref``.  No engine calls
it; ``ops.edge_candidates`` exposes it as the reference's ``ops`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .common import (MASK32, check_adjacency, gt_masks, popcount_words,
                     to_words, widen)

#: kernel launches so far (the wrapper adds one per launch, nowhere else)
launches = 0
#: calls of the plain version so far
plain_calls = 0


def _check_pairs(A: torch.Tensor, pairs: torch.Tensor) -> Tuple[int, int, int]:
    """Validate (B, T, W) int32 tiles and (B, 2) int32 local-id pairs in
    [0, T); returns (B, T, W)."""
    B, T, W = check_adjacency(A)
    if pairs.dtype != torch.int32:
        raise TypeError(f"pairs must be int32, got {pairs.dtype}")
    if tuple(pairs.shape) != (B, 2):
        raise ValueError(f"pairs must be ({B}, 2), got {tuple(pairs.shape)}")
    if pairs.device != A.device:
        raise ValueError(f"A on {A.device} but pairs on {pairs.device}")
    if not pairs.is_contiguous():
        raise ValueError("pairs must be contiguous")
    if B and not bool(((pairs >= 0) & (pairs < T)).all()):
        raise ValueError(f"pairs must hold local ids in [0, {T})")
    return B, T, W


def edge_candidates_torch(A: torch.Tensor, pairs: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: (B,T,W) int32, (B,2) int32 -> (cand (B,W)
    int32 words, n (B,) int64 holding uint32 values)."""
    global plain_calls
    plain_calls += 1
    B, T, W = _check_pairs(A, pairs)
    A64 = widen(A)
    p = pairs.to(torch.int64)
    lanes = torch.arange(B, device=A.device)
    cand = A64[lanes, p[:, 0]] & A64[lanes, p[:, 1]] & gt_masks(T, A.device)[p[:, 1]]
    return to_words(cand), popcount_words(cand).sum(-1) & MASK32


def edge_candidates(A: torch.Tensor, pairs: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, W) int32, (B, 2) int32 local ids (a < b) -> (cand (B, W)
    int32 words of N(a) & N(b) & gt(b), n (B,) int64 their sizes)."""
    global launches
    B, T, W = _check_pairs(A, pairs)
    if A.device.type == "cpu":
        return edge_candidates_torch(A, pairs)
    if A.device.type != "cuda":
        raise ValueError(f"no edge_candidates kernel for device {A.device}")
    if pairs.data_ptr() % 8:
        raise ValueError("pairs must start on an 8-byte boundary (the kernel "
                         "reads each pair as one int2)")
    cand = torch.empty((B, W), dtype=torch.int32, device=A.device)
    n = torch.empty(B, dtype=torch.int64, device=A.device)
    if B:
        so = _build.lib()
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = so.edge_candidates_launch(A.data_ptr(), pairs.data_ptr(),
                                           cand.data_ptr(), n.data_ptr(), B,
                                           T, stream)
        if rc:
            raise RuntimeError(f"edge_candidates launch failed: CUDA error "
                               f"{rc}")
        launches += 1
    return cand, n
