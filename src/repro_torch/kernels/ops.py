"""Kernel routing for per-tile clique counting and listing (port of
``repro/kernels/ops.py``).

:func:`count_tiles` routes by l = k - 2 exactly as the reference's Pallas
family does:

* ``method="auto"``: l == 3 goes to the triangle kernel
  (:mod:`repro_torch.kernels.triangle_mm`), l >= 4 to the DFS kernel
  (:mod:`repro_torch.kernels.clique_count`);
* ``"mxu"`` pins the triangle kernel (l == 3 only; the name is the
  reference's, kept so call sites read the same);
* ``"dfs"`` pins the DFS kernel, l == 3 included;
* ``"ref"`` runs the expansion oracle of :mod:`repro_torch.kernels.ref`.

l <= 2 takes closed forms and no kernel.  :func:`list_tiles` lists every
l-clique of each tile through :mod:`repro_torch.kernels.clique_list`, and
:func:`edge_candidates` builds edge-branch candidate sets through
:mod:`repro_torch.kernels.intersect`.  Each kernel wrapper sends a CUDA
tensor to its CUDA kernel and a CPU tensor to its plain torch version; the
launch counters below show which ran.

Still to be ported: ``autotune`` and the backend registry (tune slice).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import clique_count as _cc
from . import clique_list as _cl
from . import intersect as _is
from . import ref as _ref
from . import triangle_mm as _tm
from .common import COUNTER_LOCK

METHODS = ("auto", "mxu", "dfs", "ref")

_KERNELS = {"triangle_count_tiles": _tm, "clique_count_tiles": _cc,
            "clique_list_tiles": _cl, "edge_candidates": _is}


def count_tiles(A: torch.Tensor, cand: torch.Tensor, l: int,
                method: str = "auto") -> torch.Tensor:
    """Count l-cliques per tile: (B,T,W) int32 x (B,W) int32 -> (B,) int64
    (uint32 values)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{METHODS}")
    if l < 1:
        raise ValueError("counting requires l >= 1")
    if method == "ref" or l <= 2:
        return _ref.clique_count_tiles_ref(A, cand, l)
    if method == "mxu" or (method == "auto" and l == 3):
        if l != 3:
            raise ValueError("the triangle kernel implements l == 3 only")
        return _tm.triangle_count_tiles(A, cand)
    return _cc.clique_count_tiles(A, cand, l)


def list_tiles(A: torch.Tensor, cand: torch.Tensor, l: int, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """List l-cliques per tile into fixed-capacity local-id buffers.

    (B,T,W) int32 x (B,W) int32 -> (out (B,capacity,l) int32, count (B,)
    int64 true totals holding uint32 values, overflow (B,) int64).
    Overflowed tiles keep the true count but only the first ``capacity``
    cliques; callers must relist them on the host, never truncate.
    """
    return _cl.clique_list_tiles(A, cand, l, capacity)


def edge_candidates(A: torch.Tensor, pairs: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate sets N(a) & N(b) & gt(b) of each tile's pair (a, b) and
    their sizes: (B,T,W) int32 x (B,2) int32 -> ((B,W) int32, (B,) int64)."""
    return _is.edge_candidates(A, pairs)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    with COUNTER_LOCK:
        return {name: mod.launches for name, mod in _KERNELS.items()}


def plain_counts() -> Dict[str, int]:
    """Plain-version calls per kernel since the last reset."""
    with COUNTER_LOCK:
        return {name: mod.plain_calls for name, mod in _KERNELS.items()}


def reset_counts() -> None:
    """Set every launch and plain-call counter to 0 (the wrappers add to
    them under :data:`~repro_torch.kernels.common.COUNTER_LOCK`, from any
    thread)."""
    with COUNTER_LOCK:
        for mod in _KERNELS.values():
            mod.launches = 0
            mod.plain_calls = 0
