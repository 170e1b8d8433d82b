"""On-device truss decomposition (vectorized parallel peeling), in torch.

The port of the reference's ``truss_jax``.  The host peeler
(:mod:`repro_torch.core.truss`) removes one edge at a time -- exact pi_tau,
O(delta*m), but serial.  This variant peels *rounds* (all min-support edges
at once) over a dense boolean adjacency on the device: round-based peeling
yields the identical trussness values and tau (the per-round edge sets are
exactly the classic k-truss peeling levels), only the intra-level order
differs -- which the engine never relies on.  ``pipeline`` keeps the host
peeler, as the reference's does.

Intended for modest n: the (n, n) bool adjacency lives on the device
(rmat12: 16.8 MB; rmat15: 1.07 GB).  Support is triangle message passing
(gather two rows per edge, AND, sum), computed in chunks of edges so that
each (chunk, n) gather stays within :data:`SUPPORT_CHUNK_BYTES`; the
values do not depend on the chunking.  The reference's ``lax.while_loop``
is a host loop here, with one ``alive.any()`` read a round.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from .graph import Graph

#: support of an edge already peeled: above any real support (<= n - 2)
_DEAD = 1 << 30
#: bytes of one (chunk, n) bool row gather of the support computation
SUPPORT_CHUNK_BYTES = 1 << 30


def truss_decomposition_torch(g: Graph, device=None
                              ) -> Tuple[np.ndarray, int]:
    """Returns (trussness per edge (m,) int64, tau).  Exact (tested vs host).

    ``device=None`` means the CUDA device and raises without one; pass
    ``"cpu"`` to run there.
    """
    dev = resolve_device(device)
    n, m = g.n, g.m
    if m == 0:
        return np.zeros(0, np.int64), 0
    if n >= _DEAD:
        raise ValueError(f"n = {n} does not fit the int32 support sentinel")
    e = torch.as_tensor(np.asarray(g.edges, np.int64), device=dev)
    e0, e1 = e[:, 0], e[:, 1]
    adj = torch.zeros((n, n), dtype=torch.bool, device=dev)
    adj[e0, e1] = True
    adj[e1, e0] = True
    chunk = max(1, SUPPORT_CHUNK_BYTES // n)
    dead = torch.full((m,), _DEAD, dtype=torch.int32, device=dev)

    def support(alive: torch.Tensor) -> torch.Tensor:
        s = torch.empty(m, dtype=torch.int32, device=dev)
        for a in range(0, m, chunk):
            b = min(m, a + chunk)
            s[a:b] = (adj[e0[a:b]] & adj[e1[a:b]]).sum(1, dtype=torch.int32)
        return torch.where(alive, s, dead)

    alive = torch.ones(m, dtype=torch.bool, device=dev)
    truss = torch.zeros(m, dtype=torch.int32, device=dev)
    level = torch.zeros((), dtype=torch.int32, device=dev)
    while bool(alive.any()):
        sup = support(alive)
        level = torch.maximum(level, sup.min())
        frontier = alive & (sup <= level)
        truss = torch.where(frontier, level, truss)
        keep = ~frontier
        adj[e0, e1] &= keep
        adj[e1, e0] &= keep
        alive &= keep
    return truss.cpu().numpy().astype(np.int64), int(level)
