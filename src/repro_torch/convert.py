"""Carry the system's state across from the reference package.

The system has no weights: its state is the graph, the preprocessing plan
and the packed tile batches.  This module turns that state, handed over as
plain numpy arrays, into the port's own objects, so a parity test can give
one prebuilt plan and one batch to both packages.  It imports nothing of
the reference package.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .core.graph import Graph
from .core.pipeline import PipelinePlan, TileTable
from .core.truss import TrussDecomposition


def plan_from_arrays(arrays: Dict[str, np.ndarray]) -> PipelinePlan:
    """Rebuild a :class:`PipelinePlan` from the flat array names the
    reference's ``save_plan`` writes: ``graph/{n,edges,indptr,indices}``,
    ``truss_dec/{order,rank,support0,peel_support,trussness,tau}``,
    ``colors`` and ``tables/<family>/<field>``.  Absent parts stay unbuilt
    and are computed on demand."""
    g = Graph(n=int(arrays["graph/n"]), edges=arrays["graph/edges"],
              indptr=arrays["graph/indptr"], indices=arrays["graph/indices"])
    plan = PipelinePlan(g=g)
    if "truss_dec/rank" in arrays:
        plan._td = TrussDecomposition(
            order=arrays["truss_dec/order"], rank=arrays["truss_dec/rank"],
            support0=arrays["truss_dec/support0"],
            peel_support=arrays["truss_dec/peel_support"],
            trussness=arrays["truss_dec/trussness"],
            tau=int(arrays["truss_dec/tau"]))
    if "colors" in arrays:
        plan._colors = arrays["colors"]
    families = sorted({name.split("/")[1] for name in arrays
                       if name.startswith("tables/")})
    for family in families:
        p = f"tables/{family}/"
        plan._tables[family] = TileTable(
            family, arrays[p + "edge_id"], arrays[p + "anchors"],
            arrays[p + "offsets"], arrays[p + "verts"], arrays[p + "thresh"],
            arrays[p + "ekeys"], arrays.get(p + "erank"),
            member_colors=arrays.get(p + "member_colors"),
            ncolors=arrays.get(p + "ncolors"), rule1=arrays.get(p + "rule1"))
    return plan


def batch_to_torch(A_u32: np.ndarray, cand_u32: np.ndarray, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint32 numpy batch -> int32 word tensors on ``device``.

    On the CPU the tensors are zero-copy views of the numpy arrays; for a
    CUDA device they are staged through pinned memory (``pin_memory``
    needs an accelerator, so only that path pins).
    """
    for x in (A_u32, cand_u32):
        if x.dtype != np.uint32:
            raise TypeError(f"packed words must be uint32, got {x.dtype}")
    device = torch.device(device)
    A = torch.from_numpy(np.ascontiguousarray(A_u32)).view(torch.int32)
    cand = torch.from_numpy(np.ascontiguousarray(cand_u32)).view(torch.int32)
    if device.type == "cpu":
        return A, cand
    return (A.pin_memory().to(device, non_blocking=True),
            cand.pin_memory().to(device, non_blocking=True))
