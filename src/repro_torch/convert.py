"""Carry the system's state across from the reference package.

The clique engine has no weights: its state is the graph, the
preprocessing plan and the packed tile batches.  The model substrate's
state is its params.  This module turns that state, handed over as plain
numpy arrays, into the port's own objects, so a parity test can give one
prebuilt plan, one batch or one set of weights to both packages.  It
imports nothing of the reference package.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .core.pipeline import plan_from_arrays  # noqa: F401  (re-exported)


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


def params_to_torch(np_params: Any, device,
                    dtype: torch.dtype = torch.float32) -> Any:
    """A reference model's params (or optimizer state), as nested dicts
    (and lists) of numpy arrays, -> the same tree of tensors on
    ``device``: floating leaves as ``dtype``, integer leaves (AdamW's
    0-d int32 ``count``) at their own dtype.

    Every model family of the port keeps the reference's keys and
    shapes (the transformer's stacked layers and MoE keys, the GNNs'
    layer lists, NequIP's ``self`` weights keyed by ``str(l)``, DCN-v2's
    table), so the map is key for key.
    """
    if isinstance(np_params, dict):
        return {k: params_to_torch(v, device, dtype)
                for k, v in np_params.items()}
    if isinstance(np_params, (list, tuple)):
        return type(np_params)(params_to_torch(v, device, dtype)
                               for v in np_params)
    arr = np.asarray(np_params)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.from_numpy(np.array(arr)).to(torch.device(device))
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        device=torch.device(device), dtype=dtype)


#: the name the LM callers use
lm_params_to_torch = params_to_torch
