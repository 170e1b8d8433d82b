"""The LM train step of the reference's ``launch.steps.lm_train_cell``.

Only the step: M microbatches, each one's loss and grads (f32, since the
params are f32) accumulated in f32, the sum divided by M, then one AdamW
update with ``AdamWConfig(lr=3e-4, schedule=cosine_schedule(100,
10000))``.  The reference's ``Cell``, abstract shapes and shardings
belong to its dry run and sharding (ROADMAP A13e).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..configs.base import ArchSpec, ShapeCell
from ..models import transformer as tr
from ..optim import (AdamWConfig, adamw_update, cosine_schedule,
                     tree_leaves, tree_unflatten)


@dataclasses.dataclass
class TrainStep:
    """One (arch x train shape) step and the shapes it takes."""
    step_fn: Callable      # (params, opt_state, batch) -> (params, opt, metrics)
    cfg: tr.TransformerConfig
    batch: int             # global batch B
    seq_len: int           # S
    microbatches: int      # M (B % M == 0)
    meta: Dict[str, Any]


def loss_and_grads(params, batch, cfg: tr.TransformerConfig,
                   microbatches: int) -> Tuple[torch.Tensor, Dict]:
    """Mean loss and grads over ``microbatches`` equal slices of
    ``batch`` (``tokens``/``labels``, numpy or tensors, (B, S)), the
    grads summed in f32 in microbatch order and divided by M, as the
    reference's scan does.  The batch goes to the params' device; the
    param leaves are made to require grad."""
    leaves = tree_leaves(params)
    device = leaves[0].device
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.as_tensor(np.asarray(v), device=device)
             for k, v in batch.items()}
    M = microbatches
    b = batch["tokens"].shape[0] // M
    grads, loss_sum = None, torch.zeros((), device=device)
    for m in range(M):
        mb = {k: v[m * b:(m + 1) * b] for k, v in batch.items()}
        with torch.enable_grad():
            loss = tr.loss_fn(params, mb, cfg)
            gs = torch.autograd.grad(loss, leaves)
        if grads is None:
            grads = [g.float() for g in gs]
        else:
            for acc, g in zip(grads, gs):
                acc.add_(g.float())
        del gs
        loss_sum = loss_sum + loss.detach()
    for g in grads:
        g.div_(M)
    return loss_sum / M, tree_unflatten(params, grads)


def lm_train_cell(spec: ArchSpec, cell: ShapeCell, reduced: bool = False,
                  microbatches: int = 16) -> TrainStep:
    """The gradient-accumulated train step of ``cell`` (a train shape of
    ``spec``).  ``reduced`` takes the arch's smoke config at B, S = 2,
    min(S, 64) and one microbatch, as the reference; M falls back to 1
    when it does not divide B."""
    cfg: tr.TransformerConfig = spec.reduced if reduced else spec.full
    B, S = cell.dims["global_batch"], cell.dims["seq_len"]
    if reduced:
        B, S = 2, min(S, 64)
        microbatches = 1
    M = microbatches if B % microbatches == 0 else 1
    opt_cfg = AdamWConfig(lr=3e-4, schedule=cosine_schedule(100, 10000))

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg, M)
        params, opt_state, m = adamw_update(grads, opt_state, params,
                                            opt_cfg)
        return params, opt_state, {"loss": loss, **m}

    return TrainStep(step_fn=step, cfg=cfg, batch=B, seq_len=S,
                     microbatches=M,
                     meta={"tokens_per_step": B * S,
                           "model_params": cfg.num_params(),
                           "active_params": cfg.active_params()})
