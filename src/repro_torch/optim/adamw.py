"""AdamW with decoupled weight decay and global-norm clipping: the port
of the reference's ``optim.adamw``.

Trees are nested dicts (and lists) of tensors.  Leaves are visited in
the reference's order (``jax.tree.leaves``: dict keys sorted), so the
global norm sums in the same order.  The arithmetic is the reference's:
f32 moments, ``b ** count`` in f32, the clip before the moments, weight
decay on leaves with ``ndim >= 2`` (the reference's default mask; no
caller passes another).  One deliberate difference:
:func:`adamw_update` updates the params and the state in place under
``torch.no_grad()`` and returns them (the reference returns new trees),
so a full-width step holds one copy of each.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    schedule: Optional[Callable] = None  # step -> lr multiplier


def tree_leaves(tree) -> List:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """A tree shaped like ``template`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return next(it)
    return rec(template)


def _tree_map(fn, tree):
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def adamw_init(params):
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    device = tree_leaves(params)[0].device
    return {"mu": _tree_map(zeros, params), "nu": _tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return _tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig,
                 gnorm: Optional[torch.Tensor] = None):
    """Returns (params, state, metrics), params and state updated in
    place; metrics are ``grad_norm`` (before the clip) and ``lr``.
    ``gnorm``: the grads' global norm when the caller computes it (a
    tree whose leaves are blocks of sharded arrays)."""
    count = state["count"].add_(1)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm) \
        if cfg.clip_norm is not None else None
    lr = cfg.lr * (cfg.schedule(count) if cfg.schedule else 1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - b1 ** count.float()
    c2 = 1 - b2 ** count.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["mu"]), tree_leaves(state["nu"])):
        g = g.float() if scale is None else g * scale
        m.mul_(b1).add_((1 - b1) * g.float())
        v.mul_(b2).add_((1 - b2) * torch.square(g.float()))
        step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if cfg.weight_decay and p.ndim >= 2:
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
