"""Int8 gradient compression with error feedback for DP all-reduce: the
port of the reference's ``optim.compress``.

Scheme (1-bit-Adam / PowerSGD deployment style, adapted to int8): a ring
all-reduce is reduce_scatter + all_gather.  The reduce_scatter stays f32
(exact accumulation); the all_gather half of the traffic is sent as int8 +
per-shard f32 scale, so wire bytes drop from 2*N*4 to N*4 + N*1 = 0.625x.
The quantization residual is carried in an error-feedback buffer so the
long-run update is unbiased.  The f32 arithmetic is the reference's:
``scale = max(amax, 1e-12) / 127``, round half to even, clip to +-127.
A group is a ``torch.distributed`` process group (the reference's bound
axis name); ``group=None`` is its ``axis_name=None`` round trip.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..sharding.spmd import all_gather_into, reduce_scatter_into
from .adamw import tree_leaves, tree_unflatten


def int8_compress(x: torch.Tensor, err: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale f32 scalar, new_err)."""
    xf = x.float()
    if err is not None:
        xf = xf + err
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    # xf - q * scale rounded once, as the reference's compiled form (a
    # fused multiply-add) gives it: q * scale and the difference are
    # exact in f64
    new_err = (xf.double() - q.double() * scale.double()).float()
    return q, scale, new_err


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_allreduce(x: torch.Tensor, err: torch.Tensor, group):
    """Mean-all-reduce of ``x`` over the ranks of ``group`` with an int8
    all-gather.  Every rank of the group calls it.  With ``group=None``
    degrades to a quantize/dequantize round trip.  Returns (reduced,
    new_err) with ``reduced`` the same on every rank."""
    if group is None:
        q, scale, new_err = int8_compress(x, err)
        return int8_decompress(q, scale), new_err
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    shape = x.shape
    flat = x.float().reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    m = flat.shape[0] // n
    # exact f32 reduce_scatter: each rank owns 1/n of the summed gradient
    mine = torch.empty(m, dtype=torch.float32, device=x.device)
    reduce_scatter_into(mine, flat.contiguous(), group=group)
    mine = mine / n
    # quantize own shard (with persistent error feedback on the shard)
    err_flat = torch.nn.functional.pad(err.float().reshape(-1), (0, pad))
    my_err = err_flat[me * m:(me + 1) * m]
    q, scale, new_my_err = int8_compress(mine, my_err)
    # int8 all-gather (the compressed half of the ring)
    q_all = torch.empty(n * m, dtype=torch.int8, device=x.device)
    all_gather_into(q_all, q, group=group)
    s_all = torch.empty(n, dtype=torch.float32, device=x.device)
    all_gather_into(s_all, scale.reshape(1), group=group)
    full = (q_all.view(n, m).float() * s_all[:, None]).reshape(-1)
    # scatter the updated error shard back into the (replicated) buffer
    new_err_flat = torch.zeros_like(err_flat)
    new_err_flat[me * m:(me + 1) * m] = new_my_err
    dist.all_reduce(new_err_flat, group=group)
    if pad:
        full = full[:-pad]
        new_err_flat = new_err_flat[:-pad]
    return full.reshape(shape), new_err_flat.reshape(shape)


def compressed_psum_tree(grads, err_tree, group):
    """Apply compressed_allreduce leaf-wise over a gradient tree."""
    outs = [compressed_allreduce(g, e, group)
            for g, e in zip(tree_leaves(grads), tree_leaves(err_tree))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))
