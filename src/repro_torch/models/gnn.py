"""GNN substrate: message passing + GIN / MeshGraphNet / EGNN.

The port of the reference's ``models.gnn``: the same formulas, in torch.
Message passing is gather -> edge compute -> segment sum over an edge
index, as in the reference; the sums and the gathers' gradients go
through :mod:`.scatter`, which adds in a fixed order (two runs of a
step give the same bits on the card).  Each forward sorts the batch's
edges by ``dst`` once (:func:`.scatter.edge_index`) and takes the
per-edge inputs through that sort; the outputs are per node or per
graph, so only the order of each segment's additions differs from the
reference's.

Graphs arrive as fixed-shape padded batches:
  nodes  (N, d_feat)  float
  edges  (2, E) int (src, dst), padded with N-1 self loops + edge_mask
  edge_mask (E,) float {0,1}

Each forward takes the reference's sharding hook as ``shard`` (see
:mod:`.scatter`): ``None`` runs on the whole graph; a
:class:`repro_torch.sharding.spmd.Rows` runs on this rank's node and
edge blocks (edge ids global), gathering the node rows a layer reads and
reduce-scattering its sums.

One deliberate difference: EGNN's coordinate step divides by
``sqrt(max(d2, 1))`` where the reference has ``max(sqrt(d2), 1)``, the
same value, so that a zero-length edge (a self loop) gives a zero
gradient there instead of NaN.

Each message-passing layer runs under ``torch.utils.checkpoint``
(non-reentrant) when a gradient is being taken, as the reference
checkpoints each layer.  ``scan_layers`` (the reference's ``lax.scan``
over stacked blocks) is kept in the config; the port runs the same
blocks in a loop either way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .common import apply_mlp, init_mlp, layer_norm
from .scatter import (EdgeIndex, edge_index, full_rows, gather_rows,
                      num_rows, own_rows, propagate, segment_max,
                      segment_sum, segments, total)


def scatter_sum(messages, dst, num_nodes):
    return segment_sum(messages, segments(dst, num_nodes))


def scatter_mean(messages, dst, num_nodes):
    seg = segments(dst, num_nodes)
    c = seg.counts().to(messages.dtype).clamp_min(1.0)
    return segment_sum(messages, seg) / c.view(-1, *([1] * (
        messages.dim() - 1)))


def scatter_max(messages, dst, num_nodes):
    return segment_max(messages, segments(dst, num_nodes))


def _remat(fn, *args):
    """``fn(*args)``, checkpointed when a gradient is being taken."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _pool(h, graph_ids, n_graphs, shard=None):
    return total(segment_sum(h, segments(graph_ids, n_graphs)), shard)


def _index(edges, edge_mask, num_nodes, ei: Optional[EdgeIndex] = None):
    """(edge index, edge_mask in its edge order)."""
    if ei is None:
        ei = edge_index(torch.as_tensor(edges), num_nodes)
    return ei, edge_mask.index_select(0, ei.perm)


# ---------------------------------------------------------------------------
# GIN (arXiv:1810.00826): h' = MLP((1+eps) h + sum_j h_j)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GINConfig:
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 0            # input feature dim
    n_classes: int = 2
    graph_level: bool = False  # sum-pool readout over graph_ids


def init_gin(gen: torch.Generator, cfg: GINConfig, device):
    params = {"eps": torch.zeros((cfg.n_layers,), dtype=torch.float32,
                                 device=device), "layers": []}
    d_prev = cfg.d_in
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "mlp": init_mlp(gen, [d_prev, cfg.d_hidden, cfg.d_hidden],
                            device),
            "ln": {"scale": torch.ones((cfg.d_hidden,), device=device),
                   "bias": torch.zeros((cfg.d_hidden,), device=device)},
        })
        d_prev = cfg.d_hidden
    params["head"] = init_mlp(gen, [cfg.d_hidden, cfg.n_classes], device)
    return params


def gin_forward(params, nodes, edges, edge_mask, cfg: GINConfig,
                graph_ids=None, n_graphs: int = 1,
                ei: Optional[EdgeIndex] = None, shard=None):
    """``ei``: the edges' :func:`.scatter.edge_index`, when the caller
    holds it (built here otherwise)."""
    h = nodes
    ei, w = _index(edges, edge_mask, num_rows(h, shard), ei)

    def one_layer(h, layer, eps):
        agg = own_rows(propagate(full_rows(h, shard), w, ei), shard)
        h = (1.0 + eps) * h + agg
        h = apply_mlp(layer["mlp"], h, act="relu", final_act=True)
        return layer_norm(h, layer["ln"]["scale"], layer["ln"]["bias"])

    for i, layer in enumerate(params["layers"]):
        # remat per MP layer: full-batch graphs (60M+ edges) cannot keep
        # per-layer edge messages alive for the backward pass
        h = _remat(one_layer, h, layer, params["eps"][i])
    if cfg.graph_level:
        if graph_ids is None:
            raise ValueError("graph_level GIN needs graph_ids")
        return apply_mlp(params["head"], _pool(h, graph_ids, n_graphs,
                                               shard))
    return apply_mlp(params["head"], h)


# ---------------------------------------------------------------------------
# MeshGraphNet (arXiv:2010.03409): encode-process-decode, residual MP
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MGNConfig:
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 0
    d_edge_in: int = 0
    d_out: int = 3
    scan_layers: bool = False  # the reference's lax.scan; a loop here


def _mgn_mlp_dims(cfg: MGNConfig, d_in: int):
    return [d_in] + [cfg.d_hidden] * cfg.mlp_layers


def init_mgn(gen: torch.Generator, cfg: MGNConfig, device):
    params = {
        "node_enc": init_mlp(gen, _mgn_mlp_dims(cfg, cfg.d_node_in), device),
        "edge_enc": init_mlp(gen, _mgn_mlp_dims(cfg, cfg.d_edge_in), device),
        "decoder": init_mlp(gen, [cfg.d_hidden, cfg.d_hidden, cfg.d_out],
                            device),
        "blocks": [],
    }
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "edge": init_mlp(gen, _mgn_mlp_dims(cfg, 3 * cfg.d_hidden),
                             device),
            "node": init_mlp(gen, _mgn_mlp_dims(cfg, 2 * cfg.d_hidden),
                             device),
        })
    return params


def mgn_forward(params, nodes, edge_feats, edges, edge_mask, cfg: MGNConfig,
                shard=None):
    ei, w = _index(edges, edge_mask, num_rows(nodes, shard))
    w = w[:, None]
    h = apply_mlp(params["node_enc"], nodes, act="relu", final_act=True)
    e = apply_mlp(params["edge_enc"], edge_feats.index_select(0, ei.perm),
                  act="relu", final_act=True)

    def one_block(h, e, blk):
        hf = full_rows(h, shard)
        e_in = torch.cat([e, gather_rows(hf, ei.src, ei.by_src),
                          gather_rows(hf, ei.dst, ei.by_dst)], dim=-1)
        e = e + apply_mlp(blk["edge"], e_in, act="relu", final_act=True)
        agg = own_rows(segment_sum(e * w, ei.by_dst), shard)
        h = h + apply_mlp(blk["node"], torch.cat([h, agg], -1), act="relu",
                          final_act=True)
        return h, e

    for blk in params["blocks"]:
        h, e = _remat(one_block, h, e, blk)
    return apply_mlp(params["decoder"], h)


# ---------------------------------------------------------------------------
# EGNN (arXiv:2102.09844): E(n)-equivariant message passing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 0
    d_out: int = 1


def init_egnn(gen: torch.Generator, cfg: EGNNConfig, device):
    params = {"embed": init_mlp(gen, [cfg.d_in, cfg.d_hidden], device),
              "layers": []}
    d = cfg.d_hidden
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "phi_e": init_mlp(gen, [2 * d + 1, d, d], device),
            "phi_x": init_mlp(gen, [d, d, 1], device),
            "phi_h": init_mlp(gen, [2 * d, d, d], device),
        })
    params["head"] = init_mlp(gen, [d, cfg.d_out], device)
    return params


def egnn_forward(params, h0, x0, edges, edge_mask, cfg: EGNNConfig,
                 graph_ids=None, n_graphs: int = 1, shard=None):
    """h0: (N, d_in) invariant feats; x0: (N, 3) coordinates.

    Returns (out, x): invariant per-graph (or per-node) output + updated
    equivariant coordinates.
    """
    ei, w = _index(edges, edge_mask, num_rows(h0, shard))
    w = w[:, None]
    # scatter_mean's count: every edge of the segment, masked or not
    count = own_rows(ei.by_dst.counts().to(x0.dtype), shard) \
        .clamp_min(1.0)[:, None]
    h = apply_mlp(params["embed"], h0)
    x = x0

    def one_layer(h, x, layer):
        xf, hf = full_rows(x, shard), full_rows(h, shard)
        dx = gather_rows(xf, ei.src, ei.by_src) - gather_rows(xf, ei.dst,
                                                              ei.by_dst)
        d2 = torch.sum(dx * dx, dim=-1, keepdim=True)
        m_in = torch.cat([gather_rows(hf, ei.src, ei.by_src),
                          gather_rows(hf, ei.dst, ei.by_dst), d2], dim=-1)
        m = apply_mlp(layer["phi_e"], m_in, act="silu", final_act=True)
        m = m * w
        wx = apply_mlp(layer["phi_x"], m, act="silu")         # (E, 1)
        # sqrt(max(d2, 1)) is the reference's max(sqrt(d2), 1) to the bit;
        # the reference's form gives a zero-length edge (a self loop) a
        # NaN gradient (0 x the infinite slope of sqrt at 0) wherever x
        # carries one: from the second layer on, when a later layer reads x
        coef = wx / torch.sqrt(torch.clamp_min(d2, 1.0))
        x = x + own_rows(segment_sum(dx * coef * w, ei.by_dst), shard) / count
        agg = own_rows(segment_sum(m, ei.by_dst), shard)
        h = h + apply_mlp(layer["phi_h"], torch.cat([h, agg], -1),
                          act="silu", final_act=True)
        return h, x

    for layer in params["layers"]:
        h, x = _remat(one_layer, h, x, layer)
    if graph_ids is not None:
        return apply_mlp(params["head"], _pool(h, graph_ids, n_graphs,
                                               shard)), x
    return apply_mlp(params["head"], h), x

