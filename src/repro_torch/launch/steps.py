"""The step functions of the reference's ``launch.steps``.

* LM (``lm_train_cell``): M microbatches, each one's loss and grads (f32,
  since the params are f32) accumulated in f32, the sum divided by M,
  then one AdamW update with ``AdamWConfig(lr=3e-4,
  schedule=cosine_schedule(100, 10000))``.
* GNN (``gnn_train_cell``): one step per arch (GIN, MeshGraphNet, EGNN,
  NequIP) on the cell's padded batch (``_gnn_batch_abs``), AdamW with
  ``AdamWConfig(lr=1e-3, weight_decay=0.0)``.
* recsys (``recsys_cell``): DCN-v2's train step (``AdamWConfig(lr=1e-3)``),
  its serving forward and its retrieval top-k.

Only the steps and the shapes they take: the reference's ``Cell``,
abstract values and shardings belong to its dry run and sharding
(ROADMAP A13e); without a mesh its sharding constraints (``_gnn_wsc``)
are the identity, so the port has none.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..configs.base import ArchSpec, ShapeCell
from ..models import equivariant as eqv
from ..models import gnn as gnn_mod
from ..models import recsys as rec
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


@dataclasses.dataclass
class ModelCell:
    """One (arch x shape) cell of the GNN or recsys families.

    ``step_fn``: ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` for a train cell, ``(params, dense, sparse)`` -> logits
    for a serve cell, ``(params, dense, sparse, cand)`` -> (values,
    indices) for a retrieval cell; numpy inputs go to the params'
    device.  ``init(gen, device)`` draws params; ``batch_shapes`` maps
    each input to its (shape, numpy dtype) in the reference's order."""
    step_fn: Callable
    cfg: Any
    init: Callable
    batch_shapes: Dict[str, Tuple[Tuple[int, ...], Any]]
    meta: Dict[str, Any]


def _init_of(init_fn, cfg):
    return lambda gen, device: init_fn(gen, cfg, device)


def _on(x, device):
    """A numpy array or tensor as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _train_step(loss_of, opt_cfg):
    """One AdamW step on ``loss_of(params, batch)``'s grads, the batch's
    arrays moved to the params' device."""
    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        device = leaves[0].device
        for p in leaves:
            p.requires_grad_(True)
        batch = {k: _on(v, device) for k, v in batch.items()}
        with torch.enable_grad():
            loss = loss_of(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a param the loss does not reach (EGNN's last coordinate MLP,
        # NequIP's last l > 0 weights) has a zero grad, as in jax.grad
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        params, opt_state, m = adamw_update(
            tree_unflatten(params, grads), opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss.detach(), **m}
    return step


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _pad_up(x: int, mult: int = 512) -> int:
    """Graph batches are padded to a multiple of the full mesh size (the
    data pipeline emits edge_mask/padded isolated nodes); production
    sharding requires divisibility."""
    return -(-x // mult) * mult


def _gnn_batch_abs(spec: ArchSpec, cell: ShapeCell, reduced: bool):
    d = dict(cell.dims)
    if "batch" in d:      # molecule: batched small graphs
        B = 4 if reduced else d["batch"]
        N = d["n_nodes"] * B
        E = d["n_edges"] * B
        n_graphs = B
    elif "batch_nodes" in d:   # sampled minibatch: union block graph
        bn = 64 if reduced else d["batch_nodes"]
        f0, f1 = d["fanout0"], d["fanout1"]
        N = bn + bn * f0 + bn * f0 * f1
        E = bn * f0 + bn * f0 * f1
        n_graphs = 1
    else:
        N = 128 if reduced else d["n_nodes"]
        E = 512 if reduced else d["n_edges"]
        n_graphs = 1
    if not reduced:
        N, E = _pad_up(N), _pad_up(E)
    d_feat = 8 if reduced else d.get("d_feat", 16)
    n_classes = d.get("n_classes", 2)
    return N, E, d_feat, n_classes, n_graphs


def one_hot_nll(logits, labels, n_classes: int):
    """The reference's ``-(one_hot(labels) * log_softmax(logits)).sum(-1)
    .mean()``: a label outside ``[0, n_classes)`` one-hots to a zero row,
    so its row adds 0 and still counts in the mean over all rows."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    valid = (labels >= 0) & (labels < n_classes)
    picked = logp.gather(-1, torch.where(valid, labels, 0)[:, None])[:, 0]
    return -(picked * valid).mean()


def gnn_train_cell(spec: ArchSpec, cell: ShapeCell,
                   reduced: bool = False) -> ModelCell:
    N, E, d_feat, n_classes, n_graphs = _gnn_batch_abs(spec, cell, reduced)
    base = spec.reduced if reduced else spec.full
    opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.0)
    name = spec.name
    f32, i32 = np.float32, np.int32
    graph = {"edges": ((2, E), i32), "edge_mask": ((E,), f32)}

    if name == "gin-tu":
        cfg = dataclasses.replace(base, d_in=d_feat, n_classes=n_classes,
                                  graph_level=False)
        init = _init_of(gnn_mod.init_gin, cfg)

        def loss_of(params, batch):
            logits = gnn_mod.gin_forward(params, batch["nodes"],
                                         batch["edges"], batch["edge_mask"],
                                         cfg)
            return one_hot_nll(logits, batch["labels"], cfg.n_classes)

        shapes = {"nodes": ((N, d_feat), f32), **graph,
                  "labels": ((N,), i32)}
    elif name == "meshgraphnet":
        d_edge = 4
        cfg = dataclasses.replace(base, d_node_in=d_feat, d_edge_in=d_edge,
                                  d_out=n_classes, scan_layers=not reduced)
        init = _init_of(gnn_mod.init_mgn, cfg)

        def loss_of(params, batch):
            out = gnn_mod.mgn_forward(params, batch["nodes"],
                                      batch["edge_feats"], batch["edges"],
                                      batch["edge_mask"], cfg)
            return torch.mean((out - batch["targets"]) ** 2)

        shapes = {"nodes": ((N, d_feat), f32),
                  "edge_feats": ((E, d_edge), f32), **graph,
                  "targets": ((N, n_classes), f32)}
    elif name == "egnn":
        cfg = dataclasses.replace(base, d_in=d_feat, d_out=1)
        init = _init_of(gnn_mod.init_egnn, cfg)

        def loss_of(params, batch):
            out, _ = gnn_mod.egnn_forward(
                params, batch["nodes"], batch["pos"], batch["edges"],
                batch["edge_mask"], cfg, batch["graph_ids"], n_graphs)
            return torch.mean((out[:, 0] - batch["energy"]) ** 2)

        shapes = {"nodes": ((N, d_feat), f32), "pos": ((N, 3), f32),
                  **graph, "graph_ids": ((N,), i32),
                  "energy": ((n_graphs,), f32)}
    elif name == "nequip":
        cfg = dataclasses.replace(base, scan_layers=not reduced)
        init = _init_of(eqv.init_nequip, cfg)

        def loss_of(params, batch):
            out = eqv.nequip_forward(
                params, batch["species"], batch["pos"], batch["edges"],
                batch["edge_mask"], cfg, batch["graph_ids"], n_graphs)
            return torch.mean((out[:, 0] - batch["energy"]) ** 2)

        shapes = {"species": ((N, cfg.n_species), f32),
                  "pos": ((N, 3), f32), **graph, "graph_ids": ((N,), i32),
                  "energy": ((n_graphs,), f32)}
    else:
        raise KeyError(name)

    return ModelCell(step_fn=_train_step(loss_of, opt_cfg), cfg=cfg,
                     init=init, batch_shapes=shapes,
                     meta={"n_nodes": N, "n_edges": E, "n_graphs": n_graphs})


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------

def recsys_cell(spec: ArchSpec, cell: ShapeCell,
                reduced: bool = False) -> ModelCell:
    cfg: rec.DCNConfig = spec.reduced if reduced else spec.full
    kind = cell.kind
    B = cell.dims.get("batch", 256)
    if reduced:
        B = min(B, 16)
    init = _init_of(rec.init_dcn, cfg)
    shapes = {"dense": ((B, cfg.n_dense), np.float32),
              "sparse": ((B, cfg.n_sparse, cfg.bag), np.int32)}
    meta = {"batch": B}

    if kind == "train":
        def loss_of(params, batch):
            logits = rec.dcn_forward(params, batch["dense"], batch["sparse"],
                                     cfg)
            return rec.bce_loss(logits, batch["labels"])

        shapes["labels"] = ((B,), np.float32)
        return ModelCell(_train_step(loss_of, AdamWConfig(lr=1e-3)), cfg,
                         init, shapes, meta)
    if kind == "serve":
        @torch.no_grad()
        def step(params, dense, sparse):
            device = params["table"].device
            return rec.dcn_forward(params, _on(dense, device),
                                   _on(sparse, device), cfg)

        return ModelCell(step, cfg, init, shapes, meta)
    if kind == "retrieval":
        n_cand = 4096 if reduced else cell.dims["n_candidates"]

        @torch.no_grad()
        def step(params, dense, sparse, cand):
            device = params["table"].device
            return rec.retrieval_scores(params, _on(dense, device),
                                        _on(sparse, device),
                                        _on(cand, device), cfg,
                                        topk=min(100, n_cand))

        shapes["cand"] = ((n_cand, cfg.mlp_dims[-1]), np.float32)
        return ModelCell(step, cfg, init, shapes,
                         {**meta, "n_candidates": n_cand})
    raise KeyError(kind)
