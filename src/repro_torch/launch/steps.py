"""Per-family step functions + abstract inputs + specs for every
(architecture x shape) cell: the port of the reference's
``launch.steps``.

* LM (``lm_train_cell``, ``lm_prefill_cell``, ``lm_decode_cell``): the
  gradient-accumulated train step (M microbatches, each one's loss and
  grads accumulated in f32, the sum divided by M, one AdamW update with
  ``AdamWConfig(lr=3e-4, schedule=cosine_schedule(100, 10000))``), the
  prefill and one decode step.
* GNN (``gnn_train_cell``): one step per arch (GIN, MeshGraphNet, EGNN,
  NequIP) on the cell's padded batch (``_gnn_batch_abs``), AdamW with
  ``AdamWConfig(lr=1e-3, weight_decay=0.0)``.
* recsys (``recsys_cell``): DCN-v2's train step (``AdamWConfig(lr=1e-3)``),
  its serving forward and its retrieval top-k.
* clique (``clique_cell``): ``count_packed`` over a batch of tiles, the
  paper's edge-parallel scheme (Section 6.2(7)).

A :class:`Cell` holds the step, its abstract arguments (``meta``-device
tensors, the counterpart of ``ShapeDtypeStruct``) and the partition
specs of its inputs and outputs (:class:`repro_torch.sharding.P` trees
filtered to the mesh; ``None`` without one).  With a mesh (a
``DeviceMesh`` from :mod:`.mesh`) the step runs SPMD: every rank calls
it on its own blocks of the inputs (``sharding.spmd.shard_tree`` by
``in_specs``) and gets its blocks of the outputs.

* clique: tiles sharded over every mesh axis; each rank counts its block
  and the f32 total is summed over all axes.
* GNN: node and edge arrays sharded over every axis, params replicated;
  each layer gathers the node rows its edges read and reduce-scatters
  its sums (the models' ``shard`` hook).  Each rank's loss is its share
  (the mean of its rows, or of the replicated graph rows, over the
  number of blocks); the params' grads are summed over all axes before
  AdamW, so every rank's params stay equal.
* recsys: table rows over ``model``, the batch over the data axes,
  candidates over ``model``; grads summed over the data axes.
* LM: the params stored by ``transformer_param_specs`` (FSDP over
  ``data``, Megatron tensor parallelism and the experts over ``model``),
  the batch over the data axes, the KV cache by the reference's cache
  specs (the GQA fallback splits its length over ``model``; a decode of
  one sequence, ``long_500k``, splits it over the data axes); the model
  calls the collectives through its :class:`~repro_torch.models.
  transformer.ShardCtx`.  The train step's microbatch m is the global
  batch's rows ``m B / M .. (m + 1) B / M - 1``, each data rank holding
  its slice of it, its loss the mean over that microbatch's unmasked
  tokens; grads are then summed over the axes a param is replicated on
  where each rank holds a part (``_lm_grad_axes``), the norm taken over
  the blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchSpec, ShapeCell
from ..device import resolve_device
from ..models import equivariant as eqv
from ..models import gnn as gnn_mod
from ..models import recsys as rec
from ..models import transformer as tr
from ..optim import (AdamWConfig, adamw_init, adamw_update, cosine_schedule,
                     tree_leaves, tree_unflatten)
from ..sharding import spmd
from ..sharding.rules import (P, transformer_cache_specs,
                              transformer_layer_specs,
                              transformer_param_specs, tree_specs)


@dataclasses.dataclass
class Cell:
    """Everything needed to run one (arch x shape) cell.

    ``step_fn`` takes the arguments ``abstract_args`` describes (numpy
    inputs go to the params' device, or to ``device`` for the clique
    cell).  A model cell also carries its config ``cfg``, ``init(gen,
    device)`` drawing its params, and ``grads_fn(params, batch) -> (loss,
    grads)`` for a train cell (the loss summed and the grads all-reduced
    over the mesh); ``batch_shapes`` maps each batch input to its
    (global shape, numpy dtype) in the reference's order; an LM train
    cell gives its ``batch``, ``seq_len`` and ``microbatches``."""
    step_fn: Callable
    abstract_args: Tuple
    in_specs: Any
    out_specs: Any
    meta: Dict[str, Any]
    cfg: Any = None
    init: Optional[Callable] = None
    grads_fn: Optional[Callable] = None
    batch_shapes: Optional[Dict[str, Tuple[Tuple[int, ...], Any]]] = None
    device: Optional[torch.device] = None
    batch: Optional[int] = None
    seq_len: Optional[int] = None
    microbatches: Optional[int] = None


DATA_AXES = ("pod", "data")
ALL_AXES = ("pod", "data", "model")


def _opt_specs(param_specs):
    return {"mu": param_specs, "nu": param_specs, "count": P()}


def _specs(mesh, tree):
    return None if mesh is None else tree_specs(mesh, tree)


def _model_size(mesh) -> int:
    if mesh is None or "model" not in spmd.axis_names(mesh):
        return 1
    return int(spmd.mesh_sizes(mesh)["model"])


def _abstract(shapes: Dict[str, Tuple[Tuple[int, ...], Any]]):
    """``meta`` tensors of the (shape, numpy dtype) of each input."""
    return {k: torch.empty(s, dtype=torch.from_numpy(np.empty(0, d)).dtype,
                           device="meta")
            for k, (s, d) in shapes.items()}


def _init_of(init_fn, cfg):
    return lambda gen, device: init_fn(gen, cfg, device)


def _on(x, device):
    """A numpy array or tensor as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def lm_ctx(mesh, cfg, cache_len_axes=()) -> tr.ShardCtx:
    """The transformer's :class:`ShardCtx` on ``mesh`` (the reference's
    ``_lm_ctx``): the data axes it has, the layer and param specs for its
    model size, filtered to it, and the axes the KV cache's length is
    split over."""
    if mesh is None:
        return tr.ShardCtx()
    m = _model_size(mesh)
    return tr.ShardCtx(
        mesh=mesh, data_axes=spmd.present(DATA_AXES, mesh),
        model_axis="model",
        layer_specs=tree_specs(mesh, transformer_layer_specs(cfg, m)),
        param_specs=tree_specs(mesh, transformer_param_specs(
            cfg, model_size=m)),
        cache_len_axes=spmd.present(cache_len_axes, mesh))


def _lm_grad_axes(ctx: tr.ShardCtx) -> Dict[str, Tuple[str, ...]]:
    """For each param leaf (``tree_leaves`` order, by path), the mesh
    axes its grad is summed over after the backward pass:

    * the data axes its storage spec lacks (``embed`` and ``head``
      everywhere; ``pod`` for the FSDP leaves, whose gather's backward
      sums over ``data`` alone);
    * ``model`` for the replicated params whose grads each model rank
      holds in part: the router (each rank's experts) and, under sharded
      q heads, replicated kv weights (each rank's q heads)."""
    out = {}
    partial = {"router"}
    if ctx.layer_specs["wq"][1] is not None \
            and ctx.layer_specs["wk"][1] is None:
        partial |= {"wk", "wv"}
    model = spmd.present(("model",), ctx.mesh)

    def visit(path, spec):
        have = {a for part in spec for a in spmd.part_axes(part)}
        axes = [a for a in ctx.data_axes if a not in have]
        if path[-1] in partial and len(path) == 3:
            axes += list(model)
        out[path] = tuple(a for a in spmd.axis_names(ctx.mesh) if a in axes)

    def walk(path, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk((*path, k), node[k])
        else:
            visit(path, node)
    walk((), ctx.param_specs)
    return out


def _microbatches(B: int, M: int, mesh) -> int:
    """M, or on a mesh the largest divisor of it whose microbatch still
    splits over the data axes."""
    n = spmd.axis_size(mesh, DATA_AXES)
    while M > 1 and (B % M or (B // M) % n):
        M -= 1
    return M


def loss_and_grads(params, batch, cfg: tr.TransformerConfig,
                   microbatches: int, ctx: tr.ShardCtx = tr.ShardCtx()
                   ) -> Tuple[torch.Tensor, Dict]:
    """Mean loss and grads over ``microbatches`` equal slices of
    ``batch`` (``tokens``/``labels``, numpy or tensors, (B, S)), the
    grads summed in f32 in microbatch order and divided by M, as the
    reference's scan does.  The batch goes to the params' device; the
    param leaves are made to require grad.

    On a mesh (``ctx``) ``params`` and ``batch`` are this rank's blocks:
    with M > 1 the batch is gathered over the data axes and the rank
    takes its slice of each global microbatch; the loss is the global
    one, and each grad is summed over :func:`_lm_grad_axes`."""
    leaves = tree_leaves(params)
    device = leaves[0].device
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: _on(v, device) for k, v in batch.items()}
    M = microbatches
    data = spmd.present(ctx.data_axes, ctx.mesh)
    if M > 1 and spmd.axis_size(ctx.mesh, data) > 1:
        i, n = spmd.block_index(ctx.mesh, data)
        whole = {k: spmd.unshard(v, P(data, None), ctx.mesh)
                 for k, v in batch.items()}
        b = whole["tokens"].shape[0] // M
        r = b // n
        batch = {k: v.reshape(M, b, -1)[:, i * r:(i + 1) * r].reshape(
            M * r, -1) for k, v in whole.items()}
    b = batch["tokens"].shape[0] // M
    grads, loss_sum = None, torch.zeros((), device=device)
    for m in range(M):
        mb = {k: v[m * b:(m + 1) * b] for k, v in batch.items()}
        with torch.enable_grad():
            loss = tr.loss_fn(params, mb, cfg, ctx)
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
    if ctx.mesh is not None:
        by_axes: Dict[Tuple[str, ...], list] = {}
        for g, axes in zip(grads, _lm_grad_axes(ctx).values()):
            by_axes.setdefault(axes, []).append(g)
        for axes, gs in by_axes.items():
            spmd.all_reduce_grads(gs, axes, ctx.mesh)
    return loss_sum / M, tree_unflatten(params, grads)


def _lm_params_abs(cfg):
    return tr.init_params(torch.Generator(), cfg, "meta")


def _lm_meta(cfg, tokens: int) -> Dict[str, Any]:
    return {"tokens_per_step": tokens, "model_params": cfg.num_params(),
            "active_params": cfg.active_params()}


def lm_train_cell(spec: ArchSpec, cell: ShapeCell, mesh=None,
                  reduced: bool = False, microbatches: int = 16) -> Cell:
    """The gradient-accumulated train step of ``cell`` (a train shape of
    ``spec``).  ``reduced`` takes the arch's smoke config at B, S = 2,
    min(S, 64) and one microbatch, as the reference; M falls back to 1
    when it does not divide B, and on a mesh to the largest divisor whose
    microbatch splits over the data axes (the multi-pod mesh's 32 data
    blocks take 256 rows in 8)."""
    cfg: tr.TransformerConfig = spec.reduced if reduced else spec.full
    B, S = cell.dims["global_batch"], cell.dims["seq_len"]
    if reduced:
        B, S = 2, min(S, 64)
        microbatches = 1
    M = microbatches if B % microbatches == 0 else 1
    M = _microbatches(B, M, mesh)
    opt_cfg = AdamWConfig(lr=3e-4, schedule=cosine_schedule(100, 10000))
    ctx = lm_ctx(mesh, cfg)

    def grads_fn(params, batch):
        return loss_and_grads(params, batch, cfg, M, ctx)

    params_abs = _lm_params_abs(cfg)
    pspec = None if mesh is None else ctx.param_specs
    shapes = {"tokens": ((B, S), np.int32), "labels": ((B, S), np.int32)}
    bspec = {"tokens": P(DATA_AXES, None), "labels": P(DATA_AXES, None)}
    mspec = {"loss": P(), "grad_norm": P(), "lr": P()}
    return Cell(step_fn=_train_step(grads_fn, opt_cfg, pspec, mesh),
                abstract_args=(params_abs, adamw_init(params_abs),
                               _abstract(shapes)),
                in_specs=_specs(mesh, (pspec, _opt_specs(pspec), bspec)),
                out_specs=_specs(mesh, (pspec, _opt_specs(pspec), mspec)),
                meta=_lm_meta(cfg, B * S),
                cfg=cfg, init=_init_of(tr.init_params, cfg),
                grads_fn=grads_fn, batch_shapes=shapes, batch=B, seq_len=S,
                microbatches=M)


def lm_prefill_cell(spec: ArchSpec, cell: ShapeCell, mesh=None,
                    reduced: bool = False) -> Cell:
    """The prefill of ``cell``'s (B, S) prompts into an S-long cache:
    (last-position f32 logits, cache); on a mesh the logits' block
    ``P(data, "model")`` and the cache's by ``transformer_cache_specs``."""
    cfg = spec.reduced if reduced else spec.full
    B, S = cell.dims["global_batch"], cell.dims["seq_len"]
    if reduced:
        B, S = 2, min(S, 64)
    m = _model_size(mesh)
    cspec = transformer_cache_specs(cfg, model_size=m)
    ctx = lm_ctx(mesh, cfg, () if cfg.n_kv_heads % m == 0 else ("model",))

    @torch.no_grad()
    def step(params, tokens):
        return tr.prefill(params, _on(tokens, params["embed"].device), cfg,
                          max_len=S, ctx=ctx)

    shapes = {"tokens": ((B, S), np.int32)}
    pspec = None if mesh is None else ctx.param_specs
    return Cell(step_fn=step,
                abstract_args=(_lm_params_abs(cfg),
                               _abstract(shapes)["tokens"]),
                in_specs=_specs(mesh, (pspec, P(DATA_AXES, None))),
                out_specs=_specs(mesh, (P(DATA_AXES, "model"), cspec)),
                meta=_lm_meta(cfg, B * S), cfg=cfg,
                init=_init_of(tr.init_params, cfg), batch_shapes=shapes)


def lm_decode_cell(spec: ArchSpec, cell: ShapeCell, mesh=None,
                   reduced: bool = False) -> Cell:
    """One decode step of ``cell``'s B sequences against an S-long cache
    (updated in place): (f32 logits, cache).  ``B == 1`` is the
    reference's ``long_ctx`` case, whose cache length it shards over the
    data axes; otherwise the batch is, and the kv heads over ``model``
    where they divide, else the cache length (the GQA fallback)."""
    cfg = spec.reduced if reduced else spec.full
    B, S = cell.dims["global_batch"], cell.dims["seq_len"]
    if reduced:
        B, S = 2, min(S, 64)
    long_ctx = B == 1  # long_500k: shard the KV length, not the batch
    kv_shardable = cfg.n_kv_heads % max(_model_size(mesh), 1) == 0
    if long_ctx:
        kv = P(None, None, DATA_AXES, "model" if kv_shardable else None,
               None)
        tspec, lspec, ologit = P(None, None), P(None), P(None, "model")
        len_axes = DATA_AXES
    else:
        # GQA with kv < TP: shard the cache *length* over the model axis
        # instead (a replicated 32k cache is 100+ GB a device)
        kv = P(None, DATA_AXES, None, "model", None) if kv_shardable \
            else P(None, DATA_AXES, "model", None, None)
        tspec, lspec = P(DATA_AXES, None), P(DATA_AXES)
        ologit = P(DATA_AXES, "model")
        len_axes = () if kv_shardable else ("model",)
    cspec = {kind: {"k": kv, "v": kv} for kind, _ in cfg.layer_groups}
    ctx = lm_ctx(mesh, cfg, len_axes)

    @torch.no_grad()
    def step(params, cache, tokens, lengths):
        device = params["embed"].device
        return tr.decode_step(params, cache, _on(tokens, device),
                              _on(lengths, device).long(), cfg, ctx)

    shapes = {"tokens": ((B, 1), np.int32), "lengths": ((B,), np.int32)}
    ab = _abstract(shapes)
    meta = {"tokens_per_step": B, "kv_cache_tokens": S,
            "model_params": cfg.num_params(),
            "active_params": cfg.active_params()}
    pspec = None if mesh is None else ctx.param_specs
    return Cell(step_fn=step,
                abstract_args=(_lm_params_abs(cfg),
                               tr.init_cache(cfg, B, S, "meta"),
                               ab["tokens"], ab["lengths"]),
                in_specs=_specs(mesh, (pspec, cspec, tspec, lspec)),
                out_specs=_specs(mesh, (ologit, cspec)), meta=meta, cfg=cfg,
                init=_init_of(tr.init_params, cfg), batch_shapes=shapes)


# ---------------------------------------------------------------------------
# the train step of the GNN and recsys families
# ---------------------------------------------------------------------------

def _grads_fn(loss_of, mesh=None, loss_axes=(), grad_axes=()):
    """``(params, batch) -> (loss, grads)`` of ``loss_of``, the batch's
    arrays moved to the params' device.  On a mesh ``loss_of`` gives the
    rank's share: the loss is summed over ``loss_axes`` and the grads
    over ``grad_axes``."""
    def grads_fn(params, batch):
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
        spmd.all_reduce_grads(grads, grad_axes, mesh)
        return (spmd.psum(loss.detach(), loss_axes, mesh),
                tree_unflatten(params, grads))
    return grads_fn


def _global_norm(grads, pspec, mesh) -> torch.Tensor:
    """The global norm of a tree of blocks: each leaf's sum of squares
    summed over the axes its spec shards it on (tree order, as
    ``global_norm``)."""
    names = spmd.axis_names(mesh)
    sq = [spmd.psum(torch.sum(torch.square(g.float())),
                    sorted((a for part in s or () for a in
                            spmd.part_axes(part)), key=names.index), mesh)
          for g, s in zip(tree_leaves(grads), spmd.spec_leaves(pspec))]
    return torch.sqrt(sum(sq))


def _train_step(grads_fn, opt_cfg, pspec=None, mesh=None):
    """One AdamW step on ``grads_fn``'s grads (on a mesh, their norm
    over the blocks of ``pspec``)."""
    def step(params, opt_state, batch):
        loss, grads = grads_fn(params, batch)
        gnorm = None if mesh is None else _global_norm(grads, pspec, mesh)
        params, opt_state, m = adamw_update(grads, opt_state, params,
                                            opt_cfg, gnorm)
        return params, opt_state, {"loss": loss, **m}
    return step


def _train_cell(loss_of, opt_cfg, init, cfg, shapes, bspec, pspec, mesh,
                meta, loss_axes, grad_axes) -> Cell:
    params_abs = init(torch.Generator(), "meta")
    if pspec is None:
        pspec = tree_unflatten(params_abs,
                               [P() for _ in tree_leaves(params_abs)])
    grads_fn = _grads_fn(loss_of, mesh, loss_axes, grad_axes)
    mspec = {"loss": P(), "grad_norm": P(), "lr": P()}
    return Cell(step_fn=_train_step(grads_fn, opt_cfg, pspec, mesh),
                abstract_args=(params_abs, adamw_init(params_abs),
                               _abstract(shapes)),
                in_specs=_specs(mesh, (pspec, _opt_specs(pspec), bspec)),
                out_specs=_specs(mesh, (pspec, _opt_specs(pspec), mspec)),
                meta=meta, cfg=cfg, init=init, grads_fn=grads_fn,
                batch_shapes=shapes)


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


def _gnn_shard(mesh) -> Optional[spmd.Rows]:
    """The GNN models' sharding hook: node and edge rows in blocks over
    every mesh axis (the reference's ``_gnn_wsc``); ``None`` without a
    mesh."""
    if mesh is None:
        return None
    return spmd.Rows(mesh, spmd.present(ALL_AXES, mesh))


def one_hot_nll(logits, labels, n_classes: int):
    """The reference's ``-(one_hot(labels) * log_softmax(logits)).sum(-1)
    .mean()``: a label outside ``[0, n_classes)`` one-hots to a zero row,
    so its row adds 0 and still counts in the mean over all rows."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    valid = (labels >= 0) & (labels < n_classes)
    picked = logp.gather(-1, torch.where(valid, labels, 0)[:, None])[:, 0]
    return -(picked * valid).mean()


def gnn_train_cell(spec: ArchSpec, cell: ShapeCell, mesh=None,
                   reduced: bool = False) -> Cell:
    N, E, d_feat, n_classes, n_graphs = _gnn_batch_abs(spec, cell, reduced)
    base = spec.reduced if reduced else spec.full
    opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.0)
    name = spec.name
    shard = _gnn_shard(mesh)
    axes = spmd.present(ALL_AXES, mesh)
    # each rank's loss is the mean over its rows (or over the replicated
    # graph rows) divided by the number of blocks: the ranks' shares sum
    # to the mean over all rows
    n = spmd.axis_size(mesh, axes)
    f32, i32 = np.float32, np.int32
    graph = {"edges": ((2, E), i32), "edge_mask": ((E,), f32)}
    nodes, edges = P(ALL_AXES, None), P(None, ALL_AXES)
    gspec = {"edges": edges, "edge_mask": P(ALL_AXES)}

    if name == "gin-tu":
        cfg = dataclasses.replace(base, d_in=d_feat, n_classes=n_classes,
                                  graph_level=False)
        init = _init_of(gnn_mod.init_gin, cfg)

        def loss_of(params, batch):
            logits = gnn_mod.gin_forward(params, batch["nodes"],
                                         batch["edges"], batch["edge_mask"],
                                         cfg, shard=shard)
            return one_hot_nll(logits, batch["labels"], cfg.n_classes)

        shapes = {"nodes": ((N, d_feat), f32), **graph,
                  "labels": ((N,), i32)}
        bspec = {"nodes": nodes, **gspec, "labels": P(ALL_AXES)}
    elif name == "meshgraphnet":
        d_edge = 4
        cfg = dataclasses.replace(base, d_node_in=d_feat, d_edge_in=d_edge,
                                  d_out=n_classes, scan_layers=not reduced)
        init = _init_of(gnn_mod.init_mgn, cfg)

        def loss_of(params, batch):
            out = gnn_mod.mgn_forward(params, batch["nodes"],
                                      batch["edge_feats"], batch["edges"],
                                      batch["edge_mask"], cfg, shard=shard)
            return torch.mean((out - batch["targets"]) ** 2)

        shapes = {"nodes": ((N, d_feat), f32),
                  "edge_feats": ((E, d_edge), f32), **graph,
                  "targets": ((N, n_classes), f32)}
        bspec = {"nodes": nodes, "edge_feats": P(ALL_AXES, None), **gspec,
                 "targets": P(ALL_AXES, None)}
    elif name == "egnn":
        cfg = dataclasses.replace(base, d_in=d_feat, d_out=1)
        init = _init_of(gnn_mod.init_egnn, cfg)

        def loss_of(params, batch):
            out, _ = gnn_mod.egnn_forward(
                params, batch["nodes"], batch["pos"], batch["edges"],
                batch["edge_mask"], cfg, batch["graph_ids"], n_graphs,
                shard=shard)
            return torch.mean((out[:, 0] - batch["energy"]) ** 2)

        shapes = {"nodes": ((N, d_feat), f32), "pos": ((N, 3), f32),
                  **graph, "graph_ids": ((N,), i32),
                  "energy": ((n_graphs,), f32)}
        bspec = {"nodes": nodes, "pos": P(ALL_AXES, None), **gspec,
                 "graph_ids": P(ALL_AXES), "energy": P(None)}
    elif name == "nequip":
        cfg = dataclasses.replace(base, scan_layers=not reduced)
        init = _init_of(eqv.init_nequip, cfg)

        def loss_of(params, batch):
            out = eqv.nequip_forward(
                params, batch["species"], batch["pos"], batch["edges"],
                batch["edge_mask"], cfg, batch["graph_ids"], n_graphs,
                shard=shard)
            return torch.mean((out[:, 0] - batch["energy"]) ** 2)

        shapes = {"species": ((N, cfg.n_species), f32),
                  "pos": ((N, 3), f32), **graph, "graph_ids": ((N,), i32),
                  "energy": ((n_graphs,), f32)}
        bspec = {"species": nodes, "pos": P(ALL_AXES, None), **gspec,
                 "graph_ids": P(ALL_AXES), "energy": P(None)}
    else:
        raise KeyError(name)

    share = loss_of if n == 1 else (lambda p, b: loss_of(p, b) / n)
    return _train_cell(share, opt_cfg, init, cfg, shapes, bspec, None, mesh,
                       {"n_nodes": N, "n_edges": E, "n_graphs": n_graphs},
                       axes, axes)


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------

def recsys_cell(spec: ArchSpec, cell: ShapeCell, mesh=None,
                reduced: bool = False) -> Cell:
    cfg: rec.DCNConfig = spec.reduced if reduced else spec.full
    kind = cell.kind
    B = cell.dims.get("batch", 256)
    if reduced:
        B = min(B, 16)
    init = _init_of(rec.init_dcn, cfg)
    params_abs = init(torch.Generator(), "meta")
    pspec = tree_unflatten(params_abs,
                           [P() for _ in tree_leaves(params_abs)])
    pspec["table"] = P("model", None)
    shapes = {"dense": ((B, cfg.n_dense), np.float32),
              "sparse": ((B, cfg.n_sparse, cfg.bag), np.int32)}
    bspec_d, bspec_s = P(DATA_AXES, None), P(DATA_AXES, None, None)
    model = spmd.present(("model",), mesh)
    data = spmd.present(DATA_AXES, mesh)
    rows = spmd.Rows(mesh, model) if model else None
    meta = {"batch": B}

    if kind == "train":
        n_data = spmd.axis_size(mesh, data)

        def loss_of(params, batch):
            logits = rec.dcn_forward(params, batch["dense"], batch["sparse"],
                                     cfg, shard=rows)
            loss = rec.bce_loss(logits, batch["labels"])
            return loss if n_data == 1 else loss / n_data

        shapes["labels"] = ((B,), np.float32)
        bspec = {"dense": bspec_d, "sparse": bspec_s, "labels": P(DATA_AXES)}
        return _train_cell(loss_of, AdamWConfig(lr=1e-3), init, cfg, shapes,
                           bspec, pspec, mesh, meta, data, data)
    ab = _abstract(shapes)
    if kind == "serve":
        @torch.no_grad()
        def step(params, dense, sparse):
            device = params["table"].device
            return rec.dcn_forward(params, _on(dense, device),
                                   _on(sparse, device), cfg, shard=rows)

        return Cell(step, (params_abs, ab["dense"], ab["sparse"]),
                    _specs(mesh, (pspec, bspec_d, bspec_s)),
                    _specs(mesh, P(DATA_AXES)), meta, cfg=cfg, init=init,
                    batch_shapes=shapes)
    if kind == "retrieval":
        n_cand = 4096 if reduced else cell.dims["n_candidates"]

        @torch.no_grad()
        def step(params, dense, sparse, cand):
            device = params["table"].device
            return rec.retrieval_scores(params, _on(dense, device),
                                        _on(sparse, device),
                                        _on(cand, device), cfg,
                                        topk=min(100, n_cand), shard=rows,
                                        cand_shard=rows)

        shapes["cand"] = ((n_cand, cfg.mlp_dims[-1]), np.float32)
        ospec = (P(None, None), P(None, None))
        return Cell(step, (params_abs, ab["dense"], ab["sparse"],
                           _abstract(shapes)["cand"]),
                    _specs(mesh, (pspec, P(None, None), P(None, None, None),
                                  P("model", None))),
                    _specs(mesh, ospec), {**meta, "n_candidates": n_cand},
                    cfg=cfg, init=init, batch_shapes=shapes)
    raise KeyError(kind)


# ---------------------------------------------------------------------------
# clique-engine cells (the paper's own arch)
# ---------------------------------------------------------------------------

def _words(x, device) -> torch.Tensor:
    """Packed words (uint32 numpy, or an int32 tensor) as the int32 word
    view on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.ascontiguousarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32
                            else x).to(device)


def clique_cell(spec: ArchSpec, cell: ShapeCell, mesh=None,
                reduced: bool = False, device=None) -> Cell:
    """``count_packed`` over a (B, T, W) batch of tiles and its (B, W)
    candidate words: (f32 total of the per-tile counts, nv, t, f).  On a
    mesh the tiles are split over every axis, each rank counts its
    block (the triangle kernel at l = 3 on the card) and the total is
    summed over all axes; ``nv``, ``t``, ``f`` stay sharded."""
    from ..core import engine_torch
    d = dict(cell.dims)
    B = 256 if reduced else d["n_tiles"]
    T = 32 if reduced else d["T"]
    l = d["l"]
    W = T // 32
    method = "mxu" if l == 3 else "ref"
    axes = spmd.present(ALL_AXES, mesh)
    dev = resolve_device(device if device is not None or mesh is None
                         else mesh.device_type)

    def step(A, cand):
        hard, nv, t, f = engine_torch.count_packed(
            _words(A, dev), _words(cand, dev), l, method=method, et=True)
        total = spmd.psum(hard.float().sum(), axes, mesh)
        return total, nv, t, f

    shapes = {"A": ((B, T, W), np.int32), "cand": ((B, W), np.int32)}
    ab = _abstract(shapes)
    ts, cs = P(ALL_AXES, None, None), P(ALL_AXES, None)
    return Cell(step_fn=step, abstract_args=(ab["A"], ab["cand"]),
                in_specs=_specs(mesh, (ts, cs)),
                out_specs=_specs(mesh, (P(), P(ALL_AXES), P(ALL_AXES),
                                        P(ALL_AXES))),
                meta={"n_tiles": B, "T": T, "l": l, "method": method},
                batch_shapes=shapes, device=dev)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def build_cell(spec: ArchSpec, shape_name: str, mesh=None,
               reduced: bool = False, device=None) -> Cell:
    """The cell ``shape_name`` of ``spec``.  ``device``: where the cell
    runs (the CUDA device by default, raising without one; a mesh's own
    device type with a mesh)."""
    cell = spec.cells[shape_name]
    if cell.skip:
        raise ValueError(f"cell {spec.name}/{shape_name} is skipped: "
                         f"{cell.skip}")
    dev = resolve_device(device if device is not None or mesh is None
                         else mesh.device_type)
    if spec.family == "clique":
        return clique_cell(spec, cell, mesh, reduced, dev)
    if spec.family == "lm":
        if cell.kind == "train":
            out = lm_train_cell(spec, cell, mesh, reduced)
        elif cell.kind == "prefill":
            out = lm_prefill_cell(spec, cell, mesh, reduced)
        elif cell.kind == "decode":
            out = lm_decode_cell(spec, cell, mesh, reduced)
        else:
            raise KeyError((spec.family, cell.kind))
    elif spec.family == "gnn":
        out = gnn_train_cell(spec, cell, mesh, reduced)
    elif spec.family == "recsys":
        out = recsys_cell(spec, cell, mesh, reduced)
    else:
        raise KeyError((spec.family, cell.kind))
    out.device = dev
    return out
