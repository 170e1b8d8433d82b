"""Train a GIN whose node features are augmented with per-node k-clique
counts produced by the EBBkC operator -- the paper's technique feeding the
GNN substrate (higher-order structure as features, cf. paper Section 1's
motif applications).  The twin of ``examples/gnn_clique_features.py`` on
``repro_torch``.

    PYTHONPATH=src python examples/gnn_clique_features_torch.py --steps 200 [--device cpu]

The cliques are listed by ``ebbkc.list_cliques`` (the list kernel) and
the GIN trains on the CUDA device by default (raising without one);
``--device cpu`` runs both on the CPU.  Ends with the final accuracy,
which must exceed 0.9.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import ebbkc
from repro_torch.data import planted_cliques
from repro_torch.device import resolve_device
from repro_torch.launch.steps import one_hot_nll
from repro_torch.models import gnn
from repro_torch.models.scatter import edge_index
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               tree_leaves, tree_unflatten)


def clique_features(g, ks=(3, 4), **list_kw):
    """Per-node clique participation counts via the listing engine
    (``list_kw`` goes to ``ebbkc.list_cliques``)."""
    feats = np.zeros((g.n, len(ks)), np.float32)
    for j, k in enumerate(ks):
        cliques, _ = ebbkc.list_cliques(g, k, **list_kw)
        for row in cliques:
            feats[row, j] += 1.0
    return np.log1p(feats)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device, which "
                         "must exist; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # task: classify whether a node belongs to a planted clique
    g = planted_cliques(300, 6, 9, p_noise=0.02, seed=3)
    labels = np.zeros(g.n, np.int32)
    cliques, _ = ebbkc.list_cliques(g, 8, device=device)
    for row in cliques:
        labels[row] = 1
    deg = g.degrees().astype(np.float32)[:, None]
    cf = clique_features(g, device=device)
    feats = np.concatenate([deg / max(deg.max(), 1), cf], axis=1)
    edges = torch.as_tensor(
        np.concatenate([g.edges.T, g.edges.T[::-1]], 1).astype(np.int32),
        device=device)
    mask = torch.ones((edges.shape[1],), device=device)
    ei = edge_index(edges, g.n)

    cfg = gnn.GINConfig(n_layers=3, d_hidden=32, d_in=feats.shape[1],
                        n_classes=2)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = gnn.init_gin(gen, cfg, device)
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=3e-3, weight_decay=0.0)
    X = torch.as_tensor(feats, device=device)
    Y = torch.as_tensor(labels, device=device)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def accuracy():
        with torch.no_grad():
            logits = gnn.gin_forward(params, X, edges, mask, cfg, ei=ei)
        return float((torch.argmax(logits, -1) == Y).float().mean())

    for i in range(args.steps):
        loss = one_hot_nll(gnn.gin_forward(params, X, edges, mask, cfg,
                                           ei=ei), Y, 2)
        grads = torch.autograd.grad(loss, leaves)
        params, opt, _ = adamw_update(tree_unflatten(params, list(grads)),
                                      opt, params, ocfg)
        if i % 50 == 0 or i == args.steps - 1:
            acc = accuracy()
            print(f"step {i}: loss={float(loss.detach()):.4f} "
                  f"acc={acc:.3f}")
    acc = accuracy()
    print("final accuracy:", acc)
    if not acc > 0.9:
        raise SystemExit("clique features should make this easy")
    return {"acc": acc, "features": cf, "labels": labels, "graph": g}


if __name__ == "__main__":
    main()
