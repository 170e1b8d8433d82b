"""Architecture config schema: every assigned arch is an ArchSpec with its
full (paper-exact) model config, a reduced smoke config, and its own
input-shape cells."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input shape) dry-run cell."""
    name: str
    kind: str                    # train | prefill | decode | serve | retrieval
    dims: Dict[str, int]
    skip: Optional[str] = None   # reason string if this cell is skipped


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                  # lm | gnn | recsys | clique
    full: Any                    # full model config (paper-exact numbers)
    reduced: Any                 # tiny config for CPU smoke tests
    cells: Dict[str, ShapeCell]
    notes: str = ""


LM_CELLS = {
    "train_4k": ShapeCell("train_4k", "train",
                          dims=dict(seq_len=4096, global_batch=256)),
    "prefill_32k": ShapeCell("prefill_32k", "prefill",
                             dims=dict(seq_len=32768, global_batch=32)),
    "decode_32k": ShapeCell("decode_32k", "decode",
                            dims=dict(seq_len=32768, global_batch=128)),
    "long_500k": ShapeCell("long_500k", "decode",
                           dims=dict(seq_len=524288, global_batch=1)),
}


def lm_cells(full_attention: bool) -> Dict[str, ShapeCell]:
    cells = dict(LM_CELLS)
    if full_attention:
        cells["long_500k"] = dataclasses.replace(
            cells["long_500k"],
            skip="pure full-attention arch: 500k decode state is linear "
                 "full-KV with no sub-quadratic path; skipped per "
                 "assignment (DESIGN.md section 4)")
    return cells


GNN_CELLS = {
    "full_graph_sm": ShapeCell(
        "full_graph_sm", "train",
        dims=dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7)),
    "minibatch_lg": ShapeCell(
        "minibatch_lg", "train",
        dims=dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                  fanout0=15, fanout1=10, d_feat=602, n_classes=41)),
    "ogb_products": ShapeCell(
        "ogb_products", "train",
        dims=dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
                  n_classes=47)),
    "molecule": ShapeCell(
        "molecule", "train",
        dims=dict(n_nodes=30, n_edges=64, batch=128, d_feat=16)),
}

RECSYS_CELLS = {
    "train_batch": ShapeCell("train_batch", "train",
                             dims=dict(batch=65536)),
    "serve_p99": ShapeCell("serve_p99", "serve", dims=dict(batch=512)),
    "serve_bulk": ShapeCell("serve_bulk", "serve", dims=dict(batch=262144)),
    "retrieval_cand": ShapeCell("retrieval_cand", "retrieval",
                                dims=dict(batch=1, n_candidates=1000000)),
}
