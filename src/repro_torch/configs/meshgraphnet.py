"""meshgraphnet [arXiv:2010.03409]: 15 MP layers, d_hidden=128,
sum aggregator, 2-layer MLPs."""
from ..models.gnn import MGNConfig
from .base import ArchSpec, GNN_CELLS

FULL = MGNConfig(n_layers=15, d_hidden=128, mlp_layers=2, d_edge_in=4)
REDUCED = MGNConfig(n_layers=3, d_hidden=32, mlp_layers=2, d_node_in=8,
                    d_edge_in=4, d_out=3)

SPEC = ArchSpec(
    name="meshgraphnet", family="gnn", full=FULL, reduced=REDUCED,
    cells=dict(GNN_CELLS),
    notes="edge-featured MPNN; residual encode-process-decode",
)
