"""egnn [arXiv:2102.09844]: 4 layers, d_hidden=64, E(n)-equivariant."""
from ..models.gnn import EGNNConfig
from .base import ArchSpec, GNN_CELLS

FULL = EGNNConfig(n_layers=4, d_hidden=64)
REDUCED = EGNNConfig(n_layers=2, d_hidden=16, d_in=8, d_out=1)

SPEC = ArchSpec(
    name="egnn", family="gnn", full=FULL, reduced=REDUCED,
    cells=dict(GNN_CELLS),
    notes="cheap equivariant: scalar-distance messages + coordinate updates",
)
