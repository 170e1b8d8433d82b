"""gin-tu [arXiv:1810.00826]: 5 layers, d_hidden=64, sum aggregator,
learnable eps."""
from ..models.gnn import GINConfig
from .base import ArchSpec, GNN_CELLS

FULL = GINConfig(n_layers=5, d_hidden=64)
REDUCED = GINConfig(n_layers=2, d_hidden=16, d_in=8, n_classes=3)

SPEC = ArchSpec(
    name="gin-tu", family="gnn", full=FULL, reduced=REDUCED,
    cells=dict(GNN_CELLS),
    notes="SpMM regime (sum aggregation via segment_sum)",
)
