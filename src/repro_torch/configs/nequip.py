"""nequip [arXiv:2101.03164]: 5 layers, mult=32, l_max=2, n_rbf=8,
cutoff=5, E(3)-equivariant tensor products."""
from ..models.equivariant import NequIPConfig
from .base import ArchSpec, GNN_CELLS

FULL = NequIPConfig(n_layers=5, mult=32, l_max=2, n_rbf=8, cutoff=5.0,
                    n_species=16)
REDUCED = NequIPConfig(n_layers=2, mult=8, l_max=2, n_rbf=4, cutoff=2.5,
                       n_species=4)

SPEC = ArchSpec(
    name="nequip", family="gnn", full=FULL, reduced=REDUCED,
    cells=dict(GNN_CELLS),
    notes="irrep tensor-product regime; real-Gaunt CG paths, features are "
          "positions + species (the modality frontend of citation-graph "
          "shapes is a stub per the assignment)",
)
