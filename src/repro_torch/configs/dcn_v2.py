"""dcn-v2 [arXiv:2008.13535]: 13 dense + 26 sparse fields, embed_dim=16,
3 cross layers, MLP 1024-1024-512."""
from ..models.recsys import DCNConfig
from .base import ArchSpec, RECSYS_CELLS

FULL = DCNConfig(n_dense=13, n_sparse=26, vocab=1_000_000, embed_dim=16,
                 n_cross=3, mlp_dims=(1024, 1024, 512))
REDUCED = DCNConfig(n_dense=13, n_sparse=26, vocab=1000, embed_dim=8,
                    n_cross=2, mlp_dims=(64, 32))

SPEC = ArchSpec(
    name="dcn-v2", family="recsys", full=FULL, reduced=REDUCED,
    cells=dict(RECSYS_CELLS),
    notes="EmbeddingBag = take + segment-masked sum; tables row-sharded "
          "over the model axis",
)
