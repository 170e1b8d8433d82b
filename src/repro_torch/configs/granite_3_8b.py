"""granite-3-8b [hf:ibm-granite/granite-3.0]: 40L d=4096 32H (GQA kv=8)
d_ff=12800 vocab=49155."""
from ..models.transformer import TransformerConfig
from .base import ArchSpec, lm_cells

FULL = TransformerConfig(
    name="granite-3-8b", n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_head=128, d_ff=12800, vocab=49155, act="silu", gated=True,
)

REDUCED = TransformerConfig(
    name="granite-3-8b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256, act="silu", gated=True,
    q_block=32,
)

SPEC = ArchSpec(
    name="granite-3-8b", family="lm", full=FULL, reduced=REDUCED,
    cells=lm_cells(full_attention=True),
    notes="dense GQA baseline of the LM family",
)
