"""dbrx-132b [hf:databricks/dbrx-base]: 40L d=6144 48H (GQA kv=8)
d_ff=10752 vocab=100352; MoE 16 experts top-4."""
from ..models.transformer import MoEConfig, TransformerConfig
from .base import ArchSpec, lm_cells

FULL = TransformerConfig(
    name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_head=128, d_ff=10752, vocab=100352, act="silu", gated=True,
    moe=MoEConfig(n_experts=16, top_k=4, n_shared=0, d_expert=10752),
)

REDUCED = TransformerConfig(
    name="dbrx-132b-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_head=8, d_ff=128, vocab=256, act="silu", gated=True,
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_expert=128),
    q_block=32,
)

SPEC = ArchSpec(
    name="dbrx-132b", family="lm", full=FULL, reduced=REDUCED,
    cells=lm_cells(full_attention=True),
    notes="coarse MoE with large experts; top-4 of 16",
)
