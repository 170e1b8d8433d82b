"""deepseek-moe-16b [arXiv:2401.06066; hf]: 28L d=2048 16H (GQA kv=16)
d_ff=1408 vocab=102400; MoE 2 shared + 64 routed top-6, fine-grained."""
from ..models.transformer import MoEConfig, TransformerConfig
from .base import ArchSpec, lm_cells

FULL = TransformerConfig(
    name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
    n_kv_heads=16, d_head=128, d_ff=1408, vocab=102400, act="silu",
    gated=True,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
)

REDUCED = TransformerConfig(
    name="deepseek-moe-16b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=96, vocab=256, act="silu", gated=True,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=2, d_expert=96),
    q_block=32,
)

SPEC = ArchSpec(
    name="deepseek-moe-16b", family="lm", full=FULL, reduced=REDUCED,
    cells=lm_cells(full_attention=True),
    notes="fine-grained MoE; experts sharded over the model axis (EP), "
          "tokens replicated across model + psum combine",
)
