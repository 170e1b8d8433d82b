"""nemotron-4-15b [arXiv:2402.16819]: 32L d=6144 48H (GQA kv=8) d_ff=24576
vocab=256000; squared-ReLU non-gated FFN."""
from ..models.transformer import TransformerConfig
from .base import ArchSpec, lm_cells

FULL = TransformerConfig(
    name="nemotron-4-15b", n_layers=32, d_model=6144, n_heads=48,
    n_kv_heads=8, d_head=128, d_ff=24576, vocab=256000, act="squared_relu",
    gated=False,
)

REDUCED = TransformerConfig(
    name="nemotron-4-15b-smoke", n_layers=2, d_model=64, n_heads=8,
    n_kv_heads=2, d_head=8, d_ff=256, vocab=512, act="squared_relu",
    gated=False, q_block=32,
)

SPEC = ArchSpec(
    name="nemotron-4-15b", family="lm", full=FULL, reduced=REDUCED,
    cells=lm_cells(full_attention=True),
    notes="dense, squared-ReLU (Primer) activation",
)
