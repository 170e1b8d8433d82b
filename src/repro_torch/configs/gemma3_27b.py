"""gemma3-27b [hf:google/gemma-3]: 62L d=5376 32H (GQA kv=16) d_ff=21504
vocab=262144; 5:1 local:global attention, 1024-token sliding window."""
from ..models.transformer import TransformerConfig
from .base import ArchSpec, lm_cells

FULL = TransformerConfig(
    name="gemma3-27b", n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_head=128, d_ff=21504, vocab=262144, act="gelu", gated=True,
    local_window=1024, local_per_global=5,
)

REDUCED = TransformerConfig(
    name="gemma3-27b-smoke", n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=128, vocab=512, act="gelu", gated=True,
    local_window=16, local_per_global=5, q_block=16,
)

SPEC = ArchSpec(
    name="gemma3-27b", family="lm", full=FULL, reduced=REDUCED,
    cells=lm_cells(full_attention=False),
    notes="5:1 local:global; local layers keep a window-sized rolling KV, "
          "so long_500k decode state is sub-quadratic and the cell runs",
)
