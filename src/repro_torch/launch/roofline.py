"""Roofline terms of a dry-run cell on the H100: the port of the
reference's ``launch.roofline``.

Hardware model: one NVIDIA H100 SXM at its 700 W limit, from NVIDIA's
data sheet (dense rates, no sparsity): 989e12 bf16 FLOP/s, 3.35e12 B/s
of HBM, and 450e9 B/s each way over NVLink.

Terms (seconds, per device: the dry run counts rank 0's SPMD program, so
its FLOPs and bytes are already per card):

  compute    = flops / peak_flops
  memory     = bytes_accessed / hbm_bw
  collective = collective_operand_bytes / nvlink_bw

The reference parses collectives out of XLA's HLO text
(``collective_bytes``); the port counts them as they are issued
(``sharding.spmd.tally``, same keys and byte semantics).
"""
from __future__ import annotations

from typing import Dict

PEAK_FLOPS = 989e12         # bf16 FLOP/s per card (dense)
HBM_BW = 3.35e12            # bytes/s per card
NVLINK_BW = 450e9           # bytes/s per card, each way


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_operand_bytes: float) -> Dict[str, float]:
    compute = flops / PEAK_FLOPS
    memory = bytes_accessed / HBM_BW
    collective = coll_operand_bytes / NVLINK_BW
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    total = max(compute, memory, collective)
    terms["bound_s"] = total
    for k in ("compute_s", "memory_s", "collective_s"):
        terms[f"frac_{k[:-2]}"] = (terms[k] / total) if total > 0 else 0.0
    return terms


def model_flops_lm(meta: Dict, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode: per token."""
    n = meta.get("active_params") or meta.get("model_params") or 0
    toks = meta.get("tokens_per_step", 0)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * toks
