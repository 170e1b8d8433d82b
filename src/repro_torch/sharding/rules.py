"""Logical axes -> mesh axes: the port of the reference's
``sharding.rules``.

Parameters and inputs are annotated with *logical* axis names; a rules
table maps them to physical mesh axes ("pod", "data", "model").  This is
the single place where the parallelism layout of every architecture is
decided.  The tables and the spec builders are the reference's, as pure
Python; :class:`P` stands in for ``PartitionSpec`` (a tuple with one part
a dimension: ``None``, one axis name, or a tuple of axis names).

LM layout (Megatron-style TP + hierarchical DP):
  heads / ff / experts / vocab -> "model";  batch -> ("pod", "data")
GNN full-batch layout: nodes/edges -> ("pod", "data"); features
  replicated (a segment sum over sharded edges makes partial node sums,
  reduce-scattered back to the node blocks).
Recsys: embedding rows -> "model" (the tables are the model);
  batch -> ("pod", "data").
Clique engine: tiles (the EP axis of the paper) -> all axes flattened.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


class P(tuple):
    """A partition spec: ``P("data", None)`` shards dimension 0 over the
    ``data`` axis and keeps dimension 1 whole; a part that is a tuple of
    axis names shards its dimension over their product, the first axis
    major.  Equal to the plain tuple of its parts."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 \
            else f"P({self[0]!r})"


@dataclasses.dataclass(frozen=True)
class LogicalRules:
    table: Dict[str, Optional[Tuple[str, ...]]]

    def axis(self, name: Optional[str]):
        if name is None:
            return None
        return self.table.get(name, None)


LM_RULES = LogicalRules({
    "batch": ("pod", "data"),
    "seq": None,
    # FSDP: the d_model axis of every weight is sharded over the data axis
    # for storage and gathered a layer at a time where it is used
    "embed": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "ff": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "layers": None,
    "cache_len": None,
})

GNN_RULES = LogicalRules({
    "nodes": ("pod", "data"),
    "edges": ("pod", "data"),
    "feat": None,
    "hidden": None,
    "graphs": ("pod", "data"),
})

RECSYS_RULES = LogicalRules({
    "batch": ("pod", "data"),
    "rows": ("model",),
    "dim": None,
    "fields": None,
    "candidates": ("model",),
})

CLIQUE_RULES = LogicalRules({
    "tiles": ("pod", "data", "model"),
    "tile_v": None,
    "tile_w": None,
})


def spec_for(rules: LogicalRules, logical_axes: Tuple[Optional[str], ...]
             ) -> P:
    parts = []
    for ax in logical_axes:
        m = rules.axis(ax)
        if m is None:
            parts.append(None)
        elif len(m) == 1:
            parts.append(m[0])
        else:
            parts.append(tuple(m))
    return P(*parts)


def tree_specs(mesh, spec_tree):
    """``spec_tree`` with every :class:`P` filtered to ``mesh``'s axes
    (:func:`repro_torch.sharding.spmd.filter_spec`); the reference's
    ``tree_shardings``."""
    from .spmd import filter_spec, map_specs
    return map_specs(lambda s: filter_spec(s, mesh), spec_tree)


# ---------------------------------------------------------------------------
# per-model logical annotations
# ---------------------------------------------------------------------------

def transformer_param_specs(cfg, rules: LogicalRules = LM_RULES,
                            model_size: int = 1):
    """Spec tree matching ``models.transformer.init_params``.

    ``model_size``: TP degree.  KV heads are *replicated* when n_kv_heads
    is not divisible by it (GQA with kv < TP -- standard MaxText/Megatron
    fallback); same guard for q heads.
    """
    def s(*ax):
        return spec_for(rules, ax)
    kv_ax = "kv_heads" if cfg.n_kv_heads % max(model_size, 1) == 0 else None
    q_ax = "heads" if cfg.n_heads % max(model_size, 1) == 0 else None
    group = {
        "ln1": s("layers", "embed"),
        "ln2": s("layers", "embed"),
        "wq": s("layers", "embed", q_ax, "head_dim"),
        "wk": s("layers", "embed", kv_ax, "head_dim"),
        "wv": s("layers", "embed", kv_ax, "head_dim"),
        "wo": s("layers", q_ax, "head_dim", "embed"),
    }
    if cfg.moe:
        group.update({
            "router": s("layers", "embed", None),
            "we1": s("layers", "experts", "embed", None),
            "we3": s("layers", "experts", "embed", None),
            "we2": s("layers", "experts", None, "embed"),
        })
        if cfg.moe.n_shared:
            group.update({
                "ws1": s("layers", "embed", "ff"),
                "ws3": s("layers", "embed", "ff"),
                "ws2": s("layers", "ff", "embed"),
            })
    else:
        group.update({
            "w1": s("layers", "embed", "ff"),
            "w2": s("layers", "ff", "embed"),
        })
        if cfg.gated:
            group["w3"] = s("layers", "embed", "ff")
    return {
        # embed/head: vocab-sharded only (the tables are O(vocab*d/model)
        # bytes, so data-axis sharding buys nothing)
        "embed": s("vocab", "embed_noshard"),
        "final_ln": s("embed"),
        "head": s("embed_noshard", "vocab"),
        "groups": {kind: dict(group) for kind, _ in cfg.layer_groups},
    }


def transformer_layer_specs(cfg, model_size: int = 1):
    """Per-layer (sliced) weight specs: model-axis sharding only (the
    data-axis storage shards are gathered a layer at a time)."""
    kv_ax = "model" if cfg.n_kv_heads % max(model_size, 1) == 0 else None
    q_ax = "model" if cfg.n_heads % max(model_size, 1) == 0 else None
    specs = {
        "ln1": P(None),
        "ln2": P(None),
        "wq": P(None, q_ax, None),
        "wk": P(None, kv_ax, None),
        "wv": P(None, kv_ax, None),
        "wo": P(q_ax, None, None),
    }
    if cfg.moe:
        specs.update({
            "router": P(None, None),
            "we1": P("model", None, None),
            "we3": P("model", None, None),
            "we2": P("model", None, None),
        })
        if cfg.moe.n_shared:
            specs.update({"ws1": P(None, "model"), "ws3": P(None, "model"),
                          "ws2": P("model", None)})
    else:
        specs.update({"w1": P(None, "model"), "w2": P("model", None)})
        if cfg.gated:
            specs["w3"] = P(None, "model")
    return specs


def transformer_cache_specs(cfg, rules: LogicalRules = LM_RULES,
                            model_size: int = 1):
    def s(*ax):
        return spec_for(rules, ax)
    if cfg.n_kv_heads % max(model_size, 1) == 0:
        kv = s("layers", "batch", "cache_len", "kv_heads", "head_dim")
    else:
        # kv heads not shardable over TP: shard the cache length instead
        kv = P(None, spec_for(rules, ("batch",))[0], "model", None, None)
    return {kind: {"k": kv, "v": kv} for kind, _ in cfg.layer_groups}


def batch_specs(rules: LogicalRules,
                names: Dict[str, Tuple[Optional[str], ...]]):
    return {k: spec_for(rules, ax) for k, ax in names.items()}
