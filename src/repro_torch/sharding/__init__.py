"""Logical-axis sharding rules -> partition specs, and the manual SPMD
layer (blocks, groups, collectives) over a ``DeviceMesh``."""
from .rules import (LogicalRules, LM_RULES, GNN_RULES, RECSYS_RULES,
                    CLIQUE_RULES, P, spec_for, tree_specs,
                    transformer_param_specs, transformer_layer_specs,
                    transformer_cache_specs, batch_specs)
