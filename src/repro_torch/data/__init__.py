"""Synthetic data: graph generators, the padded GNN batches, the neighbor
sampler and the LM and recsys pipelines (identical to the reference's
for a seed)."""
from .graphs import (GraphBatcher, erdos_renyi, planted_cliques,
                     powerlaw_graph, rmat_graph)
from .lm import LMDataPipeline
from .recsys import RecsysPipeline
from .sampler import NeighborSampler, sampled_block_shapes
