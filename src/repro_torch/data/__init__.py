"""Synthetic data: graph generators and the LM token pipeline (identical
to the reference's for a seed)."""
from .graphs import erdos_renyi, planted_cliques, powerlaw_graph, rmat_graph
from .lm import LMDataPipeline
