"""Synthetic graph generators (identical to the reference's for a seed)."""
from .graphs import erdos_renyi, planted_cliques, powerlaw_graph, rmat_graph
