"""Graph500 Kronecker graphs, drawn for one benchmark run.

The Graph500 specification (section 3, graph generation) draws
``edge_factor * 2**scale`` edges, each by descending ``scale`` levels of a
2x2 initiator with probabilities A, B, C, D (0.57, 0.19, 0.19, 0.05), and
then permutes the vertex labels (and the order of the edges) at random.
Here every level picks the quadrant with one uniform number, and the
structure is drawn from the configuration's fixed ``kronecker_seed``; the
run's ``--seed`` draws only the label permutation.  So
every seed hands the program the same graph up to isomorphism, with the
same number of cliques and the same work, in another labelling: what
changes between seeds is the order in which ties fall, not the size of a
query.  Self loops and repeated edges are dropped, as the specification's
kernel 1 does.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .reference.kclique import canonical_edges


def kronecker_pairs(scale: int, edge_factor: int, initiator, kronecker_seed: int,
                    label_seed: int) -> Tuple[int, np.ndarray]:
    """``(n, pairs)``: the raw (m, 2) int64 edge draw, labels permuted.

    The specification also shuffles the edge list; both sides here get
    the canonical (sorted) form, which erases that order, so it is not
    drawn."""
    a, b, c, d = (float(x) for x in initiator)
    if abs(a + b + c + d - 1.0) > 1e-9:
        raise ValueError("initiator probabilities must sum to 1")
    n = 1 << int(scale)
    m = n * int(edge_factor)
    rng = np.random.default_rng(int(kronecker_seed))
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(int(scale)):
        r = rng.random(m)
        src |= (r >= a + b).astype(np.int64) << bit
        dst |= (((r >= a) & (r < a + b)) | (r >= a + b + c)).astype(np.int64) << bit
    labels = np.random.default_rng(
        np.random.SeedSequence([int(label_seed), 500])).permutation(n)
    return n, np.stack([labels[src], labels[dst]], axis=1)


def graph_for(config: dict, seed: int) -> Tuple[int, np.ndarray]:
    """``(n, edges)``: the configuration's graph for ``seed``, canonical
    (u < v, sorted, unique), as both the program and the reference get it."""
    if config.get("generator") != "graph500-kronecker":
        raise ValueError(f"unknown generator {config.get('generator')!r}")
    n, pairs = kronecker_pairs(config["scale"], config["edge_factor"],
                               config["initiator"], config["kronecker_seed"],
                               seed)
    return n, canonical_edges(n, pairs)
