"""Tile cases shared by the port's CPU and card tests.

Imports neither jax nor ``repro``, so ``test_torch_gpu.py`` can use it on
a machine that has only PyTorch.
"""
import numpy as np

from repro_torch.core.bitops import pack_bits


def structured_triangle_tiles(case, T, seed=0):
    """One packed tile (numpy uint32 words) of a kind a triangle kernel
    must get right at every bin: ``complete`` (K_T under a full cand:
    C(T, 3) triangles, 2,763,520 at T = 256), ``heavy_row`` (vertex 0
    adjacent to all over a sparse rest, the skew that a thread per row
    serialises) and ``empty_cand`` (a full A under an empty cand: 0).
    Returns ((1, T, W) adjacency, (1, W) cand)."""
    rng = np.random.default_rng(seed + T)
    if case == "heavy_row":
        upper = np.triu(rng.random((T, T)) < 0.1, 1)
        upper[0, 1:] = True
    else:
        upper = np.triu(np.ones((T, T), dtype=bool), 1)
    dense = upper | upper.T
    cmask = np.full(T, case != "empty_cand")
    return pack_bits(dense[None]), pack_bits(cmask[None])


def big_clique_tiles(seed, B, T, sizes, noise=0.05, spare=3):
    """(B, T, W) uint32 symmetric tiles and (B, W) cands, each tile a
    planted clique of ``sizes[b % len(sizes)]`` vertices scattered over the
    T slots, ``spare`` more cand vertices outside it and ``noise`` random
    edges everywhere: the tiles that hold l-cliques for l well above 16
    (C(s, l) of them in a clique of s vertices, plus what noise adds) with
    a DFS that stays short.  Returns numpy words."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((B, T, T), dtype=bool)
    cmask = np.zeros((B, T), dtype=bool)
    for b in range(B):
        s = min(T, sizes[b % len(sizes)])
        members = rng.choice(T, size=min(T, s + spare), replace=False)
        dense[b][np.ix_(members[:s], members[:s])] = True
        dense[b] |= rng.random((T, T)) < noise
        cmask[b, members] = True
    dense = np.triu(dense, 1)
    dense |= dense.transpose(0, 2, 1)
    return pack_bits(dense), pack_bits(cmask)


def planted_clique_tiles(seed, T, sizes):
    """One tile per entry of ``sizes``: a clique of that many vertices on
    scattered slots, two isolated cand vertices beside it, and no other
    edge, so the l-cliques of tile b are exactly the l-subsets of its
    clique, C(s, l) of them, listed in lexicographic order.  Returns
    ((B, T, W) words, (B, W) words, the sorted clique slots of each tile;
    a tile whose clique has under two vertices has none).
    """
    A, cand = big_clique_tiles(seed, len(sizes), T, sizes, noise=0.0,
                               spare=2)
    bits = np.unpackbits(A.view(np.uint8), bitorder="little")
    degree = bits.reshape(len(sizes), T, T).sum(-1)
    members = [np.nonzero(d)[0].tolist() for d in degree]
    assert [len(m) for m in members] == [s if s > 1 else 0 for s in sizes]
    return A, cand, members


#: tile widths above 256 that the kernels' wide path takes: W = 9, 16, 33
#: and 64 (one word past a warp's 32 lanes at W = 33, two words a lane at
#: W = 64)
WIDE_WIDTHS = (288, 512, 1056, 2048)


def wide_tiles(T, B=4, seed=None):
    """(B, T, W) tiles at a width above 256: planted cliques of 8 to 11
    vertices scattered over all T slots, four spare cand vertices and about
    two noise edges a vertex, so every word of a row and of cand can carry
    bits and each tile's counts stay far below 2**32 (C(11, 5) = 462
    5-cliques in the largest clique).  Returns numpy words."""
    return big_clique_tiles(T if seed is None else seed, B, T,
                            (11, 9, 10, 8), noise=2.0 / T, spare=4)


def turan_graph_edges(parts, size):
    """Edges of the complete multipartite graph of ``parts`` parts of
    ``size`` vertices (vertex v in part v // size): every vertex misses
    only its ``size - 1`` part-mates, so a tile's cand-induced subgraph is
    a (size + 1)-plex and, for size >= 2, no 2-plex that the router
    closes.  It holds C(parts, k) * size**k k-cliques.  Returns
    (n, (m, 2) int64 edges)."""
    n = parts * size
    ii, jj = np.triu_indices(n, 1)
    keep = ii // size != jj // size
    return n, np.stack([ii[keep], jj[keep]], 1).astype(np.int64)
