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
