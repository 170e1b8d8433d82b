"""The first-level-branch items of the DFS kernels (plain torch versions)
vs the JAX reference.

The CUDA count and list kernels split each tile's DFS into items (tile b,
vertex v): item (b, v) holds the l-cliques of tile b whose lowest vertex is
v.  ``clique_count_items_torch`` is the plain version of the item pass.
Here its row sums mod 2**32 are held against the tile counts of the plain
DFS and of the reference (the Pallas kernel in interpret mode at T = 32 and
64, the compiled lax backend above), and the plain list buffer against the
concatenation of the item blocks in v order.  Inputs are packed tiles made
with numpy from a seed; every comparison is exact (tolerance 0).  The CUDA
kernels themselves are tested on the card by ``test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bitops import pack_bits
from repro.kernels import ops as jops
from repro_torch.kernels import clique_count, clique_list, ops
from torch_cases import big_clique_tiles

BINS = (32, 64, 128, 256)


def dense_tiles(seed, B, T, s_max, p=0.75):
    """(B, T, W) uint32 symmetric tiles and (B, W) cands: each cand is up to
    ``s_max`` vertices scattered over all T slots, dense inside (p) and
    sparse outside (edges every kernel must mask).  Lane 0 has an empty
    cand over a non-empty A."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((B, T, T), dtype=bool)
    cmask = np.zeros((B, T), dtype=bool)
    for b in range(1, B):
        size = int(rng.integers(s_max // 2, s_max + 1))
        cmask[b, rng.choice(T, size=size, replace=False)] = True
        both = cmask[b][:, None] & cmask[b][None, :]
        dense[b] = np.triu(np.where(both, rng.random((T, T)) < p,
                                    rng.random((T, T)) < 0.05), 1)
    dense[0] = np.triu(rng.random((T, T)) < 0.5, 1)
    dense |= dense.transpose(0, 2, 1)
    return pack_bits(dense), pack_bits(cmask)


def port(A_u32, cand_u32):
    return (torch.from_numpy(A_u32).view(torch.int32),
            torch.from_numpy(cand_u32).view(torch.int32))


def jax_count(A_u32, cand_u32, l):
    """The reference count: Pallas interpret at T <= 64, lax above."""
    A, cand = jnp.asarray(A_u32), jnp.asarray(cand_u32)
    if A_u32.shape[1] <= 64:
        out = jops.count_tiles(A, cand, l, method="dfs", backend="pallas")
    else:
        out = jops.count_tiles(A, cand, l, backend="lax")
    return np.asarray(out).astype(np.int64)


@pytest.mark.parametrize("T", BINS)
@pytest.mark.parametrize("l", [3, 4, 5, 6, 7])
def test_item_counts_sum_to_tile_counts(T, l):
    A, cand = dense_tiles(31 * l + T, 5, T, s_max=18 if l >= 6 else 22,
                          p=0.85 if l >= 6 else 0.75)
    items = clique_count.clique_count_items_torch(*port(A, cand), l)
    assert items.shape == (5, T) and items.dtype == torch.int64
    tiles = clique_count.clique_count_tiles_torch(*port(A, cand), l)
    assert int(tiles.sum()) > 0
    np.testing.assert_array_equal((items.sum(-1) & 0xFFFFFFFF).numpy(),
                                  tiles.numpy())
    np.testing.assert_array_equal(tiles.numpy(), jax_count(A, cand, l))
    # zero wherever v is not in cand or sub is too small to hold l - 1
    vbit = np.unpackbits(cand.view(np.uint8), axis=-1,
                         bitorder="little").astype(bool)
    assert not items.numpy()[~vbit].any()
    assert not items[0].any()


@pytest.mark.parametrize("T", BINS)
@pytest.mark.parametrize("l", [1, 2, 3, 4, 5])
def test_list_buffer_is_item_blocks_in_v_order(T, l):
    A, cand = port(*dense_tiles(17 * l + T, 4, T, s_max=14 if l >= 4
                                else 20))
    items = clique_count.clique_count_items_torch(A, cand, l)
    cap = max(1, int(items.sum(-1).max()))
    buf, count, overflow = clique_list.clique_list_tiles_torch(A, cand, l,
                                                               cap)
    assert not overflow.any() and int(count.sum()) > 0
    for b in range(A.shape[0]):
        lo = 0
        for v in range(T):
            n = int(items[b, v])
            block = buf[b, lo:lo + n]
            # the block of item v is the rows whose lowest vertex is v
            assert bool((block[:, 0] == v).all()), (b, v)
            lo += n
        assert lo == int(count[b])
        assert not buf[b, lo:].any()                 # zero padding


def test_item_wrapper_takes_plain_version_on_cpu():
    ops.reset_counts()
    before = clique_count.item_launches
    A, cand = port(*dense_tiles(3, 4, 64, s_max=16))
    got = clique_count.clique_count_items(A, cand, 5)
    assert torch.equal(got, clique_count.clique_count_items_torch(A, cand,
                                                                  5))
    assert clique_count.item_launches == before
    assert sum(ops.launch_counts().values()) == 0
    # no cap on l: at l = 17 and 18 the branch counts sum to the
    # reference's tile counts
    big = big_clique_tiles(18, 3, 64, (19, 18, 0), noise=0.03)
    for l in (17, 18):
        got = clique_count.clique_count_items(*port(*big), l)
        np.testing.assert_array_equal(got.sum(-1).numpy(),
                                      jax_count(*big, l))
        assert int(got.sum()) > 0
    with pytest.raises(TypeError):
        clique_count.clique_count_items(A.to(torch.int64), cand, 4)
    # the kernels pack an item's tile index into 16 bits
    assert clique_count.item_list(5, 64, A.device).numel() == 5 * 64 * 65 // 2
    with pytest.raises(ValueError):
        clique_count.item_list(1 << 16, 32, A.device)
