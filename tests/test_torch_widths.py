"""Tile widths that are multiples of 32 but not powers of two.

The reference takes any multiple of 32 as a bin, and its tuner's
``mult32`` policy packs tiles at T = 96, 160, 192 and 224.  Here the
port's plain versions of the four kernels are held against the
reference's functions at every W = T / 32 from 1 to 8 on the same packed
batches (the triangle count against the Pallas kernel in interpret mode,
the DFS count, the list triple and the edge candidates against the
compiled lax backend and the reference's oracle), and the port's engines
against the reference's with the ``(96, 256)`` and ``mult32`` ladders.
Every comparison is exact (tolerance 0): counts and local ids are
integers, list buffers are compared whole.  The CUDA kernels at these
widths are tested on the card by ``test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine_jax, listing as jlisting
from repro.data import graphs as jgraphs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.tune import search as jsearch
from repro_torch.core import engine_torch, listing
from repro_torch.data import graphs
from repro_torch.kernels import clique_list, common, intersect, ops
from repro_torch.tune import search
from torch_cases import big_clique_tiles

WIDTHS = (1, 2, 3, 4, 5, 6, 7, 8)


def port(*arrays):
    return tuple(torch.from_numpy(x).view(torch.int32) for x in arrays)


def width_tiles(W, B=5):
    """(B, T, W) tiles at T = 32 W: planted cliques of up to 9 vertices
    scattered over all T slots under sparse noise, so every word of a row
    and of cand carries bits; lane 0 of big_clique_tiles' layout has the
    largest clique."""
    T = 32 * W
    return big_clique_tiles(1000 + W, B, T, (9, 7, 5, 8, 6),
                            noise=3.0 / T, spare=4)


@pytest.mark.parametrize("W", WIDTHS)
def test_plain_kernels_match_reference_at_every_width(W):
    T = 32 * W
    A_u32, cand_u32 = width_tiles(W)
    A, cand = port(A_u32, cand_u32)
    jA, jc = jnp.asarray(A_u32), jnp.asarray(cand_u32)
    ops.reset_counts()
    # triangles: the reference's Pallas matmul kernel in interpret mode
    tri = ops.count_tiles(A, cand, 3).numpy()
    np.testing.assert_array_equal(tri, np.asarray(jops.count_tiles(
        jA, jc, 3, method="mxu", backend="pallas")).astype(np.int64))
    assert tri.max() > 0
    # the DFS count and the list triple: the lax backend
    counts = ops.count_tiles(A, cand, 4).numpy()
    np.testing.assert_array_equal(counts, np.asarray(jops.count_tiles(
        jA, jc, 4, backend="lax")).astype(np.int64))
    assert counts.max() > 2
    for cap in (1, listing.capacity_for(counts)):
        got = ops.list_tiles(A, cand, 4, cap)
        want = jops.list_tiles(jA, jc, 4, cap, backend="lax")
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.numpy(),
                                          np.asarray(y).astype(x.numpy().dtype))
    # edge candidates of one edge per tile: the reference's oracle
    rng = np.random.default_rng(W)
    a = rng.integers(0, T - 1, A.shape[0])
    pairs = np.stack([a, a + 1 + rng.integers(0, T - 1 - a)], 1).astype(
        np.int32)
    got_c, got_n = intersect.edge_candidates(A, torch.from_numpy(pairs))
    want_c, want_n = jref.edge_candidates_ref(jA, jnp.asarray(pairs))
    np.testing.assert_array_equal(got_c.numpy().view(np.uint32),
                                  np.asarray(want_c))
    np.testing.assert_array_equal(got_n.numpy(),
                                  np.asarray(want_n).astype(np.int64))
    # all of it ran the plain versions: these are CPU tensors
    assert sum(ops.launch_counts().values()) == 0
    assert ops.plain_counts()["clique_list_tiles"] == 2


def test_plain_versions_take_tiles_wider_than_256():
    """T = 288 has no bin in either policy and no CUDA kernel (ROADMAP
    C4), but the plain versions count such tiles as the reference does."""
    A_u32, cand_u32 = big_clique_tiles(7, 3, 288, (8, 6, 7), noise=0.01)
    A, cand = port(A_u32, cand_u32)
    for l in (3, 4):
        np.testing.assert_array_equal(
            ops.count_tiles(A, cand, l).numpy(),
            np.asarray(jops.count_tiles(jnp.asarray(A_u32),
                                        jnp.asarray(cand_u32), l,
                                        backend="lax")).astype(np.int64))


def test_row_alignment_and_tile_checks():
    # the largest power of two dividing 4 W, at most 16: load_row's width
    assert [common.row_alignment(W) for W in WIDTHS] == \
        [4, 8, 4, 16, 4, 8, 4, 16]
    for W in WIDTHS:
        A = torch.zeros((2, 32 * W, W), dtype=torch.int32)
        assert common.check_tiles(A, torch.zeros((2, W), dtype=torch.int32)) \
            == (2, 32 * W, W)
    for shape in ((2, 48, 2), (2, 0, 0), (2, 96, 2)):
        with pytest.raises(ValueError):
            common.check_adjacency(torch.zeros(shape, dtype=torch.int32))


GRAPH = dict(scale=8, edge_factor=16, seed=7)
#: 5- and 6-cliques of rmat_graph(8, 16, seed=7), from the reference
PINNED = {5: 84_164, 6: 148_460}


@pytest.fixture(scope="module")
def rmat8():
    return (graphs.rmat_graph(**GRAPH), jgraphs.rmat_graph(**GRAPH))


@pytest.mark.parametrize("ladder", ["96,256", "mult32"])
def test_engines_count_and_list_with_new_widths(rmat8, ladder):
    g, jg = rmat8
    bins = ((96, 256) if ladder == "96,256" else search.bins_for("mult32"))
    if ladder == "mult32":
        assert bins == jsearch.bins_for("mult32")
    for k in (5, 6):
        got = engine_torch.count(g, k, bins=bins, device="cpu")
        assert got.count == PINNED[k]
        assert got.count == engine_jax.count(jg, k, bins=bins,
                                             backend="lax").count
    # listing: the same rows in the same order as the reference's
    sink = listing.ArraySink(5)
    listing.stream_cliques(g, 5, sink, bins=bins, device="cpu")
    jsink = jlisting.ArraySink(5)
    jlisting.stream_cliques(jg, 5, jsink, bins=bins, backend="lax")
    rows = sink.result()
    assert rows.shape == (PINNED[5], 5)
    np.testing.assert_array_equal(rows, jsink.result())


def test_list_capacity_policies_match_reference():
    rng = np.random.default_rng(3)
    for counts in (rng.integers(0, 5000, 16), np.array([0]), np.array([64]),
                   np.array([65]), np.array([20000])):
        for policy in ("pow2", "mult64"):
            assert listing.capacity_for(counts, policy=policy) == \
                jlisting.capacity_for(counts, policy=policy)
            assert listing.capacity_for(counts, 4096, policy=policy) == \
                jlisting.capacity_for(counts, 4096, policy=policy)
    with pytest.raises(ValueError):
        listing.capacity_for(np.array([3]), policy="pow3")


def test_mult64_capacity_lists_the_same_rows(rmat8):
    g, _ = rmat8
    rows = {}
    for policy in ("pow2", "mult64"):
        sink = listing.ArraySink(6)
        listing.stream_cliques(g, 6, sink, cap_policy=policy, device="cpu",
                               bins=(96, 256))
        rows[policy] = sink.result()
    assert rows["pow2"].shape[0] == PINNED[6]
    np.testing.assert_array_equal(rows["pow2"], rows["mult64"])
    # a pinned capacity below the largest count relists on the host, and
    # its triple equals the plain version's at that capacity
    A, cand = port(*width_tiles(3, B=3))
    buf, cnt, ovf = clique_list.clique_list_tiles_torch(A, cand, 4, 2)
    assert ovf.any() and (buf.reshape(3, -1).any(-1) == (cnt > 0)).all()
