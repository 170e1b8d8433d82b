"""Cliques of more than 18 vertices (l = k - 2 > 16) and batches past one
kernel launch, in the port against the JAX reference, on the CPU.

The reference takes every l >= 1 and any batch size; so does the port:
its plain versions have no cap on l, its wrappers answer l > T with zeros
(no tile of T vertices holds an l-clique) and split a batch into launches
of fewer than 2**16 tiles on the card.  Every comparison is exact
(tolerance 0): counts and listed ids are integers.  The reference runs
its Pallas kernels in interpret mode.  The card side of the same
contracts is in ``test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ebbkc as jebbkc
from repro.data import graphs as jgraphs
from repro.kernels import ops as jops
from repro_torch.core import ebbkc
from repro_torch.data import graphs as tgraphs
from repro_torch.kernels import clique_count, clique_list, ops
from torch_cases import big_clique_tiles

#: 4,512 19-cliques and 283 20-cliques (the reference's counts)
DENSE_ER = dict(n=40, p=0.9, seed=3)
EXPECTED = {19: 4_512, 20: 283}


@pytest.fixture(scope="module")
def dense_er():
    return (tgraphs.erdos_renyi(DENSE_ER["n"], DENSE_ER["p"],
                                seed=DENSE_ER["seed"]),
            jgraphs.erdos_renyi(DENSE_ER["n"], DENSE_ER["p"],
                                seed=DENSE_ER["seed"]))


def port(A_u32, x_u32):
    return (torch.from_numpy(A_u32).view(torch.int32),
            torch.from_numpy(x_u32).view(torch.int32))


@pytest.mark.parametrize("k", [19, 20])
def test_dense_er_counts_past_k18(dense_er, k):
    g, jg = dense_er
    got = ebbkc.count(g, k, device="cpu").count
    assert got == EXPECTED[k] == jebbkc.count(jg, k).count


@pytest.mark.parametrize("k", [19, 20])
def test_dense_er_rows_past_k18(dense_er, k):
    g, jg = dense_er
    got, st = ebbkc.list_cliques(g, k, device="cpu")
    want, jst = jebbkc.list_cliques(jg, k, backend="jax",
                                    engine_kwargs=dict(backend="pallas"))
    assert got.shape == (EXPECTED[k], k)
    np.testing.assert_array_equal(got, want)              # order included
    assert st.emitted_cliques == jst.emitted_cliques == EXPECTED[k]


@pytest.mark.parametrize("T,l", [(32, 33), (64, 65), (32, 40)])
def test_wrappers_above_the_tile_width_match_reference(T, l):
    """l > T: the count is 0, the branch counts are 0, and the list
    triple is the reference's, zero buffer of shape (B, capacity, l)."""
    A, cand = big_clique_tiles(T + l, 3, T, (T, T - 1, 0), noise=0.1)
    tA, tc = port(A, cand)
    want = np.asarray(jops.count_tiles(jnp.asarray(A), jnp.asarray(cand), l,
                                       backend="pallas"))
    np.testing.assert_array_equal(
        clique_count.clique_count_tiles(tA, tc, l).numpy(), want)
    assert not want.any()
    assert not clique_count.clique_count_items(tA, tc, l).any()
    jbuf, jcnt, jovf = (np.asarray(x) for x in jops.list_tiles(
        jnp.asarray(A), jnp.asarray(cand), l, 4, backend="pallas"))
    buf, cnt, ovf = clique_list.clique_list_tiles(tA, tc, l, 4)
    assert buf.shape == jbuf.shape == (3, 4, l)
    np.testing.assert_array_equal(buf.numpy(), jbuf)
    np.testing.assert_array_equal(cnt.numpy(), jcnt.astype(np.int64))
    np.testing.assert_array_equal(ovf.numpy(), jovf.astype(np.int64))


@pytest.mark.parametrize("B", [1, 65_535, 65_536, 70_000, 200_000])
def test_launch_chunks_cover_a_batch_in_order(B):
    chunks = clique_count.launch_chunks(B)
    assert chunks[0][0] == 0 and chunks[-1][1] == B
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(0 < hi - lo <= clique_count.LAUNCH_TILES < 1 << 16
               for lo, hi in chunks)
    assert len(chunks) == -(-B // clique_count.LAUNCH_TILES)


@pytest.mark.parametrize("T,tiles", [(32, 65_535), (64, 32_768),
                                     (128, 8_192), (256, 2_048)])
def test_list_launches_stay_within_the_per_x_budget(T, tiles):
    assert clique_list.launch_tiles(T) == tiles
    assert tiles * T * T * 8 <= clique_list.PER_X_BYTES
    assert tiles <= clique_count.LAUNCH_TILES
    # the item scratch of one launch packs its tile index into 16 bits
    assert clique_count.item_list(tiles, T, torch.device("cpu")).numel() \
        == tiles * T * (T + 1) // 2
    with pytest.raises(ValueError):
        clique_count.item_list(clique_count.LAUNCH_TILES + 1, T,
                               torch.device("cpu"))


def test_large_l_runs_the_plain_versions_on_the_cpu():
    """The wrappers take the plain version for a CPU tensor at any l, and
    launch nothing."""
    A, cand = port(*big_clique_tiles(5, 2, 32, (18, 0), noise=0.0))
    ops.reset_counts()
    assert clique_count.clique_count_tiles(A, cand, 17).tolist() == [18, 0]
    assert clique_list.clique_list_tiles(A, cand, 17, 32)[1].tolist() == \
        [18, 0]
    assert sum(ops.launch_counts().values()) == 0
    assert ops.plain_counts()["clique_count_tiles"] == 1
    assert ops.plain_counts()["clique_list_tiles"] == 1
    ops.reset_counts()
