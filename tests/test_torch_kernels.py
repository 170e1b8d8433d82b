"""Port kernels (plain torch versions, wrappers, routing) vs the JAX
reference kernels.

Inputs are packed tiles made with numpy from a seed and handed to both
packages.  Every comparison is exact equality (tolerance 0): all counts
are integers.  The JAX side runs the Pallas kernels in interpret mode at
T = 32 and 64, and the compiled lax backend (held byte-identical to the
Pallas kernels by the reference suite) at T = 128 and 256.  The CUDA
kernels themselves are tested on the card by ``test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bitops import pack_bits, pack_mask, pack_rows
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import clique_count, ops, ref, triangle_mm
from torch_cases import big_clique_tiles, structured_triangle_tiles

BINS = (32, 64, 128, 256)


def random_tiles(seed, B, T, p, s_max=None):
    """(B, T, W) uint32 adjacency and (B, W) uint32 candidate masks.

    Lane 0 has an empty cand over a non-empty A (a lane the 2-plex router
    zeroed), lane 1 a full cand (every word has bit 31 set), odd lanes a
    cand with holes (as DFS sub-branches have), and A keeps edges outside
    cand that every kernel must mask away.
    """
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((B, T, T)) < p, 1)
    dense = upper | upper.transpose(0, 2, 1)
    sizes = rng.integers(0, (s_max or T) + 1, B)
    cmask = np.arange(T)[None, :] < sizes[:, None]
    holes = (rng.random((B, T)) < 0.2) & (np.arange(B)[:, None] % 2 == 1)
    cmask &= ~holes
    cmask[0] = False
    if B > 1:
        cmask[1] = True
        if s_max is not None:  # keep the full lane's DFS small
            keep = np.arange(T) % 3 == 0
            dense[1] &= keep[:, None] & keep[None, :]
    return pack_bits(dense), pack_bits(cmask)


def crafted_tiles(T):
    """Zero-, one- and many-triangle tiles, a K7, and an empty cand."""
    specs = [
        (6, [(0, i) for i in range(1, 6)]),                       # star
        (4, [(0, 1), (1, 2), (2, 3), (3, 0)]),                    # c4
        (5, [(0, 1), (1, 2), (0, 2), (3, 4)]),                    # 1 tri
        (7, [(i, j) for i in range(7) for j in range(i + 1, 7)]),  # K7
        (0, [(0, 1), (1, 2), (0, 2)]),                            # empty cand
        (6, [(0, 1), (1, 2), (0, 2), (2, 3), (3, 4), (2, 4), (4, 5)]),
    ]
    As, cands = [], []
    for n, edges in specs:
        rows = [0] * T
        for u, v in edges:
            rows[u] |= 1 << v
            rows[v] |= 1 << u
        As.append(pack_rows(rows, T))
        cands.append(pack_mask((1 << n) - 1, T))
    return np.stack(As), np.stack(cands)


def port(A_u32, cand_u32):
    return (torch.from_numpy(A_u32).view(torch.int32),
            torch.from_numpy(cand_u32).view(torch.int32))


def jax_count(A_u32, cand_u32, l, method):
    """The reference count: Pallas interpret at T <= 64, lax above."""
    T = A_u32.shape[1]
    A, cand = jnp.asarray(A_u32), jnp.asarray(cand_u32)
    if T <= 64:
        out = jops.count_tiles(A, cand, l, method=method, backend="pallas")
    else:
        out = jops.count_tiles(A, cand, l, backend="lax")
    return np.asarray(out).astype(np.int64)


_DENSITY = {32: 0.35, 64: 0.2, 128: 0.12, 256: 0.06}


@pytest.mark.parametrize("T", BINS)
def test_triangle_plain_matches_reference(T):
    A, cand = random_tiles(T, 6, T, _DENSITY[T])
    got = triangle_mm.triangle_count_tiles_torch(*port(A, cand))
    np.testing.assert_array_equal(got.numpy(), jax_count(A, cand, 3, "mxu"))
    # and against the reference's matmul-form oracle
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.triangle_count_tiles_ref(
            jnp.asarray(A), jnp.asarray(cand))).astype(np.int64))


@pytest.mark.parametrize("T", BINS)
@pytest.mark.parametrize("case", ["complete", "heavy_row", "empty_cand"])
def test_triangle_plain_on_structured_tiles(case, T):
    from math import comb
    A, cand = structured_triangle_tiles(case, T)
    got = triangle_mm.triangle_count_tiles_torch(*port(A, cand)).numpy()
    np.testing.assert_array_equal(got, jax_count(A, cand, 3, "mxu"))
    np.testing.assert_array_equal(
        got, np.asarray(jref.triangle_count_tiles_ref(
            jnp.asarray(A), jnp.asarray(cand))).astype(np.int64))
    if case != "heavy_row":
        assert int(got[0]) == (comb(T, 3) if case == "complete" else 0)


@pytest.mark.parametrize("T", BINS)
@pytest.mark.parametrize("l", [3, 4, 5, 6])
def test_dfs_plain_matches_reference(T, l):
    A, cand = random_tiles(1000 * l + T, 4, T, _DENSITY[T], s_max=24)
    got = clique_count.clique_count_tiles_torch(*port(A, cand), l)
    np.testing.assert_array_equal(got.numpy(), jax_count(A, cand, l, "dfs"))


@pytest.mark.parametrize("l", [3, 4, 5, 6])
def test_dfs_plain_on_crafted_tiles(l):
    A, cand = crafted_tiles(32)
    got = clique_count.clique_count_tiles_torch(*port(A, cand), l)
    np.testing.assert_array_equal(got.numpy(), jax_count(A, cand, l, "dfs"))
    if l <= 5:  # the expansion oracle needs memory O(B * T**(l-2))
        np.testing.assert_array_equal(
            got.numpy(),
            ref.clique_count_tiles_ref(*port(A, cand), l).numpy())
    from math import comb
    assert got[3] == comb(7, l) and got[4] == 0  # K7 / empty cand


@pytest.mark.parametrize("T,l", [(32, 1), (32, 2), (32, 3), (32, 4),
                                 (64, 3), (64, 4)])
def test_ref_oracle_matches_reference_oracle(T, l):
    A, cand = random_tiles(77 + T + l, 3, T, 0.3, s_max=14)
    got = ref.clique_count_tiles_ref(*port(A, cand), l).numpy()
    exp = np.asarray(jref.clique_count_tiles_ref(
        jnp.asarray(A), jnp.asarray(cand), l)).astype(np.int64)
    np.testing.assert_array_equal(got, exp)
    if l >= 3:  # the DFS plain version agrees with the oracle too
        np.testing.assert_array_equal(
            got, clique_count.clique_count_tiles_torch(*port(A, cand),
                                                       l).numpy())


def test_edges_within_ref_matches_reference():
    A, cand = random_tiles(5, 8, 64, 0.3)
    np.testing.assert_array_equal(
        ref.edges_within_ref(*port(A, cand)).numpy(),
        np.asarray(jref.edges_within_ref(jnp.asarray(A), jnp.asarray(cand))
                   ).astype(np.int64))


def test_dfs_plain_work_counts():
    """The work tally the bound in chip_smoke.py reads: steps only where
    the DFS ran, close edges only where closes happened."""
    A, cand = random_tiles(9, 4, 32, 0.4, s_max=16)
    work = {}
    got = clique_count.clique_count_tiles_torch(*port(A, cand), 5, work=work)
    assert work["steps"][0] == 0 and work["close_edges"][0] == 0
    assert int(work["steps"].sum()) > 0
    assert (got > 0).any() and int(work["close_edges"].sum()) > 0


@pytest.mark.parametrize("method,l,kernel", [
    ("auto", 3, "triangle"), ("auto", 4, "dfs"), ("auto", 6, "dfs"),
    ("mxu", 3, "triangle"), ("dfs", 3, "dfs"), ("dfs", 5, "dfs"),
    ("ref", 4, "ref"), ("auto", 2, "ref"), ("dfs", 1, "ref"),
])
def test_count_tiles_routes_like_reference(monkeypatch, method, l, kernel):
    calls = []
    ref_oracle = ref.clique_count_tiles_ref
    monkeypatch.setattr(ops._tm, "triangle_count_tiles",
                        lambda A, c: calls.append("triangle") or
                        triangle_mm.triangle_count_tiles_torch(A, c))
    monkeypatch.setattr(ops._cc, "clique_count_tiles",
                        lambda A, c, ll: calls.append("dfs") or
                        clique_count.clique_count_tiles_torch(A, c, ll))
    monkeypatch.setattr(ops._ref, "clique_count_tiles_ref",
                        lambda A, c, ll: calls.append("ref") or
                        ref_oracle(A, c, ll))
    A, cand = random_tiles(3, 4, 32, 0.3, s_max=16)
    got = ops.count_tiles(*port(A, cand), l, method=method)
    assert calls == [kernel]
    np.testing.assert_array_equal(
        got.numpy(), jax_count(A, cand, l, "dfs" if method == "dfs"
                               else "auto"))


def test_count_tiles_rejects_bad_method_and_l():
    A, cand = port(*random_tiles(1, 2, 32, 0.3))
    with pytest.raises(ValueError):
        ops.count_tiles(A, cand, 4, method="mxu")
    with pytest.raises(ValueError):
        ops.count_tiles(A, cand, 3, method="pallas")
    with pytest.raises(ValueError):
        ops.count_tiles(A, cand, 0)
    # no cap on l: l = 17 and 18 (k = 19, 20) count as the reference does
    big = big_clique_tiles(17, 3, 32, (19, 18, 0), noise=0.03)
    for l in (17, 18):
        got = clique_count.clique_count_tiles(*port(*big), l).numpy()
        np.testing.assert_array_equal(got, jax_count(*big, l, "auto"))
        assert got.max() > 0


@pytest.mark.parametrize("wrapper", ["triangle", "dfs"])
def test_wrappers_check_inputs(wrapper):
    fn = (triangle_mm.triangle_count_tiles if wrapper == "triangle"
          else lambda A, c: clique_count.clique_count_tiles(A, c, 4))
    A, cand = port(*random_tiles(2, 4, 64, 0.3))
    with pytest.raises(TypeError):
        fn(A.to(torch.int64), cand)
    with pytest.raises(TypeError):
        fn(A, cand.to(torch.int64))
    with pytest.raises(ValueError):               # W != T // 32
        fn(A[:, :, :1].contiguous(), cand[:, :1].contiguous())
    with pytest.raises(ValueError):               # T not a bin
        fn(A[:, :48, :].contiguous(), cand)
    with pytest.raises(ValueError):               # cand batch mismatch
        fn(A, cand[:3].contiguous())
    with pytest.raises(ValueError):               # not contiguous
        fn(A.transpose(0, 1).contiguous().transpose(0, 1), cand)
    with pytest.raises(ValueError):               # (T, W) without batch
        fn(A[0], cand)


@pytest.mark.parametrize("T", [64, 128])
def test_offset_cpu_view_takes_plain_version(T):
    """A CPU view 4 bytes off a 16-byte boundary is refused on the card
    (the kernels load whole rows) but not here: the plain version reads
    it like any tensor, and counts as the reference does."""
    A_u32, cand_u32 = random_tiles(T + 3, 4, T, _DENSITY[T])
    A, cand = port(A_u32, cand_u32)
    off = torch.empty(A.numel() + 1, dtype=torch.int32)[1:].view(A.shape)
    off.copy_(A)
    assert off.data_ptr() % 16
    ops.reset_counts()
    got = triangle_mm.triangle_count_tiles(off, cand)
    assert ops.plain_counts()["triangle_count_tiles"] == 1
    np.testing.assert_array_equal(got.numpy(),
                                  jax_count(A_u32, cand_u32, 3, "mxu"))


def test_cpu_tensor_takes_plain_version_not_kernel():
    ops.reset_counts()
    A, cand = port(*random_tiles(4, 4, 32, 0.3, s_max=16))
    ops.count_tiles(A, cand, 3)
    ops.count_tiles(A, cand, 5)
    assert ops.launch_counts() == {"triangle_count_tiles": 0,
                                   "clique_count_tiles": 0,
                                   "clique_list_tiles": 0,
                                   "edge_candidates": 0}
    assert ops.plain_counts() == {"triangle_count_tiles": 1,
                                  "clique_count_tiles": 1,
                                  "clique_list_tiles": 0,
                                  "edge_candidates": 0}
    ops.reset_counts()
    assert ops.plain_counts() == {"triangle_count_tiles": 0,
                                  "clique_count_tiles": 0,
                                  "clique_list_tiles": 0,
                                  "edge_candidates": 0}
