"""The port's CUDA kernels on the card (marker ``gpu``; each test skips
without a CUDA device, since a CUDA kernel has no CPU mode).

This file imports neither jax nor ``repro``, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain torch version on the same inputs,
with exact equality (tolerance 0): counts, candidate words and listed
local ids are integers, and the list buffers are compared whole, zero
padding included.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ebbkc, engine_torch, listing
from repro_torch.core.bitops import pack_bits
from repro_torch.data import graphs
from repro_torch.kernels import (clique_count, clique_list, intersect, ops,
                                 triangle_mm)
from torch_cases import structured_triangle_tiles

pytestmark = pytest.mark.gpu

BINS = (32, 64, 128, 256)
_DENSITY = {32: 0.35, 64: 0.2, 128: 0.12, 256: 0.06}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def random_tiles(seed, B, T, p):
    """Symmetric tiles; lane 0 has an empty cand over a non-empty A (as
    the 2-plex router leaves it), lane 1 a full cand (bit 31 set in every
    word), odd lanes cands with holes."""
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((B, T, T)) < p, 1)
    dense = upper | upper.transpose(0, 2, 1)
    cmask = np.arange(T)[None, :] < rng.integers(0, 49, B)[:, None]
    cmask &= ~((rng.random((B, T)) < 0.2) & (np.arange(B)[:, None] % 2 == 1))
    cmask[0] = False
    cmask[1] = True
    keep = np.arange(T) % 3 == 0
    dense[1] &= keep[:, None] & keep[None, :]
    return (torch.from_numpy(pack_bits(dense)).view(torch.int32),
            torch.from_numpy(pack_bits(cmask)).view(torch.int32))


@pytest.mark.parametrize("T", BINS)
def test_kernels_match_plain_on_card(cuda, T):
    A, cand = (x.to(cuda) for x in random_tiles(T + 5, 64, T, _DENSITY[T]))
    before = ops.launch_counts()
    got = triangle_mm.triangle_count_tiles(A, cand)
    assert torch.equal(got, triangle_mm.triangle_count_tiles_torch(A, cand))
    for l in (1, 2, 3, 4, 5, 6):
        got = clique_count.clique_count_tiles(A, cand, l)
        assert torch.equal(got,
                           clique_count.clique_count_tiles_torch(A, cand, l))
        assert torch.equal(clique_count.clique_count_items(A, cand, l),
                           clique_count.clique_count_items_torch(A, cand, l))
    after = ops.launch_counts()
    assert after["triangle_count_tiles"] == before["triangle_count_tiles"] + 1
    assert after["clique_count_tiles"] == before["clique_count_tiles"] + 6


def structured_tiles(case, T):
    """:func:`torch_cases.structured_triangle_tiles` as int32 tensors."""
    return tuple(torch.from_numpy(x).view(torch.int32)
                 for x in structured_triangle_tiles(case, T))


def _assert_triangle_and_edge_match(A, cand, pairs):
    """Triangle kernel and edge_candidates against their plain versions,
    exactly, with int64 counts."""
    got = triangle_mm.triangle_count_tiles(A, cand)
    assert got.dtype == torch.int64 and got.device.type == "cuda"
    assert torch.equal(got, triangle_mm.triangle_count_tiles_torch(A, cand))
    cand_e, n = intersect.edge_candidates(A, pairs)
    assert n.dtype == torch.int64 and n.device.type == "cuda"
    want = intersect.edge_candidates_torch(A, pairs)
    assert torch.equal(cand_e, want[0]) and torch.equal(n, want[1])
    return got


@pytest.mark.parametrize("T", BINS)
@pytest.mark.parametrize("case", ["complete", "heavy_row", "empty_cand"])
def test_triangle_and_edge_kernels_on_structured_tiles(cuda, case, T):
    from math import comb
    A, cand = (x.to(cuda) for x in structured_tiles(case, T))
    pairs = torch.tensor([[0, 1]], dtype=torch.int32, device=cuda)
    got = _assert_triangle_and_edge_match(A, cand, pairs)
    if case != "heavy_row":
        assert int(got[0]) == (comb(T, 3) if case == "complete" else 0)


@pytest.mark.parametrize("B", [1, 7, 257])
@pytest.mark.parametrize("T", BINS)
def test_triangle_and_edge_kernels_at_batch_sizes(cuda, B, T):
    A, cand = random_tiles(7 * B + T, max(B, 2), T, _DENSITY[T])
    A, cand = A[:B].contiguous(), cand[:B].contiguous()
    for i, case in enumerate(("complete", "heavy_row", "empty_cand")):
        if B > 2 + i:  # structured tiles among random ones, the last
            A[B - 1 - i], cand[B - 1 - i] = (x[0] for x in structured_tiles(
                case, T))
    rng = np.random.default_rng(B + T)
    a = rng.integers(0, T - 1, B)
    b = a + 1 + rng.integers(0, T - 1 - a)
    pairs = torch.from_numpy(np.stack([a, b], 1).astype(np.int32))
    _assert_triangle_and_edge_match(A.to(cuda), cand.to(cuda),
                                    pairs.to(cuda))


@pytest.mark.parametrize("T", BINS)
def test_edge_candidates_on_pairs_of_every_vertex(cuda, T):
    """Every vertex paired with the next and with the last: every word and
    every bit of gt(b) in play."""
    A, _ = cliquey_tiles(T + 1, 2 * T - 2, T, s_max=T, p=0.6)
    a = np.concatenate([np.arange(T - 1), np.arange(T - 1)])
    b = np.concatenate([np.arange(1, T), np.full(T - 1, T - 1)])
    pairs = torch.from_numpy(np.stack([a, b], 1).astype(np.int32)).to(cuda)
    A = A.to(cuda)
    got = intersect.edge_candidates(A, pairs)
    want = intersect.edge_candidates_torch(A, pairs)
    assert got[1].dtype == torch.int64
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_triangle_wrapper_is_one_launch(cuda):
    """One wrapper call is one kernel on the card: the launch counter and
    the profiler's device kernels agree, and no torch op follows."""
    from torch.profiler import ProfilerActivity, profile
    A, cand = (x.to(cuda) for x in random_tiles(3, 256, 32, 0.35))
    triangle_mm.triangle_count_tiles(A, cand)  # builds the library
    torch.cuda.synchronize()
    before = ops.launch_counts()["triangle_count_tiles"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            triangle_mm.triangle_count_tiles(A, cand)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert ops.launch_counts()["triangle_count_tiles"] == before + 3
    assert len(kernels) == 3 and all("tri_" in k for k in kernels), kernels


def test_kernel_wrappers_reject_bad_input_on_card(cuda):
    A, cand = (x.to(cuda) for x in random_tiles(1, 4, 32, 0.3))
    with pytest.raises(TypeError):
        triangle_mm.triangle_count_tiles(A.to(torch.int64), cand)
    with pytest.raises(ValueError):
        clique_count.clique_count_tiles(A, cand.cpu(), 4)
    with pytest.raises(ValueError):
        clique_count.clique_count_tiles(A, cand, clique_count.L_MAX + 1)
    empty = clique_count.clique_count_tiles(A[:0], cand[:0], 4)
    assert empty.shape == (0,) and empty.device.type == "cuda"
    # an int32 view 4 bytes off a 16-byte boundary: the row loads would
    # fault on the card, so the wrappers raise first
    A, cand = (x.to(cuda) for x in random_tiles(2, 4, 128, 0.1))
    odd = torch.empty(A.numel() + 1, dtype=torch.int32, device=cuda)[1:]
    odd = odd.view(A.shape).copy_(A)
    with pytest.raises(ValueError):
        triangle_mm.triangle_count_tiles(odd, cand)
    with pytest.raises(ValueError):
        clique_count.clique_count_tiles(odd, cand, 4)
    with pytest.raises(ValueError):
        clique_count.clique_count_items(odd, cand, 4)


@pytest.mark.parametrize("k", [3, 4, 5, 6, 7])
def test_engine_on_card_matches_cpu_and_host(cuda, k):
    g = graphs.planted_cliques(300, 6, 14, p_noise=0.03, seed=11)
    ops.reset_counts()
    got = engine_torch.count(g, k, device=cuda).count
    assert got == engine_torch.count(g, k, device="cpu").count
    assert got == ebbkc.count(g, k, backend="host").count
    if k >= 5:
        assert sum(ops.launch_counts().values()) > 0


def cliquey_tiles(seed, B, T, s_max=20, p=0.7):
    """Tiles whose cands are up to ``s_max`` vertices scattered over all T
    slots, dense inside and sparse outside; lane 0 has an empty cand over
    a non-empty A, lane 1 holds bit 31 of every word."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((B, T, T), dtype=bool)
    cmask = np.zeros((B, T), dtype=bool)
    for b in range(B):
        members = rng.choice(T, size=int(rng.integers(0, s_max + 1)),
                             replace=False)
        if b == 1:
            members = np.unique(np.concatenate(
                [np.arange(31, T, 32), members]))[:s_max]
        cmask[b, members] = b != 0
        both = cmask[b][:, None] & cmask[b][None, :]
        dense[b] = np.triu(np.where(both, rng.random((T, T)) < p,
                                    rng.random((T, T)) < 0.05), 1)
    dense[0] |= np.triu(rng.random((T, T)) < 0.5, 1)
    dense |= dense.transpose(0, 2, 1)
    return (torch.from_numpy(pack_bits(dense)).view(torch.int32),
            torch.from_numpy(pack_bits(cmask)).view(torch.int32))


@pytest.mark.parametrize("T", BINS)
@pytest.mark.parametrize("l", [1, 2, 3, 4, 5, 6])
def test_list_kernel_matches_plain_on_card(cuda, T, l):
    A, cand = (x.to(cuda) for x in cliquey_tiles(100 * l + T, 37, T,
                                                s_max=18 if l >= 5 else 24))
    counts = clique_count.clique_count_tiles(A, cand, l).cpu().numpy()
    before = ops.launch_counts()["clique_list_tiles"]
    caps = sorted({1, max(1, int(counts.max()) - 1),
                   listing.capacity_for(counts)})
    for cap in caps:
        got = clique_list.clique_list_tiles(A, cand, l, cap)
        want = clique_list.clique_list_tiles_torch(A, cand, l, cap)
        for x, y in zip(got, want):
            assert x.device.type == "cuda" and torch.equal(x, y), (T, l, cap)
        assert np.array_equal(got[1].cpu().numpy(), counts)
    assert ops.launch_counts()["clique_list_tiles"] == before + len(caps)


@pytest.mark.parametrize("T", BINS)
def test_edge_candidates_match_plain_on_card(cuda, T):
    A, _ = cliquey_tiles(T, 75, T, s_max=T, p=0.6)
    rng = np.random.default_rng(T)
    a = rng.integers(0, T - 1, 75)
    b = a + 1 + rng.integers(0, T - 1 - a)
    pairs = torch.from_numpy(np.stack([a, b], 1).astype(np.int32))
    A, pairs = A.to(cuda), pairs.to(cuda)
    before = ops.launch_counts()["edge_candidates"]
    got = intersect.edge_candidates(A, pairs)
    want = intersect.edge_candidates_torch(A, pairs)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert ops.launch_counts()["edge_candidates"] == before + 1


def test_list_wrappers_reject_bad_input_on_card(cuda):
    A, cand = (x.to(cuda) for x in cliquey_tiles(1, 4, 32))
    with pytest.raises(ValueError):
        clique_list.clique_list_tiles(A, cand, clique_list.L_MAX + 1, 4)
    with pytest.raises(ValueError):
        clique_list.clique_list_tiles(A, cand, 4, 0)
    with pytest.raises(ValueError):
        intersect.edge_candidates(A, torch.full((4, 2), 32, dtype=torch.int32,
                                                device=cuda))
    odd = torch.zeros(9, dtype=torch.int32, device=cuda)[1:].view(4, 2)
    with pytest.raises(ValueError):               # pairs not 8-byte aligned
        intersect.edge_candidates(A, odd)
    A, cand = (x.to(cuda) for x in cliquey_tiles(2, 4, 64))
    off = torch.empty(A.numel() + 1, dtype=torch.int32, device=cuda)[1:]
    off = off.view(A.shape).copy_(A)              # A not 8-byte aligned
    with pytest.raises(ValueError):
        clique_list.clique_list_tiles(off, cand, 4, 8)
    with pytest.raises(ValueError):
        intersect.edge_candidates(off, torch.tensor(
            [[0, 1]] * 4, dtype=torch.int32, device=cuda))
    buf, cnt, ovf = clique_list.clique_list_tiles(A[:0], cand[:0], 4, 8)
    assert buf.shape == (0, 8, 4) and cnt.shape == ovf.shape == (0,)


@pytest.mark.parametrize("k", [3, 4, 5, 6, 7])
def test_list_cliques_on_card_matches_cpu_and_host(cuda, k):
    g = graphs.planted_cliques(300, 6, 14, p_noise=0.03, seed=11)
    ops.reset_counts()
    got, st = ebbkc.list_cliques(g, k, device=cuda)
    assert np.array_equal(got, ebbkc.list_cliques(g, k, device="cpu")[0])
    host, _ = ebbkc.list_cliques(g, k, backend="host")
    assert sorted(map(tuple, got.tolist())) == sorted(map(tuple,
                                                          host.tolist()))
    assert ops.launch_counts()["clique_list_tiles"] > 0
    small, st = ebbkc.list_cliques(g, k, device=cuda,
                                   engine_kwargs=dict(capacity=2))
    assert np.array_equal(small, got) and st.overflowed_tiles > 0


def _assert_dfs_kernels_match(A, cand, l, caps=()):
    """Count kernel, item pass and list kernel (at each capacity) against
    their plain versions, exactly."""
    want = clique_count.clique_count_tiles_torch(A, cand, l)
    assert torch.equal(clique_count.clique_count_tiles(A, cand, l), want)
    items = clique_count.clique_count_items(A, cand, l)
    assert torch.equal(items, clique_count.clique_count_items_torch(A, cand,
                                                                    l))
    assert torch.equal(items.sum(-1) & 0xFFFFFFFF, want)
    for cap in caps:
        got = clique_list.clique_list_tiles(A, cand, l, cap)
        ref = clique_list.clique_list_tiles_torch(A, cand, l, cap)
        for x, y in zip(got, ref):
            assert torch.equal(x, y), (A.shape, l, cap)
    return want, items


@pytest.mark.parametrize("T", BINS)
def test_one_dense_tile_among_empty_ones(cuda, T):
    A, cand = (x.to(cuda) for x in cliquey_tiles(T + 3, 4, T, s_max=20,
                                                p=0.8))
    heavy = int(clique_count.clique_count_tiles_torch(A, cand, 4).argmax())
    A2 = torch.zeros((256, T, T // 32), dtype=torch.int32, device=cuda)
    c2 = torch.zeros((256, T // 32), dtype=torch.int32, device=cuda)
    A2[200], c2[200] = A[heavy], cand[heavy]
    want, _ = _assert_dfs_kernels_match(A2, c2, 4, caps=(1, 7, 50_000))
    assert int(want[200]) > 0 and int(want.sum()) == int(want[200])


@pytest.mark.parametrize("T", BINS)
def test_every_cand_zero(cuda, T):
    A, cand = (x.to(cuda) for x in cliquey_tiles(T, 33, T))
    zero = torch.zeros_like(cand)
    for l in (1, 4, 6):
        want, items = _assert_dfs_kernels_match(A, zero, l, caps=(1, 3))
        assert not want.any() and not items.any()


@pytest.mark.parametrize("B", [1, 5, 257, 1024])
@pytest.mark.parametrize("T", BINS)
def test_batch_sizes_across_the_persistent_grid(cuda, B, T):
    A, cand = (x[:B].to(cuda) for x in random_tiles(B + T, max(B, 2), T,
                                                    _DENSITY[T]))
    want = clique_count.clique_count_tiles_torch(A, cand, 5)
    cap = listing.capacity_for(want.cpu().numpy())
    _assert_dfs_kernels_match(A, cand, 5, caps=(cap,))


@pytest.mark.parametrize("l", [6, 7, 8])
def test_deep_cliques_on_dense_wide_tiles(cuda, l):
    A, cand = (x.to(cuda) for x in cliquey_tiles(l, 12, 256, s_max=24,
                                                p=0.85))
    want = clique_count.clique_count_tiles_torch(A, cand, l)
    assert int(want.max()) > 1000
    _assert_dfs_kernels_match(A, cand, l,
                              caps=(listing.capacity_for(
                                  want.cpu().numpy()),))


@pytest.mark.parametrize("T", BINS)
def test_list_capacity_cuts_inside_item_blocks(cuda, T):
    A, cand = (x.to(cuda) for x in cliquey_tiles(7 * T, 16, T, s_max=20,
                                                p=0.8))
    items = clique_count.clique_count_items_torch(A, cand, 5)
    nz = items[items > 0]
    first = items[torch.arange(items.shape[0]), (items > 0).int().argmax(-1)]
    # a capacity below the first item's count, one that ends inside the
    # second item's block, and 1
    b = int(first.argmax())
    row = items[b][items[b] > 0]
    caps = {1, max(1, int(first.max()) - 1)}
    if row.numel() > 1:
        caps.add(int(row[0]) + max(1, int(row[1]) // 2))
    assert nz.numel() > 0
    _assert_dfs_kernels_match(A, cand, 5, caps=sorted(caps))
