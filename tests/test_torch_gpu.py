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
from torch_cases import (WIDE_WIDTHS, big_clique_tiles, planted_clique_tiles,
                         structured_triangle_tiles, turan_graph_edges,
                         wide_tiles)

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
    # l > T: no tile of 32 vertices holds a 33-clique, so zeros and no launch
    before = ops.launch_counts()["clique_count_tiles"]
    zeros = clique_count.clique_count_tiles(A, cand, 33)
    assert zeros.shape == (4,) and zeros.device.type == "cuda"
    assert not zeros.any()
    assert not clique_count.clique_count_items(A, cand, 33).any()
    assert ops.launch_counts()["clique_count_tiles"] == before
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
    # l > T: the reference's empty triple, zero buffer of its shape, and
    # no launch
    before = ops.launch_counts()["clique_list_tiles"]
    buf, cnt, ovf = clique_list.clique_list_tiles(A, cand, 33, 4)
    assert buf.shape == (4, 4, 33) and buf.dtype == torch.int32
    assert buf.device.type == "cuda" and not buf.any()
    assert not cnt.any() and not ovf.any()
    assert ops.launch_counts()["clique_list_tiles"] == before
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


# ---------------------------------------------------------------------------
# multi-lane dispatch (repro_torch.runtime.dispatch) on the card
# ---------------------------------------------------------------------------

_CPU_ROWS = {}


def _list_rows(spec, k, **kwargs):
    from repro_torch.launch.clique import load_graph
    sink = listing.ArraySink(k)
    res = listing.stream_cliques(load_graph(spec), k, sink, **kwargs)
    return sink.result(), res.stats


def _cpu_rows(spec, k, capacity=None):
    """The inline CPU path's rows; a pinned int ``capacity`` relists the
    overflowed tiles on the host, whose row order within a tile differs
    from the kernel's, so it is held against the CPU at that capacity."""
    if (spec, k, capacity) not in _CPU_ROWS:
        _CPU_ROWS[(spec, k, capacity)] = _list_rows(
            spec, k, device="cpu", capacity=capacity)[0]
    return _CPU_ROWS[(spec, k, capacity)]


@pytest.mark.parametrize("k", [3, 4, 5, 6, 7])
@pytest.mark.parametrize("spec", ["rmat:10", "er:400,0.06"])
def test_list_dispatcher_rows_on_lanes_match_cpu(cuda, spec, k):
    """One and two lanes on one card, in each capacity mode (16 rows
    overflows dense tiles to the host relist): the CPU rows, in order."""
    for lanes in (["cuda:0"], ["cuda:0", "cuda:0"]):
        for capacity in (None, "speculative", 16):
            want = _cpu_rows(spec, k, capacity if capacity == 16 else None)
            ops.reset_counts()
            got, st = _list_rows(spec, k, devices=lanes, capacity=capacity)
            assert np.array_equal(got, want), (lanes, capacity)
            assert st.emitted_cliques == want.shape[0]
            assert (ops.launch_counts()["clique_list_tiles"] > 0) == (
                st.device_tiles != {})
            assert sum(ops.plain_counts().values()) == 0
            if len(lanes) == 2 and spec == "rmat:10":
                assert len(st.device_tiles) == 2  # both lanes took batches


@pytest.mark.parametrize("k", [3, 5, 6, 7])
def test_dispatcher_counts_on_lanes_match_host(cuda, k):
    from repro_torch.runtime import dispatch
    g = graphs.rmat_graph(10, edge_factor=8, seed=7)
    want = ebbkc.count(g, k, backend="host").count
    for lanes in (["cuda:0"], ["cuda:0"] * 2, ["cuda:0"] * 3):
        for staging in (True, False):
            res = engine_torch.count(g, k, devices=lanes,
                                     async_staging=staging)
            assert res.count == want, (lanes, staging)
            assert len(res.stats.device_tiles) == len(lanes)
    from repro_torch.core import pipeline
    batches = list(pipeline.stream_batches(g, k))
    assert all(isinstance(b, pipeline.TileBatch) for b in batches)  # no spill
    for mesh in (None, ["cuda:0"] * 2):
        total, _ = dispatch.dispatch_scheduled(batches, k - 2,
                                               ["cuda:0"] * 2, mesh=mesh)
        assert total == want, mesh


def test_two_lanes_run_kernels_on_two_streams(cuda, tmp_path):
    """A profiled two-lane count puts its DFS kernels on two distinct
    streams (the CUDA stream ids of the trace)."""
    import json
    from torch.profiler import ProfilerActivity, profile
    g = graphs.rmat_graph(10, edge_factor=8, seed=7)
    engine_torch.count(g, 6, devices=["cuda:0"])  # builds the library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = engine_torch.count(g, 6, devices=["cuda:0", "cuda:0"])
        torch.cuda.synchronize()
    assert res.count == ebbkc.count(g, 6, backend="host").count
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    streams = {e["args"]["stream"] for e in events
               if e.get("cat") == "kernel" and "item_kernel" in e["name"]}
    assert len(streams) >= 2, streams


def test_decode_worker_waits_for_each_copy_back(cuda):
    """A large pinned capacity and a one-batch window: each triple's copy
    back is long and the decode worker reads it right after the launch;
    the rows must still be the CPU's, run after run."""
    want = _cpu_rows("rmat:10", 6)
    for lanes in (["cuda:0"], ["cuda:0", "cuda:0"]):
        for _ in range(3):
            got, st = _list_rows("rmat:10", 6, devices=lanes,
                                 capacity=16384, max_inflight=1)
            assert np.array_equal(got, want), lanes
            assert st.overflowed_tiles == 0


@pytest.mark.parametrize("capacity", [None, "speculative"])
def test_injected_launch_faults_raise_on_card(cuda, capacity):
    """Every launch failing on a CUDA lane: the first batch is retried on
    the kernel under DEFAULT_POLICY and the fault raises; nothing runs the
    plain version or the host, and nothing is demoted."""
    from repro_torch.core import pipeline
    from repro_torch.core.engine_np import Stats
    from repro_torch.resilience import inject, retry
    from repro_torch.runtime import dispatch
    g = graphs.rmat_graph(9, edge_factor=16, seed=7)
    batch = next(b for b in pipeline.stream_batches(g, 5, pack_workers=0)
                 if isinstance(b, pipeline.TileBatch))
    attempts = retry.DEFAULT_POLICY.max_attempts
    for make in (lambda st: dispatch.Dispatcher(3, ["cuda:0"], stats=st),
                 lambda st: dispatch.ListDispatcher(
                     3, ["cuda:0"], sink=listing.ArraySink(5), stats=st,
                     capacity=capacity)):
        stats = Stats()
        disp = make(stats)
        ops.reset_counts()
        inject.configure("kernel.launch=1.0")
        try:
            with pytest.raises(inject.FaultInjected):
                disp.submit(batch)
        finally:
            inject.configure(None)
            if isinstance(disp, dispatch.ListDispatcher):
                disp.close()
        assert stats.retries == attempts - 1 and stats.demotions == 0
        assert sum(ops.launch_counts().values()) == 0
        assert sum(ops.plain_counts().values()) == 0


def _card(A, cand, device):
    return (torch.from_numpy(A).view(torch.int32).to(device),
            torch.from_numpy(cand).view(torch.int32).to(device))


def _planted_want(T, members, l, cap):
    """The exact outputs on planted-clique tiles: per-tile counts C(s, l),
    per-lowest-vertex counts, and the list triple at capacity ``cap``
    (the l-subsets of each clique in lexicographic order)."""
    from itertools import combinations, islice
    from math import comb
    B = len(members)
    counts = torch.tensor([comb(len(m), l) for m in members])
    per_v = torch.zeros((B, T), dtype=torch.int64)
    buf = torch.zeros((B, cap, l), dtype=torch.int32)
    for b, m in enumerate(members):
        for i, v in enumerate(m):
            per_v[b, v] = comb(len(m) - i - 1, l - 1)
        rows = list(islice(combinations(m, l), cap))
        if rows:
            buf[b, :len(rows)] = torch.tensor(rows, dtype=torch.int32)
    return counts, per_v, (buf, counts, (counts > cap).to(torch.int64))


# The DFS kernels' todo stack is dynamic shared memory sized by l: the
# count kernel's (l - 5) KB a 256-thread block, the list kernel's
# (l - 4) KB plus (l - 2) x 256 / W prefix words.  48 KB is the most a
# kernel gets without opting in: the count kernel holds l = 53 in it and
# opts in from l = 54; the list kernel holds l = 27 at T = 32 and l = 35 at
# T = 64, and opts in from 28 and 36.  Past the card's 227 KB a block (the
# count kernel from l = 233, the list kernel from l = 206 at T = 256) the
# block shrinks to 128 threads.
_LARGE_L = [(32, 17), (64, 17), (64, 53), (64, 54), (256, 233)]
_LARGE_L_LIST = [(32, 17), (64, 17), (32, 27), (32, 28), (64, 35), (64, 36),
                 (256, 206)]


@pytest.mark.parametrize("T,l", _LARGE_L)
def test_count_kernels_at_large_l(cuda, T, l):
    """Counts and per-branch counts at l > 16, on both sides of the 48 KB
    opt-in and past 227 KB, against the planted cliques' closed forms;
    at l = 17 and at the first opted-in l also against the plain version
    (on the CPU: its DFS takes minutes at l in the hundreds)."""
    A, cand, members = planted_clique_tiles(l, T, (l + 1, l, l - 1))
    counts, per_v, _ = _planted_want(T, members, l, 1)
    tA, tc = _card(A, cand, cuda)
    before = ops.launch_counts()["clique_count_tiles"]
    got = clique_count.clique_count_tiles(tA, tc, l)
    assert ops.launch_counts()["clique_count_tiles"] == before + 1
    assert torch.equal(got.cpu(), counts)
    assert torch.equal(clique_count.clique_count_items(tA, tc, l).cpu(), per_v)
    if l in (17, 54):
        cA, cc = _card(A, cand, "cpu")
        assert torch.equal(got.cpu(),
                           clique_count.clique_count_tiles_torch(cA, cc, l))


@pytest.mark.parametrize("T,l", _LARGE_L_LIST)
def test_list_kernel_at_large_l(cuda, T, l):
    """List triples at l > 16, on both sides of the 48 KB opt-in and past
    227 KB, against the planted cliques' rows; up to T = 64 also against
    the plain version on the CPU.  Capacity l cuts the (l + 1)-clique's
    tile short (overflow) and holds the l-clique's one row."""
    A, cand, members = planted_clique_tiles(l + 1, T, (l + 1, l, l - 1))
    _, _, want = _planted_want(T, members, l, l)
    tA, tc = _card(A, cand, cuda)
    before = ops.launch_counts()["clique_list_tiles"]
    got = clique_list.clique_list_tiles(tA, tc, l, l)
    assert ops.launch_counts()["clique_list_tiles"] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y), (T, l)
    if T <= 64:
        cA, cc = _card(A, cand, "cpu")
        for x, y in zip(got, clique_list.clique_list_tiles_torch(cA, cc, l,
                                                                 l)):
            assert torch.equal(x.cpu(), y), (T, l)


@pytest.mark.parametrize("T", [32, 64])
def test_dfs_kernels_at_l17_and_18_match_plain(cuda, T):
    """Noisy planted cliques (C(19, 17) = 171 17-cliques in the largest)
    at l = 17 and 18: count, items and list kernels against their plain
    versions on the card."""
    A, cand = _card(*big_clique_tiles(T, 4, T, (19, 18, 17, 0),
                                      noise=0.03), cuda)
    for l in (17, 18):
        want, _ = _assert_dfs_kernels_match(A, cand, l, caps=(1, 64, 256))
        assert int(want.max()) > 0


def _small_tiles(seed, B, T, s_max=10, p=0.5):
    """B tiles of at most ``s_max`` cand vertices: a short DFS each."""
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((B, T, T)) < p, 1)
    dense = upper | upper.transpose(0, 2, 1)
    cmask = np.arange(T)[None, :] < rng.integers(0, s_max + 1, B)[:, None]
    return (torch.from_numpy(pack_bits(dense)).view(torch.int32),
            torch.from_numpy(pack_bits(cmask)).view(torch.int32))


@pytest.mark.parametrize("B", [65_536, 70_000])
def test_batches_past_one_launch_match_cpu(cuda, B):
    """A batch of 2^16 tiles or more goes to the card in two launches of
    at most LAUNCH_TILES tiles; counts, per-branch counts and list triples
    equal the CPU's plain versions byte for byte."""
    A, cand = _small_tiles(B, B, 32)
    tA, tc = A.to(cuda), cand.to(cuda)
    assert clique_count.launch_chunks(B) == [
        (0, clique_count.LAUNCH_TILES), (clique_count.LAUNCH_TILES, B)]
    before = ops.launch_counts()
    got = clique_count.clique_count_tiles(tA, tc, 4)
    assert torch.equal(got.cpu(), clique_count.clique_count_tiles_torch(
        A, cand, 4))
    assert torch.equal(clique_count.clique_count_items(tA, tc, 4).cpu(),
                       clique_count.clique_count_items_torch(A, cand, 4))
    for x, y in zip(clique_list.clique_list_tiles(tA, tc, 4, 4),
                    clique_list.clique_list_tiles_torch(A, cand, 4, 4)):
        assert torch.equal(x.cpu(), y)
    after = ops.launch_counts()
    assert after["clique_count_tiles"] == before["clique_count_tiles"] + 2
    assert after["clique_list_tiles"] == before["clique_list_tiles"] + 2


def test_list_batch_past_the_per_x_budget(cuda):
    """At T = 256 one list launch takes PER_X_BYTES // (8 T^2) = 2,048
    tiles, so 2,053 tiles take two launches and equal the CPU's triple."""
    B, T = 2053, 256
    A, cand = _small_tiles(7, B, T, s_max=24, p=0.3)
    before = ops.launch_counts()["clique_list_tiles"]
    got = clique_list.clique_list_tiles(A.to(cuda), cand.to(cuda), 4, 16)
    assert ops.launch_counts()["clique_list_tiles"] == before + 2
    for x, y in zip(got, clique_list.clique_list_tiles_torch(A, cand, 4, 16)):
        assert torch.equal(x.cpu(), y)


# ---------------------------------------------------------------------------
# tile widths that are multiples of 32 but not powers of two (ROADMAP C3)
# ---------------------------------------------------------------------------

NEW_WIDTHS = (96, 160, 192, 224)
_NEW_DENSITY = {96: 0.13, 160: 0.09, 192: 0.08, 224: 0.07}


@pytest.mark.parametrize("T", NEW_WIDTHS)
def test_kernels_match_plain_at_new_widths(cuda, T):
    """All four kernels (and the per-branch count) at W = 3, 5, 6, 7
    against their plain versions, exactly, each launch counted."""
    A, cand = (x.to(cuda) for x in random_tiles(T + 5, 64, T,
                                                _NEW_DENSITY[T]))
    before = ops.launch_counts()
    rng = np.random.default_rng(T)
    a = rng.integers(0, T - 1, 64)
    pairs = torch.from_numpy(np.stack([a, a + 1 + rng.integers(0, T - 1 - a)],
                                      1).astype(np.int32)).to(cuda)
    _assert_triangle_and_edge_match(A, cand, pairs)
    for l in (1, 2, 3, 4, 5, 6):
        _assert_dfs_kernels_match(A, cand, l)
    A, cand = (x.to(cuda) for x in cliquey_tiles(T, 37, T, s_max=22))
    for l in (1, 2, 3, 4, 5):
        counts = clique_count.clique_count_tiles(A, cand, l).cpu().numpy()
        caps = sorted({1, max(1, int(counts.max()) - 1),
                       listing.capacity_for(counts)})
        _assert_dfs_kernels_match(A, cand, l, caps=caps)
    after = ops.launch_counts()
    assert after["triangle_count_tiles"] == before["triangle_count_tiles"] + 1
    assert after["edge_candidates"] == before["edge_candidates"] + 1
    assert after["clique_count_tiles"] > before["clique_count_tiles"]
    assert after["clique_list_tiles"] > before["clique_list_tiles"]


def test_row_alignment_at_new_widths_on_card(cuda):
    """W = 3 rows load word by word, so a view 4 bytes off a 16-byte
    boundary runs and equals the aligned tiles; W = 6 rows load by 8
    bytes, so the same offset raises before a launch.  T = 288 runs on
    the card and equals the plain version (it raised before ROADMAP C4
    was closed)."""
    def offset(x):
        odd = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:]
        return odd.view(x.shape).copy_(x)
    A, cand = (x.to(cuda) for x in random_tiles(3, 8, 96, 0.15))
    odd = offset(A)
    assert odd.data_ptr() % 16 == 4
    pairs = torch.tensor([[0, 5]] * 8, dtype=torch.int32, device=cuda)
    assert torch.equal(triangle_mm.triangle_count_tiles(odd, cand),
                       triangle_mm.triangle_count_tiles(A, cand))
    for l in (4, 5):
        assert torch.equal(clique_count.clique_count_tiles(odd, cand, l),
                           clique_count.clique_count_tiles_torch(A, cand, l))
    for x, y in zip(clique_list.clique_list_tiles(odd, cand, 4, 64),
                    clique_list.clique_list_tiles_torch(A, cand, 4, 64)):
        assert torch.equal(x, y)
    for x, y in zip(intersect.edge_candidates(odd, pairs),
                    intersect.edge_candidates_torch(A, pairs)):
        assert torch.equal(x, y)
    A6, c6 = (x.to(cuda) for x in random_tiles(6, 8, 192, 0.08))
    odd6 = offset(A6)
    before = ops.launch_counts()
    for call in (lambda: triangle_mm.triangle_count_tiles(odd6, c6),
                 lambda: clique_count.clique_count_tiles(odd6, c6, 4),
                 lambda: clique_count.clique_count_items(odd6, c6, 4),
                 lambda: clique_list.clique_list_tiles(odd6, c6, 4, 8),
                 lambda: intersect.edge_candidates(odd6, pairs)):
        with pytest.raises(ValueError, match="8-byte boundary"):
            call()
    assert ops.launch_counts() == before
    # T = 288 (W = 9, rows 4 bytes apart past a 16-byte start) counts on
    # the card as the plain version does (ROADMAP C4)
    A9, c9 = (torch.from_numpy(x).view(torch.int32).to(cuda)
              for x in big_clique_tiles(7, 3, 288, (8, 6, 7), noise=0.01))
    for l in (3, 4):
        got = ops.count_tiles(A9, c9, l)
        assert torch.equal(got, clique_count.clique_count_tiles_torch(
            A9, c9, l)) and int(got.max()) > 0
    assert ops.launch_counts() != before


@pytest.mark.parametrize("k", [5, 6, 7])
def test_new_width_ladders_on_card_match_cpu(cuda, k):
    """Counting and listing with ladders that pack every tile at a new
    width (the tiles of rmat_graph(10, 16) are at most 27 wide), and with
    the mult32 ladder, inline and through the dispatchers (whose staged
    batches keep W = 3 tiles aligned): the CPU's count (the card's pow2
    count at k = 7, held against the CPU elsewhere) and the CPU's rows."""
    from repro_torch.core import pipeline
    from repro_torch.tune import search
    g = graphs.rmat_graph(10, edge_factor=16, seed=7)
    want = engine_torch.count(g, k, device="cpu" if k < 7 else cuda).count
    cpu_rows = None
    if k < 7:
        sink = listing.ArraySink(k)
        listing.stream_cliques(g, k, sink, device="cpu")
        cpu_rows = np.sort(sink.result().view(
            [("", np.int64)] * k).ravel())
    ops.reset_counts()
    for bins in ((96,), (160, 256), (192,), (224,), search.bins_for("mult32")):
        widths = {b.T for b in pipeline.stream_batches(g, k, bins=bins)
                  if isinstance(b, pipeline.TileBatch)}
        assert widths and (widths <= set(NEW_WIDTHS)
                           or len(bins) > 2), (bins, widths)
        assert engine_torch.count(g, k, bins=bins).count == want, bins
        for lanes in (["cuda:0"], ["cuda:0"] * 2):
            assert engine_torch.count(g, k, bins=bins,
                                      devices=lanes).count == want
        if cpu_rows is None or bins not in ((96,), (224,)):
            continue
        for kw in ({}, {"devices": ["cuda:0"] * 2},
                   {"devices": ["cuda:0"], "capacity": "speculative"}
                   )[:3 if bins == (96,) else 2]:
            sink = listing.ArraySink(k)
            listing.stream_cliques(g, k, sink, bins=bins, **kw)
            got = np.sort(sink.result().view([("", np.int64)] * k).ravel())
            assert np.array_equal(got, cpu_rows), (bins, kw)
    assert sum(ops.plain_counts().values()) == 0


def test_backend_registry_on_card(cuda, tmp_path, monkeypatch):
    """``torch`` and ``ref`` raise on a CUDA tensor; ``autotune`` reports
    its winner and runs the kernel, even when the record says the plain
    version is faster."""
    from repro_torch import tune
    from repro_torch.tune import search
    monkeypatch.delenv(ops.BACKEND_ENV, raising=False)
    A, cand = (x.to(cuda) for x in random_tiles(9, 16, 32, 0.35))
    for backend in ("torch", "ref"):
        with pytest.raises(ValueError):
            ops.count_tiles(A, cand, 4, backend=backend)
        with pytest.raises(ValueError):
            ops.list_tiles(A, cand, 3, 16, backend=backend)
    tune.configure(str(tmp_path / "tc"), build_cache=False)
    tune.clear_memory()
    ops.clear_autotune_cache()
    try:
        tune.put(tune.TuningRecord(
            "backend", tune.device_kind(), tune.torch_version(), "count", 4,
            T=32, W=1, data={"winner": "torch"}))
        ops.reset_counts()
        got = ops.count_tiles(A, cand, 4, backend="autotune")
        assert ops.launch_counts()["clique_count_tiles"] == 1
        assert ops.plain_counts()["clique_count_tiles"] == 0
        assert torch.equal(got, clique_count.clique_count_tiles_torch(
            A, cand, 4))
        winner, times = search.microbench_backend("count", 4, 32)
        assert set(times) == {"cuda", "torch"} and winner in times
    finally:
        tune.configure(None)
        tune.clear_memory()
        tune.consume_events()
        ops.clear_autotune_cache()


# ---------------------------------------------------------------------------
# tiles wider than 256 (ROADMAP C4): the kernels' wide path
# ---------------------------------------------------------------------------


def _wide_pairs(T, B, device):
    rng = np.random.default_rng(T)
    a = rng.integers(0, T - 1, B)
    return torch.from_numpy(np.stack([a, a + 1 + rng.integers(0, T - 1 - a)],
                                     1).astype(np.int32)).to(device)


@pytest.mark.parametrize("T", WIDE_WIDTHS)
def test_kernels_match_plain_on_wide_tiles(cuda, T):
    """All four kernels (and the per-branch count) at W = 9, 16, 33 and 64
    on planted cliques under noise, against their plain versions on the
    card, byte for byte, each launch counted.  Lists at l = 3 stop at
    T = 1056: the plain version unpacks a (T, T, T) mask a tile."""
    A, cand = (torch.from_numpy(x).view(torch.int32).to(cuda)
               for x in wide_tiles(T))
    before = ops.launch_counts()
    _assert_triangle_and_edge_match(A, cand, _wide_pairs(T, 4, cuda))
    for l in (1, 2, 3, 4, 5):
        caps = () if l == 3 and T > 1056 else (1, 7, 512)
        want, _ = _assert_dfs_kernels_match(A, cand, l, caps=caps)
        assert int(want.min()) > 0, (T, l)
    after = ops.launch_counts()
    assert after["triangle_count_tiles"] == before["triangle_count_tiles"] + 1
    assert after["edge_candidates"] == before["edge_candidates"] + 1
    assert after["clique_count_tiles"] == before["clique_count_tiles"] + 5
    assert after["clique_list_tiles"] == before["clique_list_tiles"] + 15 - (
        3 if T > 1056 else 0)


def test_wide_launch_splits_and_large_l(cuda):
    """A wide batch past one launch's item budget goes in several
    launches; l = 40 on a 44-clique at T = 288 runs the wide DFS 36 levels
    deep (C(44, 40) = 135,751 rows), against the plain version."""
    from math import comb
    T = 1056
    B = clique_count.count_launch_tiles(T) + 3
    A, cand = (torch.from_numpy(x).view(torch.int32).to(cuda)
               for x in wide_tiles(T, B=B, seed=5))
    before = ops.launch_counts()["clique_count_tiles"]
    assert torch.equal(clique_count.clique_count_tiles(A, cand, 4),
                       clique_count.clique_count_tiles_torch(A, cand, 4))
    assert ops.launch_counts()["clique_count_tiles"] == before + 2
    A, cand, members = planted_clique_tiles(3, 288, (44, 41))
    A, cand = (torch.from_numpy(x).view(torch.int32).to(cuda)
               for x in (A, cand))
    got = clique_count.clique_count_tiles(A, cand, 40)
    assert got.tolist() == [comb(44, 40), comb(41, 40)]
    buf, cnt, ovf = clique_list.clique_list_tiles(A, cand, 40, comb(44, 40))
    assert cnt.tolist() == got.tolist() and ovf.tolist() == [0, 0]
    from itertools import combinations
    rows = np.asarray(list(combinations(members[1], 40)), dtype=np.int32)
    assert np.array_equal(buf[1, :len(rows)].cpu().numpy(), rows)
    assert int(buf[1, len(rows):].abs().sum()) == 0


@pytest.mark.parametrize("lanes", [["cuda:0"], ["cuda:0", "cuda:0"]])
def test_engines_with_a_bin_above_256_on_card(cuda, lanes):
    """The Turan graph of 88 parts of 3 packs its widest tiles (258
    vertices, 3-plexes the router leaves to the kernel) at T = 512 under
    bins (32, ..., 512): the 5-clique count equals C(88, 5) * 3^5 and the
    3-clique rows are every triangle once, on one lane and two."""
    from math import comb
    from repro_torch.core import pipeline
    from repro_torch.core.graph import from_edges
    g = from_edges(*turan_graph_edges(88, 3))
    bins = (32, 64, 128, 256, 512)
    ops.reset_counts()
    res = engine_torch.count(g, 5, bins=bins, devices=lanes)
    assert res.count == comb(88, 5) * 3 ** 5
    assert ops.launch_counts()["triangle_count_tiles"] > 0
    assert any(b.T == 512 for b in pipeline.stream_batches(g, 5, bins=bins)
               if isinstance(b, pipeline.TileBatch))
    sink = listing.ArraySink(3)
    listing.stream_cliques(g, 3, sink, bins=bins, devices=lanes)
    rows = sink.result()
    assert rows.shape == (comb(88, 3) * 27, 3)
    parts = rows // 3
    assert (parts[:, 0] != parts[:, 1]).all() and \
        (parts[:, 1] != parts[:, 2]).all() and \
        (parts[:, 0] != parts[:, 2]).all()
    assert len(np.unique(np.sort(rows, 1), axis=0)) == len(rows)
    assert sum(ops.plain_counts().values()) == 0


# ---------------------------------------------------------------------------
# dynamic graphs (repro_torch.delta) and the serving tier on the card
# ---------------------------------------------------------------------------


def _delta_batches(g, n_batches=3, seed=11):
    """Seeded batches of about 0.5 % churn: inserts of random pairs and
    deletes of present edges."""
    rng = np.random.default_rng(seed)
    n_pairs = max(2, g.m // 200)
    out = []
    for _ in range(n_batches):
        ins = rng.integers(0, g.n, (n_pairs, 2))
        dele = g.edges[rng.choice(g.m, n_pairs, replace=False)]
        out.append((ins, dele))
    return out


@pytest.mark.parametrize("lanes", [["cuda:0"], ["cuda:0", "cuda:0"]])
def test_delta_on_card_matches_cpu(cuda, lanes):
    """A PlanIndex on one and two lanes of the card and one on the CPU take
    the same batches: every per-batch and composed delta is byte-equal,
    the count probe agrees, and the card's reads ran the kernels only."""
    from repro_torch.delta import PlanIndex
    from repro_torch.delta.query import delta_net_count
    g = graphs.rmat_graph(9, 16, seed=7)
    card = PlanIndex(g, devices=lanes)
    cpu = PlanIndex(g, device="cpu")
    ops.reset_counts()
    for ins, dele in _delta_batches(g):
        card.apply_batch(insert=ins, delete=dele)
        cpu.apply_batch(insert=ins, delete=dele)
        rec, crec = card._records[-1], cpu._records[-1]
        for k in (4, 5):
            d = rec.delta(k, card.order, **card.query)
            assert d.gained.tobytes() == crec.delta(
                k, cpu.order, **cpu.query).gained.tobytes()
            net = delta_net_count(rec.old_plan, rec.new_plan, rec.info, k,
                                  engine_kwargs={"devices": lanes})
            assert net[2] == d.net
    for k in (4, 5):
        for since in (0, 1):
            a, b = card.delta(k, since), cpu.delta(k, since)
            assert a.gained.tobytes() == b.gained.tobytes()
            assert a.lost.tobytes() == b.lost.tobytes()
    launches = ops.launch_counts()
    assert launches["clique_list_tiles"] > 0
    assert launches["triangle_count_tiles"] > 0


@pytest.mark.parametrize("lanes", [["cuda:0"], ["cuda:0", "cuda:0"]])
def test_service_on_card_matches_cpu(cuda, lanes):
    """One CliqueService on one and two lanes of the card and one on a CPU
    lane take the same paused-then-resumed burst, an update and a delta
    read: every result is byte-identical, and the card's fused batches
    ran the kernels."""
    from repro_torch.serve import CliqueService
    g = graphs.rmat_graph(10, 16, seed=7)
    h = graphs.rmat_graph(8, 16, seed=7)
    specs = [("g", 5, "count", {}), ("g", 6, "count", {}),
             ("h", 7, "count", {}), ("g", 5, "list", {}),
             ("h", 5, "list", dict(vertex_filter=3)),
             ("g", 4, "list", dict(vertex_filter=9, max_out=50))]
    results = {}
    for tag, devices in (("card", lanes), ("cpu", ["cpu"])):
        svc = CliqueService(devices=devices, chunk_tiles=32, fuse_rows=128)
        svc.register_graph("g", g)
        svc.register_graph("h", h)
        try:
            if tag == "card":
                ops.reset_counts()
            svc.pause()
            tickets = [svc.submit(n, k, m, **kw) for n, k, m, kw in specs]
            svc.resume()
            out = [t.result(600) for t in tickets]
            ins, dele = _delta_batches(g, 1, seed=5)[0]
            svc.update_graph("g", insert=ins, delete=dele)
            out.append(svc.submit("g", 5, "delta", since_version=0)
                       .result(600))
            results[tag] = out
            if tag == "card":
                assert svc.stats.cross_request_batches > 0
                launches = ops.launch_counts()
                assert launches["clique_count_tiles"] > 0
                assert launches["clique_list_tiles"] > 0
                assert sum(ops.plain_counts().values()) == 0
        finally:
            svc.close()
    for got, want in zip(results["card"], results["cpu"]):
        assert got.kind == want.kind
        if got.kind == "count":
            assert got.count == want.count
        else:
            assert got.rows.tobytes() == want.rows.tobytes()
    assert results["card"][-1].rows.shape[0] > 0


# ---------------------------------------------------------------------------
# on-device truss and the dense-LM serving path (no kernel of their own:
# torch ops on the card, held against the host peeler / the CPU run)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph", ["rmat10", "powerlaw"])
def test_truss_on_card_matches_host(cuda, graph):
    from repro_torch.core.truss import truss_decomposition
    from repro_torch.core.truss_torch import truss_decomposition_torch
    g = (graphs.rmat_graph(10, 16, seed=7) if graph == "rmat10"
         else graphs.powerlaw_graph(2000, 12, seed=3))
    truss, tau = truss_decomposition_torch(g)
    td = truss_decomposition(g)
    assert tau == td.tau
    np.testing.assert_array_equal(truss, td.trussness)


@pytest.mark.parametrize("arch", ["granite-3-8b", "gemma3-27b"])
def test_reduced_transformer_on_card_matches_cpu(cuda, arch):
    """f32 (TF32 off), the same params on both: logits within rtol 1e-4 /
    atol 1e-4 (summation order of the card's GEMMs), greedy tokens equal."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tr
    cfg = dataclasses.replace(configs.get(arch).reduced, dtype=torch.float32)
    params, prompts = serve.make_inputs(cfg, 4, 24, "cpu", seed=1)
    on_card = {k: v.to(cuda) for k, v in params.items() if k != "groups"}
    on_card["groups"] = {kind: {n: w.to(cuda) for n, w in stack.items()}
                         for kind, stack in params["groups"].items()}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = serve.generate(params, prompts, cfg, 6)
        got = serve.generate(on_card, prompts.to(cuda), cfg, 6)
        logits = tr.forward(on_card, prompts.to(cuda), cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    np.testing.assert_allclose(got.prefill_logits.cpu().numpy(),
                               want.prefill_logits.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.decode_logits.cpu().numpy(),
                               want.decode_logits.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.cpu().numpy(),
                               tr.forward(params, prompts, cfg).numpy(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got.tokens.cpu(), want.tokens)


def test_service_twin_runs_on_card(cuda):
    """``examples/clique_service_torch.py`` with its default lanes (every
    CUDA device): exit 0, every request served with no deadline miss, and
    each answer equal to the twin's CPU run (``--device cpu``)."""
    import os
    import re
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))

    def run(*extra):
        out = subprocess.run(
            [sys.executable, str(root / "examples" / "clique_service_torch.py"),
             "--snapshots", "2", "--k", "4", *extra], env=env, cwd=root,
            capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        lines = out.stdout.strip().splitlines()
        # drop the "(per-vertex rate, latency)" group of each answer line
        answers = [re.sub(r" \([^)]*\)", "", ln) for ln in lines
                   if ln.startswith("[")]
        return lines, answers

    lines, card = run()
    assert "lanes: every CUDA device" in "\n".join(lines)
    assert lines[-1].startswith("served 6 requests"), lines
    assert lines[-1].endswith(" 0 deadline misses"), lines[-1]
    assert len(card) == 6
    assert card == run("--device", "cpu")[1]


def test_new_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """Runs without a card: with CUDA reported absent, the device truss and
    the serve launcher raise instead of moving to the CPU."""
    from repro_torch.core.truss_torch import truss_decomposition_torch
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        truss_decomposition_torch(graphs.rmat_graph(6, 4, seed=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "granite-3-8b", "--requests", "1",
                    "--tokens", "2"])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "dbrx-132b"])
def test_reduced_moe_on_card_matches_cpu(cuda, arch):
    """The MoE serving path, f32 with TF32 off, the same params on both:
    logits within rtol 1e-4 / atol 1e-4, greedy tokens equal."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tr
    cfg = dataclasses.replace(configs.get(arch).reduced, dtype=torch.float32)
    params, prompts = serve.make_inputs(cfg, 4, 24, "cpu", seed=1)
    on_card = {k: v.to(cuda) for k, v in params.items() if k != "groups"}
    on_card["groups"] = {kind: {n: w.to(cuda) for n, w in stack.items()}
                         for kind, stack in params["groups"].items()}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = serve.generate(params, prompts, cfg, 6)
        got = serve.generate(on_card, prompts.to(cuda), cfg, 6)
        logits = tr.forward(on_card, prompts.to(cuda), cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in ((got.prefill_logits, want.prefill_logits),
                 (got.decode_logits, want.decode_logits),
                 (logits, tr.forward(params, prompts, cfg))):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                   rtol=1e-4, atol=1e-4)
    assert torch.equal(got.tokens.cpu(), want.tokens)


def test_moe_routing_ties_and_combine_on_card(cuda):
    """On the card: tied router probabilities go to the lower expert id
    (the stable sort), the bf16 dispatch gives the same bits twice (a
    fixed combine order, no atomics), and the f32 dispatch (TF32 off)
    equals the CPU's within rtol 1e-4 / atol 1e-5."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import transformer as tr
    cfg = configs.get("deepseek-moe-16b").reduced
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    lp = {k: v[0] for k, v in
          tr.init_params(gen, cfg, cuda)["groups"]["global"].items()}
    x = torch.randn(256, cfg.d_model, generator=gen, device=cuda)
    router = lp["router"].clone()
    router[:, 1::2] = router[:, 0::2]
    _, idx = tr._route(x, router, cfg.moe.top_k)
    assert bool((idx[:, 0] % 2 == 0).all())
    assert bool((idx[:, 1] == idx[:, 0] + 1).all())
    xb = x.bfloat16()
    a = tr._moe_dispatch_local(xb, lp, cfg)
    b = tr._moe_dispatch_local(xb, lp, cfg)
    assert torch.equal(a, b)
    cpu = tr._moe_dispatch_local(
        x.cpu(), {k: v.cpu() for k, v in lp.items()},
        dataclasses.replace(cfg, dtype=torch.float32))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = tr._moe_dispatch_local(x, lp, cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    np.testing.assert_allclose(got.cpu().numpy(), cpu.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["granite-3-8b", "deepseek-moe-16b"])
def test_reduced_train_step_on_card_matches_cpu(cuda, arch):
    """``launch.steps``' train step (reduced config, f32, TF32 off), 3 steps
    on the card and on the CPU from the same params and batches: losses
    and params within rtol 1e-4 / atol 1e-4, ``count`` an int32 on the
    card."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.optim import adamw_init, tree_leaves
    spec = configs.get(arch)
    spec = dataclasses.replace(spec, reduced=dataclasses.replace(
        spec.reduced, dtype=torch.float32))
    ts = steps.lm_train_cell(spec, spec.cells["train_4k"], reduced=True)
    gen = torch.Generator()
    gen.manual_seed(1)
    cpu_p = tr.init_params(gen, ts.cfg, "cpu")
    card_p = {k: v.to(cuda) for k, v in cpu_p.items() if k != "groups"}
    card_p["groups"] = {kind: {n: w.to(cuda) for n, w in stack.items()}
                        for kind, stack in cpu_p["groups"].items()}
    cpu_o, card_o = adamw_init(cpu_p), adamw_init(card_p)
    pipe = LMDataPipeline(vocab=ts.cfg.vocab, batch=ts.batch,
                          seq_len=ts.seq_len)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for _ in range(3):
            batch = pipe.next_batch()
            cpu_p, cpu_o, cm = ts.step_fn(cpu_p, cpu_o, batch)
            card_p, card_o, gm = ts.step_fn(card_p, card_o, batch)
            np.testing.assert_allclose(float(gm["loss"]), float(cm["loss"]),
                                       rtol=1e-4, atol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p)):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().numpy(), rtol=1e-4, atol=1e-4)
    assert card_o["count"].dtype == torch.int32 and int(card_o["count"]) == 3


def test_train_launcher_resumes_bitwise_on_card(cuda, tmp_path):
    """``launch.train`` on the card: a run crashed at step 5 (checkpoints
    every 2) and resumed ends on the bits of an uninterrupted run."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch import train
    base = ["--arch", "deepseek-moe-16b", "--steps", "7"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert train.main(base + ["--ckpt-dir", a]) == 0
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        train.main(base + ["--ckpt-dir", b, "--ckpt-every", "2",
                           "--fail-at", "5"])
    assert train.main(base + ["--ckpt-dir", b, "--ckpt-every", "2"]) == 0
    want, got = restore_checkpoint(a), restore_checkpoint(b)
    assert want["step"] == got["step"] == 7
    for k, v in want["tree"].items():
        np.testing.assert_array_equal(got["tree"][k], v)


def test_train_twin_runs_on_card(cuda):
    """``examples/train_lm_torch.py`` with its default device (the card):
    exit 0 and the final loss below the first."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "examples" / "train_lm_torch.py"),
         "--steps", "60"], env=dict(os.environ, PYTHONPATH=str(root / "src")),
        cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-1]
    first = float(last.split("first loss ")[1].split(";")[0])
    assert float(last.split("loss=")[1].split(" ")[0]) < first
    assert "on cuda" in out.stdout


# ---------------------------------------------------------------------------
# the GNN, equivariant and recsys families
# ---------------------------------------------------------------------------

A13D = ("gin-tu", "meshgraphnet", "egnn", "nequip", "dcn-v2")


def _tree_to(tree, device):
    from repro_torch.optim import tree_leaves, tree_unflatten
    return tree_unflatten(tree, [x.detach().clone().to(device)
                                 for x in tree_leaves(tree)])


def _family_cell(arch):
    """(train step, params on the CPU, pipeline) of the arch's reduced
    first train cell, through ``launch.train.build``."""
    from repro_torch import configs
    from repro_torch.launch import train
    spec = configs.get(arch)
    shape = next(n for n, c in spec.cells.items() if c.kind == "train")
    return train.build(spec, shape, True, "cpu")


@pytest.mark.parametrize("arch", A13D)
def test_reduced_family_step_on_card_matches_cpu(cuda, arch):
    """3 train steps of the reduced cell (f32, TF32 off) on the card and
    on the CPU from the same params and batches: losses and params
    within rtol 1e-4 / atol 1e-4."""
    from repro_torch.optim import adamw_init, tree_leaves
    step, cpu_p, pipe = _family_cell(arch)
    card_p = _tree_to(cpu_p, cuda)
    cpu_o, card_o = adamw_init(cpu_p), adamw_init(card_p)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for _ in range(3):
            batch = pipe.next_batch()
            cpu_p, cpu_o, cm = step(cpu_p, cpu_o, batch)
            card_p, card_o, gm = step(card_p, card_o, batch)
            np.testing.assert_allclose(float(gm["loss"]), float(cm["loss"]),
                                       rtol=1e-4, atol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(tree_leaves(card_p), tree_leaves(cpu_p)):
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", A13D)
def test_family_step_repeats_bitwise_on_card(cuda, arch):
    """One step from the same state twice on the card: the segment sums,
    the gathers' and the table's grads add in a fixed order, so params,
    moments and loss are equal bit for bit."""
    from repro_torch.optim import adamw_init, tree_leaves
    step, cpu_p, pipe = _family_cell(arch)
    batch = pipe.next_batch()
    runs = []
    for _ in range(2):
        p = _tree_to(cpu_p, cuda)
        p, o, m = step(p, adamw_init(p), batch)
        runs.append((tree_leaves((p, o)), m))
    (a, ma), (b, mb) = runs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(ma["loss"], mb["loss"])


def test_segment_ops_on_card_match_cpu(cuda):
    """The scatters (out-of-range ids dropped, empty segments), the
    gather's and propagate's grads on the card equal the CPU's within
    1e-6, and two runs of a grad on the card are equal bit for bit."""
    from repro_torch.models import gnn
    from repro_torch.models.scatter import (edge_index, gather_rows,
                                            propagate)
    rng = np.random.default_rng(0)
    N, E = 500, 20_000
    msg = torch.from_numpy(rng.normal(size=(E, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-3, N + 3, E))
    for op in (gnn.scatter_sum, gnn.scatter_mean, gnn.scatter_max):
        want = op(msg, ids, N)
        got = op(msg.to(cuda), ids.to(cuda), N).cpu()
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        np.testing.assert_allclose(got[fin].numpy(), want[fin].numpy(),
                                   rtol=1e-5, atol=1e-6)
    edges = torch.from_numpy(rng.integers(0, N, (2, E)))
    h = torch.from_numpy(rng.normal(size=(N, 8)).astype(np.float32))
    w = torch.from_numpy((rng.random(E) < 0.9).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda, cuda):
        ei = edge_index(edges.to(dev), N)
        x = h.to(dev).requires_grad_(True)
        out = propagate(x, w.to(dev).index_select(0, ei.perm), ei) \
            + gather_rows(x, ei.src, ei.by_src)[:N]
        grads.setdefault(str(dev), []).append(
            torch.autograd.grad((out * out).sum(), [x])[0].cpu())
    np.testing.assert_allclose(grads["cuda"][0].numpy(),
                               grads["cpu"][0].numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(grads["cuda"][0], grads["cuda"][1])


def test_retrieval_ties_on_card(cuda):
    """Tied scores come out lower index first on the card, as on the CPU."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.launch.train import drawn_params
    spec = configs.get("dcn-v2")
    mc = steps.recsys_cell(spec, spec.cells["retrieval_cand"], reduced=True)
    gen = torch.Generator()
    gen.manual_seed(3)
    params = drawn_params(mc.init, gen, "cpu")
    rng = np.random.default_rng(4)
    base = rng.normal(size=(7, 32)).astype(np.float32)
    cand = base[rng.integers(0, 7, 4096)]
    dense = rng.normal(size=(1, 13)).astype(np.float32)
    sparse = rng.integers(0, 1000, (1, 26, 1)).astype(np.int32)
    want = mc.step_fn(params, dense, sparse, cand)
    got = mc.step_fn(_tree_to(params, cuda), dense, sparse, cand)
    assert torch.equal(got[1].cpu(), want[1])
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_gnn_twin_runs_on_card(cuda):
    """``examples/gnn_clique_features_torch.py`` on the card: the list
    kernel lists the clique features, equal to the host recursion's, and
    the GIN passes the accuracy bar."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "gnn_clique_features_torch",
        root / "examples" / "gnn_clique_features_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    before = ops.launch_counts()["clique_list_tiles"]
    out = mod.main(["--steps", "200"])
    assert ops.launch_counts()["clique_list_tiles"] > before
    assert out["acc"] > 0.9
    np.testing.assert_array_equal(
        out["features"], mod.clique_features(out["graph"], backend="host"))


# ---------------------------------------------------------------------------
# sharding on one card (A13e-1)
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_mesh(cuda):
    """A 1-rank NCCL mesh (1, 1) on the card; the group is torn down
    after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    assert not dist.is_initialized()
    mesh = make_local_mesh((1, 1))
    yield mesh
    dist.destroy_process_group()


def test_make_local_mesh_on_card(nccl_mesh):
    import torch.distributed as dist
    from repro_torch.sharding import spmd
    assert nccl_mesh.device_type == "cuda"
    assert dist.get_backend() == "nccl"
    assert spmd.mesh_sizes(nccl_mesh) == {"data": 1, "model": 1}
    x = torch.arange(6., device="cuda").reshape(3, 2)
    assert torch.equal(spmd.psum(x, ("data", "model"), nccl_mesh), x)
    assert torch.equal(spmd.all_gather_rows(x, ("data",), nccl_mesh), x)
    assert torch.equal(spmd.reduce_scatter_rows(x, ("model",), nccl_mesh),
                       x)


@pytest.mark.parametrize("T", [32, 64, 128])
def test_clique_cell_on_nccl_mesh_equals_count_packed(nccl_mesh, T):
    """``clique_cell`` on the 1-rank NCCL mesh runs the triangle kernel
    and equals the unsharded ``count_packed`` on the same tiles: nv, t,
    f bitwise, the f32 total the exact sum of the per-tile counts."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.sharding import spmd
    spec = configs.get("ebbkc")
    cell_shape = dataclasses.replace(spec.cells["ep_tri_1m"],
                                     dims=dict(n_tiles=2048, T=T, l=3))
    cell = steps.clique_cell(spec, cell_shape, nccl_mesh)
    A, cand = (x.cuda() for x in random_tiles(T, 2048, T, _DENSITY[T]))
    ts, cs = cell.in_specs
    ops.reset_counts()
    total, nv, t, f = cell.step_fn(spmd.shard(A, ts, nccl_mesh),
                                   spmd.shard(cand, cs, nccl_mesh))
    assert ops.launch_counts()["triangle_count_tiles"] > 0
    hard, nv_u, t_u, f_u = engine_torch.count_packed(A, cand, 3,
                                                     method="mxu")
    for a, b in ((nv, nv_u), (t, t_u), (f, f_u)):
        assert torch.equal(a, b)
    assert float(total) == int(hard.sum())


# ---------------------------------------------------------------------------
# the transformer's sharding on one card (A13e-2)
# ---------------------------------------------------------------------------

LM_ONE_RANK = [(a, s) for a in ("granite-3-8b", "deepseek-moe-16b")
               for s in ("train_4k", "prefill_32k", "decode_32k")]


@pytest.mark.parametrize("arch,shape", LM_ONE_RANK,
                         ids=[f"{a}-{s}" for a, s in LM_ONE_RANK])
def test_lm_cells_on_nccl_mesh_equal_unsharded(nccl_mesh, arch, shape):
    """The reduced LM cells on the 1-rank NCCL mesh against the same
    cells without a mesh, on the card and the same seeded arguments:
    equal to the bit (world-1 collectives are copies, and the
    vocab-parallel log-sum-exp does ATen's ``logsumexp`` arithmetic)."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.optim import tree_leaves, tree_unflatten
    from repro_torch.sharding import spmd
    spec = configs.get(arch)
    cell = steps.build_cell(spec, shape, nccl_mesh, reduced=True)
    plain = steps.build_cell(spec, shape, None, reduced=True)
    rng = np.random.default_rng(len(arch) + len(shape))
    abstract = list(plain.abstract_args)
    vals = [torch.from_numpy(rng.integers(0, 2, x.shape) if not
                             x.is_floating_point() else
                             np.abs(rng.normal(size=x.shape) * 0.02))
            .to(x.dtype).cuda() for x in tree_leaves(abstract)]

    def args():
        return tree_unflatten(abstract, [v.clone() for v in vals])
    got = cell.step_fn(*spmd.shard_tree(args(), cell.in_specs, nccl_mesh))
    want = plain.step_fn(*args())
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.is_cuda and torch.equal(a, b)
