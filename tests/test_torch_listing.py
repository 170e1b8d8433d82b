"""Port listing (list kernel's plain version, edge candidates, decode,
sinks, host relist, ``list_cliques``, CLI) vs the JAX reference.

Inputs are made with numpy from a seed and handed to both packages.  Every
comparison is exact (tolerance 0, ``np.array_equal``): buffers, counts,
flags and clique rows are integers, and rows are compared in order.  The
JAX side runs the compiled lax backend, which the reference suite holds
byte-identical to the Pallas kernels, plus one case of the Pallas kernels
themselves in interpret mode.  The CUDA kernels are tested on the card by
``test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ebbkc as jebbkc
from repro.core import engine_np as jengine_np
from repro.core import listing as jlisting
from repro.core import pipeline as jpipe
from repro.core import plex as jplex
from repro.core.bitops import pack_bits
from repro.core.engine_np import Stats as JStats
from repro.data import graphs as jgraphs
from repro.kernels import clique_list as jclique_list
from repro.kernels import intersect as jintersect
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import ebbkc, engine_np, listing, pipeline, plex
from repro_torch.core.engine_np import Stats
from repro_torch.data import graphs as tgraphs
from repro_torch.kernels import clique_list, intersect, ops
from repro_torch.launch import clique
from torch_cases import big_clique_tiles

BINS = (32, 64, 128, 256)


def cliquey_tiles(seed, B, T, s_max=20, p=0.7):
    """(B, T, W) uint32 symmetric tiles and (B, W) cands: each cand is up to
    ``s_max`` vertices scattered over all T slots (so every word is used),
    dense inside (p) and sparse outside it (edges the kernels must mask).
    Lane 0 has an empty cand over a non-empty A, lane 1 a cand holding
    bit 31 of every word."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((B, T, T), dtype=bool)
    cmask = np.zeros((B, T), dtype=bool)
    for b in range(B):
        n = int(rng.integers(0, s_max + 1))
        members = rng.choice(T, size=n, replace=False)
        if b == 1:
            members = np.unique(np.concatenate(
                [np.arange(31, T, 32), members]))[:s_max]
        cmask[b, members] = b != 0
        inside = rng.random((T, T)) < p
        noise = rng.random((T, T)) < 0.05
        both = cmask[b][:, None] & cmask[b][None, :]
        dense[b] = np.triu(np.where(both, inside, noise), 1)
    dense |= dense.transpose(0, 2, 1)
    if B > 0:
        dense[0] |= np.triu(rng.random((T, T)) < 0.5, 1)
        dense[0] |= dense[0].T
    return pack_bits(dense), pack_bits(cmask)


def port(A_u32, x_u32):
    return (torch.from_numpy(A_u32).view(torch.int32),
            torch.from_numpy(x_u32).view(torch.int32))


def jax_list(A, cand, l, cap):
    out = jops.list_tiles(jnp.asarray(A), jnp.asarray(cand), l, cap,
                          backend="lax")
    return tuple(np.asarray(x) for x in out)


def assert_triple_equal(got, want):
    buf, cnt, ovf = (x.numpy() for x in got)
    assert buf.dtype == np.int32 and buf.shape == want[0].shape
    np.testing.assert_array_equal(buf, want[0])          # zero padding too
    np.testing.assert_array_equal(cnt, want[1].astype(np.int64))
    np.testing.assert_array_equal(ovf, want[2].astype(np.int64))


# ---------------------------------------------------------------------------
# list kernel (plain version) and edge candidates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", BINS)
@pytest.mark.parametrize("l", [1, 2, 3, 4, 5, 6])
def test_list_plain_matches_lax_over_capacities(T, l):
    A, cand = cliquey_tiles(100 * l + T, 5, T, s_max=18 if l >= 5 else 22)
    counts = np.asarray(jops.count_tiles(jnp.asarray(A), jnp.asarray(cand),
                                         l, backend="lax")).astype(np.int64)
    assert counts.max() > 2, "the case must overflow small capacities"
    caps = sorted({1, 2, int(counts.max()) - 1,
                   listing.capacity_for(counts)})
    for cap in caps:
        got = clique_list.clique_list_tiles_torch(*port(A, cand), l, cap)
        assert_triple_equal(got, jax_list(A, cand, l, cap))
        np.testing.assert_array_equal(got[1].numpy(), counts)


@pytest.mark.parametrize("l", [1, 2, 3, 4, 5])
def test_list_plain_matches_pallas_kernel(l):
    A, cand = cliquey_tiles(7 + l, 4, 32, s_max=12)
    for cap in (3, 64):
        want = jclique_list.clique_list_tiles(jnp.asarray(A),
                                              jnp.asarray(cand), l, cap,
                                              interpret=True)
        got = clique_list.clique_list_tiles(*port(A, cand), l, cap)
        assert_triple_equal(got, tuple(np.asarray(x) for x in want))


@pytest.mark.parametrize("l", [1, 2, 3, 4, 5, 6])
def test_list_plain_at_smaller_capacity_is_truncation(l):
    """What chip_smoke.py's list cases rely on when one plain run serves
    several capacities: the result at capacity c is the result at a larger
    capacity cut to its first c rows, with the same count, overflow =
    count > c, and the same work tally."""
    A, cand = cliquey_tiles(100 * l + 64, 5, 64, s_max=18 if l >= 5 else 22)
    big_work = {}
    big = clique_list.clique_list_tiles_torch(*port(A, cand), l, 4096,
                                              work=big_work)
    assert int(big[1].max()) > 2 and not big[2].any()
    for cap in (1, 2, int(big[1].max()) - 1):
        work = {}
        buf, cnt, ovf = clique_list.clique_list_tiles_torch(
            *port(A, cand), l, cap, work=work)
        assert torch.equal(buf, big[0][:, :cap])
        assert torch.equal(cnt, big[1])
        assert torch.equal(ovf, (big[1] > cap).to(torch.int64))
        assert ovf.any()
        for key, v in big_work.items():
            assert torch.equal(work[key], v)


def test_list_plain_work_counts():
    """The work tally the bound in chip_smoke.py reads."""
    A, cand = cliquey_tiles(3, 4, 64, s_max=16)
    for l, keys in ((3, ("close_edges",)), (4, ("steps", "close_verts"))):
        work = {}
        clique_list.clique_list_tiles_torch(*port(A, cand), l, 8, work=work)
        for key in keys:
            assert work[key][0] == 0 and int(work[key].sum()) > 0


def test_list_wrapper_checks_inputs_and_counts_plain_calls():
    A, cand = port(*cliquey_tiles(5, 3, 32))
    with pytest.raises(ValueError):
        clique_list.clique_list_tiles(A, cand, 0, 4)
    # no cap on l: at l = 17 and 18 the triple (overflowing at capacity 4)
    # is the reference's, byte for byte
    big = big_clique_tiles(19, 3, 32, (19, 18, 0), noise=0.03)
    for l in (17, 18):
        got = clique_list.clique_list_tiles(*port(*big), l, 4)
        assert_triple_equal(got, jax_list(*big, l, 4))
        assert int(got[1].max()) > 0
    with pytest.raises(ValueError):
        clique_list.clique_list_tiles(A, cand, 3, 0)
    with pytest.raises(TypeError):
        clique_list.clique_list_tiles(A.to(torch.int64), cand, 3, 4)
    ops.reset_counts()
    ops.list_tiles(A, cand, 4, 4)
    assert ops.launch_counts()["clique_list_tiles"] == 0
    assert ops.plain_counts()["clique_list_tiles"] == 1
    ops.reset_counts()


@pytest.mark.parametrize("T", BINS)
def test_edge_candidates_plain_matches_reference(T):
    A, _ = cliquey_tiles(T + 1, 9, T, s_max=T, p=0.6)
    rng = np.random.default_rng(T)
    a = rng.integers(0, T - 1, 9)
    b = a + 1 + rng.integers(0, T - 1 - a)
    pairs = np.stack([a, b], 1).astype(np.int32)
    pairs[0] = (0, T - 1)
    cand, n = intersect.edge_candidates_torch(*port(A, pairs))
    want_c, want_n = jref.edge_candidates_ref(jnp.asarray(A),
                                              jnp.asarray(pairs))
    np.testing.assert_array_equal(cand.numpy().view(np.uint32), want_c)
    np.testing.assert_array_equal(n.numpy(), np.asarray(want_n, np.int64))
    if T <= 64:  # and the Pallas kernel itself, in interpret mode
        pc, pn = jintersect.edge_candidates(jnp.asarray(A),
                                            jnp.asarray(pairs),
                                            interpret=True)
        np.testing.assert_array_equal(cand.numpy().view(np.uint32), pc)
        np.testing.assert_array_equal(n.numpy(), np.asarray(pn, np.int64))
    ops.reset_counts()
    got = ops.edge_candidates(*port(A, pairs))
    assert torch.equal(got[0], cand) and torch.equal(got[1], n)
    assert ops.launch_counts()["edge_candidates"] == 0
    assert ops.plain_counts()["edge_candidates"] == 1
    ops.reset_counts()


def test_edge_candidates_checks_inputs():
    A, _ = port(*cliquey_tiles(1, 2, 32))
    pairs = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    with pytest.raises(TypeError):
        intersect.edge_candidates(A, pairs.to(torch.int64))
    with pytest.raises(ValueError):
        intersect.edge_candidates(A, pairs[:1])
    with pytest.raises(ValueError):
        intersect.edge_candidates(A, torch.tensor([[0, 32], [0, 1]],
                                                  dtype=torch.int32))
    with pytest.raises(ValueError):
        intersect.edge_candidates(A[:, :16].contiguous(), pairs)


# ---------------------------------------------------------------------------
# host helpers: list_rec_C, 2-plex / t-plex listing, decode, sinks
# ---------------------------------------------------------------------------


def _int_rows(A_tile, s):
    return [int.from_bytes(A_tile[i].astype("<u4").tobytes(), "little")
            for i in range(s)]


@pytest.mark.parametrize("seed", range(4))
def test_host_listing_helpers_match(seed):
    A, cand = cliquey_tiles(seed, 6, 32, s_max=14, p=0.85)
    for b in range(6):
        rows = _int_rows(A[b], 32)
        c = int.from_bytes(cand[b].astype("<u4").tobytes(), "little")
        for l in (2, 3, 4, 5):
            for et_t in (0, 3):
                got, want = [], []
                engine_np.list_rec_C(rows, c, l, (), got, et_t=et_t)
                jengine_np.list_rec_C(rows, c, l, (), want, et_t=et_t)
                assert got == want, (b, l, et_t)
            assert list(plex.list_tplex(rows, c, l)) == \
                list(jplex.list_tplex(rows, c, l))
    # a 2-plex: K8 minus a perfect matching on 6 of its vertices, plus 2
    # universal vertices
    rows = [(1 << 8) - 1 & ~(1 << v) for v in range(8)]
    for v, w in ((0, 1), (2, 3), (4, 5)):
        rows[v] &= ~(1 << w)
        rows[w] &= ~(1 << v)
    cand = (1 << 8) - 1
    assert plex.match_pairs(rows, 0b111111) == \
        jplex.match_pairs(rows, 0b111111)
    for l in range(1, 7):
        assert list(plex.list_2plex(rows, cand, l)) == \
            list(jplex.list_2plex(rows, cand, l))


def _both(n, n_cliques, size, p_noise, seed):
    """The same planted-clique graph, built by each package."""
    args = (n, n_cliques, size)
    kw = dict(p_noise=p_noise, seed=seed)
    return (tgraphs.planted_cliques(*args, **kw),
            jgraphs.planted_cliques(*args, **kw))


@pytest.fixture(scope="module")
def planted():
    """Three 11-cliques in noise: tiles of up to about 12 vertices."""
    return _both(90, 3, 11, 0.04, 5)


@pytest.fixture(scope="module")
def wide():
    """A 36-clique: tiles of 34+ vertices, in the T = 64 bin, or spilled
    to the host with ``bins=(32,)``."""
    return _both(70, 1, 36, 0.03, 9)


def test_decode_capacity_triple_and_sinks_match(planted, tmp_path):
    g, jg = planted
    k = 5
    batches = [b for b in pipeline.stream_batches(g, k, pack_workers=0)]
    jbatches = [b for b in jpipe.stream_batches(jg, k, pack_workers=0)]
    assert batches
    for counts in ([0], [1, 5, 100], [3, 70000]):
        assert listing.capacity_for(np.asarray(counts), 1 << 14) == \
            jlisting.capacity_for(np.asarray(counts), 1 << 14, "pow2")
    for batch, jbatch in zip(batches, jbatches):
        triple = listing.host_list_triple(batch, k - 2)
        jtriple = jlisting.host_list_triple(jbatch, k - 2)
        for x, y in zip(triple, jtriple):
            np.testing.assert_array_equal(x, y)
        # a capacity below the largest count: decode relists the
        # overflowed tiles on the host
        A, cand = port(batch.A, batch.cand)
        cap = max(1, int(triple[1].max()) // 2)
        bufs, cnt, ovf = (x.numpy() for x in
                          clique_list.clique_list_tiles(A, cand, k - 2, cap))
        st, jst = Stats(), JStats()
        got = listing.decode_batch(batch, bufs, cnt, ovf, k - 2, st)
        want = jlisting.decode_batch(jbatch, *jax_list(jbatch.A, jbatch.cand,
                                                       k - 2, cap),
                                     k - 2, jst)
        np.testing.assert_array_equal(got, want)
        assert st.overflowed_tiles == jst.overflowed_tiles > 0
    rows = np.arange(30, dtype=np.int64).reshape(6, 5)
    for make in (lambda m: m.ArraySink(5, max_out=4),
                 lambda m: m.NpzSink(str(tmp_path / f"{m.__name__}.npz"), 5,
                                     max_out=4)):
        sink, jsink = make(listing), make(jlisting)
        for s in (sink, jsink):
            assert s.emit(rows[:3]) == 3 and s.emit(rows[3:]) == 1
            assert s.full
            s.close()
        assert (sink.accepted, sink.bytes_written) == \
            (jsink.accepted, jsink.bytes_written)
        if isinstance(sink, listing.ArraySink):
            np.testing.assert_array_equal(sink.result(), jsink.result())
        else:
            np.testing.assert_array_equal(np.load(sink.path)["cliques"],
                                          np.load(jsink.path)["cliques"])
    seen = []
    cb = listing.CallbackSink(seen.append)
    assert cb.emit(rows[:0]) == 0 and cb.emit(rows) == 6 and len(seen) == 1


# ---------------------------------------------------------------------------
# list_cliques end to end (device="cpu") vs the reference
# ---------------------------------------------------------------------------


def _jax_rows(jg, k, order, max_out=None, **kw):
    rows, st = jebbkc.list_cliques(jg, k, order=order, max_out=max_out,
                                   backend="jax",
                                   engine_kwargs=dict(backend="lax", **kw))
    return rows, st


@pytest.mark.parametrize("order", ["truss", "hybrid", "color"])
def test_list_cliques_matches_reference(planted, order):
    g, jg = planted
    for k in range(3, 8):
        got, st = ebbkc.list_cliques(g, k, order=order, device="cpu")
        want, jst = _jax_rows(jg, k, order)
        assert got.dtype == np.int64 and got.shape == want.shape, (order, k)
        np.testing.assert_array_equal(got, want)
        assert st.emitted_cliques == jst.emitted_cliques == got.shape[0]
        assert st.backend == "torch:cpu"


@pytest.mark.parametrize("case", [
    dict(graph="planted", k=5, max_out=37),
    dict(graph="planted", k=6, engine_kwargs=dict(capacity=2)),
    dict(graph="planted", k=4, engine_kwargs=dict(max_capacity=4)),
    dict(graph="wide", k=4),
    dict(graph="wide", k=4, engine_kwargs=dict(bins=(32,))),
    dict(graph="wide", k=3, engine_kwargs=dict(bins=(32,), capacity=2)),
])
def test_list_cliques_overflow_spill_and_max_out_match(request, case):
    g, jg = request.getfixturevalue(case["graph"])
    k = case["k"]
    kw = case.get("engine_kwargs", {})
    got, st = ebbkc.list_cliques(g, k, max_out=case.get("max_out"),
                                 device="cpu", engine_kwargs=kw)
    want, jst = _jax_rows(jg, k, "hybrid", max_out=case.get("max_out"), **kw)
    np.testing.assert_array_equal(got, want)
    assert (st.overflowed_tiles, st.spilled_tiles) == \
        (jst.overflowed_tiles, jst.spilled_tiles)
    if "capacity" in kw or "max_capacity" in kw:
        assert st.overflowed_tiles > 0
    if "bins" in kw:
        assert st.spilled_tiles > 0


def test_list_cliques_host_backend_and_closed_forms(planted):
    g, jg = planted
    for k in (1, 2, 4):
        for max_out in (None, 5):
            got, _ = ebbkc.list_cliques(g, k, max_out=max_out,
                                        backend="host")
            want, _ = jebbkc.list_cliques(jg, k, max_out=max_out,
                                          backend="host")
            np.testing.assert_array_equal(got, want)


def test_listing_rejects_dispatcher_modes_and_missing_cuda(planted,
                                                           monkeypatch):
    """The dispatcher's modes now run (``devices=`` through the
    ListDispatcher; the string capacities fall back to exact sizing on
    the inline path) and give the inline rows; bad modes, k < 3 and CUDA
    without a card raise."""
    g, _ = planted
    base = listing.ArraySink(4)
    listing.stream_cliques(g, 4, base, device="cpu")
    for kwargs in (dict(devices=["cpu"]), dict(capacity="speculative"),
                   dict(capacity="sized"),
                   dict(devices=["cpu"], capacity="speculative")):
        got = listing.ArraySink(4)
        listing.stream_cliques(g, 4, got, device="cpu", **kwargs)
        np.testing.assert_array_equal(got.result(), base.result())
    sink = listing.ArraySink(4)
    with pytest.raises(ValueError):
        listing.stream_cliques(g, 4, sink, devices=["cpu"],
                               capacity="bogus")
    with pytest.raises(ValueError):
        listing.stream_cliques(g, 4, sink, capacity="bogus", device="cpu")
    with pytest.raises(ValueError):
        listing.stream_cliques(g, 2, sink, device="cpu")
    with pytest.raises(ValueError):
        ebbkc.list_cliques(g, 4, backend="jax")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        ebbkc.list_cliques(g, 4)
    for devices in (["cuda:0"], "all", 2):
        with pytest.raises(RuntimeError, match="CUDA"):
            listing.stream_cliques(g, 4, sink, devices=devices)


@pytest.mark.parametrize("argv", [
    ["--graph", "er:400,0.06", "--k", "5"],
    ["--graph", "er:60,0.3", "--k", "5"],
    ["--graph", "er:60,0.3", "--k", "4", "--max-out", "9"],
])
def test_cli_lists_and_verifies_on_cpu(capsys, tmp_path, argv):
    sink = tmp_path / "c.npz"
    rc = clique.main(argv + ["--list", "--device", "cpu", "--verify",
                             "--sink", str(sink)])
    out = capsys.readouterr().out
    assert rc == 0 and "match=True" in out
    k = int(argv[argv.index("--k") + 1])
    jg = jgraphs.erdos_renyi(*((400, 0.06) if "er:400" in argv[1]
                               else (60, 0.3)), seed=7)
    max_out = int(argv[-1]) if "--max-out" in argv else None
    want, _ = _jax_rows(jg, k, "hybrid", max_out=max_out)
    np.testing.assert_array_equal(np.load(sink)["cliques"], want)
