"""Port front end vs the reference's: generators, truss decomposition,
tile tables, packed batches and spill tiles are array-equal.

Both packages get the same graphs (same generator seeds, or the same edge
arrays); every comparison is exact.
"""
import threading

import numpy as np
import pytest

from repro.core import pipeline as jpipe
from repro.core import truss as jtruss
from repro.data import graphs as jgraphs
from repro_torch.convert import plan_from_arrays
from repro_torch.core import graph as tgraph
from repro_torch.core import pipeline as tpipe
from repro_torch.core import tiles as ttiles
from repro_torch.core import truss as ttruss
from repro_torch.data import graphs as tgraphs

GRAPHS = {
    "er": ("erdos_renyi", (90, 0.15), {"seed": 1}),
    "rmat8": ("rmat_graph", (8,), {"edge_factor": 4, "seed": 7}),
    "planted": ("planted_cliques", (120, 4, 9), {"p_noise": 0.02,
                                                 "seed": 5}),
}


def both(name):
    fn, args, kw = GRAPHS[name]
    return (getattr(jgraphs, fn)(*args, **kw),
            getattr(tgraphs, fn)(*args, **kw))


def graphs_equal(a, b):
    return (a.n == b.n and np.array_equal(a.edges, b.edges)
            and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices))


def tiles_equal(a, b):
    return (tuple(a.anchor) == tuple(b.anchor)
            and np.array_equal(a.verts, b.verts)
            and a.rows == b.rows and a.nedges == b.nedges
            and a.colors == b.colors and a.edges_ranked == b.edges_ranked)


def assert_streams_equal(ref_items, got_items):
    assert len(ref_items) == len(got_items)
    for r, t in zip(ref_items, got_items):
        assert type(r).__name__ == type(t).__name__
        if hasattr(r, "A"):
            assert r.T == t.T
            for f in ("A", "cand", "sizes", "nedges", "anchors", "verts"):
                a, b = getattr(r, f), getattr(t, f)
                assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert tiles_equal(r, t)


@pytest.mark.parametrize("seed", [0, 3])
def test_generators_give_identical_edges(seed):
    pairs = [
        ("rmat_graph", (7,), {"edge_factor": 8, "seed": seed}),
        ("erdos_renyi", (60, 0.2), {"seed": seed}),
        ("powerlaw_graph", (80, 3), {"seed": seed}),
        ("planted_cliques", (70, 3, 8), {"p_noise": 0.05, "seed": seed}),
    ]
    for fn, args, kw in pairs:
        assert graphs_equal(getattr(jgraphs, fn)(*args, **kw),
                            getattr(tgraphs, fn)(*args, **kw)), fn


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_truss_decomposition_equal(name):
    jg, tg = both(name)
    a, b = jtruss.truss_decomposition(jg), ttruss.truss_decomposition(tg)
    for f in ("order", "rank", "support0", "peel_support", "trussness"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.tau == b.tau
    np.testing.assert_array_equal(jtruss.edge_supports(jg),
                                  ttruss.edge_supports(tg))


def test_graph_orderings_equal():
    from repro.core import graph as jgraph
    jg, tg = both("planted")
    (jo, jd), (to, td) = jgraph.degeneracy_order(jg), \
        tgraph.degeneracy_order(tg)
    np.testing.assert_array_equal(jo, to)
    assert jd == td
    (jc, jn), (tc, tn) = jgraph.greedy_coloring(jg), \
        tgraph.greedy_coloring(tg)
    np.testing.assert_array_equal(jc, tc)
    assert jn == tn
    np.testing.assert_array_equal(jgraph.color_vertex_order(jc),
                                  tgraph.color_vertex_order(tc))


@pytest.mark.parametrize("order", ["truss", "hybrid", "color"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_stream_batches_equal(order, name):
    jg, tg = both(name)
    jplan, tplan = jpipe.build_plan(jg, order), tpipe.build_plan(tg, order)
    for k in range(3, 8):
        assert_streams_equal(
            list(jpipe.stream_batches(jplan, k, order=order, batch_size=16)),
            list(tpipe.stream_batches(tplan, k, order=order, batch_size=16,
                                      pack_workers=2)))


@pytest.mark.parametrize("order", ["truss", "hybrid", "color"])
def test_spill_tiles_equal(order):
    """bins=(32,) pushes every tile wider than 32 out as a spill Tile."""
    jg = jgraphs.planted_cliques(160, 3, 40, p_noise=0.02, seed=2)
    tg = tgraphs.planted_cliques(160, 3, 40, p_noise=0.02, seed=2)
    ref = list(jpipe.stream_batches(jg, 5, order=order, bins=(32,)))
    got = list(tpipe.stream_batches(tg, 5, order=order, bins=(32,)))
    assert any(not hasattr(t, "A") for t in got)
    assert_streams_equal(ref, got)


@pytest.mark.parametrize("order", ["truss", "hybrid", "color"])
def test_iter_tiles_matches_python_oracle(order):
    _, tg = both("rmat8")
    for k in (4, 6):
        ref = list(ttiles.edge_tiles(tg, k, mode=order))
        got = list(tpipe.iter_tiles(tg, k, mode=order))
        assert len(ref) == len(got)
        assert all(tiles_equal(a, b) for a, b in zip(ref, got))


def plan_arrays(plan):
    """The reference plan as the flat arrays ``save_plan`` names."""
    out = {"graph/n": np.asarray(plan.g.n, np.int64),
           "graph/edges": plan.g.edges, "graph/indptr": plan.g.indptr,
           "graph/indices": plan.g.indices}
    if plan._td is not None:
        for f in ("order", "rank", "support0", "peel_support", "trussness"):
            out[f"truss_dec/{f}"] = getattr(plan._td, f)
        out["truss_dec/tau"] = np.asarray(plan._td.tau, np.int64)
    if plan._colors is not None:
        out["colors"] = plan._colors
    for family, tb in plan._tables.items():
        for f in ("edge_id", "anchors", "offsets", "verts", "thresh", "ekeys",
                  "erank", "member_colors", "ncolors", "rule1"):
            if getattr(tb, f) is not None:
                out[f"tables/{family}/{f}"] = getattr(tb, f)
    return out


@pytest.mark.parametrize("order", ["hybrid", "color"])
def test_plan_from_arrays_gives_identical_batches(order):
    jg, _ = both("planted")
    jplan = jpipe.build_plan(jg, order)
    tplan = plan_from_arrays(plan_arrays(jplan))
    assert tplan.table(order) is not None
    for k in (4, 6):
        assert_streams_equal(
            list(jpipe.stream_batches(jplan, k, order=order, batch_size=32)),
            list(tpipe.stream_batches(tplan, k, order=order, batch_size=32)))


def test_plan_key_and_cache_single_flight():
    _, tg = both("er")
    jg, _ = both("er")
    # the key is the reference's, so plans are keyed alike
    assert tpipe.plan_key(tg, "hybrid") == jpipe.plan_key(jg, "hybrid")
    assert tpipe.plan_key(tg, "truss") == tpipe.plan_key(tg, "hybrid")
    assert tpipe.plan_key(tg, "color") != tpipe.plan_key(tg, "hybrid")
    bigger = tgraph.from_edges(tg.n + 1, tg.edges)
    assert tpipe.plan_key(bigger) != tpipe.plan_key(tg)
    tpipe.clear_plan_cache()
    builds = []
    real = tpipe.build_plan

    def counting_build(g, order="hybrid"):
        builds.append(order)
        return real(g, order)

    tpipe.build_plan = counting_build
    try:
        plans = []
        threads = [threading.Thread(
            target=lambda: plans.append(tpipe.cached_plan(tg, "hybrid")))
            for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        tpipe.build_plan = real
        tpipe.clear_plan_cache()
    assert builds == ["hybrid"] and len(plans) == 6
    assert all(p is plans[0] for p in plans)
