"""repro_torch.delta held against repro.delta on the CPU.

The port's copies of ``apply_edge_batch``, ``edge_subset_supports``,
``touched_edge_ids``, the truss repair and the table splice are the
reference's numpy code, so every array they produce is compared with the
reference's on the same seeded graphs and batches; the delta queries run
the port's device engines on the CPU (``device="cpu"``, the plain torch
versions) and their rows are compared with the reference's host
recursion.  Every comparison is exact (tolerance 0): plans are integer
arrays, counts are integers and rows are compared byte for byte.  The
card runs the same paths in ``test_torch_gpu.py`` and ``chip_smoke.py``
``[delta]``.
"""
import numpy as np
import pytest

from repro.core import ebbkc as jebbkc
from repro.core import graph as jgraph
from repro.core import pipeline as jpipeline
from repro.core import truss as jtruss
from repro import delta as jdelta
from repro.delta import query as jquery
from repro.delta import repair as jrepair
from repro_torch.core import ebbkc, pipeline
from repro_torch.core.engine_np import Stats
from repro_torch.core.graph import Graph, apply_edge_batch, from_edges
from repro_torch.core.truss import edge_subset_supports, edge_supports
from repro_torch.delta import (CHURN_THRESHOLD, PlanIndex, delta_cliques,
                               repair_plan)
from repro_torch.delta.query import (_sorted_diffs, delta_net_count,
                                     rows_diff, rows_sorted, rows_union)
from repro_torch.delta.repair import touched_edge_ids

CPU = dict(device="cpu")
TABLE_FIELDS = ("edge_id", "anchors", "offsets", "verts", "thresh", "ekeys",
                "erank")


def rand_graph(n: int, m: int, seed: int) -> Graph:
    rng = np.random.default_rng(seed)
    return from_edges(n, rng.integers(0, n, size=(m, 2)))


def ref_graph(g: Graph):
    """The same edge set as a reference graph."""
    return jgraph.from_edges(g.n, g.edges)


def mutate(g: Graph, seed: int, n_ins: int = 4, n_del: int = 3):
    """One random batch: fresh pairs in, a sample of current edges out;
    returns (new graph, insert pairs, delete pairs)."""
    rng = np.random.default_rng(seed)
    ins = rng.integers(0, g.n, (n_ins, 2)) if n_ins else None
    dele = g.edges[rng.choice(g.m, min(g.m, n_del), replace=False)] \
        if n_del and g.m else None
    return apply_edge_batch(g, insert=ins, delete=dele), ins, dele


def host_rows(g: Graph, k: int) -> np.ndarray:
    """Every k-clique of ``g`` by the reference's host recursion."""
    rows, _ = jebbkc.list_cliques(ref_graph(g), k)
    return rows_sorted(rows)


def assert_tables_equal(a, b, where=""):
    for f in TABLE_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), (where, f)


# -- apply_edge_batch (the mutable-graph seam) ------------------------------

def test_apply_edge_batch_semantics():
    g = from_edges(6, np.array([[0, 1], [1, 2], [0, 2], [3, 4]]))
    jg = ref_graph(g)
    # insert dedups/canonicalizes; self loops dropped; n preserved
    ins = [(2, 0), (4, 3), (2, 3), (5, 5)]
    g2 = apply_edge_batch(g, insert=ins)
    assert g2.n == g.n and g2.m == g.m + 1
    jg2 = jgraph.apply_edge_batch(jg, insert=ins)
    for f in ("edges", "indptr", "indices"):
        assert np.array_equal(getattr(g2, f), getattr(jg2, f)), f
    # delete is exact; deleting an absent edge is a no-op
    g3 = apply_edge_batch(g2, delete=[(3, 2), (0, 5)])
    assert np.array_equal(g3.edges, g.edges)
    # insert wins when a pair appears in both lists (delete-then-insert)
    g4 = apply_edge_batch(g, insert=[(0, 1)], delete=[(1, 0)])
    assert np.array_equal(g4.edges, g.edges)
    # idempotent
    g5 = apply_edge_batch(g4, insert=[(0, 1)])
    assert np.array_equal(g5.edges, g4.edges)
    # validation: endpoints must be inside [0, n)
    with pytest.raises(ValueError):
        apply_edge_batch(g, insert=[(0, 6)])
    with pytest.raises(ValueError):
        apply_edge_batch(g, delete=[(-1, 0)])
    # empty batch is the identity
    assert np.array_equal(apply_edge_batch(g).edges, g.edges)
    # a seeded batch gives the reference's canonical graph
    for seed in range(3):
        h, i, d = mutate(rand_graph(20, 60, seed), seed + 7)
        jh = jgraph.apply_edge_batch(ref_graph(rand_graph(20, 60, seed)),
                                     insert=i, delete=d)
        assert np.array_equal(h.edges, jh.edges)
        assert np.array_equal(h.indptr, jh.indptr)


def test_edge_subset_supports_matches_full():
    for seed in range(4):
        g = rand_graph(20, 70, seed)
        full = edge_supports(g)
        eids = np.sort(np.random.default_rng(seed).choice(
            g.m, size=g.m // 2, replace=False))
        got = edge_subset_supports(g, eids)
        assert np.array_equal(got, full[eids])
        assert np.array_equal(got, jtruss.edge_subset_supports(
            ref_graph(g), eids))
        assert np.array_equal(
            edge_subset_supports(g, np.arange(g.m)), full)


# -- repair_plan: equivalence, fallback, accounting -------------------------

@pytest.mark.parametrize("order", ["truss", "hybrid"])
def test_repair_matches_from_scratch(order):
    stats = Stats()
    for seed in range(5):
        g = rand_graph(22, 80, seed)
        plan = pipeline.build_plan(g, order)
        g2, _, _ = mutate(g, seed + 50)
        plan2, info = repair_plan(plan, g2, order, churn_threshold=1.1,
                                  stats=stats)
        assert not info.rebuilt and stats.plan_repairs == seed + 1
        assert stats.plan_repair_s > 0
        # the reference's repair of the same batch: the same touched sets
        # and the same spliced table
        jplan = jpipeline.build_plan(ref_graph(g), order)
        jplan2, jinfo = jrepair.repair_plan(jplan, ref_graph(g2), order,
                                            churn_threshold=1.1)
        assert np.array_equal(info.touched_old, jinfo.touched_old)
        assert np.array_equal(info.touched_new, jinfo.touched_new)
        assert_tables_equal(plan2._tables["truss"], jplan2._tables["truss"],
                            seed)
        scratch = pipeline.build_plan(g2, order)
        for k in (3, 4, 5):
            assert ebbkc.count(g2, k, plan=plan2, **CPU).count == \
                ebbkc.count(g2, k, plan=scratch, **CPU).count, (seed, k)
            a, _ = ebbkc.list_cliques(g2, k, order=order, plan=plan2, **CPU)
            b, _ = ebbkc.list_cliques(g2, k, order=order, plan=scratch,
                                      **CPU)
            assert np.array_equal(rows_sorted(a), rows_sorted(b)), (seed, k)
    # across the sweep, at least one batch touched a real neighborhood
    assert stats.delta_touched_edges > 0


def test_splice_is_array_identical_to_full_build():
    """The spliced table equals a full build under the repaired
    decomposition field for field, in both packages, and the repaired
    decomposition's ranks are the reference's."""
    for seed in range(5):
        g = rand_graph(24, 90, seed)
        plan = pipeline.build_plan(g, "truss")
        g2, _, _ = mutate(g, seed + 9)
        plan2, info = repair_plan(plan, g2, "truss", churn_threshold=1.1)
        assert not info.rebuilt
        full = pipeline._build_truss_table(g2, plan2._td)
        tab = plan2._tables["truss"]
        assert_tables_equal(tab, full, seed)
        jtd = jrepair.repair_truss(
            ref_graph(g), jpipeline.build_plan(ref_graph(g), "truss")._td,
            ref_graph(g2), recompute=info.touched_new)
        assert np.array_equal(plan2._td.rank, jtd.rank)
        assert_tables_equal(tab, jpipeline._build_truss_table(
            ref_graph(g2), jtd), seed)
        # the touched set of the batch's pairs is the reference's
        batch = np.setxor1d(g.edge_keys(), g2.edge_keys())
        assert np.array_equal(touched_edge_ids(g2, batch),
                              jrepair.touched_edge_ids(ref_graph(g2), batch))


def test_churn_threshold_falls_back_to_rebuild():
    g = rand_graph(20, 60, 1)
    plan = pipeline.build_plan(g, "hybrid")
    g2 = apply_edge_batch(
        g, insert=np.random.default_rng(99).integers(0, 20, (40, 2)))
    stats = Stats()
    plan2, info = repair_plan(plan, g2, "hybrid", churn_threshold=0.05,
                              stats=stats)
    assert info.rebuilt and info.churn > 0.05
    assert stats.plan_rebuilds == 1 and stats.plan_build_s > 0
    assert stats.plan_repairs == 0
    assert ebbkc.count(g2, 4, plan=plan2, **CPU).count == \
        ebbkc.count(g2, 4, **CPU).count
    # the default threshold is the reference's and the color family
    # always rebuilds
    assert 0 < CHURN_THRESHOLD == jdelta.CHURN_THRESHOLD < 1
    cplan = pipeline.build_plan(g, "color")
    _, cinfo = repair_plan(cplan, g2, "color", churn_threshold=1.1)
    assert cinfo.rebuilt


def test_repair_stats_merge_tripwire():
    """The delta Stats fields are merge-registered (the _MERGE_KINDS
    tripwire), as in the reference."""
    a, b = Stats(), Stats()
    a.plan_repairs, a.plan_rebuilds = 2, 1
    a.plan_repair_s, a.delta_touched_edges = 0.5, 40
    b.plan_repairs, b.delta_touched_edges = 1, 2
    a.merge(b)
    assert (a.plan_repairs, a.plan_rebuilds, a.delta_touched_edges) == \
        (3, 1, 42)
    assert a.plan_repair_s == 0.5
    for f in ("plan_repairs", "plan_rebuilds", "plan_repair_s",
              "delta_touched_edges"):
        assert Stats._MERGE_KINDS[f] == jdelta.index.Stats._MERGE_KINDS[f]


def test_repair_rejects_vertex_set_change():
    g = rand_graph(10, 20, 0)
    plan = pipeline.build_plan(g, "hybrid")
    bigger = from_edges(12, g.edges)
    with pytest.raises(ValueError):
        repair_plan(plan, bigger, "hybrid")


# -- clique deltas ----------------------------------------------------------

def test_delta_cliques_exact_per_batch():
    """The port's deltas (plain torch versions on the CPU) are byte equal
    to the reference's host deltas, and to the snapshot diff."""
    for seed in range(4):
        g = rand_graph(20, 75, seed)
        plan = pipeline.build_plan(g, "hybrid")
        g2, _, _ = mutate(g, seed + 31)
        plan2, info = repair_plan(plan, g2, "hybrid", churn_threshold=1.1)
        jplan = jpipeline.build_plan(ref_graph(g), "hybrid")
        jplan2, jinfo = jrepair.repair_plan(jplan, ref_graph(g2), "hybrid",
                                            churn_threshold=1.1)
        for k in (3, 4):
            d = delta_cliques(plan, plan2, info, k, **CPU)
            jd = jquery.delta_cliques(jplan, jplan2, jinfo, k,
                                      backend="host")
            assert d.gained.tobytes() == jd.gained.tobytes()
            assert d.lost.tobytes() == jd.lost.tobytes()
            a, b = host_rows(g, k), host_rows(g2, k)
            assert np.array_equal(d.gained, rows_sorted(rows_diff(b, a)))
            assert np.array_equal(d.lost, rows_sorted(rows_diff(a, b)))
            assert d.net == b.shape[0] - a.shape[0]
            # the count probe agrees, on the port's engines and the host
            for kw in (CPU, dict(backend="host")):
                _, _, net = delta_net_count(plan, plan2, info, k, **kw)
                assert net == d.net
    with pytest.raises(ValueError):
        delta_cliques(plan, plan2, info, 2, **CPU)
    # the default is the CUDA device, which raises without one
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            delta_cliques(plan, plan2, info, 3)


def test_rows_set_algebra():
    a = np.array([[0, 1, 2], [1, 2, 3], [2, 3, 4]], dtype=np.int64)
    b = np.array([[1, 2, 3], [5, 6, 7]], dtype=np.int64)
    assert np.array_equal(rows_diff(a, b), a[[0, 2]])
    # rows matched by packed int64 keys, and rows too wide to pack (ids
    # near 2**40 in 5 columns), give the reference's differences
    rng = np.random.default_rng(4)
    for hi in (50, 1 << 40):
        x = np.sort(rng.integers(0, hi, (400, 5)), axis=1)
        y = np.concatenate([x[::3], np.sort(rng.integers(0, hi, (50, 5)),
                                            axis=1)])
        assert np.array_equal(rows_diff(x, y), jquery.rows_diff(x, y))
        assert np.array_equal(rows_diff(y, x), jquery.rows_diff(y, x))
    assert rows_union(a, b).shape[0] == 4
    assert np.array_equal(rows_union(a, b), jquery.rows_union(a, b))
    empty = np.zeros((0, 3), dtype=np.int64)
    assert np.array_equal(rows_diff(a, empty), a)
    assert rows_diff(empty, a).shape == (0, 3)
    assert np.array_equal(rows_union(empty, b), rows_sorted(b))



@pytest.mark.parametrize("hi", [50, 4096, 1 << 40])
def test_sorted_diffs_equal_reference_diff_then_sort(hi):
    """``delta_cliques``' set differences (sorted keys, rows decoded from
    them) equal the reference's ``rows_sorted(rows_diff(...))`` both ways,
    byte for byte: rows that pack into int64 keys (ids below 50 and 4096)
    and rows too wide to pack (ids near 2**40 in 5 columns), a side empty
    too."""
    rng = np.random.default_rng(hi % 997)
    x = np.unique(np.sort(rng.integers(0, hi, (600, 5)), axis=1), axis=0)
    rng.shuffle(x)
    y = np.concatenate([x[::3], np.sort(rng.integers(0, hi, (80, 5)),
                                        axis=1)])
    y = y[rng.permutation(y.shape[0])]
    empty = np.zeros((0, 5), dtype=np.int64)
    for a, b in ((x, y), (y, x), (x, empty), (empty, y), (empty, empty)):
        got = _sorted_diffs(a, b)
        want = (jquery.rows_sorted(jquery.rows_diff(a, b)),
                jquery.rows_sorted(jquery.rows_diff(b, a)))
        for g_rows, w_rows in zip(got, want):
            assert g_rows.dtype == w_rows.dtype == np.int64
            assert g_rows.tobytes() == w_rows.tobytes()


# -- PlanIndex: versioning, composition, lineage ----------------------------

def _batches(n, b):
    return (np.random.default_rng(200 + b).integers(0, n, (3, 2)),
            np.random.default_rng(300 + b))


def test_plan_index_versions_and_composed_deltas():
    """Versions, composed deltas and the subscription read of the port's
    index equal the reference index's on the same batches."""
    g = rand_graph(24, 85, 7)
    idx = PlanIndex(g, "hybrid", churn_threshold=1.1, history=8, **CPU)
    jidx = jdelta.PlanIndex(ref_graph(g), "hybrid", churn_threshold=1.1,
                            history=8)
    assert idx.version == 0 and idx.oldest_version() == 0
    snaps = {0: g}
    for b in range(5):
        ins, rng = _batches(24, b)
        dele = idx.graph.edges[rng.choice(idx.graph.m, 2, replace=False)]
        v = idx.apply_batch(insert=ins, delete=dele)
        assert v == b + 1 == jidx.apply_batch(insert=ins, delete=dele)
        assert idx.plan_key == jidx.plan_key
        snaps[v] = idx.graph
    # warm queries after mutation: the repaired plan is the cached plan
    s = Stats()
    assert pipeline.cached_plan(idx.graph, "hybrid", stats=s) is idx.plan
    assert s.plan_cache_hit
    # composed deltas equal the reference's and the snapshot diffs
    for since in range(6):
        for k in (3, 4):
            d = idx.delta(k, since)
            jd = jidx.delta(k, since)
            assert d.gained.tobytes() == jd.gained.tobytes()
            assert d.lost.tobytes() == jd.lost.tobytes()
            a, b_ = host_rows(snaps[since], k), host_rows(idx.graph, k)
            assert np.array_equal(d.gained, rows_sorted(rows_diff(b_, a)))
            assert np.array_equal(d.lost, rows_sorted(rows_diff(a, b_)))
    # the subscription read composes the vertex filter
    full = idx.delta(3, 0).gained
    assert full.shape[0]
    v = int(full[0, 0])
    got = idx.gained_since(3, 0, vertex=v)
    assert np.array_equal(got, full[(full == v).any(axis=1)])
    assert np.array_equal(got, jidx.gained_since(3, 0, vertex=v))
    # range validation
    with pytest.raises(ValueError):
        idx.delta(3, idx.version + 1)
    with pytest.raises(ValueError):
        idx.delta(3, -1)


def test_plan_index_history_window():
    g = rand_graph(16, 40, 3)
    idx = PlanIndex(g, "hybrid", churn_threshold=1.1, history=2, **CPU)
    jidx = jdelta.PlanIndex(ref_graph(g), "hybrid", churn_threshold=1.1,
                            history=2)
    for b in range(4):
        ins = np.random.default_rng(b).integers(0, 16, (2, 2))
        idx.apply_batch(insert=ins)
        jidx.apply_batch(insert=ins)
    assert idx.version == 4 and idx.oldest_version() == 2 == \
        jidx.oldest_version()
    idx.delta(3, 2)  # inside the window
    with pytest.raises(ValueError):
        idx.delta(3, 1)  # history exhausted
    # the index raises at once without a card unless it is told the CPU
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PlanIndex(g, "hybrid")
        PlanIndex(g, "hybrid", devices=["cpu"] * 2)
        PlanIndex(g, "hybrid", backend="host")


def test_plan_index_lineage_persisted(tmp_path):
    """The lineage record is the reference's, and each package reads the
    other's persisted repaired plan."""
    from repro_torch.checkpoint import store

    pipeline.clear_plan_cache()
    jpipeline.clear_plan_cache()
    g = rand_graph(18, 55, 11)
    cache = str(tmp_path / "plans")
    jcache = str(tmp_path / "jplans")
    idx = PlanIndex(g, "hybrid", churn_threshold=1.1, cache_dir=cache, **CPU)
    jidx = jdelta.PlanIndex(ref_graph(g), "hybrid", churn_threshold=1.1,
                            cache_dir=jcache)
    parent = idx.plan_key
    ins = np.random.default_rng(1).integers(0, 18, (3, 2))
    idx.apply_batch(insert=ins)
    jidx.apply_batch(insert=ins)
    meta = store.read_metadata(str(tmp_path / "plans" / idx.plan_key))
    assert meta is not None
    lin = meta["lineage"]
    assert lin["version"] == 1 and lin["parent_key"] == parent
    assert lin["repaired"] is True and lin["inserted"] >= 1
    jmeta = store.read_metadata(str(tmp_path / "jplans" / jidx.plan_key))
    assert jmeta["lineage"] == lin
    # the persisted repaired plan restores across "processes" and is exact
    pipeline.clear_plan_cache()
    s = Stats()
    plan = pipeline.cached_plan(idx.graph, "hybrid", cache_dir=cache,
                                stats=s)
    assert s.plan_cache_hit
    assert ebbkc.count(idx.graph, 4, plan=plan, **CPU).count == \
        jebbkc.count(ref_graph(idx.graph), 4).count
    # the reference's store of the same plan loads in the port, and the
    # port's in the reference, array for array
    pipeline.clear_plan_cache()
    jpipeline.clear_plan_cache()
    s = Stats()
    cross = pipeline.cached_plan(idx.graph, "hybrid", cache_dir=jcache,
                                 stats=s)
    assert s.plan_cache_hit
    assert_tables_equal(cross._tables["truss"], plan._tables["truss"])
    jcross = jpipeline.cached_plan(ref_graph(idx.graph), "hybrid",
                                   cache_dir=cache)
    assert_tables_equal(jcross._tables["truss"], plan._tables["truss"])
    assert store.read_metadata(str(tmp_path / "absent")) is None


# -- serving tier: update_graph + delta subscriptions -----------------------

def test_service_update_graph_and_delta_subscription():
    from repro_torch.serve import CliqueService

    rng = np.random.default_rng(5)
    n = 30
    g = from_edges(n, rng.integers(0, n, (140, 2)))
    svc = CliqueService(devices=["cpu"])
    try:
        svc.register_graph("g", g)
        assert svc.graph_version("g") == 0
        # empty delta at the current version
        d0 = svc.submit("g", 3, "delta", since_version=0).result(timeout=120)
        assert d0.rows.shape == (0, 3) and d0.kind == "delta"
        v1 = svc.update_graph("g", insert=rng.integers(0, n, (12, 2)))
        assert v1 == 1 and svc.stats.graph_updates == 1
        g2 = svc._entry("g").graph
        # post-mutation queries serve the mutated snapshot exactly
        assert svc.submit("g", 4, "count").result(timeout=120).count == \
            jebbkc.count(ref_graph(g2), 4).count
        # subscription read == from-scratch snapshot diff
        gain = rows_sorted(rows_diff(host_rows(g2, 3), host_rows(g, 3)))
        d = svc.submit("g", 3, "delta", since_version=0).result(timeout=120)
        assert np.array_equal(rows_sorted(d.rows), gain)
        assert d.emitted == d.rows.shape[0] and gain.shape[0] > 0
        # vertex_filter and max_out compose exactly as in listing mode
        v = int(gain[0, 0])
        dv = svc.submit("g", 3, "delta", since_version=0,
                        vertex_filter=v).result(timeout=120)
        assert np.array_equal(
            rows_sorted(dv.rows),
            rows_sorted(gain[(gain == v).any(axis=1)]))
        dm = svc.submit("g", 3, "delta", since_version=0,
                        max_out=2).result(timeout=120)
        assert dm.rows.shape[0] == min(2, gain.shape[0])
        assert svc.stats.delta_requests >= 4
        # error paths resolve the ticket; the service keeps serving
        with pytest.raises(ValueError):
            svc.submit("g", 3, "delta",
                       since_version=99).result(timeout=120)
        with pytest.raises(ValueError):  # delta needs a registered name
            svc.submit(g2, 3, "delta", since_version=0)
        with pytest.raises(ValueError):  # delta needs since_version
            svc.submit("g", 3, "delta")
        with pytest.raises(ValueError):  # and k >= 3
            svc.submit("g", 2, "delta", since_version=0)
        assert svc.submit("g", 3, "count").result(timeout=120).count == \
            jebbkc.count(ref_graph(g2), 3).count
    finally:
        svc.close()


def test_service_update_unknown_graph_raises():
    from repro_torch.serve import CliqueService

    svc = CliqueService(start=False, devices=["cpu"])
    with pytest.raises(KeyError):
        svc.update_graph("nope", insert=[(0, 1)])
    svc.close()


# -- committed regression: touched-set closure over survivors ---------------

def test_regression_touched_set_closure():
    """Two deleted edges sharing a common neighborhood used to leave a
    surviving edge's tile retired with no replacement in the reference
    (it sat in ``touched_old`` only), silently dropping one triangle; the
    port's copy closes the touched sets symmetrically, as the fixed
    reference does.  The rng(5)/n=30 two-batch sequence below found it."""
    rng = np.random.default_rng(5)
    n = 30
    g = from_edges(n, rng.integers(0, n, (140, 2)))
    idx = PlanIndex(g, "hybrid", churn_threshold=1.1, **CPU)
    idx.apply_batch(insert=rng.integers(0, n, (4, 2)))
    idx.apply_batch(delete=idx.graph.edges[:3])
    for k in (3, 4, 5):
        assert ebbkc.count(idx.graph, k, plan=idx.plan, **CPU).count == \
            jebbkc.count(ref_graph(idx.graph), k).count, k
