"""repro_torch.serve held against the reference on the CPU.

The port's serving tier runs on CPU lanes here (``devices=["cpu"]``, the
plain torch versions of the kernels); every count and row array it
returns is compared with the reference's engines (``engine_jax`` with
the compiled ``lax`` backend, ``listing.stream_cliques``) on the same
seeded graphs, and one burst is held against the reference's own
``CliqueService`` end to end.  Every comparison is exact (tolerance 0):
counts are integers and rows are compared byte for byte, order included.
The same service on CUDA lanes is tested by ``test_torch_gpu.py`` and
``chip_smoke.py`` ``[serve]``.
"""
import threading

import numpy as np
import pytest
import torch

from conftest import random_graph
from repro.core import engine_jax
from repro.core import graph as jgraph
from repro.core import listing as jlisting
from repro import serve as jserve
from repro_torch.core import engine_torch, listing, pipeline
from repro_torch.core import tiles as tiles_mod
from repro_torch.core.engine_np import Stats
from repro_torch.core.graph import from_edges
from repro_torch.data import graphs
from repro_torch.runtime.dispatch import Dispatcher, ListDispatcher, Routed
from repro_torch.serve import (
    CliqueService,
    ServiceClosed,
    ServiceOverloaded,
    apply_vertex_filter,
    edf_pick,
    fuse_chunks,
)


def make_graphs():
    """The reference test suite's graphs, as (port, reference) pairs."""
    rng = np.random.default_rng(77)
    a = random_graph(rng, n_lo=24, n_hi=25, p_lo=0.3, p_hi=0.3)
    b = random_graph(rng, n_lo=30, n_hi=31, p_lo=0.25, p_hi=0.25)
    c = graphs.rmat_graph(5, 8, seed=7)
    return {name: (from_edges(g.n, g.edges), jgraph.from_edges(g.n, g.edges))
            for name, g in (("a", a), ("b", b), ("c", c))}


PAIRS = make_graphs()
GRAPHS = {name: pair[0] for name, pair in PAIRS.items()}
_REF = {}


def ref_count(name, k):
    """The reference engine's count (compiled lax backend)."""
    key = ("count", name, k)
    if key not in _REF:
        _REF[key] = engine_jax.count(PAIRS[name][1], k, backend="lax").count
    return _REF[key]


def ref_rows(name, k):
    """The reference listing's rows, in its stream order."""
    key = ("rows", name, k)
    if key not in _REF:
        sink = jlisting.ArraySink(k)
        jlisting.stream_cliques(PAIRS[name][1], k, sink, backend="lax")
        _REF[key] = sink.result()
    return _REF[key]


def service(**kw):
    kw.setdefault("devices", ["cpu"])
    svc = CliqueService(**kw)
    for name, g in GRAPHS.items():
        svc.register_graph(name, g)
    return svc


# ---------------------------------------------------------------------------
# policy units
# ---------------------------------------------------------------------------

EDF_CASES = [
    [],
    [(5.0, 10, 0), (2.0, 1, 1), (9.0, 99, 2)],
    [(None, 1000, 0), (50.0, 1, 1)],
    [(None, 10, 0), (None, 30, 1), (None, 20, 2)],
    [(None, 10, 1), (None, 10, 0)],
]


def test_edf_pick_empty():
    assert edf_pick([]) is None is jserve.edf_pick([])


def test_edf_pick_earliest_deadline_wins():
    assert edf_pick(EDF_CASES[1]) == 1 == jserve.edf_pick(EDF_CASES[1])


def test_edf_pick_no_deadline_sorts_last():
    assert edf_pick(EDF_CASES[2]) == 1 == jserve.edf_pick(EDF_CASES[2])


def test_edf_pick_lpt_fallback_among_equal_deadlines():
    # no deadlines anywhere: the largest remaining work is picked (LPT)
    assert edf_pick(EDF_CASES[3]) == 1 == jserve.edf_pick(EDF_CASES[3])


def test_edf_pick_arrival_tiebreak():
    assert edf_pick(EDF_CASES[4]) == 1 == jserve.edf_pick(EDF_CASES[4])


def test_fuse_chunks_concatenates_and_segments():
    """Fused batches and segments equal the reference's on the same
    chunks (the port's packed batches are the reference's, byte for
    byte)."""
    from repro.core import pipeline as jpipeline
    plan = pipeline.cached_plan(GRAPHS["c"], "hybrid")
    jplan = jpipeline.cached_plan(PAIRS["c"][1], "hybrid")
    batches = [b for b in pipeline.stream_batches(plan, 4, batch_size=4)
               if not isinstance(b, tiles_mod.Tile)]
    jbatches = [b for b in jpipeline.stream_batches(jplan, 4, batch_size=4)
                if isinstance(b, jpipeline.TileBatch)]
    assert len(batches) == len(jbatches)
    by_t = {}
    for i, b in enumerate(batches):
        by_t.setdefault(b.T, []).append(i)
    pick = next(ix for ix in by_t.values() if len(ix) >= 2)[:2]
    same_t = [batches[i] for i in pick]
    chunks = [("r0", 0, same_t[0]), ("r1", 3, same_t[1])]
    fused, segments = fuse_chunks(chunks)
    jfused, jsegments = jserve.fuse_chunks(
        [("r0", 0, jbatches[pick[0]]), ("r1", 3, jbatches[pick[1]])])
    assert fused.B == same_t[0].B + same_t[1].B
    assert [(r, s, a, b) for r, s, a, b, _ in segments] == [
        ("r0", 0, 0, same_t[0].B),
        ("r1", 3, same_t[0].B, fused.B),
    ] == [(r, s, a, b) for r, s, a, b, _ in jsegments]
    for f in ("A", "cand", "sizes", "nedges", "anchors", "verts"):
        np.testing.assert_array_equal(getattr(fused, f), getattr(jfused, f))


def test_apply_vertex_filter():
    rows = np.array([[0, 1, 2], [1, 2, 3], [4, 5, 6]])
    np.testing.assert_array_equal(apply_vertex_filter(rows, 1), rows[:2])
    np.testing.assert_array_equal(apply_vertex_filter(rows, 1),
                                  jserve.apply_vertex_filter(rows, 1))
    assert apply_vertex_filter(rows[:0], 1).shape[0] == 0


# ---------------------------------------------------------------------------
# single-request parity vs the reference engines
# ---------------------------------------------------------------------------


def test_single_count_matches_engine():
    with service() as svc:
        for name in GRAPHS:
            for k in (3, 4, 5):
                assert svc.submit(name, k).result(120).count \
                    == ref_count(name, k)


def test_single_list_matches_stream_cliques_exactly():
    with service() as svc:
        for name in GRAPHS:
            for k in (3, 4):
                got = svc.submit(name, k, "list").result(120).rows
                assert got.tobytes() == ref_rows(name, k).tobytes()


def test_count_closed_forms_k1_k2():
    with service() as svc:
        g = GRAPHS["a"]
        assert svc.submit("a", 1).result(30).count == g.n
        assert svc.submit("a", 2).result(30).count == g.m


def test_vertex_filter_and_max_out_semantics():
    with service() as svc:
        ref = ref_rows("b", 4)
        v = int(ref[0, 0])
        want = apply_vertex_filter(ref, v)
        got = svc.submit("b", 4, "list", vertex_filter=v).result(120)
        np.testing.assert_array_equal(got.rows, want)
        # max_out truncates AFTER filtering, in stream order
        got2 = svc.submit("b", 4, "list", vertex_filter=v,
                          max_out=3).result(120)
        np.testing.assert_array_equal(got2.rows, want[:3])


def test_external_sink_delivery():
    with service() as svc:
        sink = listing.ArraySink(4)
        res = svc.submit("a", 4, "list", sink=sink).result(120)
        assert res.rows is None  # caller owns the sink
        np.testing.assert_array_equal(sink.result(), ref_rows("a", 4))
        assert res.emitted == ref_rows("a", 4).shape[0]


def test_invalid_requests():
    with service() as svc:
        with pytest.raises(KeyError):
            svc.submit("nope", 4)
        with pytest.raises(ValueError):
            svc.submit("a", 2, "list")  # listing needs k >= 3
        with pytest.raises(ValueError):
            svc.submit("a", 4, "explode")
        with pytest.raises(ValueError):
            svc.submit("a", 4, deadline_s=0.0)
    # no card and no CPU lanes asked for: the service raises at once
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            CliqueService()
        with pytest.raises(RuntimeError, match="CUDA"):
            CliqueService(devices=["cuda:0"])


def test_submit_after_close_raises():
    svc = service()
    svc.close()
    with pytest.raises(ServiceClosed):
        svc.submit("a", 4)


# ---------------------------------------------------------------------------
# concurrency: determinism, coalescing, deadlines, backpressure
# ---------------------------------------------------------------------------

SETTINGS = [
    dict(chunk_tiles=16, fuse_rows=64, async_staging=False),
    dict(chunk_tiles=32, fuse_rows=128, async_staging=True),
    dict(chunk_tiles=64, fuse_rows=256, async_staging=True,
         devices=["cpu"] * 2),
]


@pytest.mark.parametrize("cfg", SETTINGS)
def test_concurrent_burst_byte_identical_to_serial(cfg):
    """A paused-then-resumed burst (the third setting on two CPU lanes):
    every count and row array equals the reference engines'."""
    specs = [(n, k, m) for n in ("a", "b") for k in (4, 5)
             for m in ("count", "list")]
    refs = {s: ref_count(s[0], s[1]) if s[2] == "count"
            else ref_rows(s[0], s[1]) for s in specs}
    with service(**cfg) as svc:
        svc.pause()  # admit the whole burst together: maximal interleaving
        tickets = [(s, svc.submit(s[0], s[1], s[2])) for s in specs * 2]
        svc.resume()
        for s, t in tickets:
            res = t.result(300)
            if s[2] == "count":
                assert res.count == refs[s]
            else:
                assert res.rows.tobytes() == refs[s].tobytes()


def test_cross_request_coalescing_happens():
    with service(chunk_tiles=16, fuse_rows=128) as svc:
        svc.pause()
        tickets = [svc.submit("b", 4, "list") for _ in range(6)]
        svc.resume()
        want = ref_rows("b", 4)
        for t in tickets:
            np.testing.assert_array_equal(t.result(300).rows, want)
        assert svc.stats.cross_request_batches > 0
        assert svc.stats.fused_chunks > svc.stats.fused_batches


def test_deadline_miss_accounting():
    with service() as svc:
        ok = svc.submit("a", 4, deadline_s=120.0).result(120)
        assert ok.deadline_missed is False
        # an impossible deadline: the result is still exact, only flagged
        late = svc.submit("a", 5, deadline_s=1e-4).result(120)
        assert late.deadline_missed is True
        assert late.count == ref_count("a", 5)
        assert svc.stats.deadline_missed == 1
        assert svc.stats.completed >= 2


def test_overload_backpressure_sheds_then_recovers():
    svc = service(max_pending=2)
    try:
        svc.pause()  # stop admission so the queue actually fills
        kept = [svc.submit("a", 4), svc.submit("a", 5)]
        with pytest.raises(ServiceOverloaded):
            svc.submit("b", 4, block=False)
        assert svc.stats.rejected == 1
        svc.resume()  # the queued burst still completes exactly
        assert kept[0].result(120).count == ref_count("a", 4)
        assert kept[1].result(120).count == ref_count("a", 5)
    finally:
        svc.close()


def test_many_clients_many_threads():
    errors = []
    refs = {k: ref_count("c", k) for k in (3, 4, 5)}
    with service(devices=["cpu"] * 2) as svc:

        def client(i):
            try:
                for k in (3, 4, 5):
                    assert svc.submit("c", k).result(120).count == refs[k]
            except BaseException as exc:  # surfaced after join
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errors


def test_burst_matches_the_reference_service():
    """One mixed burst through the reference's CliqueService and the
    port's, each paused then resumed: every result is byte-identical,
    and both fuse chunks of different requests into shared batches."""
    specs = [("a", 4, "count", {}), ("b", 5, "count", {}),
             ("b", 4, "list", {}), ("c", 4, "list", {}),
             ("b", 4, "list", dict(vertex_filter=3, max_out=5)),
             ("c", 3, "list", dict(max_out=7))]
    results = {}
    for tag, make in (("port", lambda: service(chunk_tiles=16,
                                               fuse_rows=64)),
                      ("ref", lambda: jserve.CliqueService(
                          chunk_tiles=16, fuse_rows=64))):
        svc = make()
        if tag == "ref":
            for name, pair in PAIRS.items():
                svc.register_graph(name, pair[1])
        try:
            svc.pause()
            tickets = [svc.submit(n, k, m, **kw) for n, k, m, kw in specs]
            svc.resume()
            results[tag] = [t.result(300) for t in tickets]
            assert svc.stats.cross_request_batches > 0
        finally:
            svc.close()
    for (n, k, m, _), got, want in zip(specs, results["port"],
                                       results["ref"]):
        assert got.kind == want.kind == m
        if m == "count":
            assert got.count == want.count == ref_count(n, k)
        else:
            assert got.rows.tobytes() == want.rows.tobytes()
            assert got.emitted == want.emitted


# ---------------------------------------------------------------------------
# the routed dispatcher seam (multi-request streams through consume)
# ---------------------------------------------------------------------------


def _routed_stream(plan_k_pairs, *, interleave=True):
    """Interleave each request's packed-batch stream, wrapped in Routed."""
    streams = []
    for g, k, route in plan_k_pairs:
        plan = pipeline.cached_plan(g, "hybrid")
        items = list(pipeline.stream_batches(plan, k, batch_size=16))
        streams.append([Routed(it, route) for it in items])
    if not interleave:
        for s in streams:
            yield from s
        return
    i = 0
    while any(streams):
        s = streams[i % len(streams)]
        if s:
            yield s.pop(0)
        i += 1


def test_dispatcher_consume_interleaved_routed_counts():
    k = 4
    l = k - 2
    totals = {}

    def mk_route(rid):
        def route(hard, nv, t, f):
            totals[rid] = totals.get(rid, 0) + engine_torch.combine_counts(
                hard, nv, t, f, l, True)
        return route

    def on_spill(tile, route=None):
        c = engine_torch.count_spilled(tile, "hybrid", l, Stats(), 3, True)
        if route is not None:
            # spilled work still belongs to its request
            key = [rid for rid, r in routes.items() if r is route][0]
            totals[key] = totals.get(key, 0) + c

    routes = {0: mk_route(0), 1: mk_route(1)}
    disp = Dispatcher(l, ["cpu"] * 2, et=True)
    stream = _routed_stream([(GRAPHS["a"], k, routes[0]),
                             (GRAPHS["b"], k, routes[1])])
    disp.consume(stream, on_spill=on_spill)
    disp.finish()
    assert totals[0] == ref_count("a", k)
    assert totals[1] == ref_count("b", k)


def test_list_dispatcher_consume_interleaved_routed_rows():
    k = 4
    l = k - 2
    rows = {0: [], 1: []}

    def mk_route(rid):
        def route(batch, bufs, cnt, ovf):
            out = listing.decode_batch(batch, bufs, cnt, ovf, l, Stats(),
                                       et_t=3)
            rows[rid].append(out)
            return out.shape[0]
        return route

    disp = ListDispatcher(l, ["cpu"], sink=None, et_t=3)
    stream = _routed_stream([(GRAPHS["a"], k, mk_route(0)),
                             (GRAPHS["b"], k, mk_route(1))])
    disp.consume(stream)
    disp.finish()
    for rid, name in ((0, "a"), (1, "b")):
        got = np.concatenate(rows[rid]) if rows[rid] else np.empty((0, k))
        assert got.tobytes() == ref_rows(name, k).tobytes()


def test_dispatcher_unrouted_stream_still_totals():
    # bare TileBatch items keep the classic single-request behavior
    k, l = 4, 2
    plan = pipeline.cached_plan(GRAPHS["a"], "hybrid")
    disp = Dispatcher(l, ["cpu"], et=True)
    spilled = []
    disp.consume(pipeline.stream_batches(plan, k, batch_size=32),
                 on_spill=lambda t: spilled.append(t))
    assert disp.finish() + sum(
        engine_torch.count_spilled(t, "hybrid", l, Stats(), 3, True)
        for t in spilled) == ref_count("a", k)
