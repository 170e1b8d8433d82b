"""Port multi-lane dispatch (``repro_torch.runtime``) vs the JAX reference
(``repro.runtime``), on the CPU.

The port's lanes are ``["cpu"] * n``; the reference gets the same number
of copies of its one CPU device (``[jax.devices()[0]] * n``) and the
compiled lax backend.  Both get the same packed batches (the two pipelines
are byte-identical).  Every comparison is exact (tolerance 0): counts,
placements, bins and per-lane tile/flop/byte tallies are integers, and
scheduler loads are float64 sums of the same terms in the same order.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import engine_jax, pipeline as jpipe
from repro.core.graph import from_edges as jfrom_edges
from repro.data import graphs as jgraphs
from repro.runtime import clique_scheduler as jsched
from repro.runtime import dispatch as jdsp
from repro_torch.core import ebbkc, engine_torch, pipeline
from repro_torch.core.engine_np import Stats
from repro_torch.data import graphs as tgraphs
from repro_torch.kernels import ops
from repro_torch.launch import clique
from repro_torch.runtime import clique_scheduler as sched
from repro_torch.runtime import dispatch as dsp
from test_torch_engine import _FIXTURE, GOLDEN

JDEV = jax.devices()[0]
LANES = (1, 2, 4)


def _suite():
    """The golden graphs (with their counts) and a Graph500-shaped RMAT
    graph that streams several batches a bin."""
    out = {name: (g, golden) for name, (g, golden) in GOLDEN.items()}
    out["rmat8"] = (tgraphs.rmat_graph(8, 4, seed=7), {})
    return out


def _jax_graph(name):
    if name == "rmat8":
        return jgraphs.rmat_graph(8, 4, seed=7)
    import json
    with open(_FIXTURE) as f:
        spec = json.load(f)[name]
    return jfrom_edges(spec["n"], np.asarray(spec["edges"], np.int64))


SUITE = _suite()


@pytest.fixture(scope="module")
def jax_counts():
    """engine_jax.count(..., devices=[cpu] * n, backend="lax") per
    (graph, k, n); the order does not change a count."""
    return {(name, k, n): engine_jax.count(_jax_graph(name), k,
                                           devices=[JDEV] * n,
                                           backend="lax").count
            for name in SUITE for k in range(3, 8) for n in LANES}


def _batches(g, k, batch_size=16, **kw):
    return [b for b in pipeline.stream_batches(g, k, batch_size=batch_size,
                                               **kw)
            if isinstance(b, pipeline.TileBatch)]


def _jbatches(g, k, batch_size=16, **kw):
    return [b for b in jpipe.stream_batches(g, k, batch_size=batch_size,
                                            **kw)
            if isinstance(b, jpipe.TileBatch)]


def test_resolve_devices(monkeypatch):
    cpu = torch.device("cpu")
    assert dsp.resolve_devices(["cpu"] * 3) == [cpu] * 3
    assert dsp.resolve_devices((cpu, "cpu")) == [cpu] * 2
    with pytest.raises(ValueError):
        dsp.resolve_devices([])
    with pytest.raises(ValueError):
        dsp.resolve_devices(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec in (None, "all", 1, 3, ["cuda:0"], ["cpu", "cuda:0"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            dsp.resolve_devices(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_torch.count(GOLDEN["karate"][0], 4, devices="all")


def test_dispatchers_require_l_ge_1_and_a_spill_handler():
    with pytest.raises(ValueError):
        dsp.Dispatcher(0, ["cpu"])
    with pytest.raises(ValueError):
        dsp.ListDispatcher(0, ["cpu"])
    with pytest.raises(ValueError, match="capacity"):
        dsp.ListDispatcher(2, ["cpu"], capacity="bogus")
    dense = tgraphs.erdos_renyi(44, 0.97, seed=2)
    disp = dsp.Dispatcher(2, ["cpu"], stats=Stats())
    with pytest.raises(ValueError, match="on_spill"):
        disp.consume(pipeline.stream_batches(dense, 4, bins=(32,)))
    disp.finish()


@pytest.mark.parametrize("n", LANES)
@pytest.mark.parametrize("order", ["truss", "hybrid", "color"])
def test_count_matches_reference_and_golden(jax_counts, order, n):
    for name, (g, golden) in SUITE.items():
        for k in range(3, 8):
            for staging in (True, False):
                res = engine_torch.count(g, k, order=order,
                                         devices=["cpu"] * n,
                                         async_staging=staging)
                assert res.count == jax_counts[(name, k, n)], \
                    (name, order, k, n, staging)
                if k in golden:
                    assert res.count == golden[k], (name, order, k)
                if not staging:
                    assert res.stats.staging_overlap_s == 0.0
                # every packed tile was placed on a lane exactly once
                assert sum(res.stats.device_tiles.values()) == \
                    res.tiles - res.stats.spilled_tiles
                assert set(res.stats.device_tiles) <= set(range(n))
    # the front door forwards the knobs
    g = SUITE["rmat8"][0]
    assert ebbkc.count(g, 5, engine_kwargs=dict(
        devices=["cpu"] * n, max_inflight=1)).count == \
        jax_counts[("rmat8", 5, n)]


@pytest.mark.parametrize("order", ["truss", "hybrid", "color"])
def test_spill_path_matches_reference(order):
    """bins=(32,) sends the 40-vertex planted tiles to the host recursion
    beside the dispatched batches."""
    jg = jgraphs.planted_cliques(140, 2, 40, p_noise=0.02, seed=3)
    tg = tgraphs.planted_cliques(140, 2, 40, p_noise=0.02, seed=3)
    for k in (4, 5):
        want = engine_jax.count(jg, k, order=order, backend="lax",
                                bins=(32,), devices=[JDEV] * 2)
        got = engine_torch.count(tg, k, order=order, bins=(32,),
                                 devices=["cpu"] * 2)
        assert got.count == want.count, (order, k)
        assert got.stats.spilled_tiles == want.stats.spilled_tiles > 0
        assert got.stats.device_tiles == want.stats.device_tiles
        assert (got.tiles, got.max_tile) == (want.tiles, want.max_tile)


@pytest.mark.parametrize("k", [4, 5])
def test_online_placements_match_reference(k):
    """Online LPT over 4 lanes places every batch where the reference's
    Dispatcher places it, and the per-lane tallies agree."""
    g, jg = SUITE["rmat8"][0], _jax_graph("rmat8")
    batches, jbatches = _batches(g, k), _jbatches(jg, k)
    assert len(batches) == len(jbatches) >= 8
    stats, jstats = Stats(), jdsp.Stats()
    disp = dsp.Dispatcher(k - 2, ["cpu"] * 4, stats=stats)
    jdisp = jdsp.Dispatcher(k - 2, [JDEV] * 4, backend="lax", stats=jstats)
    for b, jb in zip(batches, jbatches):
        disp.submit(b)
        jdisp.submit(jb)
    assert disp.finish() == jdisp.finish()
    assert disp.placements == jdisp.placements
    assert len(set(disp.placements)) == 4
    np.testing.assert_array_equal(disp._loads, jdisp._loads)
    for f in ("device_tiles", "device_flops", "device_bytes"):
        assert getattr(stats, f) == getattr(jstats, f), f
    assert disp.tiles == jdisp.tiles


@pytest.mark.parametrize("n", LANES)
def test_offline_schedule_matches_reference(n):
    g, jg = SUITE["rmat8"][0], _jax_graph("rmat8")
    k = 4
    batches, jbatches = _batches(g, k, 32), _jbatches(jg, k, 32)
    bins, st = sched.schedule_batches(batches, k - 2, n)
    jbins, jst = jsched.schedule_batches(jbatches, k - 2, n)
    assert bins == jbins
    for key in ("device_loads", "batch_costs"):
        np.testing.assert_array_equal(st[key], jst[key])
    assert st["max_over_mean"] == jst["max_over_mean"]
    stats = Stats()
    total, info = dsp.dispatch_scheduled(batches, k - 2, ["cpu"] * n,
                                         stats=stats)
    jtotal, jinfo = jdsp.dispatch_scheduled(jbatches, k - 2, [JDEV] * n,
                                            backend="lax")
    assert total == jtotal == ebbkc.count(g, k, backend="host").count
    for key in ("placements", "device_bins", "tiles", "n_devices"):
        assert info[key] == jinfo[key], key
    assert sum(stats.device_tiles.values()) == sum(b.B for b in batches)
    # the tile-level scheduler agrees too
    tb = batches[0]
    assert sched.schedule_tiles(tb, k - 2, n)[0] == \
        jsched.schedule_tiles(jbatches[0], k - 2, n)[0]


@pytest.mark.parametrize("l", [1, 2, 3, 4])
def test_pad_rows_is_count_neutral(l):
    """Zero-cand padding rows contribute exactly 0 for every l >= 1, and
    pad exactly as the reference pads."""
    g = SUITE["rmat8"][0]
    b = _batches(g, l + 2, 16)[0]
    base = engine_torch.combine_counts(*engine_torch.count_packed(
        *(torch.from_numpy(x).view(torch.int32) for x in (b.A, b.cand)), l),
        l, True)
    for multiple in (3, b.B + 5):
        A, cand = dsp._pad_rows(b.A, multiple), dsp._pad_rows(b.cand,
                                                                multiple)
        np.testing.assert_array_equal(A, jdsp._pad_rows(b.A, multiple))
        assert A.shape[0] % multiple == 0 and A.shape[0] > b.B
        padded = engine_torch.combine_counts(*engine_torch.count_packed(
            *(torch.from_numpy(x).view(torch.int32) for x in (A, cand)), l),
            l, True)
        assert padded == base
    assert dsp._pad_rows(b.A, 1) is b.A


@pytest.mark.parametrize("n", [2, 3, 4])
def test_row_sharded_path_counts_and_tallies(n):
    """``mesh=`` splits each batch by rows over the lanes: the count is the
    reference's, and each lane's tiles follow the reference's formula."""
    g = SUITE["rmat8"][0]
    for k in (3, 5):
        batches = _batches(g, k, 64)
        stats = Stats()
        total, info = dsp.dispatch_scheduled(batches, k - 2,
                                             mesh=["cpu"] * n, stats=stats)
        assert total == engine_jax.count(_jax_graph("rmat8"), k,
                                         backend="lax").count
        assert info["n_devices"] == n and info["mesh"]
        assert info["placements"] == [-1] * len(batches)
        want = np.zeros(n, dtype=np.int64)
        for b in batches:  # dispatch.py's per-device accounting
            padded = -(-b.B // n) * n
            shard_rows = max(1, padded // n)
            want += np.bincount(np.minimum(np.arange(b.B) // shard_rows,
                                           n - 1), minlength=n)
        assert stats.device_tiles == {d: int(c) for d, c in enumerate(want)
                                      if c}


def test_routed_partials_sum_to_the_unrouted_total():
    g = SUITE["rmat8"][0]
    k = 5
    batches = _batches(g, k)
    routed = []

    def route(*partials):
        assert all(p.dtype == np.int64 for p in partials)
        routed.append(engine_torch.combine_counts(*partials, k - 2, True))

    disp = dsp.Dispatcher(k - 2, ["cpu"] * 2, max_inflight=1)
    for i, b in enumerate(batches):
        disp.submit(b, route=route if i % 2 else None)
    unrouted = disp.finish()
    assert len(routed) == len(batches) // 2
    assert unrouted + sum(routed) == ebbkc.count(g, k, backend="host").count
    # the row-sharded path hands back the un-padded rows
    lengths = []
    disp = dsp.Dispatcher(k - 2, mesh=["cpu"] * 3)
    for b in batches:
        disp.submit(b, route=lambda *p: lengths.append(p[0].shape[0]))
    assert disp.finish() == 0
    assert lengths == [b.B for b in batches]


def test_routed_streams_deliver_to_their_owners():
    """Items wrapped in ``Routed`` interleave two requests through one
    ``consume``: each owner gets its batches' partials (counting) or
    triples (listing) and its spill tiles, in stream order, and nothing
    reaches the dispatcher-global total or sink."""
    from repro_torch.core import listing
    jg = tgraphs.planted_cliques(140, 2, 40, p_noise=0.02, seed=3)
    k = 4
    want = ebbkc.count(jg, k, backend="host").count

    def tagged(owner):
        return (dsp.Routed(item, owner) for item in pipeline.stream_batches(
            jg, k, batch_size=16, bins=(32,)))

    def interleave():
        for a, b in zip(tagged("a"), tagged("b")):
            yield a
            yield b

    totals = {"a": 0, "b": 0}

    def count_route(owner):
        def route(*partials):
            totals[owner] += engine_torch.combine_counts(*partials, k - 2,
                                                         True)
        return route

    def on_spill(tile, owner):
        totals[owner] += engine_torch.count_spilled(tile, "hybrid", k - 2,
                                                    Stats(), 3, True)

    disp = dsp.Dispatcher(k - 2, ["cpu"] * 2)
    disp.consume((dsp.Routed(r.item, count_route(r.route))
                  if isinstance(r.item, pipeline.TileBatch) else r
                  for r in interleave()), on_spill=on_spill)
    assert disp.finish() == 0
    assert totals == {"a": want, "b": want}
    base = listing.ArraySink(k)
    listing.stream_cliques(jg, k, base, device="cpu", batch_size=16,
                           bins=(32,))
    rows = {"a": [], "b": []}
    stats = Stats()

    def list_route(owner):
        def route(batch, bufs, cnt, ovf):
            arr = listing.decode_batch(batch, bufs, cnt, ovf, k - 2, stats)
            rows[owner].append(arr)
            return arr.shape[0]
        return route

    ldisp = dsp.ListDispatcher(k - 2, ["cpu"] * 2, capacity="speculative")
    ldisp.consume((dsp.Routed(r.item, list_route(r.route))
                   if isinstance(r.item, pipeline.TileBatch) else r
                   for r in interleave()),
                  on_spill=lambda tile, owner: rows[owner].append(
                      listing.list_spilled(tile, k - 2, stats)))
    assert ldisp.finish() == 0
    for owner in rows:
        np.testing.assert_array_equal(np.concatenate(rows[owner]),
                                      base.result())


def test_consume_drives_both_dispatchers():
    from repro_torch.core import listing
    g = SUITE["rmat8"][0]
    k = 4
    ref = ebbkc.count(g, k, backend="host").count
    disp = dsp.Dispatcher(k - 2, ["cpu"] * 2, stats=Stats())
    ntiles, max_tile = disp.consume(pipeline.stream_batches(
        g, k, batch_size=32, pack_workers=2))
    assert disp.finish() == ref
    assert ntiles == sum(b.B for b in pipeline.stream_batches(g, k))
    assert max_tile in pipeline.BINS
    sink = listing.ArraySink(k)
    ldisp = dsp.ListDispatcher(k - 2, ["cpu"] * 2, sink=sink, stats=Stats())
    ldisp.consume(pipeline.stream_batches(g, k, batch_size=32,
                                          pack_workers=2))
    assert ldisp.finish() == sink.accepted == ref


def test_overlap_is_lane_time_outside_the_harvest_waits():
    # lane intervals against the consumer's (disjoint) harvest waits, ns
    assert dsp._outside_ns([(0, 100)], []) == 100
    assert dsp._outside_ns([(0, 100)], [(20, 30), (90, 150)]) == 80
    assert dsp._outside_ns([(0, 10), (50, 60)], [(5, 55)]) == 10
    assert dsp._outside_ns([(10, 20)], [(0, 100)]) == 0


def test_stats_merge_classifies_every_field(monkeypatch):
    names = {f.name for f in dataclasses.fields(Stats)}
    assert names == set(Stats._MERGE_KINDS)
    for field in ("device_tiles", "device_flops", "device_bytes",
                  "staging_overlap_s", "emit_retries", "kernel_compile_s"):
        assert field in names
    a = Stats(branches=2, peak_graph=5, spill_sizes=[40], backend="",
              device_tiles={0: 3}, plan_cache_hit=False,
              pack_queue_occupancy=0.25, staging_overlap_s=0.5)
    b = Stats(branches=3, peak_graph=4, spill_sizes=[41],
              backend="torch:cpu", device_tiles={0: 1, 1: 2},
              plan_cache_hit=True, pack_queue_occupancy=0.75,
              staging_overlap_s=0.25, emit_retries=1)
    assert a.merge(b) is a
    assert (a.branches, a.peak_graph, a.spill_sizes, a.backend) == \
        (5, 5, [40, 41], "torch:cpu")
    assert a.device_tiles == {0: 4, 1: 2}
    assert a.plan_cache_hit and a.pack_queue_occupancy == 0.75
    assert (a.staging_overlap_s, a.emit_retries) == (0.75, 1)
    # a field without a rule raises
    kinds = dict(Stats._MERGE_KINDS)
    del kinds["emit_retries"]
    monkeypatch.setattr(Stats, "_MERGE_KINDS", kinds)
    with pytest.raises(TypeError, match="emit_retries"):
        Stats().merge(Stats())


def test_a_failing_kernel_raises_out_of_the_dispatcher(monkeypatch):
    """No fallback: a launch that fails raises out of submit/finish."""
    def broken(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(ops, "count_tiles", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        engine_torch.count(SUITE["rmat8"][0], 5, devices=["cpu"] * 2)


@pytest.mark.parametrize("extra", [[], ["--offline-lpt"], ["--shard-map"],
                                   ["--sync-staging"],
                                   ["--offline-lpt", "--shard-map"]])
def test_cli_devices_verify_on_cpu(capsys, extra):
    rc = clique.main(["--graph", "rmat:10", "--k", "5", "--device", "cpu",
                      "--devices", "2", "--verify"] + extra)
    out = capsys.readouterr().out
    assert rc == 0 and "match=True" in out
    want = engine_jax.count(jgraphs.rmat_graph(10, edge_factor=8, seed=7),
                            5, backend="lax").count
    assert f"k=5: {want} cliques" in out
    assert "devices=2" in out
    assert ("shard_map" in out) == ("--shard-map" in extra)
    # the balance of the LPT bins (the row-sharded path has none)
    assert ("balance max/mean" in out) == (extra == ["--offline-lpt"])
    if "--shard-map" not in extra:
        assert "d0:" in out and "d1:" in out  # both lanes took batches


def test_launch_counters_are_exact_across_threads():
    """Two threads call a wrapper's counting path N times each; the
    counters the wrappers add to under one lock lose no update."""
    import sys
    from repro_torch.kernels import clique_count, common, triangle_mm
    A = torch.zeros((1, 32, 1), dtype=torch.int32)
    cand = torch.zeros((1, 1), dtype=torch.int32)
    n = 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ops.reset_counts()
        before = clique_count.item_launches

        def work():
            for _ in range(n):
                triangle_mm.triangle_count_tiles(A, cand)
                common.count_call(clique_count.__name__, "item_launches")

        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert ops.plain_counts()["triangle_count_tiles"] == 2 * n
    assert clique_count.item_launches == before + 2 * n
    assert sum(ops.launch_counts().values()) == 0
    clique_count.item_launches = before
    ops.reset_counts()
