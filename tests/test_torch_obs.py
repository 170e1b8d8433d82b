"""The port's observability layer (``repro_torch.obs``) on the CPU.

The port's copies of the reference's unit tests (``tests/test_obs.py``:
tracer core, determinism, the disabled-tracer overhead budget, the
Stats merge / metric classification, the metrics registry, Prometheus
exposition and the metrics server, kernel attribution, logging), run on
the port's own modules, plus what ties the port to the reference: a traced
port query passes through the same stage spans as the traced reference
query on the same graph, and the launcher's ``--trace-out``,
``--metrics-port`` and ``--log-level`` work as the reference's do.  The
serving-tier tests of the reference wait for the port's serving slice.
"""
import dataclasses
import json
import threading
import time
from collections import Counter as TallyCounter

import numpy as np
import pytest

from repro.core import engine_jax as jengine_jax
from repro.core import listing as jlisting
from repro.core import pipeline as jpipeline
from repro.data import graphs as jgraphs
from repro.obs import trace as jtrace
from repro_torch.core import ebbkc, engine_torch, listing, pipeline
from repro_torch.core.engine_np import Stats
from repro_torch.data import graphs as tgraphs
from repro_torch.launch import clique
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import trace
from repro_torch.obs.export import MetricsServer, render_prometheus, scrape
from repro_torch.obs.logging import get_logger, setup_logging
from repro_torch.obs.profile import aggregate_device_spans, note_kernel


@pytest.fixture
def tracer():
    """Enabled process tracer, reset and disabled again afterwards."""
    trace.configure(enabled=True)
    trace.reset()
    yield trace
    trace.configure(enabled=False)
    trace.reset()


@pytest.fixture
def registry():
    """A private metrics registry (the global one is left alone)."""
    return obs_metrics.Registry()


def small_graph(seed=11):
    return tgraphs.erdos_renyi(28, 0.3, seed=seed)


# ---------------------------------------------------------------------------
# tracer core
# ---------------------------------------------------------------------------


def test_spans_nest_and_validate(tracer):
    with trace.span("outer", x=1):
        with trace.span("inner") as sp:
            sp.set(y=2)
        trace.instant("tick")
    recs = trace.span_records()
    assert ("inner", "outer") in recs
    assert ("outer", None) in recs
    doc = trace.chrome_trace()
    assert trace.validate_chrome_trace(doc) == []
    by_name = {e["name"]: e for e in doc["traceEvents"] if e.get("ph") == "X"}
    # the user's attributes, and the span's thread-CPU microseconds
    args = dict(by_name["inner"]["args"])
    assert 0 <= args.pop("cpu") and args == {"y": 2}
    # inner lies within outer
    o, i = by_name["outer"], by_name["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]


def test_span_cpu_time_tells_waiting_from_working(tracer):
    with trace.span("sleep"):
        time.sleep(0.05)
    with trace.span("busy"):
        c0 = time.thread_time_ns()
        while time.thread_time_ns() - c0 < 20_000_000:
            pass
    ev = {e["name"]: e for e in trace.events()}
    assert ev["sleep"]["cpu"] < 0.1 * ev["sleep"]["dur"]
    assert 20_000_000 <= ev["busy"]["cpu"] <= ev["busy"]["dur"]
    assert ev["busy"]["cpu"] > 0.25 * ev["busy"]["dur"]


def test_device_intervals_export_as_async_pairs(tracer):
    t0 = time.perf_counter_ns()
    trace.interval("lane/batch", "lane0 cuda:0", t0, t0 + 5000, B=4)
    trace.interval("lane/kernel", "lane0 cuda:0", t0 + 1000, t0 + 2000)
    doc = trace.chrome_trace()
    assert trace.validate_chrome_trace(doc) == []
    got = [(e["name"], e["ph"], e["ts"], e["cat"]) for e in doc["traceEvents"]
           if e.get("id") == "lane0 cuda:0"]
    us = t0 / 1000.0
    assert got == [("lane/batch", "b", us, "device"),
                   ("lane/batch", "e", us + 5, "device"),
                   ("lane/kernel", "b", us + 1, "device"),
                   ("lane/kernel", "e", us + 2, "device")]
    # not complete events: nothing summing a thread's spans counts them
    assert trace.span_records() == []


def test_thread_local_nesting(tracer):
    def worker():
        with trace.span("w-outer"):
            with trace.span("w-inner"):
                pass

    with trace.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    recs = trace.span_records()
    # the worker's spans never parent onto the main thread's open span
    assert ("w-inner", "w-outer") in recs
    assert ("w-outer", None) in recs
    assert ("main", None) in recs


def test_async_request_track(tracer):
    trace.async_begin("request", id=7, k=5)
    trace.async_instant("request/admit", id=7)
    trace.async_end("request", id=7, latency_ms=1.5)
    doc = trace.chrome_trace()
    assert trace.validate_chrome_trace(doc) == []
    phs = [e["ph"] for e in doc["traceEvents"] if e.get("id") == "7"]
    assert phs == ["b", "n", "e"]


def test_unmatched_async_flagged(tracer):
    trace.async_begin("request", id=9)
    problems = trace.validate_chrome_trace(trace.chrome_trace())
    assert any("begin without end" in p for p in problems)


def test_retroactive_complete(tracer):
    t0 = time.perf_counter_ns()
    trace.complete("reorder/park", t0, 1500, rid=3)
    (ev,) = [e for e in trace.events() if e["name"] == "reorder/park"]
    assert ev["ph"] == "X" and ev["dur"] == 1500


def test_ring_buffer_drops_oldest(tracer):
    try:
        trace.configure(enabled=True, capacity=8)
        for i in range(20):
            trace.instant(f"e{i}")
        evs = trace.events()
        assert len(evs) == 8
        assert evs[0]["name"] == "e12" and trace.dropped() == 12
    finally:
        trace.configure(enabled=True, capacity=trace._DEFAULT_CAPACITY)


def test_validate_rejects_malformed():
    assert trace.validate_chrome_trace({}) != []
    bad = {"traceEvents": [{"ph": "X", "name": "x", "ts": 0.0}]}
    assert any("dur" in p or "pid" in p or "tid" in p
               for p in trace.validate_chrome_trace(bad))


# ---------------------------------------------------------------------------
# trace determinism + overhead budget
# ---------------------------------------------------------------------------


def _traced_pipeline_structure(g, k):
    """(name, parent) multiset of one serial-packed pipeline run."""
    trace.reset()
    plan = pipeline.build_plan(g, order="hybrid")
    for _ in pipeline.stream_batches(plan, k, batch_size=64,
                                     pack_workers=0):
        pass
    return TallyCounter(trace.span_records())


def test_trace_structure_deterministic(tracer):
    g = small_graph()
    first = _traced_pipeline_structure(g, 4)
    assert first, "pipeline produced no spans"
    assert {"extract", "pack"} <= {name for name, _ in first}
    for _ in range(2):
        assert _traced_pipeline_structure(g, 4) == first


def test_trace_well_nested_under_load(tracer):
    # counting and listing queries from several threads at once, the
    # listing ones with their decode workers: every sync span must close
    g = small_graph(5)
    errors = []

    def query(k, mode):
        try:
            kw = dict(devices=["cpu", "cpu"], pack_workers=2)
            if mode == "count":
                ebbkc.count(g, k, engine_kwargs=kw)
            else:
                ebbkc.list_cliques(g, k, engine_kwargs=kw)
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    threads = [threading.Thread(target=query, args=(k, mode))
               for k in (3, 4) for mode in ("count", "list")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    doc = trace.chrome_trace()
    assert trace.validate_chrome_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"device/harvest", "device/wait", "decode"} <= names


def test_disabled_tracer_overhead_budget():
    # the contract: tracing disabled adds <= 1% to the engine's work.
    # Measured as (per-disabled-span cost) * (spans the workload emits),
    # which is robust where wall-clock diffing is noise-dominated.
    g = small_graph(23)
    trace.configure(enabled=False)
    kw = dict(devices=["cpu"], batch_size=64)

    def workload():
        t0 = time.perf_counter()
        engine_torch.count(g, 4, **kw)
        return time.perf_counter() - t0

    workload()  # warm the plan cache

    trace.configure(enabled=True)
    trace.reset()
    engine_torch.count(g, 4, **kw)
    n_spans = len(trace.events())
    names = TallyCounter(ev["name"] for ev in trace.events())
    trace.configure(enabled=False)
    trace.reset()
    assert n_spans > 0
    # the budget counts device/stage's children, one of each a batch
    assert names["stage/place"] == names["stage/copy"] == \
        names["count/step"] == names["device/stage"] > 0

    def span_round(n_iter):
        t0 = time.perf_counter()
        for _ in range(n_iter):
            with trace.span("x", a=1):
                pass
        return (time.perf_counter() - t0) / n_iter

    # Both sides are timed alike: a span round is sized to last about as
    # long as one workload run, the two alternate, and the least of each
    # is kept.  Under load a long round is preempted far more often than
    # a short one, so rounds of unequal length would charge the machine's
    # load to the spans alone.
    n_iter = max(100, int(workload() / span_round(1000)))
    work, spans = [], []
    for _ in range(15):
        work.append(workload())
        spans.append(span_round(n_iter))
    work_s, per_call = min(work), min(spans)
    overhead = per_call * n_spans
    assert overhead <= 0.01 * work_s, (
        f"disabled tracing would add {overhead * 1e3:.3f}ms over "
        f"{n_spans} spans to a {work_s * 1e3:.1f}ms workload (> 1%)"
    )


def test_engine_trace_covers_device_stages(tracer):
    g = small_graph(31)
    engine_torch.count(g, 4, batch_size=64, devices=["cpu", "cpu"])
    names = {name for name, _ in trace.span_records()}
    assert {"extract", "pack", "device/stage", "device/harvest",
            "combine"} <= names
    doc = trace.chrome_trace()
    assert trace.validate_chrome_trace(doc) == []
    # device spans carry kernel-signature attribution
    rows = aggregate_device_spans(doc)
    assert rows and any(r["flops"] > 0 for r in rows)
    assert all(r["sig"].startswith("count[l=2,T=") and
               r["sig"].endswith(",backend=torch:cpu]") for r in rows)


@pytest.mark.parametrize("mode", ["count", "list"])
def test_device_stage_children_nest_on_cpu_lanes(tracer, mode):
    g = small_graph(43)
    kw = dict(devices=["cpu"], batch_size=4, pack_workers=0)
    if mode == "count":
        stats = ebbkc.count(g, 4, engine_kwargs=kw).stats
        step = "count/step"
    else:
        rows, stats = ebbkc.list_cliques(g, 4, engine_kwargs=kw)
        step = "list/step"
        assert stats.decode_backlog_s >= 0.0
    recs = TallyCounter(trace.span_records())
    n = recs[("device/stage", None)]
    assert n > 1
    for child in ("stage/place", "stage/copy", step):
        assert recs[(child, "device/stage")] == n, child
    assert recs[("list/collect", None)] == (mode == "list")
    # no CUDA lane: no timing events, nothing on a lane track
    assert stats.kernel_device_s == 0.0 and stats.staging_overlap_s == 0.0
    assert not [e for e in trace.events() if e["ph"] in ("b", "e")]


def test_lane_counters_merge_and_publish(registry):
    a = Stats(kernel_device_s=0.5, decode_backlog_s=0.25)
    assert a.merge(Stats(kernel_device_s=0.25, decode_backlog_s=0.5)) is a
    assert (a.kernel_device_s, a.decode_backlog_s) == (0.75, 0.75)
    obs_metrics.observe_stats(a, "repro_engine", registry)
    got = {m.name: m.value for m in registry.collect()}
    assert got["repro_engine_kernel_device_s_total"] == 0.75
    assert got["repro_engine_decode_backlog_s_total"] == 0.75


#: the benchmark's readers of this layer's spans and counters
_READERS = ["stage_offcpu_s.count", "stage_copy_s.count",
            "step_enqueue_s.count", "kernel_device_ms.count",
            "decode_offcpu_s.list", "decode_backlog_s.list",
            "collect_s.list"]


@pytest.mark.parametrize("metric", _READERS)
def test_span_and_counter_readers(metric):
    from bench import harness
    read = harness.load_reader(metric)
    assert read(harness.Context({}, 0.0, 0.0, 0.0, [])) is None
    names = ("device/stage", "stage/copy", "count/step", "decode",
             "list/collect")
    spans = [dict(name=n, ts=0, dur=3_000_000_000, cpu=1_000_000_000, tid=1)
             for n in names]
    q = harness.Query(1.0, Stats(kernel_device_s=0.002, decode_backlog_s=0.5))
    assert read(harness.Context({}, 1.0, 0.0, 2.0, [q, q], spans)) > 0
    # what a program without the fields records reads as nothing
    bare = [{k: v for k, v in ev.items() if k != "cpu"} for ev in spans
            if ev["name"] in ("device/stage", "decode")]
    old = harness.Query(1.0, object())
    assert read(harness.Context({}, 1.0, 0.0, 2.0, [old], bare)) is None


# ---------------------------------------------------------------------------
# Stats.merge (the single classification table)
# ---------------------------------------------------------------------------


def test_stats_merge_all_fields_classified():
    # tripwire: adding a Stats field without classifying it must fail
    # loudly in merge, not silently drift between merge and metrics
    fields = {f.name for f in dataclasses.fields(Stats)}
    assert fields == set(Stats._MERGE_KINDS)
    assert fields == set(Stats._METRIC_KINDS)
    assert Stats._MERGE_KINDS["retries"] == "sum"
    assert Stats._MERGE_KINDS["demotions"] == "sum"


def test_stats_merge_combines():
    a = Stats(branches=2, peak_graph=10, device_tiles={0: 3},
              spill_sizes=[4], backend="torch:cpu", plan_cache_hit=False,
              pack_queue_occupancy=0.5, retries=1)
    b = Stats(branches=3, peak_graph=7, device_tiles={0: 1, 1: 2},
              spill_sizes=[9], backend="torch:cpu", plan_cache_hit=True,
              pack_queue_occupancy=0.75, retries=2, demotions=4)
    a.merge(b)
    assert a.branches == 5
    assert a.peak_graph == 10
    assert a.device_tiles == {0: 4, 1: 2}
    assert a.spill_sizes == [4, 9]
    assert a.plan_cache_hit is True
    assert a.pack_queue_occupancy == 0.75
    assert a.backend == "torch:cpu"
    assert (a.retries, a.demotions) == (3, 4)


def test_stats_merge_rejects_unclassified():
    @dataclasses.dataclass
    class Odd(Stats):
        novel_field: int = 0

    with pytest.raises(TypeError, match="novel_field"):
        Odd().merge(Odd())


def test_stats_merge_keeps_info_identity():
    a, b = Stats(), Stats(backend="torch:cuda")
    a.merge(b)
    assert a.backend == "torch:cuda"  # empty self adopts other's identity
    a.merge(Stats(backend="torch:cpu"))
    assert a.backend == "torch:cuda"  # non-empty self wins


# ---------------------------------------------------------------------------
# metrics registry + exposition
# ---------------------------------------------------------------------------


def test_counter_gauge_histogram(registry):
    c = registry.counter("repro_t_total", help="h")
    c.inc(3)
    c.inc()
    assert c.value == 4
    with pytest.raises(ValueError):
        c.inc(-1)
    g = registry.gauge("repro_g")
    g.set(2.5)
    g.set_max(1.0)
    assert g.value == 2.5
    h = registry.histogram("repro_h", edges=[1.0, 2.0])
    for v in (0.5, 1.5, 99.0):
        h.observe(v)
    counts, total, n = h.snapshot()
    assert counts == [1, 1, 1] and n == 3 and total == pytest.approx(101.0)


def test_registry_get_or_create_and_label_identity(registry):
    a = registry.counter("repro_x_total", key="0")
    b = registry.counter("repro_x_total", key="0")
    c = registry.counter("repro_x_total", key="1")
    assert a is b and a is not c
    with pytest.raises(TypeError):
        registry.gauge("repro_x_total", key="0")


def test_observe_stats_and_publish_totals(registry):
    st = Stats(branches=4, device_tiles={0: 2, 1: 1}, spilled_tiles=1,
               peak_graph=9, plan_cache_hit=True, backend="torch:cpu",
               retries=3)
    obs_metrics.observe_stats(st, "repro_engine", registry)
    obs_metrics.observe_stats(st, "repro_engine", registry)
    got = {(m.name, m.labels): m for m in registry.collect()}
    assert got[("repro_engine_branches_total", ())].value == 8
    assert got[("repro_engine_device_tiles_total",
                (("key", "0"),))].value == 4
    assert got[("repro_engine_peak_graph", ())].value == 9
    assert got[("repro_engine_retries_total", ())].value == 6
    assert got[("repro_engine_plan_cache_hits_total", ())].value == 2
    # publish_totals is absolute, not additive
    reg2 = obs_metrics.Registry()
    obs_metrics.publish_totals(st, "repro_engine", reg2)
    obs_metrics.publish_totals(st, "repro_engine", reg2)
    got2 = {m.name: m for m in reg2.collect()}
    assert got2["repro_engine_branches_total"].value == 4


def _parse_exposition(text):
    """Minimal 0.0.4 parser: {metric-with-labels: value}; validates shape."""
    out = {}
    types = {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE"):
            _, _, name, kind = line.split()
            assert kind in ("counter", "gauge", "histogram"), line
            types[name] = kind
        elif line.startswith("#"):
            assert line.startswith("# HELP"), line
        else:
            key, val = line.rsplit(" ", 1)
            float(val)  # must parse
            out[key] = float(val)
    return out, types


def test_prometheus_render_parses(registry):
    registry.counter("repro_a_total", help="things").inc(2)
    registry.gauge("repro_b", key="x").set(1.5)
    registry.histogram("repro_c_seconds", edges=[0.1, 1.0]).observe(0.05)
    text = render_prometheus(registry)
    values, types = _parse_exposition(text)
    assert values['repro_a_total'] == 2
    assert values['repro_b{key="x"}'] == 1.5
    assert types["repro_c_seconds"] == "histogram"
    assert values['repro_c_seconds_bucket{le="+Inf"}'] == 1
    assert values["repro_c_seconds_count"] == 1
    # histogram buckets are cumulative and ordered
    assert values['repro_c_seconds_bucket{le="0.1"}'] <= \
        values['repro_c_seconds_bucket{le="1"}']


def test_metrics_server_scrape(registry):
    registry.counter("repro_up_total").inc()
    calls = []
    registry.add_collector(lambda: calls.append(1))
    srv = MetricsServer(port=0, registry=registry)
    try:
        text = scrape(srv.address)
    finally:
        srv.close()
    assert calls, "collector did not run at scrape time"
    values, _ = _parse_exposition(text)
    assert values["repro_up_total"] == 1


def test_note_kernel_attribution(registry):
    note_kernel("count[l=3,T=64,B=256,backend=torch:cuda]", compile_s=0.5,
                registry=registry)
    note_kernel("count[l=3,T=64,B=256,backend=torch:cuda]", execute_s=0.25,
                calls=1, flops=1e9, nbytes=1e6, registry=registry)
    got = {m.name for m in registry.collect()}
    assert "repro_kernel_compile_seconds_total" in got
    assert "repro_kernel_execute_seconds_total" in got


def test_setup_logging_idempotent():
    root = setup_logging("info")
    n = len(root.handlers)
    assert setup_logging("debug") is root
    assert len(root.handlers) == n
    log = get_logger("test_obs")
    assert log.name == "repro.test_obs"
    with pytest.raises(ValueError):
        setup_logging("shout")


# ---------------------------------------------------------------------------
# the port's hooks against the reference's
# ---------------------------------------------------------------------------


def _span_names(tracer_mod, query):
    """The complete-span names one traced query passes through."""
    tracer_mod.configure(enabled=True)
    tracer_mod.reset()
    try:
        query()
        return {name for name, _ in tracer_mod.span_records()}
    finally:
        tracer_mod.configure(enabled=False)
        tracer_mod.reset()


#: spans of the reference that a CPU run of the port does not have: the
#: reference jit-compiles its device step on the CPU too, where the port
#: builds its kernel library only for a CUDA lane (kernel/compile)
_REFERENCE_ONLY = {"kernel/compile"}
#: spans of the port that the reference does not have: the children of
#: the dispatchers' ``device/stage`` and their launches, and the front
#: door's collection of a listing's rows
_PORT_ONLY = {"stage/copy", "stage/place", "count/step", "list/step",
              "list/collect"}


@pytest.mark.parametrize("mode", ["count", "list", "list-inline"])
def test_traced_query_spans_match_reference(mode):
    """The same query on the same graph passes through the same stage
    spans in both packages (cold plan, serial packing)."""
    n, p, seed, k = 60, 0.25, 4, 4
    g = tgraphs.erdos_renyi(n, p, seed=seed)
    jg = jgraphs.erdos_renyi(n, p, seed=seed)
    pipeline.clear_plan_cache()
    jpipeline.clear_plan_cache()
    kw = dict(batch_size=32, pack_workers=0)
    if mode == "count":
        port_q = lambda: engine_torch.count(g, k, devices=["cpu"], **kw)  # noqa: E731
        ref_q = lambda: jengine_jax.count(jg, k, devices="all",  # noqa: E731
                                          backend="lax", **kw)
    else:
        dev = dict(devices=["cpu"]) if mode == "list" else {}
        jdev = dict(devices="all") if mode == "list" else {}
        port_q = lambda: listing.stream_cliques(  # noqa: E731
            g, k, listing.ArraySink(k), device="cpu", **dev, **kw)
        ref_q = lambda: jlisting.stream_cliques(  # noqa: E731
            jg, k, jlisting.ArraySink(k), backend="lax", **jdev, **kw)
    got = _span_names(trace, port_q) - _PORT_ONLY
    want = _span_names(jtrace, ref_q) - _REFERENCE_ONLY
    assert "plan/build" in got and "extract" in got
    assert got == want


def test_kernel_records_count_one_call_per_harvested_batch():
    g = small_graph(37)
    obs_profile.reset_kernels()
    res = engine_torch.count(g, 4, batch_size=16, pack_workers=0,
                             devices=["cpu", "cpu"])
    recs = obs_profile.kernel_records()
    obs_profile.reset_kernels()
    assert recs and all(r["sig"].startswith("count[l=2,") for r in recs)
    batches = sum(1 for b in pipeline.stream_batches(
        pipeline.cached_plan(g), 4, batch_size=16, pack_workers=0)
        if isinstance(b, pipeline.TileBatch))
    assert sum(r["calls"] for r in recs) == batches > 1
    assert res.count == ebbkc.count(g, 4, backend="host").count
    assert res.stats.retries == res.stats.demotions == 0


def test_profile_span_captures_a_chrome_trace(tmp_path, tracer):
    g = small_graph(41)
    with obs_profile.profile_span("query", out_dir=str(tmp_path), k=4):
        engine_torch.count(g, 4, device="cpu")
    files = list(tmp_path.glob("query.*.pt.trace.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    assert doc["traceEvents"]
    (span,) = [e for e in trace.events() if e["name"] == "query"]
    assert span["args"] == {"k": 4}


def test_cli_trace_metrics_and_log_level(tmp_path, capsys):
    out = tmp_path / "trace.json"
    rc = clique.main(["--graph", "er:120,0.1", "--k", "4", "--device", "cpu",
                      "--devices", "2", "--verify", "--trace-out", str(out),
                      "--metrics-port", "0", "--log-level", "info"])
    text = capsys.readouterr().out
    assert rc == 0 and "match=True" in text and "metrics: http://" in text
    doc = json.loads(out.read_text())
    assert trace.validate_chrome_trace(doc) == []
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"plan/build", "extract", "pack", "device/stage",
            "device/harvest", "combine"} <= names
    assert not trace.enabled()  # main leaves the tracer as it found it
    got = {m.name for m in obs_metrics.REGISTRY.collect()}
    assert "repro_engine_device_tiles_total" in got
    rows = aggregate_device_spans(doc)
    assert rows and all("backend=torch:cpu" in r["sig"] for r in rows)
    assert np.isfinite(sum(r["execute_s"] for r in rows))
