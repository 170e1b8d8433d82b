"""k-clique counting and listing from the command line, on the port's
device engines.

``python -m repro_torch.launch.clique --graph rmat:12 --k 5 --verify``
``python -m repro_torch.launch.clique --graph rmat:10 --k 5 --list --verify``

Host preprocessing (truss order cached in a PipelinePlan) -> vectorized
extraction + capacity-batched packing on a pool of pack threads -> LPT
cost-balanced placement of packed batches on lanes (one CUDA stream each,
``repro_torch.runtime.dispatch``) with double-buffered staging -> the CUDA
kernels -> exact host combine.  Oversize tiles spill to the host
recursion.  ``--devices`` (default ``all``: every visible CUDA device, one
lane each) takes a lane count; ``--offline-lpt`` materializes the batches
and maps ``schedule_batches`` bins one-to-one onto lanes (and prints the
balance); ``--shard-map`` splits each batch by rows over the lanes;
``--sync-staging`` harvests every batch before the next is staged.
``--list`` lists the cliques through the list kernel instead (``--sink
PATH`` writes them to an NPZ, ``--max-out N`` stops after N).  It runs on
the CUDA device; ``--device cpu`` runs the plain torch versions instead,
with ``--devices N`` as N CPU lanes (``all`` is one).

Observability and resilience, as in the reference launcher:
``--trace-out PATH`` records a span trace of the run and writes it as
Chrome/Perfetto trace_event JSON, ``--metrics-port PORT`` serves
Prometheus ``/metrics`` on 127.0.0.1 for the run (0 = any free port),
``--log-level`` sets the ``repro.*`` loggers' level, and ``--fault-plan
SPEC`` arms seeded fault injection (``seed=7;*=0.1;kernel.launch=0.3``):
counts and rows stay exact through retries (and, on CPU lanes,
demotions to the host); on the card a launch whose retries run out
raises.

Still to be ported from the reference launcher: ``--backend``,
``--plan-cache``, ``--tune-cache``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..core import ebbkc, engine_torch, listing, pipeline
from ..core import tiles as tiles_mod
from ..core.engine_np import Stats
from ..core.graph import Graph
from ..data import graphs as gdata
from ..obs import metrics as obs_metrics
from ..obs import trace
from ..obs.export import MetricsServer
from ..obs.logging import LEVELS, get_logger, setup_logging
from ..resilience import inject
from ..runtime.dispatch import Dispatcher, dispatch_scheduled, resolve_devices


def load_graph(desc: str) -> Graph:
    """The reference launcher's graph specs: ``rmat:S``, ``er:n,p``,
    ``powerlaw:n``, ``planted:n`` (seed 7)."""
    kind, _, arg = desc.partition(":")
    if kind == "rmat":
        return gdata.rmat_graph(int(arg or 12), edge_factor=8, seed=7)
    if kind == "er":
        n, p = arg.split(",")
        return gdata.erdos_renyi(int(n), float(p), seed=7)
    if kind == "powerlaw":
        return gdata.powerlaw_graph(int(arg or 2000), 16, seed=7)
    if kind == "planted":
        return gdata.planted_cliques(int(arg or 2000), 30, 12, seed=7)
    raise ValueError(f"unknown graph spec {desc}")


def parse_devices(spec: str, device):
    """The lanes of ``--devices``: "all" or an int count.  On a CUDA
    ``device`` they are CUDA devices (clamped to those available); on the
    CPU, N CPU lanes ("all" is one)."""
    if device.type == "cpu":
        return [device] * (1 if spec == "all" else int(spec))
    return resolve_devices("all" if spec == "all" else int(spec))


def _finish_obs(args, stats, metrics_server) -> None:
    """Flush the run's observability: publish its stats, export the trace,
    stop the metrics server."""
    if stats is not None:
        obs_metrics.observe_stats(stats)
    if args.trace_out:
        trace.export(args.trace_out)
        print(f"trace: wrote {args.trace_out} "
              f"({len(trace.events())} events, "
              f"{trace.dropped()} dropped)")
    if metrics_server is not None:
        metrics_server.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="rmat:12")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--order", default="hybrid")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="tiles per packed batch (default 256)")
    ap.add_argument("--pack-workers", type=int, default=None,
                    help="parallel pack-producer threads (default auto; "
                         "0 = serial inline packing)")
    ap.add_argument("--device", default="cuda",
                    help='torch device to count on (default "cuda"; '
                         '"cpu" runs the plain torch versions)')
    ap.add_argument("--devices", default="all",
                    help='"all" or lane count (clamped to the CUDA devices '
                         'available; with --device cpu, N CPU lanes)')
    ap.add_argument("--shard-map", action="store_true",
                    help="split each batch by rows over the lanes instead "
                         "of LPT-placing whole batches on lanes")
    ap.add_argument("--offline-lpt", action="store_true",
                    help="materialize all batches, then map "
                         "schedule_batches LPT bins one-to-one onto lanes "
                         "(prints balance; default is streaming online-LPT "
                         "dispatch, which overlaps packing with device "
                         "execution and keeps host memory bounded)")
    ap.add_argument("--sync-staging", action="store_true",
                    help="disable double-buffered host->device staging")
    ap.add_argument("--list", action="store_true", dest="list_mode",
                    help="list the cliques through the list kernel instead "
                         "of counting them")
    ap.add_argument("--sink", default=None, metavar="PATH",
                    help="with --list: write the cliques to PATH as an NPZ "
                         "(key 'cliques'); default is an in-memory buffer")
    ap.add_argument("--max-out", type=int, default=None,
                    help="with --list: stop after this many cliques")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="chaos mode: seeded fault-injection plan for "
                         "repro_torch.resilience (e.g. 'seed=7;*=0.1;"
                         "kernel.launch=0.3'); results stay exact via "
                         "retry (and demotion on CPU lanes); also "
                         "settable via REPRO_TORCH_FAULT_PLAN")
    ap.add_argument("--verify", action="store_true",
                    help="cross-check against the host engine")
    ap.add_argument("--log-level", default="warning", choices=list(LEVELS),
                    help="repro.* logger verbosity (obs/logging)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record a structured span trace of the whole run "
                         "and write it as Chrome/Perfetto trace_event JSON "
                         "(open at https://ui.perfetto.dev)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve Prometheus /metrics on 127.0.0.1:PORT for "
                         "the run's duration (0 = ephemeral port)")
    args = ap.parse_args(argv)

    setup_logging(args.log_level)
    log = get_logger("launch.clique")
    if args.trace_out:
        trace.configure(enabled=True)
    metrics_server = None
    if args.metrics_port is not None:
        metrics_server = MetricsServer(port=args.metrics_port)
        print(f"metrics: {metrics_server.address}/metrics")
    if args.fault_plan:
        inject.configure(args.fault_plan)
        print(f"fault injection: {args.fault_plan}")
    try:
        g = load_graph(args.graph)
        log.info("loaded %s: n=%d m=%d", args.graph, g.n, g.m)
        print(f"graph: n={g.n} m={g.m}")
        device = engine_torch.resolve_device(args.device)
        devices = parse_devices(args.devices, device)
        t0 = time.perf_counter()
        plan = pipeline.cached_plan(g, order=args.order)
        t_plan = time.perf_counter() - t0
        if args.list_mode:
            rc, stats = _list(args, g, plan, devices)
        else:
            rc, stats = _count(args, g, plan, devices, t_plan)
        _finish_obs(args, stats, metrics_server)
        metrics_server = None
        return rc
    finally:
        # an in-process caller gets the process back as it was: the
        # tracer off, no fault plan armed, no server left listening
        if metrics_server is not None:
            metrics_server.close()
        if args.trace_out:
            trace.configure(enabled=False)
        if args.fault_plan:
            inject.configure(None)


def _count(args, g: Graph, plan: pipeline.PipelinePlan, devices,
           t_plan: float):
    """Counting: stream the batches through the dispatcher (online or
    offline LPT); with ``--verify``, hold the total against the host
    engine.  Returns (exit code, the run's Stats)."""
    l = args.k - 2
    mesh = devices if args.shard_map else None
    stats = Stats()
    stage = {}
    stream = pipeline.stream_batches(plan, args.k, order=args.order,
                                     batch_size=args.batch_size,
                                     timings=stage,
                                     pack_workers=args.pack_workers,
                                     stats=stats)
    t0 = time.perf_counter()
    info = {}
    n_batches = 0
    n_tiles = 0
    total = 0
    try:
        if args.offline_lpt:
            # materialize, then scheduler bins become real lanes
            batches = []
            for item in stream:
                if isinstance(item, tiles_mod.Tile):
                    n_tiles += 1
                    total += engine_torch.count_spilled(
                        item, args.order, l, stats, et_t=3, use_rule2=True)
                else:
                    batches.append(item)
                    n_tiles += item.B
            n_batches = len(batches)
            got, info = dispatch_scheduled(
                batches, l, devices, mesh=mesh,
                async_staging=not args.sync_staging, stats=stats,
                stage_times=stage)
            total += got
        else:
            # streaming: pack(i+1) on the host overlaps kernel(i) on lanes
            disp = Dispatcher(l, devices, mesh=mesh,
                              async_staging=not args.sync_staging,
                              stats=stats, stage_times=stage)
            for item in stream:
                if isinstance(item, tiles_mod.Tile):
                    n_tiles += 1
                    total += engine_torch.count_spilled(
                        item, args.order, l, stats, et_t=3, use_rule2=True)
                else:
                    n_batches += 1
                    n_tiles += item.B
                    disp.submit(item)
            total += disp.finish()
    finally:
        stream.close()  # stops the pack workers on error too
    t_count = time.perf_counter() - t0
    # packing is interleaved with counting; stream_batches bills it apart
    t_pack = stage.get("extract", 0.0) + stage.get("pack", 0.0)
    balance = info.get("max_over_mean")
    bal_txt = f" balance max/mean={balance:.3f}" if balance else ""
    print(f"batches={n_batches} tiles={n_tiles} "
          f"spilled={stats.spilled_tiles} devices={len(devices)}"
          f"{' (shard_map)' if mesh is not None else ''}{bal_txt}")
    per_dev = " ".join(
        f"d{d}:{stats.device_tiles[d]}t/{stats.device_flops[d] / 1e6:.0f}MF"
        for d in sorted(stats.device_tiles))
    print(f"device tiles/flops: {per_dev or '-'} "
          f"staging_overlap={stats.staging_overlap_s:.2f}s "
          f"backend={stats.backend} compile={stats.kernel_compile_s:.2f}s "
          f"pack_workers={stats.pack_workers} "
          f"queue_occ={stats.pack_queue_occupancy:.2f}")
    print(f"k={args.k}: {total} cliques "
          f"(plan {t_plan:.2f}s, front-to-finish {t_count:.2f}s, "
          f"of which extract+pack {t_pack:.2f}s, "
          f"device {stage.get('device', 0.0):.2f}s)")
    print(f"retries={stats.retries} demotions={stats.demotions}")
    if args.verify:
        ref = ebbkc.count(g, args.k, order=args.order, plan=plan,
                          backend="host").count
        print(f"host engine: {ref}  match={ref == total}")
        if ref != total:
            return 1, stats
    return 0, stats


def _list(args, g: Graph, plan: pipeline.PipelinePlan, devices):
    """``--list``: stream the cliques into the sink; with ``--verify``,
    hold the rows as a set against the host recursion's and their number
    against the host count.  Returns (exit code, the run's Stats)."""
    sink = (listing.NpzSink(args.sink, args.k, max_out=args.max_out)
            if args.sink else listing.ArraySink(args.k, max_out=args.max_out))
    stage = {}
    t0 = time.perf_counter()
    res = listing.stream_cliques(plan, args.k, sink, order=args.order,
                                 batch_size=args.batch_size,
                                 pack_workers=args.pack_workers,
                                 stage_times=stage, devices=devices,
                                 async_staging=not args.sync_staging)
    t_list = time.perf_counter() - t0
    sink.close()
    st = res.stats
    rate = st.emitted_cliques / max(t_list, 1e-9)
    print(f"k={args.k}: listed {st.emitted_cliques} cliques in "
          f"{t_list:.2f}s ({rate:.0f} cliques/s, {st.sink_bytes} sink bytes"
          f"{', -> ' + args.sink if args.sink else ''})")
    print(f"tiles={res.tiles} spilled={st.spilled_tiles} "
          f"overflowed={st.overflowed_tiles} devices={len(devices)} "
          f"backend={st.backend} "
          f"pack_workers={st.pack_workers} device={stage.get('device', 0.0):.2f}s "
          f"decode={stage.get('decode', 0.0):.2f}s "
          f"retries={st.retries} demotions={st.demotions}")
    if not args.verify:
        return 0, st
    rows = (np.load(args.sink)["cliques"] if args.sink else sink.result())
    host, _ = ebbkc.list_cliques(g, args.k, order=args.order, plan=plan,
                                 backend="host")
    ref = ebbkc.count(g, args.k, order=args.order, plan=plan,
                      backend="host").count
    want = ref if args.max_out is None else min(args.max_out, ref)
    host_set = set(map(tuple, host.tolist()))
    got_set = set(map(tuple, rows.tolist()))
    ok = (rows.shape[0] == st.emitted_cliques == want
          and len(got_set) == rows.shape[0] and got_set <= host_set
          and (args.max_out is not None or got_set == host_set))
    print(f"host count: {ref}  match={ok}")
    return (0 if ok else 1), st


if __name__ == "__main__":
    raise SystemExit(main())
