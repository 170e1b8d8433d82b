"""The multi-tenant clique-analytics service on the PyTorch/CUDA port.

The twin of ``examples/clique_service.py`` on ``repro_torch``:

  1. ingest a stream of graph snapshots (synthetic RMAT / power-law) and
     register each with a long-lived ``repro_torch.serve.CliqueService``;
  2. submit every tenant's queries CONCURRENTLY -- exact counts at
     several k, plus a materializing "top-N k-cliques containing vertex
     v" listing query per snapshot, each with its own latency deadline;
  3. the service coalesces ready tiles from different requests into
     shared device batches on its lanes (CUDA streams: every card by
     default, raising without one), schedules pulls EDF-first under the
     deadlines, and routes exact counts / clique rows back to
     per-request sinks;
  4. each snapshot's plan is built once (in-process cache, plus an
     on-disk store with --plan-cache);
  5. the run ends with per-request latencies and the service's own
     accounting (fused batches, cross-request batches, deadline misses).

    PYTHONPATH=src python examples/clique_service_torch.py --snapshots 3 --k 5
    # without a card, on one CPU lane (the plain torch versions):
    PYTHONPATH=src python examples/clique_service_torch.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.data import powerlaw_graph, rmat_graph
from repro_torch.obs import trace
from repro_torch.obs.logging import LEVELS, setup_logging
from repro_torch.serve import CliqueService


def snapshot(i: int):
    """Synthetic tenant graph stream: alternating RMAT / power-law."""
    if i % 2 == 0:
        return f"rmat-{i}", rmat_graph(11, 6, seed=100 + i)
    return f"powerlaw-{i}", powerlaw_graph(2500, 10, seed=100 + i)


def main():
    """Ingest snapshots, serve all tenants' queries concurrently."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--snapshots", type=int, default=3)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--topn", type=int, default=5,
                    help="N for the top-N cliques-containing-v query")
    ap.add_argument("--deadline", type=float, default=30.0, metavar="S",
                    help="per-query latency deadline in seconds (EDF "
                         "scheduling + miss accounting, never cancellation)")
    ap.add_argument("--device", default=None,
                    help="one lane on this torch device (default: a lane "
                         "on every CUDA device, raising without one; 'cpu' "
                         "runs the plain torch versions)")
    ap.add_argument("--backend", default=None,
                    choices=["auto", "cuda", "torch", "ref", "autotune"],
                    help="kernel backend for all queries (default auto = "
                         "the CUDA kernels on the card)")
    ap.add_argument("--plan-cache", default=None, metavar="DIR",
                    help="on-disk plan store: a restarted service reloads "
                         "each snapshot's plan instead of re-decomposing")
    ap.add_argument("--tune-cache", default=None, metavar="DIR",
                    help="persistent autotuner directory (repro_torch.tune)")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="chaos mode: seeded repro_torch.resilience fault "
                         "plan (e.g. 'seed=7;*=0.1')")
    ap.add_argument("--log-level", default="warning", choices=list(LEVELS),
                    help="repro_torch logger verbosity (obs/logging)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto span trace of the whole "
                         "serving run (per-request async tracks included)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve Prometheus /metrics from the service on "
                         "127.0.0.1:PORT (0 = ephemeral port)")
    args = ap.parse_args()
    setup_logging(args.log_level)
    if args.trace_out:
        trace.configure(enabled=True)
    if args.tune_cache:
        from repro_torch import tune

        tune.configure(args.tune_cache)
    if args.fault_plan:
        from repro_torch.resilience import inject

        inject.configure(args.fault_plan)
        print(f"fault injection: {args.fault_plan}")

    svc = CliqueService(devices=None if args.device is None
                        else [args.device],
                        backend=None if args.backend == "auto"
                        else args.backend,
                        plan_cache_dir=args.plan_cache,
                        metrics_port=args.metrics_port)
    if svc.metrics_address:
        print(f"metrics: {svc.metrics_address}/metrics")
    graphs = {}
    for i in range(args.snapshots):
        name, g = snapshot(i)
        graphs[name] = g
        svc.register_graph(name, g)

    # every tenant submits at once: two counting queries plus the top-N
    # materializing query per snapshot, all inside one serving pipeline
    t0 = time.time()
    tickets = []
    for name, g in graphs.items():
        for k in (args.k, args.k + 1):
            tickets.append((name, f"count k={k}",
                            svc.submit(name, k, "count",
                                       deadline_s=args.deadline)))
        v = int(np.argmax(g.degrees()))
        tickets.append((name, f"top-{args.topn} {args.k}-cliques @ v={v}",
                        svc.submit(name, args.k, "list", vertex_filter=v,
                                   max_out=args.topn,
                                   deadline_s=args.deadline)))
    print(f"submitted {len(tickets)} concurrent queries over "
          f"{len(graphs)} snapshots (lanes: "
          f"{args.device or 'every CUDA device'})")

    for name, what, ticket in tickets:
        res = ticket.result()
        late = " LATE" if res.deadline_missed else ""
        if res.kind == "count":
            g = graphs[name]
            print(f"[{name}] {what}: {res.count} "
                  f"({res.count / max(g.n, 1):.2f}/vertex, "
                  f"{res.latency_s * 1e3:.0f}ms{late})")
        else:
            first = (f" first={res.rows[0].tolist()}"
                     if res.rows.shape[0] else "")
            print(f"[{name}] {what}: {res.rows.shape[0]} found "
                  f"({res.latency_s * 1e3:.0f}ms{late}){first}")
    wall = time.time() - t0

    s = svc.stats
    svc.close()
    if args.trace_out:
        trace.export(args.trace_out)
        print(f"trace: wrote {args.trace_out} "
              f"({len(trace.events())} events)")
    print(f"served {s.completed} requests in {wall:.2f}s: "
          f"{s.fused_batches} device batches "
          f"({s.cross_request_batches} cross-request, "
          f"{s.fused_chunks} chunks fused, {s.spill_tiles} host spills), "
          f"{s.deadline_missed} deadline misses")


if __name__ == "__main__":
    main()
