"""One benchmark run of one cell: set-up, measured window, verdict, result.

Everything a cell needs is found by name: its configuration in
``bench/configs/<config>.json``, its traffic mix in
``bench/traffic/<traffic>.json`` and each metric's reader in
``bench/metrics/<metric>.py``, as ``BENCHMARK.json`` names them.  A later
cell, mix or metric is added by adding files and entries.

A run builds the configuration's graph from the seed, builds the program's
plan and warms up with one whole query, then sends whole queries back to
back, one client in a closed loop, until ``seconds`` have passed; the query
running at that moment finishes and closes the window.  Once the window is
closed and the device's peak memory is read, the plain reference
(:mod:`bench.reference.kclique`) works every answer out again from the same
edge list, and the run is ``correct`` only if every count and every row
set is exact.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from . import graph500
from . import profiling
from .reference import kclique

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"

#: top-level module names that may not be loaded in a benchmark process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: environment variables that would change what the program does
PROGRAM_ENV = ("REPRO_TORCH_TUNE_CACHE", "REPRO_TORCH_BACKEND",
               "REPRO_TORCH_FAULT_PLAN")


def load_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_json(kind: str, name: str) -> dict:
    """``bench/<kind>/<name>.json`` (kind: configs or traffic)."""
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: end-to-end ones untraced,
    per-layer ones traced, each where its ``workloads`` (if any) has it."""
    group = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_reader(name: str) -> Callable[["Context"], Optional[float]]:
    """The ``read`` function of ``bench/metrics/<name>.py``, or, where
    that file is absent, of the file named by the part before the first
    dot: ``device_idle.count`` and ``device_idle.list``, one quantity split
    by the end-to-end metric it moves, share ``device_idle.py``.  Which
    cells report a metric is for its ``workloads`` in ``BENCHMARK.json``
    alone to say."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{name.partition('.')[0]}.py"
    mod_name = "bench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m for m in list(sys.modules)
                   if m.partition(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Query:
    """One whole query of the window."""
    wall_s: float
    stats: Any = None
    count: Optional[int] = None
    rows: Optional[np.ndarray] = None
    launches: int = 0
    error: Optional[str] = None


@dataclasses.dataclass
class Context:
    """What the metric readers read."""
    traffic: dict
    setup_s: float
    plan_build_s: float
    window_s: float
    queries: List[Query]
    spans: List[dict] = dataclasses.field(default_factory=list)
    device: Optional[profiling.DeviceProfile] = None


def _query_fn(traffic: dict, graph, plan, lanes: List[str]):
    from repro_torch.core import ebbkc
    k = int(traffic["k"])
    kw = {"devices": lanes}
    if traffic["query"] == "count":
        def run():
            res = ebbkc.count(graph, k, plan=plan, engine_kwargs=kw)
            return res.stats, res.count, None
    elif traffic["query"] == "list":
        def run():
            rows, stats = ebbkc.list_cliques(graph, k, plan=plan,
                                             engine_kwargs=kw)
            return stats, None, rows
    else:
        raise ValueError(f"unknown query {traffic['query']!r}")
    return run


def host_sample() -> Dict[str, float]:
    """CPU seconds so far, to be differenced around a query: ``cpu`` of
    this process, ``main`` of the calling thread (the program's consumer)
    and, where ``/proc`` gives it, ``native`` of the threads that Python
    did not start (torch's OpenMP pool, CUDA's helpers).  The same work
    taking more CPU seconds in every thread points at the host; more wall
    at the same CPU seconds, at waits inside the process."""
    out = {"cpu": time.process_time(), "main": time.thread_time()}
    try:
        python = {t.native_id for t in threading.enumerate()}
        native = 0
        for tid in os.listdir("/proc/self/task"):
            if int(tid) in python:
                continue
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            native += int(fields[11]) + int(fields[12])
        out["native"] = native / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        pass
    return out


def _host_line(before: Dict[str, float], after: Dict[str, float]) -> str:
    d = {k: after[k] - before[k] for k in after if k in before}
    line = f"{d['cpu']:.3f} cpu-s (consumer {d['main']:.3f}"
    if "native" in d:
        line += (f", native {d['native']:.2f}, pack and other Python "
                 f"{d['cpu'] - d['main'] - d['native']:.2f}")
    return line + ")"


def _launches() -> int:
    from repro_torch.kernels import ops
    return sum(ops.launch_counts().values())


def verdict(traffic: dict, n: int, edges: np.ndarray, queries: List[Query],
            device: str, log=None) -> Tuple[Dict[str, dict], int]:
    """``(checks, failed)``: the numbers compared, each
    ``{"value": v, "limit": 0}``, and how many queries raised or answered
    wrong.  The reference counts the k-cliques exactly on ``device``; a
    count query must return that count, and a list query exactly that many
    rows, each a valid clique, none twice."""
    k = int(traffic["k"])
    exact = kclique.count_kcliques(n, edges, k, device)
    if log is not None:
        log(f"reference: {exact} {k}-cliques")
    answered = [q for q in queries if q.error is None]
    failed = len(queries) - len(answered)
    checks = {"errors": failed}
    if traffic["query"] == "count":
        gaps = [abs(q.count - exact) for q in answered]
        failed += sum(g != 0 for g in gaps)
        checks["count_gap"] = max(gaps, default=0)
    else:
        keys = kclique.edge_keys(n, edges, device)
        gap = invalid = dups = 0
        for q in answered:
            c = kclique.check_rows(n, keys, q.rows)
            g = abs(c["rows"] - exact)
            failed += bool(g or c["invalid"] or c["duplicates"])
            gap = max(gap, g)
            invalid += c["invalid"]
            dups += c["duplicates"]
        checks.update(rows_gap=gap, invalid_rows=invalid,
                      duplicate_rows=dups)
    return {name: {"value": v, "limit": 0} for name, v in checks.items()}, failed


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, device: str = "cuda", t_start: Optional[float] = None,
             config: Optional[dict] = None, log=print) -> dict:
    """One run; returns the result line's object (``checks`` last).

    ``device`` is ``"cuda"`` on the card (one dispatcher lane a chip) or
    ``"cpu"`` (CPU lanes running the plain versions, for tests only);
    ``config`` overrides the cell's configuration file (tests only).
    """
    t_start = time.perf_counter() if t_start is None else t_start
    for var in PROGRAM_ENV:
        os.environ.pop(var, None)
    import torch
    from repro_torch.core import graph as graph_mod
    from repro_torch.core import pipeline
    from repro_torch.kernels import ops
    from repro_torch.obs import trace

    cell = find_cell(spec, cell_name)
    config = config or load_json("configs", cell["config"])
    traffic = load_json("traffic", cell["traffic"])
    chips = int(cell["chips"])
    on_card = device == "cuda"
    lanes = [f"cuda:{i}" for i in range(chips)] if on_card else ["cpu"] * chips
    if on_card:
        log(f"kernel library: {ops.build_library():.2f} s to load")
    n, edges = graph500.graph_for(config, seed)
    graph = graph_mod.from_edges(n, edges)
    t0 = time.perf_counter()
    plan = pipeline.build_plan(graph, config.get("order", "hybrid"))
    plan_build_s = time.perf_counter() - t0
    query = _query_fn(traffic, graph, plan, lanes)
    t0 = time.perf_counter()
    stats, count, rows = query()
    log(f"graph n={n} m={len(edges)}; plan {plan_build_s:.3f} s; warm-up "
        f"query {time.perf_counter() - t0:.3f} s; pack_workers="
        f"{stats.pack_workers}; lanes={lanes}; cpus={os.cpu_count()} "
        f"({len(os.sched_getaffinity(0))} usable); load {os.getloadavg()}")
    del stats, count, rows

    prof = None
    if traced:
        trace.configure(enabled=True, capacity=1 << 20)
        trace.reset()
        prof = profiling.Profiler(on_card)
        prof.start()
    ops.reset_counts()
    queries: List[Query] = []
    setup_s = time.perf_counter() - t_start
    w0 = time.perf_counter()
    with profiling.window(prof):
        while True:
            q0, h0 = time.perf_counter(), host_sample()
            l0 = _launches()
            try:
                stats, count, rows = query()
            except Exception:  # a query that raises fails; the window ends
                queries.append(Query(time.perf_counter() - q0,
                                     error=traceback.format_exc()))
                break
            queries.append(Query(time.perf_counter() - q0, stats, count, rows,
                                 _launches() - l0))
            log(f"query {len(queries)}: {queries[-1].wall_s:.3f} s, "
                f"{_host_line(h0, host_sample())}, frontend "
                f"{stats.frontend_s:.3f} worker-s")
            if time.perf_counter() - w0 >= seconds:
                break
    window_s = time.perf_counter() - w0
    spans: List[dict] = []
    profile = None
    if traced:
        spans = [ev for ev in trace.events() if ev.get("ph") == "X"]
        trace.configure(enabled=False)
        profile = prof.summary(spans, threading.get_ident())
    memory_peak = max(torch.cuda.max_memory_allocated(i)
                      for i in range(chips)) if on_card else 0
    for q in queries:
        if q.error:
            log(f"query failed:\n{q.error}")

    ctx = Context(traffic, setup_s, plan_build_s, window_s, queries, spans,
                  profile)
    metrics = {}
    for m in cell_metrics(spec, cell_name, traced):
        value = load_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    del plan, graph, query
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks, failed = verdict(traffic, n, edges, queries,
                             "cuda:0" if on_card else "cpu", log)
    log(f"reference verdict in {time.perf_counter() - t0:.3f} s")
    dev: Dict[str, Any] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": chips,
        "memory_peak_bytes": int(memory_peak),
    }
    if profile is not None:
        dev["busy_s"] = profile.busy_s
        dev["window_s"] = profile.window_s
    result = {"correct": passed(checks), "attempted": len(queries),
              "failed": failed, "metrics": metrics,
              "device": dev}
    if profile is not None:
        result["breakdown"] = profile.breakdown()
    result["checks"] = checks
    return result
