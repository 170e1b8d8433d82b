#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain torch version on the card, then drives
the port's paths through the entry points a user calls, each with the
kernel counters set to 0 just before it and read just after:

* counting -- ``repro_torch.core.ebbkc.count`` on its default device
  engine -- on a Graph500-shaped RMAT graph (scale 15, edge factor 16:
  n = 32,768, m = 441,769) for k = 5 (triangle kernel) and k = 7 (DFS
  kernel);
* listing -- ``repro_torch.core.ebbkc.list_cliques``' engine,
  ``listing.stream_cliques``, into a sink that hashes the rows -- on the
  same generator at scale 12 (n = 4,096, m = 48,484) for k = 5 (cold and
  warm plan; l = 3 triangle emit) and at scale 11 (n = 2,048) for k = 6
  (l = 4 DFS emit, with overflowed tiles relisted on the host);
* edge-branch candidates -- ``repro_torch.kernels.ops.edge_candidates``
  -- on every packed batch of the k = 5 listing, one edge of each tile;
* multi-lane dispatch (``[dispatch]``, ``repro_torch.runtime.dispatch``)
  on the warm plans: counting k = 7 on the scale-13 graph on one lane and
  on two lanes (two CUDA streams) of the card, k = 5 on the scale-12 graph
  split by rows over two lanes (``mesh=``) and k = 6 by offline LPT
  (``dispatch_scheduled``) over two lanes, and listing k = 5 on the
  scale-12 graph through the ``ListDispatcher`` on one lane (exact sizing)
  and on two lanes (speculative capacity), against the same counts and
  digests;

then runs the command-line launcher with ``--verify``, counting (through
the dispatcher, its default) and listing, and finally the phases below.
From ``[dispatch]`` on, the queries that [main] runs on the scale-15 graph
run on the same generator at scale 13 (n = 8,192, m = 101,992), so that
the whole smoke stays inside its time limit:

* observability (``[obs]``, ``repro_torch.obs``): the one-lane k = 7
  count traced (a valid Chrome trace through every stage span, traced
  wall beside untraced, ``kernel_records`` calls equal to the count
  kernel's launches, and the DFS count kernel's device seconds from the
  ``[dispatch]`` profiler window), the k = 6 listing of the listing phase,
  which runs traced (the host relist's span total), one scrape of a
  ``MetricsServer``, and a ``profile_span`` capture of the k = 5 count on
  the scale-12 graph (CUDA kernel events of the triangle kernel);
* resilience (``[resilience]``, ``repro_torch.resilience``): no query so
  far retried or demoted anything; under the plan ``seed=7;*=0.1`` the
  dispatched k = 6 count and k = 5 listing on the scale-12 graph stay
  exact; under ``kernel.launch=1.0`` a small graph's count and listing
  retry their first batch on the kernel and then raise, with no
  plain-version call and no host finish; a real error raised by a launch
  propagates undemoted;
* tile widths (``[widths]``): the ``-Xptxas -v`` report of the
  instantiations at W = 3, 5, 6, 7 (no spill in a full block), the four
  kernels at T = 96, 160, 192 and 224 on seeded tiles and on the
  main-path batches of a ``mult32`` stream (counting at k = 5 and 7 on
  the scale-15 graph, listing at k = 6 on the scale-12 graph), each
  against its plain version and timed beside the same tiles packed at
  the next power of two, and the k = 7 count of the scale-13 graph under
  the ``mult32`` ladder on the warm plan;
* plan persistence (``[persist]``): ``save_plan`` of the scale-15 plan,
  a fresh launcher process that loads it with ``--plan-cache`` and counts
  k = 5, and a corrupt scale-12 store (``plan.load=1.0:corrupt``)
  quarantined and rebuilt;
* the tuner (``[tune]``): ``tune_geometry`` for counting (l = 5) and
  listing (l = 3) persisted to a tune cache (the library of the build
  copied into it), a fresh launcher process that counts k = 7 on the
  scale-12 graph with ``--tune-cache`` on the tuned geometry without a
  search, and the ``autotune`` backend's kernel-vs-plain measurement,
  whose winner the card reports and does not obey;
* tiles wider than 256 (``[wide]``): the ``-Xptxas -v`` report of the
  kernels' wide path, the four kernels at T = 288, 512, 1056 and 2048
  against their plain versions and timed, and a count and a listing
  through bins (32, ..., 256, 512) on a complete multipartite graph whose
  widest tiles hold 258 vertices, against closed forms;
* dynamic graphs (``[delta]``): a ``PlanIndex`` on the scale-12 graph on
  the card through three repair batches and one past the churn
  threshold, each checked against a fresh plan, with its k = 5 delta
  exact by three counts and by its rows and its time split by the trace,
  the composed delta, and one 0.2 % batch on the scale-13 graph with its
  net count against the pinned one;
* the serving tier (``[serve]``): a ``CliqueService`` on the card with
  the scale-13 and scale-12 graphs registered, a burst of 8 client
  threads (counts and lists, filtered and truncated) on one lane, its
  scale-12 requests on two lanes (under the profiler), an update and a
  delta read, a metrics scrape, the scale-12 requests under the chaos
  plan (each exact or failed alone, then a clean request exact), and the
  same requests one at a time as the serial yardstick;
* the paper baseline (``[baseline]``): VBBkC (``vbbkc.count``, DDegCol
  and DDegCol+, a host recursion as in the reference) at k = 5 and 6 on
  the same generator at scale 11, each equal to the card's
  ``ebbkc.count`` and the pinned count, Lemma 4.1 by ``tau_delta_gap``,
  and ``examples/quickstart_torch.py`` in a fresh process on the card;
* the on-device truss (``[truss]``): ``truss_decomposition_torch`` on the
  scale-12 graph on the card, trussness and tau equal to the host
  peeler's, both times;
* the model substrate's serving path (``[lm serve]``):
  ``repro_torch.launch.serve`` at granite-3-8b's published widths (40
  layers, d = 4,096, f32 params, bf16 compute) for 8 requests of 32
  prompt tokens and 16 greedy tokens, prefill and one decode step against
  ``forward`` and the bf16 prefill against an f32 ``forward``, each within
  ``LM_ATOL``, three planted faults (a wrong position, another request's
  cache, a lost cache entry) each beyond it, every id inside the padded
  vocab, prefill and decode tok/s, peak memory and the device's busy share of
  one run under the profiler; and the reduced granite-3-8b
  and gemma3-27b configs (local windows) on the card against the port's
  CPU run on the same params.  The LM and truss paths run none of the
  four kernels (torch ops only, as the reference runs XLA ops there).

Any failure raises and exits non-zero.

Kernel times: ``device_ms`` is the device time of one call, from 100
calls of the bare C entry point (with the wrapper's zero fills) captured in
one CUDA graph and replayed between two CUDA events, so the host is out of
it; ``call_ms`` is one call timed by two events, which is what a caller
waits, host dispatch included; ``launch_floor_ms`` is the device time of
zeroing a one-element tensor, measured the same way: the least a launch
takes.

Output: the card's name and power limit, one line per phase, a
``{"kernels": [...]}`` JSON line with each kernel's launches on the main
path, its largest difference from the plain version, its times (``ms`` is
``device_ms``), the plain version's time, its lower bound and the library
yardstick's device time, and as the last line ``{"ok": true, "device":
{...}}``.  ``--json PATH`` also
writes every number to PATH.  Without a CUDA device,
or without the repository's ``src/`` beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Expected counts on rmat_graph(15, edge_factor=16, seed=7), from the JAX
# reference package on a CPU:
#   PYTHONPATH=src python -c "from repro.data.graphs import rmat_graph; \
#     from repro.core import engine_jax; g = rmat_graph(15, 16, seed=7); \
#     print(engine_jax.count(g, K, backend='lax').count)"
# with K = 5 and K = 7 (K = 7 takes about 5 minutes on a CPU).
RMAT_SCALE, RMAT_EDGE_FACTOR, RMAT_SEED = 15, 16, 7
EXPECTED = {5: 1_342_399_771, 7: 126_451_960_147}

# The phases after the main path ([dispatch], [obs], [widths], [delta],
# [serve]) run their queries on the same generator at scale 13 (n = 8,192,
# m = 101,992): a query there takes a few seconds where scale 15 takes
# about 20, which keeps the whole smoke inside its time limit.  Counts
# from the JAX reference package on a CPU, as above with scale 13 (42 s
# for both).
MID_SCALE = 13
EXPECTED_MID = {5: 102_427_518, 7: 3_790_711_418}

# Expected rows of listing rmat_graph(12, edge_factor=16, seed=7), hybrid
# order, default geometry, from the JAX reference package on a CPU:
#   PYTHONPATH=src python -c "import hashlib; \
#     from repro.data.graphs import rmat_graph; \
#     from repro.core.listing import stream_cliques, CallbackSink; \
#     h = hashlib.sha256(); g = rmat_graph(12, 16, seed=7); \
#     stream_cliques(g, K, CallbackSink(lambda r: h.update( \
#       r.astype('<i8').tobytes())), backend='lax'); print(h.hexdigest())"
# with K = 5 (20 s on a CPU) and K = 6 (279 s).  The digest is the SHA-256
# of every emitted (n, k) chunk as C-contiguous little-endian int64, in
# emit order; the row counts equal engine_jax.count(g, K, backend="lax").
LIST_SCALE = 12
EXPECTED_LIST = {
    5: (27_489_733,
        "f50e870070604910ec249ab410b73d63df19c6cb65f242c1cb67a708191e9522"),
    6: (146_073_205,
        "be3b0746468f912cc2ce3e21aa5c8320e8aede9ffb9bc3326941149689d5c790"),
}
# 7-cliques of rmat_graph(12, 16, seed=7), from the JAX reference on a
# CPU: engine_jax.count(rmat_graph(12, 16, seed=7), 7, backend="lax")
EXPECTED_12_K7 = 630_333_573
# The k = 6 listing runs on the same generator at scale 11 (n = 2,048),
# rows and digest from the JAX reference on a CPU as above (80 s there;
# 260 of its tiles overflow and are relisted on the host)
LIST6_SCALE = 11
EXPECTED_LIST6 = (
    27_035_982,
    "ef16a140f5b2d326dffc5215d3ede5310848fb95e690552493f3ee1a7ae36fb5")

# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit):
# 3.35 TB/s of HBM; 67 TFLOP/s of fp32 outside the tensor cores,
# which counts an FMA as two operations on 132 SMs x 128 lanes.  The int32
# units are half as many lanes, so 33.5e12 / 2 = 16.75e12 int32 operations
# a second; the kernels' AND / popcount / add work is counted against it.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12

BINS = (32, 64, 128, 256)

# launches captured in one CUDA graph by device_ms
GRAPH_CALLS = 100


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_header() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def call_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timings of one
    call each, after one warm-up call: what a caller waits for one call,
    the host's time to reach the launch included."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n: int = GRAPH_CALLS, reps: int = 5) -> float:
    """Device milliseconds of one call of ``fn``: ``n`` calls captured once
    in a CUDA graph and replayed between two CUDA events, the elapsed time
    over ``n``; the median of ``reps`` replays after a warm-up replay.  The
    host is out of the timing.  ``fn`` launches on the stream that is
    current when it is called and does not synchronise."""
    import torch
    side = torch.cuda.Stream()  # warm up on the capture stream, as the
    side.wait_stream(torch.cuda.current_stream())  # graph docs advise
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    graph.reset()
    return statistics.median(times)


_FLOOR = {}


def launch_floor_ms() -> float:
    """The launch floor: :func:`device_ms` of zeroing a one-element tensor,
    the least device time a launch takes.  Measured once a run."""
    import torch
    if "ms" not in _FLOOR:
        one = torch.zeros(1, device="cuda")
        _FLOOR["ms"] = device_ms(one.zero_)
    return _FLOOR["ms"]


def stream_ptr() -> int:
    """The current CUDA stream's handle (the capture stream inside a CUDA
    graph capture)."""
    import torch
    return torch.cuda.current_stream().cuda_stream


def check_rc(rc: int, name: str) -> None:
    if rc:
        fail(f"{name} launch failed: CUDA error {rc}")


def timed_once(fn):
    """(result, milliseconds) of one CUDA-event-timed call of ``fn``."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def seeded_tiles(seed: int, B: int, T: int, p: float):
    """Random symmetric tiles with the lanes the main path produces: an
    empty cand over a non-empty A (zeroed by the 2-plex router), a full
    cand (every word has bit 31 set, kept sparse), cands with holes."""
    import numpy as np
    from repro_torch.core.bitops import pack_bits
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((B, T, T)) < p, 1)
    dense = upper | upper.transpose(0, 2, 1)
    cmask = np.arange(T)[None, :] < rng.integers(0, T + 1, B)[:, None]
    cmask &= ~((rng.random((B, T)) < 0.2) & (np.arange(B)[:, None] % 2 == 1))
    cmask[0] = False
    cmask[1] = True
    keep = np.arange(T) % 4 == 0
    dense[1] &= keep[:, None] & keep[None, :]
    return pack_bits(dense), pack_bits(cmask)


def main_path_batches(plan, k: int, T: int, batch_size: int = 256,
                      zero_2plex: bool = True, bins=BINS):
    """The inputs the main path gives the kernels in bin ``T`` at ``k``:
    ``batch_size`` tiles spread evenly over the bin's stream order (its
    first tiles come from the densest, last-peeled edges and are nearly all
    2-plexes), and the bin's real last batch of ``n_tiles % batch_size``
    tiles.  Each is packed as the engine packs it; with ``zero_2plex`` the
    2-plex lanes are zeroed as ``count_packed`` zeroes them (the listing
    engine zeroes none).  ``bins`` is the ladder the stream routes by.
    Yields (tag, A, cand, live)."""
    import numpy as np
    import torch
    from repro_torch.convert import batch_to_torch
    from repro_torch.core import engine_torch, pipeline
    table = plan.table("hybrid")
    ids = table.select(k)
    sizes = table.offsets[ids + 1] - table.offsets[ids]
    lo = dict(zip(bins, (0,) + tuple(bins[:-1])))[T]
    sel = ids[(sizes > lo) & (sizes <= T)]
    picks = [("sample", sel[np.unique(np.linspace(
        0, sel.size - 1, min(batch_size, sel.size)).astype(np.int64))])]
    if sel.size > batch_size and sel.size % batch_size:
        picks.append(("tail", sel[sel.size - sel.size % batch_size:]))
    for which, chunk in picks:
        if chunk.size == 0:
            continue
        batch = pipeline._pack_batch(plan.g, table, chunk, T, "hybrid")
        A, cand = batch_to_torch(batch.A, batch.cand, "cuda")
        _, t, _ = engine_torch.plex_stats(A, cand)
        if not zero_2plex:
            yield which, A, cand, A.shape[0]
            continue
        cand = torch.where((t <= 2)[:, None], torch.zeros_like(cand), cand)
        yield which, A, cand.contiguous(), int(np.count_nonzero(
            (t > 2).cpu().numpy()))


def bmm_yardstick(A, cand):
    """One matmul-form triangle count per tile (the reference's MXU form):
    torch.bmm on the unpacked, masked fp16 M, fp32 sum of (M@M)*M, / 6.
    Returns (fn timing the library call on a prebuilt M, counts)."""
    import torch
    from repro_torch.core.bitops import unpack_bits, widen
    T = A.shape[1]
    c = unpack_bits(widen(cand), T)
    M = (unpack_bits(widen(A), T) * c[:, :, None] * c[:, None, :]).half()

    def call():
        return (torch.bmm(M, M).float() * M.float()).sum((1, 2)) / 6.0
    return call, call().round().to(torch.int64)


def bound(nbytes: int, word_ops: int):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the word operations over the int32 rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = word_ops / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def timings(launch, reps: int, calls: int = GRAPH_CALLS) -> dict:
    """The three times of a row: ``device_ms`` (``calls`` calls in a CUDA
    graph, host out), ``call_ms`` (one call, host dispatch in) and the
    run's launch floor; ``ms`` is the device time."""
    dev = device_ms(launch, calls)
    return {"ms": dev, "device_ms": dev, "call_ms": call_ms(launch, reps),
            "launch_floor_ms": launch_floor_ms()}


def kernel_cases(rows, errs, A, cand, l, tag, reps=20,
                 calls=GRAPH_CALLS):
    """Kernel vs plain on one input; record timings and the bound.

    The kernel's times are those of the bare C entry point (no wrapper, so
    no launch counted) with the wrapper's zero fills; the plain version's
    is its one comparison run, since it repeats the kernel's arithmetic
    step by step and is no yardstick of speed."""
    import torch
    from repro_torch.kernels import _build, clique_count, triangle_mm
    from repro_torch.kernels.common import check_tiles
    from repro_torch.kernels.ref import edges_within_ref
    B, T, W = check_tiles(A, cand)
    so = _build.lib()
    out = torch.empty(B + 2, dtype=torch.int32, device=A.device)
    # the item list, and at T > 256 the wide path's scratch (the C entry
    # point's scratch arguments), as the wrapper allocates them
    items, scratch_args, _scratch = clique_count.dfs_scratch(B, T, l,
                                                             A.device)
    nbytes = A.numel() * 4 + cand.numel() * 4 + B * 4
    results = []
    for kernel in (("triangle", "dfs") if l == 3 else ("dfs",)):
        extra = {}
        if kernel == "triangle":
            got = triangle_mm.triangle_count_tiles(A, cand)
            want, plain_ms = timed_once(
                lambda: triangle_mm.triangle_count_tiles_torch(A, cand))

            out64 = torch.empty(B, dtype=torch.int64, device=A.device)

            def launch():
                check_rc(so.triangle_count_tiles_launch(
                    A.data_ptr(), cand.data_ptr(), out64.data_ptr(), B, T,
                    stream_ptr()), "triangle_count_tiles")
            # 3 word ops (AND, popcount, add) per word of every induced edge
            word_ops = 3 * W * int(edges_within_ref(A, cand).sum())
            lib_fn, lib_counts = bmm_yardstick(A, cand)
            if not torch.equal(lib_counts, want):
                fail(f"bmm yardstick disagrees at T={T} ({tag})")
            lib_ms = device_ms(lib_fn, calls)
            # the wrapper as the engine calls it: its launch and any torch
            # op that follows it
            extra["wrapper_device_ms"] = device_ms(
                lambda: triangle_mm.triangle_count_tiles(A, cand), calls)
        else:
            got = clique_count.clique_count_tiles(A, cand, l)
            work = {}
            want, plain_ms = timed_once(
                lambda: clique_count.clique_count_tiles_torch(A, cand, l,
                                                              work))

            def launch():
                # the wrapper's work: zero the counts and the two item
                # counters (out[B:]), then the branch and item passes
                out.zero_()
                check_rc(so.clique_count_tiles_launch(
                    A.data_ptr(), cand.data_ptr(), out.data_ptr(),
                    items.data_ptr(), out[B:].data_ptr(), *scratch_args, B, T,
                    l, stream_ptr()), "clique_count_tiles")
            # 2 word ops (AND, popcount) per word of every DFS step, and
            # 4 (two ANDs, popcount, add) per word of every closing edge
            word_ops = 2 * W * int(work["steps"].sum()) + \
                4 * W * int(work["close_edges"].sum())
            lib_ms = None
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:5, 0].tolist()
            fail(f"{kernel} kernel != plain at T={T} l={l} ({tag}): lanes "
                 f"{bad} kernel {got[bad].tolist()} plain {want[bad].tolist()}")
        errs[kernel] = max(errs.get(kernel, 0),
                           int((got - want).abs().max()) if B else 0)
        if kernel == "dfs":
            item_case(rows, errs, A, cand, l, tag, want, reps, calls)
        # times are taken with the batch resident in L2, as the engine finds
        # it right after its H2D copy
        t = timings(launch, reps, calls)
        bound_ms, bound_by = bound(nbytes, word_ops)
        row = {"kernel": kernel, "case": tag, "T": T, "l": l, "B": B, **t,
               "plain_ms": plain_ms, "bytes": nbytes,
               "word_ops": word_ops, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms, **extra,
               "tiles_per_s": B / (t["ms"] / 1e3)}
        rows.append(row)
        results.append(row)
        log(f"  {kernel:8s} {tag:17s} T={T:3d} l={l} B={B:3d}: device "
            f"{t['device_ms']:.5f} ms, call {t['call_ms']:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}: {nbytes} B, {word_ops} word-ops)"
            + (f", bmm device {lib_ms:.5f} ms, wrapper device "
               f"{extra['wrapper_device_ms']:.5f} ms"
               if lib_ms is not None else ""))
    return results


def item_case(rows, errs, A, cand, l, tag, tile_counts, reps=20,
              calls=GRAPH_CALLS):
    """The count per first-level branch (the kernels' branch and item
    passes, summed per (tile, v)) vs its plain version: the (B, T) counts
    must be ``torch.equal``, and their row sums mod 2**32 the tiles'
    counts.  Times the bare C entry point (no launch counted) with its
    zero fills."""
    import torch
    from repro_torch.kernels import _build, clique_count
    from repro_torch.kernels.common import MASK32, check_tiles
    B, T, W = check_tiles(A, cand)
    got = clique_count.clique_count_items(A, cand, l)
    want, plain_ms = timed_once(
        lambda: clique_count.clique_count_items_torch(A, cand, l))
    if not torch.equal(got, want):
        bad = (got != want).any(-1).nonzero()[:5, 0].tolist()
        fail(f"item pass != plain at T={T} l={l} ({tag}): tiles {bad}")
    if not torch.equal(want.sum(-1) & MASK32, tile_counts):
        fail(f"item counts do not sum to the tile counts at T={T} l={l} "
             f"({tag})")
    errs["items"] = max(errs.get("items", 0),
                        int((got - want).abs().max()) if B else 0)
    so = _build.lib()
    per_v = torch.empty((B, T), dtype=torch.int64, device=A.device)
    items, scratch_args, _scratch = clique_count.dfs_scratch(B, T, l,
                                                             A.device)
    counters = torch.empty(2, dtype=torch.int32, device=A.device)

    def launch():
        per_v.zero_()
        counters.zero_()
        check_rc(so.clique_count_items_launch(
            A.data_ptr(), cand.data_ptr(), per_v.data_ptr(), items.data_ptr(),
            counters.data_ptr(), *scratch_args, B, T, l, stream_ptr()),
            "clique_count_items")
    t = timings(launch, reps, calls)
    kept = int((want > 0).sum())
    heaviest = want.max(-1).values
    row = {"kernel": "items", "case": tag, "T": T, "l": l, "B": B, **t,
           "plain_ms": plain_ms, "items_with_rows": kept,
           "max_item_share": float((heaviest.double() / want.sum(-1).clamp(
               min=1).double()).max()) if B else 0.0}
    rows.append(row)
    log(f"  items    {tag:17s} T={T:3d} l={l} B={B:3d}: device "
        f"{t['device_ms']:.5f} ms, call {t['call_ms']:.4f} ms, plain "
        f"{plain_ms:.3f} ms, {kept} items with cliques, largest item share "
        f"of its tile {row['max_item_share']:.3f}")
    return row


def list_case(rows, errs, A, cand, l, cap, tag, reps=0,
              calls=GRAPH_CALLS):
    """List kernel vs plain on one input at capacity ``cap``: buffer (zero
    padding included), count and overflow must be ``torch.equal``.  With
    ``reps`` it also times the bare C entry point (no launch counted), the
    zero fill a ``torch.zeros`` buffer would add, and the bound."""
    import torch
    from repro_torch.kernels import _build, clique_count, clique_list
    from repro_torch.kernels.common import check_tiles
    B, T, W = check_tiles(A, cand)
    got = clique_list.clique_list_tiles(A, cand, l, cap)
    work = {}
    want, plain_ms = timed_once(
        lambda: clique_list.clique_list_tiles_torch(A, cand, l, cap, work))
    for name, x, y in zip(("buffer", "count", "overflow"), got, want):
        if not torch.equal(x, y):
            bad = (x != y).reshape(B, -1).any(-1).nonzero()[:5, 0].tolist()
            fail(f"list kernel {name} != plain at T={T} l={l} cap={cap} "
                 f"({tag}): tiles {bad}")
    errs["list"] = max(errs.get("list", 0), max(
        int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
        if x.numel() else 0 for x, y in zip(got, want)))
    count = want[1]
    if not reps:
        return count
    item_case(rows, errs, A, cand, l, tag, count, reps, calls)
    so = _build.lib()
    buf = torch.empty((B, cap, l), dtype=torch.int32, device=A.device)
    cnt = torch.empty(B, dtype=torch.int32, device=A.device)
    ovf = torch.empty(B, dtype=torch.int32, device=A.device)
    per_x = torch.empty((B, T, T), dtype=torch.int64, device=A.device)
    items, scratch_args, _scratch = clique_count.dfs_scratch(B, T, l,
                                                             A.device)
    counters = torch.empty(3, dtype=torch.int32, device=A.device)

    def launch():
        # the wrapper's work: zero the per-item counts and the counters,
        # then the four device passes (branch, count, scan, emit)
        per_x.zero_()
        counters.zero_()
        check_rc(so.clique_list_tiles_launch(
            A.data_ptr(), cand.data_ptr(), buf.data_ptr(), cnt.data_ptr(),
            ovf.data_ptr(), per_x.data_ptr(), items.data_ptr(),
            counters.data_ptr(), *scratch_args, B, T, l, cap, stream_ptr()),
            "clique_list_tiles")
    # with the batch resident in L2, as the engine finds it after its H2D
    t = timings(launch, reps, calls)
    zero_ms = device_ms(buf.zero_, calls)
    written = int(torch.clamp(count, max=cap).sum())
    nbytes = A.numel() * 4 + cand.numel() * 4 + written * l * 4 + B * 8
    # 2 word ops (AND, popcount) per word of every DFS step; 3 (two ANDs,
    # popcount) per word of every vertex an edge close examines; 4 per word
    # of every induced edge the triangle close examines; W per tile for
    # the frontier close
    word_ops = W * (2 * int(work["steps"].sum())
                    + 3 * int(work["close_verts"].sum())
                    + 4 * int(work["close_edges"].sum())
                    + (B if l == 1 else 0))
    bound_ms, bound_by = bound(nbytes, word_ops)
    # library_ms stays None: no single PyTorch call lists cliques
    row = {"kernel": "list", "case": tag, "T": T, "l": l, "B": B,
           "capacity": cap, "rows": int(count.sum()), "written": written,
           **t, "plain_ms": plain_ms, "bytes": nbytes,
           "word_ops": word_ops, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None, "zero_fill_ms": zero_ms}
    rows.append(row)
    log(f"  list     {tag:17s} T={T:3d} l={l} B={B:3d} cap={cap:5d}: "
        f"device {t['device_ms']:.5f} ms, call {t['call_ms']:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}: {nbytes} "
        f"B, {word_ops} word-ops), {row['rows']} rows ({written} written), "
        f"zero fill of the buffer {zero_ms:.5f} ms")
    return row


def edge_case(rows, errs, A, pairs, tag, reps=20, calls=GRAPH_CALLS):
    """edge_candidates kernel vs plain on one input, timed."""
    import torch
    from repro_torch.kernels import _build, intersect
    B, T, W = A.shape
    got = intersect.edge_candidates(A, pairs)
    want, plain_ms = timed_once(lambda: intersect.edge_candidates_torch(
        A, pairs))
    for x, y in zip(got, want):
        if not torch.equal(x, y):
            fail(f"edge_candidates kernel != plain at T={T} ({tag})")
    errs["edge"] = max(errs.get("edge", 0), max(
        int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
        if x.numel() else 0 for x, y in zip(got, want)))
    so = _build.lib()
    cand = torch.empty((B, W), dtype=torch.int32, device=A.device)
    n = torch.empty(B, dtype=torch.int64, device=A.device)

    def launch():
        check_rc(so.edge_candidates_launch(
            A.data_ptr(), pairs.data_ptr(), cand.data_ptr(), n.data_ptr(), B,
            T, stream_ptr()), "edge_candidates")
    t = timings(launch, reps, calls)
    # the function reads two rows and the pair of each tile and writes W
    # words and a count; 3 word ops (AND, AND, popcount) a word
    nbytes = B * (2 * W * 4 + 8 + W * 4 + 4)
    bound_ms, bound_by = bound(nbytes, 3 * W * B)
    # library_ms stays None: no single PyTorch call forms A[a] & A[b] & gt(b)
    row = {"kernel": "edge", "case": tag, "T": T, "B": B, **t,
           "plain_ms": plain_ms, "bytes": nbytes, "word_ops": 3 * W * B,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    rows.append(row)
    log(f"  edge     {tag:17s} T={T:3d} B={B:4d}: device "
        f"{t['device_ms']:.5f} ms "
        f"({t['device_ms'] / t['launch_floor_ms']:.2f}x the launch floor), "
        f"call {t['call_ms']:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by})")
    return row


def first_edges(A):
    """(B, 2) int32 pairs: per tile its first edge (a, b), a < b, in
    row-major order ((0, 1) for a tile with none)."""
    import torch
    from repro_torch.core.bitops import gt_masks, unpack_bits, widen
    T = A.shape[1]
    e = unpack_bits(widen(A) & gt_masks(T, A.device), T).reshape(
        A.shape[0], T * T)
    first = torch.where(e.any(-1), e.argmax(-1), torch.ones_like(e[:, 0]))
    return torch.stack([first // T, first % T], 1).to(torch.int32)


def ptxas_report(text: str):
    """Registers, stack frame and spills of each kernel entry in the
    ``-Xptxas -v`` output, keyed by a short name (kernel and template
    arguments)."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            sym = m.group(1)
            k = re.search(r"(branch_kernel|item_kernel|list_emit_kernel|"
                          r"list_scan_kernel|tri_warp_rows|tri_block_rows|"
                          r"edge_candidates_kernel|branch_wide|item_wide|"
                          r"list_emit_wide|tri_wide|edge_candidates_wide)"
                          r"(I.*?EE)?", sym)
            name = None
            if k:
                # template arguments: ILi1E... (W), LNS0_7ItemOutE0E (mode),
                # Lb1E (a full block)
                args = re.findall(r"L(?:i|b|N\w*?E)(\d+)E", k.group(2) or "")
                name = k.group(1) + ("<" + ",".join(args) + ">" if args
                                     else "")
                out.setdefault(name, {"registers": None, "stack": None,
                                      "spill_stores": None,
                                      "spill_loads": None})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def skewed_batch(A, cand, counts, B: int = 256):
    """One tile -- the heaviest of a main-path batch -- among B - 1 tiles
    with an empty cand: the batch in which the slowest tile sets the
    time of a launch that gives each tile one worker."""
    import torch
    heavy = int(counts.argmax())
    A2 = A[:1].expand(B, -1, -1).clone()
    A2[17] = A[heavy]
    c2 = torch.zeros((B, cand.shape[1]), dtype=cand.dtype, device=cand.device)
    c2[17] = cand[heavy]
    return A2, c2


def warm(graph, graph_plan) -> None:
    """Publish ``graph_plan`` into the keyed plan cache under ``graph``'s
    key, as a query that built it would: later phases put other plans in
    the cache's few slots."""
    from repro_torch.core import pipeline
    pipeline._plan_cache_insert(pipeline.plan_key(graph, "hybrid"),
                                graph_plan)


def batches_per_bin(plan, k: int):
    """Packed batches the engines stream for ``k``, per bin."""
    import numpy as np
    table = plan.table("hybrid")
    ids = table.select(k)
    sizes = table.offsets[ids + 1] - table.offsets[ids]
    per_T = np.bincount(np.searchsorted(np.asarray(BINS), sizes),
                        minlength=len(BINS) + 1)
    return ({T: -(-int(per_T[i]) // 256) for i, T in enumerate(BINS)},
            {T: int(per_T[i]) for i, T in enumerate(BINS)})


def dispatch_phase(mg, mplan, plan, lg, lplan, list_runs,
                   queries) -> dict:
    """``[dispatch]``: the main path's queries through the multi-lane
    dispatcher, each with the kernel counters set to 0 just before it and
    read just after.  Each run must give the expected count (or rows and
    digest), launch its kernels and no plain version, and, on two lanes,
    place tiles on both.  Appends each query's Stats to ``queries``.
    Returns every run's numbers."""
    import numpy as np
    from repro_torch.core import ebbkc, engine_torch, listing, pipeline
    from repro_torch.core.engine_np import Stats
    from repro_torch.kernels import ops
    from repro_torch.runtime import dispatch
    one, two = ["cuda:0"], ["cuda:0", "cuda:0"]
    runs = {}

    def record(name, kernels, wall, stats, stage, inline_s, **extra):
        queries.append((f"[dispatch] {name}", stats))
        launches = ops.launch_counts()
        plain = ops.plain_counts()
        # the count dispatcher accounts the overlap; the ListDispatcher
        # (as the reference's) does not
        counting = "list" not in name
        overlap = stats.staging_overlap_s if counting else None
        run = dict(wall_s=wall, staging_overlap_s=overlap,
                   overlap_share=overlap / wall if counting else None,
                   device_s=stage.get("device", 0.0),
                   tiles_per_lane=dict(stats.device_tiles),
                   launches=launches, inline_wall_s=inline_s,
                   kernel_compile_s=stats.kernel_compile_s, **extra)
        runs[name] = run
        inline = (f"{inline_s:.2f} s" if inline_s is not None
                  else "not run inline")
        overlap_txt = (f"{overlap:.2f} s ({100 * overlap / wall:.1f}% of "
                       f"wall)" if counting else "not accounted (listing)")
        log(f"[dispatch] {name}: wall {wall:.2f} s (inline path in this "
            f"call: {inline}), staging_overlap {overlap_txt}, device stage "
            f"{run['device_s']:.2f} s, tiles per lane {run['tiles_per_lane']}"
            f", launches {launches}"
            + "".join(f", {k} {v}" for k, v in extra.items()))
        if sum(plain.values()):
            fail(f"dispatch {name}: a plain version ran: {plain}")
        for kernel in kernels:
            if launches[kernel] == 0:
                fail(f"dispatch {name}: {kernel} never launched: {launches}")
        if "2 lanes" in name and not (
                len(stats.device_tiles) == 2
                and min(stats.device_tiles.values()) > 0):
            fail(f"dispatch {name}: a lane took no tile: "
                 f"{stats.device_tiles}")

    def count(name, graph, graph_plan, k, lanes, inline_s, profiled=False):
        """One dispatched count; with ``profiled`` it runs under the
        profiler, which also gives the device's busy share."""
        stage = {}
        ops.reset_counts()

        def query():
            return ebbkc.count(graph, k, plan=graph_plan, engine_kwargs=dict(
                devices=lanes, stage_times=stage))
        if profiled:
            runs["device_busy"] = device_busy(name, query)
            res = runs["device_busy"].pop("result")
            runs["device_busy"]["result"] = res.count
            wall = runs["device_busy"]["wall_s"]
        else:
            t0 = time.perf_counter()
            res = query()
            wall = time.perf_counter() - t0
        record(name, [kernel_of(k)], wall, res.stats, stage, inline_s,
               count=res.count)
        return res.count

    def kernel_of(k):
        return "triangle_count_tiles" if k == 5 else "clique_count_tiles"

    # the two-lane query runs once, under the profiler, which also gives
    # the device's busy share; its wall carries the profiler's overhead
    for lanes, tag in ((one, "1 lane"), (two, "2 lanes")):
        got = count(f"count k=7 rmat{MID_SCALE} {tag}", mg, mplan, 7, lanes,
                    None, profiled=lanes is two)
        if got != EXPECTED_MID[7]:
            fail(f"dispatch k=7 on {tag} counted {got}, expected "
                 f"{EXPECTED_MID[7]}")

    # k = 5 on the scale-12 graph, each batch split by rows over two lanes
    stats, stage = Stats(), {}
    ops.reset_counts()
    t0 = time.perf_counter()
    disp = dispatch.Dispatcher(3, mesh=two, stats=stats, stage_times=stage)
    stream = pipeline.stream_batches(lplan, 5, pack_workers=None,
                                     stats=stats)
    spilled = []
    try:
        disp.consume(stream, on_spill=lambda t: spilled.append(
            engine_torch.count_spilled(t, "hybrid", 3, stats, 3, True)))
        got = disp.finish() + sum(spilled)
    finally:
        stream.close()
    record("count k=5 rmat12 mesh 2 lanes", [kernel_of(5)],
           time.perf_counter() - t0, stats, stage, None, count=got)
    if got != EXPECTED_LIST[5][0]:
        fail(f"dispatch mesh k=5 counted {got}, expected "
             f"{EXPECTED_LIST[5][0]}")

    # k = 6 on the scale-12 graph, offline LPT bins over two lanes
    stats, stage = Stats(), {}
    ops.reset_counts()
    t0 = time.perf_counter()
    items = list(pipeline.stream_batches(lplan, 6, pack_workers=None))
    batches = [b for b in items if isinstance(b, pipeline.TileBatch)]
    spill = sum(engine_torch.count_spilled(t, "hybrid", 4, stats, 3, True)
                for t in items if not isinstance(t, pipeline.TileBatch))
    got, info = dispatch.dispatch_scheduled(batches, 4, two, stats=stats,
                                            stage_times=stage)
    got += spill
    record("count k=6 rmat12 offline LPT 2 lanes", [kernel_of(6)],
           time.perf_counter() - t0, stats, stage, None, count=got,
           balance=info["max_over_mean"])
    if got != EXPECTED_LIST[6][0]:
        fail(f"dispatch offline LPT k=6 counted {got}, expected "
             f"{EXPECTED_LIST[6][0]}")

    # listing k = 5 on the scale-12 graph, rows hashed by the sink
    for lanes, tag, capacity in ((one, "1 lane", "sized"),
                                 (two, "2 lanes", "speculative")):
        digest, nrows = hashlib.sha256(), [0]

        def hash_rows(chunk):
            digest.update(np.ascontiguousarray(chunk, dtype="<i8"))
            nrows[0] += chunk.shape[0]
        stage = {}
        ops.reset_counts()
        t0 = time.perf_counter()
        res = listing.stream_cliques(lplan, 5, listing.CallbackSink(
            hash_rows), devices=lanes, capacity=capacity, stage_times=stage)
        wall = time.perf_counter() - t0
        kernels = ["clique_list_tiles"] + (
            [kernel_of(5)] if capacity == "sized" else [])
        record(f"list k=5 rmat12 {capacity} {tag}", kernels, wall,
               res.stats, stage, list_runs["k=5 warm"]["wall_s"],
               rows=nrows[0], emit_retries=res.stats.emit_retries,
               decode_s=stage.get("decode", 0.0),
               emit_s=stage.get("emit", 0.0))
        if (nrows[0], digest.hexdigest()) != EXPECTED_LIST[5]:
            fail(f"dispatch listing k=5 ({capacity}, {tag}) gave {nrows[0]} "
                 f"rows, sha256 {digest.hexdigest()}; expected "
                 f"{EXPECTED_LIST[5]}")
    runs["lane_concurrency"] = lane_concurrency(plan)
    return runs


def device_busy(name: str, query, tag: str = "[dispatch]") -> dict:
    """The device's busy share of one dispatched query: the query runs
    once more under ``torch.profiler`` (CUDA activity only), and the union
    of its device intervals (kernels, copies, fills, on every stream) is
    set against the query's wall time.  The sum of the intervals over
    their union says how much the lanes' work overlapped, and the DFS
    count kernel's share of them (its branch and item passes) is the
    query's count-kernel device time; ``top_kernels`` are the five device
    names with the most summed time."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = query()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    dfs = [e.time_range.end - e.time_range.start for e in events
           if "branch_kernel" in e.name or "item_kernel" in e.name]
    by_name = collections.Counter()
    for e in events:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    busy_us, total_us, end = 0.0, 0.0, float("-inf")
    for a, b in spans:
        total_us += b - a
        if b > end:
            busy_us += b - max(a, end)
            end = b
    out = dict(result=result, wall_s=wall, device_events=len(spans),
               busy_s=busy_us / 1e6, summed_s=total_us / 1e6,
               busy_share=busy_us / 1e6 / wall if spans else None,
               count_kernel_events=len(dfs),
               count_kernel_s=sum(dfs) / 1e6,
               top_kernels=by_name.most_common(5))
    if spans:
        share = out["busy_share"]
        log(f"{tag} device busy, {name} under the profiler: wall "
            f"{wall:.2f} s, {len(spans)} device events, "
            f"busy {out['busy_s']:.3f} s ({100 * share:.2f}% of wall; idle "
            f"{100 - 100 * share:.2f}%), summed {out['summed_s']:.3f} s "
            f"({out['summed_s'] / out['busy_s']:.2f}x the busy time); DFS "
            f"count kernel {len(dfs)} events, {out['count_kernel_s']:.4f} s")
    else:
        log(f"{tag} device busy share not measured: the profiler saw no "
            "device events")
    return out


def lane_concurrency(plan, reps: int = 40) -> dict:
    """What two lanes on one card do to the DFS count kernel's device
    time: ``reps`` launches of a main-path k = 7 sample batch on one
    stream, against the same launches alternated over two streams, each
    span between two events (the side streams wait on the first and the
    launching stream on the side streams' last); one, two, two, one.
    These launches come after the counted runs and are not part of any."""
    import torch
    from repro_torch.kernels import ops

    def span(A, cand, streams) -> float:
        cur = torch.cuda.current_stream()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(cur)
        for st in streams:
            st.wait_event(start)
        for i in range(reps):
            with torch.cuda.stream(streams[i % len(streams)]):
                ops.count_tiles(A, cand, 5)
        for st in streams:
            done = torch.cuda.Event()
            done.record(st)
            cur.wait_event(done)
        end.record(cur)
        end.synchronize()
        return start.elapsed_time(end)

    out = {}
    for T in (32, 64, 128):
        for which, A, cand, _ in main_path_batches(plan, 7, T):
            if which != "sample":
                continue
            streams = [torch.cuda.Stream() for _ in range(2)]
            span(A, cand, streams)  # warm-up
            times = {"one": [], "two": []}
            for lanes in ("one", "two", "two", "one"):
                times[lanes].append(span(A, cand, streams[:1] if lanes ==
                                         "one" else streams))
            one, two = min(times["one"]), min(times["two"])
            out[T] = dict(reps=reps, one_stream_ms=times["one"],
                          two_streams_ms=times["two"], speedup=one / two)
            log(f"[dispatch] lane concurrency k=7 T={T} sample (B="
                f"{A.shape[0]}): {reps} count launches on one stream "
                f"{times['one']} ms, alternated over two streams "
                f"{times['two']} ms: two lanes {one / two:.2f}x one")
    return out


#: the spans a dispatched count query passes through on a warm plan (the
#: library is loaded, so kernel/compile is a lookup), and those of an
#: inline listing query whose tiles overflow (the k = 6 listing)
OBS_COUNT_SPANS = ("kernel/compile", "extract", "pack", "device/stage",
                   "device/harvest", "combine")
OBS_LIST_SPANS = ("extract", "pack", "device/sizing", "device/wait",
                  "decode", "overflow/relist")
#: where profile_span writes its captures (git-ignored)
PROFILE_DIR = ROOT / "build" / "obs_profile"


def profiled_kernels(path, tags) -> dict:
    """Device kernel events of a ``profile_span`` capture whose names
    contain one of ``tags``: their number and summed device seconds."""
    doc = json.loads(Path(path).read_text())
    durs = [e.get("dur", 0.0) for e in doc.get("traceEvents", [])
            if e.get("cat") == "kernel"
            and any(t in e.get("name", "") for t in tags)]
    return dict(events=len(durs), device_s=sum(durs) / 1e6)


def obs_phase(mg, mplan, lg, lplan, dispatch_runs, list_trace,
              queries) -> dict:
    """``[obs]``: the port's tracer, kernel attribution, metrics server and
    profiler capture on the main path.  The one-lane k = 7 query runs
    traced (same count, a valid Chrome trace through every stage span,
    kernel_records' calls equal to the count kernel's launches); the k = 6
    listing of ``[list main]`` ran traced (``list_trace``: its trace doc,
    dropped events, wall and Stats; same rows and digest, checked there)
    and gives the host relist's span total; a MetricsServer is scraped
    once; ``profile_span`` captures the k = 5 count on the scale-12 graph
    (CUDA kernel events of the triangle kernel); and the DFS count
    kernel's device seconds of a k = 7 query come from ``[dispatch]``'s
    profiler window.  Appends each query's Stats to ``queries``."""
    from repro_torch.core import ebbkc
    from repro_torch.kernels import ops
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import profile as obs_profile
    from repro_torch.obs import trace
    from repro_torch.obs.export import MetricsServer, scrape
    out = {}

    def check(doc, what):
        problems = trace.validate_chrome_trace(doc)
        if problems:
            fail(f"obs: the {what} trace is not valid: {problems[:5]}")
        return {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}

    # the dispatched one-lane k = 7 query, traced
    obs_profile.reset_kernels()
    ops.reset_counts()
    trace.configure(enabled=True)
    trace.reset()
    try:
        t0 = time.perf_counter()
        res = ebbkc.count(mg, 7, plan=mplan,
                          engine_kwargs=dict(devices=["cuda:0"]))
        wall = time.perf_counter() - t0
    finally:
        trace.configure(enabled=False)
    doc, dropped = trace.chrome_trace(), trace.dropped()
    trace.reset()
    queries.append(("[obs] count k=7 traced", res.stats))
    names = check(doc, "k=7 count")
    launches = ops.launch_counts()["clique_count_tiles"]
    recs = [r for r in obs_profile.kernel_records()
            if r["sig"].startswith("count[")]
    calls = sum(r["calls"] for r in recs)
    stages = trace.stage_durations(doc)
    untraced = dispatch_runs[
        f"count k=7 rmat{MID_SCALE} 1 lane"]["wall_s"]
    busy = dispatch_runs["device_busy"]
    out["count_k7"] = dict(
        count=res.count, wall_s=wall, untraced_wall_s=untraced,
        dropped=dropped, events=len(doc["traceEvents"]),
        stage_durations=stages, launches=launches, kernel_records=recs,
        count_kernel_device_s=busy["count_kernel_s"],
        count_kernel_events=busy["count_kernel_events"])
    log(f"[obs] count k=7 rmat{MID_SCALE} 1 lane, traced: {res.count}, wall "
        f"{wall:.2f} s against {untraced:.2f} s untraced in this call "
        f"({100 * (wall / untraced - 1):+.1f}%), "
        f"{len(doc['traceEvents'])} events, dropped {dropped}")
    log("[obs]   stage_durations (s, summed over threads): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(stages.items())))
    for r in sorted(recs, key=lambda r: r["sig"]):
        log(f"[obs]   kernel_records {r['sig']}: calls {r['calls']}, "
            f"execute_s {r['execute_s']:.4f} (host blocked at harvest), "
            f"compile_s {r['compile_s']:.4f}")
    log(f"[obs]   DFS count kernel device time of a k=7 query (profiler, "
        f"[dispatch] device busy window): {busy['count_kernel_events']} "
        f"events, {busy['count_kernel_s']:.4f} s")
    if res.count != EXPECTED_MID[7]:
        fail(f"obs: traced k=7 counted {res.count}, expected "
             f"{EXPECTED_MID[7]}")
    missing = set(OBS_COUNT_SPANS) - names
    if missing:
        fail(f"obs: the traced k=7 query has no {sorted(missing)} span")
    if calls != launches or launches == 0:
        fail(f"obs: kernel_records calls {calls} != count kernel launches "
             f"{launches}")
    if busy["count_kernel_events"] != 2 * launches:
        fail(f"obs: the profiler saw {busy['count_kernel_events']} DFS "
             f"count kernel passes for {launches} launches, not two a "
             "launch")

    # the traced inline k = 6 listing of [list main]: the host relist
    doc, dropped, wall, st = list_trace
    names = check(doc, "k=6 listing")
    stages = trace.stage_durations(doc)
    relists = sum(e["name"] == "overflow/relist" for e in doc["traceEvents"])
    out["list_k6"] = dict(wall_s=wall, dropped=dropped,
                          events=len(doc["traceEvents"]),
                          stage_durations=stages, relist_spans=relists,
                          relist_s=stages.get("overflow/relist", 0.0))
    log(f"[obs] list k=6 rmat11 inline ([list main], traced): wall "
        f"{wall:.2f} s, overflow/relist {relists} spans, "
        f"{out['list_k6']['relist_s']:.2f} s "
        f"({100 * out['list_k6']['relist_s'] / wall:.1f}% of wall), decode "
        f"{stages.get('decode', 0.0):.2f} s, device/wait "
        f"{stages.get('device/wait', 0.0):.2f} s, device/sizing "
        f"{stages.get('device/sizing', 0.0):.2f} s, dropped {dropped}")
    missing = set(OBS_LIST_SPANS) - names
    if missing or relists != st.overflowed_tiles:
        fail(f"obs: the traced k=6 listing lacks {sorted(missing)} or has "
             f"{relists} relist spans for {st.overflowed_tiles} "
             "overflowed tiles")

    # one scrape of the metrics server
    reg = obs_metrics.Registry()
    obs_metrics.observe_stats(st, "repro_engine", reg)
    srv = MetricsServer(port=0, registry=reg)
    try:
        text = scrape(srv.address)
    finally:
        srv.close()
    values = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, val = line.rsplit(" ", 1)
            values[key] = float(val)
    out["metrics"] = dict(series=len(values), bytes=len(text))
    log(f"[obs] metrics: scraped {srv.address}/metrics once: {len(values)} "
        f"series, {len(text)} bytes")
    if values.get("repro_engine_emitted_cliques_total") != EXPECTED_LIST6[0]:
        fail("obs: the scrape did not parse to the listing's row count")

    # a profiler capture of the k = 5 count on rmat12 (triangle kernel)
    PROFILE_DIR.mkdir(parents=True, exist_ok=True)
    for old in PROFILE_DIR.glob("*.json"):
        old.unlink()
    name = "count_k5_rmat12"
    ops.reset_counts()
    t0 = time.perf_counter()
    with obs_profile.profile_span(name, out_dir=str(PROFILE_DIR)):
        res = ebbkc.count(lg, 5, plan=lplan,
                          engine_kwargs=dict(devices=["cuda:0"]))
    got = res.count
    queries.append((f"[obs] profile_span {name}", res.stats))
    wall = time.perf_counter() - t0
    (path,) = PROFILE_DIR.glob(f"{name}.*.json")
    kern = profiled_kernels(path, ("tri_",))
    launches = ops.launch_counts()["triangle_count_tiles"]
    out[name] = dict(count=got, wall_s=wall, launches=launches,
                     file_bytes=path.stat().st_size, **kern)
    log(f"[obs] profile_span {name}: {got}, wall {wall:.2f} s under the "
        f"profiler, {path.stat().st_size} B Chrome trace, {kern['events']} "
        f"CUDA kernel events of triangle_count_tiles for {launches} "
        f"launches, device {kern['device_s']:.6f} s")
    if got != EXPECTED_LIST[5][0]:
        fail(f"obs: profiled {name} counted {got}, expected "
             f"{EXPECTED_LIST[5][0]}")
    if kern["events"] == 0 or kern["events"] != launches:
        fail(f"obs: the {name} capture has {kern['events']} CUDA kernel "
             f"events of the triangle kernel for {launches} launches")
    return out


def resilience_phase(lg, lplan, queries, cli_outputs) -> dict:
    """``[resilience]``: with no fault plan armed, no query retried or
    demoted anything; under ``seed=7;*=0.1`` the dispatched k = 6 count
    and k = 5 listing on rmat12 stay exact with retries; under
    ``kernel.launch=1.0`` a small graph's count and listing on the card
    retry the first batch on the kernel and then raise, with no kernel
    launch, no plain-version call and no host finish; a real error raised
    by a launch propagates out of the query undemoted.  The plan is
    disarmed before the phase ends."""
    import numpy as np
    from repro_torch.core import ebbkc, listing, pipeline
    from repro_torch.core.engine_np import Stats
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.kernels import clique_count, ops
    from repro_torch.resilience import inject, retry
    from repro_torch.runtime import dispatch
    out = {}
    if inject.enabled():
        fail("resilience: a fault plan was armed during the earlier phases")
    bad = [(name, st.retries, st.demotions) for name, st in queries
           if st.retries or st.demotions]
    bad += [("[cli]", out_) for out_ in cli_outputs
            if "retries=0 demotions=0" not in out_]
    log(f"[resilience] no plan armed: {len(queries)} queries and "
        f"{len(cli_outputs)} launcher runs, retries and demotions all 0: "
        f"{not bad}")
    if bad:
        fail(f"resilience: retries or demotions with no plan armed: {bad}")
    out["unarmed_queries"] = len(queries) + len(cli_outputs)
    one = ["cuda:0"]

    def rows_of(query):
        digest, nrows = hashlib.sha256(), [0]

        def hash_rows(chunk):
            digest.update(np.ascontiguousarray(chunk, dtype="<i8"))
            nrows[0] += chunk.shape[0]
        res = query(listing.CallbackSink(hash_rows))
        return res, (nrows[0], digest.hexdigest())

    try:
        plan_spec = "seed=7;*=0.1"
        inject.configure(plan_spec)
        t0 = time.perf_counter()
        res = ebbkc.count(lg, 6, plan=lplan, engine_kwargs=dict(devices=one))
        wall = time.perf_counter() - t0
        fired = inject.fired()
        out["chaos_count_k6"] = dict(count=res.count, wall_s=wall,
                                     retries=res.stats.retries,
                                     demotions=res.stats.demotions,
                                     fired=fired)
        log(f"[resilience] {plan_spec}: count k=6 rmat12 1 lane {res.count} "
            f"in {wall:.2f} s, retries {res.stats.retries}, demotions "
            f"{res.stats.demotions}, faults fired {fired}")
        if res.count != EXPECTED_LIST[6][0] or res.stats.retries == 0:
            fail(f"resilience: chaos k=6 count {res.count} (expected "
                 f"{EXPECTED_LIST[6][0]}) with {res.stats.retries} retries")
        inject.configure(plan_spec)
        t0 = time.perf_counter()
        res, got = rows_of(lambda sink: listing.stream_cliques(
            lplan, 5, sink, devices=one))
        wall = time.perf_counter() - t0
        fired = inject.fired()
        out["chaos_list_k5"] = dict(rows=got[0], sha256=got[1], wall_s=wall,
                                    retries=res.stats.retries,
                                    demotions=res.stats.demotions,
                                    fired=fired)
        log(f"[resilience] {plan_spec}: list k=5 rmat12 1 lane {got[0]} "
            f"rows in {wall:.2f} s, sha256 equal: "
            f"{got == EXPECTED_LIST[5]}, retries {res.stats.retries}, "
            f"demotions {res.stats.demotions}, faults fired {fired}")
        if got != EXPECTED_LIST[5] or res.stats.retries == 0:
            fail(f"resilience: chaos k=5 listing gave {got} with "
                 f"{res.stats.retries} retries")

        # every launch failing, on a small graph: on the card the first
        # batch is retried on the kernel, then the fault raises out of the
        # query; nothing moves to the plain version or the host
        sg = rmat_graph(9, edge_factor=RMAT_EDGE_FACTOR, seed=RMAT_SEED)
        splan = pipeline.cached_plan(sg, "hybrid")
        attempts = retry.DEFAULT_POLICY.max_attempts
        faults = {}
        for name, query in (
                ("count", lambda: ebbkc.count(
                    sg, 5, plan=splan, engine_kwargs=dict(devices=one))),
                ("list", lambda: listing.stream_cliques(
                    splan, 5, listing.CallbackSink(lambda chunk: None),
                    devices=one))):
            inject.configure("kernel.launch=1.0")
            ops.reset_counts()
            raised = None
            try:
                query()
            except inject.FaultInjected as exc:
                raised = str(exc)
            fired = inject.fired().get("kernel.launch", 0)
            inject.configure(None)
            faults[name] = dict(raised=raised, fired=fired,
                                launches=sum(ops.launch_counts().values()),
                                plain_calls=sum(ops.plain_counts().values()))
        out["launch_fault"] = dict(graph="rmat_graph(9, 16, seed=7)", k=5,
                                   attempts=attempts, **faults)
        log(f"[resilience] kernel.launch=1.0 on rmat_graph(9), k=5, on the "
            f"card: {faults} (policy: {attempts} attempts)")
        if any(f["raised"] is None or f["fired"] != attempts
               or f["launches"] or f["plain_calls"]
               for f in faults.values()):
            fail("resilience: kernel.launch=1.0 on the card did not raise "
                 "after the retries of the first batch, or ran a plain "
                 "version or the host")

        # a real error is not retried or demoted: it propagates, with a
        # plan armed that fires (at harvest only, so nothing demotes)
        plan_spec = "seed=7;device.harvest=0.2"
        inject.configure(plan_spec)
        real = clique_count.clique_count_tiles

        def broken(*args, **kwargs):
            raise RuntimeError("launch failed: CUDA error 700 (injected by "
                               "the smoke test, not by the fault plan)")
        clique_count.clique_count_tiles = broken
        stats = Stats()
        disp = dispatch.Dispatcher(4, one, stats=stats)
        raised = None
        try:
            for batch in pipeline.stream_batches(splan, 6, pack_workers=0):
                if isinstance(batch, pipeline.TileBatch):
                    disp.submit(batch)
            disp.finish()
        except RuntimeError as exc:
            raised = str(exc)
        finally:
            clique_count.clique_count_tiles = real
        out["real_error"] = dict(raised=raised, retries=stats.retries,
                                 demotions=stats.demotions)
        log(f"[resilience] a launch raising RuntimeError under {plan_spec}: "
            f"propagated: {raised is not None}, retries {stats.retries}, "
            f"demotions {stats.demotions}")
        if raised is None or "CUDA error 700" not in raised or \
                stats.demotions:
            fail("resilience: a real launch error was hidden or demoted")
    finally:
        inject.configure(None)
    return out


#: the tile widths that are multiples of 32 but not powers of two
NEW_T = (96, 160, 192, 224)
#: the reference tuner's mult32 ladder (repro_torch.tune.search.bins_for)
MULT32 = (32, 64, 96, 128, 160, 192, 224, 256)


def pow2_twin(A, cand):
    """The same tiles packed at the next power-of-two width: each row's
    and the cand's words copied, the added vertices isolated and outside
    cand, so every kernel's result is unchanged."""
    import torch
    B, T, W = A.shape
    T2 = 1 << (T - 1).bit_length()
    A2 = torch.zeros((B, T2, T2 // 32), dtype=A.dtype, device=A.device)
    A2[:, :T, :W] = A
    c2 = torch.zeros((B, T2 // 32), dtype=cand.dtype, device=cand.device)
    c2[:, :W] = cand
    return A2, c2


def widths_ptxas(ptxas) -> dict:
    """The ``-Xptxas -v`` report of the instantiations at W = 3, 5, 6, 7;
    fails on a spill in any that runs in a full block (every kernel but the
    item and emit kernels' halved-block variants, template flag 0)."""
    out = {}
    for name, info in sorted(ptxas.items()):
        m = re.fullmatch(r"(\w+)<(\d+)((?:,\d+)*)>", name)
        if not m or int(m.group(2)) * 32 not in NEW_T:
            continue
        args = [int(a) for a in m.group(3).split(",")[1:]]
        full = not (m.group(1) in ("item_kernel", "list_emit_kernel")
                    and args[-1] == 0)
        out[name] = dict(info, full_block=full)
        log(f"[widths] ptxas {name}: {info['registers']} registers, "
            f"{info['spill_stores']} B spill stores, {info['spill_loads']} B "
            f"spill loads{'' if full else ' (halved blocks only)'}")
        if full and (info["spill_stores"] or info["spill_loads"]):
            fail(f"{name} spills in a full block: {info}")
    if len(out) < 4 * 5:
        fail(f"ptxas reported {len(out)} instantiations at the new widths")
    return out


def widths_case(rows, errs, A, cand, tag, ls=(3, 5), list_l=None,
                pairs=None):
    """Every kernel on one batch at a new width and on its pow2 twin: each
    held against its plain version (in kernel_cases / list_case /
    edge_case), the twin's results equal to the batch's, and both timed.
    Returns {(kernel, l): (device_ms, twin device_ms)}."""
    import torch
    from repro_torch.kernels import ops
    A2, c2 = pow2_twin(A, cand)
    out = {}
    for l in ls:
        got = kernel_cases(rows, errs, A, cand, l, tag, reps=10)
        twin = kernel_cases(rows, errs, A2, c2, l, tag + " twin", reps=10)
        if not torch.equal(ops.count_tiles(A, cand, l),
                           ops.count_tiles(A2, c2, l)):
            fail(f"the pow2 twin counts differently at l={l} ({tag})")
        for r, r2 in zip(got, twin):
            out[(r["kernel"], l)] = (r["device_ms"], r2["device_ms"])
    if list_l is not None:
        from repro_torch.core import listing
        counts = ops.count_tiles(A, cand, list_l).cpu().numpy()
        cap = listing.capacity_for(counts)
        r = list_case(rows, errs, A, cand, list_l, cap, tag, reps=10)
        r2 = list_case(rows, errs, A2, c2, list_l, cap, tag + " twin",
                       reps=10)
        got = ops.list_tiles(A, cand, list_l, cap)
        for x, y in zip(got, ops.list_tiles(A2, c2, list_l, cap)):
            if not torch.equal(x, y):
                fail(f"the pow2 twin lists differently ({tag})")
        out[("list", list_l)] = (r["device_ms"], r2["device_ms"])
    if pairs is not None:
        r = edge_case(rows, errs, A, pairs, tag, reps=10)
        r2 = edge_case(rows, errs, A2, pairs, tag + " twin", reps=10)
        n1 = ops.edge_candidates(A, pairs)[1]
        if not torch.equal(n1, ops.edge_candidates(A2, pairs)[1]):
            fail(f"the pow2 twin's edge candidates differ ({tag})")
        out[("edge", 0)] = (r["device_ms"], r2["device_ms"])
    for (kernel, l), (ms, ms2) in out.items():
        log(f"[widths] {tag}: {kernel} l={l} T={A.shape[1]} "
            f"{ms:.5f} ms, same tiles at T={A2.shape[1]} {ms2:.5f} ms "
            f"({ms / ms2:.2f}x)")
    return out


def widths_phase(plan, mg, mplan, lplan, rows, errs, ptxas, dispatch_runs,
                 queries) -> dict:
    """``[widths]``: the four kernels at T = 96, 160, 192 and 224 -- their
    ptxas report, seeded tiles, and the main-path batches of a ``mult32``
    stream (counting on rmat15, listing on rmat12) -- each against its
    plain version and timed beside the same tiles at the next power of
    two; then the k = 7 count on rmat13 under the mult32 ladder on the
    warm plan, exact, with its wall beside the pow2 wall of the one-lane
    query of ``[dispatch]``."""
    import numpy as np
    import torch
    from repro_torch.core import ebbkc
    from repro_torch.kernels import ops
    from repro_torch.tune import search
    if tuple(search.bins_for("mult32")) != MULT32:
        fail("the mult32 ladder changed")
    out = {"ptxas": widths_ptxas(ptxas), "times": {}}
    density = {96: 0.12, 160: 0.08, 192: 0.07, 224: 0.06}
    for T in NEW_T:
        A, cand = (torch.from_numpy(x).view(torch.int32).cuda()
                   for x in seeded_tiles(T + 7, 64, T, density[T]))
        rng = np.random.default_rng(T)
        a = rng.integers(0, T - 1, 64)
        pairs = torch.from_numpy(np.stack(
            [a, a + 1 + rng.integers(0, T - 1 - a)], 1).astype(np.int32)
        ).cuda()
        out["times"][f"seeded T={T}"] = widths_case(
            rows, errs, A, cand, f"seeded T={T}", ls=(3, 5), list_l=4,
            pairs=pairs)
    for k, l in ((5, 3), (7, 5)):
        for T in NEW_T:
            for which, A, cand, _ in main_path_batches(plan, k, T,
                                                       bins=MULT32):
                if which != "sample":
                    continue
                tag = f"mult32 k={k} T={T}"
                out["times"][tag] = widths_case(
                    rows, errs, A, cand, tag, ls=(l,),
                    pairs=first_edges(A) if k == 5 else None)
    for T in NEW_T:
        for which, A, cand, _ in main_path_batches(lplan, 6, T, bins=MULT32,
                                                   zero_2plex=False):
            if which == "sample":
                tag = f"mult32 list k=6 T={T}"
                out["times"][tag] = widths_case(rows, errs, A, cand, tag,
                                                ls=(), list_l=4)
    # one mult32 query on the warm plan (the pow2 wall is the one-lane k = 7
    # query of [dispatch], the default engine's lanes on one card)
    pow2_wall = dispatch_runs[f"count k=7 rmat{MID_SCALE} 1 lane"]["wall_s"]
    warm(mg, mplan)
    ops.reset_counts()
    t0 = time.perf_counter()
    res = ebbkc.count(mg, 7, engine_kwargs={"bins": MULT32})
    wall = time.perf_counter() - t0
    st = res.stats
    queries.append(("[widths] count k=7 mult32", st))
    launches, plain = ops.launch_counts(), ops.plain_counts()
    log(f"[widths] k=7 rmat{MID_SCALE} under mult32: count={res.count} "
        f"wall={wall:.2f} s (pow2, one lane in [dispatch]: "
        f"{pow2_wall:.2f} s) frontend={st.frontend_s:.2f} "
        f"worker-s ({st.pack_workers} workers, queue_occ="
        f"{st.pack_queue_occupancy:.2f}) tiles={res.tiles} plan cache hit "
        f"{st.plan_cache_hit} launches {launches}")
    if res.count != EXPECTED_MID[7]:
        fail(f"k=7 under mult32 counted {res.count}, expected "
             f"{EXPECTED_MID[7]}")
    if not (launches["clique_count_tiles"] and st.plan_cache_hit) \
            or sum(plain.values()):
        fail(f"k=7 under mult32: launches {launches}, plain calls {plain}, "
             f"plan cache hit {st.plan_cache_hit}")
    out["k7"] = dict(count=res.count, mult32_wall_s=wall,
                     pow2_wall_s=pow2_wall)
    return out


def child_env(env_extra=None) -> dict:
    """The environment of a fresh process of the port: ``src/`` on its
    path, no tune cache or fault plan from this environment unless
    ``env_extra`` sets one."""
    import os
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_TORCH_TUNE_CACHE", "REPRO_TORCH_FAULT_PLAN")}
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(env_extra or {})
    return env


def run_cli(argv, env_extra=None, timeout=900):
    """``python -m repro_torch.launch.clique ARGV`` in a fresh process
    (:func:`child_env`); returns its stdout."""
    env = child_env(env_extra)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.clique", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    log("[cli] " + " ".join(argv) + f" ({wall:.1f} s): "
        + " | ".join(proc.stdout.strip().splitlines()))
    if proc.returncode:
        fail(f"the launcher exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout, wall


def cli_count(out: str, k: int) -> int:
    m = re.search(rf"k={k}: (\d+) cliques", out)
    if m is None:
        fail(f"no k={k} count in the launcher's output")
    return int(m.group(1))


def dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*")
               if p.is_file())


def persist_phase(g, plan, lg, lplan, main_runs) -> dict:
    """``[persist]``: ``save_plan`` of the warm rmat15 plan and
    ``load_plan`` of its store (seconds, bytes, the tables equal); a fresh
    process counting k = 5 on rmat12 with ``--plan-cache`` loads that
    graph's store from disk (exact, ``warm``); and a store read under
    ``plan.load=1.0:corrupt`` (through REPRO_TORCH_FAULT_PLAN) is
    quarantined and rebuilt, and the count stays exact."""
    import shutil
    import numpy as np
    from repro_torch.core import pipeline
    out = {}
    base = ROOT / "build" / "smoke_plans"
    shutil.rmtree(base, ignore_errors=True)
    key = pipeline.plan_key(g, "hybrid")
    t0 = time.perf_counter()
    pipeline.save_plan(plan, str(base / key))
    out["save_s"] = time.perf_counter() - t0
    out["bytes"] = dir_bytes(base / key)
    t0 = time.perf_counter()
    loaded = pipeline.load_plan(str(base / key))
    out["load_s"] = time.perf_counter() - t0
    out["build_s_this_run"] = main_runs[5]["plan_build_s"]
    a, b = plan.table("hybrid"), loaded.table("hybrid")
    same = all(np.array_equal(getattr(a, f), getattr(b, f)) for f in (
        "edge_id", "anchors", "offsets", "verts", "thresh", "ekeys",
        "erank"))
    log(f"[persist] rmat15: save_plan {out['save_s']:.2f} s, "
        f"{out['bytes']} B on disk; load_plan {out['load_s']:.2f} s against "
        f"a {out['build_s_this_run']:.2f} s build in [main] (this run); "
        f"tables equal: {same}")
    if not same:
        fail("the loaded rmat15 plan differs from the saved one")
    lkey = pipeline.plan_key(lg, "hybrid")
    pipeline.save_plan(lplan, str(base / lkey))
    text, wall = run_cli(["--graph", f"rmat:{LIST_SCALE},{RMAT_EDGE_FACTOR}",
                          "--k", "5", "--plan-cache", str(base)])
    m = re.search(r"plan cache \[.*\]: warm \(decomposition skipped\), "
                  r"([0-9.]+)s", text)
    if m is None:
        fail("the second process did not load the rmat12 plan from disk")
    count = cli_count(text, 5)
    out["cli"] = dict(count=count, load_s=float(m.group(1)),
                      process_wall_s=wall)
    log(f"[persist] fresh process, --plan-cache: rmat12 count={count}, plan "
        f"loaded in {out['cli']['load_s']:.2f} s; process wall {wall:.1f} s")
    if count != EXPECTED_LIST[5][0]:
        fail(f"--plan-cache k=5 counted {count}, expected "
             f"{EXPECTED_LIST[5][0]}")
    text, _ = run_cli(["--graph", f"rmat:{LIST_SCALE},{RMAT_EDGE_FACTOR}",
                       "--k", "5", "--plan-cache", str(base)],
                      env_extra={"REPRO_TORCH_FAULT_PLAN":
                                 "plan.load=1.0:corrupt"})
    quarantined = list((base / lkey / "quarantine").iterdir()) \
        if (base / lkey / "quarantine").is_dir() else []
    count = cli_count(text, 5)
    out["corrupt"] = dict(count=count, quarantined=len(quarantined),
                          rebuilt="cold (built in" in text)
    log(f"[persist] rmat12 under plan.load=1.0:corrupt: count={count}, "
        f"{len(quarantined)} store(s) quarantined, rebuilt="
        f"{out['corrupt']['rebuilt']}")
    if (count != EXPECTED_LIST[5][0] or len(quarantined) != 1
            or not out["corrupt"]["rebuilt"]):
        fail(f"the corrupt plan store was not quarantined and rebuilt "
             f"exactly: {out['corrupt']}")
    return out


def tune_phase(g, main_runs) -> dict:
    """``[tune]``: the geometry search at the reference's budget (20 s)
    for counting at l = 5 and listing at l = 3, persisted to a tune cache
    (whose ``kernels/`` the library is built into); a fresh process with
    ``--tune-cache`` then resolves the count geometry from the record
    (``tune_hit=True``, no search) and counts k = 7 on rmat12 exactly;
    finally the kernel-vs-plain microbenchmark of ``autotune`` at
    (count, l = 5, T = 32), whose winner a CUDA lane reports and does not
    obey: the kernel runs, no plain version."""
    import shutil
    import torch
    from repro_torch import tune
    from repro_torch.kernels import _build, ops
    from repro_torch.tune import search
    out = {}
    base = ROOT / "build" / "smoke_tune"
    shutil.rmtree(base, ignore_errors=True)
    built = _build.build()  # [build]'s library, in the default directory
    tune.configure(str(base))
    try:
        # the library [build] compiled, copied into the tune cache: the
        # build finds it there by its source hash and compiles nothing
        t0 = time.perf_counter()
        (base / "kernels").mkdir(parents=True, exist_ok=True)
        shutil.copy2(built, base / "kernels" / built.name)
        if _build.build() != base / "kernels" / built.name:
            fail("the tune cache did not take the copied kernel library")
        out["cache_build_s"] = time.perf_counter() - t0
        log(f"[tune] kernel library copied into the tune cache "
            f"{base / 'kernels'}: {out['cache_build_s']:.2f} s")
        for mode, l in (("count", 5), ("list", 3)):
            t0 = time.perf_counter()
            rec = search.tune_geometry(mode, l, budget_s=20.0)
            geom = search.geometry_from_record(rec)
            out[f"{mode} l={l}"] = dict(
                wall_s=time.perf_counter() - t0, bins=list(geom.bins),
                **{k: v for k, v in rec.data.items()})
            log(f"[tune] tune_geometry({mode!r}, {l}): "
                f"{time.perf_counter() - t0:.1f} s, {rec.data['evals']} "
                f"evaluations, bins={geom.bins} batch_size={geom.batch_size} "
                f"cap_policy={geom.cap_policy} pack_workers="
                f"{geom.pack_workers}, {rec.data['throughput']:.0f} items/s "
                f"against {rec.data['baseline_throughput']:.0f} at the "
                f"defaults")
        want_bins = ",".join(map(str, search.geometry_from_record(
            tune.get(tune.geometry_key("count", 5))).bins))
        plans = ROOT / "build" / "smoke_plans"
        text, wall = run_cli(
            ["--graph", f"rmat:{LIST_SCALE},{RMAT_EDGE_FACTOR}", "--k", "7",
             "--tune-cache", str(base), "--plan-cache", str(plans)])
        count = cli_count(text, 7)
        ran = re.search(r"geometry: bins=([0-9,]+)", text)
        out["cli"] = dict(count=count, wall_s=wall,
                          bins=ran.group(1) if ran else None,
                          tune_hit="tune_hit=True" in text)
        log(f"[tune] fresh process, --tune-cache: count={count}, bins "
            f"{out['cli']['bins']} (record: {want_bins}), tune_hit="
            f"{out['cli']['tune_hit']}, {wall:.1f} s")
        if (count != EXPECTED_12_K7 or not out["cli"]["tune_hit"]
                or out["cli"]["bins"] != want_bins):
            fail(f"--tune-cache k=7 did not run the tuned geometry exactly: "
                 f"{out['cli']}")
        ops.clear_autotune_cache()
        winner = ops.autotune_backend("count", 5, 32)
        rec = tune.get(tune.backend_key("count", 5, 32))
        out["microbench"] = dict(winner=winner, times=rec.data["times"])
        log(f"[tune] microbench_backend('count', 5, 32): "
            + ", ".join(f"{b} {t * 1e3:.3f} ms" for b, t in
                        rec.data["times"].items()) + f"; winner {winner}")
        A, cand = (torch.from_numpy(x).view(torch.int32).cuda()
                   for x in seeded_tiles(41, 64, 32, 0.3))
        ops.reset_counts()
        got = ops.count_tiles(A, cand, 5, backend="autotune")
        launches, plain = ops.launch_counts(), ops.plain_counts()
        log(f"[tune] count_tiles(backend='autotune') on the card: winner "
            f"{winner} reported, launches {launches}, plain calls {plain}")
        if launches["clique_count_tiles"] != 1 or sum(plain.values()):
            fail("the autotune backend did not run the kernel on the card")
        from repro_torch.kernels import clique_count
        if not torch.equal(got, clique_count.clique_count_tiles_torch(
                A, cand, 5)):
            fail("the autotune backend's count differs from the plain one")
    finally:
        tune.configure(None)
        ops.clear_autotune_cache()
    return out


# ---------------------------------------------------------------------------
# [wide]: tiles wider than 256
# ---------------------------------------------------------------------------

#: tile widths of the kernels' wide path: W = 9, 16, 33 and 64
WIDE_T = (288, 512, 1056, 2048)
#: the engine ladder of [wide]: the pow2 bins and one above 256
WIDE_BINS = (32, 64, 128, 256, 512)
#: the [wide] engine graph: the complete multipartite graph of 88 parts of
#: 3 vertices (n = 264, m = 34,452); its widest tiles hold 258 vertices
TURAN_PARTS, TURAN_SIZE = 88, 3
#: calls a CUDA graph of [wide]'s timings captures (a wide launch takes up
#: to milliseconds, so the 100 of the other phases would take minutes)
WIDE_GRAPH_CALLS = 10
#: the wide kernels ptxas reports (two item-pass modes in the count
#: source, the per-item mode in the list source)
WIDE_KERNELS = ("branch_wide", "item_wide<0>", "item_wide<1>",
                "item_wide<2>", "list_emit_wide", "tri_wide",
                "edge_candidates_wide")


def planted_tiles(seed: int, B: int, T: int, sizes, noise: float,
                  spare: int):
    """(B, T, W) symmetric tiles and (B, W) cands: tile b a planted clique
    of ``sizes[b % len(sizes)]`` vertices on slots scattered over all T,
    ``spare`` more cand vertices, and ``noise`` random edges everywhere.
    Returns numpy words."""
    import numpy as np
    from repro_torch.core.bitops import pack_bits
    rng = np.random.default_rng(seed)
    dense = np.zeros((B, T, T), dtype=bool)
    cmask = np.zeros((B, T), dtype=bool)
    for b in range(B):
        s = min(T, sizes[b % len(sizes)])
        members = rng.choice(T, size=min(T, s + spare), replace=False)
        dense[b][np.ix_(members[:s], members[:s])] = True
        dense[b] |= rng.random((T, T)) < noise
        cmask[b, members] = True
    dense = np.triu(dense, 1)
    dense |= dense.transpose(0, 2, 1)
    return pack_bits(dense), pack_bits(cmask)


def wide_phase(rows, errs, ptxas) -> dict:
    """``[wide]``: the ptxas report of the wide path; each of the four
    kernels (and the per-branch count) at T = 288, 512, 1056 and 2048 on
    planted cliques under noise, held byte for byte against its plain
    version and timed; then one engine count and one listing through
    bins (32, ..., 256, 512) on the Turan graph of 88 parts of 3, whose
    widest tiles (258 vertices, 3-plexes the router leaves to the kernel)
    pack at T = 512, against closed forms."""
    out = {"ptxas": {}, "cases": {}, "graph_calls": WIDE_GRAPH_CALLS}
    for name in WIDE_KERNELS:
        info = ptxas.get(name)
        if info is None:
            fail(f"ptxas reported no {name}")
        out["ptxas"][name] = info
        log(f"[wide] ptxas {name}: {info['registers']} registers, "
            f"{info['stack']} B stack frame, {info['spill_stores']} B spill "
            f"stores, {info['spill_loads']} B spill loads")
        if info["spill_stores"] or info["spill_loads"]:
            fail(f"{name} spills: {info}")
    for T in WIDE_T:
        out["cases"][T] = wide_case(rows, errs, T)
    out["engine"] = wide_engine()
    return out


def wide_case(rows, errs, T: int) -> dict:
    """Every kernel at width T on 8 planted-clique tiles: held against its
    plain version and timed (l = 3 and 5 counts, per-branch counts, the
    l = 4 list at the exact capacity, edge candidates)."""
    import numpy as np
    import torch
    from repro_torch.core import listing
    from repro_torch.kernels import ops
    A, cand = (torch.from_numpy(x).view(torch.int32).cuda()
               for x in planted_tiles(T, 8, T, (11, 9, 10, 8),
                                      noise=2.0 / T, spare=4))
    rng = np.random.default_rng(T)
    a = rng.integers(0, T - 1, 8)
    pairs = torch.from_numpy(np.stack(
        [a, a + 1 + rng.integers(0, T - 1 - a)], 1).astype(np.int32)
    ).cuda()
    tag = f"wide T={T}"
    case = {}
    for l in (3, 5):
        for r in kernel_cases(rows, errs, A, cand, l, tag, reps=5,
                              calls=WIDE_GRAPH_CALLS):
            case[f"{r['kernel']} l={l}"] = r
    counts = ops.count_tiles(A, cand, 4).cpu().numpy()
    if counts.min() == 0:
        fail(f"[wide] a T={T} tile holds no 4-clique")
    case["list l=4"] = list_case(rows, errs, A, cand, 4,
                                 listing.capacity_for(counts), tag,
                                 reps=5, calls=WIDE_GRAPH_CALLS)
    case["edge"] = edge_case(rows, errs, A, pairs, tag, reps=5,
                             calls=WIDE_GRAPH_CALLS)
    log(f"[wide] T={T} (W={T // 32}) equal to the plain versions: "
        + ", ".join(f"{name} device {r['device_ms']:.5f} ms call "
                    f"{r['call_ms']:.4f} ms" for name, r in case.items()))
    return {name: dict(device_ms=r["device_ms"], call_ms=r["call_ms"],
                       plain_ms=r["plain_ms"], bound_ms=r.get("bound_ms"))
            for name, r in case.items()}


def wide_engine() -> dict:
    """The engines through bins (32, ..., 256, 512) on the Turan graph of
    88 parts of 3, against closed forms: the k = 5 count and the k = 3
    rows, with the T = 512 tiles reaching the kernels."""
    from math import comb
    import numpy as np
    import torch
    from repro_torch.core import ebbkc, engine_torch, listing, pipeline
    from repro_torch.core.graph import from_edges
    from repro_torch.kernels import ops
    n = TURAN_PARTS * TURAN_SIZE
    ii, jj = np.triu_indices(n, 1)
    keep = ii // TURAN_SIZE != jj // TURAN_SIZE
    g = from_edges(n, np.stack([ii[keep], jj[keep]], 1))
    t0 = time.perf_counter()
    plan = pipeline.cached_plan(g, "hybrid")
    plan_s = time.perf_counter() - t0
    top = WIDE_BINS[-1]
    table = plan.table("hybrid")

    def wide_ids(k):
        """The tiles of a k query that pack in the top bin."""
        ids = table.select(k)
        return ids[table.offsets[ids + 1] - table.offsets[ids]
                   > WIDE_BINS[-2]]
    wide = wide_ids(5)
    live = 0
    if wide.size:
        batch = pipeline._pack_batch(g, table, wide, top, "hybrid")
        A, cand = (torch.from_numpy(x).view(torch.int32).cuda()
                   for x in (batch.A, batch.cand))
        live = int((engine_torch.plex_stats(A, cand)[1] > 2).sum())
    if live == 0:
        fail(f"[wide] no tile at T={top} reaches the kernel: {wide.size} "
             f"tiles, {live} past the 2-plex router")
    want5 = comb(TURAN_PARTS, 5) * TURAN_SIZE ** 5
    ops.reset_counts()
    stage = {}
    t0 = time.perf_counter()
    res = ebbkc.count(g, 5, plan=plan, engine_kwargs=dict(
        bins=WIDE_BINS, stage_times=stage))
    count_s = time.perf_counter() - t0
    launches, plain = ops.launch_counts(), ops.plain_counts()
    t_top = stage.get(f"count_tiles_T{top}", 0.0)
    log(f"[wide] Turan graph {TURAN_PARTS} x {TURAN_SIZE} (n={g.n} m={g.m}):"
        f" plan {plan_s:.2f} s; count k=5 bins {WIDE_BINS}: {res.count} "
        f"(closed form {want5}) in {count_s:.2f} s; {wide.size} "
        f"tiles at T={top} ({live} past the 2-plex router), count_tiles "
        f"span at T={top} {1e3 * t_top:.2f} ms; launches {launches}")
    if res.count != want5 or not launches["triangle_count_tiles"] \
            or t_top <= 0 or sum(plain.values()):
        fail(f"[wide] count k=5: {res.count} (want {want5}), launches "
             f"{launches}, plain {plain}, T={top} span {t_top}")
    want3 = comb(TURAN_PARTS, 3) * TURAN_SIZE ** 3
    list_wide = int(wide_ids(3).size)
    sink = listing.ArraySink(3)
    ops.reset_counts()
    t0 = time.perf_counter()
    lres = listing.stream_cliques(plan, 3, sink, bins=WIDE_BINS)
    list_s = time.perf_counter() - t0
    got = sink.result()
    launches, plain = ops.launch_counts(), ops.plain_counts()
    parts = got // TURAN_SIZE
    keys = (got[:, 0] * n + got[:, 1]) * n + got[:, 2]
    exact = (got.shape == (want3, 3)
             and bool((parts[:, 0] != parts[:, 1]).all())
             and bool((parts[:, 1] != parts[:, 2]).all())
             and bool((parts[:, 0] != parts[:, 2]).all())
             and np.unique(keys).size == want3)
    log(f"[wide] list k=3 bins {WIDE_BINS}: {got.shape[0]} rows (closed "
        f"form {want3}), every row three parts and no row twice: {exact}, "
        f"{list_s:.2f} s, {list_wide} tiles at T={top}, overflowed "
        f"{lres.stats.overflowed_tiles}; launches {launches}")
    if not exact or not list_wide or sum(plain.values()) \
            or launches["clique_list_tiles"] == 0:
        fail(f"[wide] list k=3: exact={exact}, launches {launches}, plain "
             f"{plain}, {list_wide} wide tiles")
    return dict(n=g.n, m=g.m, plan_s=plan_s, count=res.count,
                count_s=count_s, wide_tiles=int(wide.size),
                wide_live=live, count_tiles_top_s=t_top,
                list_rows=int(got.shape[0]), list_s=list_s)


# ---------------------------------------------------------------------------
# [delta]: dynamic graphs
# ---------------------------------------------------------------------------

#: inserted and deleted pairs of each repair batch on rmat12, and of the
#: batch that must pass CHURN_THRESHOLD (a rebuild)
DELTA_REPAIR_PAIRS = 10
DELTA_REBUILD_PAIRS = 250
#: the spans the [delta] split sums: the delta's own (each side's listing,
#: the set differences with their sort) and the listing's inside them
DELTA_SPANS = ("delta/list", "delta/diff", "extract", "pack", "device",
               "decode", "overflow/relist")
#: the k of the 0.2 % batch's net counts on rmat13 (k = 7 left out: the
#: batch rebuilds, so each k recounts both whole graphs)
DELTA_MID_KS = (5,)


def clique_checks(rows, graph, batch_keys) -> dict:
    """Row checks of a delta side: every row a clique of ``graph`` holding
    a pair of ``batch_keys`` (canonical u * n + v keys), and no row twice.
    Keys are matched by sorts and binary searches (``np.isin`` runs a slow
    hash-based unique in newer numpy)."""
    import numpy as np

    def member(keys, ref):
        if ref.size == 0:
            return np.zeros(keys.shape, dtype=bool)
        at = np.minimum(np.searchsorted(ref, keys), ref.size - 1)
        return ref[at] == keys
    n, k = graph.n, rows.shape[1]
    ek, bk = np.sort(graph.edge_keys()), np.sort(batch_keys)
    clique = np.ones(rows.shape[0], dtype=bool)
    holds = np.zeros(rows.shape[0], dtype=bool)
    for i in range(k):
        for j in range(i + 1, k):
            key = rows[:, i] * n + rows[:, j]
            clique &= member(key, ek)
            holds |= member(key, bk)
    w = n ** np.arange(k - 1, -1, -1, dtype=np.int64)
    keys = np.sort(rows @ w)
    return dict(cliques=bool(clique.all()), hold_batch_edge=bool(holds.all()),
                distinct=not bool((keys[1:] == keys[:-1]).any()))


def delta_phase(mg, mplan, lg, lplan) -> dict:
    """``[delta]``: a PlanIndex on rmat12 on the card (its plan warm from
    the listing phase) takes three seeded repair batches and one past
    CHURN_THRESHOLD; each batch's table equals a full build under the
    index's decomposition, its k = 5 and 6 counts equal a fresh plan's, and
    its k = 5 delta (the list kernel over the touched tiles) is exact by
    three card counts and by its rows, its time split by the trace.  The
    composed delta since version 0 follows the per-batch deltas.  Then one
    seeded 0.2 % batch on rmat13 with its net counts against the pinned
    counts and the fresh plan's."""
    import numpy as np
    from repro_torch.core import ebbkc, pipeline
    from repro_torch.core.engine_np import Stats
    from repro_torch.core.graph import from_edges
    from repro_torch.delta import CHURN_THRESHOLD, PlanIndex
    from repro_torch.delta.query import delta_net_count
    from repro_torch.kernels import ops
    from repro_torch.obs import trace
    out = {"batches": []}
    stats = Stats()
    warm(lg, lplan)
    warm(mg, mplan)
    idx = PlanIndex(lg, stats=stats)
    if not stats.plan_cache_hit:
        fail("[delta] the rmat12 plan was not warm")
    rng = np.random.default_rng(7)
    fields = ("edge_id", "anchors", "offsets", "verts", "thresh", "ekeys",
              "erank")
    c5_old = EXPECTED_LIST[5][0]
    events = []  # (version, gained keys, lost keys) for the composition
    n = lg.n
    w5 = n ** np.arange(4, -1, -1, dtype=np.int64)
    for b, pairs in enumerate((DELTA_REPAIR_PAIRS,) * 3
                              + (DELTA_REBUILD_PAIRS,)):
        g_old = idx.graph
        ins = rng.integers(0, n, (pairs, 2))
        dele = g_old.edges[rng.choice(g_old.m, pairs, replace=False)]
        t0 = time.perf_counter()
        version = idx.apply_batch(insert=ins, delete=dele)
        repair_s = time.perf_counter() - t0
        rec = idx._records[-1]
        info, g_new = rec.info, idx.graph
        # a rebuilt batch's plan is a fresh build_plan(g_new) already
        t0 = time.perf_counter()
        fresh = idx.plan if info.rebuilt else pipeline.build_plan(g_new)
        build_s = repair_s if info.rebuilt else time.perf_counter() - t0
        # the repaired table against a whole table build under the index's
        # (repaired) truss order: a fresh order differs, by design
        full = pipeline._build_truss_table(g_new, idx.plan._td)
        table = idx.plan.table("hybrid")
        same_table = all(np.array_equal(getattr(table, f), getattr(full, f))
                         for f in fields)
        counts = {}
        for k in (5, 6):
            c = ebbkc.count(g_new, k, plan=idx.plan).count
            counts[k] = (c, c if info.rebuilt else
                         ebbkc.count(g_new, k, plan=fresh).count)
        ops.reset_counts()
        trace.configure(enabled=True)
        trace.reset()
        t0 = time.perf_counter()
        try:
            d = rec.delta(5, idx.order, **idx.query)
        finally:
            trace.configure(enabled=False)
        delta_s = time.perf_counter() - t0
        split = {name: v for name, v in trace.stage_durations(
            trace.chrome_trace(), DELTA_SPANS).items() if name in DELTA_SPANS}
        trace.reset()
        launches, plain = ops.launch_counts(), ops.plain_counts()
        both = np.intersect1d(g_old.edge_keys(), g_new.edge_keys())
        g_int = from_edges(n, np.stack([both // n, both % n], 1))
        c5_int = ebbkc.count(g_int, 5, engine_kwargs=dict(
            plan_cache=False)).count
        c5_new = counts[5][1]
        ins_keys = np.setdiff1d(g_new.edge_keys(), g_old.edge_keys())
        del_keys = np.setdiff1d(g_old.edge_keys(), g_new.edge_keys())
        gained = clique_checks(d.gained, g_new, ins_keys)
        lost = clique_checks(d.lost, g_old, del_keys)
        run = dict(batch=b, version=version, inserted=info.n_insert,
                   deleted=info.n_delete, churn=info.churn,
                   rebuilt=info.rebuilt, touched=int(info.touched_new.size),
                   repair_s=repair_s, build_plan_s=build_s,
                   same_table=same_table, counts=counts,
                   gained=int(d.gained.shape[0]), lost=int(d.lost.shape[0]),
                   count_old=c5_old, count_new=c5_new, count_both=c5_int,
                   delta_s=delta_s, split_s=split, launches=launches,
                   gained_rows=gained, lost_rows=lost)
        out["batches"].append(run)
        log(f"[delta] rmat12 batch {b}: +{info.n_insert} -{info.n_delete} "
            f"pairs, churn {info.churn:.4f} (threshold {CHURN_THRESHOLD}), "
            f"touched {run['touched']}, "
            f"{'rebuilt' if info.rebuilt else 'repaired'} in {repair_s:.3f} "
            f"s against build_plan {build_s:.3f} s; table equal: "
            f"{same_table}; k=5/6 counts repaired/fresh {counts}; delta "
            f"k=5 +{run['gained']} -{run['lost']} in {delta_s:.2f} s "
            f"(counts old {c5_old} new {c5_new} both {c5_int}); gained rows "
            f"{gained}, lost rows {lost}; launches {launches}")
        log(f"[delta] rmat12 batch {b}: the delta's split (traced, s): "
            + ", ".join(f"{name} {v:.3f}" for name, v in split.items()))
        if not (same_table and all(a == f for a, f in counts.values())):
            fail(f"[delta] batch {b}: the index's plan differs from a fresh "
                 f"one: table {same_table}, counts {counts}")
        if (run["gained"] != c5_new - c5_int
                or run["lost"] != c5_old - c5_int
                or not all(gained.values()) or not all(lost.values())):
            fail(f"[delta] batch {b}: the delta is not exact: {run}")
        if not launches["clique_list_tiles"] or sum(plain.values()):
            fail(f"[delta] batch {b}: launches {launches}, plain {plain}")
        if b == 3 and not info.rebuilt:
            fail(f"[delta] batch {b} ({pairs} pairs a side) did not pass "
                 f"the churn threshold: churn {info.churn}")
        events.append((version, d.gained @ w5, d.lost @ w5))
        c5_old = c5_new
        if b == 0:
            out["first_batch"] = dict(insert=ins, delete=dele,
                                      gained=d.gained)
    # the composition since version 0: a clique is gained when its first
    # and last events are gains, lost when both are losses
    first, last = {}, {}
    for version, gk, lk in events:
        for keys, kind in ((gk, "gain"), (lk, "loss")):
            for key in keys.tolist():
                first.setdefault(key, kind)
                last[key] = kind
    want_g = sorted(k for k in first if first[k] == last[k] == "gain")
    want_l = sorted(k for k in first if first[k] == last[k] == "loss")
    comp = idx.delta(5, 0)
    composed = (sorted((comp.gained @ w5).tolist()) == want_g
                and sorted((comp.lost @ w5).tolist()) == want_l)
    out["composed"] = dict(gained=int(comp.gained.shape[0]),
                           lost=int(comp.lost.shape[0]), exact=composed)
    log(f"[delta] composed since version 0: +{comp.gained.shape[0]} "
        f"-{comp.lost.shape[0]}, equal to the per-batch deltas in order: "
        f"{composed}; index stats: {stats.plan_repairs} repairs, "
        f"{stats.plan_rebuilds} rebuilds, {stats.plan_repair_s:.3f} s "
        f"repairing, {stats.delta_touched_edges} touched edges")
    if not composed:
        fail("[delta] the composed delta does not follow the batches")

    # one 0.2 % batch on rmat13, its net counts on the card
    idx_mid = PlanIndex(mg)
    rng = np.random.default_rng(7)
    pairs = round(0.002 * mg.m)
    ins = rng.integers(0, mg.n, (pairs - pairs // 2, 2))
    dele = mg.edges[rng.choice(mg.m, pairs // 2, replace=False)]
    t0 = time.perf_counter()
    idx_mid.apply_batch(insert=ins, delete=dele)
    repair_s = time.perf_counter() - t0
    rec = idx_mid._records[-1]
    info = rec.info
    run = dict(pairs=pairs, churn=info.churn, rebuilt=info.rebuilt,
               touched=int(info.touched_new.size), repair_s=repair_s)
    if info.rebuilt:
        fresh, run["build_plan_s"] = rec.new_plan, repair_s
    else:
        t0 = time.perf_counter()
        fresh = pipeline.build_plan(idx_mid.graph)
        run["build_plan_s"] = time.perf_counter() - t0
    for k in DELTA_MID_KS:
        ops.reset_counts()
        t0 = time.perf_counter()
        c_old, c_new, net = delta_net_count(rec.old_plan, rec.new_plan, info,
                                            k)
        net_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        c_fresh = (c_new if info.rebuilt
                   else ebbkc.count(idx_mid.graph, k, plan=fresh).count)
        run[f"k={k}"] = dict(retired=c_old, replaced=c_new, net=net,
                             fresh=c_fresh, net_s=net_s, launches=launches)
        log(f"[delta] rmat{MID_SCALE} 0.2 % batch ({pairs} pairs): churn "
            f"{info.churn:.4f}, touched {run['touched']}, "
            f"{'rebuilt' if info.rebuilt else 'repaired'} in {repair_s:.2f} "
            f"s (build_plan {run['build_plan_s']:.2f} s); k={k}: net {net} "
            f"(retired {c_old}, replaced {c_new}) in {net_s:.2f} s, pinned "
            f"{EXPECTED_MID[k]} + net = {EXPECTED_MID[k] + net}, fresh "
            f"plan {c_fresh}; launches {launches}")
        if EXPECTED_MID[k] + net != c_fresh or (
                info.rebuilt and c_old != EXPECTED_MID[k]):
            fail(f"[delta] rmat{MID_SCALE} k={k}: pinned {EXPECTED_MID[k]} "
                 f"+ net {net} != fresh {c_fresh} (retired {c_old})")
    out[f"rmat{MID_SCALE}"] = run
    return out


# ---------------------------------------------------------------------------
# [serve]: the serving tier
# ---------------------------------------------------------------------------

#: the burst's requests, one a client thread: (graph, k, mode, options)
SERVE_VERTEX, SERVE_MAX_OUT = 7, 1000
SERVE_SPECS = (
    ("rmat13", 5, "count", {}), ("rmat13", 7, "count", {}),
    ("rmat12", 5, "count", {}), ("rmat12", 6, "count", {}),
    ("rmat12", 7, "count", {}), ("rmat12", 5, "list", {}),
    ("rmat12", 5, "list", dict(vertex_filter=SERVE_VERTEX)),
    ("rmat12", 5, "list", dict(vertex_filter=SERVE_VERTEX,
                               max_out=SERVE_MAX_OUT)),
)


def serve_burst(svc, specs, tolerate=()):
    """One paused-then-resumed burst: a client thread per request submits
    while the service is paused, the service resumes once every request
    is queued, and each thread waits for its result.  A request that
    fails with an exception of ``tolerate`` gives that exception as its
    result; any other failure raises.  Returns (results, wall seconds from
    resume to the last result)."""
    import threading
    results = [None] * len(specs)
    queued = threading.Barrier(len(specs) + 1)
    errors = []

    def client(i, name, k, mode, kw):
        try:
            ticket = svc.submit(name, k, mode, **kw)
            queued.wait()
            try:
                results[i] = ticket.result(900)
            except tolerate as exc:
                results[i] = exc
        except BaseException as exc:  # raised after join
            errors.append(exc)
            queued.abort()

    svc.pause()
    threads = [threading.Thread(target=client, args=(i, *spec))
               for i, spec in enumerate(specs)]
    for t in threads:
        t.start()
    queued.wait()
    t0 = time.perf_counter()
    svc.resume()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results, time.perf_counter() - t0


def serve_phase(mg, mplan, lg, lplan, delta_runs, list_runs) -> dict:
    """``[serve]``: one CliqueService on the card with rmat13 and rmat12
    registered (plans warm): a paused-then-resumed burst of 8 client
    threads (counts k = 5, 7 on rmat13 and k = 5, 6, 7 on rmat12; lists
    k = 5 on rmat12 unfiltered, filtered and truncated) against the pinned
    counts and digest; an update of rmat12 and a delta read against
    ``[delta]``'s first batch; a metrics scrape; the burst's rmat12
    requests on two lanes of the card, under the profiler for the device's
    busy share; the same rmat12 requests under the chaos plan (each exact
    or failed alone, then a clean request exact); and the serial
    yardstick."""
    import numpy as np
    from repro_torch.core import ebbkc
    from repro_torch.kernels import ops
    from repro_torch.obs.export import scrape
    from repro_torch.resilience import inject
    from repro_torch.serve import CliqueService, apply_vertex_filter
    graphs = {"rmat13": mg, "rmat12": lg}
    warm(mg, mplan)
    warm(lg, lplan)
    pinned = {("rmat13", 5): EXPECTED_MID[5], ("rmat13", 7): EXPECTED_MID[7],
              ("rmat12", 5): EXPECTED_LIST[5][0],
              ("rmat12", 6): EXPECTED_LIST[6][0],
              ("rmat12", 7): EXPECTED_12_K7}
    out = {}
    lone = {}  # the unfiltered listing's rows, which the filtered ones follow

    def check(tag, specs, results):
        for (name, k, mode, kw), res in zip(specs, results):
            if mode == "count":
                ok = res.count == pinned[(name, k)]
            elif not kw:
                lone["rows"] = res.rows
                ok = (res.rows.shape[0], hashlib.sha256(
                    np.ascontiguousarray(res.rows, dtype="<i8")).hexdigest()
                ) == EXPECTED_LIST[5]
            else:
                want = apply_vertex_filter(lone["rows"], kw["vertex_filter"])
                want = want[:kw.get("max_out", want.shape[0])]
                ok = res.rows.tobytes() == want.tobytes()
            if not ok:
                fail(f"[serve] {tag}: {name} k={k} {mode} {kw} is not the "
                     f"pinned result")

    def burst(tag, lanes, specs, profiled=False):
        svc = CliqueService(devices=lanes)
        try:
            for name, graph in graphs.items():
                svc.register_graph(name, graph)
            ops.reset_counts()
            if profiled:
                busy = device_busy(f"burst {tag}",
                                   lambda: serve_burst(svc, specs),
                                   tag="[serve]")
                results, wall = busy.pop("result")
            else:
                busy = None
                results, wall = serve_burst(svc, specs)
            launches, plain = ops.launch_counts(), ops.plain_counts()
            check(tag, specs, results)
            if not all(r.stats.plan_cache_hit for r in results):
                fail(f"[serve] burst {tag}: a request built its plan")
            st = svc.stats
            lat = sorted(r.latency_s for r in results)
            ok = sum(1 for r in results if not r.deadline_missed)
            run = dict(wall_s=wall, p50_s=float(np.percentile(lat, 50)),
                       p99_s=float(np.percentile(lat, 99)),
                       goodput_rps=ok / wall, latencies_s=lat,
                       fused_batches=st.fused_batches,
                       cross_request_batches=st.cross_request_batches,
                       fused_chunks=st.fused_chunks, launches=launches,
                       busy=busy)
            log(f"[serve] burst {tag}: {len(results)} requests exact in "
                f"{wall:.2f} s, latency p50 {run['p50_s']:.2f} s p99 "
                f"{run['p99_s']:.2f} s, goodput {run['goodput_rps']:.3f} "
                f"req/s, fused batches {st.fused_batches} (cross-request "
                f"{st.cross_request_batches}, {st.fused_chunks} chunks), "
                f"launches {launches}"
                + (f", device busy {100 * busy['busy_share']:.2f}% of the "
                   f"burst" if busy and busy["busy_share"] is not None
                   else ""))
            if st.cross_request_batches == 0:
                fail(f"[serve] burst {tag}: no cross-request batch")
            if sum(plain.values()) or not all(
                    launches[k] for k in ("triangle_count_tiles",
                                          "clique_count_tiles",
                                          "clique_list_tiles")):
                fail(f"[serve] burst {tag}: launches {launches}, plain "
                     f"{plain}")
            return svc, run
        except BaseException:
            svc.close()
            raise

    svc, out["one_lane"] = burst("1 lane", ["cuda:0"], SERVE_SPECS)
    try:
        # update rmat12 with [delta]'s first batch and read the delta
        first = delta_runs["first_batch"]
        t0 = time.perf_counter()
        version = svc.update_graph("rmat12", insert=first["insert"],
                                   delete=first["delete"])
        update_s = time.perf_counter() - t0
        ops.reset_counts()
        d = svc.submit("rmat12", 5, "delta", since_version=0).result(900)
        same = d.rows.tobytes() == first["gained"].tobytes()
        out["delta"] = dict(version=version, update_s=update_s,
                            rows=int(d.rows.shape[0]), equal=same,
                            latency_s=d.latency_s,
                            launches=ops.launch_counts())
        log(f"[serve] update_graph rmat12 -> version {version} in "
            f"{update_s:.3f} s; delta since 0: {d.rows.shape[0]} rows in "
            f"{d.latency_s:.2f} s, equal to [delta]'s first batch: {same}; "
            f"launches {out['delta']['launches']}")
        if not same or svc.stats.graph_updates != 1:
            fail("[serve] the delta read differs from [delta]'s first batch")
        # the metrics collector and server
        from repro_torch.obs import metrics as obs_metrics
        from repro_torch.obs.export import MetricsServer
        reg = obs_metrics.get_registry()
        reg.add_collector(svc._collect_metrics)
        srv = MetricsServer(port=0, registry=reg)
        try:
            text = scrape(srv.address)
        finally:
            srv.close()
            reg.remove_collector(svc._collect_metrics)
        serve_series = sorted({line.split("{")[0].split(" ")[0]
                               for line in text.splitlines()
                               if line.startswith("repro_serve_")})
        out["metrics"] = dict(series=serve_series, bytes=len(text))
        log(f"[serve] metrics scrape {srv.address}/metrics: "
            f"{len(serve_series)} repro_serve_ series, {len(text)} bytes: "
            f"{', '.join(serve_series)}")
        if "repro_serve_cross_request_batches_total" not in serve_series:
            fail("[serve] the scrape lacks the serve series")
    finally:
        svc.close()
    # two lanes take the rmat12 requests, under the profiler (the device's
    # busy share): the rmat13 counts' time is the scheduler thread's serial
    # packing, one lane or two, and the full burst's profiler events take
    # long to read
    svc, out["two_lanes"] = burst(
        "2 lanes", ["cuda:0", "cuda:0"],
        [s for s in SERVE_SPECS if s[0] == "rmat12"], profiled=True)
    svc.close()

    # the rmat12 burst under the chaos plan: on a CUDA lane an injected
    # fault is retried on the kernel and then raises, so a request whose
    # launch draws a fault on every attempt fails with FaultInjected; it
    # must fail alone (every other request exact), and the service must
    # then serve a clean request exactly
    chaos = [s for s in SERVE_SPECS if s[0] == "rmat12"]
    svc = CliqueService(devices=["cuda:0"])
    try:
        svc.register_graph("rmat12", lg)
        inject.configure("seed=7;*=0.1")
        try:
            results, wall = serve_burst(svc, chaos,
                                        tolerate=(inject.FaultInjected,))
            fired = inject.fired()
        finally:
            inject.configure(None)
        failed = [f"{name} k={k} {mode}" + (" filtered" if kw else "")
                  for (name, k, mode, kw), r in zip(chaos, results)
                  if isinstance(r, inject.FaultInjected)]
        served = [(spec, r) for spec, r in zip(chaos, results)
                  if not isinstance(r, inject.FaultInjected)]
        check("chaos", [spec for spec, _ in served], [r for _, r in served])
        isolated = svc.stats.isolated_failures
        t0 = time.perf_counter()
        clean = svc.submit("rmat12", 6, "count").result(900)
        clean_s = time.perf_counter() - t0
        check("after chaos", [("rmat12", 6, "count", {})], [clean])
        retries = sum(r.stats.retries for _, r in served)
        out["chaos"] = dict(wall_s=wall, fired=fired, retries=retries,
                            engine_retries=svc.engine_stats.retries,
                            failed=failed, exact=len(served),
                            isolated_failures=isolated, clean_s=clean_s)
        log(f"[serve] burst of {len(chaos)} rmat12 requests under "
            f"seed=7;*=0.1 in {wall:.2f} s: {len(served)} exact, "
            f"{len(failed)} failed alone with FaultInjected {failed} "
            f"({isolated} isolation events); faults fired {fired}, retries "
            f"{svc.engine_stats.retries} (engine) {retries} (requests); "
            f"then a clean k=6 count exact in {clean_s:.2f} s")
        if not sum(fired.values()):
            fail("[serve] the chaos plan fired no fault")
        # isolated_failures counts isolation events: a request is isolated
        # once for each of its fused batches or streams that failed
        if isolated < len(failed):
            fail(f"[serve] {len(failed)} requests failed but the scheduler "
                 f"isolated {isolated} times")
    finally:
        svc.close()

    # the serial yardstick: the same requests one at a time through ebbkc
    # (the listing is [list main]'s warm k = 5 query; a serial client
    # filters the listing's rows itself)
    warm(mg, mplan)
    serial = {}
    for name, k, mode, kw in SERVE_SPECS:
        key = f"{name} k={k} {mode}" + ("" if not kw else " filtered")
        if mode == "list":
            if not kw:  # the filtered ones are the client's own filtering
                serial[key] = list_runs["k=5 warm"]["wall_s"]
            continue
        t0 = time.perf_counter()
        if mode == "count":
            got = ebbkc.count(graphs[name], k).count
            if got != pinned[(name, k)]:
                fail(f"[serve] serial {key}: {got}")
        else:
            rows, _ = ebbkc.list_cliques(graphs[name], k)
            if rows.shape[0] != EXPECTED_LIST[5][0]:
                fail(f"[serve] serial {key}: {rows.shape[0]} rows")
        serial[key] = time.perf_counter() - t0
    total = sum(serial.values())
    out["serial"] = dict(walls_s=serial, total_s=total,
                         goodput_rps=len(SERVE_SPECS) / total)
    log(f"[serve] serial yardstick (one request at a time through ebbkc, "
        f"not gated): {total:.2f} s for {len(SERVE_SPECS)} requests "
        f"({len(SERVE_SPECS) / total:.3f} req/s): "
        + ", ".join(f"{k} {v:.2f} s" for k, v in serial.items()))
    return out



# The paper baseline runs on rmat_graph(11, 16, seed=7) (n = 2,048): the
# largest scale of the generator whose four VBBkC host counts (ddegcol and
# ddegcol+ at k = 5 and 6) take under a minute (19 s on a CPU; rmat12
# about 75 s).  Counts from the JAX reference package on a CPU:
#   PYTHONPATH=src python -c "from repro.data.graphs import rmat_graph; \
#     from repro.core import ebbkc; g = rmat_graph(11, 16, seed=7); \
#     print(ebbkc.count(g, K).count)"
# with K = 5 and 6 (the k = 6 count is EXPECTED_LIST6's row count).
BASELINE_SCALE = 11
EXPECTED_11 = {5: 6_650_633, 6: EXPECTED_LIST6[0]}


def baseline_phase() -> dict:
    """``[baseline]``: the paper's VBBkC baseline (``vbbkc.count``, host
    recursion, as in the reference) with ``ddegcol`` and ``ddegcol+`` at
    k = 5 and 6 on rmat11, each equal to the card's ``ebbkc.count`` on the
    same graph and to the pinned count; Lemma 4.1 (tau < delta) by
    ``tau_delta_gap``; the quickstart twin in a fresh process on the
    card."""
    from repro_torch.core import ebbkc, vbbkc
    from repro_torch.core.truss import tau_delta_gap
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.kernels import ops
    g = rmat_graph(BASELINE_SCALE, edge_factor=16, seed=RMAT_SEED)
    out = {"n": g.n, "m": g.m}
    for k in (5, 6):
        ops.reset_counts()
        t0 = time.perf_counter()
        card = ebbkc.count(g, k).count
        card_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        run = dict(card=card, card_s=card_s, launches=launches)
        for variant in ("ddegcol", "ddegcol+"):
            t0 = time.perf_counter()
            r = vbbkc.count(g, k, variant=variant)
            run[variant] = dict(count=r.count, s=time.perf_counter() - t0,
                                branches=r.stats.branches,
                                pruned_color=r.stats.pruned_color,
                                tiles=r.tiles, max_tile=r.max_tile)
            if r.count != card or card != EXPECTED_11[k]:
                fail(f"[baseline] k={k}: VBBkC {variant} {r.count}, card "
                     f"{card}, pinned {EXPECTED_11[k]}")
        if not sum(launches.values()) or sum(ops.plain_counts().values()):
            fail(f"[baseline] k={k}: the card's count launched {launches}")
        out[f"k={k}"] = run
        log(f"[baseline] rmat{BASELINE_SCALE} k={k}: {card} cliques; card "
            f"ebbkc.count {card_s:.2f} s (launches {launches}); host VBBkC "
            + ", ".join(f"{v} {run[v]['s']:.2f} s ({run[v]['branches']} "
                        f"branches, {run[v]['pruned_color']} color-pruned)"
                        for v in ("ddegcol", "ddegcol+"))
            + " -- equal")
    t0 = time.perf_counter()
    tau, delta = tau_delta_gap(g)
    out["tau_delta"] = dict(tau=tau, delta=int(delta),
                            s=time.perf_counter() - t0)
    log(f"[baseline] tau_delta_gap: tau={tau} delta={delta} (Lemma 4.1 "
        f"tau < delta: {tau < delta})")
    if not tau < delta:
        fail("[baseline] tau >= delta")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py")],
        cwd=ROOT, env=child_env(), capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    log(f"[baseline] examples/quickstart_torch.py ({wall:.1f} s, exit "
        f"{proc.returncode}): " + " | ".join(lines))
    if proc.returncode or not lines or not lines[-1].startswith(
            "device engine agrees: True (engine: torch:cuda"):
        fail(f"[baseline] the quickstart twin failed: {proc.stderr[-2000:]}")
    out["quickstart_s"] = wall
    return out


def truss_phase(lg) -> dict:
    """``[truss]``: the on-device truss decomposition
    (``truss_decomposition_torch``, round-based peeling in torch ops) on
    rmat12 on the card against the port's host peeler: trussness array and
    tau equal; both times and the card's peak memory."""
    import numpy as np
    import torch
    from repro_torch.core.truss import truss_decomposition
    from repro_torch.core.truss_torch import truss_decomposition_torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by earlier phases
    runs = []
    for _ in range(2):  # the first call pays the ops' first launches
        t0 = time.perf_counter()
        truss, tau = truss_decomposition_torch(lg)  # ends in a D2H read
        runs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - held
    t0 = time.perf_counter()
    td = truss_decomposition(lg)
    host_s = time.perf_counter() - t0
    same = bool(np.array_equal(truss, td.trussness)) and tau == td.tau
    out = dict(n=lg.n, m=lg.m, tau=tau, device_s=runs, host_s=host_s,
               peak_bytes=peak, equal=same)
    log(f"[truss] rmat{LIST_SCALE} (n={lg.n}, m={lg.m}): card "
        f"truss_decomposition_torch {runs[0]:.3f} s cold, {runs[1]:.3f} s "
        f"warm (peak {peak / 2**20:.1f} MiB over what earlier phases hold); "
        f"host peeler {host_s:.3f} s; "
        f"tau {tau} (host {td.tau}); trussness equal: {same}")
    if not same:
        fail("[truss] the card's trussness differs from the host peeler's")
    return out


# [lm serve]: granite-3-8b at its published widths, 8 requests of 32
# prompt tokens and 16 greedy tokens.  LM_ATOL bounds three readings of
# the max |logit| difference: the first decode step against forward on the
# prompt plus that token (both bf16: the two sides take different GEMM
# shapes, so bf16 rounding differs and grows over 40 layers), the bf16
# prefill against an f32 forward of the same params (the casts), and the
# prefill against forward's last position (the two share the layer code,
# so this one reads 0 unless prefill's own embedding, norm or last-position
# slice departs).  Logits from these weights have magnitude up to about 6,
# where one bf16 ulp is 0.03, and the bound is 8 of them.  The planted
# faults (LM_FAULTS) show that the bound catches a wrong position, a wrong
# request's cache and a lost cache entry: each must read above it.
LM_ARCH, LM_REQUESTS, LM_PROMPT, LM_TOKENS = "granite-3-8b", 8, 32, 16
LM_ATOL = 0.25
#: the first decode step, faulted on purpose, against forward(prompt +
#: token): decoding at position lengths - 1 (over the prompt's last cache
#: slot), reading the next request's cache, and with the prompt's last
#: cache entry zeroed in every layer
LM_FAULTS = ("position lengths - 1", "another request's cache",
             "last prompt entry lost")
# the reduced configs on the card against the port's CPU run, f32 with
# TF32 off: summation order only
LM_SMALL_TOL = dict(rtol=1e-4, atol=1e-4)


def lm_planted_faults(params, prompts, token, cfg, want) -> dict:
    """Max |logits - want| of the first decode step (``token`` after
    ``prompts``) with each of :data:`LM_FAULTS` planted in its inputs, the
    unfaulted step as the control; each step on a fresh prefill cache."""
    import torch
    from repro_torch.models import transformer as tr
    B, S = prompts.shape
    lengths = torch.full((B,), S, dtype=torch.int64, device=prompts.device)

    def lose_last(cache):
        for kv in cache.values():
            Sc = kv["k"].shape[2]
            kv["k"][:, :, (S - 1) % Sc] = 0
            kv["v"][:, :, (S - 1) % Sc] = 0
        return cache

    def roll(cache):
        return {kind: {n: torch.roll(x, 1, dims=1) for n, x in kv.items()}
                for kind, kv in cache.items()}

    plants = {"control": (lambda c: c, lengths),
              LM_FAULTS[0]: (lambda c: c, lengths - 1),
              LM_FAULTS[1]: (roll, lengths),
              LM_FAULTS[2]: (lose_last, lengths)}
    out = {}
    with torch.inference_mode():
        for name, (plant, at) in plants.items():
            _, cache = tr.prefill(params, prompts, cfg,
                                  max_len=S + LM_TOKENS)
            logits, _ = tr.decode_step(params, plant(cache), token, at, cfg)
            out[name] = float((logits - want).abs().max())
    return out


def lm_phase(header: str) -> dict:
    """``[lm serve]``: ``repro_torch.launch.serve`` at granite-3-8b's full
    width on the card (its CLI entry in this process, then the checked run
    on the same seed); prefill and decode checked against ``forward`` and
    the bf16 prefill against an f32 ``forward``, the planted faults of
    :func:`lm_planted_faults` beyond the same bound, every generated id in
    ``[0, padded_vocab)``; prefill and decode tok/s,
    peak memory and the busy share of one profiled run; then the reduced
    granite-3-8b and gemma3-27b configs (local windows) on the card
    against the port's CPU run on the same params."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tr
    torch.cuda.empty_cache()
    cfg = configs.get(LM_ARCH).full
    out = {"arch": LM_ARCH, "num_params": cfg.num_params(),
           "padded_vocab": cfg.padded_vocab}
    argv = ["--arch", LM_ARCH, "--full", "--requests", str(LM_REQUESTS),
            "--prompt-len", str(LM_PROMPT), "--tokens", str(LM_TOKENS)]
    cli = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli):
        serve.main(argv)
    out["cli"] = dict(wall_s=time.perf_counter() - t0,
                      stdout=cli.getvalue().strip().splitlines())
    log(f"[lm serve] python -m repro_torch.launch.serve {' '.join(argv)} "
        f"({out['cli']['wall_s']:.1f} s): " + " | ".join(out["cli"]["stdout"]))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by earlier phases
    t0 = time.perf_counter()
    params, prompts = serve.make_inputs(cfg, LM_REQUESTS, LM_PROMPT, "cuda")
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params_bytes"] = sum(
        w.numel() * w.element_size() for w in
        [params["embed"], params["head"], params["final_ln"]]
        + [w for st in params["groups"].values() for w in st.values()])
    runs = [serve.generate(params, prompts, cfg, LM_TOKENS)
            for _ in range(3)]  # cold, then two warm
    peak = torch.cuda.max_memory_allocated() - held
    # one more warm run under the profiler: the device's busy share and
    # the kernels that take its time
    busy = device_busy(f"{LM_ARCH} generate", lambda: serve.generate(
        params, prompts, cfg, LM_TOKENS), tag="[lm serve]")
    busy.pop("result")
    log("[lm serve] top device kernels of the profiled run: " + ", ".join(
        f"{name[:60]} {sec:.4f} s" for name, sec in busy["top_kernels"]))
    gen = runs[0]
    for r in runs[1:]:
        if not torch.equal(r.tokens, gen.tokens):
            fail("[lm serve] a second run generated other tokens")
    bad = int(((gen.tokens < 0) | (gen.tokens >= cfg.padded_vocab)).sum())
    with torch.inference_mode():
        ref_last = tr.forward(params, prompts, cfg)[:, -1]
        ext = torch.cat([prompts, gen.tokens[:, :1]], dim=1)
        ref_next = tr.forward(params, ext, cfg)[:, -1]
        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        ref32 = tr.forward(params, prompts, f32)[:, -1]
    err_prefill = float((gen.prefill_logits - ref_last).abs().max())
    err_decode = float((gen.decode_logits - ref_next).abs().max())
    err_f32 = float((gen.prefill_logits - ref32).abs().max())
    scale = float(ref_last.abs().max())
    faults = lm_planted_faults(params, prompts, gen.tokens[:, :1], cfg,
                               ref_next)
    B = LM_REQUESTS
    timing = [dict(prefill_s=r.prefill_s, decode_s=r.decode_s,
                   prefill_tok_s=B * LM_PROMPT / r.prefill_s,
                   decode_tok_s=B * (LM_TOKENS - 1) / r.decode_s)
              for r in runs]
    out.update(runs=timing, peak_bytes=peak, busy=busy, bad_ids=bad,
               err_prefill=err_prefill, err_decode=err_decode,
               err_bf16_vs_f32=err_f32, planted_faults=faults,
               max_abs_logit=scale, atol=LM_ATOL,
               sample=gen.tokens[0].tolist())
    w = timing[-1]
    log(f"[lm serve] {LM_ARCH} full width ({cfg.n_layers} layers, d="
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff="
        f"{cfg.d_ff}, padded vocab {cfg.padded_vocab}; "
        f"{out['params_bytes'] / 1e9:.2f} GB f32 params, init "
        f"{out['init_s']:.2f} s): {B} x {LM_PROMPT} prompt + {LM_TOKENS} "
        f"greedy tokens; cold prefill {timing[0]['prefill_s']:.3f} s decode "
        f"{timing[0]['decode_s']:.3f} s; warm prefill {w['prefill_s']:.4f} s "
        f"({w['prefill_tok_s']:.1f} tok/s), decode {w['decode_s']:.4f} s "
        f"({w['decode_tok_s']:.1f} tok/s); peak "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated over what "
        f"earlier phases hold); {header}")
    log(f"[lm serve] |prefill - forward| {err_prefill:.5f}, |decode step 1 - "
        f"forward(prompt + token)| {err_decode:.5f}, |bf16 prefill - f32 "
        f"forward| {err_f32:.5f} (atol {LM_ATOL} each; max |logit| "
        f"{scale:.3f}); ids outside [0, {cfg.padded_vocab}): {bad}; sample "
        f"{out['sample'][:10]}")
    log("[lm serve] planted faults, |decode step 1 - forward(prompt + "
        "token)| (each must exceed the atol): " + ", ".join(
            f"{name} {err:.5f}" for name, err in faults.items()))
    if bad or not max(err_prefill, err_decode, err_f32) <= LM_ATOL:
        fail("[lm serve] the full-width serve run disagrees with forward")
    if not faults["control"] <= LM_ATOL or not all(
            faults[name] > LM_ATOL for name in LM_FAULTS):
        fail(f"[lm serve] LM_ATOL does not tell the planted faults from the "
             f"unfaulted step: {faults}")
    del params, runs, gen, ref_last, ref_next, ref32
    torch.cuda.empty_cache()

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in ("granite-3-8b", "gemma3-27b"):
            small = dataclasses.replace(configs.get(arch).reduced,
                                        dtype=torch.float32)
            cpu_p, cpu_t = serve.make_inputs(small, LM_REQUESTS, LM_PROMPT,
                                             "cpu", seed=1)
            card_p = {k: v.cuda() for k, v in cpu_p.items()
                      if k != "groups"}
            card_p["groups"] = {
                kind: {n: x.cuda() for n, x in st.items()}
                for kind, st in cpu_p["groups"].items()}
            want = serve.generate(cpu_p, cpu_t, small, LM_TOKENS)
            got = serve.generate(card_p, cpu_t.cuda(), small, LM_TOKENS)
            e1 = float((got.prefill_logits.cpu()
                        - want.prefill_logits).abs().max())
            e2 = float((got.decode_logits.cpu()
                        - want.decode_logits).abs().max())
            same = torch.equal(got.tokens.cpu(), want.tokens)
            ok = same and all(
                torch.allclose(a.cpu(), b, **LM_SMALL_TOL) for a, b in (
                    (got.prefill_logits, want.prefill_logits),
                    (got.decode_logits, want.decode_logits)))
            out[f"reduced {arch}"] = dict(err_prefill=e1, err_decode=e2,
                                          tokens_equal=same)
            log(f"[lm serve] reduced {arch} ({small.layer_groups}, window "
                f"{small.local_window}) f32 on the card vs the CPU: "
                f"|prefill| {e1:.2e}, |decode step 1| {e2:.2e}, tokens "
                f"equal: {same}")
            if not ok:
                fail(f"[lm serve] reduced {arch}: the card differs from the "
                     f"CPU beyond {LM_SMALL_TOL}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write every measured number (all cases, the "
                         "main path's stages) to PATH as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import ebbkc, listing, pipeline
    from repro_torch.data.graphs import rmat_graph
    from repro_torch import convert
    from repro_torch.kernels import _build, intersect, ops
    from repro_torch.launch import clique
    from repro_torch.obs import trace

    t_start = time.perf_counter()
    header = gpu_header()
    log(header)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # -- phase 2: build ----------------------------------------------------
    # a library left by an earlier run of these sources is rebuilt, so the
    # build is timed and ptxas reports every instantiation
    (_build.BUILD_DIR / f"libkernels-{_build._digest()}.so").unlink(
        missing_ok=True)
    t0 = time.perf_counter()
    nvcc_log = io.StringIO()
    with contextlib.redirect_stdout(nvcc_log):
        _build.lib(verbose=True)
    build_s = time.perf_counter() - t0
    log(nvcc_log.getvalue().rstrip())
    ptxas = ptxas_report(nvcc_log.getvalue())
    for name, info in ptxas.items():
        log(f"[ptxas] {name}: {info['registers']} registers, "
            f"{info['stack']} B stack frame, {info['spill_stores']} B spill "
            f"stores, {info['spill_loads']} B spill loads")
    log(f"[build] nvcc sm_90a, one process per source, all started "
        f"together: {build_s:.2f} s for {len(_build._sources())} sources")

    # -- phase 3: kernel vs plain on seeded tiles --------------------------
    rows, errs = [], {}
    floor = launch_floor_ms()
    log(f"[timer] device_ms: {GRAPH_CALLS} calls captured in one CUDA graph, "
        f"replayed between two events, / {GRAPH_CALLS}, median of 5 replays; "
        f"call_ms: median of single-call event timings; launch floor "
        f"(device_ms of a one-element zero_()) {floor:.5f} ms")
    log("[kernels] seeded tiles, 64 a case")
    density = {32: 0.3, 64: 0.2, 128: 0.1, 256: 0.06}
    for T in BINS:
        A, cand = (torch.from_numpy(x).view(torch.int32).cuda()
                   for x in seeded_tiles(T, 64, T, density[T]))
        for l in (3, 4, 5, 6):
            kernel_cases(rows, errs, A, cand, l, "seeded")
    log("[list] seeded tiles, 64 a case, capacities 1, below the largest "
        "count, capacity_for(counts)")
    for T in BINS:
        A, cand = (torch.from_numpy(x).view(torch.int32).cuda()
                   for x in seeded_tiles(T + 1, 64, T, density[T]))
        for l in (1, 2, 3, 4, 5):
            counts = ops.count_tiles(A, cand, l).cpu().numpy()
            top = int(counts.max())
            for cap in sorted({1, max(1, top - 1)}):
                list_case(rows, errs, A, cand, l, cap, "seeded")
            list_case(rows, errs, A, cand, l, listing.capacity_for(counts),
                      "seeded", reps=10)
    log("[edge] seeded tiles and pairs")
    for T in BINS:
        A, _ = (torch.from_numpy(x).view(torch.int32).cuda()
                for x in seeded_tiles(T + 2, 256, T, density[T]))
        rng = np.random.default_rng(T)
        a = rng.integers(0, T - 1, 256)
        b = a + 1 + rng.integers(0, T - 1 - a)
        pairs = torch.from_numpy(np.stack([a, b], 1).astype(np.int32)).cuda()
        edge_case(rows, errs, A, pairs, "seeded")
    torch.cuda.synchronize()
    log(f"[kernels] seeded cases pass: {time.perf_counter() - t_start:.1f} s "
        "since start")

    # -- phase 4: the main path at full size -------------------------------
    g = rmat_graph(RMAT_SCALE, edge_factor=RMAT_EDGE_FACTOR, seed=RMAT_SEED)
    log(f"[main] rmat_graph({RMAT_SCALE}, edge_factor={RMAT_EDGE_FACTOR}, "
        f"seed={RMAT_SEED}): n={g.n} m={g.m}")
    pipeline.clear_plan_cache()
    ops.reset_counts()
    main_runs = {}
    queries = []  # (name, Stats) of every query, for [resilience]
    for k in (5, 7):
        # with stage_times given, the engine brackets every count_tiles
        # call with CUDA events and sums the spans per bin (host enqueue
        # included: no device time)
        stage = {}
        t0 = time.perf_counter()
        res = ebbkc.count(g, k, engine_kwargs={"stage_times": stage})
        wall = time.perf_counter() - t0
        st = res.stats
        queries.append((f"[main] count k={k}", st))
        per_T = {T: 1e3 * stage.get(f"count_tiles_T{T}", 0.0) for T in BINS}
        main_runs[k] = dict(count=res.count, wall_s=wall, tiles=res.tiles,
                            spilled=st.spilled_tiles,
                            plan_build_s=st.plan_build_s,
                            plan_cache_hit=st.plan_cache_hit,
                            frontend_s=st.frontend_s,
                            device_s=stage.get("device", 0.0),
                            pack_workers=st.pack_workers,
                            queue_occupancy=st.pack_queue_occupancy,
                            count_tiles_ms_per_T=per_T,
                            count_tiles_ms=sum(per_T.values()))
        log(f"[main] k={k}: count={res.count} wall={wall:.2f} s "
            f"plan_build={st.plan_build_s:.2f} s "
            f"(cache_hit={st.plan_cache_hit}) frontend={st.frontend_s:.2f} s "
            f"(worker-s, {st.pack_workers} workers, "
            f"queue_occ={st.pack_queue_occupancy:.2f}) "
            f"device={stage.get('device', 0.0):.2f} s tiles={res.tiles} "
            f"tiles/s={res.tiles / max(wall, 1e-9):.0f} "
            f"spilled={st.spilled_tiles}")
        log(f"[main] k={k}: count_tiles span (host enqueue included) "
            f"{main_runs[k]['count_tiles_ms']:.1f} ms "
            f"({100 * main_runs[k]['count_tiles_ms'] / 1e3 / wall:.2f}% of "
            f"the query's wall time), per bin "
            + ", ".join(f"T={T}: {v:.1f} ms" for T, v in per_T.items()))
        if res.count != EXPECTED[k]:
            fail(f"k={k} counted {res.count}, expected {EXPECTED[k]}")
    launches = ops.launch_counts()
    plain = ops.plain_counts()
    log(f"[main] launches {launches} plain-version calls {plain}")
    if not (launches["triangle_count_tiles"] and
            launches["clique_count_tiles"]):
        fail(f"a kernel of the counting path never launched: {launches}")
    if sum(plain.values()):
        fail(f"a plain version ran on the main path: {plain}")
    plan = pipeline.cached_plan(g, "hybrid")
    expect_launches = dict.fromkeys(launches, 0)
    for k, name in ((5, "triangle_count_tiles"), (7, "clique_count_tiles")):
        batches, tiles = batches_per_bin(plan, k)
        main_runs[k]["batches_per_T"] = batches
        main_runs[k]["tiles_per_T"] = tiles
        expect_launches[name] += sum(batches.values())
        log(f"[main] k={k} tiles per bin {tiles}, batches per bin {batches}")
    if launches != expect_launches:
        fail(f"launches {launches} != one per packed batch {expect_launches}")
    count_launches = launches

    log(f"[time] [main] done at {time.perf_counter() - t_start:.1f} s")
    # -- kernel vs plain on main-path batches ------------------------------
    log("[kernels] main-path batches (an even sample of each bin, and the "
        "bin's real last batch)")
    real = {}
    for k, l in ((5, 3), (7, 5)):
        for T in BINS:
            for which, A, cand, live in main_path_batches(plan, k, T):
                tag = f"main k={k} {which}"
                for r in kernel_cases(rows, errs, A, cand, l, tag, reps=50):
                    real[(r["kernel"], T, l, which)] = r
                log(f"    ({live} of {A.shape[0]} tiles reach the kernel)")
    # the branch pass runs one group of W = T/32 lanes for each of the T * B
    # first-level branches, 8192 / T groups a block of 256 threads
    if not any((r["T"] * r["B"]) % (8192 // r["T"])
               for r in real.values() if r["kernel"] == "dfs"):
        fail("no compared main-path batch leaves the branch pass's last "
             "block partly empty")

    # -- a skewed batch: one heavy tile among empty ones ---------------------
    log("[kernels] skewed batches: the heaviest tile of a main-path sample "
        "among 255 tiles with an empty cand (k=5 for the triangle kernel, "
        "k=7 for the DFS kernels)")
    from repro_torch.kernels import clique_count, triangle_mm
    for which, A, cand, _ in main_path_batches(plan, 5, 32):
        if which == "sample":
            A2, c2 = skewed_batch(A, cand,
                                  triangle_mm.triangle_count_tiles(A, cand))
            r = kernel_cases(rows, errs, A2, c2, 3, "skewed k=5", reps=20)[0]
            real[("triangle", 32, 3, "skewed")] = r
    for T in (64, 128):
        for which, A, cand, _ in main_path_batches(plan, 7, T):
            if which != "sample":
                continue
            counts = clique_count.clique_count_tiles(A, cand, 5)
            A2, c2 = skewed_batch(A, cand, counts)
            r = kernel_cases(rows, errs, A2, c2, 5, "skewed k=7", reps=20)[0]
            real[("dfs", T, 5, "skewed")] = r
            n2 = clique_count.clique_count_tiles(A2, c2, 4).cpu().numpy()
            cap = listing.capacity_for(n2)
            for c in sorted({1, max(1, cap // 3), cap}):
                list_case(rows, errs, A2, c2, 4, c, "skewed l=4",
                          reps=20 if c == cap else 0)

    # -- the listing path at full size ---------------------------------------
    lg = rmat_graph(LIST_SCALE, edge_factor=RMAT_EDGE_FACTOR, seed=RMAT_SEED)
    log(f"[list main] rmat_graph({LIST_SCALE}, edge_factor="
        f"{RMAT_EDGE_FACTOR}, seed={RMAT_SEED}): n={lg.n} m={lg.m}")
    sg = rmat_graph(LIST6_SCALE, edge_factor=RMAT_EDGE_FACTOR,
                    seed=RMAT_SEED)
    list_runs, list_plain = {}, {}
    for run, k, graph in (("k=5 cold", 5, lg), ("k=5 warm", 5, lg),
                          ("k=6 rmat11", 6, sg)):
        if run == "k=5 cold":
            pipeline.clear_plan_cache()
        digest, nrows = hashlib.sha256(), [0]

        def hash_rows(chunk):
            digest.update(np.ascontiguousarray(chunk, dtype="<i8"))
            nrows[0] += chunk.shape[0]
        stage = {}
        if k == 6:  # traced; [obs] reads the trace
            trace.configure(enabled=True)
            trace.reset()
        ops.reset_counts()
        t0 = time.perf_counter()
        res = listing.stream_cliques(graph, k,
                                     listing.CallbackSink(hash_rows),
                                     stage_times=stage)
        wall = time.perf_counter() - t0
        if k == 6:
            trace.configure(enabled=False)
            list_trace = (trace.chrome_trace(), trace.dropped(), wall,
                          res.stats)
            trace.reset()
        delta = ops.launch_counts()
        list_plain[run] = ops.plain_counts()
        st = res.stats
        queries.append((f"[list main] {run}", st))
        batches, tiles = batches_per_bin(
            pipeline.cached_plan(graph, "hybrid"), k)
        list_runs[run] = dict(
            k=k, rows=nrows[0], sha256=digest.hexdigest(), wall_s=wall,
            rows_per_s=nrows[0] / wall, tiles=res.tiles,
            batches=sum(batches.values()), tiles_per_T=tiles,
            overflowed=st.overflowed_tiles, spilled=st.spilled_tiles,
            plan_build_s=st.plan_build_s, plan_cache_hit=st.plan_cache_hit,
            frontend_s=st.frontend_s, pack_workers=st.pack_workers,
            stages=stage, launches=delta)
        log(f"[list main] {run}: {nrows[0]} rows in {wall:.2f} s "
            f"({nrows[0] / wall:.0f} rows/s), tiles={res.tiles} "
            f"batches={sum(batches.values())} overflowed="
            f"{st.overflowed_tiles} spilled={st.spilled_tiles} plan_build="
            f"{st.plan_build_s:.2f} s (cache_hit={st.plan_cache_hit}) "
            f"frontend={st.frontend_s:.2f} s (worker-s)")
        log(f"[list main] {run}: device stage (H2D, count pass, list "
            f"kernel, D2H) {stage.get('device', 0.0):.2f} s, D2H "
            f"{stage.get('d2h_bytes', 0)} B, decode "
            f"{stage.get('decode', 0.0):.2f} s of which host relist of "
            f"overflowed tiles {stage.get('relist', 0.0):.2f} s, sink "
            f"{stage.get('emit', 0.0):.2f} s; launches {delta}")
        want_rows, want_sha = EXPECTED_LIST[k] if k == 5 else EXPECTED_LIST6
        if (nrows[0], digest.hexdigest()) != (want_rows, want_sha):
            fail(f"listing k={k} ({run}) gave {nrows[0]} rows, sha256 "
                 f"{digest.hexdigest()}; expected {want_rows}, {want_sha}")
        count_kernel = ("triangle_count_tiles" if k == 5
                        else "clique_count_tiles")
        if not (delta["clique_list_tiles"] == delta[count_kernel]
                == sum(batches.values()) > 0):
            fail(f"listing k={k}: launches {delta} != one list and one "
                 f"count launch per packed batch ({sum(batches.values())})")
    if list_runs["k=6 rmat11"]["overflowed"] == 0:
        fail("listing k=6 overflowed no tile: the host relist never ran")
    # the kernels line reports the k=6 run, whose batches give its row
    list_launches = list_runs["k=6 rmat11"]["launches"]
    log(f"[list main] plain-version calls per run {list_plain}")
    if any(sum(plain.values()) for plain in list_plain.values()):
        fail(f"a plain version ran on the listing path: {list_plain}")

    log(f"[time] [list main] done at {time.perf_counter() - t_start:.1f} s")
    # -- the edge-candidate path: one edge of every tile of the k=5 batches
    ops.reset_counts()
    t0 = time.perf_counter()
    nb, checked = 0, 0
    stream = pipeline.stream_batches(pipeline.cached_plan(lg, "hybrid"), 5,
                                     pack_workers=0)
    timed_input = None
    for batch in stream:
        if not isinstance(batch, pipeline.TileBatch):
            continue  # a spilled tile: no packed batch to take an edge of
        A, _ = convert.batch_to_torch(batch.A, batch.cand, "cuda")
        pairs = first_edges(A)
        cand_e, n_e = ops.edge_candidates(A, pairs)
        nb += 1
        if timed_input is None and batch.T == 32 and batch.B == 256:
            timed_input = (A, pairs)
        if nb % 16 == 1:  # held against the plain version (not counted)
            want = intersect.edge_candidates_torch(A, pairs)
            if not (torch.equal(cand_e, want[0]) and torch.equal(n_e,
                                                                 want[1])):
                fail(f"edge_candidates kernel != plain on batch {nb}")
            checked += 1
    edge_launches = ops.launch_counts()
    log(f"[edge main] {nb} batches in {time.perf_counter() - t0:.2f} s, "
        f"{checked} held against the plain version; launches "
        f"{edge_launches}")
    if edge_launches["edge_candidates"] != nb or nb == 0:
        fail(f"edge_candidates launched {edge_launches['edge_candidates']} "
             f"times on {nb} batches")
    if any(v for n, v in edge_launches.items() if n != "edge_candidates"):
        fail(f"the edge-candidate path launched other kernels: "
             f"{edge_launches}")
    edge_rep = edge_case(rows, errs, *timed_input, "main k=5 first",
                         reps=50)

    # -- kernel vs plain on the listing path's own batches ------------------
    log("[list] main-path batches (an even sample of each bin, and the "
        "bin's real last batch), capacity from the count pass")
    lplan = pipeline.cached_plan(lg, "hybrid")
    for k in (5, 6):
        for T in BINS:
            for which, A, cand, _ in main_path_batches(lplan, k, T,
                                                       zero_2plex=False):
                counts = ops.count_tiles(A, cand, k - 2).cpu().numpy()
                cap = listing.capacity_for(counts)
                tag = f"main k={k} {which}"
                real[("list", T, k - 2, which)] = list_case(
                    rows, errs, A, cand, k - 2, cap, tag, reps=20)

    # -- the later phases' graph ---------------------------------------------
    mg = rmat_graph(MID_SCALE, edge_factor=RMAT_EDGE_FACTOR, seed=RMAT_SEED)
    t0 = time.perf_counter()
    mplan = pipeline.cached_plan(mg, "hybrid")
    mid_plan_s = time.perf_counter() - t0
    log(f"[mid] rmat_graph({MID_SCALE}, edge_factor={RMAT_EDGE_FACTOR}, "
        f"seed={RMAT_SEED}): n={mg.n} m={mg.m}, plan built in "
        f"{mid_plan_s:.2f} s; the queries of [dispatch], [obs], [widths], "
        f"[delta] and [serve] run on it")

    # -- the multi-lane dispatcher ------------------------------------------
    dispatch_runs = dispatch_phase(mg, mplan, plan, lg, lplan, list_runs,
                                   queries)

    log(f"[time] [dispatch] done at {time.perf_counter() - t_start:.1f} s")
    # -- phase 5: the launcher ---------------------------------------------
    ops.reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = clique.main(["--graph", "rmat:12", "--k", "6", "--verify"])
    out = buf.getvalue()
    log("[cli] " + " | ".join(out.strip().splitlines()))
    if rc != 0 or "match=True" not in out:
        fail("launcher --verify did not match the host engine")
    cli_outputs = [out]
    if ops.launch_counts()["clique_count_tiles"] == 0:
        fail("launcher at k=6 never launched the DFS kernel")
    log(f"[cli] rmat:12 k=6 --verify: {time.perf_counter() - t0:.1f} s")
    for spec, k in (("rmat:10", 5), ("er:400,0.06", 4)):
        ops.reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = clique.main(["--graph", spec, "--k", str(k), "--list",
                              "--verify"])
        out = buf.getvalue()
        log("[cli] " + " | ".join(out.strip().splitlines()))
        cli_outputs.append(out)
        if rc != 0 or "match=True" not in out:
            fail(f"launcher --list --verify on {spec} at k={k} did not "
                 "match the host engine")
        listed = re.search(r"listed (\d+) cliques", out)
        if listed is None or int(listed.group(1)) == 0:
            fail(f"launcher --list on {spec} at k={k} listed no clique")
        if ops.launch_counts()["clique_list_tiles"] == 0:
            fail(f"launcher --list on {spec} at k={k} never launched the "
                 "list kernel")
        log(f"[cli] {spec} k={k} --list --verify: "
            f"{time.perf_counter() - t0:.1f} s")
    ops.reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = clique.main(["--graph", "rmat:10", "--k", "5", "--devices", "1",
                          "--offline-lpt", "--verify"])
    out = buf.getvalue()
    log("[cli] " + " | ".join(out.strip().splitlines()))
    cli_outputs.append(out)
    if rc != 0 or "match=True" not in out or "balance" not in out:
        fail("launcher --devices 1 --offline-lpt --verify did not match the "
             "host engine")
    if ops.launch_counts()["triangle_count_tiles"] == 0:
        fail("launcher --offline-lpt at k=5 never launched the triangle "
             "kernel")
    log(f"[cli] rmat:10 k=5 --devices 1 --offline-lpt --verify: "
        f"{time.perf_counter() - t0:.1f} s")

    log(f"[time] [cli] done at {time.perf_counter() - t_start:.1f} s")
    # -- observability and resilience ----------------------------------------
    obs_runs = obs_phase(mg, mplan, lg, lplan, dispatch_runs, list_trace,
                         queries)
    log(f"[time] [obs] done at {time.perf_counter() - t_start:.1f} s")
    resilience_runs = resilience_phase(lg, lplan, queries, cli_outputs)
    log(f"[time] [resilience] done at {time.perf_counter() - t_start:.1f} s")

    # -- the new tile widths, plan persistence, the tuner --------------------
    widths_runs = widths_phase(plan, mg, mplan, lplan, rows, errs, ptxas,
                               dispatch_runs, queries)
    log(f"[time] [widths] done at {time.perf_counter() - t_start:.1f} s")
    persist_runs = persist_phase(g, plan, lg, lplan, main_runs)
    log(f"[time] [persist] done at {time.perf_counter() - t_start:.1f} s")
    tune_runs = tune_phase(g, main_runs)
    log(f"[time] [tune] done at {time.perf_counter() - t_start:.1f} s")

    # -- tiles wider than 256, dynamic graphs, the serving tier --------------
    wide_runs = wide_phase(rows, errs, ptxas)
    log(f"[time] [wide] done at {time.perf_counter() - t_start:.1f} s")
    delta_runs = delta_phase(mg, mplan, lg, lplan)
    log(f"[time] [delta] done at {time.perf_counter() - t_start:.1f} s")
    serve_runs = serve_phase(mg, mplan, lg, lplan, delta_runs, list_runs)
    log(f"[time] [serve] done at {time.perf_counter() - t_start:.1f} s")
    del delta_runs["first_batch"]  # arrays, handed to [serve]

    # -- the paper baseline, the on-device truss, the LM serving path -------
    baseline_runs = baseline_phase()
    log(f"[time] [baseline] done at {time.perf_counter() - t_start:.1f} s")
    truss_runs = truss_phase(lg)
    log(f"[time] [truss] done at {time.perf_counter() - t_start:.1f} s")
    lm_runs = lm_phase(header)
    log(f"[time] [lm serve] done at {time.perf_counter() - t_start:.1f} s")

    # -- summary -----------------------------------------------------------
    # each kernel's row: the bin with most launches on its path; launches
    # are those of its own path's run (counting, listing, edge candidates)
    rep = {"triangle_count_tiles": (real[("triangle", 32, 3, "sample")],
                                    "triangle", count_launches),
           "clique_count_tiles": (real[("dfs", 32, 5, "sample")], "dfs",
                                  count_launches),
           "clique_list_tiles": (real[("list", 32, 4, "sample")], "list",
                                 list_launches),
           "edge_candidates": (edge_rep, "edge", edge_launches)}
    meta = {
        "triangle_count_tiles": (
            "src/repro_torch/kernels/csrc/triangle_count.cu",
            "src/repro/kernels/triangle_mm.py:47"),
        "clique_count_tiles": (
            "src/repro_torch/kernels/csrc/clique_count.cu",
            "src/repro/kernels/clique_count.py:114"),
        "clique_list_tiles": (
            "src/repro_torch/kernels/csrc/clique_list.cu",
            "src/repro/kernels/clique_list.py:165"),
        "edge_candidates": (
            "src/repro_torch/kernels/csrc/edge_candidates.cu",
            "src/repro/kernels/intersect.py:31"),
    }
    kernels = []
    for name, (r, short, path_launches) in rep.items():
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": path_launches[name],
            "max_abs_err": errs[short], "ms": r["ms"],
            "device_ms": r["device_ms"], "call_ms": r["call_ms"],
            "launch_floor_ms": r["launch_floor_ms"], "timer": "cuda_graph",
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    if args.json:
        path = Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(
            {"gpu": header, "torch": torch.__version__,
             "cuda": torch.version.cuda, "build_s": build_s,
             "cases": rows,
             "main": {str(k): v for k, v in main_runs.items()},
             "list_main": list_runs, "dispatch": dispatch_runs,
             "obs": obs_runs, "resilience": resilience_runs,
             "widths": {**widths_runs, "times": {
                 tag: {f"{kernel} l={l}": v for (kernel, l), v in t.items()}
                 for tag, t in widths_runs["times"].items()}},
             "persist": persist_runs, "tune": tune_runs,
             "wide": wide_runs, "delta": delta_runs, "serve": serve_runs,
             "baseline": baseline_runs, "truss": truss_runs, "lm": lm_runs,
             "launches": count_launches,
             "list_launches": list_launches,
             "edge_launches": edge_launches, "kernels": kernels,
             "ptxas": ptxas,
             "seconds": time.perf_counter() - t_start}, indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(header)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
