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
  warm plan; l = 3 triangle emit) and k = 6 (l = 4 DFS emit, with
  overflowed tiles relisted on the host);
* edge-branch candidates -- ``repro_torch.kernels.ops.edge_candidates``
  -- on every packed batch of the k = 5 listing, one edge of each tile;
* multi-lane dispatch (``[dispatch]``, ``repro_torch.runtime.dispatch``)
  on the warm plans: counting k = 7 on the scale-15 graph on one lane and
  on two lanes (two CUDA streams) of the card, k = 5 on the scale-12 graph
  split by rows over two lanes (``mesh=``) and k = 6 by offline LPT
  (``dispatch_scheduled``) over two lanes, and listing k = 5 on the
  scale-12 graph through the ``ListDispatcher`` on one lane (exact sizing)
  and on two lanes (speculative capacity), against the same counts and
  digests;

then runs the command-line launcher with ``--verify``, counting (through
the dispatcher, its default) and listing, and finally:

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
  main-path batches of a ``mult32`` stream, each against its plain
  version and timed beside the same tiles packed at the next power of
  two, and the k = 7 count on the scale-15 graph under the ``mult32``
  ladder;
* plan persistence (``[persist]``): ``save_plan`` of the scale-15 plan,
  a fresh launcher process that loads it with ``--plan-cache`` and counts
  k = 5, and a corrupt scale-12 store (``plan.load=1.0:corrupt``)
  quarantined and rebuilt;
* the tuner (``[tune]``): ``tune_geometry`` for counting (l = 5) and
  listing (l = 3) persisted to a tune cache, a fresh launcher process
  that counts k = 7 with ``--tune-cache`` on the tuned geometry without a
  search, and the ``autotune`` backend's kernel-vs-plain measurement,
  whose winner the card reports and does not obey.

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


def timings(launch, reps: int) -> dict:
    """The three times of a row: ``device_ms`` (CUDA graph, host out),
    ``call_ms`` (one call, host dispatch in) and the run's launch floor;
    ``ms`` is the device time."""
    dev = device_ms(launch)
    return {"ms": dev, "device_ms": dev, "call_ms": call_ms(launch, reps),
            "launch_floor_ms": launch_floor_ms()}


def kernel_cases(rows, errs, A, cand, l, tag, reps=20):
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
    items = clique_count.item_list(B, T, A.device)
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
            lib_ms = device_ms(lib_fn)
            # the wrapper as the engine calls it: its launch and any torch
            # op that follows it
            extra["wrapper_device_ms"] = device_ms(
                lambda: triangle_mm.triangle_count_tiles(A, cand))
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
                    items.data_ptr(), out[B:].data_ptr(), B, T, l,
                    stream_ptr()), "clique_count_tiles")
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
            item_case(rows, errs, A, cand, l, tag, want, reps)
        # times are taken with the batch resident in L2, as the engine finds
        # it right after its H2D copy
        t = timings(launch, reps)
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


def item_case(rows, errs, A, cand, l, tag, tile_counts, reps=20):
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
    items = clique_count.item_list(B, T, A.device)
    counters = torch.empty(2, dtype=torch.int32, device=A.device)

    def launch():
        per_v.zero_()
        counters.zero_()
        check_rc(so.clique_count_items_launch(
            A.data_ptr(), cand.data_ptr(), per_v.data_ptr(), items.data_ptr(),
            counters.data_ptr(), B, T, l, stream_ptr()), "clique_count_items")
    t = timings(launch, reps)
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


def list_case(rows, errs, A, cand, l, cap, tag, reps=0):
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
    item_case(rows, errs, A, cand, l, tag, count, reps)
    so = _build.lib()
    buf = torch.empty((B, cap, l), dtype=torch.int32, device=A.device)
    cnt = torch.empty(B, dtype=torch.int32, device=A.device)
    ovf = torch.empty(B, dtype=torch.int32, device=A.device)
    per_x = torch.empty((B, T, T), dtype=torch.int64, device=A.device)
    items = clique_count.item_list(B, T, A.device)
    counters = torch.empty(3, dtype=torch.int32, device=A.device)

    def launch():
        # the wrapper's work: zero the per-item counts and the counters,
        # then the four device passes (branch, count, scan, emit)
        per_x.zero_()
        counters.zero_()
        check_rc(so.clique_list_tiles_launch(
            A.data_ptr(), cand.data_ptr(), buf.data_ptr(), cnt.data_ptr(),
            ovf.data_ptr(), per_x.data_ptr(), items.data_ptr(),
            counters.data_ptr(), B, T, l, cap, stream_ptr()),
            "clique_list_tiles")
    # with the batch resident in L2, as the engine finds it after its H2D
    t = timings(launch, reps)
    zero_ms = device_ms(buf.zero_)
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


def edge_case(rows, errs, A, pairs, tag, reps=20):
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
    t = timings(launch, reps)
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
                          r"edge_candidates_kernel)"
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


def dispatch_phase(g, plan, lg, lplan, main_runs, list_runs,
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

    def count(name, graph, graph_plan, k, lanes, inline_s):
        stage = {}
        ops.reset_counts()
        t0 = time.perf_counter()
        res = ebbkc.count(graph, k, plan=graph_plan, engine_kwargs=dict(
            devices=lanes, stage_times=stage))
        wall = time.perf_counter() - t0
        record(name, [kernel_of(k)], wall, res.stats, stage, inline_s,
               count=res.count)
        return res.count

    def kernel_of(k):
        return "triangle_count_tiles" if k == 5 else "clique_count_tiles"

    for lanes, tag in ((one, "1 lane"), (two, "2 lanes")):
        got = count(f"count k=7 rmat15 {tag}", g, plan, 7, lanes,
                    main_runs[7]["wall_s"])
        if got != EXPECTED[7]:
            fail(f"dispatch k=7 on {tag} counted {got}, expected "
                 f"{EXPECTED[7]}")

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
    runs["device_busy"] = device_busy(
        "count k=7 rmat15 2 lanes",
        lambda: ebbkc.count(g, 7, plan=plan,
                            engine_kwargs=dict(devices=two)).count)
    if runs["device_busy"]["result"] != EXPECTED[7]:
        fail("dispatch k=7 under the profiler counted "
             f"{runs['device_busy']['result']}, expected {EXPECTED[7]}")
    return runs


def device_busy(name: str, query) -> dict:
    """The device's busy share of one dispatched query: the query runs
    once more under ``torch.profiler`` (CUDA activity only), and the union
    of its device intervals (kernels, copies, fills, on every stream) is
    set against the query's wall time.  The sum of the intervals over
    their union says how much the lanes' work overlapped, and the DFS
    count kernel's share of them (its branch and item passes) is the
    query's count-kernel device time."""
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
               count_kernel_s=sum(dfs) / 1e6)
    if spans:
        share = out["busy_share"]
        log(f"[dispatch] device busy, {name} under the profiler: wall "
            f"{wall:.2f} s, {len(spans)} device events, "
            f"busy {out['busy_s']:.3f} s ({100 * share:.2f}% of wall; idle "
            f"{100 - 100 * share:.2f}%), summed {out['summed_s']:.3f} s "
            f"({out['summed_s'] / out['busy_s']:.2f}x the busy time); DFS "
            f"count kernel {len(dfs)} events, {out['count_kernel_s']:.4f} s")
    else:
        log("[dispatch] device busy share not measured: the profiler saw "
            "no device events")
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


def obs_phase(g, plan, lg, lplan, dispatch_runs, list_trace,
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
        res = ebbkc.count(g, 7, plan=plan,
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
    untraced = dispatch_runs["count k=7 rmat15 1 lane"]["wall_s"]
    busy = dispatch_runs["device_busy"]
    out["count_k7"] = dict(
        count=res.count, wall_s=wall, untraced_wall_s=untraced,
        dropped=dropped, events=len(doc["traceEvents"]),
        stage_durations=stages, launches=launches, kernel_records=recs,
        count_kernel_device_s=busy["count_kernel_s"],
        count_kernel_events=busy["count_kernel_events"])
    log(f"[obs] count k=7 rmat15 1 lane, traced: {res.count}, wall "
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
    if res.count != EXPECTED[7]:
        fail(f"obs: traced k=7 counted {res.count}, expected {EXPECTED[7]}")
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
    log(f"[obs] list k=6 rmat12 inline ([list main], traced): wall "
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
    if values.get("repro_engine_emitted_cliques_total") != EXPECTED_LIST[6][0]:
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


def widths_phase(g, plan, lplan, rows, errs, ptxas, main_runs,
                 queries) -> dict:
    """``[widths]``: the four kernels at T = 96, 160, 192 and 224 -- their
    ptxas report, seeded tiles, and the main-path batches of a ``mult32``
    stream (counting on rmat15, listing on rmat12) -- each against its
    plain version and timed beside the same tiles at the next power of
    two; then the k = 7 count on rmat15 under the mult32 ladder, exact,
    with its wall beside the pow2 wall of ``[main]``."""
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
            for which, A, cand, live in main_path_batches(plan, k, T,
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
    # pow2, mult32, pow2 in turns on the warm plan: the host's spread
    # between queries of one call is what the two ladders are held within
    walls = {"pow2": [], "mult32": []}
    for ladder in ("pow2", "mult32", "pow2"):
        bins = MULT32 if ladder == "mult32" else BINS
        ops.reset_counts()
        t0 = time.perf_counter()
        res = ebbkc.count(g, 7, engine_kwargs={"bins": bins})
        wall = time.perf_counter() - t0
        st = res.stats
        queries.append((f"[widths] count k=7 {ladder}", st))
        launches, plain = ops.launch_counts(), ops.plain_counts()
        walls[ladder].append(wall)
        log(f"[widths] k=7 rmat15 under {ladder}: count={res.count} wall="
            f"{wall:.2f} s frontend={st.frontend_s:.2f} worker-s "
            f"({st.pack_workers} workers, queue_occ="
            f"{st.pack_queue_occupancy:.2f}) tiles={res.tiles} launches "
            f"{launches}")
        if res.count != EXPECTED[7]:
            fail(f"k=7 under {ladder} counted {res.count}, expected "
                 f"{EXPECTED[7]}")
        if not launches["clique_count_tiles"] or sum(plain.values()):
            fail(f"k=7 under {ladder}: launches {launches}, plain calls "
                 f"{plain}")
    out["k7"] = dict(count=res.count, walls_s=walls,
                     main_pow2_wall_s=main_runs[7]["wall_s"])
    log(f"[widths] k=7 rmat15 walls: mult32 {walls['mult32'][0]:.2f} s, "
        f"pow2 before and after {walls['pow2'][0]:.2f} / "
        f"{walls['pow2'][1]:.2f} s ([main], with stage timing: "
        f"{main_runs[7]['wall_s']:.2f} s)")
    return out


def run_cli(argv, env_extra=None, timeout=900):
    """``python -m repro_torch.launch.clique ARGV`` in a fresh process
    (``src/`` on its path, no tune cache or fault plan from this
    environment unless ``env_extra`` sets one); returns its stdout."""
    import os
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_TORCH_TUNE_CACHE", "REPRO_TORCH_FAULT_PLAN")}
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(env_extra or {})
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
    """``[persist]``: ``save_plan`` of the warm rmat15 plan (seconds,
    bytes); a fresh process counting k = 5 on rmat15 with ``--plan-cache``
    loads it from disk (exact, ``warm``); and on rmat12 a store read under
    ``plan.load=1.0:corrupt`` (through REPRO_TORCH_FAULT_PLAN) is
    quarantined and rebuilt, and the count stays exact."""
    import shutil
    from repro_torch.core import pipeline
    out = {}
    base = ROOT / "build" / "smoke_plans"
    shutil.rmtree(base, ignore_errors=True)
    key = pipeline.plan_key(g, "hybrid")
    t0 = time.perf_counter()
    pipeline.save_plan(plan, str(base / key))
    out["save_s"] = time.perf_counter() - t0
    out["bytes"] = dir_bytes(base / key)
    log(f"[persist] save_plan rmat15: {out['save_s']:.2f} s, "
        f"{out['bytes']} B on disk")
    text, wall = run_cli(["--graph", f"rmat:{RMAT_SCALE},{RMAT_EDGE_FACTOR}",
                          "--k", "5", "--plan-cache", str(base)])
    m = re.search(r"plan cache \[.*\]: warm \(decomposition skipped\), "
                  r"([0-9.]+)s", text)
    if m is None:
        fail("the second process did not load the rmat15 plan from disk")
    out["load_s"] = float(m.group(1))
    out["process_wall_s"] = wall
    out["build_s_this_run"] = main_runs[5]["plan_build_s"]
    count = cli_count(text, 5)
    log(f"[persist] fresh process, --plan-cache: count={count}, plan loaded "
        f"in {out['load_s']:.2f} s against a {out['build_s_this_run']:.2f} s "
        f"build in [main] (this run); process wall {wall:.1f} s")
    if count != EXPECTED[5]:
        fail(f"--plan-cache k=5 counted {count}, expected {EXPECTED[5]}")
    lkey = pipeline.plan_key(lg, "hybrid")
    pipeline.save_plan(lplan, str(base / lkey))
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
    (``tune_hit=True``, no search) and counts k = 7 on rmat15 exactly;
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
    tune.configure(str(base))
    try:
        t0 = time.perf_counter()
        _build.build()
        out["cache_build_s"] = time.perf_counter() - t0
        log(f"[tune] kernel library built into the tune cache "
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
            ["--graph", f"rmat:{RMAT_SCALE},{RMAT_EDGE_FACTOR}", "--k", "7",
             "--tune-cache", str(base), "--plan-cache", str(plans)])
        count = cli_count(text, 7)
        ran = re.search(r"geometry: bins=([0-9,]+)", text)
        out["cli"] = dict(count=count, wall_s=wall,
                          bins=ran.group(1) if ran else None,
                          tune_hit="tune_hit=True" in text)
        log(f"[tune] fresh process, --tune-cache: count={count}, bins "
            f"{out['cli']['bins']} (record: {want_bins}), tune_hit="
            f"{out['cli']['tune_hit']}, {wall:.1f} s")
        if (count != EXPECTED[7] or not out["cli"]["tune_hit"]
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
    list_runs, list_plain = {}, {}
    for run, k in (("k=5 cold", 5), ("k=5 warm", 5), ("k=6 warm", 6)):
        if run == "k=5 cold":
            pipeline.clear_plan_cache()
        digest, nrows = hashlib.sha256(), [0]

        def hash_rows(chunk):
            digest.update(np.ascontiguousarray(chunk, dtype="<i8"))
            nrows[0] += chunk.shape[0]
        stage = {}
        if run == "k=6 warm":  # traced; [obs] reads the trace
            trace.configure(enabled=True)
            trace.reset()
        ops.reset_counts()
        t0 = time.perf_counter()
        res = listing.stream_cliques(lg, k, listing.CallbackSink(hash_rows),
                                     stage_times=stage)
        wall = time.perf_counter() - t0
        if run == "k=6 warm":
            trace.configure(enabled=False)
            list_trace = (trace.chrome_trace(), trace.dropped(), wall,
                          res.stats)
            trace.reset()
        delta = ops.launch_counts()
        list_plain[run] = ops.plain_counts()
        st = res.stats
        queries.append((f"[list main] {run}", st))
        batches, tiles = batches_per_bin(pipeline.cached_plan(lg, "hybrid"),
                                         k)
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
        want_rows, want_sha = EXPECTED_LIST[k]
        if (nrows[0], digest.hexdigest()) != (want_rows, want_sha):
            fail(f"listing k={k} ({run}) gave {nrows[0]} rows, sha256 "
                 f"{digest.hexdigest()}; expected {want_rows}, {want_sha}")
        count_kernel = ("triangle_count_tiles" if k == 5
                        else "clique_count_tiles")
        if not (delta["clique_list_tiles"] == delta[count_kernel]
                == sum(batches.values()) > 0):
            fail(f"listing k={k}: launches {delta} != one list and one "
                 f"count launch per packed batch ({sum(batches.values())})")
    if list_runs["k=6 warm"]["overflowed"] == 0:
        fail("listing k=6 overflowed no tile: the host relist never ran")
    # the kernels line reports the k=6 run, whose batches give its row
    list_launches = list_runs["k=6 warm"]["launches"]
    log(f"[list main] plain-version calls per run {list_plain}")
    if any(sum(plain.values()) for plain in list_plain.values()):
        fail(f"a plain version ran on the listing path: {list_plain}")

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

    # -- the multi-lane dispatcher ------------------------------------------
    dispatch_runs = dispatch_phase(g, plan, lg, lplan, main_runs, list_runs,
                                   queries)

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

    # -- observability and resilience ----------------------------------------
    obs_runs = obs_phase(g, plan, lg, lplan, dispatch_runs, list_trace,
                         queries)
    resilience_runs = resilience_phase(lg, lplan, queries, cli_outputs)

    # -- the new tile widths, plan persistence, the tuner --------------------
    widths_runs = widths_phase(g, plan, lplan, rows, errs, ptxas, main_runs,
                               queries)
    persist_runs = persist_phase(g, plan, lg, lplan, main_runs)
    tune_runs = tune_phase(g, main_runs)

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
