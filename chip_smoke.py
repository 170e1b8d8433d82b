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
* plan persistence (``[persist]``): ``save_plan`` / ``load_plan`` of the
  scale-15 plan, and a corrupt scale-12 store (``plan.load=1.0:corrupt``)
  quarantined and rebuilt by a fresh launcher process;
* the tuner (``[tune]``): ``tune_geometry`` for counting (l = 5) and
  listing (l = 3) persisted to a tune cache (the library of the build
  copied into it), a fresh launcher process that counts k = 7 on the
  scale-12 graph with ``--tune-cache`` on the tuned geometry without a
  search and with ``--plan-cache`` on ``[persist]``'s rebuilt store
  (loaded warm), and the ``autotune`` backend's kernel-vs-plain
  measurement,
  whose winner the card reports and does not obey;
* tiles wider than 256 (``[wide]``): the ``-Xptxas -v`` report of the
  kernels' wide path, the four kernels at T = 288, 512, 1056 and 2048
  against their plain versions and timed, and a count and a listing
  through bins (32, ..., 256, 512) on a complete multipartite graph whose
  widest tiles hold 258 vertices, against closed forms;
* dynamic graphs (``[delta]``): a ``PlanIndex`` on the scale-11 graph on
  the card through a repair batch and then one past the churn
  threshold, each checked against a fresh plan, with its k = 5 delta
  exact by three counts and by its rows and its time split by the trace,
  the composed delta, and one 0.2 % batch on the scale-13 graph with its
  net count against the pinned one;
* the serving tier (``[serve]``): a ``CliqueService`` on the card with
  the scale-12 and scale-11 graphs registered, a burst of 8 client
  threads (counts on both graphs, lists on the scale-11 graph, filtered
  and truncated) on one lane, its scale-11 requests on two lanes (under
  the profiler), an update of the scale-11 graph and a delta read, a
  metrics scrape, the scale-11 requests under the chaos plan (each exact
  or failed alone, then a clean request exact), and the same requests
  one at a time as the serial yardstick;
* the paper baseline (``[baseline]``): VBBkC (``vbbkc.count``, DDegCol
  and DDegCol+, a host recursion as in the reference) at k = 5 and 6 on
  the same generator at scale 11, each equal to the card's
  ``ebbkc.count`` and the pinned count, Lemma 4.1 by ``tau_delta_gap``
  (its quickstart twin runs in ``[train]``'s batch of fresh processes);
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
  one run under the profiler; the prefill and two teacher-forced decode
  steps on a 1-rank NCCL mesh (``launch.steps.lm_ctx``: the sharded code
  path, its collectives the identity) equal to the unsharded run to the
  bit;
  and the reduced granite-3-8b
  and gemma3-27b configs (local windows) on the card against the port's
  CPU run on the same params;
* the MoE serving path (``[moe serve]``): ``launch.serve`` at
  deepseek-moe-16b's published widths and depth (28 layers, 64 routed
  experts top-6 plus 2 shared, f32 params, bf16 compute), 8 requests of
  32 prompt tokens and 16 greedy tokens: the bf16 prefill against bf16
  ``forward``, a dropless f32 decode step against f32 ``forward`` with
  the smallest top-6 router gap, two planted routing faults beyond
  ``LM_ATOL``, ids in the vocab and equal tokens over runs, init time,
  tok/s, peak memory and busy share; the same 1-rank NCCL mesh check at
  full depth (each rank's expert range in); the reduced deepseek-moe-16b and
  dbrx-132b configs on the card against the CPU;
* training (``[train]``): granite-3-8b at its published widths cut to 8
  layers, seq 4,096, a batch of 4 in 2 microbatches, remat on, 3 steps of
  ``launch.steps``' train step through ``TrainLoop`` (step time,
  tokens/s, peak memory, busy share; step 0 in bf16 against an f32 pass),
  ``launch.train`` in fresh processes (reduced granite-3-8b, crashed
  and resumed bitwise, the crashed run started before ``[lm serve]``,
  and reduced deepseek-moe-16b), ``examples/train_lm_torch.py`` and
  ``[baseline]``'s ``examples/quickstart_torch.py`` (its device engine
  equal to the host recursion), five fresh processes run while the card
  checks the trained params' loss and grads on a 1-rank NCCL mesh
  against the unsharded cell's and trains the reduced configs against
  the CPU;
* GNN training (``[gnn train]``): each GNN arch at its published config
  through ``launch.train.build`` and ``TrainLoop`` on the cell shape
  that the reference pads: gin-tu on ogb_products (N = 2,449,408, E =
  61,859,328; 2 steps; its aggregation against an f64 sum),
  meshgraphnet on minibatch_lg, egnn and nequip on molecule (3 steps
  each), each arch's two runs of one step bitwise equal and the busy
  share of one; NequIP's
  energy and EGNN's output and coordinates under a random rotation of a
  ``GraphBatcher`` batch; the five reduced GNN and recsys configs
  through ``launch.train`` on the card and trained card against CPU;
  ``examples/gnn_clique_features_torch.py`` in process (its clique
  features, listed by the list kernel, equal to the host's);
* recommendation (``[recsys]``): dcn-v2 at its published widths, 3
  train steps at B = 65,536 (a bitwise repeat), serving at B = 512 (p50
  / p99 of 50 calls, logits against the CPU) and B = 262,144, and
  retrieval over 1,000,000 candidates (its top 100 against a stable
  sort of the same scores);
* sharding (``[shard]``, ``repro_torch.sharding`` over a ``DeviceMesh``
  from ``launch.mesh``): the paper's edge-parallel clique cells
  ``ep_tri_1m`` (1,048,576 tiles, T = 64) and ``ep_tri_128`` (262,144
  tiles, T = 128) of ``launch.steps.build_cell`` on a 1-rank NCCL mesh
  through the triangle kernel (per-tile outputs against the unsharded
  ``count_packed``, the kernel against its plain version on a 4,096-tile
  slice, the f32 total beside the exact int64 sum), ``ep_tri_1m`` on two
  spawned ranks of the one card over gloo (their blocks against the
  1-rank run), then on the same two ranks the transformer's sharding
  against the unsharded runs that ``[lm serve]``, ``[moe serve]`` and
  ``[train]`` saved: granite-3-8b at full width and depth on (1, 2)
  (tensor parallelism: prefill and two teacher-forced decode steps within
  ``LM_ATOL``), deepseek-moe-16b at full width cut to 8 layers on (1, 2)
  (expert parallelism, f32), and the granite-3-8b train step at full
  width cut to 2 layers, seq 4,096, B = 2 on (2, 1) (FSDP: loss and grad
  norm within ``TRAIN_REL``, replicated leaves bitwise equal across the
  ranks), each rank drawing the unsharded leaves and keeping its block;
  one sharded gin-tu step on ``[gnn train]``'s ogb_products
  batch and params and one sharded dcn-v2 train step and retrieval
  query against their unsharded twins, and ``compressed_allreduce`` over
  a 100M-element gradient against its single-process round trip.  The
  LM, MoE, training, GNN, recsys and truss paths run none of the four
  kernels but the GNN twin's listing (torch ops only, as the reference
  runs XLA ops there); ``[shard]``'s clique cells run the triangle
  kernel, and their launches count on its row.

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


def plain_once(oracle, key, run):
    """(result, plain_ms) of the plain version: ``run`` timed once, or,
    when ``oracle`` already holds ``key``, the result it holds and None
    (its time is on the row of the input that ran it).  Each plain run is
    kept in ``oracle`` (a dict, or None to keep nothing)."""
    if oracle is not None and key in oracle:
        return oracle[key], None
    out, ms = timed_once(run)
    if oracle is not None:
        oracle[key] = out
    return out, ms


def fmt_ms(ms, digits: int = 3) -> str:
    return "shared" if ms is None else f"{ms:.{digits}f} ms"


def kernel_cases(rows, errs, A, cand, l, tag, reps=20,
                 calls=GRAPH_CALLS, oracle=None):
    """Kernel vs plain on one input; record timings and the bound.

    The kernel's times are those of the bare C entry point (no wrapper, so
    no launch counted) with the wrapper's zero fills; the plain version's
    is its one comparison run, since it repeats the kernel's arithmetic
    step by step and is no yardstick of speed.  With ``oracle`` (see
    :func:`plain_once`) the plain results of an input whose tiles are the
    same (a pow2 twin) are reused, not run again."""
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
            want, plain_ms = plain_once(
                oracle, ("triangle", l),
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

            def run_plain():
                work = {}
                return (clique_count.clique_count_tiles_torch(A, cand, l,
                                                              work), work)
            (want, work), plain_ms = plain_once(oracle, ("dfs", l),
                                                run_plain)

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
            item_case(rows, errs, A, cand, l, tag, want, reps, calls,
                      oracle)
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
            f"{fmt_ms(plain_ms)}, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}: {nbytes} B, {word_ops} word-ops)"
            + (f", bmm device {lib_ms:.5f} ms, wrapper device "
               f"{extra['wrapper_device_ms']:.5f} ms"
               if lib_ms is not None else ""))
    return results


def item_case(rows, errs, A, cand, l, tag, tile_counts, reps=20,
              calls=GRAPH_CALLS, oracle=None):
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
    want, plain_ms = plain_once(
        oracle, ("items", l),
        lambda: clique_count.clique_count_items_torch(A, cand, l))
    if want.shape[1] < T:  # a pow2 twin's added vertices hold no item
        want = torch.nn.functional.pad(want, (0, T - want.shape[1]))
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
        f"{fmt_ms(plain_ms)}, {kept} items with cliques, largest item share "
        f"of its tile {row['max_item_share']:.3f}")
    return row


def list_case(rows, errs, A, cand, l, cap, tag, reps=0,
              calls=GRAPH_CALLS, oracle=None):
    """List kernel vs plain on one input at capacity ``cap``: buffer (zero
    padding included), count and overflow must be ``torch.equal``.  With
    ``reps`` it also times the bare C entry point (no launch counted), the
    zero fill a ``torch.zeros`` buffer would add, and the bound.

    With ``oracle`` (see :func:`plain_once`) one plain run serves every
    capacity up to its own: the plain version writes rank r of a tile at
    row r when r < capacity and nothing else depends on the capacity, so
    its result at a smaller capacity is its buffer's first rows, the same
    count, and overflow = count > capacity
    (``tests/test_torch_listing.py`` holds that on the CPU).  Call the
    largest capacity first."""
    import torch
    from repro_torch.kernels import _build, clique_count, clique_list
    from repro_torch.kernels.common import check_tiles
    B, T, W = check_tiles(A, cand)
    got = clique_list.clique_list_tiles(A, cand, l, cap)

    def run_plain():
        work = {}
        return (clique_list.clique_list_tiles_torch(A, cand, l, cap, work),
                work, cap)
    (want, work, plain_cap), plain_ms = plain_once(oracle, ("list", l),
                                                   run_plain)
    if plain_cap < cap:
        fail(f"list_case at capacity {cap} after a plain run at "
             f"{plain_cap} ({tag})")
    if plain_cap > cap:
        want = (want[0][:, :cap].contiguous(), want[1],
                (want[1] > cap).to(torch.int64))
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
    item_case(rows, errs, A, cand, l, tag, count, reps, calls, oracle)
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
           **t, "plain_ms": plain_ms, "plain_capacity": plain_cap,
           "bytes": nbytes,
           "word_ops": word_ops, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None, "zero_fill_ms": zero_ms}
    rows.append(row)
    log(f"  list     {tag:17s} T={T:3d} l={l} B={B:3d} cap={cap:5d}: "
        f"device {t['device_ms']:.5f} ms, call {t['call_ms']:.4f} ms, plain "
        f"{fmt_ms(plain_ms)} (capacity {plain_cap}), bound {bound_ms:.6f} "
        f"ms ({bound_by}: {nbytes} "
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
    edge_case; the twin against the plain results of the batch, whose
    tiles it holds), the twin's results equal to the batch's, and both
    timed.
    Returns {(kernel, l): (device_ms, twin device_ms)}."""
    import torch
    from repro_torch.kernels import ops
    A2, c2 = pow2_twin(A, cand)
    out = {}
    # the twin's kernels are held against the plain results of the same
    # tiles at T (oracle), not run through the plain versions again
    oracle = {}
    for l in ls:
        got = kernel_cases(rows, errs, A, cand, l, tag, reps=10,
                           oracle=oracle)
        twin = kernel_cases(rows, errs, A2, c2, l, tag + " twin", reps=10,
                            oracle=oracle)
        if not torch.equal(ops.count_tiles(A, cand, l),
                           ops.count_tiles(A2, c2, l)):
            fail(f"the pow2 twin counts differently at l={l} ({tag})")
        for r, r2 in zip(got, twin):
            out[(r["kernel"], l)] = (r["device_ms"], r2["device_ms"])
    if list_l is not None:
        from repro_torch.core import listing
        counts = ops.count_tiles(A, cand, list_l).cpu().numpy()
        cap = listing.capacity_for(counts)
        r = list_case(rows, errs, A, cand, list_l, cap, tag, reps=10,
                      oracle=oracle)
        r2 = list_case(rows, errs, A2, c2, list_l, cap, tag + " twin",
                       reps=10, oracle=oracle)
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
    ``load_plan`` of its store (seconds, bytes, the tables equal); the
    rmat12 store saved for a fresh process, which first reads it under
    ``plan.load=1.0:corrupt`` (through REPRO_TORCH_FAULT_PLAN): it is
    quarantined and rebuilt, and the count stays exact.  ``[tune]``'s
    fresh process then loads the rebuilt store from disk (``warm``)."""
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
    (``tune_hit=True``, no search) and counts k = 7 on rmat12 exactly,
    its plan loaded from ``[persist]``'s rebuilt store (``warm``, the
    decomposition skipped: one process checks both stores);
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
        warm = re.search(r"plan cache \[.*\]: warm \(decomposition "
                         r"skipped\), ([0-9.]+)s", text)
        out["cli"] = dict(count=count, wall_s=wall,
                          bins=ran.group(1) if ran else None,
                          tune_hit="tune_hit=True" in text,
                          plan_load_s=float(warm.group(1)) if warm else None)
        log(f"[tune] fresh process, --tune-cache and --plan-cache: count="
            f"{count}, bins {out['cli']['bins']} (record: {want_bins}), "
            f"tune_hit={out['cli']['tune_hit']}, rmat12 plan loaded from "
            f"[persist]'s store in {out['cli']['plan_load_s']} s (warm); "
            f"process wall {wall:.1f} s")
        if warm is None:
            fail("the fresh process did not load the rmat12 plan from disk")
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

#: inserted and deleted pairs of the repair batch on rmat11 (churn
#: 0.0667), and of the batch after it that must pass CHURN_THRESHOLD (a
#: rebuild: churn 0.1785 against the threshold's 0.15); host-only figures
#: that the seeded draws fix
DELTA_REPAIR_PAIRS = 4
DELTA_REBUILD_PAIRS = 10
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


def delta_phase(mg, mplan, sg) -> dict:
    """``[delta]``: a PlanIndex on rmat11 on the card (its plan warm from
    the listing phase) takes a seeded repair batch and then one past
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
    pipeline.cached_plan(sg, "hybrid")
    warm(mg, mplan)
    idx = PlanIndex(sg, stats=stats)
    if not stats.plan_cache_hit:
        fail("[delta] the rmat11 plan was not warm")
    rng = np.random.default_rng(7)
    fields = ("edge_id", "anchors", "offsets", "verts", "thresh", "ekeys",
              "erank")
    c5_old = EXPECTED_11[5]
    events = []  # (version, gained keys, lost keys) for the composition
    n = sg.n
    w5 = n ** np.arange(4, -1, -1, dtype=np.int64)
    for b, pairs in enumerate((DELTA_REPAIR_PAIRS, DELTA_REBUILD_PAIRS)):
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
        log(f"[delta] rmat11 batch {b}: +{info.n_insert} -{info.n_delete} "
            f"pairs, churn {info.churn:.4f} (threshold {CHURN_THRESHOLD}), "
            f"touched {run['touched']}, "
            f"{'rebuilt' if info.rebuilt else 'repaired'} in {repair_s:.3f} "
            f"s against build_plan {build_s:.3f} s; table equal: "
            f"{same_table}; k=5/6 counts repaired/fresh {counts}; delta "
            f"k=5 +{run['gained']} -{run['lost']} in {delta_s:.2f} s "
            f"(counts old {c5_old} new {c5_new} both {c5_int}); gained rows "
            f"{gained}, lost rows {lost}; launches {launches}")
        log(f"[delta] rmat11 batch {b}: the delta's split (traced, s): "
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
        if b == 0 and info.rebuilt:
            fail(f"[delta] the repair batch ({pairs} pairs a side) rebuilt: "
                 f"churn {info.churn}")
        if b == 1 and not info.rebuilt:
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

#: the burst's requests, one a client thread: (graph, k, mode, options).
#: The large graph is rmat12 and the small one rmat11 (n = 2,048), whose
#: lists hold a quarter of rmat12's 5-cliques: the burst's time is the
#: host's packing of counts and decode of lists.
SERVE_VERTEX, SERVE_MAX_OUT = 7, 1000
SERVE_SPECS = (
    ("rmat12", 5, "count", {}), ("rmat12", 7, "count", {}),
    ("rmat11", 5, "count", {}), ("rmat11", 6, "count", {}),
    ("rmat11", 7, "count", {}), ("rmat11", 5, "list", {}),
    ("rmat11", 5, "list", dict(vertex_filter=SERVE_VERTEX)),
    ("rmat11", 5, "list", dict(vertex_filter=SERVE_VERTEX,
                               max_out=SERVE_MAX_OUT)),
)
# 7-cliques and the k = 5 listing of rmat_graph(11, 16, seed=7), from the
# JAX reference on a CPU as EXPECTED_LIST's (the listing 8 s there)
EXPECTED_11_K7 = 88_100_805
EXPECTED_LIST_11 = (
    6_650_633,
    "b58e27401d8f0535a20c54b1c177f1bdf58ba53f67b72b5323df9a6553acb163")


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


def serve_phase(lg, lplan, sg, delta_runs) -> dict:
    """``[serve]``: one CliqueService on the card with rmat12 and rmat11
    registered (plans warm): a paused-then-resumed burst of 8 client
    threads (counts k = 5, 7 on rmat12 and k = 5, 6, 7 on rmat11; lists
    k = 5 on rmat11 unfiltered, filtered and truncated) against the pinned
    counts and digest; an update of rmat11 and a delta read against
    ``[delta]``'s first batch; a metrics scrape; the burst's rmat11
    requests on two lanes of the card, under the profiler for the device's
    busy share; the same rmat11 requests under the chaos plan (each exact
    or failed alone, then a clean request exact); and the serial
    yardstick."""
    import numpy as np
    from repro_torch.core import ebbkc, pipeline
    from repro_torch.kernels import ops
    from repro_torch.obs.export import scrape
    from repro_torch.resilience import inject
    from repro_torch.serve import CliqueService, apply_vertex_filter
    graphs = {"rmat12": lg, "rmat11": sg}
    warm(lg, lplan)
    pipeline.cached_plan(sg, "hybrid")
    pinned = {("rmat12", 5): EXPECTED_LIST[5][0],
              ("rmat12", 7): EXPECTED_12_K7,
              ("rmat11", 5): EXPECTED_11[5], ("rmat11", 6): EXPECTED_11[6],
              ("rmat11", 7): EXPECTED_11_K7}
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
                ) == EXPECTED_LIST_11
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
            for name in sorted({s[0] for s in specs}):
                svc.register_graph(name, graphs[name])
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
        # update rmat11 with [delta]'s first batch and read the delta
        first = delta_runs["first_batch"]
        t0 = time.perf_counter()
        version = svc.update_graph("rmat11", insert=first["insert"],
                                   delete=first["delete"])
        update_s = time.perf_counter() - t0
        ops.reset_counts()
        d = svc.submit("rmat11", 5, "delta", since_version=0).result(900)
        same = d.rows.tobytes() == first["gained"].tobytes()
        out["delta"] = dict(version=version, update_s=update_s,
                            rows=int(d.rows.shape[0]), equal=same,
                            latency_s=d.latency_s,
                            launches=ops.launch_counts())
        log(f"[serve] update_graph rmat11 -> version {version} in "
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
    # two lanes take the rmat11 requests, under the profiler (the device's
    # busy share): the rmat12 counts' time is the scheduler thread's serial
    # packing, one lane or two, and the full burst's profiler events take
    # long to read
    svc, out["two_lanes"] = burst(
        "2 lanes", ["cuda:0", "cuda:0"],
        [s for s in SERVE_SPECS if s[0] == "rmat11"], profiled=True)
    svc.close()

    # the rmat11 burst under the chaos plan: on a CUDA lane an injected
    # fault is retried on the kernel and then raises, so a request whose
    # launch draws a fault on every attempt fails with FaultInjected; it
    # must fail alone (every other request exact), and the service must
    # then serve a clean request exactly
    chaos = [s for s in SERVE_SPECS if s[0] == "rmat11"]
    svc = CliqueService(devices=["cuda:0"])
    try:
        svc.register_graph("rmat11", sg)
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
        clean = svc.submit("rmat11", 6, "count").result(900)
        clean_s = time.perf_counter() - t0
        check("after chaos", [("rmat11", 6, "count", {})], [clean])
        retries = sum(r.stats.retries for _, r in served)
        out["chaos"] = dict(wall_s=wall, fired=fired, retries=retries,
                            engine_retries=svc.engine_stats.retries,
                            failed=failed, exact=len(served),
                            isolated_failures=isolated, clean_s=clean_s)
        log(f"[serve] burst of {len(chaos)} rmat11 requests under "
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
    # (a serial client filters the listing's rows itself)
    warm(lg, lplan)
    serial = {}
    for name, k, mode, kw in SERVE_SPECS:
        key = f"{name} k={k} {mode}" + ("" if not kw else " filtered")
        if mode == "list" and kw:
            continue
        t0 = time.perf_counter()
        if mode == "count":
            got = ebbkc.count(graphs[name], k).count
            if got != pinned[(name, k)]:
                fail(f"[serve] serial {key}: {got}")
        else:
            rows, _ = ebbkc.list_cliques(graphs[name], k)
            if rows.shape[0] != EXPECTED_LIST_11[0]:
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
    ``tau_delta_gap``.  Its quickstart twin runs in ``[train]``'s batch of
    fresh processes (:func:`train_launcher_checks`)."""
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
    out["params_bytes"] = params_bytes(params)
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
    forced = gen.tokens[:, :LM_SHARD_STEPS]
    last, steps_ = one_rank_serve_check("[lm serve]", params, prompts, forced,
                                        cfg, out)
    save_shard_ref("granite", prompts=prompts, forced=forced, last=last,
                   steps=steps_)
    del params, runs, gen, ref_last, ref_next, ref32, last, steps_
    torch.cuda.empty_cache()

    reduced_vs_cpu(("granite-3-8b", "gemma3-27b"), "[lm serve]", out)
    return out


def reduced_vs_cpu(archs, tag: str, out: dict) -> None:
    """The reduced configs of ``archs``, f32 with TF32 off, served on the
    card against the port's CPU run on the same params: prefill and first
    decode step logits within :data:`LM_SMALL_TOL`, greedy tokens equal."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in archs:
            small = dataclasses.replace(configs.get(arch).reduced,
                                        dtype=torch.float32)
            cpu_p, cpu_t = serve.make_inputs(small, LM_REQUESTS, LM_PROMPT,
                                             "cpu", seed=1)
            card_p = to_card(cpu_p)
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
            log(f"{tag} reduced {arch} ({small.layer_groups}, window "
                f"{small.local_window}, moe {small.moe}) f32 on the card vs "
                f"the CPU: |prefill| {e1:.2e}, |decode step 1| {e2:.2e}, "
                f"tokens equal: {same}")
            if not ok:
                fail(f"{tag} reduced {arch}: the card differs from the "
                     f"CPU beyond {LM_SMALL_TOL}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def to_card(tree):
    """A tree of CPU tensors (dicts and lists) as the same tree on the
    card."""
    if isinstance(tree, dict):
        return {k: to_card(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_card(v) for v in tree)
    return tree.cuda()


def params_bytes(params) -> int:
    from repro_torch.optim import tree_leaves
    return sum(w.numel() * w.element_size() for w in tree_leaves(params))


# The transformer's sharding on the card (A13e-2).  [lm serve], [moe
# serve] and [train] check their params on a 1-rank NCCL mesh against the
# unsharded run (equal to the bit: a 1-rank mesh's collectives are the
# identity, and the sharded code runs the same arithmetic) and
# save the unsharded run that [shard]'s two gloo ranks are held to:
# granite-3-8b at full width and depth on (1, 2) (tensor parallelism, 8
# kv heads over 2), deepseek-moe-16b at full width cut to 8 of its 28
# layers on (1, 2) (expert parallelism, 32 experts a rank; in f32 with
# TF32 off, since routing is discontinuous and a bf16 rounding of another
# summation order flips expert choices), and the granite-3-8b train step
# at full width cut to 2 layers, seq 4,096, B = 2 on (2, 1) (FSDP and
# data parallelism).  Each rank draws the unsharded draw's leaves in its
# order and keeps its block of each, one leaf at a time.
LM_SHARD_STEPS = 2            # decode steps teacher-forced on (1, 2)
MOE_SHARD_LAYERS = 8
TRAIN_SHARD_LAYERS, TRAIN_SHARD_BATCH = 2, 2
SHARD_LM_DIR = ROOT / "build" / "shard_lm"
# the 1-rank train check: the loss's log-sum-exp over the (whole) vocab
# block does ATen's logsumexp arithmetic, so the loss and grads are
# expected to the bit; the bound is for an equivalent formula
ONE_RANK_REL = 1e-6


def one_rank_mesh():
    """The (1, 1) NCCL mesh of the card (its process group stays until
    ``[shard]`` destroys it)."""
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh((1, 1), device="cuda")


def lm_forced(params, prompts, forced, cfg, ctx=None):
    """(last-position prefill logits, (n, B, V) logits of ``n`` decode
    steps fed ``forced``'s columns) on ``ctx``'s mesh, or unsharded."""
    import torch
    from repro_torch.models import transformer as tr
    ctx = ctx or tr.ShardCtx()
    B, S = prompts.shape
    n = forced.shape[1]
    with torch.inference_mode():
        last, cache = tr.prefill(params, prompts, cfg, max_len=S + n,
                                 ctx=ctx)
        out = []
        for t in range(n):
            lengths = torch.full((B,), S + t, dtype=torch.int64,
                                 device=prompts.device)
            logits, cache = tr.decode_step(params, cache, forced[:, t:t + 1],
                                           lengths, cfg, ctx)
            out.append(logits)
    return last, torch.stack(out)


def greedy_tokens(params, prompts, cfg, n: int):
    """(B, n) greedy tokens: the prefill's argmax, then each decode
    step's."""
    import torch
    from repro_torch.models import transformer as tr
    B, S = prompts.shape
    with torch.inference_mode():
        last, cache = tr.prefill(params, prompts, cfg, max_len=S + n)
        toks = [torch.argmax(last, -1)[:, None]]
        for t in range(n - 1):
            lengths = torch.full((B,), S + t, dtype=torch.int64,
                                 device=prompts.device)
            logits, cache = tr.decode_step(params, cache, toks[-1], lengths,
                                           cfg)
            toks.append(torch.argmax(logits, -1)[:, None])
    return torch.cat(toks, 1)


def cut_layers(params, n: int):
    """The params of the first ``n`` layers of each group (views)."""
    return {**params, "groups": {k: {name: w[:n] for name, w in g.items()}
                                 for k, g in params["groups"].items()}}


def one_rank_serve_check(tag, params, prompts, forced, cfg, out) -> tuple:
    """Prefill and :data:`LM_SHARD_STEPS` teacher-forced decode steps of
    ``params`` on the 1-rank NCCL mesh (``launch.steps.lm_ctx``: the
    sharded code path, the masked vocab gathers and the experts' local
    range in, its collectives the identity) against the same unsharded;
    equal to the bit.  Returns the unsharded
    (last, steps) logits."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.sharding import spmd
    mesh = one_rank_mesh()
    ctx = steps.lm_ctx(mesh, cfg)
    local = spmd.shard_tree(params, ctx.param_specs, mesh)
    t0 = time.perf_counter()
    want = lm_forced(params, prompts, forced, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = lm_forced(local, prompts, forced, cfg, ctx)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    out["one_rank_mesh"] = dict(bitwise_equal=equal, unsharded_s=t1 - t0,
                                sharded_s=t2 - t1)
    log(f"{tag} {cfg.name} ({cfg.n_layers} layers) on the 1-rank NCCL mesh "
        f"(its collectives the identity): prefill and {forced.shape[1]} "
        f"teacher-forced decode steps equal to the unsharded run to the "
        f"bit: {equal}; {t2 - t1:.3f} s sharded, {t1 - t0:.3f} s unsharded")
    if not equal:
        fail(f"{tag} the 1-rank mesh's logits differ from the unsharded run")
    return want


def save_shard_ref(name: str, **arrays) -> None:
    import numpy as np
    SHARD_LM_DIR.mkdir(parents=True, exist_ok=True)
    np.savez(SHARD_LM_DIR / f"{name}.npz", **{
        k: (v.detach().float().cpu().numpy() if v.is_floating_point()
            else v.cpu().numpy()) if hasattr(v, "detach") else np.asarray(v)
        for k, v in arrays.items()})


# [moe serve]: deepseek-moe-16b at its published widths and depth (28
# layers, d = 2,048, 16 heads of 128, 64 routed experts top-6 of width
# 1,408 plus 2 shared, vocab 102,400), f32 params (62.88 GiB), bf16
# compute, 8 requests of 32 prompt tokens and 16 greedy tokens.  The
# capacity C = ceil(T K 1.25 / E) is 30 slots an expert at the prefill
# (T = 256), 31 for forward on prompt + 1 token and 1 at a decode step
# (T = 8): a decode step drops assignments, as the reference's does.  So
# the decode step is held against forward in a dropless f32 run
# (capacity_factor = E / K, so C = T at every T; TF32 off), where the
# routing is the same on both sides unless two router probabilities lie
# within rounding of each other: the smallest gap between the 6th and 7th
# probability over that step's routing decisions is reported beside it.
# The planted routing faults (MOE_FAULTS) replace the router of that
# decode step and must read above LM_ATOL.
MOE_ARCH = "deepseek-moe-16b"
MOE_FAULTS = ("top-k weights not renormalised",
              "each token routed to expert (i + 1) mod E")


def moe_routers():
    """``transformer._route`` replacements: one recording the gap between
    the K-th and (K+1)-th router probability of every token it routes,
    and one planting each of :data:`MOE_FAULTS`."""
    import torch
    from repro_torch.models import transformer as tr
    route, gaps = tr._route, []

    def probs_of(x2d, router):
        return torch.softmax((x2d @ router.to(x2d.dtype)).float(), dim=-1)

    def recording(x2d, router, top_k):
        top = torch.sort(probs_of(x2d, router), dim=-1,
                         descending=True).values
        gaps.append((top[:, top_k - 1] - top[:, top_k]).min())
        return route(x2d, router, top_k)

    def unnormalised(x2d, router, top_k):
        w, i = torch.sort(probs_of(x2d, router), dim=-1, descending=True,
                          stable=True)
        return w[:, :top_k], i[:, :top_k]

    def shifted(x2d, router, top_k):
        w, i = route(x2d, router, top_k)
        return w, (i + 1) % router.shape[-1]

    return gaps, recording, {MOE_FAULTS[0]: unnormalised,
                             MOE_FAULTS[1]: shifted}


def moe_dropless_checks(params, prompts, cfg) -> dict:
    """The dropless f32 run: its first decode step against f32
    ``forward(prompt + token)``, the same step with each planted router
    (and the unplanted one as the control), and the smallest top-K gap of
    the step's routing decisions."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tr
    moe = cfg.moe
    f32 = dataclasses.replace(
        cfg, dtype=torch.float32, moe=dataclasses.replace(
            moe, capacity_factor=moe.n_experts / moe.top_k))
    B, S = prompts.shape
    lengths = torch.full((B,), S, dtype=torch.int64, device=prompts.device)
    gaps, recording, faults = moe_routers()
    route = tr._route
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        with torch.inference_mode():
            last, cache = tr.prefill(params, prompts, f32, max_len=S + 1)
            token = torch.argmax(last, -1)[:, None]
            want = tr.forward(params, torch.cat([prompts, token], 1),
                              f32)[:, -1]
            # each decode step writes slot S of the cache before reading
            # it, so the planted steps share one prefill
            for name, plant in [("control", recording), *faults.items()]:
                tr._route = plant
                logits, _ = tr.decode_step(params, cache, token, lengths,
                                           f32)
                out[name] = float((logits - want).abs().max())
    finally:
        tr._route = route
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return dict(errs=out, min_topk_gap=float(min(gaps)),
                decisions=len(gaps) * B, max_abs_logit=float(
                    want.abs().max()))


def moe_phase(header: str) -> dict:
    """``[moe serve]``: ``repro_torch.launch.serve`` at deepseek-moe-16b's
    published widths and depth on the card (its CLI entry in this
    process, then the checked run on the same seed): (a) the bf16 prefill
    against bf16 ``forward`` on the prompts (the same T, so the same
    routing and drops), (b) the dropless f32 decode step against f32
    ``forward(prompt + token)`` with the smallest top-K gap, (c) the
    planted routing faults above ``LM_ATOL`` while the control stays
    under it, (d) every id in ``[0, padded_vocab)`` and two runs'
    tokens equal; the bf16 prefill against an f32 ``forward`` reported,
    not gated; init time, peak memory, prefill and decode tok/s and the
    busy share of one profiled run; then the reduced deepseek-moe-16b and
    dbrx-132b configs on the card against the port's CPU run."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tr
    torch.cuda.empty_cache()
    cfg = configs.get(MOE_ARCH).full
    moe = cfg.moe
    out = {"arch": MOE_ARCH, "num_params": cfg.num_params(),
           "active_params": cfg.active_params(),
           "capacity": {T: tr.capacity(moe, T) for T in (
               LM_REQUESTS * LM_PROMPT, LM_REQUESTS * (LM_PROMPT + 1),
               LM_REQUESTS)}}
    argv = ["--arch", MOE_ARCH, "--full", "--requests", str(LM_REQUESTS),
            "--prompt-len", str(LM_PROMPT), "--tokens", str(LM_TOKENS)]
    cli = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(cli):
        serve.main(argv)
    out["cli"] = dict(wall_s=time.perf_counter() - t0,
                      stdout=cli.getvalue().strip().splitlines())
    log(f"[moe serve] python -m repro_torch.launch.serve {' '.join(argv)} "
        f"({out['cli']['wall_s']:.1f} s): " + " | ".join(out["cli"]["stdout"]))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by earlier phases
    t0 = time.perf_counter()
    params, prompts = serve.make_inputs(cfg, LM_REQUESTS, LM_PROMPT, "cuda")
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params_bytes"] = params_bytes(params)
    runs = [serve.generate(params, prompts, cfg, LM_TOKENS)
            for _ in range(3)]  # cold, then two warm
    peak = torch.cuda.max_memory_allocated() - held
    busy = device_busy(f"{MOE_ARCH} generate", lambda: serve.generate(
        params, prompts, cfg, LM_TOKENS), tag="[moe serve]")
    busy.pop("result")
    log("[moe serve] top device kernels of the profiled run: " + ", ".join(
        f"{name[:60]} {sec:.4f} s" for name, sec in busy["top_kernels"]))
    gen = runs[0]
    same = all(torch.equal(r.tokens, gen.tokens) for r in runs[1:])
    bad = int(((gen.tokens < 0) | (gen.tokens >= cfg.padded_vocab)).sum())
    with torch.inference_mode():
        ref_last = tr.forward(params, prompts, cfg)[:, -1]
        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        ref32 = tr.forward(params, prompts, f32)[:, -1]
    err_prefill = float((gen.prefill_logits - ref_last).abs().max())
    err_f32 = float((gen.prefill_logits - ref32).abs().max())
    dropless = moe_dropless_checks(params, prompts, cfg)
    faults = dropless["errs"]
    B = LM_REQUESTS
    timing = [dict(prefill_s=r.prefill_s, decode_s=r.decode_s,
                   prefill_tok_s=B * LM_PROMPT / r.prefill_s,
                   decode_tok_s=B * (LM_TOKENS - 1) / r.decode_s)
              for r in runs]
    out.update(runs=timing, peak_bytes=peak, busy=busy, bad_ids=bad,
               tokens_equal=same, err_prefill=err_prefill,
               err_bf16_vs_f32=err_f32, dropless=dropless,
               max_abs_logit=float(ref_last.abs().max()), atol=LM_ATOL,
               sample=gen.tokens[0].tolist())
    w = timing[-1]
    log(f"[moe serve] {MOE_ARCH} full width ({cfg.n_layers} layers, d="
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.d_head}, {moe.n_experts}"
        f" routed experts top-{moe.top_k} of width {moe.d_expert} + "
        f"{moe.n_shared} shared, padded vocab {cfg.padded_vocab}; "
        f"{out['params_bytes'] / 2**30:.2f} GiB f32 params, init "
        f"{out['init_s']:.2f} s; capacity {out['capacity']} slots an expert "
        f"by T): {B} x {LM_PROMPT} prompt + {LM_TOKENS} greedy tokens; cold "
        f"prefill {timing[0]['prefill_s']:.3f} s decode "
        f"{timing[0]['decode_s']:.3f} s; warm prefill {w['prefill_s']:.4f} s "
        f"({w['prefill_tok_s']:.1f} tok/s), decode {w['decode_s']:.4f} s "
        f"({w['decode_tok_s']:.1f} tok/s); peak {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated over what earlier phases hold); "
        f"{header}")
    log(f"[moe serve] (a) |bf16 prefill - bf16 forward| {err_prefill:.5f}; "
        f"(b) dropless f32 |decode step 1 - forward(prompt + token)| "
        f"{faults['control']:.5f} (atol {LM_ATOL} each; max |logit| "
        f"{dropless['max_abs_logit']:.3f}), smallest gap between the "
        f"{moe.top_k}th and {moe.top_k + 1}th router probability over its "
        f"{dropless['decisions']} routing decisions "
        f"{dropless['min_topk_gap']:.3e}; (d) ids outside [0, "
        f"{cfg.padded_vocab}): {bad}, three runs' tokens equal: {same}; "
        f"sample {out['sample'][:10]}")
    log("[moe serve] (c) planted routing faults in the dropless decode "
        "step, |decode step 1 - forward(prompt + token)| (each must exceed "
        "the atol): " + ", ".join(f"{name} {faults[name]:.5f}"
                                 for name in MOE_FAULTS))
    log(f"[moe serve] not gated: |bf16 prefill - f32 forward| {err_f32:.5f}"
        f" (routing is discontinuous: a one-ulp change of a router logit "
        f"flips an expert choice, so bf16 and f32 may route differently)")
    if bad or not same:
        fail("[moe serve] ids outside the vocab, or a second run generated "
             "other tokens")
    if not max(err_prefill, faults["control"]) <= LM_ATOL:
        fail("[moe serve] the full-width MoE serve run disagrees with "
             "forward")
    if not all(faults[name] > LM_ATOL for name in MOE_FAULTS):
        fail(f"[moe serve] LM_ATOL does not tell the planted routing faults "
             f"from the unfaulted step: {faults}")
    one_rank_serve_check("[moe serve]", params, prompts,
                         gen.tokens[:, :LM_SHARD_STEPS], cfg, out)
    # [shard]'s expert-parallel run is held to the first 8 layers, f32
    cut_cfg = dataclasses.replace(cfg, n_layers=MOE_SHARD_LAYERS,
                                  dtype=torch.float32)
    cut = cut_layers(params, MOE_SHARD_LAYERS)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        forced = greedy_tokens(cut, prompts, cut_cfg, LM_SHARD_STEPS)
        last, steps_ = lm_forced(cut, prompts, forced, cut_cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    save_shard_ref("moe", prompts=prompts, forced=forced, last=last,
                   steps=steps_)
    del params, runs, gen, ref_last, ref32, cut, last, steps_
    torch.cuda.empty_cache()
    reduced_vs_cpu((MOE_ARCH, "dbrx-132b"), "[moe serve]", out)
    return out


# [train]: granite-3-8b at its published widths (d = 4,096, 32 / 8 heads
# of 128, d_ff = 12,800, padded vocab 49,664) cut to 8 of its 40 layers
# (1,996,582,912 params: f32 params, grads and AdamW moments take 29.75
# GiB; all 40 layers would take 134 GB), the train_4k cell's seq_len of
# 4,096, a global batch of 4 in M = 2 microbatches, remat on, 3 steps of
# launch.steps' train step through the port's TrainLoop.  TRAIN_REL bounds
# step 0's bf16 loss and grad norm against an f32 pass on the same params
# and batch, relative: on the reduced granite, deepseek-moe, gemma3 and
# nemotron configs (3 seeds each, B = 4, S = 64, M = 2, on a CPU) the
# largest readings were 6.8e-4 (loss) and 8.5e-3 (grad norm), and the
# bounds are about 7 and 6 times those.
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_MICRO = "granite-3-8b", 8, 4, 2
TRAIN_STEPS = 3
TRAIN_REL = {"loss": 5e-3, "grad_norm": 5e-2}
# the launcher's crash and resume, and the reduced configs card vs CPU
TRAIN_CLI_STEPS, TRAIN_FAIL_AT, TRAIN_CKPT_EVERY = 8, 5, 2
TRAIN_SMALL_STEPS = 5
# the example twin's steps (its default is 300; a fresh process spends
# about 20 s starting on the card, and 100 steps show the loss falling)
TRAIN_TWIN_STEPS = 100


def start_modules(jobs) -> list:
    """Each ``(module, argv, expect_rc)`` of ``jobs`` as ``python -m MODULE
    ARGV`` (or a script path) in a fresh process (:func:`child_env`), all
    started at once; :func:`reap_modules` collects them and
    :func:`kill_modules` stops what is left."""
    procs = []
    try:
        for module, argv, _ in jobs:
            cmd = [sys.executable, *(["-m", module] if not
                                     module.endswith(".py") else [module]),
                   *argv]
            procs.append((cmd, time.perf_counter(), subprocess.Popen(
                cmd, cwd=ROOT, env=child_env(), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
    except BaseException:
        kill_modules(procs)
        raise
    return procs


def reap_modules(procs, jobs, timeout=600) -> list:
    """The started ``jobs`` reaped in order; fails unless each exits as
    expected (0, or non-zero for ``expect_rc=1``).  Returns (stdout,
    stderr, wall s) a job, the wall from its start until it is reaped."""
    outs = []
    for (cmd, t0, proc), (module, _, expect_rc) in zip(procs, jobs):
        stdout, stderr = proc.communicate(timeout=timeout)
        wall = time.perf_counter() - t0
        log(f"[train] {' '.join(cmd[1:])} ({wall:.1f} s, exit "
            f"{proc.returncode}): " + " | ".join(stdout.strip().splitlines()))
        if (proc.returncode != 0) != (expect_rc != 0):
            fail(f"{module} exited {proc.returncode}: {stderr[-2000:]}")
        outs.append((stdout, stderr, wall))
    return outs


def kill_modules(procs) -> None:
    for _, _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


TRAIN_CLI_DIR = ROOT / "build" / "smoke_train"


def train_cli(ckpt: str, *extra) -> tuple:
    """The reduced granite-3-8b launcher job, checkpointing into ``ckpt``
    under :data:`TRAIN_CLI_DIR`."""
    return ("repro_torch.launch.train",
            ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_CLI_STEPS),
             "--ckpt-dir", str(TRAIN_CLI_DIR / ckpt), *extra])


def train_crash_start():
    """Starts the launcher run crashed at ``--fail-at`` with
    ``--ckpt-every`` in a fresh process; it runs while ``[lm serve]`` and
    ``[moe serve]`` do, so that ``[train]`` resumes it beside its other
    fresh processes.  Returns (processes, jobs)."""
    import shutil
    shutil.rmtree(TRAIN_CLI_DIR, ignore_errors=True)
    every = ["--ckpt-every", str(TRAIN_CKPT_EVERY)]
    jobs = [(*train_cli("crashed", *every, "--fail-at", str(TRAIN_FAIL_AT)),
             1)]
    return start_modules(jobs), jobs


def train_launcher_start(crashed, out: dict):
    """Reaps the crashed run (:func:`train_crash_start`), then starts the
    launcher and the example twins in fresh processes, five at once on
    the card (:func:`train_launcher_checks` reaps them): the reduced
    granite-3-8b run uninterrupted, the crashed run resumed, the reduced
    deepseek-moe-16b (the MoE backward), ``examples/train_lm_torch.py``
    and ``[baseline]``'s ``examples/quickstart_torch.py``.  Returns
    (processes, jobs)."""
    (crash,) = reap_modules(*crashed)
    out["crash_wall_s"] = crash[2]
    if f"injected failure at step {TRAIN_FAIL_AT}" not in crash[1]:
        fail(f"[train] the crashed run did not fail as planted: "
             f"{crash[1][-500:]}")
    jobs = [(*train_cli("whole"), 0),
            (*train_cli("crashed", "--ckpt-every", str(TRAIN_CKPT_EVERY)), 0),
            ("repro_torch.launch.train", ["--arch", MOE_ARCH, "--steps", "3"],
             0),
            (str(ROOT / "examples" / "train_lm_torch.py"),
             ["--steps", str(TRAIN_TWIN_STEPS)], 0),
            (str(ROOT / "examples" / "quickstart_torch.py"), [], 0)]
    return start_modules(jobs), jobs


def train_launcher_checks(out: dict, started) -> None:
    """Reaps :func:`train_launcher_start`'s processes: the crashed run
    resumed (its final params equal to the uninterrupted run's bit for
    bit), the MoE run done, the train twin's final loss below its first,
    the quickstart twin's device engine equal to the host's."""
    import numpy as np
    from repro_torch.checkpoint import restore_checkpoint
    whole, resume, moe_run, twin, quick = reap_modules(*started)
    lines = quick[0].strip().splitlines()
    log(f"[baseline] examples/quickstart_torch.py (in [train]'s batch, "
        f"{quick[2]:.1f} s): " + " | ".join(lines))
    if not lines or not lines[-1].startswith(
            "device engine agrees: True (engine: torch:cuda"):
        fail(f"[baseline] the quickstart twin failed: {quick[1][-2000:]}")
    out["quickstart_s"] = quick[2]
    want = restore_checkpoint(str(TRAIN_CLI_DIR / "whole"))
    got = restore_checkpoint(str(TRAIN_CLI_DIR / "crashed"))
    equal = (want["step"] == got["step"] == TRAIN_CLI_STEPS
             and set(want["tree"]) == set(got["tree"])
             and all(np.array_equal(got["tree"][k], v)
                     for k, v in want["tree"].items()))
    moe_line = moe_run[0].strip().splitlines()[-1:] or [""]
    out["launcher"] = dict(
        wall_s={"whole": whole[2], "crash": out.pop("crash_wall_s"),
                "resume": resume[2],
                MOE_ARCH: moe_run[2], "example": twin[2]},
        resume_bitwise_equal=equal, moe_stdout=moe_line[0])
    log(f"[train] crash at step {TRAIN_FAIL_AT} (checkpoints every "
        f"{TRAIN_CKPT_EVERY}), resumed to step {TRAIN_CLI_STEPS}: params, "
        f"moments and count bitwise equal to the uninterrupted run's: "
        f"{equal}")
    if not equal:
        fail("[train] the resumed run's params differ from the "
             "uninterrupted run's on the card")
    if not moe_line[0].startswith("done at step 3 on cuda"):
        fail(f"[train] the deepseek-moe-16b launcher run: {moe_line[0]!r}")
    last = twin[0].strip().splitlines()[-1]
    m = re.match(r"first loss ([\d.]+); finished at step (\d+): "
                 r"loss=([\d.]+)", last)
    if m is None or not float(m.group(3)) < float(m.group(1)):
        fail(f"[train] the example twin did not lower its loss: {last!r}")
    out["example"] = dict(first_loss=float(m.group(1)),
                          final_loss=float(m.group(3)))


def train_small_vs_cpu(out: dict) -> None:
    """The reduced granite-3-8b and deepseek-moe-16b configs, f32 with TF32
    off, trained :data:`TRAIN_SMALL_STEPS` steps of ``launch.steps``' step
    on the card and on the CPU from the same params and batches: losses
    and final params within :data:`LM_SMALL_TOL`."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.optim import adamw_init, tree_leaves
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in (TRAIN_ARCH, MOE_ARCH):
            spec = configs.get(arch)
            spec = dataclasses.replace(spec, reduced=dataclasses.replace(
                spec.reduced, dtype=torch.float32))
            ts = steps.lm_train_cell(spec, spec.cells["train_4k"],
                                     reduced=True)
            gen = torch.Generator()
            gen.manual_seed(1)
            cpu_p = tr.init_params(gen, ts.cfg, "cpu")
            card_p = to_card(cpu_p)
            cpu_o, card_o = adamw_init(cpu_p), adamw_init(card_p)
            pipe = LMDataPipeline(vocab=ts.cfg.vocab, batch=ts.batch,
                                  seq_len=ts.seq_len)
            losses = []
            for _ in range(TRAIN_SMALL_STEPS):
                batch = pipe.next_batch()
                cpu_p, cpu_o, cm = ts.step_fn(cpu_p, cpu_o, batch)
                card_p, card_o, gm = ts.step_fn(card_p, card_o, batch)
                losses.append((float(gm["loss"]), float(cm["loss"])))
            err_loss = max(abs(a - b) for a, b in losses)
            err_p = max(float((a.detach().cpu() - b.detach()).abs().max())
                        for a, b in zip(tree_leaves(card_p),
                                        tree_leaves(cpu_p)))
            ok = all(abs(a - b) <= LM_SMALL_TOL["atol"]
                     + LM_SMALL_TOL["rtol"] * abs(b) for a, b in losses) \
                and all(torch.allclose(a.detach().cpu(), b.detach(),
                                       **LM_SMALL_TOL)
                        for a, b in zip(tree_leaves(card_p),
                                        tree_leaves(cpu_p)))
            out[f"reduced {arch}"] = dict(losses=losses, err_loss=err_loss,
                                          err_params=err_p)
            log(f"[train] reduced {arch} f32, {TRAIN_SMALL_STEPS} steps on "
                f"the card vs the CPU: losses {[round(a, 5) for a, _ in losses]}"
                f", |loss| {err_loss:.2e}, |params| {err_p:.2e}")
            if not ok:
                fail(f"[train] reduced {arch}: the card's training differs "
                     f"from the CPU's beyond {LM_SMALL_TOL}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def train_one_rank_check(spec, cell, ts, params, batch, out) -> None:
    """``grads_fn``'s loss and grads of the 8-layer step on the 1-rank
    NCCL mesh (the sharded code path: the vocab-parallel cross-entropy,
    the masked embedding; its collectives the identity) against the
    unsharded cell's on the same params and batch."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.optim import tree_leaves
    from repro_torch.sharding import spmd
    mesh = one_rank_mesh()
    sharded = steps.lm_train_cell(spec, cell, mesh, microbatches=TRAIN_MICRO)
    t0 = time.perf_counter()
    loss_u, g_u = ts.grads_fn(params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    local = spmd.shard_tree(params, sharded.in_specs[0], mesh)
    lb = spmd.shard_tree({k: torch.as_tensor(v, device="cuda")
                          for k, v in batch.items()}, sharded.in_specs[2],
                         mesh)
    loss_s, g_s = sharded.grads_fn(local, lb)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pairs = list(zip(tree_leaves(g_s), tree_leaves(g_u)))
    bitwise = torch.equal(loss_s, loss_u) and all(torch.equal(a, b)
                                                  for a, b in pairs)
    rel_loss = abs(float(loss_s) / float(loss_u) - 1)
    rel_grad = max(max_rel(a, b) for a, b in pairs)
    out["one_rank_mesh"] = dict(bitwise_equal=bitwise, rel_loss=rel_loss,
                                max_rel_grad=rel_grad, unsharded_s=t1 - t0,
                                sharded_s=t2 - t1)
    log(f"[train] {TRAIN_ARCH} {TRAIN_LAYERS} layers, batch {ts.batch} in "
        f"{TRAIN_MICRO} microbatches on the 1-rank NCCL mesh: grads_fn's "
        f"loss and {len(pairs)} grad leaves equal to the unsharded cell's to "
        f"the bit: {bitwise} (loss rel {rel_loss:.2e}, largest grad gap "
        f"{rel_grad:.2e} of its leaf's largest magnitude; bound "
        f"{ONE_RANK_REL}: the vocab-parallel log-sum-exp is ATen's "
        f"arithmetic, so equal bits are expected); {t2 - t1:.2f} s sharded, "
        f"{t1 - t0:.2f} s unsharded")
    if not (rel_loss <= ONE_RANK_REL and rel_grad <= ONE_RANK_REL):
        fail("[train] the 1-rank mesh's loss or grads differ from the "
             "unsharded step")


def train_shard_reference(spec, cell, params) -> None:
    """The unsharded step of the first :data:`TRAIN_SHARD_LAYERS` layers
    of ``params`` at seq 4,096 and B = :data:`TRAIN_SHARD_BATCH`, one
    microbatch: the loss and grad norm that ``[shard]``'s FSDP ranks are
    held to, saved with its batch."""
    import dataclasses
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch import steps
    from repro_torch.optim import adamw_init, tree_leaves, tree_unflatten
    spec2 = dataclasses.replace(spec, full=dataclasses.replace(
        spec.full, n_layers=TRAIN_SHARD_LAYERS))
    cell2 = dataclasses.replace(cell, dims=dict(
        cell.dims, global_batch=TRAIN_SHARD_BATCH))
    ts2 = steps.lm_train_cell(spec2, cell2, microbatches=1)
    cut = cut_layers(params, TRAIN_SHARD_LAYERS)
    cut = tree_unflatten(cut, [w.detach().clone() for w in tree_leaves(cut)])
    batch = LMDataPipeline(vocab=ts2.cfg.vocab, batch=ts2.batch,
                           seq_len=ts2.seq_len).next_batch()
    _, _, m = ts2.step_fn(cut, adamw_init(cut), batch)
    save_shard_ref("train", loss=m["loss"], grad_norm=m["grad_norm"],
                   **batch)


def train_phase(header: str, crashed) -> dict:
    """``[train]``: granite-3-8b at its published widths, 8 layers, 3 steps
    at seq 4,096 through ``TrainLoop`` and ``launch.steps``: step time,
    tokens/s, peak memory and the busy share of one profiled step; loss,
    grad norm and lr finite, step 0's bf16 loss and grad norm within
    :data:`TRAIN_REL` of an f32 pass, and the 2-layer step that
    ``[shard]`` is held to (:func:`train_shard_reference`); then the
    launcher's runs, resume of the crashed run (``crashed``:
    :func:`train_crash_start`) and the example twins
    (:func:`train_launcher_checks`), in fresh processes started before the
    card checks the trained params' loss and grads on the 1-rank NCCL
    mesh (:func:`train_one_rank_check`) and the reduced configs against
    the CPU (:func:`train_small_vs_cpu`)."""
    import dataclasses
    import math
    import torch
    from repro_torch import configs
    from repro_torch.data import LMDataPipeline
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.optim import adamw_init, global_norm
    from repro_torch.runtime import TrainLoop, TrainLoopConfig
    torch.cuda.empty_cache()
    spec = configs.get(TRAIN_ARCH)
    spec = dataclasses.replace(spec, full=dataclasses.replace(
        spec.full, n_layers=TRAIN_LAYERS))
    cell = spec.cells["train_4k"]
    cell = dataclasses.replace(cell, dims=dict(cell.dims,
                                               global_batch=TRAIN_BATCH))
    ts = steps.lm_train_cell(spec, cell, microbatches=TRAIN_MICRO)
    cfg = ts.cfg
    B, S, M = ts.batch, ts.seq_len, ts.microbatches
    out = {"arch": TRAIN_ARCH, "cut": f"{TRAIN_LAYERS} of "
           f"{configs.get(TRAIN_ARCH).full.n_layers} layers",
           "num_params": cfg.num_params(), "batch": B, "seq_len": S,
           "microbatches": M, "remat": cfg.remat}
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    params = tr.init_params(gen, cfg, "cuda")
    opt = adamw_init(params)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    pipe_kw = dict(vocab=cfg.vocab, batch=B, seq_len=S)
    # the f32 pass on step 0's params and batch, before any update
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        loss32, g32 = steps.loss_and_grads(
            params, LMDataPipeline(**pipe_kw).next_batch(),
            dataclasses.replace(cfg, dtype=torch.float32), M)
        f32 = {"loss": float(loss32), "grad_norm": float(global_norm(g32)),
               "s": time.perf_counter() - t0}
        del g32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    train_shard_reference(spec, cell, params)
    torch.cuda.empty_cache()
    metrics, times = [], []

    def timed_step(p, o, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = ts.step_fn(p, o, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        return p, o, m

    pipe = LMDataPipeline(**pipe_kw)
    loop = TrainLoop(TrainLoopConfig(total_steps=TRAIN_STEPS), timed_step,
                     params, opt, pipe)
    loop.run()
    peak = torch.cuda.max_memory_allocated() - held
    busy = device_busy(f"{TRAIN_ARCH} train step", lambda: ts.step_fn(
        loop.params, loop.opt_state, pipe.next_batch()), tag="[train]")
    busy.pop("result")
    log("[train] top device kernels of the profiled step: " + ", ".join(
        f"{name[:60]} {sec:.4f} s" for name, sec in busy["top_kernels"]))
    rel = {k: abs(metrics[0][k] / f32[k] - 1) for k in TRAIN_REL}
    finite = all(math.isfinite(v) for m in metrics for v in m.values())
    out.update(step_s=times, tokens_per_s=[B * S / t for t in times],
               metrics=metrics, f32_step0=f32, rel_bf16_vs_f32=rel,
               bound=TRAIN_REL, peak_bytes=peak, busy=busy)
    log(f"[train] {TRAIN_ARCH} full width cut to {TRAIN_LAYERS} of "
        f"{configs.get(TRAIN_ARCH).full.n_layers} layers (d={cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff={cfg.d_ff}, padded vocab "
        f"{cfg.padded_vocab}; {cfg.num_params():,} params, init "
        f"{out['init_s']:.2f} s), seq {S}, batch {B} in {M} microbatches, "
        f"remat {cfg.remat}: {TRAIN_STEPS} steps of "
        + ", ".join(f"{t:.3f} s" for t in times)
        + f" ({B * S / times[-1]:.0f} tokens/s at the last); peak "
        f"{peak / 2**30:.2f} GiB; {header}")
    log("[train] metrics: " + "; ".join(
        f"step {i}: loss {m['loss']:.5f} grad norm {m['grad_norm']:.5f} lr "
        f"{m['lr']:.3e}" for i, m in enumerate(metrics))
        + f"; f32 pass on step 0: loss {f32['loss']:.5f} grad norm "
        f"{f32['grad_norm']:.5f} ({f32['s']:.1f} s); bf16 vs f32 relative: "
        f"loss {rel['loss']:.2e}, grad norm {rel['grad_norm']:.2e} (bounds "
        f"{TRAIN_REL})")
    if not finite:
        fail("[train] a loss, grad norm or lr is not finite")
    if not all(rel[k] <= TRAIN_REL[k] for k in TRAIN_REL):
        fail(f"[train] step 0 in bf16 departs from the f32 pass: {rel}")
    # the fresh processes run while the card checks the 1-rank mesh (on the
    # trained params) and the reduced configs
    started = train_launcher_start(crashed, out)
    try:
        train_one_rank_check(spec, cell, ts, loop.params, pipe.next_batch(),
                             out)
        del loop, params, opt
        torch.cuda.empty_cache()
        train_small_vs_cpu(out)
        train_launcher_checks(out, started)
    finally:
        kill_modules(started[0])
    return out



# [gnn train]: every GNN arch at its published widths on the cell shapes
# that the reference's _gnn_batch_abs pads to 512, through launch.train's
# build (params by the reference launcher's rule, batches from its GNN
# pipeline) and TrainLoop.  gin-tu runs the slice's full-size path,
# ogb_products (N = 2,449,408, E = 61,859,328, d_feat 100, 47 classes);
# meshgraphnet runs minibatch_lg (its edge MLP's input at ogb_products
# would be E x 384 x 4 B = 95 GB), egnn and nequip molecule (128 graphs).
GNN_FULL = (("gin-tu", "ogb_products", 2), ("meshgraphnet", "minibatch_lg", 3),
            ("egnn", "molecule", 3), ("nequip", "molecule", 3))
# the reduced configs through launch.train, card against CPU
GNN_SMALL_ARCHS = ("gin-tu", "meshgraphnet", "egnn", "nequip", "dcn-v2")
GNN_SMALL_STEPS = 5
# f32 segment sums against f64, relative to the sum of the magnitudes
# (a sum of n terms in f32 is off by at most about n * 6e-8 of it)
SCATTER_REL = 1e-5
# the reference tests' tolerances (tests/test_equivariance.py)
EQUIV_TOL = {"nequip energy": dict(rtol=2e-3, atol=2e-3),
             "egnn out": dict(rtol=1e-4, atol=1e-4),
             "egnn x": dict(rtol=1e-3, atol=1e-4)}
GNN_TWIN_STEPS = 200


class TimedPipe:
    """A pipeline whose draws are timed apart from the steps; keeps the
    last batch.  With ``prefetch=n`` one background thread draws the
    next ``n`` batches in order from the start (numpy releases the GIL
    in its bulk draws), so the host's draws overlap earlier work on the
    card; ``draw_s`` is then each draw's own time in that thread."""

    def __init__(self, pipe, prefetch: int = 0):
        self.pipe, self.draw_s, self.last = pipe, [], None
        self.background = bool(prefetch)
        self._futures = []
        if prefetch:
            import concurrent.futures
            pool = concurrent.futures.ThreadPoolExecutor(1)
            self._futures = [pool.submit(self._draw)
                             for _ in range(prefetch)]
            pool.shutdown(wait=False)

    def _draw(self):
        t0 = time.perf_counter()
        batch = self.pipe.next_batch()
        self.draw_s.append(time.perf_counter() - t0)
        return batch

    def next_batch(self):
        self.last = (self._futures.pop(0).result() if self._futures
                     else self._draw())
        return self.last


def clone_tree(tree):
    from repro_torch.optim import tree_leaves, tree_unflatten
    return tree_unflatten(tree, [x.detach().clone()
                                 for x in tree_leaves(tree)])


def build_full(arch: str, shape: str, prefetch: int = 0) -> tuple:
    """``launch.train.build`` of ``arch``'s train cell ``shape`` at its
    published widths on the card: (step_fn, params, TimedPipe, init s),
    the pipeline drawing ``prefetch`` batches ahead in the background."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import train
    t0 = time.perf_counter()
    step_fn, params, pipe = train.build(configs.get(arch), shape, False,
                                        "cuda")
    torch.cuda.synchronize()
    return step_fn, params, TimedPipe(pipe, prefetch), \
        time.perf_counter() - t0


def full_train_run(arch: str, shape: str, n_steps: int, tag: str,
                   built=None) -> tuple:
    """``n_steps`` of ``arch``'s train cell ``shape`` at its published
    widths through ``launch.train.build`` (or ``built``, its
    :func:`build_full`) and ``TrainLoop`` on the card: draw s, step s
    (the batch's copy to the card in), peak memory, the metrics finite.
    Returns (numbers, loop, step_fn, last batch)."""
    import math
    import torch
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import TrainLoop, TrainLoopConfig
    torch.cuda.empty_cache()
    step_fn, params, pipe, init_s = built or build_full(arch, shape)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    metrics, times = [], []

    def timed_step(p, o, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step_fn(p, o, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        return p, o, m

    loop = TrainLoop(TrainLoopConfig(total_steps=n_steps), timed_step,
                     params, adamw_init(params), pipe)
    loop.run()
    peak = torch.cuda.max_memory_allocated() - held
    n_params = params_bytes(loop.params) // 4
    out = dict(arch=arch, shape=shape, init_s=init_s, n_params=n_params,
               draw_s=pipe.draw_s, step_s=times, peak_bytes=peak,
               metrics=metrics)
    batch = pipe.last
    if "edges" in batch:
        E = batch["edges"].shape[1]
        out.update(n_nodes=pipe.pipe.n_nodes, n_edges=E,
                   edges_per_s=[E / t for t in times])
        rate = f"{E / times[-1]:.3e} edges/s at the last"
        size = f"N={pipe.pipe.n_nodes:,} E={E:,}"
    else:
        B = batch["dense"].shape[0]
        out.update(batch=B, examples_per_s=[B / t for t in times])
        rate = f"{B / times[-1]:.3e} examples/s at the last"
        size = f"B={B:,}"
    log(f"{tag} {arch} full width on {shape} ({size}, {n_params:,} params, "
        f"init {init_s:.2f} s): draws"
        + (" (in the background)" if pipe.background else "") + " "
        + ", ".join(f"{d:.2f} s" for d in pipe.draw_s) + "; steps "
        + ", ".join(f"{t:.3f} s" for t in times) + f" ({rate}); peak "
        f"{peak / 2**30:.2f} GiB; metrics " + "; ".join(
            f"loss {m['loss']:.6g} grad norm {m['grad_norm']:.6g}"
            for m in metrics))
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        fail(f"{tag} {arch}: a loss, grad norm or lr is not finite")
    return out, loop, step_fn, batch


def repeat_bitwise(loop, step_fn, batch, name: str, tag: str) -> dict:
    """One step from the loop's state run twice on ``batch`` (the first
    under the profiler: the device's busy share): params, moments, loss
    and grad norm equal bit for bit."""
    from repro_torch.optim import tree_leaves
    runs = []
    for i in range(2):
        p, o = clone_tree(loop.params), clone_tree(loop.opt_state)
        if i == 0:
            busy = device_busy(f"{name} step", lambda: step_fn(p, o, batch),
                               tag=tag)
            m = busy.pop("result")[2]
        else:
            m = step_fn(p, o, batch)[2]
        runs.append((tree_leaves((p, o)), m))
    (a, ma), (b, mb) = runs
    equal = (len(a) == len(b) and all(torch_equal(x, y) for x, y in
                                      zip(a, b))
             and all(torch_equal(ma[k], mb[k]) for k in ("loss",
                                                          "grad_norm")))
    log(f"{tag} {name}: two runs of one step on the card, params, moments, "
        f"loss and grad norm bitwise equal: {equal}")
    log(f"{tag} top device kernels of the profiled step: " + ", ".join(
        f"{n[:60]} {sec:.4f} s" for n, sec in busy["top_kernels"]))
    if not equal:
        fail(f"{tag} {name}: two runs of one step differ on the card")
    return dict(bitwise_equal=equal, busy=busy)


def torch_equal(a, b) -> bool:
    import torch
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def scatter_check(batch, n_nodes: int, tag: str) -> dict:
    """GIN's aggregation at full size (``propagate``, the fused
    ``scatter_sum(h[src] * mask, dst)``) on 16 columns of the batch's
    features, in f32 against the same sum in f64, relative to the f64
    sum of the magnitudes; and ``gnn.scatter_sum`` on the materialised
    messages, which adds in the same order, equal to it bit for bit."""
    import numpy as np
    import torch
    from repro_torch.models import gnn
    from repro_torch.models.scatter import edge_index, propagate
    t0 = time.perf_counter()
    edges = torch.as_tensor(batch["edges"], device="cuda")
    ei = edge_index(edges, n_nodes)
    w = torch.as_tensor(batch["edge_mask"], device="cuda").index_select(
        0, ei.perm)
    h = torch.as_tensor(np.ascontiguousarray(batch["nodes"][:, :16]),
                        device="cuda")
    with torch.no_grad():
        got = propagate(h, w, ei)
        want = propagate(h.double(), w.double(), ei)
        mag = propagate(h.double().abs(), w.double().abs(), ei)
        rel = float(((got.double() - want).abs()
                     / mag.clamp_min(1e-300)).max())
        del want, mag
        msg = h[edges[0].long()] * torch.as_tensor(
            batch["edge_mask"], device="cuda")[:, None]
        same = torch.equal(gnn.scatter_sum(msg, edges[1], n_nodes), got)
    torch.cuda.synchronize()
    out = dict(rel_err=rel, bound=SCATTER_REL, scatter_sum_equal=same,
               s=time.perf_counter() - t0)
    log(f"{tag} gin-tu aggregation at full size (E={edges.shape[1]:,}, 16 "
        f"columns): f32 against f64 {rel:.2e} of the summed magnitudes "
        f"(bound {SCATTER_REL}); scatter_sum on the messages bitwise equal: "
        f"{same} ({out['s']:.1f} s)")
    if not (rel <= SCATTER_REL and same):
        fail(f"{tag} the full-size segment sum is off: {out}")
    return out


def equivariance_checks(tag: str) -> dict:
    """On a ``GraphBatcher`` batch of the molecule cell's shape (128
    graphs of 30 nodes and 64 edges), f32 with TF32 off: the full-width
    NequIP energy invariant under a random rotation, and the full-width
    EGNN's output invariant and its coordinates co-rotating, within the
    reference tests' tolerances (:data:`EQUIV_TOL`)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data import GraphBatcher
    from repro_torch.models import equivariant as eqv
    from repro_torch.models import gnn
    d = configs.get("egnn").cells["molecule"].dims
    b = GraphBatcher(n_nodes=d["n_nodes"], n_edges=d["n_edges"],
                     batch=d["batch"], d_feat=d["d_feat"], seed=0).next_batch()
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    Q = torch.as_tensor(q.astype(np.float32), device="cuda")
    t = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ncfg = configs.get("nequip").full
    species = torch.nn.functional.one_hot(
        torch.argmax(t["nodes"][:, :ncfg.n_species], -1),
        ncfg.n_species).float()
    ecfg = dataclasses.replace(configs.get("egnn").full, d_in=d["d_feat"],
                               d_out=1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            npar = eqv.init_nequip(gen, ncfg, "cuda")
            e1, e2 = (eqv.nequip_forward(npar, species, pos, t["edges"],
                                         t["edge_mask"], ncfg,
                                         t["graph_ids"], d["batch"])
                      for pos in (t["pos"], t["pos"] @ Q.T))
            epar = gnn.init_egnn(gen, ecfg, "cuda")
            (o1, x1), (o2, x2) = (gnn.egnn_forward(
                epar, t["nodes"], pos, t["edges"], t["edge_mask"], ecfg,
                t["graph_ids"], d["batch"]) for pos in (t["pos"],
                                                       t["pos"] @ Q.T))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    pairs = {"nequip energy": (e2, e1), "egnn out": (o2, o1),
             "egnn x": (x2, x1 @ Q.T)}
    out = {}
    for name, (got, want) in pairs.items():
        ok = torch.allclose(got, want, **EQUIV_TOL[name])
        out[name] = dict(max_abs=float((got - want).abs().max()),
                         max_value=float(want.abs().max()), ok=ok)
    log(f"{tag} equivariance on a GraphBatcher batch (N={t['pos'].shape[0]}, "
        f"E={t['edges'].shape[1]}, 128 graphs), full widths, f32: "
        + "; ".join(f"{n} |rotated - rotated back| {v['max_abs']:.2e} "
                    f"(largest |value| {v['max_value']:.2e}; tolerance "
                    f"{EQUIV_TOL[n]})" for n, v in out.items()))
    if not all(v["ok"] for v in out.values()):
        fail(f"{tag} an equivariance check failed: {out}")
    return out


def small_vs_cpu(tag: str) -> dict:
    """The reduced configs of :data:`GNN_SMALL_ARCHS` through
    ``launch.train``: ``main`` in this process on the card
    (:data:`GNN_SMALL_STEPS` steps, its last line), and ``build``'s
    params and batches trained the same steps on the card and on the CPU
    (TF32 off; the CPU's draws copied to the card, as the two devices'
    generators draw differently): losses, params and moments within
    :data:`LM_SMALL_TOL`."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.optim import adamw_init, tree_leaves
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for arch in GNN_SMALL_ARCHS:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = train.main(["--arch", arch, "--steps",
                                 str(GNN_SMALL_STEPS)])
            line = buf.getvalue().strip().splitlines()[-1]
            if rc != 0 or not line.startswith(
                    f"done at step {GNN_SMALL_STEPS} on cuda"):
                fail(f"{tag} launch.train {arch} on the card: {line!r}")
            spec = configs.get(arch)
            shape = next(n for n, c in spec.cells.items()
                         if c.kind == "train")
            step, cpu_p, pipe = train.build(spec, shape, True, "cpu")
            card_p = to_card(cpu_p)
            cpu_o, card_o = adamw_init(cpu_p), adamw_init(card_p)
            losses = []
            for _ in range(GNN_SMALL_STEPS):
                batch = pipe.next_batch()
                cpu_p, cpu_o, cm = step(cpu_p, cpu_o, batch)
                card_p, card_o, gm = step(card_p, card_o, batch)
                losses.append((float(gm["loss"]), float(cm["loss"])))
            pairs = list(zip(tree_leaves((card_p, card_o)),
                             tree_leaves((cpu_p, cpu_o))))
            err = max(float((a.detach().cpu().double()
                             - b.detach().double()).abs().max())
                      for a, b in pairs)
            ok = all(abs(a - b) <= LM_SMALL_TOL["atol"]
                     + LM_SMALL_TOL["rtol"] * abs(b) for a, b in losses) \
                and all(torch.allclose(a.detach().cpu().double(),
                                       b.detach().double(), **LM_SMALL_TOL)
                        for a, b in pairs)
            out[arch] = dict(launcher=line, losses=losses,
                             err_loss=max(abs(a - b) for a, b in losses),
                             err_params=err)
            log(f"{tag} reduced {arch}: launch.train on the card: {line}; "
                f"{GNN_SMALL_STEPS} steps on the card vs the CPU from the "
                f"same draws: losses {[round(a, 6) for a, _ in losses]}, "
                f"|loss| {out[arch]['err_loss']:.2e}, |params, moments| "
                f"{err:.2e}")
            if not ok:
                fail(f"{tag} reduced {arch}: the card's training differs "
                     f"from the CPU's beyond {LM_SMALL_TOL}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def gnn_twin(tag: str) -> dict:
    """``examples/gnn_clique_features_torch.py`` in this process on the
    card: its clique features (the list kernel, k = 3 and 4) and labels
    (k = 8) equal to the host recursion's, the list kernel launched and no
    plain version run, and the GIN at the reference's accuracy bar."""
    import importlib.util
    import numpy as np
    from repro_torch.core import ebbkc
    from repro_torch.kernels import ops
    spec = importlib.util.spec_from_file_location(
        "gnn_clique_features_torch",
        ROOT / "examples" / "gnn_clique_features_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ops.reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = mod.main(["--steps", str(GNN_TWIN_STEPS)])
    wall = time.perf_counter() - t0
    launches, plain = ops.launch_counts(), ops.plain_counts()
    g = res["graph"]
    host = mod.clique_features(g, backend="host")
    labels = np.zeros(g.n, np.int32)
    for row in ebbkc.list_cliques(g, 8, backend="host")[0]:
        labels[row] = 1
    same = (np.array_equal(res["features"], host)
            and np.array_equal(res["labels"], labels))
    log(f"{tag} examples/gnn_clique_features_torch.py ({wall:.1f} s): "
        + " | ".join(buf.getvalue().strip().splitlines()[-3:])
        + f"; clique features and labels equal the host listing's: {same}; "
        f"launches {launches}, plain-version calls {plain}")
    if not same:
        fail(f"{tag} the twin's clique features differ from the host's")
    if not launches["clique_list_tiles"] or sum(plain.values()):
        fail(f"{tag} the twin's listing did not run on the list kernel: "
             f"{launches} {plain}")
    return dict(acc=res["acc"], wall_s=wall, launches=launches,
                features_equal_host=same)


def gnn_prefetch() -> dict:
    """Each :data:`GNN_FULL` run built (:func:`build_full`), its batches
    drawn in the background from now on: the host's numpy draws (about
    28 s, two ogb_products batches of 9-10 s each) overlap the phases
    before ``[gnn train]``."""
    return {arch: build_full(arch, shape, prefetch=n)
            for arch, shape, n in GNN_FULL}


def gnn_phase(header: str, built: dict) -> dict:
    """``[gnn train]``: :data:`GNN_FULL` at full width (each arch's two
    runs of one step bitwise and its busy share; gin-tu's aggregation
    against f64) from ``built`` (:func:`gnn_prefetch`), the equivariance
    checks, the reduced archs against the CPU and the example twin."""
    tag = "[gnn train]"
    out = {}
    for arch, shape, n in GNN_FULL:
        run, loop, step_fn, batch = full_train_run(arch, shape, n, tag,
                                                   built.pop(arch))
        run.update(repeat_bitwise(loop, step_fn, batch, arch, tag))
        if arch == "gin-tu":
            run["scatter"] = scatter_check(batch, run["n_nodes"], tag)
            # for [shard]: the sharded step on the same params and batch
            out["_shard_inputs"] = (clone_tree(loop.params), batch)
        del loop
        out[arch] = run
        batch = None
    log(f"{tag} {header}")
    out["equivariance"] = equivariance_checks(tag)
    out["reduced"] = small_vs_cpu(tag)
    out["example"] = gnn_twin(tag)
    return out


# [recsys]: dcn-v2 at its published widths (26 x 1,000,000 x 16 table,
# 1.66 GB f32; 3 cross layers; MLP 1024-1024-512) on each of its cells.
RECSYS_ARCH = "dcn-v2"
RECSYS_TRAIN_STEPS = 3
RECSYS_SERVE_CALLS = 50
RECSYS_BULK_CALLS = 3
RECSYS_RETRIEVAL_CALLS = 5
RECSYS_TOL = dict(rtol=1e-5, atol=1e-5)


def timed_calls(fn, n: int) -> list:
    """Host seconds of ``n`` calls of ``fn``, each synchronised, after
    one warm call."""
    import torch
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def recsys_phase(header: str) -> dict:
    """``[recsys]``: dcn-v2 at full width: ``train_batch`` (B = 65,536)
    through ``launch.train.build`` and ``TrainLoop`` (step s, examples/s,
    two runs of one step bitwise), ``serve_p99`` (B = 512: p50 / p99 over
    50 calls, logits within :data:`RECSYS_TOL` of the CPU port on the same
    params), ``serve_bulk`` (B = 262,144: examples/s) and
    ``retrieval_cand`` (1 query against 1,000,000 candidates of width
    512: ms a call, the top 100 equal to a stable descending sort of the
    same scores); the peak memory of each."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data import RecsysPipeline
    from repro_torch.launch import steps
    from repro_torch.models import recsys as rec
    from repro_torch.models.common import apply_mlp
    tag = "[recsys]"
    spec = configs.get(RECSYS_ARCH)
    cfg = spec.full
    run, loop, step_fn, batch = full_train_run(RECSYS_ARCH, "train_batch",
                                               RECSYS_TRAIN_STEPS, tag)
    run.update(repeat_bitwise(loop, step_fn, batch, RECSYS_ARCH, tag))
    params = loop.params
    del loop
    # for [shard]: the trained params
    out = {"train_batch": run, "_shard_inputs": params}
    torch.cuda.empty_cache()

    def inputs(B, seed):
        b = RecsysPipeline(n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
                           vocab=cfg.vocab, batch=B, bag=cfg.bag,
                           seed=seed).next_batch()
        return b["dense"], b["sparse"]

    for shape, calls in (("serve_p99", RECSYS_SERVE_CALLS),
                         ("serve_bulk", RECSYS_BULK_CALLS)):
        mc = steps.recsys_cell(spec, spec.cells[shape])
        B = mc.meta["batch"]
        dense, sparse = inputs(B, 1)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        times = timed_calls(lambda: mc.step_fn(params, dense, sparse), calls)
        peak = torch.cuda.max_memory_allocated() - held
        q = np.percentile(np.asarray(times) * 1e3, [50, 99])
        r = dict(batch=B, calls=calls, ms=[1e3 * x for x in times],
                 p50_ms=float(q[0]), p99_ms=float(q[1]),
                 examples_per_s=B / statistics.median(times),
                 peak_bytes=peak)
        if shape == "serve_p99":
            cpu = to_cpu(params)
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                got = mc.step_fn(params, dense, sparse).cpu()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
            want = mc.step_fn(cpu, dense, sparse)
            del cpu
            r["err_vs_cpu"] = float((got - want).abs().max())
            r["close_to_cpu"] = torch.allclose(got, want, **RECSYS_TOL)
        out[shape] = r
        log(f"{tag} {shape} (B={B:,}), {calls} calls: p50 {r['p50_ms']:.3f} "
            f"ms, p99 {r['p99_ms']:.3f} ms, {r['examples_per_s']:.3e} "
            f"examples/s at the median; peak {peak / 2**30:.2f} GiB"
            + (f"; logits against the CPU port (TF32 off) "
               f"{r['err_vs_cpu']:.2e} (tolerance {RECSYS_TOL})"
               if "err_vs_cpu" in r else ""))
        if "close_to_cpu" in r and not r["close_to_cpu"]:
            fail(f"{tag} serve logits on the card differ from the CPU's")

    mc = steps.recsys_cell(spec, spec.cells["retrieval_cand"])
    n_cand = mc.meta["n_candidates"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    cand = torch.randn((n_cand, cfg.mlp_dims[-1]), generator=gen,
                       device="cuda")
    dense, sparse = inputs(1, 2)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    times = timed_calls(lambda: mc.step_fn(params, dense, sparse, cand),
                        RECSYS_RETRIEVAL_CALLS)
    peak = torch.cuda.max_memory_allocated() - held
    vals, idx = mc.step_fn(params, dense, sparse, cand)
    with torch.no_grad():
        d, s = (torch.as_tensor(x, device="cuda") for x in (dense, sparse))
        offs = torch.arange(cfg.n_sparse, device="cuda") * cfg.vocab
        x0 = torch.cat([d, rec.embedding_bag(params["table"], s, offs)
                        .reshape(1, -1)], -1)
        scores = apply_mlp(params["mlp"], x0, act="relu",
                           final_act=True) @ cand.T
        sv, si = torch.sort(scores, dim=-1, descending=True, stable=True)
    same = torch.equal(idx, si[:, :100]) and torch.equal(vals, sv[:, :100])
    out["retrieval_cand"] = dict(
        n_candidates=n_cand, cand_bytes=cand.numel() * 4,
        ms=[1e3 * x for x in times],
        ms_median=1e3 * statistics.median(times), peak_bytes=peak,
        top100_equals_stable_sort=same,
        ties_in_top100=int((sv[0, 1:100] == sv[0, :99]).sum()))
    log(f"{tag} retrieval_cand (1 query, {n_cand:,} candidates of width "
        f"{cfg.mlp_dims[-1]}, {cand.numel() * 4 / 1e9:.2f} GB): "
        + ", ".join(f"{1e3 * x:.3f}" for x in times)
        + f" ms a call; peak {peak / 2**30:.2f} GiB; top 100 equal to a "
        f"stable descending sort of the same scores: {same}; {header}")
    if not same:
        fail(f"{tag} the retrieval top-100 differs from a stable sort")
    return out


# [shard]: the sharding substrate on the card.  The clique cells at their
# full sizes on a 1-rank NCCL mesh and ep_tri_1m on two ranks of the one
# card over gloo (NCCL refuses two ranks on one GPU), the GNN and recsys
# cells on the 1-rank mesh against their unsharded twins, and the int8
# compressed all-reduce.
SHARD_CELLS = (("ep_tri_1m", 0.2), ("ep_tri_128", 0.1))   # (cell, density)
SHARD_SLICE = 4096          # tiles of the kernel-vs-plain comparison
SHARD_CHUNK_BYTES = 1 << 30
SHARD_WORLD = 2
SHARD_GRAD_ELEMS = 100_000_000
SHARD_COMPRESS_REPS = 5


def shard_tiles(B: int, T: int, p: float, seed: int):
    """(B, T, T // 32) int32 words of symmetric adjacency tiles (density
    ``p``, no self loops) and (B, W) candidate words (each bit 0.8),
    drawn on the card from a generator seeded ``seed``, in chunks of
    about 1 GiB of floats."""
    import torch
    W = T // 32
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    weights = (torch.ones(32, dtype=torch.int64, device="cuda")
               << torch.arange(32, device="cuda"))

    def pack(bits):
        words = (bits.view(*bits.shape[:-1], W, 32).long() * weights).sum(-1)
        return words.to(torch.int32)   # the low 32 bits: the int32 view
    A = torch.empty((B, T, W), dtype=torch.int32, device="cuda")
    cand = torch.empty((B, W), dtype=torch.int32, device="cuda")
    step = max(1, SHARD_CHUNK_BYTES // (4 * T * T))
    upper = torch.ones((T, T), dtype=torch.bool, device="cuda").triu(1)
    for b0 in range(0, B, step):
        b = min(step, B - b0)
        r = torch.rand((b, T, T), generator=gen, device="cuda") < p
        r &= upper
        A[b0:b0 + b] = pack(r | r.transpose(1, 2))
        c = torch.rand((b, T), generator=gen, device="cuda") < 0.8
        cand[b0:b0 + b] = pack(c)
    return A, cand


def kernel_device_ms(fn) -> tuple:
    """(``fn``'s result, summed device ms of the triangle kernel's
    launches in one profiled call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "tri_" in e.name)
    return out, us / 1e3


def draw_blocks(cfg, kept_cfg, mesh, seed: int, prompts=None):
    """This rank's blocks of ``kept_cfg``'s params (the first
    ``kept_cfg.n_layers`` layers of ``cfg``'s draw) by their storage
    specs on ``mesh``, drawn as the unsharded run draws them (a card
    generator seeded ``seed``, every leaf whole, in order) and kept one
    leaf at a time; then ``prompts`` (a shape) ids from the same
    generator.  The ranks draw in turn, so one whole leaf is held at a
    time on the card."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.sharding import spmd
    specs = steps.lm_ctx(mesh, kept_cfg).param_specs
    n = kept_cfg.n_layers

    def keep(path, x):
        spec = specs
        for k in path:
            spec = spec[k]
        if path[0] == "groups":
            x = x[:n]
        return spmd.shard(x, spec, mesh).clone()

    params = ids = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed)
            params = tr.init_params(gen, cfg, "cuda", keep=keep)
            if prompts is not None:
                ids = torch.randint(0, cfg.vocab, prompts, generator=gen,
                                    device="cuda")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    return params, ids


def shard_serve_rank(name, cfg, kept_cfg, mesh, results) -> None:
    """Prefill and the teacher-forced decode steps of ``[lm serve]`` /
    ``[moe serve]``'s saved run on this rank's blocks; the logits are
    gathered from the vocab blocks and saved."""
    import numpy as np
    import torch
    from repro_torch.launch import steps
    from repro_torch.sharding import P, spmd
    ref = np.load(SHARD_LM_DIR / f"{name}.npz")
    t0 = time.perf_counter()
    params, prompts = draw_blocks(cfg, kept_cfg, mesh, 0,
                                  tuple(ref["prompts"].shape))
    draw_s = time.perf_counter() - t0
    forced = torch.from_numpy(ref["forced"]).cuda()
    ctx = steps.lm_ctx(mesh, kept_cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, logits = lm_forced(params, prompts, forced, kept_cfg, ctx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    results.update({
        f"{name}_last": spmd.unshard(last, P(None, "model"), mesh).cpu(),
        f"{name}_steps": spmd.unshard(logits, P(None, None, "model"),
                                      mesh).cpu(),
        f"{name}_prompts_equal": np.array_equal(prompts.cpu().numpy(),
                                                ref["prompts"]),
        f"{name}_wall": wall, f"{name}_draw_s": draw_s,
        f"{name}_bytes": params_bytes(params)})
    del params
    torch.cuda.empty_cache()


def replicated_equal(trees, specs, axis: str) -> bool:
    """Every leaf of ``trees`` whose spec does not split it over ``axis``
    bitwise equal on every rank: the SHA-256 digests of their bytes
    (copied to the host) compared across the ranks."""
    import torch.distributed as dist
    from repro_torch.optim import tree_leaves
    from repro_torch.sharding import spmd
    digest = hashlib.sha256()
    for tree in trees:
        for x, s in zip(tree_leaves(tree), spmd.spec_leaves(specs)):
            if not any(axis in spmd.part_axes(part) for part in s):
                digest.update(x.detach().contiguous().cpu().numpy()
                              .tobytes())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, digest.hexdigest())
    return len(set(every)) == 1


def shard_lm_rank(rank: int, world: int, out_dir: str) -> None:
    """The transformer's cases on ``world`` ranks of the card: tensor
    parallelism (granite-3-8b) and expert parallelism (deepseek-moe-16b,
    8 layers, f32) on (1, world), FSDP and data parallelism (the 2-layer
    granite-3-8b train step) on (world, 1); results saved."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import spmd
    results = {}
    t_lm = time.perf_counter()
    tp = make_local_mesh((1, world), device="cuda")
    cfg = configs.get(LM_ARCH).full
    shard_serve_rank("granite", cfg, cfg, tp, results)
    full = configs.get(MOE_ARCH).full
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        shard_serve_rank("moe", full, dataclasses.replace(
            full, n_layers=MOE_SHARD_LAYERS, dtype=torch.float32), tp,
            results)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    dp = make_local_mesh((world, 1), device="cuda")
    ref = np.load(SHARD_LM_DIR / "train.npz")
    spec = configs.get(TRAIN_ARCH)
    spec2 = dataclasses.replace(spec, full=dataclasses.replace(
        spec.full, n_layers=TRAIN_SHARD_LAYERS))
    cell = spec.cells["train_4k"]
    cell = dataclasses.replace(cell, dims=dict(
        cell.dims, global_batch=TRAIN_SHARD_BATCH))
    ts = steps.lm_train_cell(spec2, cell, dp, microbatches=1)
    t0 = time.perf_counter()
    params, _ = draw_blocks(dataclasses.replace(
        spec.full, n_layers=TRAIN_LAYERS), ts.cfg, dp, 1)
    results["train_draw_s"] = time.perf_counter() - t0
    batch = spmd.shard_tree({k: torch.from_numpy(ref[k]).cuda()
                             for k in ("tokens", "labels")}, ts.in_specs[2],
                            dp)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, m = ts.step_fn(params, opt, batch)
    torch.cuda.synchronize()
    results.update(
        train_wall=time.perf_counter() - t0, train_loss=float(m["loss"]),
        train_grad_norm=float(m["grad_norm"]),
        train_peak=torch.cuda.max_memory_allocated())
    t0 = time.perf_counter()
    results["train_replicated_equal"] = replicated_equal(
        (params, opt["mu"], opt["nu"]), ts.in_specs[0], "data")
    results["train_check_s"] = time.perf_counter() - t0
    results["lm_s"] = time.perf_counter() - t_lm
    np.savez(Path(out_dir) / f"rank{rank}_lm.npz", **{
        k: np.asarray(v) for k, v in results.items()})


def shard_clique_rank(rank: int, world: int, store: str, out_dir: str,
                      seed: int) -> None:
    """One of :data:`SHARD_WORLD` spawned ranks on the card: ``ep_tri_1m``
    on a (world, 1) mesh over gloo, its blocks and times saved; then the
    transformer's cases (:func:`shard_lm_rank`)."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core import engine_torch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding import spmd
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_local_mesh((world, 1), device="cuda")
        cell = steps.build_cell(configs.get("ebbkc"), "ep_tri_1m", mesh)
        m = cell.meta
        A, cand = shard_tiles(m["n_tiles"], m["T"], SHARD_CELLS[0][1], seed)
        ts, cs = cell.in_specs
        A_loc, c_loc = spmd.shard(A, ts, mesh), spmd.shard(cand, cs, mesh)
        del A, cand
        cell.step_fn(A_loc[:SHARD_SLICE], c_loc[:SHARD_SLICE])   # warm
        dist.barrier()
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        total, nv, t, f = cell.step_fn(A_loc, c_loc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()["triangle_count_tiles"]
        hard = engine_torch.count_packed(A_loc, c_loc, 3, method="mxu")[0]
        np.savez(Path(out_dir) / f"rank{rank}.npz", total=total.cpu(),
                 nv=nv.cpu(), t=t.cpu(), f=f.cpu(), hard=hard.cpu(),
                 wall=wall, launches=launches)
        del A_loc, c_loc, hard, total, nv, t, f
        torch.cuda.empty_cache()
        shard_lm_rank(rank, world, out_dir)
    finally:
        dist.destroy_process_group()


def shard_two_ranks(one_rank: dict, seed: int, tag: str) -> dict:
    """``ep_tri_1m`` on :data:`SHARD_WORLD` spawned ranks of the card:
    each rank's blocks against the 1-rank run's rows, the totals."""
    import numpy as np
    import shutil
    import torch.multiprocessing as mp
    out_dir = ROOT / "build" / "shard_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    mp.spawn(shard_clique_rank, nprocs=SHARD_WORLD, join=True,
             args=(SHARD_WORLD, str(out_dir / "store"), str(out_dir), seed))
    spawn_s = time.perf_counter() - t0
    ranks = [dict(np.load(out_dir / f"rank{r}.npz"))
             for r in range(SHARD_WORLD)]
    whole = {k: np.concatenate([r[k] for r in ranks])
             for k in ("nv", "t", "f", "hard")}
    same = all(np.array_equal(whole[k], one_rank[k])
               for k in ("nv", "t", "f", "hard"))
    totals = [float(r["total"]) for r in ranks]
    exact = int(whole["hard"].astype(np.int64).sum())
    out = dict(world=SHARD_WORLD, spawn_s=spawn_s,
               wall_s=[float(r["wall"]) for r in ranks],
               launches=[int(r["launches"]) for r in ranks],
               totals=totals, exact_total=exact,
               blocks_equal_one_rank=same,
               total_gap_vs_one_rank=abs(totals[0] - one_rank["total"]))
    log(f"{tag} ep_tri_1m on {SHARD_WORLD} ranks of the card over gloo: "
        f"per-tile hard, nv, t, f of the gathered blocks equal to the "
        f"1-rank run: {same}; step wall "
        + ", ".join(f"{w:.4f}" for w in out["wall_s"])
        + f" s; kernel launches {out['launches']}; f32 totals {totals} "
        f"against the 1-rank f32 {one_rank['total']:.1f} and the exact "
        f"int64 {exact} (1-rank {one_rank['exact']}); spawn, build load "
        f"and tiles {spawn_s:.1f} s")
    if not same or exact != one_rank["exact"] or len(set(totals)) != 1:
        fail(f"{tag} the {SHARD_WORLD}-rank clique cell differs from the "
             "1-rank run")
    if abs(totals[0] - exact) > 2 ** -23 * exact * 4:
        fail(f"{tag} the {SHARD_WORLD}-rank f32 total is off its rounding")
    out["lm"] = shard_lm_results(out_dir, tag)
    return out


def shard_lm_results(out_dir, tag: str) -> dict:
    """The ranks' transformer cases against the unsharded runs saved by
    ``[lm serve]``, ``[moe serve]`` and ``[train]``."""
    import numpy as np
    from repro_torch import configs
    ranks = [dict(np.load(Path(out_dir) / f"rank{r}_lm.npz"))
             for r in range(SHARD_WORLD)]
    r0 = ranks[0]
    out = {}
    lm, moe = configs.get(LM_ARCH).full, configs.get(MOE_ARCH).full
    for name, arch, what in (
            ("granite", LM_ARCH, f"full width and depth, (1, {SHARD_WORLD}):"
             f" tensor parallelism, {lm.n_kv_heads} kv heads over "
             f"{SHARD_WORLD}, bf16"),
            ("moe", MOE_ARCH, f"full width, {MOE_SHARD_LAYERS} of "
             f"{moe.n_layers} layers, (1, {SHARD_WORLD}): expert parallelism,"
             f" {moe.moe.n_experts // SHARD_WORLD} experts a rank, f32 (TF32 "
             f"off)")):
        ref = np.load(SHARD_LM_DIR / f"{name}.npz")
        errs = dict(prefill=float(np.abs(r0[f"{name}_last"]
                                         - ref["last"]).max()),
                    decode=float(np.abs(r0[f"{name}_steps"]
                                        - ref["steps"]).max()))
        prompts = all(bool(r[f"{name}_prompts_equal"]) for r in ranks)
        out[name] = dict(errs=errs, prompts_equal=prompts,
                         wall_s=[float(r[f"{name}_wall"]) for r in ranks],
                         draw_s=[float(r[f"{name}_draw_s"]) for r in ranks],
                         bytes_a_rank=[int(r[f"{name}_bytes"])
                                       for r in ranks],
                         max_abs_logit=float(np.abs(ref["last"]).max()))
        log(f"{tag} {arch} {what} on {SHARD_WORLD} gloo ranks of the card: "
            f"|prefill - unsharded| {errs['prefill']:.5f}, |{LM_SHARD_STEPS} "
            f"teacher-forced decode steps - unsharded| {errs['decode']:.5f} "
            f"(atol {LM_ATOL}; max |logit| {out[name]['max_abs_logit']:.3f});"
            f" prompts drawn equal: {prompts}; "
            + ", ".join(f"{b / 2**30:.2f}" for b in out[name]["bytes_a_rank"])
            + " GiB of params a rank; prefill + decode "
            + ", ".join(f"{w:.2f}" for w in out[name]["wall_s"]) + " s, draw "
            + ", ".join(f"{w:.2f}" for w in out[name]["draw_s"]) + " s")
        if not prompts or max(errs.values()) > LM_ATOL:
            fail(f"{tag} the sharded {arch} run departs from the unsharded")
    ref = np.load(SHARD_LM_DIR / "train.npz")
    rel = {k: abs(float(r0[f"train_{k}"]) / float(ref[k]) - 1)
           for k in TRAIN_REL}
    same = len({float(r["train_loss"]) for r in ranks}) == 1
    rep_equal = all(bool(r["train_replicated_equal"]) for r in ranks)
    out["train"] = dict(rel=rel, loss=float(r0["train_loss"]),
                        grad_norm=float(r0["train_grad_norm"]),
                        want=dict(loss=float(ref["loss"]),
                                  grad_norm=float(ref["grad_norm"])),
                        replicated_equal=rep_equal, losses_equal=same,
                        wall_s=[float(r["train_wall"]) for r in ranks],
                        peak_bytes=[int(r["train_peak"]) for r in ranks])
    log(f"{tag} {TRAIN_ARCH} train step, full width, {TRAIN_SHARD_LAYERS} "
        f"layers, seq 4096, B={TRAIN_SHARD_BATCH}, ({SHARD_WORLD}, 1): FSDP and"
        f" data parallelism on {SHARD_WORLD} gloo ranks of the card: loss "
        f"{out['train']['loss']:.5f} grad norm "
        f"{out['train']['grad_norm']:.5f} against the unsharded "
        f"{out['train']['want']['loss']:.5f} / "
        f"{out['train']['want']['grad_norm']:.5f} (rel {rel['loss']:.2e}, "
        f"{rel['grad_norm']:.2e}; bounds {TRAIN_REL}); replicated params and "
        f"moments bitwise equal across the ranks: {rep_equal}; step "
        + ", ".join(f"{w:.2f}" for w in out["train"]["wall_s"]) + " s, peak "
        + ", ".join(f"{b / 2**30:.2f}" for b in out["train"]["peak_bytes"])
        + f" GiB, draw {float(r0['train_draw_s']):.2f} s, replicated check "
        f"{float(r0['train_check_s']):.2f} s; the ranks' transformer cases "
        f"{float(r0['lm_s']):.1f} s in all")
    if not (same and rep_equal and all(rel[k] <= TRAIN_REL[k]
                                       for k in TRAIN_REL)):
        fail(f"{tag} the sharded train step departs from the unsharded one")
    return out


def max_rel(got, want) -> float:
    """max |got - want| over the largest |want| (0 for equal tensors)."""
    d = float((got.double() - want.double()).abs().max())
    return d / max(float(want.double().abs().max()), 1e-30)


def shard_gnn(mesh, inputs, tag: str) -> dict:
    """One sharded gin-tu step at ogb_products on ``[gnn train]``'s params
    and batch against the unsharded step: loss and every grad within
    :data:`SCATTER_REL` of the largest magnitude, the step times."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.optim import adamw_init, tree_leaves
    from repro_torch.sharding import spmd
    params, batch = inputs
    spec = configs.get("gin-tu")
    cell_s, cell_u = (steps.gnn_train_cell(spec, spec.cells["ogb_products"],
                                           m) for m in (mesh, None))
    on_card = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    local = spmd.shard_tree(on_card, cell_s.in_specs[2], mesh)
    lu, gu = cell_u.grads_fn(clone_tree(params), on_card)
    ls, gs = cell_s.grads_fn(clone_tree(params), local)
    errs = [max_rel(a, b) for a, b in zip(tree_leaves(gs), tree_leaves(gu))]
    loss_rel = max_rel(ls, lu)
    del gu, gs
    times = {}
    for name, cell, b in (("unsharded", cell_u, on_card),
                          ("sharded", cell_s, local)):
        p = clone_tree(params)
        o = adamw_init(p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cell.step_fn(p, o, b)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        del p, o
    out = dict(loss=float(ls), loss_unsharded=float(lu), loss_rel=loss_rel,
               grad_rel_max=max(errs), step_s=times["sharded"],
               unsharded_step_s=times["unsharded"],
               n_nodes=cell_s.meta["n_nodes"], n_edges=cell_s.meta["n_edges"])
    log(f"{tag} gin-tu ogb_products (N={out['n_nodes']:,} "
        f"E={out['n_edges']:,}) on the 1-rank mesh: loss {out['loss']:.7g} "
        f"against {out['loss_unsharded']:.7g} unsharded (rel {loss_rel:.2e}),"
        f" largest grad gap {out['grad_rel_max']:.2e} of the leaf's largest "
        f"magnitude (bound {SCATTER_REL}); step {times['sharded']:.3f} s "
        f"sharded, {times['unsharded']:.3f} s unsharded")
    if loss_rel > SCATTER_REL or out["grad_rel_max"] > SCATTER_REL:
        fail(f"{tag} the sharded gin-tu step differs from the unsharded")
    return out


def shard_recsys(mesh, params, tag: str) -> dict:
    """One sharded dcn-v2 train_batch step and one retrieval_cand query at
    full width on the 1-rank mesh against their unsharded twins."""
    import torch
    from repro_torch import configs
    from repro_torch.data import RecsysPipeline
    from repro_torch.launch import steps
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import spmd
    spec = configs.get(RECSYS_ARCH)
    cfg = spec.full
    tr_s, tr_u = (steps.recsys_cell(spec, spec.cells["train_batch"], m)
                  for m in (mesh, None))
    b = RecsysPipeline(n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
                       vocab=cfg.vocab, batch=tr_s.meta["batch"],
                       bag=cfg.bag, seed=3).next_batch()
    b = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
    pspec, _, bspec = tr_s.in_specs
    metrics, times = {}, {}
    for name, cell, p, batch in (
            ("unsharded", tr_u, clone_tree(params), b),
            ("sharded", tr_s, spmd.shard_tree(clone_tree(params), pspec,
                                              mesh),
             spmd.shard_tree(b, bspec, mesh))):
        o = adamw_init(p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = cell.step_fn(p, o, batch)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        metrics[name] = {k: float(v) for k, v in m.items()}
        del p, o
    rel = {k: abs(metrics["sharded"][k] - metrics["unsharded"][k])
           / max(abs(metrics["unsharded"][k]), 1e-30)
           for k in ("loss", "grad_norm")}
    rt_s, rt_u = (steps.recsys_cell(spec, spec.cells["retrieval_cand"], m)
                  for m in (mesh, None))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    cand = torch.randn((rt_s.meta["n_candidates"], cfg.mlp_dims[-1]),
                       generator=gen, device="cuda")
    q = RecsysPipeline(n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
                       vocab=cfg.vocab, batch=1, bag=cfg.bag,
                       seed=2).next_batch()
    local_p = spmd.shard_tree(params, rt_s.in_specs[0], mesh)
    vs, is_ = rt_s.step_fn(local_p, q["dense"], q["sparse"],
                           spmd.shard(cand, rt_s.in_specs[3], mesh))
    vu, iu = rt_u.step_fn(params, q["dense"], q["sparse"], cand)
    same = torch.equal(is_, iu) and torch.equal(vs, vu)
    r_ms = timed_calls(lambda: rt_s.step_fn(local_p, q["dense"],
                                            q["sparse"], cand),
                       RECSYS_RETRIEVAL_CALLS)
    out = dict(train_metrics=metrics, train_rel=rel,
               step_s=times["sharded"], unsharded_step_s=times["unsharded"],
               retrieval_top100_equal=same,
               retrieval_ms=[1e3 * x for x in r_ms])
    log(f"{tag} dcn-v2 train_batch (B={tr_s.meta['batch']:,}) on the 1-rank "
        f"mesh: loss rel {rel['loss']:.2e}, grad norm rel "
        f"{rel['grad_norm']:.2e}; step {times['sharded']:.4f} s sharded, "
        f"{times['unsharded']:.4f} s unsharded; retrieval_cand top 100 equal "
        f"to the unsharded query's: {same}, "
        + ", ".join(f"{1e3 * x:.3f}" for x in r_ms) + " ms a query")
    if max(rel.values()) > SCATTER_REL or not same:
        fail(f"{tag} the sharded dcn-v2 step or retrieval differs")
    return out


def shard_compress(mesh, tag: str) -> dict:
    """``compressed_allreduce`` of a :data:`SHARD_GRAD_ELEMS`-element f32
    gradient over the mesh's data group at world 1 against the
    ``group=None`` round trip (equal), and its device time."""
    import torch
    import torch.distributed as dist
    from repro_torch.optim import compressed_allreduce
    from repro_torch.sharding import spmd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    x = torch.randn(SHARD_GRAD_ELEMS, generator=gen, device="cuda")
    err = torch.randn(SHARD_GRAD_ELEMS, generator=gen, device="cuda") * 1e-3
    group = spmd.axis_group(mesh, ("data", "model"))
    got, got_err = compressed_allreduce(x, err, group)
    want, want_err = compressed_allreduce(x, err, None)
    same = torch.equal(got, want) and torch.equal(got_err, want_err)
    del got, got_err, want, want_err
    ms = []
    for _ in range(SHARD_COMPRESS_REPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        compressed_allreduce(x, err, group)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    out = dict(elements=SHARD_GRAD_ELEMS, equal_to_round_trip=same, ms=ms,
               ms_median=statistics.median(ms))
    log(f"{tag} compressed_allreduce of {SHARD_GRAD_ELEMS:,} f32 at world 1 "
        f"({dist.get_backend(group)}): equal to the group=None round trip: "
        f"{same}; "
        + ", ".join(f"{t:.3f}" for t in ms) + " ms a call (CUDA events)")
    if not same:
        fail(f"{tag} compressed_allreduce differs from its round trip")
    return out


def shard_phase(header: str, gnn_inputs, recsys_params) -> dict:
    """``[shard]``: see the module docstring.  Returns the numbers and the
    triangle kernel's launches of the phase (1-rank and spawned runs)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.core import engine_torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding import spmd
    tag = "[shard]"
    t_phase = time.perf_counter()
    mesh = make_local_mesh((1, 1), device="cuda")
    log(f"{tag} 1-rank mesh over {dist.get_backend()}: "
        f"{spmd.mesh_sizes(mesh)}")
    out, launches, seed = {"cells": {}}, 0, 7
    spec = configs.get("ebbkc")
    one_rank = None
    for name, p in SHARD_CELLS:
        cell = steps.build_cell(spec, name, mesh)
        m = cell.meta
        A, cand = shard_tiles(m["n_tiles"], m["T"], p, seed)
        ts, cs = cell.in_specs
        A_loc, c_loc = spmd.shard(A, ts, mesh), spmd.shard(cand, cs, mesh)
        cell.step_fn(A_loc[:SHARD_SLICE], c_loc[:SHARD_SLICE])      # warm
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        total, nv, t, f = cell.step_fn(A_loc, c_loc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = ops.launch_counts()["triangle_count_tiles"]
        if not n_launch:
            fail(f"{tag} {name} never launched the triangle kernel")
        launches += n_launch
        (_, _, _, _), dev_ms = kernel_device_ms(
            lambda: cell.step_fn(A_loc, c_loc))
        hard, nv_u, t_u, f_u = engine_torch.count_packed(A, cand, 3,
                                                         method="mxu")
        same = (torch.equal(nv, nv_u) and torch.equal(t, t_u)
                and torch.equal(f, f_u))
        exact = int(hard.sum())
        gap = abs(float(total) - exact) / max(exact, 1)
        # the kernel against its plain version on a slice (et routing in)
        a, c = A[:SHARD_SLICE], cand[:SHARD_SLICE]
        c = torch.where((t_u[:SHARD_SLICE] <= 2)[:, None],
                        torch.zeros_like(c), c)
        k_out = ops.count_tiles(a, c, 3, method="mxu")
        p_out = kref.clique_count_tiles_ref(a.cpu(), c.cpu(), 3)
        slice_err = int((k_out.cpu() - p_out).abs().max())
        r = dict(n_tiles=m["n_tiles"], T=m["T"], density=p,
                 tile_bytes=A.numel() * 4, wall_s=wall,
                 kernel_device_ms=dev_ms, launches=n_launch,
                 per_tile_equal=same, f32_total=float(total),
                 exact_total=exact, total_rel_gap=gap,
                 slice_max_abs_err=slice_err)
        out["cells"][name] = r
        log(f"{tag} {name} (B={m['n_tiles']:,}, T={m['T']}, p={p}, "
            f"{r['tile_bytes'] / 2**20:.0f} MiB of tiles) on the 1-rank mesh:"
            f" step wall {wall:.4f} s, triangle kernel {dev_ms:.3f} ms device "
            f"in {n_launch} launches; nv, t, f equal to the unsharded "
            f"count_packed: {same}; f32 total {float(total):.1f} against the "
            f"exact int64 {exact} (rel gap {gap:.2e}); kernel vs plain on "
            f"{SHARD_SLICE} tiles max |err| {slice_err}")
        if not same or slice_err or gap > 2 ** -23 * 4:
            fail(f"{tag} {name}: the sharded cell or the kernel is off")
        if one_rank is None:
            one_rank = dict(nv=nv.cpu().numpy(), t=t.cpu().numpy(),
                            f=f.cpu().numpy(), hard=hard.cpu().numpy(),
                            total=float(total), exact=exact)
        del A, cand, A_loc, c_loc, hard, nv_u, t_u, f_u
        torch.cuda.empty_cache()
    out["two_ranks"] = shard_two_ranks(one_rank, seed, tag)
    launches += sum(out["two_ranks"]["launches"])
    out["gnn"] = shard_gnn(mesh, gnn_inputs, tag)
    torch.cuda.empty_cache()
    out["recsys"] = shard_recsys(mesh, recsys_params, tag)
    torch.cuda.empty_cache()
    out["compress"] = shard_compress(mesh, tag)
    dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"{tag} {header}")
    return out, {"triangle_count_tiles": launches}


def to_cpu(tree):
    """A tree of tensors (dicts and lists) as the same tree on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree.detach().cpu()

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
            timed = listing.capacity_for(counts)
            oracle = {}  # one plain run, at the largest capacity
            for cap in sorted({1, max(1, top - 1), timed}, reverse=True):
                list_case(rows, errs, A, cand, l, cap, "seeded",
                          reps=10 if cap == timed else 0, oracle=oracle)
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
    # the DFS kernels' skew at T = 64 only: at T = 128 the heaviest tile's
    # plain runs take about 23 s on an H100 host, too much of the limit
    for T in (64,):
        for which, A, cand, _ in main_path_batches(plan, 7, T):
            if which != "sample":
                continue
            counts = clique_count.clique_count_tiles(A, cand, 5)
            A2, c2 = skewed_batch(A, cand, counts)
            r = kernel_cases(rows, errs, A2, c2, 5, "skewed k=7", reps=20)[0]
            real[("dfs", T, 5, "skewed")] = r
            n2 = clique_count.clique_count_tiles(A2, c2, 4).cpu().numpy()
            cap = listing.capacity_for(n2)
            oracle = {}  # one plain run, at the largest capacity
            for c in sorted({1, max(1, cap // 3), cap}, reverse=True):
                list_case(rows, errs, A2, c2, 4, c, "skewed l=4",
                          reps=20 if c == cap else 0, oracle=oracle)

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
        f"{mid_plan_s:.2f} s; the queries of [dispatch], [obs], [widths] "
        f"and [delta]'s 0.2 % batch run on it")

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
    delta_runs = delta_phase(mg, mplan, sg)
    log(f"[time] [delta] done at {time.perf_counter() - t_start:.1f} s")
    serve_runs = serve_phase(lg, lplan, sg, delta_runs)
    log(f"[time] [serve] done at {time.perf_counter() - t_start:.1f} s")
    del delta_runs["first_batch"]  # arrays, handed to [serve]

    # -- the paper baseline, the on-device truss, the LM serving path -------
    baseline_runs = baseline_phase()
    log(f"[time] [baseline] done at {time.perf_counter() - t_start:.1f} s")
    truss_runs = truss_phase(lg)
    log(f"[time] [truss] done at {time.perf_counter() - t_start:.1f} s")
    # [train]'s crashed launcher run goes to a fresh process from here on
    crashed = train_crash_start()
    try:
        lm_runs = lm_phase(header)
        log(f"[time] [lm serve] done at {time.perf_counter() - t_start:.1f} s")
        moe_runs = moe_phase(header)
        log(f"[time] [moe serve] done at "
            f"{time.perf_counter() - t_start:.1f} s")
        # the GNN runs' host draws go to a background thread from here on
        gnn_built = gnn_prefetch()
        train_runs = train_phase(header, crashed)
    finally:
        kill_modules(crashed[0])
    log(f"[time] [train] done at {time.perf_counter() - t_start:.1f} s")
    gnn_runs = gnn_phase(header, gnn_built)
    log(f"[time] [gnn train] done at {time.perf_counter() - t_start:.1f} s")
    recsys_runs = recsys_phase(header)
    log(f"[time] [recsys] done at {time.perf_counter() - t_start:.1f} s")
    shard_runs, shard_launches = shard_phase(
        header, gnn_runs.pop("_shard_inputs"),
        recsys_runs.pop("_shard_inputs"))
    log(f"[time] [shard] done at {time.perf_counter() - t_start:.1f} s")

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
            "replaces": meta[name][1],
            "launches": path_launches[name] + shard_launches.get(name, 0),
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
             "moe": moe_runs, "train": train_runs, "gnn": gnn_runs,
             "recsys": recsys_runs, "shard": shard_runs,
             "launches": count_launches, "shard_launches": shard_launches,
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
