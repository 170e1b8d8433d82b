#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each kernel against its plain torch version on the card, then drives
the port's main path -- single-query k-clique counting through
``repro_torch.core.ebbkc.count`` on its default device engine -- on a
Graph500-shaped RMAT graph (scale 15, edge factor 16: n = 32,768,
m = 441,769) for k = 5 (triangle kernel) and k = 7 (DFS kernel), and
finally runs the command-line launcher with ``--verify``.  Any failure
raises and exits non-zero.

Output: the card's name and power limit, one line per phase, a
``{"kernels": [...]}`` JSON line with each kernel's launches on the main
path, its largest difference from the plain version, its time, the plain
version's time, its lower bound and the library yardstick's time, and as
the last line ``{"ok": true, "device": {...}}``.  ``--json PATH`` also
writes every number to PATH.  Without a CUDA device,
or without the repository's ``src/`` beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
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

# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit):
# 3.35 TB/s of HBM; 67 TFLOP/s of fp32 outside the tensor cores,
# which counts an FMA as two operations on 132 SMs x 128 lanes.  The int32
# units are half as many lanes, so 33.5e12 / 2 = 16.75e12 int32 operations
# a second; the kernels' AND / popcount / add work is counted against it.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12

BINS = (32, 64, 128, 256)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_header() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timings, after
    one warm-up call."""
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


def main_path_batches(plan, k: int, T: int, batch_size: int = 256):
    """The inputs the main path gives the kernels in bin ``T`` at ``k``:
    ``batch_size`` tiles spread evenly over the bin's stream order (its
    first tiles come from the densest, last-peeled edges and are nearly all
    2-plexes), and the bin's real last batch of ``n_tiles % batch_size``
    tiles.  Each is packed as the engine packs it, with the 2-plex lanes
    zeroed as ``count_packed`` zeroes them.  Yields (tag, A, cand, live)."""
    import numpy as np
    import torch
    from repro_torch.convert import batch_to_torch
    from repro_torch.core import engine_torch, pipeline
    table = plan.table("hybrid")
    ids = table.select(k)
    sizes = table.offsets[ids + 1] - table.offsets[ids]
    lo = dict(zip(BINS, (0,) + BINS[:-1]))[T]
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


def kernel_cases(rows, errs, A, cand, l, tag, reps=20):
    """Kernel vs plain on one input; record timings and the bound.

    The kernel's time is the median of ``reps`` launches of the bare C
    entry point (no wrapper, so no launch counted); the plain version's
    is its one comparison run, since it repeats the kernel's arithmetic
    step by step and is no yardstick of speed."""
    import torch
    from repro_torch.kernels import _build, clique_count, triangle_mm
    from repro_torch.kernels.common import check_tiles
    from repro_torch.kernels.ref import edges_within_ref
    B, T, W = check_tiles(A, cand)
    so = _build.lib()
    out = torch.empty(B, dtype=torch.int32, device=A.device)
    stream = torch.cuda.current_stream().cuda_stream
    nbytes = A.numel() * 4 + cand.numel() * 4 + B * 4
    results = []
    for kernel in (("triangle", "dfs") if l == 3 else ("dfs",)):
        if kernel == "triangle":
            got = triangle_mm.triangle_count_tiles(A, cand)
            want, plain_ms = timed_once(
                lambda: triangle_mm.triangle_count_tiles_torch(A, cand))

            def launch():
                so.triangle_count_tiles_launch(A.data_ptr(), cand.data_ptr(),
                                               out.data_ptr(), B, T, stream)
            # 3 word ops (AND, popcount, add) per word of every induced edge
            word_ops = 3 * W * int(edges_within_ref(A, cand).sum())
            lib_fn, lib_counts = bmm_yardstick(A, cand)
            if not torch.equal(lib_counts, want):
                fail(f"bmm yardstick disagrees at T={T} ({tag})")
            lib_ms = time_ms(lib_fn, reps)
        else:
            got = clique_count.clique_count_tiles(A, cand, l)
            work = {}
            want, plain_ms = timed_once(
                lambda: clique_count.clique_count_tiles_torch(A, cand, l,
                                                              work))

            def launch():
                so.clique_count_tiles_launch(A.data_ptr(), cand.data_ptr(),
                                             out.data_ptr(), B, T, l, stream)
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
        ms = time_ms(launch, reps)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = word_ops / INT32_OPS_PER_S * 1e3
        row = {"kernel": kernel, "case": tag, "T": T, "l": l, "B": B,
               "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
               "word_ops": word_ops,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": lib_ms, "tiles_per_s": B / (ms / 1e3)}
        rows.append(row)
        results.append(row)
        log(f"  {kernel:8s} {tag:17s} T={T:3d} l={l} B={B:3d}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}: "
            f"{nbytes} B, {word_ops} word-ops)"
            + (f", bmm {lib_ms:.4f} ms" if lib_ms is not None else ""))
    return results


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
    from repro_torch.core import ebbkc, pipeline
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import clique

    t_start = time.perf_counter()
    header = gpu_header()
    log(header)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # -- phase 2: build ----------------------------------------------------
    t0 = time.perf_counter()
    _build.lib(verbose=True)
    log(f"[build] nvcc sm_90a: {time.perf_counter() - t0:.2f} s")

    # -- phase 3: kernel vs plain on seeded tiles --------------------------
    rows, errs = [], {}
    log("[kernels] seeded tiles, 64 a case")
    density = {32: 0.3, 64: 0.2, 128: 0.1, 256: 0.06}
    for T in BINS:
        A, cand = (torch.from_numpy(x).view(torch.int32).cuda()
                   for x in seeded_tiles(T, 64, T, density[T]))
        for l in (3, 4, 5, 6):
            kernel_cases(rows, errs, A, cand, l, "seeded")
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
    for k in (5, 7):
        # with stage_times given, the engine brackets every count_tiles
        # call with CUDA events and sums its device seconds per bin
        stage = {}
        t0 = time.perf_counter()
        res = ebbkc.count(g, k, engine_kwargs={"stage_times": stage})
        wall = time.perf_counter() - t0
        st = res.stats
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
        log(f"[main] k={k}: count_tiles device time "
            f"{main_runs[k]['count_tiles_ms']:.1f} ms "
            f"({100 * main_runs[k]['count_tiles_ms'] / 1e3 / wall:.2f}% of "
            f"the query's wall time), per bin "
            + ", ".join(f"T={T}: {v:.1f} ms" for T, v in per_T.items()))
        if res.count != EXPECTED[k]:
            fail(f"k={k} counted {res.count}, expected {EXPECTED[k]}")
    launches = ops.launch_counts()
    plain = ops.plain_counts()
    log(f"[main] launches {launches} plain-version calls {plain}")
    if min(launches.values()) == 0:
        fail(f"a kernel of the main path never launched: {launches}")
    if sum(plain.values()):
        fail(f"a plain version ran on the main path: {plain}")
    plan = pipeline.cached_plan(g, "hybrid")
    expect_launches = {"triangle_count_tiles": 0, "clique_count_tiles": 0}
    for k, name in ((5, "triangle_count_tiles"), (7, "clique_count_tiles")):
        table = plan.table("hybrid")
        ids = table.select(k)
        sizes = table.offsets[ids + 1] - table.offsets[ids]
        per_T = np.bincount(np.searchsorted(np.asarray(BINS), sizes),
                            minlength=len(BINS) + 1)
        batches = {T: -(-int(per_T[i]) // 256) for i, T in enumerate(BINS)}
        main_runs[k]["batches_per_T"] = batches
        main_runs[k]["tiles_per_T"] = {T: int(per_T[i])
                                       for i, T in enumerate(BINS)}
        expect_launches[name] += sum(batches.values())
        log(f"[main] k={k} tiles per bin {main_runs[k]['tiles_per_T']}, "
            f"batches per bin {batches}")
    if launches != expect_launches:
        fail(f"launches {launches} != one per packed batch {expect_launches}")

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
    if not any(r["B"] % 4 for r in real.values()):
        fail("no compared main-path batch leaves a DFS block partly empty")

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
    if ops.launch_counts()["clique_count_tiles"] == 0:
        fail("launcher at k=6 never launched the DFS kernel")
    log(f"[cli] rmat:12 k=6 --verify: {time.perf_counter() - t0:.1f} s")

    # -- summary -----------------------------------------------------------
    rep = {"triangle_count_tiles": real[("triangle", 32, 3, "sample")],
           "clique_count_tiles": real[("dfs", 32, 5, "sample")]}
    meta = {
        "triangle_count_tiles": (
            "src/repro_torch/kernels/csrc/triangle_count.cu",
            "src/repro/kernels/triangle_mm.py:47"),
        "clique_count_tiles": (
            "src/repro_torch/kernels/csrc/clique_count.cu",
            "src/repro/kernels/clique_count.py:114"),
    }
    kernels = []
    for name, r in rep.items():
        short = "triangle" if name == "triangle_count_tiles" else "dfs"
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": errs[short], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    if args.json:
        path = Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(
            {"gpu": header, "torch": torch.__version__,
             "cuda": torch.version.cuda, "cases": rows,
             "main": {str(k): v for k, v in main_runs.items()},
             "launches": launches, "kernels": kernels,
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
