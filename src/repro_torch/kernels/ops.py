"""Backend registry and routing for per-tile clique counting and listing
(port of ``repro/kernels/ops.py``).

:func:`count_tiles` routes by l = k - 2 exactly as the reference's Pallas
family does:

* ``method="auto"``: l == 3 goes to the triangle kernel
  (:mod:`repro_torch.kernels.triangle_mm`), l >= 4 to the DFS kernel
  (:mod:`repro_torch.kernels.clique_count`);
* ``"mxu"`` pins the triangle kernel (l == 3 only; the name is the
  reference's, kept so call sites read the same);
* ``"dfs"`` pins the DFS kernel, l == 3 included;
* ``"ref"`` runs the expansion oracle of :mod:`repro_torch.kernels.ref`.

l <= 2 takes closed forms and no kernel.  :func:`list_tiles` lists every
l-clique of each tile through :mod:`repro_torch.kernels.clique_list`, and
:func:`edge_candidates` builds edge-branch candidate sets through
:mod:`repro_torch.kernels.intersect`.  Each kernel wrapper sends a CUDA
tensor to its CUDA kernel and a CPU tensor to its plain torch version; the
launch counters below show which ran.

The backend registry, :data:`BACKENDS`:

* ``"cuda"`` -- the hand-written CUDA kernels; needs CUDA tensors;
* ``"torch"`` -- the plain torch versions; CPU tensors only;
* ``"ref"`` -- the expansion oracles (counting only); CPU tensors only;
* ``"auto"`` (default) -- ``"cuda"`` on a CUDA tensor, ``"torch"`` on a
  CPU tensor;
* ``"autotune"`` -- the faster of ``"cuda"`` and ``"torch"`` per
  (device kind, mode, l, T, capacity bucket), from the in-process cache,
  a persisted :class:`~repro_torch.tune.records.TuningRecord`, or a live
  microbenchmark (:func:`autotune_backend`).

Unlike the reference, the registry never moves a CUDA tensor's work off
its kernel: ``"torch"`` and ``"ref"`` raise on a CUDA tensor, and under
``"autotune"`` a CUDA tensor runs the kernel whatever the record's winner
(the winner is reported -- the record keeps both times -- and never
obeyed; a CPU tensor runs the plain version, the only one it has).

Selection precedence, as in the reference: explicit ``backend=`` argument
> the ``REPRO_TORCH_BACKEND`` environment variable (read per call) >
``"auto"``; inside an autotune resolution a concrete
``REPRO_TORCH_BACKEND`` value beats a persisted record beats the live
microbenchmark.

The module also accounts one-time kernel costs: the first load (or build)
of the kernel library and the first launch of each (function, l, T,
device) signature on a CUDA tensor are timed synchronously into a
process-wide counter that the engines drain into
``Stats.kernel_compile_s`` via :func:`consume_compile_s`.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Tuple

import torch

from . import _build
from . import clique_count as _cc
from . import clique_list as _cl
from . import intersect as _is
from . import ref as _ref
from . import triangle_mm as _tm
from .common import COUNTER_LOCK, Timing, record_around
from ..obs import profile as obs_profile
from ..obs import trace

METHODS = ("auto", "mxu", "dfs", "ref")

BACKENDS = ("auto", "cuda", "torch", "ref", "autotune")

#: env var consulted when no explicit ``backend=`` is passed
BACKEND_ENV = "REPRO_TORCH_BACKEND"

_KERNELS = {"triangle_count_tiles": _tm, "clique_count_tiles": _cc,
            "clique_list_tiles": _cl, "edge_candidates": _is}

#: in-process autotune winners, keyed (device_kind, mode, l, T, cap_bucket)
_AUTOTUNE_CACHE: Dict[Tuple[str, str, int, int, int], str] = {}
_COMPILE_S = 0.0
_SEEN_SIGNATURES = set()
_ACCT_LOCK = threading.Lock()


def resolve_backend(backend: Optional[str] = None, device=None) -> str:
    """Resolve the backend knob to a registry name (see module docstring).

    ``"auto"`` resolves by ``device`` (a CUDA device: ``"cuda"``; the CPU:
    ``"torch"``; ``None``: the CUDA device when there is one);
    ``"autotune"`` is returned as it is (the per-shape winner is only
    known once l and T are).
    """
    for cand in (backend, os.environ.get(BACKEND_ENV) or None):
        if cand is None:
            continue
        if cand not in BACKENDS:
            raise ValueError(
                f"unknown kernel backend {cand!r}; expected one of {BACKENDS}")
        if cand != "auto":
            return cand
        break  # explicit "auto": the env knob does not override it
    if device is None:
        return "cuda" if torch.cuda.is_available() else "torch"
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def _concrete(backend: Optional[str], A: torch.Tensor, mode: str, l: int,
              capacity: Optional[int] = None, tune: bool = True) -> str:
    """The backend that runs on ``A``: "cuda", "torch" or "ref".  Raises
    where the registry name does not run on A's device.  ``"autotune"``
    consults :func:`autotune_backend` unless ``tune`` is False (a closed
    form that runs no kernel)."""
    b = resolve_backend(backend, A.device)
    on_card = A.device.type == "cuda"
    if b == "autotune":
        if not tune:
            return "cuda" if on_card else "torch"
        winner = autotune_backend(mode, l, A.shape[1],
                                  capacity if mode == "list" else None)
        b = "cuda" if on_card else "torch"
        trace.instant("tune/autotune", mode=mode, l=l, T=A.shape[1],
                      winner=winner, ran=b)
        return b
    if b == "cuda" and not on_card:
        raise ValueError("backend 'cuda' runs the CUDA kernels: it needs "
                         f"CUDA tensors, got {A.device}")
    if b in ("torch", "ref") and on_card:
        raise ValueError(f"backend {b!r} runs on the CPU only; on a CUDA "
                         f"tensor the kernel runs (backend 'cuda' or "
                         f"'auto')")
    return b


def autotune_backend(mode: str, l: int, T: int,
                     capacity: Optional[int] = None,
                     trials: int = 2) -> str:
    """Backend winner for one kernel signature, cheapest source first.

    Resolution ladder (the tail of the module-docstring precedence):

    1. a *concrete* ``REPRO_TORCH_BACKEND`` value -- the env knob overrides
       any cached or persisted winner;
    2. the in-process winner cache, keyed
       ``(device_kind, mode, l, T, capacity bucket)``;
    3. a persisted :class:`~repro_torch.tune.records.TuningRecord` from the
       configured tune-cache directory (cross-process warm start);
    4. the live kernel-vs-plain microbenchmark
       (:func:`repro_torch.tune.search.microbench_backend`), whose winner
       and both times are written back through layers 2-3.

    Lookups and microbenchmark seconds accrue to the tuning-event
    accumulator (:func:`repro_torch.tune.cache.note_event`) that engines
    drain into ``Stats.tune_s`` / ``tune_cache_hit``.
    """
    global _COMPILE_S
    env = os.environ.get(BACKEND_ENV) or None
    if env is not None and env in BACKENDS and env not in ("auto", "autotune"):
        return env
    from .. import tune
    from ..tune import search as tune_search

    bucket = tune.capacity_bucket(capacity if mode == "list" else None)
    key = (tune.device_kind(), mode, int(l), int(T), bucket)
    got = _AUTOTUNE_CACHE.get(key)
    if got is not None:
        tune.note_event(lookup=True)
        trace.instant("tune/cache_hit", source="memory", mode=mode, T=T)
        return got
    rkey = tune.backend_key(mode, l, T, capacity if mode == "list" else None)
    rec = tune.get(rkey)
    if rec is not None and rec.data.get("winner") in ("cuda", "torch"):
        best = rec.data["winner"]
        _AUTOTUNE_CACHE[key] = best
        tune.note_event(lookup=True)
        trace.instant("tune/cache_hit", source="record", mode=mode, T=T)
        return best
    # park compile seconds accrued by earlier *real* kernel calls so the
    # drain below discards only the microbenchmark's own first launches
    pending = consume_compile_s()
    t0 = time.perf_counter()
    with trace.span("tune/microbench", mode=mode, l=l, T=T, trials=trials):
        best, times = tune_search.microbench_backend(mode, l, T,
                                                     capacity=capacity,
                                                     trials=trials)
    tune_s = time.perf_counter() - t0
    consume_compile_s()
    with _ACCT_LOCK:
        _COMPILE_S += pending
    _AUTOTUNE_CACHE[key] = best
    tune.note_event(seconds=tune_s, lookup=True, miss=True)
    tune.put(tune.TuningRecord(
        "backend", key[0], tune.torch_version(), mode, int(l), T=int(T),
        W=int(T) // 32, cap_bucket=bucket,
        data={"winner": best, "times": times, "trials": trials,
              "tune_s": tune_s}))
    return best


def clear_autotune_cache() -> None:
    """Drop in-process autotune winners (persisted records survive)."""
    _AUTOTUNE_CACHE.clear()


def consume_compile_s() -> float:
    """Drain the one-time seconds accumulator (library load or build, and
    each signature's first launch)."""
    global _COMPILE_S
    with _ACCT_LOCK:
        v, _COMPILE_S = _COMPILE_S, 0.0
    return v


def consume_tune_events() -> tuple:
    """Drain tuning events -> ``(tune_s, lookups, misses)``.

    Engines call this next to :func:`consume_compile_s` and derive
    ``Stats.tune_cache_hit = lookups > 0 and misses == 0``.
    """
    from .. import tune

    return tune.consume_events()


def drain_tune_events(stats) -> None:
    """Drain tuning events into a ``Stats`` at an engine drain point.

    A drain that saw no events leaves ``tune_cache_hit`` untouched -- the
    engines and the dispatchers share one Stats and both drain, so only
    the drain that actually collected the query's lookups gets to decide
    the flag (hit = every lookup answered from a cache layer).
    """
    tune_s, lookups, misses = consume_tune_events()
    stats.tune_s += tune_s
    if lookups or misses:
        stats.tune_cache_hit = misses == 0


def build_library() -> float:
    """Load the CUDA kernel library, building it if its hash has no
    library yet.  Returns the seconds this call took to load it (0.0 once
    it is loaded in this process) and accrues them to
    :func:`consume_compile_s`."""
    global _COMPILE_S
    if _build.loaded():
        return 0.0
    t0 = time.perf_counter()
    _build.lib()
    dt = time.perf_counter() - t0
    with _ACCT_LOCK:
        _COMPILE_S += dt
    return dt


def _timed_first_call(key: tuple, fn, A: torch.Tensor):
    """Run ``fn()``; on a CUDA tensor, time the library load and the first
    call of each signature (synchronized) into the compile accumulator.
    A call inside a CUDA graph capture is never timed."""
    global _COMPILE_S
    if A.device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return fn()
    build_library()
    key = key + (A.device.index,)
    with _ACCT_LOCK:
        seen = key in _SEEN_SIGNATURES
        _SEEN_SIGNATURES.add(key)
    if seen:
        return fn()
    sig = "/".join(str(p) for p in key)
    t0 = time.perf_counter()
    with trace.span("kernel/compile", sig=sig):
        out = fn()
        torch.cuda.current_stream(A.device).synchronize()
    dt = time.perf_counter() - t0
    with _ACCT_LOCK:
        _COMPILE_S += dt
    obs_profile.note_kernel(sig, compile_s=dt)
    return out


def count_tiles(A: torch.Tensor, cand: torch.Tensor, l: int,
                method: str = "auto", backend: Optional[str] = None,
                timing: Optional[Timing] = None) -> torch.Tensor:
    """Count l-cliques per tile: (B,T,W) int32 x (B,W) int32 -> (B,) int64
    (uint32 values).  ``backend`` selects the implementation (see the
    module docstring).  On a CUDA tensor, ``timing``, a pair of events
    from :func:`~repro_torch.kernels.common.timing_events`, is recorded
    around the call's device work: by the kernel library around its
    launches, or from the host around the torch ops of the ``ref``
    version.  Nothing here waits for the device."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{METHODS}")
    if l < 1:
        raise ValueError("counting requires l >= 1")
    b = _concrete(backend, A, "count", l, tune=method != "ref" and l > 2)
    if method == "ref" or b == "ref" or l <= 2:
        with record_around(timing if A.is_cuda else None, A.device):
            return _ref.clique_count_tiles_ref(A, cand, l)
    if method == "mxu" or (method == "auto" and l == 3):
        if l != 3:
            raise ValueError("the triangle kernel implements l == 3 only")
        return _timed_first_call(
            ("tri", l, A.shape[1]),
            lambda: _tm.triangle_count_tiles(A, cand, timing), A)
    return _timed_first_call(
        ("count", l, A.shape[1]),
        lambda: _cc.clique_count_tiles(A, cand, l, timing), A)


def list_tiles(A: torch.Tensor, cand: torch.Tensor, l: int, capacity: int,
               backend: Optional[str] = None, timing: Optional[Timing] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """List l-cliques per tile into fixed-capacity local-id buffers.

    (B,T,W) int32 x (B,W) int32 -> (out (B,capacity,l) int32, count (B,)
    int64 true totals holding uint32 values, overflow (B,) int64).
    Overflowed tiles keep the true count but only the first ``capacity``
    cliques; callers must relist them on the host, never truncate.
    ``timing`` as in :func:`count_tiles`.
    """
    b = _concrete(backend, A, "list", l, capacity)
    if b == "ref":
        raise ValueError("the ref backend implements counting only")
    return _timed_first_call(
        ("list", l, A.shape[1]),
        lambda: _cl.clique_list_tiles(A, cand, l, capacity, timing), A)


def edge_candidates(A: torch.Tensor, pairs: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate sets N(a) & N(b) & gt(b) of each tile's pair (a, b) and
    their sizes: (B,T,W) int32 x (B,2) int32 -> ((B,W) int32, (B,) int64)."""
    return _is.edge_candidates(A, pairs)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    with COUNTER_LOCK:
        return {name: mod.launches for name, mod in _KERNELS.items()}


def plain_counts() -> Dict[str, int]:
    """Plain-version calls per kernel since the last reset."""
    with COUNTER_LOCK:
        return {name: mod.plain_calls for name, mod in _KERNELS.items()}


def reset_counts() -> None:
    """Set every launch and plain-call counter to 0 (the wrappers add to
    them under :data:`~repro_torch.kernels.common.COUNTER_LOCK`, from any
    thread)."""
    with COUNTER_LOCK:
        for mod in _KERNELS.values():
            mod.launches = 0
            mod.plain_calls = 0
