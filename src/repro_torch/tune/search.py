"""Geometry + backend search: live microbenchmarks behind the tuning cache.

The port of ``repro/tune/search.py``.  Two searches live here:

* :func:`microbench_backend` -- the CUDA kernel against its plain torch
  version for one kernel signature, on a small synthetic half-dense batch
  (the first call, which loads the kernel, is excluded by a warm-up).
  ``backend="autotune"`` (:mod:`repro_torch.kernels.ops`) calls this only
  when no persisted record answers first.
* :func:`tune_geometry` -- budgeted coordinate descent over the shape
  knobs of the pipeline: tile-width rounding policy (pow2 bins vs
  multiples of 32 -- fewer distinct tile widths vs tighter packing),
  ``batch_size``, emit-capacity rounding policy and cap, and the pack
  producer's ``pack_workers``.  The descent starts from the hardcoded
  defaults and only moves off them on a > 2% measured win, so the tuned
  geometry never loses to the defaults by more than measurement noise;
  the result is persisted as one geometry
  :class:`~repro_torch.tune.records.TuningRecord` that
  :func:`resolve_geometry` serves back as the engines' defaults.

Everything here is *explicitly invoked* (a tuning run, or a first-ever
``backend="autotune"`` call); a query that only *reads* tuned defaults
never pays for a search.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import cache as _cache
from . import records as _rec
from .records import TuningRecord
from ..obs import trace

#: keep in sync with repro_torch.core.listing.MAX_CAPACITY (not imported:
#: the listing module consumes this package's geometry defaults)
DEFAULT_MAX_CAPACITY = 1 << 14

#: hardcoded bin ladders per tile-width rounding policy; every entry is a
#: multiple of 32 (the uint32 word layout) and <= the widest kernel tile
_BIN_POLICIES: Dict[str, Tuple[int, ...]] = {
    "pow2": (32, 64, 128, 256),
    "mult32": (32, 64, 96, 128, 160, 192, 224, 256),
}


def bins_for(policy: str) -> Tuple[int, ...]:
    """Tile-size bin ladder for a T-rounding policy.

    ``pow2`` (the historical default) keeps the number of distinct tile
    widths at four; ``mult32`` packs tiles tighter (less padded work per
    tile) at the cost of up to eight.  Which wins is a hardware question;
    that is why it is a tuned knob.
    """
    try:
        return _BIN_POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown T-rounding policy {policy!r}; "
            f"expected one of {sorted(_BIN_POLICIES)}") from None


@dataclasses.dataclass
class Geometry:
    """The shape knobs one query runs with.  Defaults == pre-tuner behavior."""

    t_policy: str = "pow2"
    batch_size: int = 256
    cap_policy: str = "pow2"           # listing emit-capacity rounding
    max_capacity: int = DEFAULT_MAX_CAPACITY
    pack_workers: Optional[int] = None  # None = auto pool size
    prefetch: Optional[int] = None      # None = 2x workers
    #: explicit caller-supplied bin ladder; beats t_policy when set (the
    #: ladder need not match any named policy, e.g. bins=(32,) in tests)
    bins_override: Optional[Tuple[int, ...]] = None

    @property
    def bins(self) -> Tuple[int, ...]:
        if self.bins_override is not None:
            return self.bins_override
        return bins_for(self.t_policy)


def geometry_from_record(rec: TuningRecord) -> Geometry:
    """Geometry encoded in a record; unknown/missing fields keep defaults."""
    g = Geometry()
    for f in dataclasses.fields(Geometry):
        if f.name in rec.data and rec.data[f.name] is not None:
            setattr(g, f.name, rec.data[f.name])
    return g


def resolve_geometry(mode: str, l: int, *,
                     batch_size: Optional[int] = None,
                     bins: Optional[Sequence[int]] = None,
                     cap_policy: Optional[str] = None,
                     max_capacity: Optional[int] = None,
                     pack_workers: Optional[int] = None,
                     prefetch: Optional[int] = None) -> Geometry:
    """Concrete geometry for one query under the precedence ladder.

    Explicit argument > persisted/in-process tuning record > hardcoded
    default -- per knob, so a caller can pin ``batch_size`` while still
    inheriting a tuned capacity policy.  Never searches; with no record
    and no arguments this returns exactly the historical defaults.
    """
    with trace.span("tune/resolve", mode=mode, l=l) as _sp:
        rec = _cache.get(_rec.geometry_key(mode, l))
        _sp.set(hit=rec is not None)
    if rec is not None:
        # answered from a tuning record; an absent record notes nothing
        # (an untuned run is not a cache miss)
        _cache.note_event(lookup=True)
        trace.instant("tune/cache_hit", source="geometry", mode=mode, l=l)
    g = geometry_from_record(rec) if rec is not None else Geometry()
    if batch_size is not None:
        g.batch_size = int(batch_size)
    if bins is not None:
        # an explicit bin ladder always wins, even one that matches no
        # named policy (bins=(32,) forces the oversize-spill path); when
        # it does match a policy, record that too so t_policy stays
        # consistent with what actually runs
        tb = tuple(int(b) for b in bins)
        g.bins_override = tb
        for name, ladder in _BIN_POLICIES.items():
            if ladder == tuple(sorted(tb)):
                g.t_policy = name
                g.bins_override = None  # the policy already encodes it
                break
    if cap_policy is not None:
        g.cap_policy = cap_policy
    if max_capacity is not None:
        g.max_capacity = int(max_capacity)
    if pack_workers is not None:
        g.pack_workers = pack_workers
    if prefetch is not None:
        g.prefetch = prefetch
    return g


# ---------------------------------------------------------------------------
# backend microbenchmark (the live fallback behind backend="autotune")
# ---------------------------------------------------------------------------


def microbench_backend(mode: str, l: int, T: int,
                       capacity: Optional[int] = None,
                       trials: int = 2,
                       device=None) -> Tuple[str, Dict[str, float]]:
    """Fastest of the CUDA kernel and its plain torch version for one
    kernel signature.

    Runs each candidate on a small synthetic half-dense batch (B = 4
    tiles, full cand) on ``device`` (default: the CUDA device when there
    is one, else the CPU) at the *requested* capacity regime, after one
    warm-up call that loads the kernel.  On the card the candidates are
    ``"cuda"`` (the kernel, through its wrapper) and ``"torch"`` (the
    plain version, called directly on the card's tensors: the one place
    the port runs a plain version on CUDA tensors, to time it); on the CPU
    only ``"torch"`` runs.  Each call is timed on the host clock around a
    device synchronize.  Returns ``(winner, {backend: seconds/call})``.
    """
    import torch

    from ..core.bitops import pack_bits
    from ..kernels import clique_count, clique_list, ops as kops
    from ..kernels import triangle_mm

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    rng = np.random.default_rng(0)
    B = 4
    dense = rng.random((B, T, T)) < 0.5
    dense = np.triu(dense, 1)
    dense = dense | dense.transpose(0, 2, 1)
    A = torch.from_numpy(pack_bits(dense)).view(torch.int32).to(device)
    cand = torch.from_numpy(pack_bits(np.ones((B, T), dtype=bool))).view(
        torch.int32).to(device)
    cap = min(int(capacity), DEFAULT_MAX_CAPACITY) if capacity else 64

    def plain():
        if mode == "list":
            return clique_list.clique_list_tiles_torch(A, cand, l, cap)
        if l == 3:
            return triangle_mm.triangle_count_tiles_torch(A, cand)
        return clique_count.clique_count_tiles_torch(A, cand, l)

    def kernel():
        if mode == "list":
            return kops.list_tiles(A, cand, l, cap, backend="cuda")
        return kops.count_tiles(A, cand, l, backend="cuda")

    candidates = {"torch": plain}
    if device.type == "cuda":
        candidates = {"cuda": kernel, "torch": plain}
    times: Dict[str, float] = {}
    for name, run in candidates.items():
        run()  # warm-up: the kernel's first launch loads it
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(trials):
            run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times[name] = (time.perf_counter() - t0) / trials
    winner = min(times, key=times.get)
    return winner, times


# ---------------------------------------------------------------------------
# geometry coordinate descent
# ---------------------------------------------------------------------------

#: a candidate must beat the incumbent by this factor to displace it --
#: hysteresis that keeps the defaults in place under measurement noise
#: (and makes "tuned never loses to default" hold by construction)
MIN_GAIN = 1.02


def _default_graph(scale: int = 9):
    from ..data.graphs import rmat_graph

    return rmat_graph(scale, 6, seed=7)


def _eval_geometry(g, plan, mode: str, k: int, geom: Geometry,
                   backend: Optional[str], device=None) -> float:
    """Items/s of one geometry candidate on the synthetic sweep workload.

    Two runs; the first pays whatever one-time cost the candidate's new
    tile widths bring (the kernels' first launches), the second is the
    measurement.  Plan prebuilt, plan cache bypassed: only the knobs under
    test vary.
    """
    from ..core import engine_torch, listing

    kw = dict(batch_size=geom.batch_size, bins=geom.bins,
              pack_workers=geom.pack_workers, prefetch=geom.prefetch,
              backend=backend, plan_cache=False, device=device)
    best = float("inf")
    items = 1
    for i in range(2):
        t0 = time.perf_counter()
        if mode == "list":
            sink = listing.CallbackSink(lambda rows: None)
            res = listing.stream_cliques(
                plan, k, sink, cap_policy=geom.cap_policy,
                max_capacity=geom.max_capacity, **kw)
            items = max(1, res.stats.emitted_cliques)
        else:
            r = engine_torch.count(plan.g, k, plan=plan, **kw)
            items = max(1, r.tiles)
        dt = time.perf_counter() - t0
        if i:  # first run is the warm-up
            best = min(best, dt)
    return items / max(best, 1e-9)


def tune_geometry(mode: str, l: int, *, budget_s: float = 20.0,
                  graph=None, backend: Optional[str] = None,
                  persist: bool = True, device=None) -> TuningRecord:
    """Budgeted coordinate descent over the pipeline shape knobs.

    Starts from the hardcoded defaults, sweeps one knob at a time on a
    synthetic workload (rmat scale 9 unless ``graph`` is given) on
    ``device`` (default: the CUDA device), adopts a candidate only on a
    > :data:`MIN_GAIN` measured win, and stops when ``budget_s`` of search
    time is spent or a full pass makes no change.  Emits (and, with
    ``persist``, writes through the tuning cache) one geometry record that
    :func:`resolve_geometry` then serves as the defaults for every later
    query of this (device kind, mode, l).
    """
    from ..core import pipeline

    g = graph if graph is not None else _default_graph()
    k = l + 2
    plan = pipeline.build_plan(g, order="hybrid")
    t_start = time.perf_counter()
    geom = Geometry()
    base_tp = _eval_geometry(g, plan, mode, k, geom, backend, device)
    best_tp = base_tp
    knobs: List[Tuple[str, list]] = [
        ("t_policy", ["mult32"]),
        ("batch_size", [64, 128, 512]),
        ("pack_workers", [0, 2]),
    ]
    if mode == "list":
        knobs.append(("cap_policy", ["mult64"]))
        knobs.append(("max_capacity", [1 << 12]))
    evals = 1
    improved = True
    while improved and time.perf_counter() - t_start < budget_s:
        improved = False
        for name, alts in knobs:
            for val in alts:
                if time.perf_counter() - t_start >= budget_s:
                    break
                if getattr(geom, name) == val:
                    continue
                cand = dataclasses.replace(geom, **{name: val})
                tp = _eval_geometry(g, plan, mode, k, cand, backend, device)
                evals += 1
                if tp > best_tp * MIN_GAIN:
                    geom, best_tp, improved = cand, tp, True
    search_s = time.perf_counter() - t_start
    rec = TuningRecord(
        "geometry", _rec.device_kind(), _rec.torch_version(), mode, int(l),
        data={**dataclasses.asdict(geom),
              "searched": True, "search_s": search_s, "evals": evals,
              "throughput": best_tp, "baseline_throughput": base_tp})
    if persist:
        _cache.put(rec)
    return rec
