"""Persistent tuning cache, and the kernel build directory beside it.

The port of ``repro/tune/cache.py``.  One directory (the ``--tune-cache
DIR`` knob, or the ``REPRO_TORCH_TUNE_CACHE`` environment variable) holds
what a warm process needs to skip the one-time costs:

* ``<dir>/records/<digest>/`` -- one :class:`~repro_torch.tune.records.TuningRecord`
  per kernel-signature/geometry key, written atomically through the
  format-versioned :mod:`repro_torch.checkpoint.store` writer (tmp dir +
  ``os.replace`` + ``COMMITTED`` marker).  Concurrent writers of the same
  key race benignly: ``os.replace`` is atomic, the last committed record
  wins, and a reader never observes a partial write.
* ``<dir>/kernels/`` -- the CUDA kernel library
  (:func:`enable_compilation_cache` points ``kernels/_build.py`` there),
  where the reference keeps JAX's persistent compilation cache.  The
  library is keyed by the hash of its sources, so it is built once per
  machine and source tree, not once per process.  Without a tune cache it
  stays in the git-ignored ``build/repro_torch/``.

Read path: an in-process dict in front of the on-disk store.  A corrupt,
stale-format, or foreign record reads as absent -- the caller falls back
to a live measurement and overwrites it.  Records are read at the
``tune.read`` fault site.  The environment variable is the port's own, as
``REPRO_TORCH_FAULT_PLAN`` is: the reference's ``REPRO_TUNE_CACHE`` does
not configure the port.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import numpy as np

from . import records as _rec
from ..obs import metrics as _metrics
from .records import TuningRecord

#: environment knob: equivalent to calling :func:`configure` at startup
ENV_TUNE_CACHE = "REPRO_TORCH_TUNE_CACHE"

_LOCK = threading.Lock()
_DIR: Optional[str] = None
_ENV_CHECKED = False
_MEM: Dict[str, TuningRecord] = {}
# the kernel build directory before the first enable_compilation_cache
_BUILD_DIR_BEFORE = None


def configure(directory: Optional[str], *, build_cache: bool = True) -> None:
    """Activate a persistent tune-cache directory for this process.

    Points the kernel build directory at ``<dir>/kernels``
    (``build_cache=False`` leaves it, for tests that must not move global
    state).  ``None`` deactivates the on-disk layer (the in-process dict
    survives) and points the kernel build directory back where it was.
    """
    global _DIR, _ENV_CHECKED, _BUILD_DIR_BEFORE
    before = None
    with _LOCK:
        _ENV_CHECKED = True  # explicit configure beats the env knob
        if directory is not None:
            directory = os.path.abspath(directory)
            os.makedirs(os.path.join(directory, "records"), exist_ok=True)
        else:
            before, _BUILD_DIR_BEFORE = _BUILD_DIR_BEFORE, None
        _DIR = directory
    if directory is None:
        if before is not None:
            from ..kernels import _build
            _build.set_build_dir(before)
    elif build_cache:
        enable_compilation_cache(os.path.join(directory, "kernels"))


def active_dir() -> Optional[str]:
    """The configured cache directory, consulting the environment knob
    once."""
    global _ENV_CHECKED
    with _LOCK:
        if _DIR is not None or _ENV_CHECKED:
            return _DIR
        _ENV_CHECKED = True
    env = os.environ.get(ENV_TUNE_CACHE)
    if env:
        configure(env)
    return _DIR


def enable_compilation_cache(directory: str) -> bool:
    """Build and look up the CUDA kernel library under ``directory``.

    The port's compilation cache is the library itself: ``_build`` names
    it by the hash of the sources and flags, so a directory that already
    holds it skips the ``nvcc`` run.  A library already loaded in this
    process stays loaded.  Returns True.
    """
    global _BUILD_DIR_BEFORE
    from ..kernels import _build

    os.makedirs(directory, exist_ok=True)
    prev = _build.set_build_dir(directory)
    with _LOCK:
        if _BUILD_DIR_BEFORE is None:
            _BUILD_DIR_BEFORE = prev
    return True


def clear_memory() -> None:
    """Drop the in-process record layer (tests; disk records survive)."""
    with _LOCK:
        _MEM.clear()


# ---------------------------------------------------------------------------
# tuning-event accounting (drained into Stats.tune_s / tune_cache_hit)
# ---------------------------------------------------------------------------

_TUNE_S = 0.0
_TUNE_LOOKUPS = 0
_TUNE_MISSES = 0


def note_event(seconds: float = 0.0, lookup: bool = False,
               miss: bool = False) -> None:
    """Accrue one tuning event (same pattern as ops' compile accumulator).

    ``lookup`` marks a record consultation that *answered* from a cache
    layer; ``miss`` marks one that had to fall back to a live measurement
    (whose wall-clock lands in ``seconds``).  Geometry reads that find no
    record note nothing -- an untuned run is not a cache miss.
    """
    global _TUNE_S, _TUNE_LOOKUPS, _TUNE_MISSES
    with _LOCK:
        _TUNE_S += seconds
        if lookup:
            _TUNE_LOOKUPS += 1
        if miss:
            _TUNE_MISSES += 1
    if seconds:
        _metrics.REGISTRY.counter(
            "repro_tune_seconds_total",
            help="wall seconds spent in live tuning measurements",
        ).inc(seconds)
    if lookup:
        _metrics.REGISTRY.counter(
            "repro_tune_lookups_total",
            help="tuning-record consultations answered from a cache layer",
        ).inc()
    if miss:
        _metrics.REGISTRY.counter(
            "repro_tune_misses_total",
            help="tuning lookups that fell back to a live measurement",
        ).inc()


def consume_events() -> tuple:
    """Drain the accumulator -> ``(tune_s, lookups, misses)``.

    Engines call this where they drain ``ops.consume_compile_s`` and derive
    ``Stats.tune_cache_hit = lookups > 0 and misses == 0``.
    """
    global _TUNE_S, _TUNE_LOOKUPS, _TUNE_MISSES
    with _LOCK:
        out = (_TUNE_S, _TUNE_LOOKUPS, _TUNE_MISSES)
        _TUNE_S, _TUNE_LOOKUPS, _TUNE_MISSES = 0.0, 0, 0
    return out


def _record_dir(base: str, key: str) -> str:
    return os.path.join(base, "records", _rec.key_digest(key))


def get(key: str) -> Optional[TuningRecord]:
    """Record for ``key``: in-process layer, then the on-disk store.

    Any unreadable / stale-format / wrong-key record reads as None -- the
    caller re-measures and overwrites.  Never raises.
    """
    with _LOCK:
        got = _MEM.get(key)
    if got is not None:
        return got
    base = active_dir()
    if base is None:
        return None
    from ..checkpoint import store
    from ..resilience import inject

    try:
        inject.fire("tune.read")
        ckpt = store.restore_checkpoint(_record_dir(base, key),
                                        _corrupt_site="tune.read")
    except Exception:
        return None  # corrupt on-disk record: fall back to live measurement
    if ckpt is None:
        return None
    rec = TuningRecord.from_meta(ckpt.get("metadata"))
    if rec is None or rec.key() != key:
        return None
    with _LOCK:
        _MEM[key] = rec
    return rec


def put(rec: TuningRecord) -> None:
    """Persist one record (atomic, best-effort) and cache it in-process.

    Uses the checkpoint store's commit protocol; a concurrent writer of
    the same key is resolved by ``os.replace`` (last committed wins).
    Disk errors are swallowed -- the tuning cache is an accelerator, never
    a correctness dependency.
    """
    key = rec.key()
    with _LOCK:
        _MEM[key] = rec
    base = active_dir()
    if base is None:
        return
    from ..checkpoint import store

    try:
        store.save_checkpoint(
            _record_dir(base, key), 0,
            {"format": np.int64(_rec.FORMAT)}, metadata=rec.to_meta())
    except OSError:
        pass  # lost a same-key race or a full disk; next process re-measures
