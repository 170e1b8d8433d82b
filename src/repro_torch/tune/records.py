"""Tuning-record schema: what the persistent autotuner knows, versioned.

The port of ``repro/tune/records.py``.  A :class:`TuningRecord` is one
persisted fact about the hardware this process runs on.  Two kinds exist:

* ``kind="backend"`` -- the times of the CUDA kernel and of its plain torch
  version for one kernel signature ``(mode, l, T, W, capacity bucket)`` on
  one device kind, and the faster of the two.  Consulted by
  ``backend="autotune"`` (:mod:`repro_torch.kernels.ops`) before any live
  microbenchmark runs, so a warm process never re-measures.
* ``kind="geometry"`` -- the shape knobs of the pipeline: tile-width
  rounding policy, batch size, emit-capacity rounding and cap, pack
  workers / prefetch depth.  Emitted by the coordinate-descent search
  (:mod:`repro_torch.tune.search`) and read back as the *defaults* of
  ``engine_torch.count`` / ``listing.stream_cliques`` whenever the caller
  leaves those knobs ``None``.

Records are keyed per (device kind, torch version, mode, l[, T, W,
capacity bucket]): a record measured on one card, one torch/CUDA build or
one capacity regime never answers for another.  The device kind is the
card's name (``torch.cuda.get_device_name()``, "cpu" without a card) and
the version key is the torch version with its CUDA version.
:data:`FORMAT` is the port's own; a record of the reference (which keys
on the jax version) never parses here.  Readers treat a mismatched or
unreadable record as absent and fall back to a live measurement.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional

import torch

#: serialized tuning-record layout version of the port; bump on any schema
#: change so a stale on-disk record is re-measured instead of misread
FORMAT = 1


def device_kind() -> str:
    """The card this process runs its kernels on (its name), or "cpu"
    without one.  Part of every tuning-record key."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name()
    return "cpu"


def torch_version() -> str:
    """The torch build and the CUDA version it was built with, e.g.
    ``2.11.0+cu128/cuda-12.8`` (``/cuda-None`` for a CPU build)."""
    return f"{torch.__version__}/cuda-{torch.version.cuda}"


def capacity_bucket(capacity: Optional[int]) -> int:
    """Fold a listing capacity into its pow2 regime (-1 = counting mode).

    Capacities inside one bucket share one tuning record; capacities in
    different buckets (say 64 vs 16384 rows) can have different winners.
    """
    if capacity is None:
        return -1
    return max(0, int(capacity) - 1).bit_length()


@dataclasses.dataclass
class TuningRecord:
    """One persisted tuning fact (see module docstring for the two kinds)."""

    kind: str                 # "backend" | "geometry"
    device_kind: str
    torch_version: str
    mode: str                 # "count" | "list"
    l: int
    T: int = 0                # backend records: tile width (0 = n/a)
    W: int = 0                # backend records: word count (0 = n/a)
    cap_bucket: int = -1      # backend records: capacity regime (-1 = count)
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def key(self) -> str:
        """Stable record key; the on-disk store hashes it into a dirname."""
        return (f"v{FORMAT}:{self.kind}:{self.device_kind}:"
                f"{self.torch_version}:{self.mode}:l{self.l}:T{self.T}:"
                f"W{self.W}:c{self.cap_bucket}")

    def to_meta(self) -> Dict[str, Any]:
        return {"format": FORMAT, "record": dataclasses.asdict(self)}

    @staticmethod
    def from_meta(meta: Dict[str, Any]) -> Optional["TuningRecord"]:
        """Parse store metadata; None on any format/shape mismatch."""
        if not isinstance(meta, dict) or meta.get("format") != FORMAT:
            return None
        rec = meta.get("record")
        if not isinstance(rec, dict):
            return None
        try:
            return TuningRecord(**rec)
        except TypeError:
            return None


def backend_key(mode: str, l: int, T: int,
                capacity: Optional[int] = None) -> str:
    """Key of the backend-winner record for one kernel signature."""
    return TuningRecord(
        "backend", device_kind(), torch_version(), mode, int(l), T=int(T),
        W=int(T) // 32, cap_bucket=capacity_bucket(capacity)).key()


def geometry_key(mode: str, l: int) -> str:
    """Key of the geometry record the engines read their defaults from."""
    return TuningRecord(
        "geometry", device_kind(), torch_version(), mode, int(l)).key()


def key_digest(key: str) -> str:
    """Filesystem-safe digest of a record key (store subdirectory name)."""
    return hashlib.sha256(key.encode()).hexdigest()[:24]
