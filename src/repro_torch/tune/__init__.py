"""Persistent geometry/backend autotuner (the port of ``repro.tune``).

Light imports only: :mod:`~repro_torch.tune.records` (schema + keys) and
:mod:`~repro_torch.tune.cache` (persisted record store + the kernel build
directory).  The search machinery (:mod:`~repro_torch.tune.search`) pulls
in the engines and is imported lazily by its callers.
"""
from .cache import (ENV_TUNE_CACHE, active_dir, clear_memory, configure,
                    consume_events, enable_compilation_cache, get, note_event,
                    put)
from .records import (FORMAT, TuningRecord, backend_key, capacity_bucket,
                      device_kind, geometry_key, key_digest, torch_version)

__all__ = [
    "ENV_TUNE_CACHE", "FORMAT", "TuningRecord",
    "active_dir", "backend_key", "capacity_bucket", "clear_memory",
    "configure", "consume_events", "device_kind", "enable_compilation_cache",
    "geometry_key", "get", "key_digest", "note_event", "put",
    "torch_version",
]
