"""Multi-tenant continuous-batching serving tier (DESIGN.md section 10).

The port's copy of ``repro/serve`` over the torch engines and their CUDA
lanes.

Admits concurrent ``(graph, k, mode, vertex-filter, max_out, deadline)``
requests, coalesces ready tiles from different requests into shared
fixed-shape device batches, and routes exact counts / byte-identical
clique rows back to per-request sinks under EDF/LPT scheduling.
"""

from .request import (
    ET_T,
    DeadlineExceeded,
    Request,
    RequestQueue,
    RequestResult,
    ServiceClosed,
    ServiceOverloaded,
    Ticket,
    apply_vertex_filter,
)
from .scheduler import BatchScheduler, ServeStats, edf_pick, fuse_chunks
from .service import CliqueService

__all__ = [
    "ET_T",
    "BatchScheduler",
    "CliqueService",
    "DeadlineExceeded",
    "Request",
    "RequestQueue",
    "RequestResult",
    "ServeStats",
    "ServiceClosed",
    "ServiceOverloaded",
    "Ticket",
    "apply_vertex_filter",
    "edf_pick",
    "fuse_chunks",
]
