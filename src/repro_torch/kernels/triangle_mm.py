"""Per-tile triangle counting: the k = 5 (l = 3) kernel of the main path.

Port of the Pallas kernel ``repro/kernels/triangle_mm.py``
(``triangle_count_tiles``), which counts ``sum((M @ M) * M) / 6`` on the
MXU.  On Hopper the kernel is hand-written CUDA
(``csrc/triangle_count.cu``): it computes the same per-tile count as the
integer bitset form ``common.triangles_within`` -- exact at every bin, no
bf16/f32 margin to rely on -- with a warp per tile at T <= 64 and a block
per tile above, and writes the counts as int64 itself, so a call is one
launch.  The matmul form survives only as a yardstick that
``chip_smoke.py`` times beside the kernel.

:func:`triangle_count_tiles` is the wrapper: a CUDA tensor goes to the
kernel, a CPU tensor to the plain version :func:`triangle_count_tiles_torch`.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .common import (Timing, check_tiles, count_call, gt_masks,
                     launch_events, triangles_within_chunked, widen)

#: kernel launches so far (the wrapper adds one per launch, nowhere else)
launches = 0
#: calls of the plain version so far
plain_calls = 0


def triangle_count_tiles_torch(A: torch.Tensor,
                               cand: torch.Tensor) -> torch.Tensor:
    """Plain torch version: (B,T,W), (B,W) int32 -> (B,) int64 counts.

    Batched ``triangles_within``, chunked over B so the (b, T, T, W) int64
    pair intersection stays under about 256 MB.
    """
    count_call(__name__, "plain_calls")
    _, T, _ = check_tiles(A, cand)
    return triangles_within_chunked(widen(A), widen(cand), gt_masks(T, A.device))


def triangle_count_tiles(A: torch.Tensor, cand: torch.Tensor,
                         timing: Optional[Timing] = None) -> torch.Tensor:
    """(B, T, W) int32, (B, W) int32 -> (B,) int64 per-tile triangle counts
    (uint32 values, as the reference returns them).  On a CUDA tensor,
    ``timing`` (:func:`~repro_torch.kernels.common.timing_events`) is
    recorded around the launch."""
    B, T, _ = check_tiles(A, cand)
    if A.device.type == "cpu":
        return triangle_count_tiles_torch(A, cand)
    if A.device.type != "cuda":
        raise ValueError(f"no triangle kernel for device {A.device}")
    out = torch.empty(B, dtype=torch.int64, device=A.device)
    events = launch_events(timing, 1 if B else 0, A.device)
    if B:
        so = _build.lib()
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = so.triangle_count_tiles_launch(
                A.data_ptr(), cand.data_ptr(), out.data_ptr(), B, T, stream,
                *events[0])
        if rc:
            raise RuntimeError(f"triangle_count_tiles launch failed: CUDA "
                               f"error {rc}")
        count_call(__name__, "launches")
    return out
