"""Shared helpers for the clique kernels of the PyTorch port.

Plain torch forms of the reference's base-case set math
(``repro/kernels/common.py``): the edge and triangle counts of a
candidate-induced subgraph, on packed words widened to int64 (see
:mod:`repro_torch.core.bitops`).  They are batched over any leading
dimensions, and they are the arithmetic that the CUDA kernels in ``csrc/``
reproduce.  Also here: the fixed-capacity emit scatters of the listing
kernel (``emit_frontier``, ``emit_edges``, ``emit_triangles``), the input
checks every kernel wrapper shares, the lock its launch counters take, and
the host Pascal table of the closed-form 2-plex count.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.bitops import (  # noqa: F401  (re-exported kernel API)
    MASK32,
    WORD,
    gt_masks,
    gt_masks_np,
    num_words,
    popcount_words,
    unpack_bits,
    widen,
)

#: guards every kernel module's launch and plain-call counters: the
#: listing dispatcher's decode worker launches kernels beside the thread
#: that submits, and ``+= 1`` on a module global is not atomic
COUNTER_LOCK = threading.Lock()


def count_call(module: str, counter: str) -> None:
    """Add one to the counter ``counter`` of the kernel module named
    ``module`` (its ``__name__``), under :data:`COUNTER_LOCK`."""
    mod = sys.modules[module]
    with COUNTER_LOCK:
        setattr(mod, counter, getattr(mod, counter) + 1)


#: a pair of CUDA timing events, (start, end), that a kernel call records
#: around its device work (see :func:`timing_events`)
Timing = Tuple[torch.cuda.Event, torch.cuda.Event]


def timing_events(stream=None) -> Timing:
    """A (start, end) pair of CUDA timing events for a wrapper's ``timing=``.

    Both are recorded once on ``stream`` (the current stream by default),
    which creates them: the kernel library records them again by their
    handles, around its launches (:func:`launch_events`), and a handle
    exists only once torch has created the event.  Their elapsed time,
    read once the stream has passed ``end``, is the call's device time."""
    pair = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    for event in pair:
        event.record(stream)
    return pair


def launch_events(timing: Optional[Timing], n: int,
                  device: torch.device) -> List[tuple]:
    """The (start, end) event handles of each of a wrapper's ``n`` launches
    of the kernel library: ``timing``'s start on the first launch, its end
    on the last, None elsewhere (and everywhere without ``timing``).  The
    library records them on the launch stream inside the call, so no host
    work of the wrapper's falls between them.  With no launch (``n`` = 0)
    both are recorded now on ``device``'s current stream: the pair then
    brackets nothing."""
    if timing is None:
        return [(None, None)] * n
    start, end = timing
    if n == 0:
        stream = torch.cuda.current_stream(device)
        start.record(stream)
        end.record(stream)
        return []
    return [(start.cuda_event if i == 0 else None,
             end.cuda_event if i == n - 1 else None) for i in range(n)]


@contextlib.contextmanager
def record_around(timing: Optional[Timing], device: torch.device):
    """Record ``timing``'s pair from the host around the body, on
    ``device``'s current stream, for device work that torch ops enqueue
    (no kernel of the library); nothing without ``timing``."""
    if timing is None:
        yield
        return
    stream = torch.cuda.current_stream(device)
    timing[0].record(stream)
    yield
    timing[1].record(stream)


def member_rows(A: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Rows of the cand-induced subgraph: A[v] & cand, zeroed for v not in
    cand.  A: (..., T, W) int64 words, cand: (..., W).  Returns (..., T, W)."""
    T = A.shape[-2]
    vbit = unpack_bits(cand, T)                          # (..., T)
    rows = A & cand[..., None, :]
    return torch.where(vbit[..., None] > 0, rows, torch.zeros_like(rows))


def edges_within(A: torch.Tensor, cand: torch.Tensor,
                 gt: torch.Tensor) -> torch.Tensor:
    """Edge count of the cand-induced subgraph (each pair once), mod 2**32.

    A: (..., T, W) int64 words, cand: (..., W), gt: (T, W).  Returns (...,).
    """
    T = A.shape[-2]
    rows = A & cand[..., None, :] & gt                   # neighbors > v in cand
    per_v = popcount_words(rows).sum(-1)                 # (..., T)
    vbit = unpack_bits(cand, T)
    return (per_v * vbit).sum(-1) & MASK32


def triangles_within(A: torch.Tensor, cand: torch.Tensor,
                     gt: torch.Tensor) -> torch.Tensor:
    """Triangle count of the cand-induced subgraph (each once), mod 2**32.

    Every triangle v<u<w is attributed to its edge (v, u) and counted as
    |N(v) & N(u) & cand & gt(u)|: one (..., T, T, W) word AND + popcount.
    A: (..., T, W) int64 words, cand: (..., W), gt: (T, W).  Returns (...,).
    """
    T = A.shape[-2]
    rows = member_rows(A, cand)                          # (..., T, W)
    pair = rows[..., :, None, :] & rows[..., None, :, :] & gt
    cnt = popcount_words(pair).sum(-1)                   # (..., T, T)
    adj = unpack_bits(rows & gt, T)                      # edge v<u in cand
    return (adj * cnt).sum((-2, -1)) & MASK32


def triangles_within_chunked(A: torch.Tensor, cand: torch.Tensor,
                             gt: torch.Tensor,
                             budget: int = 256 << 20) -> torch.Tensor:
    """:func:`triangles_within` over a (B, T, W) batch, chunked over B so
    the (b, T, T, W) int64 pair intersection stays under ``budget`` bytes."""
    B, T, W = A.shape
    step = max(1, budget // (T * T * W * 8))
    out = torch.empty(B, dtype=torch.int64, device=A.device)
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        out[sl] = triangles_within(A[sl], cand[sl], gt)
    return out


# ---------------------------------------------------------------------------
# fixed-capacity emit scatters (the listing kernel's plain version)
# ---------------------------------------------------------------------------
#
# The reference scatters with ``count + cumsum(mask) - 1`` and drops ranks
# past ``capacity``; here ``nonzero`` lists each lane's set mask entries in
# ascending (lexicographic) order and the rank is the position within the
# lane, which is the same number.  The scatters write into ``buf`` and add
# to ``count`` IN PLACE (rows ``lanes`` of them, or every row), since the
# buffer of a listing batch is up to B x 16384 x l words and copying it on
# every DFS step would dominate.


def unpack_bool(x: torch.Tensor, T: int) -> torch.Tensor:
    """(..., W) int64 words -> (..., T) bool, bit j of word w at 32w + j.

    One bit plane at a time, so the peak is the bool result plus one
    word-sized plane (:func:`unpack_bits` builds an int64 value per bit)."""
    out = torch.empty((*x.shape, WORD), dtype=torch.bool, device=x.device)
    for j in range(WORD):
        out[..., j] = ((x >> j) & 1) > 0
    return out.reshape(*x.shape[:-1], T)


def _scatter_rows(buf: torch.Tensor, count: torch.Tensor, flat: torch.Tensor,
                  prefix: torch.Tensor, npfx: int, ncoord: int, T: int,
                  capacity: int, lanes: torch.Tensor = None) -> None:
    """Write row ``prefix[:npfx] + coords(i)`` for every set ``flat[n, i]``.

    flat: (n, T**ncoord) bool mask in lexicographic row order; the
    coordinates of entry i are its base-T digits.  Lane n's rows land at
    ``count + rank``; ranks at or past ``capacity`` are dropped while
    ``count`` takes the true total.  ``lanes`` maps the n lanes to rows of
    ``buf`` / ``count`` (default: all of them, in order).
    """
    if lanes is None:
        lanes = torch.arange(flat.shape[0], device=flat.device)
    per = flat.sum(-1)                                   # (n,)
    lane, i = flat.nonzero(as_tuple=True)                # lex order per lane
    if lane.numel():
        start = torch.cumsum(per, 0) - per
        rank = torch.arange(lane.numel(), device=flat.device) - start[lane]
        dest = count[lanes[lane]] + rank
        keep = dest < capacity
        lane, i, dest = lane[keep], i[keep], dest[keep]
        cols = [prefix[lane, :npfx]] if npfx else []
        digits = []
        for _ in range(ncoord):
            digits.append(i % T)
            i = i // T
        cols.extend(d[:, None] for d in reversed(digits))
        buf[lanes[lane], dest] = torch.cat(cols, 1).to(buf.dtype)
    count[lanes] += per


def emit_frontier(buf, count, cand, prefix, *, l: int, T: int,
                  capacity: int, lanes=None):
    """l' == 1 close: every cand vertex completes the prefix (one column).

    cand: (n, W) int64 words, prefix: (n, >= l-1) int64.  Writes ``buf``
    and ``count`` in place and returns them."""
    _scatter_rows(buf, count, unpack_bool(cand, T), prefix, l - 1, 1, T,
                  capacity, lanes)
    return buf, count


def emit_edges(buf, count, A, cand, gt, prefix, *, l: int, T: int,
               capacity: int, lanes=None):
    """l' == 2 close: every edge (u, w), u < w, of the cand-induced
    subgraph completes the prefix, in row-major (T, T) order.

    A: (n, T, W) int64 words, cand: (n, W), gt: (T, W).  In place."""
    rows = member_rows(A, cand) & gt
    e = unpack_bool(rows, T).reshape(rows.shape[0], T * T)
    _scatter_rows(buf, count, e, prefix, l - 2, 2, T, capacity, lanes)
    return buf, count


def emit_triangles(buf, count, A, cand, gt, prefix, *, l: int, T: int,
                   capacity: int, lanes=None, budget: int = 256 << 20):
    """Whole-tile triangle emit: every triangle (v, u, w), v < u < w, of the
    cand-induced subgraph completes the prefix, in lexicographic order.

    The (n, T, T, W) pair intersection ``rows[v] & rows[u] & gt[u]`` over
    the edges v < u is unpacked to a (T, T, T) bool mask, chunked over the
    lanes so each chunk stays under ``budget`` bytes.  In place."""
    n = A.shape[0]
    if lanes is None:
        lanes = torch.arange(n, device=A.device)
    W = A.shape[-1]
    step = max(1, budget // (T * T * (T + 2 * W * 8)))
    for b0 in range(0, n, step):
        sl = slice(b0, b0 + step)
        rows = member_rows(A[sl], cand[sl])              # (b, T, W)
        edge_vu = unpack_bool(rows & gt, T)              # (b, T, T)
        pair = rows[:, :, None, :] & rows[:, None, :, :] & gt
        pair = torch.where(edge_vu[..., None], pair, torch.zeros_like(pair))
        tri = unpack_bool(pair, T).reshape(pair.shape[0], T * T * T)
        _scatter_rows(buf, count, tri, prefix[sl], l - 3, 3, T, capacity,
                      lanes[sl])
    return buf, count


def to_words(x: torch.Tensor) -> torch.Tensor:
    """int64 words holding unsigned 32-bit values -> their int32 view."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def row_alignment(W: int) -> int:
    """Bytes a row of W words is aligned to in an aligned tile: the largest
    power of two that divides ``4 * W``, at most 16 (16 at W = 4 and 8, 8 at
    W = 2 and 6, 4 at odd W).  ``csrc/tile_bits.cuh`` ``load_row`` reads a
    row by loads of this width."""
    return min(16, (4 * W) & -(4 * W))


def check_adjacency(A: torch.Tensor) -> Tuple[int, int, int]:
    """Validate packed tiles for the kernels: a contiguous (B, T, T//32)
    int32 word view with T a positive multiple of 32.  Returns (B, T, W).

    On the card the kernels read a row by loads of :func:`row_alignment`
    bytes (``csrc/tile_bits.cuh`` ``load_row``), so a CUDA tensor must
    start on a multiple of that; an offset view that does not raises here
    instead of faulting on the card.
    """
    if A.dtype != torch.int32:
        raise TypeError(f"packed words must be an int32 view, got {A.dtype}")
    if A.dim() != 3:
        raise ValueError(f"A must be (B, T, W), got shape {tuple(A.shape)}")
    B, T, W = A.shape
    if T < WORD or T % WORD or W != T // WORD:
        raise ValueError(
            f"tile shape (T={T}, W={W}) must have T a positive multiple of "
            f"32 and W == T // 32")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    if A.device.type == "cuda":
        if A.data_ptr() % row_alignment(W):
            raise ValueError(f"A must start on a {row_alignment(W)}-byte "
                             f"boundary on the card (the kernels load whole "
                             f"rows)")
    return B, T, W


def check_tiles(A: torch.Tensor, cand: torch.Tensor) -> Tuple[int, int, int]:
    """Validate a packed batch for the kernels; returns (B, T, W).

    A as :func:`check_adjacency` takes it, and cand a contiguous
    (B, T//32) int32 view on the same device.
    """
    B, T, W = check_adjacency(A)
    if cand.dtype != torch.int32:
        raise TypeError(f"packed words must be an int32 view, got "
                        f"{cand.dtype}")
    if tuple(cand.shape) != (B, W):
        raise ValueError(
            f"cand must be ({B}, {W}), got shape {tuple(cand.shape)}")
    if A.device != cand.device:
        raise ValueError(f"A on {A.device} but cand on {cand.device}")
    if not cand.is_contiguous():
        raise ValueError("cand must be contiguous")
    return B, T, W


def pascal_table(nmax: int) -> np.ndarray:
    """C(n, r) table, int64, (nmax+1, nmax+1); entries that overflow clamp."""
    t = np.zeros((nmax + 1, nmax + 1), dtype=np.int64)
    t[:, 0] = 1
    for n in range(1, nmax + 1):
        for r in range(1, n + 1):
            v = t[n - 1, r - 1] + t[n - 1, r]
            t[n, r] = v
    return t
