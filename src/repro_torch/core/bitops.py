"""Bit-manipulation helpers for both engines of the PyTorch port.

Host engine: arbitrary-precision python ints as bitsets (C-speed AND /
popcount via ``int.bit_count``), as in the reference package.  Device
engine: packed 32-bit words.  The port carries packed words as
``torch.int32`` (the zero-copy view of the pipeline's ``uint32`` arrays);
the CUDA kernels reinterpret them as unsigned.  The torch helpers at the
bottom work on words widened to int64 with ``& 0xFFFFFFFF``, because torch
has no popcount and ``torch.uint32`` on the CPU has no shifts, subtraction
or ordering.
"""

from __future__ import annotations

import sys
from typing import Iterator, Sequence

import numpy as np
import torch

WORD = 32

#: mask that widens an int32 word view to its unsigned value in int64
MASK32 = 0xFFFFFFFF

_LITTLE = sys.byteorder == "little"


# ---------------------------------------------------------------------------
# python-int bitsets (host recursion)
# ---------------------------------------------------------------------------


def bits(x: int) -> Iterator[int]:
    """Iterate set bit positions of a python-int bitset (ascending)."""
    while x:
        lsb = x & -x
        yield lsb.bit_length() - 1
        x ^= lsb


def popcount(x: int) -> int:
    return x.bit_count()


def mask_gt(i: int) -> int:
    """Bits {i+1, i+2, ...} up to a practical width handled by callers."""
    return -1 << (i + 1)  # python ints: arbitrarily wide; AND with cand clips


# ---------------------------------------------------------------------------
# packed uint32 words (numpy, host side of the device tiles)
# ---------------------------------------------------------------------------


def num_words(T: int) -> int:
    if T % WORD:
        raise ValueError("tile size must be a multiple of 32")
    return T // WORD


def pack_bits(dense: np.ndarray) -> np.ndarray:
    """(..., T) bool -> (..., T//32) uint32; bit j of word w = column 32w+j."""
    packed = np.packbits(dense, axis=-1, bitorder="little")
    if not _LITTLE:  # pragma: no cover - big-endian hosts
        shape = packed.shape
        packed = packed.reshape(shape[:-1] + (-1, 4))[..., ::-1].reshape(shape)
    return np.ascontiguousarray(packed).view(np.uint32)


def gt_masks_np(T: int) -> np.ndarray:
    """(T, W) uint32: gt[v] has exactly the bits {v+1, ..., T-1} set."""
    dense = np.arange(T)[None, :] > np.arange(T)[:, None]
    return pack_bits(dense)


def pack_rows(rows: Sequence[int], T: int) -> np.ndarray:
    """python-int bitset rows -> (T, T//WORD) uint32 (pad with zeros)."""
    W = (T + WORD - 1) // WORD
    out = np.zeros((T, W), dtype=np.uint32)
    full = (1 << WORD) - 1
    for i, r in enumerate(rows):
        for w in range(W):
            out[i, w] = (r >> (w * WORD)) & full
    return out


def pack_mask(mask: int, T: int) -> np.ndarray:
    W = (T + WORD - 1) // WORD
    out = np.zeros((W,), dtype=np.uint32)
    full = (1 << WORD) - 1
    for w in range(W):
        out[w] = (mask >> (w * WORD)) & full
    return out


def unpack_mask(words: np.ndarray) -> int:
    x = 0
    for w, v in enumerate(np.asarray(words, dtype=np.uint64).tolist()):
        x |= int(v) << (w * WORD)
    return x


# ---------------------------------------------------------------------------
# torch word helpers (int64 words holding unsigned 32-bit values)
# ---------------------------------------------------------------------------


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 word view -> int64 unsigned word values."""
    return x.to(torch.int64) & MASK32


def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int64 words in [0, 2**32) (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def unpack_bits(x: torch.Tensor, T: int) -> torch.Tensor:
    """(..., W) int64 words -> (..., T) {0,1} int64 (bit j of word w -> 32w+j)."""
    shifts = torch.arange(WORD, dtype=torch.int64, device=x.device)
    out = (x[..., None] >> shifts) & 1
    return out.reshape(*x.shape[:-1], T)


def bit_at(x: torch.Tensor, v) -> torch.Tensor:
    """Bit v (int or int64 tensor, broadcast over leading dims) of packed
    (..., W) int64 words."""
    v = torch.as_tensor(v, dtype=torch.int64, device=x.device)
    word = torch.gather(x, -1, (v // WORD).expand(x.shape[:-1]).unsqueeze(-1))
    return (word.squeeze(-1) >> (v % WORD)) & 1


def gt_masks(T: int, device=None) -> torch.Tensor:
    """(T, W) int64 gt masks on ``device`` (see :func:`gt_masks_np`)."""
    return torch.from_numpy(gt_masks_np(T).astype(np.int64)).to(device)
