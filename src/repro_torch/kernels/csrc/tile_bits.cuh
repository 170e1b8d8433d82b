// Packed-bitset helpers shared by the clique kernels.
//
// A tile is a (T, W = T/32) array of 32-bit words: bit j of word w of row v
// is set when local vertices v and 32*w + j are adjacent.  Tensors arrive as
// int32 views and are read here as uint32.
#pragma once

#include <cstdint>

namespace repro_torch {

constexpr unsigned kFullMask = 0xFFFFFFFFu;

// Word w of gt(u): the bits of the vertices strictly above u.
__device__ __forceinline__ uint32_t gt_word(int u, int w) {
  const int uw = u >> 5;
  if (w < uw) return 0u;
  if (w > uw) return 0xFFFFFFFFu;
  const int b = u & 31;
  return b == 31 ? 0u : (0xFFFFFFFFu << (b + 1));
}

__device__ __forceinline__ bool has_bit(const uint32_t* set, int v) {
  return (set[v >> 5] >> (v & 31)) & 1u;
}

// The bytes a row of W words is aligned to in an aligned (B, T, W) tile:
// rows start 4 * W bytes apart, so the largest power of two dividing 4 * W,
// at most 16 (16 at W = 4 and 8, 8 at W = 2 and 6, 4 at W = 1, 3, 5 and 7).
// The wrappers demand it of a tile's start (common.py row_alignment).
template <int W>
__host__ __device__ constexpr int row_align() {
  return (4 * W) % 16 == 0 ? 16 : (4 * W) % 8 == 0 ? 8 : 4;
}

// Words 0..W-1 of one row through the read-only path, by the widest loads
// its alignment allows: W / 4 16-byte loads at W = 4 and 8, W / 2 8-byte
// loads at W = 2 and 6, W 4-byte loads at odd W.  The row must start on a
// multiple of row_align<W>() bytes, as every row of an aligned tile does.
template <int W>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ p, uint32_t (&x)[W]) {
  if constexpr (row_align<W>() == 16) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + q);
      x[4 * q] = t.x;
      x[4 * q + 1] = t.y;
      x[4 * q + 2] = t.z;
      x[4 * q + 3] = t.w;
    }
  } else if constexpr (row_align<W>() == 8) {
#pragma unroll
    for (int q = 0; q < W / 2; ++q) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p) + q);
      x[2 * q] = t.x;
      x[2 * q + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) x[w] = __ldg(p + w);
  }
}

}  // namespace repro_torch
