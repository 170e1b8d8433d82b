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

// Words 0..W-1 of one row through the read-only path, by 16-byte loads
// where a row has four or more, 8-byte loads at W = 2.  The row must start
// on a multiple of 4 * W bytes (so of 16 at W >= 4), as every row of an
// aligned (B, T, W) tile does.
template <int W>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ p, uint32_t (&x)[W]) {
  if constexpr (W >= 4) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + q);
      x[4 * q] = t.x;
      x[4 * q + 1] = t.y;
      x[4 * q + 2] = t.z;
      x[4 * q + 3] = t.w;
    }
  } else if constexpr (W == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = __ldg(p);
  }
}

}  // namespace repro_torch
