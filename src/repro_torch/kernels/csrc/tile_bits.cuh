// Packed-bitset helpers shared by the clique kernels.
//
// A tile is a (T, W = T/32) array of 32-bit words: bit j of word w of row v
// is set when local vertices v and 32*w + j are adjacent.  Tensors arrive as
// int32 views and are read here as uint32.
#pragma once

#include <cstdint>

namespace repro_torch {

constexpr int kMaxT = 256;           // widest pipeline bin
constexpr int kMaxW = kMaxT / 32;    // words per row at the widest bin
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

}  // namespace repro_torch
