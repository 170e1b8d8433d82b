// Per-tile triangle count of the candidate-induced subgraph (k = 5, l = 3).
//
// Replaces: the Pallas kernel repro/kernels/triangle_mm.py,
//   triangle_count_tiles (_kernel), which counts sum((M @ M) * M) / 6 on the
//   MXU in bf16 with f32 accumulation.
// Same function: repro/kernels/common.py triangles_within (and its torch
//   twin repro_torch/kernels/common.py triangles_within, which the plain
//   version triangle_count_tiles_torch batches).
// Bound on the H100: one tile is at most 8 KB of words and the work is
//   AND + popcount over those words, one pass per induced edge; at the
//   pipeline's batch of 256 tiles the input is 0.25-2 MB, so a launch is
//   bound by latency and by the integer (ALU/popc) issue rate, not by HBM.
//   Most main-path tiles reach the kernel with an empty cand (the 2-plex
//   router zeroes them), so a tile that has no work must cost next to
//   nothing.
// Every design counts each triangle v < u < w once, at its edge (v, u):
//   popc(U_v & U_u) with U_v = A_v & cand & gt(v) the row's upper
//   neighbours inside cand (rows outside cand are 0).  Integer arithmetic
//   keeps it exact at every bin (the MXU form relied on 6*C(256,3) < 2^24),
//   and the count is written zero-extended into an int64 output, so the
//   wrapper runs no op after the launch.  The entry point picks the design
//   by T:
//   - tri_warp_rows, T = 32 and 64: a warp per tile, several tiles a
//     block, no shared memory and no __syncthreads.  Lane j holds U_j
//     (and U_{j+32} at T = 64) in registers.  An unrolled warp-uniform
//     loop over u fetches U_u by __shfl_sync (a word that no row holds, as
//     under an empty cand, is skipped); a lane whose row holds u adds
//     popc(U_v & U_u).  __reduce_add_sync sums the lanes.
//   - tri_block_rows, T >= 96: a block of 32 warps per tile.  The rows
//     are masked once into shared memory, word-major, so that 32 lanes reading
//     32 consecutive rows' word w hit 32 banks.  Warps take the rows v in
//     a stride (W = 3..8 rows a warp: a row's steps wait on shared-memory
//     loads, so many short row lists in flight beat a few long ones);
//     within a row lane L takes the vertices u = 32 * w + L, so the set
//     bits of a dense row spread over 32 lanes, and does the (W - w)-word
//     AND + popcount.  Sums go warp first, then block.  A tile with an
//     empty cand writes 0 at once.
//   The first port's design (a 256-thread block per tile, thread v walking
//   row v) was slower than both at every bin on the H100 (PERF.md) and is
//   gone.
//   - tri_wide, T > 256 (W > 8): tri_block_rows' block of 32 warps per
//     tile and its split of the work, with W a runtime argument and no
//     shared copy of the rows (T * W * 4 = T^2 / 8 bytes: 128 KB at
//     T = 1024, past the card's 227 KB from T = 1376).  A warp reads its
//     row v (one broadcast address a word) and lane L the rows u it takes
//     through L1/L2, and masks them with cand (read-only path) on the fly:
//     U_v & U_u = A_v & A_u & cand & gt(u), since gt(u) lies inside gt(v).
//     One instantiation serves every W > 8, so the build does not grow
//     with the widths.
#include <cuda_runtime.h>

#include "tile_bits.cuh"

namespace repro_torch {
namespace {

constexpr int kWarpTiles = 2;    // tiles (warps) a block in tri_warp_rows
constexpr int kBlockWarps = 32;  // warps a block (one tile) in tri_block_rows

__device__ __forceinline__ void store_count(long long* out, int b, uint32_t count) {
  out[b] = static_cast<long long>(count);  // zero-extended uint32
}

// tri_warp_rows: one warp per tile.  Lane j holds rows v = j + 32 h for
// h < W; row v has no bits in words below h (gt(v) clears them), so
// r[h][w] with w < h stays 0.
template <int W>
__global__ void __launch_bounds__(kWarpTiles * 32)
tri_warp_rows(const uint32_t* __restrict__ A, const uint32_t* __restrict__ cand,
              long long* __restrict__ out, int B) {
  constexpr int T = 32 * W;
  const int b = blockIdx.x * kWarpTiles + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;  // the whole warp leaves together
  const uint32_t* At = A + static_cast<size_t>(b) * T * W;
  uint32_t c[W];
#pragma unroll
  for (int w = 0; w < W; ++w) c[w] = __ldg(cand + static_cast<size_t>(b) * W + w);
  uint32_t r[W][W];
#pragma unroll
  for (int h = 0; h < W; ++h) {
    const int v = lane + 32 * h;
    uint32_t x[W];
    load_row<W>(At + v * W, x);
    const bool in = (c[h] >> lane) & 1u;
#pragma unroll
    for (int w = 0; w < W; ++w) r[h][w] = in ? (x[w] & c[w] & gt_word(v, w)) : 0u;
  }
  uint32_t acc = 0;
#pragma unroll
  for (int wu = 0; wu < W; ++wu) {
    // skip the word when no row holds a vertex of it (an empty cand)
    uint32_t any = 0;
#pragma unroll
    for (int h = 0; h < W; ++h) any |= r[h][wu];
    if (!__any_sync(kFullMask, any != 0u)) continue;
    // unrolled, so the 32 shuffles overlap instead of waiting in turn
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      uint32_t ru[W];  // U_u for u = 32 * wu + j, held by lane j as row h = wu
#pragma unroll
      for (int w = wu; w < W; ++w) ru[w] = __shfl_sync(kFullMask, r[wu][w], j);
#pragma unroll
      for (int h = 0; h <= wu; ++h) {  // rows h > wu hold no bit of word wu
        if ((r[h][wu] >> j) & 1u) {
#pragma unroll
          for (int w = wu; w < W; ++w) acc += __popc(r[h][w] & ru[w]);
        }
      }
    }
  }
  acc = __reduce_add_sync(kFullMask, acc);
  if (lane == 0) store_count(out, b, acc);
}

// tri_block_rows: one block of kBlockWarps warps per tile.
template <int W>
__global__ void __launch_bounds__(kBlockWarps * 32)
tri_block_rows(const uint32_t* __restrict__ A, const uint32_t* __restrict__ cand,
               long long* __restrict__ out) {
  constexpr int T = 32 * W;
  __shared__ uint32_t rows[W * T];  // word-major: rows[w * T + v] = word w of U_v
  __shared__ uint32_t warp_sums[kBlockWarps];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t* At = A + static_cast<size_t>(b) * T * W;
  uint32_t c[W];
  bool empty = true;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    c[w] = __ldg(cand + static_cast<size_t>(b) * W + w);
    empty &= c[w] == 0u;
  }
  if (empty) {  // block-uniform: nothing in the tile
    if (threadIdx.x == 0) store_count(out, b, 0u);
    return;
  }
  for (int v = threadIdx.x; v < T; v += kBlockWarps * 32) {
    uint32_t x[W];
    load_row<W>(At + v * W, x);
    const bool in = has_bit(c, v);
#pragma unroll
    for (int w = 0; w < W; ++w) rows[w * T + v] = in ? (x[w] & c[w] & gt_word(v, w)) : 0u;
  }
  __syncthreads();

  uint32_t acc = 0;
#pragma unroll 4
  for (int i = 0; i < T / kBlockWarps; ++i) {  // rows v = warp + i * kBlockWarps
    const int v = warp + i * kBlockWarps;
    uint32_t rv[W];  // U_v, the same word for every lane (a broadcast read)
#pragma unroll
    for (int w = 0; w < W; ++w) rv[w] = rows[w * T + v];
#pragma unroll
    for (int wu = 0; wu < W; ++wu) {
      if ((rv[wu] >> lane) & 1u) {
        const int u = 32 * wu + lane;
#pragma unroll
        for (int w = wu; w < W; ++w) acc += __popc(rv[w] & rows[w * T + u]);
      }
    }
  }
  acc = __reduce_add_sync(kFullMask, acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = lane < kBlockWarps ? warp_sums[lane] : 0u;
    s = __reduce_add_sync(kFullMask, s);
    if (lane == 0) store_count(out, b, s);
  }
}

// tri_wide: one block of kBlockWarps warps per tile, W > 8 words a row.
__global__ void __launch_bounds__(kBlockWarps * 32)
tri_wide(const uint32_t* __restrict__ A, const uint32_t* __restrict__ cand,
         long long* __restrict__ out, int T) {
  __shared__ uint32_t warp_sums[kBlockWarps];
  const int W = T >> 5;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t* At = A + static_cast<size_t>(b) * T * W;
  const uint32_t* cb = cand + static_cast<size_t>(b) * W;
  int any = 0;
  for (int w = threadIdx.x; w < W; w += kBlockWarps * 32) any |= __ldg(cb + w) != 0u;
  if (!__syncthreads_or(any)) {  // block-uniform: nothing in the tile
    if (threadIdx.x == 0) store_count(out, b, 0u);
    return;
  }
  uint32_t acc = 0;
  for (int v = warp; v < T; v += kBlockWarps) {
    if (!((__ldg(cb + (v >> 5)) >> (v & 31)) & 1u)) continue;  // warp-uniform
    const uint32_t* Av = At + static_cast<size_t>(v) * W;
    for (int wu = v >> 5; wu < W; ++wu) {
      const uint32_t uv = __ldg(Av + wu) & __ldg(cb + wu) & gt_word(v, wu);
      if (!((uv >> lane) & 1u)) continue;
      const int u = 32 * wu + lane;
      const uint32_t* Au = At + static_cast<size_t>(u) * W;
      for (int w = wu; w < W; ++w)
        acc += __popc(__ldg(Av + w) & __ldg(Au + w) & __ldg(cb + w) & gt_word(u, w));
    }
  }
  acc = __reduce_add_sync(kFullMask, acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = lane < kBlockWarps ? warp_sums[lane] : 0u;
    s = __reduce_add_sync(kFullMask, s);
    if (lane == 0) store_count(out, b, s);
  }
}

template <int W>
int launch(const uint32_t* A, const uint32_t* cand, long long* out, int B, cudaStream_t stream) {
  if constexpr (W <= 2) {
    tri_warp_rows<W><<<(B + kWarpTiles - 1) / kWarpTiles, kWarpTiles * 32, 0, stream>>>(A, cand,
                                                                                     out, B);
  } else {
    tri_block_rows<W><<<B, kBlockWarps * 32, 0, stream>>>(A, cand, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// A: (B, T, T/32) words, cand: (B, T/32), out: (B,) int64, all device
// pointers; T a positive multiple of 32 (W = 1..8 by their own
// instantiations, wider tiles by tri_wide).  Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for another T).
extern "C" int triangle_count_tiles_launch(const void* A, const void* cand, void* out, int B,
                                           int T, void* stream) {
  using namespace repro_torch;
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const auto* a = static_cast<const uint32_t*>(A);
  const auto* c = static_cast<const uint32_t*>(cand);
  auto* o = static_cast<long long*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 32: return launch<1>(a, c, o, B, st);
    case 64: return launch<2>(a, c, o, B, st);
    case 96: return launch<3>(a, c, o, B, st);
    case 128: return launch<4>(a, c, o, B, st);
    case 160: return launch<5>(a, c, o, B, st);
    case 192: return launch<6>(a, c, o, B, st);
    case 224: return launch<7>(a, c, o, B, st);
    case 256: return launch<8>(a, c, o, B, st);
    default:
      if (T < 256 || T % 32) return static_cast<int>(cudaErrorInvalidValue);
      tri_wide<<<B, kBlockWarps * 32, 0, st>>>(a, c, o, T);
      return static_cast<int>(cudaGetLastError());
  }
}
