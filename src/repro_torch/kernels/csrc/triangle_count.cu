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
// Design: one CTA per tile, 256 threads.  The tile is staged in shared
//   memory already masked by cand on rows and columns, so the inner loop
//   needs no cand test.  Thread v walks the neighbors u > v of row v by
//   lowest set bit (__ffs) and adds popc(row_v & row_u & gt(u)) word by
//   word, starting at u's word (gt(u) is zero below it).  gt is computed,
//   not loaded.  Integer arithmetic keeps it exact at every bin (the MXU
//   form relied on 6*C(256,3) < 2^24).  A warp-shuffle reduction and one
//   shared-memory pass produce the tile's uint32.  Later work: int8 MMA.
#include <cuda_runtime.h>

#include "tile_bits.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
triangle_count_kernel(const uint32_t* __restrict__ A,
                      const uint32_t* __restrict__ cand,
                      uint32_t* __restrict__ out, int T) {
  __shared__ uint32_t rows[kMaxT * kMaxW];
  __shared__ uint32_t cmask[kMaxW];
  __shared__ uint32_t warp_sums[kThreads / 32];

  const int W = T >> 5;
  const int b = blockIdx.x;
  const uint32_t* At = A + static_cast<size_t>(b) * T * W;
  if (threadIdx.x < W) cmask[threadIdx.x] = cand[static_cast<size_t>(b) * W + threadIdx.x];
  __syncthreads();
  for (int i = threadIdx.x; i < T * W; i += blockDim.x) {
    const int v = i / W;
    const int w = i - v * W;
    rows[i] = has_bit(cmask, v) ? (At[i] & cmask[w]) : 0u;
  }
  __syncthreads();

  uint32_t acc = 0;
  for (int v = threadIdx.x; v < T; v += blockDim.x) {
    const uint32_t* rv = rows + v * W;
    for (int wu = v >> 5; wu < W; ++wu) {
      uint32_t nb = rv[wu] & gt_word(v, wu);
      while (nb) {
        const int u = (wu << 5) + __ffs(nb) - 1;
        nb &= nb - 1u;
        const uint32_t* ru = rows + u * W;
        for (int w = wu; w < W; ++w) acc += __popc(rv[w] & ru[w] & gt_word(u, w));
      }
    }
  }

  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(kFullMask, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s = 0;
    for (int i = 0; i < kThreads / 32; ++i) s += warp_sums[i];
    out[b] = s;
  }
}

}  // namespace
}  // namespace repro_torch

// A: (B, T, T/32) words, cand: (B, T/32), out: (B,), all device pointers.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int triangle_count_tiles_launch(const void* A, const void* cand, void* out,
                                           int B, int T, void* stream) {
  if (B > 0) {
    repro_torch::triangle_count_kernel<<<B, repro_torch::kThreads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(A), static_cast<const uint32_t*>(cand),
        static_cast<uint32_t*>(out), T);
  }
  return static_cast<int>(cudaGetLastError());
}
