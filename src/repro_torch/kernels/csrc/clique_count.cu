// Per-tile l-clique count by an explicit-stack bitset DFS (k >= 6, l >= 4).
//
// Replaces: the Pallas kernel repro/kernels/clique_count.py,
//   clique_count_tiles (_kernel): a cursor-stack DFS that pushes
//   cand & A[v] & gt[v] when its popcount is >= remaining - 1 and closes at
//   three levels remaining with common.triangles_within.
// Same function: repro/kernels/lax_backend.py _count_tile_dfs (the todo-stack
//   form walked here) and its torch twin clique_count_tiles_torch in
//   repro_torch/kernels/clique_count.py.
// Bound on the H100: the input is at most 8 KB a tile, but the work grows
//   with the tile's clique structure: one W-word AND + popcount per DFS step
//   and one per induced edge at every close.  It is bound by the integer
//   issue rate and by branch divergence (tiles differ widely in DFS cost),
//   not by HBM bytes.
// Design: one warp per tile, 4 warps per CTA.  The warp stages the tile's A
//   (<= 8 KB) and a todo stack of (l - 3) x W words in shared memory.  Lane w
//   owns word w of every stack level, so taking the lowest set bit is one
//   ballot + shuffle and the popcount of sub = after & A[v] one warp
//   reduction; every lane holds the same depth, so control flow stays
//   uniform.  A sub-branch with three levels left closes with a
//   warp-cooperative triangles_within, lanes striding over its vertices.
//   l <= 3 takes the closed forms inline; an empty cand returns 0 after one
//   ballot.  l is a runtime argument up to kLMax (the wrapper checks it).
#include <cuda_runtime.h>

#include "tile_bits.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kLMax = 16;
constexpr int kStackLevels = kLMax - 3;  // depths 0 .. l-4

__device__ __forceinline__ uint32_t warp_sum(uint32_t x) {
  return __reduce_add_sync(kFullMask, x);
}

// Edges of the sub-induced subgraph, each pair once.  All lanes return it.
__device__ uint32_t warp_edges(const uint32_t* A, const uint32_t* sub, int T, int W,
                               int lane) {
  uint32_t acc = 0;
  for (int v = lane; v < T; v += 32) {
    if (!has_bit(sub, v)) continue;
    const uint32_t* av = A + v * W;
    for (int w = v >> 5; w < W; ++w) acc += __popc(av[w] & sub[w] & gt_word(v, w));
  }
  return warp_sum(acc);
}

// Triangles of the sub-induced subgraph, each once: for every edge v < u of
// it, popc(A[v] & A[u] & sub & gt(u)).  All lanes return it.
__device__ uint32_t warp_triangles(const uint32_t* A, const uint32_t* sub, int T, int W,
                                   int lane) {
  uint32_t acc = 0;
  for (int v = lane; v < T; v += 32) {
    if (!has_bit(sub, v)) continue;
    const uint32_t* av = A + v * W;
    for (int wu = v >> 5; wu < W; ++wu) {
      uint32_t nb = av[wu] & sub[wu] & gt_word(v, wu);
      while (nb) {
        const int u = (wu << 5) + __ffs(nb) - 1;
        nb &= nb - 1u;
        const uint32_t* au = A + u * W;
        for (int w = wu; w < W; ++w) acc += __popc(av[w] & au[w] & sub[w] & gt_word(u, w));
      }
    }
  }
  return warp_sum(acc);
}

__global__ void __launch_bounds__(kWarps * 32)
clique_count_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ cand,
                    uint32_t* __restrict__ out, int B, int T, int l) {
  __shared__ uint32_t sA[kWarps][kMaxT * kMaxW];
  __shared__ uint32_t sStack[kWarps][kStackLevels * kMaxW];
  __shared__ uint32_t sSub[kWarps][kMaxW];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + warp;
  if (tile >= B) return;  // the whole warp leaves together; no block barrier follows

  const int W = T >> 5;
  uint32_t* At = sA[warp];
  uint32_t* stack = sStack[warp];
  uint32_t* sub_s = sSub[warp];
  const uint32_t* Ag = A + static_cast<size_t>(tile) * T * W;
  for (int i = lane; i < T * W; i += 32) At[i] = Ag[i];
  if (lane < W) stack[lane] = cand[static_cast<size_t>(tile) * W + lane];
  __syncwarp();

  uint32_t count = 0;
  if (l == 1) {
    count = warp_sum(lane < W ? __popc(stack[lane]) : 0u);
  } else if (l == 2) {
    count = warp_edges(At, stack, T, W, lane);
  } else if (l == 3) {
    count = warp_triangles(At, stack, T, W, lane);
  } else {
    int depth = 0;
    while (depth >= 0) {
      uint32_t* todo = stack + depth * W;
      const uint32_t mine = lane < W ? todo[lane] : 0u;
      const unsigned nonzero = __ballot_sync(kFullMask, mine != 0u);
      if (nonzero == 0u) {  // frontier exhausted: pop
        --depth;
        continue;
      }
      const int wl = __ffs(nonzero) - 1;
      const uint32_t word = __shfl_sync(kFullMask, mine, wl);
      const int v = (wl << 5) + __ffs(word) - 1;
      const uint32_t after = (lane == wl) ? (mine & (mine - 1u)) : mine;
      if (lane < W) todo[lane] = after;
      // sub = after & A[v]: cand & N(v) & gt(v), since after only holds
      // vertices above v
      const uint32_t s = lane < W ? (after & At[v * W + lane]) : 0u;
      const int nsub = static_cast<int>(warp_sum(__popc(s)));
      if (depth == l - 4) {  // sub has three levels left: close
        if (nsub >= 3) {
          if (lane < W) sub_s[lane] = s;
          __syncwarp();
          count += warp_triangles(At, sub_s, T, W, lane);
          __syncwarp();
        }
      } else if (nsub >= l - depth - 1) {  // push
        ++depth;
        if (lane < W) stack[depth * W + lane] = s;
      }
      __syncwarp();
    }
  }
  if (lane == 0) out[tile] = count;
}

}  // namespace
}  // namespace repro_torch

// A: (B, T, T/32) words, cand: (B, T/32), out: (B,), all device pointers;
// 1 <= l <= 16.  Launches on `stream` and returns cudaGetLastError().
extern "C" int clique_count_tiles_launch(const void* A, const void* cand, void* out, int B,
                                         int T, int l, void* stream) {
  using namespace repro_torch;
  if (B > 0) {
    const int blocks = (B + kWarps - 1) / kWarps;
    clique_count_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(A), static_cast<const uint32_t*>(cand),
        static_cast<uint32_t*>(out), B, T, l);
  }
  return static_cast<int>(cudaGetLastError());
}
