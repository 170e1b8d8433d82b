// Per-tile l-clique listing into a fixed-capacity buffer.
//
// Replaces: the Pallas kernel repro/kernels/clique_list.py,
//   clique_list_tiles (_kernel): a cursor-stack DFS that closes at two levels
//   remaining by scattering the edge frontier (common.emit_edges), and for
//   l <= 3 one whole-tile scatter (emit_frontier / emit_edges /
//   emit_triangles).
// Same function: repro/kernels/lax_backend.py _list_tile_dfs (the todo-stack
//   form walked here) and its torch twin clique_list_tiles_torch in
//   repro_torch/kernels/clique_list.py.
// Contract: rows are local ids in lexicographic order -- the prefix in DFS
//   order, then (u, w) in row-major order at an edge close, (v, u, w) in
//   lexicographic order for l == 3, ascending v for l == 1.  count is the
//   true total (uint32, wrapping), only ranks < capacity are written,
//   overflow = count > capacity, and the kernel zeroes every row at and past
//   min(count, capacity), so the wrapper allocates the buffer uninitialised.
// Bound on the H100: the input is at most 8 KB a tile; the output is
//   min(count, capacity) * l * 4 bytes of rows (plus the zero fill), and the
//   work is one W-word AND + popcount per DFS step plus one per candidate
//   vertex (edge close) or induced edge (triangle close).  Tiles differ
//   widely in DFS cost, so it is bound by integer instruction throughput,
//   divergence and scattered row stores, not by HBM bandwidth.
// Design: one warp per tile, 4 warps per CTA, A and the todo stack in shared
//   memory as in clique_count.cu.  Ranks come from prefix sums, never from
//   atomics: at a close, lanes take 32 consecutive first vertices u at a
//   time, each counts the rows it completes, a warp exclusive scan
//   (__shfl_up_sync) gives each lane its first rank, and each lane writes its
//   rows in ascending order.  Rows go straight to global memory; staging them
//   in shared memory is left for later.  l is a runtime argument up to
//   kLMax (the wrapper checks it).
#include <cuda_runtime.h>

#include "tile_bits.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kLMax = 16;
constexpr int kStackLevels = kLMax - 2;  // depths 0 .. l-3

__device__ __forceinline__ uint32_t warp_sum(uint32_t x) {
  return __reduce_add_sync(kFullMask, x);
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// One tile's output rows and its running true count (uniform in the warp).
struct Emit {
  int* rows;  // (capacity, l) int32
  int capacity;
  int l;
  unsigned long long total;
};

// Row `dest` = prefix[0..npfx) followed by the ncoord coordinates c.
__device__ __forceinline__ void put_row(const Emit& e, unsigned long long dest,
                                        const int* prefix, int npfx, int c0, int c1,
                                        int c2) {
  if (dest >= static_cast<unsigned long long>(e.capacity)) return;
  int* row = e.rows + dest * e.l;
  for (int j = 0; j < npfx; ++j) row[j] = prefix[j];
  const int c[3] = {c0, c1, c2};
  for (int j = npfx; j < e.l; ++j) row[j] = c[j - npfx];
}

// l' == 1 close: every vertex of `set`, ascending.
__device__ void emit_frontier(Emit& e, const uint32_t* set, int T, int lane) {
  for (int vb = 0; vb < T; vb += 32) {
    const bool in = (set[vb >> 5] >> lane) & 1u;
    const unsigned ballot = __ballot_sync(kFullMask, in);
    if (in) {
      const int rank = __popc(ballot & ((1u << lane) - 1u));
      put_row(e, e.total + rank, nullptr, 0, vb + lane, 0, 0);
    }
    e.total += __popc(ballot);
  }
}

// l' == 2 close: every edge (u, w), u < w, of the sub-induced subgraph behind
// prefix[0..l-2), in row-major order.  Lane i takes u = ub + i.
__device__ void emit_edges(Emit& e, const uint32_t* A, const uint32_t* sub,
                           const int* prefix, int T, int W, int lane) {
  const int npfx = e.l - 2;
  for (int ub = 0; ub < T; ub += 32) {
    if (sub[ub >> 5] == 0u) continue;  // sub is in shared memory: uniform
    const int u = ub + lane;
    const uint32_t* au = A + u * W;
    uint32_t c = 0;
    const bool in = (sub[ub >> 5] >> lane) & 1u;
    if (in)
      for (int w = ub >> 5; w < W; ++w) c += __popc(au[w] & sub[w] & gt_word(u, w));
    const uint32_t incl = warp_inclusive_scan(c, lane);
    const uint32_t chunk = __shfl_sync(kFullMask, incl, 31);
    if (c && e.total < static_cast<unsigned long long>(e.capacity)) {
      unsigned long long dest = e.total + (incl - c);
      for (int w = ub >> 5; w < W; ++w) {
        uint32_t nb = au[w] & sub[w] & gt_word(u, w);
        while (nb) {
          put_row(e, dest++, prefix, npfx, u, (w << 5) + __ffs(nb) - 1, 0);
          nb &= nb - 1u;
        }
      }
    }
    e.total += chunk;
  }
}

// l == 3: every triangle (v, u, w), v < u < w, of the cand-induced subgraph,
// in lexicographic order.  v walks ascending (uniform); lane i takes u = ub + i.
__device__ void emit_triangles(Emit& e, const uint32_t* A, const uint32_t* cand, int T,
                               int W, int lane) {
  for (int v = 0; v < T; ++v) {
    if (!has_bit(cand, v)) continue;
    const uint32_t* av = A + v * W;
    for (int ub = v & ~31; ub < T; ub += 32) {
      const int wu = ub >> 5;
      const uint32_t nbv = av[wu] & cand[wu] & gt_word(v, wu);  // u: v < u, edge
      if (nbv == 0u) continue;
      const int u = ub + lane;
      const uint32_t* au = A + u * W;
      uint32_t c = 0;
      const bool in = (nbv >> lane) & 1u;
      if (in)
        for (int w = wu; w < W; ++w) c += __popc(av[w] & au[w] & cand[w] & gt_word(u, w));
      const uint32_t incl = warp_inclusive_scan(c, lane);
      const uint32_t chunk = __shfl_sync(kFullMask, incl, 31);
      if (c && e.total < static_cast<unsigned long long>(e.capacity)) {
        unsigned long long dest = e.total + (incl - c);
        for (int w = wu; w < W; ++w) {
          uint32_t nb = av[w] & au[w] & cand[w] & gt_word(u, w);
          while (nb) {
            put_row(e, dest++, nullptr, 0, v, u, (w << 5) + __ffs(nb) - 1);
            nb &= nb - 1u;
          }
        }
      }
      e.total += chunk;
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
clique_list_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ cand,
                   int* __restrict__ out, uint32_t* __restrict__ out_count,
                   uint32_t* __restrict__ out_overflow, int B, int T, int l, int capacity) {
  __shared__ uint32_t sA[kWarps][kMaxT * kMaxW];
  __shared__ uint32_t sStack[kWarps][kStackLevels * kMaxW];
  __shared__ uint32_t sSub[kWarps][kMaxW];
  __shared__ int sPrefix[kWarps][kLMax];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + warp;
  if (tile >= B) return;  // the whole warp leaves together; no block barrier follows

  const int W = T >> 5;
  uint32_t* At = sA[warp];
  uint32_t* stack = sStack[warp];
  uint32_t* sub_s = sSub[warp];
  int* prefix = sPrefix[warp];
  const uint32_t* Ag = A + static_cast<size_t>(tile) * T * W;
  for (int i = lane; i < T * W; i += 32) At[i] = Ag[i];
  if (lane < W) stack[lane] = cand[static_cast<size_t>(tile) * W + lane];
  __syncwarp();

  Emit e{out + static_cast<size_t>(tile) * capacity * l, capacity, l, 0ull};
  if (l == 1) {
    emit_frontier(e, stack, T, lane);
  } else if (l == 2) {
    emit_edges(e, At, stack, prefix, T, W, lane);
  } else if (l == 3) {
    emit_triangles(e, At, stack, T, W, lane);
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
      if (depth == l - 3) {  // sub has two levels left: emit its edges
        if (nsub >= 2) {
          if (lane < W) sub_s[lane] = s;
          if (lane == 0) prefix[depth] = v;
          __syncwarp();
          emit_edges(e, At, sub_s, prefix, T, W, lane);
        }
      } else if (nsub >= l - depth - 1) {  // push
        if (lane == 0) prefix[depth] = v;
        ++depth;
        if (lane < W) stack[depth * W + lane] = s;
      }
      __syncwarp();
    }
  }

  // zero every row at and past min(count, capacity)
  const unsigned long long cap = static_cast<unsigned long long>(capacity);
  const size_t written = static_cast<size_t>(e.total < cap ? e.total : cap);
  for (size_t i = written * l + lane; i < static_cast<size_t>(capacity) * l; i += 32)
    e.rows[i] = 0;
  if (lane == 0) {
    const uint32_t count = static_cast<uint32_t>(e.total);  // wraps as the reference
    out_count[tile] = count;
    out_overflow[tile] = count > static_cast<uint32_t>(capacity) ? 1u : 0u;
  }
}

}  // namespace
}  // namespace repro_torch

// A: (B, T, T/32) words, cand: (B, T/32), out: (B, capacity, l) int32,
// count and overflow: (B,) uint32, all device pointers; 1 <= l <= 16,
// capacity >= 1.  Launches on `stream` and returns cudaGetLastError().
extern "C" int clique_list_tiles_launch(const void* A, const void* cand, void* out,
                                        void* count, void* overflow, int B, int T, int l,
                                        int capacity, void* stream) {
  using namespace repro_torch;
  if (B > 0) {
    const int blocks = (B + kWarps - 1) / kWarps;
    clique_list_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(A), static_cast<const uint32_t*>(cand),
        static_cast<int*>(out), static_cast<uint32_t*>(count),
        static_cast<uint32_t*>(overflow), B, T, l, capacity);
  }
  return static_cast<int>(cudaGetLastError());
}
