// The wide path of the DFS kernels: tiles wider than 256 (W = T/32 > 8).
//
// The instantiations of dfs_items.cuh hold a set's words in registers and
// take W as a template argument, W = 1..8; a wider tile runs here, in one
// instantiation per kernel with W a runtime argument, so the build does not
// grow with the number of widths.  The items are the same second-level
// branches (tile b, v, x) and the DFS is the same todo-stack walk, with
// three changes:
//   - a group is the whole warp: lane r owns words r, r + 32, r + 64, ...
//     of every set, so each step's AND + popcount reads consecutive words
//     across the lanes (W = 9..32 leave lanes r >= W a zero share);
//   - the todo stack, the set a close reads and the list kernel's prefix
//     live in a per-warp slot of global scratch (slot_words below) that
//     the wrapper allocates: registers cannot hold a set of any width, and
//     shared memory would cap l at wide T.  A lane reads and writes only its
//     own words of a stack level; a close reads every word of its set, after
//     a __syncwarp.  The slots are private to a warp and stay in L1/L2;
//   - an item is 64 bits: tile b (< 2^16, the wrappers' launch split), v
//     and x (< 2^24 each, far past any tile that fits the card).
// Closes deal a set's vertices by bit: lane j takes the vertices 32 w + j,
// so a list close still walks its rows in ascending order, word by word,
// with a warp scan for their ranks.  Counts are exact in 64 bits (a lane's
// share and the warp's sum), so the per-branch and per-item outputs stay
// exact; the per-tile count wraps mod 2^32 as the reference's does.
// This path is simple first: its times are in PERF.md.
#pragma once

#include <cuda_runtime.h>

#include "dfs_items.cuh"

namespace repro_torch {
namespace wide {

constexpr int kThreads = 256;  // threads of a block of the wide kernels
constexpr int kWarps = kThreads / 32;
constexpr unsigned kNone = 0xFFFFFFFFu;

// Words of one warp's scratch slot at tile width T and clique size l: the
// todo stack (at most max(l - 4, 1) levels of W words), the set a close
// reads (W words) and the list kernel's prefix (l ints).  The wrappers size
// the scratch by it (dfs_slot_words in clique_count.cu).
__host__ __device__ inline long long slot_words(int T, int l) {
  const long long W = T / 32;
  return (static_cast<long long>(l > 4 ? l - 4 : 1) + 1) * W + l;
}

__device__ __forceinline__ unsigned long long pack(int b, int v, int x) {
  return (static_cast<unsigned long long>(b) << 48) |
         (static_cast<unsigned long long>(v) << 24) | static_cast<unsigned long long>(x);
}

__device__ __forceinline__ void unpack(unsigned long long item, int* b, int* v, int* x) {
  *b = static_cast<int>(item >> 48);
  *v = static_cast<int>((item >> 24) & 0xFFFFFFull);
  *x = static_cast<int>(item & 0xFFFFFFull);
}

__device__ __forceinline__ unsigned long long warp_sum64(unsigned long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

__device__ __forceinline__ uint32_t warp_scan(uint32_t x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// The warp's next item, taken from the launch's counter by lane 0.
__device__ __forceinline__ unsigned next_item(unsigned* counter, int lane) {
  unsigned i = 0;
  if (lane == 0) i = atomicAdd(counter, 1u);
  return __shfl_sync(kFullMask, i, 0);
}

// This warp's scratch slot: warps of the launch are numbered in block order.
__device__ __forceinline__ uint32_t* warp_slot(uint32_t* scratch, long long slot) {
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  return scratch + warp * slot;
}

// The edges of the s-induced subgraph (each once); s is W words that every
// lane may read.  Lane j takes the vertices 32 w + j of s.
__device__ __forceinline__ unsigned long long edges_wide(const uint32_t* __restrict__ At,
                                                         const uint32_t* s, int W, int lane) {
  unsigned long long acc = 0;
  for (int wv = 0; wv < W; ++wv) {
    if (!((s[wv] >> lane) & 1u)) continue;
    const int v = (wv << 5) + lane;
    const uint32_t* Av = At + static_cast<size_t>(v) * W;
    uint32_t c = 0;
    for (int w = wv; w < W; ++w) c += __popc(__ldg(Av + w) & s[w] & gt_word(v, w));
    acc += c;
  }
  return warp_sum64(acc);
}

// The triangles of the s-induced subgraph (each once, at its edge v < u):
// popc(A[v] & A[u] & s & gt(u)) for every edge v < u of it.
__device__ __forceinline__ unsigned long long triangles_wide(const uint32_t* __restrict__ At,
                                                             const uint32_t* s, int W,
                                                             int lane) {
  unsigned long long acc = 0;
  for (int wv = 0; wv < W; ++wv) {
    if (!((s[wv] >> lane) & 1u)) continue;
    const int v = (wv << 5) + lane;
    const uint32_t* Av = At + static_cast<size_t>(v) * W;
    for (int wu = wv; wu < W; ++wu) {
      uint32_t nb = __ldg(Av + wu) & s[wu] & gt_word(v, wu);
      while (nb) {
        const int u = (wu << 5) + __ffs(nb) - 1;
        nb &= nb - 1u;
        const uint32_t* Au = At + static_cast<size_t>(u) * W;
        uint32_t c = 0;
        for (int w = wu; w < W; ++w) c += __popc(__ldg(Av + w) & __ldg(Au + w) & s[w] & gt_word(u, w));
        acc += c;
      }
    }
  }
  return warp_sum64(acc);
}

// Takes the lowest set bit of the todo set (this lane's words written by
// this lane only) and returns its vertex, or -1 when the set is empty.
__device__ __forceinline__ int take_lowest_wide(uint32_t* todo, int W, int lane) {
  unsigned wl = kNone;
  uint32_t word = 0;
  for (int w = lane; w < W; w += 32) {
    const uint32_t m = todo[w];
    if (m) {
      wl = static_cast<unsigned>(w);
      word = m;
      break;
    }
  }
  const unsigned wmin = __reduce_min_sync(kFullMask, wl);
  if (wmin == kNone) return -1;
  const uint32_t mw = __shfl_sync(kFullMask, word, static_cast<int>(wmin & 31u));
  if (lane == static_cast<int>(wmin & 31u)) todo[wmin] = mw & (mw - 1u);
  return static_cast<int>(wmin << 5) + __ffs(mw) - 1;
}

// dst = todo & A[y] (this lane's words); returns the warp's popcount of it.
__device__ __forceinline__ int and_row(uint32_t* dst, const uint32_t* todo,
                                       const uint32_t* __restrict__ Ay, int W, int lane) {
  int n = 0;
  for (int w = lane; w < W; w += 32) {
    const uint32_t u = todo[w] & __ldg(Ay + w);
    dst[w] = u;
    n += __popc(u);
  }
  return static_cast<int>(__reduce_add_sync(kFullMask, static_cast<unsigned>(n)));
}

// t = cand & A[v] & A[x] & gt(x) into `t` (this lane's words); returns its
// popcount.  gt(x) lies inside gt(v), since x > v.
__device__ __forceinline__ int second_branch_wide(uint32_t* t, const uint32_t* __restrict__ At,
                                                  const uint32_t* __restrict__ cb, int v, int x,
                                                  int W, int lane) {
  const uint32_t* Av = At + static_cast<size_t>(v) * W;
  const uint32_t* Ax = At + static_cast<size_t>(x) * W;
  int n = 0;
  for (int w = lane; w < W; w += 32) {
    const uint32_t m = __ldg(cb + w) & __ldg(Av + w) & __ldg(Ax + w) & gt_word(x, w);
    t[w] = m;
    n += __popc(m);
  }
  return static_cast<int>(__reduce_add_sync(kFullMask, static_cast<unsigned>(n)));
}

// The k-cliques of the set at stack[0 .. W) (nt its popcount), exact in 64
// bits.  Stack level d sits at stack + d * W; `close` is the set a close
// reads.
__device__ __forceinline__ unsigned long long cliques_wide(const uint32_t* __restrict__ At,
                                                           uint32_t* stack, uint32_t* close,
                                                           int nt, int k, int W, int lane) {
  if (k == 0) return 1ull;
  if (k == 1) return static_cast<unsigned long long>(nt);
  __syncwarp();  // every lane wrote its words of level 0
  if (k == 2) return edges_wide(At, stack, W, lane);
  if (k == 3) return triangles_wide(At, stack, W, lane);
  unsigned long long count = 0;
  int depth = 0;
  while (depth >= 0) {
    uint32_t* todo = stack + static_cast<size_t>(depth) * W;
    const int y = take_lowest_wide(todo, W, lane);
    if (y < 0) {  // frontier exhausted: pop
      --depth;
      continue;
    }
    const bool closing = depth == k - 4;  // three levels left
    uint32_t* dst = closing ? close : todo + W;
    const int nu = and_row(dst, todo, At + static_cast<size_t>(y) * W, W, lane);
    if (closing) {
      if (nu >= 3) {
        __syncwarp();
        count += triangles_wide(At, close, W, lane);
        __syncwarp();  // every lane has read the set before it changes
      }
    } else if (nu >= k - depth - 1) {  // push
      ++depth;
    }
  }
  return count;
}

namespace {

// The branch pass: one warp per first-level branch (b, v), v-major.  Lane j
// tests the x = 32 w + j of sub = cand & A[v] & gt(v); the warp appends its
// kept items to list[0 .. *n_list) with one atomic.
__global__ void __launch_bounds__(kThreads)
branch_wide(const uint32_t* __restrict__ A, const uint32_t* __restrict__ cand,
            unsigned long long* __restrict__ list, unsigned* __restrict__ n_list, int B, int T,
            int l) {
  const int W = T >> 5;
  const int lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(T) * B) return;  // the whole warp leaves
  const int v = static_cast<int>(item / B);
  const int b = static_cast<int>(item % B);
  const uint32_t* At = A + static_cast<size_t>(b) * T * W;
  const uint32_t* cb = cand + static_cast<size_t>(b) * W;
  if (!((__ldg(cb + (v >> 5)) >> (v & 31)) & 1u)) return;  // v not in cand
  const uint32_t* Av = At + static_cast<size_t>(v) * W;
  int ns = 0;
  for (int w = lane; w < W; w += 32) ns += __popc(__ldg(cb + w) & __ldg(Av + w) & gt_word(v, w));
  if (static_cast<int>(__reduce_add_sync(kFullMask, static_cast<unsigned>(ns))) < l - 1) return;
  auto in_sub = [&](int w) {
    return ((__ldg(cb + w) & __ldg(Av + w) & gt_word(v, w)) >> lane) & 1u;
  };
  // x is kept when t = sub & A[x] & gt(x) can still hold l - 2 vertices
  auto kept = [&](int x) {
    if (l <= 2) return true;
    const uint32_t* Ax = At + static_cast<size_t>(x) * W;
    int nt = 0;
    for (int w = x >> 5; w < W; ++w)
      nt += __popc(__ldg(cb + w) & __ldg(Av + w) & __ldg(Ax + w) & gt_word(x, w));
    return nt >= l - 2;
  };
  uint32_t n = 0;  // this lane's kept x, counted, then written
  if (l == 1) {
    n = lane == 0 ? 1u : 0u;
  } else {
    for (int w = v >> 5; w < W; ++w)
      if (in_sub(w) && kept((w << 5) + lane)) ++n;
  }
  const uint32_t incl = warp_scan(n, lane);
  unsigned base = 0;
  if (lane == 31 && incl) base = atomicAdd(n_list, incl);
  base = __shfl_sync(kFullMask, base, 31) + (incl - n);
  if (l == 1) {
    if (n) list[base] = pack(b, v, v);
    return;
  }
  for (int w = v >> 5; w < W && n; ++w) {
    const int x = (w << 5) + lane;
    if (in_sub(w) && kept(x)) {
      list[base++] = pack(b, v, x);
      --n;
    }
  }
}

// The item pass: the l-cliques of every listed item, a warp an item, on a
// persistent grid; outputs as in dfs_items.cuh item_kernel.
template <ItemOut kOut>
__global__ void __launch_bounds__(kThreads)
item_wide(const uint32_t* __restrict__ A, const uint32_t* __restrict__ cand,
          const unsigned long long* __restrict__ list, const unsigned* __restrict__ n_list,
          unsigned* __restrict__ counter, uint32_t* __restrict__ out,
          unsigned long long* __restrict__ per, uint32_t* scratch, long long slot, int T, int l) {
  const int W = T >> 5;
  const int lane = threadIdx.x & 31;
  uint32_t* stack = warp_slot(scratch, slot);
  uint32_t* close = stack + static_cast<size_t>(l > 4 ? l - 4 : 1) * W;
  const unsigned n = *n_list;
  for (unsigned i = next_item(counter, lane); i < n; i = next_item(counter, lane)) {
    int b, v, x;
    unpack(list[i], &b, &v, &x);
    unsigned long long c = 1ull;  // l <= 2: the item is a vertex or an edge
    if (l >= 3) {
      const uint32_t* At = A + static_cast<size_t>(b) * T * W;
      const int nt = second_branch_wide(stack, At, cand + static_cast<size_t>(b) * W, v, x, W,
                                        lane);
      c = cliques_wide(At, stack, close, nt, l - 2, W, lane);
    }
    if (lane != 0 || c == 0ull) continue;
    if constexpr (kOut == ItemOut::kTile) {
      atomicAdd(out + b, static_cast<uint32_t>(c));  // mod 2^32, order-free
    } else if constexpr (kOut == ItemOut::kBranch) {
      atomicAdd(per + static_cast<size_t>(b) * T + v, c);
    } else {
      per[(static_cast<size_t>(b) * T + v) * T + x] = c;
    }
  }
}

// Blocks of a persistent wide kernel: as many as fit on the card at once,
// and no more than the scratch has slots for (slots >= kWarps).
template <class Kernel>
int wide_grid(Kernel kernel, long long slots) {
  const long long blocks = persistent_grid(kernel, kThreads, 0);
  const long long fit = slots / kWarps;
  return static_cast<int>(blocks < fit ? blocks : fit);
}

// Runs the wide branch and item passes on `stream`: list holds room for
// B * T * (T + 1) / 2 items, counters[0] and counters[1] start at 0, and
// scratch holds `slots` slots of slot_words(T, l) words.
template <ItemOut kOut>
void launch_items_wide(const uint32_t* A, const uint32_t* cand, unsigned long long* list,
                       unsigned* counters, uint32_t* out, unsigned long long* per,
                       uint32_t* scratch, long long slots, int B, int T, int l,
                       cudaStream_t stream) {
  const long long firsts = static_cast<long long>(T) * B;
  const int branch_blocks = static_cast<int>((firsts + kWarps - 1) / kWarps);
  branch_wide<<<branch_blocks, kThreads, 0, stream>>>(A, cand, list, counters, B, T, l);
  auto items = item_wide<kOut>;
  items<<<wide_grid(items, slots), kThreads, 0, stream>>>(A, cand, list, counters, counters + 1,
                                                          out, per, scratch, slot_words(T, l),
                                                          T, l);
}

// The arguments a wide launch takes: T a multiple of 32 above 256,
// 1 <= l <= T, 0 < B < 2^16 and room for kWarps slots at least.
inline bool wide_args_ok(int B, int T, int l, long long scratch_words) {
  return T > 256 && T % 32 == 0 && l >= 1 && l <= T && B < (1 << 16) &&
         scratch_words / slot_words(T, l) >= kWarps;
}

}  // namespace
}  // namespace wide
}  // namespace repro_torch
