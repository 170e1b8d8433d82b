// Work items of the DFS kernels (clique_count.cu, clique_list.cu).
//
// A tile's DFS takes the lowest set bit v of cand first, then the lowest
// set bit x of sub_v = cand & A[v] & gt(v), and so on.  The l-cliques of a
// tile whose two lowest vertices are v < x are v, x and the (l-2)-cliques of
// t = sub_v & A[x] & gt(x), so the work splits into items (tile b, v, x),
// the DFS's second-level branches: a tile's count is the sum of its items'
// counts, and its list the concatenation of their rows in (v, x) order.
// For l = 2 an item is an edge (b, v, x); for l = 1 a vertex, (b, v, v).
//
// Two passes.  The branch pass takes the first-level branches (b, v), one
// group each, v-major (every tile's v = 0 first: a low v has the largest
// sub); it keeps v when v is in cand and popcount(sub_v) >= l - 1 (the
// test the per-tile DFS makes at depth 0) and appends to a list every x of
// sub_v with popcount(t) >= l - 2 (its test at depth 1).  The item passes
// run the list on a persistent grid: groups take items from a global
// counter, one atomic per warp's worth of group leaders, in the order the
// branch pass appended them (heavy low-v branches roughly first).  No item
// is large enough to set a launch's time alone; first-level branches were
// (the heaviest took most of a T = 64 batch's time on the H100).
//
// A group of W = T/32 lanes runs one item; lane r owns word r of every
// stack level, so at T = 32 every thread walks its own DFS and a warp runs
// 32 items.  The todo stack is dynamic shared memory sized by l, so any
// l <= T runs (item_block picks the block that holds it).
#pragma once

#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>
#include <cuda_runtime.h>

#include "tile_bits.cuh"

namespace repro_torch {

namespace cg = cooperative_groups;

constexpr int kItemThreads = 256;  // threads of a block of the item kernels
// At least 4 blocks (1,024 threads) an SM, so at most 64 registers a
// thread.  ptxas left to itself gave the W = 4 kernels 32 registers and
// spilled (up to 28 bytes); with this bound no kernel spills.
constexpr int kItemMinBlocks = 4;
// Dynamic shared memory a kernel may use without opting in.
constexpr int kDefaultSmemBytes = 48 * 1024;

// An item packed into 32 bits: tile b (< 2^16), v and x (< 256 each).
__device__ __forceinline__ uint32_t pack_item(int b, int v, int x) {
  return (static_cast<uint32_t>(b) << 16) | (static_cast<uint32_t>(v) << 8) |
         static_cast<uint32_t>(x);
}

// The W lanes of a warp that run one item.  Every decision the DFS takes is
// made from a group-wide ballot, shuffle or sum, so the group's control flow
// stays uniform while the groups of one warp diverge freely.
template <int W>
struct Group {
  int r;          // rank in the group: the word this lane owns
  unsigned mask;  // the group's lanes within the warp

  __device__ Group() {
    const int lane = threadIdx.x & 31;
    r = lane & (W - 1);
    mask = ((1u << W) - 1u) << (lane & ~(W - 1));
  }
  __device__ unsigned ballot(bool p) const {
    if constexpr (W == 1) {
      return p ? 1u : 0u;
    } else {
      return (__ballot_sync(mask, p) >> ((threadIdx.x & 31) & ~(W - 1))) &
             ((1u << W) - 1u);
    }
  }
  template <class X>
  __device__ X shfl(X x, int src) const {
    if constexpr (W == 1) {
      return x;
    } else {
      return __shfl_sync(mask, x, src, W);
    }
  }
  __device__ uint32_t sum(uint32_t x) const {
    if constexpr (W == 1) {
      return x;
    } else {
      return __reduce_add_sync(mask, x);
    }
  }
  __device__ uint32_t inclusive_scan(uint32_t x) const {
#pragma unroll
    for (int o = 1; o < W; o <<= 1) {
      const uint32_t y = __shfl_up_sync(mask, x, o, W);
      if (r >= o) x += y;
    }
    return x;
  }
  __device__ void sync() const {
    if constexpr (W > 1) __syncwarp(mask);
  }
  // All W words of a value whose word w lane w holds.
  __device__ void gather(uint32_t mine, uint32_t (&all)[W]) const {
#pragma unroll
    for (int w = 0; w < W; ++w) all[w] = shfl(mine, w);
  }
};

// The next item of the launch for this group, or >= the item count when
// none is left.  The leaders that reach this point together take one block
// of consecutive items with one atomic.
template <int W>
__device__ __forceinline__ unsigned next_item(const Group<W>& g, unsigned* counter) {
  unsigned item = 0;
  if (g.r == 0) {
    cg::coalesced_group leaders = cg::coalesced_threads();
    unsigned first = 0;
    if (leaders.thread_rank() == 0) first = atomicAdd(counter, leaders.size());
    item = leaders.shfl(first, 0) + leaders.thread_rank();
  }
  return g.shfl(item, 0);
}

// Takes the lowest set bit of m and returns its vertex, or -1 if m is empty.
template <int W>
__device__ __forceinline__ int take_lowest(uint32_t (&m)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (m[w]) {
      const int b = __ffs(m[w]) - 1;
      m[w] &= m[w] - 1u;
      return (w << 5) + b;
    }
  }
  return -1;
}

// The set bits of a W-word set dealt round robin over the group's lanes:
// lane r gets the set bits of rank r, r + W, r + 2W, ... in ascending order.
template <int W>
struct Stride {
  uint32_t m[W];

  __device__ __forceinline__ Stride(const uint32_t (&set)[W], int r) {
#pragma unroll
    for (int w = 0; w < W; ++w) m[w] = set[w];
    for (int i = 0; i < r; ++i) take_lowest<W>(m);
  }
  __device__ __forceinline__ int next() {
    const int v = take_lowest<W>(m);
    for (int i = 1; i < W; ++i) take_lowest<W>(m);
    return v;
  }
};

// This lane's share of the edges of the sub-induced subgraph (each once).
template <int W>
__device__ __forceinline__ uint32_t edges_share(const uint32_t* __restrict__ A,
                                                const uint32_t (&sub)[W], int r) {
  Stride<W> it(sub, r);
  uint32_t acc = 0;
  for (int v = it.next(); v >= 0; v = it.next()) {
    uint32_t av[W];
    load_row<W>(A + v * W, av);
#pragma unroll
    for (int w = 0; w < W; ++w) acc += __popc(av[w] & sub[w] & gt_word(v, w));
  }
  return acc;
}

// This lane's share of the triangles of the sub-induced subgraph (each
// once): for every edge v < u of it, popc(A[v] & A[u] & sub & gt(u)).
template <int W>
__device__ __forceinline__ uint32_t triangles_share(const uint32_t* __restrict__ A,
                                                    const uint32_t (&sub)[W], int r) {
  Stride<W> it(sub, r);
  uint32_t acc = 0;
  for (int v = it.next(); v >= 0; v = it.next()) {
    uint32_t vs[W], nb[W];
    load_row<W>(A + v * W, vs);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      vs[w] &= sub[w];
      nb[w] = vs[w] & gt_word(v, w);
    }
    for (int u = take_lowest<W>(nb); u >= 0; u = take_lowest<W>(nb)) {
      uint32_t au[W];
      load_row<W>(A + u * W, au);
#pragma unroll
      for (int w = 0; w < W; ++w) acc += __popc(vs[w] & au[w] & gt_word(u, w));
    }
  }
  return acc;
}

// This lane's word of t for item (b, v, x) with x > v: cand & A[v] & A[x] &
// gt(x) (gt(x) lies inside gt(v)), and the group's popcount of it.
template <int W>
__device__ __forceinline__ uint32_t second_branch(const Group<W>& g,
                                                  const uint32_t* __restrict__ At,
                                                  const uint32_t* __restrict__ cand_b, int v,
                                                  int x, int* nt) {
  const uint32_t t = __ldg(cand_b + g.r) & __ldg(At + v * W + g.r) & __ldg(At + x * W + g.r) &
                     gt_word(x, g.r);
  *nt = static_cast<int>(g.sum(__popc(t)));
  return t;
}

// The k-cliques of the set t (this lane's word of it; nt its popcount),
// exact in 64 bits.  `stack` is this lane's slot of the level-major todo
// stack (k - 3 levels, `stride` words apart); every lane reads and writes
// only its own word of it.
template <int W>
__device__ __forceinline__ unsigned long long cliques_in(const Group<W>& g,
                                                         const uint32_t* __restrict__ At,
                                                         uint32_t t, int nt, int k,
                                                         uint32_t* stack, int stride) {
  if (k == 0) return 1ull;
  if (k == 1) return static_cast<unsigned long long>(nt);
  if (k <= 3) {
    uint32_t sub[W];
    g.gather(t, sub);
    return g.sum(k == 2 ? edges_share<W>(At, sub, g.r) : triangles_share<W>(At, sub, g.r));
  }
  unsigned long long count = 0;
  int depth = 0;
  stack[0] = t;
  while (depth >= 0) {
    uint32_t* todo = stack + depth * stride;
    const uint32_t mine = *todo;
    const unsigned nonzero = g.ballot(mine != 0u);
    if (nonzero == 0u) {  // frontier exhausted: pop
      --depth;
      continue;
    }
    const int wl = __ffs(nonzero) - 1;
    const uint32_t word = g.shfl(mine, wl);
    const int y = (wl << 5) + __ffs(word) - 1;
    const uint32_t after = g.r == wl ? (mine & (mine - 1u)) : mine;
    *todo = after;
    // u = after & A[y]: the todo's vertices above y that are adjacent to y
    const uint32_t u = after & __ldg(At + y * W + g.r);
    const int nu = static_cast<int>(g.sum(__popc(u)));
    if (depth == k - 4) {  // three levels left: close
      if (nu >= 3) {
        uint32_t sub[W];
        g.gather(u, sub);
        count += g.sum(triangles_share<W>(At, sub, g.r));
      }
    } else if (nu >= k - depth - 1) {  // push
      ++depth;
      stack[depth * stride] = u;
    }
  }
  return count;
}

namespace {

// The branch pass: one group per first-level branch (b, v), v-major.  Each
// lane tests the x of sub_v dealt to it; the group appends its kept items
// to list[0 .. *n_list) with one atomic.
template <int W>
__global__ void __launch_bounds__(kItemThreads, kItemMinBlocks)
branch_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ cand,
              uint32_t* __restrict__ list, unsigned* __restrict__ n_list, int B, int l) {
  constexpr int T = W * 32;
  const Group<W> g;
  const unsigned item = blockIdx.x * (kItemThreads / W) + threadIdx.x / W;
  if (item >= static_cast<unsigned>(T) * B) return;  // the whole group leaves
  const int v = static_cast<int>(item / B);
  const int b = static_cast<int>(item % B);
  const uint32_t* At = A + static_cast<size_t>(b) * T * W;
  const uint32_t cw = __ldg(cand + static_cast<size_t>(b) * W + g.r);
  if (!((g.shfl(cw, v >> 5) >> (v & 31)) & 1u)) return;  // v not in cand
  const uint32_t s = cw & __ldg(At + v * W + g.r) & gt_word(v, g.r);
  if (static_cast<int>(g.sum(__popc(s))) < l - 1) return;
  uint32_t sub[W];
  g.gather(s, sub);
  // x is kept when t = sub & A[x] & gt(x) can still hold l - 2 vertices
  auto kept = [&](int x) {
    if (l <= 2) return true;
    uint32_t ax[W];
    load_row<W>(At + x * W, ax);
    int nt = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) nt += __popc(sub[w] & ax[w] & gt_word(x, w));
    return nt >= l - 2;
  };
  uint32_t n = 0;  // this lane's kept x, counted, then written
  if (l == 1) {
    n = g.r == 0 ? 1u : 0u;
  } else {
    Stride<W> it(sub, g.r);
    for (int x = it.next(); x >= 0; x = it.next()) n += kept(x) ? 1u : 0u;
  }
  const uint32_t incl = g.inclusive_scan(n);
  unsigned base = 0;
  if (g.r == W - 1 && incl) base = atomicAdd(n_list, incl);
  base = g.shfl(base, W - 1) + (incl - n);
  if (l == 1) {
    if (n) list[base] = pack_item(b, v, v);
    return;
  }
  Stride<W> it(sub, g.r);
  for (int x = it.next(); x >= 0 && n; x = it.next()) {
    if (kept(x)) {
      list[base++] = pack_item(b, v, x);
      --n;
    }
  }
}

// What the item pass writes for item (b, v, x) with c cliques.
enum class ItemOut {
  kTile,    // out[b] += c mod 2^32 (uint32 atomics)
  kBranch,  // per_v[b * T + v] += c (uint64 atomics)
  kItem,    // per_x[(b * T + v) * T + x] = c
};

// The item pass: the l-cliques of every listed item, on a persistent grid.
// kFull: the block has kItemThreads threads, so the stack stride is a
// compile-time constant; else (a block that item_block halved) it is the
// block's own size.
template <int W, ItemOut kOut, bool kFull>
__global__ void __launch_bounds__(kItemThreads, kItemMinBlocks)
item_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ cand,
            const uint32_t* __restrict__ list, const unsigned* __restrict__ n_list,
            unsigned* __restrict__ counter, uint32_t* __restrict__ out,
            unsigned long long* __restrict__ per, int l) {
  extern __shared__ uint32_t stack_smem[];
  constexpr int T = W * 32;
  const Group<W> g;
  uint32_t* stack = stack_smem + threadIdx.x;  // level-major: no bank conflicts
  const int stride = kFull ? kItemThreads : static_cast<int>(blockDim.x);
  const unsigned n = *n_list;
  for (unsigned i = next_item(g, counter); i < n; i = next_item(g, counter)) {
    const uint32_t item = list[i];
    const int b = static_cast<int>(item >> 16);
    const int v = static_cast<int>((item >> 8) & 0xFFu);
    const int x = static_cast<int>(item & 0xFFu);
    unsigned long long c = 1ull;  // l <= 2: the item is a vertex or an edge
    if (l >= 3) {
      const uint32_t* At = A + static_cast<size_t>(b) * T * W;
      int nt;
      const uint32_t t = second_branch(g, At, cand + static_cast<size_t>(b) * W, v, x, &nt);
      c = cliques_in(g, At, t, nt, l - 2, stack, stride);
    }
    if (g.r != 0 || c == 0ull) continue;
    if constexpr (kOut == ItemOut::kTile) {
      // the leaders here that add into the same tile add once: a tile's
      // items sit side by side in the list, so they finish together
      const cg::coalesced_group leaders = cg::coalesced_threads();
      const cg::coalesced_group same = cg::labeled_partition(leaders, b);
      const uint32_t sum = cg::reduce(same, static_cast<uint32_t>(c), cg::plus<uint32_t>());
      if (same.thread_rank() == 0) atomicAdd(out + b, sum);
    } else if constexpr (kOut == ItemOut::kBranch) {
      atomicAdd(per + static_cast<size_t>(b) * T + v, c);
    } else {
      per[(static_cast<size_t>(b) * T + v) * T + x] = c;
    }
  }
}

// Blocks for a persistent item kernel of `threads` threads and `smem_bytes`
// of dynamic shared memory: as many as fit on the card at once.
template <class Kernel>
int persistent_grid(Kernel kernel, int threads, int smem_bytes) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem_bytes);
  return (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
}

// The block shape of an item kernel whose dynamic shared memory grows with
// l: `smem_for(threads)` bytes for a block of `threads` (a multiple of 32).
// A block has kItemThreads threads, halved (down to one warp) while its
// shared memory would exceed what the card lets one block opt in to
// (227 KB on the H100; the todo stack alone is (l - 5) KB at 256 threads,
// so this happens only above l = 232, at T = 256).
template <class SmemFor>
cudaError_t item_block(SmemFor smem_for, int* threads, int* smem) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int t = kItemThreads;
  while (t > 32 && smem_for(t) > optin) t /= 2;
  *threads = t;
  *smem = smem_for(t);
  return *smem > optin ? cudaErrorInvalidValue : cudaSuccess;
}

// Launches a persistent item kernel of `threads` threads and `smem` bytes of
// dynamic shared memory on `stream`, opted in to its size above the 48 KB
// that a kernel gets without asking; returns the opt-in's error, if any.
template <class Kernel, class... Args>
cudaError_t launch_persistent(Kernel kernel, int threads, int smem, cudaStream_t stream,
                              Args... args) {
  if (smem > kDefaultSmemBytes) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<persistent_grid(kernel, threads, smem), threads, smem, stream>>>(args...);
  return cudaSuccess;
}

// Runs the branch pass and then the item pass on `stream`: list holds room
// for B * T * (T + 1) / 2 items, counters[0] and counters[1] start at 0.
// Returns the error of the item kernel's shared-memory opt-in, if any.
template <int W, ItemOut kOut>
cudaError_t launch_items(const uint32_t* A, const uint32_t* cand, uint32_t* list,
                         unsigned* counters, uint32_t* out, unsigned long long* per, int B,
                         int l, cudaStream_t stream) {
  const long long firsts = static_cast<long long>(W) * 32 * B;
  const int groups = kItemThreads / W;
  const int branch_blocks = static_cast<int>((firsts + groups - 1) / groups);
  auto branch = branch_kernel<W>;
  branch<<<branch_blocks, kItemThreads, 0, stream>>>(A, cand, list, counters, B, l);
  // the todo stack of cliques_in at k = l - 2: l - 5 words a thread
  const int levels = l > 5 ? l - 5 : 1;
  int threads = 0, smem = 0;
  const cudaError_t err = item_block(
      [&](int t) { return levels * t * static_cast<int>(sizeof(uint32_t)); }, &threads, &smem);
  if (err != cudaSuccess) return err;
  if (threads == kItemThreads)
    return launch_persistent(item_kernel<W, kOut, true>, threads, smem, stream, A, cand, list,
                             counters, counters + 1, out, per, l);
  return launch_persistent(item_kernel<W, kOut, false>, threads, smem, stream, A, cand, list,
                           counters, counters + 1, out, per, l);
}

}  // namespace
}  // namespace repro_torch
