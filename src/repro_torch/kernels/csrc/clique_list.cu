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
//   order, then (u, w) in row-major order at an edge close.  count is the
//   true total (uint32, wrapping), only ranks < capacity are written,
//   overflow = count > capacity, and the kernel zeroes every row at and past
//   min(count, capacity), so the wrapper allocates the buffer uninitialised.
// Bound on the H100: the input is at most 8 KB a tile; the output is
//   min(count, capacity) * l * 4 bytes of rows (plus the zero fill), and the
//   work is one W-word AND + popcount per DFS step plus one per candidate
//   vertex of every edge close.  It is bound by the latency of each DFS
//   step's dependent chain, by divergence and by scattered row stores, not
//   by HBM bandwidth.
// Design: the work items of dfs_items.cuh, the DFS's second-level branches
//   (tile b, v, x), in four device passes behind one wrapper call:
//   1. branch: list the items (as clique_count.cu does);
//   2. count: the item pass writes each item's exact 64-bit count into a
//      dense (B, T, T) buffer at [b, v, x] (zero elsewhere);
//   3. scan: one block per tile takes the exclusive prefix sum over its
//      T * T entries in (v, x) order, in place, giving each item its first
//      rank, the tile's count (low 32 bits) and overflow flag, and zeroes
//      the rows at and past min(count, capacity);
//   4. emit: every item with rows whose first rank is below capacity walks
//      its branch again and writes its rows from that rank, stopping at
//      capacity; items wholly past capacity are skipped.
//   The DFS takes the lowest set bit first, so every row under (v, x)
//   precedes every row under a later (v', x') and the item blocks in (v, x)
//   order are exactly the per-tile DFS's buffer.  Inside an item, ranks
//   come from prefix sums, never atomics: a close deals the set's vertices
//   round robin over the group's P lanes, each lane counts the rows it
//   completes, a group scan gives each lane its first rank, and each lane
//   writes its rows ascending.  As in the count kernel, a group of P lanes
//   (W = T/32 rounded up to a power of two; lanes r >= W own a zero word)
//   runs one item on a persistent grid, the todo stack and the branch
//   prefix are the only shared memory (sized by l and P), and A is read
//   through L1/L2.  Items that were first-level branches, as a
//   first version of this design had, took 2.7x the warp-per-tile kernel's
//   time on an overflowed k = 6 T = 64 batch: its first branches wrote most
//   of each tile's 16,384 rows with W = 2 lanes.
// Tiles wider than 256 (W > 8) take, through the same entry point, the same
//   four passes on the wide path of dfs_wide.cuh (a warp an item, W a
//   runtime argument, the stack, the close's set and the prefix in per-warp
//   global scratch).  A close deals its set by bit, lane j taking the
//   vertices 32 w + j, one word at a time, so its rows stay in order.  The
//   per-item count buffer is still dense (B, T, T) uint64 (32 MB a tile at
//   T = 2048); the wrapper splits a batch to keep it within PER_X_BYTES.
#include <cuda_runtime.h>

#include "dfs_items.cuh"
#include "dfs_wide.cuh"
#include "events.cuh"

namespace repro_torch {
namespace {

constexpr int kScanThreads = 256;

// One tile's output rows.
struct Rows {
  int* rows;  // (capacity, l) int32
  int capacity;
  int l;
};

// Row `dest` = the npfx prefix vertices (pf[j * pstride]) followed by the
// l - npfx coordinates c0, c1.
__device__ __forceinline__ void put_row(const Rows& out, unsigned long long dest, const int* pf,
                                        int pstride, int npfx, int c0, int c1) {
  if (dest >= static_cast<unsigned long long>(out.capacity)) return;
  int* row = out.rows + dest * out.l;
  for (int j = 0; j < npfx; ++j) row[j] = pf[j * pstride];
  if (npfx < out.l) row[npfx] = c0;
  if (npfx + 1 < out.l) row[npfx + 1] = c1;
}

// Two levels left: every edge (u, w), u < w, of the sub-induced subgraph
// behind the l - 2 prefix vertices, in row-major order, from rank `total`.
// Returns the rank after its rows (or a rank >= capacity once it is full).
template <int W>
__device__ __forceinline__ unsigned long long emit_edges(
    const Group<W>& g, const uint32_t* __restrict__ At, const uint32_t (&sub)[W], int nsub,
    const int* pf, int pstride, const Rows& out, unsigned long long total) {
  constexpr int P = Group<W>::P;
  const unsigned long long cap = static_cast<unsigned long long>(out.capacity);
  Stride<W> it(sub, g.r);
  for (int done = 0; done < nsub && total < cap; done += P) {
    const int u = it.next();  // lane r: the sub's vertex of rank done + r
    uint32_t nb[W];
    uint32_t c = 0;
    if (u >= 0) {
      load_row<W>(At + u * W, nb);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        nb[w] &= sub[w] & gt_word(u, w);
        c += __popc(nb[w]);
      }
    }
    const uint32_t incl = g.inclusive_scan(c);
    if (c) {
      unsigned long long dest = total + (incl - c);
      for (int w2 = take_lowest<W>(nb); w2 >= 0 && dest < cap; w2 = take_lowest<W>(nb))
        put_row(out, dest++, pf, pstride, out.l - 2, u, w2);
    }
    total += g.shfl(incl, P - 1);
  }
  return total;
}

// Writes the rows of an item from rank `first` until they end or reach
// capacity: the p prefix vertices pf[0 .. p) followed by each k-clique of
// the set t (this lane's word; nt its popcount), p + k = l, in the per-tile
// DFS's order.  `stack`: this lane's slot of the level-major todo stack
// (k - 2 levels, `stride` words apart); `pf`: the group's prefix
// (max(l - 2, 2) entries, `pstride` apart), whose first p entries the
// caller wrote.
template <int W>
__device__ __forceinline__ void emit_cliques(const Group<W>& g, const uint32_t* __restrict__ At,
                                             uint32_t t, int nt, int k, const Rows& out,
                                             unsigned long long first, uint32_t* stack,
                                             int stride, int* pf, int pstride) {
  const unsigned long long cap = static_cast<unsigned long long>(out.capacity);
  if (k == 0) {  // the prefix alone
    if (g.r == 0) put_row(out, first, pf, pstride, out.l, 0, 0);
    return;
  }
  if (k == 1) {  // the prefix and each vertex of t, ascending
    const uint32_t c = __popc(t);
    unsigned long long dest = first + (g.inclusive_scan(c) - c);
    for (; t && dest < cap; t &= t - 1u)
      put_row(out, dest++, pf, pstride, out.l - 1, (g.r << 5) + __ffs(t) - 1, 0);
    return;
  }
  if (k == 2) {  // the prefix and each edge of t
    uint32_t sub[W];
    g.gather(t, sub);
    emit_edges<W>(g, At, sub, nt, pf, pstride, out, first);
    return;
  }
  const int p = out.l - k;
  unsigned long long total = first;
  int depth = 0;
  stack[0] = t;
  while (depth >= 0 && total < cap) {
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
    const uint32_t u = after & g.word(At + y * W);
    const int nu = static_cast<int>(g.sum(__popc(u)));
    if (depth == k - 3) {  // two levels left: emit the edges of u
      if (nu >= 2) {
        if (g.r == 0) pf[(p + depth) * pstride] = y;
        g.sync();
        uint32_t sub[W];
        g.gather(u, sub);
        total = emit_edges<W>(g, At, sub, nu, pf, pstride, out, total);
        g.sync();  // every lane has read the prefix before it changes
      }
    } else if (nu >= k - depth - 1) {  // push
      if (g.r == 0) pf[(p + depth) * pstride] = y;
      ++depth;
      stack[depth * stride] = u;
    }
  }
}

// The emit pass: every listed item with rows below capacity writes them.
// kFull as in item_kernel: a block of kItemThreads threads.
template <int W, bool kFull>
__global__ void __launch_bounds__(kItemThreads, kItemMinBlocks)
list_emit_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ cand,
                 const uint32_t* __restrict__ list, const unsigned* __restrict__ n_list,
                 unsigned* __restrict__ counter, const unsigned long long* __restrict__ firsts,
                 int* __restrict__ rows, int l, int capacity) {
  extern __shared__ uint32_t list_smem[];
  constexpr int T = W * 32;
  const Group<W> g;
  const int levels = l > 4 ? l - 4 : 1;
  const int threads = kFull ? kItemThreads : static_cast<int>(blockDim.x);
  uint32_t* stack = list_smem + threadIdx.x;  // level-major: no bank conflicts
  const int groups = threads / Group<W>::P;
  int* pf = reinterpret_cast<int*>(list_smem + levels * threads) + threadIdx.x / Group<W>::P;
  const unsigned n = *n_list;
  for (unsigned i = next_item(g, counter); i < n; i = next_item(g, counter)) {
    const uint32_t item = list[i];
    const int b = static_cast<int>(item >> 16);
    const int v = static_cast<int>((item >> 8) & 0xFFu);
    const int x = static_cast<int>(item & 0xFFu);
    const size_t at = (static_cast<size_t>(b) * T + v) * T + x;
    const unsigned long long first = firsts[at];
    // l <= 2: one row; else the next entry of the tile's scan (x > v, so
    // (v, x) is never the tile's last entry)
    const unsigned long long count = l <= 2 ? 1ull : firsts[at + 1] - first;
    if (count == 0ull || first >= static_cast<unsigned long long>(capacity)) continue;
    const uint32_t* At = A + static_cast<size_t>(b) * T * W;
    const Rows out{rows + static_cast<size_t>(b) * capacity * l, capacity, l};
    if (g.r == 0) {
      pf[0] = v;
      if (l >= 2) pf[groups] = x;
    }
    g.sync();
    if (l <= 2) {
      emit_cliques<W>(g, At, 0u, 0, 0, out, first, stack, threads, pf, groups);
    } else {
      int nt;
      const uint32_t t = second_branch(g, At, cand + static_cast<size_t>(b) * W, v, x, &nt);
      emit_cliques<W>(g, At, t, nt, l - 2, out, first, stack, threads, pf, groups);
    }
    g.sync();  // the prefix is read before the next item writes it
  }
}

// One block per tile: the exclusive prefix sum of its T * T item counts in
// place (first ranks), the tile's count and flag, and the zero fill.
__global__ void __launch_bounds__(kScanThreads)
list_scan_kernel(unsigned long long* __restrict__ per_x, int* __restrict__ rows,
                 uint32_t* __restrict__ out_count, uint32_t* __restrict__ out_overflow, int T,
                 int l, int capacity) {
  __shared__ unsigned long long s_warp[kScanThreads / 32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = T * T / kScanThreads;  // entries a thread sums, in order
  unsigned long long* mine = per_x + static_cast<size_t>(b) * T * T + threadIdx.x * per;
  unsigned long long sum = 0;
  for (int i = 0; i < per; ++i) sum += mine[i];
  unsigned long long incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  unsigned long long before = 0, total = 0;
  for (int w = 0; w < kScanThreads / 32; ++w) {
    if (w < warp) before += s_warp[w];
    total += s_warp[w];
  }
  unsigned long long run = before + incl - sum;
  for (int i = 0; i < per; ++i) {
    const unsigned long long c = mine[i];
    mine[i] = run;
    run += c;
  }
  if (threadIdx.x == 0) {
    const uint32_t count = static_cast<uint32_t>(total);  // wraps as the reference
    out_count[b] = count;
    out_overflow[b] = count > static_cast<uint32_t>(capacity) ? 1u : 0u;
  }
  // zero every row at and past min(count, capacity), 16 bytes a store where
  // the address allows it
  const unsigned long long cap = static_cast<unsigned long long>(capacity);
  const size_t written = static_cast<size_t>(total < cap ? total : cap);
  int* lo = rows + static_cast<size_t>(b) * capacity * l + written * l;
  int* hi = rows + static_cast<size_t>(b + 1) * capacity * l;
  int* lo4 = reinterpret_cast<int*>((reinterpret_cast<uintptr_t>(lo) + 15) & ~uintptr_t{15});
  int* hi4 = reinterpret_cast<int*>(reinterpret_cast<uintptr_t>(hi) & ~uintptr_t{15});
  if (lo4 > hi4) lo4 = hi4 = hi;
  for (int* q = lo + threadIdx.x; q < lo4; q += blockDim.x) *q = 0;
  for (int4* q = reinterpret_cast<int4*>(lo4) + threadIdx.x; q < reinterpret_cast<int4*>(hi4);
       q += blockDim.x)
    *q = make_int4(0, 0, 0, 0);
  for (int* q = hi4 + threadIdx.x; q < hi; q += blockDim.x) *q = 0;
}

template <int W>
cudaError_t launch_list(const uint32_t* A, const uint32_t* cand, int* rows, uint32_t* count,
                        uint32_t* overflow, unsigned long long* per_x, uint32_t* list,
                        unsigned* counters, int B, int l, int capacity, cudaStream_t stream) {
  cudaError_t err =
      launch_items<W, ItemOut::kItem>(A, cand, list, counters, nullptr, per_x, B, l, stream);
  if (err != cudaSuccess) return err;
  list_scan_kernel<<<B, kScanThreads, 0, stream>>>(per_x, rows, count, overflow, W * 32, l,
                                                   capacity);
  // the todo stack (l - 4 words a thread) and the prefix (l - 2 entries a
  // group of Group<W>::P threads)
  const int levels = l > 4 ? l - 4 : 1;
  const int prefix = l > 4 ? l - 2 : 2;
  int threads = 0, smem = 0;
  err = item_block(
      [&](int t) {
        return (levels * t + prefix * (t / Group<W>::P)) * static_cast<int>(sizeof(uint32_t));
      },
      &threads, &smem);
  if (err != cudaSuccess) return err;
  if (threads == kItemThreads)
    return launch_persistent(list_emit_kernel<W, true>, threads, smem, stream, A, cand, list,
                             counters, counters + 2, per_x, rows, l, capacity);
  return launch_persistent(list_emit_kernel<W, false>, threads, smem, stream, A, cand, list,
                           counters, counters + 2, per_x, rows, l, capacity);
}

// ---- the wide path (W > 8) ------------------------------------------------

// Two levels left: every edge (u, w), u < w, of the set s (W words every
// lane may read) behind the l - 2 prefix vertices, in row-major order, from
// rank `total`: one word of s at a time, lane j taking its vertex 32 w + j,
// a warp scan giving each lane its first rank.  Returns the rank after its
// rows (or a rank >= capacity once it is full).
__device__ __forceinline__ unsigned long long emit_edges_wide(const uint32_t* __restrict__ At,
                                                              const uint32_t* s, const int* pf,
                                                              const Rows& out,
                                                              unsigned long long total, int W,
                                                              int lane) {
  const unsigned long long cap = static_cast<unsigned long long>(out.capacity);
  for (int wu = 0; wu < W && total < cap; ++wu) {
    const uint32_t sw = s[wu];
    if (!sw) continue;  // warp-uniform
    const int u = (wu << 5) + lane;
    const uint32_t* Au = At + static_cast<size_t>(u) * W;
    uint32_t c = 0;
    if ((sw >> lane) & 1u)
      for (int w = wu; w < W; ++w) c += __popc(__ldg(Au + w) & s[w] & gt_word(u, w));
    const uint32_t incl = wide::warp_scan(c, lane);
    if (c) {
      unsigned long long dest = total + (incl - c);
      for (int w = wu; w < W && dest < cap; ++w) {
        uint32_t nb = __ldg(Au + w) & s[w] & gt_word(u, w);
        for (; nb && dest < cap; nb &= nb - 1u)
          put_row(out, dest++, pf, 1, out.l - 2, u, (w << 5) + __ffs(nb) - 1);
      }
    }
    total += __shfl_sync(kFullMask, incl, 31);
  }
  return total;
}

// Writes the rows of an item from rank `first` until they end or reach
// capacity: the prefix pf[0 .. l - k) followed by each k-clique of the set at
// stack[0 .. W) (each lane's words written by that lane), in the per-tile
// DFS's order.  Stack level d sits at stack + d * W, `close` is the set an
// edge close reads.
__device__ __forceinline__ void emit_cliques_wide(const uint32_t* __restrict__ At,
                                                  uint32_t* stack, uint32_t* close, int* pf,
                                                  int k, const Rows& out,
                                                  unsigned long long first, int W, int lane) {
  const unsigned long long cap = static_cast<unsigned long long>(out.capacity);
  if (k == 1) {  // the prefix and each vertex of t, ascending: 32 words a round
    unsigned long long total = first;
    for (int w0 = 0; w0 < W && total < cap; w0 += 32) {
      const int w = w0 + lane;  // this lane's own word
      uint32_t m = w < W ? stack[w] : 0u;
      const uint32_t c = __popc(m);
      const uint32_t incl = wide::warp_scan(c, lane);
      unsigned long long dest = total + (incl - c);
      for (; m && dest < cap; m &= m - 1u)
        put_row(out, dest++, pf, 1, out.l - 1, (w << 5) + __ffs(m) - 1, 0);
      total += __shfl_sync(kFullMask, incl, 31);
    }
    return;
  }
  __syncwarp();  // every lane wrote its words of level 0 and the prefix
  if (k == 2) {
    emit_edges_wide(At, stack, pf, out, first, W, lane);
    return;
  }
  const int p = out.l - k;
  unsigned long long total = first;
  int depth = 0;
  while (depth >= 0 && total < cap) {
    uint32_t* todo = stack + static_cast<size_t>(depth) * W;
    const int y = wide::take_lowest_wide(todo, W, lane);
    if (y < 0) {  // frontier exhausted: pop
      --depth;
      continue;
    }
    const bool closing = depth == k - 3;  // two levels left
    uint32_t* dst = closing ? close : todo + W;
    const int nu = wide::and_row(dst, todo, At + static_cast<size_t>(y) * W, W, lane);
    if (closing) {
      if (nu >= 2) {
        if (lane == 0) pf[p + depth] = y;
        __syncwarp();
        total = emit_edges_wide(At, close, pf, out, total, W, lane);
        __syncwarp();  // every lane has read the set and prefix before they change
      }
    } else if (nu >= k - depth - 1) {  // push
      if (lane == 0) pf[p + depth] = y;
      ++depth;
    }
  }
}

// The emit pass of the wide path: a warp an item with rows below capacity.
__global__ void __launch_bounds__(wide::kThreads)
list_emit_wide(const uint32_t* __restrict__ A, const uint32_t* __restrict__ cand,
               const unsigned long long* __restrict__ list, const unsigned* __restrict__ n_list,
               unsigned* __restrict__ counter, const unsigned long long* __restrict__ firsts,
               int* __restrict__ rows, uint32_t* scratch, long long slot, int T, int l,
               int capacity) {
  const int W = T >> 5;
  const int lane = threadIdx.x & 31;
  uint32_t* stack = wide::warp_slot(scratch, slot);
  uint32_t* close = stack + static_cast<size_t>(l > 4 ? l - 4 : 1) * W;
  int* pf = reinterpret_cast<int*>(close + W);
  const unsigned n = *n_list;
  for (unsigned i = wide::next_item(counter, lane); i < n; i = wide::next_item(counter, lane)) {
    int b, v, x;
    wide::unpack(list[i], &b, &v, &x);
    const size_t at = (static_cast<size_t>(b) * T + v) * T + x;
    const unsigned long long first = firsts[at];
    // l <= 2: one row; else the next entry of the tile's scan (x > v)
    const unsigned long long count = l <= 2 ? 1ull : firsts[at + 1] - first;
    if (count == 0ull || first >= static_cast<unsigned long long>(capacity)) continue;
    const uint32_t* At = A + static_cast<size_t>(b) * T * W;
    const Rows out{rows + static_cast<size_t>(b) * capacity * l, capacity, l};
    if (lane == 0) {
      pf[0] = v;
      if (l >= 2) pf[1] = x;
    }
    __syncwarp();
    if (l <= 2) {
      if (lane == 0) put_row(out, first, pf, 1, l, 0, 0);
    } else {
      wide::second_branch_wide(stack, At, cand + static_cast<size_t>(b) * W, v, x, W, lane);
      emit_cliques_wide(At, stack, close, pf, l - 2, out, first, W, lane);
    }
    __syncwarp();  // the prefix is read before the next item writes it
  }
}

void launch_list_wide(const uint32_t* A, const uint32_t* cand, int* rows, uint32_t* count,
                      uint32_t* overflow, unsigned long long* per_x, unsigned long long* list,
                      unsigned* counters, uint32_t* scratch, long long slots, int B, int T,
                      int l, int capacity, cudaStream_t stream) {
  wide::launch_items_wide<ItemOut::kItem>(A, cand, list, counters, nullptr, per_x, scratch,
                                          slots, B, T, l, stream);
  list_scan_kernel<<<B, kScanThreads, 0, stream>>>(per_x, rows, count, overflow, T, l,
                                                   capacity);
  list_emit_wide<<<wide::wide_grid(list_emit_wide, slots), wide::kThreads, 0, stream>>>(
      A, cand, list, counters, counters + 2, per_x, rows, scratch, wide::slot_words(T, l), T, l,
      capacity);
}

}  // namespace
}  // namespace repro_torch

// A: (B, T, T/32) words, cand: (B, T/32), out: (B, capacity, l) int32,
// count and overflow: (B,) uint32, per_x: B * T * T uint64 and counters:
// three uint32, both zeroed by the caller, all device pointers;
// 1 <= l <= T, capacity >= 1, B < 2^16, T a multiple of 32.  At T <= 256
// list has room for B * T * (T + 1) / 2 uint32 items and scratch is unused
// (null, 0); at T > 256 (the wide path) list has room for as many uint64
// items and scratch holds scratch_words uint32 words, at least 8 slots of
// dfs_slot_words(T, l) (one slot a warp of the item and emit passes).
// Launches four kernels on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for an argument it does not take, or the error of
// a shared-memory opt-in).
static int list_launch(const void* A, const void* cand, void* out, void* count,
                       void* overflow, void* per_x, void* list, void* counters, void* scratch,
                       long long scratch_words, int B, int T, int l, int capacity,
                       void* stream) {
  using namespace repro_torch;
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const auto* a = static_cast<const uint32_t*>(A);
  const auto* c = static_cast<const uint32_t*>(cand);
  auto* o = static_cast<int*>(out);
  auto* n = static_cast<uint32_t*>(count);
  auto* f = static_cast<uint32_t*>(overflow);
  auto* px = static_cast<unsigned long long*>(per_x);
  auto* ctr = static_cast<unsigned*>(counters);
  auto st = static_cast<cudaStream_t>(stream);
  if (T > 256) {  // the wide path: W a runtime argument
    if (capacity < 1 || !wide::wide_args_ok(B, T, l, scratch_words))
      return static_cast<int>(cudaErrorInvalidValue);
    launch_list_wide(a, c, o, n, f, px, static_cast<unsigned long long*>(list), ctr,
                     static_cast<uint32_t*>(scratch), scratch_words / wide::slot_words(T, l), B,
                     T, l, capacity, st);
    return static_cast<int>(cudaGetLastError());
  }
  if (l < 1 || l > T || capacity < 1 || B >= (1 << 16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* li = static_cast<uint32_t*>(list);
  cudaError_t err;
  switch (T) {
    case 32: err = launch_list<1>(a, c, o, n, f, px, li, ctr, B, l, capacity, st); break;
    case 64: err = launch_list<2>(a, c, o, n, f, px, li, ctr, B, l, capacity, st); break;
    case 96: err = launch_list<3>(a, c, o, n, f, px, li, ctr, B, l, capacity, st); break;
    case 128: err = launch_list<4>(a, c, o, n, f, px, li, ctr, B, l, capacity, st); break;
    case 160: err = launch_list<5>(a, c, o, n, f, px, li, ctr, B, l, capacity, st); break;
    case 192: err = launch_list<6>(a, c, o, n, f, px, li, ctr, B, l, capacity, st); break;
    case 224: err = launch_list<7>(a, c, o, n, f, px, li, ctr, B, l, capacity, st); break;
    case 256: err = launch_list<8>(a, c, o, n, f, px, li, ctr, B, l, capacity, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// list_launch's entry point.  `start` and `end` are CUDA timing events or
// null (events.cuh), recorded on `stream` around the launches.
extern "C" int clique_list_tiles_launch(const void* A, const void* cand, void* out,
                                        void* count, void* overflow, void* per_x, void* list,
                                        void* counters, void* scratch, long long scratch_words,
                                        int B, int T, int l, int capacity, void* stream,
                                        void* start, void* end) {
  using namespace repro_torch;
  record_event(start, stream);
  return record_end(list_launch(A, cand, out, count, overflow, per_x, list, counters, scratch,
                                scratch_words, B, T, l, capacity, stream),
                    end, stream);
}
