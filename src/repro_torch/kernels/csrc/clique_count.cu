// Per-tile l-clique count by a bitset DFS split into its second-level branches.
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
//   issue rate, by the latency of each step's dependent chain and by
//   divergence (tiles and branches differ widely in DFS cost), not by bytes.
// Design (dfs_items.cuh), against the four limits of a warp per tile:
//   - too few warps in flight: the work is split into items, the DFS's
//     second-level branches (tile b, v, x), up to T * (T - 1) / 2 a tile,
//     run by a persistent grid sized from the occupancy calculator and the
//     SM count, so a 256-tile batch fills every SM with as many warps as fit;
//   - idle lanes: a group of P lanes runs one item, P = W = T/32 rounded
//     up to a power of two, lane r < W owning word r of every stack level
//     (at W = 3, 5, 6, 7 lanes r >= W own a zero word: the tile is not
//     padded to the next power of two, so its loads and its DFS stay at W
//     words); at T = 32 each thread walks its own DFS with __ffs/__popc and
//     no warp collective; the closes deal the set's vertices round robin
//     over all P lanes;
//   - shared memory sized for the widest bin: only the todo stack lives in
//     shared memory, (l - 5) words a thread, dynamic, so every l <= T runs
//     (opted in above 48 KB, and in smaller blocks where 256 threads' stack
//     would pass the card's 227 KB); A rows are read through the read-only
//     path (a batch's A is at most 2 MB, inside L2);
//   - the slowest tile sets the launch's time: a branch pass lists the
//     items (first-level branches v-major, so the heavy low-v ones first)
//     and groups take them from a global counter.  An item is a small
//     share of its tile; first-level branches were not (measured on the
//     H100: the heaviest branch of one T = 64 tile took 2.0 of a batch's
//     2.4 ms).
//   Items add into out[tile] with a uint32 atomicAdd: sums mod 2^32 are
//   order-free, so the reference's wrap is kept exactly.  The wrapper zeroes
//   out and the two counters.  l <= 3 rides on the same items (an item
//   counts 1, or popcount(t) at l = 3).
// Tiles wider than 256 (W > 8) take the wide path of dfs_wide.cuh, chosen
//   by the same entry points: one instantiation with W a runtime argument,
//   a warp an item, 64-bit items and the DFS's sets in per-warp global
//   scratch.  W = 1..8 keep their instantiations above.
#include <cuda_runtime.h>

#include "dfs_items.cuh"
#include "dfs_wide.cuh"
#include "events.cuh"

namespace repro_torch {
namespace {

template <ItemOut kOut>
int count_launch(const void* A, const void* cand, void* out, void* per, void* list,
                 void* counters, void* scratch, long long scratch_words, int B, int T, int l,
                 void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const auto* a = static_cast<const uint32_t*>(A);
  const auto* c = static_cast<const uint32_t*>(cand);
  auto* ctr = static_cast<unsigned*>(counters);
  auto* o = static_cast<uint32_t*>(out);
  auto* p = static_cast<unsigned long long*>(per);
  auto st = static_cast<cudaStream_t>(stream);
  if (T > 256) {  // the wide path: W a runtime argument
    if (!wide::wide_args_ok(B, T, l, scratch_words))
      return static_cast<int>(cudaErrorInvalidValue);
    wide::launch_items_wide<kOut>(a, c, static_cast<unsigned long long*>(list), ctr, o, p,
                                  static_cast<uint32_t*>(scratch),
                                  scratch_words / wide::slot_words(T, l), B, T, l, st);
    return static_cast<int>(cudaGetLastError());
  }
  if (l < 1 || l > T || B >= (1 << 16)) return static_cast<int>(cudaErrorInvalidValue);
  auto* li = static_cast<uint32_t*>(list);
  cudaError_t err;
  switch (T) {
    case 32: err = launch_items<1, kOut>(a, c, li, ctr, o, p, B, l, st); break;
    case 64: err = launch_items<2, kOut>(a, c, li, ctr, o, p, B, l, st); break;
    case 96: err = launch_items<3, kOut>(a, c, li, ctr, o, p, B, l, st); break;
    case 128: err = launch_items<4, kOut>(a, c, li, ctr, o, p, B, l, st); break;
    case 160: err = launch_items<5, kOut>(a, c, li, ctr, o, p, B, l, st); break;
    case 192: err = launch_items<6, kOut>(a, c, li, ctr, o, p, B, l, st); break;
    case 224: err = launch_items<7, kOut>(a, c, li, ctr, o, p, B, l, st); break;
    case 256: err = launch_items<8, kOut>(a, c, li, ctr, o, p, B, l, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// A: (B, T, T/32) words, cand: (B, T/32), out: (B,) uint32, counters: two
// uint32, all device pointers, out and counters zeroed by the caller;
// 1 <= l <= T, B < 2^16, T a multiple of 32.  At T <= 256 list has room
// for B * T * (T + 1) / 2 uint32 items and scratch is unused (null, 0); at
// T > 256 (the wide path) list has room for as many uint64 items and
// scratch holds scratch_words uint32 words, at least 8 slots of
// dfs_slot_words(T, l) (one slot a warp of the item pass).  Launches the
// branch and item passes on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for an argument it does not take, or the error of
// the item pass's shared-memory opt-in).  `start` and `end` are CUDA timing
// events or null (events.cuh), recorded on `stream` around the launches.
extern "C" int clique_count_tiles_launch(const void* A, const void* cand, void* out, void* list,
                                         void* counters, void* scratch, long long scratch_words,
                                         int B, int T, int l, void* stream, void* start,
                                         void* end) {
  using namespace repro_torch;
  record_event(start, stream);
  return record_end(count_launch<ItemOut::kTile>(A, cand, out, nullptr, list, counters, scratch,
                                                 scratch_words, B, T, l, stream),
                    end, stream);
}

// The count per first-level branch: per_v (B, T) uint64, zeroed by the
// caller, gets at [b, v] the l-cliques of tile b whose lowest vertex is v.
// Otherwise as above.
extern "C" int clique_count_items_launch(const void* A, const void* cand, void* per_v,
                                         void* list, void* counters, void* scratch,
                                         long long scratch_words, int B, int T, int l,
                                         void* stream, void* start, void* end) {
  using namespace repro_torch;
  record_event(start, stream);
  return record_end(count_launch<ItemOut::kBranch>(A, cand, nullptr, per_v, list, counters,
                                                   scratch, scratch_words, B, T, l, stream),
                    end, stream);
}

// Words of one warp's scratch slot of the wide path at tile width T and
// clique size l (the wrappers size the scratch by it).
extern "C" long long dfs_slot_words(int T, int l) {
  return repro_torch::wide::slot_words(T, l);
}
