// Edge-branch candidate sets: cand = A[a] & A[b] & gt(b) and its popcount.
//
// Replaces: the Pallas kernel repro/kernels/intersect.py, edge_candidates
//   (_kernel): for each tile's pair (a, b) the candidate set of the EBBkC
//   sub-branch (Eq. 2), N(a) & N(b) restricted to vertices above b.
// Same function: repro/kernels/ref.py edge_candidates_ref and its torch twin
//   edge_candidates_torch in repro_torch/kernels/intersect.py.
// Bound on the H100: bytes, but at a batch of 256 tiles the bytes take
//   nanoseconds, so a launch is bound by its latency: one load of the pair,
//   then the loads of the two rows it names, then the stores.
// Design: one thread per tile, 64 threads a block, so a batch spreads over
//   B / 64 SMs and no thread waits on another.  The thread loads its pair
//   once (8 bytes), then both rows with the widest loads a row allows (16
//   bytes at W = 4 and 8, 8 at W = 2 and 6, 4 at odd W), and writes its W words and its count, zero-extended
//   into an int64, itself: the wrapper runs no op after the launch.  (A
//   warp per tile that loads the whole tile beside the pair, to take the
//   row loads out of the chain, was measured no faster on the H100 and
//   slower at T = 256; PERF.md.)
#include <cuda_runtime.h>

#include "tile_bits.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 64;

template <int W>
__global__ void __launch_bounds__(kThreads)
edge_candidates_kernel(const uint32_t* __restrict__ A, const int2* __restrict__ pairs,
                       uint32_t* __restrict__ cand, long long* __restrict__ n, int B) {
  constexpr int T = 32 * W;
  const int tile = blockIdx.x * kThreads + threadIdx.x;
  if (tile >= B) return;
  const int2 ab = __ldg(pairs + tile);
  const uint32_t* At = A + static_cast<size_t>(tile) * T * W;
  uint32_t ra[W], rb[W];
  load_row<W>(At + ab.x * W, ra);
  load_row<W>(At + ab.y * W, rb);
  uint32_t* ct = cand + static_cast<size_t>(tile) * W;
  uint32_t count = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t c = ra[w] & rb[w] & gt_word(ab.y, w);
    ct[w] = c;
    count += __popc(c);
  }
  n[tile] = static_cast<long long>(count);  // zero-extended
}

template <int W>
void launch(const void* A, const void* pairs, void* cand, void* n, int B, cudaStream_t stream) {
  edge_candidates_kernel<W><<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(A), static_cast<const int2*>(pairs),
      static_cast<uint32_t*>(cand), static_cast<long long*>(n), B);
}

}  // namespace
}  // namespace repro_torch

// A: (B, T, T/32) words, pairs: (B, 2) int32 local ids in [0, T), 8-byte
// aligned, cand: (B, T/32) words, n: (B,) int64, all device pointers;
// T = 32 * W with 1 <= W <= 8.  Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a T it does not take).
extern "C" int edge_candidates_launch(const void* A, const void* pairs, void* cand, void* n,
                                      int B, int T, void* stream) {
  using namespace repro_torch;
  auto st = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    switch (T) {
      case 32: launch<1>(A, pairs, cand, n, B, st); break;
      case 64: launch<2>(A, pairs, cand, n, B, st); break;
      case 96: launch<3>(A, pairs, cand, n, B, st); break;
      case 128: launch<4>(A, pairs, cand, n, B, st); break;
      case 160: launch<5>(A, pairs, cand, n, B, st); break;
      case 192: launch<6>(A, pairs, cand, n, B, st); break;
      case 224: launch<7>(A, pairs, cand, n, B, st); break;
      case 256: launch<8>(A, pairs, cand, n, B, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
