// Edge-branch candidate sets: cand = A[a] & A[b] & gt(b) and its popcount.
//
// Replaces: the Pallas kernel repro/kernels/intersect.py, edge_candidates
//   (_kernel): for each tile's pair (a, b) the candidate set of the EBBkC
//   sub-branch (Eq. 2), N(a) & N(b) restricted to vertices above b.
// Same function: repro/kernels/ref.py edge_candidates_ref and its torch twin
//   edge_candidates_torch in repro_torch/kernels/intersect.py.
// Bound on the H100: bytes.  Each tile reads two rows of W words and its
//   pair, and writes W words and one count; three word operations a word.
// Design: one thread per tile-word, so neighbouring threads read and write
//   neighbouring words.  W (1, 2, 4 or 8) divides 32, so a tile's W threads
//   sit in one warp and the popcount is summed by __shfl_xor_sync within them.
#include <cuda_runtime.h>

#include "tile_bits.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
edge_candidates_kernel(const uint32_t* __restrict__ A, const int* __restrict__ pairs,
                       uint32_t* __restrict__ cand, uint32_t* __restrict__ n, int B, int T) {
  const int W = T >> 5;
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long tile = g / W;
  const int w = static_cast<int>(g % W);
  uint32_t c = 0;
  if (tile < B) {
    const int a = pairs[2 * tile];
    const int b = pairs[2 * tile + 1];
    const uint32_t* At = A + static_cast<size_t>(tile) * T * W;
    c = At[a * W + w] & At[b * W + w] & gt_word(b, w);
    cand[static_cast<size_t>(tile) * W + w] = c;
  }
  uint32_t p = __popc(c);  // every thread of the warp takes part in the shuffles
  for (int o = W >> 1; o > 0; o >>= 1) p += __shfl_xor_sync(kFullMask, p, o);
  if (tile < B && w == 0) n[tile] = p;
}

}  // namespace
}  // namespace repro_torch

// A: (B, T, T/32) words, pairs: (B, 2) int32 local ids in [0, T), cand:
// (B, T/32) words, n: (B,) uint32, all device pointers.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int edge_candidates_launch(const void* A, const void* pairs, void* cand, void* n,
                                      int B, int T, void* stream) {
  using namespace repro_torch;
  if (B > 0) {
    const long long threads = static_cast<long long>(B) * (T >> 5);
    const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
    edge_candidates_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(A), static_cast<const int*>(pairs),
        static_cast<uint32_t*>(cand), static_cast<uint32_t*>(n), B, T);
  }
  return static_cast<int>(cudaGetLastError());
}
