// The timing events a wrapper may hand a launch entry point.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// Records `event` (a cudaEvent_t, or null for none) on `stream`.  The launch
// entry points record their `start` before their first launch and their
// `end` behind their last, inside the one call from the host, so the pair's
// elapsed time is the device time of the launches with no host work of the
// caller's between them.
inline cudaError_t record_event(void* event, void* stream) {
  if (!event) return cudaSuccess;
  return cudaEventRecord(static_cast<cudaEvent_t>(event), static_cast<cudaStream_t>(stream));
}

// The entry points' common tail: the launches' error, else `end`'s record's.
inline int record_end(int rc, void* end, void* stream) {
  const cudaError_t err = record_event(end, stream);
  return rc ? rc : static_cast<int>(err);
}

}  // namespace repro_torch
