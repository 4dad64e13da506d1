// Staging of a tile of telemetry windows in shared memory, shared by the radix and
// pairwise window-reduction kernels (median_weights_radix.cu,
// median_weights_pairwise.cu).
//
// A block owns 32 neighbouring (rank, signal) windows g0 .. g0 + 31 and stages them
// slot-major: slot j of tile window t lives at xs[j * kTileStride + t]. Thread t of
// the block always loads tile window t % 32, so one warp reads slot j of 32
// neighbouring windows. On the telemetry ring's permuted [R, S, W] view those are
// neighbouring signals at the same slot, consecutive words of one 128-byte line: the
// loads coalesce although consecutive slots of one window lie R * S words apart.
// The row is padded to 33 words, so a warp that reads 32 slots of ONE window
// (lane l at slot l + 32 i) also hits 32 different banks.
//
// Slots at positions >= count are stored as +inf, as the TPU kernels mask them.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace tr {

constexpr int kTileWindows = 32;
constexpr int kTileStride = kTileWindows + 1;

// Stages tile windows [g0, g0 + 32) into `xs` and their counts into `cnt`; windows
// past n_windows stage as empty. The caller synchronises the block afterwards.
__device__ inline void stage_tile(const float* __restrict__ data,
                                  const int* __restrict__ counts, float* xs,
                                  int* cnt, long long g0, long long n_windows,
                                  int signals, int window, long long sr,
                                  long long ss, long long sw, long long cr,
                                  long long cs) {
  const int t = threadIdx.x % kTileWindows;
  const int rows = blockDim.x / kTileWindows;
  const long long g = g0 + t;
  const float* src = data;
  int count = 0;
  if (g < n_windows) {
    const long long r = g / signals;
    const long long s = g - r * signals;
    src = data + r * sr + s * ss;
    count = counts[r * cr + s * cs];
  }
  if (threadIdx.x < kTileWindows) cnt[t] = count;
  for (int j = threadIdx.x / kTileWindows; j < window; j += rows) {
    xs[j * kTileStride + t] = j < count ? src[j * sw] : CUDART_INF_F;
  }
}

}  // namespace tr
