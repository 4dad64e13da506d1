// Telemetry window reduction on Hopper by all-pairs ranking: masked median + masked
// total per window.
//
// Replaces the Pallas TPU kernel `_median_weights_pairwise_kernel` (mode
// "pairwise") and its shared tail `_write_median_and_weight` in
// tpu_resiliency/ops/scoring_pallas.py.
//
// Input: `data` f32 [R, S, W] windows addressed through element strides (the
// telemetry ring's [W, R, S] storage read as a permuted view, no copy) and `counts`
// i32 [R, S]. Output: contiguous f32 [R, S] medians (+inf where count <= 0) and
// weights (the masked sum).
//
// What it computes. The TPU kernel ranks every element of a window at once from one
// [W, W] comparison block: slots past the count become +inf, and
//   rank_i = #{j : x_j < x_i} + #{j < i : x_j == x_i}
// is each element's stable rank. The shared tail then sums, into 0.0, the values
// (invalid slots zeroed) whose rank is (n-1)/2 and those whose rank is n/2, with
// n = max(count, 1), and the median is half their sum. Stable ranks are distinct, so
// each sum holds one value; it is still added into 0.0f here, so that a picked -0.0
// comes out as +0.0 exactly as the TPU kernel gives it. Over a window of one slot
// XLA folds the sum into the element itself, so there the value is taken as it is.
//
// Design. A block of 8 warps stages 32 neighbouring windows (window_tile.cuh:
// coalesced row loads of the strided ring, padded rows). The all-pairs work is then
// parallel over elements: lane t of a warp ranks element i of tile window t, the
// warps taking i = warp, warp + 8, ...; each thread compares its element with the W
// staged slots of its window (a warp reads one word of each of 32 windows per step,
// no bank conflicts). The thread whose rank is a median rank writes its value into
// the window's slot in shared memory; after a barrier the first warp writes the
// medians and the weights (a sequential sum in slot order, as the loop kernel).
//
// Bound. At 4096 x 64 x 32 the kernel must read 34.6 MB and write 2.1 MB, 0.011 ms
// at 3.35 TB/s; its W^2 compares per window (268 M there) take 0.004 ms at 67 T/s,
// so bytes bound it. Each compare is one shared-memory load, so this version is
// limited by shared-memory bandwidth, W^2 loads per window, not by memory.
//
// Shared memory: W * 33 * 4 B of dynamic shared memory per block plus 384 B, so
// W <= 1760 on Hopper's 227 KB.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (tpu_resiliency_torch/ops/_build.py). Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "window_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kStaticSharedLimit = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
median_weights_pairwise_kernel(const float* __restrict__ data,
                               const int* __restrict__ counts,
                               float* __restrict__ medians,
                               float* __restrict__ weights, long long n_windows,
                               int signals, int window, long long sr,
                               long long ss, long long sw, long long cr,
                               long long cs) {
  extern __shared__ float xs[];  // [window][kTileStride]
  __shared__ int cnt[tr::kTileWindows];
  __shared__ float lo_s[tr::kTileWindows];
  __shared__ float hi_s[tr::kTileWindows];
  const long long g0 = static_cast<long long>(blockIdx.x) * tr::kTileWindows;
  if (threadIdx.x < tr::kTileWindows) {
    lo_s[threadIdx.x] = 0.0f;
    hi_s[threadIdx.x] = 0.0f;
  }
  tr::stage_tile(data, counts, xs, cnt, g0, n_windows, signals, window, sr, ss,
                 sw, cr, cs);
  __syncthreads();

  const int t = threadIdx.x % tr::kTileWindows;
  const int count = cnt[t];
  const int n = max(count, 1);
  const int lo_idx = (n - 1) / 2;
  const int hi_idx = n / 2;
  for (int i = threadIdx.x / tr::kTileWindows; i < window;
       i += kThreads / tr::kTileWindows) {
    const float xi = xs[i * tr::kTileStride + t];
    int rank = 0;
    for (int j = 0; j < i; ++j) rank += xs[j * tr::kTileStride + t] <= xi;
    for (int j = i + 1; j < window; ++j) rank += xs[j * tr::kTileStride + t] < xi;
    const float xf = i < count ? xi : 0.0f;
    const float picked = window == 1 ? xf : 0.0f + xf;
    if (rank == lo_idx) lo_s[t] = picked;
    if (rank == hi_idx) hi_s[t] = picked;
  }
  __syncthreads();

  const long long g = g0 + t;
  if (threadIdx.x < tr::kTileWindows && g < n_windows) {
    float total = 0.0f;
    const int valid = min(count, window);
    for (int j = 0; j < valid; ++j) total += xs[j * tr::kTileStride + t];
    medians[g] = count > 0 ? 0.5f * (lo_s[t] + hi_s[t]) : CUDART_INF_F;
    weights[g] = total;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`: one block of 256 threads per 32 windows, with
// window * 33 * 4 bytes of dynamic shared memory. Returns the CUDA error code of the
// launch (0 on success); the caller raises on anything else.
int tr_median_weights_pairwise(const float* data, const int* counts,
                               float* medians, float* weights,
                               long long n_windows, int signals, int window,
                               long long sr, long long ss, long long sw,
                               long long cr, long long cs, void* stream) {
  if (n_windows <= 0 || signals <= 0 || window <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (n_windows + tr::kTileWindows - 1) / tr::kTileWindows;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(window) * tr::kTileStride * sizeof(float);
  if (smem > kStaticSharedLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        median_weights_pairwise_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  median_weights_pairwise_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      data, counts, medians, weights, n_windows, signals, window, sr, ss, sw, cr,
      cs);
  return static_cast<int>(cudaGetLastError());
}

const char* tr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
