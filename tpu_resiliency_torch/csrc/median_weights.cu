// Telemetry window reduction on Hopper: masked median + masked total per window.
//
// Replaces the Pallas TPU kernel `_median_weights_kernel` (mode "loop") and its
// shared tail `_write_median_and_weight` in tpu_resiliency/ops/scoring_pallas.py.
//
// Input: `data` f32 [R, S, W] timing windows, addressed through element strides so
// that the telemetry ring's [W, R, S] storage can be read as a permuted view with no
// copy; `counts` i32 [R, S] valid-slot counts (slots at positions >= count are
// masked). Output: contiguous f32 [R, S] medians (+inf where count <= 0) and
// weights (the masked sum).
//
// Design. One thread owns one (rank, signal) window. It stages the masked window
// in shared memory, column-major across the block (element j of thread t lives at
// xs[j * blockDim.x + t]), so a warp reading element j touches 32 consecutive words:
// no bank conflicts. Each element's stable rank
//   rank_i = #{j : x_j < x_i} + #{j < i : x_j == x_i}
// is counted with two compare loops (j < i counts x_j <= x_i, j > i counts
// x_j < x_i, which is the same sum), and the median is the mean of the elements
// whose ranks are (n-1)/2 and n/2 with n = max(count, 1), exactly as the TPU tail
// picks them. Medians are order statistics, so they match the plain PyTorch version
// bit for bit; the weight is a sequential f32 sum and differs only by summation order.
//
// Bound. Per report the kernel must read R*S*W*4 + R*S*4 bytes and write 2*R*S*4
// bytes; at 4096 x 64 x 32 that is 36.7 MB, about 11 us at 3.35 TB/s. It does
// R*S*W^2 pair compares (268 M there). This simple version is limited by the W^2
// compare loop, not by memory; warp-per-window selection is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (tpu_resiliency_torch/ops/_build.py). Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kMaxThreads = 128;
constexpr size_t kStaticSharedLimit = 48 * 1024;

__global__ void __launch_bounds__(kMaxThreads)
median_weights_loop_kernel(const float* __restrict__ data,
                           const int* __restrict__ counts,
                           float* __restrict__ medians,
                           float* __restrict__ weights,
                           long long n_windows, int signals, int window,
                           long long sr, long long ss, long long sw,
                           long long cr, long long cs) {
  extern __shared__ float xs[];  // [window][blockDim.x]
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const long long g = static_cast<long long>(blockIdx.x) * nt + t;
  // No barrier below: each thread touches only its own shared-memory column.
  if (g >= n_windows) return;

  const long long r = g / signals;
  const long long s = g - r * signals;
  const float* src = data + r * sr + s * ss;
  const int count = counts[r * cr + s * cs];

  float total = 0.0f;
  for (int j = 0; j < window; ++j) {
    const bool valid = j < count;
    const float v = src[j * sw];
    xs[j * nt + t] = valid ? v : CUDART_INF_F;
    total += valid ? v : 0.0f;
  }

  const int n = max(count, 1);
  const int lo_idx = (n - 1) / 2;
  const int hi_idx = n / 2;
  // Like the TPU tail, the picked values come from the window with invalid slots
  // zeroed and are summed into 0.0 over every rank match (a picked -0.0 comes out
  // +0.0), except over a window of one slot, whose sum XLA folds into the element.
  float lo = 0.0f;
  float hi = 0.0f;
  for (int i = 0; i < window; ++i) {
    const float xi = xs[i * nt + t];
    int rank = 0;
    for (int j = 0; j < i; ++j) rank += xs[j * nt + t] <= xi;
    for (int j = i + 1; j < window; ++j) rank += xs[j * nt + t] < xi;
    const float xf = i < count ? xi : 0.0f;
    if (rank == lo_idx) lo = window == 1 ? xf : lo + xf;
    if (rank == hi_idx) hi = window == 1 ? xf : hi + xf;
  }
  medians[g] = count > 0 ? 0.5f * (lo + hi) : CUDART_INF_F;
  weights[g] = total;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` with `threads` threads per block and
// threads * window * 4 bytes of dynamic shared memory. Returns the CUDA error code
// of the launch (0 on success); the caller raises on anything else.
int tr_median_weights_loop(const float* data, const int* counts, float* medians,
                           float* weights, long long n_windows, int signals,
                           int window, long long sr, long long ss, long long sw,
                           long long cr, long long cs, int threads, void* stream) {
  if (n_windows <= 0 || signals <= 0 || window <= 0 || threads <= 0 ||
      threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (n_windows + threads - 1) / threads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(threads) * window * sizeof(float);
  if (smem > kStaticSharedLimit) {
    cudaError_t err = cudaFuncSetAttribute(
        median_weights_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  median_weights_loop_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      data, counts, medians, weights, n_windows, signals, window, sr, ss, sw, cr,
      cs);
  return static_cast<int>(cudaGetLastError());
}

const char* tr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
