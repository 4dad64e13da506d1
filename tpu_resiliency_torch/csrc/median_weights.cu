// Telemetry window reduction on Hopper: masked median + masked total per window.
//
// Replaces the Pallas TPU kernel `_median_weights_kernel` (mode "loop") and its
// shared tail `_write_median_and_weight` in tpu_resiliency/ops/scoring_pallas.py.
//
// Input: `data` f32 [R, S, W] timing windows, addressed through element strides so
// that the telemetry ring's [W, R, S] storage can be read as a permuted view with no
// copy; `counts` i32 [R, S] valid-slot counts (slots at positions >= count are
// masked). Output: contiguous f32 [R, S] medians (+inf where count <= 0) and
// weights (the masked sum, taken in slot order from 0.0f).
//
// Both paths give one thread one (rank, signal) window; neighbouring threads take
// neighbouring signals, so on the ring view a warp's load of slot j reads 32
// consecutive words. The TPU kernel ranks each slot by its stable rank
//   rank_i = #{j : x_j < x_i} + #{j < i : x_j == x_i}
// with the slots at or past the count set to +inf, and its tail takes the median as
// the mean of the values ranked (n-1)/2 and n/2, n = max(count, 1), each added into
// 0.0 (the value where the slot is valid, else 0).
//
// W <= kNetworkMaxWindow (64 as built): the window in one thread's registers,
// sorted by a bitonic network. The thread holds x[P], P the smallest power of two
// >= W (a template parameter, chosen from W at launch), with the slots at or past
// the count and past W set to +inf. Its W loads are independent, so all are in
// flight at once. A bitonic network sorts x ascending with fminf/fmaxf compare-exchanges whose indices
// are compile-time constants: no shared memory, no branch, no dynamic register index.
// Order statistic k is then x[k], taken by an unrolled predicated select. That is the
// value the stable rank picks:
// - ties with the +inf padding break by index and the valid slots come first, so the
//   first n_valid = min(count, W) ranks are the valid values in ascending order, which
//   is x[0 .. n_valid) after any correct sort, whatever the network does with ties;
// - a rank at or past n_valid picks an invalid slot (0) or, when count > W, no slot at
//   all (0);
// - tied values are equal bit for bit except -0.0 against +0.0, and adding the picked
//   value into 0.0 turns either into +0.0. Only a window of one slot keeps the
//   element's sign (XLA folds a sum over one slot into the element); it has nothing
//   to sort. NaN is outside the contract, as in every TPU kernel.
//
// Longer windows: the general path, O(W^2). The masked window is staged
// column-major in shared memory (element j of thread t at xs[j * blockDim.x + t],
// so a warp reading element j touches 32 consecutive words: no bank conflicts),
// and each element's stable rank is counted with two compare loops (j < i counts
// x_j <= x_i, j > i counts x_j < x_i, which is the same sum).
//
// Medians are order statistics, so they match the plain PyTorch version bit for bit;
// the weight is a sequential f32 sum and differs only by summation order.
//
// Bound. Per report the kernel must read R*S*W*4 + R*S*4 bytes and write 2*R*S*4
// bytes; at 4096 x 64 x 32 that is 36.7 MB, about 11 us at 3.35 TB/s. The network's
// 240 compare-exchanges per window at P = 32 are 126 M FMNMX there, about 2 us at
// 67 T/s, so the register path is bytes-bound on this card. The general path does
// R*S*W^2 pair compares and is bound by its compare loop.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (tpu_resiliency_torch/ops/_build.py). Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kMaxThreads = 128;
constexpr size_t kStaticSharedLimit = 48 * 1024;
// Largest window held in registers, a power of two. The build passes it
// (ops/_build.py DEFINES), which is where ops/scoring_kernels.py reads it too.
#ifndef TR_NETWORK_MAX_WINDOW
#error "compile with -DTR_NETWORK_MAX_WINDOW (ops/_build.py)"
#endif
constexpr int kNetworkMaxWindow = TR_NETWORK_MAX_WINDOW;
static_assert(kNetworkMaxWindow >= 1 && (kNetworkMaxWindow & (kNetworkMaxWindow - 1)) == 0,
              "the register network sorts a power of two of slots");

__host__ __device__ constexpr int log2_of(int p) { return p <= 1 ? 0 : 1 + log2_of(p / 2); }

template <int P>
__global__ void __launch_bounds__(kMaxThreads)
median_weights_network_kernel(const float* __restrict__ data,
                              const int* __restrict__ counts,
                              float* __restrict__ medians,
                              float* __restrict__ weights,
                              long long n_windows, int signals, int window,
                              long long sr, long long ss, long long sw,
                              long long cr, long long cs) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= n_windows) return;

  const long long r = g / signals;
  const long long s = g - r * signals;
  const float* src = data + r * sr + s * ss;
  const int count = counts[r * cr + s * cs];

  // Every load is predicated on the window alone, so none waits for the count, and
  // the first P/2 + 1 slots lie inside every window of this P. The address steps by
  // one stride a slot (one 64-bit add), not a product per slot.
  float x[P];
  const float* p = src;
#pragma unroll
  for (int j = 0; j < P; ++j, p += sw) {
    x[j] = j <= P / 2 || j < window ? *p : CUDART_INF_F;
  }

  const int n_valid = min(max(count, 0), window);
  float total = 0.0f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const bool valid = j < n_valid;
    total += valid ? x[j] : 0.0f;
    x[j] = valid ? x[j] : CUDART_INF_F;
  }

  // Bitonic sort, ascending: stage k = 2^ks merges runs of k, sub-stage j = 2^js
  // (js = ks - 1 down to 0) compares i with i ^ j, ascending where (i & k) == 0.
  // Every loop runs a compile-time count of times (the sub-stage loop a fixed
  // kLogP, skipping js < 0), so the unroll is complete and each index a constant.
  constexpr int kLogP = log2_of(P);
#pragma unroll
  for (int ks = 1; ks <= kLogP; ++ks) {
#pragma unroll
    for (int step = 0; step < kLogP; ++step) {
      const int js = ks - 1 - step;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int l = i ^ (1 << (js < 0 ? 0 : js));
        if (js >= 0 && l > i) {
          const float a = x[i];
          const float b = x[l];
          const bool up = (i & (1 << ks)) == 0;
          x[i] = up ? fminf(a, b) : fmaxf(a, b);
          x[l] = up ? fmaxf(a, b) : fminf(a, b);
        }
      }
    }
  }

  const int n = max(count, 1);
  const int k_lo = (n - 1) / 2;
  const int k_hi = n / 2;
  float v_lo = 0.0f;
  float v_hi = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    v_lo = i == k_lo ? x[i] : v_lo;
    v_hi = i == k_hi ? x[i] : v_hi;
  }
  // P == 1 is exactly window == 1, where the picked value keeps its sign.
  const float lo = k_lo < n_valid ? (P == 1 ? v_lo : 0.0f + v_lo) : 0.0f;
  const float hi = k_hi < n_valid ? (P == 1 ? v_hi : 0.0f + v_hi) : 0.0f;
  medians[g] = count > 0 ? 0.5f * (lo + hi) : CUDART_INF_F;
  weights[g] = total;
}

// Launches the network kernel of the smallest P >= window (window <= P on entry).
template <int P, typename... Args>
int launch_network(int window, unsigned blocks, int threads, cudaStream_t stream,
                   Args... args) {
  if constexpr (P > 1) {
    if (window <= P / 2) {
      return launch_network<P / 2>(window, blocks, threads, stream, args...);
    }
  }
  median_weights_network_kernel<P><<<blocks, threads, 0, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

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

// Launches on `stream` with `threads` threads per block: the register network for
// window <= kNetworkMaxWindow, else the general kernel with threads * window * 4
// bytes of dynamic shared memory. Returns the CUDA error code of the launch (0 on
// success); the caller raises on anything else.
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
  if (window <= kNetworkMaxWindow) {
    return launch_network<kNetworkMaxWindow>(
        window, static_cast<unsigned>(blocks), threads,
        static_cast<cudaStream_t>(stream), data, counts, medians, weights, n_windows,
        signals, window, sr, ss, sw, cr, cs);
  }
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
