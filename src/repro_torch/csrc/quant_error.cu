// Fused quantization error of A candidate smoothing scales (the alpha
// search's diagonal loss).
//
// Replaces repro/kernels/quant_error.py::quant_error_pallas (TPU).  For w
// (k, n) in bf16 or f32, scales (A, k) f32 and mean_sq (k,) f32 it computes
//
//   err[a] = sum_ij mean_sq[i] * (deq(Q(w * s_a))[i, j] / s_a[i] - w[i, j])^2 / n
//
// with group-wise (g rows) asymmetric or symmetric quantization: per
// (group, column) lo/hi of w * s_a (asymmetric: lo <= 0 <= hi), scale =
// max(range / denom, 1e-8), zero = rint(-lo / scale) (0 when symmetric),
// codes = clamp(rint(ws / scale) + zero, qmin, qmax) with rint's
// half-to-even rounding, w_hat = (codes - zero) * scale / s_a.  Each
// element's terms are the plain version's, operation for operation; only
// the order of the final sum differs.
//
// What bounds it on the H100: W is read once (k * n * 2 bytes in bf16, 117
// MB for 4096 x 14336), but every element is quantized A times with 16 f32
// operations each (two of them IEEE divisions) on the CUDA cores, so it is
// bound by operations at the f32 (non-tensor) rate, not by bytes.
//
// Design: the TPU grid (A, k/bk, n/bn) streams W once per candidate; here
// one block owns 32 columns of one group of g rows, loads that tile into
// shared memory once and loops over all A candidates.  The 8 warps split
// the group's rows (lane = column), so the per-column lo/hi of a candidate
// is a warp-local pass plus an 8-way merge through shared memory (double
// buffered: one barrier per candidate).  Each block writes one partial per
// candidate into an (A, n_blocks) buffer; a second kernel sums each row in
// a fixed order and divides by n: the result is deterministic, with no
// atomics.  Columns past n (the last tile) hold w = 0 and contribute 0.
#include <math_constants.h>

#include "common.cuh"

namespace {

using repro::to_f32;
using repro::warp_sum;

constexpr int QE_THREADS = 256;
constexpr int QE_WARPS = QE_THREADS / 32;
constexpr int QE_COLS = 32;

template <typename TW>
__global__ void __launch_bounds__(QE_THREADS)
qe_partial(const TW* __restrict__ w, const float* __restrict__ scales,
           const float* __restrict__ msq, float* __restrict__ part, int k,
           int n, int g, int A, float qmin, float qmax, float denom,
           int symmetric) {
  extern __shared__ float smem[];
  float* tile = smem;                              // (g, 32) w values
  float* red = tile + g * QE_COLS;                 // 2 x (lo, hi) x (8, 32)
  float* warp_part = red + 4 * QE_WARPS * QE_COLS; // (A, 8)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = blockIdx.x * QE_COLS + lane;
  const int k0 = blockIdx.y * g;
  const bool live = col < n;
  for (int r = warp; r < g; r += QE_WARPS)
    tile[r * QE_COLS + lane] = live ? to_f32(w[static_cast<size_t>(k0 + r) * n + col]) : 0.f;
  __syncthreads();

  for (int a = 0; a < A; ++a) {
    const float* s = scales + static_cast<size_t>(a) * k + k0;
    float lo = CUDART_INF_F, hi = -CUDART_INF_F;
    for (int r = warp; r < g; r += QE_WARPS) {
      const float ws = tile[r * QE_COLS + lane] * s[r];
      lo = fminf(lo, ws);
      hi = fmaxf(hi, ws);
    }
    float* buf = red + (a & 1) * 2 * QE_WARPS * QE_COLS;
    buf[warp * QE_COLS + lane] = lo;
    buf[(QE_WARPS + warp) * QE_COLS + lane] = hi;
    __syncthreads();
    for (int i = 0; i < QE_WARPS; ++i) {
      lo = fminf(lo, buf[i * QE_COLS + lane]);
      hi = fmaxf(hi, buf[(QE_WARPS + i) * QE_COLS + lane]);
    }
    float scale, zero;
    if (symmetric) {
      scale = fmaxf(fmaxf(fabsf(lo), fabsf(hi)) / denom, 1e-8f);
      zero = 0.f;
    } else {
      lo = fminf(lo, 0.f);
      hi = fmaxf(hi, 0.f);
      scale = fmaxf((hi - lo) / denom, 1e-8f);
      zero = rintf(-lo / scale);
    }
    float acc = 0.f;
    for (int r = warp; r < g; r += QE_WARPS) {
      const float wv = tile[r * QE_COLS + lane], sr = s[r];
      const float ws = wv * sr;
      const float c = fminf(fmaxf(rintf(ws / scale) + zero, qmin), qmax);
      const float d = (c - zero) * scale / sr - wv;
      acc += msq[k0 + r] * d * d;
    }
    acc = warp_sum(acc);
    if (lane == 0) warp_part[a * QE_WARPS + warp] = acc;
  }
  __syncthreads();
  const size_t nb = static_cast<size_t>(gridDim.x) * gridDim.y;
  const size_t bid = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  for (int a = threadIdx.x; a < A; a += QE_THREADS) {
    float t = 0.f;
    for (int i = 0; i < QE_WARPS; ++i) t += warp_part[a * QE_WARPS + i];
    part[static_cast<size_t>(a) * nb + bid] = t;
  }
}

// out[a] = (sum of row a of part, in a fixed order) / n
__global__ void __launch_bounds__(QE_THREADS)
qe_reduce(const float* __restrict__ part, int nb, int n, float* __restrict__ out) {
  __shared__ float sums[QE_WARPS];
  const float* row = part + static_cast<size_t>(blockIdx.x) * nb;
  float t = 0.f;
  for (int j = threadIdx.x; j < nb; j += QE_THREADS) t += row[j];
  t = warp_sum(t);
  if (threadIdx.x % 32 == 0) sums[threadIdx.x / 32] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int i = 0; i < QE_WARPS; ++i) total += sums[i];
    out[blockIdx.x] = total / static_cast<float>(n);
  }
}

template <typename TW>
int launch(const void* w, const float* scales, const float* msq, float* part,
           float* out, int k, int n, int g, int A, float qmin, float qmax,
           float denom, int symmetric, cudaStream_t stream) {
  const dim3 grid((n + QE_COLS - 1) / QE_COLS, k / g);
  const size_t smem = (static_cast<size_t>(g) * QE_COLS + 4 * QE_WARPS * QE_COLS +
                       static_cast<size_t>(A) * QE_WARPS) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(qe_partial<TW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  qe_partial<TW><<<grid, QE_THREADS, smem, stream>>>(
      static_cast<const TW*>(w), scales, msq, part, k, n, g, A, qmin, qmax, denom, symmetric);
  qe_reduce<<<A, QE_THREADS, 0, stream>>>(part, static_cast<int>(grid.x * grid.y), n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch: part holds A * ceil(n / 32) * (k / g) floats.  g divides k.
// denom is qmax when symmetric, else levels - 1.
extern "C" int quant_error_launch(const void* w, const void* scales, const void* msq,
                                  void* part, void* out, int k, int n, int g, int A,
                                  float qmin, float qmax, float denom, int symmetric,
                                  int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scales);
  const float* m = static_cast<const float*>(msq);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  if (is_bf16)
    return launch<__nv_bfloat16>(w, s, m, p, o, k, n, g, A, qmin, qmax, denom, symmetric, st);
  return launch<float>(w, s, m, p, o, k, n, g, A, qmin, qmax, denom, symmetric, st);
}
