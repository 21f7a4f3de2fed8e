// W4A16 grouped dequant-GEMM: out = x @ ((nibble - zero) * scale).
//
// Replaces repro/kernels/quant_matmul.py::quant_matmul_pallas (TPU).
// x (m, k) bf16 or f32 (already divided by act_scale), codes (k/2, n)
// uint8 with byte i holding code[2i] in the low nibble and code[2i+1] in
// the high nibble, scale/zero (k/g, n) f32; out (m, n) in x's dtype.
// Codes are dequantized in registers / shared memory and accumulated in
// f32; they never reach device memory dequantized.
//
// What bounds it on the H100: at decode m is the number of serving slots
// (4), so the work is ~4 flops per code byte — far below the ~295 flop/B
// ridge.  Reading the int4 codes plus their f32 scales/zeros (k*n/2 +
// 8*k*n/g bytes) bounds it; at g = 64 that is 0.625 byte per weight.
// Prefill (m = slots x bucket, up to 2048) is compute-bound.
//
// Design:
// * skinny path (m <= 8): each thread owns 4 neighbouring output columns,
//   reads one 32-bit word per packed code row (a warp reads 128
//   contiguous bytes), dequantizes 8 weights in registers and applies
//   them to all m rows held in shared memory.  k is split into chunks of
//   KC rows across blockIdx.y so that even n = 1024 fills the SMs; each
//   chunk writes an f32 partial and a second kernel sums the partials in
//   chunk order and casts.
// * tiled path (m > 8): 64x64 output tile per block, 32-deep k steps,
//   codes dequantized into shared memory, 4x4 outputs per thread on the
//   CUDA cores.
// Both paths accumulate each output as the same sequence: within a chunk
// of KC k-rows a sequential f32 fma chain from 0, then the chunk sums
// added in order.  A row's result therefore does not depend on m or on
// the path taken, so batched serving and single-request generate agree
// bit for bit.  Tensor cores (wgmma) and TMA pipelining are later work.
#include "common.cuh"

namespace {

using repro::to_f32;
using repro::store_as;

constexpr int KC = 256;           // k-rows per accumulation chunk
constexpr int SK_THREADS = 64;    // skinny: threads per block
constexpr int SK_COLS = 4;        // skinny: columns per thread
constexpr int SK_MAXM = 8;        // skinny: largest m
constexpr int TM = 64, TN = 64, TK = 32, T_THREADS = 256;
static_assert(KC % TK == 0, "chunks must hold whole k-steps");

__device__ __forceinline__ float deq(uint32_t code, float zero, float scale) {
  return __fmul_rn(__fsub_rn(static_cast<float>(code), zero), scale);
}

template <typename T>
__global__ void __launch_bounds__(SK_THREADS)
qmm_skinny(const T* __restrict__ x, const uint8_t* __restrict__ codes,
           const float* __restrict__ scale, const float* __restrict__ zero,
           float* __restrict__ partial, int m, int k, int n, int g) {
  __shared__ float xs[SK_MAXM][KC];
  const int split = blockIdx.y;
  const int k0 = split * KC;
  const int klen = min(KC, k - k0);           // even: k and KC are even
  for (int i = threadIdx.x; i < m * klen; i += SK_THREADS) {
    const int r = i / klen, kk = i % klen;
    xs[r][kk] = to_f32(x[static_cast<size_t>(r) * k + k0 + kk]);
  }
  __syncthreads();
  const int c0 = (blockIdx.x * SK_THREADS + threadIdx.x) * SK_COLS;
  if (c0 >= n) return;
  const int nc = min(SK_COLS, n - c0);
  const bool vec = nc == SK_COLS && (n % SK_COLS) == 0 &&
                   (reinterpret_cast<uintptr_t>(codes) % 4) == 0;

  float acc[SK_MAXM][SK_COLS];
#pragma unroll
  for (int r = 0; r < SK_MAXM; ++r)
#pragma unroll
    for (int c = 0; c < SK_COLS; ++c) acc[r][c] = 0.f;
  float sc[SK_COLS] = {0.f, 0.f, 0.f, 0.f}, zr[SK_COLS] = {0.f, 0.f, 0.f, 0.f};
  int cur_group = -1;

#pragma unroll 4
  for (int kk = 0; kk < klen; kk += 2) {
    const int kg = k0 + kk;                    // k of the low nibble
    const uint8_t* row = codes + static_cast<size_t>(kg >> 1) * n + c0;
    uint32_t word = 0;
    if (vec) {
      word = __ldg(reinterpret_cast<const uint32_t*>(row));
    } else {
      for (int c = 0; c < nc; ++c) word |= static_cast<uint32_t>(row[c]) << (8 * c);
    }
    float w0[SK_COLS], w1[SK_COLS];
    int grp = kg / g;
    if (grp != cur_group) {
      cur_group = grp;
      for (int c = 0; c < nc; ++c) {
        sc[c] = __ldg(scale + static_cast<size_t>(grp) * n + c0 + c);
        zr[c] = __ldg(zero + static_cast<size_t>(grp) * n + c0 + c);
      }
    }
#pragma unroll
    for (int c = 0; c < SK_COLS; ++c) w0[c] = deq((word >> (8 * c)) & 0xF, zr[c], sc[c]);
    grp = (kg + 1) / g;                        // differs only for odd g
    if (grp != cur_group) {
      cur_group = grp;
      for (int c = 0; c < nc; ++c) {
        sc[c] = __ldg(scale + static_cast<size_t>(grp) * n + c0 + c);
        zr[c] = __ldg(zero + static_cast<size_t>(grp) * n + c0 + c);
      }
    }
#pragma unroll
    for (int c = 0; c < SK_COLS; ++c) w1[c] = deq((word >> (8 * c + 4)) & 0xF, zr[c], sc[c]);
#pragma unroll
    for (int r = 0; r < SK_MAXM; ++r) {
      if (r < m) {
        const float xa = xs[r][kk], xb = xs[r][kk + 1];
#pragma unroll
        for (int c = 0; c < SK_COLS; ++c) {
          acc[r][c] = __fmaf_rn(xa, w0[c], acc[r][c]);
          acc[r][c] = __fmaf_rn(xb, w1[c], acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < SK_MAXM; ++r) {
    if (r < m) {
      float* dst = partial + (static_cast<size_t>(split) * m + r) * n + c0;
      for (int c = 0; c < nc; ++c) dst[c] = acc[r][c];
    }
  }
}

template <typename T>
__global__ void qmm_reduce(const float* __restrict__ partial, T* __restrict__ out,
                           int mn, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp)
    s = __fadd_rn(s, partial[static_cast<size_t>(sp) * mn + i]);
  store_as(out + i, s);
}

template <typename T>
__global__ void __launch_bounds__(T_THREADS)
qmm_tiled(const T* __restrict__ x, const uint8_t* __restrict__ codes,
          const float* __restrict__ scale, const float* __restrict__ zero,
          T* __restrict__ out, int m, int k, int n, int g) {
  __shared__ float xs[TK][TM + 4];
  __shared__ float ws[TK][TN + 4];
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4], tot[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = tot[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += TK) {
    for (int e = threadIdx.x; e < TM * TK; e += T_THREADS) {
      const int r = e / TK, kk = e % TK;
      const int gr = m0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < m && gk < k) ? to_f32(x[static_cast<size_t>(gr) * k + gk]) : 0.f;
    }
    for (int e = threadIdx.x; e < (TK / 2) * TN; e += T_THREADS) {
      const int i = e / TN, c = e % TN;
      const int gk = k0 + 2 * i, gc = n0 + c;
      float lo = 0.f, hi = 0.f;
      if (gc < n && gk < k) {
        const uint32_t b = codes[static_cast<size_t>(gk >> 1) * n + gc];
        const size_t o0 = static_cast<size_t>(gk / g) * n + gc;
        const size_t o1 = static_cast<size_t>((gk + 1) / g) * n + gc;
        lo = deq(b & 0xF, zero[o0], scale[o0]);
        hi = deq(b >> 4, zero[o1], scale[o1]);
      }
      ws[2 * i][c] = lo;
      ws[2 * i + 1][c] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if ((k0 + TK) % KC == 0 || k0 + TK >= k) {   // chunk boundary: fold
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tot[i][j] = __fadd_rn(tot[i][j], acc[i][j]);
          acc[i][j] = 0.f;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < n) store_as(out + static_cast<size_t>(r) * n + c, tot[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* codes, const void* scale,
           const void* zero, void* out, void* partial, int m, int k, int n,
           int g, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const uint8_t* ct = static_cast<const uint8_t*>(codes);
  const float* st = static_cast<const float*>(scale);
  const float* zt = static_cast<const float*>(zero);
  T* ot = static_cast<T*>(out);
  if (m <= SK_MAXM) {
    const int splits = (k + KC - 1) / KC;
    const dim3 grid((n + SK_THREADS * SK_COLS - 1) / (SK_THREADS * SK_COLS), splits);
    float* pt = static_cast<float*>(partial);
    qmm_skinny<T><<<grid, SK_THREADS, 0, stream>>>(xt, ct, st, zt, pt, m, k, n, g);
    const int mn = m * n;
    qmm_reduce<T><<<(mn + 255) / 256, 256, 0, stream>>>(pt, ot, mn, splits);
  } else {
    const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
    qmm_tiled<T><<<grid, T_THREADS, 0, stream>>>(xt, ct, st, zt, ot, m, k, n, g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int quant_matmul_kchunk() { return KC; }
extern "C" int quant_matmul_skinny_max_m() { return SK_MAXM; }

// partial: f32 scratch of ceil(k / KC) * m * n floats when m <= 8.
extern "C" int quant_matmul_launch(const void* x, const void* codes,
                                   const void* scale, const void* zero,
                                   void* out, void* partial, int m, int k,
                                   int n, int g, int x_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch<__nv_bfloat16>(x, codes, scale, zero, out, partial, m, k, n, g, s);
  return launch<float>(x, codes, scale, zero, out, partial, m, k, n, g, s);
}
