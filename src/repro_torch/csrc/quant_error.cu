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
// element's terms are the plain version's, bit for bit; only the order of
// the final sum differs.
//
// What bounds it on the H100: W is read once (k * n * 2 bytes in bf16, 117
// MB for 4096 x 14336: 35 us), but every element is quantized A times, each
// time with two divisions, a rounding, a clamp and the weighted square, on
// the CUDA cores.  So it is bound by instruction issue (4 warp instructions
// per clock per SM), not by bytes.  An IEEE division (div.rn.f32) is a
// low-rate reciprocal (MUFU), about eight FFMA-pipe instructions and a
// range-check branch; rintf is a conversion-pipe FRND.
//
// Design:
// * One thread per column, a block of 128 columns x one group of g rows.
//   The register path (g = 64, 128) holds the thread's g values of w in
//   registers for every candidate, so a column's lo/hi is a loop inside the
//   thread: the candidate loop has no barrier, no shuffle and no
//   shared-memory traffic for w.  Other g take the general path, which
//   reads its column from global memory (L1) in each pass and computes the
//   same terms.
// * The block stages s_a[r], the reciprocal of s_a[r] (as hi + lo) for all
//   A candidates and mean_sq[r] in shared memory once; the element loop
//   reads them as 16-byte broadcasts.
// * No division instruction in the candidate loop.  Every divisor is
//   shared: denom by all, scale by the g rows of a (candidate, column),
//   s_a[r] by all n columns of a row.  For each divisor b the kernel
//   computes hi = RN(1/b) and lo = RN((1 - b hi) hi) once; a quotient is
//   then q = RN(a hi + RN(a lo)) (within one ulp of a/b: hi + lo is 1/b to
//   ~2^-47), whose remainder a - b q is exact, and one Markstein step
//   RN(q + (a - b q) hi) gives RN(a / b) (hi within half an ulp of 1/b):
//   one FMUL and three FFMA.  rint(q) is (q + 1.5 * 2^23) - 1.5 * 2^23,
//   exact half-to-even for |q| < 2^22 (|q| <= 2^bits here); the clamp and
//   the zero fold into that shifted domain, and the lower clamp, which
//   never acts (see deviation), is left out.  Both substitutions are held
//   equal to __fdiv_rn and rintf by the tests (tests/test_torch_cuda.py on
//   the card, tests/test_torch_qe.py's float32 model on the CPU).
// * Each thread stores its error per candidate in shared memory; after the
//   candidate loop the block sums each candidate's 128 in a fixed order
//   into an (A, n_blocks) buffer, and a second kernel sums each row in a
//   fixed order and divides by n.  The result is deterministic, with no
//   atomics, and err[a] does not depend on the other candidates.
#include <math_constants.h>

#include "common.cuh"

namespace {

using repro::to_f32;
using repro::warp_sum;

constexpr int QE_THREADS = 128;            // one column per thread
constexpr int QE_WARPS = QE_THREADS / 32;
constexpr int RED_THREADS = 256;
constexpr float kMagic = 12582912.f;       // 1.5 * 2^23

struct QeArgs {
  const void* w;
  const float* scales;
  const float* msq;
  float* part;
  int k, n, g, A;
  float qmax, denom;
  int symmetric;
};

// 1/b as hi + lo: hi = RN(1/b); 1 - b hi is exact for a correctly rounded
// reciprocal, so lo carries the rest of 1/b to ~2^-47 relative.
struct Recip {
  float hi, lo;
};

__device__ __forceinline__ Recip recip(float b) {
  const float hi = __frcp_rn(b);
  return {hi, __fmul_rn(__fmaf_rn(-b, hi, 1.f), hi)};
}

// RN(a / b), given b's Recip: equal to __fdiv_rn(a, b) (see the note above).
__device__ __forceinline__ float div_rn(float a, float b, float hi, float lo) {
  const float q = __fmaf_rn(a, hi, __fmul_rn(a, lo));
  return __fmaf_rn(__fmaf_rn(-b, q, a), hi, q);
}

// rintf(x) for |x| < 2^22: the add rounds to an integer, half to even.
__device__ __forceinline__ float rint_magic(float x) {
  return __fsub_rn(__fadd_rn(x, kMagic), kMagic);
}

// The register paths' occupancy, chosen on the H100 (PERF.md): the blocks
// per SM each asks ptxas to fit, and rows per compiler fence in the second
// pass, which bounds how far ptxas hoists shared-memory loads ahead of
// their use, and with them the registers they hold.
template <int G>
struct RowsCfg;
template <>
struct RowsCfg<64> {
  static constexpr int kMinBlocks = 4, kFence = 32;
};
template <>
struct RowsCfg<128> {
  static constexpr int kMinBlocks = 2, kFence = 16;
};

// One (candidate, column) of the plain version: scale, 1/scale, and the
// upper clamp of rint(ws / scale) + kMagic, shifted by -zero.  The
// divisions are div_rn's (range / denom by denom's Recip).
struct Col {
  float scale, hi, lo, thi;
};

__device__ __forceinline__ Col col_params(float lo, float hi, const QeArgs& p,
                                          const Recip& den) {
  float scale, zero = 0.f;
  if (p.symmetric) {
    scale = fmaxf(div_rn(fmaxf(fabsf(lo), fabsf(hi)), p.denom, den.hi, den.lo), 1e-8f);
  } else {
    lo = fminf(lo, 0.f);
    hi = fmaxf(hi, 0.f);
    scale = fmaxf(div_rn(__fsub_rn(hi, lo), p.denom, den.hi, den.lo), 1e-8f);
  }
  const Recip r = recip(scale);
  if (!p.symmetric) zero = rint_magic(div_rn(-lo, scale, r.hi, r.lo));
  return {scale, r.hi, r.lo, kMagic + (p.qmax - zero)};
}

// w_hat - w for one element: w_hat = ((codes - zero) * scale) / s, with
// codes - zero = min(rint(ws / scale), qmax - zero).  The plain version's
// lower clamp at qmin never acts: ws >= lo (the group's own minimum) and
// RN division and rint are monotonic and odd, so asymmetric codes are >=
// rint(lo / scale) + rint(-lo / scale) = 0, and symmetric ones >= -rint(
// amax / scale) >= -qmax > qmin (amax / scale <= qmax (1 + 2^-23)).
__device__ __forceinline__ float deviation(float wv, float ws, float s, float s_hi,
                                           float s_lo, const Col& c) {
  const float t = fminf(__fadd_rn(div_rn(ws, c.scale, c.hi, c.lo), kMagic), c.thi);
  const float v = __fmul_rn(__fsub_rn(t, kMagic), c.scale);
  return __fsub_rn(div_rn(v, s, s_hi, s_lo), wv);
}

// The block's shared arrays: s and its reciprocal (hi, lo) per (candidate,
// row) of the group, mean_sq per row, and each thread's error per candidate:
// (kPerCandidateRow A g + kPerRow g + QE_THREADS A) floats.
struct Stage {
  float *s, *hi, *lo, *msq, *acc;
};
constexpr int kPerCandidateRow = 3, kPerRow = 1;

__device__ Stage stage(float* smem, const QeArgs& p, int k0) {
  const int ag = p.A * p.g;
  float* msq = smem + kPerCandidateRow * ag;
  const Stage st{smem, smem + ag, smem + 2 * ag, msq, msq + kPerRow * p.g};
  for (int i = threadIdx.x; i < ag; i += QE_THREADS) {
    const int a = i / p.g, r = i - a * p.g;
    const float s = p.scales[static_cast<size_t>(a) * p.k + k0 + r];
    const Recip rc = recip(s);
    st.s[i] = s;
    st.hi[i] = rc.hi;
    st.lo[i] = rc.lo;
  }
  for (int r = threadIdx.x; r < p.g; r += QE_THREADS) st.msq[r] = p.msq[k0 + r];
  return st;
}

// After the candidate loop: candidate a's block sum (its 128 threads'
// errors, in a fixed order) into the (A, n_blocks) buffer.
__device__ void block_partials(const Stage& st, const QeArgs& p) {
  static_assert(QE_THREADS == 128, "four warps' errors per candidate");
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const size_t nb = static_cast<size_t>(gridDim.x) * gridDim.y;
  const size_t bid = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  for (int a = threadIdx.x / 32; a < p.A; a += QE_WARPS) {
    const float* t = st.acc + a * QE_THREADS + lane;
    const float v = warp_sum(__fadd_rn(__fadd_rn(t[0], t[32]), __fadd_rn(t[64], t[96])));
    if (lane == 0) p.part[static_cast<size_t>(a) * nb + bid] = v;
  }
}

// One column's error for one candidate, its G values of w in registers.
// The second pass multiplies w * s again rather than keep the first pass's
// G products in registers (ptxas rematerializes them when asked to keep).
template <int G>
__device__ __forceinline__ float column_error(const float (&wr)[G], const float* s,
                                              const float* s_hi, const float* s_lo,
                                              const float* msq, const QeArgs& p,
                                              const Recip& den) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
  const float4* hi4 = reinterpret_cast<const float4*>(s_hi);
  const float4* lo4 = reinterpret_cast<const float4*>(s_lo);
  const float4* m4 = reinterpret_cast<const float4*>(msq);
  float lo[4], hi[4];
#pragma unroll
  for (int r4 = 0; r4 < G / 4; ++r4) {
    const float4 sv = s4[r4];
    const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = __fmul_rn(wr[4 * r4 + j], sr[j]);
      lo[j] = r4 == 0 ? x : fminf(lo[j], x);
      hi[j] = r4 == 0 ? x : fmaxf(hi[j], x);
    }
  }
  const Col c = col_params(fminf(fminf(lo[0], lo[1]), fminf(lo[2], lo[3])),
                           fmaxf(fmaxf(hi[0], hi[1]), fmaxf(hi[2], hi[3])), p, den);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r4 = 0; r4 < G / 4; ++r4) {
    if (r4 > 0 && 4 * r4 % RowsCfg<G>::kFence == 0)
      asm volatile("" ::: "memory");
    const float4 hv = hi4[r4], lv = lo4[r4], mv = m4[r4];
    const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
    const float lr[4] = {lv.x, lv.y, lv.z, lv.w};
    const float mr[4] = {mv.x, mv.y, mv.z, mv.w};
    const float4 sv = s4[r4];
    const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * r4 + j;
      const float d = deviation(wr[r], __fmul_rn(wr[r], sr[j]), sr[j], hr[j], lr[j], c);
      acc[j] = __fmaf_rn(__fmul_rn(mr[j], d), d, acc[j]);
    }
  }
  return __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
}

// The register path: g == G.  Columns past n hold w = 0, whose error is 0.
template <int G, typename TW>
__global__ void __launch_bounds__(QE_THREADS, RowsCfg<G>::kMinBlocks) qe_rows(QeArgs p) {
  extern __shared__ float4 smem4[];
  const int col = blockIdx.x * QE_THREADS + threadIdx.x;
  const int k0 = blockIdx.y * G;
  const bool live = col < p.n;
  const TW* wc = static_cast<const TW*>(p.w) + static_cast<size_t>(k0) * p.n + col;
  float wr[G];
#pragma unroll
  for (int r = 0; r < G; ++r) wr[r] = live ? to_f32(wc[static_cast<size_t>(r) * p.n]) : 0.f;
  const Stage st = stage(reinterpret_cast<float*>(smem4), p, k0);
  const Recip den = recip(p.denom);
  __syncthreads();
#pragma unroll 1
  for (int a = 0; a < p.A; ++a)     // the candidate loop (SASS counted per element)
    st.acc[a * QE_THREADS + threadIdx.x] = column_error<G>(
        wr, st.s + a * G, st.hi + a * G, st.lo + a * G, st.msq, p, den);
  block_partials(st, p);
}

// The general path: any g; the column is read from global memory in both
// passes of every candidate, the terms are the register path's.
template <typename TW>
__global__ void __launch_bounds__(QE_THREADS) qe_any(QeArgs p) {
  extern __shared__ float4 smem4[];
  const int col = blockIdx.x * QE_THREADS + threadIdx.x;
  const int k0 = blockIdx.y * p.g;
  const bool live = col < p.n;
  const TW* wc = static_cast<const TW*>(p.w) + static_cast<size_t>(k0) * p.n + col;
  const Stage st = stage(reinterpret_cast<float*>(smem4), p, k0);
  const Recip den = recip(p.denom);
  __syncthreads();
  for (int a = 0; a < p.A; ++a) {
    const float* s = st.s + a * p.g;
    const float* s_hi = st.hi + a * p.g;
    const float* s_lo = st.lo + a * p.g;
    float acc = 0.f;
    if (live) {
      float lo = CUDART_INF_F, hi = -CUDART_INF_F;
      for (int r = 0; r < p.g; ++r) {
        const float x = __fmul_rn(to_f32(wc[static_cast<size_t>(r) * p.n]), s[r]);
        lo = fminf(lo, x);
        hi = fmaxf(hi, x);
      }
      const Col c = col_params(lo, hi, p, den);
      for (int r = 0; r < p.g; ++r) {
        const float wv = to_f32(wc[static_cast<size_t>(r) * p.n]);
        const float d = deviation(wv, __fmul_rn(wv, s[r]), s[r], s_hi[r], s_lo[r], c);
        acc = __fmaf_rn(__fmul_rn(st.msq[r], d), d, acc);
      }
    }
    st.acc[a * QE_THREADS + threadIdx.x] = acc;
  }
  block_partials(st, p);
}

// out[a] = (sum of row a of part, in a fixed order) / n
__global__ void __launch_bounds__(RED_THREADS)
qe_reduce(const float* __restrict__ part, int nb, int n, float* __restrict__ out) {
  __shared__ float sums[RED_THREADS / 32];
  const float* row = part + static_cast<size_t>(blockIdx.x) * nb;
  float t = 0.f;
  for (int j = threadIdx.x; j < nb; j += RED_THREADS) t += row[j];
  t = warp_sum(t);
  if (threadIdx.x % 32 == 0) sums[threadIdx.x / 32] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int i = 0; i < RED_THREADS / 32; ++i) total += sums[i];
    out[blockIdx.x] = total / static_cast<float>(n);
  }
}

template <typename TW>
int launch(const QeArgs& p, int path, int smem, float* out, cudaStream_t stream) {
  void (*kern)(QeArgs);
  if (path == 64 && p.g == 64)
    kern = qe_rows<64, TW>;
  else if (path == 128 && p.g == 128)
    kern = qe_rows<128, TW>;
  else if (path == 0)
    kern = qe_any<TW>;
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.k % p.g != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((p.n + QE_THREADS - 1) / QE_THREADS, p.k / p.g);
  kern<<<grid, QE_THREADS, smem, stream>>>(p);
  qe_reduce<<<p.A, RED_THREADS, 0, stream>>>(p.part, static_cast<int>(grid.x * grid.y),
                                             p.n, out);
  return static_cast<int>(cudaGetLastError());
}

// Test only: for each pair, whether div_rn equals __fdiv_rn and whether
// rint_magic of the quotient equals rintf (|quotient| < 2^22).  bad[0]
// counts division mismatches, bad[1] rounding mismatches.
__global__ void qe_div_check(const float* __restrict__ a, const float* __restrict__ b,
                             long long n, unsigned long long* bad) {
  unsigned long long bad_div = 0, bad_rint = 0;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const Recip r = recip(b[i]);
    const float q = div_rn(a[i], b[i], r.hi, r.lo);
    const float want = __fdiv_rn(a[i], b[i]);
    bad_div += !(q == want);
    bad_rint += fabsf(want) < 4194304.f && !(rint_magic(want) == rintf(want));
  }
  bad_div = __reduce_add_sync(repro::kFullMask, static_cast<unsigned>(bad_div));
  bad_rint = __reduce_add_sync(repro::kFullMask, static_cast<unsigned>(bad_rint));
  if (threadIdx.x % 32 == 0) {
    atomicAdd(bad, bad_div);
    atomicAdd(bad + 1, bad_rint);
  }
}

}  // namespace

// The geometry the wrapper's plan is made from (kernels/quant_error.py
// checks it at its first launch): columns per block, the register paths'
// g, and the block's shared floats per (candidate, row) and per row (it
// also holds QE_THREADS per candidate).
extern "C" void quant_error_geometry(int* out) {
  const int geo[5] = {QE_THREADS, 64, 128, kPerCandidateRow, kPerRow};
  for (int i = 0; i < 5; ++i) out[i] = geo[i];
}

// Scratch: part holds A * ceil(n / 128) * (k / g) floats.  g divides k.
// denom is qmax when symmetric, else levels - 1.  path is 64 or 128 (the
// register path for that g) or 0 (the general path), and smem the block's
// dynamic shared memory in bytes: both from the wrapper's plan.
extern "C" int quant_error_launch(const void* w, const void* scales, const void* msq,
                                  void* part, void* out, int k, int n, int g, int A,
                                  float qmax, float denom, int symmetric, int is_bf16,
                                  int path, int smem, void* stream) {
  const QeArgs p{w, static_cast<const float*>(scales), static_cast<const float*>(msq),
                 static_cast<float*>(part), k, n, g, A, qmax, denom, symmetric};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (is_bf16) return launch<__nv_bfloat16>(p, path, smem, o, st);
  return launch<float>(p, path, smem, o, st);
}

// Test only (tests/test_torch_cuda.py): bad (2,) u64, zeroed by the caller.
extern "C" int quant_error_div_check(const void* a, const void* b, long long n, void* bad,
                                     void* stream) {
  qe_div_check<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), n,
      static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaGetLastError());
}
