// Split-KV (flash-decoding) decode attention against a dense cache.
//
// Replaces repro/kernels/flash_decode.py::flash_decode_pallas (TPU; body
// _decode_body, combine _combine).  q (B, 1, H, hd), caches in their
// native (B, KH, S, hd) layout, cache_len (B,) int32, optional sliding
// window (positions [len - window, len)); out (B, 1, H, hd) in q's dtype.
// The H = KH * G query heads are grouped: head kh * G + g reads KV head kh.
//
// What bounds it on the H100: each live cache row is read once and used
// for G = 4 query heads, ~2 flops per byte, so it is bound by the bytes of
// the live K/V rows (len * KH * hd * 2 * 2 B per slot), not by max_len.
//
// Design: one block per (b, kv_head, split of bs positions).  A split
// past cache_len (or wholly below the window) is dead: it writes the
// combine identity (o, m, l) = (0, -1e30, 0) without reading the cache,
// so traffic tracks the live length.  A live split keeps the G query rows
// in shared memory and makes one pass over its K rows (one warp per
// position, lanes across hd) for all G heads, then one pass over its V
// rows (threads across hd, coalesced).  Masked positions are never read:
// their probability and V row count as exactly zero.  A second small
// kernel merges the per-split partials by the log-sum-exp combine, so a
// slot whose cache_len is 0 yields 0.
#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::to_f32;
using repro::store_as;
using repro::warp_max;
using repro::warp_sum;

constexpr int FD_THREADS = 128;
constexpr int FD_WARPS = FD_THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(FD_THREADS)
fd_split(const T* __restrict__ q, const T* __restrict__ kc,
         const T* __restrict__ vc, const int* __restrict__ lens,
         float* __restrict__ po, float* __restrict__ pm,
         float* __restrict__ pl, int KH, int S, int hd, int G, int bs,
         int ns, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;             // (G, hd)
  float* pr = smem + G * hd;    // (G, bs) scores, then probabilities
  const int bh = blockIdx.x, b = bh / KH, h = bh % KH, s = blockIdx.y;
  const int len = lens[b];
  const int start = s * bs, end = min(start + bs, S);
  // live positions of this split: [lo, hi)
  const int lo = window > 0 ? max(start, len - window) : start;
  const int hi = min(end, len);
  const size_t obase = (static_cast<size_t>(bh) * ns + s) * G;
  if (lo >= hi) {               // dead split: the combine identity
    for (int i = threadIdx.x; i < G * hd; i += FD_THREADS) po[obase * hd + i] = 0.f;
    for (int i = threadIdx.x; i < G; i += FD_THREADS) {
      pm[obase + i] = kNegInf;
      pl[obase + i] = 0.f;
    }
    return;
  }
  const int H = KH * G;
  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(h) * G) * hd;
  for (int i = threadIdx.x; i < G * hd; i += FD_THREADS) qs[i] = to_f32(qb[i]);
  __syncthreads();

  const T* kb = kc + static_cast<size_t>(bh) * S * hd;
  const T* vb = vc + static_cast<size_t>(bh) * S * hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = lo + warp; p < hi; p += FD_WARPS) {
    const T* krow = kb + static_cast<size_t>(p) * hd;
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) dot = fmaf(qs[g * hd + d], to_f32(krow[d]), dot);
      dot = warp_sum(dot);
      if (lane == 0) pr[g * bs + (p - start)] = dot * scale;
    }
  }
  __syncthreads();

  for (int g = warp; g < G; g += FD_WARPS) {
    float mx = kNegInf;
    for (int j = lo - start + lane; j < hi - start; j += 32) mx = fmaxf(mx, pr[g * bs + j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lo - start + lane; j < hi - start; j += 32) {
      const float e = expf(pr[g * bs + j] - mx);
      pr[g * bs + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      pm[obase + g] = mx;
      pl[obase + g] = sum;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * hd; i += FD_THREADS) {
    const int g = i / hd, d = i % hd;
    float acc = 0.f;
    for (int p = lo; p < hi; ++p)
      acc = fmaf(pr[g * bs + (p - start)], to_f32(vb[static_cast<size_t>(p) * hd + d]), acc);
    po[obase * hd + i] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(FD_THREADS)
fd_combine(const float* __restrict__ po, const float* __restrict__ pm,
           const float* __restrict__ pl, T* __restrict__ out, int KH, int G,
           int hd, int ns) {
  const int bh = blockIdx.x, b = bh / KH, h = bh % KH, H = KH * G;
  for (int i = threadIdx.x; i < G * hd; i += FD_THREADS) {
    const int g = i / hd, d = i % hd;
    const size_t base = static_cast<size_t>(bh) * ns * G + g;
    float big_m = kNegInf;
    for (int s = 0; s < ns; ++s) big_m = fmaxf(big_m, pm[base + static_cast<size_t>(s) * G]);
    float l_tot = 0.f, acc = 0.f;
    for (int s = 0; s < ns; ++s) {
      const size_t o = base + static_cast<size_t>(s) * G;
      const float w = expf(pm[o] - big_m);
      l_tot = fmaf(w, pl[o], l_tot);
      acc = fmaf(w, po[o * hd + d], acc);
    }
    store_as(out + (static_cast<size_t>(b) * H + static_cast<size_t>(h) * G + g) * hd + d,
             acc / fmaxf(l_tot, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lens,
           float* po, float* pm, float* pl, void* out, int B, int KH, int S,
           int hd, int G, int bs, int window, float scale, cudaStream_t stream) {
  const int ns = (S + bs - 1) / bs;
  const size_t smem = static_cast<size_t>(G) * (hd + bs) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fd_split<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fd_split<T><<<dim3(B * KH, ns), FD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lens,
      po, pm, pl, KH, S, hd, G, bs, ns, window, scale);
  fd_combine<T><<<B * KH, FD_THREADS, 0, stream>>>(po, pm, pl, static_cast<T*>(out), KH, G, hd, ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch: po (B*KH*ns*G*hd), pm and pl (B*KH*ns*G) floats, ns = ceil(S/bs).
// window <= 0 means no sliding window.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* lens, void* po, void* pm, void* pl,
                                   void* out, int B, int KH, int S, int hd, int G,
                                   int bs, int window, float scale, int is_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lens);
  float* o = static_cast<float*>(po);
  float* m = static_cast<float*>(pm);
  float* ls = static_cast<float*>(pl);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, l, o, m, ls, out, B, KH, S, hd, G, bs, window, scale, s);
  return launch<float>(q, k, v, l, o, m, ls, out, B, KH, S, hd, G, bs, window, scale, s);
}
