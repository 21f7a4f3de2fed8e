// Split-KV (flash-decoding) decode attention: dense or paged cache, bf16/f32
// or int8 codes with per-row scales.
//
// Replaces repro/kernels/flash_decode.py (TPU; body _decode_body, combine
// _combine): flash_decode_pallas, flash_decode_q8_pallas,
// flash_decode_paged_pallas and flash_decode_paged_q8_pallas.  q (B, 1, H,
// hd); dense caches in their native (B, KH, S, hd) layout, paged stores
// (P, KH, ps, hd) read through page_table (B, NP) (logical position p of
// slot b lives at offset p % ps of page table[b, p / ps]); int8 variants
// carry f32 scales (.., 1) beside the codes; cache_len (B,) int32; optional
// sliding window (positions [len - window, len)); out (B, 1, H, hd) in q's
// dtype.  The H = KH * G query heads are grouped: head kh * G + g reads KV
// head kh.
//
// What bounds it on the H100: each live cache row is read once and used
// for G = 4 query heads, ~2 flops per byte, so it is bound by the bytes of
// the live K/V rows (len * KH * hd * 2 * sizeof(elem) per slot, plus 8 B of
// scales per row for int8), not by max_len.
//
// Design: one block per (b, kv_head, split of bs logical positions).  The
// split boundaries do not depend on the cache kind (128 positions, however
// many pages that spans), and the per-position warp dots, the softmax folds
// and the sequential P.V fold are the same code for every kind: only the
// row address differs (the Rows policy).  So a paged cache gives exactly
// the dense kernel's bits on the same logical cache, and paged int8 the
// dense int8 kernel's.  A split past cache_len (or wholly below the window)
// is dead: it writes the combine identity (o, m, l) = (0, -1e30, 0) without
// reading the cache, so traffic tracks the live length.  A live split keeps
// the G query rows and, when paged, each live position's row index (the
// page-table read and the division by ps, done once) in shared memory and
// makes one pass over its K rows (one warp per position, lanes across hd)
// for all G heads, then one pass over its V rows (threads across hd,
// coalesced).  Masked positions are never read, which also keeps garbage in
// unmapped pages (the trash page 0) out: their probability and V row count
// as exactly zero.  The int8 fold follows the reference body: score = (q .
// k_codes) * hd^-0.5 * k_scale, softmax sum l taken before the V scale
// multiplies the probabilities; int8 rows are read as 32-bit words (4 codes
// each).  A second small kernel merges the per-split partials by the
// log-sum-exp combine, so a slot whose cache_len is 0 yields 0.
#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::to_f32;
using repro::store_as;
using repro::warp_max;
using repro::warp_sum;

constexpr int FD_THREADS = 128;
constexpr int FD_WARPS = FD_THREADS / 32;

// Row address policies: the index of the hd-wide row holding logical
// position p of (slot b, kv head h); element d of it is at row * hd + d and
// its scale (int8 variants) at scales[row].
struct DenseRows {
  static constexpr bool kResolve = false;   // cheap: computed where used
  int KH, S;
  __device__ __forceinline__ size_t row(int b, int h, int p) const {
    return (static_cast<size_t>(b) * KH + h) * S + p;
  }
};

struct PagedRows {
  static constexpr bool kResolve = true;    // resolved once per split
  const int* table;   // (B, np) physical page ids
  int KH, np, ps;
  __device__ __forceinline__ size_t row(int b, int h, int p) const {
    const int page = table[static_cast<size_t>(b) * np + p / ps];
    return (static_cast<size_t>(page) * KH + h) * ps + p % ps;
  }
};

// q (G rows in shared memory) . one cache row, for one query head g.
__device__ __forceinline__ float row_dot(const float* qg, const float* krow,
                                         int hd, int lane) {
  float dot = 0.f;
  for (int d = lane; d < hd; d += 32) dot = fmaf(qg[d], krow[d], dot);
  return dot;
}
__device__ __forceinline__ float row_dot(const float* qg,
                                         const __nv_bfloat16* krow, int hd,
                                         int lane) {
  float dot = 0.f;
  for (int d = lane; d < hd; d += 32) dot = fmaf(qg[d], to_f32(krow[d]), dot);
  return dot;
}
__device__ __forceinline__ float row_dot(const float* qg, const int8_t* krow,
                                         int hd, int lane) {
  const int* words = reinterpret_cast<const int*>(krow);   // hd % 4 == 0
  float dot = 0.f;
  for (int w = lane; w < hd / 4; w += 32) {
    const char4 c = *reinterpret_cast<const char4*>(&words[w]);
    const float* qw = qg + 4 * w;
    dot = fmaf(qw[0], static_cast<float>(c.x), dot);
    dot = fmaf(qw[1], static_cast<float>(c.y), dot);
    dot = fmaf(qw[2], static_cast<float>(c.z), dot);
    dot = fmaf(qw[3], static_cast<float>(c.w), dot);
  }
  return dot;
}

template <typename TQ, typename TC, typename Rows>
__global__ void __launch_bounds__(FD_THREADS)
fd_split(const TQ* __restrict__ q, const TC* __restrict__ kc,
         const TC* __restrict__ vc, const float* __restrict__ ks,
         const float* __restrict__ vs, const int* __restrict__ lens,
         Rows rows, float* __restrict__ po, float* __restrict__ pm,
         float* __restrict__ pl, int KH, int S, int hd, int G, int bs,
         int ns, int window, float scale) {
  constexpr bool kQ8 = sizeof(TC) == 1;
  extern __shared__ float smem[];
  float* qs = smem;             // (G, hd)
  float* pr = smem + G * hd;    // (G, bs) scores, then probabilities
  int* rix = reinterpret_cast<int*>(pr + G * bs);   // (bs) row of position
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
  const TQ* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(h) * G) * hd;
  for (int i = threadIdx.x; i < G * hd; i += FD_THREADS) qs[i] = to_f32(qb[i]);
  // a paged row costs a page-table read and a division by ps: resolve each
  // live position's once for the three passes below
  if constexpr (Rows::kResolve)
    for (int j = lo - start + threadIdx.x; j < hi - start; j += FD_THREADS)
      rix[j] = static_cast<int>(rows.row(b, h, start + j));
  auto row_of = [&](int p) -> size_t {
    if constexpr (Rows::kResolve) return static_cast<size_t>(rix[p - start]);
    else return rows.row(b, h, p);
  };
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = lo + warp; p < hi; p += FD_WARPS) {
    const size_t r = row_of(p);
    const TC* krow = kc + r * hd;
    for (int g = 0; g < G; ++g) {
      const float dot = warp_sum(row_dot(qs + g * hd, krow, hd, lane));
      if (lane == 0) {
        float sc = dot * scale;
        if constexpr (kQ8) sc *= ks[r];
        pr[g * bs + (p - start)] = sc;
      }
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
      sum += e;                 // l is the sum before the V-scale fold
      if constexpr (kQ8)
        pr[g * bs + j] = e * vs[row_of(start + j)];
      else
        pr[g * bs + j] = e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      pm[obase + g] = mx;
      pl[obase + g] = sum;
    }
  }
  __syncthreads();

  if constexpr (kQ8) {
    // each thread owns 4 neighbouring outputs of one head: one 32-bit
    // word (4 codes) of each V row
    for (int i = threadIdx.x; i < G * hd / 4; i += FD_THREADS) {
      const int g = (4 * i) / hd, d = (4 * i) % hd;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int p = lo; p < hi; ++p) {
        const float w = pr[g * bs + (p - start)];
        const char4 c = *reinterpret_cast<const char4*>(vc + row_of(p) * hd + d);
        a0 = fmaf(w, static_cast<float>(c.x), a0);
        a1 = fmaf(w, static_cast<float>(c.y), a1);
        a2 = fmaf(w, static_cast<float>(c.z), a2);
        a3 = fmaf(w, static_cast<float>(c.w), a3);
      }
      float* o = po + obase * hd + static_cast<size_t>(g) * hd + d;
      o[0] = a0;
      o[1] = a1;
      o[2] = a2;
      o[3] = a3;
    }
  } else {
    for (int i = threadIdx.x; i < G * hd; i += FD_THREADS) {
      const int g = i / hd, d = i % hd;
      float acc = 0.f;
      for (int p = lo; p < hi; ++p)
        acc = fmaf(pr[g * bs + (p - start)], to_f32(vc[row_of(p) * hd + d]), acc);
      po[obase * hd + i] = acc;
    }
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

// Split kernel + combine for one (q type, cache element type, row policy).
// S is the logical positions per slot (max_len, or NP * ps when paged).
template <typename TQ, typename TC, typename Rows>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const int* lens, Rows rows, float* po, float* pm,
           float* pl, void* out, int B, int KH, int S, int hd, int G, int bs,
           int window, float scale, cudaStream_t stream) {
  const int ns = (S + bs - 1) / bs;
  const size_t smem = static_cast<size_t>(G) * (hd + bs) * sizeof(float) + bs * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fd_split<TQ, TC, Rows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fd_split<TQ, TC, Rows><<<dim3(B * KH, ns), FD_THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), lens, rows,
      po, pm, pl, KH, S, hd, G, bs, ns, window, scale);
  fd_combine<TQ><<<B * KH, FD_THREADS, 0, stream>>>(po, pm, pl, static_cast<TQ*>(out), KH,
                                                   G, hd, ns);
  return static_cast<int>(cudaGetLastError());
}

// q in bf16 or f32; the cache either in q's type (Q8 false) or int8 codes.
template <bool Q8, typename Rows>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* lens, Rows rows, void* po, void* pm,
             void* pl, void* out, int B, int KH, int S, int hd, int G, int bs,
             int window, float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lens);
  float* o = static_cast<float*>(po);
  float* m = static_cast<float*>(pm);
  float* ls = static_cast<float*>(pl);
  if constexpr (Q8) {
    if (is_bf16)
      return launch<__nv_bfloat16, int8_t>(q, k, v, ks, vs, l, rows, o, m, ls, out, B, KH, S,
                                           hd, G, bs, window, scale, st);
    return launch<float, int8_t>(q, k, v, ks, vs, l, rows, o, m, ls, out, B, KH, S, hd, G,
                                 bs, window, scale, st);
  } else {
    if (is_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, ks, vs, l, rows, o, m, ls, out, B,
                                                  KH, S, hd, G, bs, window, scale, st);
    return launch<float, float>(q, k, v, ks, vs, l, rows, o, m, ls, out, B, KH, S, hd, G, bs,
                                window, scale, st);
  }
}

}  // namespace

// Scratch for every variant: po (B*KH*ns*G*hd), pm and pl (B*KH*ns*G)
// floats, ns = ceil(S/bs) with S the logical positions per slot (NP * ps
// when paged).  window <= 0 means no sliding window.  int8 variants need
// hd % 4 == 0 (rows are read as 32-bit words).  A cache or store holds
// fewer than 2^31 rows of hd (row indices are int).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* lens, void* po, void* pm, void* pl,
                                   void* out, int B, int KH, int S, int hd, int G,
                                   int bs, int window, float scale, int is_bf16,
                                   void* stream) {
  return dispatch<false>(q, k, v, nullptr, nullptr, lens, DenseRows{KH, S}, po, pm, pl, out,
                         B, KH, S, hd, G, bs, window, scale, is_bf16, stream);
}

extern "C" int flash_decode_q8_launch(const void* q, const void* k, const void* ks,
                                      const void* v, const void* vs, const void* lens,
                                      void* po, void* pm, void* pl, void* out, int B,
                                      int KH, int S, int hd, int G, int bs, int window,
                                      float scale, int is_bf16, void* stream) {
  return dispatch<true>(q, k, v, ks, vs, lens, DenseRows{KH, S}, po, pm, pl, out, B, KH, S,
                        hd, G, bs, window, scale, is_bf16, stream);
}

extern "C" int flash_decode_paged_launch(const void* q, const void* k, const void* v,
                                         const void* table, const void* lens, void* po,
                                         void* pm, void* pl, void* out, int B, int KH,
                                         int np, int ps, int hd, int G, int bs,
                                         int window, float scale, int is_bf16,
                                         void* stream) {
  const PagedRows rows{static_cast<const int*>(table), KH, np, ps};
  return dispatch<false>(q, k, v, nullptr, nullptr, lens, rows, po, pm, pl, out, B, KH,
                         np * ps, hd, G, bs, window, scale, is_bf16, stream);
}

extern "C" int flash_decode_paged_q8_launch(const void* q, const void* k, const void* ks,
                                            const void* v, const void* vs,
                                            const void* table, const void* lens, void* po,
                                            void* pm, void* pl, void* out, int B, int KH,
                                            int np, int ps, int hd, int G, int bs,
                                            int window, float scale, int is_bf16,
                                            void* stream) {
  const PagedRows rows{static_cast<const int*>(table), KH, np, ps};
  return dispatch<true>(q, k, v, ks, vs, lens, rows, po, pm, pl, out, B, KH, np * ps, hd, G,
                        bs, window, scale, is_bf16, stream);
}
