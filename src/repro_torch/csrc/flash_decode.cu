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
// for G = 4 query heads, ~2 flops per byte, so the bytes of the live K/V
// rows bound it (len * KH * hd * 2 * sizeof(elem) per slot, plus 8 B of
// scales per row for int8): 5.1 MB, 1.5 us at 3.35 TB/s, at the main
// path's decode shape (B 4, KH 8, hd 128, lens 44/140/332/732).  Work that
// small is bound in practice by latency: how many bytes are in flight at
// once, and how many dependent steps each block takes.  The first port
// kept 128 positions per block with one warp per position, 2-byte loads
// and a serial P.V chain over global memory, and a second launch for the
// combine (0.080 ms on an H100 80GB HBM3 at 700 W).
//
// Design: one block (16 warps) per (b, kv_head, split of SPLIT = 64 logical
// positions).  A live split first issues 16-byte cp.async copies of all its
// live K and V rows into shared memory (8- or 4-byte copies where the row
// length or alignment does not allow 16), so every row of the split is in
// flight at once, its int8 scales (4-byte copies) in the same group; q loads
// meanwhile.  Scores run in parallel across positions (8 threads per position
// on a full split, each a strided slice of hd; one K load serves up to 8
// heads, q broadcast from shared memory), the softmax folds one warp per
// head, and P.V gives each thread 4 neighbouring output dims of one head
// over a group of the split's rows (two independent chains), the groups'
// partials summed in a fixed order.  Splits write (o, m, l) partials; the
// last live split of each (b, kv_head) to finish, found by a per-(b,
// kv_head) counter, merges them by the log-sum-exp combine in split order
// (the splits' m and l loaded into shared memory first), so the result is
// deterministic and no float atomics are used; it then zeroes the counter
// for the next launch.  Launches that could overlap must not share counters:
// the wrapper keeps one buffer per (device, stream), and one stream runs its
// launches in order.  A slot with one live split writes o / l directly; a
// slot with none (cache_len 0) gets 0 from split 0.  Splits outside the live
// range exit without reading anything.  One launch per call, where the first
// port needed two.
//
// Verify (speculative decoding): q (B, T, H, hd) holds a burst of T
// positions per slot and base (B,) the entries before it; row t attends
// the first base + t + 1 positions.  The T rows ride one launch as a third
// index of the grid's x axis: block (b, t, kv_head, split) runs the T = 1
// body with len = base + t + 1 and its own partials and combine counter,
// so row t gives the bits of a T = 1 launch at that length, and the
// reference's T sequential decode calls (repro/kernels/ops.py,
// _verify_attention_local) become one launch per layer.  The burst is a
// template flag: the decode entry points compile the body with T = 1 folded
// in, as before the burst existed.  The rows of a burst load the same K/V
// rows; sharing those loads is left for later.
//
// Invariants: the split size is the caller's constant (kernels/
// flash_decode.py SPLIT) and never depends on B, the page size or other
// slots; the dense and paged policies (Rows) differ only in the address of
// a row, so they run the same dots, folds and combine in the same order and
// paged gives dense's bits, paged int8 dense int8's; a slot's bits depend
// only on its own q, cache and length; masked positions are never read
// (that also keeps an unmapped page's garbage out: its probability and V
// row count as exactly zero).  The int8 fold follows the reference body:
// score = (q . k_codes) * hd^-0.5 * k_scale, the softmax sum l taken before
// the V scale multiplies the probabilities.
#include <initializer_list>

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::to_f32;
using repro::store_as;
using repro::warp_max;
using repro::warp_sum;

constexpr int FD_THREADS = 512;
constexpr int FD_WARPS = FD_THREADS / 32;
constexpr int FD_GR = 8;                // heads scored per K-row load

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

// Four neighbouring elements of a staged row, as floats.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}

__device__ __forceinline__ float4 fma4(float w, float4 x, float4 a) {
  return make_float4(fmaf(w, x.x, a.x), fmaf(w, x.y, a.y), fmaf(w, x.z, a.z),
                     fmaf(w, x.w, a.w));
}

// One `vec`-byte unit global -> shared: cp.async for 16, 8 and 4 bytes, a
// plain copy for 2 (bf16 rows of odd length).
__device__ __forceinline__ void copy_unit(char* dst, const char* src, int vec) {
  const uint32_t d = repro::smem_u32(dst);
  if (vec == 16) repro::cp_async<16>(d, src);
  else if (vec == 8) repro::cp_async<8>(d, src);
  else if (vec == 4) repro::cp_async<4>(d, src);
  else *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
}

// Staged row stride in bytes: the row rounded up to 16 bytes, plus 16 so
// that neighbouring rows start in other banks.
__host__ __device__ __forceinline__ int staged_stride(int hd, int elem) {
  return (hd * elem + 15) / 16 * 16 + 16;
}

template <typename TQ, typename TC, typename Rows, bool kBurst>
__global__ void __launch_bounds__(FD_THREADS)
fd_split(const TQ* __restrict__ q, const TC* __restrict__ kc,
         const TC* __restrict__ vc, const float* __restrict__ ks,
         const float* __restrict__ vs, const int* __restrict__ lens,
         Rows rows, float* __restrict__ po, float* __restrict__ pm,
         float* __restrict__ pl, int* __restrict__ counters,
         TQ* __restrict__ out, int KH, int S, int hd, int G, int bs, int ns,
         int window, float scale, int vec, int T, int lofs) {
  constexpr bool kQ8 = sizeof(TC) == 1;
  // bh indexes (slot, burst row, kv head): q, out, partials and counters
  // are all laid out by it.  The decode entry points (kBurst false) compile
  // the single-position source as it was before bursts: a build of them
  // with the burst's runtime T took 40 registers instead of 52-60 and ran
  // ~30% slower (chip_smoke.py on an H100 80GB HBM3 at 700 W).
  const int bh = blockIdx.x, s = blockIdx.y;
  const int b = kBurst ? bh / KH / T : bh / KH, h = bh % KH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = min(kBurst ? lens[b] + bh / KH % T + lofs : lens[b], S);
  const int first = window > 0 ? max(0, len - window) : 0;   // first live position
  const int s0 = first / bs;
  const int n_splits = len > first ? (len - 1) / bs - s0 + 1 : 0;
  const size_t qrow = kBurst ? static_cast<size_t>(bh) : static_cast<size_t>(b) * KH + h;
  TQ* ob = out + qrow * G * hd;
  if (n_splits == 0) {          // nothing live: the result is 0
    if (s == 0)
      for (int i = tid; i < G * hd; i += FD_THREADS) store_as(ob + i, 0.f);
    return;
  }
  if (s < s0 || s >= s0 + n_splits) return;    // dead split: reads nothing
  const int lo = max(s * bs, first), n = min(s * bs + bs, len) - lo;

  const int hd4 = (hd + 3) / 4;                // 4-element units of a row
  const int rs = staged_stride(hd, sizeof(TC));
  extern __shared__ __align__(16) char smem[];
  char* kst = smem;                                        // (bs, rs) K rows
  char* vst = kst + bs * rs;                               // (bs, rs) V rows
  float4* qs = reinterpret_cast<float4*>(vst + bs * rs);  // (G, hd4) q
  float4* red = qs + G * hd4;                              // (THREADS) P.V partials
  float* pr = reinterpret_cast<float*>(red + FD_THREADS);  // (G, bs) scores, P
  float* lsum = pr + G * bs;                               // (G) softmax sums
  float* ksc = lsum + G;                                   // (bs) int8 scales
  float* vsc = ksc + bs;
  int* rix = reinterpret_cast<int*>(vsc + bs);             // (bs) paged rows
  float* cm = reinterpret_cast<float*>(rix + bs);          // (G, ns) combine m
  float* cl = cm + G * ns;                                 // (G, ns) combine l
  __shared__ int is_last;

  // a paged row costs a page-table read and a division by ps: resolve each
  // live position's once
  if constexpr (Rows::kResolve) {
    for (int j = tid; j < n; j += FD_THREADS) rix[j] = static_cast<int>(rows.row(b, h, lo + j));
    __syncthreads();
  }
  auto row_of = [&](int j) -> size_t {
    if constexpr (Rows::kResolve) return static_cast<size_t>(rix[j]);
    else return rows.row(b, h, lo + j);
  };

  // every live K and V row of the split (and its int8 scales) in flight at
  // once (scales read by plain loads after the copies left paged int8 28%
  // slower than dense int8 on an H100 80GB HBM3 at 700 W)
  const int rb = hd * static_cast<int>(sizeof(TC)), upr = rb / vec;
  for (int u = tid; u < n * upr; u += FD_THREADS) {
    const int j = u / upr, c = (u - j * upr) * vec;
    const size_t r = row_of(j) * hd;
    copy_unit(kst + j * rs + c, reinterpret_cast<const char*>(kc + r) + c, vec);
    copy_unit(vst + j * rs + c, reinterpret_cast<const char*>(vc + r) + c, vec);
  }
  if constexpr (kQ8) {
    for (int j = tid; j < n; j += FD_THREADS) {
      const size_t r = row_of(j);
      repro::cp_async<4>(repro::smem_u32(ksc + j), ks + r);
      repro::cp_async<4>(repro::smem_u32(vsc + j), vs + r);
    }
  }
  repro::cp_async_commit();
  // meanwhile: q (zero-padded to whole units), zero row tails
  const TQ* qb = q + qrow * G * hd;
  float* qf = reinterpret_cast<float*>(qs);
  for (int i = tid; i < G * hd4 * 4; i += FD_THREADS) {
    const int g = i / (hd4 * 4), d = i - g * hd4 * 4;
    qf[i] = d < hd ? to_f32(qb[g * hd + d]) : 0.f;
  }
  const int tail = hd4 * 4 * static_cast<int>(sizeof(TC)) - rb;   // bytes
  for (int i = tid; i < n * tail; i += FD_THREADS) {
    const int j = i / tail, c = rb + i % tail;
    kst[j * rs + c] = 0;
    vst[j * rs + c] = 0;
  }
  repro::cp_async_wait_all();
  __syncthreads();

  // scores: tpp threads per position (all threads busy on a full split),
  // each a strided part of the dims; one K load serves up to FD_GR heads
  int tpp = 1;
  while (tpp < 32 && 2 * tpp * bs <= FD_THREADS) tpp *= 2;
  for (int base = 0; base < n; base += FD_THREADS / tpp) {
    const int j = base + tid / tpp, sub = tid % tpp;
    const bool ok = j < n;
    const TC* krow = reinterpret_cast<const TC*>(kst + (ok ? j : 0) * rs);
    for (int g0 = 0; g0 < G; g0 += FD_GR) {
      float dot[FD_GR];
#pragma unroll
      for (int i = 0; i < FD_GR; ++i) dot[i] = 0.f;
      if (ok) {
        for (int u = sub; u < hd4; u += tpp) {
          const float4 k4 = load4(krow + 4 * u);
#pragma unroll
          for (int i = 0; i < FD_GR; ++i) {
            if (g0 + i >= G) break;
            const float4 q4 = qs[(g0 + i) * hd4 + u];
            dot[i] = fmaf(q4.x, k4.x, dot[i]);
            dot[i] = fmaf(q4.y, k4.y, dot[i]);
            dot[i] = fmaf(q4.z, k4.z, dot[i]);
            dot[i] = fmaf(q4.w, k4.w, dot[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < FD_GR; ++i) {
        float d = dot[i];
        for (int o = 1; o < tpp; o <<= 1) d += __shfl_xor_sync(repro::kFullMask, d, o);
        if (ok && sub == 0 && g0 + i < G) {
          float sc = d * scale;
          if constexpr (kQ8) sc *= ksc[j];
          pr[(g0 + i) * bs + j] = sc;
        }
      }
    }
  }
  __syncthreads();

  // softmax over the split, one warp per head
  const size_t pbase = (static_cast<size_t>(bh) * ns + s) * G;
  for (int g = warp; g < G; g += FD_WARPS) {
    float mx = kNegInf;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, pr[g * bs + j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(pr[g * bs + j] - mx);
      sum += e;                 // l is the sum before the V-scale fold
      if constexpr (kQ8)
        pr[g * bs + j] = e * vsc[j];
      else
        pr[g * bs + j] = e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      lsum[g] = sum;
      if (n_splits > 1) {
        pm[pbase + g] = mx;
        pl[pbase + g] = sum;
      }
    }
  }
  __syncthreads();

  // P.V: a thread owns 4 neighbouring dims of one head ("item")
  const int items = G * hd4;
  auto pv = [&](int it, int grp, int npg) {
    const int g = it / hd4, u = it - g * hd4;
    const float* p = pr + g * bs;
    auto vrow = [&](int j) { return load4(reinterpret_cast<const TC*>(vst + j * rs) + 4 * u); };
    // two chains (alternate positions of the group), summed at the end
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
    int j = grp;
    for (; j + npg < n; j += 2 * npg) {
      a0 = fma4(p[j], vrow(j), a0);
      a1 = fma4(p[j + npg], vrow(j + npg), a1);
    }
    if (j < n) a0 = fma4(p[j], vrow(j), a0);
    return make_float4(a0.x + a1.x, a0.y + a1.y, a0.z + a1.z, a0.w + a1.w);
  };
  auto finish = [&](int it, float4 a) {
    const int g = it / hd4, d = 4 * (it - g * hd4);
    const float acc[4] = {a.x, a.y, a.z, a.w};
    const float l = fmaxf(lsum[g], 1e-30f);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (d + e >= hd) break;
      if (n_splits == 1)
        store_as(ob + g * hd + d + e, acc[e] / l);
      else
        po[(pbase + g) * hd + d + e] = acc[e];
    }
  };
  const int npg = items >= FD_THREADS ? 1 : FD_THREADS / items;   // position groups
  if (npg == 1) {
    for (int it = tid; it < items; it += FD_THREADS) finish(it, pv(it, 0, 1));
  } else {
    const int it = tid % items, grp = tid / items;
    if (grp < npg) red[grp * items + it] = pv(it, grp, npg);
    __syncthreads();
    if (tid < items) {
      float4 a = red[tid];
      for (int k = 1; k < npg; ++k) {
        const float4 x = red[k * items + tid];
        a = make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
      }
      finish(tid, a);
    }
  }
  if (n_splits == 1) return;

  // the last live split of (b, h) to finish merges the partials in split
  // order (log-sum-exp combine), then re-arms the counter
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + bh, 1) == n_splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // (m, l) of every live split, loaded together into shared memory
  const size_t pb = static_cast<size_t>(bh) * ns * G;
  for (int i = tid; i < G * n_splits; i += FD_THREADS) {
    const int g = i / n_splits, t = i - g * n_splits;
    const size_t o = pb + static_cast<size_t>(s0 + t) * G + g;
    cm[i] = __ldcg(pm + o);
    cl[i] = __ldcg(pl + o);
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += FD_THREADS) {
    const int g = i / hd, d = i - g * hd;
    const float* m_g = cm + g * n_splits;
    const float* l_g = cl + g * n_splits;
    float big_m = kNegInf;
    for (int t = 0; t < n_splits; ++t) big_m = fmaxf(big_m, m_g[t]);
    float l_tot = 0.f, acc = 0.f;
#pragma unroll 4
    for (int t = 0; t < n_splits; ++t) {
      const float w = expf(m_g[t] - big_m);
      l_tot = fmaf(w, l_g[t], l_tot);
      acc = fmaf(w, __ldcg(po + (pb + static_cast<size_t>(s0 + t) * G + g) * hd + d), acc);
    }
    store_as(ob + i, acc / fmaxf(l_tot, 1e-30f));
  }
  if (tid == 0) counters[bh] = 0;
}

// One launch for one (q type, cache element type, row policy).  S is the
// logical positions per slot (max_len, or NP * ps when paged).
template <typename TQ, typename TC, typename Rows, bool kBurst>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const int* lens, Rows rows, float* po, float* pm,
           float* pl, int* counters, void* out, int B, int T, int lofs, int KH,
           int S, int hd, int G, int bs, int window, float scale,
           cudaStream_t stream) {
  const int ns = (S + bs - 1) / bs;
  const int hd4 = (hd + 3) / 4;
  const size_t smem = 2 * static_cast<size_t>(bs) * staged_stride(hd, sizeof(TC)) +
                      (static_cast<size_t>(G) * hd4 + FD_THREADS) * 16 +
                      (static_cast<size_t>(G) * bs + G + 3 * bs + 2 * G * ns) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fd_split<TQ, TC, Rows, kBurst>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // widest copy unit that the row length and both base addresses allow
  const int rb = hd * static_cast<int>(sizeof(TC));
  const uintptr_t addr = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  int vec = 2;
  for (const int w : {16, 8, 4}) {
    if (rb % w == 0 && addr % w == 0) {
      vec = w;
      break;
    }
  }
  fd_split<TQ, TC, Rows, kBurst>
      <<<dim3(B * T * KH, ns), FD_THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs), lens, rows,
      po, pm, pl, counters, static_cast<TQ*>(out), KH, S, hd, G, bs, ns, window, scale,
      vec, T, lofs);
  return static_cast<int>(cudaGetLastError());
}

// q in bf16 or f32; the cache either in q's type (Q8 false) or int8 codes;
// a verify burst (kBurst) or a single position.
template <bool Q8, bool kBurst, typename Rows>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* lens, Rows rows, void* po, void* pm,
             void* pl, void* counters, void* out, int B, int T, int lofs, int KH,
             int S, int hd, int G, int bs, int window, float scale, int is_bf16,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lens);
  float* o = static_cast<float*>(po);
  float* m = static_cast<float*>(pm);
  float* ls = static_cast<float*>(pl);
  int* c = static_cast<int*>(counters);
  if constexpr (Q8) {
    if (is_bf16)
      return launch<__nv_bfloat16, int8_t, Rows, kBurst>(
          q, k, v, ks, vs, l, rows, o, m, ls, c, out, B, T, lofs, KH, S, hd, G, bs, window,
          scale, st);
    return launch<float, int8_t, Rows, kBurst>(q, k, v, ks, vs, l, rows, o, m, ls, c, out,
                                               B, T, lofs, KH, S, hd, G, bs, window,
                                               scale, st);
  } else {
    if (is_bf16)
      return launch<__nv_bfloat16, __nv_bfloat16, Rows, kBurst>(
          q, k, v, ks, vs, l, rows, o, m, ls, c, out, B, T, lofs, KH, S, hd, G, bs, window,
          scale, st);
    return launch<float, float, Rows, kBurst>(q, k, v, ks, vs, l, rows, o, m, ls, c, out,
                                              B, T, lofs, KH, S, hd, G, bs, window, scale,
                                              st);
  }
}

}  // namespace

// Scratch for every variant: po (B*T*KH*ns*G*hd), pm and pl (B*T*KH*ns*G)
// floats, ns = ceil(S/bs) with S the logical positions per slot (NP * ps
// when paged); counters (B*T*KH) ints, zero at launch and left zero.  The
// decode entry points run T = 1 with lens the lengths after the step; the
// verify entry points take q (B, T, H, hd) and base the lengths before the
// burst (row t attends base + t + 1 positions).  window <= 0 means no
// sliding window.  int8 variants need hd % 4 == 0.  A cache or store holds
// fewer than 2^31 rows of hd (row indices are int).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* lens, void* po, void* pm, void* pl,
                                   void* counters, void* out, int B, int KH, int S,
                                   int hd, int G, int bs, int window, float scale,
                                   int is_bf16, void* stream) {
  return dispatch<false, false>(q, k, v, nullptr, nullptr, lens, DenseRows{KH, S}, po, pm, pl,
                         counters, out, B, 1, 0, KH, S, hd, G, bs, window, scale, is_bf16,
                         stream);
}

extern "C" int flash_decode_q8_launch(const void* q, const void* k, const void* ks,
                                      const void* v, const void* vs, const void* lens,
                                      void* po, void* pm, void* pl, void* counters,
                                      void* out, int B, int KH, int S, int hd, int G,
                                      int bs, int window, float scale, int is_bf16,
                                      void* stream) {
  return dispatch<true, false>(q, k, v, ks, vs, lens, DenseRows{KH, S}, po, pm, pl, counters, out,
                        B, 1, 0, KH, S, hd, G, bs, window, scale, is_bf16, stream);
}

extern "C" int flash_decode_paged_launch(const void* q, const void* k, const void* v,
                                         const void* table, const void* lens, void* po,
                                         void* pm, void* pl, void* counters, void* out,
                                         int B, int KH, int np, int ps, int hd, int G,
                                         int bs, int window, float scale, int is_bf16,
                                         void* stream) {
  const PagedRows rows{static_cast<const int*>(table), KH, np, ps};
  return dispatch<false, false>(q, k, v, nullptr, nullptr, lens, rows, po, pm, pl, counters, out,
                         B, 1, 0, KH, np * ps, hd, G, bs, window, scale, is_bf16, stream);
}

extern "C" int flash_decode_paged_q8_launch(const void* q, const void* k, const void* ks,
                                            const void* v, const void* vs,
                                            const void* table, const void* lens, void* po,
                                            void* pm, void* pl, void* counters, void* out,
                                            int B, int KH, int np, int ps, int hd, int G,
                                            int bs, int window, float scale, int is_bf16,
                                            void* stream) {
  const PagedRows rows{static_cast<const int*>(table), KH, np, ps};
  return dispatch<true, false>(q, k, v, ks, vs, lens, rows, po, pm, pl, counters, out, B, 1, 0,
                        KH, np * ps, hd, G, bs, window, scale, is_bf16, stream);
}

extern "C" int flash_verify_launch(const void* q, const void* k, const void* v,
                                   const void* base, void* po, void* pm, void* pl,
                                   void* counters, void* out, int B, int T, int KH,
                                   int S, int hd, int G, int bs, int window,
                                   float scale, int is_bf16, void* stream) {
  return dispatch<false, true>(q, k, v, nullptr, nullptr, base, DenseRows{KH, S}, po, pm, pl,
                         counters, out, B, T, 1, KH, S, hd, G, bs, window, scale, is_bf16,
                         stream);
}

extern "C" int flash_verify_q8_launch(const void* q, const void* k, const void* ks,
                                      const void* v, const void* vs, const void* base,
                                      void* po, void* pm, void* pl, void* counters,
                                      void* out, int B, int T, int KH, int S, int hd,
                                      int G, int bs, int window, float scale,
                                      int is_bf16, void* stream) {
  return dispatch<true, true>(q, k, v, ks, vs, base, DenseRows{KH, S}, po, pm, pl, counters, out,
                        B, T, 1, KH, S, hd, G, bs, window, scale, is_bf16, stream);
}

extern "C" int flash_verify_paged_launch(const void* q, const void* k, const void* v,
                                         const void* table, const void* base, void* po,
                                         void* pm, void* pl, void* counters, void* out,
                                         int B, int T, int KH, int np, int ps, int hd,
                                         int G, int bs, int window, float scale,
                                         int is_bf16, void* stream) {
  const PagedRows rows{static_cast<const int*>(table), KH, np, ps};
  return dispatch<false, true>(q, k, v, nullptr, nullptr, base, rows, po, pm, pl, counters, out,
                         B, T, 1, KH, np * ps, hd, G, bs, window, scale, is_bf16, stream);
}

extern "C" int flash_verify_paged_q8_launch(const void* q, const void* k, const void* ks,
                                            const void* v, const void* vs,
                                            const void* table, const void* base, void* po,
                                            void* pm, void* pl, void* counters, void* out,
                                            int B, int T, int KH, int np, int ps, int hd,
                                            int G, int bs, int window, float scale,
                                            int is_bf16, void* stream) {
  const PagedRows rows{static_cast<const int*>(table), KH, np, ps};
  return dispatch<true, true>(q, k, v, ks, vs, base, rows, po, pm, pl, counters, out, B, T, 1,
                        KH, np * ps, hd, G, bs, window, scale, is_bf16, stream);
}
