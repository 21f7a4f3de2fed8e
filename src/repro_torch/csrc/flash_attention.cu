// Causal flash-attention forward, GQA-grouped.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (TPU;
// body _kernel).  q (BKH, G, T, hd), k/v (BKH, T, hd) unrepeated, hd <= 128;
// out (BKH, G, T, hd) in q's dtype.  Scores and probabilities never leave
// the chip: only q, k, v are read and out written.
//
// What bounds it on the H100: at the calibration shape (q (64, 4, 512,
// 128) bf16, causal) the two products do 1.7e10 flops (0.017 ms at 989
// TFLOP/s bf16) on 50 MB read (q, k, v) and 34 MB written (out), 0.025 ms
// at 3.35 TB/s: bytes bound it, with the tensor cores close behind.  The
// first port ran on the CUDA cores in f32 (2.31 ms on an H100 80GB HBM3 at
// 700 W): one serial fma chain per score, P.V by shuffle, one block per
// grouped head re-reading every K/V tile G times.
//
// bf16 route (what the main path passes), fa_fwd_tc: Hopper's tensor cores
// through wgmma (bf16 in, f32 accumulators).  One block of two warp groups
// per (KV head, group of up to 8 query heads, tile of query positions):
// its 128 rows hold every grouped head at those positions (G = 4: 4 heads
// x 32 positions), so all of them share one causal limit and each K/V tile
// is loaded once for the G heads, as the Pallas kernel folds G into the
// rows of one product.  Each warp group owns 64 rows.  K/V tiles of 64
// keys arrive by TMA (one thread asks, an mbarrier counts the bytes) into a
// two-stage ring in the 128-byte swizzle, so the next tile is in flight
// while the current one is multiplied; q arrives once by 16-byte cp.async
// in the same layout.  S = Q K^T is an m64n64k16 wgmma with both operands
// in shared memory (keeping q out of registers leaves 126 per thread, so
// two blocks share an SM); P.V is an m64nHDk16 wgmma with P from registers
// (the S accumulators repacked to bf16) and V read transposed.  The online
// softmax runs on the accumulators in f32, with hd^-0.5 * log2(e) applied
// to the f32 scores inside the exp2 argument; the output rescale is
// skipped when no row's max moved.  Tiles wholly in a warp group's future
// are skipped; only tiles that cross the diagonal or the ragged tail (T
// off the tile grid) are masked.  An optional key length per batch row
// (kv_lens, for bucket-padded prefill) masks keys at or past it, so a
// prompt padded to any bucket, in a batch of any size, gives its valid rows
// the bits of the same prompt run alone at its exact length: tiles keep
// their offsets from key 0 and a wholly masked tile changes no row's bits.
// TMA zero-fills keys past T and columns
// past hd, so no uninitialised shared memory meets 0 x NaN.  The output
// goes back through shared memory as 16-byte stores.  Blocks with the most
// causal work launch first.  Rows that TMA cannot describe (hd % 8 != 0,
// or a base not 16-byte aligned) are zero-padded by the wrapper.
//
// What still bounds it (ptxas and chip_smoke.py's numbers are in PERF.md):
// the block runs its phases in turn, so reading q and writing out (two
// thirds of the bytes) do not overlap its own products, and the softmax
// does not overlap the wgmma of its warp group.  A persistent,
// warp-specialised block (a producer warp loading the next q; two consumer
// warp groups taking turns at the tensor cores) is the next step.
//
// Deviation from the plain version: P is rounded to bf16 for the P.V
// product, as FlashAttention-2/3 do (the Pallas kernel keeps P in f32).
// That is at most 2^-9 relative per term, well inside the bf16 limits the
// card checks apply (max error 1e-2 * max|plain|, and the error's norm
// 1e-2 * the plain output's).  l sums the f32 P.
//
// Training (kernels/flash_attention.py's autograd.Function) asks both
// routes for each row's log-sum-exp of its scaled scores as well (lse, f32,
// natural log): the backward, flash_attention_bwd.cu, rebuilds the
// probabilities from it.  The bf16 route has it from its own max (log2
// units) and sum; without the request nothing else changes, bits included.
//
// f32 route (no main path passes it), fa_fwd: the first port's CUDA-core
// kernel, on f32 only.  One block (4 warps) per (kv-batch-head, group head,
// 32 query rows); it walks 32-key tiles to the causal diagonal of its last
// row; each warp owns 8 query rows, lane j scores key j, the warp keeps
// the online softmax and each lane accumulates hd/32 output dims.  Keys
// past T and keys in a row's future get probability exactly zero.
#include "hopper.cuh"

namespace {

using repro::kNegInf;
using repro::kFullMask;
using repro::warp_max;
using repro::warp_sum;
using repro::encode_tiled;
using repro::EncodeTiled;
using repro::fence_regs;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::sw128_desc;
using repro::tile_off;
using repro::tma_load_3d;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_rs;
using repro::wgmma_ss_n64;
using repro::wgmma_wait0;

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------
constexpr int FA_THREADS = 128;
constexpr int FA_BQ = 32;                     // query rows per block
constexpr int FA_BK = 32;                     // keys per tile (= warp width)
constexpr int FA_ROWS = FA_BQ / (FA_THREADS / 32);

template <int DPL>                            // DPL = ceil(hd / 32)
__global__ void __launch_bounds__(FA_THREADS)
fa_fwd(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
       int G, int t_len, int hd, int causal, float scale, const int* __restrict__ kv_lens,
       int heads_per_len) {
  extern __shared__ float smem[];
  float* qs = smem;                          // (BQ, hd), pre-scaled
  float* ks = qs + FA_BQ * hd;               // (BK, hd + 1), padded rows
  float* vs = ks + FA_BK * (hd + 1);         // (BK, hd)
  const int bg = blockIdx.x;                 // bkh * G + g
  const int bkh = bg / G;
  const int q0 = blockIdx.y * FA_BQ;
  const float* qb = q + static_cast<size_t>(bg) * t_len * hd;
  const float* kb = k + static_cast<size_t>(bkh) * t_len * hd;
  const float* vb = v + static_cast<size_t>(bkh) * t_len * hd;
  for (int i = threadIdx.x; i < FA_BQ * hd; i += FA_THREADS) {
    const int qp = q0 + i / hd;
    qs[i] = qp < t_len ? qb[static_cast<size_t>(q0) * hd + i] * scale : 0.f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float m_i[FA_ROWS], l_i[FA_ROWS], acc[FA_ROWS][DPL];
#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }
  // keys at or past klen are masked (bucket padding); query rows there
  // still attend the valid keys
  const int klen = kv_lens ? min(kv_lens[bkh / heads_per_len], t_len) : t_len;
  const int k_end = causal ? min(klen, q0 + FA_BQ) : klen;
  for (int k0 = 0; k0 < k_end; k0 += FA_BK) {
    __syncthreads();                         // previous tile consumed
    for (int i = threadIdx.x; i < FA_BK * hd; i += FA_THREADS) {
      const int j = i / hd, d = i % hd, kp = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < t_len) {
        kv = kb[static_cast<size_t>(kp) * hd + d];
        vv = vb[static_cast<size_t>(kp) * hd + d];
      }
      ks[j * (hd + 1) + d] = kv;
      vs[j * hd + d] = vv;
    }
    __syncthreads();
    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < FA_ROWS; ++r) {
      const int row = warp * FA_ROWS + r, qp = q0 + row;
      if (qp >= t_len) continue;             // uniform across the warp
      const float* qrow = qs + row * hd;
      const float* krow = ks + lane * (hd + 1);
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qrow[d], krow[d], s);
      const bool valid = kp < klen && (!causal || kp <= qp);
      const float m_new = fmaxf(m_i[r], warp_max(valid ? s : kNegInf));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m_i[r] - m_new);
      l_i[r] = l_i[r] * corr + warp_sum(p);
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= corr;
#pragma unroll 8
      for (int j = 0; j < FA_BK; ++j) {
        const float pj = __shfl_sync(kFullMask, p, j);
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          const int d = lane + 32 * e;
          if (d < hd) acc[r][e] = fmaf(pj, vs[j * hd + d], acc[r][e]);
        }
      }
      m_i[r] = m_new;
    }
  }
#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    const int qp = q0 + warp * FA_ROWS + r;
    if (qp >= t_len) continue;
    const float inv = 1.f / fmaxf(l_i[r], 1e-30f);
    if (lse != nullptr && lane == 0)
      lse[static_cast<size_t>(bg) * t_len + qp] = m_i[r] + logf(fmaxf(l_i[r], 1e-30f));
    float* orow = out + (static_cast<size_t>(bg) * t_len + qp) * hd;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) orow[d] = acc[r][e] * inv;
    }
  }
}

template <int DPL>
int launch_dpl(const void* q, const void* k, const void* v, void* out, float* lse,
               int BKH, int G, int t_len, int hd, int causal, float scale,
               const int* kv_lens, int heads_per_len, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(FA_BQ * hd + FA_BK * (hd + 1) + FA_BK * hd) *
                      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fa_fwd<DPL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(BKH * G, (t_len + FA_BQ - 1) / FA_BQ);
  fa_fwd<DPL><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, G, t_len, hd, causal, scale, kv_lens, heads_per_len);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* out, float* lse, int BKH,
           int G, int t_len, int hd, int causal, float scale, const int* kl, int hpl,
           cudaStream_t s) {
  switch ((hd + 31) / 32) {
    case 1: return launch_dpl<1>(q, k, v, out, lse, BKH, G, t_len, hd, causal, scale, kl, hpl, s);
    case 2: return launch_dpl<2>(q, k, v, out, lse, BKH, G, t_len, hd, causal, scale, kl, hpl, s);
    case 3: return launch_dpl<3>(q, k, v, out, lse, BKH, G, t_len, hd, causal, scale, kl, hpl, s);
    case 4: return launch_dpl<4>(q, k, v, out, lse, BKH, G, t_len, hd, causal, scale, kl, hpl, s);
    default: return static_cast<int>(cudaErrorInvalidValue);   // hd > 128
  }
}


// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int TC_NWG = 2;                  // warp groups (64 query rows each)
constexpr int TC_BK = 64;                  // keys per K/V tile
constexpr int TC_MAX_HEADS = 8;            // grouped heads per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage R rows into a swizzled tile by 16-byte cp.async (the caller
// commits).  row_of(r) gives row r's first element, or nullptr for a
// padding row; padding rows and columns past hd become zeros.
template <int HD, int R, int THREADS, typename RowOf>
__device__ __forceinline__ void stage_rows(char* tile, int hd, const bf16* any, RowOf row_of) {
  constexpr int CPR = HD / 8;              // 16-byte chunks per row
  const uint32_t base = repro::smem_u32(tile);
  for (int i = threadIdx.x; i < R * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const bf16* row = row_of(r);
    const bool live = row != nullptr && c * 8 < hd;
    repro::cp_async<16>(base + tile_off<R>(r, c), live ? row + c * 8 : any, live ? 16 : 0);
  }
}

// Shared memory of one block: q (later out), two K and two V stages, the
// warps' position ranges and two stage barriers; +1024 to align the tiles
// to swizzle atoms.
template <int HD>
constexpr int tc_smem_bytes() {
  return (64 * TC_NWG + 4 * TC_BK) * HD * 2 + 2 * 4 * TC_NWG * 4 + 16 + 1024;
}

// One block: heads [g0, g0 + gb) of KV head bkh at positions [q0, q0 + bq);
// row r of the block is head g0 + r / bq at position q0 + r % bq.  Warp
// group wg owns rows [64 wg, 64 wg + 64).  K/V tile j lands in stage j % 2;
// once every warp is done with it, one thread asks TMA for tile j + 2 in
// its place.
template <int HD>
__global__ void __launch_bounds__(128 * TC_NWG, 2)
fa_fwd_tc(const bf16* __restrict__ q, bf16* __restrict__ out, float* __restrict__ lse,
          int G, int t_len, int hd,
          int causal, float scale_log2, int gb, int bq, const int* __restrict__ kv_lens,
          int heads_per_len, const __grid_constant__ CUtensorMap tmk,
          const __grid_constant__ CUtensorMap tmv) {
  constexpr int THREADS = 128 * TC_NWG, ROWS = 64 * TC_NWG, WARPS = 4 * TC_NWG;
  constexpr int QB = ROWS * HD * 2, KB = TC_BK * HD * 2;   // tile bytes
  extern __shared__ __align__(128) char tc_smem[];
  char* qs = tc_smem + ((1024 - (repro::smem_u32(tc_smem) & 1023)) & 1023);
  char* kst = qs + QB;                       // 2 stages of (BK, HD)
  char* vst = kst + 2 * KB;
  int* wpos = reinterpret_cast<int*>(vst + 2 * KB);   // (2, WARPS) max / min
  const uint32_t full = repro::smem_u32(wpos + 2 * WARPS);   // (2) stage barriers
  const int ngb = (G + gb - 1) / gb;
  const int bkh = blockIdx.x / ngb, g0 = (blockIdx.x % ngb) * gb;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;   // most work first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;

  auto row_index = [&](int r) -> long long {   // -1 for a padding row
    const int gi = r / bq, pos = q0 + r % bq, g = g0 + gi;
    if (gi >= gb || g >= G || pos >= t_len) return -1;
    return (static_cast<long long>(bkh) * G + g) * t_len + pos;
  };
  // keys at or past klen are masked (bucket padding).  Tiles sit at fixed
  // offsets from key 0, and a tile wholly masked for a row leaves its max,
  // sum and accumulator bit for bit as they were (correction exp2(0) = 1,
  // p = 0), so a row's bits depend on its position and its keys alone: not
  // on T, the bucket, or the other rows of the batch
  const int klen = kv_lens ? min(kv_lens[bkh / heads_per_len], t_len) : t_len;
  const int kv_end = causal ? min(klen, q0 + bq) : klen;
  const int n_tiles = (kv_end + TC_BK - 1) / TC_BK;
  // K/V tile j into stage j % 2 (one thread): 64-dim panels of 64 rows, rows
  // past T zero-filled; the stage's barrier counts the bytes
  auto load_tile = [&](int j) {
    const int st = j & 1;
    const uint32_t bar = full + 8 * st;
    const uint32_t kd = repro::smem_u32(kst + st * KB), vd = repro::smem_u32(vst + st * KB);
    mbar_expect_tx(bar, 2 * KB);
#pragma unroll
    for (int pn = 0; pn < HD / 64; ++pn) {
      tma_load_3d(kd + pn * TC_BK * 128, &tmk, 64 * pn, j * TC_BK, bkh, bar);
      tma_load_3d(vd + pn * TC_BK * 128, &tmv, 64 * pn, j * TC_BK, bkh, bar);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (n_tiles > 0) load_tile(0);
    if (n_tiles > 1) load_tile(1);
  }
  stage_rows<HD, ROWS, THREADS>(qs, hd, q, [&](int r) -> const bf16* {
    const long long i = row_index(r);
    return i < 0 ? nullptr : q + static_cast<size_t>(i) * hd;
  });
  repro::cp_async_commit();

  // this thread's two accumulator rows; each warp's valid positions, shared
  // so that a warp group can agree on what to skip and mask
  const int ra = 16 * warp + lane / 4;
  const int pos_a = q0 + ra % bq, pos_b = q0 + (ra + 8) % bq;
  {
    const int r = 16 * warp + (lane & 15);
    const bool ok = row_index(r) >= 0;
    const int pos = q0 + r % bq;
    const int mx = __reduce_max_sync(repro::kFullMask, ok ? pos : -1);
    const int mn = __reduce_min_sync(repro::kFullMask, ok ? pos : 0x7fffffff);
    if (lane == 0) {
      wpos[warp] = mx;
      wpos[WARPS + warp] = mn;
    }
  }
  repro::cp_async_wait_all();
  // q was written through the generic proxy; wgmma reads it through the
  // async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int gmax = max(max(wpos[4 * wg], wpos[4 * wg + 1]), max(wpos[4 * wg + 2], wpos[4 * wg + 3]));
  const int gmin = min(min(wpos[WARPS + 4 * wg], wpos[WARPS + 4 * wg + 1]),
                       min(wpos[WARPS + 4 * wg + 2], wpos[WARPS + 4 * wg + 3]));

  float s[TC_BK / 8][4];
  float o[HD / 8][4];
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < TC_BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
  const uint32_t qa = repro::smem_u32(qs) + wg * 64 * 128;

  for (int j = 0; j < n_tiles; ++j) {
    mbar_wait(full + 8 * (j & 1), (j >> 1) & 1);
    const int k0 = j * TC_BK;
    if (gmax >= 0 && (!causal || k0 <= gmax)) {   // uniform in the warp group
      const uint32_t kt = repro::smem_u32(kst + (j & 1) * KB);
      const uint32_t vt = repro::smem_u32(vst + (j & 1) * KB);
      // S = Q K^T: q's rows (this warp group's 64) are A's rows and K's
      // rows B's columns, both hd-contiguous (K-major); a k-step of 16 dims
      // is 32 bytes into a 64-dim panel
      wgmma_fence();
      fence_regs(s);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(s, sw128_desc(qa + (kk / 4) * (ROWS * 128) + (kk % 4) * 32, 16, 1024),
                     sw128_desc(kt + (kk / 4) * (TC_BK * 128) + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      // online softmax on the accumulators; mask only where it can bite
      const bool edge = k0 + TC_BK > klen || (causal && k0 + TC_BK - 1 > gmin);
      float cr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = h ? pos_b : pos_a;
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < TC_BK / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[nt][2 * h + e];
            if (edge) {
              const int key = k0 + nt * 8 + (lane & 3) * 2 + e;
              if (key >= klen || (causal && key > pos)) x = kNegInf;
            }
            s[nt][2 * h + e] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(repro::kFullMask, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(repro::kFullMask, mx, 2));
        // m is kept in log2 units of the scaled scores: p = 2^(s c - m)
        const float m_new = fmaxf(m_r[h], mx * scale_log2);
        const float corr = fast_exp2(m_r[h] - m_new);
        m_r[h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < TC_BK / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = fast_exp2(fmaf(s[nt][2 * h + e], scale_log2, -m_new));
            s[nt][2 * h + e] = p;
            sum += p;
          }
        }
        l_r[h] = l_r[h] * corr + sum;        // this lane's share of the row
        cr[h] = corr;
      }
      if (__any_sync(repro::kFullMask, cr[0] != 1.f || cr[1] != 1.f)) {
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt) {
          o[dt][0] *= cr[0];
          o[dt][1] *= cr[0];
          o[dt][2] *= cr[1];
          o[dt][3] *= cr[1];
        }
      }
      // O += P V: P (bf16) from the S accumulators as A fragments; V's rows
      // are B's k-rows, hd-contiguous (MN-major, transposed): a k-step of
      // 16 keys is two swizzle atoms, the 64-dim panels lie TC_BK * 128
      // bytes apart
      wgmma_fence();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint64_t desc = sw128_desc(vt + kk * 2048, TC_BK * 128, 1024);
        wgmma_rs<HD / 8, 1>(o, a, desc, 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
    }
    __syncthreads();                         // stage j % 2 is free again
    if (threadIdx.x == 0 && j + 2 < n_tiles) load_tile(j + 2);
  }

  // normalise; each warp writes its own rows of the q tile, then the block
  // stores whole 16-byte chunks
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(repro::kFullMask, l, 1);
    l += __shfl_xor_sync(repro::kFullMask, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int r = ra + 8 * h;
    if (lse != nullptr && (lane & 3) == 0) {
      // m is in log2 units of the scaled scores
      const long long row = row_index(r);
      if (row >= 0) lse[row] = (m_r[h] + log2f(fmaxf(l, 1e-30f))) * kLn2;
    }
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<uint32_t*>(qs + tile_off<ROWS>(r, dt) + (lane & 3) * 4) =
          pack_bf16(o[dt][2 * h] * inv, o[dt][2 * h + 1] * inv);
  }
  __syncthreads();
  constexpr int CPR = HD / 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const long long row = row_index(r);
    if (row < 0 || c * 8 >= hd) continue;
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * hd + c * 8) =
        *reinterpret_cast<const uint4*>(qs + tile_off<ROWS>(r, c));
  }
}

// (hd, T, BKH) bf16 as 64 x 64 x 1 boxes in the 128-byte swizzle
bool kv_map(CUtensorMap* map, const void* base, int BKH, int t_len, int hd) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(t_len),
                              static_cast<cuuint64_t>(BKH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(t_len) * hd * 2};
  const cuuint32_t box[3] = {64, TC_BK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* out, float* lse, int BKH,
              int G, int t_len, int hd, int causal, float scale, const int* kv_lens,
              int heads_per_len, cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  CUtensorMap tmk, tmv;
  if (hd % 8 != 0 || addr % 16 != 0 || !kv_map(&tmk, k, BKH, t_len, hd) ||
      !kv_map(&tmv, v, BKH, t_len, hd))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = tc_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(fa_fwd_tc<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int gb = min(G, TC_MAX_HEADS), bq = 64 * TC_NWG / gb;
  const int ngb = (G + gb - 1) / gb;
  const dim3 grid(BKH * ngb, (t_len + bq - 1) / bq);
  fa_fwd_tc<HD><<<grid, 128 * TC_NWG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<bf16*>(out), lse, G, t_len, hd, causal,
      scale * kLog2e, gb, bq, kv_lens, heads_per_len, tmk, tmv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_bf16: the tensor-core kernel (hd <= 64 runs the 64-wide tiles, hd <= 128
// the 128-wide ones, zero-padded; needs hd % 8 == 0 and 16-byte aligned
// tensors, which the wrapper arranges); otherwise the f32 CUDA-core kernel.
// kv_lens (int32, one per batch row; row b covers heads_per_len consecutive
// BKH entries, each >= 1) masks keys at or past kv_lens[b]; null masks
// none.  lse (f32, one per row of q, (BKH, G, T)), when not null, takes each
// row's log-sum-exp of its scaled scores, natural log, for the backward
// (flash_attention_bwd.cu); null writes nothing and leaves out's bits as
// they are.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int BKH, int G, int t_len, int hd,
                                      int causal, float scale, int is_bf16,
                                      const void* kv_lens, int heads_per_len,
                                      void* lse_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kl = static_cast<const int*>(kv_lens);
  float* lse = static_cast<float*>(lse_out);
  if (!is_bf16)
    return launch(q, k, v, out, lse, BKH, G, t_len, hd, causal, scale, kl, heads_per_len, s);
  if (hd <= 64)
    return launch_tc<64>(q, k, v, out, lse, BKH, G, t_len, hd, causal, scale, kl,
                         heads_per_len, s);
  if (hd <= 128)
    return launch_tc<128>(q, k, v, out, lse, BKH, G, t_len, hd, causal, scale, kl,
                          heads_per_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
