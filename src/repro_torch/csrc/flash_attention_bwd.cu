// Causal flash-attention backward, GQA-grouped: dQ, dK, dV.
//
// A kernel of the port with no TPU counterpart: repro has no backward
// kernel (no custom_vjp under src/repro, and jax.grad through
// flash_attention_pallas fails), so it trains through its jnp attention.
// The port's forward is the flash_attention.cu kernel, whose output has no
// autograd graph; this is the backward that kernels/flash_attention.py's
// autograd.Function calls.
//
// q, o, dO (BKH, G, T, hd) and k, v (BKH, T, hd) in bf16 or f32, lse
// (BKH, G, T) f32 (the forward's per-row log-sum-exp of the scaled scores,
// natural log); dq like q, dk and dv like k (summed over the G query heads
// of their KV head); hd <= 128, causal or not, no key lengths.
// FlashAttention-2's recomputation: the probabilities are rebuilt from q,
// k and lse, never stored.  With scale = hd^-0.5, S = Q K^T, P = exp(S
// scale - lse) (masked) and D = rowsum(dO * O):
//   dV = sum_g P^T dO,   dP = dO V^T,   dS = P (dP - D),
//   dQ = dS K scale,     dK = sum_g dS^T Q scale.
// Every output element is summed by one thread (or one wgmma accumulator)
// in a fixed order, with no atomics, so a run's gradients are the same bits
// on every call.  That takes one pass owning keys (dK, dV) and one owning
// queries (dQ), so S and dP are computed in both: 7 products, not 5.
//
// What bounds it on the H100: at the train shape (q (32, 4, 512, 128)
// bf16, causal) the function's five products do 2.2e10 flops (0.022 ms at
// 989 TFLOP/s bf16) on 50 MB read and 34 MB written (0.025 ms at 3.35
// TB/s): bytes, with the tensor cores close behind.  The CUDA cores alone
// would take 0.33 ms at their f32 peak, so only the tensor cores come near.
//
// bf16 route (what training passes): three launches, the products on the
// tensor cores through wgmma (bf16 in, f32 accumulators), 64-row tiles
// arriving by TMA in the 128-byte swizzle, as in the forward (fa_fwd_tc).
//   1. fa_bwd_prep: per row of q, D and lse * log2(e), stored per 64-row
//      tile as (lse2[64], D[64]) so that TMA brings a tile's 512 bytes
//      with its rows; rows past T get lse2 = 1e30 (their P is exactly 0)
//      and D = 0.
//   2. fa_bwd_dkdv_tc: one block (one warp group) per (KV head, 64 keys).
//      K and V arrive once; 64-row tiles of Q and dO, with their lse2 and
//      D, stream through a two-stage mbarrier ring, walking the G heads in
//      order and, for each, the query tiles (causal: from the block's first
//      key on).  Per tile: S^T = K Q^T and dP^T = V dO^T (both operands in
//      shared memory, K-major), P^T and dS^T on the accumulators in f32,
//      then dV += P^T dO and dK += dS^T Q with P^T / dS^T repacked to bf16
//      in registers (as the forward repacks P) and dO / Q read transposed.
//      dK and dV stay in registers (64 + 64 per thread at hd 128) for the
//      whole walk and leave through shared memory as 16-byte stores.
//   3. fa_bwd_dq_tc: one block (one warp group) per (KV head, group of up
//      to 8 query heads, positions): its 64 rows hold the grouped heads at
//      those positions, as the forward folds G, so each 64-key K/V tile
//      (two-stage TMA ring) is loaded once for the G heads.  Per tile: S =
//      Q K^T, dP = dO V^T, dS = P (dP - D), dQ += dS K (K read
//      transposed).  Q and dO rows arrive once by 16-byte cp.async.
// Only tiles that cross the causal diagonal or T are masked; a masked P is
// set to 0 after its exp, so a score far above a row's lse never meets 0
// as inf * 0.  Rows TMA cannot describe (hd % 8 != 0, or a base not
// 16-byte aligned) are zero-padded by the wrapper.  Two blocks share an SM
// (~99 KB of shared memory each at hd 128), so one block's products
// overlap the other's exponentials.
//
// Deviation from the plain version: P and dS are rounded to bf16 for the
// dV, dK and dQ products, as FlashAttention-2/3 do (2^-9 relative per
// term); S, dP, the exponentials and every sum stay f32.
//
// What still bounds it (ptxas and chip_smoke.py's numbers are in PERF.md):
// a warp group runs its phases in turn (products, exponentials, products)
// with a block barrier per tile, and the two passes recompute S and dP.
// A producer warp and two consumer warp groups taking turns at the tensor
// cores (FlashAttention-3's layout) are the next step.
//
// f32 route (no main path passes it): the first port's CUDA-core kernels.
// fa_bwd_dot (D), fa_bwd_dkdv (a block per KV head and 32 keys) and
// fa_bwd_dq (a block per query head and 32 rows) run on tiles staged in
// shared memory as f32 (K and V rows padded by one float, so that 32 lanes
// reading 32 keys at one dim hit 32 banks).
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------
constexpr int BT = 32;            // queries and keys per tile
constexpr int THREADS = 256;      // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RPW = BT / WARPS;   // tile rows per warp (4)

__global__ void __launch_bounds__(THREADS)
fa_bwd_dot(const float* __restrict__ o, const float* __restrict__ dout, float* __restrict__ dvec,
           long long rows, int hd) {
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* orow = o + row * hd;
  const float* drow = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(orow[d], drow[d], acc);
  acc = repro::warp_sum(acc);
  if (lane == 0) dvec[row] = acc;
}

// rows [r0, r0 + BT) of a (T, hd) matrix into shared f32 with row stride
// `stride`; rows past T and columns past hd become zeros
__device__ __forceinline__ void stage(float* dst, int stride, const float* src, int r0, int t_len,
                                      int hd, int width) {
  for (int i = threadIdx.x; i < BT * width; i += THREADS) {
    const int r = i / width, d = i % width;
    const int pos = r0 + r;
    dst[r * stride + d] = pos < t_len && d < hd ? src[static_cast<size_t>(pos) * hd + d] : 0.f;
  }
}

// Shared floats of either block: two (BT, W) tiles, two (BT, W + 1) tiles,
// two (BT, BT) tiles of P / dS and the rows' lse and D.
__host__ __device__ constexpr int smem_floats(int width) {
  return 2 * BT * width + 2 * BT * (width + 1) + 2 * BT * BT + 2 * BT;
}

// One block: KV head bkh, keys [k0, k0 + BT).  Thread (warp w, lane l)
// scores key k0 + l against rows w + 8i of a query tile, and accumulates
// dK and dV for keys k0 + w + 8i at dims l + 32e.
template <int DPL>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ dvec, float* __restrict__ dk, float* __restrict__ dv, int G,
            int t_len, int hd, int causal, float scale) {
  constexpr int W = 32 * DPL;     // staged width (hd rounded up to 32)
  extern __shared__ float sm[];
  float* qs = sm;                 // (BT, W)
  float* dos = qs + BT * W;       // (BT, W)
  float* ks = dos + BT * W;       // (BT, W + 1)
  float* vs = ks + BT * (W + 1);  // (BT, W + 1)
  float* ps = vs + BT * (W + 1);  // (BT, BT): P[row][key]
  float* dss = ps + BT * BT;      // (BT, BT): dS[row][key]
  float* lses = dss + BT * BT;    // (BT)
  float* ds_ = lses + BT;         // (BT)
  const int bkh = blockIdx.x, k0 = blockIdx.y * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t kv_off = static_cast<size_t>(bkh) * t_len * hd;
  stage(ks, W + 1, k + kv_off, k0, t_len, hd, W);
  stage(vs, W + 1, v + kv_off, k0, t_len, hd, W);
  float acc_k[RPW][DPL], acc_v[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;
  const int key = k0 + lane;
  const int q_first = causal ? k0 : 0;      // earlier rows see none of these keys
  for (int g = 0; g < G; ++g) {
    const size_t head = static_cast<size_t>(bkh) * G + g;
    const float* qh = q + head * t_len * hd;
    const float* dh = dout + head * t_len * hd;
    for (int q0 = q_first; q0 < t_len; q0 += BT) {
      __syncthreads();                      // previous tile consumed
      stage(qs, W, qh, q0, t_len, hd, W);
      stage(dos, W, dh, q0, t_len, hd, W);
      if (threadIdx.x < BT) {
        const int pos = q0 + threadIdx.x;
        lses[threadIdx.x] = pos < t_len ? lse[head * t_len + pos] : 0.f;
        ds_[threadIdx.x] = pos < t_len ? dvec[head * t_len + pos] : 0.f;
      }
      __syncthreads();
      float s[RPW], dp[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) s[i] = dp[i] = 0.f;
      const float* krow = ks + lane * (W + 1);
      const float* vrow = vs + lane * (W + 1);
      for (int d = 0; d < W; ++d) {
        const float kd = krow[d], vd = vrow[d];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int r = warp + WARPS * i;
          s[i] = fmaf(qs[r * W + d], kd, s[i]);
          dp[i] = fmaf(dos[r * W + d], vd, dp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + WARPS * i, pos = q0 + r;
        const bool live = pos < t_len && key < t_len && (!causal || key <= pos);
        const float p = live ? expf(fmaf(s[i], scale, -lses[r])) : 0.f;
        ps[r * BT + lane] = p;
        dss[r * BT + lane] = p * (dp[i] - ds_[r]);
      }
      __syncthreads();
      for (int r = 0; r < BT; ++r) {
        float dor[DPL], qr[DPL];
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          dor[e] = dos[r * W + lane + 32 * e];
          qr[e] = qs[r * W + lane + 32 * e];
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int j = warp + WARPS * i;
          const float p = ps[r * BT + j], dsv = dss[r * BT + j];
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            acc_v[i][e] = fmaf(p, dor[e], acc_v[i][e]);
            acc_k[i][e] = fmaf(dsv, qr[e], acc_k[i][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int pos = k0 + warp + WARPS * i;
    if (pos >= t_len) continue;
    const size_t off = kv_off + static_cast<size_t>(pos) * hd;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) {
        dk[off + d] = acc_k[i][e] * scale;
        dv[off + d] = acc_v[i][e];
      }
    }
  }
}

// One block: query head bg = bkh * G + g, rows [q0, q0 + BT).  Thread
// (warp w, lane l) scores rows w + 8i against key l of a key tile and
// accumulates dQ for the same rows at dims l + 32e.
template <int DPL>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dvec, float* __restrict__ dq, int G, int t_len, int hd,
          int causal, float scale) {
  constexpr int W = 32 * DPL;
  extern __shared__ float sm[];
  float* qs = sm;
  float* dos = qs + BT * W;
  float* ks = dos + BT * W;
  float* vs = ks + BT * (W + 1);
  float* dss = vs + BT * (W + 1);    // (BT, BT): dS[row][key]
  float* lses = dss + 2 * BT * BT;
  float* ds_ = lses + BT;
  const int bg = blockIdx.x, q0 = blockIdx.y * BT;
  const int bkh = bg / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t q_off = static_cast<size_t>(bg) * t_len * hd;
  const size_t kv_off = static_cast<size_t>(bkh) * t_len * hd;
  stage(qs, W, q + q_off, q0, t_len, hd, W);
  stage(dos, W, dout + q_off, q0, t_len, hd, W);
  if (threadIdx.x < BT) {
    const int pos = q0 + threadIdx.x;
    lses[threadIdx.x] = pos < t_len ? lse[static_cast<size_t>(bg) * t_len + pos] : 0.f;
    ds_[threadIdx.x] = pos < t_len ? dvec[static_cast<size_t>(bg) * t_len + pos] : 0.f;
  }
  float acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  const int k_end = causal ? min(t_len, q0 + BT) : t_len;
  for (int k0 = 0; k0 < k_end; k0 += BT) {
    __syncthreads();                        // previous tile consumed
    stage(ks, W + 1, k + kv_off, k0, t_len, hd, W);
    stage(vs, W + 1, v + kv_off, k0, t_len, hd, W);
    __syncthreads();
    float s[RPW], dp[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = dp[i] = 0.f;
    const float* krow = ks + lane * (W + 1);
    const float* vrow = vs + lane * (W + 1);
    for (int d = 0; d < W; ++d) {
      const float kd = krow[d], vd = vrow[d];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + WARPS * i;
        s[i] = fmaf(qs[r * W + d], kd, s[i]);
        dp[i] = fmaf(dos[r * W + d], vd, dp[i]);
      }
    }
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + WARPS * i, pos = q0 + r;
      const bool live = pos < t_len && key < t_len && (!causal || key <= pos);
      const float p = live ? expf(fmaf(s[i], scale, -lses[r])) : 0.f;
      dss[r * BT + lane] = p * (dp[i] - ds_[r]);
    }
    __syncwarp();                           // a warp reads only its own rows
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float kr[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) kr[e] = ks[j * (W + 1) + lane + 32 * e];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float dsv = dss[(warp + WARPS * i) * BT + j];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] = fmaf(dsv, kr[e], acc[i][e]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int pos = q0 + warp + WARPS * i;
    if (pos >= t_len) continue;
    const size_t off = q_off + static_cast<size_t>(pos) * hd;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) dq[off + d] = acc[i][e] * scale;
    }
  }
}

template <int DPL>
int launch_f32(const float* q, const float* k, const float* v, const float* o,
               const float* dout, const float* lse, float* dvec, float* dq, float* dk, float* dv,
               int BKH, int G, int t_len, int hd, int causal, float scale, cudaStream_t stream) {
  const long long rows = static_cast<long long>(BKH) * G * t_len;
  fa_bwd_dot<<<static_cast<unsigned>((rows + WARPS - 1) / WARPS), THREADS, 0, stream>>>(
      o, dout, dvec, rows, hd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = smem_floats(32 * DPL) * static_cast<int>(sizeof(float));
  e = cudaFuncSetAttribute(fa_bwd_dkdv<DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(fa_bwd_dq<DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (t_len + BT - 1) / BT;
  fa_bwd_dkdv<DPL><<<dim3(BKH, tiles), THREADS, smem, stream>>>(
      q, k, v, dout, lse, dvec, dk, dv, G, t_len, hd, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fa_bwd_dq<DPL><<<dim3(BKH * G, tiles), THREADS, smem, stream>>>(
      q, k, v, dout, lse, dvec, dq, G, t_len, hd, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
using repro::fast_exp2;
using repro::fence_regs;
using repro::kLog2e;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::pack_bf16;
using repro::sw128_desc;
using repro::tile_off;
using repro::tma_load_3d;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_rs;
using repro::wgmma_ss_n64;
using repro::wgmma_wait0;

constexpr int TB = 64;                 // rows of every tile: keys or query rows
constexpr int TC_MAX_HEADS = 8;        // grouped heads per dQ block
constexpr float kPadLse2 = 1e30f;      // lse2 of a padding row: its P is 0

// Shared memory of either block: six (TB, HD) bf16 tiles, two (lse2, D)
// stages and three barriers; +1024 to align the tiles to swizzle atoms.
template <int HD>
constexpr int tc_smem_bytes() {
  return 6 * TB * HD * 2 + 2 * 2 * TB * 4 + 3 * 8 + 1024;
}

// D = rowsum(dO * O) and lse * log2(e) of every row, into ld (BKH G,
// n_tiles, 2 TB): tile i of head h holds the lse2 of its 64 rows, then
// their D.  16 lanes per row, lane c summing the 16-byte chunk c (hd % 8 ==
// 0, hd <= 128) in order, folded by a fixed butterfly.
__global__ void __launch_bounds__(256)
fa_bwd_prep(const bf16* __restrict__ o, const bf16* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ ld, int t_len, int n_tiles,
            int hd) {
  const long long row = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / 16;
  const int c = threadIdx.x % 16, tpad = n_tiles * TB;
  const long long h = row / tpad;
  const int pos = static_cast<int>(row % tpad);
  float acc = 0.f;
  if (pos < t_len && c * 8 < hd) {
    const size_t off = (static_cast<size_t>(h) * t_len + pos) * hd + c * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + off);
    const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(ah[i]), y = __bfloat1622float2(bh[i]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) acc += __shfl_xor_sync(repro::kFullMask, acc, m);
  if (c == 0) {
    float* t = ld + (static_cast<size_t>(h) * n_tiles + pos / TB) * (2 * TB) + pos % TB;
    const bool live = pos < t_len;
    t[0] = live ? lse[h * t_len + pos] * kLog2e : kPadLse2;
    t[TB] = live ? acc : 0.f;
  }
}

// The A fragments (rows = this warp's 16, k = 16 columns from 16 kk) of a
// 64 x 64 f32 accumulator, rounded to bf16.
__device__ __forceinline__ void a_frag(const float (&x)[TB / 8][4], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// d = a b^T over hd for two (TB, HD) K-major tiles: 64 x 64 f32 per warp
// group, a k-step of 16 dims is 32 bytes into a 64-dim panel
template <int HD>
__device__ __forceinline__ void scores(float (&d)[TB / 8][4], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * (TB * 128) + (kk % 4) * 32;
    wgmma_ss_n64(d, sw128_desc(a + off, 16, 1024), sw128_desc(b + off, 16, 1024), kk > 0);
  }
}

// acc += x b: x (64 x TB f32 accumulators, rounded to bf16) from
// registers, b a (TB, HD) tile whose rows are the k-rows, hd-contiguous
// (read transposed: a k-step of 16 rows is two swizzle atoms, the 64-dim
// panels TB * 128 bytes apart)
template <int HD>
__device__ __forceinline__ void times_tile(float (&acc)[HD / 8][4], const float (&x)[TB / 8][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < TB / 16; ++kk) {
    uint32_t a[4];
    a_frag(x, kk, a);
    wgmma_rs<HD / 8, 1>(acc, a, sw128_desc(b + kk * 2048, TB * 128, 1024), 1);
  }
}

// One block: KV head bkh, keys [k0, k0 + TB).  Step j of its walk is head
// j / per_head at query tile first + j % per_head, in stage j % 2; once
// every warp is done with it, one thread asks TMA for step j + 2 in its
// place.  Thread (warp w, lane l) holds keys k0 + 16 w + l / 4 (+ 8).
template <int HD>
__global__ void __launch_bounds__(128, 2)
fa_bwd_dkdv_tc(bf16* __restrict__ dk, bf16* __restrict__ dv, int G, int t_len, int hd,
               int causal, float scale_log2, float scale,
               const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmdo,
               const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv,
               const __grid_constant__ CUtensorMap tmld) {
  constexpr int KB = TB * HD * 2;           // bytes of one tile
  extern __shared__ __align__(128) char tc_smem[];
  char* ks = tc_smem + ((1024 - (repro::smem_u32(tc_smem) & 1023)) & 1023);
  char* vs = ks + KB;
  char* qs = vs + KB;                       // 2 stages of (TB, HD)
  char* dos = qs + 2 * KB;                  // 2 stages of (TB, HD)
  float* lds = reinterpret_cast<float*>(dos + 2 * KB);   // 2 stages of (lse2, D)
  const uint32_t bar = repro::smem_u32(lds + 4 * TB);     // K/V, stage 0, stage 1
  const int bkh = blockIdx.x, k0 = blockIdx.y * TB;       // the most causal work first
  const int n_tiles = (t_len + TB - 1) / TB;
  const int first = causal ? blockIdx.y : 0;   // earlier query tiles see none of these keys
  const int per_head = n_tiles - first, n_steps = G * per_head;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  auto load_step = [&](int j) {
    const int st = j & 1, h = bkh * G + j / per_head, qi = first + j % per_head;
    const uint32_t b = bar + 8 + 8 * st;
    const uint32_t qd = repro::smem_u32(qs + st * KB), dd = repro::smem_u32(dos + st * KB);
    mbar_expect_tx(b, 2 * KB + 2 * TB * 4);
#pragma unroll
    for (int pn = 0; pn < HD / 64; ++pn) {
      tma_load_3d(qd + pn * TB * 128, &tmq, 64 * pn, qi * TB, h, b);
      tma_load_3d(dd + pn * TB * 128, &tmdo, 64 * pn, qi * TB, h, b);
    }
    tma_load_3d(repro::smem_u32(lds + st * 2 * TB), &tmld, 0, qi, h, b);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint32_t kt = repro::smem_u32(ks), vt = repro::smem_u32(vs);
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 2 * KB);
#pragma unroll
    for (int pn = 0; pn < HD / 64; ++pn) {
      tma_load_3d(kt + pn * TB * 128, &tmk, 64 * pn, k0, bkh, bar);
      tma_load_3d(vt + pn * TB * 128, &tmv, 64 * pn, k0, bkh, bar);
    }
    load_step(0);
    if (n_steps > 1) load_step(1);
  }

  float dka[HD / 8][4], dva[HD / 8][4], s[TB / 8][4], dp[TB / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < TB / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
  const int key_a = k0 + 16 * warp + lane / 4;
  // a tile is masked only where it crosses the diagonal or the keys pass T
  const bool tail = k0 + TB > t_len;
  mbar_wait(bar, 0);

  for (int j = 0; j < n_steps; ++j) {
    const int st = j & 1;
    mbar_wait(bar + 8 + 8 * st, (j >> 1) & 1);
    const int q0 = (first + j % per_head) * TB;
    const uint32_t qt = repro::smem_u32(qs + st * KB), dt = repro::smem_u32(dos + st * KB);
    // S^T = K Q^T, dP^T = V dO^T: keys are A's rows, query rows B's columns
    wgmma_fence();
    fence_regs(s);
    fence_regs(dp);
    scores<HD>(s, kt, qt);
    scores<HD>(dp, vt, dt);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);
    const float* l = lds + st * 2 * TB;
    const bool edge = tail || (causal && q0 < k0 + TB - 1);
#pragma unroll
    for (int nt = 0; nt < TB / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + (lane & 3) * 2 + e;   // query q0 + col
        const float l2 = l[col], dd = l[TB + col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p = fast_exp2(fmaf(s[nt][2 * h + e], scale_log2, -l2));
          if (edge) {
            const int key = key_a + 8 * h;
            if (key >= t_len || (causal && key > q0 + col)) p = 0.f;
          }
          s[nt][2 * h + e] = p;
          dp[nt][2 * h + e] = p * (dp[nt][2 * h + e] - dd);
        }
      }
    }
    // dV += P^T dO, dK += dS^T Q
    wgmma_fence();
    fence_regs(dva);
    fence_regs(dka);
    times_tile<HD>(dva, s, dt);
    times_tile<HD>(dka, dp, qt);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dva);
    fence_regs(dka);
    __syncthreads();                         // stage j % 2 is free again
    if (threadIdx.x == 0 && j + 2 < n_steps) load_step(j + 2);
  }

  // dK (scaled) and dV into the free stage-0 tiles, then 16-byte stores
  const int ra = 16 * warp + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
#pragma unroll
    for (int d8 = 0; d8 < HD / 8; ++d8) {
      const uint32_t off = tile_off<TB>(r, d8) + (lane & 3) * 4;
      *reinterpret_cast<uint32_t*>(qs + off) =
          pack_bf16(dka[d8][2 * h] * scale, dka[d8][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dos + off) = pack_bf16(dva[d8][2 * h], dva[d8][2 * h + 1]);
    }
  }
  __syncthreads();
  constexpr int CPR = HD / 8;
  for (int i = threadIdx.x; i < TB * CPR; i += 128) {
    const int r = i / CPR, c = i % CPR, key = k0 + r;
    if (key >= t_len || c * 8 >= hd) continue;
    const size_t off = (static_cast<size_t>(bkh) * t_len + key) * hd + c * 8;
    *reinterpret_cast<uint4*>(dk + off) = *reinterpret_cast<const uint4*>(qs + tile_off<TB>(r, c));
    *reinterpret_cast<uint4*>(dv + off) = *reinterpret_cast<const uint4*>(dos + tile_off<TB>(r, c));
  }
}

// One block: heads [g0, g0 + gb) of KV head bkh at positions [q0, q0 +
// bq); row r is head g0 + r / bq at position q0 + r % bq.  K/V tile j lands
// in stage j % 2; once every warp is done with it, one thread asks TMA for
// tile j + 2 in its place.
template <int HD>
__global__ void __launch_bounds__(128, 2)
fa_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ dout,
             const float* __restrict__ ld, bf16* __restrict__ dq, int G, int t_len, int hd,
             int causal, float scale_log2, float scale, int gb, int bq,
             const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv) {
  constexpr int KB = TB * HD * 2;
  extern __shared__ __align__(128) char tc_smem[];
  char* qs = tc_smem + ((1024 - (repro::smem_u32(tc_smem) & 1023)) & 1023);
  char* dos = qs + KB;
  char* kst = dos + KB;                     // 2 stages of (TB, HD)
  char* vst = kst + 2 * KB;
  const uint32_t full = repro::smem_u32(vst + 2 * KB);   // 2 stage barriers
  const int ngb = (G + gb - 1) / gb;
  const int bkh = blockIdx.x / ngb, g0 = (blockIdx.x % ngb) * gb;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;      // the most causal work first
  const int n_tiles = (t_len + TB - 1) / TB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  auto row_index = [&](int r) -> long long {   // -1 for a padding row
    const int gi = r / bq, pos = q0 + r % bq, g = g0 + gi;
    if (gi >= gb || g >= G || pos >= t_len) return -1;
    return (static_cast<long long>(bkh) * G + g) * t_len + pos;
  };
  const int kv_end = causal ? min(t_len, q0 + bq) : t_len;
  const int n_kv = (kv_end + TB - 1) / TB;
  auto load_tile = [&](int j) {
    const int st = j & 1;
    const uint32_t b = full + 8 * st;
    const uint32_t kd = repro::smem_u32(kst + st * KB), vd = repro::smem_u32(vst + st * KB);
    mbar_expect_tx(b, 2 * KB);
#pragma unroll
    for (int pn = 0; pn < HD / 64; ++pn) {
      tma_load_3d(kd + pn * TB * 128, &tmk, 64 * pn, j * TB, bkh, b);
      tma_load_3d(vd + pn * TB * 128, &tmv, 64 * pn, j * TB, bkh, b);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    load_tile(0);
    if (n_kv > 1) load_tile(1);
  }
  repro::stage_rows<HD, TB, 128>(qs, hd, q, [&](int r) -> const bf16* {
    const long long i = row_index(r);
    return i < 0 ? nullptr : q + static_cast<size_t>(i) * hd;
  });
  repro::stage_rows<HD, TB, 128>(dos, hd, dout, [&](int r) -> const bf16* {
    const long long i = row_index(r);
    return i < 0 ? nullptr : dout + static_cast<size_t>(i) * hd;
  });
  repro::cp_async_commit();
  // this thread's rows ra and ra + 8: position, lse2 and D (a padding
  // row's lse2 makes its P exactly 0)
  const int ra = 16 * warp + lane / 4;
  int pos[2];
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    const long long i = row_index(r);
    pos[h] = q0 + r % bq;
    l2[h] = kPadLse2;
    dd[h] = 0.f;
    if (i >= 0) {
      const float* t = ld + (i / t_len * n_tiles + pos[h] / TB) * (2 * TB) + pos[h] % TB;
      l2[h] = t[0];
      dd[h] = t[TB];
    }
  }
  repro::cp_async_wait_all();
  // q and dO were written through the generic proxy; wgmma reads them
  // through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  float dqa[HD / 8][4], s[TB / 8][4], dp[TB / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < TB / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
  const uint32_t qa = repro::smem_u32(qs), da = repro::smem_u32(dos);

  for (int j = 0; j < n_kv; ++j) {
    mbar_wait(full + 8 * (j & 1), (j >> 1) & 1);
    const int k0 = j * TB;
    const uint32_t kt = repro::smem_u32(kst + (j & 1) * KB);
    const uint32_t vt = repro::smem_u32(vst + (j & 1) * KB);
    // S = Q K^T, dP = dO V^T: rows are A's rows, keys B's columns
    wgmma_fence();
    fence_regs(s);
    fence_regs(dp);
    scores<HD>(s, qa, kt);
    scores<HD>(dp, da, vt);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);
    const bool edge = k0 + TB > t_len || (causal && k0 + TB - 1 > q0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int nt = 0; nt < TB / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = fast_exp2(fmaf(s[nt][2 * h + e], scale_log2, -l2[h]));
          if (edge) {
            const int key = k0 + nt * 8 + (lane & 3) * 2 + e;
            if (key >= t_len || (causal && key > pos[h])) p = 0.f;
          }
          dp[nt][2 * h + e] = p * (dp[nt][2 * h + e] - dd[h]);
        }
      }
    }
    // dQ += dS K
    wgmma_fence();
    fence_regs(dqa);
    times_tile<HD>(dqa, dp, kt);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dqa);
    __syncthreads();                         // stage j % 2 is free again
    if (threadIdx.x == 0 && j + 2 < n_kv) load_tile(j + 2);
  }

  // dQ (scaled) into the q tile, then 16-byte stores of the valid rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
#pragma unroll
    for (int d8 = 0; d8 < HD / 8; ++d8)
      *reinterpret_cast<uint32_t*>(qs + tile_off<TB>(r, d8) + (lane & 3) * 4) =
          pack_bf16(dqa[d8][2 * h] * scale, dqa[d8][2 * h + 1] * scale);
  }
  __syncthreads();
  constexpr int CPR = HD / 8;
  for (int i = threadIdx.x; i < TB * CPR; i += 128) {
    const int r = i / CPR, c = i % CPR;
    const long long row = row_index(r);
    if (row < 0 || c * 8 >= hd) continue;
    *reinterpret_cast<uint4*>(dq + static_cast<size_t>(row) * hd + c * 8) =
        *reinterpret_cast<const uint4*>(qs + tile_off<TB>(r, c));
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, float* ld, void* dq, void* dk, void* dv, int BKH, int G,
              int t_len, int hd, int causal, float scale, cudaStream_t stream) {
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
      reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
      reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  const int n_tiles = (t_len + TB - 1) / TB, heads = BKH * G;
  // first a runtime call that needs the context: it makes the context
  // current in this thread (an autograd worker may have none yet), which
  // cuTensorMapEncodeTiled needs
  constexpr int smem = tc_smem_bytes<HD>();
  cudaError_t e =
      cudaFuncSetAttribute(fa_bwd_dkdv_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(fa_bwd_dq_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // q, dO (hd, T, BKH G) and k, v (hd, T, BKH) as 64 x 64 boxes; ld as one
  // tile's (lse2, D) per box
  CUtensorMap tmq, tmdo, tmk, tmv, tmld;
  if (hd % 8 != 0 || addr % 16 != 0 ||
      !repro::tensor_map_3d(&tmq, q, false, hd, t_len, heads, 64, TB) ||
      !repro::tensor_map_3d(&tmdo, dout, false, hd, t_len, heads, 64, TB) ||
      !repro::tensor_map_3d(&tmk, k, false, hd, t_len, BKH, 64, TB) ||
      !repro::tensor_map_3d(&tmv, v, false, hd, t_len, BKH, 64, TB) ||
      !repro::tensor_map_3d(&tmld, ld, true, 2 * TB, n_tiles, heads, 2 * TB, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long prep_threads = static_cast<long long>(heads) * n_tiles * TB * 16;
  fa_bwd_prep<<<static_cast<unsigned>(prep_threads / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, ld, t_len, n_tiles, hd);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fa_bwd_dkdv_tc<HD><<<dim3(BKH, n_tiles), 128, smem, stream>>>(
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), G, t_len, hd, causal, scale * kLog2e,
      scale, tmq, tmdo, tmk, tmv, tmld);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int gb = min(G, TC_MAX_HEADS), bq = TB / gb, ngb = (G + gb - 1) / gb;
  fa_bwd_dq_tc<HD><<<dim3(BKH * ngb, (t_len + bq - 1) / bq), 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(dout), ld, static_cast<bf16*>(dq),
      G, t_len, hd, causal, scale * kLog2e, scale, gb, bq, tmk, tmv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The number of f32 scratch floats flash_attention_bwd_launch's `scratch`
// must hold: bf16, (lse2, D) per 64-row tile of each query head; f32, D
// per row.
extern "C" long long flash_attention_bwd_scratch(int BKH, int G, int t_len, int is_bf16) {
  const long long heads = static_cast<long long>(BKH) * G;
  return is_bf16 ? heads * ((t_len + TB - 1) / TB) * 2 * TB : heads * t_len;
}

// All tensors contiguous: q, o, dout, dq (BKH, G, T, hd); k, v, dk, dv
// (BKH, T, hd), all bf16 (is_bf16) or all f32; lse (BKH, G, T) f32 from the
// forward; scratch f32 of flash_attention_bwd_scratch(...) floats.  T >= 1,
// 1 <= hd <= 128.  bf16: the tensor-core kernels (hd <= 64 runs the 64-wide
// tiles, hd <= 128 the 128-wide ones; needs hd % 8 == 0 and 16-byte aligned
// tensors, which the wrapper arranges); f32: the CUDA-core kernels.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* scratch, void* dq, void* dk, void* dv, int BKH,
                                          int G, int t_len, int hd, int causal, float scale,
                                          int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  if (is_bf16) {
    if (hd <= 64)
      return launch_tc<64>(q, k, v, o, dout, l, sc, dq, dk, dv, BKH, G, t_len, hd, causal, scale,
                           s);
    if (hd <= 128)
      return launch_tc<128>(q, k, v, o, dout, l, sc, dq, dk, dv, BKH, G, t_len, hd, causal,
                            scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* df = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  switch ((hd + 31) / 32) {
    case 1: return launch_f32<1>(qf, kf, vf, of, df, l, sc, dqf, dkf, dvf, BKH, G, t_len, hd, causal, scale, s);
    case 2: return launch_f32<2>(qf, kf, vf, of, df, l, sc, dqf, dkf, dvf, BKH, G, t_len, hd, causal, scale, s);
    case 3: return launch_f32<3>(qf, kf, vf, of, df, l, sc, dqf, dkf, dvf, BKH, G, t_len, hd, causal, scale, s);
    case 4: return launch_f32<4>(qf, kf, vf, of, df, l, sc, dqf, dkf, dvf, BKH, G, t_len, hd, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);   // hd > 128
  }
}
