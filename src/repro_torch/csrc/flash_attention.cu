// Causal flash-attention forward, GQA-grouped.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (TPU;
// body _kernel).  q (BKH, G, T, hd), k/v (BKH, T, hd) unrepeated, hd <= 128;
// out (BKH, G, T, hd) in q's dtype.  Scores and probabilities stay in
// registers; only q, k, v are read and out written.
//
// What bounds it on the H100: at the calibration shape (T = 512, hd = 128)
// it does ~T/2 * 4 flops per q/k/v element, so on paper it is bound by
// the bf16 tensor-core rate.  This first version runs on the CUDA cores in
// f32, so it is bound by their fma and shared-memory rate instead; wgmma
// tiles are later work.
//
// Design: one block (4 warps) per (kv-batch-head, group head, 32 query
// rows).  It walks 32-key tiles of K and V through shared memory in order
// and stops at the causal diagonal of its last query row, so future tiles
// are never read.  Each warp owns 8 query rows; for each row, lane j
// scores key j of the tile, the warp keeps the running max / sum of the
// online softmax, and each lane accumulates hd/32 output dims from the
// tile's V rows with the probabilities broadcast by shuffle.  Keys past T
// (T off the tile grid) and keys in a row's future get probability
// exactly zero, the tail-key mask of the reference.
#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::kFullMask;
using repro::to_f32;
using repro::store_as;
using repro::warp_max;
using repro::warp_sum;

constexpr int FA_THREADS = 128;
constexpr int FA_BQ = 32;                     // query rows per block
constexpr int FA_BK = 32;                     // keys per tile (= warp width)
constexpr int FA_ROWS = FA_BQ / (FA_THREADS / 32);

template <typename T, int DPL>                // DPL = ceil(hd / 32)
__global__ void __launch_bounds__(FA_THREADS)
fa_fwd(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, T* __restrict__ out, int G, int t_len,
       int hd, int causal, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // (BQ, hd), pre-scaled
  float* ks = qs + FA_BQ * hd;               // (BK, hd + 1), padded rows
  float* vs = ks + FA_BK * (hd + 1);         // (BK, hd)
  const int bg = blockIdx.x;                 // bkh * G + g
  const int bkh = bg / G;
  const int q0 = blockIdx.y * FA_BQ;
  const T* qb = q + static_cast<size_t>(bg) * t_len * hd;
  const T* kb = k + static_cast<size_t>(bkh) * t_len * hd;
  const T* vb = v + static_cast<size_t>(bkh) * t_len * hd;
  for (int i = threadIdx.x; i < FA_BQ * hd; i += FA_THREADS) {
    const int qp = q0 + i / hd;
    qs[i] = qp < t_len ? to_f32(qb[static_cast<size_t>(q0) * hd + i]) * scale : 0.f;
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
  const int k_end = causal ? min(t_len, q0 + FA_BQ) : t_len;
  for (int k0 = 0; k0 < k_end; k0 += FA_BK) {
    __syncthreads();                         // previous tile consumed
    for (int i = threadIdx.x; i < FA_BK * hd; i += FA_THREADS) {
      const int j = i / hd, d = i % hd, kp = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < t_len) {
        kv = to_f32(kb[static_cast<size_t>(kp) * hd + d]);
        vv = to_f32(vb[static_cast<size_t>(kp) * hd + d]);
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
      const bool valid = kp < t_len && (!causal || kp <= qp);
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
    T* orow = out + (static_cast<size_t>(bg) * t_len + qp) * hd;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) store_as(orow + d, acc[r][e] * inv);
    }
  }
}

template <typename T, int DPL>
int launch_dpl(const void* q, const void* k, const void* v, void* out, int BKH,
               int G, int t_len, int hd, int causal, float scale,
               cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(FA_BQ * hd + FA_BK * (hd + 1) + FA_BK * hd) *
                      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fa_fwd<T, DPL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(BKH * G, (t_len + FA_BQ - 1) / FA_BQ);
  fa_fwd<T, DPL><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), G, t_len, hd, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BKH,
           int G, int t_len, int hd, int causal, float scale, cudaStream_t s) {
  switch ((hd + 31) / 32) {
    case 1: return launch_dpl<T, 1>(q, k, v, out, BKH, G, t_len, hd, causal, scale, s);
    case 2: return launch_dpl<T, 2>(q, k, v, out, BKH, G, t_len, hd, causal, scale, s);
    case 3: return launch_dpl<T, 3>(q, k, v, out, BKH, G, t_len, hd, causal, scale, s);
    case 4: return launch_dpl<T, 4>(q, k, v, out, BKH, G, t_len, hd, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);   // hd > 128
  }
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int BKH, int G, int t_len, int hd,
                                      int causal, float scale, int is_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, BKH, G, t_len, hd, causal, scale, s);
  return launch<float>(q, k, v, out, BKH, G, t_len, hd, causal, scale, s);
}
