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
// (BKH, G, T) f32 (the forward's per-row log-sum-exp of the scaled scores);
// dq like q, dk and dv like k (summed over the G query heads of their KV
// head); hd <= 128, causal or not, no key lengths.  FlashAttention-2's
// recomputation: the probabilities are rebuilt from q, k and lse, never
// stored.
//
//   1. fa_bwd_dot: D = rowsum(dO * O) per row of q, f32.
//   2. fa_bwd_dkdv: one block per (KV head, tile of BT keys).  It holds
//      its keys' dK and dV in registers and walks the query tiles of each
//      of the G heads in turn (causal: only tiles at or after its first
//      key): S = Q K^T * scale, P = exp(S - lse), dV += P^T dO,
//      dP = dO V^T, dS = P (dP - D), dK += dS^T Q * scale.
//   3. fa_bwd_dq: one block per (query head, tile of BT queries).  It
//      walks the key tiles up to the causal diagonal: dQ += dS K * scale.
//
// Every output element is summed by one thread in a fixed order, with no
// atomics, so a run's gradients are the same bits on every call.  The work
// runs on the CUDA cores in f32 from tiles staged in shared memory as f32
// (K and V rows padded by one float, so that the lanes of a warp reading
// 32 different keys at one dim hit 32 banks); a tensor-core version
// (wgmma, as the forward) is later work.
//
// What bounds it on the H100: the FLOPs of the five products,
// 5 * 2 * hd per (query, key) pair in the causal triangle, at the f32 rate
// of the CUDA cores (the kernel reads each tile of q, k, v, dO from shared
// memory many times, so shared-memory bandwidth, not HBM, is its limit).
#include "common.cuh"

namespace {

constexpr int BT = 32;            // queries and keys per tile
constexpr int THREADS = 256;      // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RPW = BT / WARPS;   // tile rows per warp (4)

template <typename T>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dvec,
           long long rows, int hd) {
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + row * hd;
  const T* drow = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(repro::to_f32(orow[d]), repro::to_f32(drow[d]), acc);
  acc = repro::warp_sum(acc);
  if (lane == 0) dvec[row] = acc;
}

// rows [r0, r0 + BT) of a (T, hd) matrix into shared f32 with row stride
// `stride`; rows past T and columns past hd become zeros
template <typename T>
__device__ __forceinline__ void stage(float* dst, int stride, const T* src, int r0, int t_len,
                                      int hd, int width) {
  for (int i = threadIdx.x; i < BT * width; i += THREADS) {
    const int r = i / width, d = i % width;
    const int pos = r0 + r;
    dst[r * stride + d] =
        pos < t_len && d < hd ? repro::to_f32(src[static_cast<size_t>(pos) * hd + d]) : 0.f;
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
template <typename T, int DPL>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv, int G,
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
    const T* qh = q + head * t_len * hd;
    const T* dh = dout + head * t_len * hd;
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
        repro::store_as(dk + off + d, acc_k[i][e] * scale);
        repro::store_as(dv + off + d, acc_v[i][e]);
      }
    }
  }
}

// One block: query head bg = bkh * G + g, rows [q0, q0 + BT).  Thread
// (warp w, lane l) scores rows w + 8i against key l of a key tile and
// accumulates dQ for the same rows at dims l + 32e.
template <typename T, int DPL>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dvec, T* __restrict__ dq, int G, int t_len, int hd,
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
      if (d < hd) repro::store_as(dq + off + d, acc[i][e] * scale);
    }
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* dvec, void* dq, void* dk, void* dv, int BKH, int G,
           int t_len, int hd, int causal, float scale, cudaStream_t stream) {
  const long long rows = static_cast<long long>(BKH) * G * t_len;
  fa_bwd_dot<T><<<static_cast<unsigned>((rows + WARPS - 1) / WARPS), THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dvec, rows, hd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = smem_floats(32 * DPL) * static_cast<int>(sizeof(float));
  e = cudaFuncSetAttribute(fa_bwd_dkdv<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(fa_bwd_dq<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (t_len + BT - 1) / BT;
  fa_bwd_dkdv<T, DPL><<<dim3(BKH, tiles), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv), G,
      t_len, hd, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fa_bwd_dq<T, DPL><<<dim3(BKH * G, tiles), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dvec, static_cast<T*>(dq), G, t_len, hd, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const float* lse, float* dvec, void* dq, void* dk, void* dv, int BKH, int G,
             int t_len, int hd, int causal, float scale, cudaStream_t s) {
  switch ((hd + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, dout, lse, dvec, dq, dk, dv, BKH, G, t_len, hd, causal, scale, s);
    case 2: return launch<T, 2>(q, k, v, o, dout, lse, dvec, dq, dk, dv, BKH, G, t_len, hd, causal, scale, s);
    case 3: return launch<T, 3>(q, k, v, o, dout, lse, dvec, dq, dk, dv, BKH, G, t_len, hd, causal, scale, s);
    case 4: return launch<T, 4>(q, k, v, o, dout, lse, dvec, dq, dk, dv, BKH, G, t_len, hd, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);   // hd > 128
  }
}

}  // namespace

// All tensors contiguous: q, o, dout, dq (BKH, G, T, hd); k, v, dk, dv
// (BKH, T, hd), all bf16 (is_bf16) or all f32; lse (BKH, G, T) f32 from the
// forward; dvec (BKH, G, T) f32 scratch for D.  T >= 1, 1 <= hd <= 128.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* dvec, void* dq, void* dk, void* dv, int BKH,
                                          int G, int t_len, int hd, int causal, float scale,
                                          int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dd = static_cast<float*>(dvec);
  if (is_bf16)
    return launch_t<__nv_bfloat16>(q, k, v, o, dout, l, dd, dq, dk, dv, BKH, G, t_len, hd,
                                   causal, scale, s);
  return launch_t<float>(q, k, v, o, dout, l, dd, dq, dk, dv, BKH, G, t_len, hd, causal,
                         scale, s);
}
