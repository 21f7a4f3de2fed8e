// RMS normalisation of rows: out = x * rsqrt(mean(x^2) + eps) * w.
//
// A kernel of the port with no TPU counterpart: repro computes rms_norm in
// plain jnp (repro/models/common.py), which XLA fuses.  In PyTorch the same
// function is ~7 eager launches, and torch's row reduction picks its
// summation order from the tensor's shape, so one row's bits changed with
// the number of rows beside it: a decode step at batch 1 and at batch 4, or
// a verify pass over B * (K + 1) rows and the decode step it stands for,
// rounded the same hidden state differently.
//
// x (rows, d) and w (d,) in f32 or bf16, out in x's type.  One block per
// row.  Thread i owns the 8-element chunks i, i + THREADS, ...; it sums the
// squares of its elements in order (fmaf, f32), the warps fold by a fixed
// butterfly, and thread 0 adds the warps' sums in warp order.  That order
// depends on d alone, never on the number of rows or on the row's address
// (16-byte loads where the row is aligned, scalar loads of the same
// elements otherwise), so a row's bits do not depend on the rows around it.
// The scale is applied as the plain version does: (x * r) * w, rounded to
// out's type once.
//
// What bounds it on the H100: each element is read once (twice, the second
// read from L1/L2) and written once, ~3 flops per element: bytes.  At the
// decode step's 4 rows of 4096 bf16 it moves 64 KB (~0.02 us at 3.35 TB/s),
// so in practice it is bound by the launch and one block's latency.
#include "common.cuh"

namespace {

constexpr int RN_THREADS = 256;
constexpr int RN_CHUNK = 8;
constexpr int RN_BWD_ROWS = 16;   // rows per block of the backward

// The 8 elements of chunk c (those past d read as 0), as floats.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* row, int c, int d, bool vec,
                                           float (&v)[RN_CHUNK]) {
  const int e0 = c * RN_CHUNK;
  if (vec) {
    if constexpr (sizeof(T) == 2) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + e0);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
      const float4 a = *reinterpret_cast<const float4*>(row + e0);
      const float4 b = *reinterpret_cast<const float4*>(row + e0 + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < RN_CHUNK; ++i)
    v[i] = e0 + i < d ? repro::to_f32(row[e0 + i]) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(RN_THREADS)
rms_norm_rows(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
              int d, float eps, bool vec) {
  const size_t r = blockIdx.x;
  const T* xr = x + r * d;
  T* orow = out + r * d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_chunks = (d + RN_CHUNK - 1) / RN_CHUNK;
  __shared__ float part[RN_THREADS / 32];
  __shared__ float scale;

  float acc = 0.f;
  for (int c = tid; c < n_chunks; c += RN_THREADS) {
    float v[RN_CHUNK];
    load_chunk(xr, c, d, vec, v);
#pragma unroll
    for (int i = 0; i < RN_CHUNK; ++i) acc = fmaf(v[i], v[i], acc);
  }
  acc = repro::warp_sum(acc);
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int i = 0; i < RN_THREADS / 32; ++i) sum += part[i];
    scale = rsqrtf(sum / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float rs = scale;
  for (int c = tid; c < n_chunks; c += RN_THREADS) {
    float v[RN_CHUNK], g[RN_CHUNK];
    load_chunk(xr, c, d, vec, v);
    load_chunk(w, c, d, vec, g);
    const int e0 = c * RN_CHUNK;
#pragma unroll
    for (int i = 0; i < RN_CHUNK; ++i)
      if (e0 + i < d) repro::store_as(orow + e0 + i, (v[i] * rs) * g[i]);
  }
}

// Backward of one row block: rows [r0, r0 + RN_BWD_ROWS).  For each row,
// with r = rsqrt(mean(x^2) + eps) summed exactly as the forward sums it,
//   dx = r * w * dy - x * r^3 * mean(x * w * dy),
// and this block's partial dw (d,) = sum over its rows, in row order, of
// x * r * dy, kept per element by the thread that owns the element and
// written to part[block].  rms_norm_dw then adds the partials in block
// order: no atomics, so dw's bits are the same on every run.
template <typename T>
__global__ void __launch_bounds__(RN_THREADS)
rms_norm_bwd_rows(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ part, int rows, int d, float eps,
                  bool vec) {
  extern __shared__ float dwp[];             // (d) this block's partial dw
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_chunks = (d + RN_CHUNK - 1) / RN_CHUNK;
  __shared__ float part_sq[RN_THREADS / 32], part_dot[RN_THREADS / 32];
  __shared__ float row_scale, row_dot;
  for (int e = tid; e < d; e += RN_THREADS) dwp[e] = 0.f;
  const int r0 = blockIdx.x * RN_BWD_ROWS, r1 = min(rows, r0 + RN_BWD_ROWS);
  for (int r = r0; r < r1; ++r) {
    const size_t off = static_cast<size_t>(r) * d;
    float sq = 0.f, dot = 0.f;
    for (int c = tid; c < n_chunks; c += RN_THREADS) {
      float v[RN_CHUNK], g[RN_CHUNK], dv[RN_CHUNK];
      load_chunk(x + off, c, d, vec, v);
      load_chunk(w, c, d, vec, g);
      load_chunk(dy + off, c, d, vec, dv);
#pragma unroll
      for (int i = 0; i < RN_CHUNK; ++i) {
        sq = fmaf(v[i], v[i], sq);
        dot = fmaf(v[i] * g[i], dv[i], dot);
      }
    }
    sq = repro::warp_sum(sq);
    dot = repro::warp_sum(dot);
    if (lane == 0) {
      part_sq[warp] = sq;
      part_dot[warp] = dot;
    }
    __syncthreads();
    if (tid == 0) {
      float s1 = 0.f, s2 = 0.f;
      for (int i = 0; i < RN_THREADS / 32; ++i) {
        s1 += part_sq[i];
        s2 += part_dot[i];
      }
      row_scale = rsqrtf(s1 / static_cast<float>(d) + eps);
      row_dot = s2 / static_cast<float>(d);
    }
    __syncthreads();
    const float rs = row_scale, mdot = row_dot;
    const float c3 = rs * rs * rs * mdot;
    for (int c = tid; c < n_chunks; c += RN_THREADS) {
      float v[RN_CHUNK], g[RN_CHUNK], dv[RN_CHUNK];
      load_chunk(x + off, c, d, vec, v);
      load_chunk(w, c, d, vec, g);
      load_chunk(dy + off, c, d, vec, dv);
      const int e0 = c * RN_CHUNK;
#pragma unroll
      for (int i = 0; i < RN_CHUNK; ++i) {
        if (e0 + i < d) {
          repro::store_as(dx + off + e0 + i, rs * g[i] * dv[i] - v[i] * c3);
          dwp[e0 + i] = fmaf(v[i] * rs, dv[i], dwp[e0 + i]);
        }
      }
    }
    __syncthreads();                         // row_scale / row_dot reused
  }
  float* pb = part + static_cast<size_t>(blockIdx.x) * d;
  for (int e = tid; e < d; e += RN_THREADS) pb[e] = dwp[e];
}

// dw[e] = sum over blocks b, in order, of part[b][e]
template <typename T>
__global__ void __launch_bounds__(RN_THREADS)
rms_norm_dw(const float* __restrict__ part, T* __restrict__ dw, int n_blocks, int d) {
  const int e = blockIdx.x * RN_THREADS + threadIdx.x;
  if (e >= d) return;
  float acc = 0.f;
  for (int b = 0; b < n_blocks; ++b) acc += part[static_cast<size_t>(b) * d + e];
  repro::store_as(dw + e, acc);
}

template <typename T>
int launch(const void* x, const void* w, void* out, int rows, int d, float eps,
           cudaStream_t stream) {
  // vector loads where every chunk lies inside its row and every row and w
  // start on 16 bytes
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w);
  const bool vec = d % RN_CHUNK == 0 && addr % 16 == 0;
  rms_norm_rows<T><<<rows, RN_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), d, eps,
      vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw, float* part,
               int rows, int d, float eps, cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(dy);
  const bool vec = d % RN_CHUNK == 0 && addr % 16 == 0;
  const int smem = d * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(rms_norm_bwd_rows<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_blocks = (rows + RN_BWD_ROWS - 1) / RN_BWD_ROWS;
  rms_norm_bwd_rows<T><<<n_blocks, RN_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), part, rows, d, eps, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rms_norm_dw<T><<<(d + RN_THREADS - 1) / RN_THREADS, RN_THREADS, 0, stream>>>(
      part, static_cast<T*>(dw), n_blocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The number of (d,) f32 partials rms_norm_bwd_launch's `part` must hold.
extern "C" int rms_norm_bwd_blocks(int rows) { return (rows + RN_BWD_ROWS - 1) / RN_BWD_ROWS; }

// Backward of rms_norm_launch: x, dy, dx (rows, d) and w, dw (d,) contiguous,
// all f32 or all bf16; part f32 scratch of rms_norm_bwd_blocks(rows) * d.
// rows >= 1; d * 4 bytes of shared memory per block (d <= 32768).
extern "C" int rms_norm_bwd_launch(const void* x, const void* w, const void* dy, void* dx,
                                   void* dw, void* part, int rows, int d, float eps,
                                   int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (is_bf16) return launch_bwd<__nv_bfloat16>(x, w, dy, dx, dw, p, rows, d, eps, st);
  return launch_bwd<float>(x, w, dy, dx, dw, p, rows, d, eps, st);
}

// x (rows, d) and w (d,) contiguous, both f32 or both bf16; out like x.
// rows >= 1 and rows < 2^31.
extern "C" int rms_norm_launch(const void* x, const void* w, void* out, int rows, int d,
                               float eps, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, w, out, rows, d, eps, st);
  return launch<float>(x, w, out, rows, d, eps, st);
}
