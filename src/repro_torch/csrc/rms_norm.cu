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

}  // namespace

// x (rows, d) and w (d,) contiguous, both f32 or both bf16; out like x.
// rows >= 1 and rows < 2^31.
extern "C" int rms_norm_launch(const void* x, const void* w, void* out, int rows, int d,
                               float eps, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, w, out, rows, d, eps, st);
  return launch<float>(x, w, out, rows, d, eps, st);
}
