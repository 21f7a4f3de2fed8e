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
// x (rows, d) and w (d,) in f32 or bf16, out in x's type.  The summation
// order is fixed by d alone: logical thread t of 256 sums, with fmaf and in
// order, the squares of its 8-element chunks t, t + 256, ...; each logical
// warp of 32 folds by the xor butterfly 16, 8, 4, 2, 1; the 8 warps' sums
// are added in warp order from 0.f; r = rsqrt(sum / d + eps) and out =
// (x * r) * w, rounded to out's type once.  Loads are 16 bytes where the
// row is aligned and scalar otherwise, of the same elements.  So a row's
// bits depend on neither the rows around it nor its address, and the
// backward (below) recomputes the forward's r exactly.
//
// Two routes give those bits:
// - the warp route (rms_norm_warp_rows), for more rows than the card has
//   SMs, of rows whose chunks fit a warp's registers: d <= 4096 in bf16 (16
//   chunks a lane), d <= 2048 in f32 (8 chunks a lane);
// - the block route (rms_norm_rows), a 256-thread block per row: up to one
//   row per SM (the decode step, a verify pass: a row's latency is the
//   time there, and 8 warps share it) and wider rows (up to llama3-405b's
//   16384).
//
// What bounds it on the H100: bytes (each element read once and written
// once, ~3 flops each).  (2048, 4096) bf16 moves 32 MB, 0.010 ms at 3.35
// TB/s.  The warp route reads x once into registers as stored and needs no
// barrier: rows up to 2048 wide (at most 8 chunks a lane) keep w in
// registers across the several rows each warp takes and load the next row
// before the current row's butterflies (the grid is capped at 2 blocks a
// SM); rows up to 4096 wide (64 registers of x a lane) take a row per warp,
// 4 blocks of 128 threads a SM (the train step's 2048 rows in one wave),
// and copy each lane's own chunks of w to shared memory by cp.async while
// x loads.  At 4 rows of 4096 (64 KB) the launch and one row's latency are
// the time: the block route.
#include "common.cuh"

#include <algorithm>

namespace {

constexpr int RN_THREADS = 256;
constexpr int RN_CHUNK = 8;
constexpr int RN_BWD_ROWS = 8;    // rows per block of the backward (256 blocks at 2048)
constexpr int RN_WARPS = 4;       // warps per block of the warp route

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

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

// The block route: a block of RN_THREADS per row, thread i summing its chunks
// i, i + RN_THREADS, ...; x is read again, from L1, to scale it.
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

// One chunk's 8 elements as stored (16 bytes of bf16, 32 of f32): held
// this way, two rows ahead fit in the registers one row of floats takes.
template <typename T>
struct Raw {
  uint4 u[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Raw<T> to_raw(const float (&v)[RN_CHUNK]) {
  Raw<T> r;
  if constexpr (sizeof(T) == 2) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(r.u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      r.u[i] = make_uint4(__float_as_uint(v[4 * i]), __float_as_uint(v[4 * i + 1]),
                          __float_as_uint(v[4 * i + 2]), __float_as_uint(v[4 * i + 3]));
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void from_raw(const Raw<T>& r, float (&v)[RN_CHUNK]) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(r.u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      v[4 * i] = __uint_as_float(r.u[i].x);
      v[4 * i + 1] = __uint_as_float(r.u[i].y);
      v[4 * i + 2] = __uint_as_float(r.u[i].z);
      v[4 * i + 3] = __uint_as_float(r.u[i].w);
    }
  }
}

// Chunk c as stored (elements past d read as 0).
template <typename T>
__device__ __forceinline__ Raw<T> load_raw(const T* row, int c, int d, bool vec) {
  if (vec) return *reinterpret_cast<const Raw<T>*>(row + c * RN_CHUNK);
  float v[RN_CHUNK];
  load_chunk(row, c, d, false, v);
  return to_raw<T>(v);
}

// Stores the 8 elements of chunk c (those past d are dropped).
template <typename T>
__device__ __forceinline__ void store_chunk(T* row, int c, int d, bool vec,
                                            const float (&v)[RN_CHUNK]) {
  const int e0 = c * RN_CHUNK;
  if (vec) {
    *reinterpret_cast<Raw<T>*>(row + e0) = to_raw<T>(v);
    return;
  }
#pragma unroll
  for (int i = 0; i < RN_CHUNK; ++i)
    if (e0 + i < d) repro::store_as(row + e0 + i, v[i]);
}

// Copies 16 bytes from global to shared memory through L1, where the next
// warp on the SM finds them.
__device__ __forceinline__ void cp_async_ca16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(repro::smem_u32(dst)),
               "l"(src));
}

// The warp route: a warp per row, the block route's sums.  Lane l stands for
// the block route's threads l + 32 j, j < J (J is 4 where rows of d <= 1024
// leave threads 128.. without a chunk, else 8): accumulator j sums, in
// order, the chunks thread l + 32 j owns (l + 32 j + 256 k, k < NK),
// butterfly j over the lanes is that thread's warp's fold, and every lane
// adds the folds in warp order from 0.f as thread 0 does there.  A logical
// warp with no chunk adds +0, which changes nothing, so its butterfly is
// skipped.  The row is held in registers as stored (Raw): x is read once.
// No barrier: w's chunks are each lane's own, in registers (NK 1) or in
// shared memory (NK 2).  Warp g takes rows g, g + (warps in the grid), ...;
// with NK 1 the next row's loads are issued before the current row's
// butterflies.
template <typename T, int J, int NK>
__global__ void __launch_bounds__(RN_WARPS * 32, NK == 1 ? 2 : 4)
rms_norm_warp_rows(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                   int rows, int d, float eps, bool vec) {
  constexpr int AHEAD = NK == 1 ? 1 : 0;      // rows loaded beyond the current one
  constexpr int Q = sizeof(Raw<T>) / 16;      // 16-byte words of a chunk
  __shared__ uint4 wsm[NK == 2 ? RN_WARPS : 1][NK == 2 ? NK * J * Q : 1][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_chunks = (d + RN_CHUNK - 1) / RN_CHUNK;
  const unsigned stride = gridDim.x * RN_WARPS;     // rows < 2^31: r + stride < 2^32
  unsigned r = blockIdx.x * RN_WARPS + warp;
  if (r >= static_cast<unsigned>(rows)) return;
  Raw<T> xr[AHEAD + 1][NK][J];                // slot s: row r + s * stride
  Raw<T> wr[NK == 1 ? J : 1];
  uint4 (*ws)[32] = wsm[NK == 2 ? warp : 0];
  auto chunk = [&](int k, int j) { return lane + 32 * j + RN_THREADS * k; };

  auto load_row = [&](unsigned row, int slot) {
    const T* xrow = x + static_cast<size_t>(row) * d;
#pragma unroll
    for (int k = 0; k < NK; ++k)
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (chunk(k, j) < n_chunks) xr[slot][k][j] = load_raw(xrow, chunk(k, j), d, vec);
  };
  if constexpr (NK == 1) {
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (chunk(0, j) < n_chunks) wr[j] = load_raw(w, chunk(0, j), d, vec);
  } else if (vec) {
#pragma unroll
    for (int k = 0; k < NK; ++k)
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (chunk(k, j) < n_chunks)
#pragma unroll
          for (int q = 0; q < Q; ++q)
            cp_async_ca16(&ws[(k * J + j) * Q + q][lane],
                          reinterpret_cast<const uint4*>(w + chunk(k, j) * RN_CHUNK) + q);
    repro::cp_async_commit();
  }
  if (AHEAD) load_row(r, 0);
  for (; r < static_cast<unsigned>(rows); r += stride) {
    if (!AHEAD) load_row(r, 0);
    else if (r + stride < static_cast<unsigned>(rows)) load_row(r + stride, AHEAD);
    float acc[J];
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < NK; ++k)
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (chunk(k, j) < n_chunks) {
          float v[RN_CHUNK];
          from_raw(xr[0][k][j], v);
#pragma unroll
          for (int i = 0; i < RN_CHUNK; ++i) acc[j] = fmaf(v[i], v[i], acc[j]);
        }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) sum += 32 * j < n_chunks ? repro::warp_sum(acc[j]) : 0.f;
    const float rs = rsqrtf(sum / static_cast<float>(d) + eps);
    if constexpr (NK == 2) repro::cp_async_wait_all();
    T* orow = out + static_cast<size_t>(r) * d;
#pragma unroll
    for (int k = 0; k < NK; ++k)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = chunk(k, j);
        if (c < n_chunks) {
          float v[RN_CHUNK], g[RN_CHUNK];
          from_raw(xr[0][k][j], v);
          if constexpr (NK == 1) {
            from_raw(wr[j], g);
          } else if (vec) {
            Raw<T> raw;
#pragma unroll
            for (int q = 0; q < Q; ++q) raw.u[q] = ws[(k * J + j) * Q + q][lane];
            from_raw(raw, g);
          } else {
            load_chunk(w, c, d, false, g);
          }
#pragma unroll
          for (int i = 0; i < RN_CHUNK; ++i) v[i] = (v[i] * rs) * g[i];
          store_chunk(orow, c, d, vec, v);
        }
      }
    if (AHEAD) {
#pragma unroll
      for (int j = 0; j < J; ++j) xr[0][0][j] = xr[AHEAD][0][j];
    }
  }
}

// Backward of one row block: rows [r0, r0 + RN_BWD_ROWS).  For each row,
// with r = rsqrt(mean(x^2) + eps) summed exactly as the forward sums it
// (thread i owns chunks i + 256 k, k < NC, the same butterfly, the warps'
// sums added in warp order),
//   dx = r * w * dy - x * r^3 * mean(x * w * dy),
// and this block's partial dw (d,) = sum over its rows, in row order, of
// x * r * dy, kept in registers by the thread that owns the element and
// written to part[block].  A thread keeps its chunks of x and dy in
// registers, as stored, across both phases of a row, so each element is
// read once; rows up to 4096 wide (NC <= 2) have the next two rows' chunks
// in flight while the current row's sums cross the block.  One barrier per
// row: the warps' sums go to one of two buffers by row parity, and every
// thread adds them itself.  rms_norm_dw then adds the partials in block
// order: no atomics, so dw's bits are the same on every run.
//
// What bounds it: bytes, x and dy read once and dx written once (50 MB at
// the train path's (2048, 4096) bf16, 0.015 ms at 3.35 TB/s).  What holds
// it back (PERF.md): a block's rows run in turn, one barrier each, so at
// 256 blocks (about 2 per SM) the loads two rows ahead are all that keeps
// memory busy; the partials add 2 x 4 MB and a second launch.
template <typename T, int NC>
__global__ void __launch_bounds__(RN_THREADS)
rms_norm_bwd_rows(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ part, int rows, int d, float eps,
                  bool vec) {
  constexpr int AHEAD = NC <= 2 ? 2 : 0;      // rows loaded beyond the current one
  constexpr int WARPS = RN_THREADS / 32;
  __shared__ float red[2][2][WARPS];          // [row parity][squares, dot][warp]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_chunks = (d + RN_CHUNK - 1) / RN_CHUNK;
  const int r0 = blockIdx.x * RN_BWD_ROWS, r1 = min(rows, r0 + RN_BWD_ROWS);
  Raw<T> xr[AHEAD + 1][NC], yr[AHEAD + 1][NC];   // slot i: row r + i
  float dwp[NC][RN_CHUNK];
#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int i = 0; i < RN_CHUNK; ++i) dwp[k][i] = 0.f;

  auto load_row = [&](int r, int slot) {
    const size_t off = static_cast<size_t>(r) * d;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = tid + RN_THREADS * k;
      if (c < n_chunks) {
        xr[slot][k] = load_raw(x + off, c, d, vec);
        yr[slot][k] = load_raw(dy + off, c, d, vec);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < AHEAD; ++i)
    if (r0 + i < r1) load_row(r0 + i, i);
  for (int r = r0, par = 0; r < r1; ++r, par ^= 1) {
    if (r + AHEAD < r1) load_row(r + AHEAD, AHEAD);
    float sq = 0.f, dot = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = tid + RN_THREADS * k;
      if (c < n_chunks) {
        float xv[RN_CHUNK], yv[RN_CHUNK], g[RN_CHUNK];
        from_raw(xr[0][k], xv);
        from_raw(yr[0][k], yv);
        load_chunk(w, c, d, vec, g);
#pragma unroll
        for (int i = 0; i < RN_CHUNK; ++i) {
          sq = fmaf(xv[i], xv[i], sq);
          dot = fmaf(xv[i] * g[i], yv[i], dot);
        }
      }
    }
    sq = repro::warp_sum(sq);
    dot = repro::warp_sum(dot);
    if (lane == 0) {
      red[par][0][warp] = sq;
      red[par][1][warp] = dot;
    }
    __syncthreads();
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      s1 += red[par][0][i];
      s2 += red[par][1][i];
    }
    const float rs = rsqrtf(s1 / static_cast<float>(d) + eps);
    const float c3 = rs * rs * rs * (s2 / static_cast<float>(d));
    const size_t off = static_cast<size_t>(r) * d;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = tid + RN_THREADS * k;
      if (c < n_chunks) {
        float xv[RN_CHUNK], yv[RN_CHUNK], g[RN_CHUNK], out[RN_CHUNK];
        from_raw(xr[0][k], xv);
        from_raw(yr[0][k], yv);
        load_chunk(w, c, d, vec, g);
#pragma unroll
        for (int i = 0; i < RN_CHUNK; ++i) {
          out[i] = rs * g[i] * yv[i] - xv[i] * c3;
          dwp[k][i] = fmaf(xv[i] * rs, yv[i], dwp[k][i]);
        }
        store_chunk(dx + off, c, d, vec, out);
      }
    }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i)
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        xr[i][k] = xr[i + 1][k];
        yr[i][k] = yr[i + 1][k];
      }
  }
  float* pb = part + static_cast<size_t>(blockIdx.x) * d;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = tid + RN_THREADS * k;
    if (c < n_chunks) store_chunk(pb, c, d, vec, dwp[k]);
  }
}

// dw[e] = the sum over blocks b, in order, of part[b][e]: each of the 8
// warps adds a run of consecutive blocks (runs in block order), then warp 0
// adds the runs' sums in order.  32 elements per block, a lane each; the
// order depends on n_blocks alone.
template <typename T>
__global__ void __launch_bounds__(RN_THREADS)
rms_norm_dw(const float* __restrict__ part, T* __restrict__ dw, int n_blocks, int d) {
  constexpr int WARPS = RN_THREADS / 32;
  __shared__ float run[WARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = blockIdx.x * 32 + lane;
  const int per = (n_blocks + WARPS - 1) / WARPS;
  const int b1 = min(n_blocks, (warp + 1) * per);
  float acc = 0.f;
  if (e < d) {
    int b = warp * per;
    for (; b + 8 <= b1; b += 8) {             // 8 loads in flight, added in order
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = part[static_cast<size_t>(b + u) * d + e];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += v[u];
    }
    for (; b < b1; ++b) acc += part[static_cast<size_t>(b) * d + e];
  }
  run[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && e < d) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) sum += run[i][lane];
    repro::store_as(dw + e, sum);
  }
}

template <typename T, int J, int NK>
int launch_warp(const T* x, const T* w, T* out, int rows, int d, float eps, bool vec,
                cudaStream_t stream) {
  unsigned blocks = (static_cast<unsigned>(rows) + RN_WARPS - 1) / RN_WARPS;
  if (NK == 1) blocks = std::min(blocks, 2u * sm_count());   // each warp several rows
  rms_norm_warp_rows<T, J, NK><<<blocks, RN_WARPS * 32, 0, stream>>>(x, w, out, rows, d, eps,
                                                                     vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, void* out, int rows, int d, float eps,
           cudaStream_t stream) {
  // vector loads and stores where every chunk lies inside its row and every
  // row, w and out start on 16 bytes
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out);
  const bool vec = d % RN_CHUNK == 0 && addr % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  const int n_chunks = (d + RN_CHUNK - 1) / RN_CHUNK;
  if (rows > sm_count()) {
    if (n_chunks <= RN_THREADS / 2)
      return launch_warp<T, 4, 1>(xt, wt, ot, rows, d, eps, vec, stream);
    if (n_chunks <= RN_THREADS)
      return launch_warp<T, 8, 1>(xt, wt, ot, rows, d, eps, vec, stream);
    if constexpr (sizeof(T) == 2) {
      if (n_chunks <= 2 * RN_THREADS)
        return launch_warp<T, 8, 2>(xt, wt, ot, rows, d, eps, vec, stream);
    }
  }
  rms_norm_rows<T><<<rows, RN_THREADS, 0, stream>>>(xt, wt, ot, d, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NC>
int launch_bwd(const T* x, const T* w, const T* dy, T* dx, T* dw, float* part, int rows, int d,
               float eps, cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx) |
                         reinterpret_cast<uintptr_t>(part);
  const bool vec = d % RN_CHUNK == 0 && addr % 16 == 0;
  const int n_blocks = (rows + RN_BWD_ROWS - 1) / RN_BWD_ROWS;
  rms_norm_bwd_rows<T, NC><<<n_blocks, RN_THREADS, 0, stream>>>(x, w, dy, dx, part, rows, d,
                                                                 eps, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rms_norm_dw<T><<<(d + 31) / 32, RN_THREADS, 0, stream>>>(part, dw, n_blocks, d);
  return static_cast<int>(cudaGetLastError());
}

// chunks per thread: 1, 2, 4 or 8 (d <= 16384)
template <typename T>
int launch_bwd_t(const void* x, const void* w, const void* dy, void* dx, void* dw, float* part,
                 int rows, int d, float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  T* dwt = static_cast<T*>(dw);
  const int per_thread = ((d + RN_CHUNK - 1) / RN_CHUNK + RN_THREADS - 1) / RN_THREADS;
  if (per_thread <= 1) return launch_bwd<T, 1>(xt, wt, dyt, dxt, dwt, part, rows, d, eps, s);
  if (per_thread <= 2) return launch_bwd<T, 2>(xt, wt, dyt, dxt, dwt, part, rows, d, eps, s);
  if (per_thread <= 4) return launch_bwd<T, 4>(xt, wt, dyt, dxt, dwt, part, rows, d, eps, s);
  if (per_thread <= 8) return launch_bwd<T, 8>(xt, wt, dyt, dxt, dwt, part, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The number of (d,) f32 partials rms_norm_bwd_launch's `part` must hold.
extern "C" int rms_norm_bwd_blocks(int rows) { return (rows + RN_BWD_ROWS - 1) / RN_BWD_ROWS; }

// Backward of rms_norm_launch: x, dy, dx (rows, d) and w, dw (d,) contiguous,
// all f32 or all bf16; part f32 scratch of rms_norm_bwd_blocks(rows) * d.
// rows >= 1; d <= 16384 (8 chunks of 8 per thread, held in registers).
extern "C" int rms_norm_bwd_launch(const void* x, const void* w, const void* dy, void* dx,
                                   void* dw, void* part, int rows, int d, float eps,
                                   int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (is_bf16) return launch_bwd_t<__nv_bfloat16>(x, w, dy, dx, dw, p, rows, d, eps, st);
  return launch_bwd_t<float>(x, w, dy, dx, dw, p, rows, d, eps, st);
}

// x (rows, d) and w (d,) contiguous, both f32 or both bf16; out like x.
// rows >= 1 and rows < 2^31.
extern "C" int rms_norm_launch(const void* x, const void* w, void* out, int rows, int d,
                               float eps, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, w, out, rows, d, eps, st);
  return launch<float>(x, w, out, rows, d, eps, st);
}
