// W4A16 grouped dequant-GEMM: out = x @ ((nibble - zero) * scale).
//
// Replaces repro/kernels/quant_matmul.py::quant_matmul_pallas (TPU; body
// _kernel).
// x (m, k) bf16 or f32 (already divided by act_scale), codes (k/2, n)
// uint8 with byte i holding code[2i] in the low nibble and code[2i+1] in
// the high nibble, scale/zero (k/g, n) f32; out (m, n) in x's dtype.
// Codes are dequantized in registers; they never reach device memory
// dequantized.
//
// What bounds it on the H100.  Decode (m = serving slots, 4): ~4 flops per
// code byte, far below the ~295 flop/B ridge, so bytes bound it: the int4
// codes plus their f32 scales and zeros, k n / 2 + 8 k n / g bytes (0.625
// byte per weight at g = 64; 0.011 ms at 4096 -> 14336).  Prefill (m =
// slots x bucket, up to 2048): 2 m k n operations, which only the tensor
// cores deliver at speed (0.24 ms at 989 TFLOP/s for 2048 x 4096 -> 14336).
// Between the two, the CUDA cores must turn every weight into a tensor-core
// operand at the rate the bytes arrive (~23 weights per SM-cycle at decode).
//
// bf16 route (every main path), qmm_tc: one kernel and one launch for all
// m, on the tensor cores by wgmma (bf16 in, f32 accumulators) with the
// weights as the A operand, from registers ("swap AB"): A's rows are output
// columns, so m becomes the instruction's N (8, 16, 32 or 64), and decode
// pads m = 4 to 8, not to 64.  x, the B operand, is staged K-major in the
// 128-byte swizzle wgmma reads.  A byte of the interchange layout holds two
// k-consecutive codes of one column, exactly one bf16x2 register of an A
// fragment; A's rows are mapped to columns so that a thread's 4 columns are
// adjacent and one 32-bit shared-memory read brings them for a packed row.
//   Dequantization is exact: a byte permute and a LOP3 put two nibbles
// under the bf16 exponent of 128 (128 + code), and one bf16x2 subtraction
// of (128 + zero) leaves code - zero, exact in bf16 because zero is an
// integer in [0, 15] (the quantizer rounds it).  The tensor cores sum
// x (code - zero) over each group of 64 rows into f32, and the group's
// scale is applied to that sum in f32 (c = fma(scale, p, c)).  So the
// kernel differs from the plain version only in f32 summation order: no
// weight is rounded to bf16.  That is ~3 instructions per pair of weights;
// the rule bf16((code - zero) * scale) takes ~7.
//   Codes, x and the group's scale / zero row stream by 16-byte cp.async
// through a 4-stage ring of 64-row k steps; each thread's copy addresses
// are computed once and advanced per stage.  A block is one warp group of
// 128 columns by 8, 16 or 32 x rows (m <= 8, 16, 64), or two warp groups of
// 256 columns by 64 rows for m > 64, where the chunk totals live in shared
// memory to leave registers to the group and chunk sums.  Where (m, n)
// gives too few blocks, k is split: each block sums a run of chunks and
// writes each chunk's sum to an f32 scratch, and the last block of each
// tile, found by a counter that it re-arms (no float atomics), folds them
// in order.  With g % 64 == 0 every stage lies in one group and carries
// that group's scale / zero row.  Groups not a multiple of 64 rows (hymba's
// g = 100) take a slow general path: scale and zero per nibble from global
// memory, the weight rounded once as bf16((code - zero) * scale) (at most
// 2^-9 relative per weight), one chain per chunk.  Shapes the 16-byte
// copies cannot describe (n % 16, k % 8, an unaligned tensor) are
// zero-padded by the wrapper.
//   What still bounds it (PERF.md has the numbers): at decode, instruction
// issue and latency per warp, not bytes (a bare copy ring of the same tiles
// reads at the plain-load rate); at prefill, the L2 traffic of 64 x 256
// tiles (x is read once per 256 columns, codes once per 64 rows) and the
// wait for each group's products before its scale is applied.  The exact
// fold holds two f32 registers per output (the group sum p and the chunk
// sum c), so a warp group's tile is capped near 64 x 128: a wgmma N of 128
// (128 x 128 tile) needs 256 accumulator registers per thread and spills
// (scripts/qmm_tile_probe.py), and 128 x 256 with its totals in shared
// memory does not fit in shared memory.  A larger tile needs the chunk
// sums out of registers, or the scale folded while the next group's wgmma
// runs.
//
// Batch invariance by construction: k is cut into at most 16 chunks fixed
// by k and g alone (4 groups of 64 at k = 4096, 14 at k = 14336).  Within a
// chunk each group's mma chain starts from zero and is folded into the
// chunk sum by fma in group order (general path: one chain per chunk);
// chunk sums are added into the total in chunk order, in registers, in
// shared memory or by the last block.  Every output element is accumulated
// by the same instruction over the same k order whatever m, the tile or
// the split, so a row's bits depend on neither m nor the regime: batched
// serving gives a slot the bits it gets alone.
//
// f32 route (no main path passes f32): the first port's CUDA-core kernels,
// unchanged.  Skinny path (m <= 8): each thread owns 4 neighbouring output
// columns and applies 8 dequantized weights per packed row to all m rows
// held in shared memory; k is split into KC-row chunks across blockIdx.y,
// each writing an f32 partial that qmm_reduce sums in chunk order.  Tiled
// path (m > 8): 64x64 output tile per block, 32-deep k steps, codes
// dequantized into shared memory, 4x4 outputs per thread.  Both fold each
// output the same way (a sequential fma chain per KC-row chunk from 0, then
// the chunk sums in order), so a row does not depend on m either.
#include <type_traits>

#include "hopper.cuh"



namespace {

using repro::store_as;
using repro::to_f32;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// f32 route: CUDA cores
// ---------------------------------------------------------------------------
constexpr int KC = 256;           // k-rows per accumulation chunk
constexpr int SK_THREADS = 64;    // skinny: threads per block
constexpr int SK_COLS = 4;        // skinny: columns per thread
constexpr int SK_MAXM = 8;        // skinny: largest m
constexpr int TM = 64, TN = 64, TK = 32, T_THREADS = 256;
static_assert(KC % TK == 0, "chunks must hold whole k-steps");

__device__ __forceinline__ float deq(uint32_t code, float zero, float scale) {
  return __fmul_rn(__fsub_rn(static_cast<float>(code), zero), scale);
}

template <typename T>
__global__ void __launch_bounds__(SK_THREADS)
qmm_skinny(const T* __restrict__ x, const uint8_t* __restrict__ codes,
           const float* __restrict__ scale, const float* __restrict__ zero,
           float* __restrict__ partial, int m, int k, int n, int g) {
  __shared__ float xs[SK_MAXM][KC];
  const int split = blockIdx.y;
  const int k0 = split * KC;
  const int klen = min(KC, k - k0);           // even: k and KC are even
  for (int i = threadIdx.x; i < m * klen; i += SK_THREADS) {
    const int r = i / klen, kk = i % klen;
    xs[r][kk] = to_f32(x[static_cast<size_t>(r) * k + k0 + kk]);
  }
  __syncthreads();
  const int c0 = (blockIdx.x * SK_THREADS + threadIdx.x) * SK_COLS;
  if (c0 >= n) return;
  const int nc = min(SK_COLS, n - c0);
  const bool vec = nc == SK_COLS && (n % SK_COLS) == 0 &&
                   (reinterpret_cast<uintptr_t>(codes) % 4) == 0;

  float acc[SK_MAXM][SK_COLS];
#pragma unroll
  for (int r = 0; r < SK_MAXM; ++r)
#pragma unroll
    for (int c = 0; c < SK_COLS; ++c) acc[r][c] = 0.f;
  float sc[SK_COLS] = {0.f, 0.f, 0.f, 0.f}, zr[SK_COLS] = {0.f, 0.f, 0.f, 0.f};
  int cur_group = -1;

#pragma unroll 4
  for (int kk = 0; kk < klen; kk += 2) {
    const int kg = k0 + kk;                    // k of the low nibble
    const uint8_t* row = codes + static_cast<size_t>(kg >> 1) * n + c0;
    uint32_t word = 0;
    if (vec) {
      word = __ldg(reinterpret_cast<const uint32_t*>(row));
    } else {
      for (int c = 0; c < nc; ++c) word |= static_cast<uint32_t>(row[c]) << (8 * c);
    }
    float w0[SK_COLS], w1[SK_COLS];
    int grp = kg / g;
    if (grp != cur_group) {
      cur_group = grp;
      for (int c = 0; c < nc; ++c) {
        sc[c] = __ldg(scale + static_cast<size_t>(grp) * n + c0 + c);
        zr[c] = __ldg(zero + static_cast<size_t>(grp) * n + c0 + c);
      }
    }
#pragma unroll
    for (int c = 0; c < SK_COLS; ++c) w0[c] = deq((word >> (8 * c)) & 0xF, zr[c], sc[c]);
    grp = (kg + 1) / g;                        // differs only for odd g
    if (grp != cur_group) {
      cur_group = grp;
      for (int c = 0; c < nc; ++c) {
        sc[c] = __ldg(scale + static_cast<size_t>(grp) * n + c0 + c);
        zr[c] = __ldg(zero + static_cast<size_t>(grp) * n + c0 + c);
      }
    }
#pragma unroll
    for (int c = 0; c < SK_COLS; ++c) w1[c] = deq((word >> (8 * c + 4)) & 0xF, zr[c], sc[c]);
#pragma unroll
    for (int r = 0; r < SK_MAXM; ++r) {
      if (r < m) {
        const float xa = xs[r][kk], xb = xs[r][kk + 1];
#pragma unroll
        for (int c = 0; c < SK_COLS; ++c) {
          acc[r][c] = __fmaf_rn(xa, w0[c], acc[r][c]);
          acc[r][c] = __fmaf_rn(xb, w1[c], acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < SK_MAXM; ++r) {
    if (r < m) {
      float* dst = partial + (static_cast<size_t>(split) * m + r) * n + c0;
      for (int c = 0; c < nc; ++c) dst[c] = acc[r][c];
    }
  }
}

template <typename T>
__global__ void qmm_reduce(const float* __restrict__ partial, T* __restrict__ out,
                           int mn, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp)
    s = __fadd_rn(s, partial[static_cast<size_t>(sp) * mn + i]);
  store_as(out + i, s);
}

template <typename T>
__global__ void __launch_bounds__(T_THREADS)
qmm_tiled(const T* __restrict__ x, const uint8_t* __restrict__ codes,
          const float* __restrict__ scale, const float* __restrict__ zero,
          T* __restrict__ out, int m, int k, int n, int g) {
  __shared__ float xs[TK][TM + 4];
  __shared__ float ws[TK][TN + 4];
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4], tot[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = tot[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += TK) {
    for (int e = threadIdx.x; e < TM * TK; e += T_THREADS) {
      const int r = e / TK, kk = e % TK;
      const int gr = m0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < m && gk < k) ? to_f32(x[static_cast<size_t>(gr) * k + gk]) : 0.f;
    }
    for (int e = threadIdx.x; e < (TK / 2) * TN; e += T_THREADS) {
      const int i = e / TN, c = e % TN;
      const int gk = k0 + 2 * i, gc = n0 + c;
      float lo = 0.f, hi = 0.f;
      if (gc < n && gk < k) {
        const uint32_t b = codes[static_cast<size_t>(gk >> 1) * n + gc];
        const size_t o0 = static_cast<size_t>(gk / g) * n + gc;
        const size_t o1 = static_cast<size_t>((gk + 1) / g) * n + gc;
        lo = deq(b & 0xF, zero[o0], scale[o0]);
        hi = deq(b >> 4, zero[o1], scale[o1]);
      }
      ws[2 * i][c] = lo;
      ws[2 * i + 1][c] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if ((k0 + TK) % KC == 0 || k0 + TK >= k) {   // chunk boundary: fold
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tot[i][j] = __fadd_rn(tot[i][j], acc[i][j]);
          acc[i][j] = 0.f;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < n) store_as(out + static_cast<size_t>(r) * n + c, tot[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* codes, const void* scale,
           const void* zero, void* out, void* partial, int m, int k, int n,
           int g, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const uint8_t* ct = static_cast<const uint8_t*>(codes);
  const float* st = static_cast<const float*>(scale);
  const float* zt = static_cast<const float*>(zero);
  T* ot = static_cast<T*>(out);
  if (m <= SK_MAXM) {
    const int splits = (k + KC - 1) / KC;
    const dim3 grid((n + SK_THREADS * SK_COLS - 1) / (SK_THREADS * SK_COLS), splits);
    float* pt = static_cast<float*>(partial);
    qmm_skinny<T><<<grid, SK_THREADS, 0, stream>>>(xt, ct, st, zt, pt, m, k, n, g);
    const int mn = m * n;
    qmm_reduce<T><<<(mn + 255) / 256, 256, 0, stream>>>(pt, ot, mn, splits);
  } else {
    const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
    qmm_tiled<T><<<grid, T_THREADS, 0, stream>>>(xt, ct, st, zt, ot, m, k, n, g);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores
// ---------------------------------------------------------------------------
constexpr int TC_BK = 64;                 // k rows per pipeline stage
constexpr int TC_STAGES = 4;              // stages in the copy ring (a power of two)
constexpr int TC_MAX_CHUNKS = 16;         // the fold's chunks (the wrapper's MAX_CHUNKS)

// Kernel configurations (the wrapper's plan picks one by m): the block's
// BM = 8 MT x rows are every wgmma's N; WN warps (whole warp groups) of 32
// columns each.  At MT = 8 the chunk totals live in shared memory, so that
// the registers hold the group sums p and the chunk sums c.
template <int MT_, int WN_>
struct TcCfg {
  static constexpr int MT = MT_, WN = WN_, STAGES = TC_STAGES;
  static constexpr bool TOT_SMEM = MT >= 8;
  static constexpr int BN = 32 * WN, BM = 8 * MT, THREADS = 32 * WN;
  static constexpr int CS = BN + 32;      // code-row stride: 32-bit reads conflict-free
  // one stage: BM x rows of 64 k in the 128-byte swizzle (wgmma's B, 1024-
  // byte aligned), 32 packed code rows, one row of scales and one of zeros
  // (a stage lies in one group: g % 64 == 0)
  static constexpr int XB = BM * 128;
  static constexpr int STAGE = XB + 32 * CS + 2 * BN * 4;
  static constexpr int SMEM = STAGES * STAGE + (TOT_SMEM ? BM * BN * 4 : 0) + 1024;
  static_assert(STAGE % 1024 == 0 && WN % 4 == 0, "aligned stages, whole warp groups");
};
using Cfg0 = TcCfg<1, 4>;       // m <= 8
using Cfg1 = TcCfg<2, 4>;       // m <= 16
using Cfg2 = TcCfg<4, 4>;       // m <= 64 (x tiles of 32 rows)
using Cfg3 = TcCfg<8, 8>;       // m > 64: 64 x 256 tiles
#ifdef QMM_PROBE_MT
// another tile, as config 4, for scripts/qmm_tile_probe.py only
using CfgProbe = TcCfg<QMM_PROBE_MT, QMM_PROBE_WN>;
#endif

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ __nv_bfloat162 bits_bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// bf16x2 (code_lo - zero, code_hi - zero) of byte J of u, exact; v = u >> 4
// and zb = bf16x2 (128 + zero, 128 + zero).  The permute puts byte J of u
// in byte 0 and byte J of v in byte 2, the LOP3 keeps their low nibbles
// under the exponent of 128.
template <int J>
__device__ __forceinline__ uint32_t nib_pair(uint32_t u, uint32_t v, uint32_t zb) {
  constexpr uint32_t sel = J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12);
  const uint32_t t = (__byte_perm(u, v, sel) & 0x000F000Fu) | 0x43004300u;
  return bf2_bits(__hsub2(bits_bf2(t), bits_bf2(zb)));
}

// General path: one weight as bf16((code - zero) * scale) in f32, scale and
// zero of row kr's group (0 past the last group: padded rows).
__device__ __forceinline__ float deq_f32(uint32_t code, int kr, int col, const float* scale,
                                         const float* zero, int n, int g, int ng) {
  const int grp = kr / g;
  if (grp >= ng) return 0.f;
  const size_t o = static_cast<size_t>(grp) * n + col;
  return __fmul_rn(__fsub_rn(static_cast<float>(code), __ldg(zero + o)), __ldg(scale + o));
}

__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  uint2 v;
  v.x = bf2_bits(__floats2bfloat162_rn(a, b));
  v.y = bf2_bits(__floats2bfloat162_rn(c, d));
  *reinterpret_cast<uint2*>(p) = v;
}

// Block (n tile blockIdx.x, k chunk blockIdx.y when split, m tile
// blockIdx.z).  Warp wn owns columns n0 + 32 wn .. + 31 as the rows of two
// m16 tiles of A; lane (gq, cq) owns columns n0 + 32 wn + 4 gq .. + 3: A
// row gq + 8 h of tile t is column 4 gq + 2 t + h.  A warp group's four
// warps stack their tile t into one m64 wgmma whose N is the block's BM x
// rows.  Accumulators [t][j][e]: tile t, x rows 8 j .., e as in the m16n8
// layout (e >> 1 = h, e & 1 picks x row 2 cq or 2 cq + 1).  GA: g % 64 == 0
// (every stage lies in one group and carries its scale / zero row, read at
// the group's first stage); else the general path.
template <class C, bool GA>
__global__ void __launch_bounds__(C::THREADS)
qmm_tc(const bf16* __restrict__ x, const uint8_t* __restrict__ codes,
       const float* __restrict__ scale, const float* __restrict__ zero,
       bf16* __restrict__ out, float* __restrict__ partial, int* __restrict__ counters, int m,
       int k, int n, int g, int ng, int chunk, int cpb) {
  constexpr int MT = C::MT, BN = C::BN, BM = C::BM, THREADS = C::THREADS, CS = C::CS;
  constexpr int SB = C::STAGE, STAGES = C::STAGES;
  static_assert((STAGES & (STAGES - 1)) == 0, "the ring slot is s & (STAGES - 1)");
  extern __shared__ __align__(16) char tc_raw[];
  char* tc_smem = tc_raw + ((1024 - (repro::smem_u32(tc_raw) & 1023)) & 1023);
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, wn = tid >> 5;
  const int gq = lane >> 2, cq = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.z * BM;
  const int kb = cpb ? blockIdx.y * cpb * chunk : 0;   // cpb: chunks per block when split
  const int ke = cpb ? min(k, kb + cpb * chunk) : k;
  const int n_stages = (ke - kb + TC_BK - 1) / TC_BK;
  const uint32_t sbase = repro::smem_u32(tc_smem);
  float* tot_s = reinterpret_cast<float*>(tc_smem + STAGES * SB);   // TOT_SMEM

  // Copies by 16-byte cp.async; whatever lies past k, n, m or the block's
  // k range is zero-filled.  Each thread's share of a stage is fixed, so its
  // addresses and predicates are set up once here and advanced per stage.
  constexpr int CODE_ITEMS = 32 * (BN / 16) / THREADS;          // 2 for every config
  constexpr int X_ITEMS = (BM * 8 + THREADS - 1) / THREADS;
  static_assert(CODE_ITEMS * THREADS == 32 * (BN / 16), "code tile split evenly");
  const uint8_t* c_src[CODE_ITEMS];
  uint32_t c_dst[CODE_ITEMS];
  int c_row[CODE_ITEMS];              // packed row of stage 0 (-1: column past n)
#pragma unroll
  for (int u = 0; u < CODE_ITEMS; ++u) {
    const int i = tid + u * THREADS, r = i / (BN / 16), c = i % (BN / 16);
    const int col = n0 + 16 * c;
    c_row[u] = col < n ? kb / 2 + r : -1;
    c_src[u] = codes + static_cast<size_t>(kb / 2 + r) * n + (col < n ? col : 0);
    c_dst[u] = C::XB + r * CS + 16 * c;
  }
  const bf16* x_src[X_ITEMS];
  uint32_t x_dst[X_ITEMS];
  int x_k[X_ITEMS];                   // k of stage 0 (-1: row past m or no item)
#pragma unroll
  for (int u = 0; u < X_ITEMS; ++u) {
    const int i = tid + u * THREADS, r = i >> 3, c = i & 7;
    const bool ok = i < BM * 8 && m0 + r < m;
    x_k[u] = ok ? kb + 8 * c : -1;
    x_src[u] = x + (ok ? static_cast<size_t>(m0 + r) * k + kb + 8 * c : 0);
    x_dst[u] = repro::tile_off<BM>(r, c);
  }
  // GA: threads below BN / 2 copy 4 scales (or zeros) of the stage's group
  const int sz_i = tid < BN / 2 ? tid : -1;
  const float* sz_src = nullptr;
  uint32_t sz_dst = 0;
  bool sz_ok = false;
  if (GA && sz_i >= 0) {
    const int c = sz_i % (BN / 4), col = n0 + 4 * c;
    sz_ok = col < n;
    sz_src = (sz_i < BN / 4 ? scale : zero) + static_cast<size_t>(kb / g) * n + (sz_ok ? col : 0);
    sz_dst = C::XB + 32 * CS + (sz_i / (BN / 4)) * BN * 4 + 16 * c;
  }
  int ld_gpos = 0;                    // GA: stage index within its group, for the next load
  auto load_stage = [&](int s) {
    const uint32_t st = sbase + (s & (STAGES - 1)) * SB;
#pragma unroll
    for (int u = 0; u < CODE_ITEMS; ++u) {
      const bool ok = c_row[u] >= 0 && 2 * (c_row[u] + 32 * s) < ke;
      repro::cp_async<16>(st + c_dst[u], ok ? c_src[u] : codes, ok ? 16 : 0);
      c_src[u] += static_cast<size_t>(32) * n;
    }
#pragma unroll
    for (int u = 0; u < X_ITEMS; ++u) {
      if (u * THREADS + tid < BM * 8) {
        const bool ok = x_k[u] >= 0 && x_k[u] + TC_BK * s < ke;
        repro::cp_async<16>(st + x_dst[u], ok ? x_src[u] : x, ok ? 16 : 0);
        x_src[u] += TC_BK;
      }
    }
    if constexpr (GA) {
      if (sz_i >= 0) repro::cp_async<16>(st + sz_dst, sz_ok ? sz_src : scale, sz_ok ? 16 : 0);
      if (++ld_gpos == g / TC_BK) {   // the next stage starts a new group
        ld_gpos = 0;
        sz_src += n;
      }
    }
  };

  float p[2][MT][4], c[2][MT][4], tot[2][MT][C::TOT_SMEM ? 1 : 4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < MT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[t][j][e] = c[t][j][e] = 0.f;
#pragma unroll
      for (int e = 0; e < (C::TOT_SMEM ? 1 : 4); ++e) tot[t][j][e] = 0.f;
    }
  if constexpr (C::TOT_SMEM) {
#pragma unroll
    for (int i = 0; i < 2 * MT * 4; ++i) tot_s[i * THREADS + tid] = 0.f;
  }
  const int colq = n0 + 32 * wn + 4 * gq;
  const bool col_ok = colq < n;        // n % 16 == 0: all 4 columns or none
  int ch = kb / chunk;                 // the chunk being summed
  // chunk done: split, its sum to the scratch (the tile's last block folds
  // all chunks in order); else total += its sum.  Then the sum restarts.
  auto fold_chunk = [&](float (&sum)[2][MT][4]) {
    if (cpb) {
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = m0 + 8 * j + 2 * cq + e;
          if (col_ok && row < m)
            *reinterpret_cast<float4*>(partial + (static_cast<size_t>(ch) * m + row) * n +
                                       colq) =
                make_float4(sum[0][j][e], sum[0][j][e + 2], sum[1][j][e], sum[1][j][e + 2]);
        }
      ++ch;
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!cpb) {
            if constexpr (C::TOT_SMEM) {
              float& d = tot_s[((t * MT + j) * 4 + e) * THREADS + tid];
              d = __fadd_rn(d, sum[t][j][e]);
            } else {
              tot[t][j][e] = __fadd_rn(tot[t][j][e], sum[t][j][e]);
            }
          }
          sum[t][j][e] = 0.f;
        }
  };
  uint32_t zb[4] = {0, 0, 0, 0};     // GA: bf16x2 (128 + zero) of this thread's columns
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  int chunk_left = chunk / 16;       // k steps left in the chunk

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) load_stage(s);
    repro::cp_async_commit();
  }
  // wait for stage s, queue stage s + STAGES - 1; returns s's ring slot
  auto next_stage = [&](int s) {
    repro::cp_async_wait<STAGES - 2>();
    // the x tile came through the generic proxy; wgmma reads it through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                  // stage s landed; stage s - 1 is free
    if (s + STAGES - 1 < n_stages) load_stage(s + STAGES - 1);
    repro::cp_async_commit();
    return s & (STAGES - 1);
  };
  // wgmma's B at k step kk of the stage in ring slot `slot`: the BM x rows,
  // 16 k (32 bytes) into their rows
  auto b_desc = [&](int slot, int kk) {
    return repro::sw128_desc(sbase + slot * SB + 32 * kk, 16, 1024);
  };
  auto code_rows = [&](int slot) {    // this thread's columns in the slot's code rows
    return reinterpret_cast<const uint8_t*>(tc_smem + slot * SB) + C::XB + 32 * wn + 4 * gq;
  };
  if constexpr (GA) {
    // Every stage lies in one group (kb and ke are multiples of g, g of 64).
    // A group's first stage is peeled (FIRST), so that at g = 64 each stage
    // runs straight-line code: read the group's scale / zero, start the
    // group's chain from zero, fold it.
    auto group_stage = [&](int s, auto first) {
      constexpr bool FIRST = decltype(first)::value;
      const int slot = next_stage(s);
      const uint8_t* cw = code_rows(slot);
      if constexpr (FIRST) {
        const float* ss = reinterpret_cast<const float*>(tc_smem + slot * SB + C::XB + 32 * CS);
        const float4 sv = *reinterpret_cast<const float4*>(ss + 32 * wn + 4 * gq);
        const float4 zv = *reinterpret_cast<const float4*>(ss + BN + 32 * wn + 4 * gq);
        sc[0] = sv.x, sc[1] = sv.y, sc[2] = sv.z, sc[3] = sv.w;
        zb[0] = bf2_bits(__float2bfloat162_rn(128.f + zv.x));
        zb[1] = bf2_bits(__float2bfloat162_rn(128.f + zv.y));
        zb[2] = bf2_bits(__float2bfloat162_rn(128.f + zv.z));
        zb[3] = bf2_bits(__float2bfloat162_rn(128.f + zv.w));
      }
      repro::wgmma_fence();
      repro::fence_regs(p[0]);
      repro::fence_regs(p[1]);
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        // packed rows 8 kk + cq (k rows 2 cq, 2 cq + 1) and + 4 (k + 8)
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(cw + (8 * kk + cq) * CS);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(cw + (8 * kk + cq + 4) * CS);
        const uint32_t v0 = w0 >> 4, v1 = w1 >> 4;
        const uint32_t a[2][4] = {
            {nib_pair<0>(w0, v0, zb[0]), nib_pair<1>(w0, v0, zb[1]),
             nib_pair<0>(w1, v1, zb[0]), nib_pair<1>(w1, v1, zb[1])},
            {nib_pair<2>(w0, v0, zb[2]), nib_pair<3>(w0, v0, zb[3]),
             nib_pair<2>(w1, v1, zb[2]), nib_pair<3>(w1, v1, zb[3])}};
        const int acc = FIRST && kk == 0 ? 0 : 1;   // a group's chain starts from zero
        repro::wgmma_rs<MT, 0>(p[0], a[0], b_desc(slot, kk), acc);
        repro::wgmma_rs<MT, 0>(p[1], a[1], b_desc(slot, kk), acc);
      }
      repro::wgmma_commit();
      repro::wgmma_wait0();
      repro::fence_regs(p[0]);
      repro::fence_regs(p[1]);
    };
    const int spg = g / TC_BK;        // stages per group
    for (int s = 0; s < n_stages; s += spg) {
      group_stage(s, std::true_type{});
      for (int i = 1; i < spg; ++i) group_stage(s + i, std::false_type{});
#pragma unroll
      for (int t = 0; t < 2; ++t)     // group done: c += scale * p
#pragma unroll
        for (int j = 0; j < MT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            c[t][j][e] = __fmaf_rn(sc[2 * t + (e >> 1)], p[t][j][e], c[t][j][e]);
      chunk_left -= g / 16;
      if (chunk_left == 0 || kb + (s + spg) * TC_BK >= ke) {
        fold_chunk(c);
        chunk_left = chunk / 16;
      }
    }
  } else {
    for (int s = 0; s < n_stages; ++s) {
      const int slot = next_stage(s);
      const int k0 = kb + s * TC_BK;
      const uint8_t* cw = code_rows(slot);
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        const int kg = k0 + 16 * kk;
        if (kg >= ke) break;
        const uint32_t w[2] = {*reinterpret_cast<const uint32_t*>(cw + (8 * kk + cq) * CS),
                               *reinterpret_cast<const uint32_t*>(cw + (8 * kk + cq + 4) * CS)};
        uint32_t a[2][4];
#pragma unroll
        for (int wi = 0; wi < 2; ++wi) {
          const int kr = kg + 8 * wi + 2 * cq;
#pragma unroll
          for (int j4 = 0; j4 < 4; ++j4) {
            const uint32_t byte = (w[wi] >> (8 * j4)) & 0xFF;
            const int col = colq + j4;
            const float lo = col < n ? deq_f32(byte & 0xF, kr, col, scale, zero, n, g, ng) : 0.f;
            const float hi = col < n ? deq_f32(byte >> 4, kr + 1, col, scale, zero, n, g, ng) : 0.f;
            a[j4 >> 1][(j4 & 1) + 2 * wi] = bf2_bits(__floats2bfloat162_rn(lo, hi));
          }
        }
        repro::wgmma_fence();
        repro::fence_regs(p[0]);
        repro::fence_regs(p[1]);
        repro::wgmma_rs<MT, 0>(p[0], a[0], b_desc(slot, kk), 1);
        repro::wgmma_rs<MT, 0>(p[1], a[1], b_desc(slot, kk), 1);
        repro::wgmma_commit();
        repro::wgmma_wait0();
        repro::fence_regs(p[0]);
        repro::fence_regs(p[1]);
        if (--chunk_left == 0 || kg + 16 >= ke) {   // chunk done: total += its sum
          fold_chunk(p);
          chunk_left = chunk / 16;
        }
      }
    }
  }
  repro::cp_async_wait_all();

  // this thread's 4 columns of x row (8 j + 2 cq + e): the chunk total
  auto total4 = [&](int j, int e) -> float4 {
    if constexpr (C::TOT_SMEM) {
      auto at = [&](int t, int ee) { return tot_s[((t * MT + j) * 4 + ee) * THREADS + tid]; };
      return make_float4(at(0, e), at(0, e + 2), at(1, e), at(1, e + 2));
    } else {
      return make_float4(tot[0][j][e], tot[0][j][e + 2], tot[1][j][e], tot[1][j][e + 2]);
    }
  };
  if (!cpb) {
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 8 * j + 2 * cq + e;
        if (col_ok && row < m) {
          const float4 v = total4(j, e);
          store4(out + static_cast<size_t>(row) * n + colq, v.x, v.y, v.z, v.w);
        }
      }
    return;
  }
  // split: the chunk sums are in the scratch; the tile's last block folds
  // every chunk in order and re-arms the counter
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(counters + tile, 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int n_chunks = (k + chunk - 1) / chunk;   // <= TC_MAX_CHUNKS
  for (int i = tid; i < BM * (BN / 4); i += THREADS) {
    const int row = m0 + i / (BN / 4), col = n0 + 4 * (i % (BN / 4));
    if (row >= m || col >= n) continue;
    const float* src = partial + static_cast<size_t>(row) * n + col;
    const size_t step = static_cast<size_t>(m) * n;
    float4 v[TC_MAX_CHUNKS];          // all loads in flight at once, then the sums in order
#pragma unroll
    for (int c2 = 0; c2 < TC_MAX_CHUNKS; ++c2)
      if (c2 < n_chunks) v[c2] = __ldcg(reinterpret_cast<const float4*>(src + c2 * step));
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c2 = 0; c2 < TC_MAX_CHUNKS; ++c2) {
      if (c2 < n_chunks) {
        acc.x = __fadd_rn(acc.x, v[c2].x);
        acc.y = __fadd_rn(acc.y, v[c2].y);
        acc.z = __fadd_rn(acc.z, v[c2].z);
        acc.w = __fadd_rn(acc.w, v[c2].w);
      }
    }
    store4(out + static_cast<size_t>(row) * n + col, acc.x, acc.y, acc.z, acc.w);
  }
  if (tid == 0) counters[tile] = 0;
}

// Shared-memory attributes, set once per kernel and device: the dynamic
// size where it exceeds 48 KB, and the largest shared-memory carveout, so
// that as many blocks fit an SM as the registers allow.
template <class C, bool GA>
cudaError_t prepare_tc() {
  static unsigned done = 0;         // bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (done >> dev & 1u)) return e;
  e = cudaFuncSetAttribute(qmm_tc<C, GA>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(qmm_tc<C, GA>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done |= 1u << dev;
  return e;
}

template <class C, bool GA>
int launch_tc(const void* x, const void* codes, const void* scale, const void* zero, void* out,
              void* partial, void* counters, int m, int k, int n, int g, int ng, int chunk,
              int cpb, cudaStream_t stream) {
  const cudaError_t e = prepare_tc<C, GA>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_chunks = (k + chunk - 1) / chunk;
  const dim3 grid((n + C::BN - 1) / C::BN, cpb ? (n_chunks + cpb - 1) / cpb : 1, (m + C::BM - 1) / C::BM);
  qmm_tc<C, GA><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<bf16*>(out), static_cast<float*>(partial), static_cast<int*>(counters), m, k,
      n, g, ng, chunk, cpb);
  return static_cast<int>(cudaGetLastError());
}

template <bool GA>
int launch_cfg(int cfg, const void* x, const void* codes, const void* scale, const void* zero,
               void* out, void* partial, void* counters, int m, int k, int n, int g, int ng,
               int chunk, int cpb, cudaStream_t s) {
  switch (cfg) {
    case 0: return launch_tc<Cfg0, GA>(x, codes, scale, zero, out, partial, counters, m, k, n, g, ng, chunk, cpb, s);
    case 1: return launch_tc<Cfg1, GA>(x, codes, scale, zero, out, partial, counters, m, k, n, g, ng, chunk, cpb, s);
    case 2: return launch_tc<Cfg2, GA>(x, codes, scale, zero, out, partial, counters, m, k, n, g, ng, chunk, cpb, s);
    case 3: return launch_tc<Cfg3, GA>(x, codes, scale, zero, out, partial, counters, m, k, n, g, ng, chunk, cpb, s);
#ifdef QMM_PROBE_MT
    case 4: return launch_tc<CfgProbe, GA>(x, codes, scale, zero, out, partial, counters, m, k, n, g, ng, chunk, cpb, s);
#endif
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int quant_matmul_kchunk() { return KC; }
extern "C" int quant_matmul_skinny_max_m() { return SK_MAXM; }
// The bf16 kernel's geometry, for the wrapper to check its own against:
// x rows and columns of configs 0..3, the most chunks, the k step.
extern "C" void quant_matmul_geometry(int* out) {
  const int g[10] = {Cfg0::BM, Cfg0::BN, Cfg1::BM, Cfg1::BN, Cfg2::BM,
                     Cfg2::BN, Cfg3::BM, Cfg3::BN, TC_MAX_CHUNKS, TC_BK};
  for (int i = 0; i < 10; ++i) out[i] = g[i];
}

// x_is_bf16: the tensor-core kernel, which needs n % 16 == 0, k % 8 == 0
// and 16-byte aligned tensors (the wrapper pads other shapes); ng = rows of
// scale / zero; chunk = the fold's k rows per chunk (a multiple of 16, and
// of g when g % 64 == 0); cfg picks the tile (0..3: 8, 16, 32 x rows by 128
// columns with 4 warps, 64 by 256 with 8).  cpb > 0 splits k: each block
// sums cpb consecutive chunks and writes each chunk's sum to partial
// (chunks x m x n f32); the last block of each tile, found by counters (one
// int per tile, zero, left zero), folds them in order.  Otherwise f32 x on
// the CUDA cores: partial is f32 scratch of ceil(k / KC) * m * n floats
// when m <= 8, and counters, ng, chunk, cfg and cpb are not read.
extern "C" int quant_matmul_launch(const void* x, const void* codes, const void* scale,
                                   const void* zero, void* out, void* partial, void* counters,
                                   int m, int k, int n, int g, int ng, int chunk, int cfg,
                                   int cpb, int x_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_is_bf16) return launch<float>(x, codes, scale, zero, out, partial, m, k, n, g, s);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(codes) |
                         reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(zero) |
                         reinterpret_cast<uintptr_t>(out);
  const bool ga = g % TC_BK == 0;
  if (n % 16 != 0 || k % 8 != 0 || addr % 16 != 0 || chunk <= 0 || chunk % 16 != 0 ||
      (ga && chunk % g != 0) || cpb < 0 || (k + chunk - 1) / chunk > TC_MAX_CHUNKS ||
      (cpb > 0 && (partial == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ga)
    return launch_cfg<true>(cfg, x, codes, scale, zero, out, partial, counters, m, k, n, g, ng,
                            chunk, cpb, s);
  return launch_cfg<false>(cfg, x, codes, scale, zero, out, partial, counters, m, k, n, g, ng,
                           chunk, cpb, s);
}
