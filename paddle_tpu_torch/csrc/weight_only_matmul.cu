// Weight-only GEMMs (int4 and int8) for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernels `_int4_kernel`
// (paddle_tpu/ops/pallas/quant_matmul.py:77) and `_int8_kernel` (:65),
// both reached through `weight_only_matmul` (pallas_call at :138):
//   out[M, N] = (x[M, K] @ dequant(w)) * scales[N]
// products summed in f32, the per-column scale applied once after the
// whole sum, the result written in x's dtype.
//
// int4 weight layout: the BLOCK-HALVED nibbles of `pack_int4_blocked`
// (quant_matmul.py:95-115). Within each block_n column block, byte c of
// the block's block_n/2 bytes holds column c in its low nibble and
// column c + block_n/2 in its high nibble. This is not the even/odd
// interleave of `quantize_int4`. A nibble u sign-extends as
// ((u & 0xF) ^ 8) - 8. int8 weight layout: plain [K, N] int8, one byte
// per column. Both are the JAX engine's bytes; nothing is re-laid out.
//
// Two bodies share the column tiling. A block owns BM rows and BN output
// columns: for int8 BN consecutive columns; for int4 BN/2 packed bytes a
// K row, whose low nibbles are BN/2 consecutive columns and whose high
// nibbles the BN/2 columns half a block_n further on, so every packed
// byte is read once per M tile and both of its nibbles are used.
//
// bf16 / fp16 activations: the tensor-core body (`int8_kernel_mma`,
// `int4_kernel_mma`). Four warps; BM = 16 at M <= 16 (decode), 64 above;
// BN from `pick_bn`. A ring of NS stages (4 at BM 16, 3 at BM 64) holds,
// per 64-deep K slice, the x tile [BM][64] (16-bit, cp.async when rows
// are 16-byte aligned, element loads otherwise) and the weight tile's raw
// bytes (cp.async, 16 bytes a thread), so that NS - 1 stages of weight
// bytes are in flight while one is multiplied. A stage's bytes are dequantized exactly to
// bf16 / fp16 by byte permutes (the magic-exponent trick: a byte or
// nibble becomes the mantissa of a float whose offset is subtracted)
// into one padded [64][BN + 8] 16-bit tile, from which `ldmatrix.trans`
// takes the B fragments of `mma.sync` m16n8k16 with f32 accumulators
// (csrc/mma_tiles.cuh). Only the quantized bytes cross HBM: no float copy
// of w exists in device memory.
//
// Split over K. At decode M the grid has few column tiles (8 for a
// 1024-wide projection at BN = 128) against 132 SMs. When the unsplit
// grid is below one wave, the plan (`make_plan`, exported as
// `weight_only_plan`) splits K into S slices, S the nearest count to
// cover the card TC_WAVES times with the grid (M tiles x N tiles x S),
// every slice a multiple of 64 deep and at least 128. A grid of a wave or more
// does not split: there the workspace traffic and the last blocks' sums
// cost more than the idle SMs of a partial last wave. At S = 1 a block scales its accumulators and writes the output.
// At S > 1 each block writes its f32 partial tile to a workspace [S, M,
// N] and counts itself in the tile's counter (zeroed by the launcher
// with cudaMemsetAsync); after a __threadfence() the block that arrives
// last sums the S partials in split order 0..S-1, scales, casts and
// writes. A call is one kernel launch, and two calls give bit-equal
// outputs.
//
// What bounds it on an H100: at decode M the bytes (K*N int8 or K*N/2
// int4 weight bytes against 2*M*K*N flops, a few flops per byte: 1.7 us
// for the 5.8 MB of an int8 ffn1 at 3.35 TB/s), so the ring keeps bytes
// in flight and the split fills the card; at prefill M (512) the
// operations (5.9 GFLOP at M=512, K=1024, N=5632: 6 us at 989 TFLOP/s),
// which run on the tensor cores from the dequantized tile, converted
// once per M tile. Measured (PERF.md §6), a decode call is held by a
// fixed cost of some 6-7 us rather than its bytes (the counter memset,
// the launch, a ring that a 128-384-row slice never fills, the split
// sum), and prefill reaches about a fifth of the tensor-core peak.
//
// f32 activations: the CUDA-core body (`int8_kernel`, `int4_kernel`):
// each K slice of 32 staged in shared memory as f32, each of 256 threads
// accumulating a (BM/16) x 8 patch of outputs on CUDA cores; one block
// per 128 columns and BM rows, no split.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int NT = 256;   // 16 x 16 threads
constexpr int BK = 32;    // K slice per stage
constexpr int BB = 64;    // packed bytes per tile (128 output columns)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

__device__ __forceinline__ float nib(uint32_t u) {
  return (float)((int)((u & 0xFu) ^ 8u) - 8);
}

// Tile of the block's 128 output columns: [lo0, lo0 + 64) then
// [hi0, hi0 + 64). int4: the low-nibble strip and the high-nibble strip
// half a block_n further on; int8: 128 consecutive columns.
template <bool INT4>
__device__ __forceinline__ void column_tile(int tile, int block_n, int& lo0,
                                            int& hi0) {
  if (INT4) {
    const int half = block_n / 2;
    const int b0 = tile * BB;               // first packed byte of the tile
    lo0 = (b0 / half) * block_n + b0 % half;
    hi0 = lo0 + half;
  } else {
    lo0 = tile * 2 * BB;
    hi0 = lo0 + BB;
  }
}

template <typename T, int BM, bool INT4>
__device__ __forceinline__ void wo_body(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scales, T* __restrict__ out, int M, int K,
    int N, int block_n) {
  constexpr int TM = BM / 16;
  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][2 * BB];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  int lo0, hi0;
  column_tile<INT4>(blockIdx.x, block_n, lo0, hi0);
  // bytes per K row of w, and the tile's first byte in a row
  const int row_bytes = INT4 ? N / 2 : N;
  const int c0 = INT4 ? blockIdx.x * BB : lo0;
  constexpr int TILE_BYTES = INT4 ? BB : 2 * BB;

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x slice [BM, BK]
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, kk = i % BK;
      const int m = m0 + r, k = k0 + kk;
      xs[r][kk] = (m < M && k < K) ? to_f(x[(size_t)m * K + k]) : 0.f;
    }
    // weight slice [BK, TILE_BYTES] bytes, read as 32-bit words
    for (int i = tid; i < BK * TILE_BYTES / 4; i += NT) {
      const int kk = i / (TILE_BYTES / 4), c4 = (i % (TILE_BYTES / 4)) * 4;
      const int k = k0 + kk;
      uint32_t word = 0;
      if (k < K) {
        word = *reinterpret_cast<const uint32_t*>(
            w + (size_t)k * row_bytes + c0 + c4);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t byte = (word >> (8 * e)) & 0xFFu;
        if (INT4) {
          ws[kk][c4 + e] = nib(byte);            // low nibble: low strip
          ws[kk][BB + c4 + e] = nib(byte >> 4);  // high nibble: high strip
        } else {
          ws[kk][c4 + e] = (float)(int8_t)byte;
        }
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bcol[8];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) bcol[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * bcol[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = (j < 4 ? lo0 : hi0) + tx + 16 * (j % 4);
    const float s = scales[n];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m < M) out[(size_t)m * N + n] = from_f<T>(acc[i][j] * s);
    }
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(NT)
int4_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scales, T* __restrict__ out, int M,
            int K, int N, int block_n) {
  wo_body<T, BM, true>(x, w, scales, out, M, K, N, block_n);
}

template <typename T, int BM>
__global__ void __launch_bounds__(NT)
int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scales, T* __restrict__ out, int M,
            int K, int N, int block_n) {
  wo_body<T, BM, false>(x, w, scales, out, M, K, N, block_n);
}

template <typename T, bool INT4>
int launch_t(const void* x, const int8_t* w, const float* scales, void* out,
             int M, int K, int N, int block_n, cudaStream_t stream) {
  // both modes: one block per 128 output columns and BM rows
  if (M <= 16) {
    dim3 grid(N / (2 * BB), (M + 15) / 16);
    auto kern = INT4 ? &int4_kernel<T, 16> : &int8_kernel<T, 16>;
    kern<<<grid, NT, 0, stream>>>((const T*)x, w, scales, (T*)out, M, K, N,
                                  block_n);
  } else {
    dim3 grid(N / (2 * BB), (M + 63) / 64);
    auto kern = INT4 ? &int4_kernel<T, 64> : &int8_kernel<T, 64>;
    kern<<<grid, NT, 0, stream>>>((const T*)x, w, scales, (T*)out, M, K, N,
                                  block_n);
  }
  return (int)cudaGetLastError();
}


// -- the tensor-core body (bf16 / fp16 activations) --------------------------

constexpr int TC_NT = 128;       // four warps
constexpr int TC_BK = 64;        // K rows per stage
constexpr int SLICE_MIN = 128;   // shallowest K slice of a split
constexpr int TC_WAVES = 2;      // knob two's rule: a split grid covers the SMs this often

template <int BM, int BN, bool INT4>
struct TcShape {
  static constexpr int TILE_BYTES = INT4 ? BN / 2 : BN;   // weight bytes per K row
  static constexpr int WARPS_M = BM >= 32 ? BM / 32 : 1;
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MI = WM / 16, NI = WN / 8;          // 16 x 8 products a warp
  // stages in the ring: four at decode M, where bytes in flight are the
  // limit; three at BM 64, so that three blocks fit an SM
  static constexpr int NS = BM == 16 ? 4 : 3;
  static constexpr int LDX = TC_BK + 8, LDW = BN + 8;      // padded rows (16 bytes)
  static constexpr int X_STAGE = BM * LDX * 2;             // bytes (16-bit x)
  static constexpr int B_STAGE = TC_BK * TILE_BYTES;       // bytes
  static constexpr int SMEM = NS * (X_STAGE + B_STAGE) + TC_BK * LDW * 2;
  static_assert(NI % 2 == 0 && MI >= 1, "whole 16-column B fragments");
  static_assert(TILE_BYTES % 16 == 0, "16-byte weight chunks");
  static_assert((TC_BK * TILE_BYTES / 16) % TC_NT == 0, "whole chunks per thread");
  static_assert((BM * TC_BK / 8) % TC_NT == 0, "whole x chunks per thread");
};

// First output column of the tile's two halves: tile column c < BN/2 is
// column lo0 + c, c >= BN/2 is hi0 + c - BN/2. int4: the low-nibble
// strip and the high-nibble strip half a block_n further on; int8: BN
// consecutive columns.
template <bool INT4, int BN>
__device__ __forceinline__ void tc_column_tile(int tile, int block_n, int& lo0, int& hi0) {
  if (INT4) {
    const int half = block_n / 2;
    const int b0 = tile * (BN / 2);         // first packed byte of the tile
    lo0 = (b0 / half) * block_n + b0 % half;
    hi0 = lo0 + half;
  } else {
    lo0 = tile * BN;
    hi0 = lo0 + BN / 2;
  }
}

__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b, __half) {
  const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&a),
                            *reinterpret_cast<const __half2*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b, __nv_bfloat16) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Four int8 values (the bytes of w) -> two packed pairs of T, exactly.
// fp16: byte b + 128 as the low mantissa bits of 1024.0, minus 1152.
// bf16 (7 mantissa bits): b's low 7 bits as the mantissa of 128.0, minus
// 256.0 where b is negative (its sign bit as the lowest exponent bit of
// 128.0), else minus 128.0.
__device__ __forceinline__ void int8x4(uint32_t w, uint32_t& p01, uint32_t& p23, __half) {
  const uint32_t u = w ^ 0x80808080u;
  p01 = sub2(__byte_perm(u, 0x64646464u, 0x4140), 0x64806480u, __half());
  p23 = sub2(__byte_perm(u, 0x64646464u, 0x4342), 0x64806480u, __half());
}
__device__ __forceinline__ void int8x4(uint32_t w, uint32_t& p01, uint32_t& p23,
                                       __nv_bfloat16) {
  const uint32_t lo7 = w & 0x7F7F7F7Fu, sign = w & 0x80808080u;
  p01 = sub2(__byte_perm(lo7, 0x43434343u, 0x4140), __byte_perm(sign, 0x43434343u, 0x4140),
             __nv_bfloat16());
  p23 = sub2(__byte_perm(lo7, 0x43434343u, 0x4342), __byte_perm(sign, 0x43434343u, 0x4342),
             __nv_bfloat16());
}

// Eight int4 values (the nibbles of w's four bytes) -> the low nibbles'
// two pairs and the high nibbles' two pairs of T, exactly: n ^ 8 as the
// low mantissa bits of 1024.0 (fp16) or 128.0 (bf16), minus 1032 / 136.
template <typename T>
__device__ __forceinline__ void int4x8(uint32_t w, uint32_t (&lo)[2], uint32_t (&hi)[2]) {
  constexpr bool H = std::is_same<T, __half>::value;
  const uint32_t mag = H ? 0x64646464u : 0x43434343u;
  const uint32_t off = H ? 0x64086408u : 0x43084308u;
  const uint32_t v = w ^ 0x88888888u;
  const uint32_t l = v & 0x0F0F0F0Fu, h = (v >> 4) & 0x0F0F0F0Fu;
  lo[0] = sub2(__byte_perm(l, mag, 0x4140), off, T());
  lo[1] = sub2(__byte_perm(l, mag, 0x4342), off, T());
  hi[0] = sub2(__byte_perm(h, mag, 0x4140), off, T());
  hi[1] = sub2(__byte_perm(h, mag, 0x4342), off, T());
}

template <typename T, int BM, int BN, bool INT4>
__device__ __forceinline__ void wo_mma_body(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scales, T* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ counters, int M, int K, int N, int block_n, int kslice,
    int nsplit, bool x_async) {
  using S = TcShape<BM, BN, INT4>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xring = smem;                                // [NS][BM][LDX] T
  unsigned char* bring = smem + S::NS * S::X_STAGE;           // [NS][BK][TILE_BYTES]
  T* wq = reinterpret_cast<T*>(bring + S::NS * S::B_STAGE);   // [BK][LDW]
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / S::WARPS_N, wn = warp % S::WARPS_N;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int kbeg = split * kslice;
  const int kend = min(K, kbeg + kslice);
  const int nst = (kend - kbeg + TC_BK - 1) / TC_BK;
  int lo0, hi0;
  tc_column_tile<INT4, BN>(blockIdx.x, block_n, lo0, hi0);
  const int row_bytes = INT4 ? N / 2 : N;
  const int c0 = INT4 ? blockIdx.x * S::TILE_BYTES : lo0;     // the tile's first byte

  // stage st (rows kbeg + 64 st ..) into ring slot `slot`; rows past the
  // slice and x rows past M are zero-filled
  auto load_stage = [&](int st, int slot) {
    const int k0 = kbeg + st * TC_BK;
    unsigned char* bd = bring + slot * S::B_STAGE;
    constexpr int CPR = S::TILE_BYTES / 16;
#pragma unroll
    for (int it = 0; it < TC_BK * CPR / TC_NT; ++it) {
      const int i = tid + it * TC_NT;
      const int r = i / CPR, c = i % CPR, k = k0 + r;
      const bool live = k < kend;
      cp_async16(bd + r * S::TILE_BYTES + c * 16,
                 live ? w + (size_t)k * row_bytes + c0 + c * 16 : w, live);
    }
    T* xd = reinterpret_cast<T*>(xring + slot * S::X_STAGE);
    if (x_async) {
      constexpr int XC = TC_BK / 8;
#pragma unroll
      for (int it = 0; it < BM * XC / TC_NT; ++it) {
        const int i = tid + it * TC_NT;
        const int r = i / XC, c = i % XC, m = m0 + r, k = k0 + c * 8;
        const bool live = m < M && k < kend;
        cp_async16(xd + r * S::LDX + c * 8, live ? x + (size_t)m * K + k : x, live);
      }
    } else {
      for (int i = tid; i < BM * TC_BK; i += TC_NT) {
        const int r = i / TC_BK, c = i % TC_BK, m = m0 + r, k = k0 + c;
        xd[r * S::LDX + c] = (m < M && k < kend) ? x[(size_t)m * K + k] : from_f<T>(0.f);
      }
    }
  };

  // ring slot `slot`'s weight bytes -> the 16-bit tile wq
  auto dequant = [&](int slot) {
    const unsigned char* bs = bring + slot * S::B_STAGE;
    constexpr int CPR = S::TILE_BYTES / 16;
#pragma unroll
    for (int it = 0; it < TC_BK * CPR / TC_NT; ++it) {
      const int i = tid + it * TC_NT;
      const int r = i / CPR, c = i % CPR;
      const uint4 q = *reinterpret_cast<const uint4*>(bs + r * S::TILE_BYTES + c * 16);
      const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
      T* row = wq + r * S::LDW + c * 16;
      if (INT4) {
        uint32_t lo[8], hi[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t l2[2], h2[2];
          int4x8<T>(wd[j], l2, h2);
          lo[2 * j] = l2[0]; lo[2 * j + 1] = l2[1];
          hi[2 * j] = h2[0]; hi[2 * j + 1] = h2[1];
        }
        *reinterpret_cast<uint4*>(row) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(row + 8) = make_uint4(lo[4], lo[5], lo[6], lo[7]);
        *reinterpret_cast<uint4*>(row + BN / 2) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(row + BN / 2 + 8) = make_uint4(hi[4], hi[5], hi[6], hi[7]);
      } else {
        uint32_t p[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) int8x4(wd[j], p[2 * j], p[2 * j + 1], T());
        *reinterpret_cast<uint4*>(row) = make_uint4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<uint4*>(row + 8) = make_uint4(p[4], p[5], p[6], p[7]);
      }
    }
  };

  float acc[S::MI][S::NI][4];
#pragma unroll
  for (int i = 0; i < S::MI; ++i)
#pragma unroll
    for (int j = 0; j < S::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < S::NS - 1; ++s) {
    if (s < nst) load_stage(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<S::NS - 2>();     // stage st has landed
    __syncthreads();                // and every warp is done with stage st - 1
    const int nx = st + S::NS - 1;
    if (nx < nst) load_stage(nx, nx % S::NS);
    cp_async_commit();
    dequant(st % S::NS);
    __syncthreads();
    const T* xs = reinterpret_cast<const T*>(xring + (st % S::NS) * S::X_STAGE);
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      uint32_t a[S::MI][4];
#pragma unroll
      for (int i = 0; i < S::MI; ++i) frag_a(a[i], xs, S::LDX, wm * S::WM + 16 * i, kk);
#pragma unroll
      for (int j = 0; j < S::NI; j += 2) {
        uint32_t b[4];
        frag_b2_t(b, wq, S::LDW, wn * S::WN + 8 * j, kk);
#pragma unroll
        for (int i = 0; i < S::MI; ++i) {
          mma16816<T>(acc[i][j], a[i], b[0], b[1]);
          mma16816<T>(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator (i, j, e): row wm WM + 16 i + g (+ 8 for e >= 2), tile
  // column wn WN + 8 j + 2 t (+ 1 for odd e)
  const int g = lane / 4, t = lane % 4;
  auto column = [&](int c) { return c < BN / 2 ? lo0 + c : hi0 + c - BN / 2; };
  if (nsplit == 1) {
#pragma unroll
    for (int j = 0; j < S::NI; ++j) {
      const int n = column(wn * S::WN + 8 * j + 2 * t);
      const float s0 = scales[n], s1 = scales[n + 1];
#pragma unroll
      for (int i = 0; i < S::MI; ++i) {
        const int m = m0 + wm * S::WM + 16 * i + g;
        if (m < M)
          *reinterpret_cast<uint32_t*>(out + (size_t)m * N + n) =
              pack2<T>(acc[i][j][0] * s0, acc[i][j][1] * s1);
        if (m + 8 < M)
          *reinterpret_cast<uint32_t*>(out + (size_t)(m + 8) * N + n) =
              pack2<T>(acc[i][j][2] * s0, acc[i][j][3] * s1);
      }
    }
    return;
  }

  // S > 1: this split's f32 partial, then the last block of the tile sums
  float* part = ws + (size_t)split * M * N;
#pragma unroll
  for (int j = 0; j < S::NI; ++j) {
    const int n = column(wn * S::WN + 8 * j + 2 * t);
#pragma unroll
    for (int i = 0; i < S::MI; ++i) {
      const int m = m0 + wm * S::WM + 16 * i + g;
      if (m < M)
        *reinterpret_cast<float2*>(part + (size_t)m * N + n) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (m + 8 < M)
        *reinterpret_cast<float2*>(part + (size_t)(m + 8) * N + n) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(counters + blockIdx.y * gridDim.x + blockIdx.x, 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  constexpr int QPR = BN / 4;                       // 4-column groups per row
  for (int i = tid; i < BM * QPR; i += TC_NT) {
    const int r = i / QPR, m = m0 + r;
    if (m >= M) continue;
    const int n = column((i % QPR) * 4);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = 0; sp < nsplit; ++sp) {         // split order: deterministic
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          ws + ((size_t)sp * M + m) * N + n));
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    uint2 o;
    o.x = pack2<T>(sum.x * scales[n], sum.y * scales[n + 1]);
    o.y = pack2<T>(sum.z * scales[n + 2], sum.w * scales[n + 3]);
    *reinterpret_cast<uint2*>(out + (size_t)m * N + n) = o;
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(TC_NT)
int8_kernel_mma(const T* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scales, T* __restrict__ out,
                float* __restrict__ ws, int* __restrict__ counters, int M, int K,
                int N, int block_n, int kslice, int nsplit, bool x_async) {
  wo_mma_body<T, BM, BN, false>(x, w, scales, out, ws, counters, M, K, N, block_n,
                                kslice, nsplit, x_async);
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(TC_NT)
int4_kernel_mma(const T* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scales, T* __restrict__ out,
                float* __restrict__ ws, int* __restrict__ counters, int M, int K,
                int N, int block_n, int kslice, int nsplit, bool x_async) {
  wo_mma_body<T, BM, BN, true>(x, w, scales, out, ws, counters, M, K, N, block_n,
                               kslice, nsplit, x_async);
}

// -- the plan ----------------------------------------------------------------

struct Plan {
  int bm, bn, nsplit, kslice, mtiles, ntiles;
  long long blocks, ws_bytes;
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Knob one: the column tile. The rule: 128 unless the grid of 128-wide
// tiles leaves SMs idle (decode M), then 64.
int pick_bn(int M, int N, int bm, int sms) {
  return cdiv(M, bm) * (N / 128) < sms ? 64 : 128;
}

// The plan of the tensor-core body. `bn` (64 or 128) and `waves` (>= 1)
// override the two knobs, 0 keeps each one's rule; the f32 body takes
// neither.
Plan make_plan(int M, int K, int N, int dtype, int sms, int bn, int waves) {
  Plan p{};
  p.bm = M <= 16 ? 16 : 64;
  p.bn = dtype == 0 ? 128 : bn ? bn : pick_bn(M, N, p.bm, sms);
  if (waves == 0 || dtype == 0) waves = TC_WAVES;
  p.mtiles = cdiv(M, p.bm);
  p.ntiles = N / p.bn;
  p.nsplit = 1;
  p.kslice = K;
  const long long tiles = (long long)p.mtiles * p.ntiles;
  if (dtype != 0 && tiles < sms) {      // the unsplit grid leaves SMs idle
    // the split nearest `waves` waves (a grid just short of one wave
    // takes 2 splits, not 3)
    int s = (int)(((long long)waves * sms + tiles / 2) / tiles);
    const int smax = K / SLICE_MIN;
    if (s > smax) s = smax;
    if (s > 1) {
      int ks = cdiv(cdiv(K, s), TC_BK) * TC_BK;
      if (ks < SLICE_MIN) ks = SLICE_MIN;
      p.kslice = ks;
      p.nsplit = cdiv(K, ks);
    }
  }
  p.blocks = tiles * p.nsplit;
  p.ws_bytes = p.nsplit > 1 ? (long long)p.nsplit * M * N * 4 + tiles * 4 : 0;
  return p;
}

template <typename T, int BM, int BN, bool INT4>
int launch_mma(const Plan& p, const void* x, const int8_t* w, const float* scales,
               void* out, void* ws, int M, int K, int N, int block_n,
               cudaStream_t stream) {
  using S = TcShape<BM, BN, INT4>;
  auto kern = INT4 ? &int4_kernel_mma<T, BM, BN> : &int8_kernel_mma<T, BM, BN>;
  // the dynamic shared-memory limit, once per device: the static s_last
  // counts against the default 48 KB too
  static bool wide[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(dev < 64 && wide[dev])) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) wide[dev] = true;
  }
  float* wsp = nullptr;
  int* counters = nullptr;
  if (p.nsplit > 1) {
    wsp = (float*)ws;
    counters = (int*)((char*)ws + (size_t)p.nsplit * M * N * 4);
    const cudaError_t e = cudaMemsetAsync(
        counters, 0, (size_t)p.mtiles * p.ntiles * sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
  }
  const bool x_async = K % 8 == 0 && (uintptr_t)x % 16 == 0;
  dim3 grid(p.ntiles, p.mtiles, p.nsplit);
  kern<<<grid, TC_NT, S::SMEM, stream>>>((const T*)x, w, scales, (T*)out, wsp, counters,
                                         M, K, N, block_n, p.kslice, p.nsplit, x_async);
  return (int)cudaGetLastError();
}

template <typename T, bool INT4>
int launch_tc(const Plan& p, const void* x, const int8_t* w, const float* scales,
              void* out, void* ws, int M, int K, int N, int block_n,
              cudaStream_t stream) {
  if (p.bm == 16 && p.bn == 64)
    return launch_mma<T, 16, 64, INT4>(p, x, w, scales, out, ws, M, K, N, block_n, stream);
  if (p.bm == 16)
    return launch_mma<T, 16, 128, INT4>(p, x, w, scales, out, ws, M, K, N, block_n, stream);
  if (p.bn == 64)
    return launch_mma<T, 64, 64, INT4>(p, x, w, scales, out, ws, M, K, N, block_n, stream);
  return launch_mma<T, 64, 128, INT4>(p, x, w, scales, out, ws, M, K, N, block_n, stream);
}

bool bad_sizes(int M, int K, int N, int block_n, int dtype, int sms) {
  return M < 0 || K <= 0 || N <= 0 || block_n <= 0 || block_n % 128 != 0 ||
         N % block_n != 0 || dtype < 0 || dtype > 2 || sms <= 0;
}

bool bad_knobs(int bn, int waves) {
  return !(bn == 0 || bn == 64 || bn == 128) || waves < 0 || waves > 64;
}

template <bool INT4>
int launch(int dtype, const void* x, const void* w, const void* scales, void* out,
           int M, int K, int N, int block_n, void* ws, long long ws_bytes, int sms,
           int bn, int waves, void* stream) {
  if (bad_sizes(M, K, N, block_n, dtype, sms) || bad_knobs(bn, waves))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* wp = (const int8_t*)w;
  const float* sp = (const float*)scales;
  if (dtype == 0) return launch_t<float, INT4>(x, wp, sp, out, M, K, N, block_n, s);
  const Plan p = make_plan(M, K, N, dtype, sms, bn, waves);
  if (p.ws_bytes > 0 && (ws == nullptr || ws_bytes < p.ws_bytes))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_tc<__nv_bfloat16, INT4>(p, x, wp, sp, out, ws, M, K, N, block_n, s);
  return launch_tc<__half, INT4>(p, x, wp, sp, out, ws, M, K, N, block_n, s);
}

}  // namespace

extern "C" {

// The argument list of the entry points below: 2 since the plan's knobs
// became launch arguments (a build without this symbol takes none).
int weight_only_matmul_abi() { return 2; }

// dtype: 0 float32, 1 bfloat16, 2 float16 (x and out). w is the packed
// [K, N/2] int8 array, 16-byte aligned; scales [N] float32. block_n must
// be a multiple of 128 that divides N. `ws` holds at least the plan's
// workspace bytes (null when the plan has none); sms is the card's SM
// count the plan was made for, `bn` / `waves` its two knobs (0: the
// rule; weight_only_plan gives the plan they make). Returns the CUDA
// error code of the launch.
int weight_only_int4_launch(int dtype, const void* x, const void* w,
                            const void* scales, void* out, int M, int K, int N,
                            int block_n, void* ws, long long ws_bytes, int sms,
                            int bn, int waves, void* stream) {
  return launch<true>(dtype, x, w, scales, out, M, K, N, block_n, ws, ws_bytes, sms,
                      bn, waves, stream);
}

// The same for int8: w is the [K, N] int8 array, 16-byte aligned. The
// tiles do not depend on block_n; it is checked as the TPU kernel's grid
// needs it (a multiple of 128 dividing N).
int weight_only_int8_launch(int dtype, const void* x, const void* w,
                            const void* scales, void* out, int M, int K, int N,
                            int block_n, void* ws, long long ws_bytes, int sms,
                            int bn, int waves, void* stream) {
  return launch<false>(dtype, x, w, scales, out, M, K, N, block_n, ws, ws_bytes, sms,
                       bn, waves, stream);
}

// The launch plan, the same for both modes, for x [M, K] of `dtype`
// against a weight of N columns on a card with `sms` SMs, with the knobs
// `bn` and `waves` (0: the rule): out[0] BM, [1] BN, [2] S (K splits),
// [3] blocks, [4] workspace bytes the caller allocates. Returns 5, or -1
// on bad sizes or knobs.
int weight_only_plan(int M, int K, int N, int dtype, int sms, int bn, int waves,
                     long long* out) {
  if (bad_sizes(M, K, N, 128, dtype, sms) || N % 128 != 0 || bad_knobs(bn, waves))
    return -1;
  const Plan p = make_plan(M, K, N, dtype, sms, bn, waves);
  out[0] = p.bm;
  out[1] = p.bn;
  out[2] = p.nsplit;
  out[3] = p.blocks;
  out[4] = p.ws_bytes;
  return 5;
}

}  // extern "C"
