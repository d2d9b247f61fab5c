// Weight-only GEMMs (int4 and int8) for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernels `_int4_kernel`
// (paddle_tpu/ops/pallas/quant_matmul.py:77) and `_int8_kernel` (:65),
// both reached through `weight_only_matmul` (pallas_call at :138):
//   out[M, N] = (x[M, K] @ dequant(w)) * scales[N]
// accumulated in f32, written in x's dtype.
//
// int4 weight layout: the BLOCK-HALVED nibbles of `pack_int4_blocked`
// (quant_matmul.py:95-115). Within each block_n column block, byte c of
// the block's block_n/2 bytes holds column c in its low nibble and
// column c + block_n/2 in its high nibble. This is not the even/odd
// interleave of `quantize_int4`. A nibble u sign-extends as
// ((u & 0xF) ^ 8) - 8. int8 weight layout: plain [K, N] int8, one byte
// per column; the TPU kernel converts it to the compute dtype (exact in
// bf16) before the product, which is what reading it as f32 here is.
//
// Design. The TPU kernel keeps M whole (quant_matmul.py:142): its M is
// the decode batch. Here M is not only the decode batch: the serving
// step hands the projection [B*C, E] rows (512 at 8 slots and 64-token
// prefill chunks), so the kernel tiles M as well as N. A block owns BM
// rows and 128 output columns. For int4 that is one tile of 64 packed
// bytes per K row: 64 consecutive columns from the low nibbles and the
// 64 columns half a block_n further on from the high nibbles, so every
// packed byte is read once per M tile and both of its nibbles are used.
// For int8 it is 128 consecutive bytes per K row. The K loop stages a
// [BM, 32] slice of x and the matching [32, 128] slice of weight values
// in shared memory as f32; each of the 256 threads accumulates a
// (BM/16) x 8 patch of outputs in f32 registers, and the per-column scale
// is applied once in the epilogue. Decode-sized M (<= 16) uses BM = 16,
// larger M uses BM = 64. The two modes share that body and differ only
// in how a K row's tile of bytes becomes 128 weight values.
//
// What bounds it: at decode M the bytes (K*N/2 int4 or K*N int8 weight
// bytes against 2*M*K*N flops: a few flops per byte), so the design
// streams only the quantized bytes and converts them in registers; no
// float copy of w exists in device memory. At prefill M = 512 the
// products dominate; this kernel runs them on CUDA cores in f32, not on
// the tensor cores (wgmma and TMA are later work).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

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

template <bool INT4>
int launch(int dtype, const void* x, const void* w, const void* scales,
           void* out, int M, int K, int N, int block_n, void* stream) {
  if (block_n <= 0 || block_n % (2 * BB) != 0 || N % block_n != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* wp = (const int8_t*)w;
  const float* sp = (const float*)scales;
  switch (dtype) {
    case 0: return launch_t<float, INT4>(x, wp, sp, out, M, K, N, block_n, s);
    case 1: return launch_t<__nv_bfloat16, INT4>(x, wp, sp, out, M, K, N, block_n, s);
    case 2: return launch_t<__half, INT4>(x, wp, sp, out, M, K, N, block_n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16 (x and out). w is the packed
// [K, N/2] int8 array, scales [N] float32. block_n must be a multiple of
// 128 that divides N. Returns the CUDA error code of the launch.
int weight_only_int4_launch(int dtype, const void* x, const void* w,
                            const void* scales, void* out, int M, int K,
                            int N, int block_n, void* stream) {
  return launch<true>(dtype, x, w, scales, out, M, K, N, block_n, stream);
}

// The same for int8: w is the [K, N] int8 array, 4-byte aligned. The
// kernel's tiles do not depend on block_n; it is checked as the TPU
// kernel's grid needs it (a multiple of 128 dividing N).
int weight_only_int8_launch(int dtype, const void* x, const void* w,
                            const void* scales, void* out, int M, int K,
                            int N, int block_n, void* stream) {
  return launch<false>(dtype, x, w, scales, out, M, K, N, block_n, stream);
}

}  // extern "C"
