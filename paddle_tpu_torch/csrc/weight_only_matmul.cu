// int4 weight-only GEMM for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_int4_kernel`
// (paddle_tpu/ops/pallas/quant_matmul.py:77, reached through
// `weight_only_matmul`, pallas_call at :138):
//   out[M, N] = (x[M, K] @ unpack(w[K, N/2])) * scales[N]
// accumulated in f32, written in x's dtype.
//
// Weight layout: the BLOCK-HALVED nibbles of `pack_int4_blocked`
// (quant_matmul.py:95-115). Within each block_n column block, byte c of
// the block's block_n/2 bytes holds column c in its low nibble and
// column c + block_n/2 in its high nibble. This is not the even/odd
// interleave of `quantize_int4`. A nibble u sign-extends as
// ((u & 0xF) ^ 8) - 8.
//
// Design. The TPU kernel keeps M whole (quant_matmul.py:142): its M is
// the decode batch. Here M is not only the decode batch: the serving
// step hands the projection [B*C, E] rows (512 at 8 slots and 64-token
// prefill chunks), so the kernel tiles M as well as N. A block owns BM
// rows and one tile of 64 packed bytes per K row, which is 128 output
// columns: 64 consecutive columns from the low nibbles and the 64
// columns half a block_n further on from the high nibbles. Every packed
// byte is therefore read once per M tile and both of its nibbles are
// used. The K loop stages a [BM, 32] slice of x and the matching
// [32, 128] slice of unpacked int4 values in shared memory as f32; each
// of the 256 threads accumulates a (BM/16) x 8 patch of outputs in f32
// registers, and the per-column scale is applied once in the epilogue.
// Decode-sized M (<= 16) uses BM = 16, larger M uses BM = 64.
//
// What bounds it: at decode M the bytes (K*N/2 packed weight bytes
// against 2*M*K*N flops: a few flops per byte), so the design streams
// only the packed bytes and unpacks in registers. At prefill M = 512 the
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

template <typename T, int BM>
__global__ void __launch_bounds__(NT)
int4_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scales, T* __restrict__ out, int M,
            int K, int N, int block_n) {
  constexpr int TM = BM / 16;
  __shared__ float xs[BM][BK + 1];
  __shared__ float ws[BK][2 * BB];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int half = block_n / 2;
  const int nbytes = N / 2;                 // packed bytes per K row
  const int b0 = blockIdx.x * BB;           // first packed byte of the tile
  const int m0 = blockIdx.y * BM;
  // output columns: low strip lo0 .. lo0+63, high strip lo0+half ..
  const int lo0 = (b0 / half) * block_n + b0 % half;
  const int hi0 = lo0 + half;

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
    // packed slice [BK, BB] bytes, read as 32-bit words (4 bytes each)
    for (int i = tid; i < BK * BB / 4; i += NT) {
      const int kk = i / (BB / 4), c4 = (i % (BB / 4)) * 4;
      const int k = k0 + kk;
      uint32_t word = 0;
      if (k < K) {
        word = *reinterpret_cast<const uint32_t*>(
            w + (size_t)k * nbytes + b0 + c4);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t byte = (word >> (8 * e)) & 0xFFu;
        ws[kk][c4 + e] = nib(byte);              // low nibble: low strip
        ws[kk][BB + c4 + e] = nib(byte >> 4);    // high nibble: high strip
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bcol[8];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bcol[j] = ws[kk][tx + 16 * j];
        bcol[4 + j] = ws[kk][BB + tx + 16 * j];
      }
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

template <typename T>
int launch_t(const void* x, const int8_t* w, const float* scales, void* out,
             int M, int K, int N, int block_n, cudaStream_t stream) {
  if (M <= 16) {
    dim3 grid(N / 2 / BB, (M + 15) / 16);
    int4_kernel<T, 16><<<grid, NT, 0, stream>>>(
        (const T*)x, w, scales, (T*)out, M, K, N, block_n);
  } else {
    dim3 grid(N / 2 / BB, (M + 63) / 64);
    int4_kernel<T, 64><<<grid, NT, 0, stream>>>(
        (const T*)x, w, scales, (T*)out, M, K, N, block_n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16 (x and out). w is the packed
// [K, N/2] int8 array, scales [N] float32. block_n must be a multiple of
// 128 that divides N. Returns the CUDA error code of the launch.
int weight_only_int4_launch(int dtype, const void* x, const void* w,
                            const void* scales, void* out, int M, int K,
                            int N, int block_n, void* stream) {
  if (block_n <= 0 || block_n % (2 * BB) != 0 || N % block_n != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* wp = (const int8_t*)w;
  const float* sp = (const float*)scales;
  switch (dtype) {
    case 0: return launch_t<float>(x, wp, sp, out, M, K, N, block_n, s);
    case 1: return launch_t<__nv_bfloat16>(x, wp, sp, out, M, K, N, block_n, s);
    case 2: return launch_t<__half>(x, wp, sp, out, M, K, N, block_n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
