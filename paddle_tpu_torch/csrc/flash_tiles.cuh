// Tile helpers shared by flash_attention.cu and flashmask.cu (Hopper,
// sm_90a): dtype conversions, f32 tiles staged in shared memory with padded
// rows, the register-tile product of a 16 x 16 thread grid, half-warp row
// reductions and the delta = rowsum(do * o) pre-pass. Each source that
// includes it is its own shared library; `ops/_build.py` hashes this file
// into every library's name, so an edit here rebuilds both.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block: 16 x 16
constexpr int PAD = 4;           // row padding in floats
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

// v rounded to T and back: the value a cast to the dtype leaves
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// rows [row0, row0 + rows) of a [total, D] matrix into dst[r * LD + d]
// (transpose: dst[d * LD + r]) as f32; rows past the end are zeros
template <typename T, int D, int LD, bool TRANSPOSE>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int rows, int total) {
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, d = i % D, gr = row0 + r;
    const float v = gr < total ? to_f(src[(size_t)gr * D + d]) : 0.f;
    if (TRANSPOSE) dst[d * LD + r] = v;
    else dst[r * LD + d] = v;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z; v[4 * i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

template <int RI, int RJ>
__device__ __forceinline__ void zero(float (&c)[RI][RJ]) {
#pragma unroll
  for (int ii = 0; ii < RI; ++ii) {
#pragma unroll
    for (int jj = 0; jj < RJ; ++jj) c[ii][jj] = 0.f;
  }
}

// c[ii][jj] += sum_kk A(i, kk) * B(kk, j) for the thread's rows
// i = ty * RI + ii and columns j = tx * RJ + jj. B is stored [kk][j] with
// row stride LDB. A is stored [i][kk] (A_COL false, stride LDA) or
// [kk][i] (A_COL true).
template <int RI, int RJ, int KD, int LDA, int LDB, bool A_COL>
__device__ __forceinline__ void tile_mma(float (&c)[RI][RJ], const float* A,
                                         const float* B, int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < KD; ++kk) {
    float a[RI], b[RJ];
    if constexpr (A_COL) {
      load_vec<RI>(a, A + kk * LDA + ty * RI);
    } else {
#pragma unroll
      for (int ii = 0; ii < RI; ++ii) a[ii] = A[(ty * RI + ii) * LDA + kk];
    }
    load_vec<RJ>(b, B + kk * LDB + tx * RJ);
#pragma unroll
    for (int ii = 0; ii < RI; ++ii) {
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) c[ii][jj] = fmaf(a[ii], b[jj], c[ii][jj]);
    }
  }
}

// reductions over the 16 threads that share a row (one half-warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// delta[r] = sum_d do[r, d] * o[r, d] in f32, one warp per row
template <typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int D) {
  const int row = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) {
    acc += to_f(dout[(size_t)row * D + d]) * to_f(o[(size_t)row * D + d]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// launch `rows` rows of the delta pre-pass on `stream`
template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, int rows,
                         int D, cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  flash_bwd_delta_kernel<T><<<(rows + NT / 32 - 1) / (NT / 32), NT, 0, stream>>>(
      (const T*)o, (const T*)dout, delta, rows, D);
  return cudaGetLastError();
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
