// Helpers shared by the training step's fused tier (fused_norm.cu,
// swiglu.cu, token_ce.cu): element conversions that round as PyTorch's
// casts do (round to nearest even), eight-element loads and stores that
// take one or two 16-byte accesses where the row allows it, eight elements
// kept packed in registers, cp.async copies into shared memory, a named
// barrier, and a block sum in a fixed order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fused_tier {

// dtype codes of the wrappers: 0 float32, 1 bfloat16, 2 float16
enum { F32 = 0, BF16 = 1, F16 = 2 };

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) { return __bfloat162float(x); }
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) { return __float2bfloat16_rn(x); }
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and back: the value a PyTorch op of dtype T stores.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Elements p[0..n) as floats, zeros from n to 8. VEC: n is 8 and p is
// 16-byte aligned, read with one (16-bit types) or two (f32) 16-byte loads.
template <typename T, bool VEC>
__device__ __forceinline__ void load8(const T* p, int n, float (&f)[8]) {
  if (VEC) {
    if (sizeof(T) == 2) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = to_f<T>(e[i]);
    } else {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
      f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = i < n ? to_f<T>(p[i]) : 0.0f;
  }
}

// f[0..n) rounded to T and stored at p[0..n) (VEC as in load8).
template <typename T, bool VEC>
__device__ __forceinline__ void store8(T* p, int n, const float (&f)[8]) {
  if (VEC) {
    if (sizeof(T) == 2) {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = from_f<T>(f[i]);
      *reinterpret_cast<uint4*>(p) = u;
    } else {
      reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) p[i] = from_f<T>(f[i]);
  }
}

// Eight elements of T kept packed in registers (16 bytes for a 16-bit T,
// 32 for f32): what a row kept on chip holds between its two uses.
template <typename T> struct Pack8 {
  uint4 u[sizeof(T) / 2];
};

__device__ __forceinline__ void words(const uint4& u, uint32_t (&w)[4]) {
  w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
}

// The eight elements of q as floats (exact: every T widens to f32).
template <typename T>
__device__ __forceinline__ void unpack(const Pack8<T>& q, float (&f)[8]) {
  uint32_t w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      words(q.u[j], w);
#pragma unroll
      for (int i = 0; i < 4; ++i) f[4 * j + i] = __uint_as_float(w[i]);
    }
  } else {
    words(q.u[0], w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        f[2 * j] = __uint_as_float(w[j] << 16);
        f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      } else {
        const float2 t = __half22float2(*reinterpret_cast<const __half2*>(&w[j]));
        f[2 * j] = t.x;
        f[2 * j + 1] = t.y;
      }
    }
  }
}

// f rounded to T (to nearest even), packed.
template <typename T>
__device__ __forceinline__ void pack(const float (&f)[8], Pack8<T>& q) {
  uint32_t w[8];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = __float_as_uint(f[i]);
    q.u[0] = make_uint4(w[0], w[1], w[2], w[3]);
    q.u[1] = make_uint4(w[4], w[5], w[6], w[7]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
        w[j] = *reinterpret_cast<const uint32_t*>(&t);
      } else {
        const __half2 t = __floats2half2_rn(f[2 * j], f[2 * j + 1]);
        w[j] = *reinterpret_cast<const uint32_t*>(&t);
      }
    }
    q.u[0] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// cp.async of a Pack8's bytes (one or two 16-byte copies, L1 bypassed)
// from 16-byte aligned global memory into shared memory; cp_async4 copies
// 4 bytes. commit / wait as PTX's cp.async groups.
template <typename T>
__device__ __forceinline__ void cp_async_pack(Pack8<T>* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
#pragma unroll
  for (int j = 0; j < (int)(sizeof(T) / 2); ++j)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * j),
                 "l"(reinterpret_cast<const uint4*>(src) + j)
                 : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `n` threads, whole warps.
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum of v over the block's NT threads, returned to every thread; warps
// first, then the warps' sums in warp order. red holds NT / 32 floats.
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red may still be read by the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) t += red[i];
  return t;
}

template <int NT>
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) t = fmaxf(t, red[i]);
  return t;
}

}  // namespace fused_tier
