// Kernel B of the training step's fused tier: SwiGLU forward and backward,
// out = silu(gate) * up, for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces work that the JAX package leaves to XLA's fusion inside its
// jitted step (no pallas_call): the MLP's silu(gate) * up of
// paddle_tpu/models/llama.py:209-214 and
// paddle_tpu/incubate/nn/functional/__init__.py:1011 swiglu.
//
// Element-wise over rows: gate and up are read through their own row
// strides, so the two halves of a fused [R, 2 im] projection need no
// copy, and the backward writes d(gate) and d(up) through theirs, so the
// fused projection's gradient is one [R, 2 im] tensor with no
// concatenation. The eager ops' roundings are kept (silu in f32):
//   out    = round(round(silu(g)) * u)
//   d_up   = round(dout * round(silu(g)))
//   d_gate = round(silu'(g) * round(dout * u))
// with silu(g) = g / (1 + exp(-g)) and silu'(g) = s (1 + g (1 - s)),
// s = 1 / (1 + exp(-g)), as PyTorch's silu and silu_backward compute them.
//
// Bound: bytes. At the flagship (16384 x 2816 of each half, bf16) the
// forward moves gu and out (277 MB, 0.083 ms at 3.35 TB/s), the backward
// gu, dout and dgu (461 MB, 0.138 ms). Each thread takes 8 elements of a
// row in 16-byte accesses where im and the row strides are multiples of 8
// and the bases 16-byte aligned.
#include <algorithm>

#include "fused_tier.cuh"

using namespace fused_tier;

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float silu_f(float g) {
  return g / (1.0f + expf(-g));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
swiglu_fwd_kernel(const T* __restrict__ g, const T* __restrict__ u,
                  T* __restrict__ out, long long sg, long long su,
                  long long so, long long R, int im) {
  const long long per_row = (im + 7) / 8;
  const long long total = R * per_row;
  for (long long i = blockIdx.x * (long long)NT + threadIdx.x; i < total;
       i += (long long)gridDim.x * NT) {
    const long long r = i / per_row;
    const int c = (int)(i - r * per_row) * 8;
    const int n = min(8, im - c);
    float gv[8], uv[8], o[8];
    load8<T, VEC>(g + r * sg + c, n, gv);
    load8<T, VEC>(u + r * su + c, n, uv);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = round_to<T>(silu_f(gv[k])) * uv[k];
    store8<T, VEC>(out + r * so + c, n, o);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
swiglu_bwd_kernel(const T* __restrict__ dout, const T* __restrict__ g,
                  const T* __restrict__ u, T* __restrict__ dg,
                  T* __restrict__ du, long long sd, long long sg,
                  long long su, long long sdg, long long sdu, long long R,
                  int im) {
  const long long per_row = (im + 7) / 8;
  const long long total = R * per_row;
  for (long long i = blockIdx.x * (long long)NT + threadIdx.x; i < total;
       i += (long long)gridDim.x * NT) {
    const long long r = i / per_row;
    const int c = (int)(i - r * per_row) * 8;
    const int n = min(8, im - c);
    float dv[8], gv[8], uv[8], a[8], b[8];
    load8<T, VEC>(dout + r * sd + c, n, dv);
    load8<T, VEC>(g + r * sg + c, n, gv);
    load8<T, VEC>(u + r * su + c, n, uv);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float s = 1.0f / (1.0f + expf(-gv[k]));
      const float silu = round_to<T>(gv[k] / (1.0f + expf(-gv[k])));
      b[k] = dv[k] * silu;                              // d_up
      const float gs = round_to<T>(dv[k] * uv[k]);      // d silu
      a[k] = gs * s * (1.0f + gv[k] * (1.0f - s));      // d_gate
    }
    store8<T, VEC>(dg + r * sdg + c, n, a);
    store8<T, VEC>(du + r * sdu + c, n, b);
  }
}

template <typename T>
int launch_fwd(bool vec, const void* g, const void* u, void* out,
               long long sg, long long su, long long so, long long R, int im,
               int sms, cudaStream_t s) {
  const long long total = R * ((im + 7) / 8);
  const long long blocks =
      std::min<long long>((total + NT - 1) / NT, (long long)sms * 16);
  if (vec)
    swiglu_fwd_kernel<T, true><<<(unsigned)blocks, NT, 0, s>>>(
        (const T*)g, (const T*)u, (T*)out, sg, su, so, R, im);
  else
    swiglu_fwd_kernel<T, false><<<(unsigned)blocks, NT, 0, s>>>(
        (const T*)g, (const T*)u, (T*)out, sg, su, so, R, im);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(bool vec, const void* dout, const void* g, const void* u,
               void* dg, void* du, long long sd, long long sg, long long su,
               long long sdg, long long sdu, long long R, int im, int sms,
               cudaStream_t s) {
  const long long total = R * ((im + 7) / 8);
  const long long blocks =
      std::min<long long>((total + NT - 1) / NT, (long long)sms * 16);
  if (vec)
    swiglu_bwd_kernel<T, true><<<(unsigned)blocks, NT, 0, s>>>(
        (const T*)dout, (const T*)g, (const T*)u, (T*)dg, (T*)du, sd, sg, su,
        sdg, sdu, R, im);
  else
    swiglu_bwd_kernel<T, false><<<(unsigned)blocks, NT, 0, s>>>(
        (const T*)dout, (const T*)g, (const T*)u, (T*)dg, (T*)du, sd, sg, su,
        sdg, sdu, R, im);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. g, u, out: [R, im] rows at the
// given strides (elements), the last axis contiguous. vec: im and every
// stride a multiple of 8, every base 16-byte aligned. Returns the CUDA
// error of the launch (0 on success).
int swiglu_fwd(int dtype, int vec, const void* g, const void* u, void* out,
               long long sg, long long su, long long so, long long R, int im,
               void* stream) {
  if (R < 0 || im < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32)
    return launch_fwd<float>(vec, g, u, out, sg, su, so, R, im, sms, s);
  if (dtype == BF16)
    return launch_fwd<__nv_bfloat16>(vec, g, u, out, sg, su, so, R, im, sms,
                                     s);
  if (dtype == F16)
    return launch_fwd<__half>(vec, g, u, out, sg, su, so, R, im, sms, s);
  return -1;
}

int swiglu_bwd(int dtype, int vec, const void* dout, const void* g,
               const void* u, void* dg, void* du, long long sd, long long sg,
               long long su, long long sdg, long long sdu, long long R,
               int im, void* stream) {
  if (R < 0 || im < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == F32)
    return launch_bwd<float>(vec, dout, g, u, dg, du, sd, sg, su, sdg, sdu, R,
                             im, sms, s);
  if (dtype == BF16)
    return launch_bwd<__nv_bfloat16>(vec, dout, g, u, dg, du, sd, sg, su, sdg,
                                     sdu, R, im, sms, s);
  if (dtype == F16)
    return launch_bwd<__half>(vec, dout, g, u, dg, du, sd, sg, su, sdg, sdu,
                              R, im, sms, s);
  return -1;
}

}  // extern "C"
