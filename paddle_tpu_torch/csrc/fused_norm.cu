// Kernel A of the training step's fused tier: RMSNorm with an optional
// bias and residual, forward and backward, for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces work that the JAX package leaves to XLA's fusion inside its
// jitted step (no pallas_call): paddle_tpu/nn/functional/norm.py:81
// rms_norm, the residual adds before each norm of
// paddle_tpu/models/llama.py:227-235, and
// paddle_tpu/incubate/nn/functional/__init__.py:1042 fused_rms_norm.
//
// Forward, one block of NT threads a row: h = x (+ bias) (+ residual), each
// add rounded to x's dtype T, is stored as residual_out; the mean square
// of h in f32 gives inv = rsqrt(ms + eps), kept per row for the
// backward; out = round_O(round_T(h * inv) * round_O(w)), where O is T (the
// nn.RMSNorm rule: the scale cast to the activation's dtype) or f32
// (fused_rms_norm with an f32 scale over a 16-bit activation).
//
// Backward, a fixed grid of blocks each walking rows b, b + G, ...: per
// row one pass for dn = round_T(dout * w) and sum(dn * h), then one that
// writes dh = round_T(dn * inv + 2 h d(ms) / H) (+ the residual_out
// gradient, rounded again as autograd's sum rounds). dw is a column sum of
// round_O(dout * round_T(h * inv)): each block sums its rows in shared
// memory (every thread owns the same columns in every row, so no atomics),
// writes one f32 row of partials, and a second launch sums the G partials
// of each column in a fixed order. Bit-equal from call to call.
//
// Bound: bytes. At the flagship (16384 x 1024 bf16) the forward must move
// x, residual, out and residual_out (134 MB, 0.040 ms at 3.35 TB/s) and
// the backward dout, h, the residual_out gradient and dh (134 MB, 0.040
// ms). Each thread reads 8
// elements at a time in 16-byte loads where H is a multiple of 8 and the
// rows are 16-byte aligned; the second pass over a row reads what the
// first left in L1 / L2.
#include "fused_tier.cuh"

using namespace fused_tier;

namespace {

constexpr int NT = 128;

template <typename T, typename WT, typename OT, bool VEC>
__global__ void __launch_bounds__(NT)
rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                    const T* __restrict__ res, const WT* __restrict__ w,
                    OT* __restrict__ out, T* hout, float* __restrict__ inv_out,
                    int H, float eps) {
  __shared__ float red[NT / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * H;
  const T* rr = res ? res + row * H : nullptr;
  T* hr = hout ? hout + row * H : nullptr;
  float ss = 0.0f;
  for (int c = threadIdx.x * 8; c < H; c += NT * 8) {
    const int n = min(8, H - c);
    float h[8], a[8];
    load8<T, VEC>(xr + c, n, h);
    if (bias) {
      load8<T, VEC>(bias + c, n, a);
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = round_to<T>(h[i] + a[i]);
    }
    if (rr) {
      load8<T, VEC>(rr + c, n, a);
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = round_to<T>(h[i] + a[i]);
    }
    if (hr) store8<T, VEC>(hr + c, n, h);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += h[i] * h[i];
  }
  ss = block_sum<NT>(ss, red);
  // PyTorch's mean (the sum times 1 / H) and rsqrt (rsqrtf)
  const float inv = rsqrtf(ss * (1.0f / (float)H) + eps);
  if (threadIdx.x == 0) inv_out[row] = inv;
  const T* src = hr ? hr : xr;  // the thread re-reads what it wrote
  OT* orow = out + row * H;
  for (int c = threadIdx.x * 8; c < H; c += NT * 8) {
    const int n = min(8, H - c);
    float h[8], wv[8], o[8];
    load8<T, VEC>(src + c, n, h);
    if (w) load8<WT, VEC>(w + c, n, wv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float nv = round_to<T>(h[i] * inv);
      o[i] = w ? nv * round_to<OT>(wv[i]) : nv;
    }
    store8<OT, VEC>(orow + c, n, o);
  }
}

template <typename T, typename WT, typename OT, bool VEC>
__global__ void __launch_bounds__(NT)
rms_norm_bwd_kernel(const OT* __restrict__ dout, const T* __restrict__ dres,
                    const T* __restrict__ h, const WT* __restrict__ w,
                    const float* __restrict__ inv, T* __restrict__ dh,
                    float* __restrict__ part, long long R, int H) {
  // dw sums when part != nullptr: element i of the 8-wide chunk c / 8 at
  // dwacc[i * nch + c / 8], so the threads of a warp (neighbouring chunks)
  // hit neighbouring banks
  extern __shared__ float dwacc[];
  __shared__ float red[NT / 32];
  const int nch = (H + 7) / 8;
  if (part)
    for (int c = threadIdx.x * 8; c < H; c += NT * 8)
      for (int i = 0; i < 8; ++i) dwacc[i * nch + c / 8] = 0.0f;
  for (long long row = blockIdx.x; row < R; row += gridDim.x) {
    const float iv = inv[row];
    const OT* dor = dout + row * H;
    const T* hr = h + row * H;
    float dot = 0.0f;
    for (int c = threadIdx.x * 8; c < H; c += NT * 8) {
      const int n = min(8, H - c);
      float d[8], hv[8], wv[8];
      load8<OT, VEC>(dor + c, n, d);
      load8<T, VEC>(hr + c, n, hv);
      if (w) load8<WT, VEC>(w + c, n, wv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dn = w ? round_to<T>(d[i] * round_to<OT>(wv[i]))
                           : round_to<T>(d[i]);
        dot += dn * hv[i];
        if (part && i < n)
          dwacc[i * nch + c / 8] +=
              round_to<OT>(d[i] * round_to<T>(hv[i] * iv));
      }
    }
    dot = block_sum<NT>(dot, red);
    // rsqrt's backward, then the mean's: d(ms) = -dot inv^3 / 2, / H
    const float gsq = (-0.5f * dot * (iv * iv * iv)) / (float)H;
    const T* drr = dres ? dres + row * H : nullptr;
    T* dhr = dh + row * H;
    for (int c = threadIdx.x * 8; c < H; c += NT * 8) {
      const int n = min(8, H - c);
      float d[8], hv[8], wv[8], r[8], o[8];
      load8<OT, VEC>(dor + c, n, d);
      load8<T, VEC>(hr + c, n, hv);
      if (w) load8<WT, VEC>(w + c, n, wv);
      if (drr) load8<T, VEC>(drr + c, n, r);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dn = w ? round_to<T>(d[i] * round_to<OT>(wv[i]))
                           : round_to<T>(d[i]);
        const float t = gsq * hv[i];
        float g = round_to<T>(dn * iv + (t + t));
        if (drr) g = round_to<T>(g + r[i]);
        o[i] = g;
      }
      store8<T, VEC>(dhr + c, n, o);
    }
  }
  if (part) {
    float* pr = part + (long long)blockIdx.x * H;
    for (int c = threadIdx.x * 8; c < H; c += NT * 8)
      for (int i = 0; i < 8 && c + i < H; ++i)
        pr[c + i] = dwacc[i * nch + c / 8];
  }
}

// dw[c] = the G block partials of column c summed in a fixed order,
// rounded to O (the product's dtype, as autograd's sum over rows rounds)
// and stored in w's dtype. A block takes 32 columns; its DW_GROUPS thread
// rows each sum the partials g = ty, ty + DW_GROUPS, ... in order, then
// thread row 0 adds the groups' sums in group order.
constexpr int DW_GROUPS = 16;

template <typename WT, typename OT>
__global__ void __launch_bounds__(32 * DW_GROUPS)
rms_norm_dw_kernel(const float* __restrict__ part, int G, int H,
                   WT* __restrict__ dw) {
  __shared__ float acc[DW_GROUPS][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float s = 0.0f;
  if (c < H)
    for (int g = ty; g < G; g += DW_GROUPS) s += part[(long long)g * H + c];
  acc[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < H) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < DW_GROUPS; ++i) t += acc[i][tx];
    dw[c] = from_f<WT>(round_to<OT>(t));
  }
}

template <typename T, typename WT, typename OT>
int launch_fwd(bool vec, const void* x, const void* bias, const void* res,
               const void* w, void* out, void* hout, float* inv, long long R,
               int H, float eps, cudaStream_t s) {
  const dim3 grid((unsigned)R);
  if (vec)
    rms_norm_fwd_kernel<T, WT, OT, true><<<grid, NT, 0, s>>>(
        (const T*)x, (const T*)bias, (const T*)res, (const WT*)w, (OT*)out,
        (T*)hout, inv, H, eps);
  else
    rms_norm_fwd_kernel<T, WT, OT, false><<<grid, NT, 0, s>>>(
        (const T*)x, (const T*)bias, (const T*)res, (const WT*)w, (OT*)out,
        (T*)hout, inv, H, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename WT, typename OT>
int launch_bwd(bool vec, const void* dout, const void* dres, const void* h,
               const void* w, const float* inv, void* dh, float* part,
               void* dw, long long R, int H, int G, cudaStream_t s) {
  const size_t smem = part ? (size_t)(H + 7) / 8 * 8 * sizeof(float) : 0;
  auto k = vec ? rms_norm_bwd_kernel<T, WT, OT, true>
               : rms_norm_bwd_kernel<T, WT, OT, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k<<<G, NT, smem, s>>>((const OT*)dout, (const T*)dres, (const T*)h,
                        (const WT*)w, inv, (T*)dh, part, R, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !part) return (int)e;
  rms_norm_dw_kernel<WT, OT><<<(H + 31) / 32, 32 * DW_GROUPS, 0, s>>>(
      part, G, H, (WT*)dw);
  return (int)cudaGetLastError();
}

// (T, W, O) dispatch: T the activation's dtype, W the scale's (T or f32),
// O the output's (T or f32). Returns -1 for a combination not built.
#define FUSED_NORM_DISPATCH(CALL)                                           \
  if (tcode == F32 && wcode == F32 && ocode == F32)                         \
    return CALL(float, float, float);                                       \
  if (tcode == BF16 && wcode == BF16 && ocode == BF16)                      \
    return CALL(__nv_bfloat16, __nv_bfloat16, __nv_bfloat16);               \
  if (tcode == BF16 && wcode == F32 && ocode == BF16)                       \
    return CALL(__nv_bfloat16, float, __nv_bfloat16);                       \
  if (tcode == BF16 && wcode == F32 && ocode == F32)                        \
    return CALL(__nv_bfloat16, float, float);                               \
  if (tcode == F16 && wcode == F16 && ocode == F16)                         \
    return CALL(__half, __half, __half);                                    \
  if (tcode == F16 && wcode == F32 && ocode == F16)                         \
    return CALL(__half, float, __half);                                     \
  if (tcode == F16 && wcode == F32 && ocode == F32)                         \
    return CALL(__half, float, float);                                      \
  return -1;

}  // namespace

extern "C" {

// Blocks of the backward's grid for R rows on a card of `sms` SMs: eight
// an SM, at most one a row (a function of the shape and the card alone,
// so the partials and their sum are the same from call to call).
int fused_norm_bwd_blocks(long long R, int sms) {
  long long g = 8LL * sms;
  return (int)(R < g ? (R < 1 ? 1 : R) : g);
}

// tcode / wcode / ocode: 0 float32, 1 bfloat16, 2 float16 (activation,
// scale, output). bias, res and w may be null; hout (residual_out) is null
// when there is neither bias nor residual. vec: H % 8 == 0 and every row
// 16-byte aligned. Returns the CUDA error of the launch (0 on success), or
// -1 for a dtype combination not built.
int fused_norm_fwd(int tcode, int wcode, int ocode, int vec, const void* x,
                   const void* bias, const void* res, const void* w,
                   void* out, void* hout, void* inv, long long R, int H,
                   float eps, void* stream) {
  if (R < 0 || H < 1 || R > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(T, W, O)                                                       \
  launch_fwd<T, W, O>(vec != 0, x, bias, res, w, out, hout, (float*)inv, R, \
                      H, eps, s)
  FUSED_NORM_DISPATCH(CALL)
#undef CALL
}

// dres (the residual_out gradient) and w may be null; part ([G, H] f32) and
// dw are null when w is. G from fused_norm_bwd_blocks.
int fused_norm_bwd(int tcode, int wcode, int ocode, int vec, const void* dout,
                   const void* dres, const void* h, const void* w,
                   const void* inv, void* dh, void* part, void* dw,
                   long long R, int H, int G, void* stream) {
  if (R < 0 || H < 1 || G < 1) return (int)cudaErrorInvalidValue;
  if ((size_t)(H + 7) / 8 * 8 * sizeof(float) > 227 * 1024 && part)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(T, W, O)                                                       \
  launch_bwd<T, W, O>(vec != 0, dout, dres, h, w, (const float*)inv, dh,    \
                      (float*)part, dw, R, H, G, s)
  FUSED_NORM_DISPATCH(CALL)
#undef CALL
}

}  // extern "C"
