// Kernel C of the training step's fused tier: the streamed token cross
// entropy over logits [N, V], forward and backward, for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces work that the JAX package leaves to XLA's fusion inside its
// jitted step (no pallas_call): the streamed path of
// paddle_tpu/nn/functional/loss.py:23-48 cross_entropy (softmax on, hard
// labels, class axis last, no class weights), which "never materializes
// the [N, V] fp32 log-softmax". Neither does this kernel.
//
// Forward, one block a row, two passes over the row in the logits' own
// dtype T: the row max m (and, with label smoothing, the sum of the f32
// logits); then S = sum exp(f32(round_T(x - m))), JAX's order (the
// difference upcast after the subtraction). lse = log S + m; the row's
// loss is lse - x[label] (with smoothing eps: (1 - eps) (lse - x[label]) +
// eps (lse - mean x)), 0 on rows whose label is ignore_index, NaN for a
// label outside [0, V) (JAX's gather fills). (m, S) is kept per row for
// the backward. A second launch, one block, sums the rows' losses and
// valid counts in a fixed order (each thread a fixed strided set of rows,
// then the warps' sums in warp order): sum, count and
// sum / max(count, 1), bit-equal from call to call.
//
// Backward, one block a row, one pass: dx = round_T(g_r (exp(f32(round_T(x
// - m))) / S - (1 - eps) [x is the label] - eps / V)), where g_r is the
// row's gradient: given per row (reduction none), one scalar (sum), or
// one scalar over max(count, 1) read on the device (mean; no host sync).
//
// Bound: bytes. At the flagship (16384 x 32000 bf16 logits) the forward
// must read the logits once (1.05 GB, 0.31 ms at 3.35 TB/s); its second
// pass reads the row again from L1 / L2. The backward reads and writes
// them (2.1 GB, 0.63 ms). 16-byte accesses where V and the row stride are
// multiples of 8 and the base is 16-byte aligned.
#include <math.h>

#include "fused_tier.cuh"

using namespace fused_tier;

namespace {

constexpr int NT = 256;
constexpr int NT_SUM = 1024;

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
token_ce_fwd_kernel(const T* __restrict__ x, const long long* __restrict__ lab,
                    float* __restrict__ loss, float* __restrict__ stats,
                    long long stride, int V, long long ignore, float one_m,
                    float smooth) {
  __shared__ float red[NT / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * stride;
  float mx = -INFINITY, tot = 0.0f;
  for (int c = threadIdx.x * 8; c < V; c += NT * 8) {
    const int n = min(8, V - c);
    float v[8];
    load8<T, VEC>(xr + c, n, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < n) mx = fmaxf(mx, v[i]);
      tot += v[i];
    }
  }
  const float m = block_max<NT>(mx, red);
  if (smooth != 0.0f) tot = block_sum<NT>(tot, red);
  float s = 0.0f;
  for (int c = threadIdx.x * 8; c < V; c += NT * 8) {
    const int n = min(8, V - c);
    float v[8];
    load8<T, VEC>(xr + c, n, v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) s += expf(round_to<T>(v[i] - m));
  }
  s = block_sum<NT>(s, red);
  if (threadIdx.x == 0) {
    const long long l = lab[row];
    const float lse = logf(s) + m;
    float out = 0.0f;
    if (l != ignore) {
      const float gold = (l >= 0 && l < V) ? to_f<T>(xr[l]) : NAN;
      out = lse - gold;
      if (smooth != 0.0f)
        out = one_m * out + smooth * (lse - tot / (float)V);
    }
    loss[row] = out;
    stats[2 * row] = m;
    stats[2 * row + 1] = s;
  }
}

// totals = (sum of the rows' losses, count of rows not ignored,
// sum / max(count, 1)), in a fixed order.
__global__ void __launch_bounds__(NT_SUM)
token_ce_sum_kernel(const float* __restrict__ loss,
                    const long long* __restrict__ lab, long long N,
                    long long ignore, float* __restrict__ totals) {
  __shared__ float red[NT_SUM / 32];
  float s = 0.0f, cnt = 0.0f;
  for (long long r = threadIdx.x; r < N; r += NT_SUM) {
    s += loss[r];
    cnt += lab[r] != ignore ? 1.0f : 0.0f;
  }
  s = block_sum<NT_SUM>(s, red);
  cnt = block_sum<NT_SUM>(cnt, red);
  if (threadIdx.x == 0) {
    totals[0] = s;
    totals[1] = cnt;
    totals[2] = s / fmaxf(cnt, 1.0f);
  }
}

// gmode: 0 g[row], 1 g[0], 2 g[0] / max(totals[1], 1)
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
token_ce_bwd_kernel(const T* __restrict__ x, const long long* __restrict__ lab,
                    const float* __restrict__ stats,
                    const float* __restrict__ g,
                    const float* __restrict__ totals, T* __restrict__ dx,
                    long long stride, long long dstride, int V,
                    long long ignore, float one_m, float smooth, int gmode) {
  const long long row = blockIdx.x;
  const long long l = lab[row];
  float gr = gmode == 0 ? g[row] : g[0];
  if (gmode == 2) gr = gr / fmaxf(totals[1], 1.0f);
  if (l == ignore) gr = 0.0f;
  const float m = stats[2 * row];
  const float t = (one_m * gr + smooth * gr) / stats[2 * row + 1];
  const float hit = one_m * gr;
  const float flat = smooth * gr / (float)V;
  const T* xr = x + row * stride;
  T* dr = dx + row * dstride;
  for (int c = threadIdx.x * 8; c < V; c += NT * 8) {
    const int n = min(8, V - c);
    float v[8], o[8];
    load8<T, VEC>(xr + c, n, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float d = t * expf(round_to<T>(v[i] - m)) - flat;
      if (c + i == l) d -= hit;
      o[i] = gr == 0.0f ? 0.0f : d;
    }
    store8<T, VEC>(dr + c, n, o);
  }
}

template <typename T>
int launch_fwd(bool vec, const void* x, const long long* lab, float* loss,
               float* stats, float* totals, long long N, long long stride,
               int V, long long ignore, float one_m, float smooth,
               cudaStream_t s) {
  if (vec)
    token_ce_fwd_kernel<T, true><<<(unsigned)N, NT, 0, s>>>(
        (const T*)x, lab, loss, stats, stride, V, ignore, one_m, smooth);
  else
    token_ce_fwd_kernel<T, false><<<(unsigned)N, NT, 0, s>>>(
        (const T*)x, lab, loss, stats, stride, V, ignore, one_m, smooth);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  token_ce_sum_kernel<<<1, NT_SUM, 0, s>>>(loss, lab, N, ignore, totals);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(bool vec, const void* x, const long long* lab,
               const float* stats, const float* g, const float* totals,
               void* dx, long long N, long long stride, long long dstride,
               int V, long long ignore, float one_m, float smooth, int gmode,
               cudaStream_t s) {
  if (vec)
    token_ce_bwd_kernel<T, true><<<(unsigned)N, NT, 0, s>>>(
        (const T*)x, lab, stats, g, totals, (T*)dx, stride, dstride, V,
        ignore, one_m, smooth, gmode);
  else
    token_ce_bwd_kernel<T, false><<<(unsigned)N, NT, 0, s>>>(
        (const T*)x, lab, stats, g, totals, (T*)dx, stride, dstride, V,
        ignore, one_m, smooth, gmode);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16 (logits). x [N, V] at row
// stride `stride` (elements), labels [N] int64, loss [N] f32, stats [N, 2]
// f32 (row max, sum of exp), totals [3] f32. one_m = 1 - smoothing. vec: V
// and the stride multiples of 8, x 16-byte aligned. Returns the CUDA error
// of the launches (0 on success), -1 for a dtype not built.
int token_ce_fwd(int dtype, int vec, const void* x, const void* labels,
                 void* loss, void* stats, void* totals, long long N,
                 long long stride, int V, long long ignore, float one_m,
                 float smooth, void* stream) {
  if (N < 0 || V < 1 || N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (N == 0) {
    token_ce_sum_kernel<<<1, NT_SUM, 0, s>>>(
        (const float*)loss, (const long long*)labels, 0, ignore,
        (float*)totals);
    return (int)cudaGetLastError();
  }
#define CALL(T)                                                             \
  launch_fwd<T>(vec != 0, x, (const long long*)labels, (float*)loss,        \
                (float*)stats, (float*)totals, N, stride, V, ignore, one_m, \
                smooth, s)
  if (dtype == F32) return CALL(float);
  if (dtype == BF16) return CALL(__nv_bfloat16);
  if (dtype == F16) return CALL(__half);
#undef CALL
  return -1;
}

// g: [N] f32 (gmode 0) or a 0-dim f32 (1: sum, 2: mean over totals[1]);
// dx [N, V] in the logits' dtype at row stride dstride.
int token_ce_bwd(int dtype, int vec, const void* x, const void* labels,
                 const void* stats, const void* g, const void* totals,
                 void* dx, long long N, long long stride, int V,
                 long long ignore, float one_m, float smooth, int gmode,
                 void* stream) {
  if (N < 0 || V < 1 || N > 0x7fffffffLL || gmode < 0 || gmode > 2)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(T)                                                             \
  launch_bwd<T>(vec != 0, x, (const long long*)labels, (const float*)stats, \
                (const float*)g, (const float*)totals, dx, N, stride, V,    \
                V, ignore, one_m, smooth, gmode, s)
  if (dtype == F32) return CALL(float);
  if (dtype == BF16) return CALL(__nv_bfloat16);
  if (dtype == F16) return CALL(__half);
#undef CALL
  return -1;
}

}  // extern "C"
