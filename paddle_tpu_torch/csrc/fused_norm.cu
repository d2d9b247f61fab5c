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
// Backward: dn = round_T(dout * w), sum(dn * h) per row, then dh =
// round_T(dn * inv + 2 h d(ms) / H) (+ the residual_out gradient, rounded
// again as autograd's sum rounds); dw is a column sum of round_O(dout *
// round_T(h * inv)). Three routes, which ops.fused_norm.bwd_plan picks
// from T, H and whether the rows allow 16-byte accesses, and passes in:
//   "warp"  (H <= 1024 16-bit, <= 512 f32): one warp a row, the row read
//           from HBM once through a cp.async ring in shared memory, the
//           dot a warp_sum of shuffles, dw in f32 registers
//           (rms_norm_bwd_warp_kernel, design note above it);
//   "warps" (16-bit up to 8192; Llama-7B's 4096): the same body with 2, 4
//           or 8 warps a row, their dots added in warp order through
//           shared memory behind a named barrier of the group;
//   "block" (wider, f32 past 512, and rows without 16-byte accesses): a
//           block of NT threads a row, two passes over the row (the second
//           from L1 / L2) and dw summed in shared memory
//           (rms_norm_bwd_kernel).
// Every route writes one f32 row of dw partials per block, and a second
// launch sums the G partials of each column in a fixed order: a single
// last block would read all G x H partials through one SM (about 1 MB at
// the flagship, some 10 us), the second launch spreads them over H / 32
// blocks. No atomics: bit-equal from call to call.
//
// Bound: bytes. At the flagship (16384 x 1024 bf16) the forward must move
// x, residual, out and residual_out (134 MB, 0.040 ms at 3.35 TB/s) and
// the backward dout, h, the residual_out gradient and dh (134 MB, 0.040
// ms). Each thread reads 8 elements at a time in 16-byte loads where H is
// a multiple of 8 and the rows are 16-byte aligned.
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

// ---- backward, routes "warp" and "warps": the row read once ----
//
// Rows that allow 16-byte accesses (H % 8 == 0, every row aligned; other
// rows take route "block"). A lane holds 64 bytes of each operand of a
// row: lane_chunks<T> chunks of 8 elements, its columns col0 + (lane + 32
// k) 8 + i. A warp so holds warp_cols<T> columns (1024 of a 16-bit T, 512
// of f32); a row of H columns takes wpr warps (a group: 1 route "warp",
// 2-8 "warps"), given by the caller with the block's nw warps. A block
// holds nw / wpr groups; group slot s = block * groups + group walks the
// rows s, s + S, ... (S slots in the grid). Each warp streams its rows'
// dout, h, dres and inv through a ring of ring<T, OT>() stages in shared
// memory by cp.async, the ring's depth less one rows ahead of the one it
// reduces (about 6 KB a row a warp, so 8 warps keep some 150 KB in flight
// an SM); a lane copies and reads only its own chunks, so the ring needs
// no barrier, and it reads its stage twice, for the dot and for dh.
// sum(dn h) is a warp_sum of shuffles, then (wpr > 1) the group's warp
// sums in warp order through shared memory behind a named barrier of the
// group alone. dw: a lane owns the same columns in every row, so it adds
// round_O(dout round_T(h inv)) into f32 registers; at the end the block's
// groups add theirs in group order through shared memory into the block's
// partial row, and the second launch sums the partial rows.
template <typename T> __host__ __device__ constexpr int lane_chunks() {
  return sizeof(T) == 2 ? 4 : 2;
}
template <typename T> __host__ __device__ constexpr int warp_cols() {
  return 32 * 8 * lane_chunks<T>();
}
constexpr int ROW_WARPS_MAX = 8;   // widest group: 8192 16-bit / 4096 f32

// the ring: stages, and the bytes of one stage of one warp
template <typename T, typename OT> __host__ __device__ constexpr int ring() {
  return sizeof(OT) > sizeof(T) ? 2 : 3;
}
template <typename T, typename OT>
__host__ __device__ constexpr int stage_bytes() {
  return 32 * lane_chunks<T>() * (int)(sizeof(Pack8<OT>) + 2 * sizeof(Pack8<T>)) +
         32 * (int)sizeof(float);
}
template <typename T, typename OT> size_t warp_smem(int nw, bool dw) {
  const size_t ring_b = (size_t)nw * ring<T, OT>() * stage_bytes<T, OT>();
  const size_t dw_b = dw ? (size_t)nw * warp_cols<T>() * sizeof(float) : 0;
  return ring_b > dw_b ? ring_b : dw_b;
}

template <typename T, typename WT, typename OT>
__global__ void __launch_bounds__(32 * ROW_WARPS_MAX)
rms_norm_bwd_warp_kernel(const OT* __restrict__ dout,
                         const T* __restrict__ dres, const T* __restrict__ h,
                         const WT* __restrict__ w,
                         const float* __restrict__ inv, T* __restrict__ dh,
                         float* __restrict__ part, long long R, int H,
                         int wpr) {
  constexpr int NC = lane_chunks<T>();
  constexpr int CW = warp_cols<T>();
  constexpr int S = ring<T, OT>();
  constexpr int SB = stage_bytes<T, OT>();
  extern __shared__ uint4 smem[];    // the warps' rings; then dw sums
  __shared__ float dots[2][ROW_WARPS_MAX];         // [row parity][warp]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5, groups = nw / wpr;
  const int grp = warp / wpr, wig = warp % wpr;
  const long long nslots = (long long)gridDim.x * groups;
  const long long first = (long long)blockIdx.x * groups + grp;
  const int col0 = wig * CW;

  // round_O(w) over the lane's columns, in registers for every row
  Pack8<OT> wo[NC];
  float dwa[NC][8];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = col0 + (lane + 32 * k) * 8;
    float f[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (w && c < H) load8<WT, true>(w + c, 8, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      f[i] = round_to<OT>(f[i]);
      dwa[k][i] = 0.0f;
    }
    pack<OT>(f, wo[k]);
  }

  // stage st of this warp's ring: dout [NC][32], h [NC][32], dres [NC][32]
  // Pack8s, then inv [32]
  char* ring_base = reinterpret_cast<char*>(smem) + (size_t)warp * S * SB;
  auto st_d = [&](int st) {
    return reinterpret_cast<Pack8<OT>*>(ring_base + st * SB);
  };
  auto st_h = [&](int st) {
    return reinterpret_cast<Pack8<T>*>(ring_base + st * SB +
                                       32 * NC * sizeof(Pack8<OT>));
  };
  auto st_r = [&](int st) { return st_h(st) + 32 * NC; };
  auto st_inv = [&](int st) {
    return reinterpret_cast<float*>(ring_base + (st + 1) * SB) - 32;
  };
  auto issue = [&](long long row, int st) {     // row's copies, one group
    if (row < R) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = col0 + (lane + 32 * k) * 8;
        if (c < H) {
          cp_async_pack<OT>(st_d(st) + 32 * k + lane, dout + row * H + c);
          cp_async_pack<T>(st_h(st) + 32 * k + lane, h + row * H + c);
          if (dres) cp_async_pack<T>(st_r(st) + 32 * k + lane, dres + row * H + c);
        }
      }
      cp_async4(st_inv(st) + lane, inv + row);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int j = 0; j < S - 1; ++j) issue(first + j * nslots, j);
  long long row = first;
  for (int it = 0; row < R; ++it, row += nslots) {
    const int st = it % S;
    // the row S - 1 ahead goes out before this one is read
    issue(row + (S - 1) * nslots, (it + S - 1) % S);
    cp_async_wait<S - 1>();
    const float ivc = st_inv(st)[lane];
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      if (col0 + (lane + 32 * k) * 8 >= H) continue;   // chunk not loaded
      float d[8], hv[8], wv[8];
      unpack<OT>(st_d(st)[32 * k + lane], d);
      unpack<T>(st_h(st)[32 * k + lane], hv);
      unpack<OT>(wo[k], wv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dn = w ? round_to<T>(d[i] * wv[i]) : round_to<T>(d[i]);
        dot += dn * hv[i];
        if (part) dwa[k][i] += round_to<OT>(d[i] * round_to<T>(hv[i] * ivc));
      }
    }
    dot = warp_sum(dot);
    if (wpr > 1) {
      if (lane == 0) dots[it & 1][warp] = dot;
      named_barrier(1 + grp, 32 * wpr);
      dot = 0.0f;
      for (int j = 0; j < wpr; ++j) dot += dots[it & 1][grp * wpr + j];
    }
    // rsqrt's backward, then the mean's: d(ms) = -dot inv^3 / 2, / H
    const float gsq = (-0.5f * dot * (ivc * ivc * ivc)) / (float)H;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = col0 + (lane + 32 * k) * 8;
      if (c >= H) continue;
      float d[8], hv[8], wv[8], r[8], o[8];
      unpack<OT>(st_d(st)[32 * k + lane], d);
      unpack<T>(st_h(st)[32 * k + lane], hv);
      unpack<OT>(wo[k], wv);
      if (dres) unpack<T>(st_r(st)[32 * k + lane], r);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dn = w ? round_to<T>(d[i] * wv[i]) : round_to<T>(d[i]);
        const float t = gsq * hv[i];
        float g = round_to<T>(dn * ivc + (t + t));
        if (dres) g = round_to<T>(g + r[i]);
        o[i] = g;
      }
      store8<T, true>(dh + row * H + c, 8, o);
    }
  }
  if (!part) return;
  // the block's partial row: its groups' sums added in group order (the
  // sums reuse the rings' shared memory once every copy has landed)
  cp_async_wait<0>();
  __syncthreads();
  float* dwsum = reinterpret_cast<float*>(smem);   // [groups][wpr * CW]
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    float* dst = dwsum + grp * wpr * CW + col0 + (lane + 32 * k) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = dwa[k][i];
  }
  __syncthreads();
  float* pr = part + (long long)blockIdx.x * H;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float t = 0.0f;
    for (int g = 0; g < groups; ++g) t += dwsum[g * wpr * CW + c];
    pr[c] = t;
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
               void* dw, long long R, int H, int G, int wpr, int nw,
               cudaStream_t s) {
  if (wpr > 0) {
    // the register routes run what they are given or nothing: 16-byte
    // rows, a group of warps that holds the row, whole groups a block
    if (!vec || (long long)wpr * warp_cols<T>() < H || nw % wpr != 0 ||
        nw > ROW_WARPS_MAX)
      return (int)cudaErrorInvalidValue;
    const size_t smem = warp_smem<T, OT>(nw, part != nullptr);
    auto k = rms_norm_bwd_warp_kernel<T, WT, OT>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    k<<<G, 32 * nw, smem, s>>>((const OT*)dout, (const T*)dres,
                               (const T*)h, (const WT*)w, inv, (T*)dh, part,
                               R, H, wpr);
  } else {
    if (nw != NT / 32) return (int)cudaErrorInvalidValue;
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
  }
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
// dw are null when w is. The route and grid come from
// ops.fused_norm.bwd_plan: wpr warps a row (1 "warp", 2-8 "warps", 0
// "block"), nw warps a block (4 on "block") and G blocks (any G >= 1 is
// right; the plan's fills the card). A route that cannot run the shape
// returns cudaErrorInvalidValue.
int fused_norm_bwd(int tcode, int wcode, int ocode, int vec, const void* dout,
                   const void* dres, const void* h, const void* w,
                   const void* inv, void* dh, void* part, void* dw,
                   long long R, int H, int G, int wpr, int nw, void* stream) {
  if (R < 0 || H < 1 || G < 1 || wpr < 0) return (int)cudaErrorInvalidValue;
  if ((size_t)(H + 7) / 8 * 8 * sizeof(float) > 227 * 1024 && part)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(T, W, O)                                                       \
  launch_bwd<T, W, O>(vec != 0, dout, dres, h, w, (const float*)inv, dh,    \
                      (float*)part, dw, R, H, G, wpr, nw, s)
  FUSED_NORM_DISPATCH(CALL)
#undef CALL
}

}  // extern "C"
