// Kernel D of the training step's fused tier: AdamW with the global-norm
// clip over every parameter of a model, as two launches a step, for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces work that the JAX package leaves to XLA's fusion inside its
// jitted step (no pallas_call): paddle_tpu/models/pretrain.py:176-200
// _adamw, whose port was a chain of about 14 torch._foreach_* passes.
//
// The tensors are cut into chunks of CHUNK elements (a chunk never spans
// two tensors) and a launch takes up to MAX_T tensors in its parameters
// (pointers, sizes, grad dtypes, decay flags, the first chunk of each), so
// no table is copied to the card.
//   Launch 1: each block writes its chunk's sum of squares of the grads
//   (f64) and whether the chunk ends its tensor into a fixed workspace; the
//   last block to finish (an atomic ticket after __threadfence(), the
//   counter set back to 0) walks the chunks in order: each tensor's norm
//   sqrt(sum) rounded to f32, then gnorm = sqrt(sum of their squares) and
//   the clip scale min(1, clip * (1 / (gnorm + 1e-6))), both left on the
//   card (no host sync). Bit-equal from call to call.
//   Launch 2: each block updates its chunk of p, m and v in place with the
//   port's op order and roundings (pretrain._adamw_plain's foreach
//   passes, see adamw_elem): g *= scale; m = m b1 + (1 - b1) g;
//   v = v b2 + (1 - b2) g g; step = (m / c1) / (sqrt(v / c2) + eps);
//   step += wd p where the tensor has ndim >= 2; p += -lr step.
// Grads may be f32, bf16 or f16 (upcast in registers); p, m, v are f32.
// More than MAX_T tensors take ceil(T / MAX_T) launches of each.
//
// Telemetry (the JAX step's _pack_telemetry, pretrain.py:205-229, which
// XLA fuses into its jitted step) rides on the same two launches, with no
// pass of its own: launch 1 also writes each chunk's count of non-finite
// grads, launch 2 (its telemetry instance) each chunk's f64 sums of p_old^2
// and (p_new - p_old)^2, the difference rounded to f32 first, and its
// group's id (a per-tensor id in the launch parameters). The last block of
// launch 2 (the same ticket as launch 1's) walks the chunks in order, one
// lane of its first warp a group, sums them into the groups in f64 and
// writes the packed f32 vector
// [loss, gnorm, then (grad_norm, param_norm, update_norm, nonfinite) per
// group]. The update itself runs the same instructions in both instances,
// so p, m, v and gnorm are bit-equal with the telemetry on and off.
//
// Bound: bytes. At the flagship's 373.9M parameters with f32 grads: launch
// 1 reads g (1.50 GB), launch 2 reads g, p, m, v and writes p, m, v
// (10.47 GB): 11.97 GB, 3.57 ms at 3.35 TB/s. Each thread moves four
// elements at a time in 16-byte accesses where the tensors are aligned.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NT = 256;
constexpr int CHUNK = 65536;
constexpr int MAX_T = 256;
constexpr int MAX_G = 32;   // telemetry groups
constexpr int WS_SLOTS = 6;  // g^2, end flag, nonfinite, p^2, du^2, group

struct TensorList {
  float* p[MAX_T];
  const void* g[MAX_T];
  float* m[MAX_T];
  float* v[MAX_T];
  long long n[MAX_T];
  int chunk0[MAX_T + 1];  // first chunk of each tensor, in this launch
  int gtype[MAX_T];       // 0 f32, 1 bf16, 2 f16
  int decay[MAX_T];
  int group[MAX_T];       // telemetry group of each tensor
  int count;
};

__device__ __forceinline__ float load_g(const void* g, int type,
                                        long long i) {
  if (type == 1) return __bfloat162float(((const __nv_bfloat16*)g)[i]);
  if (type == 2) return __half2float(((const __half*)g)[i]);
  return ((const float*)g)[i];
}

// four grads at g[i..i+4), i a multiple of 4 and the tensor aligned
__device__ __forceinline__ void load_g4(const void* g, int type, long long i,
                                        float (&f)[4]) {
  if (type == 0) {
    const float4 a = *reinterpret_cast<const float4*>((const float*)g + i);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  } else {
    const uint2 u =
        *reinterpret_cast<const uint2*>((const unsigned short*)g + i);
    const unsigned short* e = reinterpret_cast<const unsigned short*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[k] = type == 1 ? __bfloat162float(__ushort_as_bfloat16(e[k]))
                       : __half2float(__ushort_as_half(e[k]));
    }
  }
}

// the tensor holding this block's chunk: the last t with chunk0[t] <= b
__device__ __forceinline__ int find_tensor(const TensorList& L, int b) {
  int lo = 0, hi = L.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (L.chunk0[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool vec_ok(const TensorList& L, int t) {
  const uintptr_t a = (uintptr_t)L.p[t] | (uintptr_t)L.m[t] |
                      (uintptr_t)L.v[t];
  const uintptr_t ga = (uintptr_t)L.g[t];
  return (a % 16) == 0 && ga % (L.gtype[t] == 0 ? 16 : 8) == 0;
}

__device__ double block_sum_d(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
  for (int i = 0; i < NT / 32; ++i) t += red[i];
  return t;
}

// ws: [2 * total chunks] f64 (the chunks' sums, then 1.0 where a chunk ends
// its tensor; with telemetry WS_SLOTS * total, slot 2 the chunks' counts of
// non-finite grads); base: this launch's first chunk; out: [2] f32 (gnorm,
// scale) written by the last block of the last launch.
__global__ void __launch_bounds__(NT)
adamw_sumsq_kernel(const TensorList L, double* ws, int base, int total,
                   int last_launch, unsigned int* counter, float* out,
                   float clip, int telemetry) {
  __shared__ double red[NT / 32];
  __shared__ bool is_last;
  const int b = blockIdx.x;
  const int t = find_tensor(L, b);
  const long long start = (long long)(b - L.chunk0[t]) * CHUNK;
  const long long end = min(L.n[t], start + CHUNK);
  const void* g = L.g[t];
  const int type = L.gtype[t];
  double acc = 0.0;
  int bad = 0;  // non-finite grads (counted only with telemetry)
  if (vec_ok(L, t)) {
    const long long end4 = start + ((end - start) & ~3LL);
    for (long long i = start + threadIdx.x * 4; i < end4; i += NT * 4) {
      float f[4];
      load_g4(g, type, i, f);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc += (double)f[k] * f[k];
        bad += !isfinite(f[k]);
      }
    }
    for (long long i = end4 + threadIdx.x; i < end; i += NT) {
      const float f = load_g(g, type, i);
      acc += (double)f * f;
      bad += !isfinite(f);
    }
  } else {
    for (long long i = start + threadIdx.x; i < end; i += NT) {
      const float f = load_g(g, type, i);
      acc += (double)f * f;
      bad += !isfinite(f);
    }
  }
  acc = block_sum_d(acc, red);
  if (telemetry) {
    __syncthreads();  // every thread has read red
    const double nf = block_sum_d((double)bad, red);
    if (threadIdx.x == 0) ws[2 * total + base + b] = nf;
  }
  if (threadIdx.x == 0) {
    ws[base + b] = acc;
    ws[total + base + b] = end == L.n[t] ? 1.0 : 0.0;
    __threadfence();
    const unsigned int ticket = atomicAdd(counter, 1u);
    is_last = ticket == gridDim.x - 1;
    if (is_last) *counter = 0u;  // every block of this launch has counted
  }
  __syncthreads();
  if (!is_last || !last_launch) return;
  // the last block of the last launch: every chunk is written. The chunks'
  // sums come through shared memory a tile at a time; thread 0 walks them
  // in order.
  __shared__ double sv[NT], sf[NT];
  double s = 0.0, sq = 0.0;
  for (int c0 = 0; c0 < total; c0 += NT) {
    const int c = c0 + threadIdx.x;
    sv[threadIdx.x] = c < total ? __ldcg(ws + c) : 0.0;
    sf[threadIdx.x] = c < total ? __ldcg(ws + total + c) : 0.0;
    __syncthreads();
    if (threadIdx.x == 0) {
      const int lim = min(NT, total - c0);
      for (int i = 0; i < lim; ++i) {
        s += sv[i];
        if (sf[i] != 0.0) {
          const float norm = (float)sqrt(s);
          sq += (double)norm * norm;
          s = 0.0;
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float gnorm = (float)sqrt(sq);
    out[0] = gnorm;
    // a NaN gnorm gives a NaN scale, as the plain version's clamp does
    const float r = __fmul_rn(__frcp_rn(__fadd_rn(gnorm, 1e-6f)), clip);
    out[1] = clip != 0.0f ? (isnan(r) ? r : fminf(r, 1.0f)) : 1.0f;
  }
}

struct Hyper {
  float b1, omb1, b2, omb2, rc1, rc2, eps, wd, neg_lr;
  int clip_on;
};

// The foreach passes' roundings, as PyTorch's CUDA foreach kernels compute
// them: each `a + alpha * b` is one fused multiply-add, a division by a
// scalar is a product with its reciprocal (rc1 = 1 / c1 and rc2 = 1 / c2,
// taken in double and rounded to f32 by the caller), a division by a
// tensor is a true division. Where m b1 and (1 - b1) g, or p and lr step,
// nearly cancel, one rounding taken otherwise would move the result by
// many of its own ulps.
__device__ __forceinline__ void adamw_elem(float& p, float gv, float& m,
                                           float& v, float scale,
                                           const Hyper& h, bool decay) {
  const float g = h.clip_on ? __fmul_rn(gv, scale) : gv;
  m = __fmaf_rn(h.omb1, g, __fmul_rn(m, h.b1));
  v = __fmaf_rn(h.omb2, __fmul_rn(g, g), __fmul_rn(v, h.b2));
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.rc2)), h.eps);
  float step = __fdiv_rn(__fmul_rn(m, h.rc1), denom);
  if (decay) step = __fmaf_rn(h.wd, p, step);
  p = __fmaf_rn(h.neg_lr, step, p);
}

// Telemetry's chunk sums of p_old^2 and (p_new - p_old)^2, the difference
// rounded to f32 as the plain version takes it.
struct TelSums {
  double p2 = 0.0, u2 = 0.0;
  __device__ __forceinline__ void add(float before, float after) {
    const float d = __fsub_rn(after, before);
    p2 += (double)before * before;
    u2 += (double)d * d;
  }
};

template <bool TEL>
__device__ __forceinline__ void update_chunk(const TensorList& L, int t,
                                             long long start, long long end,
                                             float scale, const Hyper& h,
                                             TelSums& tel) {
  const bool decay = L.decay[t] != 0;
  float* p = L.p[t];
  float* m = L.m[t];
  float* v = L.v[t];
  const void* g = L.g[t];
  const int type = L.gtype[t];
  long long tail = start;
  if (vec_ok(L, t)) {
    const long long end4 = start + ((end - start) & ~3LL);
    for (long long i = start + threadIdx.x * 4; i < end4; i += NT * 4) {
      float gv[4];
      load_g4(g, type, i, gv);
      float4 pp = *reinterpret_cast<float4*>(p + i);
      float4 mm = *reinterpret_cast<float4*>(m + i);
      float4 vv = *reinterpret_cast<float4*>(v + i);
      const float4 p0 = pp;
      adamw_elem(pp.x, gv[0], mm.x, vv.x, scale, h, decay);
      adamw_elem(pp.y, gv[1], mm.y, vv.y, scale, h, decay);
      adamw_elem(pp.z, gv[2], mm.z, vv.z, scale, h, decay);
      adamw_elem(pp.w, gv[3], mm.w, vv.w, scale, h, decay);
      *reinterpret_cast<float4*>(p + i) = pp;
      *reinterpret_cast<float4*>(m + i) = mm;
      *reinterpret_cast<float4*>(v + i) = vv;
      if (TEL) {
        tel.add(p0.x, pp.x);
        tel.add(p0.y, pp.y);
        tel.add(p0.z, pp.z);
        tel.add(p0.w, pp.w);
      }
    }
    tail = end4;
  }
  for (long long i = tail + threadIdx.x; i < end; i += NT) {
    float pv = p[i], mv = m[i], vv = v[i];
    const float p0 = pv;
    adamw_elem(pv, load_g(g, type, i), mv, vv, scale, h, decay);
    p[i] = pv;
    m[i] = mv;
    v[i] = vv;
    if (TEL) tel.add(p0, pv);
  }
}

__global__ void __launch_bounds__(NT)
adamw_update_kernel(const TensorList L, const float* __restrict__ out,
                    const Hyper h) {
  const int b = blockIdx.x;
  const int t = find_tensor(L, b);
  const long long start = (long long)(b - L.chunk0[t]) * CHUNK;
  const long long end = min(L.n[t], start + CHUNK);
  TelSums tel;
  update_chunk<false>(L, t, start, end, out[1], h, tel);
}

// Where the telemetry's walk writes: loss [1] f32 on the card, vec
// [2 + 4 * groups] f32.
struct TelOut {
  const float* loss;
  float* vec;
  int groups;
};

// Launch 2 with the telemetry: the update of adamw_update_kernel, each
// chunk's p^2 / du^2 sums and group into ws (slots 3-5, slot 0 and 2 as
// launch 1 left them), and the packed vector from the last block of the
// last launch.
__global__ void __launch_bounds__(NT)
adamw_update_tel_kernel(const TensorList L, const float* __restrict__ out,
                        const Hyper h, double* ws, int base, int total,
                        int last_launch, unsigned int* counter,
                        const TelOut to) {
  __shared__ double red[NT / 32];
  __shared__ bool is_last;
  const int b = blockIdx.x;
  const int t = find_tensor(L, b);
  const long long start = (long long)(b - L.chunk0[t]) * CHUNK;
  const long long end = min(L.n[t], start + CHUNK);
  TelSums tel;
  update_chunk<true>(L, t, start, end, out[1], h, tel);
  const double p2 = block_sum_d(tel.p2, red);
  __syncthreads();
  const double u2 = block_sum_d(tel.u2, red);
  if (threadIdx.x == 0) {
    ws[3 * total + base + b] = p2;
    ws[4 * total + base + b] = u2;
    ws[5 * total + base + b] = (double)L.group[t];
    __threadfence();
    const unsigned int ticket = atomicAdd(counter, 1u);
    is_last = ticket == gridDim.x - 1;
    if (is_last) *counter = 0u;
  }
  __syncthreads();
  if (!is_last || !last_launch) return;
  // every chunk of every launch is written: slot by slot a tile of NT
  // chunks comes through shared memory, and lane j of warp 0 adds group
  // j's chunks in chunk order into its registers (the tile's values are
  // broadcast reads; a lane skips the chunks of other groups)
  __shared__ double tile[5][NT];
  constexpr int slot[5] = {0, 3, 4, 2, 5};  // g^2, p^2, du^2, nf, group
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
  for (int c0 = 0; c0 < total; c0 += NT) {
    const int c = c0 + threadIdx.x;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      tile[k][threadIdx.x] = c < total ? __ldcg(ws + slot[k] * total + c)
                                       : 0.0;
    __syncthreads();
    if (threadIdx.x < 32) {
      const int lim = min(NT, total - c0);
      for (int i = 0; i < lim; ++i) {
        const double x0 = tile[0][i], x1 = tile[1][i], x2 = tile[2][i];
        const double x3 = tile[3][i];
        if ((int)tile[4][i] == (int)threadIdx.x) {
          a0 += x0;
          a1 += x1;
          a2 += x2;
          a3 += x3;
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    to.vec[0] = *to.loss;
    to.vec[1] = out[0];
  }
  if ((int)threadIdx.x < to.groups) {
    float* r = to.vec + 2 + 4 * threadIdx.x;
    r[0] = (float)sqrt(a0);
    r[1] = (float)sqrt(a1);
    r[2] = (float)sqrt(a2);
    r[3] = (float)a3;
  }
}

// Fills L with tensors [t0, t0 + count) of the caller's arrays; returns
// this launch's chunks.
int fill(TensorList& L, int t0, int count, void* const* p, void* const* g,
         void* const* m, void* const* v, const long long* n,
         const int* gtype, const int* decay, const int* group = nullptr) {
  int c = 0;
  L.count = count;
  for (int i = 0; i < count; ++i) {
    const int t = t0 + i;
    L.p[i] = p ? (float*)p[t] : nullptr;
    L.g[i] = g[t];
    L.m[i] = m ? (float*)m[t] : nullptr;
    L.v[i] = v ? (float*)v[t] : nullptr;
    L.n[i] = n[t];
    L.gtype[i] = gtype[t];
    L.decay[i] = decay ? decay[t] : 0;
    L.group[i] = group ? group[t] : 0;
    L.chunk0[i] = c;
    c += (int)((n[t] + CHUNK - 1) / CHUNK);
  }
  L.chunk0[count] = c;
  return c;
}

}  // namespace

extern "C" {

int adamw_max_tensors() { return MAX_T; }
int adamw_chunk_elems() { return CHUNK; }
int adamw_max_groups() { return MAX_G; }
int adamw_ws_slots() { return WS_SLOTS; }

// Launch 1 over T tensors' grads g[T] (n[T] elements, gtype[T]: 0 f32, 1
// bf16, 2 f16): ws holds 2 x (sum of ceil(n / CHUNK)) doubles (WS_SLOTS x
// with telemetry, which also counts the non-finite grads), counter one
// zeroed unsigned int (left zeroed), out [2] f32 receives (gnorm, scale);
// clip 0 leaves the scale at 1. Tensors of 0 elements take no chunk. Returns
// the CUDA error of the launches (0 on success).
int adamw_sumsq(int T, void* const* g, const long long* n, const int* gtype,
                void* ws, void* counter, void* out, float clip,
                int telemetry, void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long total = 0;
  for (int t = 0; t < T; ++t) total += (n[t] + CHUNK - 1) / CHUNK;
  if (total < 1 || total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the last launch with chunks finishes the reduction
  int last = T - 1;
  while (last > 0 && n[last] == 0) --last;
  const int last_batch = last / MAX_T;
  int base = 0;
  for (int t0 = 0, bi = 0; t0 < T; t0 += MAX_T, ++bi) {
    TensorList L;
    const int chunks = fill(L, t0, std::min(MAX_T, T - t0), nullptr, g,
                            nullptr, nullptr, n, gtype, nullptr);
    if (chunks > 0)
      adamw_sumsq_kernel<<<chunks, NT, 0, s>>>(
          L, (double*)ws, base, (int)total, bi == last_batch,
          (unsigned int*)counter, (float*)out, clip, telemetry);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    base += chunks;
  }
  return 0;
}

// Launch 2: p, m, v [T] f32 updated in place from g (as in adamw_sumsq),
// decay[T] 1 for the tensors that take weight decay, out as adamw_sumsq
// left it (the scale is read when clip_on); rc1 / rc2 the reciprocals of
// the bias corrections. With the telemetry (vec not null): group[T] (each
// tensor's group, 0 <= group < groups <= MAX_G), ws and counter as
// adamw_sumsq(telemetry=1) left them, loss [1] f32 and vec [2 + 4 groups]
// f32 on the card; without it group, ws, counter and loss are not read.
int adamw_update(int T, void* const* p, void* const* g, void* const* m,
                 void* const* v, const long long* n, const int* gtype,
                 const int* decay, const int* group, void* out, float b1,
                 float omb1, float b2, float omb2, float rc1, float rc2,
                 float eps, float wd, float neg_lr, int clip_on, void* ws,
                 void* counter, void* loss, void* vec, int groups,
                 void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  const bool tel = vec != nullptr;
  long long total = 0;
  if (tel) {
    if (!group || !ws || !counter || !loss || groups < 1 || groups > MAX_G)
      return (int)cudaErrorInvalidValue;
    for (int t = 0; t < T; ++t) {
      if (group[t] < 0 || group[t] >= groups)
        return (int)cudaErrorInvalidValue;
      total += (n[t] + CHUNK - 1) / CHUNK;
    }
    if (total < 1 || total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const Hyper h{b1, omb1, b2, omb2, rc1, rc2, eps, wd, neg_lr, clip_on};
  const TelOut to{(const float*)loss, (float*)vec, groups};
  int last = T - 1;
  while (last > 0 && n[last] == 0) --last;
  const int last_batch = last / MAX_T;
  int base = 0;
  for (int t0 = 0, bi = 0; t0 < T; t0 += MAX_T, ++bi) {
    TensorList L;
    const int chunks = fill(L, t0, std::min(MAX_T, T - t0), p, g, m, v, n,
                            gtype, decay, tel ? group : nullptr);
    if (chunks > 0 && tel)
      adamw_update_tel_kernel<<<chunks, NT, 0, s>>>(
          L, (const float*)out, h, (double*)ws, base, (int)total,
          bi == last_batch, (unsigned int*)counter, to);
    else if (chunks > 0)
      adamw_update_kernel<<<chunks, NT, 0, s>>>(L, (const float*)out, h);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    base += chunks;
  }
  return 0;
}

}  // extern "C"
