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
// On the training mesh (pretrain.make_train_step with a mesh) a rank holds
// shards and the norm is global, so the clip scale cannot be finished
// inside launch 1. There launch 1's last block writes the sum of squares
// of the grads (f64, the chunks' sums in chunk order) to sumsq_out, the
// caller all_reduces it over the ranks, and every block of launch 2 takes
// gnorm = sqrt(global sum) and the scale from it (block 0 also writes them
// to out). owned[t] 0 leaves a tensor out of every sum (its chunks write
// 0), so that a shard replicated over ranks counts once: the update itself
// is the same. With the telemetry, launch 2's last block writes the
// groups' raw f64 sums (g^2, p_old^2, du^2, non-finite) to raw[4 * group]
// for the caller to all_reduce and take the square roots of. With owned
// all 1 and no sumsq_out / gsumsq / raw, the kernels run the one-device
// instructions and give the same bits.
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

// a tensor's flags: decayed; clipped (the eager form's need_clip); counted
// in the sums of squares (owned once over the ranks, and in the eager form
// need_clip too)
constexpr int F_DECAY = 1, F_CLIP = 2, F_NORM = 4;

// The tensors of one launch, both forms. The pretrain form reads p, m, v
// as f32 and leaves out, lr, keep, wd, ptype and otype unset.
struct TensorList {
  void* p[MAX_T];
  void* out[MAX_T];       // eager: the parameter written as round(p), or null
  const void* g[MAX_T];
  float* m[MAX_T];
  float* v[MAX_T];
  long long n[MAX_T];
  int chunk0[MAX_T + 1];  // first chunk of each tensor, in this launch
  float lr[MAX_T];        // eager: the tensor's rate
  float keep[MAX_T];      // eager: 1 - lr wd (AdamW, decayed), else 1
  float wd[MAX_T];        // eager: the tensor's weight decay (Adam's L2)
  // dtypes 0 f32, 1 bf16, 2 f16; F_* flags; telemetry group of each tensor
  unsigned char gtype[MAX_T], ptype[MAX_T], otype[MAX_T], flags[MAX_T];
  unsigned char group[MAX_T];
  int count;
};

__device__ __forceinline__ float load_g(const void* g, int type,
                                        long long i) {
  if (type == 1) return __bfloat162float(((const __nv_bfloat16*)g)[i]);
  if (type == 2) return __half2float(((const __half*)g)[i]);
  return ((const float*)g)[i];
}

// four elements at g[i..i+4), i a multiple of 4 and the array aligned
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

// a dtype-`type` array aligned to 4 of its elements (16 bytes for f32, 8
// for 16-bit)
__device__ __forceinline__ bool aligned4(const void* x, int type) {
  return (uintptr_t)x % (type == 0 ? 16 : 8) == 0;
}

// the pretrain form's 16-byte route: f32 p, m, v and g aligned
__device__ __forceinline__ bool vec_ok(const TensorList& L, int t) {
  const uintptr_t a = (uintptr_t)L.p[t] | (uintptr_t)L.m[t] |
                      (uintptr_t)L.v[t];
  return (a % 16) == 0 && aligned4(L.g[t], L.gtype[t]);
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

// The eager form's clip scale, min(clip / max(gnorm, 1e-12), 1); a NaN
// gnorm gives a NaN scale, as jnp.minimum / jnp.maximum propagate it.
__device__ __forceinline__ float eager_scale(float gnorm, float clip) {
  const float den = isnan(gnorm) ? gnorm : fmaxf(gnorm, 1e-12f);
  const float r = __fdiv_rn(clip, den);
  return isnan(r) ? r : fminf(r, 1.0f);
}

// Launch 1 of both forms: each block writes its chunk's f64 sum of g^2 (0
// for a tensor without F_NORM) and whether the chunk ends its tensor into
// ws; the last block of the last launch sums the chunks in order.
// ws: [2 * total chunks] f64 (the chunks' sums, then 1.0 where a chunk ends
// its tensor; with telemetry WS_SLOTS * total, slot 2 the chunks' counts of
// non-finite grads); base: this launch's first chunk; out: [2] f32 (gnorm,
// scale) written by the last block of the last launch:
//   pretrain: gnorm = sqrt of the sum of the squared f32 tensor norms,
//     scale min(1, clip * (1 / (gnorm + 1e-6))) (1 for clip 0);
//   eager: gnorm = sqrt(sum), scale eager_scale (1 for clip <= 0).
// sumsq_out (the mesh form, else null): the last block writes the sum of
// the chunks' sums there instead of gnorm and the scale.
__global__ void __launch_bounds__(NT)
adamw_sumsq_kernel(const TensorList L, double* ws, int base, int total,
                   int last_launch, unsigned int* counter, float* out,
                   float clip, int telemetry, int eager, double* sumsq_out) {
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
  if (L.flags[t] & F_NORM) {  // else a replica's shard: writes 0
    long long tail = start;
    if (aligned4(g, type)) {
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
      tail = end4;
    }
    for (long long i = tail + threadIdx.x; i < end; i += NT) {
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
  // in order. Only the pretrain form on one device takes each tensor's
  // norm; the others need the plain sum, whose walk has no branch on the
  // data (with the branch, the walk took 0.13 of the eager form's 0.45 ms
  // launch 1 at the flagship).
  const bool norms = !eager && sumsq_out == nullptr;
  __shared__ double sv[NT], sf[NT];
  double s = 0.0, sq = 0.0, all = 0.0;
  for (int c0 = 0; c0 < total; c0 += NT) {
    const int c = c0 + threadIdx.x;
    sv[threadIdx.x] = c < total ? __ldcg(ws + c) : 0.0;
    if (norms) sf[threadIdx.x] = c < total ? __ldcg(ws + total + c) : 0.0;
    __syncthreads();
    if (threadIdx.x == 0 && norms) {
      const int lim = min(NT, total - c0);
      for (int i = 0; i < lim; ++i) {
        s += sv[i];
        if (sf[i] != 0.0) {
          const float norm = (float)sqrt(s);
          sq += (double)norm * norm;
          s = 0.0;
        }
      }
    } else if (threadIdx.x == 0) {
      const int lim = min(NT, total - c0);
      for (int i = 0; i < lim; ++i) all += sv[i];
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  if (sumsq_out != nullptr) {
    *sumsq_out = all;
  } else if (eager) {
    const float gnorm = (float)sqrt(all);
    out[0] = gnorm;
    out[1] = clip > 0.0f ? eager_scale(gnorm, clip) : 1.0f;
  } else {
    const float gnorm = (float)sqrt(sq);
    out[0] = gnorm;
    // a NaN gnorm gives a NaN scale, as the plain version's clamp does
    const float r = __fmul_rn(__frcp_rn(__fadd_rn(gnorm, 1e-6f)), clip);
    out[1] = clip != 0.0f ? (isnan(r) ? r : fminf(r, 1.0f)) : 1.0f;
  }
}

// -- the pretrain form's launch 2 ----------------------------------------

struct Hyper {
  float b1, omb1, b2, omb2, rc1, rc2, eps, wd, neg_lr;
  int clip_on;
  float clip;
  const double* gsumsq;  // the mesh form: the global sum of squares
};

// The scale of a block of launch 2: launch 1's (out[1]), or in the mesh
// form from the global sum of squares, as launch 1's last block takes it
// on one device; block 0 writes gnorm and the scale to out.
__device__ __forceinline__ float block_scale(float* out, const Hyper& h) {
  if (h.gsumsq == nullptr) return out[1];
  const float gnorm = (float)sqrt(*h.gsumsq);
  const float r = __fmul_rn(__frcp_rn(__fadd_rn(gnorm, 1e-6f)), h.clip);
  const float scale =
      h.clip != 0.0f ? (isnan(r) ? r : fminf(r, 1.0f)) : 1.0f;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out[0] = gnorm;
    out[1] = scale;
  }
  return scale;
}

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
  const bool decay = (L.flags[t] & F_DECAY) != 0;
  float* p = (float*)L.p[t];
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
adamw_update_kernel(const TensorList L, float* out, const Hyper h) {
  const int b = blockIdx.x;
  const int t = find_tensor(L, b);
  const long long start = (long long)(b - L.chunk0[t]) * CHUNK;
  const long long end = min(L.n[t], start + CHUNK);
  TelSums tel;
  update_chunk<false>(L, t, start, end, block_scale(out, h), h, tel);
}

// Where the telemetry's walk writes: loss [1] f32 on the card, vec
// [2 + 4 * groups] f32; or in the mesh form (raw not null) the groups' raw
// f64 sums, raw [4 * groups], and no vec.
struct TelOut {
  const float* loss;
  float* vec;
  int groups;
  double* raw;
};

// Launch 2 with the telemetry: the update of adamw_update_kernel, each
// chunk's p^2 / du^2 sums and group into ws (slots 3-5, slot 0 and 2 as
// launch 1 left them), and the packed vector from the last block of the
// last launch.
__global__ void __launch_bounds__(NT)
adamw_update_tel_kernel(const TensorList L, float* out,
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
  update_chunk<true>(L, t, start, end, block_scale(out, h), h, tel);
  if (!(L.flags[t] & F_NORM)) tel = TelSums();  // a replica's shard: 0
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
  if (to.raw != nullptr) {
    if ((int)threadIdx.x < to.groups) {
      double* r = to.raw + 4 * threadIdx.x;
      r[0] = a0;
      r[1] = a1;
      r[2] = a2;
      r[3] = a3;
    }
    return;
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


// ---------------------------------------------------------------------------
// The eager form: the eager optimizer's AdamW and Adam with the global-norm
// clip (paddle_tpu_torch/optimizer), the math of the JAX package's
// paddle_tpu/optimizer/optimizers.py:25-42 _adam_update / _adamw_update,
// optimizer.py:141-146 _l2 and nn/clip.py:63-103 ClipGradByGlobalNorm, which
// XLA fuses (no pallas_call). Per tensor: p the f32 master or the
// parameter itself (f32 / bf16 / f16), out null or the parameter written as
// round(p) under multi_precision, g f32 / bf16 / f16, m and v f32, the
// tensor's own learning rate and weight decay (f32, lr_ratio, optimize_attr
// and its group folded in by the caller), 1 - lr wd for a decayed AdamW
// tensor, and flags: F_DECAY, F_CLIP (need_clip: the scale applies) and
// F_NORM (counted in the global norm; need_clip and, on sharded state,
// owned once over the ranks).
//   Launch 1: adamw_sumsq_kernel with eager set: gnorm = sqrt(sum of the
//   chunks' sums) rounded to f32, and the scale
//   min(clip / max(gnorm, 1e-12), 1), both left on the card. The mesh
//   form writes the sum to sumsq_out for the caller's all_reduce and
//   launch 2 takes gnorm and the scale from the global sum.
//   Launch 2: per element, in JAX's expression order with one rounding an
//   operation (no fused multiply-add, true divisions):
//     g = round_to_g(g * scale) where clipped (nn/clip.py:102)
//     g = g + wd * p            Adam's coupled L2 on decayed tensors
//     m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) (g g)
//     p = p (1 - lr wd) - (lr (m / c1)) / (sqrt(v / c2) + eps)
//   and p (and out) stored rounded to their dtypes.
// Bound: bytes. Launch 1 reads g, launch 2 reads g, p, m, v and writes p,
// m, v (and out). Each thread takes four elements at a time, each array in
// one 16-byte (f32) or 8-byte (16-bit) access, where the tensor's arrays
// are aligned to four elements; the rest elementwise.

__device__ __forceinline__ void store_any(void* x, int type, long long i,
                                          float f) {
  if (type == 1) ((__nv_bfloat16*)x)[i] = __float2bfloat16_rn(f);
  else if (type == 2) ((__half*)x)[i] = __float2half_rn(f);
  else ((float*)x)[i] = f;
}

// f rounded to the dtype `type` and back (the value a cast stores)
__device__ __forceinline__ float round_any(int type, float f) {
  if (type == 1) return __bfloat162float(__float2bfloat16_rn(f));
  if (type == 2) return __half2float(__float2half_rn(f));
  return f;
}

struct EagerHyper {
  float b1, omb1, b2, omb2, c1, c2, eps;
  int adam_l2, clip_on;
  float clip;
  const double* gsumsq;  // the mesh form: the all_reduced sum of squares
};

// One element's update from its grad g (as loaded) and base (the master
// or the parameter, as loaded); m and v in and out. Returns the new p.
__device__ __forceinline__ float eager_math(float g, float base, float& m,
                                           float& v, float scale,
                                           const EagerHyper& h, int gt,
                                           int fl, float lr, float keep,
                                           float wd) {
  if (h.clip_on && (fl & F_CLIP)) g = round_any(gt, __fmul_rn(g, scale));
  if (h.adam_l2 && (fl & F_DECAY)) g = __fadd_rn(g, __fmul_rn(wd, base));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.c2)), h.eps);
  const float upd = __fdiv_rn(__fmul_rn(lr, __fdiv_rn(m, h.c1)), denom);
  return __fsub_rn(__fmul_rn(base, keep), upd);
}

// four elements of a dtype-`type` array written at x[i..i+4), i a multiple
// of 4 and x aligned to 4 elements (the packing load_g4 reads)
__device__ __forceinline__ void store4_any(void* x, int type, long long i,
                                           const float (&f)[4]) {
  if (type == 0) {
    *reinterpret_cast<float4*>((float*)x + i) =
        make_float4(f[0], f[1], f[2], f[3]);
    return;
  }
  unsigned int e[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    e[k] = type == 1 ? __bfloat16_as_ushort(__float2bfloat16_rn(f[k]))
                     : __half_as_ushort(__float2half_rn(f[k]));
  *reinterpret_cast<uint2*>((unsigned short*)x + i) =
      make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
}

// every array of tensor t aligned to 4 of its elements: the 16- or 8-byte
// route
__device__ __forceinline__ bool eager_vec_ok(const TensorList& L, int t) {
  return aligned4(L.g[t], L.gtype[t]) && aligned4(L.p[t], L.ptype[t]) &&
         (L.out[t] == nullptr || aligned4(L.out[t], L.otype[t])) &&
         aligned4(L.m[t], 0) && aligned4(L.v[t], 0);
}

__global__ void __launch_bounds__(NT)
adamw_eager_update_kernel(const TensorList L, float* out,
                          const EagerHyper h) {
  const int b = blockIdx.x;
  const int t = find_tensor(L, b);
  const long long start = (long long)(b - L.chunk0[t]) * CHUNK;
  const long long end = min(L.n[t], start + CHUNK);
  float scale = 1.0f;
  if (h.gsumsq != nullptr) {
    const float gnorm = (float)sqrt(*h.gsumsq);
    scale = h.clip > 0.0f ? eager_scale(gnorm, h.clip) : 1.0f;
    if (b == 0 && threadIdx.x == 0) {
      out[0] = gnorm;
      out[1] = scale;
    }
  } else {
    scale = out[1];
  }
  const int gt = L.gtype[t], pt = L.ptype[t], fl = L.flags[t];
  const float lr = L.lr[t], keep = L.keep[t], wd = L.wd[t];
  float* m = L.m[t];
  float* v = L.v[t];
  long long tail = start;
  if (eager_vec_ok(L, t)) {
    // four elements a thread, each array in one 16- (or 8-) byte access
    const long long end4 = start + ((end - start) & ~3LL);
    for (long long i = start + threadIdx.x * 4; i < end4; i += NT * 4) {
      float g4[4], p4[4], np[4];
      load_g4(L.g[t], gt, i, g4);
      load_g4(L.p[t], pt, i, p4);
      float4 mm = *reinterpret_cast<const float4*>(m + i);
      float4 vv = *reinterpret_cast<const float4*>(v + i);
      np[0] = eager_math(g4[0], p4[0], mm.x, vv.x, scale, h, gt, fl, lr,
                         keep, wd);
      np[1] = eager_math(g4[1], p4[1], mm.y, vv.y, scale, h, gt, fl, lr,
                         keep, wd);
      np[2] = eager_math(g4[2], p4[2], mm.z, vv.z, scale, h, gt, fl, lr,
                         keep, wd);
      np[3] = eager_math(g4[3], p4[3], mm.w, vv.w, scale, h, gt, fl, lr,
                         keep, wd);
      *reinterpret_cast<float4*>(m + i) = mm;
      *reinterpret_cast<float4*>(v + i) = vv;
      store4_any(L.p[t], pt, i, np);
      if (L.out[t] != nullptr) store4_any(L.out[t], L.otype[t], i, np);
    }
    tail = end4;
  }
  for (long long i = tail + threadIdx.x; i < end; i += NT) {
    float mi = m[i], vi = v[i];
    const float np = eager_math(load_g(L.g[t], gt, i),
                                load_g(L.p[t], pt, i), mi, vi, scale, h,
                                gt, fl, lr, keep, wd);
    m[i] = mi;
    v[i] = vi;
    store_any(L.p[t], pt, i, np);
    if (L.out[t] != nullptr) store_any(L.out[t], L.otype[t], i, np);
  }
}

// -- host side ------------------------------------------------------------

// The caller's arrays, T long; a null array leaves its field at its
// default (null, 0, keep 1). flags null: the pretrain form's, from decay
// (F_DECAY) and owned (null: all owned; F_NORM).
struct Sources {
  void* const* p = nullptr;
  const int* ptype = nullptr;
  void* const* out = nullptr;
  const int* otype = nullptr;
  void* const* g = nullptr;
  const int* gtype = nullptr;
  void* const* m = nullptr;
  void* const* v = nullptr;
  const long long* n = nullptr;
  const float* lr = nullptr;
  const float* keep = nullptr;
  const float* wd = nullptr;
  const int* flags = nullptr;
  const int* decay = nullptr;
  const int* owned = nullptr;
  const int* group = nullptr;
};

// Fills L with tensors [t0, t0 + count) of S; returns this launch's chunks.
int fill(TensorList& L, int t0, int count, const Sources& S) {
  int c = 0;
  L.count = count;
  for (int i = 0; i < count; ++i) {
    const int t = t0 + i;
    L.p[i] = S.p ? S.p[t] : nullptr;
    L.out[i] = S.out ? S.out[t] : nullptr;
    L.g[i] = S.g[t];
    L.m[i] = S.m ? (float*)S.m[t] : nullptr;
    L.v[i] = S.v ? (float*)S.v[t] : nullptr;
    L.n[i] = S.n[t];
    L.lr[i] = S.lr ? S.lr[t] : 0.0f;
    L.keep[i] = S.keep ? S.keep[t] : 1.0f;
    L.wd[i] = S.wd ? S.wd[t] : 0.0f;
    L.gtype[i] = (unsigned char)S.gtype[t];
    L.ptype[i] = (unsigned char)(S.ptype ? S.ptype[t] : 0);
    L.otype[i] = (unsigned char)(S.otype ? S.otype[t] : 0);
    L.flags[i] = (unsigned char)(
        S.flags ? S.flags[t]
                : ((S.decay && S.decay[t]) ? F_DECAY : 0) |
                      ((!S.owned || S.owned[t]) ? F_NORM : 0));
    L.group[i] = (unsigned char)(S.group ? S.group[t] : 0);
    L.chunk0[i] = c;
    c += (int)((S.n[t] + CHUNK - 1) / CHUNK);
  }
  L.chunk0[count] = c;
  return c;
}

// The chunks of T tensors of n[T] elements (0 if more than an int holds).
long long total_chunks(int T, const long long* n) {
  long long total = 0;
  for (int t = 0; t < T; ++t) total += (n[t] + CHUNK - 1) / CHUNK;
  return total > 0x7fffffffLL ? 0 : total;
}

// The batch of MAX_T tensors whose launch finishes a reduction: that of
// the last tensor with elements.
int last_batch(int T, const long long* n) {
  int last = T - 1;
  while (last > 0 && n[last] == 0) --last;
  return last / MAX_T;
}

// Launch 1 of either form over S.g (ceil(T / MAX_T) launches).
int launch_sumsq(int T, const Sources& S, void* ws, void* counter, void* out,
                 float clip, int telemetry, int eager, void* sumsq_out,
                 cudaStream_t s) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  const long long total = total_chunks(T, S.n);
  if (total < 1) return (int)cudaErrorInvalidValue;
  const int lb = last_batch(T, S.n);
  int base = 0;
  for (int t0 = 0, bi = 0; t0 < T; t0 += MAX_T, ++bi) {
    TensorList L;
    const int chunks = fill(L, t0, std::min(MAX_T, T - t0), S);
    if (chunks > 0)
      adamw_sumsq_kernel<<<chunks, NT, 0, s>>>(
          L, (double*)ws, base, (int)total, bi == lb,
          (unsigned int*)counter, (float*)out, clip, telemetry, eager,
          (double*)sumsq_out);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    base += chunks;
  }
  return 0;
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
// clip 0 leaves the scale at 1. Tensors of 0 elements take no chunk. The
// mesh form: owned[T] (null: all 1) and sumsq_out, one f64 on the card that
// receives the sum of squares instead of out. Returns the CUDA error of
// the launches (0 on success).
int adamw_sumsq(int T, void* const* g, const long long* n, const int* gtype,
                void* ws, void* counter, void* out, float clip,
                int telemetry, const int* owned, void* sumsq_out,
                void* stream) {
  Sources S;
  S.g = g;
  S.n = n;
  S.gtype = gtype;
  S.owned = owned;
  return launch_sumsq(T, S, ws, counter, out, clip, telemetry, 0, sumsq_out,
                      (cudaStream_t)stream);
}

// Launch 2: p, m, v [T] f32 updated in place from g (as in adamw_sumsq),
// decay[T] 1 for the tensors that take weight decay, out as adamw_sumsq
// left it (the scale is read when clip_on); rc1 / rc2 the reciprocals of
// the bias corrections. With the telemetry (vec not null): group[T] (each
// tensor's group, 0 <= group < groups <= MAX_G), ws and counter as
// adamw_sumsq(telemetry=1) left them, loss [1] f32 and vec [2 + 4 groups]
// f32 on the card; without it group, ws, counter and loss are not read.
// The mesh form: owned[T] as adamw_sumsq had it, gsumsq the all_reduced
// f64 sum of squares (the scale is taken from it with clip, and gnorm and
// the scale written to out), and with the telemetry raw [4 groups] f64 in
// place of vec (which may then be null).
int adamw_update(int T, void* const* p, void* const* g, void* const* m,
                 void* const* v, const long long* n, const int* gtype,
                 const int* decay, const int* group, void* out, float b1,
                 float omb1, float b2, float omb2, float rc1, float rc2,
                 float eps, float wd, float neg_lr, int clip_on, void* ws,
                 void* counter, void* loss, void* vec, int groups,
                 const int* owned, const void* gsumsq, float clip, void* raw,
                 void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  const bool tel = vec != nullptr || raw != nullptr;
  long long total = 0;
  if (tel) {
    if (!group || !ws || !counter || !loss || groups < 1 || groups > MAX_G)
      return (int)cudaErrorInvalidValue;
    for (int t = 0; t < T; ++t)
      if (group[t] < 0 || group[t] >= groups)
        return (int)cudaErrorInvalidValue;
    total = total_chunks(T, n);
    if (total < 1) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const Hyper h{b1, omb1, b2, omb2, rc1, rc2, eps, wd, neg_lr, clip_on,
                clip, (const double*)gsumsq};
  const TelOut to{(const float*)loss, (float*)vec, groups, (double*)raw};
  Sources S;
  S.p = p;
  S.g = g;
  S.m = m;
  S.v = v;
  S.n = n;
  S.gtype = gtype;
  S.decay = decay;
  S.owned = owned;
  S.group = tel ? group : nullptr;
  const int lb = last_batch(T, n);
  int base = 0;
  for (int t0 = 0, bi = 0; t0 < T; t0 += MAX_T, ++bi) {
    TensorList L;
    const int chunks = fill(L, t0, std::min(MAX_T, T - t0), S);
    if (chunks > 0 && tel)
      adamw_update_tel_kernel<<<chunks, NT, 0, s>>>(
          L, (float*)out, h, (double*)ws, base, (int)total, bi == lb,
          (unsigned int*)counter, to);
    else if (chunks > 0)
      adamw_update_kernel<<<chunks, NT, 0, s>>>(L, (float*)out, h);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    base += chunks;
  }
  return 0;
}

// The eager form's launch 1 over T tensors' grads g[T] (n[T] elements,
// gtype[T] 0 f32 / 1 bf16 / 2 f16, flags[T] as F_*): ws holds 2 x (the
// sum of ceil(n / CHUNK)) doubles, counter one zeroed unsigned int (left
// zeroed), out [2] f32 receives (gnorm, scale); clip <= 0 leaves the scale
// at 1. The mesh form: sumsq_out (one f64 on the card) receives the sum of
// squares instead of out. Returns the CUDA error of the launches.
int adamw_eager_sumsq(int T, void* const* g, const long long* n,
                      const int* gtype, const int* flags, void* ws,
                      void* counter, void* out, float clip, void* sumsq_out,
                      void* stream) {
  Sources S;
  S.g = g;
  S.n = n;
  S.gtype = gtype;
  S.flags = flags;
  return launch_sumsq(T, S, ws, counter, out, clip, 0, 1, sumsq_out,
                      (cudaStream_t)stream);
}

// The eager form's launch 2: p[T] (ptype[T]) updated in place, outp[T]
// (null entries allowed; otype[T]) written as round(p), g as launch 1 had
// it, m, v [T] f32 in place, lr[T], keep[T] and wd[T] f32, flags[T]; out as
// launch 1 left it (the scale is read when clip_on). c1 = 1 - b1^t and
// c2 = 1 - b2^t are f32. adam_l2 1 adds Adam's wd p to the decayed
// tensors' grads. The mesh form: gsumsq the all_reduced f64 sum of squares
// (gnorm and the scale written to out by block 0).
int adamw_eager_update(int T, void* const* p, const int* ptype,
                       void* const* outp, const int* otype, void* const* g,
                       const int* gtype, void* const* m, void* const* v,
                       const long long* n, const float* lr,
                       const float* keep, const float* wd,
                       const int* flags, void* out, float b1, float omb1,
                       float b2, float omb2, float c1, float c2, float eps,
                       int adam_l2,
                       int clip_on, float clip, const void* gsumsq,
                       void* stream) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const EagerHyper h{b1, omb1, b2, omb2, c1, c2, eps, adam_l2, clip_on,
                     clip, (const double*)gsumsq};
  Sources S;
  S.p = p;
  S.ptype = ptype;
  S.out = outp;
  S.otype = otype;
  S.g = g;
  S.gtype = gtype;
  S.m = m;
  S.v = v;
  S.n = n;
  S.lr = lr;
  S.keep = keep;
  S.wd = wd;
  S.flags = flags;
  for (int t0 = 0; t0 < T; t0 += MAX_T) {
    TensorList L;
    const int chunks = fill(L, t0, std::min(MAX_T, T - t0), S);
    if (chunks > 0)
      adamw_eager_update_kernel<<<chunks, NT, 0, s>>>(L, (float*)out, h);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
