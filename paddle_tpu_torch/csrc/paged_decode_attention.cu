// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_decode_kernel`
// (paddle_tpu/ops/pallas/paged_attention.py:74, reached through
// `paged_attention` :118, pallas_call at :157): one query token per
// sequence attends over its paged KV cache, online softmax in f32.
//
// Layouts (the JAX package's, kept at the port's public function):
//   q       [B, H, D]           one query row per (sequence, head)
//   k/v     [KVH, NB, BS, D]    paged caches
//   tables  [B, MAXNB] int32    block ids of each sequence
//   lens    [B] int32           context length of each sequence
//   out     [B, H, D]
//
// Design. The TPU grid is (b, kv head, MAXNB) and runs in order, so the
// kernel carries m / l / acc in scratch from one block-table column to
// the next; every sequence pays MAXNB grid steps and skips the ones at or
// past its length (`i * BS >= ctx`, :88). Hopper blocks run in parallel
// and in no order, so here one block owns one (sequence, kv head) and a
// loop inside it walks that sequence's cache blocks. The G = H / KVH query
// rows of the kv head (rows h*G .. h*G+G-1 of q[b], the `q.reshape(b,
// kvh, g, d)` of :134) share each [BS, D] k and v tile, which is staged
// in shared memory as f32 (k rows padded by one word against bank
// conflicts). m, l and the [G, D] accumulator stay in shared memory.
//
// The walk covers min(ceil(ctx / BS), MAXNB) blocks and reads no table
// entry past the last of them: a real allocator leaves anything there
// (the TPU grid fetches every column and masks it). An id inside the walk
// is clamped into [0, NB) before the read, as the TPU's block index is.
// Inside a block only the positions below ctx take part (the Pallas mask
// `pos < ctx`, :98): their scores, their share of l and of acc; each
// walked block holds at least one of them, so the running max is a real
// score after the first block. A row with ctx = 0 walks nothing and
// writes exact zeros (acc 0, l 0 read as 1, :114). q, k and v are read as
// f32 and p is never rounded, as in the Pallas body.
//
// What bounds it: bytes. Each (sequence, kv head) reads its KV once for
// 4*G*D flops per key, about G flops per byte of bf16 cache, far below
// the ~295 flops per byte where the card's tensor cores would become the
// limit. The design reads every needed KV byte exactly once and keeps the
// softmax state on chip; the arithmetic runs on CUDA cores in f32. One
// block per (sequence, kv head) leaves most SMs idle at decode batch 8
// (64 blocks at 8 kv heads); splitting long sequences over several blocks
// is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per block
constexpr int MAX_BS = 128;      // largest cache block size supported
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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out, int H,
                    int KVH, int NB, int BS, int MAXNB, float scale) {
  const int h = blockIdx.x;                 // kv head
  const int b = blockIdx.y;                 // sequence
  const int tid = threadIdx.x;
  const int G = H / KVH;
  const int GD = G * D;

  extern __shared__ float smem[];
  float* qs = smem;                         // [G][D]
  float* acc = qs + GD;                     // [G][D]
  float* ks = acc + GD;                     // [BS][D + 1]
  float* vs = ks + BS * (D + 1);            // [BS][D]
  float* ps = vs + BS * D;                  // [G][BS]
  float* ms = ps + G * BS;                  // [G]
  float* ls = ms + G;                       // [G]
  float* cs = ls + G;                       // [G]

  const int ctx = lens[b];
  const int nblk = ctx > 0 ? min((ctx + BS - 1) / BS, MAXNB) : 0;
  const size_t row0 = ((size_t)b * H + (size_t)h * G) * D;
  for (int i = tid; i < GD; i += NT) {
    qs[i] = to_f(q[row0 + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }

  const int per = BS * D;
  for (int blk = 0; blk < nblk; ++blk) {
    int id = tables[(size_t)b * MAXNB + blk];
    id = min(max(id, 0), NB - 1);           // never read outside the pool
    const size_t base = ((size_t)h * NB + id) * per;
    __syncthreads();                        // previous tile fully used
    for (int i = tid; i < per; i += NT) {
      ks[(i / D) * (D + 1) + i % D] = to_f(kc[base + i]);
      vs[i] = to_f(vc[base + i]);
    }
    __syncthreads();
    const int live = min(BS, ctx - blk * BS);   // positions below ctx, >= 1

    // scores of the live positions: s = (q . k) * scale
    for (int i = tid; i < G * BS; i += NT) {
      const int g = i / BS, kk = i % BS;
      float s = NEG_INF;
      if (kk < live) {
        const float* qr = qs + g * D;
        const float* kr = ks + kk * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        s = dot * scale;
      }
      ps[i] = s;
    }
    __syncthreads();

    // online softmax update, one thread per query row
    for (int g = tid; g < G; g += NT) {
      float* pr = ps + g * BS;
      const float m_prev = ms[g];
      float m_new = m_prev;
      for (int kk = 0; kk < live; ++kk) m_new = fmaxf(m_new, pr[kk]);
      float sum = 0.f;
      for (int kk = 0; kk < BS; ++kk) {
        const float p = kk < live ? expf(pr[kk] - m_new) : 0.f;
        pr[kk] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      ls[g] = corr * ls[g] + sum;
      ms[g] = m_new;
      cs[g] = corr;
    }
    __syncthreads();

    // acc = acc * corr + p @ v over the live positions
    for (int i = tid; i < GD; i += NT) {
      const int g = i / D, d = i % D;
      const float* pr = ps + g * BS;
      float v = acc[i] * cs[g];
      for (int kk = 0; kk < live; ++kk) v += pr[kk] * vs[kk * D + d];
      acc[i] = v;
    }
  }
  __syncthreads();

  for (int i = tid; i < GD; i += NT) {
    float l = ls[i / D];
    l = (l == 0.f) ? 1.f : l;
    out[row0 + i] = from_f<T>(acc[i] / l);
  }
}

template <typename T, int D>
int launch_t(const void* q, const void* kc, const void* vc, const int* tables,
             const int* lens, void* out, int B, int H, int KVH, int NB,
             int BS, int MAXNB, float scale, cudaStream_t stream) {
  const int G = H / KVH;
  dim3 grid(KVH, B);
  const size_t smem = sizeof(float) *
      (2 * (size_t)G * D + (size_t)BS * (D + 1) + (size_t)BS * D +
       (size_t)G * BS + 3 * (size_t)G);
  auto kern = paged_decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, tables, lens, (T*)out, H, KVH,
      NB, BS, MAXNB, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* kc, const void* vc, const int* tables,
             const int* lens, void* out, int B, int H, int KVH, int NB,
             int BS, int MAXNB, int D, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_t<T, 32>(q, kc, vc, tables, lens, out, B, H, KVH, NB, BS, MAXNB, scale, stream);
    case 64: return launch_t<T, 64>(q, kc, vc, tables, lens, out, B, H, KVH, NB, BS, MAXNB, scale, stream);
    case 128: return launch_t<T, 128>(q, kc, vc, tables, lens, out, B, H, KVH, NB, BS, MAXNB, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Largest cache block size the kernel takes (the wrapper checks it).
int paged_decode_attention_max_block_size() { return MAX_BS; }

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, caches and out).
// Returns the CUDA error code of the launch (0 on success).
int paged_decode_attention_launch(int dtype, const void* q, const void* kc,
                                  const void* vc, const int* tables,
                                  const int* lens, void* out, int B, int H,
                                  int KVH, int NB, int BS, int MAXNB, int D,
                                  float scale, void* stream) {
  if (BS < 1 || BS > MAX_BS || KVH < 1 || H % KVH != 0 || NB < 1 ||
      MAXNB < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_d<float>(q, kc, vc, tables, lens, out, B, H, KVH, NB, BS, MAXNB, D, scale, s);
    case 1: return launch_d<__nv_bfloat16>(q, kc, vc, tables, lens, out, B, H, KVH, NB, BS, MAXNB, D, scale, s);
    case 2: return launch_d<__half>(q, kc, vc, tables, lens, out, B, H, KVH, NB, BS, MAXNB, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
