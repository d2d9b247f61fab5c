// Ragged paged attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_ragged_kernel`
// (paddle_tpu/ops/pallas/paged_attention.py:484, reached through
// `ragged_paged_attention`, pallas_call at :703): mixed prefill/decode
// attention over a paged KV cache, online softmax in f32, intra-chunk
// causal mask, grouped-query heads.
//
// Layouts (the JAX package's, kept at the port's public function):
//   q       [B, C, H, D]        query rows, C = 1 for decode
//   k/v     [KVH, NB, BS, D]    paged caches
//   tables  [B, MAXNB] int32    block ids of each sequence
//   lens    [B] int32           context length INCLUDING this step's span
//   qlens   [B] int32 or NULL   query span per sequence (NULL: one query)
//   out     [B, C, H, D]
//
// Design. The TPU grid is sequential: (kv_head, work entry) carries
// m / l / acc from one grid step to the next through the wfirst/wlast
// flags, which only works because TPU grid steps run in order. Hopper
// blocks run in parallel and in no order, so the parallel unit here is
// (kv head, sequence, tile of ROWS query rows), and a loop inside the
// block walks that sequence's KV blocks. A sequence's rows for one kv
// head are its C*G query rows (row = j*G + g: chunk position j, group
// row g; query head = kv_head*G + g). Each KV block is staged in shared
// memory as f32 (K rows padded by one word against bank conflicts),
// m and l stay in shared memory per row, and the [ROWS, D] accumulator
// stays in registers, spread over the block's threads. The next KV block
// is fetched into registers before the current one is used, so its
// global-memory latency overlaps the current block's arithmetic.
//
// The block ids come from the block table, not from the host's work
// list: one block walks one sequence, and the table row already holds
// that sequence's ids contiguously, where the group-major work list
// would need an extra per-sequence offset index. The host still builds
// one work list per step; its padded length keys the serving step's
// buckets and its counters.
//
// Masking is the TPU kernel's (:548-554): row (j, g) is live when
// j < q_len; key position pos is visible when pos <= q_start + j, with
// q_start = max(len - q_len, 0). NEG_INF is -1e30 and l == 0 divides by
// one. Dead rows (j >= q_len, len 0) write zeros (:713-720). Only the
// first min(ceil(len / BS), MAXNB) blocks are walked (an over-capacity
// len attends over the table's capacity), block ids are clamped into
// [0, NB) before any read (as `kdma` does at :497, so a -1 free-slot id
// never faults), and a tile skips the blocks past its last row's causal
// horizon, which are fully masked and would be exact no-ops.
//
// What bounds it: bytes. A decode row attends with G query rows per kv
// head, so each (kv head, sequence) reads its whole KV once for 4*G*D
// flops per key: about G flops per byte of bf16 KV, far below the ~295
// the card needs before its tensor cores, not its memory, are the
// limit. The design reads every needed KV byte exactly once per (kv
// head, sequence, row tile) and keeps all softmax state on chip; the
// arithmetic runs on CUDA cores in f32. A split of long sequences over
// several blocks (more parallelism at small batch) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per block
constexpr int ROWS = 16;         // query rows per block
constexpr int MAX_BS = 32;       // largest cache block size supported
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
ragged_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ tables,
              const int* __restrict__ lens, const int* __restrict__ qlens,
              T* __restrict__ out, int C, int H, int KVH, int NB, int BS,
              int MAXNB, float scale) {
  constexpr int ACC = ROWS * D / NT;             // accumulator per thread
  constexpr int PF = (MAX_BS * D + NT - 1) / NT; // prefetch per thread
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.z * ROWS;
  const int tid = threadIdx.x;
  const int G = H / KVH;
  const int span = C * G;

  extern __shared__ float smem[];
  float* qs = smem;                         // [ROWS][D]
  float* ks = qs + ROWS * D;                // [BS][D + 1]
  float* vs = ks + BS * (D + 1);            // [BS][D]
  float* ps = vs + BS * D;                  // [ROWS][BS]
  float* ms = ps + ROWS * BS;               // [ROWS]
  float* ls = ms + ROWS;                    // [ROWS]
  float* cs = ls + ROWS;                    // [ROWS]

  const int len = lens[b];
  const int ql = qlens ? qlens[b] : 1;
  const int qstart = max(len - ql, 0);
  int nblk = 0;
  if (len > 0 && ql > 0) nblk = min((len + BS - 1) / BS, MAXNB);
  // causal horizon of this tile: its last live row's last visible key
  const int jlast = min(ql - 1, (min(row0 + ROWS, span) - 1) / G);
  if (row0 / G >= ql) {
    nblk = 0;                               // no live row in the tile
  } else {
    nblk = min(nblk, (qstart + jlast) / BS + 1);
  }

  for (int i = tid; i < ROWS * D; i += NT) {
    const int r = i / D, d = i % D, gr = row0 + r;
    float v = 0.f;
    if (gr < span) {
      const int j = gr / G, h = kvh * G + gr % G;
      v = to_f(q[((size_t)(b * C + j) * H + h) * D + d]);
    }
    qs[i] = v;
  }
  if (tid < ROWS) {
    ms[tid] = NEG_INF;
    ls[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const int per = BS * D;
  T kreg[PF], vreg[PF];
  auto fetch = [&](int blk) {
    int id = tables[(size_t)b * MAXNB + blk];
    id = min(max(id, 0), NB - 1);           // never read outside the pool
    const size_t base = ((size_t)kvh * NB + id) * per;
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      const int i = tid + p * NT;
      if (i < per) {
        kreg[p] = kc[base + i];
        vreg[p] = vc[base + i];
      }
    }
  };
  if (nblk > 0) fetch(0);

  for (int blk = 0; blk < nblk; ++blk) {
    __syncthreads();                        // previous block fully used
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      const int i = tid + p * NT;
      if (i < per) {
        ks[(i / D) * (D + 1) + i % D] = to_f(kreg[p]);
        vs[i] = to_f(vreg[p]);
      }
    }
    if (blk + 1 < nblk) fetch(blk + 1);     // in flight during the math
    __syncthreads();

    // scores: s = (q . k) * scale for live (row, key) pairs
    for (int i = tid; i < ROWS * BS; i += NT) {
      const int r = i / BS, kk = i % BS, gr = row0 + r;
      const int j = gr / G, pos = blk * BS + kk;
      float s = NEG_INF;
      if (gr < span && j < ql && pos <= qstart + j) {
        const float* qr = qs + r * D;
        const float* kr = ks + kk * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        s = dot * scale;
      }
      ps[i] = s;
    }
    __syncthreads();

    // online softmax update, one thread per row
    if (tid < ROWS) {
      const int r = tid, gr = row0 + r, j = gr / G;
      const bool row_live = gr < span && j < ql;
      const float m_prev = ms[r];
      float m_new = m_prev;
      if (row_live) {
        for (int kk = 0; kk < BS; ++kk) {
          if (blk * BS + kk <= qstart + j) m_new = fmaxf(m_new, ps[r * BS + kk]);
        }
      }
      float sum = 0.f;
      for (int kk = 0; kk < BS; ++kk) {
        const bool vis = row_live && blk * BS + kk <= qstart + j;
        const float p = vis ? expf(ps[r * BS + kk] - m_new) : 0.f;
        ps[r * BS + kk] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      ls[r] = corr * ls[r] + sum;
      ms[r] = m_new;
      cs[r] = corr;
    }
    __syncthreads();

    // acc = acc * corr + p @ v
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int idx = tid + a * NT;
      const int r = idx / D, d = idx % D;
      float v = acc[a] * cs[r];
      const float* pr = ps + r * BS;
      for (int kk = 0; kk < BS; ++kk) v += pr[kk] * vs[kk * D + d];
      acc[a] = v;
    }
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int idx = tid + a * NT;
    const int r = idx / D, d = idx % D, gr = row0 + r;
    if (gr >= span) continue;
    const int j = gr / G, h = kvh * G + gr % G;
    float l = ls[r];
    l = (l == 0.f) ? 1.f : l;
    const float o = (j < ql && len > 0) ? acc[a] / l : 0.f;
    out[((size_t)(b * C + j) * H + h) * D + d] = from_f<T>(o);
  }
}

template <typename T, int D>
int launch_t(const void* q, const void* kc, const void* vc, const int* tables,
             const int* lens, const int* qlens, void* out, int B, int C,
             int H, int KVH, int NB, int BS, int MAXNB, float scale,
             cudaStream_t stream) {
  const int G = H / KVH;
  dim3 grid(KVH, B, (C * G + ROWS - 1) / ROWS);
  const size_t smem = sizeof(float) *
      (ROWS * D + BS * (D + 1) + BS * D + ROWS * BS + 3 * ROWS);
  auto kern = ragged_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, tables, lens, qlens, (T*)out,
      C, H, KVH, NB, BS, MAXNB, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* kc, const void* vc, const int* tables,
             const int* lens, const int* qlens, void* out, int B, int C,
             int H, int KVH, int NB, int BS, int MAXNB, int D, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 32: return launch_t<T, 32>(q, kc, vc, tables, lens, qlens, out, B, C, H, KVH, NB, BS, MAXNB, scale, stream);
    case 64: return launch_t<T, 64>(q, kc, vc, tables, lens, qlens, out, B, C, H, KVH, NB, BS, MAXNB, scale, stream);
    case 128: return launch_t<T, 128>(q, kc, vc, tables, lens, qlens, out, B, C, H, KVH, NB, BS, MAXNB, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Largest cache block size the kernel takes (the wrapper checks it).
int ragged_paged_attention_max_block_size() { return MAX_BS; }

// dtype: 0 float32, 1 bfloat16, 2 float16. qlens may be NULL (decode).
// Returns the CUDA error code of the launch (0 on success).
int ragged_paged_attention_launch(int dtype, const void* q, const void* kc,
                                  const void* vc, const int* tables,
                                  const int* lens, const int* qlens,
                                  void* out, int B, int C, int H, int KVH,
                                  int NB, int BS, int MAXNB, int D,
                                  float scale, void* stream) {
  if (BS < 1 || BS > MAX_BS || KVH < 1 || H % KVH != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_d<float>(q, kc, vc, tables, lens, qlens, out, B, C, H, KVH, NB, BS, MAXNB, D, scale, s);
    case 1: return launch_d<__nv_bfloat16>(q, kc, vc, tables, lens, qlens, out, B, C, H, KVH, NB, BS, MAXNB, D, scale, s);
    case 2: return launch_d<__half>(q, kc, vc, tables, lens, qlens, out, B, C, H, KVH, NB, BS, MAXNB, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
