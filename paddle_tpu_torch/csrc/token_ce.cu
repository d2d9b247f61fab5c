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
// Forward: the row max m (and, with label smoothing, the sum of the f32
// logits), then S = sum exp(f32(round_T(x - m))) with the final m, JAX's
// order (the difference rounded in the logits' dtype T, then upcast): the
// rounding rules out an online softmax, whose rescaled partial sums round
// elsewhere, so the row has to stay on chip between the max and the
// exp-sum. lse = log S + m; the row's loss is lse - x[label] (with
// smoothing eps: (1 - eps) (lse - x[label]) + eps (lse - mean x)), 0 on
// rows whose label is ignore_index, NaN for a label outside [0, V) (JAX's
// gather fills). (m, S) is kept per row for the backward. Routes, which
// ops.token_ce.fwd_plan picks from the dtype and V alone and passes in:
//   "rows"     (V <= 32768 16-bit, 16384 f32): one block of NT_ROW a row,
//              the row read once into shared memory by cp.async, in
//              16-byte chunks from its first 16-byte boundary, the few
//              elements before it and after the last whole chunk by
//              scalar loads (V = 32001, GPT-2's 50257)
//              (token_ce_fwd_row_kernel, design note above it), one
//              compiled form per chunks-a-thread bucket (1, 2, 4, 8);
//   "cluster"  (up to 8 x that: Llama-3's 128256 in bf16 on 4 blocks, the
//              flagship's f32 logits on 2): the same body over a
//              thread-block cluster that splits the row, the max, the
//              smoothing sum and the exp-sum exchanged over DSMEM;
//   "two-pass" (wider rows): one block of NT a row, two passes over the
//              row, the second from L2 where it still holds it
//              (token_ce_fwd_kernel).
// A second launch, one block, sums the rows' losses and valid counts in a
// fixed order (each thread a fixed strided set of rows, then the warps'
// sums in warp order): sum, count and sum / max(count, 1), bit-equal from
// call to call. It stays a launch of its own: folding it behind a counter
// into the last block would save one launch gap and make that block read
// all N losses alone.
//
// The vocab-sharded form (token_ce_fwd_partial, fleet's
// ParallelCrossEntropy and the mesh step's vocab-parallel LM head): x
// holds columns [start, start + V) of a vocabulary split over ranks, and
// the same launch on the same route writes the row's partials (m_r, S_r =
// sum exp(round_T(x - m_r)), x[label - start] or 0) instead of its loss;
// the caller combines them over the ranks (a max, then one sum) and the
// backward below runs with the combined (M, S) and the offset `start`.
// JAX computes this with a shard_map (paddle_tpu/distributed/fleet/
// mp_layers.py:147) that XLA fuses: no pallas_call stands behind it.
//
// Backward, one block a row, one pass: dx = round_T(g_r (exp(f32(round_T(x
// - m))) / S - (1 - eps) [x is the label] - eps / V)), where g_r is the
// row's gradient: given per row (reduction none), one scalar (sum), or
// one scalar over max(count, 1) read on the device (mean; no host sync).
//
// Bound: bytes. At the flagship (16384 x 32000 bf16 logits) the forward
// must read the logits once (1.05 GB, 0.31 ms at 3.35 TB/s), as the rows
// route does; two passes over a 64 KB row cannot both be served from HBM
// once (132 SMs x 8 blocks x 64 KB in flight outgrow the 50 MB L2). The
// backward reads and writes
// them (2.1 GB, 0.63 ms). 16-byte accesses where V and the row stride are
// multiples of 8 and the base is 16-byte aligned.
#include <cooperative_groups.h>
#include <math.h>

#include "fused_tier.cuh"

using namespace fused_tier;
namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int NT_SUM = 1024;

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
token_ce_fwd_kernel(const T* __restrict__ x, const long long* __restrict__ lab,
                    float* __restrict__ loss, float* __restrict__ stats,
                    long long stride, int V, long long ignore, float one_m,
                    float smooth, long long start, float* __restrict__ part) {
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
    const long long l = lab[row], li = l - start;
    const bool in = li >= 0 && li < V;
    if (part != nullptr) {
      part[3 * row] = m;
      part[3 * row + 1] = s;
      part[3 * row + 2] = in ? to_f<T>(xr[li]) : 0.0f;
      return;
    }
    const float lse = logf(s) + m;
    float out = 0.0f;
    if (l != ignore) {
      const float gold = in ? to_f<T>(xr[li]) : NAN;
      out = lse - gold;
      if (smooth != 0.0f)
        out = one_m * out + smooth * (lse - tot / (float)V);
    }
    loss[row] = out;
    stats[2 * row] = m;
    stats[2 * row + 1] = s;
  }
}

// ---- forward, routes "rows" and "cluster": the row kept on chip ----
//
// A block of NT_ROW threads holds up to NT_ROW * NC 16-byte chunks of a
// row, NC a thread (thread t's chunks t + NT_ROW k, so a warp's accesses
// are 512 contiguous bytes): at most 64 KB, copied by cp.async straight
// into shared memory, so the registers stay free and three blocks (three
// rows, 192 KB) fit an SM: while one block computes, the others' rows
// stream in. Chunk j holds elements h0 + 8 j .. h0 + 8 j + 7, where h0 < 8
// counts the elements before the row's first 16-byte boundary (0 where V
// and the row stride are multiples of 8 and the base is aligned); the
// head [0, h0) and the tail after the last whole chunk, at most 7 + 7
// elements, go one each to the first threads of block 0 as scalar loads.
// The row max and the smoothing sum come from the chunks in shared memory,
// then the exp-sum from the same chunks with the final m (a thread reads
// only what it copied: no barrier). Route "cluster": rows wider than one
// block holds go to a cluster of CS blocks (2, 4 or 8), block q holding
// chunks q NT_ROW NC onwards; each block pushes its (max, sum) into every
// peer's shared memory, a cluster barrier, and each adds the CS values in
// rank order (the same order everywhere); the exp-sums go to rank 0 the
// same way. The sums: a thread's chunks in order (then its head or tail
// element), warp_sum's tree, the warps in warp order, the blocks in rank
// order: a function of the shape and the row's 16-byte phase alone.
constexpr int NT_ROW = 512;
constexpr int CLUSTER_MAX = 8;
constexpr int ROW_BLOCKS_PER_SM = 3;

__device__ __forceinline__ void cl_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cl_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// (max of a, sum of b) over the block, to every thread, in warp order.
__device__ __forceinline__ void block_max_sum(float& a, float& b,
                                              float (*red)[NT_ROW / 32]) {
  a = warp_max(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = a;
    red[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  a = red[0][0];
  b = red[1][0];
#pragma unroll
  for (int i = 1; i < NT_ROW / 32; ++i) {
    a = fmaxf(a, red[0][i]);
    b += red[1][i];
  }
}

template <typename T, int NC, bool CLUSTER>
__global__ void __launch_bounds__(NT_ROW, ROW_BLOCKS_PER_SM)
token_ce_fwd_row_kernel(const T* __restrict__ x,
                        const long long* __restrict__ lab,
                        float* __restrict__ loss, float* __restrict__ stats,
                        long long stride, int V, long long ignore,
                        float one_m, float smooth, long long start,
                        float* __restrict__ part) {
  __shared__ float red[2][2][NT_ROW / 32];
  __shared__ float peer[3][CLUSTER_MAX];     // m, sum, exp-sum of each rank
  extern __shared__ uint4 srow[];            // the block's chunks
  int cs = 1, rank = 0;
  long long row = blockIdx.x;
  if (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    cs = (int)cluster.num_blocks();
    rank = (int)cluster.block_rank();
    row = blockIdx.x / cs;
  }
  const T* xr = x + row * stride;
  const int h0 =
      min(V, (int)(((16 - ((uintptr_t)xr & 15)) & 15) / sizeof(T)));
  const int nfull = (V - h0) / 8;            // whole 16-byte chunks
  const int j0 = rank * NT_ROW * NC + threadIdx.x;
  Pack8<T>* sv = reinterpret_cast<Pack8<T>*>(srow) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < NC; ++k)
    if (j0 + NT_ROW * k < nfull)
      cp_async_pack<T>(sv + NT_ROW * k, xr + h0 + 8 * (j0 + NT_ROW * k));
  cp_async_commit();
  if (CLUSTER) cl_arrive();     // every peer started before any push
  // the head and the tail: one element each for block 0's first threads
  bool has_e = false;
  float xe = 0.0f;
  if (rank == 0) {
    const int t = threadIdx.x, tail = h0 + 8 * nfull;
    if (t < h0 || (t >= h0 && t - h0 < V - tail)) {
      xe = to_f<T>(xr[t < h0 ? t : tail + t - h0]);
      has_e = true;
    }
  }
  long long l = 0;
  float gold = 0.0f;
  if (threadIdx.x == 0 && rank == 0) {
    l = lab[row];
    const long long li = l - start;
    gold = (li >= 0 && li < V) ? to_f<T>(xr[li])
                               : (part != nullptr ? 0.0f : NAN);
  }
  cp_async_wait<0>();
  float mx = -INFINITY, tot = 0.0f;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (j0 + NT_ROW * k >= nfull) continue;
    float f[8];
    unpack<T>(sv[NT_ROW * k], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) mx = fmaxf(mx, f[i]);
    if (smooth != 0.0f) {
#pragma unroll
      for (int i = 0; i < 8; ++i) tot += f[i];
    }
  }
  if (has_e) {
    mx = fmaxf(mx, xe);
    tot += xe;
  }
  block_max_sum(mx, tot, red[0]);
  if (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    cl_wait();
    if (threadIdx.x < cs) {
      float* dst = cluster.map_shared_rank(&peer[0][0], (int)threadIdx.x);
      dst[rank] = mx;
      dst[CLUSTER_MAX + rank] = tot;
    }
    cl_arrive();
    cl_wait();
    mx = peer[0][0];
    tot = peer[1][0];
    for (int q = 1; q < cs; ++q) {
      mx = fmaxf(mx, peer[0][q]);
      tot += peer[1][q];
    }
  }
  const float m = mx;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (j0 + NT_ROW * k >= nfull) continue;
    float f[8];
    unpack<T>(sv[NT_ROW * k], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += expf(round_to<T>(f[i] - m));
  }
  if (has_e) s += expf(round_to<T>(xe - m));
  float unused = 0.0f;
  block_max_sum(unused, s, red[1]);
  if (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0)
      cluster.map_shared_rank(&peer[2][0], 0)[rank] = s;
    cl_arrive();
    cl_wait();
    if (rank != 0) return;
    s = peer[2][0];
    for (int q = 1; q < cs; ++q) s += peer[2][q];
  }
  if (threadIdx.x == 0) {
    if (part != nullptr) {
      part[3 * row] = m;
      part[3 * row + 1] = s;
      part[3 * row + 2] = gold;
      return;
    }
    const float lse = logf(s) + m;
    float out = 0.0f;
    if (l != ignore) {
      out = lse - gold;
      if (smooth != 0.0f)
        out = one_m * out + smooth * (lse - tot / (float)V);
    }
    loss[row] = out;
    stats[2 * row] = m;
    stats[2 * row + 1] = s;
  }
}

template <typename T, int NC>
int launch_rows(int cluster, const void* x, const long long* lab,
                float* loss, float* stats, long long N, long long stride,
                int V, long long ignore, float one_m, float smooth,
                long long start, float* part, cudaStream_t s) {
  const size_t smem = (size_t)NT_ROW * NC * sizeof(Pack8<T>);
  auto k = cluster == 1 ? token_ce_fwd_row_kernel<T, NC, false>
                        : token_ce_fwd_row_kernel<T, NC, true>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (cluster == 1) {
    k<<<(unsigned)N, NT_ROW, smem, s>>>((const T*)x, lab, loss, stats,
                                          stride, V, ignore, one_m, smooth,
                                          start, part);
    return (int)cudaGetLastError();
  }
  if (N * cluster > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(N * cluster));
  cfg.blockDim = dim3(NT_ROW);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, k, (const T*)x, lab, loss,
                                           stats, stride, V, ignore, one_m,
                                           smooth, start, part);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
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
                    long long ignore, long long start, float one_m,
                    float smooth, int gmode) {
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
      if (c + i + start == l) d -= hit;
      o[i] = gr == 0.0f ? 0.0f : d;
    }
    store8<T, VEC>(dr + c, n, o);
  }
}

template <typename T>
int launch_fwd(int chunks, int cluster, bool vec, const void* x,
               const long long* lab, float* loss, float* stats,
               float* totals, long long N, long long stride, int V,
               long long ignore, float one_m, float smooth, long long start,
               float* part, cudaStream_t s) {
  // the rows routes run what they are given or nothing: a compiled chunk
  // count (up to 64 KB a block), a cluster of 1 to 8 that holds the row
  if (chunks < 0 || (chunks > 0 && (chunks * (int)sizeof(Pack8<T>) > 128 ||
                     (chunks & (chunks - 1)) != 0 || cluster < 1 ||
                     cluster > CLUSTER_MAX ||
                     (long long)NT_ROW * 8 * chunks * cluster < V)))
    return (int)cudaErrorInvalidValue;
  int rc = 0;
#define ROWS(NC)                                                            \
  launch_rows<T, NC>(cluster, x, lab, loss, stats, N, stride, V, ignore,    \
                     one_m, smooth, start, part, s)
  if (chunks == 1) rc = ROWS(1);
  else if (chunks == 2) rc = ROWS(2);
  else if (chunks == 4) rc = ROWS(4);
  else if (chunks == 8) {
    if constexpr (sizeof(T) == 2) rc = ROWS(8);     // 8 only for 16-bit T
  } else if (vec) {
    token_ce_fwd_kernel<T, true><<<(unsigned)N, NT, 0, s>>>(
        (const T*)x, lab, loss, stats, stride, V, ignore, one_m, smooth,
        start, part);
  } else {
    token_ce_fwd_kernel<T, false><<<(unsigned)N, NT, 0, s>>>(
        (const T*)x, lab, loss, stats, stride, V, ignore, one_m, smooth,
        start, part);
  }
#undef ROWS
  if (rc != 0) return rc;
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || part != nullptr) return (int)e;
  token_ce_sum_kernel<<<1, NT_SUM, 0, s>>>(loss, lab, N, ignore, totals);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(bool vec, const void* x, const long long* lab,
               const float* stats, const float* g, const float* totals,
               void* dx, long long N, long long stride, long long dstride,
               int V, long long ignore, long long start, float one_m,
               float smooth, int gmode, cudaStream_t s) {
  if (vec)
    token_ce_bwd_kernel<T, true><<<(unsigned)N, NT, 0, s>>>(
        (const T*)x, lab, stats, g, totals, (T*)dx, stride, dstride, V,
        ignore, start, one_m, smooth, gmode);
  else
    token_ce_bwd_kernel<T, false><<<(unsigned)N, NT, 0, s>>>(
        (const T*)x, lab, stats, g, totals, (T*)dx, stride, dstride, V,
        ignore, start, one_m, smooth, gmode);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16 (logits). x [N, V] at row
// stride `stride` (elements), labels [N] int64, loss [N] f32, stats [N, 2]
// f32 (row max, sum of exp), totals [3] f32. one_m = 1 - smoothing. vec: V
// and the stride multiples of 8, x 16-byte aligned. The route, from
// ops.token_ce.fwd_plan: chunks of 16 bytes a thread holds (0: route
// "two-pass") and blocks a row (1 "rows", 2-8 "cluster"); a route that
// cannot run the shape returns cudaErrorInvalidValue. Returns the CUDA
// error of the launches (0 on success), -1 for a dtype not built.
int token_ce_fwd(int dtype, int vec, const void* x, const void* labels,
                 void* loss, void* stats, void* totals, long long N,
                 long long stride, int V, long long ignore, float one_m,
                 float smooth, int chunks, int cluster, void* stream) {
  if (N < 0 || V < 1 || N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (N == 0) {
    token_ce_sum_kernel<<<1, NT_SUM, 0, s>>>(
        (const float*)loss, (const long long*)labels, 0, ignore,
        (float*)totals);
    return (int)cudaGetLastError();
  }
#define CALL(T)                                                             \
  launch_fwd<T>(chunks, cluster, vec != 0, x, (const long long*)labels,    \
                (float*)loss, (float*)stats, (float*)totals, N, stride, V,  \
                ignore, one_m, smooth, 0, nullptr, s)
  if (dtype == F32) return CALL(float);
  if (dtype == BF16) return CALL(__nv_bfloat16);
  if (dtype == F16) return CALL(__half);
#undef CALL
  return -1;
}

// The vocab-sharded form: x [N, V] holds columns [start, start + V) of a
// vocabulary split over ranks. One launch on the same route as
// token_ce_fwd writes part [N, 3] f32 per row: the shard's max m_r, its
// sum of exp(round_T(x - m_r)) and the label's logit x[label - start]
// where the label falls in the shard, else 0. The caller combines the
// ranks' rows (ops.token_ce.combine_partials); no loss, no totals.
int token_ce_fwd_partial(int dtype, int vec, const void* x,
                         const void* labels, void* part, long long N,
                         long long stride, int V, long long start,
                         int chunks, int cluster, void* stream) {
  if (N < 0 || V < 1 || N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(T)                                                             \
  launch_fwd<T>(chunks, cluster, vec != 0, x, (const long long*)labels,    \
                nullptr, nullptr, nullptr, N, stride, V, 0, 1.0f, 0.0f,     \
                start, (float*)part, s)
  if (dtype == F32) return CALL(float);
  if (dtype == BF16) return CALL(__nv_bfloat16);
  if (dtype == F16) return CALL(__half);
#undef CALL
  return -1;
}

// g: [N] f32 (gmode 0) or a 0-dim f32 (1: sum, 2: mean over totals[1]);
// dx [N, V] in the logits' dtype at row stride dstride. start: the first
// vocabulary column x holds (0 but for the vocab-sharded form, whose
// stats are the combined (M, S) of the whole row): the one-hot lands at
// column label - start, nowhere for a label outside the shard.
int token_ce_bwd(int dtype, int vec, const void* x, const void* labels,
                 const void* stats, const void* g, const void* totals,
                 void* dx, long long N, long long stride, int V,
                 long long ignore, long long start, float one_m,
                 float smooth, int gmode, void* stream) {
  if (N < 0 || V < 1 || N > 0x7fffffffLL || gmode < 0 || gmode > 2)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(T)                                                             \
  launch_bwd<T>(vec != 0, x, (const long long*)labels, (const float*)stats, \
                (const float*)g, (const float*)totals, dx, N, stride, V,    \
                V, ignore, start, one_m, smooth, gmode, s)
  if (dtype == F32) return CALL(float);
  if (dtype == BF16) return CALL(__nv_bfloat16);
  if (dtype == F16) return CALL(__half);
#undef CALL
  return -1;
}

}  // extern "C"
