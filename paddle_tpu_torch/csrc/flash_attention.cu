// Flash attention forward and fused backward for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces two TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   `_fwd_kernel` (:78, reached through `_flash_fwd` :169, pallas_call
//   :195): causal or full softmax(q k^T * scale) v with online softmax,
//   saving the row logsumexp;
//   `_bwd_fused_kernel` (:223, reached through `_flash_bwd` :430,
//   pallas_call :458): dq, dk and dv from (q, k, v, o, lse, do) in one
//   pass over the (k tile, q tile) pairs.
// Both take the optional neox rope operands of the TPU kernels
// (`rope_cos` / `rope_sin`, :58-75): q and k are rotated inside the kernel
// and the rotated tensors never reach device memory.
//
// Layouts (the JAX package's kernel contract, heads folded into batch):
//   q, o, do   [BH, Sq, D]     float32 / bfloat16 / float16
//   k, v       [BH, Sk, D]
//   lse        [BH, Sq] f32    (the TPU's [BH, 8, S] is a lane-tiling
//                               artifact; all 8 rows there are equal)
//   dq_acc     [BH, Sq, D] f32 zeroed by the caller, summed atomically
//   delta      [BH, Sq] f32    scratch: rowsum(do * o)
//   dk, dv     [BH, Sk, D]     q's dtype
//   rcos, rsin [S, D/2] f32    rope tables, S >= Sq and Sk, or both null;
//                              row p rotates the q and k rows at position p
// D is 32, 64 or 128. Any Sq, Sk: tiles past the end are zero-filled and
// masked. The causal mask is top-left aligned (row >= col), as the TPU
// kernel's (:121).
//
// Arithmetic follows the Pallas bodies step for step: products of the
// input dtype accumulated in f32, scores scaled after the dot, running max
// and denominator in f32, p rounded to v's dtype before p @ v (:134), and
// in the backward p rounded to q's dtype before p^T do and ds rounded to
// q's dtype before ds^T q and ds k (:281-290). Fully masked rows give
// zeros and lse = NEG_INF (:148). Rope rotates a tile in the input dtype
// as `_rope_fwd` (:58) does, rounding after each product and each sum, and
// counter-rotates the f32 dq and dk as `_rope_bwd` (:69) does.
//
// Design. Tiles of 64 query rows by 64 keys, 256 threads as a 16 x 16
// grid; every thread holds a small register tile of each product and the
// operands are staged in shared memory as f32 (row padding of 4 floats
// keeps float4 reads aligned and the column walks free of bank conflicts;
// the tile helpers are in flash_tiles.cuh, shared with flashmask.cu).
//   Forward: one block per (bh, q tile) walks the k tiles up to the
//   diagonal (tiles strictly above it are skipped, :141). A thread's
//   score rows are also its output rows, so m / l / the [rows, D]
//   accumulator stay in registers; row reductions are 16-lane shuffles.
//   Backward (the FA2 layout): one block per (bh, k tile) keeps K and V
//   and the dk / dv accumulators on chip and walks the q tiles (32 rows
//   each) from the diagonal down, computing s, p, dp and ds once per
//   pair and contracting them into dv += p^T do, dk += ds^T q and a dq
//   contribution ds k that is added into dq_acc with atomicAdd. The TPU
//   kernel's per-k-tile dq partials [nk, BH, S, D] would cost nk times
//   dq's bytes (2 GB per layer at the flagship shape); the atomics cost
//   one f32 buffer, and f32 addition order makes dq non-deterministic in
//   its last bits. delta = rowsum(do * o) is one small pre-pass kernel.
//   Rope: the loop-invariant tile is rotated once in shared memory (q in
//   the forward, k in the backward, as the TPU kernel's scratch, :94-98 and
//   :245-247) and the walked tile after each load. A dq contribution is
//   counter-rotated in registers before its atomicAdd, dk once at the end:
//   the neox partner of a thread's column j is column j +- D/2, held by the
//   lane tx ^ 8 of the same half-warp.
//
// What bounds it: at the flagship shape (S = 2048, D = 64, causal)
// operations — the forward does about 500 flops per byte it must move,
// above the ~295 at which the bf16 tensor cores, not memory, are the
// limit. This first kernel runs its products on CUDA cores in f32
// (67 TFLOP/s peak, not the 989 of bf16 tensor cores); mma / wgmma tiles
// are later work.

#include "flash_tiles.cuh"

namespace {

constexpr int BQ = 64;           // forward: query rows per tile
constexpr int BQB = 32;          // backward: query rows per tile
constexpr int BK = 64;           // key rows per tile

// Neox rotation of a tile held as f32 in shared memory, element (r, d) at
// X[r * RS + d * DS], for the sequence rows [row0, row0 + rows): each
// product and each sum is rounded to T, the plain version's arithmetic in
// the tile's dtype; __fmul_rn / __fadd_rn keep the compiler from
// contracting them into FMAs. Rows past the end stay zero.
template <typename T, int D>
__device__ __forceinline__ void rope_tile(float* X, int RS, int DS,
                                          const float* __restrict__ rcos,
                                          const float* __restrict__ rsin,
                                          int row0, int rows, int total) {
  constexpr int HALF = D / 2;
  for (int i = threadIdx.x; i < rows * HALF; i += NT) {
    const int r = i / HALF, j = i % HALF, gr = row0 + r;
    if (gr >= total) continue;
    const float c = round_to<T>(rcos[(size_t)gr * HALF + j]);
    const float s = round_to<T>(rsin[(size_t)gr * HALF + j]);
    float* p1 = X + r * RS + j * DS;
    float* p2 = X + r * RS + (j + HALF) * DS;
    const float x1 = *p1, x2 = *p2;
    *p1 = round_to<T>(__fsub_rn(round_to<T>(__fmul_rn(x1, c)),
                                round_to<T>(__fmul_rn(x2, s))));
    *p2 = round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(x2, c)),
                                round_to<T>(__fmul_rn(x1, s))));
  }
}

// Counter-rotation (the transpose of rope_tile, in f32) of a gradient held
// in registers: the thread's rows row0 + ii, columns tx * RD + dd. Lanes
// tx < 8 hold the first half of the row, their partners tx + 8 the second.
template <int R, int RD, int D>
__device__ __forceinline__ void rope_bwd_regs(float (&x)[R][RD],
                                              const float* __restrict__ rcos,
                                              const float* __restrict__ rsin,
                                              int row0, int total, int tx) {
  constexpr int HALF = D / 2;
  const bool first = tx < 8;
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    const int row = row0 + ii;
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) {
      const float other = __shfl_xor_sync(0xffffffffu, x[ii][dd], 8);
      const int j = (tx * RD + dd) % HALF;
      const float c = row < total ? rcos[(size_t)row * HALF + j] : 1.f;
      const float s = row < total ? rsin[(size_t)row * HALF + j] : 0.f;
      x[ii][dd] = first ? __fadd_rn(__fmul_rn(x[ii][dd], c), __fmul_rn(other, s))
                        : __fsub_rn(__fmul_rn(x[ii][dd], c), __fmul_rn(other, s));
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const float* __restrict__ rcos,
                 const float* __restrict__ rsin, int Sq, int Sk, float scale,
                 int causal) {
  constexpr int LDQ = D + PAD;    // Qs [BQ][LDQ]
  constexpr int LDK = BK + PAD;   // Kt [D][LDK], Ps [BQ][LDK]
  constexpr int LDV = D + PAD;    // Vs [BK][LDV]
  constexpr int RI = BQ / 16;     // rows per thread
  constexpr int RJ = BK / 16;     // score columns per thread
  constexpr int RD = D / 16;      // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Kt = Qs + BQ * LDQ;
  float* Vs = Kt + D * LDK;
  float* Ps = Vs + BK * LDV;

  const int bh = blockIdx.y;
  // the longest causal rows first, so they do not trail the grid
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;

  load_tile<T, D, LDQ, false>(Qs, qb, q0, BQ, Sq);
  if (rcos) {                              // the q tile is loop-invariant: rotate once
    __syncthreads();
    rope_tile<T, D>(Qs, LDQ, 1, rcos, rsin, q0, BQ, Sq);
  }
  float m[RI], l[RI], acc[RI][RD];
#pragma unroll
  for (int ii = 0; ii < RI; ++ii) {
    m[ii] = NEG_INF;
    l[ii] = 0.f;
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) acc[ii][dd] = 0.f;
  }
  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);  // skip tiles above the diagonal

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                       // the previous tile is consumed
    load_tile<T, D, LDK, true>(Kt, kb, k0, BK, Sk);
    load_tile<T, D, LDV, false>(Vs, vb, k0, BK, Sk);
    __syncthreads();
    if (rcos) {
      rope_tile<T, D>(Kt, 1, LDK, rcos, rsin, k0, BK, Sk);
      __syncthreads();
    }

    float s[RI][RJ];
#pragma unroll
    for (int ii = 0; ii < RI; ++ii) {
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) s[ii][jj] = 0.f;
    }
    tile_mma<RI, RJ, D, LDQ, LDK, false>(s, Qs, Kt, ty, tx);

#pragma unroll
    for (int ii = 0; ii < RI; ++ii) {
      const int row = q0 + ty * RI + ii;
      bool vis[RJ];
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        const int col = k0 + tx * RJ + jj;
        vis[jj] = col < Sk && (!causal || row >= col);
        s[ii][jj] = vis[jj] ? s[ii][jj] * scale : NEG_INF;
        mx = fmaxf(mx, s[ii][jj]);
      }
      const float m_new = fmaxf(m[ii], row_max(mx));
      const float corr = expf(m[ii] - m_new);
      float p[RJ], psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        const float e = vis[jj] ? expf(s[ii][jj] - m_new) : 0.f;
        psum += e;
        p[jj] = round_to<T>(e);            // p in v's dtype before p @ v
      }
      store_vec<RJ>(Ps + (ty * RI + ii) * LDK + tx * RJ, p);
      l[ii] = corr * l[ii] + row_sum(psum);
      m[ii] = m_new;
#pragma unroll
      for (int dd = 0; dd < RD; ++dd) acc[ii][dd] *= corr;
    }
    __syncthreads();
    tile_mma<RI, RD, BK, LDK, LDV, false>(acc, Ps, Vs, ty, tx);
  }

#pragma unroll
  for (int ii = 0; ii < RI; ++ii) {
    const int row = q0 + ty * RI + ii;
    if (row >= Sq) continue;
    const float lz = l[ii] == 0.f ? 1.f : l[ii];   // fully masked rows -> zeros
    T* orow = o + ((size_t)bh * Sq + row) * D + tx * RD;
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) orow[dd] = from_f<T>(acc[ii][dd] / lz);
    if (tx == 0) lse[(size_t)bh * Sq + row] = m[ii] + logf(lz);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ lse,
                 const float* __restrict__ delta, const T* __restrict__ dout,
                 float* __restrict__ dq_acc, T* __restrict__ dk,
                 T* __restrict__ dv, const float* __restrict__ rcos,
                 const float* __restrict__ rsin, int Sq, int Sk, float scale,
                 int causal) {
  constexpr int LDD = D + PAD;    // Qs, dOs [BQB][LDD]; Ks [BK][LDD]
  constexpr int LDK = BK + PAD;   // Kt, Vt [D][LDK]; Ps, dSs [BQB][LDK]
  constexpr int RS = BQB / 16;    // score rows per thread
  constexpr int RJ = BK / 16;     // score columns per thread
  constexpr int RK = BK / 16;     // dk / dv rows per thread
  constexpr int RD = D / 16;      // columns of D per thread
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);
  float* Vt = Kt + D * LDK;
  float* Ks = Vt + D * LDK;
  float* Qs = Ks + BK * LDD;
  float* dOs = Qs + BQB * LDD;
  float* Ps = dOs + BQB * LDD;
  float* dSs = Ps + BQB * LDK;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;          // the longest causal walks first
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;

  load_tile<T, D, LDK, true>(Kt, k + koff, k0, BK, Sk);
  load_tile<T, D, LDK, true>(Vt, v + koff, k0, BK, Sk);
  load_tile<T, D, LDD, false>(Ks, k + koff, k0, BK, Sk);
  if (rcos) {                              // the k tile is loop-invariant: rotate once
    __syncthreads();
    rope_tile<T, D>(Kt, 1, LDK, rcos, rsin, k0, BK, Sk);
    rope_tile<T, D>(Ks, LDD, 1, rcos, rsin, k0, BK, Sk);
  }
  float dK[RK][RD], dV[RK][RD];
#pragma unroll
  for (int ii = 0; ii < RK; ++ii) {
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) { dK[ii][dd] = 0.f; dV[ii][dd] = 0.f; }
  }
  const int nq = (Sq + BQB - 1) / BQB;
  const int qt0 = causal ? k0 / BQB : 0;   // q tiles wholly above the diagonal see no key here

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * BQB;
    __syncthreads();                       // the previous q tile is consumed
    load_tile<T, D, LDD, false>(Qs, q + qoff, q0, BQB, Sq);
    load_tile<T, D, LDD, false>(dOs, dout + qoff, q0, BQB, Sq);
    __syncthreads();
    if (rcos) {
      rope_tile<T, D>(Qs, LDD, 1, rcos, rsin, q0, BQB, Sq);
      __syncthreads();
    }

    float s[RS][RJ], dp[RS][RJ];
#pragma unroll
    for (int ii = 0; ii < RS; ++ii) {
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) { s[ii][jj] = 0.f; dp[ii][jj] = 0.f; }
    }
    tile_mma<RS, RJ, D, LDD, LDK, false>(s, Qs, Kt, ty, tx);
    tile_mma<RS, RJ, D, LDD, LDK, false>(dp, dOs, Vt, ty, tx);
#pragma unroll
    for (int ii = 0; ii < RS; ++ii) {
      const int row = q0 + ty * RS + ii;
      const bool live = row < Sq;
      const float lse_r = live ? lse[(size_t)bh * Sq + row] : 0.f;
      const float delta_r = live ? delta[(size_t)bh * Sq + row] : 0.f;
      float p[RJ], ds[RJ];
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        const int col = k0 + tx * RJ + jj;
        const bool vis = live && col < Sk && (!causal || row >= col);
        const float e = vis ? expf(s[ii][jj] * scale - lse_r) : 0.f;
        p[jj] = round_to<T>(e);                               // p in q's dtype
        ds[jj] = round_to<T>(e * (dp[ii][jj] - delta_r) * scale);  // ds in q's dtype
      }
      store_vec<RJ>(Ps + (ty * RS + ii) * LDK + tx * RJ, p);
      store_vec<RJ>(dSs + (ty * RS + ii) * LDK + tx * RJ, ds);
    }
    __syncthreads();
    tile_mma<RK, RD, BQB, LDK, LDD, true>(dV, Ps, dOs, ty, tx);    // dv += p^T do
    tile_mma<RK, RD, BQB, LDK, LDD, true>(dK, dSs, Qs, ty, tx);    // dk += ds^T q
    float dq[RS][RD];
#pragma unroll
    for (int ii = 0; ii < RS; ++ii) {
#pragma unroll
      for (int dd = 0; dd < RD; ++dd) dq[ii][dd] = 0.f;
    }
    tile_mma<RS, RD, BK, LDK, LDD, false>(dq, dSs, Ks, ty, tx);    // dq += ds k
    if (rcos) rope_bwd_regs<RS, RD, D>(dq, rcos, rsin, q0 + ty * RS, Sq, tx);
#pragma unroll
    for (int ii = 0; ii < RS; ++ii) {
      const int row = q0 + ty * RS + ii;
      if (row >= Sq) continue;
      float* dst = dq_acc + qoff + (size_t)row * D + tx * RD;
#pragma unroll
      for (int dd = 0; dd < RD; ++dd) atomicAdd(dst + dd, dq[ii][dd]);
    }
  }

  if (rcos) rope_bwd_regs<RK, RD, D>(dK, rcos, rsin, k0 + ty * RK, Sk, tx);
#pragma unroll
  for (int ii = 0; ii < RK; ++ii) {
    const int row = k0 + ty * RK + ii;
    if (row >= Sk) continue;
    T* dkr = dk + koff + (size_t)row * D + tx * RD;
    T* dvr = dv + koff + (size_t)row * D + tx * RD;
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) {
      dkr[dd] = from_f<T>(dK[ii][dd]);
      dvr[dd] = from_f<T>(dV[ii][dd]);
    }
  }
}

template <typename T, int D>
int fwd_t(const void* q, const void* k, const void* v, void* o, float* lse,
          const float* rcos, const float* rsin, int BH, int Sq, int Sk,
          float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (BQ * (D + PAD) + D * (BK + PAD) + BK * (D + PAD) + BQ * (BK + PAD));
  auto kern = flash_fwd_kernel<T, D>;
  static const cudaError_t attr = allow_smem(kern, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  kern<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                   (T*)o, lse, rcos, rsin, Sq, Sk, scale,
                                   causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_t(const void* q, const void* k, const void* v, const void* o,
          const float* lse, const void* dout, float* dq_acc, void* dk,
          void* dv, float* delta, const float* rcos, const float* rsin,
          int BH, int Sq, int Sk, float scale, int causal,
          cudaStream_t stream) {
  const cudaError_t e = launch_delta<T>(o, dout, delta, BH * Sq, D, stream);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sizeof(float) *
      (2 * D * (BK + PAD) + BK * (D + PAD) + 2 * BQB * (D + PAD) + 2 * BQB * (BK + PAD));
  auto kern = flash_bwd_kernel<T, D>;
  static const cudaError_t attr = allow_smem(kern, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Sk + BK - 1) / BK, BH);
  kern<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, lse,
                                   delta, (const T*)dout, dq_acc, (T*)dk,
                                   (T*)dv, rcos, rsin, Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_d(const void* q, const void* k, const void* v, void* o, float* lse,
          const float* rc, const float* rs, int BH, int Sq, int Sk, int D,
          float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 32: return fwd_t<T, 32>(q, k, v, o, lse, rc, rs, BH, Sq, Sk, scale, causal, s);
    case 64: return fwd_t<T, 64>(q, k, v, o, lse, rc, rs, BH, Sq, Sk, scale, causal, s);
    case 128: return fwd_t<T, 128>(q, k, v, o, lse, rc, rs, BH, Sq, Sk, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int bwd_d(const void* q, const void* k, const void* v, const void* o,
          const float* lse, const void* dout, float* dq_acc, void* dk,
          void* dv, float* delta, const float* rc, const float* rs, int BH,
          int Sq, int Sk, int D, float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 32: return bwd_t<T, 32>(q, k, v, o, lse, dout, dq_acc, dk, dv, delta, rc, rs, BH, Sq, Sk, scale, causal, s);
    case 64: return bwd_t<T, 64>(q, k, v, o, lse, dout, dq_acc, dk, dv, delta, rc, rs, BH, Sq, Sk, scale, causal, s);
    case 128: return bwd_t<T, 128>(q, k, v, o, lse, dout, dq_acc, dk, dv, delta, rc, rs, BH, Sq, Sk, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int BH, int Sq, int Sk) {
  return BH < 0 || Sq < 0 || Sk < 0 || BH > 65535;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. Writes o and lse. rcos / rsin
// are the [S, D/2] f32 rope tables, or both null for no rope.
// Returns the CUDA error code of the launch (0 on success).
int flash_attention_fwd_launch(int dtype, const void* q, const void* k,
                               const void* v, void* o, float* lse,
                               const float* rcos, const float* rsin, int BH,
                               int Sq, int Sk, int D, float scale, int causal,
                               void* stream) {
  if (bad_shape(BH, Sq, Sk) || (rcos == nullptr) != (rsin == nullptr))
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return fwd_d<float>(q, k, v, o, lse, rcos, rsin, BH, Sq, Sk, D, scale, causal, s);
    case 1: return fwd_d<__nv_bfloat16>(q, k, v, o, lse, rcos, rsin, BH, Sq, Sk, D, scale, causal, s);
    case 2: return fwd_d<__half>(q, k, v, o, lse, rcos, rsin, BH, Sq, Sk, D, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Adds dq into the zeroed f32 dq_acc and writes dk, dv; delta is [BH, Sq]
// f32 scratch; rcos / rsin as for the forward. Two launches (the delta
// pre-pass, then the backward).
int flash_attention_bwd_launch(int dtype, const void* q, const void* k,
                               const void* v, const void* o, const float* lse,
                               const void* dout, float* dq_acc, void* dk,
                               void* dv, float* delta, const float* rcos,
                               const float* rsin, int BH, int Sq, int Sk,
                               int D, float scale, int causal, void* stream) {
  if (bad_shape(BH, Sq, Sk) || (rcos == nullptr) != (rsin == nullptr))
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0 || Sk == 0) return 0;   // nothing to add; dk, dv are the caller's
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return bwd_d<float>(q, k, v, o, lse, dout, dq_acc, dk, dv, delta, rcos, rsin, BH, Sq, Sk, D, scale, causal, s);
    case 1: return bwd_d<__nv_bfloat16>(q, k, v, o, lse, dout, dq_acc, dk, dv, delta, rcos, rsin, BH, Sq, Sk, D, scale, causal, s);
    case 2: return bwd_d<__half>(q, k, v, o, lse, dout, dq_acc, dk, dv, delta, rcos, rsin, BH, Sq, Sk, D, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
