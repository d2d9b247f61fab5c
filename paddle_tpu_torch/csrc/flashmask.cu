// FlashMask attention forward and the two-pass flash backward for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces five TPU kernels:
//   paddle_tpu/ops/pallas/flashmask.py
//     `_fm_fwd_kernel` (:69, reached through `_fm_fwd` :230, pallas_call
//     :237): flash attention in which key column j masks the query rows
//     [sr_j, er_j) on top of the causal mask, skipping the (q tile, k tile)
//     pairs that `_block_live` (:49-66) proves dead; writes o and lse;
//     `_fm_bwd_dq_kernel` (:123, `_fm_bwd` :252, pallas_call :263): dq;
//     `_fm_bwd_dkv_kernel` (:170, pallas_call :280): dk and dv;
//   paddle_tpu/ops/pallas/flash_attention.py
//     `_bwd_dq_kernel` (:316, `_flash_bwd_twopass` :485, pallas_call :504)
//     and `_bwd_dkv_kernel` (:370, pallas_call :523): the same two-pass
//     backward without the interval, kept for A/B measurement against the
//     fused backward of flash_attention.cu.
//
// Layouts (heads folded into batch; row-major, contiguous):
//   q, o, do   [BH, Sq, D]     float32 / bfloat16 / float16, D 32, 64, 128
//   k, v       [BH, Sk, D]
//   sr, er     [B, MH, Sk]     int32; BH = B * H, head h of a batch row
//                              reads mask head h / (H / MH)
//   lse        [BH, Sq] f32    (the TPU's [BH, 8, S] is a lane-tiling
//                              artifact, as are its [BH, 8, S] sr / er)
//   ext        [B * MH, nk]    int2 scratch: (max sr, min er) over the
//                              valid columns of each 64-column k tile
//   delta      [BH, Sq] f32    scratch: rowsum(do * o)
//   dq, dk, dv                 the dtypes of q, k, v
// Any Sq, Sk: tiles past the end are zero-filled and columns past Sk are
// masked. A column is visible to a row when col < Sk, row >= col if causal
// (top-left), and not sr_col <= row < er_col (`_mask_block` :33-46).
//
// Two instantiations of the backward, chosen at compile time:
//   FlashMask (INTERVALS, f32 steps): every operand cast to f32 and p, ds
//   never rounded (flashmask.py:140-159, :188-210);
//   two-pass (no interval, ROUND): p rounded to q's dtype before p^T do and
//   ds before ds k and ds^T q (flash_attention.py:353-357, :401-417), the
//   same steps as the fused backward.
// The forward is FlashMask's only: f32 p (:96-106). A row that sees no
// column gets o = 0 and lse = -1e30 (:114-118), p = 0 in the backward
// (:152, :200), dq = 0, and adds nothing to dk or dv.
//
// Design. CUDA-core f32 FMAs on tiles staged as f32 in shared memory, 256
// threads as a 16 x 16 grid each holding a small register tile, rows padded
// by 4 floats (aligned float4 reads, conflict-free column walks): the tile
// helpers of flash_tiles.cuh, shared with flash_attention.cu. FlashMask's p
// is f32 and is never rounded, so a 16-bit tensor-core product p @ v would
// need p split into exact parts (blockwise_ce.cu does that for dl, three
// products for one); this first version keeps every product on the CUDA
// cores.
//   Tile skip: a pre-pass writes each mask row's (max sr, min er) per k
//   tile, padded columns left out (:58-59). A (q tile, k tile) pair is dead
//   when rows_lo >= max sr and rows_hi < min er, or, causal, when the k tile
//   starts past rows_hi; all three kernels skip dead pairs before loading
//   anything. The decision is the same for every thread of a block.
//   Forward: one block per (bh, 64-row q tile) walks the live k tiles; a
//   thread's score rows are its output rows, so m / l / the [rows, D]
//   accumulator stay in registers (online softmax, :96-106); o and lse are
//   written once.
//   dq: one block per (bh, 64-row q tile) keeps q, do, their lse and delta
//   on chip and walks the live k tiles, adding ds k into a register
//   accumulator: no atomics, so dq is deterministic (the fused backward's
//   dq is summed atomically).
//   dk / dv: one block per (bh, 64-key tile) keeps k, v and the dk / dv
//   accumulators on chip and walks the live 32-row q tiles from the
//   diagonal.
//   delta = rowsum(do * o) in f32 is one pre-pass kernel for both.
//
// What bounds it, counted on the visible pairs: with packed documents at
// the flagship widths (S = 2048, D = 64, bf16, about 3 in 10 causal pairs
// visible) the bytes: each kernel must move its inputs and outputs once in
// more time than the visible pairs' products take on the bf16 tensor cores
// (about 150 flops per byte forward, under the ~295 where operations take
// over); with more pairs visible (bands, long contexts) the operations.
// These kernels run f32 FMAs on the CUDA cores (67 TFLOP/s peak), far from
// either bound; the skip makes their work follow the live tiles.
// Tensor-core tiles with split p are later work.

#include <limits.h>

#include "flash_tiles.cuh"

namespace {

constexpr int BQ = 64;           // forward and dq: query rows per tile
constexpr int BQB = 32;          // dk / dv: query rows per tile
constexpr int BK = 64;           // key rows per tile

// the interval bounds of the k tile's columns; past Sk an empty interval
__device__ __forceinline__ void load_bounds(int* srs, int* ers, const int* __restrict__ sr,
                                            const int* __restrict__ er, int k0, int Sk) {
  for (int j = threadIdx.x; j < BK; j += NT) {
    const int col = k0 + j;
    srs[j] = col < Sk ? sr[col] : 0;
    ers[j] = col < Sk ? er[col] : 0;
  }
}

// the mask row (batch row, mask head) that head bh reads
__device__ __forceinline__ int mask_row(int bh, int H, int MH) {
  return (bh / H) * MH + (bh % H) / (H / MH);
}

// `_block_live` (:49-66) for rows [lo, hi] against a k tile's extremes
__device__ __forceinline__ bool interval_live(int2 e, int lo, int hi) {
  return !(lo >= e.x && hi < e.y);
}

// row masked by its column's interval
__device__ __forceinline__ bool in_interval(int row, int s, int e) {
  return row >= s && row < e;
}

// ext[m * nk + t] = (max sr_j, min er_j) over the valid columns j of k tile
// t of mask row m, one warp each; a tile with no valid column is (0, INT_MAX)
__global__ void __launch_bounds__(NT)
flashmask_extremes_kernel(const int* __restrict__ sr, const int* __restrict__ er,
                          int2* __restrict__ ext, int rows, int Sk, int nk) {
  const int w = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= rows * nk) return;
  const int m = w / nk, t = w % nk;
  const int end = min(Sk, (t + 1) * BK);
  int smax = 0, emin = INT_MAX;
  for (int j = t * BK + lane; j < end; j += 32) {
    smax = max(smax, sr[(size_t)m * Sk + j]);
    emin = min(emin, er[(size_t)m * Sk + j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    smax = max(smax, __shfl_xor_sync(0xffffffffu, smax, off));
    emin = min(emin, __shfl_xor_sync(0xffffffffu, emin, off));
  }
  if (lane == 0) ext[w] = make_int2(smax, emin);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flashmask_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ sr,
                     const int* __restrict__ er, const int2* __restrict__ ext,
                     T* __restrict__ o, float* __restrict__ lse, int H, int MH,
                     int Sq, int Sk, float scale, int causal) {
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
  int* srs = reinterpret_cast<int*>(Ps + BQ * LDK);
  int* ers = srs + BK;

  const int bh = blockIdx.y;
  // the longest causal rows first, so they do not trail the grid
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;
  const int m = mask_row(bh, H, MH);
  const int* srm = sr + (size_t)m * Sk;
  const int* erm = er + (size_t)m * Sk;
  const int nk_all = (Sk + BK - 1) / BK;
  const int2* extm = ext + (size_t)m * nk_all;

  load_tile<T, D, LDQ, false>(Qs, qb, q0, BQ, Sq);
  float mx[RI], l[RI], acc[RI][RD];
#pragma unroll
  for (int ii = 0; ii < RI; ++ii) {
    mx[ii] = NEG_INF;
    l[ii] = 0.f;
  }
  zero(acc);
  int nk = nk_all;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);  // skip tiles above the diagonal

  for (int kt = 0; kt < nk; ++kt) {
    if (!interval_live(extm[kt], q0, q0 + BQ - 1)) continue;   // a dead tile
    const int k0 = kt * BK;
    __syncthreads();                       // the previous tile is consumed
    load_tile<T, D, LDK, true>(Kt, kb, k0, BK, Sk);
    load_tile<T, D, LDV, false>(Vs, vb, k0, BK, Sk);
    load_bounds(srs, ers, srm, erm, k0, Sk);
    __syncthreads();

    float s[RI][RJ];
    zero(s);
    tile_mma<RI, RJ, D, LDQ, LDK, false>(s, Qs, Kt, ty, tx);

#pragma unroll
    for (int ii = 0; ii < RI; ++ii) {
      const int row = q0 + ty * RI + ii;
      bool vis[RJ];
      float smax = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        const int j = tx * RJ + jj, col = k0 + j;
        vis[jj] = col < Sk && (!causal || row >= col) && !in_interval(row, srs[j], ers[j]);
        s[ii][jj] = vis[jj] ? s[ii][jj] * scale : NEG_INF;
        smax = fmaxf(smax, s[ii][jj]);
      }
      const float m_new = fmaxf(mx[ii], row_max(smax));
      const float corr = expf(mx[ii] - m_new);
      float p[RJ], psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        p[jj] = vis[jj] ? expf(s[ii][jj] - m_new) : 0.f;   // f32, never rounded
        psum += p[jj];
      }
      store_vec<RJ>(Ps + (ty * RI + ii) * LDK + tx * RJ, p);
      l[ii] = corr * l[ii] + row_sum(psum);
      mx[ii] = m_new;
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
    const float lz = l[ii] == 0.f ? 1.f : l[ii];   // rows that see nothing -> zeros
    T* orow = o + ((size_t)bh * Sq + row) * D + tx * RD;
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) orow[dd] = from_f<T>(acc[ii][dd] / lz);
    if (tx == 0) lse[(size_t)bh * Sq + row] = mx[ii] + logf(lz);
  }
}

// p and ds of one score element: f32 for FlashMask, rounded to T for the
// two-pass backward
template <typename T, bool ROUND>
__device__ __forceinline__ void p_ds(float s, float dp, bool vis, float lse_r,
                                     float delta_r, float scale, float& p, float& ds) {
  const float e = vis ? expf(s * scale - lse_r) : 0.f;
  const float g = e * (dp - delta_r) * scale;
  p = ROUND ? round_to<T>(e) : e;
  ds = ROUND ? round_to<T>(g) : g;
}

template <typename T, int D, bool INTERVALS, bool ROUND>
__global__ void __launch_bounds__(NT)
flashmask_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ lse,
                        const float* __restrict__ delta, const T* __restrict__ dout,
                        const int* __restrict__ sr, const int* __restrict__ er,
                        const int2* __restrict__ ext, T* __restrict__ dq, int H,
                        int MH, int Sq, int Sk, float scale, int causal) {
  constexpr int LDD = D + PAD;    // Qs, dOs [BQ][LDD]; Ks [BK][LDD]
  constexpr int LDK = BK + PAD;   // Kt, Vt [D][LDK]; dSs [BQ][LDK]
  constexpr int RI = BQ / 16;     // rows per thread
  constexpr int RJ = BK / 16;     // score columns per thread
  constexpr int RD = D / 16;      // dq columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BQ * LDD;
  float* Ks = dOs + BQ * LDD;
  float* Kt = Ks + BK * LDD;
  float* Vt = Kt + D * LDK;
  float* dSs = Vt + D * LDK;
  int* srs = reinterpret_cast<int*>(dSs + BQ * LDK);
  int* ers = srs + BK;

  const int bh = blockIdx.y;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;
  const int nk_all = (Sk + BK - 1) / BK;
  const int m = INTERVALS ? mask_row(bh, H, MH) : 0;

  load_tile<T, D, LDD, false>(Qs, q + qoff, q0, BQ, Sq);
  load_tile<T, D, LDD, false>(dOs, dout + qoff, q0, BQ, Sq);
  float lse_r[RI], delta_r[RI];
#pragma unroll
  for (int ii = 0; ii < RI; ++ii) {
    const int row = q0 + ty * RI + ii;
    lse_r[ii] = row < Sq ? lse[(size_t)bh * Sq + row] : 0.f;
    delta_r[ii] = row < Sq ? delta[(size_t)bh * Sq + row] : 0.f;
  }
  float acc[RI][RD];
  zero(acc);
  int nk = nk_all;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < nk; ++kt) {
    if constexpr (INTERVALS) {
      if (!interval_live(ext[(size_t)m * nk_all + kt], q0, q0 + BQ - 1)) continue;
    }
    const int k0 = kt * BK;
    __syncthreads();                       // the previous tile is consumed
    load_tile<T, D, LDK, true>(Kt, k + koff, k0, BK, Sk);
    load_tile<T, D, LDK, true>(Vt, v + koff, k0, BK, Sk);
    load_tile<T, D, LDD, false>(Ks, k + koff, k0, BK, Sk);
    if constexpr (INTERVALS)
      load_bounds(srs, ers, sr + (size_t)m * Sk, er + (size_t)m * Sk, k0, Sk);
    __syncthreads();

    float s[RI][RJ], dp[RI][RJ];
    zero(s);
    zero(dp);
    tile_mma<RI, RJ, D, LDD, LDK, false>(s, Qs, Kt, ty, tx);
    tile_mma<RI, RJ, D, LDD, LDK, false>(dp, dOs, Vt, ty, tx);
#pragma unroll
    for (int ii = 0; ii < RI; ++ii) {
      const int row = q0 + ty * RI + ii;
      float ds[RJ];
#pragma unroll
      for (int jj = 0; jj < RJ; ++jj) {
        const int j = tx * RJ + jj, col = k0 + j;
        bool vis = row < Sq && col < Sk && (!causal || row >= col);
        if constexpr (INTERVALS) vis = vis && !in_interval(row, srs[j], ers[j]);
        float p;
        p_ds<T, ROUND>(s[ii][jj], dp[ii][jj], vis, lse_r[ii], delta_r[ii],
                                  scale, p, ds[jj]);
      }
      store_vec<RJ>(dSs + (ty * RI + ii) * LDK + tx * RJ, ds);
    }
    __syncthreads();
    tile_mma<RI, RD, BK, LDK, LDD, false>(acc, dSs, Ks, ty, tx);   // dq += ds k
  }

#pragma unroll
  for (int ii = 0; ii < RI; ++ii) {
    const int row = q0 + ty * RI + ii;
    if (row >= Sq) continue;
    T* dst = dq + qoff + (size_t)row * D + tx * RD;
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) dst[dd] = from_f<T>(acc[ii][dd]);
  }
}

template <typename T, int D, bool INTERVALS, bool ROUND>
__global__ void __launch_bounds__(NT)
flashmask_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ lse,
                         const float* __restrict__ delta, const T* __restrict__ dout,
                         const int* __restrict__ sr, const int* __restrict__ er,
                         const int2* __restrict__ ext, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int MH, int Sq, int Sk,
                         float scale, int causal) {
  constexpr int LDD = D + PAD;    // Qs, dOs [BQB][LDD]
  constexpr int LDK = BK + PAD;   // Kt, Vt [D][LDK]; Ps, dSs [BQB][LDK]
  constexpr int RS = BQB / 16;    // score rows per thread
  constexpr int RJ = BK / 16;     // score columns per thread
  constexpr int RK = BK / 16;     // dk / dv rows per thread
  constexpr int RD = D / 16;      // columns of D per thread
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);
  float* Vt = Kt + D * LDK;
  float* Qs = Vt + D * LDK;
  float* dOs = Qs + BQB * LDD;
  float* Ps = dOs + BQB * LDD;
  float* dSs = Ps + BQB * LDK;
  int* srs = reinterpret_cast<int*>(dSs + BQB * LDK);
  int* ers = srs + BK;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;

  load_tile<T, D, LDK, true>(Kt, k + koff, k0, BK, Sk);
  load_tile<T, D, LDK, true>(Vt, v + koff, k0, BK, Sk);
  int2 e = make_int2(0, INT_MAX);
  if constexpr (INTERVALS) {
    const int m = mask_row(bh, H, MH);
    load_bounds(srs, ers, sr + (size_t)m * Sk, er + (size_t)m * Sk, k0, Sk);
    e = ext[(size_t)m * ((Sk + BK - 1) / BK) + blockIdx.x];
  }
  float dK[RK][RD], dV[RK][RD];
  zero(dK);
  zero(dV);
  const int nq = (Sq + BQB - 1) / BQB;
  const int qt0 = causal ? k0 / BQB : 0;   // q tiles wholly above the diagonal see no key here

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * BQB;
    if (INTERVALS && !interval_live(e, q0, q0 + BQB - 1)) continue;   // a dead tile
    __syncthreads();                       // the previous q tile is consumed
    load_tile<T, D, LDD, false>(Qs, q + qoff, q0, BQB, Sq);
    load_tile<T, D, LDD, false>(dOs, dout + qoff, q0, BQB, Sq);
    __syncthreads();

    float s[RS][RJ], dp[RS][RJ];
    zero(s);
    zero(dp);
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
        const int j = tx * RJ + jj, col = k0 + j;
        bool vis = live && col < Sk && (!causal || row >= col);
        if constexpr (INTERVALS) vis = vis && !in_interval(row, srs[j], ers[j]);
        p_ds<T, ROUND>(s[ii][jj], dp[ii][jj], vis, lse_r, delta_r, scale,
                                  p[jj], ds[jj]);
      }
      store_vec<RJ>(Ps + (ty * RS + ii) * LDK + tx * RJ, p);
      store_vec<RJ>(dSs + (ty * RS + ii) * LDK + tx * RJ, ds);
    }
    __syncthreads();
    tile_mma<RK, RD, BQB, LDK, LDD, true>(dV, Ps, dOs, ty, tx);    // dv += p^T do
    tile_mma<RK, RD, BQB, LDK, LDD, true>(dK, dSs, Qs, ty, tx);    // dk += ds^T q
  }

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

int extremes(const int* sr, const int* er, int* ext, int rows, int Sk, cudaStream_t s) {
  const int nk = (Sk + BK - 1) / BK;
  if (rows * nk == 0) return 0;
  flashmask_extremes_kernel<<<(rows * nk + NT / 32 - 1) / (NT / 32), NT, 0, s>>>(
      sr, er, reinterpret_cast<int2*>(ext), rows, Sk, nk);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int fwd_t(const void* q, const void* k, const void* v, const int* sr,
          const int* er, const int* ext, void* o, float* lse, int BH, int H,
          int MH, int Sq, int Sk, float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (BQ * (D + PAD) + D * (BK + PAD) + BK * (D + PAD) + BQ * (BK + PAD)) +
      2 * BK * sizeof(int);
  auto kern = flashmask_fwd_kernel<T, D>;
  static const cudaError_t attr = allow_smem(kern, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  kern<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, sr, er,
                                   reinterpret_cast<const int2*>(ext), (T*)o, lse,
                                   H, MH, Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

struct BwdArgs {
  const void *q, *k, *v;
  const float *lse, *delta;
  const void* dout;
  const int *sr, *er, *ext;
  int BH, H, MH, Sq, Sk;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D, bool IV, bool RD>
int dq_t(const BwdArgs& a, void* dq) {
  const size_t smem = sizeof(float) *
      (2 * BQ * (D + PAD) + BK * (D + PAD) + 2 * D * (BK + PAD) + BQ * (BK + PAD)) +
      2 * BK * sizeof(int);
  auto kern = flashmask_bwd_dq_kernel<T, D, IV, RD>;
  static const cudaError_t attr = allow_smem(kern, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.BH);
  kern<<<grid, NT, smem, a.stream>>>((const T*)a.q, (const T*)a.k, (const T*)a.v,
                                     a.lse, a.delta, (const T*)a.dout, a.sr, a.er,
                                     reinterpret_cast<const int2*>(a.ext), (T*)dq,
                                     a.H, a.MH, a.Sq, a.Sk, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool IV, bool RD>
int dkv_t(const BwdArgs& a, void* dk, void* dv) {
  const size_t smem = sizeof(float) *
      (2 * D * (BK + PAD) + 2 * BQB * (D + PAD) + 2 * BQB * (BK + PAD)) +
      2 * BK * sizeof(int);
  auto kern = flashmask_bwd_dkv_kernel<T, D, IV, RD>;
  static const cudaError_t attr = allow_smem(kern, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((a.Sk + BK - 1) / BK, a.BH);
  kern<<<grid, NT, smem, a.stream>>>((const T*)a.q, (const T*)a.k, (const T*)a.v,
                                     a.lse, a.delta, (const T*)a.dout, a.sr, a.er,
                                     reinterpret_cast<const int2*>(a.ext), (T*)dk,
                                     (T*)dv, a.H, a.MH, a.Sq, a.Sk, a.scale, a.causal);
  return (int)cudaGetLastError();
}

// FlashMask: the interval and f32 steps; two-pass: no interval, rounding
template <typename T, int D>
int dq_m(int mode, const BwdArgs& a, void* dq) {
  return mode == 0 ? dq_t<T, D, true, false>(a, dq) : dq_t<T, D, false, true>(a, dq);
}
template <typename T, int D>
int dkv_m(int mode, const BwdArgs& a, void* dk, void* dv) {
  return mode == 0 ? dkv_t<T, D, true, false>(a, dk, dv)
                   : dkv_t<T, D, false, true>(a, dk, dv);
}

template <typename T>
int dq_d(int mode, int D, const BwdArgs& a, void* dq) {
  switch (D) {
    case 32: return dq_m<T, 32>(mode, a, dq);
    case 64: return dq_m<T, 64>(mode, a, dq);
    case 128: return dq_m<T, 128>(mode, a, dq);
    default: return (int)cudaErrorInvalidValue;
  }
}
template <typename T>
int dkv_d(int mode, int D, const BwdArgs& a, void* dk, void* dv) {
  switch (D) {
    case 32: return dkv_m<T, 32>(mode, a, dk, dv);
    case 64: return dkv_m<T, 64>(mode, a, dk, dv);
    case 128: return dkv_m<T, 128>(mode, a, dk, dv);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int fwd_d(int D, const void* q, const void* k, const void* v, const int* sr,
          const int* er, const int* ext, void* o, float* lse, int BH, int H,
          int MH, int Sq, int Sk, float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 32: return fwd_t<T, 32>(q, k, v, sr, er, ext, o, lse, BH, H, MH, Sq, Sk, scale, causal, s);
    case 64: return fwd_t<T, 64>(q, k, v, sr, er, ext, o, lse, BH, H, MH, Sq, Sk, scale, causal, s);
    case 128: return fwd_t<T, 128>(q, k, v, sr, er, ext, o, lse, BH, H, MH, Sq, Sk, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int BH, int H, int MH, int Sq, int Sk) {
  return BH < 0 || Sq < 0 || Sk < 0 || BH > 65535 || H <= 0 || MH <= 0 ||
         H % MH != 0 || BH % H != 0;
}

}  // namespace

extern "C" {

// Columns per k tile: the caller sizes ext as B * MH * ceil(Sk / this) int2.
int flashmask_block_k(void) { return BK; }

// dtype: 0 float32, 1 bfloat16, 2 float16. Writes ext (the tile extremes
// pre-pass), then o and lse. Returns the CUDA error code of the launches
// (0 on success).
int flashmask_fwd_launch(int dtype, const void* q, const void* k, const void* v,
                         const int* sr, const int* er, int* ext, void* o, float* lse,
                         int BH, int H, int MH, int Sq, int Sk, int D, float scale,
                         int causal, void* stream) {
  if (bad_shape(BH, H, MH, Sq, Sk) || !sr || !er || !ext) return (int)cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int e = extremes(sr, er, ext, BH / H * MH, Sk, s);
  if (e != 0) return e;
  switch (dtype) {
    case 0: return fwd_d<float>(D, q, k, v, sr, er, ext, o, lse, BH, H, MH, Sq, Sk, scale, causal, s);
    case 1: return fwd_d<__nv_bfloat16>(D, q, k, v, sr, er, ext, o, lse, BH, H, MH, Sq, Sk, scale, causal, s);
    case 2: return fwd_d<__half>(D, q, k, v, sr, er, ext, o, lse, BH, H, MH, Sq, Sk, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward's pre-pass: delta = rowsum(do * o) in f32 and, when sr, er
// and ext are given (FlashMask), the tile extremes; the dq and dk / dv
// launches read both.
int flashmask_bwd_prep_launch(int dtype, const void* o, const void* dout,
                              const int* sr, const int* er, int* ext, float* delta,
                              int BH, int H, int MH, int Sq, int Sk, int D,
                              void* stream) {
  if (bad_shape(BH, H, MH, Sq, Sk) || (sr == nullptr) != (ext == nullptr) ||
      (er == nullptr) != (ext == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (ext) {
    const int e = extremes(sr, er, ext, BH / H * MH, Sk, s);
    if (e != 0) return e;
  }
  switch (dtype) {
    case 0: return (int)launch_delta<float>(o, dout, delta, BH * Sq, D, s);
    case 1: return (int)launch_delta<__nv_bfloat16>(o, dout, delta, BH * Sq, D, s);
    case 2: return (int)launch_delta<__half>(o, dout, delta, BH * Sq, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// mode 0: FlashMask (sr, er and ext required); mode 1: the two-pass flash
// backward (sr, er and ext ignored). Writes dq.
int flashmask_bwd_dq_launch(int mode, int dtype, const void* q, const void* k,
                            const void* v, const float* lse, const float* delta,
                            const void* dout, const int* sr, const int* er,
                            const int* ext, void* dq, int BH, int H, int MH, int Sq,
                            int Sk, int D, float scale, int causal, void* stream) {
  if (bad_shape(BH, H, MH, Sq, Sk) || (mode != 0 && mode != 1) ||
      (mode == 0 && (!sr || !er || !ext)))
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return 0;
  const BwdArgs a{q, k, v, lse, delta, dout, sr, er, ext, BH, H, MH, Sq, Sk,
                  scale, causal, (cudaStream_t)stream};
  switch (dtype) {
    case 0: return dq_d<float>(mode, D, a, dq);
    case 1: return dq_d<__nv_bfloat16>(mode, D, a, dq);
    case 2: return dq_d<__half>(mode, D, a, dq);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As flashmask_bwd_dq_launch; writes dk and dv.
int flashmask_bwd_dkv_launch(int mode, int dtype, const void* q, const void* k,
                             const void* v, const float* lse, const float* delta,
                             const void* dout, const int* sr, const int* er,
                             const int* ext, void* dk, void* dv, int BH, int H,
                             int MH, int Sq, int Sk, int D, float scale, int causal,
                             void* stream) {
  if (bad_shape(BH, H, MH, Sq, Sk) || (mode != 0 && mode != 1) ||
      (mode == 0 && (!sr || !er || !ext)))
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Sk == 0) return 0;
  const BwdArgs a{q, k, v, lse, delta, dout, sr, er, ext, BH, H, MH, Sq, Sk,
                  scale, causal, (cudaStream_t)stream};
  switch (dtype) {
    case 0: return dkv_d<float>(mode, D, a, dk, dv);
    case 1: return dkv_d<__nv_bfloat16>(mode, D, a, dk, dv);
    case 2: return dkv_d<__half>(mode, D, a, dk, dv);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
