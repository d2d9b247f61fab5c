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
// What bounds it, counted on the visible pairs: with packed documents at
// the flagship widths (S = 2048, D = 64, bf16, about 3 in 10 causal pairs
// visible) the bytes: each kernel must move its inputs and outputs once in
// more time than the visible pairs' products take on the bf16 tensor cores
// (about 150 flops per byte forward, under the ~295 where operations take
// over); with more pairs visible (bands, long contexts) the operations.
// The tile skip makes the work follow the live tiles. The tensor-core
// forward and backward still take several times that bound at the
// smoke's shapes (PERF.md section 6, rows 6, 10 and 11): the element-wise
// step (exp, masks, the split of p) holds them as much as the products.
//
// Tile skip: a pre-pass writes each mask row's (max sr, min er) per k tile,
// padded columns left out (:58-59). A (q tile, k tile) pair is dead when
// rows_lo >= max sr and rows_hi < min er, or, causal, when the k tile starts
// past rows_hi; every kernel skips dead pairs before loading anything, and
// the tensor-core backward also skips a warp's slice of a live pair by the
// same rule. The decision is the same for every thread that takes it.
//
// f32 forward and backward: CUDA-core f32 FMAs on tiles staged as f32 in
// shared memory, 256 threads as a 16 x 16 grid each holding a small
// register tile, rows padded by 4 floats: the tile helpers of
// flash_tiles.cuh. The forward's block per (bh, 64-row q tile) walks the
// live k tiles with an online softmax (:96-106) in registers. The f32 dq
// block per (bh, 64-row q tile) adds ds k into registers; the f32 dk / dv
// block per (bh, 64-key tile) walks the live 32-row q tiles from the
// diagonal. f32 stays off the tensor cores, as flash_attention.cu's f32
// body does: TF32 would round the f32 gradients phase 14 holds to 1e-4.
//
// Tensor-core forward (bf16 and fp16; `_fm_fwd_kernel`, :69): the same
// (bh, 64-row q tile) blocks, as 4 warps of 16 rows each, walking the live
// k tiles in the dq kernel's order. Its CUDA-core body (q k^T and p v as
// f32 FMAs, p through shared memory, three block barriers and synchronous
// loads a tile, expf and every mask on every element) ran 1.9-2.9x masked
// SDPA; here each warp keeps its q fragments in registers, k, v and the
// tile's interval bounds arrive through the two-stage cp.async ring of
// live tiles, s = q k^T is exact in f32 on mma.sync, the online max and
// sum run over each row's quad in log2 units (ex2.approx, the scale and
// log2(e) in one FMA), the masks come in the backward's four compiled
// forms, and p, f32 as the Pallas body keeps it (:96-106), enters p v from
// the score accumulators as FM_FWD_PARTS exact 16-bit parts (split_frag)
// with v as ldmatrix.trans fragments: nothing passes through shared
// memory between the products. One part (p rounded, as the flash forward
// does) misses the smoke's o gate where |o| is near 0; two hold it
// (tests/test_torch_flashmask_split.py emulates both against the Pallas
// forward). A row that sees nothing keeps l = 0 and writes o = 0 and lse =
// -1e30.
//
// Tensor-core backward (bf16 and fp16; mma_tiles.cuh): mma.sync m16n8k16
// with f32 accumulators, operands in 16-bit shared tiles padded by 16
// bytes and read with ldmatrix, each walked tile arriving through a
// two-stage cp.async ring with zero-filled tails. q k^T and do v^T take
// 16-bit inputs, so their products are exact in f32. FlashMask's p and ds
// are f32: they enter p^T do, ds^T q and ds k as FM_PARTS 16-bit parts
// (split_frag: hi, then what hi leaves, rounded), one mma.sync a part into
// one f32 accumulator. Two parts carry 16 significant bits (bf16), 22
// (fp16); the gate holds with two (tests/test_torch_flashmask_split.py
// emulates the parts against the Pallas backward). The two-pass
// instantiation rounds p and ds to T, which is one part: the same body.
// fp16 parts below 2**-14 are subnormal, an absolute step of 2**-24 per
// value: the card tests' fp16 cases, small and large |ds|, hold.
//   The element-wise step (p, ds and their split) takes as many instruction
// slots as the products, so it is cut to what each warp's slice needs: exp is
// ex2.approx with the scale and log2(e) folded into one FMA, ds takes delta
// scale from the row, and the step comes in four compiled forms, the
// causal and length mask only on edge tiles and the interval test only
// where an interval of the slice's keys (dk / dv: the warp's 16 keys; dq:
// the tile's 64 columns, reduced from the staged bounds) can meet its rows
// ((min sr, max er) against the rows). tools/flashmask_kernel_ab.py timed
// each of these steps against a first form with expf and every mask on
// every element (PERF.md section 6).
//   dk / dv: one block of 8 warps per (bh, 64-key tile) keeps k and v in
//   shared memory and walks the live 64-row q tiles from the diagonal, (q,
//   do, lse, delta) through the ring. Warp (wk, wq) computes s^T = k q^T
//   and dp^T = v do^T for keys 16 wk .. 16 wk + 15 and q rows 32 wq .. of
//   the tile (k and v as A fragments, q and do as B fragments, both by
//   ldmatrix from the tiles as stored). p^T and ds^T are formed in the
//   accumulators, which are already the A fragments of dv += p^T do and
//   dk += ds^T q (the repack of mma_tiles.cuh), with do and q as
//   ldmatrix.trans B fragments: nothing passes through shared memory
//   between the products. The two query halves (wq = 0, 1) are summed
//   through shared memory once at the end, in that order.
//   dq: one block of 4 warps per (bh, 64-row q tile) keeps q and do in
//   shared memory and walks the live k tiles (k, v and the tile's interval
//   bounds through the ring); warp w computes s and dp for q rows 16 w ..
//   and the tile's 64 keys and adds ds k from the ds accumulators' parts.
//   No atomics: dq is deterministic, as dk and dv are.
//   delta = rowsum(do * o) in f32 is one pre-pass kernel for both.

#include <limits.h>

#include "flash_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int BQ = 64;           // forward and the f32 dq: query rows per tile
constexpr int BQB = 32;          // the f32 dk / dv: query rows per tile
constexpr int BK = 64;           // key rows per tile: the tile skip's columns
constexpr int TC_BQ = 64;        // tensor-core backward: query rows per tile
constexpr int TC_DQ_WARPS = 4;   // dq: 16 query rows a warp
constexpr int TC_DKV_WARPS = 8;  // dk / dv: 16 keys x 32 query rows a warp
constexpr int TC_FWD_WARPS = 4;  // the tensor-core forward: 16 query rows a warp
constexpr int TC_FWD_MIN_BLOCKS_D64 = 3;   // its blocks an SM at D <= 64 (4 spill)
constexpr int FM_PARTS = 2;      // FlashMask's p and ds: 16-bit parts a product
constexpr int FM_FWD_PARTS = 2;  // the forward's p: 16-bit parts in p v

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

// The CUDA-core forward (f32): one block of NT threads per (bh, BQ query
// rows), tiles staged as f32
template <int D>
__global__ void __launch_bounds__(NT)
flashmask_fwd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ sr,
                         const int* __restrict__ er, const int2* __restrict__ ext,
                         float* __restrict__ o, float* __restrict__ lse, int H, int MH,
                         int Sq, int Sk, float scale, int causal) {
  using T = float;
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

// p and ds of one score element of the f32 backward
__device__ __forceinline__ void p_ds(float s, float dp, bool vis, float lse_r,
                                     float delta_r, float scale, float& p, float& ds) {
  p = vis ? expf(s * scale - lse_r) : 0.f;
  ds = p * (dp - delta_r) * scale;
}

// The CUDA-core backward (f32): dq and dk / dv on tiles staged as f32
template <int D, bool INTERVALS>
__global__ void __launch_bounds__(NT)
flashmask_bwd_dq_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ lse,
                            const float* __restrict__ delta, const float* __restrict__ dout,
                            const int* __restrict__ sr, const int* __restrict__ er,
                            const int2* __restrict__ ext, float* __restrict__ dq, int H,
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

  load_tile<float, D, LDD, false>(Qs, q + qoff, q0, BQ, Sq);
  load_tile<float, D, LDD, false>(dOs, dout + qoff, q0, BQ, Sq);
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
    load_tile<float, D, LDK, true>(Kt, k + koff, k0, BK, Sk);
    load_tile<float, D, LDK, true>(Vt, v + koff, k0, BK, Sk);
    load_tile<float, D, LDD, false>(Ks, k + koff, k0, BK, Sk);
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
        p_ds(s[ii][jj], dp[ii][jj], vis, lse_r[ii], delta_r[ii],
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
    float* dst = dq + qoff + (size_t)row * D + tx * RD;
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) dst[dd] = acc[ii][dd];
  }
}

template <int D, bool INTERVALS>
__global__ void __launch_bounds__(NT)
flashmask_bwd_dkv_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ lse,
                             const float* __restrict__ delta, const float* __restrict__ dout,
                             const int* __restrict__ sr, const int* __restrict__ er,
                             const int2* __restrict__ ext, float* __restrict__ dk,
                             float* __restrict__ dv, int H, int MH, int Sq, int Sk,
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

  load_tile<float, D, LDK, true>(Kt, k + koff, k0, BK, Sk);
  load_tile<float, D, LDK, true>(Vt, v + koff, k0, BK, Sk);
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
    load_tile<float, D, LDD, false>(Qs, q + qoff, q0, BQB, Sq);
    load_tile<float, D, LDD, false>(dOs, dout + qoff, q0, BQB, Sq);
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
        p_ds(s[ii][jj], dp[ii][jj], vis, lse_r, delta_r, scale,
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
    float* dkr = dk + koff + (size_t)row * D + tx * RD;
    float* dvr = dv + koff + (size_t)row * D + tx * RD;
#pragma unroll
    for (int dd = 0; dd < RD; ++dd) {
      dkr[dd] = dK[ii][dd];
      dvr[dd] = dV[ii][dd];
    }
  }
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2**x on the SFU; results below 2**-126 flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p = exp(s scale - lse) and ds = p (dp - delta) scale of one score element
// of the tensor-core backward, in place of its scores s and dp, from the
// row's lse log2(e) and delta scale: f32 here; split_frag rounds them
// (two-pass) or splits them (FlashMask) on their way into the next product
__device__ __forceinline__ void p_ds_inplace(float& s, float& dp, bool vis, float lse2,
                                             float delta_s, float scale) {
  const float e = vis ? ex2(s * (scale * LOG2E) - lse2) : 0.f;
  dp = e * (dp * scale - delta_s);
  s = e;
}

// The forward on the tensor cores (bf16 / fp16): one block of TC_FWD_WARPS
// warps per (bh, TC_BQ query rows), warp w owning rows 16 w .. 16 w + 15
// with its q fragments in registers, loaded once. k, v and the tile's
// interval bounds arrive through a two-stage cp.async ring that fetches
// only the live tiles, tile kt + 1 landing while tile kt is multiplied. s
// = q k^T sums exact products in f32; the online max and sum run over each
// row's quad of lanes in log2 units (scale and log2(e) folded into one FMA
// before ex2.approx); p stays f32 and enters p v as P exact 16-bit parts
// (split_frag) from the score accumulators, v as ldmatrix.trans B
// fragments: nothing passes through shared memory between the products.
template <typename T, int D, int P>
__global__ void __launch_bounds__(TC_FWD_WARPS * 32, D <= 64 ? TC_FWD_MIN_BLOCKS_D64 : 2)
flashmask_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ sr,
                     const int* __restrict__ er, const int2* __restrict__ ext,
                     T* __restrict__ o, float* __restrict__ lse, int H, int MH,
                     int Sq, int Sk, float scale, int causal) {
  constexpr int NTH = TC_FWD_WARPS * 32;
  constexpr int BQT = TC_BQ, BKT = BK;
  constexpr int LD = D + 8;      // 16-bit row stride: 16 bytes of padding
  constexpr int KS = D / 16;     // k-steps of q k^T
  constexpr int NS = BKT / 8;    // score tiles of 8 keys
  constexpr int ND = D / 8;      // o tiles of 8 columns
  static_assert(BQT == 16 * TC_FWD_WARPS, "a warp owns 16 query rows");
  extern __shared__ __align__(16) unsigned char smem16[];
  T* Qs = reinterpret_cast<T*>(smem16);          // [BQT][LD]
  T* Ks = Qs + BQT * LD;                         // [2][BKT][LD]
  T* Vs = Ks + 2 * BKT * LD;                     // [2][BKT][LD]
  int* Bs = reinterpret_cast<int*>(Vs + 2 * BKT * LD);   // [2][sr, er][BKT]

  const int bh = blockIdx.y;
  // the longest causal rows first, so they do not trail the grid
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_lo = q0 + 16 * warp;             // the warp's first row
  const float scale_log2 = scale * LOG2E;       // scores and m in log2 units
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;
  const int nk_all = (Sk + BKT - 1) / BKT;
  int nk = nk_all;
  if (causal) nk = min(nk, (q0 + BQT - 1) / BKT + 1);   // skip tiles above the diagonal
  const int m_row = mask_row(bh, H, MH);
  const int2* extm = ext + (size_t)m_row * nk_all;
  const int* srm = sr + (size_t)m_row * Sk;
  const int* erm = er + (size_t)m_row * Sk;

  // the first live k tile at or after x
  auto next_live = [&](int x) {
    while (x < nk && !interval_live(extm[x], q0, q0 + BQT - 1)) ++x;
    return x;
  };
  // k, v and the interval bounds of k tile kt into stage st; bounds past
  // Sk land as zeros (empty intervals), those columns masked by col < Sk
  auto load_k_tile = [&](int kt, int st) {
    const int k0 = kt * BKT;
    load_rows_async<D, LD, BKT, NTH>(Ks + st * BKT * LD, k + koff, k0, Sk);
    load_rows_async<D, LD, BKT, NTH>(Vs + st * BKT * LD, v + koff, k0, Sk);
    for (int i = threadIdx.x; i < 2 * BKT; i += NTH) {
      const int col = k0 + i % BKT;
      const bool live = col < Sk;
      const int* src = i < BKT ? srm : erm;
      cp_async4(Bs + st * 2 * BKT + i, live ? src + col : src, live);
    }
  };

  load_rows_async<D, LD, BQT, NTH>(Qs, q + qoff, q0, Sq);
  int kt = next_live(0);
  if (kt < nk) load_k_tile(kt, 0);
  cp_async_commit();

  uint32_t qf[KS][4];
  bool have_q = false;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int st = 0; kt < nk; st ^= 1) {
    const int k0 = kt * BKT;
    const int nxt = next_live(kt + 1);
    if (nxt < nk) {                               // the next live tile lands meanwhile
      load_k_tile(nxt, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + st * BKT * LD;
    const T* Vt = Vs + st * BKT * LD;
    if (!have_q) {                                // the q tile landed with the first k tile
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) frag_a(qf[ks], Qs, LD, 16 * warp, 16 * ks);
      have_q = true;
    }

    // a warp whose rows are past Sq, all above the tile's first key, or all
    // inside every column's interval sees none of the tile
    const bool skip = row_lo >= Sq || (causal && k0 > row_lo + 15) ||
                      !interval_live(extm[kt], row_lo, row_lo + 15);
    if (!skip) {
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          uint32_t b[4];
          frag_b2(b, Kt, LD, 8 * j, 16 * ks);
          mma16816<T>(s[j], qf[ks], b[0], b[1]);
          mma16816<T>(s[j + 1], qf[ks], b[2], b[3]);
        }
      }
      // only tiles on the diagonal or the ragged end need the causal and
      // length mask, and the interval test only where an interval of the
      // tile's columns can meet the warp's rows: (min sr, max er) over the
      // tile (padded columns read as empty intervals at 0, which only widen it)
      const bool edge = (causal && k0 + BKT - 1 > row_lo) || k0 + BKT > Sk;
      const int* srs = Bs + st * 2 * BKT;
      int smin = min(srs[lane], srs[lane + 32]);
      int emax = max(srs[BKT + lane], srs[BKT + lane + 32]);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        smin = min(smin, __shfl_xor_sync(0xffffffffu, smin, off));
        emax = max(emax, __shfl_xor_sync(0xffffffffu, emax, off));
      }
      const bool hit = row_lo < emax && row_lo + 15 >= smin;
      // the online softmax of the tile in place of its scores: s becomes p
      // = 2**(s scale log2(e) - m), 0 where masked
      auto softmax_tile = [&](auto edge_c, auto hit_c) {
        constexpr bool EDGE = decltype(edge_c)::value, HIT = decltype(hit_c)::value;
        constexpr bool MASK = EDGE || HIT;
        uint32_t vis = 0xffffffffu;               // bit 4 j + e: element e of tile j
        if constexpr (MASK) {
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const int c = 8 * j + 2 * t;
            int2 s2 = make_int2(0, 0), e2 = make_int2(0, 0);
            if constexpr (HIT) {
              s2 = *reinterpret_cast<const int2*>(srs + c);
              e2 = *reinterpret_cast<const int2*>(srs + BKT + c);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = row_lo + g + 8 * (e >> 1), col = k0 + c + (e & 1);
              bool ok = true;
              if constexpr (EDGE) ok = col < Sk && (!causal || row >= col);
              if constexpr (HIT)
                ok = ok && !in_interval(row, (e & 1) ? s2.y : s2.x, (e & 1) ? e2.y : e2.x);
              if (!ok) vis &= ~(1u << (4 * j + e));
            }
          }
        }
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!MASK || (vis >> (4 * j + e)) & 1u) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        }
        float corr[2], neg_m[2], psum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {             // a row's four lanes: t = 0 .. 3
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          // a row with nothing visible yet keeps m = NEG_INF
          const float m_new = mx[h] == NEG_INF ? m[h] : fmaxf(m[h], mx[h] * scale_log2);
          corr[h] = ex2(m[h] - m_new);
          m[h] = m_new;
          neg_m[h] = -m_new;
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(fmaf(s[j][e], scale_log2, neg_m[e >> 1]));
            if constexpr (MASK) p = (vis >> (4 * j + e)) & 1u ? p : 0.f;
            psum[e >> 1] += p;
            s[j][e] = p;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
          psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
          l[h] = corr[h] * l[h] + psum[h];
        }
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
          acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
        }
      };
      if (edge) {
        if (hit) softmax_tile(std::true_type{}, std::true_type{});
        else softmax_tile(std::true_type{}, std::false_type{});
      } else {
        if (hit) softmax_tile(std::false_type{}, std::true_type{});
        else softmax_tile(std::false_type{}, std::false_type{});
      }
      // o += p v: p's accumulators are the A fragments (P parts), v [key][d]
      // the B fragments
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk) {
        uint32_t a[P][4];
        split_frag<T, P>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          uint32_t b[4];
          frag_b2_t(b, Vt, LD, 8 * n, 16 * kk);
#pragma unroll
          for (int i = 0; i < P; ++i) {
            mma16816<T>(acc[n], a[i], b[0], b[1]);
            mma16816<T>(acc[n + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();                              // stage st is consumed
    kt = nxt;
  }
  cp_async_wait<0>();

  // o = acc / l, a row that sees nothing 0 with lse -1e30
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + g + 8 * h;
    if (row >= Sq) continue;
    const float lz = l[h] == 0.f ? 1.f : l[h];    // acc is 0 where l is
    T* dst = o + qoff + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) = pack2<T>(acc[n][2 * h] / lz, acc[n][2 * h + 1] / lz);
    if (t == 0) lse[(size_t)bh * Sq + row] = l[h] == 0.f ? NEG_INF : m[h] * LN2 + logf(lz);
  }
}

// dq on the tensor cores (bf16 / fp16): one block of TC_DQ_WARPS warps per
// (bh, TC_BQ query rows), warp w owning rows 16 w .. 16 w + 15. q and do
// stay in shared memory; k, v and the tile's interval bounds arrive through
// a two-stage cp.async ring, tile kt + 1 (the next live one) landing while
// tile kt is multiplied. P parts of ds a product (1: ds rounded to T).
template <typename T, int D, bool INTERVALS, int P>
__global__ void __launch_bounds__(TC_DQ_WARPS * 32, D <= 64 ? 3 : 2)
flashmask_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ lse,
                        const float* __restrict__ delta, const T* __restrict__ dout,
                        const int* __restrict__ sr, const int* __restrict__ er,
                        const int2* __restrict__ ext, T* __restrict__ dq, int H,
                        int MH, int Sq, int Sk, float scale, int causal) {
  constexpr int NTH = TC_DQ_WARPS * 32;
  constexpr int BQT = TC_BQ, BKT = BK;
  constexpr int LD = D + 8;      // 16-bit row stride: 16 bytes of padding
  constexpr int KS = D / 16;     // k-steps of q k^T and do v^T
  constexpr int NS = BKT / 8;    // score tiles of 8 keys
  constexpr int ND = D / 8;      // dq tiles of 8 columns
  static_assert(BQT == 16 * TC_DQ_WARPS, "a warp owns 16 query rows");
  extern __shared__ __align__(16) unsigned char smem16[];
  T* Qs = reinterpret_cast<T*>(smem16);          // [BQT][LD]
  T* dOs = Qs + BQT * LD;                        // [BQT][LD]
  T* Ks = dOs + BQT * LD;                        // [2][BKT][LD]
  T* Vs = Ks + 2 * BKT * LD;                     // [2][BKT][LD]
  int* Bs = reinterpret_cast<int*>(Vs + 2 * BKT * LD);   // [2][sr, er][BKT]

  const int bh = blockIdx.y;
  // the longest causal rows first, so they do not trail the grid
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_lo = q0 + 16 * warp;             // the warp's first row
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;
  const int nk_all = (Sk + BKT - 1) / BKT;
  int nk = nk_all;
  if (causal) nk = min(nk, (q0 + BQT - 1) / BKT + 1);   // skip tiles above the diagonal
  const int m = INTERVALS ? mask_row(bh, H, MH) : 0;
  const int2* extm = ext + (size_t)m * nk_all;
  const int* srm = sr + (size_t)m * Sk;
  const int* erm = er + (size_t)m * Sk;

  // the first live k tile at or after x
  auto next_live = [&](int x) {
    if constexpr (INTERVALS) {
      while (x < nk && !interval_live(extm[x], q0, q0 + BQT - 1)) ++x;
    }
    return x;
  };
  // k, v and (FlashMask) the interval bounds of k tile kt into stage st;
  // bounds past Sk land as zeros, and those columns are masked by col < Sk
  auto load_k_tile = [&](int kt, int st) {
    const int k0 = kt * BKT;
    load_rows_async<D, LD, BKT, NTH>(Ks + st * BKT * LD, k + koff, k0, Sk);
    load_rows_async<D, LD, BKT, NTH>(Vs + st * BKT * LD, v + koff, k0, Sk);
    if constexpr (INTERVALS) {
      for (int i = threadIdx.x; i < 2 * BKT; i += NTH) {
        const int col = k0 + i % BKT;
        const bool live = col < Sk;
        const int* src = i < BKT ? srm : erm;
        cp_async4(Bs + st * 2 * BKT + i, live ? src + col : src, live);
      }
    }
  };

  load_rows_async<D, LD, BQT, NTH>(Qs, q + qoff, q0, Sq);
  load_rows_async<D, LD, BQT, NTH>(dOs, dout + qoff, q0, Sq);
  int kt = next_live(0);
  if (kt < nk) load_k_tile(kt, 0);
  cp_async_commit();

  float lse2[2], delta_s[2];                     // lse log2(e) and delta scale of the rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + g + 8 * h;
    lse2[h] = row < Sq ? lse[(size_t)bh * Sq + row] * LOG2E : 0.f;
    delta_s[h] = row < Sq ? delta[(size_t)bh * Sq + row] * scale : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int st = 0; kt < nk; st ^= 1) {
    const int k0 = kt * BKT;
    const int nxt = next_live(kt + 1);
    if (nxt < nk) {                               // the next live tile lands meanwhile
      load_k_tile(nxt, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + st * BKT * LD;
    const T* Vt = Vs + st * BKT * LD;

    // a warp whose rows are past Sq, all above the tile's first key, or all
    // inside every column's interval sees none of the tile
    bool skip = row_lo >= Sq || (causal && k0 > row_lo + 15);
    if constexpr (INTERVALS) skip = skip || !interval_live(extm[kt], row_lo, row_lo + 15);
    if (!skip) {
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) { s[j][e] = 0.f; dp[j][e] = 0.f; }
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t aq[4], ad[4];
        frag_a(aq, Qs, LD, 16 * warp, 16 * ks);
        frag_a(ad, dOs, LD, 16 * warp, 16 * ks);
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          uint32_t b[4];
          frag_b2(b, Kt, LD, 8 * j, 16 * ks);
          mma16816<T>(s[j], aq, b[0], b[1]);
          mma16816<T>(s[j + 1], aq, b[2], b[3]);
          frag_b2(b, Vt, LD, 8 * j, 16 * ks);
          mma16816<T>(dp[j], ad, b[0], b[1]);
          mma16816<T>(dp[j + 1], ad, b[2], b[3]);
        }
      }
      // p and ds in place; only tiles on the diagonal or an edge need the
      // causal and length mask, FlashMask tiles the interval everywhere
      const bool edge = (causal && k0 + BKT - 1 > row_lo) || k0 + BKT > Sk || row_lo + 16 > Sq;
      const int* srs = Bs + st * 2 * BKT;
      // the interval test only where an interval of the tile's columns can
      // meet the warp's rows: (min sr, max er) over the tile (padded
      // columns read as empty intervals at 0, which only widen it)
      bool hit = false;
      if constexpr (INTERVALS) {
        int smin = min(srs[lane], srs[lane + 32]);
        int emax = max(srs[BKT + lane], srs[BKT + lane + 32]);
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          smin = min(smin, __shfl_xor_sync(0xffffffffu, smin, off));
          emax = max(emax, __shfl_xor_sync(0xffffffffu, emax, off));
        }
        hit = row_lo < emax && row_lo + 15 >= smin;
      }
      auto p_ds_tile = [&](auto edge_c, auto hit_c) {
        constexpr bool EDGE = decltype(edge_c)::value, HIT = decltype(hit_c)::value;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int c = 8 * j + 2 * t;
          int2 s2 = make_int2(0, 0), e2 = make_int2(0, 0);
          if constexpr (HIT) {
            s2 = *reinterpret_cast<const int2*>(srs + c);
            e2 = *reinterpret_cast<const int2*>(srs + BKT + c);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row_lo + g + 8 * h;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = k0 + c + e;
              bool vis = true;
              if constexpr (EDGE) vis = row < Sq && col < Sk && (!causal || row >= col);
              if constexpr (HIT)
                vis = vis && !in_interval(row, e ? s2.y : s2.x, e ? e2.y : e2.x);
              p_ds_inplace(s[j][2 * h + e], dp[j][2 * h + e], vis, lse2[h], delta_s[h], scale);
            }
          }
        }
      };
      if (edge) {
        if (hit) p_ds_tile(std::true_type{}, std::true_type{});
        else p_ds_tile(std::true_type{}, std::false_type{});
      } else {
        if (hit) p_ds_tile(std::false_type{}, std::true_type{});
        else p_ds_tile(std::false_type{}, std::false_type{});
      }
      // dq += ds k: ds's accumulators are the A fragments, k [key][d] the B
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk) {
        uint32_t a[P][4];
        split_frag<T, P>(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          uint32_t b[4];
          frag_b2_t(b, Kt, LD, 8 * n, 16 * kk);
#pragma unroll
          for (int i = 0; i < P; ++i) {
            mma16816<T>(acc[n], a[i], b[0], b[1]);
            mma16816<T>(acc[n + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();                              // stage st is consumed
    kt = nxt;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_lo + g + 8 * h;
    if (row >= Sq) continue;
    T* dst = dq + qoff + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) = pack2<T>(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// dk / dv on the tensor cores (bf16 / fp16): one block of TC_DKV_WARPS
// warps per (bh, 64-key tile); warp (wk, wq) = (w % 4, w / 4) owns keys
// 16 wk .. 16 wk + 15 and, of each q tile, rows 32 wq .. 32 wq + 31. k and
// v stay in shared memory; (q, do, lse, delta) of the next live q tile
// land through the ring while the current one is multiplied. The products
// are taken transposed (s^T = k q^T), so that p^T and ds^T sit in the
// accumulators as the A fragments of p^T do and ds^T q. P parts of p and
// ds a product (1: rounded to T).
template <typename T, int D, bool INTERVALS, int P>
__global__ void __launch_bounds__(TC_DKV_WARPS * 32, D <= 64 ? 2 : 1)
flashmask_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ lse,
                         const float* __restrict__ delta, const T* __restrict__ dout,
                         const int* __restrict__ sr, const int* __restrict__ er,
                         const int2* __restrict__ ext, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int MH, int Sq, int Sk,
                         float scale, int causal) {
  constexpr int NTH = TC_DKV_WARPS * 32;
  constexpr int BQT = TC_BQ, BKT = BK;
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;     // k-steps of k q^T and v do^T
  constexpr int NQ = 4;          // a warp's score tiles: 8 query rows each
  constexpr int ND = D / 8;      // dk / dv tiles of 8 columns
  constexpr int LDR = D + 8;     // f32 row stride of the final sum
  static_assert(BKT == 16 * 4 && BQT == 32 * 2 && TC_DKV_WARPS == 8,
                "4 x 16 keys by 2 x 32 query rows");
  extern __shared__ __align__(16) unsigned char smem16[];
  T* Ks = reinterpret_cast<T*>(smem16);          // [BKT][LD]
  T* Vs = Ks + BKT * LD;                         // [BKT][LD]
  T* Qs = Vs + BKT * LD;                         // [2][BQT][LD]
  T* dOs = Qs + 2 * BQT * LD;                    // [2][BQT][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQT * LD);   // [2][BQT] lse
  float* Dl = Ls + 2 * BQT;                                    // [2][BQT] delta

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BKT;               // the longest causal walks first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wk = warp & 3, wq = warp >> 2;
  const int key_lo = k0 + 16 * wk;               // the warp's first key
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;
  const float* lse_b = lse + (size_t)bh * Sq;
  const float* delta_b = delta + (size_t)bh * Sq;

  // FlashMask: the intervals of the thread's keys (key_lo + g, + 8; past
  // Sk every row is masked), their (max sr, min er) over the warp's 16 keys
  // and the tile's from the pre-pass
  int ksr[2] = {0, 0}, ker[2] = {0, 0};
  int2 wext = make_int2(0, INT_MAX), e = make_int2(0, INT_MAX);
  int2 whit = make_int2(INT_MAX, INT_MIN);       // (min sr, max er) of the warp's keys
  if constexpr (INTERVALS) {
    const int m = mask_row(bh, H, MH);
    int smax = 0, emin = INT_MAX, smin = INT_MAX, emax = INT_MIN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = key_lo + g + 8 * h;
      ksr[h] = col < Sk ? sr[(size_t)m * Sk + col] : 0;
      ker[h] = col < Sk ? er[(size_t)m * Sk + col] : INT_MAX;
      if (col < Sk) {
        smax = max(smax, ksr[h]);
        emin = min(emin, ker[h]);
        smin = min(smin, ksr[h]);
        emax = max(emax, ker[h]);
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {     // over g: the lanes of one t
      smax = max(smax, __shfl_xor_sync(0xffffffffu, smax, off));
      emin = min(emin, __shfl_xor_sync(0xffffffffu, emin, off));
      smin = min(smin, __shfl_xor_sync(0xffffffffu, smin, off));
      emax = max(emax, __shfl_xor_sync(0xffffffffu, emax, off));
    }
    wext = make_int2(smax, emin);
    whit = make_int2(smin, emax);
    e = ext[(size_t)m * gridDim.x + blockIdx.x];
  }

  const int nq = (Sq + BQT - 1) / BQT;
  // the first live q tile at or after x
  auto next_live = [&](int x) {
    if constexpr (INTERVALS) {
      while (x < nq && !interval_live(e, x * BQT, x * BQT + BQT - 1)) ++x;
    }
    return x;
  };
  // q, do, lse and delta rows of q tile qt into stage st
  auto load_q_tile = [&](int qt, int st) {
    const int q0 = qt * BQT;
    load_rows_async<D, LD, BQT, NTH>(Qs + st * BQT * LD, q + qoff, q0, Sq);
    load_rows_async<D, LD, BQT, NTH>(dOs + st * BQT * LD, dout + qoff, q0, Sq);
    const int i = threadIdx.x;
    if (i < 2 * BQT) {
      const int r = i % BQT, row = q0 + r;
      const bool live = row < Sq;
      const float* src = i < BQT ? lse_b : delta_b;
      cp_async4((i < BQT ? Ls : Dl) + st * BQT + r, live ? src + row : src, live);
    }
  };

  load_rows_async<D, LD, BKT, NTH>(Ks, k + koff, k0, Sk);
  load_rows_async<D, LD, BKT, NTH>(Vs, v + koff, k0, Sk);
  // q tiles wholly above the diagonal see no key here
  int qt = next_live(causal ? k0 / BQT : 0);
  if (qt < nq) load_q_tile(qt, 0);
  cp_async_commit();

  float dKa[ND][4], dVa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) { dKa[n][i] = 0.f; dVa[n][i] = 0.f; }
  }

  for (int st = 0; qt < nq; st ^= 1) {
    const int q0 = qt * BQT;
    const int nxt = next_live(qt + 1);
    if (nxt < nq) {                               // the next live q tile lands meanwhile
      load_q_tile(nxt, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + st * BQT * LD;
    const T* dOt = dOs + st * BQT * LD;
    const int row_lo = q0 + 32 * wq;              // the warp's first query row

    bool skip = row_lo >= Sq || (causal && row_lo + 31 < key_lo);
    if constexpr (INTERVALS) skip = skip || !interval_live(wext, row_lo, row_lo + 31);
    if (!skip) {
      // s^T = k q^T and dp^T = v do^T: keys 16 wk .., query rows 32 wq ..
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) { s[j][i] = 0.f; dp[j][i] = 0.f; }
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ak[4], av[4];
        frag_a(ak, Ks, LD, 16 * wk, 16 * ks);
        frag_a(av, Vs, LD, 16 * wk, 16 * ks);
#pragma unroll
        for (int j = 0; j < NQ; j += 2) {
          uint32_t b[4];
          frag_b2(b, Qt, LD, 32 * wq + 8 * j, 16 * ks);
          mma16816<T>(s[j], ak, b[0], b[1]);
          mma16816<T>(s[j + 1], ak, b[2], b[3]);
          frag_b2(b, dOt, LD, 32 * wq + 8 * j, 16 * ks);
          mma16816<T>(dp[j], av, b[0], b[1]);
          mma16816<T>(dp[j + 1], av, b[2], b[3]);
        }
      }
      // p^T and ds^T in place: element (key key_lo + g + 8 h, query row
      // row_lo + 8 j + 2 t + e)
      const bool edge = (causal && row_lo < key_lo + 15) || key_lo + 16 > Sk || row_lo + 32 > Sq;
      // the interval test only where an interval of the warp's keys can
      // meet its rows; the causal and length mask only on edge tiles
      const bool hit = INTERVALS && row_lo < whit.y && row_lo + 31 >= whit.x;
      auto p_ds_tile = [&](auto edge_c, auto hit_c) {
        constexpr bool EDGE = decltype(edge_c)::value, HIT = decltype(hit_c)::value;
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int c = 32 * wq + 8 * j + 2 * t;  // the query row in the tile
          float2 l2 = *reinterpret_cast<const float2*>(Ls + st * BQT + c);
          float2 d2 = *reinterpret_cast<const float2*>(Dl + st * BQT + c);
          l2 = make_float2(l2.x * LOG2E, l2.y * LOG2E);
          d2 = make_float2(d2.x * scale, d2.y * scale);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int key = key_lo + g + 8 * h;
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int row = q0 + c + x;
              bool vis = true;
              if constexpr (EDGE) vis = row < Sq && key < Sk && (!causal || row >= key);
              if constexpr (HIT) vis = vis && !in_interval(row, ksr[h], ker[h]);
              p_ds_inplace(s[j][2 * h + x], dp[j][2 * h + x], vis, x ? l2.y : l2.x,
                           x ? d2.y : d2.x, scale);
            }
          }
        }
      };
      if (edge) {
        if (hit) p_ds_tile(std::true_type{}, std::true_type{});
        else p_ds_tile(std::true_type{}, std::false_type{});
      } else {
        if (hit) p_ds_tile(std::false_type{}, std::true_type{});
        else p_ds_tile(std::false_type{}, std::false_type{});
      }
      // dv += p^T do and dk += ds^T q over the warp's 32 query rows: do and
      // q [row][d] are the B operands, read transposed
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ap[P][4], ads[P][4];
        split_frag<T, P>(ap, s[2 * kk], s[2 * kk + 1]);
        split_frag<T, P>(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          uint32_t b[4];
          frag_b2_t(b, dOt, LD, 8 * n, 32 * wq + 16 * kk);
#pragma unroll
          for (int i = 0; i < P; ++i) {
            mma16816<T>(dVa[n], ap[i], b[0], b[1]);
            mma16816<T>(dVa[n + 1], ap[i], b[2], b[3]);
          }
          frag_b2_t(b, Qt, LD, 8 * n, 32 * wq + 16 * kk);
#pragma unroll
          for (int i = 0; i < P; ++i) {
            mma16816<T>(dKa[n], ads[i], b[0], b[1]);
            mma16816<T>(dKa[n + 1], ads[i], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();                              // stage st is consumed
    qt = nxt;
  }
  cp_async_wait<0>();
  __syncthreads();

  // dk / dv = the wq = 0 half + the wq = 1 half, through the ring's space
  float* red = reinterpret_cast<float*>(Qs);     // [2][BKT][LDR] f32
  const int r0 = 16 * wk + g;
  if (wq == 1) {
#pragma unroll
    for (int n = 0; n < ND; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* rk = red + (r0 + 8 * h) * LDR + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(rk) = make_float2(dKa[n][2 * h], dKa[n][2 * h + 1]);
        *reinterpret_cast<float2*>(rk + BKT * LDR) = make_float2(dVa[n][2 * h], dVa[n][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  if (wq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key_lo + g + 8 * h;
      if (key >= Sk) continue;
      const size_t base = koff + (size_t)key * D + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const float* rk = red + (r0 + 8 * h) * LDR + 8 * n + 2 * t;
        const float2 ok = *reinterpret_cast<const float2*>(rk);
        const float2 ov = *reinterpret_cast<const float2*>(rk + BKT * LDR);
        *reinterpret_cast<uint32_t*>(dk + base + 8 * n) =
            pack2<T>(dKa[n][2 * h] + ok.x, dKa[n][2 * h + 1] + ok.y);
        *reinterpret_cast<uint32_t*>(dv + base + 8 * n) =
            pack2<T>(dVa[n][2 * h] + ov.x, dVa[n][2 * h + 1] + ov.y);
      }
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

// The forward body a dtype takes: 0 the CUDA-core f32 body, else the
// tensor-core body with that many 16-bit parts of p in p v
template <typename T>
constexpr int fwd_parts() {
  return std::is_same<T, float>::value ? 0 : FM_FWD_PARTS;
}

template <typename T, int D>
int fwd_t(const void* q, const void* k, const void* v, const int* sr,
          const int* er, const int* ext, void* o, float* lse, int BH, int H,
          int MH, int Sq, int Sk, float scale, int causal, cudaStream_t stream) {
  constexpr int P = fwd_parts<T>();
  size_t smem;
  void (*kern)(const T*, const T*, const T*, const int*, const int*, const int2*, T*,
               float*, int, int, int, int, float, int);
  dim3 grid, block;
  if constexpr (P == 0) {
    smem = sizeof(float) *
        (BQ * (D + PAD) + D * (BK + PAD) + BK * (D + PAD) + BQ * (BK + PAD)) +
        2 * BK * sizeof(int);
    kern = flashmask_fwd_kernel_f32<D>;
    grid = dim3((Sq + BQ - 1) / BQ, BH);
    block = dim3(NT);
  } else {
    smem = sizeof(T) * (TC_BQ + 4 * BK) * (D + 8) + 4 * BK * sizeof(int);
    kern = flashmask_fwd_kernel<T, D, P>;
    grid = dim3((Sq + TC_BQ - 1) / TC_BQ, BH);
    block = dim3(TC_FWD_WARPS * 32);
  }
  static const cudaError_t attr = allow_smem(kern, smem);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<grid, block, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, sr, er,
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

// The backward body a dtype and mode take: 0 the CUDA-core f32 body, else
// the tensor-core body with that many 16-bit parts of p and ds a product
// (FlashMask FM_PARTS, two-pass 1: p and ds rounded to T)
template <typename T>
constexpr int tc_parts(bool intervals) {
  return std::is_same<T, float>::value ? 0 : intervals ? FM_PARTS : 1;
}

template <typename T, int D, bool IV>
int dq_t(const BwdArgs& a, void* dq) {
  constexpr int P = tc_parts<T>(IV);
  size_t smem;
  void (*kern)(const T*, const T*, const T*, const float*, const float*, const T*,
               const int*, const int*, const int2*, T*, int, int, int, int, float, int);
  dim3 grid, block;
  if constexpr (P == 0) {
    smem = sizeof(float) *
        (2 * BQ * (D + PAD) + BK * (D + PAD) + 2 * D * (BK + PAD) + BQ * (BK + PAD)) +
        2 * BK * sizeof(int);
    kern = flashmask_bwd_dq_kernel_f32<D, IV>;
    grid = dim3((a.Sq + BQ - 1) / BQ, a.BH);
    block = dim3(NT);
  } else {
    smem = sizeof(T) * (2 * TC_BQ + 4 * BK) * (D + 8) + 4 * BK * sizeof(int);
    kern = flashmask_bwd_dq_kernel<T, D, IV, P>;
    grid = dim3((a.Sq + TC_BQ - 1) / TC_BQ, a.BH);
    block = dim3(TC_DQ_WARPS * 32);
  }
  static const cudaError_t attr = allow_smem(kern, smem);
  if (attr != cudaSuccess) return (int)attr;
  kern<<<grid, block, smem, a.stream>>>((const T*)a.q, (const T*)a.k, (const T*)a.v,
                                        a.lse, a.delta, (const T*)a.dout, a.sr, a.er,
                                        reinterpret_cast<const int2*>(a.ext), (T*)dq,
                                        a.H, a.MH, a.Sq, a.Sk, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool IV>
int dkv_t(const BwdArgs& a, void* dk, void* dv) {
  constexpr int P = tc_parts<T>(IV);
  size_t smem;
  void (*kern)(const T*, const T*, const T*, const float*, const float*, const T*,
               const int*, const int*, const int2*, T*, T*, int, int, int, int, float,
               int);
  dim3 block;
  if constexpr (P == 0) {
    smem = sizeof(float) *
        (2 * D * (BK + PAD) + 2 * BQB * (D + PAD) + 2 * BQB * (BK + PAD)) +
        2 * BK * sizeof(int);
    kern = flashmask_bwd_dkv_kernel_f32<D, IV>;
    block = dim3(NT);
  } else {
    smem = sizeof(T) * (2 * BK + 4 * TC_BQ) * (D + 8) + 4 * TC_BQ * sizeof(float);
    kern = flashmask_bwd_dkv_kernel<T, D, IV, P>;
    block = dim3(TC_DKV_WARPS * 32);
  }
  static const cudaError_t attr = allow_smem(kern, smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((a.Sk + BK - 1) / BK, a.BH);
  kern<<<grid, block, smem, a.stream>>>((const T*)a.q, (const T*)a.k, (const T*)a.v,
                                        a.lse, a.delta, (const T*)a.dout, a.sr, a.er,
                                        reinterpret_cast<const int2*>(a.ext), (T*)dk,
                                        (T*)dv, a.H, a.MH, a.Sq, a.Sk, a.scale, a.causal);
  return (int)cudaGetLastError();
}

// FlashMask: the interval and f32 p, ds; two-pass: no interval, rounding
template <typename T, int D>
int dq_m(int mode, const BwdArgs& a, void* dq) {
  return mode == 0 ? dq_t<T, D, true>(a, dq) : dq_t<T, D, false>(a, dq);
}
template <typename T, int D>
int dkv_m(int mode, const BwdArgs& a, void* dk, void* dv) {
  return mode == 0 ? dkv_t<T, D, true>(a, dk, dv) : dkv_t<T, D, false>(a, dk, dv);
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

// The backward body that mode (0 FlashMask, 1 two-pass) and dtype (0
// float32, 1 bfloat16, 2 float16) launch: 0 the CUDA-core f32 body, else
// the tensor-core body with this many 16-bit parts of p and ds a product;
// -1 for a mode or dtype the launches refuse.
int flashmask_bwd_parts(int mode, int dtype) {
  if (mode != 0 && mode != 1) return -1;
  switch (dtype) {
    case 0: return tc_parts<float>(mode == 0);
    case 1: return tc_parts<__nv_bfloat16>(mode == 0);
    case 2: return tc_parts<__half>(mode == 0);
    default: return -1;
  }
}

// The forward body that dtype (0 float32, 1 bfloat16, 2 float16)
// launches: 0 the CUDA-core f32 body, else the tensor-core body with this
// many 16-bit parts of p in p v; -1 for a dtype the launch refuses.
int flashmask_fwd_parts(int dtype) {
  switch (dtype) {
    case 0: return fwd_parts<float>();
    case 1: return fwd_parts<__nv_bfloat16>();
    case 2: return fwd_parts<__half>();
    default: return -1;
  }
}

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
