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
// D is 16, 32, 64 or 128. Any Sq, Sk: tiles past the end are zero-filled
// and masked. The causal mask is top-left aligned (row >= col), as the TPU
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
// What bounds it: at the flagship shape (S = 2048, D = 64, causal)
// operations: the forward does about 500 flops per byte it must move,
// above the ~295 at which the bf16 tensor cores, not memory, are the
// limit. So bf16 and fp16 run on the tensor cores; f32 keeps a CUDA-core
// body, since TF32 would round the f32 training the smoke holds to 1e-4.
//
// Tensor-core bodies (bf16 / fp16; helpers in mma_tiles.cuh). Operands
// are staged in shared memory in their own 16-bit type, rows padded by 16
// bytes so that ldmatrix reads are free of bank conflicts, by cp.async
// copies (16 bytes a thread, rows past the end zero-filled: the tails that
// make the reference's kernel read NaN stay exact here) into a two-stage
// ring: the next tile lands while the current one is multiplied. Products
// are mma.sync.m16n8k16 with f32 accumulators; each warp owns 16-row
// slices of its products in registers, so row reductions are shuffles
// among the four lanes of a row. The forward's exp(x) is exp2(x log2 e),
// the factor folded into the score scale. Only the diagonal tile and the ragged last
// tile evaluate the mask.
//   Forward: one block of 8 warps per (bh, 128 query rows) loads its q
//   fragments into registers once and walks the 64-key tiles up to the
//   diagonal (tiles strictly above it are skipped, :141; longest rows
//   first); a warp whose rows all precede a tile's first key skips it.
//   p is rounded to T and repacked from the score accumulators straight
//   into the A fragments of p @ v. o leaves through shared memory in
//   16-byte stores.
//   Backward (the FA2 layout): one block of 8 warps per (bh, 64-key tile)
//   keeps K and V in shared memory and dk / dv in registers, and walks the
//   64-row q tiles from the diagonal down, (q, do, lse, delta) arriving
//   through the ring. s = q k^T and dp = do v^T are computed once per
//   pair; p and ds, rounded to T, go through shared memory into
//   dv += p^T do, dk += ds^T q and dq = ds k; dq is added into dq_acc
//   with float2 atomics. The TPU kernel's per-k-tile dq partials
//   [nk, BH, S, D] would cost nk times dq's bytes (2 GB per layer at the
//   flagship shape); the atomics cost one f32 buffer, and f32 addition
//   order makes dq non-deterministic in its last bits (dk and dv are
//   deterministic). delta = rowsum(do * o) is one small pre-pass kernel.
//   Rope: the loop-invariant tile is rotated once in shared memory (q in
//   the forward, k in the backward, as the TPU kernel's scratch, :94-98
//   and :245-247) and the walked tile after it lands, each table element
//   read once per tile. dq and dk are counter-rotated in registers: the
//   backward lays a warp's D columns out so that the neox partner of
//   column j (j + D / 2) is held by the same thread (see d_tile).
//
// CUDA-core body (f32): tiles of 64 query rows by 64 keys, 256 threads as
// a 16 x 16 grid, every thread a small register tile of each product, the
// operands staged in shared memory as f32 (flash_tiles.cuh, shared with
// flashmask.cu); the backward walks 32-row q tiles and adds dq with
// scalar atomics. The neox partner of a thread's column there is held by
// the lane tx ^ 8 of the same half-warp.

#include "flash_tiles.cuh"
#include "mma_tiles.cuh"

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
flash_fwd_kernel_f32(const T* __restrict__ q, const T* __restrict__ k,
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
flash_bwd_kernel_f32(const T* __restrict__ q, const T* __restrict__ k,
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

// ---------------------------------------------------------------------------
// Tensor-core bodies (bf16 / fp16)
// ---------------------------------------------------------------------------

// Forward block shape, chosen by measurement (PERF.md, tools/
// flash_kernel_ab.py): 8 warps of 16 query rows, and for D <= 64 a
// register cap of 128 so that two blocks share an SM (at D = 128 the cap
// spills; one block of 222 registers runs faster).
constexpr int TC_FWD_WARPS = 8;
constexpr int TC_FWD_MIN_BLOCKS_D64 = 2;
constexpr int TC_BK = 64;        // key rows per tile (forward and backward)
constexpr int TC_BQB = 64;       // backward: query rows per tile
constexpr int TC_BWD_THREADS = 256;
// The forward takes exp(x) as exp2(x log2 e), the factor folded into the
// score scale (one multiply-add and one MUFU.EX2 per element); the
// backward keeps expf, whose p stays closest to the plain version's
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Neox rotation of a 16-bit tile in shared memory, element (r, d) at
// X[r * LD + d], for the sequence rows [row0, row0 + rows): rounded as
// rope_tile does. A thread takes two neighbouring columns of each half
// (32-bit shared accesses, one float2 of each table); each table element
// is read once per tile.
template <typename T, int D, int LD, int NTH>
__device__ __forceinline__ void rope_tile16(T* X, const float* __restrict__ rcos,
                                            const float* __restrict__ rsin,
                                            int row0, int rows, int total) {
  constexpr int HALF = D / 2, PAIRS = HALF / 2;
  for (int i = threadIdx.x; i < rows * PAIRS; i += NTH) {
    const int r = i / PAIRS, j = 2 * (i % PAIRS), gr = row0 + r;
    if (gr >= total) continue;
    const float2 c2 = __ldg(reinterpret_cast<const float2*>(rcos + (size_t)gr * HALF + j));
    const float2 s2 = __ldg(reinterpret_cast<const float2*>(rsin + (size_t)gr * HALF + j));
    T* p1 = X + r * LD + j;
    T* p2 = p1 + HALF;
    float o1[2], o2[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float c = round_to<T>(e ? c2.y : c2.x), s = round_to<T>(e ? s2.y : s2.x);
      const float x1 = to_f(p1[e]), x2 = to_f(p2[e]);
      o1[e] = __fsub_rn(round_to<T>(__fmul_rn(x1, c)), round_to<T>(__fmul_rn(x2, s)));
      o2[e] = __fadd_rn(round_to<T>(__fmul_rn(x2, c)), round_to<T>(__fmul_rn(x1, s)));
    }
    *reinterpret_cast<uint32_t*>(p1) = pack2<T>(o1[0], o1[1]);
    *reinterpret_cast<uint32_t*>(p2) = pack2<T>(o2[0], o2[1]);
  }
}

// The backward splits D over two warps (wc = 0, 1), each holding NH = D / 16
// accumulator tiles of 8 columns: local tile i is global tile
// (i / QH) * (D / 16) + wc * QH + i % QH with QH = D / 32, so the neox
// partner of column j (j + D / 2) sits in local tile i + QH of the same
// thread, at the same element: the counter-rotation needs no shuffle.
// At D = 16 (QH = 0) warp wc holds the one tile wc, and the partner sits
// in the other warp of the pair (rope_bwd_frag16).
template <int D>
__device__ __forceinline__ int d_tile(int i, int wc) {
  constexpr int QH = D / 32;
  if constexpr (QH == 0) return wc;
  else return (i / QH) * (D / 16) + wc * QH + i % QH;
}

// Counter-rotation (the transpose of the neox rotation, in f32) of a
// [16, D / 2] accumulator slice in the layout above: rows row_base + g and
// row_base + g + 8; rows past `total` are left as they are.
template <int D>
__device__ __forceinline__ void rope_bwd_frag(float (&x)[D / 16][4], const float* __restrict__ rcos,
                                              const float* __restrict__ rsin, int row_base,
                                              int total, int wc) {
  constexpr int HALF = D / 2, QH = D / 32;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_base + g + 8 * h;
    if (row >= total) continue;
#pragma unroll
    for (int i = 0; i < QH; ++i) {
      const int col = 8 * d_tile<D>(i, wc) + 2 * t;
      const float2 c = __ldg(reinterpret_cast<const float2*>(rcos + (size_t)row * HALF + col));
      const float2 s = __ldg(reinterpret_cast<const float2*>(rsin + (size_t)row * HALF + col));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float cc = e ? c.y : c.x, ss = e ? s.y : s.x;
        const float x1 = x[i][2 * h + e], x2 = x[i + QH][2 * h + e];
        x[i][2 * h + e] = __fadd_rn(__fmul_rn(x1, cc), __fmul_rn(x2, ss));
        x[i + QH][2 * h + e] = __fsub_rn(__fmul_rn(x2, cc), __fmul_rn(x1, ss));
      }
    }
  }
}

// The counter-rotation at D = 16, where warps (wr, 0) and (wr, 1) hold the
// two halves of rows 16 wr ..: the pair trades its f32 values through X
// ([64][16] f32 in shared memory), then each thread rotates its own as
// rope_bwd_frag does. Every thread of the block calls it (it holds two
// __syncthreads).
__device__ __forceinline__ void rope_bwd_frag16(float (&x)[1][4], float* X,
                                                const float* __restrict__ rcos,
                                                const float* __restrict__ rsin, int row_base,
                                                int total, int wr, int wc) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* xr = X + (16 * wr + g + 8 * h) * 16 + 8 * wc + 2 * t;
    xr[0] = x[0][2 * h];
    xr[1] = x[0][2 * h + 1];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_base + g + 8 * h;
    if (row >= total) continue;
    const float* other = X + (16 * wr + g + 8 * h) * 16 + 8 * (wc ^ 1) + 2 * t;
    const float2 c = __ldg(reinterpret_cast<const float2*>(rcos + (size_t)row * 8 + 2 * t));
    const float2 s = __ldg(reinterpret_cast<const float2*>(rsin + (size_t)row * 8 + 2 * t));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float cc = e ? c.y : c.x, ss = e ? s.y : s.x;
      const float own = __fmul_rn(x[0][2 * h + e], cc), part = __fmul_rn(other[e], ss);
      x[0][2 * h + e] = wc == 0 ? __fadd_rn(own, part) : __fsub_rn(own, part);
    }
  }
  __syncthreads();
}

// the counter-rotation of a warp's [16, D / 2] accumulator slice, either form
template <int D>
__device__ __forceinline__ void rope_bwd_acc(float (&x)[D / 16][4], float* X,
                                             const float* __restrict__ rcos,
                                             const float* __restrict__ rsin, int row_base,
                                             int total, int wr, int wc) {
  if constexpr (D == 16) rope_bwd_frag16(x, X, rcos, rsin, row_base, total, wr, wc);
  else rope_bwd_frag<D>(x, rcos, rsin, row_base, total, wc);
}

// acc[i] += A B[:, 8 d_tile(i) ..] for the warp's NH tiles of D columns;
// B stored [k][n] (dO, Q or K rows), the A fragment given
template <typename T, int D>
__device__ __forceinline__ void mma_d_tiles(float (&acc)[D / 16][4], const uint32_t (&a)[4],
                                            const T* B, int ld, int k0, int wc) {
  constexpr int NH = D / 16, QH = D / 32;
  if constexpr (QH >= 2) {
#pragma unroll
    for (int i = 0; i < NH; i += 2) {           // tiles i, i + 1 are adjacent
      uint32_t b[4];
      frag_b2_t(b, B, ld, 8 * d_tile<D>(i, wc), k0);
      mma16816<T>(acc[i], a, b[0], b[1]);
      mma16816<T>(acc[i + 1], a, b[2], b[3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      uint32_t b[2];
      frag_b1_t(b, B, ld, 8 * d_tile<D>(i, wc), k0);
      mma16816<T>(acc[i], a, b[0], b[1]);
    }
  }
}

// Forward on the tensor cores: one block of TC_FWD_WARPS warps per
// (bh, tile of 16 * warps query rows); warp w owns rows 16 w .. 16 w + 15
// of the tile, its q fragments in registers, its S = q k^T slice [16, 64]
// and its o accumulator [16, D] as m16n8 f32 tiles. The K / V tiles walk
// a two-stage cp.async ring: tile kt + 1 lands while tile kt is multiplied.
template <typename T, int D>
__global__ void __launch_bounds__(TC_FWD_WARPS * 32, D <= 64 ? TC_FWD_MIN_BLOCKS_D64 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const float* __restrict__ rcos,
                 const float* __restrict__ rsin, int Sq, int Sk, float scale,
                 int causal) {
  constexpr int NTH = TC_FWD_WARPS * 32;
  constexpr int BQT = 16 * TC_FWD_WARPS, BKT = TC_BK;
  constexpr int LD = D + 8;      // 16-bit row stride: 16 bytes of padding
  constexpr int KS = D / 16;     // k-steps of q k^T
  constexpr int NS = BKT / 8;    // score tiles of 8 keys
  constexpr int NO = D / 8;      // output tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem16[];
  T* Qs = reinterpret_cast<T*>(smem16);          // [BQT][LD], then the o staging
  T* Ks = Qs + BQT * LD;                         // [2][BKT][LD]
  T* Vs = Ks + 2 * BKT * LD;                     // [2][BKT][LD]

  const int bh = blockIdx.y;
  // the longest causal rows first, so they do not trail the grid
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr0 = warp * 16;                     // the warp's first row in the tile
  const int row_lo = q0 + wr0;
  const float scale_log2 = scale * LOG2E;       // scores and m in log2 units
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;

  int nk = (Sk + BKT - 1) / BKT;
  if (causal) nk = min(nk, (q0 + BQT - 1) / BKT + 1);  // skip tiles above the diagonal

  load_rows_async<D, LD, BQT, NTH>(Qs, qb, q0, Sq);
  if (nk > 0) {
    load_rows_async<D, LD, BKT, NTH>(Ks, kb, 0, Sk);
    load_rows_async<D, LD, BKT, NTH>(Vs, vb, 0, Sk);
  }
  cp_async_commit();

  uint32_t qf[KS][4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * BKT;
    if (kt + 1 < nk) {                            // the next tile lands meanwhile
      load_rows_async<D, LD, BKT, NTH>(Ks + (st ^ 1) * BKT * LD, kb, k0 + BKT, Sk);
      load_rows_async<D, LD, BKT, NTH>(Vs + (st ^ 1) * BKT * LD, vb, k0 + BKT, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    T* Kt = Ks + st * BKT * LD;
    const T* Vt = Vs + st * BKT * LD;
    if (kt == 0) {
      if (rcos) {                                 // the q tile is loop-invariant: rotate once
        rope_tile16<T, D, LD, NTH>(Qs, rcos, rsin, q0, BQT, Sq);
        __syncthreads();
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) frag_a(qf[ks], Qs, LD, wr0, 16 * ks);
    }
    if (rcos) {
      rope_tile16<T, D, LD, NTH>(Kt, rcos, rsin, k0, BKT, Sk);
      __syncthreads();
    }

    // a warp whose rows all sit above this tile's first key sees none of it
    if (!(causal && k0 > row_lo + 15)) {
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
      // only the diagonal tile and the ragged last tile need the mask
      const bool edge = k0 + BKT > Sk || (causal && k0 + BKT - 1 > row_lo);
      auto visible = [&](int j, int e) {
        const int row = row_lo + g + 8 * (e >> 1), col = k0 + 8 * j + 2 * t + (e & 1);
        return !edge || (col < Sk && (!causal || row >= col));
      };
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = visible(j, e) ? s[j][e] * scale_log2 : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
      float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {               // a row's four lanes: t = 0 .. 3
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex = visible(j, e) ? exp2f(s[j][e] - m[e >> 1]) : 0.f;
          psum[e >> 1] += ex;
          s[j][e] = ex;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
        psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
        l[h] = corr[h] * l[h] + psum[h];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
        acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
      }
      // o += p v: p rounded to v's dtype, the score tiles repacked as A
      // fragments in registers
#pragma unroll
      for (int kk = 0; kk < BKT / 16; ++kk) {
        uint32_t pf[4];
        pf[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
        pf[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
        pf[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pf[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t b[4];
          frag_b2_t(b, Vt, LD, 8 * n, 16 * kk);
          mma16816<T>(acc[n], pf, b[0], b[1]);
          mma16816<T>(acc[n + 1], pf, b[2], b[3]);
        }
      }
    }
    __syncthreads();                              // stage st is consumed
  }

  cp_async_wait<0>();                             // no copy may still target Qs
  __syncthreads();
  // o = acc / l through the warp's own 16 rows of Qs, then 16-byte stores
  float lz[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) lz[h] = l[h] == 0.f ? 1.f : l[h];   // fully masked rows -> zeros
  T* Os = Qs + wr0 * LD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<uint32_t*>(Os + (g + 8 * h) * LD + 8 * n + 2 * t) =
          pack2<T>(acc[n][2 * h] / lz[h], acc[n][2 * h + 1] / lz[h]);
    }
  }
  __syncwarp();
  constexpr int CPR = D / 8;
#pragma unroll
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, cc = c % CPR, row = row_lo + r;
    if (row < Sq) {
      *reinterpret_cast<uint4*>(o + ((size_t)bh * Sq + row) * D + cc * 8) =
          *reinterpret_cast<const uint4*>(Os + r * LD + cc * 8);
    }
  }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + g + 8 * h;
      if (row < Sq) lse[(size_t)bh * Sq + row] = l[h] == 0.f ? NEG_INF : m[h] * LN2 + logf(lz[h]);
    }
  }
}

// Backward on the tensor cores (the FA2 layout): one block of 8 warps per
// (bh, 64-key tile) keeps K and V in shared memory (K rotated once with
// rope) and the dK / dV accumulators in registers, and walks the 64-row q
// tiles from the diagonal down through a two-stage cp.async ring of
// (q, do, lse, delta). Per q tile, warp (wr, wc) = (w % 4, w / 4):
//   s = q k^T and dp = do v^T for q rows 16 wr .., keys 32 wc .. (32);
//   p and ds rounded to T into shared memory;
//   dv += p^T do and dk += ds^T q for keys 16 wr .., half wc of D;
//   dq = ds k for q rows 16 wr .., half wc of D, added into dq_acc with
//   float2 atomics (counter-rotated first with rope).
template <typename T, int D>
__global__ void __launch_bounds__(TC_BWD_THREADS)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ lse,
                 const float* __restrict__ delta, const T* __restrict__ dout,
                 float* __restrict__ dq_acc, T* __restrict__ dk,
                 T* __restrict__ dv, const float* __restrict__ rcos,
                 const float* __restrict__ rsin, int Sq, int Sk, float scale,
                 int causal) {
  constexpr int NTH = TC_BWD_THREADS;
  constexpr int BQT = TC_BQB, BKT = TC_BK;
  constexpr int LD = D + 8, LDP = BKT + 8;
  constexpr int KS = D / 16;     // k-steps over D
  constexpr int NH = D / 16;     // a warp's accumulator tiles of D columns
  extern __shared__ __align__(16) unsigned char smem16[];
  T* Ks = reinterpret_cast<T*>(smem16);          // [BKT][LD]
  T* Vs = Ks + BKT * LD;                         // [BKT][LD]
  T* Qs = Vs + BKT * LD;                         // [2][BQT][LD]
  T* dOs = Qs + 2 * BQT * LD;                    // [2][BQT][LD]
  T* Ps = dOs + 2 * BQT * LD;                    // [BQT][LDP]
  T* dSs = Ps + BQT * LDP;                       // [BQT][LDP]
  float* Ls = reinterpret_cast<float*>(dSs + BQT * LDP);   // [2][BQT] lse
  float* Dl = Ls + 2 * BQT;                                 // [2][BQT] delta
  float* Xr = Dl + 2 * BQT;       // D = 16 with rope: [BQT][16] f32 (rope_bwd_frag16)

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BKT;               // the longest causal walks first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp & 3, wc = warp >> 2;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;
  const float* lse_b = lse + (size_t)bh * Sq;
  const float* delta_b = delta + (size_t)bh * Sq;

  const int nq = (Sq + BQT - 1) / BQT;
  const int qt0 = causal ? k0 / BQT : 0;         // q tiles wholly above the diagonal see no key here

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
  if (qt0 < nq) load_q_tile(qt0, 0);
  cp_async_commit();

  float dKa[NH][4], dVa[NH][4];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) { dKa[i][e] = 0.f; dVa[i][e] = 0.f; }
  }

  for (int qt = qt0; qt < nq; ++qt) {
    const int st = (qt - qt0) & 1, q0 = qt * BQT;
    if (qt + 1 < nq) {                            // the next q tile lands meanwhile
      load_q_tile(qt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    T* Qt = Qs + st * BQT * LD;
    const T* dOt = dOs + st * BQT * LD;
    if (rcos) {
      if (qt == qt0) rope_tile16<T, D, LD, NTH>(Ks, rcos, rsin, k0, BKT, Sk);  // once
      rope_tile16<T, D, LD, NTH>(Qt, rcos, rsin, q0, BQT, Sq);
      __syncthreads();
    }

    // s = q k^T and dp = do v^T: q rows 16 wr .., keys 32 wc .. 32 wc + 31
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) { s[j][e] = 0.f; dp[j][e] = 0.f; }
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4], ad[4];
      frag_a(a, Qt, LD, 16 * wr, 16 * ks);
      frag_a(ad, dOt, LD, 16 * wr, 16 * ks);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t b[4];
        frag_b2(b, Ks, LD, 32 * wc + 8 * j, 16 * ks);
        mma16816<T>(s[j], a, b[0], b[1]);
        mma16816<T>(s[j + 1], a, b[2], b[3]);
        frag_b2(b, Vs, LD, 32 * wc + 8 * j, 16 * ks);
        mma16816<T>(dp[j], ad, b[0], b[1]);
        mma16816<T>(dp[j + 1], ad, b[2], b[3]);
      }
    }
    // p = exp(s * scale - lse) and ds = p (dp - delta) scale, each rounded
    // to q's dtype; only tiles on the diagonal or an edge need the mask
    const bool edge = (causal && q0 < k0 + BKT - 1) || k0 + BKT > Sk || q0 + BQT > Sq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wr + g + 8 * h, row = q0 + r;
      const float lse_r = Ls[st * BQT + r], delta_r = Dl[st * BQT + r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 32 * wc + 8 * j + 2 * t;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + c + e;
          const bool vis = !edge || (row < Sq && col < Sk && (!causal || row >= col));
          const float ex = vis ? expf(s[j][2 * h + e] * scale - lse_r) : 0.f;
          p[e] = ex;
          ds[e] = ex * (dp[j][2 * h + e] - delta_r) * scale;
        }
        *reinterpret_cast<uint32_t*>(Ps + r * LDP + c) = pack2<T>(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(dSs + r * LDP + c) = pack2<T>(ds[0], ds[1]);
      }
    }
    __syncthreads();

    // dv += p^T do, dk += ds^T q: keys 16 wr .., half wc of D
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk) {
      uint32_t ap[4], ads[4];
      frag_a_t(ap, Ps, LDP, 16 * wr, 16 * kk);
      frag_a_t(ads, dSs, LDP, 16 * wr, 16 * kk);
      mma_d_tiles<T, D>(dVa, ap, dOt, LD, 16 * kk, wc);
      mma_d_tiles<T, D>(dKa, ads, Qt, LD, 16 * kk, wc);
    }
    // dq = ds k: q rows 16 wr .., half wc of D
    float dq[NH][4];
#pragma unroll
    for (int i = 0; i < NH; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, dSs, LDP, 16 * wr, 16 * kk);
      mma_d_tiles<T, D>(dq, a, Ks, LD, 16 * kk, wc);
    }
    if (rcos) rope_bwd_acc<D>(dq, Xr, rcos, rsin, q0 + 16 * wr, Sq, wr, wc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 16 * wr + g + 8 * h;
      if (row >= Sq) continue;
      float* dst = dq_acc + qoff + (size_t)row * D + 2 * t;
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        atomicAdd(reinterpret_cast<float2*>(dst + 8 * d_tile<D>(i, wc)),
                  make_float2(dq[i][2 * h], dq[i][2 * h + 1]));
      }
    }
    __syncthreads();                              // p, ds and stage st are consumed
  }
  cp_async_wait<0>();

  if (rcos) rope_bwd_acc<D>(dKa, Xr, rcos, rsin, k0 + 16 * wr, Sk, wr, wc);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + 16 * wr + g + 8 * h;
    if (row >= Sk) continue;
    const size_t base = koff + (size_t)row * D + 2 * t;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const int col = 8 * d_tile<D>(i, wc);
      *reinterpret_cast<uint32_t*>(dk + base + col) = pack2<T>(dKa[i][2 * h], dKa[i][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + col) = pack2<T>(dVa[i][2 * h], dVa[i][2 * h + 1]);
    }
  }
}

template <typename T, int D>
int fwd_t(const void* q, const void* k, const void* v, void* o, float* lse,
          const float* rcos, const float* rsin, int BH, int Sq, int Sk,
          float scale, int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = sizeof(float) *
        (BQ * (D + PAD) + D * (BK + PAD) + BK * (D + PAD) + BQ * (BK + PAD));
    auto kern = flash_fwd_kernel_f32<T, D>;
    static const cudaError_t attr = allow_smem(kern, smem);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid((Sq + BQ - 1) / BQ, BH);
    kern<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                     (T*)o, lse, rcos, rsin, Sq, Sk, scale,
                                     causal);
  } else {
    constexpr int BQT = 16 * TC_FWD_WARPS;
    const size_t smem = sizeof(T) * (BQT + 4 * TC_BK) * (D + 8);
    auto kern = flash_fwd_kernel<T, D>;
    static const cudaError_t attr = allow_smem(kern, smem);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid((Sq + BQT - 1) / BQT, BH);
    kern<<<grid, TC_FWD_WARPS * 32, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, rcos, rsin, Sq, Sk,
        scale, causal);
  }
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
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = sizeof(float) *
        (2 * D * (BK + PAD) + BK * (D + PAD) + 2 * BQB * (D + PAD) + 2 * BQB * (BK + PAD));
    auto kern = flash_bwd_kernel_f32<T, D>;
    static const cudaError_t attr = allow_smem(kern, smem);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid((Sk + BK - 1) / BK, BH);
    kern<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, lse,
                                     delta, (const T*)dout, dq_acc, (T*)dk,
                                     (T*)dv, rcos, rsin, Sq, Sk, scale, causal);
  } else {
    const size_t smem = sizeof(T) * ((2 * TC_BK + 4 * TC_BQB) * (D + 8) +
                                     2 * TC_BQB * (TC_BK + 8)) +
                        sizeof(float) * (4 + (D == 16 ? 16 : 0)) * TC_BQB;
    auto kern = flash_bwd_kernel<T, D>;
    static const cudaError_t attr = allow_smem(kern, smem);
    if (attr != cudaSuccess) return (int)attr;
    dim3 grid((Sk + TC_BK - 1) / TC_BK, BH);
    kern<<<grid, TC_BWD_THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, lse, delta, (const T*)dout,
        dq_acc, (T*)dk, (T*)dv, rcos, rsin, Sq, Sk, scale, causal);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_d(const void* q, const void* k, const void* v, void* o, float* lse,
          const float* rc, const float* rs, int BH, int Sq, int Sk, int D,
          float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return fwd_t<T, 16>(q, k, v, o, lse, rc, rs, BH, Sq, Sk, scale, causal, s);
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
    case 16: return bwd_t<T, 16>(q, k, v, o, lse, dout, dq_acc, dk, dv, delta, rc, rs, BH, Sq, Sk, scale, causal, s);
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
