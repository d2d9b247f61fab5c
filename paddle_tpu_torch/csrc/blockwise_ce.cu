// Blockwise LM-head cross entropy for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces three TPU kernels of paddle_tpu/ops/pallas/blockwise_ce.py:
//   `_fwd_kernel` (:57, reached through `_ce_fwd` :121, pallas_call :131):
//   the LM-head product folded into an online logsumexp plus the gold
//   logit, giving loss and lse per token;
//   `_dh_kernel` (:179, through `_ce_bwd_dh` :236, pallas_call :244):
//   recompute a logits tile, dl = (softmax - onehot) * g, dh += dl w^T;
//   `_dw_kernel` (:209, through `_ce_bwd_dw` :263, pallas_call :271):
//   recompute a logits tile, dw += h^T dl.
// The [T, V] logits never exist in device memory.
//
// Layouts (row-major, contiguous):
//   h [T, H] and w [H, V] in one of float32 / bfloat16 / float16
//   labels [T] int64; rows equal to `ignore` count zero
//   loss, lse [T] f32; g [T] f32 (the upstream gradient of loss)
//   dh [T, H] in h's dtype, dw [H, V] in w's dtype
// Any T, H, V: tiles past an edge are zero-filled on load, columns past V
// are masked out of the softmax and no element past an array is read.
//
// Arithmetic follows the Pallas bodies: logits are products of the input
// dtype accumulated in f32, the softmax statistics are f32, the gold logit
// is read from the f32 logits (a label outside [0, V) has none), dl is
// f32, and dh / dw are f32 sums rounded once to the output dtype.
//
// Design. Every kernel computes 64-token x 128-vocab logits tiles,
// accumulated GEMM-style over 32-deep chunks of the hidden axis staged
// through shared memory (a [64, H] h tile does not fit on chip: 256 KB at
// H = 1024 in f32), before they are folded into the softmax. The epilogues
// see the tile as 256 threads in a 16 x 16 grid, each with 4 x 8 values.
//   bf16 / f16 inputs: the logits products run on the tensor cores
//   (mma.sync m16n8k16, f32 accumulators; 8 warps of 16 x 64 outputs,
//   fragments read with ldmatrix; two staging buffers, the next chunk's
//   16-byte loads in flight while the current one is multiplied). A
//   product of two 16-bit inputs is exact in f32, so this is the same f32
//   sum as the plain version's in another order. The accumulators go
//   through shared memory to the epilogue's layout.
//   f32 inputs: CUDA-core f32 FMAs (each thread a 4 x 8 register tile,
//   operands staged as f32), since the f32 path must stay f32.
//   The backward's second product contracts the f32 dl. For bf16 inputs it
//   runs on the tensor cores too: dl is split exactly into three bf16
//   parts (hi + mid + lo carry its 24 significant bits) and each part is
//   contracted with the bf16 operand, three products into one f32 sum.
//   f32 and f16 inputs contract dl on CUDA cores in f32.
//   Forward: one block per (64-token tile, vocab split) walks its vocab
//   tiles with the flash softmax recurrence (running max, scaled sum) and
//   picks up the gold logit; each split writes (m, l, gold) per token and a
//   small combine kernel merges the splits into lse and loss. The TPU grid
//   walks the whole vocabulary in order; the split keeps the card busy when
//   T has few tiles (T = 1000: 16 token tiles x 17 splits).
//   dh: one block per (64-token tile, vocab split) walks its vocab tiles;
//   each tile's dl [64, 128] goes to shared memory and is contracted with
//   w's columns into dh's rows in 128-wide chunks of H. The TPU keeps the
//   [block_t, H] accumulator resident; here it would be 256 KB per block
//   at H = 1024, so the block adds into its split's private f32 workspace
//   row block [64, H] in device memory (no atomics: one block owns those
//   rows), and a combine kernel sums the splits' workspaces into dh in its
//   dtype, one split or many. At the flagship
//   (T=16384, H=1024, V=32000) the read-modify-write is 64 x 1024 x 8 B =
//   512 KB per vocab tile against 33.5 MFLOP, 64 flops per byte.
//   dw: the same with the roles swapped: one block per 128-column vocab
//   tile walks the token tiles and adds h^T dl into a private [H, 128] f32
//   workspace column block in 64-row chunks of H (1 MB per token tile at
//   H = 1024, 32 flops per byte); the last token tile writes dw.
//
// What bounds it: operations. At the flagship the forward is 2 T H V =
// 1.07 TFLOP and each backward kernel 2.15 TFLOP against at most 0.2 GB of
// inputs and outputs, far above the ~295 flops per byte where the bf16
// tensor cores, not memory, are the limit. mma.sync from shared memory
// without TMA, wgmma or a pipeline of stages reaches a fraction of the 989
// TFLOP/s; the split contraction costs three tensor-core products; wgmma
// tiles fed by TMA are later work. The workspaces cost one f32 copy of dh
// (T x H) per vocab split and one of dw (H x V) in device memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;          // threads per block: 16 x 16
constexpr int BM = 64;           // logits tile rows (tokens)
constexpr int BN = 128;          // logits tile columns (vocab)
constexpr int BK = 32;           // depth of one staged chunk
constexpr int PAD = 4;           // row padding in floats (keeps float4 reads aligned)
constexpr int LDM = BM + PAD;    // stride of a [k][m] staging tile
constexpr int LDN = BN + PAD;    // stride of a [k][n] staging tile
// 16-bit tiles for the tensor cores: rows padded by 16 bytes so that the
// eight 16-byte rows of an ldmatrix read fall in distinct bank groups
constexpr int LDK16 = BK + 8;    // a row 32 deep (80 B)
constexpr int LD64 = BM + 8;     // a row 64 wide (144 B)
constexpr int LDP = BN + 8;      // a row 128 wide (272 B)
constexpr float NEG_INF = -1e30f;

// One shared region holds, one at a time: the f32 staging of a CUDA-core
// product (As, Bs), the 16-bit staging of a tensor-core product, and the
// f32 logits tile read back from the tensor-core accumulators (Ls).
constexpr int REGION = BM * LDN > BK * LDM + BK * LDN ? BM * LDN : BK * LDM + BK * LDN;
static_assert(2 * (BM * LDK16 + BK * LDP) <= 2 * REGION,
              "the double-buffered logits staging fits the region");
static_assert(BN * LD64 <= 2 * REGION && BM * LD64 <= 2 * REGION,
              "the contraction staging fits the region");

// dl of the current tile after the region: f32 for a CUDA-core
// contraction, three bf16 parts for a tensor-core one
template <typename T>
constexpr bool kTcContract = std::is_same<T, __nv_bfloat16>::value;
template <typename T> constexpr size_t dh_smem() {
  return sizeof(float) * (REGION + (kTcContract<T> ? 3 * BM * LDP / 2 : BN * LDM));
}
template <typename T> constexpr size_t dw_smem() {
  return sizeof(float) * (REGION + (kTcContract<T> ? 3 * BN * LD64 / 2 : BM * LDN));
}

// (bf16 operands go only to the tensor cores, as raw 16-bit values)
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

__device__ __forceinline__ uint16_t bits16(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint16_t bits16(__half v) { return __half_as_ushort(v); }

// d += a b on the tensor cores: a 16 x 16 (row-major fragment), b 16 x 8
// (column fragment), d 16 x 8 f32
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// four 8 x 8 16-bit matrices from shared memory (ldmatrix): lane l gives
// the address of one 16-byte row of matrix l / 8; .trans hands each lane
// the transposed pairs
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// the A fragment of rows r0 .. r0 + 16, depth k0 .. k0 + 16 of a 16-bit
// tile stored [row][k] (frag_a) or [k][row] (frag_a_t), row stride ld
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint16_t* X, int ld,
                                       int r0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm4(a, X + (r0 + (l & 15)) * ld + k0 + ((l >> 4) << 3));
}
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const uint16_t* X, int ld,
                                         int r0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm4_t(a, X + (k0 + (l & 7) + ((l >> 4) << 3)) * ld + r0 + (((l >> 3) & 1) << 3));
}

// the B fragments of columns n0 .. n0 + 16 (two 8-column pieces: b[0..1]
// and b[2..3]), depth k0 .. k0 + 16, of a 16-bit tile stored [n][k]
// (frag_b2) or [k][n] (frag_b2_t)
__device__ __forceinline__ void frag_b2(uint32_t (&b)[4], const uint16_t* X, int ld,
                                        int n0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm4(b, X + (n0 + (l & 7) + ((l >> 4) << 3)) * ld + k0 + (((l >> 3) & 1) << 3));
}
__device__ __forceinline__ void frag_b2_t(uint32_t (&b)[4], const uint16_t* X, int ld,
                                          int n0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm4_t(b, X + (k0 + (l & 15)) * ld + n0 + ((l >> 4) << 3));
}

// eight 16-bit values from global memory as one 16-byte load, or zeros
template <typename T>
__device__ __forceinline__ uint4 ld8(const T* p, bool live) {
  return live ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ void st8(uint16_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// rows of 16-bit h and w load 16 bytes at a time when every row starts on
// a 16-byte boundary; other shapes take element loads
template <typename T>
__device__ __forceinline__ bool rows16(const T* h, const T* w, int H, int V) {
  return ((H | V) & 7) == 0 &&
         ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
}

// x = hi + mid + lo exactly, each part a bf16 (8 significant bits apiece)
__device__ __forceinline__ void split3(float x, uint16_t (&part)[3]) {
  const __nv_bfloat16 hi = __float2bfloat16(x);
  const float r1 = x - __bfloat162float(hi);
  const __nv_bfloat16 mid = __float2bfloat16(r1);
  const __nv_bfloat16 lo = __float2bfloat16(r1 - __bfloat162float(mid));
  part[0] = bits16(hi);
  part[1] = bits16(mid);
  part[2] = bits16(lo);
}

// The tensor-core warp tile of a [64, 128] product: warp w owns rows
// 16 (w % 4) .. + 16 and columns 64 (w / 4) .. + 64 as eight 16 x 8 pieces;
// element e of piece j sits at row gq + 8 (e / 2), column 8 j + 2 tq + e % 2.
struct WarpTile {
  int gq, tq, r0, n0;
  __device__ WarpTile() {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    gq = lane / 4;
    tq = lane % 4;
    r0 = (warp % 4) * 16;
    n0 = (warp / 4) * 64;
  }
  __device__ int row(int e) const { return r0 + gq + 8 * (e / 2); }
  __device__ int col(int j, int e) const { return n0 + 8 * j + 2 * tq + e % 2; }
};

// The thread's tile: rows ty * 4 + i (i < 4), columns col_of(tx, j) (j < 8),
// two groups of four neighbours so that a half-warp's float4 reads of a
// staged row are contiguous.
__device__ __forceinline__ int col_of(int tx, int j) { return (j / 4) * 64 + tx * 4 + (j % 4); }

// c[i][j] += sum_k A[k][row i] * B[k][col j] over one BK-deep chunk;
// A stored [k][m] with stride LDM, B stored [k][n] with stride LDN.
__device__ __forceinline__ void mma_chunk(float (&c)[4][8], const float* A,
                                          const float* B, int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(A + kk * LDM + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(B + kk * LDN + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(B + kk * LDN + 64 + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&c)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
  }
}

// As[k][m] = h[row0 + m, k0 + k] (h's rows as the product's rows)
template <typename T>
__device__ __forceinline__ void stage_h_rows(float* As, const T* __restrict__ h,
                                             int row0, int k0, int Tn, int H) {
  for (int i = threadIdx.x; i < BM * BK; i += NT) {
    const int m = i / BK, k = i % BK, r = row0 + m, hk = k0 + k;
    As[k * LDM + m] = (r < Tn && hk < H) ? to_f(h[(size_t)r * H + hk]) : 0.f;
  }
}

// As[k][m] = h[t0 + k, hc0 + m] (h^T: hidden units as the product's rows)
template <typename T>
__device__ __forceinline__ void stage_h_cols(float* As, const T* __restrict__ h,
                                             int t0, int hc0, int Tn, int H) {
  for (int i = threadIdx.x; i < BK * BM; i += NT) {
    const int k = i / BM, m = i % BM, t = t0 + k, hc = hc0 + m;
    As[k * LDM + m] = (t < Tn && hc < H) ? to_f(h[(size_t)t * H + hc]) : 0.f;
  }
}

// Bs[k][n] = w[k0 + k, col0 + n]
template <typename T>
__device__ __forceinline__ void stage_w_rows(float* Bs, const T* __restrict__ w,
                                             int k0, int col0, int H, int V) {
  for (int i = threadIdx.x; i < BK * BN; i += NT) {
    const int k = i / BN, n = i % BN, hk = k0 + k, col = col0 + n;
    Bs[k * LDN + n] = (hk < H && col < V) ? to_f(w[(size_t)hk * V + col]) : 0.f;
  }
}

// Bs[k][n] = w[hc0 + n, c0 + k] (w^T: vocab as the contraction)
template <typename T>
__device__ __forceinline__ void stage_w_cols(float* Bs, const T* __restrict__ w,
                                             int c0, int hc0, int H, int V) {
  for (int i = threadIdx.x; i < BN * BK; i += NT) {
    const int n = i / BK, k = i % BK, hc = hc0 + n, col = c0 + k;
    Bs[k * LDN + n] = (hc < H && col < V) ? to_f(w[(size_t)hc * V + col]) : 0.f;
  }
}

// acc += Hb Wb over one BK-deep chunk on the tensor cores; Hb [BM][LDK16],
// Wb [BK][LDP]
template <typename T>
__device__ __forceinline__ void tc_chunk(float (&acc)[8][4], const uint16_t* Hb,
                                         const uint16_t* Wb, const WarpTile& wt) {
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t a[4];
    frag_a(a, Hb, LDK16, wt.r0, ks);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4];
      frag_b2_t(b, Wb, LDP, wt.n0 + 16 * jj, ks);
      mma16816<T>(acc[2 * jj], a, b[0], b[1]);
      mma16816<T>(acc[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// c = h[row0 : row0 + 64] @ w[:, col0 : col0 + 128] in f32 on the tensor
// cores (16-bit T), delivered in the epilogue's 16 x 16-thread layout. Two
// staging buffers: the next chunk's 16-byte loads are in flight while the
// tensor cores take the current one.
template <typename T>
__device__ __forceinline__ void logits_tile_tc(float (&c)[4][8], const T* __restrict__ h,
                                               const T* __restrict__ w, int row0,
                                               int col0, int Tn, int H, int V,
                                               float* region, int ty, int tx) {
  uint16_t* Hs = reinterpret_cast<uint16_t*>(region);   // [2][BM][LDK16]
  uint16_t* Ws = Hs + 2 * BM * LDK16;                   // [2][BK][LDP]
  const WarpTile wt;
  float acc[8][4] = {};
  const int nk = (H + BK - 1) / BK;
  __syncthreads();                         // the region's last readers are done
  if (rows16(h, w, H, V)) {
    // thread i: h row i / 4, depth 8 (i % 4) ..; w rows i / 16 and
    // i / 16 + 16, columns 8 (i % 16) ..
    const int hm = threadIdx.x / 4, hk = (threadIdx.x % 4) * 8;
    const int wk = threadIdx.x / 16, wn = (threadIdx.x % 16) * 8;
    uint4 rh, rw0, rw1;
    auto load = [&](int k0) {
      rh = ld8(h + (size_t)(row0 + hm) * H + k0 + hk, row0 + hm < Tn && k0 + hk < H);
      rw0 = ld8(w + (size_t)(k0 + wk) * V + col0 + wn, k0 + wk < H && col0 + wn < V);
      rw1 = ld8(w + (size_t)(k0 + wk + 16) * V + col0 + wn,
                k0 + wk + 16 < H && col0 + wn < V);
    };
    auto store = [&](int buf) {
      st8(Hs + buf * BM * LDK16 + hm * LDK16 + hk, rh);
      st8(Ws + buf * BK * LDP + wk * LDP + wn, rw0);
      st8(Ws + buf * BK * LDP + (wk + 16) * LDP + wn, rw1);
    };
    load(0);
    store(0);
    __syncthreads();
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk) load((kc + 1) * BK);
      tc_chunk<T>(acc, Hs + (kc & 1) * BM * LDK16, Ws + (kc & 1) * BK * LDP, wt);
      if (kc + 1 < nk) store((kc + 1) & 1);
      __syncthreads();
    }
  } else {
    for (int k0 = 0; k0 < H; k0 += BK) {
      for (int i = threadIdx.x; i < BM * BK; i += NT) {
        const int m = i / BK, k = i % BK, r = row0 + m, hk = k0 + k;
        Hs[m * LDK16 + k] = (r < Tn && hk < H) ? bits16(h[(size_t)r * H + hk]) : (uint16_t)0;
      }
      for (int i = threadIdx.x; i < BK * BN; i += NT) {
        const int k = i / BN, n = i % BN, hk = k0 + k, col = col0 + n;
        Ws[k * LDP + n] = (hk < H && col < V) ? bits16(w[(size_t)hk * V + col]) : (uint16_t)0;
      }
      __syncthreads();
      tc_chunk<T>(acc, Hs, Ws, wt);
      __syncthreads();                     // the staging tiles are consumed
    }
  }
  float* Ls = region;                      // [BM][LDN]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(Ls + wt.row(0) * LDN + wt.col(j, 0)) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(Ls + wt.row(2) * LDN + wt.col(j, 0)) =
        make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* p = Ls + (ty * 4 + i) * LDN;
    const float4 x0 = *reinterpret_cast<const float4*>(p + tx * 4);
    const float4 x1 = *reinterpret_cast<const float4*>(p + 64 + tx * 4);
    c[i][0] = x0.x; c[i][1] = x0.y; c[i][2] = x0.z; c[i][3] = x0.w;
    c[i][4] = x1.x; c[i][5] = x1.y; c[i][6] = x1.z; c[i][7] = x1.w;
  }
}

// c = h[row0 : row0 + 64] @ w[:, col0 : col0 + 128] in f32; `region` is the
// kernel's shared staging region (REGION floats)
template <typename T>
__device__ __forceinline__ void logits_tile(float (&c)[4][8], const T* __restrict__ h,
                                            const T* __restrict__ w, int row0,
                                            int col0, int Tn, int H, int V,
                                            float* region, int ty, int tx) {
  if constexpr (std::is_same<T, float>::value) {
    float* As = region;
    float* Bs = region + BK * LDM;
    zero(c);
    for (int k0 = 0; k0 < H; k0 += BK) {
      __syncthreads();                     // the staging tiles are consumed
      stage_h_rows<T>(As, h, row0, k0, Tn, H);
      stage_w_rows<T>(Bs, w, k0, col0, H, V);
      __syncthreads();
      mma_chunk(c, As, Bs, ty, tx);
    }
  } else {
    logits_tile_tc<T>(c, h, w, row0, col0, Tn, H, V, region, ty, tx);
  }
}

// reductions over the 16 threads that share a row (one half-warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dl = (exp(c - lse) - onehot(label)) * scale for the thread's tile, zero
// in the columns past V (scale is 0 on ignored rows and rows past T)
__device__ __forceinline__ void dlogits(float (&c)[4][8], const long long (&lab)[4],
                                        const float (&lse_r)[4], const float (&sc)[4],
                                        int col0, int V, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + col_of(tx, j);
      const bool live = col < V;
      const float p = live ? expf(c[i][j] - lse_r[i]) : 0.f;
      const float hit = (live && col == lab[i]) ? 1.f : 0.f;
      c[i][j] = (p - hit) * sc[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
blockwise_ce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                        const long long* __restrict__ labels,
                        float* __restrict__ part, int Tn, int H, int V,
                        int nsplit, int tiles_per_split) {
  extern __shared__ float4 smem4[];
  float* region = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int nv = (V + BN - 1) / BN;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(nv, vt0 + tiles_per_split);

  long long lab[4];
  float m[4], l[4], gold[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    lab[i] = r < Tn ? labels[r] : -1;
    m[i] = NEG_INF;
    l[i] = 0.f;
    gold[i] = 0.f;
  }
  float c[4][8];
  for (int vt = vt0; vt < vt1; ++vt) {
    const int col0 = vt * BN;
    logits_tile<T>(c, h, w, row0, col0, Tn, H, V, region, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + col_of(tx, j);
        if (col < V) {
          if (col == lab[i]) gold[i] += c[i][j];
        } else {
          c[i][j] = NEG_INF;
        }
        mx = fmaxf(mx, c[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (col0 + col_of(tx, j) < V) s += expf(c[i][j] - m_new);
      }
      l[i] = expf(m[i] - m_new) * l[i] + row_sum(s);
      m[i] = m_new;
    }
  }
  float* pm = part;
  float* pl = part + (size_t)nsplit * Tn;
  float* pg = part + 2 * (size_t)nsplit * Tn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float gsum = row_sum(gold[i]);
    const int r = row0 + ty * 4 + i;
    if (tx == 0 && r < Tn) {
      pm[(size_t)split * Tn + r] = m[i];
      pl[(size_t)split * Tn + r] = l[i];
      pg[(size_t)split * Tn + r] = gsum;
    }
  }
}

// merge the vocab splits' (m, l, gold) into lse and loss, one thread per token
__global__ void __launch_bounds__(NT)
blockwise_ce_combine_kernel(const float* __restrict__ part,
                            const long long* __restrict__ labels,
                            float* __restrict__ loss, float* __restrict__ lse,
                            int Tn, int nsplit, int nused, long long ignore) {
  const int t = blockIdx.x * NT + threadIdx.x;
  if (t >= Tn) return;
  const float* pm = part;
  const float* pl = part + (size_t)nsplit * Tn;
  const float* pg = part + 2 * (size_t)nsplit * Tn;
  float mx = NEG_INF;
  for (int s = 0; s < nused; ++s) mx = fmaxf(mx, pm[(size_t)s * Tn + t]);
  float l = 0.f, g = 0.f;
  for (int s = 0; s < nused; ++s) {
    l += pl[(size_t)s * Tn + t] * expf(pm[(size_t)s * Tn + t] - mx);
    g += pg[(size_t)s * Tn + t];
  }
  const float out = mx + logf(l == 0.f ? 1.f : l);
  lse[t] = out;
  loss[t] = labels[t] == ignore ? 0.f : out - g;
}

// the per-row (label, lse, gradient scale) of the thread's four rows
__device__ __forceinline__ void row_state(long long (&lab)[4], float (&lse_r)[4],
                                          float (&sc)[4], const long long* __restrict__ labels,
                                          const float* __restrict__ g,
                                          const float* __restrict__ lse, int row0,
                                          int Tn, long long ignore, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    const bool live = r < Tn;
    lab[i] = live ? labels[r] : -1;
    lse_r[i] = live ? lse[r] : 0.f;
    sc[i] = (live && lab[i] != ignore) ? g[r] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
blockwise_ce_dh_kernel(const T* __restrict__ h, const T* __restrict__ w,
                       const long long* __restrict__ labels,
                       const float* __restrict__ g, const float* __restrict__ lse,
                       float* __restrict__ ws, int Tn, int H, int V,
                       long long ignore, int tiles_per_split) {
  extern __shared__ float4 smem4[];
  float* region = reinterpret_cast<float*>(smem4);
  float* dlbuf = region + REGION;                // dl of the current vocab tile
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.x * BM;
  const int nv = (V + BN - 1) / BN;
  const int vt0 = blockIdx.y * tiles_per_split;
  const int vt1 = min(nv, vt0 + tiles_per_split);
  ws += (size_t)blockIdx.y * Tn * H;             // this split's workspace
  long long lab[4];
  float lse_r[4], sc[4];
  row_state(lab, lse_r, sc, labels, g, lse, row0, Tn, ignore, ty);

  float c[4][8];
  for (int vt = vt0; vt < vt1; ++vt) {
    const int col0 = vt * BN;
    const bool first = vt == vt0;
    logits_tile<T>(c, h, w, row0, col0, Tn, H, V, region, ty, tx);
    dlogits(c, lab, lse_r, sc, col0, V, tx);
    // dh[rows, hc0 : hc0 + 128] += dl @ w[hc0 : hc0 + 128, col0 : col0 + 128]^T
    if constexpr (kTcContract<T>) {
      uint16_t* Dp = reinterpret_cast<uint16_t*>(dlbuf);   // [3][BM][LDP]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint16_t part[3];
          split3(c[i][j], part);
#pragma unroll
          for (int q = 0; q < 3; ++q)
            Dp[q * BM * LDP + (ty * 4 + i) * LDP + col_of(tx, j)] = part[q];
        }
      }
      uint16_t* Ws = reinterpret_cast<uint16_t*>(region);  // [BN (h)][LD64]
      const WarpTile wt;
      const bool vec = rows16(h, w, H, V);
      for (int hc0 = 0; hc0 < H; hc0 += BN) {
        float acc[8][4] = {};
        for (int kc = 0; kc < BN; kc += BM) {              // 64 vocab columns
          __syncthreads();                 // Dp written / Ws consumed
          if (vec) {                       // 128 rows x 8 loads of 16 bytes
            for (int i = threadIdx.x; i < BN * 8; i += NT) {
              const int n = i / 8, k = (i % 8) * 8, hc = hc0 + n, col = col0 + kc + k;
              st8(Ws + n * LD64 + k, ld8(w + (size_t)hc * V + col, hc < H && col < V));
            }
          } else {
            for (int i = threadIdx.x; i < BN * BM; i += NT) {
              const int n = i / BM, k = i % BM, hc = hc0 + n, col = col0 + kc + k;
              Ws[n * LD64 + k] = (hc < H && col < V) ? bits16(w[(size_t)hc * V + col])
                                                     : (uint16_t)0;
            }
          }
          __syncthreads();
#pragma unroll
          for (int ks = 0; ks < BM; ks += 16) {
            uint32_t a[3][4];
#pragma unroll
            for (int q = 0; q < 3; ++q) frag_a(a[q], Dp + q * BM * LDP, LDP, wt.r0, kc + ks);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              uint32_t b[4];
              frag_b2(b, Ws, LD64, wt.n0 + 16 * jj, ks);
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                mma16816<T>(acc[2 * jj], a[q], b[0], b[1]);
                mma16816<T>(acc[2 * jj + 1], a[q], b[2], b[3]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = row0 + wt.row(e), hc = hc0 + wt.col(j, e);
            if (r >= Tn || hc >= H) continue;
            const size_t idx = (size_t)r * H + hc;
            ws[idx] = first ? acc[j][e] : ws[idx] + acc[j][e];
          }
        }
      }
    } else {
      float* Bs = region + BK * LDM;       // [BK][LDN]: w^T staging
      float* DlT = dlbuf;                  // [BN][LDM]: dl, vocab-major
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) DlT[col_of(tx, j) * LDM + ty * 4 + i] = c[i][j];
      }
      for (int hc0 = 0; hc0 < H; hc0 += BN) {
        float acc[4][8];
        zero(acc);
        for (int kc = 0; kc < BN; kc += BK) {
          __syncthreads();                 // DlT written / Bs consumed
          stage_w_cols<T>(Bs, w, col0 + kc, hc0, H, V);
          __syncthreads();
          mma_chunk(acc, DlT + kc * LDM, Bs, ty, tx);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = row0 + ty * 4 + i;
          if (r >= Tn) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int hc = hc0 + col_of(tx, j);
            if (hc >= H) continue;
            const size_t idx = (size_t)r * H + hc;
            ws[idx] = first ? acc[i][j] : ws[idx] + acc[i][j];
          }
        }
      }
    }
  }
}

// dh = the sum of the vocab splits' f32 workspaces, rounded to T once
template <typename T>
__global__ void __launch_bounds__(NT)
blockwise_ce_dh_combine_kernel(const float* __restrict__ ws, T* __restrict__ dh,
                               size_t n, int nsplit) {
  const size_t i = (size_t)blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int s = 0; s < nsplit; ++s) v += ws[(size_t)s * n + i];
  dh[i] = from_f<T>(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
blockwise_ce_dw_kernel(const T* __restrict__ h, const T* __restrict__ w,
                       const long long* __restrict__ labels,
                       const float* __restrict__ g, const float* __restrict__ lse,
                       float* __restrict__ ws, T* __restrict__ dw, int Tn, int H,
                       int V, long long ignore) {
  extern __shared__ float4 smem4[];
  float* region = reinterpret_cast<float*>(smem4);
  float* dlbuf = region + REGION;                // dl of the current token tile
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int col0 = blockIdx.x * BN;
  const int nt = (Tn + BM - 1) / BM;

  float c[4][8];
  for (int tt = 0; tt < nt; ++tt) {
    const int row0 = tt * BM;
    long long lab[4];
    float lse_r[4], sc[4];
    row_state(lab, lse_r, sc, labels, g, lse, row0, Tn, ignore, ty);
    logits_tile<T>(c, h, w, row0, col0, Tn, H, V, region, ty, tx);
    dlogits(c, lab, lse_r, sc, col0, V, tx);
    const bool first = tt == 0, last = tt == nt - 1;
    // dw[hc0 : hc0 + 64, cols] += h[rows, hc0 : hc0 + 64]^T @ dl
    if constexpr (kTcContract<T>) {
      uint16_t* DpT = reinterpret_cast<uint16_t*>(dlbuf);  // [3][BN][LD64]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint16_t part[3];
          split3(c[i][j], part);
#pragma unroll
          for (int q = 0; q < 3; ++q)
            DpT[q * BN * LD64 + col_of(tx, j) * LD64 + ty * 4 + i] = part[q];
        }
      }
      uint16_t* Hs = reinterpret_cast<uint16_t*>(region);  // [BM (t)][LD64 (h)]
      const WarpTile wt;
      const bool vec = rows16(h, w, H, V);
      for (int hc0 = 0; hc0 < H; hc0 += BM) {
        float acc[8][4] = {};
        __syncthreads();                   // DpT written / Hs consumed
        if (vec) {                         // 64 rows x 8 loads of 16 bytes
          for (int i = threadIdx.x; i < BM * 8; i += NT) {
            const int k = i / 8, m = (i % 8) * 8, t = row0 + k, hc = hc0 + m;
            st8(Hs + k * LD64 + m, ld8(h + (size_t)t * H + hc, t < Tn && hc < H));
          }
        } else {
          for (int i = threadIdx.x; i < BM * BM; i += NT) {
            const int k = i / BM, m = i % BM, t = row0 + k, hc = hc0 + m;
            Hs[k * LD64 + m] = (t < Tn && hc < H) ? bits16(h[(size_t)t * H + hc])
                                                  : (uint16_t)0;
          }
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < BM; ks += 16) {
          uint32_t a[4];
          frag_a_t(a, Hs, LD64, wt.r0, ks);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              uint32_t b[4];
              frag_b2(b, DpT + q * BN * LD64, LD64, wt.n0 + 16 * jj, ks);
              mma16816<T>(acc[2 * jj], a, b[0], b[1]);
              mma16816<T>(acc[2 * jj + 1], a, b[2], b[3]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = hc0 + wt.row(e), col = col0 + wt.col(j, e);
            if (hr >= H || col >= V) continue;
            const size_t idx = (size_t)hr * V + col;
            const float v = first ? acc[j][e] : ws[idx] + acc[j][e];
            if (last) dw[idx] = from_f<T>(v);
            else ws[idx] = v;
          }
        }
      }
    } else {
      float* As = region;                  // [BK][LDM]: h^T staging
      float* Dl = dlbuf;                   // [BM][LDN]: dl, token-major
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) Dl[(ty * 4 + i) * LDN + col_of(tx, j)] = c[i][j];
      }
      for (int hc0 = 0; hc0 < H; hc0 += BM) {
        float acc[4][8];
        zero(acc);
        for (int kc = 0; kc < BM; kc += BK) {
          __syncthreads();                 // Dl written / As consumed
          stage_h_cols<T>(As, h, row0 + kc, hc0, Tn, H);
          __syncthreads();
          mma_chunk(acc, As, Dl + kc * LDN, ty, tx);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hr = hc0 + ty * 4 + i;
          if (hr >= H) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = col0 + col_of(tx, j);
            if (col >= V) continue;
            const size_t idx = (size_t)hr * V + col;
            const float v = first ? acc[i][j] : ws[idx] + acc[i][j];
            if (last) dw[idx] = from_f<T>(v);
            else ws[idx] = v;
          }
        }
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

constexpr size_t FWD_SMEM = sizeof(float) * REGION;

template <typename T>
int fwd_t(const void* h, const void* w, const long long* labels, float* loss,
          float* lse, float* part, int Tn, int H, int V, int nsplit,
          long long ignore, cudaStream_t stream) {
  const int nv = (V + BN - 1) / BN;
  const int tps = (nv + nsplit - 1) / nsplit;
  const int nused = (nv + tps - 1) / tps;  // splits that own a vocab tile
  dim3 grid((Tn + BM - 1) / BM, nused);
  blockwise_ce_fwd_kernel<T><<<grid, NT, FWD_SMEM, stream>>>(
      (const T*)h, (const T*)w, labels, part, Tn, H, V, nsplit, tps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  blockwise_ce_combine_kernel<<<(Tn + NT - 1) / NT, NT, 0, stream>>>(
      part, labels, loss, lse, Tn, nsplit, nused, ignore);
  return (int)cudaGetLastError();
}

template <typename T>
int dh_t(const void* h, const void* w, const long long* labels, const float* g,
         const float* lse, float* ws, void* dh, int Tn, int H, int V,
         int nsplit, long long ignore, cudaStream_t stream) {
  auto kern = blockwise_ce_dh_kernel<T>;
  static const cudaError_t attr = allow_smem(kern, dh_smem<T>());
  if (attr != cudaSuccess) return (int)attr;
  const int nv = (V + BN - 1) / BN;
  const int tps = (nv + nsplit - 1) / nsplit;
  const int nused = (nv + tps - 1) / tps;  // splits that own a vocab tile
  dim3 grid((Tn + BM - 1) / BM, nused);
  kern<<<grid, NT, dh_smem<T>(), stream>>>(
      (const T*)h, (const T*)w, labels, g, lse, ws, Tn, H, V, ignore, tps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)Tn * H;
  blockwise_ce_dh_combine_kernel<T><<<(unsigned)((n + NT - 1) / NT), NT, 0,
                                      stream>>>(ws, (T*)dh, n, nused);
  return (int)cudaGetLastError();
}

template <typename T>
int dw_t(const void* h, const void* w, const long long* labels, const float* g,
         const float* lse, float* ws, void* dw, int Tn, int H, int V,
         long long ignore, cudaStream_t stream) {
  auto kern = blockwise_ce_dw_kernel<T>;
  static const cudaError_t attr = allow_smem(kern, dw_smem<T>());
  if (attr != cudaSuccess) return (int)attr;
  kern<<<(V + BN - 1) / BN, NT, dw_smem<T>(), stream>>>(
      (const T*)h, (const T*)w, labels, g, lse, ws, (T*)dw, Tn, H, V, ignore);
  return (int)cudaGetLastError();
}

bool bad_shape(int Tn, int H, int V) { return Tn < 0 || H <= 0 || V <= 0; }

}  // namespace

extern "C" {

// The vocab splits of the forward and of dh for T tokens over V columns on
// a card with `sms` multiprocessors: enough blocks for two per SM when the
// token tiles alone are too few (small T), at most one split per vocab
// tile. The caller sizes the scratch of both launches by it.
int blockwise_ce_splits(int Tn, int V, int sms) {
  if (Tn <= 0 || V <= 0 || sms <= 0) return 1;
  const int tiles_t = (Tn + BM - 1) / BM, tiles_v = (V + BN - 1) / BN;
  const int want = (2 * sms + tiles_t - 1) / tiles_t;
  return want < 1 ? 1 : (want < tiles_v ? want : tiles_v);
}

// dtype: 0 float32, 1 bfloat16, 2 float16. Writes loss and lse; part is
// [3, nsplit, T] f32 scratch (running max, scaled sum and gold logit of
// each vocab split). Two launches (the split kernel, then the combine).
// Returns the CUDA error code of the launches (0 on success).
int blockwise_ce_fwd_launch(int dtype, const void* h, const void* w,
                            const long long* labels, float* loss, float* lse,
                            float* part, int Tn, int H, int V, int nsplit,
                            long long ignore, void* stream) {
  if (bad_shape(Tn, H, V) || nsplit < 1) return (int)cudaErrorInvalidValue;
  if (Tn == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return fwd_t<float>(h, w, labels, loss, lse, part, Tn, H, V, nsplit, ignore, s);
    case 1: return fwd_t<__nv_bfloat16>(h, w, labels, loss, lse, part, Tn, H, V, nsplit, ignore, s);
    case 2: return fwd_t<__half>(h, w, labels, loss, lse, part, Tn, H, V, nsplit, ignore, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Writes dh [T, H] in h's dtype; ws is [nsplit, T, H] f32 scratch, one
// [T, H] workspace per vocab split. Two launches (the split kernel, then
// the combine that sums the workspaces into dh).
int blockwise_ce_dh_launch(int dtype, const void* h, const void* w,
                           const long long* labels, const float* g,
                           const float* lse, float* ws, void* dh, int Tn, int H,
                           int V, int nsplit, long long ignore, void* stream) {
  if (bad_shape(Tn, H, V) || nsplit < 1) return (int)cudaErrorInvalidValue;
  if (Tn == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return dh_t<float>(h, w, labels, g, lse, ws, dh, Tn, H, V, nsplit, ignore, s);
    case 1: return dh_t<__nv_bfloat16>(h, w, labels, g, lse, ws, dh, Tn, H, V, nsplit, ignore, s);
    case 2: return dh_t<__half>(h, w, labels, g, lse, ws, dh, Tn, H, V, nsplit, ignore, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Writes dw [H, V] in w's dtype; ws is [H, V] f32 scratch.
int blockwise_ce_dw_launch(int dtype, const void* h, const void* w,
                           const long long* labels, const float* g,
                           const float* lse, float* ws, void* dw, int Tn, int H,
                           int V, long long ignore, void* stream) {
  if (bad_shape(Tn, H, V)) return (int)cudaErrorInvalidValue;
  if (Tn == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return dw_t<float>(h, w, labels, g, lse, ws, dw, Tn, H, V, ignore, s);
    case 1: return dw_t<__nv_bfloat16>(h, w, labels, g, lse, ws, dw, Tn, H, V, ignore, s);
    case 2: return dw_t<__half>(h, w, labels, g, lse, ws, dw, Tn, H, V, ignore, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
