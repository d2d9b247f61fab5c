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
// Design. Every kernel computes logits tiles on the way to its output and
// never stores them.
//
// Forward, bf16 / fp16 (`blockwise_ce_fwd_wgmma_kernel`): a GEMM whose
// epilogue is a row reduction, on Hopper's warpgroup products. It is bound
// by operations (2 T H V = 1.07 TFLOP at the flagship against 0.1 GB of
// inputs); the mma.sync body it replaced ran at 147 TFLOP/s, held by small
// tiles, loads staged through registers with one block barrier a 32-deep
// chunk, and an epilogue through shared memory. Here one block of three
// warpgroups takes a (128-token tile, vocab split) item: a producer thread
// keeps TMA loads of h [128, 64] and w [64, 256] in flight through a
// 4-stage ring (48 KB a stage, full / empty mbarriers, no block barrier in
// the loop); two consumer warpgroups each issue wgmma m64n128k16 for 64
// rows (w MN-major through the transpose bit, both operands under the
// 128-byte swizzle); the epilogue reads the accumulators in registers,
// each thread keeping its own running max and sum in log2 units
// (ex2.approx) and the gold logit, merged over its quad once at the end,
// while the producer already loads the next vocab tile. Each split writes
// (m, l, gold) per token and a small combine kernel merges the splits into
// lse and loss. The split count comes from the shapes
// (`blockwise_ce_fwd_plan`): the (token tile, split) items fill whole
// waves of the SMs (T = 16384: 128 items, one split; T = 1000: 8 token
// tiles x 16 splits). TMA reads rows that start on 16 bytes only: where H
// or V is not a multiple of 8 (V = 32001, GPT-2's 50257) the launch first
// copies h and / or w with rows padded to the next 8 elements
// (cudaMemcpy2DAsync into the scratch; the pad is never read, since the
// map's extent is the real one and TMA zero-fills past it).
//
// Forward, f32: one block per (64-token tile, vocab split) walks its vocab
// tiles with the same recurrence, the logits GEMM-style over 32-deep
// chunks of the hidden axis staged through shared memory with CUDA-core
// FMAs, since the f32 path must stay f32. In both, a product of two inputs
// is exact in f32, so the sum is the plain version's in another order.
//
// bf16 backward, dh and dw (one body, `blockwise_ce_bwd_cluster_kernel`):
// thread-block clusters keep each gradient tile on chip. A cluster of C
// blocks, C = min(8, the power of two >= ceil(H / 128)), splits the hidden
// axis: block r owns the 128-wide panels [r P, (r + 1) P), P = ceil(ceil(H
// / 128) / C), zero-filled past H. One step covers a (64-token tile,
// 128-vocab tile) pair:
//   1. each block multiplies its slice on the tensor cores into partial
//      logits h[rows, slice] @ w[slice, cols], [64, 128] f32, and stores
//      each row into the shared memory of the block that reduces it over
//      distributed shared memory (DSMEM): block r owns 64 / C rows;
//   2. cluster barrier; block r sums the C partials of its rows in rank
//      order 0 .. C-1, the same order in every block, so the cluster holds
//      one logits tile; it computes dl = (softmax - onehot) g for those
//      rows by the forward's rules (labels, ignore, lse, columns past V
//      masked), splits it into three bf16 parts, hi + mid + lo carrying
//      dl's 24 significant bits exactly (`split3`), and stores them into
//      every block's shared memory;
//   3. cluster barrier; every block now holds all 64 rows of dl locally
//      (ldmatrix reads only local shared memory) and contracts the three
//      parts with its panel on the tensor cores into one f32 sum:
//        dh: a cluster per 64-token tile walks every vocab tile. The h panel
//            [64, 128] stays resident; w's panel [128, 128] of each vocab
//            tile streams in (cp.async, two buffers, the next tile's in
//            flight) and feeds both the logits and dh[64, 128] += dl
//            w_panel^T (32 registers a thread).
//        dw: a cluster per 128-vocab tile walks every token tile. The w
//            panel stays resident; h's panel [64, 128] of each token tile
//            streams in and feeds both the logits and dw[128, 128] +=
//            h_panel^T dl (64 registers a thread).
//      Each step's contraction sums into zeroed registers, then into the
//      accumulator in f32 (the tensor cores' own accumulation would carry
//      thousands of steps at the running sum's exponent).
// Data moves by remote stores only, and each barrier is split into its
// arrive and its wait with work between them (the kernel's step comment
// gives the order). Rows of 16-bit values that do not start on 16 bytes
// (an odd V, H % 8 != 0) are loaded as the aligned 16-byte words around
// them and shifted into place in registers. At the end each block rounds
// its accumulator to bf16 once and writes its panel, then waits at a last
// cluster barrier: a block must not exit while a peer may still touch its
// shared memory. No f32 workspace, no combine launch. For H > 1024 (P > 1)
// the accumulator stays one panel wide: G = P clusters share each tile,
// group g accumulating panel r P + g, and each recomputes the logits over
// its whole slice panel by panel (no pipeline): G times the logits work,
// on the same body, for every H up to 8192 (Llama-70B's width). Above
// that, bf16 takes the workspace bodies below; the route is chosen from H
// before launch and `blockwise_ce_bwd_plan` reports it with the tile plan.
//
// f32 and f16 backward (and bf16 above H = 8192): dh: one block per
// (64-token tile, vocab split) walks its vocab tiles; each tile's dl
// [64, 128] goes to shared memory and is contracted with w's columns into
// the split's private f32 workspace rows [64, H] in device memory (no
// atomics: one block owns those rows; 512 KB read-modify-write per vocab
// tile at H = 1024), and a combine kernel sums the splits' workspaces into
// dh. dw: one block per 128-column vocab tile walks the token tiles and
// adds h^T dl into a private [H, 128] f32 workspace column block (1 MB per
// token tile); the last token tile writes dw. f32 and f16 contract dl on
// CUDA cores in f32; bf16 here splits dl into three parts for the tensor
// cores as above.
//
// What bounds it: operations. At the flagship (T=16384, H=1024, V=32000)
// the forward is 2 T H V = 1.07 TFLOP and each backward kernel needs 4 T H
// V = 2.15 TFLOP (the logits and one contraction) against at most 0.2 GB
// of inputs and outputs, far above the ~295 flops per byte where the bf16
// tensor cores, not memory, are the limit. The backward executes 8 T H V:
// the exact split costs three contraction products. Its mma.sync without
// TMA, wgmma or warp specialisation reaches a fraction of the 989 TFLOP/s;
// a cluster step also sends 28 KB of f32 partials and 42 KB of dl parts
// per block over DSMEM and passes two cluster barriers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cooperative_groups.h>
#include <cuda.h>        // CUtensorMap and its enums; the encoder is looked up at run time
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

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

// ---- bf16 backward on thread-block clusters (design note at the top) ----

constexpr int CL_MAX = 8;          // blocks per cluster: the portable maximum
constexpr int PANEL = 128;         // hidden units in one panel
constexpr int CL_MAX_H = 8192;     // the widest H the cluster plan holds
constexpr int LDT = PANEL + 8;     // stride of a 16-bit tile row 128 wide (272 B)
constexpr int LDF = BN + 4;        // stride of an f32 logits row (528 B)
static_assert(BN == PANEL, "a panel is as wide as a vocab tile");

// rows of the resident and of the streamed operand: dh keeps h [64 t][128 k]
// and streams w [128 k][128 v]; dw keeps w and streams h
template <bool DW> __host__ __device__ constexpr int res_rows() { return DW ? PANEL : BM; }
template <bool DW> __host__ __device__ constexpr int str_rows() { return DW ? BM : PANEL; }
// the partials received [C][64 / C][LDF] f32, two steps' row state
// (labels, lse, g of 64 rows), the resident panel, two streamed panels and
// the three bf16 parts of dl [3][BM][LDT]
template <bool DW> constexpr size_t cluster_smem() {
  return sizeof(float) * BM * LDF + 2 * BM * (sizeof(long long) + 2 * sizeof(float)) +
         sizeof(uint16_t) * (res_rows<DW>() + 2 * str_rows<DW>() + 3 * BM) * LDT;
}
static_assert(cluster_smem<false>() <= 232448 && cluster_smem<true>() <= 232448,
              "one block fits the 227 KB of shared memory");

struct BwdPlan {
  int C, npanel, ngroup;           // blocks per cluster, panels per block, clusters per tile
};
BwdPlan bwd_plan(int H) {
  const int np = (H + PANEL - 1) / PANEL;
  int C = 1;
  while (C < np && C < CL_MAX) C *= 2;
  const int npanel = (np + C - 1) / C;
  return {C, npanel, npanel};
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(live ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_small(void* dst, const void* src, int bytes, bool live) {
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src),
                    "r"(live ? 8 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src),
                    "r"(live ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// the two halves of cluster.sync(): arrive releases this thread's writes
// (to its own and to peers' shared memory), wait acquires every block's
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// dst[r * LDT + c] = src[(r0 + r) * ld + c0 + c] for ROWS rows and 128
// columns of an array of `total` elements, zero at or past (rlim, clim).
// Rows that start on 16 bytes (vec: ld % 8 == 0, aligned base) take
// 16-byte cp.async copies. Other rows (an odd V) take, for each 8-element
// chunk, the two aligned 16-byte words that cover it, loaded together for
// four chunks at a time and funnel-shifted into place in registers; a
// chunk whose cover would reach outside the array takes element loads.
// (The shifted path is a call of its own: inlined, its registers would
// spill the kernel's accumulators on the aligned path too.)
template <int ROWS>
__device__ __noinline__ void load_panel_shifted(uint16_t* dst, const uint16_t* __restrict__ src,
                                                size_t total, int ld, int r0, int c0,
                                                int rlim, int clim) {
  constexpr int IT = ROWS * (PANEL / 8) / NT;    // chunks per thread
  constexpr int B = 4;
  const uintptr_t beg = reinterpret_cast<uintptr_t>(src), end = beg + 2 * total;
#pragma unroll
  for (int b0 = 0; b0 < IT; b0 += B) {
    uint4 lo[B], hi[B];
    bool cover[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int i = threadIdx.x + (b0 + u) * NT;
      const int gr = r0 + i / (PANEL / 8), gc = c0 + (i % (PANEL / 8)) * 8;
      const uintptr_t a = (beg + 2 * ((size_t)gr * ld + gc)) & ~(uintptr_t)15;
      cover[u] = gr < rlim && gc < clim && a >= beg && a + 32 <= end;
      lo[u] = cover[u] ? *reinterpret_cast<const uint4*>(a) : make_uint4(0u, 0u, 0u, 0u);
      hi[u] = cover[u] ? *reinterpret_cast<const uint4*>(a + 16) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int i = threadIdx.x + (b0 + u) * NT;
      const int r = i / (PANEL / 8), c = (i % (PANEL / 8)) * 8, gr = r0 + r, gc = c0 + c;
      const size_t idx = (size_t)gr * ld + gc;
      uint32_t o[4];
      if (cover[u]) {
        // the chunk's first element within its cover
        const int sh = (int)(((beg + 2 * idx) & 15) >> 1);
        uint32_t x[8] = {lo[u].x, lo[u].y, lo[u].z, lo[u].w, hi[u].x, hi[u].y, hi[u].z, hi[u].w};
        if (sh & 4) {
#pragma unroll
          for (int j = 0; j < 6; ++j) x[j] = x[j + 2];
        }
        if (sh & 2) {
#pragma unroll
          for (int j = 0; j < 7; ++j) x[j] = x[j + 1];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = __funnelshift_r(x[k], x[k + 1], 16 * (sh & 1));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool l0 = gr < rlim && gc + 2 * k < clim, l1 = gr < rlim && gc + 2 * k + 1 < clim;
          o[k] = (l0 ? (uint32_t)src[idx + 2 * k] : 0u) |
                 ((l1 ? (uint32_t)src[idx + 2 * k + 1] : 0u) << 16);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {                // columns past clim are zero
        if (gc + 2 * k >= clim) o[k] &= 0xffff0000u;
        if (gc + 2 * k + 1 >= clim) o[k] &= 0x0000ffffu;
      }
      st8(dst + r * LDT + c, make_uint4(o[0], o[1], o[2], o[3]));
    }
  }
}

template <int ROWS>
__device__ __forceinline__ void load_panel(uint16_t* dst, const uint16_t* __restrict__ src,
                                           size_t total, int ld, int r0, int c0, int rlim,
                                           int clim, bool vec) {
  if (!vec) {
    load_panel_shifted<ROWS>(dst, src, total, ld, r0, c0, rlim, clim);
    return;
  }
#pragma unroll
  for (int it = 0; it < ROWS * (PANEL / 8) / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / (PANEL / 8), c = (i % (PANEL / 8)) * 8, gr = r0 + r, gc = c0 + c;
    const bool live = gr < rlim && gc < clim;
    cp_async16(dst + r * LDT + c, live ? src + (size_t)gr * ld + gc : src, live);
  }
}

// DW false: dh, a cluster per (64-token tile, group) walks the vocab
// tiles; DW true: dw, a cluster per (128-vocab tile, group) walks the token
// tiles. Grid: C x groups x tiles blocks, clusters of C along x.
//
// DSMEM traffic is pushed, never pulled: a remote store does not stall its
// thread on a round trip. Each barrier is split into its arrive and its
// wait, with work between them. Step s, in every block:
//   wait A(s); sum this block's rows of the partials it received (Rv) in
//   rank order, compute their dl and push its three bf16 parts to every
//   rank's D; arrive B(s); the logits of s + 1; wait B(s); push the
//   partials of s + 1 to the ranks that reduce their rows (every rank has
//   read Rv for s); contract D with the panel; arrive A(s + 1); add the
//   step's sum to the accumulator and start the copy of the panel of s + 2.
// A rank writes a peer's D only between A and B and its Rv only between B
// and A, while that peer reads them in the other phase: one buffer of each.
template <bool DW>
__global__ void __launch_bounds__(NT, 1)
blockwise_ce_bwd_cluster_kernel(const uint16_t* __restrict__ h, const uint16_t* __restrict__ w,
                                const long long* __restrict__ labels,
                                const float* __restrict__ g, const float* __restrict__ lse,
                                __nv_bfloat16* __restrict__ out, int Tn, int H, int V,
                                long long ignore, int npanel, int ngroup, int hvec, int wvec) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();                              // peers must have started before any push
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cl = (int)(blockIdx.x / C);
  const int grp = cl % ngroup, tile = cl / ngroup;
  const int rpr = BM / C;                        // logits rows this block reduces
  const int accp = rank * npanel + grp;          // the panel it accumulates
  extern __shared__ float4 smem4[];
  float* Rv = reinterpret_cast<float*>(smem4);                    // [C][rpr][LDF] partials received
  long long* Lab = reinterpret_cast<long long*>(Rv + BM * LDF);   // [2][BM] row state
  float* Lse = reinterpret_cast<float*>(Lab + 2 * BM);            // [2][BM]
  float* Gr = Lse + 2 * BM;                                       // [2][BM]
  uint16_t* R = reinterpret_cast<uint16_t*>(Gr + 2 * BM);         // resident panel
  uint16_t* Sb = R + res_rows<DW>() * LDT;                        // [2] streamed panels
  uint16_t* D = Sb + 2 * str_rows<DW>() * LDT;                    // [3][BM][LDT] dl parts
  constexpr int SROWS = str_rows<DW>();
  const WarpTile wt;
  const int nsteps = DW ? (Tn + BM - 1) / BM : (V + BN - 1) / BN;
  const int trow0 = tile * BM, tcol0 = tile * BN;   // the cluster's own tile
  const bool pipe = npanel == 1;

  // h[row0 .., panel kp] [64 x 128] and w[panel kp, col0 ..] [128 x 128]
  auto load_h = [&](uint16_t* dst, int row0, int kp) {
    load_panel<BM>(dst, h, (size_t)Tn * H, H, row0, kp * PANEL, Tn, H, hvec);
  };
  auto load_w = [&](uint16_t* dst, int kp, int col0) {
    load_panel<PANEL>(dst, w, (size_t)H * V, V, kp * PANEL, col0, H, V, wvec);
  };
  auto load_res = [&](int kp) {
    if (DW) load_w(R, kp, tcol0);
    else load_h(R, trow0, kp);
  };
  auto load_str = [&](uint16_t* dst, int s, int kp) {
    if (DW) load_h(dst, s * BM, kp);
    else load_w(dst, kp, s * BN);
  };
  // labels, lse and g of step s's 64 rows into state buffer s & 1 (dh: its
  // one token tile, buffer 0, loaded once); zero past T
  auto load_state = [&](int s) {
    const int r = (DW ? s * BM : trow0) + threadIdx.x, b = (DW ? s & 1 : 0) * BM + threadIdx.x;
    const bool live = r < Tn;
    if (threadIdx.x < BM) {
      cp_async_small(Lab + b, live ? labels + r : labels, 8, live);
      cp_async_small(Lse + b, live ? lse + r : lse, 4, live);
      cp_async_small(Gr + b, live ? g + r : g, 4, live);
    }
  };
  // lg += h panel [64 t][128 k] @ w panel [128 k][128 v]
  auto product = [&](float (&lg)[8][4], const uint16_t* Ht, const uint16_t* Wt) {
#pragma unroll
    for (int ks = 0; ks < PANEL; ks += 16) {
      uint32_t a[4];
      frag_a(a, Ht, LDT, wt.r0, ks);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b[4];
        frag_b2_t(b, Wt, LDT, wt.n0 + 16 * jj, ks);
        mma16816<__nv_bfloat16>(lg[2 * jj], a, b[0], b[1]);
        mma16816<__nv_bfloat16>(lg[2 * jj + 1], a, b[2], b[3]);
      }
    }
  };
  // the block's partial logits of step s over its slice. The pipeline
  // streams one panel a step (the next one's copy in flight); with P > 1
  // panels each is loaded in turn into R and Sb[0].
  auto logits = [&](int s, float (&lg)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) lg[j][0] = lg[j][1] = lg[j][2] = lg[j][3] = 0.f;
    if (pipe) {
      const uint16_t* Sp = Sb + (s & 1) * SROWS * LDT;
      cp_async_wait<0>();
      __syncthreads();
      product(lg, DW ? Sp : R, DW ? R : Sp);
    } else {
      for (int p = 0; p < npanel; ++p) {
        __syncthreads();                         // the panels' last readers are done
        load_res(rank * npanel + p);
        load_str(Sb, s, rank * npanel + p);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        product(lg, DW ? Sb : R, DW ? R : Sb);
      }
    }
  };
  // each partial row to the rank that reduces it, at [this rank][row % rpr]
  auto push_partials = [&](const float (&lg)[8][4]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = wt.row(2 * hf);
      float* dst = cluster.map_shared_rank(Rv + (rank * rpr + row % rpr) * LDF, row / rpr);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(dst + wt.col(j, 0)) =
            make_float2(lg[j][2 * hf], lg[j][2 * hf + 1]);
    }
  };

  // dh: rows 16 (warp % 4) .. + 16 (tokens) x columns 64 (warp / 4) .. + 64
  // (hidden); dw: rows 32 (warp % 4) .. + 32 (hidden) x 64 vocab columns.
  // Each step's contraction sums into zeroed registers and is then added
  // to acc in f32: the tensor cores' accumulation alone would carry
  // thousands of steps at the running sum's exponent.
  float acc[DW ? 2 : 1][8][4] = {};
  // the state of step s lands with its streamed panel: the logits of s
  // (one step earlier) wait for both
  load_state(0);
  if (pipe) {
    load_res(rank);
    load_str(Sb, 0, rank);
    cp_async_commit();
    if (nsteps > 1) {
      load_str(Sb + SROWS * LDT, 1, rank);
      if (DW) load_state(1);
    }
    cp_async_commit();
  } else {
    load_str(Sb + SROWS * LDT, 0, accp);
    cp_async_commit();
  }
  {
    float lg[8][4];
    logits(0, lg);
    cluster_wait();
    push_partials(lg);
  }
  cluster_arrive();
  cluster_wait();                                // A(0)
  for (int s = 0; s < nsteps; ++s) {
    const int row0 = DW ? s * BM : trow0, col0 = DW ? tcol0 : s * BN;
    if (!pipe && DW) {                           // this step's state has landed
      cp_async_wait<0>();
      __syncthreads();
    }
    const int sb = (DW ? s & 1 : 0) * BM;
    // reduce: this block's rows summed in rank order, then dl, pushed to
    // every rank as three bf16 parts
    for (int i = threadIdx.x; i < rpr * (BN / 4); i += NT) {
      const int rl = i / (BN / 4), c4 = (i % (BN / 4)) * 4;
      float4 y[CL_MAX];
#pragma unroll
      for (int q = 0; q < CL_MAX; ++q)
        if (q < C) y[q] = *reinterpret_cast<const float4*>(Rv + (q * rpr + rl) * LDF + c4);
      float4 x = y[0];
#pragma unroll
      for (int q = 1; q < CL_MAX; ++q) {
        if (q < C) {
          x.x += y[q].x; x.y += y[q].y; x.z += y[q].z; x.w += y[q].w;
        }
      }
      const int rr = rank * rpr + rl, r = row0 + rr;
      const bool live = r < Tn;
      const long long lab = live ? Lab[sb + rr] : -1;
      const float l = live ? Lse[sb + rr] : 0.f;
      const float sc = (live && lab != ignore) ? Gr[sb + rr] : 0.f;
      const float v[4] = {x.x, x.y, x.z, x.w};
      uint16_t part[4][3];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + c4 + e;
        const bool lv = col < V;
        const float p = lv ? expf(v[e] - l) : 0.f;
        const float hit = (lv && col == lab) ? 1.f : 0.f;
        split3((p - hit) * sc, part[e]);
      }
      uint2 pk[3];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        pk[q] = make_uint2(part[0][q] | ((uint32_t)part[1][q] << 16),
                           part[2][q] | ((uint32_t)part[3][q] << 16));
#pragma unroll
      for (int q = 0; q < CL_MAX; ++q) {
        if (q < C) {
          uint16_t* dst = cluster.map_shared_rank(D + rr * LDT + c4, q);
#pragma unroll
          for (int k = 0; k < 3; ++k) *reinterpret_cast<uint2*>(dst + k * BM * LDT) = pk[k];
        }
      }
    }
    cluster_arrive();                            // B(s)
    float lg[8][4];
    if (s + 1 < nsteps) logits(s + 1, lg);
    cluster_wait();
    if (s + 1 < nsteps) push_partials(lg);
    if (!pipe) {                                 // the accumulated panel has landed
      cp_async_wait<0>();
      __syncthreads();
    }
    const uint16_t* Sc = Sb + (pipe ? (s & 1) : 1) * SROWS * LDT;
    float cacc[DW ? 2 : 1][8][4] = {};
    if constexpr (DW) {
      // dw[panel, cols] += h[rows, panel]^T dl: h stored [t][k] is A^T
#pragma unroll
      for (int ts = 0; ts < BM; ts += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) frag_a_t(a[m], Sc, LDT, 2 * wt.r0 + 16 * m, ts);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            uint32_t b[4];
            frag_b2_t(b, D + q * BM * LDT, LDT, wt.n0 + 16 * jj, ts);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma16816<__nv_bfloat16>(cacc[m][2 * jj], a[m], b[0], b[1]);
              mma16816<__nv_bfloat16>(cacc[m][2 * jj + 1], a[m], b[2], b[3]);
            }
          }
        }
      }
    } else {
      // dh[rows, panel] += dl w[panel, cols]^T: w stored [k][v] is B's [n][k]
#pragma unroll
      for (int vs = 0; vs < BN; vs += 16) {
        uint32_t a[3][4];
#pragma unroll
        for (int q = 0; q < 3; ++q) frag_a(a[q], D + q * BM * LDT, LDT, wt.r0, vs);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t b[4];
          frag_b2(b, Sc, LDT, wt.n0 + 16 * jj, vs);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            mma16816<__nv_bfloat16>(cacc[0][2 * jj], a[q], b[0], b[1]);
            mma16816<__nv_bfloat16>(cacc[0][2 * jj + 1], a[q], b[2], b[3]);
          }
        }
      }
    }
    const bool more = s + 1 < nsteps;
    if (more) cluster_arrive();                  // A(s + 1): done with D, partials sent
#pragma unroll
    for (int m = 0; m < (DW ? 2 : 1); ++m) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] += cacc[m][j][e];
      }
    }
    __syncthreads();                             // Sc is consumed
    if (pipe && s + 2 < nsteps) {
      load_str(Sb + (s & 1) * SROWS * LDT, s + 2, rank);
      if (DW) load_state(s + 2);
    }
    if (!pipe && more) {
      load_str(Sb + SROWS * LDT, s + 1, accp);
      if (DW) load_state(s + 1);
    }
    cp_async_commit();
    if (more) cluster_wait();
  }
  // each output element once, rounded from its f32 sum
#pragma unroll
  for (int m = 0; m < (DW ? 2 : 1); ++m) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (DW) {
          const int hr = accp * PANEL + 2 * wt.r0 + 16 * m + wt.gq + 8 * (e / 2);
          const int col = tcol0 + wt.col(j, e);
          if (hr < H && col < V) out[(size_t)hr * V + col] = __float2bfloat16(acc[m][j][e]);
        } else {
          const int r = trow0 + wt.row(e), hc = accp * PANEL + wt.col(j, e);
          if (r < Tn && hc < H) out[(size_t)r * H + hc] = __float2bfloat16(acc[m][j][e]);
        }
      }
    }
  }
  cluster.sync();                                // a block exits only when its peers are done
}

// every block of every cluster reads each peer's shared memory: out[b C + q]
// = 1000 x (b's cluster) + q from rank q of b's cluster
__global__ void blockwise_ce_cluster_check_kernel(int* __restrict__ out) {
  __shared__ int v;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  if (threadIdx.x == 0) v = 1000 * (int)(blockIdx.x / C) + (int)cluster.block_rank();
  cluster.sync();
  if ((int)threadIdx.x < C)
    out[blockIdx.x * C + threadIdx.x] = *cluster.map_shared_rank(&v, threadIdx.x);
  cluster.sync();
}

cudaLaunchConfig_t cluster_config(dim3 grid, int threads, size_t smem, int C,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool DW> cudaError_t cluster_prepare() {
  static const cudaError_t e = cudaFuncSetAttribute(
      blockwise_ce_bwd_cluster_kernel<DW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cluster_smem<DW>());
  return e;
}

template <bool DW> int cluster_tiles(int Tn, int V) {
  return DW ? (V + BN - 1) / BN : (Tn + BM - 1) / BM;
}

template <bool DW>
int bwd_cluster(const void* h, const void* w, const long long* labels, const float* g,
                const float* lse, void* out, int Tn, int H, int V, long long ignore,
                cudaStream_t stream) {
  const cudaError_t prep = cluster_prepare<DW>();
  if (prep != cudaSuccess) return (int)prep;
  const BwdPlan p = bwd_plan(H);
  const int hvec = ((H & 7) == 0 && (reinterpret_cast<uintptr_t>(h) & 15) == 0) ? 1 : 0;
  const int wvec = ((V & 7) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) ? 1 : 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3((unsigned)(cluster_tiles<DW>(Tn, V) * p.ngroup * p.C)), NT, cluster_smem<DW>(),
      p.C, stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, blockwise_ce_bwd_cluster_kernel<DW>, (const uint16_t*)h, (const uint16_t*)w,
      labels, g, lse, (__nv_bfloat16*)out, Tn, H, V, ignore, p.npanel, p.ngroup, hvec, wvec);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// clusters of this plan that fit on the card at once (0 on an error)
template <bool DW> int max_active_clusters(int C, int nclusters) {
  if (cluster_prepare<DW>() != cudaSuccess) return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3((unsigned)(nclusters * C)), NT,
                                                cluster_smem<DW>(), C, nullptr, &attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, blockwise_ce_bwd_cluster_kernel<DW>, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---- The forward for bf16 / fp16: wgmma fed by a TMA ring ----
//
// One block of three warpgroups per (128-token tile, vocab split). Warp-
// group 0 is the producer: one thread keeps TMA loads of h [128, 64] and w
// [64, WG_BN] in flight through a WG_STAGES-deep ring of shared memory,
// each stage guarded by a full and an empty mbarrier. Warpgroups 1 and 2
// consume: each owns 64 token rows and issues wgmma m64n128k16 (two of
// them for the tile's 256 columns) from the staged tiles, f32 accumulators
// in registers. h is K-major (hidden contiguous); w is MN-major (vocab
// contiguous) and takes wgmma's transpose bit; both land in 128-byte rows
// under the 128-byte swizzle, which the TMA boxes and the descriptors
// share. The epilogue reads the accumulators where wgmma leaves them: each
// thread keeps its own running max and sum over its columns in log2 units
// (ex2.approx with log2(e) folded into one FMA) and the gold logit where its
// column is the label; its quad merges them once at the end. The producer
// is already loading the next vocab tile while the epilogue runs.
constexpr int WG_BM = 128;                     // token rows per tile: two consumers of 64
constexpr int WG_BN = 256;                     // vocab columns per tile
constexpr int WG_BK = 64;                      // hidden units per stage: one 128-byte row
constexpr int WG_STAGES = 4;
constexpr int WG_THREADS = 384;                // producer + two consumer warpgroups
constexpr int WG_NB = WG_BN / 128;             // m64n128 products per k-step
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;  // h [128][64]: 16 KB
constexpr int WG_B_BOX = WG_BK * 64 * 2;       // w [64][64], one TMA box: 8 KB
constexpr int WG_B_BYTES = WG_BN / 64 * WG_B_BOX;
constexpr int WG_STAGE_BYTES = WG_A_BYTES + WG_B_BYTES;
constexpr size_t WG_SMEM = 1024 + (size_t)WG_STAGES * WG_STAGE_BYTES + 2 * WG_STAGES * 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2**x on the SFU; results below 2**-126 flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(b)), "r"(count)
               : "memory");
}
// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(b)) : "memory");
}
// spin until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_u32(b)), "r"(parity) : "memory");
}

// box (c0 inner, c1 outer) of a 2-D tensor map into shared memory; the
// bytes complete a transaction of the barrier
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// the accumulators are read only after the wait that completes them
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// shared-memory matrix descriptors, 128-byte swizzle (addresses in 16-byte
// units): K-major h, 8-row groups 1024 B apart (the leading offset unused);
// MN-major w, 8-row groups of the hidden axis 1024 B apart and 64-column
// blocks one TMA box apart
__device__ __forceinline__ uint64_t desc_enc(uint32_t x) { return (uint64_t)((x & 0x3FFFF) >> 4); }
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_enc(addr) | (1ull << 16) | (desc_enc(1024) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return desc_enc(addr) | (desc_enc(WG_B_BOX) << 16) | (desc_enc(1024) << 32) | (1ull << 62);
}

// d (+)= a b for one warpgroup: a 64 x 16 K-major, b 16 x 128 MN-major
// (transposed), d 64 x 128 f32; scale_d 0 starts the sum at zero
template <typename T>
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

template <int R> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <typename T>
__global__ void __launch_bounds__(WG_THREADS, 1)
blockwise_ce_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_h,
                              const __grid_constant__ CUtensorMap tm_w,
                              const long long* __restrict__ labels,
                              float* __restrict__ part, int Tn, int H, int V,
                              int nsplit, int tiles_per_split) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzled stages start on 1024 bytes, the swizzle's period
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WG_STAGES * WG_STAGE_BYTES);
  uint64_t* empty = full + WG_STAGES;
  auto stage_a = [&](int s) { return smem + s * WG_STAGE_BYTES; };
  auto stage_b = [&](int s) { return smem + s * WG_STAGE_BYTES + WG_A_BYTES; };

  const int wg = threadIdx.x / 128;
  const int row0 = blockIdx.x * WG_BM;
  const int split = blockIdx.y;
  const int nv = (V + WG_BN - 1) / WG_BN;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(nv, vt0 + tiles_per_split);
  const int nkc = (H + WG_BK - 1) / WG_BK;       // stages per vocab tile

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);                    // the producer's arrival and the bytes
      mbar_init(&empty[s], 8);                   // each consumer warp's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int i = 0;
      for (int vt = vt0; vt < vt1; ++vt) {
        for (int kc = 0; kc < nkc; ++kc, ++i) {
          const int s = i % WG_STAGES;
          if (i >= WG_STAGES) mbar_wait(&empty[s], (i / WG_STAGES - 1) & 1);
          mbar_expect_tx(&full[s], WG_STAGE_BYTES);
          tma_load_2d(stage_a(s), &tm_h, &full[s], kc * WG_BK, row0);
#pragma unroll
          for (int nb = 0; nb < WG_BN / 64; ++nb)
            tma_load_2d(stage_b(s) + nb * WG_B_BOX, &tm_w, &full[s], vt * WG_BN + nb * 64,
                        kc * WG_BK);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int c = wg - 1;                        // rows 64 c .. 64 c + 63 of the tile
    const int lane = threadIdx.x % 32, wq = (threadIdx.x / 32) % 4;
    const int g = lane / 4, t = lane % 4;
    const int r_lo = row0 + 64 * c + 16 * wq + g;   // the thread's rows: r_lo, r_lo + 8
    long long lab[2];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, gold[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) lab[h] = r_lo + 8 * h < Tn ? labels[r_lo + 8 * h] : -1;
    float acc[WG_NB][64];
    // release a consumed stage: every warp of both consumers arrives
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    int i = 0;
    for (int vt = vt0; vt < vt1; ++vt) {
      int prev = 0;
      for (int kc = 0; kc < nkc; ++kc, ++i) {
        const int s = i % WG_STAGES;
        mbar_wait(&full[s], (i / WG_STAGES) & 1);
#pragma unroll
        for (int nb = 0; nb < WG_NB; ++nb) fence_acc(acc[nb]);
        wgmma_fence();
        const uint32_t a0 = smem_u32(stage_a(s)) + c * (64 * 128);
        const uint32_t b0 = smem_u32(stage_b(s));
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) {
          const uint64_t da = desc_kmajor(a0 + 32 * kk);
#pragma unroll
          for (int nb = 0; nb < WG_NB; ++nb)
            wgmma_128<T>(acc[nb], da, desc_mnmajor(b0 + nb * 2 * WG_B_BOX + kk * 16 * 128),
                         kc > 0 || kk > 0);
        }
        wgmma_commit();
        if (kc > 0) {                            // the previous stage's products are done
          wgmma_wait<1>();
          release(prev);
        }
        prev = s;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < WG_NB; ++nb) fence_acc(acc[nb]);
      release(prev);

      // epilogue: element (nb, j, e) of row h sits in acc[nb][4 j + 2 h + e]
      // at column vt WG_BN + 128 nb + 8 j + 2 t + e
      const int cbase = vt * WG_BN + 2 * t;
      auto epilogue = [&](auto edge_c) {
        constexpr bool EDGE = decltype(edge_c)::value;   // columns past V in the tile
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = NEG_INF;
#pragma unroll
          for (int nb = 0; nb < WG_NB; ++nb) {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (!EDGE || cbase + 128 * nb + 8 * j + e < V)
                  mx = fmaxf(mx, acc[nb][4 * j + 2 * h + e]);
              }
            }
          }
          // a thread with no column left in the tile keeps its state
          const float m_new = mx == NEG_INF ? m[h] : fmaxf(m[h], mx * LOG2E);
          const float corr = ex2(m[h] - m_new), neg = -m_new;
          float sum = 0.f;
#pragma unroll
          for (int nb = 0; nb < WG_NB; ++nb) {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float p = ex2(fmaf(acc[nb][4 * j + 2 * h + e], LOG2E, neg));
                if (EDGE && cbase + 128 * nb + 8 * j + e >= V) p = 0.f;
                sum += p;
              }
            }
          }
          l[h] = l[h] * corr + sum;
          m[h] = m_new;
          // the gold logit, from the f32 logits, in the one tile that holds it
          if ((unsigned long long)(lab[h] - (long long)vt * WG_BN) < (unsigned long long)WG_BN &&
              lab[h] < V) {
#pragma unroll
            for (int nb = 0; nb < WG_NB; ++nb) {
#pragma unroll
              for (int j = 0; j < 16; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  if (cbase + 128 * nb + 8 * j + e == lab[h]) gold[h] += acc[nb][4 * j + 2 * h + e];
                }
              }
            }
          }
        }
      };
      if (vt * WG_BN + WG_BN > V) epilogue(std::true_type{});
      else epilogue(std::false_type{});
    }

    // merge the quad's running (max, sum, gold) per row and write the split's
    float* pm = part;
    float* pl = part + (size_t)nsplit * Tn;
    float* pg = part + 2 * (size_t)nsplit * Tn;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float M = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, 2));
      float L = l[h] * ex2(m[h] - M), G = gold[h];
      L += __shfl_xor_sync(0xffffffffu, L, 1);
      L += __shfl_xor_sync(0xffffffffu, L, 2);
      G += __shfl_xor_sync(0xffffffffu, G, 1);
      G += __shfl_xor_sync(0xffffffffu, G, 2);
      const int r = r_lo + 8 * h;
      if (t == 0 && r < Tn) {
        pm[(size_t)split * Tn + r] = M * LN2;
        pl[(size_t)split * Tn + r] = L;
        pg[(size_t)split * Tn + r] = G;
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver the process has loaded (no link
// flag): null where there is none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// the map of a row-major [rows, cols] 16-bit matrix whose rows are `pitch`
// elements apart, read in boxes of box_rows x 64 under the 128-byte swizzle;
// a box past an edge reads zeros there
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* base, uint64_t cols,
              uint64_t rows, uint64_t pitch, uint32_t box_rows) {
  const cuuint64_t dim[2] = {cols, rows};
  const cuuint64_t stride[1] = {pitch * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t estride[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT16, 2, const_cast<void*>(base), dim, stride, box,
             estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA reads rows that start on 16 bytes: h [T, H] when H % 8 == 0, w [H, V]
// when V % 8 == 0. Other shapes read a copy of the matrix with its rows
// padded to the next multiple of 8 elements (the pad never read: the map's
// extent is the real one), placed in the scratch after the split partials.
struct FwdLayout {
  size_t part_floats, h_off, w_off, floats;      // offsets in floats; 0: no copy
  int h_pitch, w_pitch;
};
FwdLayout fwd_layout(int Tn, int H, int V, int nsplit) {
  auto up = [](size_t x, size_t m) { return (x + m - 1) / m * m; };
  FwdLayout L{};
  L.part_floats = 3 * (size_t)nsplit * Tn;
  L.h_pitch = (int)up((size_t)H, 8);
  L.w_pitch = (int)up((size_t)V, 8);
  size_t off = up(L.part_floats, 64);           // 256-byte aligned copies
  if (H % 8) {
    L.h_off = off;
    off += up((size_t)Tn * L.h_pitch / 2, 64);
  }
  if (V % 8) {
    L.w_off = off;
    off += up((size_t)H * L.w_pitch / 2, 64);
  }
  L.floats = off > L.part_floats ? off : L.part_floats;
  return L;
}

// The wgmma forward's vocab splits for T tokens on `sms` multiprocessors
// (one block each): the fewest splits that minimise the longest queue of
// the (token tile, split) grid in waves of `sms` blocks, a block costing
// its vocab tiles plus WG_BLOCK_COST_Q quarters of a tile (filling the
// ring, the partials' writes).
constexpr int WG_BLOCK_COST_Q = 1;
int wgmma_splits(int Tn, int V, int sms) {
  const int tt = (Tn + WG_BM - 1) / WG_BM, nv = (V + WG_BN - 1) / WG_BN;
  int best = 1;
  long long best_t = -1;
  for (int s = 1; s <= nv; ++s) {
    const int tps = (nv + s - 1) / s, used = (nv + tps - 1) / tps;
    const long long waves = ((long long)tt * used + sms - 1) / sms;
    const long long span = waves * (4LL * tps + WG_BLOCK_COST_Q);
    if (best_t < 0 || span < best_t) {
      best_t = span;
      best = s;
    }
  }
  return best;
}

template <typename T>
int fwd_wgmma(const void* h, const void* w, const long long* labels, float* loss, float* lse,
              float* part, int Tn, int H, int V, int nsplit, long long ignore,
              cudaStream_t stream) {
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const FwdLayout L = fwd_layout(Tn, H, V, nsplit);
  const void* hh = h;
  const void* ww = w;
  int hp = H, wp = V;
  if (L.h_off) {                                 // rows of h padded to 16 bytes
    void* dst = part + L.h_off;
    const cudaError_t e = cudaMemcpy2DAsync(dst, (size_t)L.h_pitch * 2, h, (size_t)H * 2,
                                            (size_t)H * 2, Tn, cudaMemcpyDeviceToDevice, stream);
    if (e != cudaSuccess) return (int)e;
    hh = dst;
    hp = L.h_pitch;
  }
  if (L.w_off) {                                 // rows of w padded to 16 bytes
    void* dst = part + L.w_off;
    const cudaError_t e = cudaMemcpy2DAsync(dst, (size_t)L.w_pitch * 2, w, (size_t)V * 2,
                                            (size_t)V * 2, H, cudaMemcpyDeviceToDevice, stream);
    if (e != cudaSuccess) return (int)e;
    ww = dst;
    wp = L.w_pitch;
  }
  CUtensorMap tm_h, tm_w;
  if (!make_map(enc, &tm_h, hh, H, Tn, hp, WG_BM) || !make_map(enc, &tm_w, ww, V, H, wp, WG_BK))
    return (int)cudaErrorInvalidValue;
  auto kern = blockwise_ce_fwd_wgmma_kernel<T>;
  static const cudaError_t attr = allow_smem(kern, WG_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int nv = (V + WG_BN - 1) / WG_BN;
  const int tps = (nv + nsplit - 1) / nsplit;
  const int nused = (nv + tps - 1) / tps;        // splits that own a vocab tile
  dim3 grid((Tn + WG_BM - 1) / WG_BM, nused);
  kern<<<grid, WG_THREADS, WG_SMEM, stream>>>(tm_h, tm_w, labels, part, Tn, H, V, nsplit, tps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  blockwise_ce_combine_kernel<<<(Tn + NT - 1) / NT, NT, 0, stream>>>(
      part, labels, loss, lse, Tn, nsplit, nused, ignore);
  return (int)cudaGetLastError();
}

constexpr size_t FWD_SMEM = sizeof(float) * REGION;

template <typename T>
int fwd_t(const void* h, const void* w, const long long* labels, float* loss,
          float* lse, float* part, int Tn, int H, int V, int nsplit,
          long long ignore, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    return fwd_wgmma<T>(h, w, labels, loss, lse, part, Tn, H, V, nsplit, ignore, stream);
  } else {
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
}

template <typename T>
int dh_t(const void* h, const void* w, const long long* labels, const float* g,
         const float* lse, float* ws, void* dh, int Tn, int H, int V,
         int nsplit, long long ignore, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (H <= CL_MAX_H)
      return bwd_cluster<false>(h, w, labels, g, lse, dh, Tn, H, V, ignore, stream);
  }
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
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
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (H <= CL_MAX_H)
      return bwd_cluster<true>(h, w, labels, g, lse, dw, Tn, H, V, ignore, stream);
  }
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
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

// The vocab splits of the f32 forward and of the workspace dh for T tokens
// over V columns on a card with `sms` multiprocessors: enough blocks for
// two per SM when the token tiles alone are too few (small T), at most one
// split per vocab tile. The caller sizes the workspace of dh by it; the
// forward's plan (below) gives its own.
int blockwise_ce_splits(int Tn, int V, int sms) {
  if (Tn <= 0 || V <= 0 || sms <= 0) return 1;
  const int tiles_t = (Tn + BM - 1) / BM, tiles_v = (V + BN - 1) / BN;
  const int want = (2 * sms + tiles_t - 1) / tiles_t;
  return want < 1 ? 1 : (want < tiles_v ? want : tiles_v);
}

// The forward's plan for dtype (0 float32, 1 bfloat16, 2 float16), T
// tokens, H hidden units and V columns on a card with `sms`
// multiprocessors, into out[0 .. 10):
//   [0] route: 0 the CUDA-core f32 body; 1 wgmma with TMA loads straight
//       from h and w; 2 the same over copies of h and / or w whose rows are
//       padded to 16 bytes (H % 8 != 0 or V % 8 != 0)
//   [1] vocab splits  [2] vocab tiles per split  [3] tokens per tile
//   [4] vocab columns per tile  [5] ring stages (0: none)  [6] blocks
//   [7] scratch floats the launch needs in `part`  [8] bytes of h copied
//   [9] bytes of w copied
// Returns 10, or -1 on bad sizes or dtype. The caller sizes `part` by [7]
// and passes [1] as nsplit.
int blockwise_ce_fwd_plan(int dtype, int Tn, int H, int V, int sms, long long* out) {
  if (bad_shape(Tn, H, V) || sms <= 0 || dtype < 0 || dtype > 2) return -1;
  for (int i = 0; i < 10; ++i) out[i] = 0;
  const bool wg = dtype != 0;
  const int bm = wg ? WG_BM : BM, bn = wg ? WG_BN : BN;
  const int nsplit = wg ? wgmma_splits(Tn, V, sms) : blockwise_ce_splits(Tn, V, sms);
  const int nv = (V + bn - 1) / bn, tps = (nv + nsplit - 1) / nsplit;
  const int nused = (nv + tps - 1) / tps;
  const FwdLayout L = fwd_layout(Tn, H, V, nsplit);
  const long long vals[10] = {
      wg ? (L.h_off || L.w_off ? 2 : 1) : 0, nsplit, tps, bm, bn, wg ? WG_STAGES : 0,
      (long long)((Tn + bm - 1) / bm) * nused,
      wg ? (long long)L.floats : 3LL * nsplit * Tn,
      wg && L.h_off ? 2LL * Tn * H : 0, wg && L.w_off ? 2LL * H * V : 0};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 10;
}

// dtype: 0 float32, 1 bfloat16, 2 float16. Writes loss and lse; part is
// f32 scratch: [3, nsplit, T] (running max, scaled sum and gold logit of
// each vocab split), then for bf16 / fp16 the padded copies of
// blockwise_ce_fwd_plan (its [7] floats in all). Two launches (the split
// kernel, then the combine), after the copies. bf16 / fp16 need h and w
// on 16-byte boundaries. Returns the CUDA error code of the launches (0 on
// success).
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

// Writes dh [T, H] in h's dtype. bf16 with H <= 8192: one cluster launch;
// ws and nsplit are not read (ws may be null). Otherwise ws is [nsplit, T,
// H] f32 scratch, one [T, H] workspace per vocab split, and there are two
// launches (the split kernel, then the combine that sums the workspaces
// into dh).
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

// Writes dw [H, V] in w's dtype, one launch. bf16 with H <= 8192: ws is
// not read (it may be null); otherwise it is [H, V] f32 scratch.
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

// The bf16 backward's plan for T tokens, H hidden units and V columns on a
// card with `sms` multiprocessors, into out[0 .. 15):
//   [0] route: 1 the cluster kernel, 0 the workspace bodies (H > 8192)
//   [1] C, blocks per cluster  [2] S, hidden units a block multiplies
//   [3] panels of 128 a block multiplies  [4] clusters per tile (groups)
//   [5] tokens per tile  [6] vocab columns per tile
//   [7] dh clusters  [8] dw clusters  [9] dh / [10] dw shared memory bytes
//   [11] dh / [12] dw clusters resident at once (cudaOccupancyMaxActiveClusters)
//   [13] dh / [14] dw SMs busy in the first wave
// Returns 15, or -1 on bad sizes. The cluster route's values are zero on
// the workspace route.
int blockwise_ce_bwd_plan(int H, int V, int Tn, int sms, int* out) {
  if (bad_shape(Tn, H, V) || sms <= 0) return -1;
  for (int i = 0; i < 15; ++i) out[i] = 0;
  if (H > CL_MAX_H) return 15;
  const BwdPlan p = bwd_plan(H);
  const int ndh = cluster_tiles<false>(Tn, V) * p.ngroup;
  const int ndw = cluster_tiles<true>(Tn, V) * p.ngroup;
  const int adh = max_active_clusters<false>(p.C, ndh > 0 ? ndh : 1);
  const int adw = max_active_clusters<true>(p.C, ndw);
  const int vals[15] = {1, p.C, p.npanel * PANEL, p.npanel, p.ngroup, BM, BN, ndh, ndw,
                        (int)cluster_smem<false>(), (int)cluster_smem<true>(), adh, adw,
                        (ndh < adh ? ndh : adh) * p.C, (ndw < adw ? ndw : adw) * p.C};
  for (int i = 0; i < 15; ++i) out[i] = vals[i];
  if (out[13] > sms) out[13] = sms;
  if (out[14] > sms) out[14] = sms;
  return 15;
}

// Launches `nclusters` clusters of C blocks (1 <= C <= 8) whose blocks read
// every peer's shared memory: out [nclusters * C * C] int gets, at b C + q,
// 1000 x (block b's cluster) + q as read from rank q. Returns the CUDA error
// code of the launch.
int blockwise_ce_cluster_check(int C, int nclusters, int* out, void* stream) {
  if (C < 1 || C > CL_MAX || nclusters < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3((unsigned)(nclusters * C)), 32, 0, C,
                                                (cudaStream_t)stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, blockwise_ce_cluster_check_kernel, out);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // extern "C"
