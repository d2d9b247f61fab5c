// Tensor-core tile helpers for Hopper (sm_90a): mma.sync m16n8k16 with f32
// accumulators, ldmatrix fragment loads from padded 16-bit shared tiles,
// cp.async copies with zero-fill for a ring of staged tiles, and the exact
// split of an f32 operand into 16-bit parts. Used by flash_attention.cu and
// flashmask.cu; written to be shared by the later tensor-core redesigns.
// `ops/_build.py` hashes every header into every library's name, so an
// edit here rebuilds every source.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 / .f16 operands), for
// lane = 4 * g + t (g = lane / 4, t = lane % 4):
//   A 16 x 16, four registers of two values (lower column in the lower
//   half): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//   a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B 16 x 8: b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g);
//   C / D 16 x 8 f32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// Two C tiles side by side (columns 0-7 and 8-15) are one A fragment once
// rounded to 16 bits: a0 = (c0, c1) and a1 = (c2, c3) of the left tile, a2,
// a3 the same of the right one. That is how a product's result feeds the
// next product without a trip through shared memory.
//
// Shared tiles keep rows of 16-bit values padded by 16 bytes (a row stride
// of D + 8 elements): the eight 16-byte rows that one ldmatrix phase reads
// then fall in eight distinct bank groups for every width used here.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <type_traits>

namespace {

// d += a b on the tensor cores: a 16 x 16, b 16 x 8, d 16 x 8 in f32
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  static_assert(std::is_same<T, __nv_bfloat16>::value || std::is_same<T, __half>::value,
                "tensor-core operands are bf16 or fp16");
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 8 x 8 16-bit matrices from shared memory: lane l gives the address of
// one 16-byte row of matrix l / 8 (x4: lanes 0-31; x2: lanes 0-15); .trans
// hands each lane the transposed pairs
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// The A fragment of rows r0 .. r0 + 16, depth k0 .. k0 + 16, of a 16-bit
// tile stored [row][k] (frag_a) or [k][row] (frag_a_t), row stride ld.
template <typename T>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const T* X, int ld, int r0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(a, X + (r0 + (l & 15)) * ld + k0 + ((l >> 4) << 3));
}
template <typename T>
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const T* X, int ld, int r0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4_t(a, X + (k0 + (l & 7) + ((l >> 4) << 3)) * ld + r0 + (((l >> 3) & 1) << 3));
}

// The B fragments of columns n0 .. n0 + 16 as two 8-column pieces (b[0..1]
// and b[2..3]), depth k0 .. k0 + 16, of a 16-bit tile stored [n][k]
// (frag_b2: rows of the tile are the product's columns, as K's rows are
// for q k^T) or [k][n] (frag_b2_t); frag_b1_t is one 8-column piece.
template <typename T>
__device__ __forceinline__ void frag_b2(uint32_t (&b)[4], const T* X, int ld, int n0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(b, X + (n0 + (l & 7) + ((l >> 4) << 3)) * ld + k0 + (((l >> 3) & 1) << 3));
}
template <typename T>
__device__ __forceinline__ void frag_b2_t(uint32_t (&b)[4], const T* X, int ld, int n0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4_t(b, X + (k0 + (l & 15)) * ld + n0 + ((l >> 4) << 3));
}
template <typename T>
__device__ __forceinline__ void frag_b1_t(uint32_t (&b)[2], const T* X, int ld, int n0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x2_t(b, X + (k0 + (l & 15)) * ld + n0);
}

// two f32 values rounded to T and packed (lo in the lower half)
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two values of a packed pair as f32 (lo in .x)
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t v);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t v) {
  return __half22float2(*reinterpret_cast<const __half2*>(&v));
}

// An f32 A fragment split exactly into P 16-bit parts, hi first, from two
// C tiles side by side (l: columns 0-7, r: 8-15; see the layouts above):
// part i is what the parts before it leave of x, rounded to T. x less a
// part is exact in f32, so the parts sum to x within 2**-16 |x| for P = 2
// in bf16 (2**-22 in fp16) and exactly for P = 3 in bf16 (|x| >= 2**-110,
// where the last part is not below bf16's subnormals). P = 1 is x rounded
// to T. One mma.sync per part, all into one f32 accumulator, multiplies x.
template <typename T, int P>
__device__ __forceinline__ void split_frag(uint32_t (&a)[P][4], const float (&l)[4],
                                           const float (&r)[4]) {
  float x[8] = {l[0], l[1], l[2], l[3], r[0], r[1], r[2], r[3]};
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      a[i][f] = pack2<T>(x[2 * f], x[2 * f + 1]);
      if (i + 1 < P) {
        const float2 u = unpack2<T>(a[i][f]);
        x[2 * f] -= u.x;
        x[2 * f + 1] -= u.y;
      }
    }
  }
}

// cp.async: 16 (or 4) bytes from global to shared memory without a trip
// through registers; `live` false writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(live ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(live ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a row-major [total, D] 16-bit matrix into
// dst[r * LD + c] by NTH threads, 16 bytes per copy; rows past `total`
// are zero-filled. The caller commits the group. Narrow tiles (D = 16: 2
// copies a row) may need fewer copies than there are threads.
template <int D, int LD, int ROWS, int NTH, typename T>
__device__ __forceinline__ void load_rows_async(T* dst, const T* __restrict__ src, int row0,
                                                int total) {
  constexpr int CPR = D / 8;                     // 16-byte chunks per row
  constexpr int COPIES = ROWS * CPR;
  static_assert(COPIES % NTH == 0 || COPIES < NTH,
                "whole copies per thread, or fewer copies than threads");
#pragma unroll
  for (int it = 0; it < (COPIES + NTH - 1) / NTH; ++it) {
    const int i = threadIdx.x + it * NTH;
    if (COPIES < NTH && i >= COPIES) break;
    const int r = i / CPR, c = i % CPR, gr = row0 + r;
    const bool live = gr < total;
    cp_async16(dst + r * LD + c * 8, live ? src + (size_t)gr * D + c * 8 : src, live);
  }
}

}  // namespace
