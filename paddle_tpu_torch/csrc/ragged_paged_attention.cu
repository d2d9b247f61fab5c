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
// Masking is the TPU kernel's (:548-554): row (j, g) is live when
// j < q_len; key position pos is visible when pos <= q_start + j, with
// q_start = max(len - q_len, 0). NEG_INF is -1e30 and l == 0 divides by
// one. Dead rows (j >= q_len, len 0) write zeros (:713-720). Only the
// first min(ceil(len / BS), MAXNB) pages are walked (an over-capacity
// len attends over the table's capacity), block ids are clamped into
// [0, NB) before any read (as `kdma` does at :497, so a -1 free-slot id
// never faults), and a tile skips the pages past its last live row's
// causal horizon, which are fully masked and would be exact no-ops.
//
// What bounds it: bytes. A decode row attends with G query rows per kv
// head, so each (kv head, sequence) reads its KV once for 4*G*D flops
// per key: about G flops per byte of bf16 KV, far below the ~295 the card
// needs before its tensor cores, not its memory, are the limit. At
// decode the whole call moves about 3 MB, under a microsecond of the
// card's bytes; what costs time is latency: how many pages are in flight
// at once, how many SMs issue them, and the chain of dependent steps a
// block takes (lengths, ids, page copy, softmax, partial, combine).
//
// The TPU grid is sequential: (kv head, work entry) carries m / l / acc
// from one grid step to the next. Hopper blocks run in parallel and in
// no order. Here a block is (split, kv head x row tile, sequence):
//
// * Rows. A sequence's rows for one kv head are its C*G query rows (row
//   = j*G + g: chunk position j, group row g; query head kv_head*G + g),
//   cut into tiles of 64. A decode tile holds its G rows, unpadded.
// * The split. The host's plan (`ops.paged_attention.ragged_plan`, from
//   shapes alone) cuts the page walk into S splits of P pages, so that
//   the grid covers the SMs at least twice where the unsplit grid would
//   not (decode at B=8, KVH=8, MAXNB=32: 8 splits of 4 pages, 512 blocks
//   in place of 64). Each block reads only lens / q_lens on the device
//   to find its tile's pages; a split past its tile's last page returns
//   at once and writes nothing.
// * The warp-shuffle route (f32, and 16-bit tiles with fewer than 16
//   live rows: decode, and the decode rows of a mixed step). Rows go in
//   groups of 4 (16-bit; fewer registers keep four blocks an SM) or 8
//   (f32), up to four groups at once; where fewer groups are live,
//   several warps share one, each taking every 2nd or 4th page of the
//   split. A warp reads its pages' ids first (one table read for 32
//   pages), then streams the pages through its own cp.async ring of two
//   (one where two would not fit), kept in the cache's own type; 16-byte
//   loads, D/8 (16-bit) or D/4 (f32) lanes per key row. A dot product is
//   a lane's 16 bytes, then warp shuffles, for every row of the group at
//   once (independent chains); every key group of the warp keeps its own
//   online softmax in registers, and the groups, then the warps, merge at
//   the end.
// * The tensor-core route (bf16 / fp16 tiles with 16 or more live rows:
//   chunked prefill). The 64-row q tile sits in shared memory; pages are
//   gathered through the block table into a four-page cp.async ring (a
//   page padded to 16 or 32 key rows with zeros); S = q k^T and o += p v
//   run on mma.sync m16n8k16 (csrc/mma_tiles.cuh), each warp owning 16
//   rows and skipping a page its rows cannot see. p is split into two
//   16-bit terms (hi + lo) for p v, so o keeps the f32 softmax's
//   accuracy where the route is held to the plain f32 version.
// * The combine, in the same launch. A tile with one live split writes
//   its output directly. Otherwise each live split writes its partial
//   (m, l, acc[rows, D], scores in log2 units) to an f32 workspace, and
//   the block that counts itself last in the tile's counter (an atomic
//   after __threadfence()) sets the counter back to zero (no memset runs
//   per call), computes each row's split weights 2^(m_s - max m) / l,
//   then sums the partials in split order, 16 bytes a load: two calls
//   give bit-equal outputs. Splits past a tile's last page are never
//   summed, and an empty partial (m = -1e30, l = 0, acc = 0) could only
//   add zeros.
//
// The block ids come from the block table, not from the host's work
// list; the host still builds the list per step, and its padded length
// keys the serving step's buckets and its counters.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <type_traits>

#include "mma_tiles.cuh"

namespace {

constexpr int NT = 128;           // threads per block
constexpr int NW = NT / 32;       // warps per block
constexpr int TILE = 64;          // query rows of a tile: 16 per warp on the mma route
constexpr int RG = 8;             // rows of a shuffle group, at most (f32: 8, 16-bit: 4)
constexpr int MMA_MIN_ROWS = 16;  // live rows from which a 16-bit tile takes mma.sync
constexpr int MAX_BS = 32;        // largest cache block size supported
constexpr int MAX_SPLITS = 32;    // most splits of a plan (the combine's weights fit res)
constexpr int MSTG = 4;           // pages in flight on the mma route
constexpr int SMEM_LIMIT = 232448;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
constexpr bool kIs16 = !std::is_same<T, float>::value;
// rows a warp-shuffle pass keeps in registers: 16-bit tiles on this route
// hold at most 15 live rows, and fewer rows keep four blocks an SM
template <typename T>
constexpr int kRows = kIs16<T> ? 4 : RG;

// 16 bytes of shared memory as f32 values
__device__ __forceinline__ void load16(float (&f)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load16(float (&f)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x; f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void load16(float (&f)[8], const __half* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __half22float2(h[i]);
    f[2 * i] = x.x; f[2 * i + 1] = x.y;
  }
}

// two f32 values as a 16-bit pair hi plus the pair lo of what hi misses
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack2<T>(x0, x1);
  float2 h;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  } else {
    h = __half22float2(*reinterpret_cast<const __half2*>(&hi));
  }
  lo = pack2<T>(x0 - h.x, x1 - h.y);
}

// eight f32 values stored as T, 16 (or 32) bytes at once
__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&v)[8]) {
  uint4 u;
  u.x = pack2<T>(v[0], v[1]);
  u.y = pack2<T>(v[2], v[3]);
  u.z = pack2<T>(v[4], v[5]);
  u.w = pack2<T>(v[6], v[7]);
  *reinterpret_cast<uint4*>(dst) = u;
}

struct Args {
  const void* q;
  const void* kc;
  const void* vc;
  const int* tables;
  const int* lens;
  const int* qlens;
  void* out;
  float* ws;        // S > 1: [S][tiles][TR][D] acc, then [S][tiles][TR][2] m, l
  int* counters;    // S > 1: one per tile, zero between launches
  int C, H, KVH, NB, BS, MAXNB;
  int TILES;        // row tiles per (kv head, sequence)
  int TR;           // rows of a tile's workspace and staging: min(64, C*G)
  int S, PPS;       // splits of the page walk, pages per split
  int nstg;         // pages in a warp's ring on the warp-shuffle route
  int ubytes;       // bytes of the shared region the routes share
  float scale_log2; // softmax scale times log2(e): scores in log2 units
};

// The block-table ids of a warp's pages pbeg + phase + k * stride, k = 0,
// 1, ...: lane i holds the id of page k = 32 * chunk + i, read (and
// clamped into [0, NB), so a -1 free-slot id never faults) before any copy
// is issued, so a page's copy never waits on its own table read. Called by
// every lane of the warp with k increasing.
struct PageIds {
  const int* trow;
  int pbeg, phase, stride, pend, NB, chunk, id;
  __device__ __forceinline__ int operator()(int k) {
    if ((k >> 5) != chunk) {
      chunk = k >> 5;
      const int p = pbeg + phase + ((chunk << 5) + threadIdx.x % 32) * stride;
      id = p < pend ? min(max(trow[p], 0), NB - 1) : 0;
    }
    return __shfl_sync(FULL, id, k & 31);
  }
};

// The warp-shuffle route: rows [0, nlive) of the tile over pages [pbeg,
// pend), in row groups of R. Up to four groups run at once, one per
// warp or, when fewer groups are live, several warps a group, each taking
// every wpr-th page. Leaves each row's (m, l, acc) in res / resm / resl.
template <typename T, int D>
__device__ __forceinline__ void shuffle_route(const Args& a, int b, int kvh, int row0,
                                              int nlive, int qstart, int pbeg, int pend,
                                              float* res, float* resm, float* resl,
                                              float* qs, unsigned char* U) {
  constexpr int EPL = 16 / sizeof(T);   // elements in 16 bytes
  constexpr int LPK = D / EPL;          // lanes per key row
  constexpr int KPP = 32 / LPK;         // key rows per warp pass
  constexpr int R = kRows<T>;           // rows of a group
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ kc = static_cast<const T*>(a.kc);
  const T* __restrict__ vc = static_cast<const T*>(a.vc);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = lane % LPK, gi = lane / LPK;
  const int G = a.H / a.KVH, BS = a.BS;
  const int page = BS * D;
  T* ring = reinterpret_cast<T*>(U) + (size_t)warp * a.nstg * 2 * page;
  float* mrg = reinterpret_cast<float*>(U);     // [NW][RG][D], aliasing the rings
  float* mm = mrg + NW * RG * D;                // [NW][RG]
  float* ml = mm + NW * RG;                     // [NW][RG]
  const int nrg = (nlive + R - 1) / R;          // row groups
  const int npar = min(nrg, NW);                // row groups at once
  const int wpr = NW / npar;                    // warps on one group
  const int phase = warp / npar;                // the warp's first page of the split

  for (int base = 0; base < nrg; base += npar) {
    __syncthreads();                            // qs, the rings and mrg are free
    const int nq = min(nlive - base * R, npar * R);
    for (int i = tid; i < npar * R * (D / EPL); i += NT) {
      const int r = i / (D / EPL), c8 = i % (D / EPL);
      float f[EPL];
      if (r < nq) {
        const int gr = row0 + base * R + r, j = gr / G, h = kvh * G + gr % G;
        load16(f, q + ((size_t)(b * a.C + j) * a.H + h) * D + c8 * EPL);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) qs[r * D + c8 * EPL + e] = f[e];
    }
    __syncthreads();                            // qs visible

    const int rg = base + warp % npar;
    const bool act = warp < npar * wpr && rg < nrg;
    const int r0 = rg * R, nr = act ? min(R, nlive - r0) : 0;
    const float* qg = qs + (warp % npar) * R * D;
    int qend[R];
#pragma unroll
    for (int r = 0; r < R; ++r) qend[r] = r < nr ? qstart + (row0 + r0 + r) / G : -1;
    float m[R], l[R], acc[R][EPL];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
    }
    if (act) {
      // the group's causal horizon, and this warp's pages below it
      const int pe = min(pend, (qstart + (row0 + r0 + nr - 1) / G) / BS + 1);
      const int np = pe > pbeg + phase ? (pe - pbeg - phase + wpr - 1) / wpr : 0;
      PageIds ids{a.tables + (size_t)b * a.MAXNB, pbeg, phase, wpr, pe, a.NB, -1, 0};
      auto issue = [&](int k, int slot) {
        const size_t base_e = ((size_t)kvh * a.NB + ids(k)) * page;
        T* ks = ring + slot * 2 * page;
        for (int e = lane * EPL; e < page; e += 32 * EPL) {
          cp_async16(ks + e, kc + base_e + e, true);
          cp_async16(ks + page + e, vc + base_e + e, true);
        }
      };
      if (np > 0) issue(0, 0);
      cp_async_commit();
      for (int i = 0; i < np; ++i) {
        int slot = 0;
        if (a.nstg == 2) {                      // the next page lands meanwhile
          slot = i & 1;
          if (i + 1 < np) issue(i + 1, slot ^ 1);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
        const T* ks = ring + slot * 2 * page;
        const T* vs = ks + page;
        const int p0 = (pbeg + phase + i * wpr) * BS;
        for (int k0 = 0; k0 < BS; k0 += KPP) {
          const int kk = k0 + gi;
          const bool vk = kk < BS;
          float kf[EPL], vf[EPL];
          if (vk) {
            load16(kf, ks + kk * D + c * EPL);
            load16(vf, vs + kk * D + c * EPL);
          } else {
#pragma unroll
            for (int e = 0; e < EPL; ++e) kf[e] = vf[e] = 0.f;
          }
          // every row at once (a row past nr has q = 0 and sees nothing):
          // independent chains for the scheduler
          float dot[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float t = 0.f;
#pragma unroll
            for (int v = 0; v < EPL / 4; ++v) {
              const float4 x = *reinterpret_cast<const float4*>(qg + r * D + c * EPL + 4 * v);
              t += x.x * kf[4 * v] + x.y * kf[4 * v + 1] + x.z * kf[4 * v + 2] +
                   x.w * kf[4 * v + 3];
            }
            dot[r] = t;
          }
#pragma unroll
          for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
            for (int r = 0; r < R; ++r) dot[r] += __shfl_xor_sync(FULL, dot[r], off);
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (vk && p0 + kk <= qend[r]) {
              const float sc = dot[r] * a.scale_log2;
              const float mn = fmaxf(m[r], sc);
              const float corr = exp2f(m[r] - mn), p = exp2f(sc - mn);
              l[r] = l[r] * corr + p;
#pragma unroll
              for (int e = 0; e < EPL; ++e) acc[r][e] = acc[r][e] * corr + p * vf[e];
              m[r] = mn;
            }
          }
        }
        __syncwarp();                           // the slot is consumed
        if (a.nstg == 1 && i + 1 < np) {
          issue(i + 1, 0);
          cp_async_commit();
        }
      }
      cp_async_wait<0>();
      // the warp's key groups merged; an empty state (m = -1e30, l = 0,
      // acc = 0) adds zeros
#pragma unroll
      for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r >= nr) continue;                // uniform over the warp
          const float mo = __shfl_xor_sync(FULL, m[r], off);
          const float lo = __shfl_xor_sync(FULL, l[r], off);
          const float mn = fmaxf(m[r], mo);
          const float c1 = exp2f(m[r] - mn), c2 = exp2f(mo - mn);
          l[r] = l[r] * c1 + lo * c2;
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            const float ao = __shfl_xor_sync(FULL, acc[r][e], off);
            acc[r][e] = acc[r][e] * c1 + ao * c2;
          }
          m[r] = mn;
        }
      }
    }
    if (wpr == 1) {                             // one warp a group: its rows are final
      if (act) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < nr) {
            if (gi == 0) {
#pragma unroll
              for (int e = 0; e < EPL; ++e) res[(r0 + r) * D + c * EPL + e] = acc[r][e];
            }
            if (lane == 0) {
              resm[r0 + r] = m[r];
              resl[r0 + r] = l[r];
            }
          }
        }
      }
      continue;
    }
    // several warps a group (one round): merged through mrg, warp order
    __syncthreads();                            // every warp is done with its ring
    if (act) {
      if (gi == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) mrg[(warp * RG + r) * D + c * EPL + e] = acc[r][e];
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          mm[warp * RG + r] = m[r];
          ml[warp * RG + r] = l[r];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < nq * D; i += NT) {
      const int rr = i / D, d = i % D, gl = rr / R, r = rr % R;
      float M = NEG_INF;
      for (int w = gl; w < npar * wpr; w += npar) M = fmaxf(M, mm[w * RG + r]);
      float L = 0.f, A = 0.f;
      for (int w = gl; w < npar * wpr; w += npar) {
        const float f = exp2f(mm[w * RG + r] - M);
        L += ml[w * RG + r] * f;
        A += mrg[(w * RG + r) * D + d] * f;
      }
      res[(base * R + rr) * D + d] = A;
      if (d == 0) {
        resm[base * R + rr] = M;
        resl[base * R + rr] = L;
      }
    }
  }
}

// The tensor-core route (16-bit): rows [0, nlive) of the tile, nlive >= 16,
// over pages [pbeg, pend) through a ring of MSTG pages. Leaves each live
// row's (m, l, acc) in res / resm / resl.
template <typename T, int D>
__device__ __forceinline__ void mma_route(const Args& a, int b, int kvh, int row0, int nlive,
                                          int qstart, int pbeg, int pend, float* res,
                                          float* resm, float* resl, unsigned char* U) {
  constexpr int LD = D + 8;      // 16-bit row stride: 16 bytes of padding
  constexpr int KS = D / 16;     // k-steps of q k^T
  constexpr int NO = D / 8;      // output tiles of 8 columns
  constexpr int CPR = D / 8;     // 16-byte chunks per row
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ kc = static_cast<const T*>(a.kc);
  const T* __restrict__ vc = static_cast<const T*>(a.vc);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int G = a.H / a.KVH, BS = a.BS;
  const int kp = BS <= 16 ? 16 : 32;            // key rows of a stage, zero-padded
  T* Qs = reinterpret_cast<T*>(U);              // [TILE][LD]
  T* Ks = Qs + TILE * LD;                       // [MSTG][kp][LD]
  T* Vs = Ks + MSTG * kp * LD;                  // [MSTG][kp][LD]
  const int wr0 = warp * 16;                    // the warp's first row in the tile
  PageIds ids{a.tables + (size_t)b * a.MAXNB, pbeg, 0, 1, pend, a.NB, -1, 0};

  for (int i = tid; i < TILE * CPR; i += NT) {
    const int r = i / CPR, cc = i % CPR;
    const bool live = r < nlive;
    const int gr = row0 + r, j = gr / G, h = kvh * G + gr % G;
    const T* src = live ? q + ((size_t)(b * a.C + j) * a.H + h) * D + cc * 8 : q;
    cp_async16(Qs + r * LD + cc * 8, src, live);
  }
  auto load_page = [&](int k, int st) {
    const size_t base = ((size_t)kvh * a.NB + ids(k)) * BS * D;
    for (int i = tid; i < kp * CPR; i += NT) {
      const int kk = i / CPR, cc = i % CPR;
      const bool live = kk < BS;                // rows past BS: zeros
      const size_t off = base + (size_t)(live ? kk : 0) * D + cc * 8;
      cp_async16(Ks + (st * kp + kk) * LD + cc * 8, kc + off, live);
      cp_async16(Vs + (st * kp + kk) * LD + cc * 8, vc + off, live);
    }
  };
  const int np = pend - pbeg;
#pragma unroll
  for (int st = 0; st < MSTG - 1; ++st) {       // the ring's first pages (q with page 0)
    if (st < np) load_page(st, st);
    cp_async_commit();
  }

  int qend[2];                                  // rows g and g + 8 of the warp
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g + 8 * h;
    qend[h] = r < nlive ? qstart + (row0 + r) / G : -1;
  }
  const int wlast = min(wr0 + 15, nlive - 1);   // the warp's last live row
  const int whor = wlast >= wr0 ? qstart + (row0 + wlast) / G : -1;

  uint32_t qf[KS][4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < np; ++it) {
    const int st = it % MSTG, p = pbeg + it;
    if (it + MSTG - 1 < np) load_page(it + MSTG - 1, (it + MSTG - 1) % MSTG);
    cp_async_commit();
    cp_async_wait<MSTG - 1>();                  // page it (and q) landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) frag_a(qf[ks], Qs, LD, wr0, 16 * ks);
    }
    const T* Kt = Ks + st * kp * LD;
    const T* Vt = Vs + st * kp * LD;
    if (p * BS <= whor) {                       // some row of the warp sees a key here
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          if (8 * j < kp) {
            uint32_t bf[4];
            frag_b2(bf, Kt, LD, 8 * j, 16 * ks);
            mma16816<T>(s[j], qf[ks], bf[0], bf[1]);
            mma16816<T>(s[j + 1], qf[ks], bf[2], bf[3]);
          }
        }
      }
      auto visible = [&](int j, int e) {
        const int kk = 8 * j + 2 * t + (e & 1);
        return kk < BS && p * BS + kk <= qend[e >> 1];
      };
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = visible(j, e) ? s[j][e] * a.scale_log2 : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
      float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {             // a row's four lanes: t = 0 .. 3
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex = visible(j, e) ? exp2f(s[j][e] - m[e >> 1]) : 0.f;
          psum[e >> 1] += ex;
          s[j][e] = ex;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        psum[h] += __shfl_xor_sync(FULL, psum[h], 1);
        psum[h] += __shfl_xor_sync(FULL, psum[h], 2);
        l[h] = corr[h] * l[h] + psum[h];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
        acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
      }
      // o += p v, p as hi + lo 16-bit A fragments built in registers
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (16 * kk < kp) {
          uint32_t ph[4], pl[4];
          split2<T>(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
          split2<T>(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
          split2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
          split2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
          for (int n = 0; n < NO; n += 2) {
            uint32_t bf[4];
            frag_b2_t(bf, Vt, LD, 8 * n, 16 * kk);
            mma16816<T>(acc[n], ph, bf[0], bf[1]);
            mma16816<T>(acc[n + 1], ph, bf[2], bf[3]);
            mma16816<T>(acc[n], pl, bf[0], bf[1]);
            mma16816<T>(acc[n + 1], pl, bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();                            // stage st is consumed
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + g + 8 * h;
    if (r < nlive) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        res[r * D + 8 * n + 2 * t] = acc[n][2 * h];
        res[r * D + 8 * n + 2 * t + 1] = acc[n][2 * h + 1];
      }
      if (t == 0) {
        resm[r] = m[h];
        resl[r] = l[h];
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, D <= 64 ? 4 : 2)
ragged_kernel(const Args a) {
  const int split = blockIdx.x;
  const int kvh = blockIdx.y % a.KVH, tile = blockIdx.y / a.KVH;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = a.H / a.KVH, span = a.C * G;
  const int row0 = tile * TILE;
  const int nrows = min(TILE, span - row0);     // rows of the tile
  const int len = a.lens[b];
  const int ql = a.qlens ? a.qlens[b] : 1;
  const int qstart = max(len - ql, 0);
  // live rows (j < q_len) are a prefix of the tile
  const int nlive = max(0, min(nrows, min(span, max(ql, 0) * G) - row0));
  int nblk = 0;
  if (len > 0 && nlive > 0) {
    nblk = min((len + a.BS - 1) / a.BS, a.MAXNB);
    nblk = min(nblk, (qstart + (row0 + nlive - 1) / G) / a.BS + 1);   // causal horizon
  }
  const int nsplit = (nblk + a.PPS - 1) / a.PPS; // live splits of the tile
  if (split >= max(nsplit, 1)) return;          // past the tile's last page
  T* __restrict__ out = static_cast<T*>(a.out);
  auto row_out = [&](int r) {                   // row r of the tile in out
    const int gr = row0 + r, j = gr / G, h = kvh * G + gr % G;
    return out + ((size_t)(b * a.C + j) * a.H + h) * D;
  };
  constexpr int C8 = D / 8;                     // 8-element chunks of a row
  if (nsplit == 0) {                            // no live row sees a key: zeros
    const float z[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < nrows * C8; i += NT) store8(row_out(i / C8) + (i % C8) * 8, z);
    return;
  }
  const int pbeg = split * a.PPS, pend = min(pbeg + a.PPS, nblk);

  extern __shared__ __align__(16) unsigned char smem[];
  float* res = reinterpret_cast<float*>(smem); // [TR][D] this split's acc per row
  float* qs = res + a.TR * D;                   // [NW * RG][D] the shuffle route's q rows
  unsigned char* U = reinterpret_cast<unsigned char*>(qs + NW * RG * D);
  float* resm = reinterpret_cast<float*>(U + a.ubytes);   // [TR]
  float* resl = resm + a.TR;                    // [TR]

  if constexpr (kIs16<T>) {
    if (nlive >= MMA_MIN_ROWS) {
      mma_route<T, D>(a, b, kvh, row0, nlive, qstart, pbeg, pend, res, resm, resl, U);
    } else {
      shuffle_route<T, D>(a, b, kvh, row0, nlive, qstart, pbeg, pend, res, resm, resl, qs, U);
    }
  } else {
    shuffle_route<T, D>(a, b, kvh, row0, nlive, qstart, pbeg, pend, res, resm, resl, qs, U);
  }
  __syncthreads();                              // res, resm, resl complete

  if (nsplit == 1) {                            // the only live split writes the output
    for (int i = tid; i < nrows * C8; i += NT) {
      const int r = i / C8, c8 = i % C8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < nlive) {
        const float lz = resl[r] == 0.f ? 1.f : resl[r];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = res[r * D + c8 * 8 + e] / lz;
      }
      store8(row_out(r) + c8 * 8, v);
    }
    return;
  }

  // the partial of this split, then the last of the tile's splits sums them
  const int ntiles = gridDim.z * gridDim.y;
  const int tix = b * gridDim.y + blockIdx.y;
  const size_t wstep = (size_t)ntiles * a.TR * D, mlstep = (size_t)ntiles * a.TR * 2;
  const float* w0 = a.ws + (size_t)tix * a.TR * D;
  const float* ml0 = a.ws + (size_t)a.S * wstep + (size_t)tix * a.TR * 2;
  float4* wacc = reinterpret_cast<float4*>(a.ws + split * wstep + (size_t)tix * a.TR * D);
  float* wml = a.ws + (size_t)a.S * wstep + split * mlstep + (size_t)tix * a.TR * 2;
  for (int i = tid; i < nlive * D / 4; i += NT) wacc[i] = reinterpret_cast<const float4*>(res)[i];
  for (int i = tid; i < nlive; i += NT) {
    wml[2 * i] = resm[i];
    wml[2 * i + 1] = resl[i];
  }
  __threadfence();
  __syncthreads();
  __shared__ int s_last;
  if (tid == 0) {
    s_last = atomicAdd(a.counters + tix, 1) == nsplit - 1;
    if (s_last) atomicExch(a.counters + tix, 0);   // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // each row's split weights 2^(m_s - max m) / l first (in res, free now:
  // nsplit <= 32 <= D), then every element's sum in split order
  float* wts = res;                             // [TR][nsplit]
  for (int r = tid; r < nlive; r += NT) {
    float M = NEG_INF;
    for (int sp = 0; sp < nsplit; ++sp) M = fmaxf(M, __ldcg(ml0 + sp * mlstep + 2 * r));
    float L = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const float f = exp2f(__ldcg(ml0 + sp * mlstep + 2 * r) - M);
      wts[r * nsplit + sp] = f;
      L += __ldcg(ml0 + sp * mlstep + 2 * r + 1) * f;
    }
    const float lz = L == 0.f ? 1.f : L;
    for (int sp = 0; sp < nsplit; ++sp) wts[r * nsplit + sp] /= lz;
  }
  __syncthreads();
  for (int i = tid; i < nrows * C8; i += NT) {
    const int r = i / C8, c8 = i % C8;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < nlive) {
#pragma unroll 4
      for (int sp = 0; sp < nsplit; ++sp) {     // split order: deterministic
        const float w = wts[r * nsplit + sp];
        const float4* src = reinterpret_cast<const float4*>(w0 + sp * wstep + r * D + c8 * 8);
        const float4 x0 = __ldcg(src), x1 = __ldcg(src + 1);
        v[0] += x0.x * w; v[1] += x0.y * w; v[2] += x0.z * w; v[3] += x0.w * w;
        v[4] += x1.x * w; v[5] += x1.y * w; v[6] += x1.z * w; v[7] += x1.w * w;
      }
    }
    store8(row_out(r) + c8 * 8, v);
  }
}

int round16(size_t n) { return (int)((n + 15) / 16 * 16); }

template <typename T, int D>
int launch_t(Args a, int B, cudaStream_t stream) {
  const size_t page2 = (size_t)a.BS * D * sizeof(T) * 2;          // a page of K and V
  const size_t merge = (size_t)NW * RG * (D + 2) * sizeof(float);
  // the mma route's q tile and ring, where a tile can hold 16 live rows
  const int kp = a.BS <= 16 ? 16 : 32;
  const size_t tc = kIs16<T> && a.C * (a.H / a.KVH) >= MMA_MIN_ROWS
      ? (size_t)(TILE + 2 * MSTG * kp) * (D + 8) * sizeof(T) : 0;
  const size_t fixed = ((size_t)a.TR * (D + 2) + NW * RG * D) * sizeof(float);
  auto shared_u = [&](int nstg) {
    size_t u = (size_t)NW * nstg * page2;
    if (merge > u) u = merge;
    if (tc > u) u = tc;
    return round16(u);
  };
  a.nstg = fixed + shared_u(2) <= (size_t)SMEM_LIMIT ? 2 : 1;
  a.ubytes = shared_u(a.nstg);
  const size_t smem = fixed + a.ubytes;
  auto kern = ragged_kernel<T, D>;
  // the dynamic shared-memory limit, raised once per device and size
  static int granted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && !(dev < 64 && granted[dev] >= (int)smem)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) granted[dev] = (int)smem;
  }
  dim3 grid(a.S, a.KVH * a.TILES, B);
  kern<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_t<T, 32>(a, B, stream);
    case 64: return launch_t<T, 64>(a, B, stream);
    case 128: return launch_t<T, 128>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Largest cache block size the kernel takes (the wrapper checks it).
int ragged_paged_attention_max_block_size() { return MAX_BS; }

// Version of the launch's argument list: 2 takes a workspace, counters and
// the split plan (version 1 had neither).
int ragged_paged_attention_abi() { return 2; }

// dtype: 0 float32, 1 bfloat16, 2 float16. qlens may be NULL (decode).
// splits (at most 32) x pages_per_split must cover MAXNB; with splits > 1, ws holds
// splits x B x KVH x ceil(C*G / 64) x min(64, C*G) x (D + 2) floats and
// counters one zeroed int per (sequence, kv head, row tile), which the
// kernel leaves zeroed. q, k and v must be 16-byte aligned. Returns the
// CUDA error code of the launch (0 on success).
int ragged_paged_attention_launch(int dtype, const void* q, const void* kc,
                                  const void* vc, const int* tables,
                                  const int* lens, const int* qlens,
                                  void* out, void* ws, void* counters, int B,
                                  int C, int H, int KVH, int NB, int BS,
                                  int MAXNB, int D, int splits,
                                  int pages_per_split, float scale,
                                  void* stream) {
  if (BS < 1 || BS > MAX_BS || KVH < 1 || H % KVH != 0 || splits < 1 ||
      splits > MAX_SPLITS || pages_per_split < 1 ||
      (long long)splits * pages_per_split < MAXNB ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || C == 0) return 0;
  const int span = C * (H / KVH);
  Args a{};
  a.q = q; a.kc = kc; a.vc = vc;
  a.tables = tables; a.lens = lens; a.qlens = qlens;
  a.out = out; a.ws = (float*)ws; a.counters = (int*)counters;
  a.C = C; a.H = H; a.KVH = KVH; a.NB = NB; a.BS = BS; a.MAXNB = MAXNB;
  a.TILES = (span + TILE - 1) / TILE;
  a.TR = span < TILE ? span : TILE;
  a.S = splits; a.PPS = pages_per_split;
  a.scale_log2 = scale * LOG2E;
  if ((long long)KVH * a.TILES > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_d<float>(a, B, D, s);
    case 1: return launch_d<__nv_bfloat16>(a, B, D, s);
    case 2: return launch_d<__half>(a, B, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
