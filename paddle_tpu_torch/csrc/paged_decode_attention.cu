// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_decode_kernel`
// (paddle_tpu/ops/pallas/paged_attention.py:74, reached through
// `paged_attention` :118, pallas_call at :157): one query token per
// sequence attends over its paged KV cache, online softmax in f32.
//
// Layouts (the JAX package's, kept at the port's public function):
//   q       [B, H, D]           one query row per (sequence, head)
//   k/v     [KVH, NB, BS, D]    paged caches
//   tables  [B, MAXNB] int32    block ids of each sequence
//   lens    [B] int32           context length of each sequence
//   out     [B, H, D]
//
// What it computes (the Pallas body, :74-115): query heads h*G .. h*G+G-1
// read kv head h; s = (q . k) * scale in f32 over the positions below ctx;
// an online softmax in f32 with l == 0 read as one, so a row with ctx 0
// returns exact zeros; only the first min(ceil(ctx / BS), MAXNB) pages are
// walked (an over-capacity ctx attends over the table's capacity), and
// every id is clamped into [0, NB) before a read, so a -1 free-slot id
// never faults. p is never rounded.
//
// What bounds it: bytes, and at decode their latency. Each (sequence, kv
// head) reads its KV once for 4*G*D flops a key, about G flops a byte of
// bf16 cache, far below the ~295 at which the card's tensor cores would
// set the pace, so the arithmetic runs on CUDA cores in f32. At the
// serving cache a call moves a few MB, a microsecond or two of the card's
// bytes: what costs time is how few SMs a (sequence, kv head) grid keeps
// busy and the chain of dependent steps each block takes.
//
// Design. The TPU grid (b, kv head, MAXNB) runs in order and carries m / l
// / acc in scratch from one block-table column to the next. Hopper blocks
// run in parallel and in no order. Here a block is (split, kv head,
// sequence), 4 warps:
//
// * The split. The host's plan (`ops.paged_attention.decode_plan`, from
//   shapes alone, the split rule of the ragged kernel's plan) cuts the
//   page walk into S splits of P pages where B x KVH blocks would not
//   cover the SMs twice (B=8, KVH=8, MAXNB=32: 8 splits of 4 pages, 512
//   blocks in place of 64). A block reads its sequence's length and the
//   split's first 32 block-table ids in one go, before it knows which of
//   them its walk uses; a split past the sequence's last page returns at
//   once and writes nothing.
// * Chunks. A page of up to 128 keys is streamed in chunks of at most 32
//   key rows (fewer where a row is wide: a stage of k and v holds at most
//   8 KB), so shared memory does not grow with BS. Each warp takes every
//   wpr-th chunk of the split through its own two-stage cp.async ring, in
//   the cache's own type, 16-byte copies.
// * Rows. The G query rows of the kv head go in groups of R rows kept in
//   registers (R = 1, 2 or 4 from G for 16-bit caches; up to 8 for f32),
//   one group a warp, or, where fewer groups than warps are live, several
//   warps a group, each taking every wpr-th chunk: at G = 1 or 2 all four
//   warps walk the one group. q is read once into registers with
//   scale * log2(e) folded in, so scores are in log2 units and the
//   exponent is exp2f.
// * Dot products. D/8 (16-bit) or D/4 (f32) lanes hold a key row's 16-byte
//   pieces; a score is each lane's part, then warp shuffles, for every row
//   of the group at once (independent chains). Every key group of a warp
//   keeps its own online softmax in registers; they merge over shuffles at
//   the end of the split, then the warps of a group through shared memory
//   in warp order.
// * The combine, in the same launch. A sequence with one live split writes
//   its output directly. Otherwise each live split writes its f32 partial
//   (m, l, acc[G][D], log2 units) to a workspace, and the block that counts
//   itself last on the (sequence, kv head) counter (an atomic after
//   __threadfence()) sets the counter back to zero (no memset runs a call)
//   and sums the partials in split order with weights 2^(m_s - max m):
//   two calls give bit-equal outputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <type_traits>

#include "mma_tiles.cuh"   // cp.async helpers, pack2

namespace {

constexpr int NT = 128;             // threads per block
constexpr int NW = NT / 32;         // warps per block
constexpr int MAX_BS = 128;         // largest cache block size supported
constexpr int MAX_SPLITS = 32;      // most splits of a plan
constexpr int NSTG = 2;             // chunks in a warp's ring
constexpr int STAGE_BYTES = 8192;   // most bytes of k and v in one stage
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
constexpr bool kIs16 = !std::is_same<T, float>::value;
// key rows of a chunk at most: 32, fewer where a stage would pass 8 KB
template <typename T, int D>
constexpr int kChunk = STAGE_BYTES / (2 * D * (int)sizeof(T)) < 32
                           ? STAGE_BYTES / (2 * D * (int)sizeof(T)) : 32;

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

// 16 bytes of T from f32 values
__device__ __forceinline__ void store16(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
template <typename T>
__device__ __forceinline__ void store16(T* dst, const float (&v)[8]) {
  uint4 u;
  u.x = pack2<T>(v[0], v[1]);
  u.y = pack2<T>(v[2], v[3]);
  u.z = pack2<T>(v[4], v[5]);
  u.w = pack2<T>(v[6], v[7]);
  *reinterpret_cast<uint4*>(dst) = u;
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

struct Args {
  const void* q;
  const void* kc;
  const void* vc;
  const int* tables;
  const int* lens;
  void* out;
  float* ws;        // S > 1: [S][B*KVH][G][D] acc, then [S][B*KVH][G][2] m, l
  int* counters;    // S > 1: one per (sequence, kv head), zero between launches
  int H, KVH, NB, BS, MAXNB;
  int S, PPS;       // splits of the page walk, pages per split
  int CK;           // key rows of a chunk: min(BS, kChunk)
  float scale_log2; // softmax scale times log2(e): scores in log2 units
};

// The block-table ids of the split's pages pbeg + k, k = 0, 1, ...: lane i
// holds the id of page pbeg + 32 * chunk + i, clamped into [0, NB) (a -1
// free-slot id never faults). Called by every lane of the warp, k never
// decreasing; the first 32 are read before the walk (`read(0)`).
struct PageIds {
  const int* trow;
  int pbeg, pend, NB, chunk, id;
  __device__ __forceinline__ void read(int ch) {
    chunk = ch;
    const int p = pbeg + (ch << 5) + threadIdx.x % 32;
    id = p < pend ? min(max(trow[p], 0), NB - 1) : 0;
  }
  __device__ __forceinline__ int operator()(int k) {
    if ((k >> 5) != chunk) read(k >> 5);
    return __shfl_sync(FULL, id, k & 31);
  }
};

template <typename T, int D, int R>
__global__ void __launch_bounds__(NT, 4)
paged_decode_kernel(const Args a) {
  constexpr int EPL = 16 / sizeof(T);   // elements in 16 bytes
  constexpr int LPK = D / EPL;          // lanes per key row
  constexpr int KPP = 32 / LPK;         // key rows per warp pass
  constexpr int C4 = D / 4;             // 4-column pieces of a row
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ kc = static_cast<const T*>(a.kc);
  const T* __restrict__ vc = static_cast<const T*>(a.vc);
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = lane % LPK, gi = lane / LPK;
  const int G = a.H / a.KVH, BS = a.BS;
  const int nrg = (G + R - 1) / R;      // row groups
  const int npar = min(nrg, NW);        // row groups at once
  const int wpr = NW / npar;            // warps on one group
  const int phase = warp / npar;        // the warp's first chunk of the split
  const size_t row0 = ((size_t)b * a.H + (size_t)kvh * G) * D;   // the kv head's rows

  // the warp's q rows of a round, times scale * log2(e), in registers
  float qf[R][EPL];
  auto load_q = [&](int base) {
    const int rg = base + warp % npar;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = rg * R + r;
      if (rg < nrg && row < G) {
        load16(qf[r], q + row0 + (size_t)row * D + c * EPL);
#pragma unroll
        for (int e = 0; e < EPL; ++e) qf[r][e] *= a.scale_log2;
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) qf[r][e] = 0.f;
      }
    }
  };
  // the length, the split's first ids and the first round's q, all at once
  const int pbeg = split * a.PPS;
  PageIds ids{a.tables + (size_t)b * a.MAXNB, pbeg, min(pbeg + a.PPS, a.MAXNB), a.NB, 0, 0};
  ids.read(0);
  load_q(0);
  const int ctx = a.lens[b];
  const int nblk = ctx > 0 ? min((ctx + BS - 1) / BS, a.MAXNB) : 0;
  const int nsplit = (nblk + a.PPS - 1) / a.PPS;   // live splits
  if (split >= max(nsplit, 1)) return;             // past the last page
  T* __restrict__ out = static_cast<T*>(a.out) + row0;
  if (nsplit == 0) {                               // ctx 0: exact zeros
    for (int i = tid; i < G * D; i += NT) out[i] = from_f<T>(0.f);
    return;
  }
  const int pend = min(pbeg + a.PPS, nblk);
  const int kend = min(pend * BS, ctx);            // positions [pbeg*BS, kend)
  const int CK = a.CK, cpp = (BS + CK - 1) / CK;   // chunk rows, chunks a page
  const int nch = (pend - pbeg - 1) * cpp + (kend - (pend - 1) * BS + CK - 1) / CK;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem) + (size_t)warp * NSTG * 2 * CK * D;
  float* mrg = reinterpret_cast<float*>(smem);     // [NW][R][D], aliasing the rings
  float* mm = mrg + NW * R * D;                    // [NW][R]
  float* ml = mm + NW * R;                         // [NW][R]

  const int nbk = gridDim.y * gridDim.z;           // B * KVH
  const int tix = b * a.KVH + kvh;
  float* wacc = a.ws + ((size_t)split * nbk + tix) * G * D;
  float* wml = a.ws + (size_t)a.S * nbk * G * D + ((size_t)split * nbk + tix) * G * 2;
  const bool one = nsplit == 1;

  for (int base = 0; base < nrg; base += npar) {
    if (base > 0) {
      __syncthreads();                             // rings and mrg are free
      load_q(base);
    }
    const int nq = min(G - base * R, npar * R);    // rows of the round
    const int rg = base + warp % npar;
    const bool act = warp < npar * wpr && rg < nrg;
    const int nr = act ? min(R, G - rg * R) : 0;
    float m[R], l[R], acc[R][EPL];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
    }
    if (act) {
      const int nmy = nch > phase ? (nch - phase + wpr - 1) / wpr : 0;   // the warp's chunks
      auto issue = [&](int i) {
        const int ci = phase + i * wpr, sub = ci % cpp;
        const int rows = min(CK, BS - sub * CK);
        const size_t src = (((size_t)kvh * a.NB + ids(ci / cpp)) * BS + (size_t)sub * CK) * D;
        T* ks = ring + (i % NSTG) * 2 * CK * D;
        for (int e = lane * EPL; e < rows * D; e += 32 * EPL) {
          cp_async16(ks + e, kc + src + e, true);
          cp_async16(ks + CK * D + e, vc + src + e, true);
        }
      };
#pragma unroll
      for (int st = 0; st < NSTG - 1; ++st) {      // the ring's first chunks
        if (st < nmy) issue(st);
        cp_async_commit();
      }
      for (int i = 0; i < nmy; ++i) {
        if (i + NSTG - 1 < nmy) issue(i + NSTG - 1);   // lands while i is used
        cp_async_commit();
        cp_async_wait<NSTG - 1>();
        __syncwarp();
        const T* ks = ring + (i % NSTG) * 2 * CK * D;
        const T* vs = ks + CK * D;
        const int ci = phase + i * wpr, sub = ci % cpp;
        const int p0 = (pbeg + ci / cpp) * BS + sub * CK;   // the chunk's first position
        const int rows = min(min(CK, BS - sub * CK), kend - p0);   // live key rows
        for (int k0 = 0; k0 < rows; k0 += KPP) {
          const int kk = k0 + gi;
          const bool vk = kk < rows;
          float kf[EPL], vf[EPL];
          if (vk) {
            load16(kf, ks + kk * D + c * EPL);
            load16(vf, vs + kk * D + c * EPL);
          } else {
#pragma unroll
            for (int e = 0; e < EPL; ++e) kf[e] = vf[e] = 0.f;
          }
          float dot[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float t = 0.f;
#pragma unroll
            for (int e = 0; e < EPL; ++e) t += qf[r][e] * kf[e];
            dot[r] = t;
          }
#pragma unroll
          for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
            for (int r = 0; r < R; ++r) dot[r] += __shfl_xor_sync(FULL, dot[r], off);
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (vk && r < nr) {
              const float mn = fmaxf(m[r], dot[r]);
              const float corr = exp2f(m[r] - mn), p = exp2f(dot[r] - mn);
              l[r] = l[r] * corr + p;
#pragma unroll
              for (int e = 0; e < EPL; ++e) acc[r][e] = acc[r][e] * corr + p * vf[e];
              m[r] = mn;
            }
          }
        }
        __syncwarp();                              // the slot is consumed
      }
      cp_async_wait<0>();
      // the warp's key groups merged; an empty state (m = -1e30, l = 0,
      // acc = 0) adds zeros
#pragma unroll
      for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r >= nr) continue;                   // uniform over the warp
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
    if (wpr == 1) {                                // one warp a group: its rows are final
      if (act && gi == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r >= nr) continue;
          const int row = rg * R + r;
          float v[EPL];
          if (one) {
            const float lz = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
            for (int e = 0; e < EPL; ++e) v[e] = acc[r][e] / lz;
            store16(out + (size_t)row * D + c * EPL, v);
          } else {
#pragma unroll
            for (int e = 0; e < EPL; e += 4) {
              float w[4] = {acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]};
              store16(wacc + (size_t)row * D + c * EPL + e, w);
            }
            if (c == 0) {
              wml[2 * row] = m[r];
              wml[2 * row + 1] = l[r];
            }
          }
        }
      }
      continue;
    }
    // several warps a group (one round): merged through mrg in warp order
    __syncthreads();                               // every warp is done with its ring
    if (act) {
      if (gi == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) mrg[(warp * R + r) * D + c * EPL + e] = acc[r][e];
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          mm[warp * R + r] = m[r];
          ml[warp * R + r] = l[r];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < nq * D; i += NT) {
      const int rr = i / D, d = i % D, gl = rr / R, r = rr % R;
      const int row = base * R + rr;
      float M = NEG_INF;
      for (int w = gl; w < npar * wpr; w += npar) M = fmaxf(M, mm[w * R + r]);
      float L = 0.f, A = 0.f;
      for (int w = gl; w < npar * wpr; w += npar) {
        const float f = exp2f(mm[w * R + r] - M);
        L += ml[w * R + r] * f;
        A += mrg[(w * R + r) * D + d] * f;
      }
      if (one) {
        out[(size_t)row * D + d] = from_f<T>(A / (L == 0.f ? 1.f : L));
      } else {
        wacc[(size_t)row * D + d] = A;
        if (d == 0) {
          wml[2 * row] = M;
          wml[2 * row + 1] = L;
        }
      }
    }
  }
  if (one) return;

  // this split's partial is out; the last of the sequence's splits sums them
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
  const size_t wstep = (size_t)nbk * G * D, mlstep = (size_t)nbk * G * 2;
  const float* w0 = a.ws + (size_t)tix * G * D;
  const float* ml0 = a.ws + (size_t)a.S * wstep + (size_t)tix * G * 2;
  for (int i = tid; i < G * C4; i += NT) {
    const int r = i / C4, c4 = i % C4;
    float M = NEG_INF;
    for (int sp = 0; sp < nsplit; ++sp) M = fmaxf(M, __ldcg(ml0 + sp * mlstep + 2 * r));
    float L = 0.f;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int sp = 0; sp < nsplit; ++sp) {          // split order: deterministic
      const float f = exp2f(__ldcg(ml0 + sp * mlstep + 2 * r) - M);
      L += __ldcg(ml0 + sp * mlstep + 2 * r + 1) * f;
      const float4 x = __ldcg(reinterpret_cast<const float4*>(w0 + sp * wstep + r * D) + c4);
      v[0] += x.x * f; v[1] += x.y * f; v[2] += x.z * f; v[3] += x.w * f;
    }
    const float lz = L == 0.f ? 1.f : L;
    T* o = out + (size_t)r * D + c4 * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = from_f<T>(v[e] / lz);
  }
}

template <typename T, int D, int R>
int launch_t(Args a, int B, cudaStream_t stream) {
  a.CK = a.BS < kChunk<T, D> ? a.BS : kChunk<T, D>;
  const size_t ring = (size_t)NW * NSTG * 2 * a.CK * D * sizeof(T);
  const size_t merge = (size_t)NW * R * (D + 2) * sizeof(float);
  const size_t smem = ring > merge ? ring : merge;
  auto kern = paged_decode_kernel<T, D, R>;
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
  dim3 grid(a.S, a.KVH, B);
  kern<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// rows of a group: G itself up to 4 (no idle row at G = 1, 2 or 4), else
// 4 (16-bit) or 8 (f32) a group
template <typename T, int D>
int launch_r(const Args& a, int B, cudaStream_t stream) {
  const int G = a.H / a.KVH;
  if (G == 1) return launch_t<T, D, 1>(a, B, stream);
  if (G == 2) return launch_t<T, D, 2>(a, B, stream);
  if constexpr (!kIs16<T>) {
    if (G > 4) return launch_t<T, D, 8>(a, B, stream);
  }
  return launch_t<T, D, 4>(a, B, stream);
}

template <typename T>
int launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_r<T, 32>(a, B, stream);
    case 64: return launch_r<T, 64>(a, B, stream);
    case 128: return launch_r<T, 128>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Largest cache block size the kernel takes (the wrapper checks it).
int paged_decode_attention_max_block_size() { return MAX_BS; }

// Version of the launch's argument list: 2 takes a workspace, counters and
// the split plan (version 1 had neither).
int paged_decode_attention_abi() { return 2; }

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, caches and out). splits (at
// most 32) x pages_per_split must cover MAXNB; with splits > 1, ws holds
// splits x B x H x (D + 2) floats and counters one zeroed int per
// (sequence, kv head), which the kernel leaves zeroed. q, k and v must be
// 16-byte aligned. Returns the CUDA error code of the launch (0 on
// success).
int paged_decode_attention_launch(int dtype, const void* q, const void* kc,
                                  const void* vc, const int* tables,
                                  const int* lens, void* out, void* ws,
                                  void* counters, int B, int H, int KVH,
                                  int NB, int BS, int MAXNB, int D,
                                  int splits, int pages_per_split,
                                  float scale, void* stream) {
  if (BS < 1 || BS > MAX_BS || KVH < 1 || H % KVH != 0 || NB < 1 ||
      MAXNB < 1 || splits < 1 || splits > MAX_SPLITS || pages_per_split < 1 ||
      (long long)splits * pages_per_split < MAXNB ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  if (KVH > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q; a.kc = kc; a.vc = vc;
  a.tables = tables; a.lens = lens;
  a.out = out; a.ws = (float*)ws; a.counters = (int*)counters;
  a.H = H; a.KVH = KVH; a.NB = NB; a.BS = BS; a.MAXNB = MAXNB;
  a.S = splits; a.PPS = pages_per_split;
  a.scale_log2 = scale * LOG2E;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_d<float>(a, B, D, s);
    case 1: return launch_d<__nv_bfloat16>(a, B, D, s);
    case 2: return launch_d<__half>(a, B, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
