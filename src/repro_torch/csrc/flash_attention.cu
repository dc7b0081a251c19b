// Flash-attention forward for Hopper (sm_90a), fp32 softmax statistics.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` (_fa_kernel) of
// src/repro/kernels/flash_attention/kernel.py, together with the fold of
// its wrapper (src/repro/kernels/flash_attention/ops.py).  q is
// (B, S, Hq, HD), k and v (B, S, Hkv, HD) with Hq = g * Hkv, o is
// (B, S, Hq, HD); each is read through element strides of its batch,
// sequence and head axes (the head dim has stride 1), so the model's
// layout is read and written in place: query head h reads key/value
// head h / g, the function of the JAX wrapper's broadcast_to + reshape
// without its copies.  float32 or bfloat16 (widened to fp32 on load);
// scores are fp32 q.k times `scale`, with optional causal (k <= q) and
// sliding-window (q - k < window) masks; the output is
// acc / max(l, 1e-30) in q's dtype.  The (BH, S, HD) layout of the TPU
// kernel is the case H = 1.
//
// Bound on the H100 at the funnel's labelling shape (B = 128 000 rows of
// S = 21, H = 8, HD = 4, fp32): q, k, v read once and o written once are
// 4 x 1.024 M x 21 x 4 x 4 B = 1.376 GB, 0.41 ms at 3.35 TB/s; the
// 4 S^2 HD operations per (row, head) are 7.2 GFLOP, 0.11 ms at 67 TFLOP/s
// fp32.  Bytes bound it, and tensor cores buy nothing at HD = 4.  At the
// LM's prefill shapes (B 8, S 4096, Hq 32, bf16, causal) operations bound
// it: the causal half's 2 B Hq S^2 HD operations are 5.50e11 at
// tinyllama-1.1b's (Hkv 4, HD 64), 0.556 ms at 989 TFLOP/s bf16, and
// 1.10e12 at qwen3-4b's (Hkv 8, HD 128), 1.112 ms; the bytes (q, k, v
// and o once: 302 and 335 MB) take 0.090 and 0.100 ms.
//
// Two paths; the general one has two routes.
//
// * Short path (S <= SHORT_MAX_S, HD <= SHORT_MAX_HD): the funnel's case.
//   What held the first kernel at 35% of the byte bound was the way it
//   fed the cores, not the arithmetic: 85 000 short blocks each staged
//   K and V with 4-byte loads, then waited at a barrier with nothing in
//   flight, and its online softmax took a divergent rescale branch.
//   Here a group is a span of whole batch rows (S * H * HD elements
//   each), and persistent blocks (as many as fit on the SMs, each
//   walking groups gridDim.x apart) keep a ring of STAGES groups in
//   shared memory.  On the bulk route one thread fills a stage with 1-D
//   bulk async copies (cp.async.bulk, completion on an mbarrier): one
//   copy a tensor when the group's rows are contiguous, one a row when
//   the batch stride leaves gaps.  So the next groups' Q, K and V are in
//   flight while this group computes, and loads cost no thread
//   instructions.  A thread owns QPT = 2 query rows of one head: it reads
//   each q as one 16-byte load (HD = 4, fp32) with scale * log2(e)
//   folded in, computes all S scores into registers (max first), then
//   p = exp2(s - max) (one MUFU instruction), their sum and P.V in a
//   second pass: no rescale and no divergent branch.  Each K and V load
//   serves the thread's QPT rows.  The key loops are unrolled to SMAX,
//   S rounded up to 8, with no branch, so the compiler schedules the loads
//   ahead of their use (a branch per key put each load in its own basic
//   block and a load latency on every key); keys past S re-read key
//   S - 1 and score -inf.  Without a mask SMAX is S rounded up to 8; a
//   causal or windowed call (no path makes one) takes SMAX = SHORT_MAX_S
//   with every key index clamped to S - 1, which keeps the build to one
//   masked instantiation per head dim and dtype.  o is written as one
//   16-byte store a row; neighbouring threads own neighbouring heads, so
//   a warp's stores are contiguous.  Builds of this file with the compute
//   or the copies cut out, timed on an H100 at the funnel's shape, put
//   the compute alone above the copies alone: the instructions per
//   (query, key) pair, not the bytes, set the kernel's time, and the ring
//   overlaps the two.  When the strides give no
//   16-byte aligned contiguous rows (a sliced head dim, a broadcast
//   operand), the loads route stages each group through the same ring
//   with plain loads, 16 bytes a thread where the alignment allows: the
//   same compute, one stage, a barrier between load and compute.
//   flash_attention_launch picks the path and the route from the shape
//   and the operands' strides and alignment, and reports which it took.
//
// * General path (long S or HD up to 128: the LM shapes), route
//   general: a group of G threads owns one query row, each holding
//   DPT = HD / G (at most 8) of
//   its query and accumulator dims in registers and summing its partial
//   dot products with warp shuffles; a block owns `rows` query rows of
//   `bpb` consecutive (batch, head) pairs, walks the kv tiles itself
//   (the TPU grid's sequential kv axis) with K and V tiles in shared
//   memory, and keeps an online softmax in fp32.  The tiles are staged
//   16 bytes a load where the strides and addresses allow (one element a
//   load otherwise), from each (batch, head)'s K and V offsets computed
//   once per block.  The causal and window
//   masks apply per element; kv tiles no row of the block can reach are
//   never loaded.  A masked key is skipped, where the TPU kernel adds
//   exp(-1e30 - m) = 0 once a live key has been seen: the same result,
//   since every row reaches its own diagonal key.  This route runs on
//   the CUDA cores, so it stays for what the tensor-core route does not
//   take: float32 (which must stay within 2e-5; TF32 would not), head
//   dims other than 64 and 128, and operands TMA cannot address.
//
// * General path on the tensor cores (route general_tc: bf16, HD 64 or
//   128, q, k and v addressable by TMA: 16-byte aligned bases and byte
//   strides that are multiples of 16 on every axis longer than 1).  A
//   work item is 128 query positions of one query head; the g query
//   heads of one KV head at one query tile are adjacent items, so their
//   K and V tiles come from L2, and the last (heaviest causal) query
//   tiles come first.  Blocks are persistent, one an SM, each walking
//   items gridDim.x apart.  Warpgroup 2 produces: one thread loads each
//   item's Q tile once and keeps a ring of TC_STAGES (K, V) tiles of 128
//   keys in flight with TMA (4-D tensor maps (HD, H, S, B) over the
//   operands' own strides, encoded on the host per call; 128-byte
//   swizzle; at HD = 128 a row is two boxes of 64 columns; completion on
//   mbarriers; keys past S arrive as zeros).  The ring runs on across
//   items, so the next item's Q and first tiles load while this one's
//   last tiles and epilogue run (`kernels/flash_attention/cutouts.py`
//   times a build with a block an item against it).  Warpgroups 0 and 1
//   consume, 64 query rows each,
//   with registers moved to them by setmaxnreg: S = Q.K^T is one
//   `wgmma` m64n128k16 per 16 dims (bf16 in, f32 out, both K-major);
//   the online softmax runs in registers, each row's max over the 4
//   threads that hold it, p = 2^(s scale log2(e) - max), O rescaled once
//   a tile; P is packed in registers into the bf16 A fragments of
//   O += P.V (`wgmma` with A from registers, V MN-major through the
//   transpose bit).  Tile t's Q.K^T is issued beside tile t - 1's P.V,
//   and its softmax runs while P.V is in flight.  Masks apply per
//   element only on tiles that reach S, the causal diagonal or the
//   window's far end; a row with no live key yet keeps max -inf and
//   subtracts 0, so no -inf - -inf is formed.  Tiles above the diagonal
//   or wholly outside the window are never loaded.  The output is
//   O / max(l, 1e-30) in bf16, stored through o's strides; rows past S
//   are not written.  One rounding point is new: P is cast to bf16 as
//   the PV product's A operand, where the Pallas kernel keeps it in
//   fp32; the reference model path rounds there too (`_attend_block`,
//   src/repro/models/attention.py, which casts its normalised
//   probabilities; here the unnormalised p in [0, 1] are cast and the
//   row sums stay fp32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cmath>
#include <initializer_list>
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_THREADS = 256;
constexpr int SMEM_FLOATS = 8192;    // general path: K + V tiles, 32 KB
constexpr int MAX_DEVICES = 64;      // devices whose opt-in is remembered

// The short path: its caps, the ring (STAGES groups of STAGE_BYTES of Q,
// K and V), and the query rows a thread owns.
constexpr int SHORT_MAX_S = 32;
constexpr int SHORT_MAX_HD = 16;
constexpr int STAGE_BYTES = 32 * 1024;
constexpr int STAGES = 3;
constexpr int SHORT_THREADS = 256;
constexpr int QPT = 2;
constexpr int SHORT_SMEM_MAX = STAGES * (STAGE_BYTES + 48);

// route codes that flash_attention_launch reports
constexpr int ROUTE_GENERAL = 0;
constexpr int ROUTE_SHORT_BULK = 1;
constexpr int ROUTE_SHORT_LOADS = 2;
constexpr int ROUTE_GENERAL_TC = 3;

struct Strides {
  long long b, s, h;  // elements; the head dim has stride 1
};

template <typename T>
struct Operands {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  Strides qs, ks, vs, os;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as JAX's astype
}

__device__ __forceinline__ void unpack(uint32_t w, float* out, float) {
  out[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(uint32_t w, float* out,
                                       __nv_bfloat16) {
  out[0] = __uint_as_float(w << 16);           // the lower address
  out[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack(const float* x, float) {
  return __float_as_uint(x[0]);
}
__device__ __forceinline__ uint32_t pack(const float* x, __nv_bfloat16) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x[0], x[1]);  // .x is lower
  return *reinterpret_cast<uint32_t*>(&h);
}

// HD elements as fp32 (a (row, position, head) chunk of the short path,
// a piece of one on the general path): 8 or 16 bytes a load.  `src` is
// aligned to min(16, chunk bytes).
template <int HD, typename T>
__device__ __forceinline__ void load_chunk(const T* src, float* out) {
  constexpr int BYTES = HD * sizeof(T);
  constexpr int PER_WORD = 4 / sizeof(T);
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 w = reinterpret_cast<const uint4*>(src)[i];
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        unpack(ws[k], out + (i * 4 + k) * PER_WORD, T());
    }
  } else {
    static_assert(BYTES == 8, "a chunk is 8 bytes or a multiple of 16");
    const uint2 w = *reinterpret_cast<const uint2*>(src);
    unpack(w.x, out, T());
    unpack(w.y, out + PER_WORD, T());
  }
}

template <int HD, typename T>
__device__ __forceinline__ void store_chunk(T* dst, const float* x) {
  constexpr int BYTES = HD * sizeof(T);
  constexpr int PER_WORD = 4 / sizeof(T);
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      uint4 w;
      w.x = pack(x + (i * 4 + 0) * PER_WORD, T());
      w.y = pack(x + (i * 4 + 1) * PER_WORD, T());
      w.z = pack(x + (i * 4 + 2) * PER_WORD, T());
      w.w = pack(x + (i * 4 + 3) * PER_WORD, T());
      reinterpret_cast<uint4*>(dst)[i] = w;
    }
  } else {
    uint2 w;
    w.x = pack(x, T());
    w.y = pack(x + PER_WORD, T());
    *reinterpret_cast<uint2*>(dst) = w;
  }
}

// ------------------------------------------------------------ general --

template <int HD>
struct Split {
  static constexpr int DPT = HD < 8 ? HD : 8;  // dims per thread
  static constexpr int G = HD / DPT;           // threads per query row
};

template <int HD, typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    fa_kernel(Operands<T> p, long long BH, int S, int Hq, int g, int bpb,
              int rows, int n_qt, int tkv, float scale, int causal,
              int window, int vec) {
  constexpr int DPT = Split<HD>::DPT;
  constexpr int G = Split<HD>::G;
  // K and V elements staged by one load where `vec` allows: 16 bytes
  // (8 at HD = 4 in bf16)
  constexpr int C = HD < 16 / (int)sizeof(T) ? HD : 16 / (int)sizeof(T);
  extern __shared__ float smem[];
  float* ks = smem;                  // [bpb][tkv][HD]
  float* vs = smem + bpb * tkv * HD;
  // [bpb][2]: the element offsets of each (batch, head)'s K and V
  long long* kvbase = reinterpret_cast<long long*>(vs + bpb * tkv * HD);

  const int qt = blockIdx.x % n_qt;
  const long long bh0 = (long long)(blockIdx.x / n_qt) * bpb;
  const int t = threadIdx.x;
  const int grp = t / G;
  const int lane_g = t % G;
  int lb = grp / rows;               // this thread's bh within the block
  const int q_lo = qt * rows;
  const int qi = q_lo + grp % rows;
  const long long bh = bh0 + lb;
  const bool valid = lb < bpb && bh < BH && qi < S;
  if (lb >= bpb) lb = bpb - 1;       // keep smem reads in range; unused

  // keys that any query row [q_lo, q_hi] of this block may see
  const int q_hi = min(S, q_lo + rows) - 1;
  const int kv_hi = causal ? q_hi + 1 : S;
  const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const long long n_bh = min((long long)bpb, BH - bh0);
  for (int i = t; i < n_bh; i += blockDim.x) {
    const long long bhe = bh0 + i;
    const long long be = bhe / Hq;
    const long long hk = (bhe - be * Hq) / g;
    kvbase[2 * i] = be * p.ks.b + hk * p.ks.h;
    kvbase[2 * i + 1] = be * p.vs.b + hk * p.vs.h;
  }

  const long long b = bh / Hq;
  const int h = (int)(bh - b * Hq);
  float qr[DPT], acc[DPT];
  const long long qoff = b * p.qs.b + (long long)qi * p.qs.s
                         + (long long)h * p.qs.h + lane_g * DPT;
#pragma unroll
  for (int d = 0; d < DPT; ++d) {
    qr[d] = valid ? to_f(p.q[qoff + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  for (int j0 = kv_lo; j0 < kv_hi; j0 += tkv) {
    const int nj = min(tkv, kv_hi - j0);
    const int per_bh = nj * HD;
    __syncthreads();                 // the previous tile is consumed
    if (vec) {
      const int per_c = per_bh / C;
      for (int e = t; e < bpb * per_c; e += blockDim.x) {
        const int lbe = e / per_c;
        const int r = (e - lbe * per_c) * C;
        float kx[C], vx[C];
        if (lbe < n_bh) {
          const long long j = j0 + r / HD;
          const int d = r % HD;
          load_chunk<C, T>(p.k + kvbase[2 * lbe] + j * p.ks.s + d, kx);
          load_chunk<C, T>(p.v + kvbase[2 * lbe + 1] + j * p.vs.s + d, vx);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) kx[c] = vx[c] = 0.f;
        }
#pragma unroll
        for (int c = 0; c < C; c += 4) {
          *reinterpret_cast<float4*>(ks + lbe * tkv * HD + r + c) =
              make_float4(kx[c], kx[c + 1], kx[c + 2], kx[c + 3]);
          *reinterpret_cast<float4*>(vs + lbe * tkv * HD + r + c) =
              make_float4(vx[c], vx[c + 1], vx[c + 2], vx[c + 3]);
        }
      }
    } else {
      for (int e = t; e < bpb * per_bh; e += blockDim.x) {
        const int lbe = e / per_bh;
        const int r = e - lbe * per_bh;
        float kx = 0.f, vx = 0.f;
        if (lbe < n_bh) {
          const long long j = j0 + r / HD;
          const int d = r % HD;
          kx = to_f(p.k[kvbase[2 * lbe] + j * p.ks.s + d]);
          vx = to_f(p.v[kvbase[2 * lbe + 1] + j * p.vs.s + d]);
        }
        ks[lbe * tkv * HD + r] = kx;
        vs[lbe * tkv * HD + r] = vx;
      }
    }
    __syncthreads();
    const float* kb = ks + lb * tkv * HD + lane_g * DPT;
    const float* vb = vs + lb * tkv * HD + lane_g * DPT;
    for (int jj = 0; jj < nj; ++jj) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DPT; ++d) s = fmaf(qr[d], kb[jj * HD + d], s);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const int j = j0 + jj;
      bool live = valid;
      if (causal) live = live && j <= qi;
      if (window > 0) live = live && qi - j < window;
      if (!live) continue;
      s *= scale;
      if (s > m) {                   // new running max: rescale first
        const float alpha = expf(m - s);
        l = l * alpha + 1.f;
#pragma unroll
        for (int d = 0; d < DPT; ++d)
          acc[d] = fmaf(acc[d], alpha, vb[jj * HD + d]);
        m = s;
      } else {
        const float pj = expf(s - m);
        l += pj;
#pragma unroll
        for (int d = 0; d < DPT; ++d)
          acc[d] = fmaf(pj, vb[jj * HD + d], acc[d]);
      }
    }
  }
  if (valid) {
    const float den = fmaxf(l, 1e-30f);
    const long long ooff = b * p.os.b + (long long)qi * p.os.s
                           + (long long)h * p.os.h + lane_g * DPT;
#pragma unroll
    for (int d = 0; d < DPT; ++d) store(p.o + ooff + d, acc[d] / den);
  }
}

// -------------------------------------------------------------- short --

// n / d for 0 <= n, d < 2^16 as one wide multiply: m = ceil(2^32 / d)
// (exact while n * d < 2^32).
struct FastDiv {
  unsigned long long m;
};
FastDiv fast_div(int d) {
  return {((1ull << 32) + (unsigned long long)d - 1) / (unsigned long long)d};
}
__device__ __forceinline__ int operator/(int n, FastDiv f) {
  return (int)(((unsigned long long)(unsigned)n * f.m) >> 32);
}

// 2^x in one MUFU instruction (2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The layout of one stage of the ring: `rows` batch rows of Q, then of
// K, then of V, each region starting on 16 bytes; a row is S * H * HD
// elements in (s, h, d) order, as in the model layout.
struct ShortPlan {
  long long B, n_groups;
  int S, Hq, g, rows;
  int q_row, kv_row;                 // elements of one batch row
  int k_off, v_off, stage_bytes;     // bytes (Q starts at 0)
  int units_row;                     // thread units of one batch row
  FastDiv by_units, by_hq, by_g;     // units_row, Hq and g
};

template <int U>
struct Unit;
template <> struct Unit<16> { using type = uint4; };
template <> struct Unit<8> { using type = uint2; };
template <> struct Unit<4> { using type = uint32_t; };
template <> struct Unit<2> { using type = uint16_t; };

// The loads route: rows [b0, b0 + nr) of one operand into a stage region
// with plain loads of U bytes (16 where the alignment allows).
template <int U, int HD, typename T>
__device__ __noinline__ void load_rows(unsigned char* dst, const T* src,
                                       Strides st, long long b0, int nr,
                                       int S, int H) {
  using W = typename Unit<U>::type;
  constexpr int CB = HD * sizeof(T);  // chunk bytes
  constexpr int UPC = CB / U;         // units a chunk
  const int n = nr * S * H * UPC;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int c = e / UPC;
    const int u = e - c * UPC;
    const int h = c % H;
    const int rs = c / H;
    const int s = rs % S;
    const int r = rs / S;
    const T* chunk = src + (b0 + r) * st.b + (long long)s * st.s
                     + (long long)h * st.h;
    reinterpret_cast<W*>(dst + (size_t)c * CB)[u] =
        reinterpret_cast<const W*>(chunk)[u];
  }
}

template <int HD, typename T>
__device__ void load_rows_any(int unit, unsigned char* dst, const T* src,
                              Strides st, long long b0, int nr, int S,
                              int H) {
  constexpr int CB = HD * sizeof(T);  // 8 bytes at least
  if constexpr (CB % 16 == 0) {
    if (unit >= 16) return load_rows<16, HD, T>(dst, src, st, b0, nr, S, H);
  }
  if (unit >= 8) return load_rows<8, HD, T>(dst, src, st, b0, nr, S, H);
  if (unit >= 4) return load_rows<4, HD, T>(dst, src, st, b0, nr, S, H);
  load_rows<2, HD, T>(dst, src, st, b0, nr, S, H);
}

// Start the bulk copies of group `grp` into stage `st` (one thread).
template <typename T>
__device__ void fill_stage(const Operands<T>& p, const ShortPlan& pl,
                            long long grp, unsigned char* stage,
                            uint64_t* bar) {
  const long long b0 = grp * pl.rows;
  const int nr = (int)min((long long)pl.rows, pl.B - b0);
  const uint32_t qb = pl.q_row * sizeof(T), kb = pl.kv_row * sizeof(T);
  mbar_expect_tx(bar, nr * (qb + 2 * kb));
  const T* src[3] = {p.q, p.k, p.v};
  const long long sb[3] = {p.qs.b, p.ks.b, p.vs.b};
  const int off[3] = {0, pl.k_off, pl.v_off};
  const uint32_t rb[3] = {qb, kb, kb};
  const int row[3] = {pl.q_row, pl.kv_row, pl.kv_row};
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    if (sb[x] == row[x] || nr == 1) {  // the group's rows are one span
      bulk_load(stage + off[x], src[x] + b0 * sb[x], nr * rb[x], bar);
    } else {
      for (int r = 0; r < nr; ++r)
        bulk_load(stage + off[x] + r * rb[x], src[x] + (b0 + r) * sb[x],
                  rb[x], bar);
    }
  }
}

// SMAX: without MASK, S rounded up to a multiple of 8, so the unrolled
// key loops run at most 7 keys past S and no other score is masked.
// MASK (causal or windowed): SMAX = SHORT_MAX_S and every key index is
// clamped to S - 1, the keys past S masked with the rest.
template <int HD, int SMAX, bool MASK, typename T>
__global__ void __launch_bounds__(SHORT_THREADS)
    fa_short_kernel(Operands<T> p, ShortPlan pl, float scale_log2,
                    int causal, int window, int bulk, int unit) {
  extern __shared__ uint4 smem_raw[];
  __shared__ uint64_t full[STAGES];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_raw);
  const int S = pl.S, Hq = pl.Hq;
  const int Hkv = Hq / pl.g;

  if (bulk) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        const long long grp = blockIdx.x + (long long)s * gridDim.x;
        if (grp < pl.n_groups)
          fill_stage(p, pl, grp, smem + s * pl.stage_bytes, &full[s]);
      }
    }
  }

  int it = 0;
  for (long long grp = blockIdx.x; grp < pl.n_groups;
       grp += gridDim.x, ++it) {
    const int st = bulk ? it % STAGES : 0;
    unsigned char* stage = smem + st * pl.stage_bytes;
    const long long b0 = grp * pl.rows;
    const int nr = (int)min((long long)pl.rows, pl.B - b0);
    if (bulk) {
      mbar_wait(&full[st], (it / STAGES) & 1);
    } else {
      load_rows_any<HD, T>(unit, stage, p.q, p.qs, b0, nr, S, Hq);
      load_rows_any<HD, T>(unit, stage + pl.k_off, p.k, p.ks, b0, nr, S,
                           Hkv);
      load_rows_any<HD, T>(unit, stage + pl.v_off, p.v, p.vs, b0, nr, S,
                           Hkv);
      __syncthreads();
    }
    const T* qs = reinterpret_cast<const T*>(stage);
    const T* ks = reinterpret_cast<const T*>(stage + pl.k_off);
    const T* vs = reinterpret_cast<const T*>(stage + pl.v_off);
    const int n_units = nr * pl.units_row;
    for (int u = threadIdx.x; u < n_units; u += blockDim.x) {
      const int r = u / pl.by_units;
      const int rem = u - r * pl.units_row;
      const int iq = rem / pl.by_hq;
      const int h = rem - iq * Hq;             // query head
      const int hk = h / pl.by_g;              // its key/value head
      const int i0 = iq * QPT;                 // first query position
      float qv[QPT][HD];
#pragma unroll
      for (int e = 0; e < QPT; ++e) {
        const int i = min(i0 + e, S - 1);
        load_chunk<HD, T>(qs + ((r * S + i) * Hq + h) * HD, qv[e]);
#pragma unroll
        for (int d = 0; d < HD; ++d) qv[e][d] *= scale_log2;
      }
      const T* kr = ks + r * pl.kv_row + hk * HD;
      const T* vr = vs + r * pl.kv_row + hk * HD;
      const int kstep = Hkv * HD;
      // live keys [j_lo, j_hi] of each query
      int j_lo[QPT], j_hi[QPT];
#pragma unroll
      for (int e = 0; e < QPT; ++e) {
        j_lo[e] = MASK && window > 0 ? i0 + e - window + 1 : 0;
        j_hi[e] = MASK && causal ? i0 + e : S - 1;
      }
      // Keys are unrolled to SMAX with no branch, so every load can be
      // started ahead of its use: the keys past S (without MASK only the
      // last 7 can be) read key S - 1 and score -inf.
      float sc[QPT][SMAX], m[QPT];
#pragma unroll
      for (int e = 0; e < QPT; ++e) m[e] = -INFINITY;
#pragma unroll
      for (int j = 0; j < SMAX; ++j) {      // pass 1: scores and their max
        const bool tail = MASK || j > SMAX - 8;
        float kv[HD];
        load_chunk<HD, T>(kr + (tail ? min(j, S - 1) : j) * kstep, kv);
#pragma unroll
        for (int e = 0; e < QPT; ++e) {
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) s = fmaf(qv[e][d], kv[d], s);
          bool live = !tail || j < S;
          if (MASK) live = live && j >= j_lo[e] && j <= j_hi[e];
          sc[e][j] = live ? s : -INFINITY;
          m[e] = fmaxf(m[e], sc[e][j]);
        }
      }
      float l[QPT], acc[QPT][HD];
#pragma unroll
      for (int e = 0; e < QPT; ++e) {
        l[e] = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[e][d] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < SMAX; ++j) {      // pass 2: 2^(s - max) and P.V
        const bool tail = MASK || j > SMAX - 8;
        float vv[HD];
        load_chunk<HD, T>(vr + (tail ? min(j, S - 1) : j) * kstep, vv);
#pragma unroll
        for (int e = 0; e < QPT; ++e) {
          const float pj = ex2(sc[e][j] - m[e]);
          l[e] += pj;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc[e][d] = fmaf(pj, vv[d], acc[e][d]);
        }
      }
#pragma unroll
      for (int e = 0; e < QPT; ++e) {
        const int i = i0 + e;
        if (QPT > 1 && i >= S) break;
        const float inv = 1.f / fmaxf(l[e], 1e-30f);
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[e][d] *= inv;
        store_chunk<HD, T>(p.o + (b0 + r) * p.os.b + (long long)i * p.os.s
                               + (long long)h * p.os.h,
                           acc[e]);
      }
    }
    __syncthreads();                 // every thread is done with the stage
    if (bulk && threadIdx.x == 0) {
      const long long nxt = grp + (long long)STAGES * gridDim.x;
      if (nxt < pl.n_groups) {
        // order the block's reads of the stage before the async writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        fill_stage(p, pl, nxt, stage, &full[st]);
      }
    }
  }
}

// ------------------------------------------------------- tensor cores --

// The tensor-core route: a block owns TC_BM query rows of one query
// head.  Warpgroups 0 and 1 consume 64 rows each; warpgroup 2 produces
// (one thread issues the copies).  Keys come in tiles of TC_BN through
// a ring of TC_STAGES stages, each K then V.
constexpr int TC_BM = 128;
constexpr int TC_BN = 128;
constexpr int TC_STAGES = 3;
constexpr int TC_CONSUMERS = 256;
constexpr int TC_THREADS = TC_CONSUMERS + 128;
constexpr int BOX_COLS = 64;  // bf16 columns of one 128-byte swizzled row
// 1000 + the CUresult of a tensor map the driver refused
constexpr int TC_ENCODE_ERROR = 1000;

// Shared memory: Q's boxes, then the stages.  A box holds BOX_COLS
// columns of every row (rows of 128 bytes, TMA's 128-byte swizzle); at
// HD = 128 a row spans two boxes.
template <int HD>
struct TcLayout {
  static constexpr int BOXES = HD / BOX_COLS;
  static constexpr int Q_BOX = TC_BM * 128;
  static constexpr int KV_BOX = TC_BN * 128;
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int KV_BYTES = BOXES * KV_BOX;  // K or V of one tile
  static constexpr int STAGE = 2 * KV_BYTES;
  // + slack to put the first box on 1024 bytes (a swizzle atom)
  static constexpr int SMEM = Q_BYTES + TC_STAGES * STAGE + 1024;
};

struct TcArgs {
  __nv_bfloat16* o;
  Strides os;
  int B, S, Hq, g, n_qt, causal, window;
  float scale_log2;
};

// S = Q . K^T for one warpgroup's 64 rows and a tile's TC_BN keys: HD / 16
// steps of 16 dims, each 32 bytes further along the swizzled rows.
template <int HD>
__device__ __forceinline__ void tc_scores(float (&sc)[TC_BN / 2],
                                          uint32_t q_at, uint32_t k_at) {
  using L = TcLayout<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_m64n128k16_ss(
        sc, sw128_desc(q_at + kk / 4 * L::Q_BOX + kk % 4 * 32, 16, 1024),
        sw128_desc(k_at + kk / 4 * L::KV_BOX + kk % 4 * 32, 16, 1024),
        kk > 0);
}

// O += P . V: P from registers in TC_BN / 16 steps of 16 keys (2048
// bytes of V each); V is MN-major (HD contiguous), its two boxes at
// HD = 128 one KV_BOX apart.
template <int HD>
__device__ __forceinline__ void tc_pv(float (&acc)[HD / 2],
                                      const uint32_t (&pb)[TC_BN / 4],
                                      uint32_t v_at) {
  using L = TcLayout<HD>;
#pragma unroll
  for (int kk = 0; kk < TC_BN / 16; ++kk) {
    const uint64_t d = sw128_desc(v_at + kk * 16 * 128, L::KV_BOX, 1024);
    if constexpr (HD == 64)
      wgmma_m64n64k16_rs(acc, pb + 4 * kk, d);
    else
      wgmma_m64n128k16_rs(acc, pb + 4 * kk, d);
  }
}

// The online softmax of one tile's scores, in place: masks (only on a
// tile that reaches an edge), the running max of each of the thread's two
// rows over the 4 threads that share it, p = 2^(s * scale log2(e) - max)
// and the thread's part of the row sums.  `alpha` rescales what was
// summed before.  A row with no live key so far keeps max -inf and takes
// 0 as the max it subtracts, so no -inf - -inf is formed.
__device__ __forceinline__ void tc_softmax(float (&sc)[TC_BN / 2],
                                           float (&m)[2], float (&l)[2],
                                           float (&alpha)[2], int j0,
                                           int row, int col, bool edge,
                                           const TcArgs& a) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < TC_BN / 2; ++i) {
      const int j = j0 + 8 * (i / 4) + col + (i % 2);
      const int r = row + 8 * ((i / 2) % 2);
      bool live = j < a.S;
      if (a.causal) live = live && j <= r;
      if (a.window > 0) live = live && r - j < a.window;
      if (!live) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < TC_BN / 2; ++i)
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
  float mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * a.scale_log2);
    mc[r] = mn == -INFINITY ? 0.f : mn;
    alpha[r] = ex2(m[r] - mc[r]);
    m[r] = mn;
  }
#pragma unroll
  for (int i = 0; i < TC_BN / 2; ++i) {
    const int r = (i / 2) % 2;
    sc[i] = ex2(fmaf(sc[i], a.scale_log2, -mc[r]));
    sum[r] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], sum[r]);
}

// p (fp32, the scores' accumulator layout) to the bf16 A fragments of
// the PV product: register i holds p[2i] (low half) and p[2i + 1].
__device__ __forceinline__ void tc_pack(const float (&sc)[TC_BN / 2],
                                        uint32_t (&pb)[TC_BN / 4]) {
#pragma unroll
  for (int i = 0; i < TC_BN / 4; ++i)
    pb[i] = pack(sc + 2 * i, __nv_bfloat16());
}

// One work item: 128 query rows of one query head.  Items are numbered
// so that the g query heads of one KV head at one query tile are
// adjacent (their K and V tiles come from L2) and the last, heaviest
// causal query tiles come first.
struct TcItem {
  int b, h, hk, q0, n_lo, n_tiles;  // n_lo, n_tiles: its key tiles
};

__device__ __forceinline__ TcItem tc_item(int idx, const TcArgs& a) {
  TcItem w;
  const int hg = idx % a.g;
  idx /= a.g;
  w.hk = idx % (a.Hq / a.g);
  idx /= a.Hq / a.g;
  w.b = idx % a.B;
  w.q0 = (a.n_qt - 1 - idx / a.B) * TC_BM;
  w.h = w.hk * a.g + hg;
  // the key tiles some row of the item may see
  const int kv_end = a.causal ? min(a.S, w.q0 + TC_BM) : a.S;
  w.n_lo = (a.window > 0 ? max(0, w.q0 - a.window + 1) : 0) / TC_BN;
  w.n_tiles = (kv_end + TC_BN - 1) / TC_BN - w.n_lo;
  return w;
}

// Persistent: block k takes items k, k + gridDim.x, ...  The ring runs on
// across items (`it` counts the block's tiles), so the producer loads the
// next item's Q and first tiles while the consumers finish this one.
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
    fa_tc_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const TcArgs a) {
  using L = TcLayout<HD>;
  extern __shared__ uint4 tc_raw[];
  __shared__ uint64_t full[TC_STAGES], empty[TC_STAGES], q_full, q_empty;
  unsigned char* qs = reinterpret_cast<unsigned char*>(tc_raw);
  qs += (1024 - (smem_addr(qs) & 1023)) & 1023;
  unsigned char* kv = qs + L::Q_BYTES;  // stage st: K at st * STAGE, V after
  const int n_items = a.n_qt * a.B * a.Hq;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TC_CONSUMERS);
    }
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, TC_CONSUMERS);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= TC_CONSUMERS / 32) {  // the producer warpgroup
    regs_lower<24>();
    if (warp == TC_CONSUMERS / 32 && lane == 0) {
      int it = 0, k = 0;
      for (int idx = blockIdx.x; idx < n_items; idx += gridDim.x, ++k) {
        const TcItem w = tc_item(idx, a);
        mbar_wait(&q_empty, (k & 1) ^ 1);  // the last item's Q is used
        mbar_expect_tx(&q_full, L::Q_BYTES);
        for (int c = 0; c < L::BOXES; ++c)
          tma_load_4d(qs + c * L::Q_BOX, &tq, c * BOX_COLS, w.h, w.q0, w.b,
                      &q_full);
        for (int t = 0; t < w.n_tiles; ++t, ++it) {
          const int st = it % TC_STAGES;
          const int j0 = (w.n_lo + t) * TC_BN;
          mbar_wait(&empty[st], ((it / TC_STAGES) & 1) ^ 1);
          unsigned char* ks = kv + st * L::STAGE;
          mbar_expect_tx(&full[st], L::STAGE);
          for (int c = 0; c < L::BOXES; ++c) {
            tma_load_4d(ks + c * L::KV_BOX, &tk, c * BOX_COLS, w.hk, j0, w.b,
                        &full[st]);
            tma_load_4d(ks + L::KV_BYTES + c * L::KV_BOX, &tv, c * BOX_COLS,
                        w.hk, j0, w.b, &full[st]);
          }
        }
      }
    }
  } else {  // a consumer warpgroup: 64 query rows of each item
    regs_raise<240>();
    const uint32_t q_at = smem_addr(qs) + warp / 4 * 64 * 128;
    const uint32_t kv_at = smem_addr(kv);
    float sc[TC_BN / 2], acc[HD / 2], alpha[2];
    uint32_t pb[TC_BN / 4];
    int it = 0, k = 0;
    for (int idx = blockIdx.x; idx < n_items; idx += gridDim.x, ++k) {
      const TcItem w = tc_item(idx, a);
      const int qw0 = w.q0 + warp / 4 * 64;
      // this thread's rows (row, row + 8) and first column of each 8
      // columns of an accumulator
      const int row = qw0 + warp % 4 * 16 + lane / 4;
      const int col = 2 * (lane % 4);
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
      // whether a tile reaches an edge of this warpgroup's rows: past S,
      // the causal diagonal or the window's far end
      auto edge = [&](int j0) {
        return j0 + TC_BN > a.S || (a.causal && j0 + TC_BN - 1 > qw0) ||
               (a.window > 0 && qw0 + 63 - j0 >= a.window);
      };

      mbar_wait(&q_full, k & 1);
      mbar_wait(&full[it % TC_STAGES], (it / TC_STAGES) & 1);
      hold_regs(sc);
      wgmma_fence();
      tc_scores<HD>(sc, q_at, kv_at + it % TC_STAGES * L::STAGE);
      wgmma_commit();
      wgmma_wait<0>();
      hold_regs(sc);
      if (w.n_tiles == 1) mbar_arrive(&q_empty);
      tc_softmax(sc, m, l, alpha, w.n_lo * TC_BN, row, col,
                 edge(w.n_lo * TC_BN), a);
      tc_pack(sc, pb);
      // Tile t's scores run on the tensor cores beside tile t - 1's P.V;
      // its softmax runs while P.V is still in flight, and rescales O
      // once P.V has landed.
      for (int t = 1; t < w.n_tiles; ++t) {
        const int st = (it + t) % TC_STAGES, prev = (it + t - 1) % TC_STAGES;
        const int j0 = (w.n_lo + t) * TC_BN;
        mbar_wait(&full[st], ((it + t) / TC_STAGES) & 1);
        hold_regs(sc);
        hold_regs(acc);
        hold_regs(pb);
        wgmma_fence();
        tc_scores<HD>(sc, q_at, kv_at + st * L::STAGE);
        wgmma_commit();
        tc_pv<HD>(acc, pb, kv_at + prev * L::STAGE + L::KV_BYTES);
        wgmma_commit();
        wgmma_wait<1>();
        hold_regs(sc);
        if (t == w.n_tiles - 1) mbar_arrive(&q_empty);  // Q's last use
        tc_softmax(sc, m, l, alpha, j0, row, col, edge(j0), a);
        wgmma_wait<0>();
        hold_regs(acc);
        hold_regs(pb);
        mbar_arrive(&empty[prev]);
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
        tc_pack(sc, pb);
      }
      it += w.n_tiles;
      const int last = (it - 1) % TC_STAGES;
      hold_regs(acc);
      hold_regs(pb);
      wgmma_fence();
      tc_pv<HD>(acc, pb, kv_at + last * L::STAGE + L::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      hold_regs(acc);
      hold_regs(pb);
      mbar_arrive(&empty[last]);

      // O / max(l, 1e-30) in bf16, two values a 4-byte store; rows past
      // S are not written
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int qi = row + 8 * r;
        if (qi >= a.S) continue;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        __nv_bfloat16* dst = a.o + (long long)w.b * a.os.b
                             + (long long)qi * a.os.s
                             + (long long)w.h * a.os.h + col;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const float x[2] = {acc[4 * j + 2 * r] * inv,
                              acc[4 * j + 2 * r + 1] * inv};
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack(x, __nv_bfloat16());
        }
      }
    }
  }
}

// ------------------------------------------------------------ launch --

// the largest power of two up to 16 that divides every nonzero value
unsigned align16(std::initializer_list<unsigned long long> xs) {
  unsigned a = 16;
  for (unsigned long long x : xs)
    while (x % a) a >>= 1;
  return a;
}

// the card's SM count, asked once per device (0: not asked yet)
int sm_count(int dev, int* out) {
  static std::atomic<int> known[MAX_DEVICES];
  if (dev < MAX_DEVICES && known[dev].load() > 0) {
    *out = known[dev].load();
    return 0;
  }
  cudaError_t e =
      cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES) known[dev].store(*out);
  return 0;
}

template <typename T>
struct Launch {
  Operands<T> p;
  ShortPlan pl;
  float scale_log2;
  int causal, window, bulk, unit, threads;
  size_t smem;
  cudaStream_t stream;
};

// Launch one instantiation of the short kernel: opt in to the ring's
// shared memory once per device, and remember per device the occupancy
// of the last (threads, smem) asked, packed in one word so that
// concurrent callers read a consistent triple.
template <int HD, int SMAX, bool MASK, typename T>
int start_short(const Launch<T>& a) {
  auto kernel = fa_short_kernel<HD, SMAX, MASK, T>;
  static bool opted_in[MAX_DEVICES] = {};
  static std::atomic<unsigned long long> occ[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SHORT_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  const unsigned long long key = ((unsigned long long)a.threads << 40) |
                                 ((unsigned long long)a.smem << 8);
  int per_sm = 0;
  const unsigned long long seen = dev < MAX_DEVICES ? occ[dev].load() : 0;
  if (seen >> 8 == key >> 8 && (seen & 0xff) > 0) {
    per_sm = (int)(seen & 0xff);
  } else {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      a.threads, a.smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES && per_sm > 0 && per_sm < 256)
      occ[dev].store(key | (unsigned long long)per_sm);
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int sms = 0;
  const int err = sm_count(dev, &sms);
  if (err) return err;
  const long long cap = (long long)per_sm * sms;
  const long long blocks = a.pl.n_groups < cap ? a.pl.n_groups : cap;
  kernel<<<(unsigned)blocks, a.threads, a.smem, a.stream>>>(
      a.p, a.pl, a.scale_log2, a.causal, a.window, a.bulk, a.unit);
  return (int)cudaGetLastError();
}

// Whether the short path takes the call: S and the group's row within
// their caps, and o writable a chunk (8 or 16 bytes) a store.
template <int HD, typename T>
bool short_fits(const Operands<T>& p, int S, int Hq, int g) {
  constexpr int E = sizeof(T);
  constexpr int CB = HD * E;
  const long long row_bytes = (long long)S * (Hq + 2 * (Hq / g)) * HD * E;
  return S <= SHORT_MAX_S && row_bytes <= STAGE_BYTES &&
         align16({(unsigned long long)(uintptr_t)p.o,
                  (unsigned long long)(p.os.b * E),
                  (unsigned long long)(p.os.s * E),
                  (unsigned long long)(p.os.h * E)}) >= (CB < 16 ? CB : 16);
}

// Whether the bulk copies can move the batch rows: each batch row of q,
// k and v one contiguous span of a multiple of 16 bytes, 16-byte
// aligned, and so the step from one row to the next.
template <int HD, typename T>
bool bulk_fits(const Operands<T>& p, long long B, int S, int Hq, int g) {
  constexpr int E = sizeof(T);
  const T* src[3] = {p.q, p.k, p.v};
  const Strides st[3] = {p.qs, p.ks, p.vs};
  const int H[3] = {Hq, Hq / g, Hq / g};
  for (int x = 0; x < 3; ++x) {
    if ((S > 1 && st[x].s != (long long)H[x] * HD) ||
        (H[x] > 1 && st[x].h != HD) || (S * H[x] * HD * E) % 16 != 0 ||
        align16({(unsigned long long)(uintptr_t)src[x],
                 (unsigned long long)(B > 1 ? st[x].b * E : 0)}) < 16)
      return false;
  }
  return true;
}

template <int HD, typename T>
int launch_short(const Operands<T>& p, long long B, int S, int Hq, int g,
                 int causal, int window, float scale, bool bulk,
                 cudaStream_t stream) {
  constexpr int E = sizeof(T);
  constexpr int CB = HD * E;
  const int Hkv = Hq / g;
  ShortPlan pl;
  pl.B = B;
  pl.S = S;
  pl.Hq = Hq;
  pl.g = g;
  pl.q_row = S * Hq * HD;
  pl.kv_row = S * Hkv * HD;
  pl.rows = STAGE_BYTES / ((pl.q_row + 2 * pl.kv_row) * E);
  if (pl.rows > B) pl.rows = (int)B;
  auto up16 = [](int x) { return (x + 15) / 16 * 16; };
  pl.k_off = up16(pl.rows * pl.q_row * E);
  pl.v_off = pl.k_off + up16(pl.rows * pl.kv_row * E);
  pl.stage_bytes = pl.v_off + up16(pl.rows * pl.kv_row * E);
  pl.n_groups = (B + pl.rows - 1) / pl.rows;

  // the loads route: the widest load every address allows
  const unsigned unit =
      bulk ? 16
           : align16({(unsigned long long)(uintptr_t)p.q,
                      (unsigned long long)(uintptr_t)p.k,
                      (unsigned long long)(uintptr_t)p.v,
                      (unsigned long long)(p.qs.b * E),
                      (unsigned long long)(p.qs.s * E),
                      (unsigned long long)(p.qs.h * E),
                      (unsigned long long)(p.ks.b * E),
                      (unsigned long long)(p.ks.s * E),
                      (unsigned long long)(p.ks.h * E),
                      (unsigned long long)(p.vs.b * E),
                      (unsigned long long)(p.vs.s * E),
                      (unsigned long long)(p.vs.h * E),
                      (unsigned long long)CB});
  const size_t smem = (size_t)(bulk ? STAGES : 1) * pl.stage_bytes;

  // threads: the group's (query, head) pairs in whole passes of at most
  // SHORT_THREADS, so the last pass is not mostly idle
  pl.units_row = (S + QPT - 1) / QPT * Hq;
  const int units = pl.rows * pl.units_row;
  const int passes = (units + SHORT_THREADS - 1) / SHORT_THREADS;
  const int threads = ((units + passes - 1) / passes + 31) / 32 * 32;
  pl.by_units = fast_div(pl.units_row);
  pl.by_hq = fast_div(Hq);
  pl.by_g = fast_div(g);
  const Launch<T> a{p, pl, scale * LOG2E, causal, window, bulk ? 1 : 0,
                    (int)unit, threads, smem, stream};
  if (causal || window > 0) return start_short<HD, SHORT_MAX_S, true, T>(a);
  if (S <= 8) return start_short<HD, 8, false, T>(a);
  if (S <= 16) return start_short<HD, 16, false, T>(a);
  if (S <= 24) return start_short<HD, 24, false, T>(a);
  return start_short<HD, 32, false, T>(a);
}

template <int HD, typename T>
int launch_general(const Operands<T>& p, long long B, int S, int Hq, int g,
                   int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int G = Split<HD>::G;
  const long long BH = B * Hq;
  const int rows_max = MAX_THREADS / G;
  int rows, bpb, n_qt;
  if (S <= rows_max) {               // whole bh per block, several of them
    rows = S;
    bpb = rows_max / S;
    n_qt = 1;
  } else {                           // one bh, a tile of query rows
    rows = rows_max;
    bpb = 1;
    n_qt = (S + rows - 1) / rows;
  }
  int tkv = SMEM_FLOATS / (2 * bpb * HD);
  if (tkv > S) tkv = S;
  if (tkv < 1) return (int)cudaErrorInvalidValue;
  const int threads = ((bpb * rows * G + 31) / 32) * 32;
  const long long blocks = (BH + bpb - 1) / bpb * n_qt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * bpb * tkv * HD * sizeof(float)
                      + (size_t)2 * bpb * sizeof(long long);
  // K and V staged C elements a load where every K and V address allows
  constexpr int E = sizeof(T);
  constexpr int C = HD < 16 / E ? HD : 16 / E;
  const int vec = align16({(unsigned long long)(uintptr_t)p.k,
                           (unsigned long long)(uintptr_t)p.v,
                           (unsigned long long)(p.ks.b * E),
                           (unsigned long long)(p.ks.s * E),
                           (unsigned long long)(p.ks.h * E),
                           (unsigned long long)(p.vs.b * E),
                           (unsigned long long)(p.vs.s * E),
                           (unsigned long long)(p.vs.h * E)}) >= C * E;
  fa_kernel<HD, T><<<(unsigned)blocks, threads, smem, stream>>>(
      p, BH, S, Hq, g, bpb, rows, n_qt, tkv, scale, causal, window, vec);
  return (int)cudaGetLastError();
}

// Whether TMA can address an operand (B, S, H, HD) of bf16: a 16-byte
// aligned base, and on every axis longer than 1 a byte stride that is a
// positive multiple of 16 below 2^40.
bool tma_fits(const void* ptr, Strides st, long long B, int S, int H) {
  const long long n[3] = {H, S, B}, s[3] = {st.h, st.s, st.b};
  if ((uintptr_t)ptr % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1 && (s[i] <= 0 || s[i] * 2 % 16 || s[i] * 2 >= (1ll << 40)))
      return false;
  return true;
}

// Whether the tensor-core route takes a bf16 call: q, k and v addressable
// by TMA, o writable two values a store, the work items within 2^31.
bool tc_fits(const Operands<__nv_bfloat16>& p, long long B, int S, int Hq,
             int g) {
  const long long blocks = (long long)((S + TC_BM - 1) / TC_BM) * B * Hq;
  return blocks <= 0x7fffffffLL && tma_fits(p.q, p.qs, B, S, Hq) &&
         tma_fits(p.k, p.ks, B, S, Hq / g) &&
         tma_fits(p.v, p.vs, B, S, Hq / g) &&
         align16({(unsigned long long)(uintptr_t)p.o,
                  (unsigned long long)(p.os.b * 2),
                  (unsigned long long)(p.os.s * 2),
                  (unsigned long long)(p.os.h * 2)}) >= 4;
}

// A 4-D tensor map (HD, H, S, B) of a bf16 operand with boxes of
// BOX_COLS x 1 x rows x 1, 128-byte swizzle; out-of-range elements load
// as zeros.  An axis of length 1 is never stepped and gets the packed
// stride.
int tc_map(CUtensorMap* map, const void* ptr, Strides st, long long B,
           int S, int H, int HD, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {
      (cuuint64_t)(H > 1 ? st.h : HD) * 2,
      (cuuint64_t)(S > 1 ? st.s : (long long)H * HD) * 2,
      (cuuint64_t)(B > 1 ? st.b : (long long)S * H * HD) * 2};
  const cuuint32_t box[4] = {BOX_COLS, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TC_ENCODE_ERROR + (int)r;
}

template <int HD>
int launch_tc(const Operands<__nv_bfloat16>& p, long long B, int S, int Hq,
              int g, int causal, int window, float scale,
              cudaStream_t stream) {
  using L = TcLayout<HD>;
  CUtensorMap tq, tk, tv;
  int e = tc_map(&tq, p.q, p.qs, B, S, Hq, HD, TC_BM);
  if (!e) e = tc_map(&tk, p.k, p.ks, B, S, Hq / g, HD, TC_BN);
  if (!e) e = tc_map(&tv, p.v, p.vs, B, S, Hq / g, HD, TC_BN);
  if (e) return e;
  auto kernel = fa_tc_kernel<HD>;
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return (int)ce;
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    ce = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (ce != cudaSuccess) return (int)ce;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  int sms = 0;
  const int err = sm_count(dev, &sms);
  if (err) return err;
  const int n_qt = (S + TC_BM - 1) / TC_BM;
  const long long items = (long long)n_qt * B * Hq;
  const TcArgs a{p.o, p.os, (int)B, S, Hq, g, n_qt, causal, window,
                 scale * LOG2E};
  kernel<<<(unsigned)(items < sms ? items : sms), TC_THREADS, L::SMEM,
           stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

template <int HD, typename T>
int launch(const Operands<T>& p, long long B, int S, int Hq, int g,
           int causal, int window, float scale, int* route,
           cudaStream_t stream) {
  if constexpr (HD <= SHORT_MAX_HD) {
    if (short_fits<HD, T>(p, S, Hq, g)) {
      const bool bulk = bulk_fits<HD, T>(p, B, S, Hq, g);
      *route = bulk ? ROUTE_SHORT_BULK : ROUTE_SHORT_LOADS;
      return launch_short<HD, T>(p, B, S, Hq, g, causal, window, scale, bulk,
                                 stream);
    }
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value &&
                (HD == 64 || HD == 128)) {
    if (tc_fits(p, B, S, Hq, g)) {
      *route = ROUTE_GENERAL_TC;
      return launch_tc<HD>(p, B, S, Hq, g, causal, window, scale, stream);
    }
  }
  *route = ROUTE_GENERAL;
  return launch_general<HD, T>(p, B, S, Hq, g, causal, window, scale,
                               stream);
}

template <typename T>
int run(void* q, void* k, void* v, void* o, const long long* st,
        long long B, int S, int Hq, int g, int HD, int causal, int window,
        float scale, int* route, cudaStream_t stream) {
  const Operands<T> p{(const T*)q, (const T*)k, (const T*)v, (T*)o,
                      {st[0], st[1], st[2]}, {st[3], st[4], st[5]},
                      {st[6], st[7], st[8]}, {st[9], st[10], st[11]}};
  switch (HD) {
#define FA_CASE(D)                                                          \
  case D:                                                                   \
    return launch<D, T>(p, B, S, Hq, g, causal, window, scale, route,       \
                        stream);
    FA_CASE(4)
    FA_CASE(8)
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
#undef FA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, Hq, HD), k and v (B, S, Hq / g, HD), o (B, S, Hq, HD), each
// with element strides (batch, sequence, head) in `strides` (q, k, v, o:
// twelve values) and stride 1 on the head dim.  dtype: 0 float32,
// 1 bfloat16.  window <= 0 means no window.  The launcher picks the
// path and writes it to `route`: 0 general, 1 short with bulk copies,
// 2 short with plain loads, 3 general on the tensor cores (-1: nothing
// launched).  Returns cudaGetLastError(), or 1000 + the CUresult of a
// tensor map the driver refused.
extern "C" int flash_attention_launch(void* q, void* k, void* v, void* o,
                                      const long long* strides,
                                      long long B, int S, int Hq, int g,
                                      int HD, int dtype, int causal,
                                      int window, float scale, int* route,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  *route = -1;
  if (B <= 0 || S <= 0 || Hq <= 0 || g <= 0 || Hq % g != 0)
    return B == 0 ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return run<float>(q, k, v, o, strides, B, S, Hq, g, HD, causal, window,
                      scale, route, st);
  if (dtype == 1)
    return run<__nv_bfloat16>(q, k, v, o, strides, B, S, Hq, g, HD, causal,
                              window, scale, route, st);
  return (int)cudaErrorInvalidValue;
}
