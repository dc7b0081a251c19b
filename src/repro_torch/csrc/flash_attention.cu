// Flash-attention forward for Hopper (sm_90a): online softmax, fp32 stats.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` (_fa_kernel) of
// src/repro/kernels/flash_attention/kernel.py.  Inputs q, k, v and the
// output are (BH, S, HD) row-major, float32 or bfloat16; scores are
// fp32 q.k times `scale`, optional causal (k <= q) and sliding-window
// (q - k < window) masks, running max / normaliser / accumulator in fp32,
// output acc / max(l, 1e-30) in q's dtype.
//
// Design.  The TPU grid carries m, l and acc through the kv axis in VMEM
// scratch from one grid step to the next; blocks on Hopper run in
// parallel, so each block walks the kv tiles itself.  A group of G
// threads owns one query row: each holds DPT = HD / G (at most 8) of its
// query and accumulator dims in registers, and the group sums its
// partial dot products with warp shuffles.  A block owns `rows` query
// rows of each of `bpb` consecutive bh: at the funnel's shape (S = 21,
// HD = 4) one block packs 12 whole bh (252 rows) instead of launching
// one tiny block per bh; for long S, one bh and a tile of rows.  K and
// V tiles of `tkv` keys for all the block's bh sit in shared memory
// (fp32, at most 32 KB).  The causal and window masks are applied per
// element, and kv tiles no row of the block can reach are never loaded.
// A masked key is skipped, where the TPU kernel adds exp(-1e30 - m) = 0
// once a live key has been seen: the same result, since every row
// reaches its own diagonal key.
//
// Bound on the H100 at the funnel's labelling shape (BH = 1 024 000,
// S = 21, HD = 4, fp32): bytes 4 x BH x S x HD x 4 B = 1.38 GB (0.41 ms at
// 3.35 TB/s), operations 4 S^2 HD per bh = 7.2 GFLOP (0.11 ms at 67
// TFLOP/s fp32), so bytes bound it.  This first kernel does one `expf`
// and 2 HD FMAs per (query, key) pair on the CUDA cores, one thread per
// pair at a time, and is instruction-bound above that floor; tensor-core
// tiles (`wgmma`) and TMA loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_THREADS = 256;
constexpr int SMEM_FLOATS = 8192;  // K + V tiles: 32 KB

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as JAX's astype
}

template <int HD>
struct Split {
  static constexpr int DPT = HD < 8 ? HD : 8;  // dims per thread
  static constexpr int G = HD / DPT;           // threads per query row
};

template <int HD, typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, long long BH,
              int S, int bpb, int rows, int n_qt, int tkv, float scale,
              int causal, int window) {
  constexpr int DPT = Split<HD>::DPT;
  constexpr int G = Split<HD>::G;
  extern __shared__ float smem[];
  float* ks = smem;                  // [bpb][tkv][HD]
  float* vs = smem + bpb * tkv * HD;

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

  float qr[DPT], acc[DPT];
  const long long qoff = (bh * S + qi) * HD + lane_g * DPT;
#pragma unroll
  for (int d = 0; d < DPT; ++d) {
    qr[d] = valid ? to_f(q[qoff + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  for (int j0 = kv_lo; j0 < kv_hi; j0 += tkv) {
    const int nj = min(tkv, kv_hi - j0);
    const int per_bh = nj * HD;
    __syncthreads();                 // the previous tile is consumed
    for (int e = t; e < bpb * per_bh; e += blockDim.x) {
      const int b = e / per_bh;
      const int r = e - b * per_bh;
      float kx = 0.f, vx = 0.f;
      if (b < n_bh) {
        const long long g = ((bh0 + b) * S + j0) * HD + r;
        kx = to_f(k[g]);
        vx = to_f(v[g]);
      }
      ks[b * tkv * HD + r] = kx;
      vs[b * tkv * HD + r] = vx;
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
        const float p = expf(s - m);
        l += p;
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[d] = fmaf(p, vb[jj * HD + d], acc[d]);
      }
    }
  }
  if (valid) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < DPT; ++d) store(o + qoff + d, acc[d] / den);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           long long BH, int S, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int G = Split<HD>::G;
  if (BH <= 0 || S <= 0) return (int)cudaGetLastError();
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
  const size_t smem = (size_t)2 * bpb * tkv * HD * sizeof(float);
  if (blocks > 0) {
    fa_kernel<HD, T><<<(unsigned)blocks, threads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, BH, S, bpb, rows,
        n_qt, tkv, scale, causal, window);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             long long BH, int S, int HD, int causal, int window,
             float scale, cudaStream_t st) {
  switch (HD) {
    case 4: return launch<4, T>(q, k, v, o, BH, S, causal, window, scale, st);
    case 8: return launch<8, T>(q, k, v, o, BH, S, causal, window, scale, st);
    case 16: return launch<16, T>(q, k, v, o, BH, S, causal, window, scale, st);
    case 32: return launch<32, T>(q, k, v, o, BH, S, causal, window, scale, st);
    case 64: return launch<64, T>(q, k, v, o, BH, S, causal, window, scale, st);
    case 128: return launch<128, T>(q, k, v, o, BH, S, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0 means no window.
extern "C" int flash_attention_launch(void* q, void* k, void* v, void* o,
                                      long long BH, int S, int HD,
                                      int dtype, int causal, int window,
                                      float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, BH, S, HD, causal, window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, BH, S, HD, causal, window,
                                   scale, st);
  return (int)cudaErrorInvalidValue;
}
